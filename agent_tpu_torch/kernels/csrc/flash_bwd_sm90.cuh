// Flash attention backward for Hopper with TMA and wgmma (sm_90a): the bf16
// dQ and dK/dV kernels.
//
// Part of flash_attention_bwd.cu's translation unit; the TMA, mbarrier and
// wgmma primitives are sm90_common.cuh's, shared with the forward
// (flash_fwd_sm90.cuh). For D in {32, 64, 128}:
// - flash_bwd_dq_sm90<D> replaces the Pallas kernel `_flash_bwd_dq_kernel`
//   (agent_tpu/kernels/flash_attention.py:629, pallas_call :780). It also
//   computes delta = rowsum(dO * O) in f32 for its rows, from dO's tile and
//   O, and stores it for the dK/dV kernel, launched after it on the stream.
// - flash_bwd_dkv_sm90<D> replaces `_flash_bwd_dkv_kernel` (:665,
//   pallas_call :801).
// Both compute what flash_attention_bwd_reference computes, with 64-key (dQ)
// and 64-query (dK/dV) tiles: p = keep ? exp(min(s * scale - lse, 80)) : 0
// with s = Q K^T in f32, ds = p * (dO V^T - delta), dQ = scale * sum_k
// bf16(ds) K, dV = sum_q bf16(p)^T dO, dK = scale * sum_q bf16(ds)^T Q, f32
// accumulation and the scale applied to the f32 sum once at the end. The
// exponential is ex2.approx of the exponent times log2(e) on the MUFU
// (relative error ~2^-22, far below bf16's rounding of p and ds). A row with
// no real key has p = 0 on every key, so its gradients are exactly 0; query
// rows past Lq take lse = +inf, so their p is exactly 0 too.
//
// Bound on an H100 SXM at the training shape (B 128, H 12, L 512, D 64,
// every key real): dQ does 3 products (1.55e11 FLOP, 0.157 ms at 989
// TFLOP/s) and moves Q, K, V, dO, O, dQ (0.60 GB, 0.18 ms at 3.35 TB/s);
// dK/dV does 4 products (2.06e11 FLOP, 0.209 ms) and moves Q, K, V, dO, dK,
// dV (0.60 GB, 0.18 ms). Both sit near the card's ridge, so, as in the
// forward, loads have to stay in flight while the tensor cores are fed.
// What the design does about it:
// - A warpgroup owns 64 rows (dQ: query rows; dK/dV: keys) of one head and
//   streams the other side's 64-row tiles through a 3-stage TMA ring paced
//   by full/empty mbarriers, refilled by thread 0 two tiles after their use,
//   as the forward. Its own rows are loaded once by TMA; 3-D tensor maps
//   [B*H, L, D] zero-fill past each head's L. Registers and shared memory
//   set the occupancy: at D <= 64 a block is one warpgroup, and three dQ
//   blocks or two dK/dV blocks (214 registers a thread at D 64) share a
//   multiprocessor, so one block's start and end run under the others' main
//   loops; at D 128 a block is two warpgroups sharing each tile, one a
//   multiprocessor.
// - Every product is a wgmma in the forward's two modes. The first two of a
//   tile, S = Q K^T and dP = dO V^T (dK/dV: the transposed tiles S^T = K Q^T
//   and dP^T = V dO^T), read B K-major; their A, the block's own rows, comes
//   from registers at D <= 64 and from shared memory at D 128, where the
//   fragments would not fit beside the accumulators. The second products
//   take A from registers: the f32 accumulators of p or ds rounded to bf16
//   pairs are wgmma's register A fragment as they stand (dK/dV computes the
//   transposed tiles for that), and B (K for dQ, dO and Q for dK/dV) is read
//   MN-major from the tile that the first products used. Nothing is
//   transposed through shared memory, and no score reaches device memory.
// - dQ issues a tile's S and dP together with the previous tile's dQ += ds K
//   and computes ds while that runs. dK/dV holds four accumulators (dK, dV,
//   S^T, dP^T), so it runs its products in turn; the other warpgroup on the
//   multiprocessor fills the tensor cores meanwhile. At D 128 it takes the
//   query tile in two steps of 32 to keep its registers under 255.
// - The dQ kernel reads the key mask a tile ahead (as the forward); dK/dV
//   reads lse and delta of the next query tile into registers a tile ahead,
//   and each warp stages them in shared memory for its lanes' columns.
// - No atomics: every output element is written by one block, so the
//   gradients are deterministic. Each kernel recomputes S and dP: 7 products
//   for the pair against the 5 of a fused backward.
// - Epilogues write the scaled gradients as bf16, swizzled, into the
//   warpgroup's own tiles (read by no pending product) and store them with
//   TMA, which clips rows past Lq or Lk.
#pragma once

#include "sm90_common.cuh"

namespace {
namespace sm90 {
namespace bwd {

// Warpgroups a block: one at D <= 64, where several blocks share a
// multiprocessor (each block's start and end then run under the others'
// main loops): three of dQ (<= 168 registers a thread), two of dK/dV; two
// at D 128, whose tiles leave shared memory for one block.
template <int D>
constexpr int kWarpgroups = D <= 64 ? 1 : 2;
template <int D>
constexpr int kDqCtas = D <= 64 ? 3 : 1;
template <int D>
constexpr int kDkvCtas = D <= 64 ? 2 : 1;
template <int D>
constexpr int kBlockRows = kRows * kWarpgroups<D>;
template <int D>
constexpr int kThreads = 128 * kWarpgroups<D>;
constexpr int kStages = 3;       // ring depth
// Tile it refills the stage of tile it - kLag, which every warpgroup gave
// back by the end of tile it - kLag + 1, with tile it - kLag + kStages.
constexpr int kLag = 2;
static_assert(kLag >= 2 && kLag < kStages, "a refill waits for a stage given back a tile ago");
constexpr float kExpCap = 80.f * kLog2e;  // min(x, 80) of the reference, in log2 units

// Whether the first products' A fragments live in registers.
template <int D>
constexpr bool kARegs = D <= 64;

// This lane's A fragments of a warpgroup's 64-row tile (swizzled, in shared
// memory), one per 16 columns: [0] row 16 warp + g, columns 2t, 2t + 1; [1]
// row + 8; [2], [3] the same rows 8 columns on.
template <int D>
__device__ __forceinline__ void load_frags(uint32_t (&a)[D / 16][4], const uint8_t* tile,
                                           int warp, int g, int t) {
  using T = Tile<D>;
  const uint32_t rw = warp * 16 + g;
#pragma unroll
  for (int kt = 0; kt < D / 16; ++kt) {
    const int c = 16 * kt + 2 * t;
    a[kt][0] = *reinterpret_cast<const uint32_t*>(tile + T::offset(rw, c));
    a[kt][1] = *reinterpret_cast<const uint32_t*>(tile + T::offset(rw + 8, c));
    a[kt][2] = *reinterpret_cast<const uint32_t*>(tile + T::offset(rw, c + 8));
    a[kt][3] = *reinterpret_cast<const uint32_t*>(tile + T::offset(rw + 8, c + 8));
  }
}

// The same fragments of rows r0 and r1 (= r0 + 8) of a row-major [rows, D]
// bf16 matrix in device memory; rows at or past `rows` read as 0.
template <int D>
__device__ __forceinline__ void load_a_rows(uint32_t (&f)[D / 16][4],
                                            const __nv_bfloat16* base, int r0,
                                            int r1, int rows, int t) {
#pragma unroll
  for (int kt = 0; kt < D / 16; ++kt) {
    const int c = kt * 16 + 2 * t;
    const uint32_t* p0 = reinterpret_cast<const uint32_t*>(base + static_cast<size_t>(r0) * D + c);
    const uint32_t* p1 = reinterpret_cast<const uint32_t*>(base + static_cast<size_t>(r1) * D + c);
    f[kt][0] = r0 < rows ? p0[0] : 0u;
    f[kt][1] = r1 < rows ? p1[0] : 0u;
    f[kt][2] = r0 < rows ? p0[4] : 0u;
    f[kt][3] = r1 < rows ? p1[4] : 0u;
  }
}

// Byte offset of columns 16 kt .. 16 kt + 15 in a tile (its box, and the
// 32 bytes within the box's swizzled rows).
template <int D>
__device__ __forceinline__ uint32_t slice(int kt) {
  using T = Tile<D>;
  return (kt / (T::kBox / 16)) * T::kBoxBytes + (kt % (T::kBox / 16)) * 32;
}

template <int N>
__device__ __forceinline__ void wgmma_rs_abt(float (&acc)[N / 2], const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
  if constexpr (N == 64) wgmma_rs_m64n64<0>(acc, a, desc, accumulate);
  else wgmma_rs_m64n32<0>(acc, a, desc, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_ss_abt(float (&acc)[N / 2], uint64_t desc_a,
                                             uint64_t desc, int accumulate) {
  if constexpr (N == 64) wgmma_ss_m64n64(acc, desc_a, desc, accumulate);
  else wgmma_ss_m64n32(acc, desc_a, desc, accumulate);
}

// acc[64 x N] = A X^T over D / 16 slices, X the N rows of a staged tile from
// address x (B K-major); A from registers (a) or from the tile at a_tile.
template <int D, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 2], const uint32_t (&a)[D / 16][4],
                                        uint32_t x) {
  using T = Tile<D>;
#pragma unroll
  for (int kt = 0; kt < D / 16; ++kt)
    wgmma_rs_abt<N>(acc, a[kt], smem_desc(x + slice<D>(kt), 16, T::kAtomBytes, T::kLayout),
                    kt > 0);
}

template <int D, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 2], uint32_t a_tile, uint32_t x) {
  using T = Tile<D>;
#pragma unroll
  for (int kt = 0; kt < D / 16; ++kt)
    wgmma_ss_abt<N>(acc, smem_desc(a_tile + slice<D>(kt), 16, T::kAtomBytes, T::kLayout),
                    smem_desc(x + slice<D>(kt), 16, T::kAtomBytes, T::kLayout), kt > 0);
}

// acc[64 x D] += A Y, A = kSteps fragments of 16 columns from registers, Y
// the 16 kSteps rows of a staged tile from address y (B MN-major).
template <int D, int kSteps>
__device__ __forceinline__ void mma_ay(float (&acc)[D / 2], const uint32_t (&a)[kSteps][4],
                                       uint32_t y) {
  using T = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    wgmma_pv<D>(acc, a[kk], smem_desc(y + kk * 16 * T::kRowBytes, T::kBoxBytes,
                                      T::kAtomBytes, T::kLayout));
}

// N columns of accumulators as wgmma's register A fragments: columns
// 16 kk .. 16 kk + 15 are the accumulators of column groups 2 kk and
// 2 kk + 1.
template <int N>
__device__ __forceinline__ void pack_frags(uint32_t (&a)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_f32(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_f32(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_f32(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_f32(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// acc * mul as bf16, swizzled into a warpgroup's tile.
template <int D>
__device__ __forceinline__ void store_tile(uint8_t* tile, const float (&acc)[D / 2], float mul,
                                           int warp, int g, int t) {
  using T = Tile<D>;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(tile + T::offset(warp * 16 + g + 8 * h, 8 * j + 2 * t)) =
          pack_f32(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
}

// One warpgroup's tile (tile_s) to device memory at rows row0.. of head bh,
// after its threads wrote it: rows past the map's end are clipped.
template <int D>
__device__ __forceinline__ void tma_store_tile(const CUtensorMap* map, uint32_t tile_s, int row0,
                                               int bh, int wg, int tid) {
  using T = Tile<D>;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  if (tid == 0) {
    for (int c = 0; c < T::kBoxes; ++c) tma_store(map, tile_s + c * T::kBoxBytes, c * T::kBox, row0, bh);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---- dQ -------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads<D>, kDqCtas<D>)
    flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do,
                      const __grid_constant__ CUtensorMap map_dq,
                      const __nv_bfloat16* __restrict__ o, const int32_t* __restrict__ mask,
                      const float* __restrict__ lse, float* __restrict__ delta, int H, int Lq,
                      int Lk, int n_q_tiles, int mask_b_stride, float scale) {
  using T = Tile<D>;
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];  // Q and dO, full[], empty[]
  extern __shared__ __align__(16) uint8_t dyn[];
  const uint32_t raw = smem_u32(dyn);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atoms' alignment
  const uint32_t q_s = base;
  const uint32_t do_s = q_s + kWarpgroups<D> * T::kBytes;
  const uint32_t k_s = do_s + kWarpgroups<D> * T::kBytes;
  const uint32_t v_s = k_s + kStages * T::kBytes;
  const uint32_t q_bar = smem_u32(&bars[0]);
  const uint32_t full0 = smem_u32(&bars[1]), empty0 = smem_u32(&bars[1 + kStages]);

  const int bh = blockIdx.x / n_q_tiles;
  const int q_blk = (blockIdx.x % n_q_tiles) * kBlockRows<D>;
  const int n_k = (Lk + kKeys - 1) / kKeys;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  // Thread 0 issues every load: Q and dO of its warpgroups once, and K/V
  // tiles into the ring.
  const bool issuer = threadIdx.x == 0;
  auto load_kv = [&](int it) {
    const int s = it % kStages;
    mbar_expect_tx(full0 + 8 * s, 2 * T::kBytes);
    for (int c = 0; c < T::kBoxes; ++c) {
      tma_load(k_s + s * T::kBytes + c * T::kBoxBytes, &map_k, full0 + 8 * s, c * T::kBox,
               it * kKeys, bh);
      tma_load(v_s + s * T::kBytes + c * T::kBoxBytes, &map_v, full0 + 8 * s, c * T::kBox,
               it * kKeys, bh);
    }
  };
  if (issuer) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kThreads<D>);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(q_bar, 2 * kWarpgroups<D> * T::kBytes);
    for (int w = 0; w < kWarpgroups<D>; ++w)
      for (int c = 0; c < T::kBoxes; ++c) {
        tma_load(q_s + w * T::kBytes + c * T::kBoxBytes, &map_q, q_bar, c * T::kBox,
                 q_blk + w * kRows, bh);
        tma_load(do_s + w * T::kBytes + c * T::kBoxBytes, &map_do, q_bar, c * T::kBox,
                 q_blk + w * kRows, bh);
      }
    for (int it = 0; it < kStages && it < n_k; ++it) load_kv(it);
  }
  __syncthreads();
  auto refill = [&](int it) {
    const int j = it - kLag;
    if (issuer && j >= 0 && j + kStages < n_k) {
      mbar_wait(empty0 + 8 * (j % kStages), (j / kStages) & 1);
      load_kv(j + kStages);
    }
    __syncwarp();
  };

  const int q_wg = q_blk + wg * kRows;
  const int r0 = q_wg + warp * 16 + g, r1 = r0 + 8;  // this lane's two rows
  const uint32_t my_q = q_s + wg * T::kBytes, my_do = do_s + wg * T::kBytes;
  uint8_t* my_q_ptr = dyn + (my_q - raw);
  const uint8_t* my_do_ptr = dyn + (my_do - raw);
  const int32_t* mrow = mask + static_cast<size_t>(bh / H) * mask_b_stride;
  // lse of this lane's rows in log2 units; +inf past Lq makes their p 0.
  const float* lh = lse + static_cast<size_t>(bh) * Lq;
  const float lse2[2] = {r0 < Lq ? lh[r0] * kLog2e : INFINITY,
                         r1 < Lq ? lh[r1] * kLog2e : INFINITY};
  const float mul = scale * kLog2e;

  // The key mask a tile ahead, and a tile's keep bits (bit 8j + e is this
  // lane's column 8j + 2t + e), as the forward reads them.
  int32_t keep_raw[2];
  auto keep_load = [&](int k0) {
    const int ka = k0 + lane, kb = ka + 32;
    keep_raw[0] = ka < Lk ? mrow[ka] : 0;
    keep_raw[1] = kb < Lk ? mrow[kb] : 0;
  };
  auto next_keep = [&](int it) {
    const uint32_t lo = __ballot_sync(0xffffffffu, keep_raw[0] > 0);
    const uint32_t hi = __ballot_sync(0xffffffffu, keep_raw[1] > 0);
    if (it + 1 < n_k) keep_load((it + 1) * kKeys);
    return (static_cast<uint64_t>(hi) << 32 | lo) >> (2 * t);
  };
  keep_load(0);

  // delta = rowsum(dO * O) of this lane's rows: dO from its tile, O from
  // device memory in the same fragment layout (rows past Lq read as 0).
  mbar_wait(q_bar, 0);
  uint32_t qa[kARegs<D> ? D / 16 : 1][4], da[D / 16][4], oa[D / 16][4];
  load_frags<D>(da, my_do_ptr, warp, g, t);
  load_a_rows<D>(oa, o + static_cast<size_t>(bh) * Lq * D, r0, r1, Lq, t);
  float dl[2] = {0.f, 0.f};
#pragma unroll
  for (int kt = 0; kt < D / 16; ++kt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&da[kt][i]));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&oa[kt][i]));
      dl[i & 1] = fmaf(x.x, y.x, fmaf(x.y, y.y, dl[i & 1]));
    }
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {  // the 4 lanes holding a row
    dl[0] += __shfl_xor_sync(0xffffffffu, dl[0], off);
    dl[1] += __shfl_xor_sync(0xffffffffu, dl[1], off);
  }
  if (t == 0) {
    float* dh = delta + static_cast<size_t>(bh) * Lq;
    if (r0 < Lq) dh[r0] = dl[0];
    if (r1 < Lq) dh[r1] = dl[1];
  }
  if constexpr (kARegs<D>) load_frags<D>(qa, my_q_ptr, warp, g, t);

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  float s[32], dp[32];  // s[4j + 2h + e]: row r_h, key 8j + 2t + e of the tile
  uint32_t dsa[4][4];   // bf16(ds) as register A fragments, 16 keys each

  // S = Q K^T and dP = dO V^T of stage st.
  auto issue_sdp = [&](int st) {
    wgmma_fence();
    if constexpr (kARegs<D>) {
      mma_abt<D, 64>(s, qa, k_s + st * T::kBytes);
      mma_abt<D, 64>(dp, da, v_s + st * T::kBytes);
    } else {
      mma_abt<D, 64>(s, my_q, k_s + st * T::kBytes);
      mma_abt<D, 64>(dp, my_do, v_s + st * T::kBytes);
    }
    wgmma_commit();
  };
  // dQ += bf16(ds) K of stage st.
  auto issue_dq = [&](int st) {
    mma_ay<D, 4>(dq, dsa, k_s + st * T::kBytes);
    wgmma_commit();
  };
  // ds = p * (dP - delta) into s, p = keep ? exp(min(s scale - lse, 80)) : 0.
  auto grad = [&](uint64_t keep) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + e;
          const float p = (keep >> (8 * j + e)) & 1
                              ? ex2(fminf(fmaf(s[i], mul, -lse2[h]), kExpCap)) : 0.f;
          s[i] = p * (dp[i] - dl[h]);
        }
  };

  // Tile 0 alone; then each step issues S and dP of tile it with dQ of tile
  // it - 1 and computes tile it's ds while dQ's product runs.
  uint64_t keep = next_keep(0);
  mbar_wait(full0, 0);
  issue_sdp(0);
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  grad(keep);
  pack_frags<64>(dsa, s);
  for (int it = 1; it < n_k; ++it) {
    const int st = it % kStages, prev = (it - 1) % kStages;
    refill(it);
    keep = next_keep(it);
    mbar_wait(full0 + 8 * st, (it / kStages) & 1);
    fence_regs(dq);
    issue_sdp(st);  // its wgmma.fence also orders the writes of dsa
    issue_dq(prev);
    wgmma_wait<1>();  // S and dP are done, dQ's product may still run
    fence_regs(s);
    fence_regs(dp);
    grad(keep);
    wgmma_wait<0>();
    fence_regs(dq);
    mbar_arrive(empty0 + 8 * prev);
    pack_frags<64>(dsa, s);
  }
  fence_regs(dq);
  wgmma_fence();
  issue_dq((n_k - 1) % kStages);
  wgmma_wait<0>();
  fence_regs(dq);

  // dQ = scale * dq in bf16 through this warpgroup's Q tile, whose last
  // reader has finished.
  store_tile<D>(my_q_ptr, dq, scale, warp, g, t);
  if (q_wg < Lq) tma_store_tile<D>(&map_dq, my_q, q_wg, bh, wg, tid);
}

// ---- dK/dV ----------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads<D>, kDkvCtas<D>)
    flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_do,
                       const __grid_constant__ CUtensorMap map_dk,
                       const __grid_constant__ CUtensorMap map_dv,
                       const int32_t* __restrict__ mask, const float* __restrict__ lse,
                       const float* __restrict__ delta, int H, int Lq, int Lk, int n_k_tiles,
                       int mask_b_stride, float scale) {
  using T = Tile<D>;
  constexpr int kN = D <= 64 ? 64 : 32;  // query columns per step
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];  // K and V, full[], empty[]
  // Per warp: lse (log2 units) and delta of the current query tile.
  __shared__ __align__(16) float cols_s[kThreads<D> / 32][2 * kKeys];
  extern __shared__ __align__(16) uint8_t dyn[];
  const uint32_t raw = smem_u32(dyn);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base;
  const uint32_t v_s = k_s + kWarpgroups<D> * T::kBytes;
  const uint32_t q_s = v_s + kWarpgroups<D> * T::kBytes;
  const uint32_t do_s = q_s + kStages * T::kBytes;
  const uint32_t kv_bar = smem_u32(&bars[0]);
  const uint32_t full0 = smem_u32(&bars[1]), empty0 = smem_u32(&bars[1 + kStages]);

  const int bh = blockIdx.x / n_k_tiles;
  const int k_blk = (blockIdx.x % n_k_tiles) * kBlockRows<D>;
  const int n_q = (Lq + kRows - 1) / kRows;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  const bool issuer = threadIdx.x == 0;
  auto load_qdo = [&](int it) {
    const int s = it % kStages;
    mbar_expect_tx(full0 + 8 * s, 2 * T::kBytes);
    for (int c = 0; c < T::kBoxes; ++c) {
      tma_load(q_s + s * T::kBytes + c * T::kBoxBytes, &map_q, full0 + 8 * s, c * T::kBox,
               it * kRows, bh);
      tma_load(do_s + s * T::kBytes + c * T::kBoxBytes, &map_do, full0 + 8 * s, c * T::kBox,
               it * kRows, bh);
    }
  };
  if (issuer) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kThreads<D>);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(kv_bar, 2 * kWarpgroups<D> * T::kBytes);
    for (int w = 0; w < kWarpgroups<D>; ++w)
      for (int c = 0; c < T::kBoxes; ++c) {
        tma_load(k_s + w * T::kBytes + c * T::kBoxBytes, &map_k, kv_bar, c * T::kBox,
                 k_blk + w * kRows, bh);
        tma_load(v_s + w * T::kBytes + c * T::kBoxBytes, &map_v, kv_bar, c * T::kBox,
                 k_blk + w * kRows, bh);
      }
    for (int it = 0; it < kStages && it < n_q; ++it) load_qdo(it);
  }
  __syncthreads();
  auto refill = [&](int it) {
    const int j = it - kLag;
    if (issuer && j >= 0 && j + kStages < n_q) {
      mbar_wait(empty0 + 8 * (j % kStages), (j / kStages) & 1);
      load_qdo(j + kStages);
    }
    __syncwarp();
  };

  const int k_wg = k_blk + wg * kRows;
  const int r0 = k_wg + warp * 16 + g, r1 = r0 + 8;  // this lane's two keys
  const uint32_t my_k = k_s + wg * T::kBytes, my_v = v_s + wg * T::kBytes;
  uint8_t* my_k_ptr = dyn + (my_k - raw);
  uint8_t* my_v_ptr = dyn + (my_v - raw);
  const int32_t* mrow = mask + static_cast<size_t>(bh / H) * mask_b_stride;
  const bool keep[2] = {r0 < Lk && mrow[r0] > 0, r1 < Lk && mrow[r1] > 0};
  const float mul = scale * kLog2e;

  // lse and delta of query rows q0 + lane and q0 + lane + 32, loaded a tile
  // ahead of their use; query rows past Lq take lse = +inf (p = 0).
  const float* lh = lse + static_cast<size_t>(bh) * Lq;
  const float* dh = delta + static_cast<size_t>(bh) * Lq;
  float next_l[2], next_d[2];
  auto cols_load = [&](int q0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + lane + 32 * i;
      next_l[i] = qi < Lq ? lh[qi] * kLog2e : INFINITY;
      next_d[i] = qi < Lq ? dh[qi] : 0.f;
    }
  };
  float* my_cols = cols_s[threadIdx.x / 32];
  auto cols_stage = [&]() {
    __syncwarp();  // every lane has read the previous tile's
    my_cols[lane] = next_l[0];
    my_cols[lane + 32] = next_l[1];
    my_cols[kKeys + lane] = next_d[0];
    my_cols[kKeys + lane + 32] = next_d[1];
    __syncwarp();
  };
  cols_load(0);

  mbar_wait(kv_bar, 0);
  uint32_t ka[kARegs<D> ? D / 16 : 1][4], va[kARegs<D> ? D / 16 : 1][4];
  if constexpr (kARegs<D>) {
    load_frags<D>(ka, my_k_ptr, warp, g, t);
    load_frags<D>(va, my_v_ptr, warp, g, t);
  }

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  float s[kN / 2], dp[kN / 2];  // s[4j + 2h + e]: key r_h, query column 8j + 2t + e of the step
  uint32_t pa[kN / 16][4], dsa[kN / 16][4];

  for (int it = 0; it < n_q; ++it) {
    const int st = it % kStages;
    const uint32_t q_t = q_s + st * T::kBytes, do_t = do_s + st * T::kBytes;
    refill(it);
    cols_stage();
    if (it + 1 < n_q) cols_load((it + 1) * kRows);
    mbar_wait(full0 + 8 * st, (it / kStages) & 1);
#pragma unroll
    for (int n0 = 0; n0 < kRows; n0 += kN) {
      // S^T = K Q^T and dP^T = V dO^T of query columns n0 .. n0 + kN - 1.
      wgmma_fence();
      if constexpr (kARegs<D>) {
        mma_abt<D, kN>(s, ka, q_t + n0 * T::kRowBytes);
        mma_abt<D, kN>(dp, va, do_t + n0 * T::kRowBytes);
      } else {
        mma_abt<D, kN>(s, my_k, q_t + n0 * T::kRowBytes);
        mma_abt<D, kN>(dp, my_v, do_t + n0 * T::kRowBytes);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      // p^T and ds^T = p^T * (dP^T - delta) in place.
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int c = n0 + 8 * j + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(my_cols + c);
        const float2 d2 = *reinterpret_cast<const float2*>(my_cols + kKeys + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h;
          const float p0 = keep[h] ? ex2(fminf(fmaf(s[i], mul, -l2.x), kExpCap)) : 0.f;
          const float p1 = keep[h] ? ex2(fminf(fmaf(s[i + 1], mul, -l2.y), kExpCap)) : 0.f;
          s[i] = p0;
          s[i + 1] = p1;
          dp[i] = p0 * (dp[i] - d2.x);
          dp[i + 1] = p1 * (dp[i + 1] - d2.y);
        }
      }
      pack_frags<kN>(pa, s);
      pack_frags<kN>(dsa, dp);
      // dV += bf16(p^T) dO and dK += bf16(ds^T) Q over the step's rows.
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
      mma_ay<D, kN / 16>(dv, pa, do_t + n0 * T::kRowBytes);
      mma_ay<D, kN / 16>(dk, dsa, q_t + n0 * T::kRowBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
    }
    mbar_arrive(empty0 + 8 * st);
  }

  // dK = scale * dk and dV in bf16 through this warpgroup's K and V tiles.
  store_tile<D>(my_k_ptr, dk, scale, warp, g, t);
  store_tile<D>(my_v_ptr, dv, 1.f, warp, g, t);
  if (k_wg < Lk) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (tid == 0) {
      for (int c = 0; c < T::kBoxes; ++c) {
        tma_store(&map_dk, my_k + c * T::kBoxBytes, c * T::kBox, k_wg, bh);
        tma_store(&map_dv, my_v + c * T::kBoxBytes, c * T::kBox, k_wg, bh);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// ---- host side ------------------------------------------------------------------

template <int D>
constexpr size_t smem_bytes() {
  return 1024 + static_cast<size_t>(2 * kWarpgroups<D> + 2 * kStages) * Tile<D>::kBytes;
}

// Above 48 KB of shared memory only after opting in, once per device and
// kernel.
template <typename Kernel>
int opt_in(Kernel kernel, size_t bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  if (const cudaError_t err = cudaGetDevice(&dev)) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    if (const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)))
      return err;
    done[dev] = true;
  }
  return 0;
}

// q, dout, o, dq: bf16 [B*H, Lq, D]; k, v: [B*H, Lk, D]; lse, delta (out):
// f32 [B*H, Lq].
template <int D>
int launch_dq(const void* q, const void* k, const void* v, const int32_t* mask,
              const void* dout, const void* o, const float* lse, float* delta, void* dq, int B,
              int H, int Lq, int Lk, int mask_b_stride, float scale, cudaStream_t stream) {
  EncodeTiledFn encode;
  if (const int err = encode_tiled_fn(&encode)) return err;
  CUtensorMap maps[5];
  const void* ptrs[5] = {q, k, v, dout, dq};
  const int rows[5] = {Lq, Lk, Lk, Lq, Lq};
  for (int i = 0; i < 5; ++i)
    if (const int err = encode_map<D>(encode, &maps[i], ptrs[i], B * H, rows[i])) return err;
  auto kernel = flash_bwd_dq_sm90<D>;
  static bool opted_in[kMaxDevices] = {};
  if (const int err = opt_in(kernel, smem_bytes<D>(), opted_in)) return err;
  const int n_q = (Lq + kBlockRows<D> - 1) / kBlockRows<D>;
  kernel<<<static_cast<unsigned>(n_q) * B * H, kThreads<D>, smem_bytes<D>(), stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], static_cast<const __nv_bfloat16*>(o), mask,
      lse, delta, H, Lq, Lk, n_q, mask_b_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

// dk, dv: bf16 [B*H, Lk, D]; delta: the dQ kernel's.
template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const int32_t* mask,
               const void* dout, const float* lse, const float* delta, void* dk, void* dv,
               int B, int H, int Lq, int Lk, int mask_b_stride, float scale,
               cudaStream_t stream) {
  EncodeTiledFn encode;
  if (const int err = encode_tiled_fn(&encode)) return err;
  CUtensorMap maps[6];
  const void* ptrs[6] = {k, v, q, dout, dk, dv};
  const int rows[6] = {Lk, Lk, Lq, Lq, Lk, Lk};
  for (int i = 0; i < 6; ++i)
    if (const int err = encode_map<D>(encode, &maps[i], ptrs[i], B * H, rows[i])) return err;
  auto kernel = flash_bwd_dkv_sm90<D>;
  static bool opted_in[kMaxDevices] = {};
  if (const int err = opt_in(kernel, smem_bytes<D>(), opted_in)) return err;
  const int n_k = (Lk + kBlockRows<D> - 1) / kBlockRows<D>;
  kernel<<<static_cast<unsigned>(n_k) * B * H, kThreads<D>, smem_bytes<D>(), stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], mask, lse, delta, H, Lq, Lk, n_k,
      mask_b_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd
}  // namespace sm90
}  // namespace
