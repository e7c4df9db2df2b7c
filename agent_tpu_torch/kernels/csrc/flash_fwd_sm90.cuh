// Flash attention forward for Hopper with TMA and wgmma (sm_90a): every
// bf16 forward of the port, one template for the four Pallas bodies.
//
// Part of flash_attention.cu's translation unit, included after its kNegInf,
// kMaxBiasDistance and rel_bias_at; the TMA, mbarrier and wgmma primitives
// are sm90_common.cuh's. Template flash_fwd_sm90<D, WriteLse, CarryState,
// RelBias> for D in {32, 64, 128}, with at most one flag set:
// - none: the serving forward, replacing the Pallas kernel `_flash_kernel`
//   (agent_tpu/kernels/flash_attention.py:149, pallas_call :228): softmax
//   attention with a key-padding mask, out = acc / max(l, 1e-30) in bf16.
// - CarryState replaces the ring hop `_flash_fold_kernel` (:258,
//   pallas_call :329): each query row starts from its carried f32 (m, l,
//   acc) instead of (NEG_INF, 0, 0), folds the K/V block in with the same
//   per-tile update, and writes (m, l, acc) back unnormalised, in place.
// - WriteLse replaces the training forward `_flash_fwd_lse_kernel` (:598,
//   pallas_call :719): the serving forward that also stores each query
//   row's lse = m + log(max(l, 1e-30)) in f32.
// - RelBias replaces `_flash_t5_kernel` (:354, pallas_call :467): s = q.k *
//   scale + bias[h, clamp(k - q, -maxd, maxd) + maxd] before the mask, from
//   the per-distance table that flash_attention.cu describes.
// All compute what their plain versions in kernels/flash_attention.py
// compute: 64-key tiles, the online softmax in f32 with the running max and
// the 1e-30 floor, masked scores NEG_INF with p multiplied by keep (a fully
// masked row is exactly 0, a wholly masked block leaves a carried state
// bit for bit as it was: its p are 0 and its correction ex2(0) = 1), P
// rounded to bf16 against the tile's running max. Only the exponential
// differs: exp(x) is ex2.approx of x * log2(e) on the MUFU (relative error
// ~2^-22, far below bf16's rounding of P); m stays in natural units and is
// scaled by log2(e) only where it is used, so a carried m is written back
// exactly as read when no key raises it.
//
// Bounds on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16), each input read once
// and each output written once, products counted over the real keys:
// - serving, the 256-row BERT-base request (B 256, H 12, L 512, D 64): Q, K,
//   V and O, 805 MB, 0.240 ms; the products take less.
// - training (B 128, H 12, L 512, D 64): 403 MB, 0.121 ms; T5-large's
//   encoder (B 64, H 16, L 512, D 64): 268 MB, 0.080 ms.
// - the ring hop at phase 5b's shard (B 8, H 4, Lq = Lk = 2048, D 128):
//   5.4e10 FLOP over the real keys, 0.0545 ms, against 118.5 MB (Q, K, V in
//   bf16, acc in and out in f32, m and l in and out), 0.035 ms: the
//   products bound it.
// The forwards' products (~255 FLOP per byte) sit just under the card's
// ridge, so the kernel has to keep the loads in flight and the tensor cores
// fed at once. What the design does about it:
// - One block owns 128 query rows of one head: two warpgroups of 64 rows
//   share every K/V tile, so K and V cross device memory once per 128 query
//   rows (L2 serves the other query tiles of the head). Two blocks share a
//   multiprocessor at D <= 64 (128 registers a thread), so one block's
//   start and end run under the other's main loop; one at D 128.
// - Thread 0 issues every load with TMA: Q once and K/V tiles into a ring
//   of kStages stages, through 3-D tensor maps [B*H, L, D] whose hardware
//   zero-fill ends each head at its own Lq or Lk. Full and empty mbarriers
//   pace the ring; a stage is refilled kLag tiles after its use, when the
//   other warpgroup has given it back too, so the refill rarely waits and
//   the next tiles are always in flight. The key mask is read a tile ahead.
// - S = Q K^T is wgmma m64n64k16 with Q from registers (loaded once) and K
//   from shared memory (stored [keys, D], K-major); O += P V is wgmma
//   m64nDk16 with P from registers (the S accumulators converted to bf16
//   pairs) and V read transposed (MN-major) from shared memory. Each tile
//   issues its S with the previous tile's P V and runs its softmax while P V
//   is in flight. Tiles use the 128-byte swizzle (64-byte at D 32, whose
//   rows are 64 bytes); a D 128 tile is two boxes of 64 columns.
// - The T5 bias row lives in shared memory; a warpgroup whose 64 rows x 64
//   keys all lie beyond +max_distance or below -max_distance adds the
//   saturated entry, one value a head, instead of looking it up per score
//   (t5_constant_bias_index in kernels/flash_attention.py is the same rule).
// - The epilogue normalises O in registers, writes it swizzled into the
//   warpgroup's Q tile (no longer read) and stores it with TMA, which clips
//   rows past Lq; one lane per row stores lse.
// - The fold reads its rows' state into the O accumulators' fragment layout
//   before the first tile (float2 loads, in flight under the Q wait and tile
//   0's S) and corrects it by tile 0's exp(m_old - m_new) before tile 0's
//   P V, as every later tile corrects O. It writes the state back from the
//   same registers with float2 stores: a quad of lanes covers 32 contiguous
//   bytes of a row, so every sector is written whole, and the f32 tile needs
//   no staging in shared memory (64 KB more at D 128, beside the 161 KB the
//   ring and Q take). The state is [B, H, Lq, 1|D] and contiguous, so row Lq
//   of one head is row 0 of the next: every state load and store is guarded
//   by row < Lq, so a block whose 128 rows run past Lq touches no other
//   head's rows, and each block reads its own rows before it writes them.
// Not yet: persistent blocks, a producer warp with the two warpgroups
// taking turns on the tensor cores, and TMA reading Q/K/V straight from
// the projections' [B, L, H*D] layout.
#pragma once

#include <type_traits>

#include "sm90_common.cuh"

namespace {
namespace sm90 {

constexpr int kWarpgroups = 2;   // per block
constexpr int kBlockRows = kRows * kWarpgroups;
constexpr int kStages = 4;       // K/V ring depth
// Tile it refills the stage of tile it - kLag, which both warpgroups gave
// back by the end of tile it - kLag + 1, with tile it - kLag + kStages.
constexpr int kLag = 2;
static_assert(kLag >= 2 && kLag < kStages, "a refill waits for a stage given back a tile ago");
constexpr int kThreads = 128 * kWarpgroups;

// Blocks a multiprocessor holds: two at D <= 64 (128 registers a thread),
// one at D 128, whose O accumulators alone take 64.
template <int D>
constexpr int kCtas = D <= 64 ? 2 : 1;

// ---- the kernel -----------------------------------------------------------------

template <int D, bool WriteLse, bool CarryState, bool RelBias>
__global__ void __launch_bounds__(kThreads, kCtas<D>)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_o,
                   const int32_t* __restrict__ mask, float* __restrict__ lse, int H, int Lq,
                   int Lk, int n_q_tiles, int mask_b_stride, float scale,
                   const float* __restrict__ dist_bias, int max_distance,
                   float* __restrict__ st_m, float* __restrict__ st_l,
                   float* __restrict__ st_acc) {
  static_assert(WriteLse + CarryState + RelBias <= 1, "one variant at a time");
  using T = Tile<D>;
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];  // Q, full[], empty[]
  extern __shared__ __align__(16) uint8_t dyn[];
  // The swizzle atoms need 1024-byte alignment: round the window up.
  const uint32_t raw = smem_u32(dyn);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + kWarpgroups * T::kBytes;
  const uint32_t v_s = k_s + kStages * T::kBytes;
  float* bias_s = reinterpret_cast<float*>(dyn + (v_s + kStages * T::kBytes - raw));
  const uint32_t q_bar = smem_u32(&bars[0]);
  const uint32_t full0 = smem_u32(&bars[1]), empty0 = smem_u32(&bars[1 + kStages]);

  const int bh = blockIdx.x / n_q_tiles;
  const int q_blk = (blockIdx.x % n_q_tiles) * kBlockRows;
  const int n_k = (Lk + kKeys - 1) / kKeys;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  // Thread 0 issues every load. It sets up the barriers and at once asks for
  // Q and the first kStages tiles; meanwhile the block stages T5's bias row.
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
      mbar_init(empty0 + 8 * s, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(q_bar, kWarpgroups * T::kBytes);
    for (int w = 0; w < kWarpgroups; ++w)
      for (int c = 0; c < T::kBoxes; ++c)
        tma_load(q_s + w * T::kBytes + c * T::kBoxBytes, &map_q, q_bar, c * T::kBox,
                 q_blk + w * kRows, bh);
    for (int it = 0; it < kStages && it < n_k; ++it) load_kv(it);  // the ring starts empty
  }
  if constexpr (RelBias) {
    const int n = 2 * max_distance + 1;
    const float* row = dist_bias + static_cast<size_t>(bh % H) * n;
    for (int i = threadIdx.x; i < n; i += kThreads) bias_s[i] = row[i];
  }
  __syncthreads();
  // At the start of tile it: the stage of tile it - kLag gets tile it - kLag
  // + kStages, once both warpgroups have given it back.
  auto refill = [&](int it) {
    const int j = it - kLag;
    if (issuer && j >= 0 && j + kStages < n_k) {
      mbar_wait(empty0 + 8 * (j % kStages), (j / kStages) & 1);
      load_kv(j + kStages);
    }
    __syncwarp();
  };

  // ---- two warpgroups of 64 query rows each ----
  const int q_wg = q_blk + wg * kRows;
  const int r0 = q_wg + warp * 16 + g, r1 = r0 + 8;  // this lane's two rows
  const uint32_t my_q = q_s + wg * T::kBytes;
  uint8_t* my_q_ptr = dyn + (my_q - raw);
  const int32_t* mrow = mask + static_cast<size_t>(bh / H) * mask_b_stride;

  float o[D / 2];  // o[4j + 2h + e] is row r_h, column 8j + 2t + e
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  if constexpr (CarryState) {  // the carried state of this lane's rows below Lq
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? r1 : r0;
      if (r >= Lq) continue;
      const size_t row = static_cast<size_t>(bh) * Lq + r;
      m[h] = st_m[row];
      l[h] = st_l[row];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float2 a = *reinterpret_cast<const float2*>(st_acc + row * D + 8 * j + 2 * t);
        o[4 * j + 2 * h] = a.x;
        o[4 * j + 2 * h + 1] = a.y;
      }
    }
  }
  float sc[32];       // S, then P, of one tile: sc[4j + 2h + e] is row r_h, column 8j + 2t + e
  uint32_t pa[4][4];  // bf16(P) as wgmma's register A fragments, 16 keys each

  // The mask of keys k0 + lane and k0 + lane + 32, loaded a tile ahead of
  // its use; then the tile's keep bits, shifted so that bit 8j + e is this
  // lane's column 8j + 2t + e, and whether the tile keeps every key.
  int32_t keep_raw[2];
  auto keep_load = [&](int k0) {
    const int ka = k0 + lane, kb = ka + 32;
    keep_raw[0] = ka < Lk ? mrow[ka] : 0;
    keep_raw[1] = kb < Lk ? mrow[kb] : 0;
  };
  auto keep_bits = [&](uint64_t& keep, bool& every) {
    const uint32_t lo = __ballot_sync(0xffffffffu, keep_raw[0] > 0);
    const uint32_t hi = __ballot_sync(0xffffffffu, keep_raw[1] > 0);
    every = (lo & hi) == 0xffffffffu;
    keep = (static_cast<uint64_t>(hi) << 32 | lo) >> (2 * t);
  };
  // Tile it's keep bits; the next tile's mask is loaded meanwhile.
  auto next_keep = [&](int it, uint64_t& keep, bool& every) {
    keep_bits(keep, every);
    if (it + 1 < n_k) keep_load((it + 1) * kKeys);
  };
  // This warpgroup's Q rows as wgmma's register A fragments, one per 16
  // columns: [0] row g, columns 2t, 2t + 1; [1] row g + 8; [2], [3] the
  // same rows 8 columns on.
  uint32_t qa[D / 16][4];
  auto load_q = [&]() {
    const uint32_t rw = warp * 16 + g;
#pragma unroll
    for (int kt = 0; kt < D / 16; ++kt) {
      const int c = 16 * kt + 2 * t;
      qa[kt][0] = *reinterpret_cast<const uint32_t*>(my_q_ptr + T::offset(rw, c));
      qa[kt][1] = *reinterpret_cast<const uint32_t*>(my_q_ptr + T::offset(rw + 8, c));
      qa[kt][2] = *reinterpret_cast<const uint32_t*>(my_q_ptr + T::offset(rw, c + 8));
      qa[kt][3] = *reinterpret_cast<const uint32_t*>(my_q_ptr + T::offset(rw + 8, c + 8));
    }
  };
  // S = Q K^T of stage s, over D / 16 slices of 16 columns.
  auto issue_s = [&](int s) {
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < D / 16; ++kt) {
      const uint32_t col = (kt / (T::kBox / 16)) * T::kBoxBytes + (kt % (T::kBox / 16)) * 32;
      const uint64_t desc_k =
          smem_desc(k_s + s * T::kBytes + col, 16, T::kAtomBytes, T::kLayout);
      wgmma_rs_m64n64<0>(sc, qa[kt], desc_k, kt > 0);
    }
    wgmma_commit();
  };
  // O += bf16(P) V of stage s.
  auto issue_pv = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<D>(o, pa[kk],
                  smem_desc(v_s + s * T::kBytes + kk * 16 * T::kRowBytes, T::kBoxBytes,
                            T::kAtomBytes, T::kLayout));
    wgmma_commit();
  };
  // Softmax of tile k0, whose q.k are in sc: the scores (scaled, biased,
  // masked), their row maxima, p in place, the running (m, l) and the
  // correction that O still needs.
  auto softmax = [&](int k0, uint64_t keep, bool every, float (&corr)[2]) {
    float mx[2];
    auto fold = [&](auto masked, auto bias_of) {
      constexpr bool kMasked = decltype(masked)::value;
      if constexpr (RelBias) {
        // s = q.k * scale + bias, two rounded operations as the plain
        // version; masked scores NEG_INF.
        mx[0] = m[0];
        mx[1] = m[1];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float& x = sc[4 * j + 2 * h + e];
              x = __fadd_rn(__fmul_rn(x, scale), bias_of(h, 8 * j + e));
              if constexpr (kMasked) x = (keep >> (8 * j + e)) & 1 ? x : kNegInf;
              mx[h] = fmaxf(mx[h], x);
            }
#pragma unroll
        for (int off = 1; off < 4; off *= 2) {  // the 4 lanes holding a row
          mx[0] = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], off));
          mx[1] = fmaxf(mx[1], __shfl_xor_sync(0xffffffffu, mx[1], off));
        }
      } else {
        // The max of the kept q.k, scaled once: rounding is monotonic, so
        // it is the max of the rounded scores; masked scores are NEG_INF,
        // never above the running max.
        float top[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float x = sc[4 * j + 2 * h + e];
              top[h] = fmaxf(top[h], !kMasked || (keep >> (8 * j + e)) & 1 ? x : -INFINITY);
            }
#pragma unroll
        for (int off = 1; off < 4; off *= 2) {
          top[0] = fmaxf(top[0], __shfl_xor_sync(0xffffffffu, top[0], off));
          top[1] = fmaxf(top[1], __shfl_xor_sync(0xffffffffu, top[1], off));
        }
        mx[0] = fmaxf(m[0], top[0] * scale);
        mx[1] = fmaxf(m[1], top[1] * scale);
      }
      // p = exp(s - mx) = 2^(s log2 e - mx log2 e); masked p = 0.
      const float mul = RelBias ? kLog2e : scale * kLog2e;
      const float sub[2] = {mx[0] * kLog2e, mx[1] * kLog2e};
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float& x = sc[4 * j + 2 * h + e];
            x = ex2(fmaf(x, mul, -sub[h]));
            if constexpr (kMasked) x = (keep >> (8 * j + e)) & 1 ? x : 0.f;
            rs[h] += x;
          }
#pragma unroll
      for (int off = 1; off < 4; off *= 2) {
        rs[0] += __shfl_xor_sync(0xffffffffu, rs[0], off);
        rs[1] += __shfl_xor_sync(0xffffffffu, rs[1], off);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        corr[h] = ex2((m[h] - mx[h]) * kLog2e);
        l[h] = l[h] * corr[h] + rs[h];
        m[h] = mx[h];
      }
    };
    auto with_bias = [&](auto bias_of) {
      if (every) fold(std::false_type{}, bias_of);
      else fold(std::true_type{}, bias_of);
    };
    if constexpr (RelBias) {
      // The warpgroup's 64 x 64 tile: all beyond +-max_distance (one
      // value), all within (no clamp), or both.
      const int rel_lo = k0 - (q_wg + kRows - 1), rel_hi = k0 + kKeys - 1 - q_wg;
      if (rel_lo >= max_distance || rel_hi <= -max_distance) {
        const float c = bias_s[rel_lo >= max_distance ? 2 * max_distance : 0];
        with_bias([c](int, int) { return c; });
      } else if (rel_lo >= -max_distance && rel_hi <= max_distance) {
        const float* row[2] = {bias_s + (k0 + 2 * t - r0 + max_distance),
                               bias_s + (k0 + 2 * t - r1 + max_distance)};
        with_bias([row](int h, int col) { return row[h][col]; });
      } else {
        const int rel[2] = {k0 + 2 * t - r0, k0 + 2 * t - r1};
        with_bias([bias_s, rel, max_distance](int h, int col) {
          return rel_bias_at(bias_s, rel[h] + col, max_distance);
        });
      }
    } else {
      with_bias([](int, int) { return 0.f; });
    }
  };
  // O by the correction of its rows.
  auto rescale = [&](const float (&c)[2]) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 0] *= c[0];
      o[4 * j + 1] *= c[0];
      o[4 * j + 2] *= c[1];
      o[4 * j + 3] *= c[1];
    }
  };
  // keys 16kk..16kk+15 of P are the accumulators of column groups 2kk
  // and 2kk + 1, exactly wgmma's register A fragment.
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_f32(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_f32(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_f32(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_f32(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };

  // Tile 0 alone; then each step issues S of tile it and P V of tile
  // it - 1 together and runs tile it's softmax while P V is in flight.
  uint64_t keep;
  bool every;
  float corr[2];
  keep_load(0);
  mbar_wait(q_bar, 0);
  load_q();
  next_keep(0, keep, every);
  mbar_wait(full0, 0);
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(0, keep, every, corr);
  // A fresh O is 0; a carried one takes tile 0's correction before tile 0's
  // P V, as later tiles correct O below.
  if constexpr (CarryState) rescale(corr);
  pack_p();
  for (int it = 1; it < n_k; ++it) {
    const int s = it % kStages, prev = (it - 1) % kStages;
    refill(it);
    next_keep(it, keep, every);
    mbar_wait(full0 + 8 * s, (it / kStages) & 1);
    fence_regs(o);
    issue_s(s);  // its wgmma.fence also orders the writes of pa and o
    issue_pv(prev);
    wgmma_wait<1>();  // S is done, P V may still run
    fence_regs(sc);
    softmax(it * kKeys, keep, every, corr);
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(empty0 + 8 * prev);
    rescale(corr);  // by exp(m_old - m_new), once the previous P V is in O
    pack_p();
  }
  fence_regs(o);
  wgmma_fence();
  issue_pv((n_k - 1) % kStages);
  wgmma_wait<0>();
  fence_regs(o);

  if constexpr (CarryState) {
    // The state back in place, unnormalised; m and l from one lane of the
    // four that hold a row, once all four have read them. The rows and
    // pointers pass through an empty asm, so the stores' addresses are
    // computed here: kept from the prologue, they would hold registers
    // through the main loop.
    __syncwarp();
    int rows[2] = {r0, r1};
    float *sm = st_m, *sl = st_l, *sa = st_acc;
    asm volatile("" : "+r"(rows[0]), "+r"(rows[1]), "+l"(sm), "+l"(sl), "+l"(sa));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rows[h] >= Lq) continue;
      const size_t row = static_cast<size_t>(bh) * Lq + rows[h];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(sa + row * D + 8 * j + 2 * t) =
            make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
      if (t == 0) {
        sm[row] = m[h];
        sl[row] = l[h];
      }
    }
    return;
  }

  // Epilogue: O / max(l, 1e-30) in bf16, swizzled into this warpgroup's
  // Q tile, stored by TMA (rows past Lq clipped).
  const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(my_q_ptr + T::offset(warp * 16 + g + 8 * h, 8 * j + 2 * t)) =
          pack_f32(o[4 * j + 2 * h] / den[h], o[4 * j + 2 * h + 1] / den[h]);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  if (tid == 0 && q_wg < Lq) {
    for (int c = 0; c < T::kBoxes; ++c)
      tma_store(&map_o, my_q + c * T::kBoxBytes, c * T::kBox, q_wg, bh);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
  if constexpr (WriteLse) {
    // m and l are the same in the 4 lanes that hold a row; one stores.
    float* lh = lse + static_cast<size_t>(bh) * Lq;
    if (t == 0 && r0 < Lq) lh[r0] = m[0] + logf(den[0]);
    if (t == 0 && r1 < Lq) lh[r1] = m[1] + logf(den[1]);
  }
}

// ---- host side ------------------------------------------------------------------

template <int D>
constexpr size_t smem_bytes(int bias_floats) {
  return 1024 + static_cast<size_t>(kWarpgroups + 2 * kStages) * Tile<D>::kBytes +
         static_cast<size_t>(bias_floats) * sizeof(float);
}

template <int D, bool WriteLse, bool CarryState, bool RelBias>
int launch(const void* q, const void* k, const void* v, const int32_t* mask, void* out,
           float* lse, int B, int H, int Lq, int Lk, int mask_b_stride, float scale,
           cudaStream_t stream, const float* dist_bias, int max_distance, float* st_m,
           float* st_l, float* st_acc) {
  EncodeTiledFn encode;
  if (const int err = encode_tiled_fn(&encode)) return err;
  CUtensorMap maps[4] = {};
  const void* ptrs[4] = {q, k, v, out};
  const int rows[4] = {Lq, Lk, Lk, Lq};
  // The fold stores its f32 state without TMA: no output map.
  for (int i = 0; i < (CarryState ? 3 : 4); ++i)
    if (const int err = encode_map<D>(encode, &maps[i], ptrs[i], B * H, rows[i])) return err;

  auto kernel = flash_fwd_sm90<D, WriteLse, CarryState, RelBias>;
  // Above 48 KB only after opting in, once per device for this instantiation.
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  if (const cudaError_t err = cudaGetDevice(&dev)) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    const size_t most = smem_bytes<D>(RelBias ? 2 * kMaxBiasDistance + 1 : 0);
    if (const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(most)))
      return err;
    opted_in[dev] = true;
  }
  const int n_q = (Lq + kBlockRows - 1) / kBlockRows;
  const size_t smem = smem_bytes<D>(RelBias ? 2 * max_distance + 1 : 0);
  kernel<<<static_cast<unsigned>(n_q) * B * H, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], mask, lse, H, Lq, Lk, n_q, mask_b_stride, scale,
      dist_bias, max_distance, st_m, st_l, st_acc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace
