// Flash attention forward for Hopper (sm_90a), with a key-padding mask.
//
// Replaces the Pallas TPU kernel `_flash_kernel` (agent_tpu/kernels/
// flash_attention.py:149-175, launched by `flash_attention` at :228). It
// computes softmax(Q K^T * D^-1/2, keys masked to NEG_INF) V with an online
// softmax: running max m, denominator l and numerator acc in f32, P rounded
// to the input type before P V, masked scores set to NEG_INF *and* their
// probabilities multiplied by keep (so a fully masked tile adds exactly 0),
// output acc / max(l, 1e-30) in the input type (a fully masked row is 0).
// The training forward (WriteLse: also each query row's logsumexp lse = m +
// log(max(l, 1e-30)) in f32, the only softmax residual of the backward in
// flash_attention_bwd.cu) and the T5 forward (RelBias, below) run, in bf16,
// on the TMA + wgmma kernel of flash_fwd_sm90.cuh, which says which Pallas
// kernels they replace; in f32 on this file's FMA kernel.
//
// Bound on an H100 SXM at the classify path's shape (B 256, H 12, L 512,
// D 64, bf16): 4*B*H*L^2*D = 2.06e11 FLOP over 989 TFLOP/s = 0.21 ms, and
// Q, K, V read once plus O written once = 4*B*H*L*D*2 B = 0.81 GB over
// 3.35 TB/s = 0.24 ms, so the bound is the bytes, 0.24 ms; the arithmetic
// intensity (~255 FLOP/B) sits just under the card's ridge (~295).
//
// What the design does about it: the [L, L] score matrix never reaches
// device memory. One block owns one (b, h, 64-row query tile) and loops
// over 64-key tiles staged in shared memory, so Q, K and V each cross
// device memory about once per query tile (K/V re-reads of the L/64 query
// tiles of one head mostly hit the 50 MB L2). The bf16 kernel runs both
// products on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
// accumulate), keeps the score tile in registers and reuses the QK^T
// accumulator fragments directly as the P operand of P V. It does not
// overlap tile loads with compute nor use wgmma: flash_fwd_sm90.cuh does,
// and this kernel can move onto its main loop later. The f32 kernel is a
// plain FMA loop (no f32 tensor core path keeps f32 accuracy); it serves
// f32 models and the tests.
//
// Blocks run in no order, so the TPU kernel's sequential K-tile grid axis
// becomes the loop inside the block, and the ragged edges (Lq, Lk not
// multiples of the tiles) are masked here: keys past Lk load as zeros with
// keep = 0, query rows past Lq are computed and not stored.
//
// The CarryState = true variant replaces `_flash_fold_kernel` (agent_tpu/
// kernels/flash_attention.py:258-288, launched by `flash_fold` at :329),
// one hop of ring attention (agent_tpu_torch/parallel/ring.py): instead of
// starting from (NEG_INF, 0, 0) it reads each query row's f32 (m, l, acc)
// from device memory, folds the K/V block into it with the same per-tile
// update, and writes (m, l, acc) back unnormalised instead of the output.
// A wholly masked tile leaves the state exactly as it was (its p are 0 and
// its correction exp(0) = 1). Each block owns its query rows, and every
// thread reads its state before the first __syncthreads and writes it after
// the last, so the state is updated in place. Bound on an H100 SXM at the
// ring's shard shape (B 8, H 4, Lq = Lk = 2048, D 128, bf16): 4*B*H*Lq*Lk*D
// = 6.87e10 FLOP over 989 TFLOP/s = 0.069 ms against 118.5 MB (Q, K, V in
// bf16, acc in and out in f32, m and l) over 3.35 TB/s = 0.035 ms, so the
// products bound it (~580 FLOP/B, above the ridge). What the design does
// about it: the tensor-core loop is the forward's, and the state crosses
// device memory once in and once out per query row, in registers in between.
//
// The RelBias variant is T5's encoder self-attention: unscaled scores
// (scale = 1) plus T5's bucketed relative-position bias, s = q.k * scale +
// bias[h, bucket(k - q)], before the mask. The bucket saturates beyond
// +-max_distance, so the wrapper hands in a per-distance table, f32 [H, 2 *
// max_distance + 1], row h holding bias[h, bucket(clamp(k - q, -maxd,
// maxd))] at index clamp(k - q) + maxd, computed from the learned
// [num_buckets, H] table with the port's own bucket function (no logf in
// the kernel, where an ulp at rel = 16, 32, 64 would flip a bucket). Each
// block copies its head's row into dynamic shared memory (1 KB at
// max_distance 128); the [H, Lq, Lk] bias never exists in device memory.
// The scale and the bias are applied as two rounded operations, as the
// plain version computes them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr float kNegInf = -1e9f;  // finite, as agent_tpu.models.layers.NEG_INF
constexpr int kThreads = 128;
// Largest max_distance of the RelBias table: 2 * 1024 + 1 floats (8 KB) of
// dynamic shared memory stay, beside the f32 kernel's tile buffers, under
// the 48 KB a block gets without opting in (the sm90 kernel opts in).
constexpr int kMaxBiasDistance = 1024;

// This lane's bias for relative position rel = key - query, from the head's
// per-distance row staged in shared memory.
__device__ __forceinline__ float rel_bias_at(const float* bias_s, int rel,
                                             int max_distance) {
  return bias_s[min(max(rel, -max_distance), max_distance) + max_distance];
}

// Copies head h's per-distance row of `dist_bias` into the dynamic shared
// memory and returns it; visible to the block after its next __syncthreads.
__device__ __forceinline__ float* stage_bias_row(const float* dist_bias, int h,
                                                 int max_distance) {
  extern __shared__ float dyn_smem[];
  const int n = 2 * max_distance + 1;
  const float* row = dist_bias + static_cast<size_t>(h) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) dyn_smem[i] = row[i];
  return dyn_smem;
}

}  // namespace

#include "flash_fwd_sm90.cuh"

namespace {

// ---- bf16: mma.sync kernel (serving forward, ring hop) ------------------------

constexpr int kBq = 64;  // query rows per block, 16 per warp
constexpr int kBk = 64;  // keys per tile

template <int D, bool CarryState>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const int32_t* __restrict__ mask,
                   __nv_bfloat16* __restrict__ out, int H, int Lq, int Lk,
                   int n_q_tiles, int mask_b_stride, float scale,
                   float* __restrict__ st_m, float* __restrict__ st_l,
                   float* __restrict__ st_acc) {
  constexpr int kStride = D + 8;  // smem row pitch: 16-byte pad, no conflicts
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 k_s[kBk * kStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBk * kStride];
  __shared__ float keep_s[kBk];

  const int bh = blockIdx.x / n_q_tiles;
  const int q0 = (blockIdx.x % n_q_tiles) * kBq;
  const int b = bh / H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const __nv_bfloat16* qh = q + static_cast<size_t>(bh) * Lq * D;
  const __nv_bfloat16* kh = k + static_cast<size_t>(bh) * Lk * D;
  const __nv_bfloat16* vh = v + static_cast<size_t>(bh) * Lk * D;
  const int32_t* mrow = mask + static_cast<size_t>(b) * mask_b_stride;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  // This warp's 16 query rows as A fragments, straight from device memory.
  uint32_t qf[D / 16][4];
  load_a_rows<D>(qf, qh, r0, r1, Lq, t);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  if constexpr (CarryState) {
    // The carried state of this lane's rows: m and l in all 4 lanes of a
    // row, acc as the fragment [dt][0..1] = row r0, columns dt*8 + 2t, +1,
    // [dt][2..3] = row r1.
    const size_t s0 = static_cast<size_t>(bh) * Lq + r0, s1 = s0 + 8;
    if (r0 < Lq) {
      m[0] = st_m[s0];
      l[0] = st_l[s0];
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const float2 a = *reinterpret_cast<const float2*>(st_acc + s0 * D + dt * 8 + 2 * t);
        acc[dt][0] = a.x;
        acc[dt][1] = a.y;
      }
    }
    if (r1 < Lq) {
      m[1] = st_m[s1];
      l[1] = st_l[s1];
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const float2 a = *reinterpret_cast<const float2*>(st_acc + s1 * D + dt * 8 + 2 * t);
        acc[dt][2] = a.x;
        acc[dt][3] = a.y;
      }
    }
  }

  for (int k0 = 0; k0 < Lk; k0 += kBk) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < kBk * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8, key = k0 + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (key < Lk) {
        kv = *reinterpret_cast<const uint4*>(kh + static_cast<size_t>(key) * D + c);
        vv = *reinterpret_cast<const uint4*>(vh + static_cast<size_t>(key) * D + c);
      }
      *reinterpret_cast<uint4*>(k_s + r * kStride + c) = kv;
      *reinterpret_cast<uint4*>(v_s + r * kStride + c) = vv;
    }
    for (int i = tid; i < kBk; i += kThreads) {
      const int key = k0 + i;
      keep_s[i] = (key < Lk && mrow[key] > 0) ? 1.f : 0.f;
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, 8 accumulator tiles of 16x8.
    float s[kBk / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kp = k_s + (nt * 8 + g) * kStride + 2 * t;
#pragma unroll
      for (int kt = 0; kt < D / 16; ++kt) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kp + kt * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kp + kt * 16 + 8);
        mma_16816(s[nt], qf[kt], b0, b1);
      }
    }

    // Scale after the product, mask, and fold the tile into (m, l, acc).
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool keep = keep_s[nt * 8 + 2 * t + j] != 0.f;
        s[nt][j] = keep ? s[nt][j] * scale : kNegInf;
        s[nt][2 + j] = keep ? s[nt][2 + j] * scale : kNegInf;
        mx[0] = fmaxf(mx[0], s[nt][j]);
        mx[1] = fmaxf(mx[1], s[nt][2 + j]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {  // the 4 lanes holding a row
      mx[0] = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], off));
      mx[1] = fmaxf(mx[1], __shfl_xor_sync(0xffffffffu, mx[1], off));
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float keep = keep_s[nt * 8 + 2 * t + j];
        s[nt][j] = expf(s[nt][j] - mx[0]) * keep;
        s[nt][2 + j] = expf(s[nt][2 + j] - mx[1]) * keep;
        rs[0] += s[nt][j];
        rs[1] += s[nt][2 + j];
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      rs[0] += __shfl_xor_sync(0xffffffffu, rs[0], off);
      rs[1] += __shfl_xor_sync(0xffffffffu, rs[1], off);
    }
    const float corr0 = expf(m[0] - mx[0]), corr1 = expf(m[1] - mx[1]);
    l[0] = l[0] * corr0 + rs[0];
    l[1] = l[1] * corr1 + rs[1];
    m[0] = mx[0];
    m[1] = mx[1];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= corr0;
      acc[dt][1] *= corr0;
      acc[dt][2] *= corr1;
      acc[dt][3] *= corr1;
    }

    // acc += bf16(P) V: the S accumulators of key tiles 2kk and 2kk+1 are
    // exactly the A fragment of a 16-key slice of P.
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      const uint32_t pa[4] = {pack_f32(s[2 * kk][0], s[2 * kk][1]),
                              pack_f32(s[2 * kk][2], s[2 * kk][3]),
                              pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vp = v_s + (kk * 16 + 2 * t) * kStride + g;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* p = vp + dt * 8;
        const uint32_t b0 = pack_raw(p[0], p[kStride]);
        const uint32_t b1 = pack_raw(p[8 * kStride], p[9 * kStride]);
        mma_16816(acc[dt], pa, b0, b1);
      }
    }
  }

  if constexpr (CarryState) {
    // Unnormalised state back in place; m and l from one lane of the 4.
    const size_t s0 = static_cast<size_t>(bh) * Lq + r0, s1 = s0 + 8;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      if (r0 < Lq)
        *reinterpret_cast<float2*>(st_acc + s0 * D + dt * 8 + 2 * t) =
            make_float2(acc[dt][0], acc[dt][1]);
      if (r1 < Lq)
        *reinterpret_cast<float2*>(st_acc + s1 * D + dt * 8 + 2 * t) =
            make_float2(acc[dt][2], acc[dt][3]);
    }
    if (t == 0 && r0 < Lq) {
      st_m[s0] = m[0];
      st_l[s0] = l[0];
    }
    if (t == 0 && r1 < Lq) {
      st_m[s1] = m[1];
      st_l[s1] = l[1];
    }
    return;
  }
  const float d0 = fmaxf(l[0], 1e-30f), d1 = fmaxf(l[1], 1e-30f);
  __nv_bfloat16* oh = out + static_cast<size_t>(bh) * Lq * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (r0 < Lq)
      *reinterpret_cast<uint32_t*>(oh + static_cast<size_t>(r0) * D + c) =
          pack_f32(acc[dt][0] / d0, acc[dt][1] / d0);
    if (r1 < Lq)
      *reinterpret_cast<uint32_t*>(oh + static_cast<size_t>(r1) * D + c) =
          pack_f32(acc[dt][2] / d1, acc[dt][3] / d1);
  }
}

// ---- f32: FMA kernel ---------------------------------------------------------

constexpr int kRowsF32 = 32;  // query rows per block, 4 threads per row
constexpr int kTileF32 = 32;  // keys per tile

template <int D, bool WriteLse, bool CarryState, bool RelBias>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int32_t* __restrict__ mask,
                  float* __restrict__ out, float* __restrict__ lse, int H,
                  int Lq, int Lk, int n_q_tiles, int mask_b_stride,
                  float scale, float* __restrict__ st_m,
                  float* __restrict__ st_l, float* __restrict__ st_acc,
                  const float* __restrict__ dist_bias, int max_distance) {
  constexpr int kPer = D / 4;  // this thread's dims: t + 4 i
  __shared__ __align__(16) float k_s[kTileF32 * D];
  __shared__ __align__(16) float v_s[kTileF32 * D];
  __shared__ float keep_s[kTileF32];

  const int bh = blockIdx.x / n_q_tiles;
  const int row = (blockIdx.x % n_q_tiles) * kRowsF32 + threadIdx.x / 4;
  const int t = threadIdx.x % 4;
  const int b = bh / H;
  const float* qh = q + static_cast<size_t>(bh) * Lq * D;
  const float* kh = k + static_cast<size_t>(bh) * Lk * D;
  const float* vh = v + static_cast<size_t>(bh) * Lk * D;
  const int32_t* mrow = mask + static_cast<size_t>(b) * mask_b_stride;
  const float* bias_s = nullptr;
  if constexpr (RelBias) bias_s = stage_bias_row(dist_bias, bh % H, max_distance);

  float qr[kPer], acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    qr[i] = row < Lq ? qh[static_cast<size_t>(row) * D + t + 4 * i] : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  const size_t srow = static_cast<size_t>(bh) * Lq + row;
  if constexpr (CarryState) {
    if (row < Lq) {
      m = st_m[srow];
      l = st_l[srow];
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] = st_acc[srow * D + t + 4 * i];
    }
  }

  for (int k0 = 0; k0 < Lk; k0 += kTileF32) {
    __syncthreads();
    for (int i = threadIdx.x; i < kTileF32 * D / 4; i += kThreads) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4, key = k0 + r;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (key < Lk) {
        kv = *reinterpret_cast<const float4*>(kh + static_cast<size_t>(key) * D + c);
        vv = *reinterpret_cast<const float4*>(vh + static_cast<size_t>(key) * D + c);
      }
      *reinterpret_cast<float4*>(k_s + r * D + c) = kv;
      *reinterpret_cast<float4*>(v_s + r * D + c) = vv;
    }
    for (int i = threadIdx.x; i < kTileF32; i += kThreads) {
      const int key = k0 + i;
      keep_s[i] = (key < Lk && mrow[key] > 0) ? 1.f : 0.f;
    }
    __syncthreads();

    float s[kTileF32];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kTileF32; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) part = fmaf(qr[i], k_s[j * D + t + 4 * i], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if constexpr (RelBias) {
        s[j] = keep_s[j] != 0.f
                   ? __fadd_rn(__fmul_rn(part, scale),
                               rel_bias_at(bias_s, k0 + j - row, max_distance))
                   : kNegInf;
      } else {
        s[j] = keep_s[j] != 0.f ? part * scale : kNegInf;
      }
      mx = fmaxf(mx, s[j]);
    }
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kTileF32; ++j) {
      s[j] = expf(s[j] - mx) * keep_s[j];
      rs += s[j];
    }
    const float corr = expf(m - mx);
    l = l * corr + rs;
    m = mx;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      float a = acc[i] * corr;
#pragma unroll
      for (int j = 0; j < kTileF32; ++j) a = fmaf(s[j], v_s[j * D + t + 4 * i], a);
      acc[i] = a;
    }
  }

  if constexpr (CarryState) {
    if (row < Lq) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) st_acc[srow * D + t + 4 * i] = acc[i];
      if (t == 0) {
        st_m[srow] = m;
        st_l[srow] = l;
      }
    }
    return;
  }
  if (row < Lq) {
    const float den = fmaxf(l, 1e-30f);
    float* orow = out + (static_cast<size_t>(bh) * Lq + row) * D;
#pragma unroll
    for (int i = 0; i < kPer; ++i) orow[t + 4 * i] = acc[i] / den;
    if constexpr (WriteLse) {
      if (t == 0) lse[static_cast<size_t>(bh) * Lq + row] = m + logf(den);
    }
  }
}

template <bool WriteLse, bool CarryState, bool RelBias = false>
int launch_fwd(const void* q, const void* k, const void* v, const void* mask,
               void* out, float* lse, int B, int H, int Lq, int Lk, int D,
               int mask_b_stride, int is_bf16, float scale, void* stream,
               float* st_m = nullptr, float* st_l = nullptr,
               float* st_acc = nullptr, const float* dist_bias = nullptr,
               int max_distance = 0) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return cudaErrorInvalidValue;
  if (D != 32 && D != 64 && D != 128) return cudaErrorInvalidValue;
  if (RelBias && (max_distance < 1 || max_distance > kMaxBiasDistance))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* m = static_cast<const int32_t*>(mask);
  if (is_bf16) {
    if constexpr (WriteLse || RelBias) {
      // The training forward and T5's: the TMA + wgmma kernel.
      switch (D) {
        case 32: return sm90::launch<32, WriteLse, RelBias>(q, k, v, m, out, lse, B, H, Lq, Lk, mask_b_stride, scale, st, dist_bias, max_distance);
        case 64: return sm90::launch<64, WriteLse, RelBias>(q, k, v, m, out, lse, B, H, Lq, Lk, mask_b_stride, scale, st, dist_bias, max_distance);
        default: return sm90::launch<128, WriteLse, RelBias>(q, k, v, m, out, lse, B, H, Lq, Lk, mask_b_stride, scale, st, dist_bias, max_distance);
      }
    } else {
      const int n_q = (Lq + kBq - 1) / kBq;
      const dim3 grid(static_cast<unsigned>(n_q) * B * H);
      const auto* qq = static_cast<const __nv_bfloat16*>(q);
      const auto* kk = static_cast<const __nv_bfloat16*>(k);
      const auto* vv = static_cast<const __nv_bfloat16*>(v);
      auto* oo = static_cast<__nv_bfloat16*>(out);
      switch (D) {
        case 32: flash_fwd_bf16<32, CarryState><<<grid, kThreads, 0, st>>>(qq, kk, vv, m, oo, H, Lq, Lk, n_q, mask_b_stride, scale, st_m, st_l, st_acc); break;
        case 64: flash_fwd_bf16<64, CarryState><<<grid, kThreads, 0, st>>>(qq, kk, vv, m, oo, H, Lq, Lk, n_q, mask_b_stride, scale, st_m, st_l, st_acc); break;
        default: flash_fwd_bf16<128, CarryState><<<grid, kThreads, 0, st>>>(qq, kk, vv, m, oo, H, Lq, Lk, n_q, mask_b_stride, scale, st_m, st_l, st_acc); break;
      }
    }
  } else {
    const int n_q = (Lq + kRowsF32 - 1) / kRowsF32;
    const dim3 grid(static_cast<unsigned>(n_q) * B * H);
    const auto* qq = static_cast<const float*>(q);
    const auto* kk = static_cast<const float*>(k);
    const auto* vv = static_cast<const float*>(v);
    auto* oo = static_cast<float*>(out);
    const size_t smem = RelBias ? (2 * max_distance + 1) * sizeof(float) : 0;
    switch (D) {
      case 32: flash_fwd_f32<32, WriteLse, CarryState, RelBias><<<grid, kThreads, smem, st>>>(qq, kk, vv, m, oo, lse, H, Lq, Lk, n_q, mask_b_stride, scale, st_m, st_l, st_acc, dist_bias, max_distance); break;
      case 64: flash_fwd_f32<64, WriteLse, CarryState, RelBias><<<grid, kThreads, smem, st>>>(qq, kk, vv, m, oo, lse, H, Lq, Lk, n_q, mask_b_stride, scale, st_m, st_l, st_acc, dist_bias, max_distance); break;
      default: flash_fwd_f32<128, WriteLse, CarryState, RelBias><<<grid, kThreads, smem, st>>>(qq, kk, vv, m, oo, lse, H, Lq, Lk, n_q, mask_b_stride, scale, st_m, st_l, st_acc, dist_bias, max_distance); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q: [B, H, Lq, D], k/v: [B, H, Lk, D], out: [B, H, Lq, D], all contiguous
// and of one type (bf16 when is_bf16, else f32); mask: int32 [B or 1, Lk]
// (mask_b_stride = Lk or 0), > 0 = attend. D in {32, 64, 128}. Launches on
// `stream` and returns the launch's cudaError_t (0 = success).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* mask, void* out, int B, int H, int Lq,
                        int Lk, int D, int mask_b_stride, int is_bf16,
                        float scale, void* stream) {
  return launch_fwd<false, false>(q, k, v, mask, out, nullptr, B, H, Lq, Lk, D,
                                  mask_b_stride, is_bf16, scale, stream);
}

// As flash_attention_fwd, and lse: f32 [B, H, Lq] (contiguous) receives
// each query row's m + log(max(l, 1e-30)).
int flash_attention_fwd_lse(const void* q, const void* k, const void* v,
                            const void* mask, void* out, void* lse, int B,
                            int H, int Lq, int Lk, int D, int mask_b_stride,
                            int is_bf16, float scale, void* stream) {
  return launch_fwd<true, false>(q, k, v, mask, out, static_cast<float*>(lse), B,
                                 H, Lq, Lk, D, mask_b_stride, is_bf16, scale, stream);
}

// One ring hop: fold the K/V block (k, v, mask as above) into the carried
// softmax state of each query row, IN PLACE: m, l f32 [B, H, Lq] and acc
// f32 [B, H, Lq, D] (contiguous) are read as the state before the block and
// overwritten with the state after it, unnormalised (the caller divides acc
// by max(l, 1e-30) after the last hop). Start a ring from m = -1e9, l = 0,
// acc = 0.
int flash_attention_fold(const void* q, const void* k, const void* v,
                         const void* mask, void* m, void* l, void* acc, int B,
                         int H, int Lq, int Lk, int D, int mask_b_stride,
                         int is_bf16, float scale, void* stream) {
  return launch_fwd<false, true>(q, k, v, mask, nullptr, nullptr, B, H, Lq, Lk, D,
                                 mask_b_stride, is_bf16, scale, stream,
                                 static_cast<float*>(m), static_cast<float*>(l),
                                 static_cast<float*>(acc));
}

// T5 self-attention: as flash_attention_fwd with s = q.k * scale +
// dist_bias[h, clamp(k - q, -max_distance, max_distance) + max_distance]
// before the mask; dist_bias: f32 [H, 2 * max_distance + 1] (contiguous),
// 1 <= max_distance <= 1024.
int flash_attention_fwd_t5(const void* q, const void* k, const void* v,
                           const void* mask, void* out, const void* dist_bias,
                           int B, int H, int Lq, int Lk, int D,
                           int mask_b_stride, int is_bf16, float scale,
                           int max_distance, void* stream) {
  return launch_fwd<false, false, true>(
      q, k, v, mask, out, nullptr, B, H, Lq, Lk, D, mask_b_stride, is_bf16,
      scale, stream, nullptr, nullptr, nullptr,
      static_cast<const float*>(dist_bias), max_distance);
}

const char* flash_attention_error_string(int err) {
  if (err >= sm90::kEncodeError) return "cuTensorMapEncodeTiled failed (CUresult = code - 100000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
