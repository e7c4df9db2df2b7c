// Flash attention forward with a key-padding mask: the C entry points of
// every forward kernel, and the f32 FMA kernel.
//
// Four Pallas kernels of agent_tpu/kernels/flash_attention.py compute
// softmax(Q K^T * scale, keys masked to NEG_INF) V with an online softmax:
// running max m, denominator l and numerator acc in f32, P rounded to the
// input type before P V, masked scores set to NEG_INF *and* their
// probabilities multiplied by keep (so a fully masked tile adds exactly 0),
// output acc / max(l, 1e-30) in the input type (a fully masked row is 0):
// `_flash_kernel` (:149, pallas_call :228) serves; `_flash_fwd_lse_kernel`
// (:598, :719) also stores each query row's logsumexp lse = m + log(max(l,
// 1e-30)) in f32, the backward's only softmax residual
// (flash_attention_bwd.cu); `_flash_fold_kernel` (:258, :329) is one hop of
// ring attention (agent_tpu_torch/parallel/ring.py), starting from each
// query row's carried f32 (m, l, acc) instead of (NEG_INF, 0, 0) and
// writing it back unnormalised, in place; `_flash_t5_kernel` (:354, :467)
// is T5's encoder self-attention, below. In bf16 all four run on the TMA +
// wgmma kernel of flash_fwd_sm90.cuh, which gives their bounds and design.
//
// This file's own kernel, flash_fwd_f32, is their f32 form, a plain FMA
// loop (no f32 tensor-core path keeps f32 accuracy) that serves f32 models
// and the tests. One block owns 32 query rows of one head, four threads a
// row, and loops over 32-key tiles staged in shared memory, so the [L, L]
// score matrix never reaches device memory. Blocks run in no order, so the
// TPU kernel's sequential key-tile grid axis becomes the loop inside the
// block, and the ragged edges are masked here: keys past Lk load as zeros
// with keep = 0, query rows past Lq are computed and not stored. The fold
// variant (CarryState) reads each row's state before its first tile and
// writes it after its last; each thread owns its row's state, so the
// update is in place. Bound on an H100 SXM: its 4 * Lq * Lk * D FLOP a
// head at the f32 FMA rate, 67 TFLOP/s; what it does about it: nothing yet,
// no main path runs f32 at scale.
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

#include <cuda_runtime.h>
#include <stdint.h>

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
    // Every bf16 forward: the TMA + wgmma kernel.
    switch (D) {
      case 32: return sm90::launch<32, WriteLse, CarryState, RelBias>(q, k, v, m, out, lse, B, H, Lq, Lk, mask_b_stride, scale, st, dist_bias, max_distance, st_m, st_l, st_acc);
      case 64: return sm90::launch<64, WriteLse, CarryState, RelBias>(q, k, v, m, out, lse, B, H, Lq, Lk, mask_b_stride, scale, st, dist_bias, max_distance, st_m, st_l, st_acc);
      default: return sm90::launch<128, WriteLse, CarryState, RelBias>(q, k, v, m, out, lse, B, H, Lq, Lk, mask_b_stride, scale, st, dist_bias, max_distance, st_m, st_l, st_acc);
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
