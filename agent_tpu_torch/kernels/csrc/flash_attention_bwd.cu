// Flash attention backward for Hopper (sm_90a), with a key-padding mask.
//
// Replaces the Pallas TPU kernels `_flash_bwd_dq_kernel` (agent_tpu/kernels/
// flash_attention.py:629-662) and `_flash_bwd_dkv_kernel` (:665-703), both
// launched by `_flash_bwd_res` (:780, :801), the backward of the trainable
// attention (`_trainable_core`, :880-913). Given the forward's inputs, its
// output O and that output's gradient dO, and the row logsumexp lse
// (flash_attention.cu, WriteLse), they recompute the probabilities tile by
// tile, p = keep ? exp(min(s - lse, 80)) : 0 with s = (Q K^T) * scale in
// f32, and
//   dQ = scale * sum_k bf16(ds) K,  ds = p * (dO V^T - delta)   (dQ kernel)
//   dV = sum_q bf16(p)^T dO,  dK = scale * sum_q bf16(ds)^T Q    (dK/dV kernel)
// rounding where the Pallas bodies round (p to dO's type before p^T dO, ds
// to K's/Q's type before the products, scale on the f32 product; here the
// scale multiplies the f32 sum once at the end, which differs from the
// per-tile scale only in f32 rounding). The dQ kernel also computes delta =
// rowsum(dO * O) in f32 and stores it; the dK/dV kernel, launched after it
// on the same stream, reads it. A row with no real key gets zero gradients
// (p = 0 on every key), as the reference documents (:848-851); the dense
// path's uniform-softmax gradient is not reproduced.
//
// bf16: the TMA + wgmma kernels of flash_bwd_sm90.cuh, whose note gives
// their bound and design. f32: plain FMA loops, as in the forward, one
// query row (dQ) or key (dK/dV) per 4 threads, the other side's rows staged
// 32 at a time in shared memory; ragged edges load as zeros with keep = 0,
// and query rows past Lq carry a validity flag that zeroes their p.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_sm90.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kExpCap = 80.f;  // exp(80) is finite in f32, so no inf * 0

__device__ __forceinline__ float prob(bool keep, float s, float scale,
                                      float lse) {
  return keep ? expf(fminf(s * scale - lse, kExpCap)) : 0.f;
}

// ---- f32: FMA kernels ------------------------------------------------------

constexpr int kRowsF32 = 32;  // rows a block owns, 4 threads per row
constexpr int kTileF32 = 32;  // rows per staged tile

// Stage rows [r0, r0 + kTileF32) of two [rows, D] f32 matrices, zeros past
// `rows`.
template <int D>
__device__ __forceinline__ void stage_pair_f32(float* a_s, float* b_s, const float* a,
                                               const float* b, int r0, int rows) {
  for (int i = threadIdx.x; i < kTileF32 * D / 4; i += kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4, row = r0 + r;
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f), bv = av;
    if (row < rows) {
      av = *reinterpret_cast<const float4*>(a + static_cast<size_t>(row) * D + c);
      bv = *reinterpret_cast<const float4*>(b + static_cast<size_t>(row) * D + c);
    }
    *reinterpret_cast<float4*>(a_s + r * D + c) = av;
    *reinterpret_cast<float4*>(b_s + r * D + c) = bv;
  }
}

// Dot product of a row held by 4 lanes (dims t + 4i) with a staged row.
template <int D>
__device__ __forceinline__ float dot4(const float (&x)[D / 4], const float* y, int t) {
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < D / 4; ++i) part = fmaf(x[i], y[t + 4 * i], part);
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  return part + __shfl_xor_sync(0xffffffffu, part, 2);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int32_t* __restrict__ mask,
                     const float* __restrict__ dout, const float* __restrict__ o,
                     const float* __restrict__ lse, float* __restrict__ delta,
                     float* __restrict__ dq, int H, int Lq, int Lk, int n_q_tiles,
                     int mask_b_stride, float scale) {
  constexpr int kPer = D / 4;  // this thread's dims: t + 4 i
  __shared__ __align__(16) float k_s[kTileF32 * D];
  __shared__ __align__(16) float v_s[kTileF32 * D];
  __shared__ float keep_s[kTileF32];

  const int bh = blockIdx.x / n_q_tiles;
  const int row = (blockIdx.x % n_q_tiles) * kRowsF32 + threadIdx.x / 4;
  const int t = threadIdx.x % 4;
  const int b = bh / H;
  const size_t row_off = (static_cast<size_t>(bh) * Lq + row) * D;
  const float* kh = k + static_cast<size_t>(bh) * Lk * D;
  const float* vh = v + static_cast<size_t>(bh) * Lk * D;
  const int32_t* mrow = mask + static_cast<size_t>(b) * mask_b_stride;

  float qr[kPer], dor[kPer], acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    qr[i] = row < Lq ? q[row_off + t + 4 * i] : 0.f;
    dor[i] = row < Lq ? dout[row_off + t + 4 * i] : 0.f;
    acc[i] = 0.f;
  }
  const float ls = row < Lq ? lse[static_cast<size_t>(bh) * Lq + row] : 0.f;
  // delta = rowsum(dO * O) over the row's 4 lanes (dims t + 4 i each).
  float dl = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    dl = fmaf(dor[i], row < Lq ? o[row_off + t + 4 * i] : 0.f, dl);
  dl += __shfl_xor_sync(0xffffffffu, dl, 1);
  dl += __shfl_xor_sync(0xffffffffu, dl, 2);
  if (t == 0 && row < Lq) delta[static_cast<size_t>(bh) * Lq + row] = dl;

  for (int k0 = 0; k0 < Lk; k0 += kTileF32) {
    __syncthreads();
    stage_pair_f32<D>(k_s, v_s, kh, vh, k0, Lk);
    for (int i = threadIdx.x; i < kTileF32; i += kThreads) {
      const int key = k0 + i;
      keep_s[i] = (key < Lk && mrow[key] > 0) ? 1.f : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < kTileF32; ++j) {
      const float s = dot4<D>(qr, k_s + j * D, t);
      const float dp = dot4<D>(dor, v_s + j * D, t);
      const float ds = prob(keep_s[j] != 0.f, s, scale, ls) * (dp - dl);
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] = fmaf(ds, k_s[j * D + t + 4 * i], acc[i]);
    }
  }
  if (row < Lq) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) dq[row_off + t + 4 * i] = acc[i] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const int32_t* __restrict__ mask,
                      const float* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int H, int Lq, int Lk, int n_k_tiles,
                      int mask_b_stride, float scale) {
  constexpr int kPer = D / 4;
  __shared__ __align__(16) float q_s[kTileF32 * D];
  __shared__ __align__(16) float do_s[kTileF32 * D];
  __shared__ float lse_s[kTileF32], delta_s[kTileF32], valid_s[kTileF32];

  const int bh = blockIdx.x / n_k_tiles;
  const int key = (blockIdx.x % n_k_tiles) * kRowsF32 + threadIdx.x / 4;
  const int t = threadIdx.x % 4;
  const int b = bh / H;
  const size_t key_off = (static_cast<size_t>(bh) * Lk + key) * D;
  const float* qh = q + static_cast<size_t>(bh) * Lq * D;
  const float* doh = dout + static_cast<size_t>(bh) * Lq * D;
  const float* lh = lse + static_cast<size_t>(bh) * Lq;
  const float* dh = delta + static_cast<size_t>(bh) * Lq;
  const bool keep = key < Lk && mask[static_cast<size_t>(b) * mask_b_stride + key] > 0;

  float kr[kPer], vr[kPer], dk_acc[kPer], dv_acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    kr[i] = key < Lk ? k[key_off + t + 4 * i] : 0.f;
    vr[i] = key < Lk ? v[key_off + t + 4 * i] : 0.f;
    dk_acc[i] = dv_acc[i] = 0.f;
  }

  for (int q0 = 0; q0 < Lq; q0 += kTileF32) {
    __syncthreads();
    stage_pair_f32<D>(q_s, do_s, qh, doh, q0, Lq);
    for (int i = threadIdx.x; i < kTileF32; i += kThreads) {
      const bool valid = q0 + i < Lq;
      lse_s[i] = valid ? lh[q0 + i] : 0.f;
      delta_s[i] = valid ? dh[q0 + i] : 0.f;
      valid_s[i] = valid ? 1.f : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < kTileF32; ++j) {
      const float s = dot4<D>(kr, q_s + j * D, t);
      const float dp = dot4<D>(vr, do_s + j * D, t);
      const float p = prob(keep && valid_s[j] != 0.f, s, scale, lse_s[j]);
      const float ds = p * (dp - delta_s[j]);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        dv_acc[i] = fmaf(p, do_s[j * D + t + 4 * i], dv_acc[i]);
        dk_acc[i] = fmaf(ds, q_s[j * D + t + 4 * i], dk_acc[i]);
      }
    }
  }
  if (key < Lk) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      dk[key_off + t + 4 * i] = dk_acc[i] * scale;
      dv[key_off + t + 4 * i] = dv_acc[i];
    }
  }
}

// One launcher for both kernels: kDq picks which. For the dQ kernel `out` is
// dq and `delta` is written; for the dK/dV kernel `out` is dk, `out2` dv,
// and `delta` is the dQ kernel's.
template <bool kDq>
int launch_bwd(const void* q, const void* k, const void* v, const void* mask,
               const void* dout, const void* o, const void* lse, void* delta, void* out,
               void* out2, int B, int H, int Lq, int Lk, int D, int mask_b_stride,
               int is_bf16, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return cudaErrorInvalidValue;
  if (D != 32 && D != 64 && D != 128) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const int32_t*>(mask);
  const auto* ls = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  if (is_bf16) {
    namespace bwd = sm90::bwd;
#define LAUNCH_SM90(DIM)                                                                       \
  if constexpr (kDq)                                                                              \
    return bwd::launch_dq<DIM>(q, k, v, m, dout, o, ls, dl, out, B, H, Lq, Lk, mask_b_stride,   \
                               scale, st);                                                        \
  else                                                                                            \
    return bwd::launch_dkv<DIM>(q, k, v, m, dout, ls, dl, out, out2, B, H, Lq, Lk,              \
                                mask_b_stride, scale, st)
    switch (D) {
      case 32: LAUNCH_SM90(32);
      case 64: LAUNCH_SM90(64);
      default: LAUNCH_SM90(128);
    }
#undef LAUNCH_SM90
  }
  const int n = ((kDq ? Lq : Lk) + kRowsF32 - 1) / kRowsF32;
  const dim3 grid(static_cast<unsigned>(n) * B * H);
  const float *qq = static_cast<const float*>(q), *kk = static_cast<const float*>(k),
              *vv = static_cast<const float*>(v), *dd = static_cast<const float*>(dout),
              *oo = static_cast<const float*>(o);
  float *o1 = static_cast<float*>(out), *o2 = static_cast<float*>(out2);
#define LAUNCH_F32(DIM)                                                                     \
  if constexpr (kDq)                                                                           \
    flash_bwd_dq_f32<DIM><<<grid, kThreads, 0, st>>>(qq, kk, vv, m, dd, oo, ls, dl, o1, H,   \
                                                     Lq, Lk, n, mask_b_stride, scale);       \
  else                                                                                      \
    flash_bwd_dkv_f32<DIM><<<grid, kThreads, 0, st>>>(qq, kk, vv, m, dd, ls, dl, o1, o2,    \
                                                      H, Lq, Lk, n, mask_b_stride, scale)
  switch (D) {
    case 32: LAUNCH_F32(32); break;
    case 64: LAUNCH_F32(64); break;
    default: LAUNCH_F32(128); break;
  }
#undef LAUNCH_F32
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, dout, o: [B, H, Lq, D]; k, v: [B, H, Lk, D]; all contiguous and of one
// type (bf16 when is_bf16, else f32). mask: int32 [B or 1, Lk]
// (mask_b_stride = Lk or 0), > 0 = attend. lse, delta: f32 [B, H, Lq].
// D in {32, 64, 128}. Each launches on `stream` and returns the launch's
// cudaError_t (0 = success), or 100000 + CUresult when a TMA tensor map
// could not be encoded.

// dq: [B, H, Lq, D], the type of q; delta (written): rowsum(dout * o) in f32.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const void* mask, const void* dout, const void* o,
                           const void* lse, void* delta, void* dq, int B, int H,
                           int Lq, int Lk, int D, int mask_b_stride, int is_bf16,
                           float scale, void* stream) {
  return launch_bwd<true>(q, k, v, mask, dout, o, lse, delta, dq, nullptr, B, H, Lq,
                          Lk, D, mask_b_stride, is_bf16, scale, stream);
}

// dk, dv: [B, H, Lk, D], the type of k; delta: flash_attention_bwd_dq's,
// for the same inputs, launched before on the same stream.
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* mask, const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int B, int H,
                            int Lq, int Lk, int D, int mask_b_stride, int is_bf16,
                            float scale, void* stream) {
  return launch_bwd<false>(q, k, v, mask, dout, nullptr, lse, const_cast<void*>(delta), dk,
                           dv, B, H, Lq, Lk, D, mask_b_stride, is_bf16, scale, stream);
}

const char* flash_attention_bwd_error_string(int err) {
  if (err >= sm90::kEncodeError) return "cuTensorMapEncodeTiled failed (CUresult = code - 100000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
