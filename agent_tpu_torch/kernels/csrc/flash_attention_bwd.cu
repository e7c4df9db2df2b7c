// Flash attention backward for Hopper (sm_90a), with a key-padding mask.
//
// Replaces the Pallas TPU kernels `_flash_bwd_dq_kernel` (agent_tpu/kernels/
// flash_attention.py:629-662) and `_flash_bwd_dkv_kernel` (:665-703), both
// launched by `_flash_bwd_res` (:780, :801), the backward of the trainable
// attention (`_trainable_core`, :880-913). Given the forward's inputs, its
// output's gradient dO, the row logsumexp lse (flash_attention.cu, WriteLse)
// and delta = rowsum(dO * O) in f32, they recompute the probabilities tile
// by tile, p = keep ? exp(min(s - lse, 80)) : 0 with s = (Q K^T) * scale in
// f32, and
//   dQ = scale * sum_k bf16(ds) K,  ds = p * (dO V^T - delta)   (dQ kernel)
//   dV = sum_q bf16(p)^T dO,  dK = scale * sum_q bf16(ds)^T Q    (dK/dV kernel)
// rounding where the Pallas bodies round (p to dO's type before p^T dO, ds
// to K's/Q's type before the products, scale on the f32 product; here the
// scale multiplies the f32 sum once at the end, which differs from the
// per-tile scale only in f32 rounding). A row with no real key gets zero
// gradients (p = 0 on every key), as the reference documents (:848-851);
// the dense path's uniform-softmax gradient is not reproduced.
//
// Bound on an H100 SXM at the training shape (B 128, H 12, L 512, D 64,
// bf16, all keys real): the dQ kernel does 3 products of 2*L*L*D per
// (b, h), 6*B*H*L^2*D = 1.55e11 FLOP / 989 TFLOP/s = 0.157 ms, and moves
// Q, K, V, dO, dQ (5 * B*H*L*D*2 B = 0.50 GB) / 3.35 TB/s = 0.150 ms;
// the dK/dV kernel does 4 products, 2.06e11 FLOP = 0.209 ms, and moves 6
// tensors, 0.60 GB = 0.180 ms. Both are bound by the tensor cores, just.
//
// What the design does about it: the two-kernel split of the reference
// needs no atomics here either. One dQ block owns one (b, h, 64-row query
// tile) and loops over 64-key tiles of K and V staged in shared memory,
// with dq in f32 registers; one dK/dV block owns one (b, h, 64-key tile)
// and loops over 64-row tiles of Q and dO, with dk and dv in f32 registers.
// No output crosses blocks, and neither the score nor the probability
// matrix reaches device memory. All four products of a tile run on the
// tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate). The dK/dV
// kernel computes the transposed tiles S^T = K Q^T and dP^T = V dO^T, so
// p^T and ds^T come out of the accumulators already in the A-operand layout
// of p^T dO and ds^T Q: the register-reuse trick that flash_attention.cu
// uses for P V, with nothing transposed through shared memory. No cp.async
// or TMA pipeline and no wgmma yet: that is later work. d_head 128 works
// the tile in 32-column steps to stay within the register file. The f32
// kernels are plain FMA loops, as in the forward.
//
// Ragged edges: keys past Lk load as zeros with keep = 0; in the dK/dV
// kernel, query rows past Lq load Q and dO as zeros and carry a validity
// flag that zeroes their p (their lse and delta are masked to 0), so they
// contribute exactly 0 without relying on exp(0 - 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kExpCap = 80.f;  // exp(80) is finite in f32, so no inf * 0

// ---- bf16: tensor-core kernels ---------------------------------------------

constexpr int kTile = 64;  // rows a block owns, and rows per staged tile

__device__ __forceinline__ float prob(bool keep, float s, float scale,
                                      float lse) {
  return keep ? expf(fminf(s * scale - lse, kExpCap)) : 0.f;
}

// Stage rows [r0, r0 + kTile) of two [rows, D] bf16 matrices in shared
// memory (pitch D + 8), zeros past `rows`.
template <int D>
__device__ __forceinline__ void stage_pair(__nv_bfloat16* a_s, __nv_bfloat16* b_s,
                                           const __nv_bfloat16* a,
                                           const __nv_bfloat16* b, int r0,
                                           int rows, int tid) {
  constexpr int kStride = D + 8, kChunks = D / 8;
  for (int i = tid; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8, row = r0 + r;
    uint4 av = make_uint4(0, 0, 0, 0), bv = make_uint4(0, 0, 0, 0);
    if (row < rows) {
      av = *reinterpret_cast<const uint4*>(a + static_cast<size_t>(row) * D + c);
      bv = *reinterpret_cast<const uint4*>(b + static_cast<size_t>(row) * D + c);
    }
    *reinterpret_cast<uint4*>(a_s + r * kStride + c) = av;
    *reinterpret_cast<uint4*>(b_s + r * kStride + c) = bv;
  }
}

// acc[16 x kN] = A[16 x D] (fragments) * X^T, X = kN rows of a staged tile
// starting at row n0: the B operand is X[n][d], contiguous along d.
template <int D, int kN>
__device__ __forceinline__ void mma_abt(float (&acc)[kN / 8][4],
                                        const uint32_t (&af)[D / 16][4],
                                        const __nv_bfloat16* x_s, int n0, int g,
                                        int t) {
  constexpr int kStride = D + 8;
#pragma unroll
  for (int nt = 0; nt < kN / 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    const __nv_bfloat16* xp = x_s + (n0 + nt * 8 + g) * kStride + 2 * t;
#pragma unroll
    for (int kt = 0; kt < D / 16; ++kt) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xp + kt * 16);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xp + kt * 16 + 8);
      mma_16816(acc[nt], af[kt], b0, b1);
    }
  }
}

// out[16 x D] += bf16(P)[16 x kN] * Y, P the f32 accumulators of mma_abt
// (already in A-fragment order: n-tiles 2kk and 2kk + 1 make one 16-wide
// slice), Y = kN rows of a staged tile starting at row n0.
template <int D, int kN>
__device__ __forceinline__ void mma_pv(float (&out)[D / 8][4],
                                       const float (&p)[kN / 8][4],
                                       const __nv_bfloat16* y_s, int n0, int g,
                                       int t) {
  constexpr int kStride = D + 8;
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
    const uint32_t pa[4] = {pack_f32(p[2 * kk][0], p[2 * kk][1]),
                            pack_f32(p[2 * kk][2], p[2 * kk][3]),
                            pack_f32(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_f32(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const __nv_bfloat16* yp = y_s + (n0 + kk * 16 + 2 * t) * kStride + g;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const __nv_bfloat16* y = yp + dt * 8;
      const uint32_t b0 = pack_raw(y[0], y[kStride]);
      const uint32_t b1 = pack_raw(y[8 * kStride], y[9 * kStride]);
      mma_16816(out[dt], pa, b0, b1);
    }
  }
}

// Rows r0, r1 (= r0 + 8) of acc * mul as bf16, rows at or past `rows` skipped.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base,
                                           const float (&acc)[D / 8][4], float mul,
                                           int r0, int r1, int rows, int t) {
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (r0 < rows)
      *reinterpret_cast<uint32_t*>(base + static_cast<size_t>(r0) * D + c) =
          pack_f32(acc[dt][0] * mul, acc[dt][1] * mul);
    if (r1 < rows)
      *reinterpret_cast<uint32_t*>(base + static_cast<size_t>(r1) * D + c) =
          pack_f32(acc[dt][2] * mul, acc[dt][3] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const int32_t* __restrict__ mask,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, int H, int Lq, int Lk,
                      int n_q_tiles, int mask_b_stride, float scale) {
  constexpr int kStride = D + 8;
  constexpr int kN = D > 64 ? 32 : 64;  // keys per compute step
  __shared__ __align__(16) __nv_bfloat16 k_s[kTile * kStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[kTile * kStride];
  __shared__ float keep_s[kTile];

  const int bh = blockIdx.x / n_q_tiles;
  const int q0 = (blockIdx.x % n_q_tiles) * kTile;
  const int b = bh / H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t q_off = static_cast<size_t>(bh) * Lq * D;
  const __nv_bfloat16* kh = k + static_cast<size_t>(bh) * Lk * D;
  const __nv_bfloat16* vh = v + static_cast<size_t>(bh) * Lk * D;
  const int32_t* mrow = mask + static_cast<size_t>(b) * mask_b_stride;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  // This warp's 16 query rows of Q and dO as A fragments.
  uint32_t qf[D / 16][4], df[D / 16][4];
  load_a_rows<D>(qf, q + q_off, r0, r1, Lq, t);
  load_a_rows<D>(df, dout + q_off, r0, r1, Lq, t);
  const float* lh = lse + static_cast<size_t>(bh) * Lq;
  const float* dh = delta + static_cast<size_t>(bh) * Lq;
  const float lse0 = r0 < Lq ? lh[r0] : 0.f, lse1 = r1 < Lq ? lh[r1] : 0.f;
  const float dl0 = r0 < Lq ? dh[r0] : 0.f, dl1 = r1 < Lq ? dh[r1] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile
    stage_pair<D>(k_s, v_s, kh, vh, k0, Lk, tid);
    for (int i = tid; i < kTile; i += kThreads) {
      const int key = k0 + i;
      keep_s[i] = (key < Lk && mrow[key] > 0) ? 1.f : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int n0 = 0; n0 < kTile; n0 += kN) {
      float s[kN / 8][4], dp[kN / 8][4];
      mma_abt<D, kN>(s, qf, k_s, n0, g, t);   // S = Q K^T
      mma_abt<D, kN>(dp, df, v_s, n0, g, t);  // dP = dO V^T
#pragma unroll
      for (int nt = 0; nt < kN / 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bool keep = keep_s[n0 + nt * 8 + 2 * t + j] != 0.f;
          s[nt][j] = prob(keep, s[nt][j], scale, lse0) * (dp[nt][j] - dl0);
          s[nt][2 + j] = prob(keep, s[nt][2 + j], scale, lse1) * (dp[nt][2 + j] - dl1);
        }
      }
      mma_pv<D, kN>(acc, s, k_s, n0, g, t);  // dQ += bf16(dS) K
    }
  }
  store_rows<D>(dq + q_off, acc, scale, r0, r1, Lq, t);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_bf16(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const int32_t* __restrict__ mask,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int H, int Lq, int Lk,
                       int n_k_tiles, int mask_b_stride, float scale) {
  constexpr int kStride = D + 8;
  constexpr int kN = D > 64 ? 32 : 64;  // query rows per compute step
  __shared__ __align__(16) __nv_bfloat16 q_s[kTile * kStride];
  __shared__ __align__(16) __nv_bfloat16 do_s[kTile * kStride];
  __shared__ float lse_s[kTile], delta_s[kTile], valid_s[kTile];

  const int bh = blockIdx.x / n_k_tiles;
  const int k0 = (blockIdx.x % n_k_tiles) * kTile;
  const int b = bh / H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const __nv_bfloat16* qh = q + static_cast<size_t>(bh) * Lq * D;
  const __nv_bfloat16* doh = dout + static_cast<size_t>(bh) * Lq * D;
  const size_t k_off = static_cast<size_t>(bh) * Lk * D;
  const float* lh = lse + static_cast<size_t>(bh) * Lq;
  const float* dh = delta + static_cast<size_t>(bh) * Lq;
  const int32_t* mrow = mask + static_cast<size_t>(b) * mask_b_stride;
  const int r0 = k0 + warp * 16 + g, r1 = r0 + 8;  // this lane's key rows

  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_rows<D>(kf, k + k_off, r0, r1, Lk, t);
  load_a_rows<D>(vf, v + k_off, r0, r1, Lk, t);
  const bool keep0 = r0 < Lk && mrow[r0] > 0, keep1 = r1 < Lk && mrow[r1] > 0;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }

  for (int q0 = 0; q0 < Lq; q0 += kTile) {
    __syncthreads();
    stage_pair<D>(q_s, do_s, qh, doh, q0, Lq, tid);
    for (int i = tid; i < kTile; i += kThreads) {
      const bool valid = q0 + i < Lq;
      lse_s[i] = valid ? lh[q0 + i] : 0.f;
      delta_s[i] = valid ? dh[q0 + i] : 0.f;
      valid_s[i] = valid ? 1.f : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int n0 = 0; n0 < kTile; n0 += kN) {
      float pt[kN / 8][4], dst[kN / 8][4];
      mma_abt<D, kN>(pt, kf, q_s, n0, g, t);    // S^T = K Q^T
      mma_abt<D, kN>(dst, vf, do_s, n0, g, t);  // dP^T = V dO^T
#pragma unroll
      for (int nt = 0; nt < kN / 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = n0 + nt * 8 + 2 * t + j;  // query column
          const bool valid = valid_s[c] != 0.f;
          const float ls = lse_s[c], dl = delta_s[c];
          const float p0 = prob(keep0 && valid, pt[nt][j], scale, ls);
          const float p1 = prob(keep1 && valid, pt[nt][2 + j], scale, ls);
          dst[nt][j] = p0 * (dst[nt][j] - dl);
          dst[nt][2 + j] = p1 * (dst[nt][2 + j] - dl);
          pt[nt][j] = p0;
          pt[nt][2 + j] = p1;
        }
      }
      mma_pv<D, kN>(dv_acc, pt, do_s, n0, g, t);  // dV += bf16(P)^T dO
      mma_pv<D, kN>(dk_acc, dst, q_s, n0, g, t);  // dK += bf16(dS)^T Q
    }
  }
  store_rows<D>(dk + k_off, dk_acc, scale, r0, r1, Lk, t);
  store_rows<D>(dv + k_off, dv_acc, 1.f, r0, r1, Lk, t);
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
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     int H, int Lq, int Lk, int n_q_tiles, int mask_b_stride,
                     float scale) {
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
  const float dl = row < Lq ? delta[static_cast<size_t>(bh) * Lq + row] : 0.f;

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

// One launcher for both kernels: kDq picks which; for the dK/dV kernel
// `out` is dk and `out2` dv.
template <bool kDq>
int launch_bwd(const void* q, const void* k, const void* v, const void* mask,
               const void* dout, const void* lse, const void* delta, void* out,
               void* out2, int B, int H, int Lq, int Lk, int D, int mask_b_stride,
               int is_bf16, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return cudaErrorInvalidValue;
  if (D != 32 && D != 64 && D != 128) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const int32_t*>(mask);
  const auto* ls = static_cast<const float*>(lse);
  const auto* dl = static_cast<const float*>(delta);
  const int rows = kDq ? Lq : Lk;
  if (is_bf16) {
    using T = __nv_bfloat16;
    const int n = (rows + kTile - 1) / kTile;
    const dim3 grid(static_cast<unsigned>(n) * B * H);
    const T *qq = static_cast<const T*>(q), *kk = static_cast<const T*>(k),
            *vv = static_cast<const T*>(v), *dd = static_cast<const T*>(dout);
    T *o1 = static_cast<T*>(out), *o2 = static_cast<T*>(out2);
#define LAUNCH_BF16(DIM)                                                                   \
  if constexpr (kDq)                                                                          \
    flash_bwd_dq_bf16<DIM><<<grid, kThreads, 0, st>>>(qq, kk, vv, m, dd, ls, dl, o1, H, Lq, \
                                                      Lk, n, mask_b_stride, scale);        \
  else                                                                                     \
    flash_bwd_dkv_bf16<DIM><<<grid, kThreads, 0, st>>>(qq, kk, vv, m, dd, ls, dl, o1, o2,  \
                                                       H, Lq, Lk, n, mask_b_stride, scale)
    switch (D) {
      case 32: LAUNCH_BF16(32); break;
      case 64: LAUNCH_BF16(64); break;
      default: LAUNCH_BF16(128); break;
    }
#undef LAUNCH_BF16
  } else {
    const int n = (rows + kRowsF32 - 1) / kRowsF32;
    const dim3 grid(static_cast<unsigned>(n) * B * H);
    const float *qq = static_cast<const float*>(q), *kk = static_cast<const float*>(k),
                *vv = static_cast<const float*>(v), *dd = static_cast<const float*>(dout);
    float *o1 = static_cast<float*>(out), *o2 = static_cast<float*>(out2);
#define LAUNCH_F32(DIM)                                                                   \
  if constexpr (kDq)                                                                         \
    flash_bwd_dq_f32<DIM><<<grid, kThreads, 0, st>>>(qq, kk, vv, m, dd, ls, dl, o1, H, Lq, \
                                                     Lk, n, mask_b_stride, scale);        \
  else                                                                                    \
    flash_bwd_dkv_f32<DIM><<<grid, kThreads, 0, st>>>(qq, kk, vv, m, dd, ls, dl, o1, o2,  \
                                                      H, Lq, Lk, n, mask_b_stride, scale)
    switch (D) {
      case 32: LAUNCH_F32(32); break;
      case 64: LAUNCH_F32(64); break;
      default: LAUNCH_F32(128); break;
    }
#undef LAUNCH_F32
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, dout: [B, H, Lq, D]; k, v: [B, H, Lk, D]; all contiguous and of one
// type (bf16 when is_bf16, else f32). mask: int32 [B or 1, Lk]
// (mask_b_stride = Lk or 0), > 0 = attend. lse, delta: f32 [B, H, Lq].
// D in {32, 64, 128}. Each launches on `stream` and returns the launch's
// cudaError_t (0 = success).

// dq: [B, H, Lq, D], the type of q.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const void* mask, const void* dout, const void* lse,
                           const void* delta, void* dq, int B, int H, int Lq,
                           int Lk, int D, int mask_b_stride, int is_bf16,
                           float scale, void* stream) {
  return launch_bwd<true>(q, k, v, mask, dout, lse, delta, dq, nullptr, B, H, Lq,
                          Lk, D, mask_b_stride, is_bf16, scale, stream);
}

// dk, dv: [B, H, Lk, D], the type of k.
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* mask, const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int B, int H,
                            int Lq, int Lk, int D, int mask_b_stride, int is_bf16,
                            float scale, void* stream) {
  return launch_bwd<false>(q, k, v, mask, dout, lse, delta, dk, dv, B, H, Lq, Lk,
                           D, mask_b_stride, is_bf16, scale, stream);
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
