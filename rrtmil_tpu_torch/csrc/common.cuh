// Building blocks shared by the port's hand-written Hopper kernels.
//
// Each .cu file in this directory is compiled on its own by nvcc into a
// shared library with a plain C interface (ops/kernels/build.py) and bound
// with ctypes.  Every C entry launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError().
//
// Types: the stream dtype TS and the product-input ("mm") dtype TM are
// float or __nv_bfloat16 (dtype code 0 / 1).  All sums are fp32.  Values are
// rounded to TM exactly where the JAX package's Pallas kernels cast to
// their mm dtype, so the plain PyTorch versions can mirror them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rrt {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T and back (the identity for float)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v, int width = 32) {
  for (int o = width / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o, width);
  return v;
}
__device__ __forceinline__ float warp_max(float v, int width = 32) {
  for (int o = width / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o, width));
  return v;
}
__device__ __forceinline__ float warp_min(float v, int width = 32) {
  for (int o = width / 2; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o, width));
  return v;
}

// Channels one lane holds when a warp owns one token row: C <= 32 * CPL.
constexpr int CPL = 32;

// Where token p of region r lives in the (B, G*G, C) stream.  grid == 0
// means the regions are already contiguous: row r * P + p of (R, P, C).
struct TokenMap {
  int grid;  // G, or 0 for the contiguous (R, P, C) layout
  int rs;    // region side
  int nrs;   // regions per grid side
  int P;     // tokens per region
};

__device__ __forceinline__ long long token_of(const TokenMap& tm, int r, int p) {
  if (tm.grid == 0) return (long long)r * tm.P + p;
  const int nr = tm.nrs * tm.nrs;
  const int b = r / nr, rr = r % nr;
  const int ri = rr / tm.nrs, rj = rr % tm.nrs;
  const int pi = p / tm.rs, pj = p % tm.rs;
  return (long long)b * tm.grid * tm.grid +
         (long long)(ri * tm.rs + pi) * tm.grid + rj * tm.rs + pj;
}

// One LayerNorm output value, ((v - mu) * rstd) * s + b, then times the row
// mask, rounded op by op (no FMA contraction) so every kernel that
// recomputes z gets the same bits.
__device__ __forceinline__ float ln_apply(float v, float mu, float rstd, float s,
                                          float b, float m) {
  return __fmul_rn(__fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mu), rstd), s), b), m);
}

// Mean and 1/sqrt(var + eps) of one token row held by a warp (flax fast
// variance: var = max(0, E[x^2] - mu^2)); vals[i] is channel lane + 32 * i.
__device__ __forceinline__ void warp_ln_stats(const float (&vals)[CPL], int C, int lane,
                                              float eps, float& mu, float& rstd) {
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    if (c < C) { s += vals[i]; s2 += vals[i] * vals[i]; }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  mu = s / C;
  const float var = fmaxf(0.f, s2 / C - mu * mu);
  rstd = 1.f / sqrtf(var + eps);
}

// ---------------------------------------------------------------------------
// LayerNorm (flax fast variance: var = max(0, E[x^2] - mu^2), eps given)
// of one token row held by a warp, times the row mask.  vals[i] holds channel
// lane + 32 * i on entry (as fp32) and the normalised, masked value on exit.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void warp_ln_mask(float (&vals)[CPL], int C, int lane,
                                             const float* ls, const float* lb,
                                             float m, float eps) {
  float mu, rstd;
  warp_ln_stats(vals, C, lane, eps, mu, rstd);
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    if (c < C) vals[i] = ln_apply(vals[i], mu, rstd, ls[c], lb[c], m);
  }
}

// z[t] = round_TM(mask[t] * LN(x[t])), one warp per token row.
template <typename TS, typename TM>
__global__ void __launch_bounds__(256)
ln_mask_kernel(const TS* __restrict__ x, const uint8_t* __restrict__ mask,
               const float* __restrict__ ls, const float* __restrict__ lb,
               TM* __restrict__ z, long long M, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (t >= M) return;
  const TS* xr = x + t * C;
  float vals[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    vals[i] = c < C ? to_f(xr[c]) : 0.f;
  }
  warp_ln_mask(vals, C, lane, ls, lb, mask[t] ? 1.f : 0.f, eps);
  TM* zr = z + t * C;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    if (c < C) zr[c] = from_f<TM>(vals[i]);
  }
}

// ---------------------------------------------------------------------------
// Tiled product  out[M, N] = round_TM(A)[M, K] @ round_TM(B)[K, N] (+ bias[N])
//                            (* mask[row]) (+ resid[row, N]),  stored as TO.
// 128 x 128 tile per block of 256 threads, 8 x 8 outputs per thread, fp32
// FMA on the CUDA cores (so float inputs stay exact float products; no
// TF32).  A is row-major (M, K) with row stride lda, or, with AT, stored
// transposed as (K, M); B is row-major (K, N) (ldb), or, with BT, stored as
// (N, K).  blockIdx.z splits K into chunks of kchunk, each chunk writing its
// own partial product at out + z * zstride (a later pass sums them in a
// fixed order, so no atomics and no order-dependent sums).
// ---------------------------------------------------------------------------
constexpr int GBM = 128, GBN = 128, GBK = 8;

template <typename TA, typename TB, typename TM, typename TO, bool AT, bool BT>
__global__ void __launch_bounds__(256)
gemm_kernel(const TA* __restrict__ A, int lda, const TB* __restrict__ B, int ldb,
            TO* __restrict__ out, int ldc, int M, int N, int K, int kchunk,
            long long zstride, const float* __restrict__ bias,
            const uint8_t* __restrict__ rowmask, const TO* __restrict__ resid,
            int ldr) {
  __shared__ __align__(16) float As[GBK][GBM];
  __shared__ __align__(16) float Bs[GBK][GBN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int kb = blockIdx.z * kchunk;
  const int ke = min(K, kb + kchunk);
  out += (long long)blockIdx.z * zstride;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // each thread loads 4 consecutive elements along the operand's rows
  const int a_m = AT ? (tid & 31) * 4 : tid >> 1, a_k = AT ? tid >> 5 : (tid & 1) * 4;
  const int b_n = BT ? tid >> 1 : (tid & 31) * 4, b_k = BT ? (tid & 1) * 4 : tid >> 5;

  for (int k0 = kb; k0 < ke; k0 += GBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + a_m + (AT ? i : 0), gk = k0 + a_k + (AT ? 0 : i);
      float v = 0.f;
      if (gm < M && gk < ke)
        v = round_to<TM>(to_f(AT ? A[(long long)gk * lda + gm] : A[(long long)gm * lda + gk]));
      As[a_k + (AT ? 0 : i)][a_m + (AT ? i : 0)] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gn = n0 + b_n + (BT ? 0 : i), gk = k0 + b_k + (BT ? i : 0);
      float v = 0.f;
      if (gn < N && gk < ke)
        v = round_to<TM>(to_f(BT ? B[(long long)gn * ldb + gk] : B[(long long)gk * ldb + gn]));
      Bs[b_k + (BT ? i : 0)][b_n + (BT ? 0 : i)] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 8 + 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + ty * 8 + i;
    if (gm >= M) continue;
    const float mrow = rowmask ? (rowmask[gm] ? 1.f : 0.f) : 1.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + tx * 8 + j;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (bias) v += bias[gn];
      if (rowmask) v *= mrow;
      if (resid) v = to_f(resid[(long long)gm * ldr + gn]) + v;
      out[(long long)gm * ldc + gn] = from_f<TO>(v);
    }
  }
}

template <typename TA, typename TB, typename TM, typename TO, bool AT, bool BT>
cudaError_t launch_gemm_ex(const void* A, int lda, const void* B, int ldb, void* out,
                           int ldc, int M, int N, int K, int kchunk,
                           long long zstride, const void* bias, const void* rowmask,
                           const void* resid, int ldr, cudaStream_t stream) {
  if (kchunk <= 0 || kchunk % GBK != 0) return cudaErrorInvalidValue;
  dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM, (K + kchunk - 1) / kchunk);
  gemm_kernel<TA, TB, TM, TO, AT, BT><<<grid, 256, 0, stream>>>(
      (const TA*)A, lda, (const TB*)B, ldb, (TO*)out, ldc, M, N, K, kchunk, zstride,
      (const float*)bias, (const uint8_t*)rowmask, (const TO*)resid, ldr);
  return cudaGetLastError();
}

// the forward's product: B already in TM, K in one chunk
template <typename TA, typename TM, typename TO>
cudaError_t launch_gemm(const void* A, int lda, const void* B, int ldb, void* out,
                        int ldc, int M, int N, int K, const void* bias,
                        const void* rowmask, const void* resid, int ldr,
                        cudaStream_t stream) {
  const int kchunk = ((K + GBK - 1) / GBK) * GBK;
  return launch_gemm_ex<TA, TM, TM, TO, false, false>(
      A, lda, B, ldb, out, ldc, M, N, K, kchunk > 0 ? kchunk : GBK, 0, bias,
      rowmask, resid, ldr, stream);
}

// out[n] = sum over s = 0..S-1 of part[s * N + n], in that order: the second
// pass of every cross-block sum (weight and bias gradients), deterministic.
__global__ void __launch_bounds__(256)
reduce_rows_kernel(const float* __restrict__ part, int S, long long N,
                   float* __restrict__ out) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += part[(long long)s * N + n];
  out[n] = acc;
}

inline cudaError_t launch_reduce_rows(const void* part, int S, long long N, void* out,
                                      cudaStream_t stream) {
  if (S <= 0 || N <= 0) return cudaErrorInvalidValue;
  reduce_rows_kernel<<<(unsigned)((N + 255) / 256), 256, 0, stream>>>(
      (const float*)part, S, N, (float*)out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Attention core of one (region, head), 64 query rows per block, with the
// EPEG Toeplitz pass on q and an exact two-pass softmax over key tiles.
//
//   q'  = round_TM(M_h q),  M_h = round_TM(I + T_h)   (k-tap pass, kk > 0)
//   L   = q' k^T (+ pb_h when kk > 0 and pb is given)
//   A   = round_TM(exp(L - max) / sum)                (row softmax)
//   o   = A v, stored as TO (the TM rounding when TO = TM)
//
// Pass 1 walks the key tiles for the row max and sum (online), pass 2
// recomputes each logit tile and accumulates A v, so no P x P tile is ever
// held and the probabilities are normalised before the TM rounding, as in
// the TPU kernel.  q, k, v are read from Y (M, ldy) at the token of each
// region row (TokenMap): q at column h*HD, k at kcol0 + h*HD, v at
// vcol0 + h*HD; o goes to O (M, ldo) at column h*HD.  Key columns past P
// (tile padding) are masked; the bucket's zero tokens are real keys.
// ---------------------------------------------------------------------------
constexpr int AQT = 64, AKT = 64;
constexpr int MAX_KK = 128;

template <int HD>
constexpr int attn_smem_bytes() {
  return (AQT * (HD + 4) + HD * AKT + AKT * HD + AQT * (AKT + 4)) * 4;
}

template <typename TM, typename TO, int HD>
__global__ void __launch_bounds__(256)
attn_kernel(const TM* __restrict__ Y, int ldy, int kcol0, int vcol0,
            TO* __restrict__ O, int ldo, int H, TokenMap tm,
            const float* __restrict__ pw, int kk, const float* __restrict__ pb) {
  static_assert(HD == 64, "thread layout assumes 64-wide heads");
  constexpr int QS = HD + 4, PS = AKT + 4;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // [AQT][QS]
  float* Kt = Qs + AQT * QS;     // [HD][AKT]  (k transposed)
  float* Vs = Kt + HD * AKT;     // [AKT][HD]
  float* Ps = Vs + AKT * HD;     // [AQT][PS]
  __shared__ float coef[MAX_KK];

  const int P = tm.P;
  const int r = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * AQT;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qcol = h * HD, kcol = kcol0 + h * HD, vcol = vcol0 + h * HD;

  if (kk > 0) {
    const int pad = kk / 2;
    for (int t = tid; t < kk; t += blockDim.x)
      coef[t] = round_to<TM>(pw[h * kk + t] + (t == pad ? 1.f : 0.f));
    float* Hs = Kt;  // halo rows q0-pad .. q0+AQT-1+(kk-1-pad), reuses Kt..Ps
    const int nh = AQT + kk - 1;
    for (int idx = tid; idx < nh * HD; idx += blockDim.x) {
      const int row = idx / HD, d = idx % HD;
      const int p = q0 - pad + row;
      Hs[idx] = (p >= 0 && p < P) ? to_f(Y[token_of(tm, r, p) * ldy + qcol + d]) : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < AQT * HD; idx += blockDim.x) {
      const int i = idx / HD, d = idx % HD;
      float acc = 0.f;
      for (int t = 0; t < kk; ++t) acc = fmaf(coef[t], Hs[(i + t) * HD + d], acc);
      Qs[i * QS + d] = round_to<TM>(acc);
    }
  } else {
    for (int idx = tid; idx < AQT * HD; idx += blockDim.x) {
      const int i = idx / HD, d = idx % HD;
      const int p = q0 + i;
      Qs[i * QS + d] = p < P ? to_f(Y[token_of(tm, r, p) * ldy + qcol + d]) : 0.f;
    }
  }
  __syncthreads();

  const float bias = (kk > 0 && pb != nullptr) ? pb[h] : 0.f;
  float mrow[4], srow[4], s[4][4], o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = -INFINITY;
    srow[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) o[i][c] = 0.f;
  }

  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < P; k0 += AKT) {
      for (int idx = tid; idx < AKT * HD; idx += blockDim.x) {
        const int j = idx / HD, d = idx % HD;
        const int p = k0 + j;
        float kv = 0.f, vv = 0.f;
        if (p < P) {
          const long long row = token_of(tm, r, p) * ldy;
          kv = to_f(Y[row + kcol + d]);
          if (pass == 1) vv = to_f(Y[row + vcol + d]);
        }
        Kt[d * AKT + j] = kv;
        if (pass == 1) Vs[j * HD + d] = vv;
      }
      __syncthreads();

#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        const float4 b = *reinterpret_cast<const float4*>(&Kt[d * AKT + tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = Qs[(ty * 4 + i) * QS + d];
          s[i][0] = fmaf(a, b.x, s[i][0]);
          s[i][1] = fmaf(a, b.y, s[i][1]);
          s[i][2] = fmaf(a, b.z, s[i][2]);
          s[i][3] = fmaf(a, b.w, s[i][3]);
        }
      }

      if (pass == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float tmax = -INFINITY;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool valid = k0 + tx * 4 + j < P;
            s[i][j] = valid ? s[i][j] + bias : -INFINITY;
            tmax = fmaxf(tmax, s[i][j]);
          }
          tmax = warp_max(tmax, 16);
          const float mnew = fmaxf(mrow[i], tmax);
          float tsum = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) tsum += expf(s[i][j] - mnew);
          tsum = warp_sum(tsum, 16);
          srow[i] = srow[i] * expf(mrow[i] - mnew) + tsum;
          mrow[i] = mnew;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool valid = k0 + tx * 4 + j < P;
            Ps[(ty * 4 + i) * PS + tx * 4 + j] =
                valid ? round_to<TM>(expf(s[i][j] + bias - mrow[i]) / srow[i]) : 0.f;
          }
        __syncthreads();
#pragma unroll 8
        for (int j = 0; j < AKT; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(&Vs[j * HD + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a = Ps[(ty * 4 + i) * PS + j];
            o[i][0] = fmaf(a, v.x, o[i][0]);
            o[i][1] = fmaf(a, v.y, o[i][1]);
            o[i][2] = fmaf(a, v.z, o[i][2]);
            o[i][3] = fmaf(a, v.w, o[i][3]);
          }
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = q0 + ty * 4 + i;
    if (p >= P) continue;
    TO* orow = O + token_of(tm, r, p) * ldo + qcol + tx * 4;
#pragma unroll
    for (int c = 0; c < 4; ++c) orow[c] = from_f<TO>(o[i][c]);
  }
}

template <typename TM, typename TO>
cudaError_t launch_attention(const void* Y, int ldy, int kcol0, int vcol0, void* O,
                             int ldo, int R, int H, TokenMap tm, const void* pw,
                             int kk, const void* pb, cudaStream_t stream) {
  constexpr int smem = attn_smem_bytes<64>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<TM, TO, 64>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(R * H, (tm.P + AQT - 1) / AQT);
  attn_kernel<TM, TO, 64><<<grid, 256, smem, stream>>>(
      (const TM*)Y, ldy, kcol0, vcol0, (TO*)O, ldo, H, tm, (const float*)pw, kk,
      (const float*)pb);
  return cudaGetLastError();
}

}  // namespace rrt

// dtype codes shared with the Python wrappers: 0 = float32, 1 = bfloat16
#define RRT_DISPATCH(code, T, ...)                  \
  switch (code) {                                   \
    case 0: { typedef float T; __VA_ARGS__; break; } \
    case 1: { typedef rrt::bf16 T; __VA_ARGS__; break; } \
    default: return (int)cudaErrorInvalidValue;     \
  }
