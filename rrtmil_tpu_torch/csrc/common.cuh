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
// With folds (rf > 0) the regions of fold f are f * rf .. f * rf + rf - 1,
// and each fold has weights of its own, stacked on a leading fold axis.
struct TokenMap {
  int grid;  // G, or 0 for the contiguous (R, P, C) layout
  int rs;    // region side
  int nrs;   // regions per grid side
  int P;     // tokens per region
  int rf;    // regions per fold, or 0 for one fold
};

__host__ __device__ __forceinline__ int fold_of(const TokenMap& tm, int r) {
  return tm.rf > 0 ? r / tm.rf : 0;
}

// p moved to fold f's weights (f * fs elements on), null kept null
template <typename T> __device__ __forceinline__ T* fold_ptr(T* p, long long off) {
  return p ? p + off : p;
}

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

// z[t] = round_TM(mask[t] * LN(x[t])), one warp per token row.  The rows
// fall into gridDim.y folds of Mf rows; fold blockIdx.y's LayerNorm is ls,
// lb (F, C) row blockIdx.y (no division: one fold is the kernel as it was).
template <typename TS, typename TM>
__global__ void __launch_bounds__(256)
ln_mask_kernel(const TS* __restrict__ x, const uint8_t* __restrict__ mask,
               const float* __restrict__ ls, const float* __restrict__ lb,
               TM* __restrict__ z, long long Mf, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const long long tf = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (tf >= Mf) return;
  const long long t = blockIdx.y * Mf + tf;
  ls += blockIdx.y * C;
  lb += blockIdx.y * C;
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
// Operand descriptions.  The kernels read their operands where they lie,
// through strides (in elements), with unit stride along the last axis:
//
//  * RowsA: row m of A is region m / P, token m % P, at p + (m / P) * sr +
//    (m % P) * sp; a plain row-major (M, K) matrix is P = 1, sr = ld.
//  * Thirds: B (K, N) as up to three column blocks of nper columns (the
//    q | k | v thirds of a qkv weight, or one block), block t at p[t], all
//    with one layout: element (k, n) at (k / kdiv) * sk1 + (k % kdiv) * sk0
//    + (n / ndiv) * sn1 + (n % ndiv) * sn0, so a weight (H, C, hd) or
//    (H, hd, C) is read as the (C, H * hd) or (H * hd, C) matrix it is; one
//    of sk0, sn0 is 1.
//  * Bias3: the bias in the same blocks, contiguous float32, or null.
// With folds, fold f's B and bias start fs elements after fold f - 1's.
// ---------------------------------------------------------------------------
struct RowsA {
  const void* p;
  int P;
  long long sr, sp;
};
struct Thirds {
  const void* p[3];
  int nper, kdiv, ndiv;
  long long sk1, sk0, sn1, sn0;
  long long fs;  // fold stride (elements), 0 without folds
  __device__ __forceinline__ long long off(int k, int n) const {
    return (long long)(k / kdiv) * sk1 + (long long)(k % kdiv) * sk0 +
           (long long)(n / ndiv) * sn1 + (long long)(n % ndiv) * sn0;
  }
};
struct Bias3 {
  const float* p[3];
  int nper;
  long long fs;  // fold stride (elements), 0 without folds
  __device__ __forceinline__ Bias3 fold(int f) const {
    return Bias3{{fold_ptr(p[0], f * fs), fold_ptr(p[1], f * fs), fold_ptr(p[2], f * fs)},
                 nper, fs};
  }
  __device__ __forceinline__ float at(int n) const {
    const int t = n / nper;
    const float* q = t == 0 ? p[0] : t == 1 ? p[1] : p[2];  // no indexed param array
    return q ? q[n - t * nper] : 0.f;
  }
};

// element accessors of the SIMT product below, as fp32
template <typename T, bool TR> struct PlainMat {  // (i, j) of row-major or, TR, its transpose
  const T* p;
  int ld;
  long long fs;  // fold stride (elements) of a per-fold operand
  __device__ __forceinline__ PlainMat fold(int f) const { return PlainMat{p + f * fs, ld, fs}; }
  __device__ __forceinline__ float at(int i, int j) const {
    return to_f(TR ? p[(long long)j * ld + i] : p[(long long)i * ld + j]);
  }
};
template <typename T> struct RowsAt {
  RowsA a;
  __device__ __forceinline__ RowsAt fold(int) const { return *this; }
  __device__ __forceinline__ float at(int m, int k) const {
    return to_f(((const T*)a.p)[(long long)(m / a.P) * a.sr + (long long)(m % a.P) * a.sp + k]);
  }
};
template <typename T> struct ThirdsAt {
  Thirds b;
  __device__ __forceinline__ ThirdsAt fold(int f) const {
    ThirdsAt c = *this;
    for (int t = 0; t < 3; ++t)
      c.b.p[t] = b.p[t] ? (const void*)((const T*)b.p[t] + f * b.fs) : nullptr;
    return c;
  }
  __device__ __forceinline__ float at(int k, int n) const {
    const int t = n / b.nper;
    const T* q = (const T*)(t == 0 ? b.p[0] : t == 1 ? b.p[1] : b.p[2]);
    return to_f(q[b.off(k, n - t * b.nper)]);
  }
};

// ---------------------------------------------------------------------------
// Tiled product  out[M, N] = round_TM(A)[M, K] @ round_TM(B)[K, N] (+ bias[N])
//                            (* mask[row]) (+ resid[row, N]),  stored as TO.
// 128 x 128 tile per block of 256 threads, 8 x 8 outputs per thread, fp32
// FMA on the CUDA cores (so float inputs stay exact float products; no
// TF32): the f32-product path, and K2's transposed products.  AL / BL read
// A (m, k) and B (k, n); AT / BT only pick the load pattern that walks the
// operand's contiguous axis (AT: A stored as (K, M); BT: B stored as (N, K)).
// blockIdx.z splits K into chunks of kchunk, each chunk writing its own
// partial product at out + z * zstride (a later pass sums them in a fixed
// order, so no atomics and no order-dependent sums).
//
// Folds (GFold): the M rows fall into folds of Mf rows, each with its own B
// and bias (fold f's tiles are rows f Mf .. f Mf + Mf - 1 only, so no tile
// straddles two folds), or the K rows into folds of Kf rows, each split
// into kcpf chunks of its own (fold f's partials are chunks f kcpf ..
// f kcpf + kcpf - 1).  Mf = M and Kf = K is one fold: the kernel as it was.
// ---------------------------------------------------------------------------
constexpr int GBM = 128, GBN = 128, GBK = 8;

struct GFold {
  int Mf, Kf, kcpf;
};

template <typename TM, typename TO, class AL, class BL, bool AT, bool BT>
__global__ void __launch_bounds__(256)
gemm_kernel(AL A, BL B, TO* __restrict__ out, int ldc, int M, int N, int K, int kchunk,
            long long zstride, Bias3 bias, const uint8_t* __restrict__ rowmask,
            const TO* __restrict__ resid, int ldr, GFold fd) {
  __shared__ __align__(16) float As[GBK][GBM];
  __shared__ __align__(16) float Bs[GBK][GBN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int tpf = (fd.Mf + GBM - 1) / GBM, fm = blockIdx.y / tpf, fk = blockIdx.z / fd.kcpf;
  const int m0 = fm * fd.Mf + (blockIdx.y % tpf) * GBM, n0 = blockIdx.x * GBN;
  M = min(M, fm * fd.Mf + fd.Mf);
  const int kb = fk * fd.Kf + (blockIdx.z % fd.kcpf) * kchunk;
  const int ke = min(min(K, fk * fd.Kf + fd.Kf), kb + kchunk);
  B = B.fold(fm);
  bias = bias.fold(fm);
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
      As[a_k + (AT ? 0 : i)][a_m + (AT ? i : 0)] =
          (gm < M && gk < ke) ? round_to<TM>(A.at(gm, gk)) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gn = n0 + b_n + (BT ? 0 : i), gk = k0 + b_k + (BT ? i : 0);
      Bs[b_k + (BT ? i : 0)][b_n + (BT ? 0 : i)] =
          (gn < N && gk < ke) ? round_to<TM>(B.at(gk, gn)) : 0.f;
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
      float v = acc[i][j] + bias.at(gn);
      if (rowmask) v *= mrow;
      if (resid) v = to_f(resid[(long long)gm * ldr + gn]) + v;
      out[(long long)gm * ldc + gn] = from_f<TO>(v);
    }
  }
}

// K2's products: plain row-major operands (or their transposes), no epilogue.
// With F folds: A^T B (AT) sums each fold's K / F rows into chunks of its
// own; A B^T (BT) takes fold f's B b_fs elements on for its M / F rows.
template <typename TA, typename TB, typename TM, typename TO, bool AT, bool BT>
cudaError_t launch_gemm_ex(const void* A, int lda, const void* B, int ldb, void* out,
                           int ldc, int M, int N, int K, int kchunk,
                           long long zstride, int F, long long b_fs, cudaStream_t stream) {
  if (kchunk <= 0 || kchunk % GBK != 0 || F < 1) return cudaErrorInvalidValue;
  if (AT ? K % F != 0 : M % F != 0) return cudaErrorInvalidValue;
  const int Mf = AT ? M : M / F, Kf = AT ? K / F : K, kcpf = (Kf + kchunk - 1) / kchunk;
  dim3 grid((N + GBN - 1) / GBN, (AT ? 1 : F) * ((Mf + GBM - 1) / GBM), (AT ? F : 1) * kcpf);
  gemm_kernel<TM, TO, PlainMat<TA, AT>, PlainMat<TB, BT>, AT, BT><<<grid, 256, 0, stream>>>(
      PlainMat<TA, AT>{(const TA*)A, lda, 0}, PlainMat<TB, BT>{(const TB*)B, ldb, b_fs},
      (TO*)out, ldc, M, N, K, kchunk, zstride, Bias3{{nullptr, nullptr, nullptr}, N, 0},
      nullptr, nullptr, 0, GFold{Mf, Kf, kcpf});
  return cudaGetLastError();
}

// the forward's f32 product on described operands, K in one chunk; with
// folds of Mf rows, fold f's B and bias b.fs and bias.fs elements on
template <typename TA, typename TB, typename TO>
cudaError_t launch_gemm_simt(RowsA a, Thirds b, void* out, int ldc, int M, int N, int K,
                             Bias3 bias, const void* rowmask, const void* resid, int ldr,
                             int Mf, cudaStream_t stream) {
  const int kchunk = ((K + GBK - 1) / GBK) * GBK;
  dim3 grid((N + GBN - 1) / GBN, (M / Mf) * ((Mf + GBM - 1) / GBM), 1);
  gemm_kernel<float, TO, RowsAt<TA>, ThirdsAt<TB>, false, false><<<grid, 256, 0, stream>>>(
      RowsAt<TA>{a}, ThirdsAt<TB>{b}, (TO*)out, ldc, M, N, K, kchunk > 0 ? kchunk : GBK, 0,
      bias, (const uint8_t*)rowmask, (const TO*)resid, ldr, GFold{Mf, K, 1});
  return cudaGetLastError();
}

// out[n] = sum over s = 0..S-1 of part[s * N + n]: the second pass of every
// cross-block sum (weight and bias gradients), deterministic.  With many
// columns (the weight gradients' partials) a thread owns a column and adds
// its S rows in order; with few (bias and LayerNorm partials, hundreds to
// thousands of rows of 0.5-2 K columns) a block owns 32 columns (a lane
// each) and splits the rows into one stripe of consecutive rows a warp,
// each stripe summed in order and the stripes added in warp order.  The
// choice and the split depend on (S, N) alone, so every call on the same
// shapes gives the same bits.
constexpr long long REDUCE_WIDE = 32768;  // columns past which a thread owns one

__global__ void __launch_bounds__(256)
reduce_rows_kernel(const float* __restrict__ part, int S, long long N,
                   float* __restrict__ out) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  part += (long long)blockIdx.y * S * N;  // fold blockIdx.y's partials
  out += (long long)blockIdx.y * N;
  if (n >= N) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += part[(long long)s * N + n];
  out[n] = acc;
}

__global__ void __launch_bounds__(1024)
reduce_rows_striped_kernel(const float* __restrict__ part, int S, long long N,
                           float* __restrict__ out) {
  __shared__ float stripe[32][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, W = blockDim.x >> 5;
  part += (long long)blockIdx.y * S * N;
  out += (long long)blockIdx.y * N;
  const long long n = (long long)blockIdx.x * 32 + lane;
  const int s0 = (int)((long long)S * w / W), s1 = (int)((long long)S * (w + 1) / W);
  float acc = 0.f;
  if (n < N) {
#pragma unroll 4
    for (int s = s0; s < s1; ++s) acc += part[(long long)s * N + n];
  }
  stripe[w][lane] = acc;
  __syncthreads();
  if (w == 0 && n < N) {
    float t = 0.f;
    for (int v = 0; v < W; ++v) t += stripe[v][lane];
    out[n] = t;
  }
}

// With F folds, part is (F, S, N) and out (F, N): each fold's S rows
// summed as one fold's are.
inline cudaError_t launch_reduce_rows(const void* part, int S, long long N, void* out,
                                      cudaStream_t stream, int F = 1) {
  if (S <= 0 || N <= 0 || F < 1) return cudaErrorInvalidValue;
  if (N >= REDUCE_WIDE || S < 32) {
    reduce_rows_kernel<<<dim3((unsigned)((N + 255) / 256), F), 256, 0, stream>>>(
        (const float*)part, S, N, (float*)out);
  } else {
    reduce_rows_striped_kernel<<<dim3((unsigned)((N + 31) / 32), F), 1024, 0, stream>>>(
        (const float*)part, S, N, (float*)out);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Attention operands, read where they lie: element d of head h of token p of
// region r at p + row(r, p) + h * sh + d, where row(r, p) = token_of(r, p) *
// sp on K1's grid token map (grid > 0) and r * sr + p * sp otherwise.
// ---------------------------------------------------------------------------
struct Opnd {
  const void* p;
  long long sr, sh, sp;
};

__device__ __forceinline__ long long row_of(const TokenMap& tm, const Opnd& o, int r, int p) {
  return tm.grid ? token_of(tm, r, p) * o.sp : (long long)r * o.sr + (long long)p * o.sp;
}

// ---------------------------------------------------------------------------
// Attention core of one (region, head), 64 query rows and one 64-wide chunk
// of the head's output columns per block, with the EPEG Toeplitz pass on q
// and an exact two-pass softmax over key tiles.  This is the f32-product
// path (strict parity); bf16 products run the tensor-core core (tc.cuh).
//
//   q'  = round_TM(M_h round_TM(q s)),  M_h = round_TM(I + T_h)  (kk > 0)
//   L   = q' k^T (+ pb_h when kk > 0 and pb is given)
//   A   = round_TM(exp(L - max) / sum)                (row softmax)
//   o   = A v, stored as TO (the TM rounding when TO = TM)
//
// The logits sum over the whole head width hd (a multiple of 32, <= 512)
// chunk by chunk; each block (blockIdx.z = output chunk) accumulates only
// its own 64 columns of o.  A width that is not a multiple of 64 (32, 96,
// ...) is held as the next multiple of 64 (head_chunks), the columns past
// hd read as zeros and never written: a zero column adds exact zeros to
// every fp32 sum, so the logits and outputs are those of the hd columns.
// With EPEG the k-tap pass runs a 64-wide column chunk at a time through
// the halo buffer (any hd up to 128).  Pass 1 walks the key tiles for the row max and
// sum (online), pass 2 recomputes each logit tile and accumulates A v, so
// no P x P tile is ever held and the probabilities are normalised before
// the TM rounding, as in the TPU kernel.  Key columns past P (tile padding)
// are masked; the bucket's zero tokens are real keys.
// ---------------------------------------------------------------------------
constexpr int AQT = 64, AKT = 64, ADC = 64;
constexpr int MAX_KK = 128, MAX_HD = 512;
constexpr int MAX_EPEG_HD = 128;  // widest head the cores take with EPEG

// 64-wide column chunks of a head of hd columns (hd a multiple of 32)
__host__ __device__ __forceinline__ int head_chunks(int hd) { return (hd + 63) / 64; }

inline int attn_smem_bytes(int hd) {
  return (AQT * (64 * head_chunks(hd) + 4) + ADC * AKT + AKT * ADC + AQT * (AKT + 4)) * 4;
}

template <typename TI, typename TM, typename TO>
__global__ void __launch_bounds__(256)
attn_kernel(Opnd q, Opnd k, Opnd v, Opnd o, int H, int hd, TokenMap tm, float scale,
            const float* __restrict__ pw, int kk, const float* __restrict__ pb) {
  const int nch = head_chunks(hd), QS = nch * ADC + 4, PS = AKT + 4;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // [AQT][QS]  the whole head width
  float* Kt = Qs + AQT * QS;     // [ADC][AKT]  one chunk of k, transposed
  float* Vs = Kt + ADC * AKT;    // [AKT][ADC]  the block's chunk of v
  float* Ps = Vs + AKT * ADC;    // [AQT][PS]
  __shared__ float coef[MAX_KK];

  const int P = tm.P;
  const int r = blockIdx.x / H, h = blockIdx.x % H, hw = fold_of(tm, r) * H + h;
  const int q0 = blockIdx.y * AQT, oc = blockIdx.z * ADC, ow = min(ADC, hd - oc);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const TI* qp = (const TI*)q.p + (long long)h * q.sh;
  const TI* kp = (const TI*)k.p + (long long)h * k.sh;
  const TI* vp = (const TI*)v.p + (long long)h * v.sh + oc;

  if (kk > 0) {  // hd <= 128: the k-tap pass a 64-wide chunk at a time
    const int pad = kk / 2;
    for (int t = tid; t < kk; t += blockDim.x)
      coef[t] = round_to<TM>(pw[hw * kk + t] + (t == pad ? 1.f : 0.f));
    float* Hs = Kt;  // halo rows q0-pad .. q0+AQT-1+(kk-1-pad), reuses Kt..Ps
    const int nh = AQT + kk - 1;
    for (int c = 0; c < nch; ++c) {
      const int cw = min(ADC, hd - c * ADC);
      if (c > 0) __syncthreads();  // every thread done with chunk c - 1's halo
      for (int idx = tid; idx < nh * ADC; idx += blockDim.x) {
        const int row = idx / ADC, d = idx % ADC;
        const int p = q0 - pad + row;
        Hs[idx] = (p >= 0 && p < P && d < cw)
                      ? round_to<TM>(to_f(qp[row_of(tm, q, r, p) + c * ADC + d]) * scale)
                      : 0.f;
      }
      __syncthreads();
      for (int idx = tid; idx < AQT * ADC; idx += blockDim.x) {
        const int i = idx / ADC, d = idx % ADC;
        float acc = 0.f;
        for (int t = 0; t < kk; ++t) acc = fmaf(coef[t], Hs[(i + t) * ADC + d], acc);
        Qs[i * QS + c * ADC + d] = round_to<TM>(acc);
      }
    }
  } else {
    const int hp = nch * ADC;
    for (int idx = tid; idx < AQT * hp; idx += blockDim.x) {
      const int i = idx / hp, d = idx % hp;
      const int p = q0 + i;
      Qs[i * QS + d] = (p < P && d < hd)
                           ? round_to<TM>(to_f(qp[row_of(tm, q, r, p) + d]) * scale)
                           : 0.f;
    }
  }
  __syncthreads();

  const float bias = (kk > 0 && pb != nullptr) ? pb[hw] : 0.f;
  float mrow[4], srow[4], s[4][4], oacc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = -INFINITY;
    srow[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) oacc[i][c] = 0.f;
  }

  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < P; k0 += AKT) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      for (int c = 0; c < nch; ++c) {
        for (int idx = tid; idx < AKT * ADC; idx += blockDim.x) {
          const int j = idx / ADC, d = idx % ADC;
          const int p = k0 + j;
          float kv = 0.f, vv = 0.f;
          if (p < P) {
            if (c * ADC + d < hd)
              kv = round_to<TM>(to_f(kp[row_of(tm, k, r, p) + c * ADC + d]));
            if (pass == 1 && c == 0 && d < ow)
              vv = round_to<TM>(to_f(vp[row_of(tm, v, r, p) + d]));
          }
          Kt[d * AKT + j] = kv;
          if (pass == 1 && c == 0) Vs[j * ADC + d] = vv;
        }
        __syncthreads();
#pragma unroll 8
        for (int d = 0; d < ADC; ++d) {
          const float4 b = *reinterpret_cast<const float4*>(&Kt[d * AKT + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a = Qs[(ty * 4 + i) * QS + c * ADC + d];
            s[i][0] = fmaf(a, b.x, s[i][0]);
            s[i][1] = fmaf(a, b.y, s[i][1]);
            s[i][2] = fmaf(a, b.z, s[i][2]);
            s[i][3] = fmaf(a, b.w, s[i][3]);
          }
        }
        __syncthreads();
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
          const float4 vv = *reinterpret_cast<const float4*>(&Vs[j * ADC + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a = Ps[(ty * 4 + i) * PS + j];
            oacc[i][0] = fmaf(a, vv.x, oacc[i][0]);
            oacc[i][1] = fmaf(a, vv.y, oacc[i][1]);
            oacc[i][2] = fmaf(a, vv.z, oacc[i][2]);
            oacc[i][3] = fmaf(a, vv.w, oacc[i][3]);
          }
        }
        __syncthreads();
      }
    }
  }

  TO* op = (TO*)o.p + (long long)h * o.sh + oc + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = q0 + ty * 4 + i;
    if (p >= P) continue;
    TO* orow = op + row_of(tm, o, r, p);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (tx * 4 + c < ow) orow[c] = from_f<TO>(oacc[i][c]);
  }
}

}  // namespace rrt

// dtype codes shared with the Python wrappers: 0 = float32, 1 = bfloat16
#define RRT_DISPATCH(code, T, ...)                  \
  switch (code) {                                   \
    case 0: { typedef float T; __VA_ARGS__; break; } \
    case 1: { typedef rrt::bf16 T; __VA_ARGS__; break; } \
    default: return (int)cudaErrorInvalidValue;     \
  }
