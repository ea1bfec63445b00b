// The CR-MSA layer's shared pieces: K3 / K12 (crmsa.cu) and their backward
// K4 (crmsa_bwd.cu) read the stream in one layout, described here; the
// redistribution's kernels (K8, K10 in crmsa.cu; K9, K11 in crmsa_bwd.cu)
// in another, a warp a row (load_row4, and stream_ln: K8's stream value and
// LayerNorm statistics, which K9 recomputes).
//
// A region's P token rows are split over blocks (blockIdx.x the region,
// blockIdx.y the chunk of `chunk` rows, chosen by crmsa_kernels.row_split
// so that a B = 1 slide or a 64-region survival bag still puts two blocks on
// every SM).  Two passes over the region's rows, both with 16-byte loads
// (4 float or 8 bf16 channels):
//  * pass 1 (compress_rows_kernel) gives a token row to a warp for what
//    needs a sum over the row's channels: its LayerNorm statistics, its k
//    logits and, in K4, the row's other k-wide dot products.  A few floats
//    a row go to scratch.
//  * pass 2 (compress_reps_kernel, compress_bwd_kernel) first reduces what
//    crosses the region's rows -- the softmax's max and sum, min and max,
//    K4's sums over P -- from that scratch, in one fixed order in every
//    block of the region, and forms each row's scalars (combine rounded to
//    TM once normalised by the region's sums, w, K4's logit gradient and
//    LayerNorm-backward means) a thread a row.  Then it streams the rows:
//    a thread owns one 16-byte channel group of one row slot, several rows
//    in flight, and keeps its channels' sums over the rows (reps; dls, dlb,
//    dphi) in registers; no per-row reduction is left.  The slots' sums
//    are added in slot order, and the blocks' in a fixed order by
//    launch_reduce_rows.
// No atomics: every call on the same inputs gives the same bits.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace rrt {

constexpr int KMAX = 16;                    // CR-MSA representatives per region (crmsa_k)
constexpr int CR_THREADS = 256;             // threads of a block (pass 2: at most)
constexpr int CR_SMEM_MAX = 227 * 1024;

// elements of T in one 16-byte load
template <typename T> __host__ __device__ constexpr int vec_width() { return 16 / (int)sizeof(T); }

// channels of a row rounded up to whole 16-byte groups: the row stride of
// the shared-memory channel vectors (zero past C)
template <typename T> __host__ __device__ inline int padded_channels(int C) {
  return (C + vec_width<T>() - 1) / vec_width<T>() * vec_width<T>();
}

// 16 bytes at p as fp32 (p 16-byte aligned), and back
__device__ __forceinline__ void ld16(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void ld16(const bf16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void st16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st16(bf16* p, const float* v) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    w[e] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = u;
}

// VW floats of a shared-memory channel vector (16-byte aligned), as float4s
template <int VW>
__device__ __forceinline__ void lds(const float* p, float* v) {
#pragma unroll
  for (int h = 0; h < VW / 4; ++h) {
    const float4 t = reinterpret_cast<const float4*>(p)[h];
    v[4 * h] = t.x; v[4 * h + 1] = t.y; v[4 * h + 2] = t.z; v[4 * h + 3] = t.w;
  }
}

// The channel group c0 .. c0 + VW - 1 of a row as fp32, zero past C: one
// 16-byte load (vec: C % VW == 0 and an aligned base) or VW element loads
template <typename TS>
__device__ __forceinline__ void load_group(const TS* __restrict__ row, int c0, int C, bool vec,
                                           float* v) {
  constexpr int VW = vec_width<TS>();
  if (vec) {
    ld16(row + c0, v);
  } else {
#pragma unroll
    for (int e = 0; e < VW; ++e) v[e] = c0 + e < C ? to_f(row[c0 + e]) : 0.f;
  }
}
template <typename TS>
__device__ __forceinline__ void store_group(TS* __restrict__ row, int c0, int C, bool vec,
                                            const float* v) {
  constexpr int VW = vec_width<TS>();
  if (vec) {
    st16(row + c0, v);
  } else {
#pragma unroll
    for (int e = 0; e < VW; ++e)
      if (c0 + e < C) row[c0 + e] = from_f<TS>(v[e]);
  }
}

// The row held by a warp: v[VW i + e] is channel VW (lane + 32 i) + e, zero
// past C
template <typename TS, int NC>
__device__ __forceinline__ void load_row(const TS* __restrict__ row, int C, int lane, bool vec,
                                         float (&v)[NC]) {
  constexpr int VW = vec_width<TS>(), NQ = NC / VW;
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const int c0 = VW * (lane + 32 * i);
    if (c0 < C) {
      load_group<TS>(row, c0, C, vec, &v[VW * i]);
    } else {
#pragma unroll
      for (int e = 0; e < VW; ++e) v[VW * i + e] = 0.f;
    }
  }
}

// The slot of block (region, part pt of parts) among per-block partials
// that are summed per fold: fold f's blocks are consecutive, in (part,
// region) order, so one fold (rf = 0) is the order pt * R + region.
__device__ __forceinline__ long long fold_slot(const TokenMap& tm, int region, int R, int pt,
                                               int parts) {
  const int rf = tm.rf > 0 ? tm.rf : R, f = region / rf;
  return ((long long)f * parts + pt) * rf + (region - f * rf);
}

// Region r's token 0 in the stream, and its token p from there: the grid
// map's divisions once a block, one a row
__device__ __forceinline__ long long region_base(const TokenMap& tm, int r) {
  return token_of(tm, r, 0);
}
__device__ __forceinline__ long long row_token(const TokenMap& tm, long long base, int p) {
  if (tm.grid == 0) return base + p;
  const int pi = p / tm.rs;
  return base + (long long)pi * tm.grid + (p - pi * tm.rs);
}

// ---------------------------------------------------------------------------
// The redistribution's row layout (K8, K9, K10, K11): a warp owns a token
// row, a lane NC channels as NC / 4 groups of four consecutive channels
// (group lane + 32 i: channels 4 (lane + 32 i) .. + 3), each moved as one
// 16-byte (float) or 8-byte (bf16) vector; C % 4 == 0, C <= 32 NC.
// ---------------------------------------------------------------------------

// 4 consecutive elements (16-byte aligned float, 8-byte aligned bf16) as
// fp32, and back
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// The lane's groups of a row as fp32: v[4 i + e] is channel 4 (lane + 32 i)
// + e.  A group past the row (q >= nq = C / 4) reads the row's last group,
// so every load stays in bounds; the callers zero those.
template <typename T, int NC>
__device__ __forceinline__ void load_row4(const T* __restrict__ row, int lane, int nq,
                                          float (&v)[NC]) {
#pragma unroll
  for (int i = 0; i < NC / 4; ++i) {
    const float4 u = load4(row + 4 * min(lane + 32 * i, nq - 1));
    v[4 * i] = u.x; v[4 * i + 1] = u.y; v[4 * i + 2] = u.z; v[4 * i + 3] = u.w;
  }
}

// K8's stream value x + mask * round(w)^T round(reps) (+ shortcut) of the
// warp's row and its LayerNorm statistics (flax fast variance: var = max(0,
// E[v^2] - mu^2)).  K8 computes its output and K9 its backward from this one
// function, rounded op by op, so K9 recomputes K8's values bit for bit.  v:
// the row's x on entry (load_row4), the stream value on exit, zero past C;
// s: the shortcut's row (zeros without one); wr[j] = round(w)[j, p] (KW =
// k_width(k) >= k entries); repm: round(reps_r) [k][C] in shared memory.
template <int NC, int KW>
__device__ __forceinline__ void stream_ln(float (&v)[NC], const float (&s)[NC], float m,
                                          const float (&wr)[KW], const float* repm, int k,
                                          int C, int lane, float eps, float& mu, float& rstd) {
  const int nq = C / 4;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < NC / 4; ++i) {
    const int q = lane + 32 * i, c0 = 4 * min(q, nq - 1);
    float y[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < KW; ++j) {
      if (j < k) {
        const float4 r = *reinterpret_cast<const float4*>(repm + j * C + c0);
        y[0] = fmaf(wr[j], r.x, y[0]);
        y[1] = fmaf(wr[j], r.y, y[1]);
        y[2] = fmaf(wr[j], r.z, y[2]);
        y[3] = fmaf(wr[j], r.w, y[3]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float u = q < nq ? __fadd_rn(fmaf(y[e], m, v[4 * i + e]), s[4 * i + e]) : 0.f;
      v[4 * i + e] = u;
      s1 = __fadd_rn(s1, u);
      s2 = fmaf(u, u, s2);
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  mu = __fdiv_rn(s1, (float)C);
  rstd = __frcp_rn(__fsqrt_rn(__fadd_rn(fmaxf(0.f, __fsub_rn(__fdiv_rn(s2, (float)C),
                                                            __fmul_rn(mu, mu))),
                                        eps)));
}

// Channels a lane holds in the redistribution's row layout: 4, 8, 16 or 32
inline int row4_channels(int C) { return C <= 128 ? 4 : C <= 256 ? 8 : C <= 512 ? 16 : 32; }

// LAUNCH(NC) for the lane channels C needs
#define RRT_BY_ROW4(C, LAUNCH)            \
  switch (rrt::row4_channels(C)) {        \
    case 4: LAUNCH(4); break;             \
    case 8: LAUNCH(8); break;             \
    case 16: LAUNCH(16); break;           \
    default: LAUNCH(32); break;           \
  }

// Mean and 1/sqrt(var + eps) of the warp's row (flax fast variance), as
// warp_ln_stats
template <int NC>
__device__ __forceinline__ void row_ln_stats(const float (&v)[NC], int C, float eps, float& mu,
                                             float& rstd) {
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    s += v[n];
    s2 += v[n] * v[n];
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  mu = s / C;
  rstd = 1.f / sqrtf(fmaxf(0.f, s2 / C - mu * mu) + eps);
}

// Max, min and softmax denominator over the region's P logits of each row
// j < k of lg ([k][P], shared memory), a warp a row, in a fixed order.
__device__ __forceinline__ void region_stats(const float* lg, int P, int k, float* lmax,
                                             float* lmin, float* lsum) {
  const int lane = threadIdx.x & 31, W = blockDim.x >> 5;
  for (int j = threadIdx.x >> 5; j < k; j += W) {
    float mx = -INFINITY, mn = INFINITY;
    for (int p = lane; p < P; p += 32) {
      mx = fmaxf(mx, lg[j * P + p]);
      mn = fminf(mn, lg[j * P + p]);
    }
    mx = warp_max(mx);
    mn = warp_min(mn);
    float s = 0.f;
    for (int p = lane; p < P; p += 32) s += expf(lg[j * P + p] - mx);
    s = warp_sum(s);
    if (lane == 0) {
      lmax[j] = mx;
      lmin[j] = mn;
      lsum[j] = s;
    }
  }
}

// Max and softmax denominator over the k logits of token p (dispatch)
__device__ __forceinline__ void token_softmax(const float* lg, int P, int k, int p, float& dmax,
                                              float& dsum) {
  dmax = -INFINITY;
  for (int j = 0; j < k; ++j) dmax = fmaxf(dmax, lg[j * P + p]);
  dsum = 0.f;
  for (int j = 0; j < k; ++j) dsum += expf(lg[j * P + p] - dmax);
}

// Pass 1 of K3, K12 and K4: one warp a token row of the block's chunk.  The
// row's z = round(mask * LN(x)) (ls given: K3, K4; its mean and 1/std into
// stats (R, P, 2)) or round(x) (K12), and its k logits round(phi)^T z into
// logits (R, k, P).  With DC (K4) also, each (R, k, P): round(dreps_r) z
// into dcomb, and the LayerNorm backward's row sums sum_c ls zhat
// round(dreps_r) into su and sum_c ls zhat phi into sv (zhat = (x - mu) /
// std).  KB >= k bounds the accumulators.
template <typename TS, typename TM, int NC, int KB, bool DC>
__global__ void __launch_bounds__(CR_THREADS, NC <= 16 ? 2 : 1)
compress_rows_kernel(const TS* __restrict__ x, const uint8_t* __restrict__ mask,
                     const float* __restrict__ ls, const float* __restrict__ lb,
                     const float* __restrict__ phi, const float* __restrict__ dreps,
                     float* __restrict__ logits, float* __restrict__ stats,
                     float* __restrict__ dcomb, float* __restrict__ su, float* __restrict__ sv,
                     TokenMap map, int C, int k, int chunk, int vec, float eps) {
  constexpr int VW = vec_width<TS>(), NQ = NC / VW;
  extern __shared__ __align__(16) float sm[];
  const int Cp = padded_channels<TS>(C);
  float* phir = sm;                          // [k][Cp] round(phi)^T
  float* phit = phir + k * Cp;               // [k][Cp] phi^T          (DC)
  float* drm = phit + (DC ? k * Cp : 0);     // [k][Cp] round(dreps_r) (DC)
  float* lss = drm + (DC ? k * Cp : 0);      // [Cp] ls, then [Cp] lb  (ls given)
  float* lbs = lss + Cp;
  const int P = map.P, region = blockIdx.x;
  const int p0 = blockIdx.y * chunk, p1 = min(P, p0 + chunk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, W = blockDim.x >> 5;
  const long long base = region_base(map, region);
  const int fold = fold_of(map, region);  // its LayerNorm and phi
  ls = fold_ptr(ls, (long long)fold * C);
  lb = fold_ptr(lb, (long long)fold * C);
  phi += (long long)fold * C * k;

  for (int i = tid; i < k * Cp; i += blockDim.x) {
    const int j = i / Cp, c = i - j * Cp;
    phir[i] = c < C ? round_to<TM>(phi[c * k + j]) : 0.f;
    if (DC) {
      phit[i] = c < C ? phi[c * k + j] : 0.f;
      drm[i] = c < C ? round_to<TM>(dreps[((long long)region * k + j) * C + c]) : 0.f;
    }
  }
  if (ls) {
    for (int c = tid; c < Cp; c += blockDim.x) {
      lss[c] = c < C ? ls[c] : 0.f;
      lbs[c] = c < C ? lb[c] : 0.f;
    }
  }
  __syncthreads();

  for (int p = p0 + warp; p < p1; p += W) {
    const long long t = row_token(map, base, p);
    float v[NC];
    load_row<TS, NC>(x + t * C, C, lane, vec, v);
    const float m = mask ? (mask[t] ? 1.f : 0.f) : 1.f;
    float mu = 0.f, rstd = 1.f;
    if (ls) row_ln_stats(v, C, eps, mu, rstd);
    float acc[KB], dac[KB], ua[KB], va[KB];
#pragma unroll
    for (int j = 0; j < KB; ++j) acc[j] = dac[j] = ua[j] = va[j] = 0.f;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int c0 = VW * (lane + 32 * i);
      if (c0 < C) {
        float z[VW], s[VW], b[VW], sz[VW];
#pragma unroll
        for (int e = 0; e < VW; ++e) s[e] = b[e] = 0.f;
        if (ls) {
          lds<VW>(lss + c0, s);
          lds<VW>(lbs + c0, b);
        }
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          const float xv = v[VW * i + e];
          z[e] = round_to<TM>(ls ? ln_apply(xv, mu, rstd, s[e], b[e], m) : xv);
          sz[e] = s[e] * ((xv - mu) * rstd);
        }
#pragma unroll
        for (int j = 0; j < KB; ++j) {
          if (j < k) {
            float f[VW];
            lds<VW>(phir + j * Cp + c0, f);
#pragma unroll
            for (int e = 0; e < VW; ++e) acc[j] = fmaf(f[e], z[e], acc[j]);
            if (DC) {
              lds<VW>(drm + j * Cp + c0, f);
#pragma unroll
              for (int e = 0; e < VW; ++e) {
                dac[j] = fmaf(f[e], z[e], dac[j]);
                ua[j] = fmaf(f[e], sz[e], ua[j]);
              }
              lds<VW>(phit + j * Cp + c0, f);
#pragma unroll
              for (int e = 0; e < VW; ++e) va[j] = fmaf(f[e], sz[e], va[j]);
            }
          }
        }
      }
    }
    const long long rp = (long long)region * P + p;
    if (ls && lane == 0) {
      stats[2 * rp] = mu;
      stats[2 * rp + 1] = rstd;
    }
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      if (j < k) {
        const long long at = ((long long)region * k + j) * P + p;
        const float s = warp_sum(acc[j]);
        if (lane == 0) logits[at] = s;
        if (DC) {
          const float d = warp_sum(dac[j]), a = warp_sum(ua[j]), b = warp_sum(va[j]);
          if (lane == 0) {
            dcomb[at] = d;
            su[at] = a;
            sv[at] = b;
          }
        }
      }
    }
  }
}

// k rounded up to the accumulator width the compression kernels are built
// for: 1, 4, 8 or 16
inline int k_bound(int k) { return k == 1 ? 1 : k <= 4 ? 4 : k <= 8 ? 8 : 16; }

// the redistribution kernels' per-row weight registers for k: 8 or 16 (k
// <= 8, the main path's, keeps eight registers)
inline int k_width(int k) { return k <= 8 ? 8 : 16; }

// Channels a lane of pass 1 holds for C channels of TS: 8, 16 or 32
template <typename TS> inline int lane_channels(int C) {
  const int cp = padded_channels<TS>(C);
  return cp <= 256 ? 8 : cp <= 512 ? 16 : 32;
}

// Pass 2's shape: channel groups a row, row slots (rows in flight at once,
// a thread per group) and threads of a block (slots x groups, rounded up to
// whole warps, <= CR_THREADS)
struct StreamShape {
  int groups, slots, threads;
};
template <typename TS> inline StreamShape stream_shape(int C) {
  const int ng = padded_channels<TS>(C) / vec_width<TS>();
  const int slots = std::max(1, CR_THREADS / ng);
  return {ng, slots, (slots * ng + 31) / 32 * 32};  // whole warps; the rest idle
}

// Allow a launch of `kernel` with `smem` bytes of dynamic shared memory.
// The 48 KB a launch gets without the opt-in hold the kernels' static
// arrays too (KMAX-wide region sums, at most CR_STATIC_SMEM bytes).
constexpr size_t CR_STATIC_SMEM = 1024;
template <typename F> inline cudaError_t cr_smem(F* kernel, size_t smem) {
  if (smem > (size_t)CR_SMEM_MAX) return cudaErrorInvalidValue;
  if (smem + CR_STATIC_SMEM <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename TS, typename TM, int NC, int KB, bool DC>
cudaError_t launch_rows(dim3 grid, cudaStream_t s, const void* x, const void* mask,
                        const float* ls, const float* lb, const float* phi, const float* dreps,
                        float* logits, float* stats, float* dcomb, float* su, float* sv,
                        TokenMap map, int C, int k, int chunk, int vec, float eps) {
  const int Cp = padded_channels<TS>(C);
  const size_t smem = (size_t)((DC ? 3 : 1) * k * Cp + (ls ? 2 * Cp : 0)) * 4;
  cudaError_t err = cr_smem(compress_rows_kernel<TS, TM, NC, KB, DC>, smem);
  if (err != cudaSuccess) return err;
  compress_rows_kernel<TS, TM, NC, KB, DC><<<grid, CR_THREADS, smem, s>>>(
      (const TS*)x, (const uint8_t*)mask, ls, lb, phi, dreps, logits, stats, dcomb, su, sv, map,
      C, k, chunk, vec, eps);
  return cudaGetLastError();
}

template <typename TS, typename TM, int NC, bool DC>
cudaError_t launch_rows_k(dim3 grid, cudaStream_t s, const void* x, const void* mask,
                          const float* ls, const float* lb, const float* phi,
                          const float* dreps, float* logits, float* stats, float* dcomb,
                          float* su, float* sv, TokenMap map, int C, int k, int chunk, int vec,
                          float eps) {
  switch (k_bound(k)) {
    case 1:
      return launch_rows<TS, TM, NC, 1, DC>(grid, s, x, mask, ls, lb, phi, dreps, logits, stats,
                                            dcomb, su, sv, map, C, k, chunk, vec, eps);
    case 4:
      return launch_rows<TS, TM, NC, 4, DC>(grid, s, x, mask, ls, lb, phi, dreps, logits, stats,
                                            dcomb, su, sv, map, C, k, chunk, vec, eps);
    case 8:
      return launch_rows<TS, TM, NC, 8, DC>(grid, s, x, mask, ls, lb, phi, dreps, logits, stats,
                                            dcomb, su, sv, map, C, k, chunk, vec, eps);
    default:
      return launch_rows<TS, TM, NC, 16, DC>(grid, s, x, mask, ls, lb, phi, dreps, logits,
                                             stats, dcomb, su, sv, map, C, k, chunk, vec, eps);
  }
}

// Pass 1 over the (R, parts) grid, built for the lane's channels and k
template <typename TS, typename TM, bool DC>
cudaError_t launch_compress_rows(dim3 grid, cudaStream_t s, const void* x, const void* mask,
                                 const float* ls, const float* lb, const float* phi,
                                 const float* dreps, float* logits, float* stats, float* dcomb,
                                 float* su, float* sv, TokenMap map, int C, int k, int chunk,
                                 int vec, float eps) {
  switch (lane_channels<TS>(C)) {
    case 8:
      return launch_rows_k<TS, TM, 8, DC>(grid, s, x, mask, ls, lb, phi, dreps, logits, stats,
                                          dcomb, su, sv, map, C, k, chunk, vec, eps);
    case 16:
      return launch_rows_k<TS, TM, 16, DC>(grid, s, x, mask, ls, lb, phi, dreps, logits, stats,
                                           dcomb, su, sv, map, C, k, chunk, vec, eps);
    default:
      return launch_rows_k<TS, TM, 32, DC>(grid, s, x, mask, ls, lb, phi, dreps, logits, stats,
                                           dcomb, su, sv, map, C, k, chunk, vec, eps);
  }
}

// 16-byte loads apply: whole groups per row and an aligned stream
template <typename TS> inline int use_vec(const void* x, int C) {
  return C % vec_width<TS>() == 0 && ((uintptr_t)x & 15) == 0;
}

}  // namespace rrt
