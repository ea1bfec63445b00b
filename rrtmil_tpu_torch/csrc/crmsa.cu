// K3, K8, K10, K12 and K13: the stream-touching halves of the CR-MSA layer.
//
// K3 replaces rrtmil_tpu/ops/pallas/crmsa_kernels.py::_compress_grid_pallas
// (kernel body _compress_grid_kernel).  Per region r of the raw stream:
//   z       = round(mask * LN(x_r))                      (P, C)
//   logits  = round(phi)^T z^T                           (k, P)
//   combine = softmax over P;  dispatch = softmax over k
//   mm      = (logits - min_P) / (max_P - min_P + 1e-8)
//   reps    = round(combine) @ z   (B, nR, k, C) f32;  w = mm * dispatch.
// Bound on an H100: bytes (~19 MFLOP against ~19 MB a c16_r50 slide).
// Design: one block per region.  Warps own token rows: each row is read
// once for its LN statistics and logits (kept in shared memory with the
// per-token mean and 1/std), the two softmaxes and min/max are reduced in
// shared memory, then the block re-reads the region (its ~290 KB stay in the
// 50 MB L2) to form reps with threads across channels, so reads stay
// coalesced and no P x C tile has to fit in shared memory.
//
// K12 replaces crmsa_kernels.py::_compress_pallas (kernel body
// _compress_kernel): K3's math on regions that are already partitioned,
// (R, P, C) in the stream dtype, with no LayerNorm and no mask: z = round(x).
// Same kernel (template flag LN = false, contiguous token map).  Bound:
// bytes (a survival bag of 45000 patches: R = 64, P = 729, C = 512 f32,
// ~96 MB read, ~0.029 ms).  One block per region: the logits need all of C
// before either softmax, and a region's reductions stay in one block, so at
// B = 1 only 64 of the 132 SMs work; splitting a region across blocks would
// need a cross-block softmax (a later PR's work).
//
// K8 replaces crmsa_kernels.py::_rgrid_ln_pallas (kernel body
// _rgrid_ln_kernel): per token, round(w)^T round(reps) from its region,
// times the mask, + x (the layer residual), + the encoder's global
// shortcut, then the encoder-final LayerNorm and mask, written as fp32.
// Bound on an H100: bytes (~57 MB a c16_r50 slide).  Design: one warp per
// token row, the row held in registers, so x, the shortcut and the output
// each cross device memory once; w and reps are tiny and stay in L2.
//
// K10 replaces crmsa_kernels.py::_redistribute_grid_pallas (kernel body
// _redistribute_grid_kernel): out = x + mask * reverse(round(w)^T
// round(reps)) in x's dtype (without x when add_residual is False).  K13
// replaces crmsa_kernels.py::_redistribute_pallas (kernel body
// _redistribute_kernel): out_r = round(w_r)^T round(reps_r) on contiguous
// (R, P, C) regions, fp32.  Bound for both: bytes (K10 at c16_r50 + FFN,
// L = 9000, B = 8: ~302 MB, ~0.090 ms; K13 at the 45000-patch survival bag:
// ~96 MB written, ~0.029 ms).  Design: each token row is a rank-k update
// (k <= 8), so the work tiles freely: one block per (region, 32 token rows),
// the region's k reps rows rounded once into shared memory, one warp per
// token row writing four channels per lane per step; x, the mask and the
// output cross device memory once, and a B = 1 survival bag still gives
// 64 x 23 blocks to the 132 SMs.
#include "common.cuh"

using namespace rrt;

constexpr int KMAX = 8;  // CR-MSA representatives per region (crmsa_k)

// LN = true: K3 on the raw stream (map: the grid); LN = false: K12 on
// partitioned regions (map: contiguous), where z = round(x) and mask is unused.
template <typename TS, typename TM, bool LN>
__global__ void __launch_bounds__(256)
compress_grid_kernel(const TS* __restrict__ x, const uint8_t* __restrict__ mask,
                     const float* __restrict__ ls, const float* __restrict__ lb,
                     const float* __restrict__ phi, float* __restrict__ reps,
                     float* __restrict__ w, TokenMap map, int C, int k, float eps) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float lmax[KMAX], lmin[KMAX], lsum[KMAX];
  const int P = map.P;
  const int region = blockIdx.x;
  float* phis = sm;               // [C][k], rounded to TM
  float* logit = phis + C * k;    // [k][P]
  float* comb = logit + k * P;    // [k][P], rounded to TM
  float* mu = comb + k * P;       // [P]
  float* rstd = mu + P;           // [P]
  float* msk = rstd + P;          // [P]
  int* tok = (int*)(msk + P);     // [P] stream row of each region token
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int i = tid; i < C * k; i += blockDim.x) phis[i] = round_to<TM>(phi[i]);
  for (int p = tid; p < P; p += blockDim.x) tok[p] = (int)token_of(map, region, p);
  __syncthreads();

  // phase 1: LN statistics and phi logits, one warp per token row
  for (int p = warp; p < P; p += nwarps) {
    const TS* xr = x + (long long)tok[p] * C;
    const float m = LN ? (mask[tok[p]] ? 1.f : 0.f) : 1.f;
    float vals[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      vals[i] = c < C ? to_f(xr[c]) : 0.f;
    }
    float mu_p = 0.f, rstd_p = 1.f;
    if (LN) warp_ln_stats(vals, C, lane, eps, mu_p, rstd_p);
    float acc[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) acc[j] = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      if (c < C) {
        const float z = round_to<TM>(
            LN ? ln_apply(vals[i], mu_p, rstd_p, ls[c], lb[c], m) : vals[i]);
#pragma unroll
        for (int j = 0; j < KMAX; ++j)
          if (j < k) acc[j] = fmaf(phis[c * k + j], z, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) {
        const float s = warp_sum(acc[j]);
        if (lane == 0) logit[j * P + p] = s;
      }
    }
    if (lane == 0) { mu[p] = mu_p; rstd[p] = rstd_p; msk[p] = m; }
  }
  __syncthreads();

  // phase 2: max, min and softmax denominator over P, one warp per row j
  if (warp < k) {
    float mx = -INFINITY, mn = INFINITY;
    for (int p = lane; p < P; p += 32) {
      mx = fmaxf(mx, logit[warp * P + p]);
      mn = fminf(mn, logit[warp * P + p]);
    }
    mx = warp_max(mx);
    mn = warp_min(mn);
    float s = 0.f;
    for (int p = lane; p < P; p += 32) s += expf(logit[warp * P + p] - mx);
    s = warp_sum(s);
    if (lane == 0) { lmax[warp] = mx; lmin[warp] = mn; lsum[warp] = s; }
  }
  __syncthreads();

  // phase 3: combine (softmax over P), dispatch (softmax over k), w
  for (int p = tid; p < P; p += blockDim.x) {
    float dmax = -INFINITY;
    for (int j = 0; j < k; ++j) dmax = fmaxf(dmax, logit[j * P + p]);
    float dsum = 0.f;
    for (int j = 0; j < k; ++j) dsum += expf(logit[j * P + p] - dmax);
    for (int j = 0; j < k; ++j) {
      const float l = logit[j * P + p];
      comb[j * P + p] = round_to<TM>(expf(l - lmax[j]) / lsum[j]);
      const float disp = expf(l - dmax) / dsum;
      const float mmv = (l - lmin[j]) / (lmax[j] - lmin[j] + 1e-8f);
      w[((long long)region * k + j) * P + p] = mmv * disp;
    }
  }
  __syncthreads();

  // phase 4: reps = combine @ z, threads across channels, z recomputed
  for (int c = tid; c < C; c += blockDim.x) {
    float acc[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) acc[j] = 0.f;
    const float s = LN ? ls[c] : 1.f, b = LN ? lb[c] : 0.f;
    for (int p = 0; p < P; ++p) {
      const float v = to_f(x[(long long)tok[p] * C + c]);
      const float z = round_to<TM>(LN ? ln_apply(v, mu[p], rstd[p], s, b, msk[p]) : v);
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (j < k) acc[j] = fmaf(comb[j * P + p], z, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < k) reps[((long long)region * k + j) * C + c] = acc[j];
  }
}

template <typename TS, typename TM>
__global__ void __launch_bounds__(256)
redistribute_ln_kernel(const TS* __restrict__ x, const uint8_t* __restrict__ mask,
                       const float* __restrict__ w, const float* __restrict__ reps,
                       const float* __restrict__ ls, const float* __restrict__ lb,
                       const TS* __restrict__ sc, float* __restrict__ out,
                       long long M, int G, int rs, int C, int k, float eps) {
  const int lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (t >= M) return;
  const int gg = G * G, nrs = G / rs, P = rs * rs;
  const int b = (int)(t / gg), pos = (int)(t % gg);
  const int gi = pos / G, gj = pos % G;
  const long long region = (long long)b * nrs * nrs + (gi / rs) * nrs + gj / rs;
  const int p = (gi % rs) * rs + gj % rs;
  const float m = mask[t] ? 1.f : 0.f;

  float wj[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j)
    wj[j] = j < k ? round_to<TM>(w[(region * k + j) * P + p]) : 0.f;

  float vals[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    if (c < C) {
      float y = 0.f;
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (j < k) y = fmaf(wj[j], round_to<TM>(reps[(region * k + j) * C + c]), y);
      float v = to_f(x[t * C + c]) + y * m;
      if (sc) v += to_f(sc[t * C + c]);
      vals[i] = v;
    } else {
      vals[i] = 0.f;
    }
  }
  warp_ln_mask(vals, C, lane, ls, lb, m, eps);
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    if (c < C) out[t * C + c] = vals[i];
  }
}

// K10 / K13: out[t] = (x[t] +) mask[t] * sum_j round(w[r, j, p]) round(reps[r, j]),
// t the token of row p of region r under `map`.  x == nullptr: no residual;
// mask == nullptr: no mask.  One block per (region, RT rows), one warp per
// row, four channels per lane per step (C % 4 == 0).
constexpr int RT = 32;

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]), b = __bfloat1622float2(q[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v[0], v[1]);
  q[1] = __floats2bfloat162_rn(v[2], v[3]);
}

template <typename TS, typename TM>
__global__ void __launch_bounds__(256)
redistribute_kernel(const TS* __restrict__ x, const uint8_t* __restrict__ mask,
                    const float* __restrict__ w, const float* __restrict__ reps,
                    TS* __restrict__ out, TokenMap map, int C, int k) {
  extern __shared__ __align__(16) float sm[];
  float* rs_ = sm;              // [k][C] round(reps_r)
  float* ws = rs_ + k * C;      // [k][RT] round(w_r) of this block's rows
  const int P = map.P;
  const int r = blockIdx.x, p0 = blockIdx.y * RT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* rr = reps + (long long)r * k * C;
  for (int i = tid; i < k * C; i += blockDim.x) rs_[i] = round_to<TM>(rr[i]);
  for (int i = tid; i < k * RT; i += blockDim.x) {
    const int j = i / RT, p = p0 + i % RT;
    ws[i] = p < P ? round_to<TM>(w[((long long)r * k + j) * P + p]) : 0.f;
  }
  __syncthreads();
  for (int row = warp; row < RT && p0 + row < P; row += nwarps) {
    const long long t = token_of(map, r, p0 + row);
    const float m = mask ? (mask[t] ? 1.f : 0.f) : 1.f;
    float wj[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) wj[j] = j < k ? ws[j * RT + row] : 0.f;
    for (int c = 4 * lane; c < C; c += 128) {
      float y[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j < k) {
          const float4 rv = *reinterpret_cast<const float4*>(&rs_[j * C + c]);
          y[0] = fmaf(wj[j], rv.x, y[0]);
          y[1] = fmaf(wj[j], rv.y, y[1]);
          y[2] = fmaf(wj[j], rv.z, y[2]);
          y[3] = fmaf(wj[j], rv.w, y[3]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] *= m;
      if (x) {
        float xv[4];
        load4(x + t * C + c, xv);
#pragma unroll
        for (int e = 0; e < 4; ++e) y[e] = xv[e] + y[e];
      }
      store4(out + t * C + c, y);
    }
  }
}

static size_t compress_smem_bytes(int C, int k, int P) {
  return (size_t)(C * k + 2 * k * P + 3 * P) * 4 + (size_t)P * 4;
}

extern "C" int cr_compress_grid(int ts, int tm, const void* x, const void* mask,
                                const void* ls, const void* lb, const void* phi,
                                void* reps, void* w, int B, int G, int rs, int C,
                                int k, float eps, void* stream) {
  if (C > 32 * CPL || k < 1 || k > KMAX || G % rs != 0) return (int)cudaErrorInvalidValue;
  const int nrs = G / rs;
  const size_t smem = compress_smem_bytes(C, k, rs * rs);
  const TokenMap map{G, rs, nrs, rs * rs};
  cudaError_t err = cudaSuccess;
  RRT_DISPATCH(ts, TS, RRT_DISPATCH(tm, TM,
      err = cudaFuncSetAttribute(compress_grid_kernel<TS, TM, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      compress_grid_kernel<TS, TM, true><<<B * nrs * nrs, 256, smem, (cudaStream_t)stream>>>(
          (const TS*)x, (const uint8_t*)mask, (const float*)ls, (const float*)lb,
          (const float*)phi, (float*)reps, (float*)w, map, C, k, eps)));
  return (int)cudaGetLastError();
}

// K12: x (R, P, C) -> reps (R, k, C), w (R, k, P)
extern "C" int cr_compress(int ts, int tm, const void* x, const void* phi, void* reps,
                           void* w, int R, int P, int C, int k, void* stream) {
  if (C > 32 * CPL || k < 1 || k > KMAX || R < 1 || P < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = compress_smem_bytes(C, k, P);
  const TokenMap map{0, 1, 1, P};
  cudaError_t err = cudaSuccess;
  RRT_DISPATCH(ts, TS, RRT_DISPATCH(tm, TM,
      err = cudaFuncSetAttribute(compress_grid_kernel<TS, TM, false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      compress_grid_kernel<TS, TM, false><<<R, 256, smem, (cudaStream_t)stream>>>(
          (const TS*)x, nullptr, nullptr, nullptr, (const float*)phi, (float*)reps,
          (float*)w, map, C, k, 0.f)));
  return (int)cudaGetLastError();
}

// K10 (G > 0: regions of the (B, G*G, C) stream, R = B * (G / rs)^2, x may be
// null for add_residual=False) and K13 (G == 0: contiguous (R, P, C) regions,
// no x, no mask, ts = float).  out has x's dtype ts.
extern "C" int cr_redistribute(int ts, int tm, const void* x, const void* mask,
                               const void* w, const void* reps, void* out, int R, int G,
                               int rs, int P, int C, int k, void* stream) {
  if (C % 4 != 0 || C > 32 * CPL || k < 1 || k > KMAX || R < 1 || P < 1)
    return (int)cudaErrorInvalidValue;
  if (G > 0 && (rs < 1 || G % rs != 0 || P != rs * rs)) return (int)cudaErrorInvalidValue;
  const TokenMap map = G > 0 ? TokenMap{G, rs, G / rs, P} : TokenMap{0, 1, 1, P};
  const size_t smem = (size_t)(k * C + k * RT) * 4;
  const dim3 grid(R, (P + RT - 1) / RT);
  RRT_DISPATCH(ts, TS, RRT_DISPATCH(tm, TM,
      redistribute_kernel<TS, TM><<<grid, 256, smem, (cudaStream_t)stream>>>(
          (const TS*)x, (const uint8_t*)mask, (const float*)w, (const float*)reps,
          (TS*)out, map, C, k)));
  return (int)cudaGetLastError();
}

extern "C" int cr_redistribute_ln(int ts, int tm, const void* x, const void* mask,
                                  const void* w, const void* reps, const void* ls,
                                  const void* lb, const void* sc, void* out, int B,
                                  int G, int rs, int C, int k, float eps,
                                  void* stream) {
  if (C > 32 * CPL || k < 1 || k > KMAX || G % rs != 0) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * G * G;
  const unsigned blocks = (unsigned)((M + 7) / 8);
  RRT_DISPATCH(ts, TS, RRT_DISPATCH(tm, TM,
      redistribute_ln_kernel<TS, TM><<<blocks, 256, 0, (cudaStream_t)stream>>>(
          (const TS*)x, (const uint8_t*)mask, (const float*)w, (const float*)reps,
          (const float*)ls, (const float*)lb, (const TS*)sc, (float*)out, M, G, rs,
          C, k, eps)));
  return (int)cudaGetLastError();
}
