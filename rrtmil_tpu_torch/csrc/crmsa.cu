// K3 and K8: the stream-touching halves of the CR-MSA TransLayer.
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
// K8 replaces crmsa_kernels.py::_rgrid_ln_pallas (kernel body
// _rgrid_ln_kernel): per token, round(w)^T round(reps) from its region,
// times the mask, + x (the layer residual), + the encoder's global
// shortcut, then the encoder-final LayerNorm and mask, written as fp32.
// Bound on an H100: bytes (~57 MB a c16_r50 slide).  Design: one warp per
// token row, the row held in registers, so x, the shortcut and the output
// each cross device memory once; w and reps are tiny and stay in L2.
#include "common.cuh"

using namespace rrt;

constexpr int KMAX = 8;  // CR-MSA representatives per region (crmsa_k)

template <typename TS, typename TM>
__global__ void __launch_bounds__(256)
compress_grid_kernel(const TS* __restrict__ x, const uint8_t* __restrict__ mask,
                     const float* __restrict__ ls, const float* __restrict__ lb,
                     const float* __restrict__ phi, float* __restrict__ reps,
                     float* __restrict__ w, int G, int rs, int C, int k, float eps) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float lmax[KMAX], lmin[KMAX], lsum[KMAX];
  const int P = rs * rs, nrs = G / rs;
  const int region = blockIdx.x;
  float* phis = sm;               // [C][k], rounded to TM
  float* logit = phis + C * k;    // [k][P]
  float* comb = logit + k * P;    // [k][P], rounded to TM
  float* mu = comb + k * P;       // [P]
  float* rstd = mu + P;           // [P]
  float* msk = rstd + P;          // [P]
  int* tok = (int*)(msk + P);     // [P] stream row of each region token
  const TokenMap map{G, rs, nrs, P};
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int i = tid; i < C * k; i += blockDim.x) phis[i] = round_to<TM>(phi[i]);
  for (int p = tid; p < P; p += blockDim.x) tok[p] = (int)token_of(map, region, p);
  __syncthreads();

  // phase 1: LN statistics and phi logits, one warp per token row
  for (int p = warp; p < P; p += nwarps) {
    const TS* xr = x + (long long)tok[p] * C;
    const float m = mask[tok[p]] ? 1.f : 0.f;
    float vals[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      vals[i] = c < C ? to_f(xr[c]) : 0.f;
    }
    float mu_p, rstd_p;
    warp_ln_stats(vals, C, lane, eps, mu_p, rstd_p);
    float acc[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) acc[j] = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      if (c < C) {
        const float z = round_to<TM>(ln_apply(vals[i], mu_p, rstd_p, ls[c], lb[c], m));
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
    const float s = ls[c], b = lb[c];
    for (int p = 0; p < P; ++p) {
      const float z = round_to<TM>(
          ln_apply(to_f(x[(long long)tok[p] * C + c]), mu[p], rstd[p], s, b, msk[p]));
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
  cudaError_t err = cudaSuccess;
  RRT_DISPATCH(ts, TS, RRT_DISPATCH(tm, TM,
      err = cudaFuncSetAttribute(compress_grid_kernel<TS, TM>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      compress_grid_kernel<TS, TM><<<B * nrs * nrs, 256, smem, (cudaStream_t)stream>>>(
          (const TS*)x, (const uint8_t*)mask, (const float*)ls, (const float*)lb,
          (const float*)phi, (float*)reps, (float*)w, G, rs, C, k, eps)));
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
