// K4, K9 and K11: the backwards of the CR-MSA layer's stream-touching halves.
//
// K4 replaces rrtmil_tpu/ops/pallas/crmsa_kernels.py::_cgrid_bwd_pallas
// (kernel body _cgrid_bwd_kernel), the backward of K3: given d(reps) and
// d(w), it recomputes the region's LayerNorm, the phi logits, combine (the
// softmax over P), dispatch (the softmax over k) and the min-max weights,
// and emits dx, d(LN scale, bias) and dphi:
//   d_comb = round(dreps) z^T,  dz = round(combine)^T round(dreps) + round(dl)^T phi,
//   dl = softmax_P bwd(d_comb) + softmax_k bwd(dw * mm) + min-max bwd(dw * dispatch)
// with the min and max gradients split equally among tied tokens (the
// bucket's zero pad rows all tie at logit 0, so this is the real-bag case).
// K9 replaces crmsa_kernels.py::_rgrid_ln_bwd_pallas (kernel body
// _rgrid_ln_bwd_kernel), the backward of K8: it recomputes the post-layer
// stream x + mask * round(w)^T round(reps) (+ shortcut), runs the final
// LayerNorm's backward and emits dx (which is also the shortcut's gradient),
// dw = round(reps) gm^T, dreps = round(w) gm and d(LN scale, bias), with
// gm = round(mask * dx).
//
// What bounds both on an H100: bytes.  A c16_r50 slide moves ~38 MB (K4:
// x read, dx written) and ~75 MB (K9: x, shortcut and g read, dx written)
// against a few tens of MFLOP.  K4's design: one block per region, as K3's
// forward.  A first pass gives each token row to a warp (LayerNorm
// statistics, the logits, the row sums the LayerNorm backward needs), the
// per-region reductions over P run in shared memory, and a last pass gives
// each thread a channel and walks the region's rows, so every read and write
// is coalesced and each per-channel sum (dls, dlb, dphi) stays in one
// thread's registers.  K9's design: one pass over x, the shortcut and g, as
// the TPU kernel (its two-pass form read them twice: at B = 8 the regions
// in flight hold ~450 MB, far past the 50 MB L2).  A warp owns a token row
// at a time and, beside dx and the row's dw sums, adds the row's terms into
// its own partials (dls and dlb in registers, dreps in its slice of shared
// memory), so the warps of a block run without a barrier between rows and
// keep their loads in flight; the warps' partials are summed in warp order
// at the end.  Each region's rows are split over enough blocks that B = 1
// (64 regions) still puts two blocks on every SM.  The sums across blocks
// are partials that cb_reduce adds in a fixed order: no atomics, so every
// run gives the same bits.
//
// K11 replaces crmsa_kernels.py::_rgrid_bwd_pallas (kernel body
// _rgrid_bwd_kernel), the backward of K10: with gm = round(g * mask) in
// region order, dw = round(reps) gm^T (k, P) and dreps = round(w) gm (k, C)
// per region; dx (g itself, or zeros) stays in the wrapper.  Bound: bytes
// (c16_r50 + FFN at L = 9000, B = 8: the f32 g, ~151 MB, ~0.045 ms).
// Design: one block per region, so dreps (a sum over the region's P rows)
// never crosses blocks: no partials, deterministic by construction.  The
// block walks its region in chunks of 16 token rows: the chunk's gm rows are
// staged once in shared memory (coalesced row reads), then each warp takes
// a row for its k dot products over C (dw), and each thread keeps the k
// dreps sums of its channels in registers across all chunks.  g crosses
// device memory once.  At B = 1 a 64-region bag keeps only 64 SMs busy.
#include <algorithm>

#include "common.cuh"

using namespace rrt;

namespace {

constexpr int KMAX = 8;  // CR-MSA representatives per region (crmsa_k)

size_t cgrid_smem_bytes(int C, int k, int P) {
  return (size_t)(2 * C * k + 4 * k * P + 5 * P) * 4 + (size_t)P * 4;
}

template <typename TS, typename TM>
__global__ void __launch_bounds__(256)
compress_grid_bwd_kernel(const TS* __restrict__ x, const uint8_t* __restrict__ mask,
                         const float* __restrict__ ls, const float* __restrict__ lb,
                         const float* __restrict__ phi, const float* __restrict__ dreps,
                         const float* __restrict__ dw, TS* __restrict__ dx,
                         float* __restrict__ part, int G, int rs, int C, int k, float eps) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float lmax[KMAX], lmin[KMAX], lsum[KMAX];
  __shared__ float s1[KMAX], s2[KMAX], s3[KMAX], nmin[KMAX], nmax[KMAX];
  const int P = rs * rs, nrs = G / rs;
  const int region = blockIdx.x;
  float* phis = sm;                // [C][k] round(phi)
  float* drm = phis + C * k;       // [k][C] round(dreps)
  float* logit = drm + k * C;      // [k][P]
  float* comb = logit + k * P;     // [k][P]
  float* disp = comb + k * P;      // [k][P]
  float* dl = disp + k * P;        // [k][P] d(combine) of each logit, then round(dlogit)
  float* mu = dl + k * P;          // [P]
  float* rstd = mu + P;            // [P]
  float* msk = rstd + P;           // [P]
  float* m1 = msk + P;             // [P]
  float* m2 = m1 + P;              // [P]
  int* tok = (int*)(m2 + P);       // [P]
  const TokenMap map{G, rs, nrs, P};
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* dr = dreps + (long long)region * k * C;
  const float* dwr = dw + (long long)region * k * P;

  for (int i = tid; i < C * k; i += blockDim.x) phis[i] = round_to<TM>(phi[i]);
  for (int i = tid; i < k * C; i += blockDim.x) drm[i] = round_to<TM>(dr[i]);
  for (int p = tid; p < P; p += blockDim.x) tok[p] = (int)token_of(map, region, p);
  __syncthreads();

  // phase 1: LayerNorm statistics, the logits (K3's code) and d_comb per row
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
    float acc[KMAX], dac[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) { acc[j] = 0.f; dac[j] = 0.f; }
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      if (c < C) {
        const float z = round_to<TM>(ln_apply(vals[i], mu_p, rstd_p, ls[c], lb[c], m));
#pragma unroll
        for (int j = 0; j < KMAX; ++j)
          if (j < k) {
            acc[j] = fmaf(phis[c * k + j], z, acc[j]);
            dac[j] = fmaf(drm[j * C + c], z, dac[j]);
          }
      }
    }
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) {
        const float s = warp_sum(acc[j]), d = warp_sum(dac[j]);
        if (lane == 0) { logit[j * P + p] = s; dl[j * P + p] = d; }
      }
    }
    if (lane == 0) { mu[p] = mu_p; rstd[p] = rstd_p; msk[p] = m; }
  }
  __syncthreads();

  // phase 2: max, min and softmax denominator over P (K3's code)
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

  // phase 3: combine and dispatch
  for (int p = tid; p < P; p += blockDim.x) {
    float dmax = -INFINITY;
    for (int j = 0; j < k; ++j) dmax = fmaxf(dmax, logit[j * P + p]);
    float dsum = 0.f;
    for (int j = 0; j < k; ++j) dsum += expf(logit[j * P + p] - dmax);
    for (int j = 0; j < k; ++j) {
      const float l = logit[j * P + p];
      comb[j * P + p] = expf(l - lmax[j]) / lsum[j];
      disp[j * P + p] = expf(l - dmax) / dsum;
    }
  }
  __syncthreads();

  // phase 4: the sums over P of each row j (one warp per row)
  if (warp < k) {
    const int j = warp;
    const float rng = lmax[j] - lmin[j] + 1e-8f;
    float a = 0.f, b = 0.f, c = 0.f, nlo = 0.f, nhi = 0.f;
    for (int p = lane; p < P; p += 32) {
      const float l = logit[j * P + p], lz = l - lmin[j];
      const float dmm = dwr[j * P + p] * disp[j * P + p];
      a += dl[j * P + p] * comb[j * P + p];
      b += dmm * (lz - rng);
      c += dmm * lz;
      nlo += l == lmin[j] ? 1.f : 0.f;
      nhi += l == lmax[j] ? 1.f : 0.f;
    }
    a = warp_sum(a); b = warp_sum(b); c = warp_sum(c);
    nlo = warp_sum(nlo); nhi = warp_sum(nhi);
    if (lane == 0) { s1[j] = a; s2[j] = b; s3[j] = c; nmin[j] = nlo; nmax[j] = nhi; }
  }
  __syncthreads();

  // phase 5: the logit gradient, rounded to TM
  for (int p = tid; p < P; p += blockDim.x) {
    float tdisp = 0.f;
    for (int j = 0; j < k; ++j) {
      const float rng = lmax[j] - lmin[j] + 1e-8f;
      const float mmv = (logit[j * P + p] - lmin[j]) / rng;
      tdisp += dwr[j * P + p] * mmv * disp[j * P + p];
    }
    for (int j = 0; j < k; ++j) {
      const float l = logit[j * P + p];
      const float rng = lmax[j] - lmin[j] + 1e-8f;
      const float mmv = (l - lmin[j]) / rng;
      const float dmm = dwr[j * P + p] * disp[j * P + p];
      const float ddisp = dwr[j * P + p] * mmv;
      float g = comb[j * P + p] * (dl[j * P + p] - s1[j]);
      g += disp[j * P + p] * (ddisp - tdisp);
      g += dmm / rng;
      const float dlmin = s2[j] / (rng * rng), dlmax = -s3[j] / (rng * rng);
      if (l == lmin[j]) g += dlmin / nmin[j];
      if (l == lmax[j]) g += dlmax / nmax[j];
      dl[j * P + p] = round_to<TM>(g);
    }
  }
  __syncthreads();

  // phase 6: the LayerNorm backward's row means, one warp per row
  for (int p = warp; p < P; p += nwarps) {
    const TS* xr = x + (long long)tok[p] * C;
    float a = 0.f, b = 0.f;
    for (int c = lane; c < C; c += 32) {
      float dz = 0.f;
      for (int j = 0; j < k; ++j)
        dz = fmaf(round_to<TM>(comb[j * P + p]), drm[j * C + c], dz);
      for (int j = 0; j < k; ++j) dz = fmaf(dl[j * P + p], phi[c * k + j], dz);
      const float zhat = (to_f(xr[c]) - mu[p]) * rstd[p];
      const float dzh = dz * msk[p] * ls[c];
      a += dzh;
      b += dzh * zhat;
    }
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) { m1[p] = a / C; m2[p] = b / C; }
  }
  __syncthreads();

  // phase 7: dx and the per-channel sums, one thread per channel
  for (int c = tid; c < C; c += blockDim.x) {
    const float s = ls[c], bb = lb[c];
    float dls = 0.f, dlb = 0.f, dph[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) dph[j] = 0.f;
    for (int p = 0; p < P; ++p) {
      const long long at = (long long)tok[p] * C + c;
      const float xv = to_f(x[at]);
      const float zhat = (xv - mu[p]) * rstd[p];
      const float z = round_to<TM>(ln_apply(xv, mu[p], rstd[p], s, bb, msk[p]));
      float dz = 0.f;
      for (int j = 0; j < k; ++j)
        dz = fmaf(round_to<TM>(comb[j * P + p]), drm[j * C + c], dz);
      for (int j = 0; j < k; ++j) dz = fmaf(dl[j * P + p], phi[c * k + j], dz);
      const float dzs = dz * msk[p];
      dls += dzs * zhat;
      dlb += dzs;
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (j < k) dph[j] = fmaf(dl[j * P + p], z, dph[j]);
      dx[at] = from_f<TS>(rstd[p] * (dzs * s - m1[p] - zhat * m2[p]));
    }
    float* out = part + (long long)region * (2 + k) * C;
    out[c] = dls;
    out[C + c] = dlb;
    for (int j = 0; j < k; ++j) out[(2 + j) * C + c] = dph[j];
  }
}

constexpr int K9_MAX_WARPS = 8;
constexpr int K9_SMEM_BUDGET = 110 * 1024;  // two blocks an SM

// warps of a K9 block: each keeps its dreps partials (k x C floats) in
// shared memory beside round(reps), within K9_SMEM_BUDGET
int rgrid_warps(int C, int k) {
  const int per = k * C * 4;
  return std::max(1, std::min(K9_MAX_WARPS, (K9_SMEM_BUDGET - per - C * 4) / per));
}

size_t rgrid_smem_bytes(int C, int k, int warps) {
  return ((size_t)(1 + warps) * k * C + C) * 4;
}

// 4 consecutive elements (16-byte aligned float, 8-byte aligned bf16) as fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(bf16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// K9, one pass over the region's rows p0 .. p1 - 1 (p1 - p0 <= chunk),
// each warp its rows p0 + warp, p0 + warp + W, ... with no barrier between
// rows.  The warp recomputes the stream value x + mask * round(w)^T
// round(reps) (+ shortcut) (K8's order), runs the LayerNorm backward,
// writes dx and the row's k dw sums, and adds the row's terms into its
// partials: dls += gym * zhat and dlb += gym (gym = g * mask) in its lanes'
// registers, dreps[j] += round(w)[j, p] * gm (gm = round(gout * mask)) in
// its own k x C slice of shared memory.  At the end the warps' partials
// are summed in warp order into part_reps[part, region, k, C] and
// part_ln[part * R + region, 2 C], which cb_reduce sums in a fixed order.
// A lane holds NC channels as NC / 4 groups of 4 (group lane + 32 i:
// channels 4 (lane + 32 i) .. + 3), moved as 16-byte vectors, every load of
// a row issued before any is used; C is a multiple of 4, C <= 32 NC.
template <typename TS, typename TM, int NC>
__global__ void __launch_bounds__(32 * K9_MAX_WARPS, NC <= 16 ? 2 : 1)
redistribute_ln_bwd_kernel(const TS* __restrict__ x, const uint8_t* __restrict__ mask,
                           const float* __restrict__ w, const float* __restrict__ reps,
                           const float* __restrict__ ls, const TS* __restrict__ sc,
                           const float* __restrict__ g, TS* __restrict__ dx,
                           float* __restrict__ dw, float* __restrict__ part_reps,
                           float* __restrict__ part_ln, int G, int rs, int C, int k,
                           int chunk, float eps) {
  constexpr int NQ = NC / 4;  // 4-channel groups a lane holds
  extern __shared__ __align__(16) float sm[];
  const int P = rs * rs, nrs = G / rs;
  const int region = blockIdx.x, R = gridDim.x, part = blockIdx.y;
  const int p0 = part * chunk, p1 = min(P, p0 + chunk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, W = blockDim.x >> 5;
  const int nq = C / 4;
  float* lss = sm;               // [C] the LayerNorm scale
  float* repm = lss + C;         // [k][C] round(reps)
  float* wdr = repm + k * C;     // [W][k][C] each warp's dreps partials
  float* mine = wdr + (long long)warp * k * C;
  const TokenMap map{G, rs, nrs, P};

  for (int i = tid; i < C; i += blockDim.x) lss[i] = ls[i];
  for (int i = tid; i < k * C; i += blockDim.x)
    repm[i] = round_to<TM>(reps[(long long)region * k * C + i]);
  for (int i = tid; i < W * k * C; i += blockDim.x) wdr[i] = 0.f;
  float pls[NC], plb[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    pls[i] = 0.f;
    plb[i] = 0.f;
  }
  __syncthreads();

  for (int p = p0 + warp; p < p1; p += W) {
    const long long t = token_of(map, region, p);
    const float m = mask[t] ? 1.f : 0.f;
    float wr[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      wr[j] = j < k ? round_to<TM>(w[((long long)region * k + j) * P + p]) : 0.f;
    // the row's loads, all issued before any is used (group index clamped;
    // groups past C are zeroed below)
    float vals[NC], gv[NC], sv[NC];
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const long long at = t * C + 4 * min(lane + 32 * i, nq - 1);
      const float4 xv = load4(x + at), gg = load4(g + at);
      const float4 ss = sc ? load4(sc + at) : make_float4(0.f, 0.f, 0.f, 0.f);
      vals[4 * i] = xv.x; vals[4 * i + 1] = xv.y; vals[4 * i + 2] = xv.z; vals[4 * i + 3] = xv.w;
      gv[4 * i] = gg.x; gv[4 * i + 1] = gg.y; gv[4 * i + 2] = gg.z; gv[4 * i + 3] = gg.w;
      sv[4 * i] = ss.x; sv[4 * i + 1] = ss.y; sv[4 * i + 2] = ss.z; sv[4 * i + 3] = ss.w;
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int q = lane + 32 * i, c0 = 4 * min(q, nq - 1);
      const bool ok = q < nq;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float y = 0.f;
#pragma unroll
        for (int j = 0; j < KMAX; ++j)
          if (j < k) y = fmaf(wr[j], repm[j * C + c0 + e], y);
        const float v = ok ? vals[4 * i + e] + y * m + sv[4 * i + e] : 0.f;
        vals[4 * i + e] = v;
        gv[4 * i + e] = ok ? gv[4 * i + e] * m : 0.f;
        s1 += v;
        s2 += v * v;
      }
    }
    // the LayerNorm statistics (flax fast variance), as warp_ln_stats
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const float mu = s1 / C;
    const float rstd = 1.f / sqrtf(fmaxf(0.f, s2 / C - mu * mu) + eps);
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int c0 = 4 * min(lane + 32 * i, nq - 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float zh = (vals[4 * i + e] - mu) * rstd;
        vals[4 * i + e] = zh;
        const float dzh = gv[4 * i + e] * lss[c0 + e];
        a += dzh;
        b += dzh * zh;
      }
    }
    const float m1 = warp_sum(a) / C, m2 = warp_sum(b) / C;
    float acc[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) acc[j] = 0.f;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int q = lane + 32 * i;
      if (q < nq) {
        const int c0 = 4 * q;
        float go[4], gm[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 4 * i + e;
          go[e] = rstd * (gv[n] * lss[c0 + e] - m1 - vals[n] * m2);
          gm[e] = round_to<TM>(go[e] * m);
          pls[n] += gv[n] * vals[n];
          plb[n] += gv[n];
        }
        store4(dx + t * C + c0, go[0], go[1], go[2], go[3]);
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          if (j < k) {
            const float4 rv = *reinterpret_cast<const float4*>(&repm[j * C + c0]);
            acc[j] = fmaf(rv.x, gm[0], fmaf(rv.y, gm[1], fmaf(rv.z, gm[2],
                                                             fmaf(rv.w, gm[3], acc[j]))));
            float4* d = reinterpret_cast<float4*>(&mine[j * C + c0]);
            float4 u = *d;
            u.x = fmaf(wr[j], gm[0], u.x);
            u.y = fmaf(wr[j], gm[1], u.y);
            u.z = fmaf(wr[j], gm[2], u.z);
            u.w = fmaf(wr[j], gm[3], u.w);
            *d = u;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) {
        const float s = warp_sum(acc[j]);
        if (lane == 0) dw[((long long)region * k + j) * P + p] = s;
      }
    }
  }
  __syncthreads();

  // the warps' partials, summed in warp order
  const long long blk = (long long)part * R + region;
  for (int e = tid; e < k * C; e += blockDim.x) {
    float s = 0.f;
    for (int v = 0; v < W; ++v) s += wdr[(long long)v * k * C + e];
    part_reps[blk * k * C + e] = s;
  }
  for (int r = 0; r < 2; ++r) {  // dls, then dlb, through the same buffer
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int q = lane + 32 * i;
      if (q < nq) {
        const int n = 4 * i;
        if (r)
          store4(&wdr[warp * C + 4 * q], plb[n], plb[n + 1], plb[n + 2], plb[n + 3]);
        else
          store4(&wdr[warp * C + 4 * q], pls[n], pls[n + 1], pls[n + 2], pls[n + 3]);
      }
    }
    __syncthreads();
    for (int c = tid; c < C; c += blockDim.x) {
      float s = 0.f;
      for (int v = 0; v < W; ++v) s += wdr[v * C + c];
      part_ln[blk * 2 * C + r * C + c] = s;
    }
  }
}

template <typename TS, typename TM, int NC>
cudaError_t launch_redistribute_ln_bwd(dim3 grid, int warps, size_t smem, cudaStream_t stream,
                                       const void* x, const void* mask, const void* w,
                                       const void* reps, const void* ls, const void* sc,
                                       const void* g, void* dx, void* dw, void* part_reps,
                                       void* part_ln, int G, int rs, int C, int k, int chunk,
                                       float eps) {
  cudaError_t err = cudaFuncSetAttribute(redistribute_ln_bwd_kernel<TS, TM, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  redistribute_ln_bwd_kernel<TS, TM, NC><<<grid, 32 * warps, smem, stream>>>(
      (const TS*)x, (const uint8_t*)mask, (const float*)w, (const float*)reps,
      (const float*)ls, (const TS*)sc, (const float*)g, (TS*)dx, (float*)dw,
      (float*)part_reps, (float*)part_ln, G, rs, C, k, chunk, eps);
  return cudaGetLastError();
}

constexpr int BT = 16;   // token rows per chunk (K11)
constexpr int CPT = 4;   // channels per thread (K11): C <= 4 * 256

size_t rgrid_bwd_smem_bytes(int C, int k) {
  return (size_t)(k * C + BT * C + k * BT) * 4;
}

template <typename TS, typename TM>
__global__ void __launch_bounds__(256)
redistribute_grid_bwd_kernel(const TS* __restrict__ g, const uint8_t* __restrict__ mask,
                             const float* __restrict__ w, const float* __restrict__ reps,
                             float* __restrict__ dw, float* __restrict__ dreps,
                             TokenMap map, int C, int k) {
  extern __shared__ __align__(16) float sm[];
  float* rs_ = sm;             // [k][C] round(reps_r)
  float* gs = rs_ + k * C;     // [BT][C] round(g * mask) of the chunk's rows
  float* ws = gs + BT * C;     // [k][BT] round(w_r) of the chunk's rows
  const int P = map.P;
  const int r = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* rr = reps + (long long)r * k * C;
  for (int i = tid; i < k * C; i += blockDim.x) rs_[i] = round_to<TM>(rr[i]);
  float acc[CPT][KMAX];
#pragma unroll
  for (int i = 0; i < CPT; ++i)
#pragma unroll
    for (int j = 0; j < KMAX; ++j) acc[i][j] = 0.f;

  for (int p0 = 0; p0 < P; p0 += BT) {
    const int nb = min(BT, P - p0);
    for (int i = tid; i < nb * C; i += blockDim.x) {
      const int row = i / C, c = i - row * C;
      const long long t = token_of(map, r, p0 + row);
      const float m = mask[t] ? 1.f : 0.f;
      gs[i] = round_to<TM>(to_f(g[t * C + c]) * m);
    }
    for (int i = tid; i < k * BT; i += blockDim.x) {
      const int j = i / BT, row = i % BT;
      ws[i] = row < nb ? round_to<TM>(w[((long long)r * k + j) * P + p0 + row]) : 0.f;
    }
    __syncthreads();
    // dw: one warp per row, k dot products over C
    for (int row = warp; row < nb; row += nwarps) {
      float a[KMAX];
#pragma unroll
      for (int j = 0; j < KMAX; ++j) a[j] = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float gv = gs[row * C + c];
#pragma unroll
        for (int j = 0; j < KMAX; ++j)
          if (j < k) a[j] = fmaf(rs_[j * C + c], gv, a[j]);
      }
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j < k) {
          const float s = warp_sum(a[j]);
          if (lane == 0) dw[((long long)r * k + j) * P + p0 + row] = s;
        }
      }
    }
    // dreps: each thread its channels, the chunk's rows in order
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = tid + i * blockDim.x;
      if (c < C) {
        for (int row = 0; row < nb; ++row) {
          const float gv = gs[row * C + c];
#pragma unroll
          for (int j = 0; j < KMAX; ++j)
            if (j < k) acc[i][j] = fmaf(ws[j * BT + row], gv, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = tid + i * blockDim.x;
    if (c < C) {
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (j < k) dreps[((long long)r * k + j) * C + c] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int cb_compress_grid_bwd(int ts, int tm, const void* x, const void* mask,
                                    const void* ls, const void* lb, const void* phi,
                                    const void* dreps, const void* dw, void* dx, void* part,
                                    int B, int G, int rs, int C, int k, float eps,
                                    void* stream) {
  if (C > 32 * CPL || k < 1 || k > KMAX || G % rs != 0) return (int)cudaErrorInvalidValue;
  const int nrs = G / rs;
  const size_t smem = cgrid_smem_bytes(C, k, rs * rs);
  cudaError_t err = cudaSuccess;
  RRT_DISPATCH(ts, TS, RRT_DISPATCH(tm, TM,
      err = cudaFuncSetAttribute(compress_grid_bwd_kernel<TS, TM>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      compress_grid_bwd_kernel<TS, TM><<<B * nrs * nrs, 256, smem, (cudaStream_t)stream>>>(
          (const TS*)x, (const uint8_t*)mask, (const float*)ls, (const float*)lb,
          (const float*)phi, (const float*)dreps, (const float*)dw, (TS*)dx,
          (float*)part, G, rs, C, k, eps)));
  return (int)cudaGetLastError();
}

// K9: one block per (region, chunk of `chunk` token rows); the partials
// part_reps (parts, R, k, C) and part_ln (parts * R, 2 C) are summed by
// cb_reduce over the parts (dreps) and over every block (dls, dlb)
extern "C" int cb_redistribute_ln_bwd(int ts, int tm, const void* x, const void* mask,
                                      const void* w, const void* reps, const void* ls,
                                      const void* sc, const void* g, void* dx, void* dw,
                                      void* part_reps, void* part_ln, int B, int G, int rs,
                                      int C, int k, int chunk, float eps, void* stream) {
  if (C > 32 * CPL || C % 4 != 0 || k < 1 || k > KMAX || rs < 1 || G % rs != 0 ||
      chunk < 1)
    return (int)cudaErrorInvalidValue;
  const int nrs = G / rs, P = rs * rs;
  const dim3 grid(B * nrs * nrs, (P + chunk - 1) / chunk);
  const int warps = rgrid_warps(C, k);
  const size_t smem = rgrid_smem_bytes(C, k, warps);
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
#define RRT_K9(NC)                                                                       \
  err = launch_redistribute_ln_bwd<TS, TM, NC>(grid, warps, smem, s, x, mask, w, reps, ls, \
                                               sc, g, dx, dw, part_reps, part_ln, G, rs,  \
                                               C, k, chunk, eps)
  RRT_DISPATCH(ts, TS, RRT_DISPATCH(tm, TM,
      if (C <= 128) RRT_K9(4);
      else if (C <= 256) RRT_K9(8);
      else if (C <= 512) RRT_K9(16);
      else RRT_K9(32)));
#undef RRT_K9
  return (int)err;
}

// K11: g (B, G*G, C) -> dw (B, nR, k, P), dreps (B, nR, k, C)
extern "C" int cb_redistribute_grid_bwd(int ts, int tm, const void* g, const void* mask,
                                        const void* w, const void* reps, void* dw,
                                        void* dreps, int B, int G, int rs, int C, int k,
                                        void* stream) {
  if (C > CPT * 256 || k < 1 || k > KMAX || rs < 1 || G % rs != 0)
    return (int)cudaErrorInvalidValue;
  const int nrs = G / rs;
  const TokenMap map{G, rs, nrs, rs * rs};
  const size_t smem = rgrid_bwd_smem_bytes(C, k);
  cudaError_t err = cudaSuccess;
  RRT_DISPATCH(ts, TS, RRT_DISPATCH(tm, TM,
      err = cudaFuncSetAttribute(redistribute_grid_bwd_kernel<TS, TM>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      redistribute_grid_bwd_kernel<TS, TM><<<B * nrs * nrs, 256, smem,
                                             (cudaStream_t)stream>>>(
          (const TS*)g, (const uint8_t*)mask, (const float*)w, (const float*)reps,
          (float*)dw, (float*)dreps, map, C, k)));
  return (int)cudaGetLastError();
}

extern "C" int cb_reduce(const void* part, int S, long long N, void* out, void* stream) {
  return (int)launch_reduce_rows(part, S, N, out, (cudaStream_t)stream);
}
