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
// against a few tens of MFLOP.  K4's design (K3's layout, crmsa.cuh): a
// first row pass (a warp a token row, 16-byte loads) writes each row's k
// logits, d_comb, LayerNorm statistics and the two k-wide row sums its
// LayerNorm backward needs; a second reads them back (a few floats a row)
// for the region's sums over P and each row's scalars, then streams the
// rows, a thread a 16-byte channel group: dx written with 16-byte stores,
// the per-channel sums (dls, dlb, dphi) in registers.  Each region's rows
// are split over blocks as K3's, so B = 1 fills the card; launch_reduce_rows
// adds the blocks' partials in a fixed order.  The stream is read twice
// (from L2 at B = 1) and dx written once.
//
// K9's design: one pass over x, the shortcut and g, as the TPU kernel (its
// two-pass form read them twice: at B = 8 the regions in flight hold ~450
// MB, far past the 50 MB L2), in the redistribution's row layout of
// crmsa.cuh (a lane four consecutive channels a group, 16-byte loads; 8-byte
// for a bf16 stream).  A warp owns a token row at a time: it recomputes the
// stream value and statistics with K8's own function (stream_ln, so the
// values are K8's bit for bit), writes dx and the row's dw sums, and adds
// the row's terms into its own partials (dls and dlb in registers, dreps in
// its slice of shared memory), so the warps of a block run without a
// barrier between rows and keep their loads in flight; the warps' partials
// are summed in warp order at the end.  Each region's rows are split over
// enough blocks (crmsa_kernels.row_split) that B = 1 (64 regions) still
// puts two blocks on every SM; launch_reduce_rows adds the blocks' partials
// in a fixed order: no atomics, so every run gives the same bits.
//
// K11 replaces crmsa_kernels.py::_rgrid_bwd_pallas (kernel body
// _rgrid_bwd_kernel), the backward of K10: with gm = round(g * mask) in
// region order, dw = round(reps) gm^T (k, P) and dreps = round(w) gm (k, C)
// per region; dx (g itself, or zeros) stays in the wrapper.  Bound: bytes
// (c16_r50 + FFN at L = 9000, B = 8: the f32 g, ~151 MB, ~0.045 ms).
// Design: K9's kernel without the LayerNorm (one template, LN = false): no
// x, shortcut or dx, g read once in its own dtype, gm formed in registers,
// dw a warp sum against round(reps) in shared memory, dreps in per-warp
// partials; rows split over blocks as K9's, and a region of one chunk
// writes dreps in place (no second pass).
#include "crmsa.cuh"

using namespace rrt;

namespace {

// Pass 2 of K4 (pass 1: compress_rows_kernel with DC: the rows' logits,
// d_comb, LayerNorm statistics and LayerNorm-backward row sums).  Every
// block of a region reduces, in one fixed order, the region's logits (max,
// min, softmax sums), the sums over P of the softmax and min-max backwards
// (s1, sdm, s3 and the tie counts) and A_j = sum_c ls round(dreps_j), B_j =
// sum_c ls phi_j.  A thread a row of the chunk forms the row's dl =
// round(d logit), round(combine) and the LayerNorm backward's means, which
// are linear in them: m1 = m / C (round(comb) A + dl B), m2 = m / C
// (round(comb) su + dl sv).  Then thread (slot, group) streams its channel
// group over rows p0 + slot, p0 + slot + slots, ... (UNR in flight):
// dz = round(comb)^T round(dreps) + dl^T phi, dx written with 16-byte
// stores, dls, dlb and dphi (dl z^T) added in registers; the slots' sums,
// added in slot order, go to part[part * R + region] = (dls | dlb | dphi^T),
// which launch_reduce_rows sums over every block.  KB >= k bounds the
// accumulators.
template <typename TS, typename TM, int KB>
__global__ void __launch_bounds__(CR_THREADS)
compress_bwd_kernel(const TS* __restrict__ x, const uint8_t* __restrict__ mask,
                    const float* __restrict__ ls, const float* __restrict__ lb,
                    const float* __restrict__ phi, const float* __restrict__ dreps,
                    const float* __restrict__ dw, const float* __restrict__ logits,
                    const float* __restrict__ stats, const float* __restrict__ dcomb,
                    const float* __restrict__ su, const float* __restrict__ sv,
                    TS* __restrict__ dx, float* __restrict__ part, TokenMap map, int C, int k,
                    int chunk, int slots, int vec) {
  constexpr int VW = vec_width<TS>(), UNR = 16 / VW;
  extern __shared__ __align__(16) float sm[];
  __shared__ float lmax[KMAX], lmin[KMAX], lsum[KMAX], ga[KMAX], gb[KMAX];
  __shared__ float s1[KMAX], sdm[KMAX], s3[KMAX], nmin[KMAX], nmax[KMAX];
  const int Cp = padded_channels<TS>(C), ng = Cp / VW, P = map.P;
  const int region = blockIdx.x, R = gridDim.x, pt = blockIdx.y;
  const int p0 = pt * chunk, np = min(P, p0 + chunk) - p0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, W = blockDim.x >> 5;
  const int slot = tid / ng, c0 = (tid - slot * ng) * VW;
  float* phit = sm;                // [k][Cp] phi^T (not rounded: dz's second term)
  float* drm = phit + k * Cp;      // [k][Cp] round(dreps_r)
  float* lg = drm + k * Cp;        // [k][P] the region's logits
  float* rc = lg + k * P;          // [k][chunk] round(combine) of the chunk's rows
  float* rdl = rc + k * chunk;     // [k][chunk] dl
  float* rmu = rdl + k * chunk;    // [chunk] mean, 1/std, mask, m1, m2
  float* rrs = rmu + chunk;
  float* rmk = rrs + chunk;
  float* rm1 = rmk + chunk;
  float* rm2 = rm1 + chunk;
  const long long rk = (long long)region * k;
  const float* dwr = dw + rk * P;
  const float* dcr = dcomb + rk * P;
  const long long base = region_base(map, region);
  const int fold = fold_of(map, region);  // its LayerNorm and phi
  ls += (long long)fold * C;
  lb += (long long)fold * C;
  phi += (long long)fold * C * k;

  for (int i = tid; i < k * Cp; i += blockDim.x) {
    const int j = i / Cp, c = i - j * Cp;
    phit[i] = c < C ? phi[c * k + j] : 0.f;
    drm[i] = c < C ? round_to<TM>(dreps[(rk + j) * C + c]) : 0.f;
  }
  for (int i = tid; i < k * P; i += blockDim.x) lg[i] = logits[rk * P + i];
  __syncthreads();
  region_stats(lg, P, k, lmax, lmin, lsum);
  __syncthreads();

  // the sums over P of each row j, a warp a row: d_comb combine, d_mm, d_mm
  // lz, the tie counts; and A_j, B_j over the channels
  for (int j = warp; j < k; j += W) {
    float a = 0.f, b = 0.f, c = 0.f, nlo = 0.f, nhi = 0.f;
    for (int p = lane; p < P; p += 32) {
      float dmax, dsum;
      token_softmax(lg, P, k, p, dmax, dsum);
      const float l = lg[j * P + p], lz = l - lmin[j];
      const float dmm = dwr[j * P + p] * (expf(l - dmax) / dsum);
      a += dcr[j * P + p] * (expf(l - lmax[j]) / lsum[j]);
      b += dmm;
      c += dmm * lz;
      nlo += l == lmin[j] ? 1.f : 0.f;
      nhi += l == lmax[j] ? 1.f : 0.f;
    }
    float ca = 0.f, cb = 0.f;
    for (int cc = lane; cc < C; cc += 32) {
      ca = fmaf(ls[cc], drm[j * Cp + cc], ca);
      cb = fmaf(ls[cc], phit[j * Cp + cc], cb);
    }
    a = warp_sum(a); b = warp_sum(b); c = warp_sum(c);
    nlo = warp_sum(nlo); nhi = warp_sum(nhi);
    ca = warp_sum(ca); cb = warp_sum(cb);
    if (lane == 0) {
      s1[j] = a; sdm[j] = b; s3[j] = c; nmin[j] = nlo; nmax[j] = nhi;
      ga[j] = ca; gb[j] = cb;
    }
  }
  __syncthreads();

  // a thread a row: its logit gradient (rounded to TM), round(combine), the
  // LayerNorm statistics, mask and backward means
  for (int i = tid; i < np; i += blockDim.x) {
    const int p = p0 + i;
    float dmax, dsum, tdisp = 0.f;
    token_softmax(lg, P, k, p, dmax, dsum);
    for (int j = 0; j < k; ++j) {
      const float l = lg[j * P + p];
      tdisp += dwr[j * P + p] * ((l - lmin[j]) / (lmax[j] - lmin[j] + 1e-8f)) *
               (expf(l - dmax) / dsum);
    }
    const long long t = row_token(map, base, p), rp = (long long)region * P + p;
    const float m = mask[t] ? 1.f : 0.f;
    float t1 = 0.f, t2 = 0.f;
    for (int j = 0; j < k; ++j) {
      const float l = lg[j * P + p];
      const float rng = lmax[j] - lmin[j] + 1e-8f;
      const float mmv = (l - lmin[j]) / rng;
      const float comb = expf(l - lmax[j]) / lsum[j], disp = expf(l - dmax) / dsum;
      const float dwv = dwr[j * P + p];
      float g = comb * (dcr[j * P + p] - s1[j]);
      g += disp * (dwv * mmv - tdisp);
      // the min-max backward as the plain version gathers it: exact for a
      // region whose tokens all tie (see compress_grid_bwd_plain)
      const float emin = l == lmin[j] ? 1.f : 0.f, emax = l == lmax[j] ? 1.f : 0.f;
      g += (dwv * disp - emin * sdm[j] / nmin[j]) / rng;
      g += (emin / nmin[j] - emax / nmax[j]) * s3[j] / (rng * rng);
      const float d = round_to<TM>(g), r = round_to<TM>(comb);
      rdl[j * chunk + i] = d;
      rc[j * chunk + i] = r;
      t1 += r * ga[j] + d * gb[j];
      t2 += r * su[(rk + j) * P + p] + d * sv[(rk + j) * P + p];
    }
    rmu[i] = stats[2 * rp];
    rrs[i] = stats[2 * rp + 1];
    rmk[i] = m;
    rm1[i] = m * t1 / C;
    rm2[i] = m * t2 / C;
  }
  __syncthreads();

  float pls[VW], plb[VW], pph[KB][VW];
#pragma unroll
  for (int e = 0; e < VW; ++e) {
    pls[e] = plb[e] = 0.f;
#pragma unroll
    for (int j = 0; j < KB; ++j) pph[j][e] = 0.f;
  }
  if (slot < slots) {
    float s[VW], b[VW];
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      s[e] = c0 + e < C ? ls[c0 + e] : 0.f;
      b[e] = c0 + e < C ? lb[c0 + e] : 0.f;
    }
    for (int i0 = slot; i0 < np; i0 += UNR * slots) {
      float v[UNR][VW];
      long long row[UNR];
#pragma unroll
      for (int q = 0; q < UNR; ++q) {
        const int i = i0 + q * slots;
        row[q] = i < np ? row_token(map, base, p0 + i) * C : 0;
        if (i < np) {
          load_group<TS>(x + row[q], c0, C, vec, v[q]);
        } else {
#pragma unroll
          for (int e = 0; e < VW; ++e) v[q][e] = 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < UNR; ++q) {
        const int i = i0 + q * slots;
        if (i < np) {
          const float mu = rmu[i], rstd = rrs[i], m = rmk[i], m1 = rm1[i], m2 = rm2[i];
          float dz[VW], o[VW];
#pragma unroll
          for (int e = 0; e < VW; ++e) dz[e] = 0.f;
#pragma unroll
          for (int j = 0; j < KB; ++j) {
            if (j < k) {
              const float r = rc[j * chunk + i];
              float f[VW];
              lds<VW>(drm + j * Cp + c0, f);
#pragma unroll
              for (int e = 0; e < VW; ++e) dz[e] = fmaf(r, f[e], dz[e]);
            }
          }
#pragma unroll
          for (int j = 0; j < KB; ++j) {
            if (j < k) {
              const float d = rdl[j * chunk + i];
              float f[VW];
              lds<VW>(phit + j * Cp + c0, f);
#pragma unroll
              for (int e = 0; e < VW; ++e) dz[e] = fmaf(d, f[e], dz[e]);
            }
          }
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            const float zh = (v[q][e] - mu) * rstd;
            const float z = round_to<TM>(ln_apply(v[q][e], mu, rstd, s[e], b[e], m));
            const float dzs = dz[e] * m;
            pls[e] += dzs * zh;
            plb[e] += dzs;
#pragma unroll
            for (int j = 0; j < KB; ++j)
              if (j < k) pph[j][e] = fmaf(rdl[j * chunk + i], z, pph[j][e]);
            o[e] = rstd * (dzs * s[e] - m1 - zh * m2);
          }
          store_group<TS>(dx + row[q], c0, C, vec, o);
        }
      }
    }
  }
  __syncthreads();

  // the slots' sums in slot order (the staging arrays are dead: reuse them)
  float* red = sm;  // [slots][2 + k][Cp]
  if (slot < slots) {
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      red[((long long)slot * (2 + k)) * Cp + c0 + e] = pls[e];
      red[((long long)slot * (2 + k) + 1) * Cp + c0 + e] = plb[e];
#pragma unroll
      for (int j = 0; j < KB; ++j)
        if (j < k) red[((long long)slot * (2 + k) + 2 + j) * Cp + c0 + e] = pph[j][e];
    }
  }
  __syncthreads();
  float* out = part + fold_slot(map, region, R, pt, gridDim.y) * (2 + k) * C;
  for (int e = tid; e < (2 + k) * C; e += blockDim.x) {
    const int r = e / C, c = e - r * C;
    float t = 0.f;
    for (int u = 0; u < slots; ++u) t += red[((long long)u * (2 + k) + r) * Cp + c];
    out[e] = t;
  }
}

constexpr int K9_MAX_WARPS = 8;
constexpr int K9_SMEM_BUDGET = 110 * 1024;  // two blocks an SM

// warps of a K9 / K11 block: each keeps its dreps partials (k x C floats)
// in shared memory beside round(reps), within K9_SMEM_BUDGET
int rgrid_warps(int C, int k) {
  const int per = k * C * 4;
  return std::max(1, std::min(K9_MAX_WARPS, (K9_SMEM_BUDGET - per - C * 4) / per));
}

// round(reps), the warps' dreps partials and, with the LayerNorm, its scale
size_t rgrid_smem_bytes(int C, int k, int warps, bool ln) {
  return ((size_t)(1 + warps) * k * C + (ln ? C : 0)) * 4;
}

// K9 (LN) and K11 (!LN), one pass over the region's rows p0 .. p1 - 1 (p1 -
// p0 <= chunk), each warp its rows p0 + warp, p0 + warp + W, ... with no
// barrier between rows, in the row layout of crmsa.cuh (a lane NC channels
// as groups of 4, every load of a row issued before any is used).
//  * K9: the warp recomputes K8's stream value and statistics (stream_ln,
//    the function K8 computes them with), runs the LayerNorm backward,
//    writes dx and adds dls += gym * zhat, dlb += gym (gym = g * mask) into
//    its lanes' registers; gm = round(mask * dx).
//  * K11: gm = round(g * mask), g in the stream dtype.
// Both write the row's k dw sums round(reps) gm^T (a warp sum each) and add
// dreps[j] += round(w)[j, p] gm into the warp's own k x C slice of shared
// memory.  At the end the warps' partials are summed in warp order into
// part_reps[part, region, k, C] (dreps itself when a region is one chunk)
// and, K9, part_ln[part * R + region, 2 C] = (dls | dlb); launch_reduce_rows
// sums them over the blocks in a fixed order.  C is a multiple of 4, C <= 32
// NC.
template <typename TS, typename TG, typename TM, int NC, bool LN, int KW>
__global__ void __launch_bounds__(32 * K9_MAX_WARPS, NC <= 16 ? 2 : 1)
redistribute_bwd_kernel(const TS* __restrict__ x, const uint8_t* __restrict__ mask,
                        const float* __restrict__ w, const float* __restrict__ reps,
                        const float* __restrict__ ls, const TS* __restrict__ sc,
                        const TG* __restrict__ g, TS* __restrict__ dx, float* __restrict__ dw,
                        float* __restrict__ part_reps, float* __restrict__ part_ln,
                        TokenMap map, int C, int k, int chunk, float eps) {
  constexpr int NQ = NC / 4;  // 4-channel groups a lane holds
  extern __shared__ __align__(16) float sm[];
  const int P = map.P, region = blockIdx.x, R = gridDim.x, part = blockIdx.y;
  const int p0 = part * chunk, p1 = min(P, p0 + chunk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, W = blockDim.x >> 5;
  const int nq = C / 4;
  float* repm = sm;                    // [k][C] round(reps)
  float* lss = repm + k * C;           // [C] the LayerNorm scale (K9)
  float* wdr = lss + (LN ? C : 0);     // [W][k][C] each warp's dreps partials
  float* mine = wdr + (long long)warp * k * C;
  const long long base = region_base(map, region);

  if constexpr (LN)
    for (int i = tid; i < C; i += blockDim.x) lss[i] = ls[(long long)fold_of(map, region) * C + i];
  for (int i = tid; i < k * C; i += blockDim.x)
    repm[i] = round_to<TM>(reps[(long long)region * k * C + i]);
  for (int i = tid; i < W * k * C; i += blockDim.x) wdr[i] = 0.f;
  float pls[NC], plb[NC];
#pragma unroll
  for (int n = 0; n < NC; ++n) pls[n] = plb[n] = 0.f;
  __syncthreads();

  for (int p = p0 + warp; p < p1; p += W) {
    const long long t = row_token(map, base, p);
    const float m = mask[t] ? 1.f : 0.f;
    float wr[KW];
#pragma unroll
    for (int j = 0; j < KW; ++j)
      wr[j] = j < k ? round_to<TM>(w[((long long)region * k + j) * P + p]) : 0.f;
    float gv[NC], xv[NC];
    load_row4<TG, NC>(g + t * C, lane, nq, gv);
    float mu = 0.f, rstd = 1.f, m1 = 0.f, m2 = 0.f;
    if constexpr (LN) {
      float s[NC];
      load_row4<TS, NC>(x + t * C, lane, nq, xv);
      if (sc) {
        load_row4<TS, NC>(sc + t * C, lane, nq, s);
      } else {
#pragma unroll
        for (int n = 0; n < NC; ++n) s[n] = 0.f;
      }
      stream_ln<NC, KW>(xv, s, m, wr, repm, k, C, lane, eps, mu, rstd);
      // zhat into xv, gym = g * mask (zero past C) into gv, the backward's
      // two row means
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const int q = lane + 32 * i;
        const float4 l = *reinterpret_cast<const float4*>(lss + 4 * min(q, nq - 1));
        const float lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 4 * i + e;
          const float zh = (xv[n] - mu) * rstd;
          xv[n] = zh;
          gv[n] = q < nq ? gv[n] * m : 0.f;
          const float dzh = gv[n] * lv[e];
          a += dzh;
          b += dzh * zh;
        }
      }
      m1 = warp_sum(a) / C;
      m2 = warp_sum(b) / C;
    }
    // a group at a time: gm (K9: from dx, written here), the row's dw sums
    // and the warp's dreps partials
    float acc[KW];
#pragma unroll
    for (int j = 0; j < KW; ++j) acc[j] = 0.f;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int q = lane + 32 * i;
      if (q < nq) {
        const int c0 = 4 * q;
        float gm[4];
        if constexpr (LN) {
          const float4 l = *reinterpret_cast<const float4*>(lss + c0);
          const float lv[4] = {l.x, l.y, l.z, l.w};
          float go[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = 4 * i + e;
            go[e] = rstd * (gv[n] * lv[e] - m1 - xv[n] * m2);
            gm[e] = round_to<TM>(go[e] * m);
            pls[n] += gv[n] * xv[n];
            plb[n] += gv[n];
          }
          store4(dx + t * C + c0, make_float4(go[0], go[1], go[2], go[3]));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) gm[e] = round_to<TM>(gv[4 * i + e] * m);
        }
#pragma unroll
        for (int j = 0; j < KW; ++j) {
          if (j < k) {
            const float4 rv = *reinterpret_cast<const float4*>(&repm[j * C + c0]);
            acc[j] = fmaf(rv.x, gm[0], fmaf(rv.y, gm[1], fmaf(rv.z, gm[2],
                                                          fmaf(rv.w, gm[3], acc[j]))));
            float4* d = reinterpret_cast<float4*>(&mine[j * C + c0]);
            float4 o = *d;
            o.x = fmaf(wr[j], gm[0], o.x);
            o.y = fmaf(wr[j], gm[1], o.y);
            o.z = fmaf(wr[j], gm[2], o.z);
            o.w = fmaf(wr[j], gm[3], o.w);
            *d = o;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < KW; ++j) {
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
  if constexpr (LN) {
    for (int r = 0; r < 2; ++r) {  // dls, then dlb, through the same buffer
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const int q = lane + 32 * i;
        if (q < nq) {
          const int n = 4 * i;
          store4(&wdr[warp * C + 4 * q],
                 r ? make_float4(plb[n], plb[n + 1], plb[n + 2], plb[n + 3])
                   : make_float4(pls[n], pls[n + 1], pls[n + 2], pls[n + 3]));
        }
      }
      __syncthreads();
      for (int c = tid; c < C; c += blockDim.x) {
        float s = 0.f;
        for (int v = 0; v < W; ++v) s += wdr[v * C + c];
        part_ln[fold_slot(map, region, R, part, gridDim.y) * 2 * C + r * C + c] = s;
      }
    }
  }
}

template <typename TS, typename TG, typename TM, int NC, bool LN, int KW>
cudaError_t launch_redistribute_bwd_kw(dim3 grid, int warps, size_t smem, cudaStream_t stream,
                                       const void* x, const void* mask, const void* w,
                                       const void* reps, const void* ls, const void* sc,
                                       const void* g, void* dx, void* dw, float* part_reps,
                                       float* part_ln, TokenMap map, int C, int k, int chunk,
                                       float eps) {
  cudaError_t err = cr_smem(redistribute_bwd_kernel<TS, TG, TM, NC, LN, KW>, smem);
  if (err != cudaSuccess) return err;
  redistribute_bwd_kernel<TS, TG, TM, NC, LN, KW><<<grid, 32 * warps, smem, stream>>>(
      (const TS*)x, (const uint8_t*)mask, (const float*)w, (const float*)reps,
      (const float*)ls, (const TS*)sc, (const TG*)g, (TS*)dx, (float*)dw, part_reps, part_ln,
      map, C, k, chunk, eps);
  return cudaGetLastError();
}

// the instance for k's weight registers (k_width)
template <typename TS, typename TG, typename TM, int NC, bool LN>
cudaError_t launch_redistribute_bwd(dim3 grid, int warps, size_t smem, cudaStream_t stream,
                                    const void* x, const void* mask, const void* w,
                                    const void* reps, const void* ls, const void* sc,
                                    const void* g, void* dx, void* dw, float* part_reps,
                                    float* part_ln, TokenMap map, int C, int k, int chunk,
                                    float eps) {
  if (k_width(k) == 8)
    return launch_redistribute_bwd_kw<TS, TG, TM, NC, LN, 8>(
        grid, warps, smem, stream, x, mask, w, reps, ls, sc, g, dx, dw, part_reps, part_ln, map,
        C, k, chunk, eps);
  return launch_redistribute_bwd_kw<TS, TG, TM, NC, LN, 16>(
      grid, warps, smem, stream, x, mask, w, reps, ls, sc, g, dx, dw, part_reps, part_ln, map, C,
      k, chunk, eps);
}

template <typename TS, typename TM, int KB>
cudaError_t launch_compress_bwd(dim3 grid, StreamShape sh, size_t smem, cudaStream_t s,
                                const void* x, const void* mask, const float* ls,
                                const float* lb, const float* phi, const float* dreps,
                                const float* dw, const float* logits, const float* stats,
                                const float* dcomb, const float* su, const float* sv, void* dx,
                                float* part, TokenMap map, int C, int k, int chunk, int vec) {
  cudaError_t err = cr_smem(compress_bwd_kernel<TS, TM, KB>, smem);
  if (err != cudaSuccess) return err;
  compress_bwd_kernel<TS, TM, KB><<<grid, sh.threads, smem, s>>>(
      (const TS*)x, (const uint8_t*)mask, ls, lb, phi, dreps, dw, logits, stats, dcomb, su, sv,
      (TS*)dx, part, map, C, k, chunk, sh.slots, vec);
  return cudaGetLastError();
}

// K4's two passes and the sum of the blocks' partials.  scratch: the rows'
// logits, d_comb, su and sv (R, k, P) each, then their LayerNorm statistics
// (R, P, 2); part (parts * R, (2 + k) C); out = (dls | dlb | dphi^T), one
// row a fold (F = R / map.rf), each the sum of its own blocks' partials.
template <typename TS, typename TM>
int compress_bwd(const void* x, const void* mask, const float* ls, const float* lb,
                 const float* phi, const float* dreps, const float* dw, void* dx,
                 float* scratch, float* part, float* out, int R, TokenMap map, int C, int k,
                 int chunk, float eps, cudaStream_t s) {
  const int P = map.P, parts = (P + chunk - 1) / chunk;
  const int Cp = padded_channels<TS>(C), vec = use_vec<TS>(x, C) && use_vec<TS>(dx, C);
  const StreamShape sh = stream_shape<TS>(C);
  const size_t smem = (size_t)std::max(2 * k * Cp + k * P + (2 * k + 5) * chunk,
                                       sh.slots * (2 + k) * Cp) * 4;
  const dim3 grid(R, parts);
  const long long rkp = (long long)R * k * P;
  float *logits = scratch, *dcomb = scratch + rkp, *su = scratch + 2 * rkp,
        *sv = scratch + 3 * rkp, *stats = scratch + 4 * rkp;
  cudaError_t err = launch_compress_rows<TS, TM, true>(grid, s, x, mask, ls, lb, phi, dreps,
                                                      logits, stats, dcomb, su, sv, map, C, k,
                                                      chunk, vec, eps);
  if (err != cudaSuccess) return (int)err;
#define RRT_COMPRESS_BWD(KB)                                                                \
  err = launch_compress_bwd<TS, TM, KB>(grid, sh, smem, s, x, mask, ls, lb, phi, dreps, dw, \
                                        logits, stats, dcomb, su, sv, dx, part, map, C, k,  \
                                        chunk, vec)
  switch (k_bound(k)) {
    case 1: RRT_COMPRESS_BWD(1); break;
    case 4: RRT_COMPRESS_BWD(4); break;
    case 8: RRT_COMPRESS_BWD(8); break;
    default: RRT_COMPRESS_BWD(16); break;
  }
#undef RRT_COMPRESS_BWD
  const int F = map.rf > 0 ? R / map.rf : 1;
  if (err == cudaSuccess)
    err = launch_reduce_rows(part, parts * (R / F), (long long)(2 + k) * C, out, s, F);
  return (int)err;
}

}  // namespace

// K4: x (B, G*G, C), d(reps) (B, nR, k, C), d(w) (B, nR, k, P) -> dx in x's
// dtype and out = (dls | dlb | dphi^T) ((2 + k) C); scratch (R (4 k + 2) P
// floats) and part (parts * R, (2 + k) C) as compress_bwd takes them.  bf >
// 0: folds of bf bags with ls, lb (F, C), phi (F, C, k); out (F, (2 + k) C)
extern "C" int cb_compress_grid_bwd(int ts, int tm, const void* x, const void* mask,
                                    const void* ls, const void* lb, const void* phi,
                                    const void* dreps, const void* dw, void* dx,
                                    void* scratch, void* part, void* out, int B, int G, int rs,
                                    int C, int k, int chunk, float eps, int bf, void* stream) {
  if (C < 1 || C > 32 * CPL || k < 1 || k > KMAX || rs < 1 || G % rs != 0 || chunk < 1 ||
      bf < 0 || (bf > 0 && B % bf != 0))
    return (int)cudaErrorInvalidValue;
  const int nrs = G / rs;
  const TokenMap map{G, rs, nrs, rs * rs, bf * nrs * nrs};
  RRT_DISPATCH(ts, TS, RRT_DISPATCH(tm, TM,
      return compress_bwd<TS, TM>(x, mask, (const float*)ls, (const float*)lb,
                                  (const float*)phi, (const float*)dreps, (const float*)dw, dx,
                                  (float*)scratch, (float*)part, (float*)out, B * nrs * nrs,
                                  map, C, k, chunk, eps, (cudaStream_t)stream)));
  return (int)cudaErrorInvalidValue;
}

// K9 and K11's shared frame: one block per (region, chunk of `chunk` token
// rows) of the (B, G*G, C) stream; with more than one chunk a region the
// blocks' dreps partials go to part (parts, R, k, C) and are summed into
// dreps, else straight into dreps
struct RgridPlan {
  TokenMap map;
  dim3 grid;
  int R, parts;
  bool ok;
};

static RgridPlan rgrid_plan(int B, int G, int rs, int C, int k, int chunk, int bf = 0) {
  RgridPlan pl{};
  pl.ok = C >= 4 && C <= 32 * CPL && C % 4 == 0 && k >= 1 && k <= KMAX && rs >= 1 &&
          G % rs == 0 && chunk >= 1 && bf >= 0 && (bf == 0 || B % bf == 0);
  if (!pl.ok) return pl;
  const int nrs = G / rs, P = rs * rs;
  pl.map = TokenMap{G, rs, nrs, P, bf * nrs * nrs};
  pl.R = B * nrs * nrs;
  pl.parts = (P + chunk - 1) / chunk;
  pl.grid = dim3(pl.R, pl.parts);
  return pl;
}

// K9: x, the shortcut (or null) in the stream dtype, g = d(out) fp32 ->
// dx, dw (B, nR, k, P), dreps (B, nR, k, C) and dln = (dls | dlb) (2 C);
// part: (parts, R, k, C) floats when a region is more than one chunk, then
// (parts * R, 2 C) for the blocks' dls / dlb partials.  bf > 0: folds of bf
// bags, ls (F, C), dln (F, 2 C) each fold's own sums
extern "C" int cb_redistribute_ln_bwd(int ts, int tm, const void* x, const void* mask,
                                      const void* w, const void* reps, const void* ls,
                                      const void* sc, const void* g, void* dx, void* dw,
                                      void* dreps, void* dln, void* part, int B, int G, int rs,
                                      int C, int k, int chunk, float eps, int bf,
                                      void* stream) {
  const RgridPlan pl = rgrid_plan(B, G, rs, C, k, chunk, bf);
  if (!pl.ok || part == nullptr) return (int)cudaErrorInvalidValue;
  const long long nrep = (long long)pl.R * k * C;
  float* part_reps = pl.parts > 1 ? (float*)part : (float*)dreps;
  float* part_ln = (float*)part + (pl.parts > 1 ? pl.parts * nrep : 0);
  const int warps = rgrid_warps(C, k);
  const size_t smem = rgrid_smem_bytes(C, k, warps, true);
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
#define RRT_K9(NC)                                                                            \
  err = launch_redistribute_bwd<TS, float, TM, NC, true>(pl.grid, warps, smem, s, x, mask, w, \
                                                         reps, ls, sc, g, dx, dw, part_reps,  \
                                                         part_ln, pl.map, C, k, chunk, eps)
  RRT_DISPATCH(ts, TS, RRT_DISPATCH(tm, TM, RRT_BY_ROW4(C, RRT_K9)));
#undef RRT_K9
  if (err == cudaSuccess && pl.parts > 1)
    err = launch_reduce_rows(part_reps, pl.parts, nrep, dreps, s);
  const int F = bf > 0 ? B / bf : 1;
  if (err == cudaSuccess)
    err = launch_reduce_rows(part_ln, pl.parts * (pl.R / F), 2LL * C, dln, s, F);
  return (int)err;
}

// K11: g (B, G*G, C) in the stream dtype -> dw (B, nR, k, P), dreps (B, nR,
// k, C); part (parts, R, k, C) floats when a region is more than one chunk
// (else unused, may be null)
extern "C" int cb_redistribute_grid_bwd(int ts, int tm, const void* g, const void* mask,
                                        const void* w, const void* reps, void* dw,
                                        void* dreps, void* part, int B, int G, int rs, int C,
                                        int k, int chunk, void* stream) {
  const RgridPlan pl = rgrid_plan(B, G, rs, C, k, chunk);
  if (!pl.ok || (pl.parts > 1 && part == nullptr)) return (int)cudaErrorInvalidValue;
  float* part_reps = pl.parts > 1 ? (float*)part : (float*)dreps;
  const int warps = rgrid_warps(C, k);
  const size_t smem = rgrid_smem_bytes(C, k, warps, false);
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
#define RRT_K11(NC)                                                                           \
  err = launch_redistribute_bwd<TS, TS, TM, NC, false>(pl.grid, warps, smem, s, nullptr, mask, \
                                                       w, reps, nullptr, nullptr, g, nullptr, \
                                                       dw, part_reps, nullptr, pl.map, C, k,  \
                                                       chunk, 0.f)
  RRT_DISPATCH(ts, TS, RRT_DISPATCH(tm, TM, RRT_BY_ROW4(C, RRT_K11)));
#undef RRT_K11
  if (err == cudaSuccess && pl.parts > 1)
    err = launch_reduce_rows(part_reps, pl.parts, (long long)pl.R * k * C, dreps, s);
  return (int)err;
}
