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
//
// K12 replaces crmsa_kernels.py::_compress_pallas (kernel body
// _compress_kernel): K3's math on regions that are already partitioned,
// (R, P, C) in the stream dtype, with no LayerNorm and no mask: z = round(x).
// Bound: bytes (a survival bag of 45000 patches: R = 64, P = 729, C = 512
// f32, ~96 MB read, ~0.029 ms).
//
// Design of both (the same two kernels; crmsa.cuh has the shared pieces and
// the layout): combine is rounded to TM only once it is normalised by the
// region's max and sum over all P, so no block can form a region's reps
// before every logit of the region exists, and the region is read twice.
// Pass 1 (compress_rows_kernel) gives each token row to a warp, 16-byte
// loads, and writes the row's k logits and LayerNorm statistics; pass 2
// (compress_reps_kernel) reduces the region's logits (max, min, sum: a few
// KB, in a fixed order in every block), forms combine and w a thread a row,
// then streams the rows, a thread a 16-byte channel group, adding combine z
// into registers.  Each region's rows are split over blocks
// (crmsa_kernels.row_split) so that B = 1 (64 regions) and the 64-region
// survival bag put two blocks on every SM; the blocks' partials are added in
// a fixed order by launch_reduce_rows.  At B = 1 the re-read comes from L2
// (19 MB of stream); at B = 8 (151 MB) from device memory, so K3 moves the
// stream twice there.
//
// K8 replaces crmsa_kernels.py::_rgrid_ln_pallas (kernel body
// _rgrid_ln_kernel): per token, round(w)^T round(reps) from its region,
// times the mask, + x (the layer residual), + the encoder's global
// shortcut, then the encoder-final LayerNorm and mask, written as fp32.
// Bound on an H100: bytes (~57 MB a c16_r50 slide, f32 stream).  Design:
// K9's row layout (crmsa.cuh): one block per (region, chunk of token rows),
// a warp a row, a lane four consecutive channels a group (16-byte loads of
// x and the shortcut, 8-byte for a bf16 stream; 16-byte stores of the
// output), every load of a row issued before any is used, so x, the
// shortcut and the output each cross device memory once.  round(reps),
// round(w) of the block's rows and the LayerNorm's scale and bias are
// staged in shared memory once a block.  The stream value and its
// statistics come from stream_ln, which K9 calls too.  K8 sums nothing
// across rows, so the chunk is chosen for the card alone
// (crmsa_kernels.k8_split: row_split's chunk, at most K8_ROWS rows).
//
// K10 replaces crmsa_kernels.py::_redistribute_grid_pallas (kernel body
// _redistribute_grid_kernel): out = x + mask * reverse(round(w)^T
// round(reps)) in x's dtype (without x when add_residual is False).  K13
// replaces crmsa_kernels.py::_redistribute_pallas (kernel body
// _redistribute_kernel): out_r = round(w_r)^T round(reps_r) on contiguous
// (R, P, C) regions, fp32.  Bound for both: bytes (K10 at c16_r50 + FFN,
// L = 9000, B = 8: ~302 MB, ~0.090 ms; K13 at the 45000-patch survival bag:
// ~96 MB written, ~0.029 ms).  Design: each token row is a rank-k update
// (k <= 16), so the work tiles freely: one block per (region, 32 token rows),
// the region's k reps rows rounded once into shared memory, one warp per
// token row writing four channels per lane per step; x, the mask and the
// output cross device memory once, and a B = 1 survival bag still gives
// 64 x 23 blocks to the 132 SMs.
#include "crmsa.cuh"

using namespace rrt;

// Pass 2 of K3 and K12 (pass 1: compress_rows_kernel, crmsa.cuh).  The
// region's max, min and softmax sums from its logits; a thread a row of the
// chunk for its combine (rounded to TM once normalised by the region's
// sums), w, LayerNorm statistics and mask; then thread (slot, group) adds
// combine z of its channel group over rows p0 + slot, p0 + slot + slots,
// ... (UNR of them in flight) into registers, and the slots' sums, added in
// slot order, go to reps_part[part, region] (reps itself with one part).
// KB >= k bounds the accumulators.
template <typename TS, typename TM, int KB>
__global__ void __launch_bounds__(CR_THREADS)
compress_reps_kernel(const TS* __restrict__ x, const uint8_t* __restrict__ mask,
                     const float* __restrict__ ls, const float* __restrict__ lb,
                     const float* __restrict__ logits, const float* __restrict__ stats,
                     float* __restrict__ reps_part, float* __restrict__ w, TokenMap map, int C,
                     int k, int chunk, int slots, int vec) {
  constexpr int VW = vec_width<TS>(), UNR = 16 / VW;
  extern __shared__ __align__(16) float sm[];
  __shared__ float lmax[KMAX], lmin[KMAX], lsum[KMAX];
  const int Cp = padded_channels<TS>(C), ng = Cp / VW, P = map.P;
  const int region = blockIdx.x, R = gridDim.x, part = blockIdx.y;
  const int p0 = part * chunk, np = min(P, p0 + chunk) - p0;
  const int tid = threadIdx.x, slot = tid / ng, c0 = (tid - slot * ng) * VW;
  ls = fold_ptr(ls, (long long)fold_of(map, region) * C);
  lb = fold_ptr(lb, (long long)fold_of(map, region) * C);
  float* lg = sm;                   // [k][P] the region's logits
  float* cm = lg + k * P;           // [k][chunk] round(combine) of the chunk's rows
  float* rmu = cm + k * chunk;      // [chunk] mean, then 1/std, then mask
  float* rrs = rmu + chunk;
  float* rmk = rrs + chunk;
  const long long base = region_base(map, region);

  for (int i = tid; i < k * P; i += blockDim.x) lg[i] = logits[(long long)region * k * P + i];
  __syncthreads();
  region_stats(lg, P, k, lmax, lmin, lsum);
  __syncthreads();
  for (int i = tid; i < np; i += blockDim.x) {
    const int p = p0 + i;
    float dmax, dsum;
    token_softmax(lg, P, k, p, dmax, dsum);
    for (int j = 0; j < k; ++j) {
      const float l = lg[j * P + p];
      cm[j * chunk + i] = round_to<TM>(expf(l - lmax[j]) / lsum[j]);
      w[((long long)region * k + j) * P + p] =
          (l - lmin[j]) / (lmax[j] - lmin[j] + 1e-8f) * (expf(l - dmax) / dsum);
    }
    const long long t = row_token(map, base, p), rp = (long long)region * P + p;
    rmk[i] = mask ? (mask[t] ? 1.f : 0.f) : 1.f;
    rmu[i] = ls ? stats[2 * rp] : 0.f;
    rrs[i] = ls ? stats[2 * rp + 1] : 1.f;
  }
  __syncthreads();

  float acc[KB][VW];
#pragma unroll
  for (int j = 0; j < KB; ++j)
#pragma unroll
    for (int e = 0; e < VW; ++e) acc[j][e] = 0.f;
  if (slot < slots) {
    float s[VW], b[VW];
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      s[e] = ls && c0 + e < C ? ls[c0 + e] : 0.f;
      b[e] = ls && c0 + e < C ? lb[c0 + e] : 0.f;
    }
    for (int i0 = slot; i0 < np; i0 += UNR * slots) {
      float v[UNR][VW];
#pragma unroll
      for (int q = 0; q < UNR; ++q) {
        const int i = i0 + q * slots;
        if (i < np) {
          load_group<TS>(x + row_token(map, base, p0 + i) * C, c0, C, vec, v[q]);
        } else {
#pragma unroll
          for (int e = 0; e < VW; ++e) v[q][e] = 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < UNR; ++q) {
        const int i = i0 + q * slots;
        if (i < np) {
          const float mu = rmu[i], rstd = rrs[i], m = rmk[i];
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            const float z = round_to<TM>(ls ? ln_apply(v[q][e], mu, rstd, s[e], b[e], m)
                                            : v[q][e]);
#pragma unroll
            for (int j = 0; j < KB; ++j)
              if (j < k) acc[j][e] = fmaf(cm[j * chunk + i], z, acc[j][e]);
          }
        }
      }
    }
  }
  __syncthreads();

  // the slots' sums in slot order (the staging arrays are dead: reuse them)
  float* red = sm;  // [slots][k][Cp]
  if (slot < slots) {
#pragma unroll
    for (int j = 0; j < KB; ++j)
      if (j < k)
#pragma unroll
        for (int e = 0; e < VW; ++e) red[((long long)slot * k + j) * Cp + c0 + e] = acc[j][e];
  }
  __syncthreads();
  float* out = reps_part + ((long long)part * R + region) * k * C;
  for (int e = tid; e < k * C; e += blockDim.x) {
    const int j = e / C, c = e - j * C;
    float t = 0.f;
    for (int u = 0; u < slots; ++u) t += red[((long long)u * k + j) * Cp + c];
    out[e] = t;
  }
}

// K8: one block per (region, chunk of `chunk` token rows), a warp a row at
// a time (rows p0 + warp, p0 + warp + W, ...), no barrier between rows.  The
// region's round(reps), the block's round(w) and the LayerNorm's scale and
// bias are staged in shared memory once a block; a row's mask, x and
// shortcut loads are all issued before any is used; stream_ln forms the
// stream value and its statistics (as K9 recomputes them), and the masked
// LayerNorm goes out as fp32 with 16-byte stores.
template <typename TS, typename TM, int NC, int KW>
__global__ void __launch_bounds__(CR_THREADS, NC <= 16 ? 2 : 1)
redistribute_ln_kernel(const TS* __restrict__ x, const uint8_t* __restrict__ mask,
                       const float* __restrict__ w, const float* __restrict__ reps,
                       const float* __restrict__ ls, const float* __restrict__ lb,
                       const TS* __restrict__ sc, float* __restrict__ out, TokenMap map, int C,
                       int k, int chunk, float eps) {
  constexpr int NQ = NC / 4;
  extern __shared__ __align__(16) float sm[];
  float* lss = sm;             // [C] the LayerNorm scale, then [C] its bias
  float* lbs = lss + C;
  float* repm = lbs + C;       // [k][C] round(reps_r)
  float* ws = repm + k * C;    // [k][chunk] round(w_r) of the block's rows
  const int P = map.P, region = blockIdx.x, p0 = blockIdx.y * chunk;
  const int np = min(P, p0 + chunk) - p0, nq = C / 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, W = blockDim.x >> 5;
  const long long base = region_base(map, region);
  const long long lo = (long long)fold_of(map, region) * C;  // the fold's LayerNorm

  for (int i = tid; i < C; i += blockDim.x) {
    lss[i] = ls[lo + i];
    lbs[i] = lb[lo + i];
  }
  for (int i = tid; i < k * C; i += blockDim.x)
    repm[i] = round_to<TM>(reps[(long long)region * k * C + i]);
  for (int i = tid; i < k * np; i += blockDim.x) {
    const int j = i / np, r = i - j * np;
    ws[j * chunk + r] = round_to<TM>(w[((long long)region * k + j) * P + p0 + r]);
  }
  __syncthreads();

  for (int i = warp; i < np; i += W) {
    const long long t = row_token(map, base, p0 + i);
    const float m = mask[t] ? 1.f : 0.f;
    float v[NC], s[NC];
    load_row4<TS, NC>(x + t * C, lane, nq, v);
    if (sc) {
      load_row4<TS, NC>(sc + t * C, lane, nq, s);
    } else {
#pragma unroll
      for (int n = 0; n < NC; ++n) s[n] = 0.f;
    }
    float wr[KW];
#pragma unroll
    for (int j = 0; j < KW; ++j) wr[j] = j < k ? ws[j * chunk + i] : 0.f;
    float mu, rstd;
    stream_ln<NC, KW>(v, s, m, wr, repm, k, C, lane, eps, mu, rstd);
#pragma unroll
    for (int g = 0; g < NQ; ++g) {
      const int q = lane + 32 * g;
      if (q < nq) {
        const float4 a = *reinterpret_cast<const float4*>(lss + 4 * q);
        const float4 b = *reinterpret_cast<const float4*>(lbs + 4 * q);
        store4(out + t * C + 4 * q,
               make_float4(ln_apply(v[4 * g], mu, rstd, a.x, b.x, m),
                           ln_apply(v[4 * g + 1], mu, rstd, a.y, b.y, m),
                           ln_apply(v[4 * g + 2], mu, rstd, a.z, b.z, m),
                           ln_apply(v[4 * g + 3], mu, rstd, a.w, b.w, m)));
      }
    }
  }
}

// K10 / K13: out[t] = (x[t] +) mask[t] * sum_j round(w[r, j, p]) round(reps[r, j]),
// t the token of row p of region r under `map`.  x == nullptr: no residual;
// mask == nullptr: no mask.  One block per (region, RT rows), one warp per
// row, four channels per lane per step (C % 4 == 0).
constexpr int RT = 32;

template <typename TS, typename TM, int KW>
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
    float wj[KW];
#pragma unroll
    for (int j = 0; j < KW; ++j) wj[j] = j < k ? ws[j * RT + row] : 0.f;
    for (int c = 4 * lane; c < C; c += 128) {
      float y[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < KW; ++j) {
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
        const float4 xv = load4(x + t * C + c);
        y[0] = xv.x + y[0];
        y[1] = xv.y + y[1];
        y[2] = xv.z + y[2];
        y[3] = xv.w + y[3];
      }
      store4(out + t * C + c, make_float4(y[0], y[1], y[2], y[3]));
    }
  }
}

// K10 / K13's launch, its k x C staging of round(reps) opted in past 48 KB
template <typename TS, typename TM, int KW>
cudaError_t launch_redistribute(dim3 grid, size_t smem, cudaStream_t s, const void* x,
                                const void* mask, const void* w, const void* reps, void* out,
                                TokenMap map, int C, int k) {
  cudaError_t err = cr_smem(redistribute_kernel<TS, TM, KW>, smem);
  if (err != cudaSuccess) return err;
  redistribute_kernel<TS, TM, KW><<<grid, 256, smem, s>>>(
      (const TS*)x, (const uint8_t*)mask, (const float*)w, (const float*)reps, (TS*)out, map, C,
      k);
  return cudaGetLastError();
}

template <typename TS, typename TM, int KB>
cudaError_t launch_compress_reps(dim3 grid, StreamShape sh, size_t smem, cudaStream_t s,
                                 const void* x, const void* mask, const float* ls,
                                 const float* lb, const float* logits, const float* stats,
                                 float* reps_part, float* w, TokenMap map, int C, int k,
                                 int chunk, int vec) {
  cudaError_t err = cr_smem(compress_reps_kernel<TS, TM, KB>, smem);
  if (err != cudaSuccess) return err;
  compress_reps_kernel<TS, TM, KB><<<grid, sh.threads, smem, s>>>(
      (const TS*)x, (const uint8_t*)mask, ls, lb, logits, stats, reps_part, w, map, C, k, chunk,
      sh.slots, vec);
  return cudaGetLastError();
}

// K3 (ls given: LayerNorm and mask on the grid map) and K12 (contiguous
// regions, z = round(x)): the two passes over R regions of P rows split into
// chunks of `chunk`, then, with more than one chunk a region, the partials
// part (parts, R, k, C) summed over the chunks in order into reps.  scratch:
// the rows' logits (R, k, P) and LayerNorm statistics (R, P, 2).
template <typename TS, typename TM>
int compress(const void* x, const void* mask, const float* ls, const float* lb,
             const float* phi, float* reps, float* w, float* scratch, float* part, int R,
             TokenMap map, int C, int k, int chunk, float eps, cudaStream_t s) {
  const int P = map.P, parts = (P + chunk - 1) / chunk;
  if (parts > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  const int Cp = padded_channels<TS>(C), vec = use_vec<TS>(x, C);
  const StreamShape sh = stream_shape<TS>(C);
  const size_t smem = (size_t)std::max(k * P + (k + 3) * chunk, sh.slots * k * Cp) * 4;
  const dim3 grid(R, parts);
  float* logits = scratch;
  float* stats = scratch + (long long)R * k * P;
  float* reps_part = parts > 1 ? part : reps;
  cudaError_t err = launch_compress_rows<TS, TM, false>(
      grid, s, x, mask, ls, lb, phi, nullptr, logits, stats, nullptr, nullptr, nullptr, map, C,
      k, chunk, vec, eps);
  if (err != cudaSuccess) return (int)err;
#define RRT_REPS(KB)                                                                          \
  err = launch_compress_reps<TS, TM, KB>(grid, sh, smem, s, x, mask, ls, lb, logits, stats,   \
                                         reps_part, w, map, C, k, chunk, vec)
  switch (k_bound(k)) {
    case 1: RRT_REPS(1); break;
    case 4: RRT_REPS(4); break;
    case 8: RRT_REPS(8); break;
    default: RRT_REPS(16); break;
  }
#undef RRT_REPS
  if (err == cudaSuccess && parts > 1)
    err = launch_reduce_rows(part, parts, (long long)R * k * C, reps, s);
  return (int)err;
}

// K3: x (B, G*G, C) -> reps (B, nR, k, C), w (B, nR, k, P); scratch
// (R (k + 2) P floats) and part (parts, R, k, C) when P > chunk.  bf > 0:
// folds of bf bags, bag b taking fold b / bf's ls, lb (F, C), phi (F, C, k)
extern "C" int cr_compress_grid(int ts, int tm, const void* x, const void* mask,
                                const void* ls, const void* lb, const void* phi,
                                void* reps, void* w, void* scratch, void* part, int B, int G,
                                int rs, int C, int k, int chunk, float eps, int bf,
                                void* stream) {
  if (C < 1 || C > 32 * CPL || k < 1 || k > KMAX || rs < 1 || G % rs != 0 || chunk < 1 ||
      bf < 0 || (bf > 0 && B % bf != 0))
    return (int)cudaErrorInvalidValue;
  const int nrs = G / rs;
  const TokenMap map{G, rs, nrs, rs * rs, bf * nrs * nrs};
  RRT_DISPATCH(ts, TS, RRT_DISPATCH(tm, TM,
      return compress<TS, TM>(x, mask, (const float*)ls, (const float*)lb, (const float*)phi,
                              (float*)reps, (float*)w, (float*)scratch, (float*)part,
                              B * nrs * nrs, map, C, k, chunk, eps, (cudaStream_t)stream)));
  return (int)cudaErrorInvalidValue;
}

// K12: x (R, P, C) -> reps (R, k, C), w (R, k, P); scratch (R k P floats)
// and part as K3's.  rf > 0: folds of rf regions, each with its phi (F, C, k)
extern "C" int cr_compress(int ts, int tm, const void* x, const void* phi, void* reps,
                           void* w, void* scratch, void* part, int R, int P, int C, int k,
                           int chunk, int rf, void* stream) {
  if (C < 1 || C > 32 * CPL || k < 1 || k > KMAX || R < 1 || P < 1 || chunk < 1 || rf < 0 ||
      (rf > 0 && R % rf != 0))
    return (int)cudaErrorInvalidValue;
  const TokenMap map{0, 1, 1, P, rf};
  RRT_DISPATCH(ts, TS, RRT_DISPATCH(tm, TM,
      return compress<TS, TM>(x, nullptr, nullptr, nullptr, (const float*)phi, (float*)reps,
                              (float*)w, (float*)scratch, (float*)part, R, map, C, k, chunk,
                              0.f, (cudaStream_t)stream)));
  return (int)cudaErrorInvalidValue;
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
  cudaError_t err = cudaErrorInvalidValue;
  RRT_DISPATCH(ts, TS, RRT_DISPATCH(tm, TM,
      err = k_width(k) == 8
                ? launch_redistribute<TS, TM, 8>(grid, smem, (cudaStream_t)stream, x, mask, w,
                                                 reps, out, map, C, k)
                : launch_redistribute<TS, TM, 16>(grid, smem, (cudaStream_t)stream, x, mask, w,
                                                  reps, out, map, C, k)));
  return (int)err;
}

template <typename TS, typename TM, int NC, int KW>
cudaError_t launch_redistribute_ln_kw(dim3 grid, size_t smem, cudaStream_t s, const void* x,
                                      const void* mask, const float* w, const float* reps,
                                      const float* ls, const float* lb, const void* sc,
                                      float* out, TokenMap map, int C, int k, int chunk,
                                      float eps) {
  cudaError_t err = cr_smem(redistribute_ln_kernel<TS, TM, NC, KW>, smem);
  if (err != cudaSuccess) return err;
  redistribute_ln_kernel<TS, TM, NC, KW><<<grid, CR_THREADS, smem, s>>>(
      (const TS*)x, (const uint8_t*)mask, w, reps, ls, lb, (const TS*)sc, out, map, C, k, chunk,
      eps);
  return cudaGetLastError();
}

template <typename TS, typename TM, int NC>
cudaError_t launch_redistribute_ln(dim3 grid, size_t smem, cudaStream_t s, const void* x,
                                   const void* mask, const float* w, const float* reps,
                                   const float* ls, const float* lb, const void* sc, float* out,
                                   TokenMap map, int C, int k, int chunk, float eps) {
  return k_width(k) == 8
             ? launch_redistribute_ln_kw<TS, TM, NC, 8>(grid, smem, s, x, mask, w, reps, ls, lb,
                                                        sc, out, map, C, k, chunk, eps)
             : launch_redistribute_ln_kw<TS, TM, NC, 16>(grid, smem, s, x, mask, w, reps, ls,
                                                         lb, sc, out, map, C, k, chunk, eps);
}

// K8: x (B, G*G, C) (+ shortcut, or null) -> out (B, G*G, C) fp32, one block
// per (region, chunk of `chunk` token rows).  bf > 0: folds of bf bags, bag
// b taking fold b / bf's final LayerNorm ls, lb (F, C)
extern "C" int cr_redistribute_ln(int ts, int tm, const void* x, const void* mask,
                                  const void* w, const void* reps, const void* ls,
                                  const void* lb, const void* sc, void* out, int B, int G,
                                  int rs, int C, int k, int chunk, float eps, int bf,
                                  void* stream) {
  if (C < 4 || C % 4 != 0 || C > 32 * CPL || k < 1 || k > KMAX || rs < 1 || G % rs != 0 ||
      chunk < 1 || bf < 0 || (bf > 0 && B % bf != 0))
    return (int)cudaErrorInvalidValue;
  const int nrs = G / rs, P = rs * rs;
  const TokenMap map{G, rs, nrs, P, bf * nrs * nrs};
  const dim3 grid(B * nrs * nrs, (P + chunk - 1) / chunk);
  const size_t smem = (size_t)(2 * C + k * C + k * chunk) * 4;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
#define RRT_K8(NC)                                                                         \
  err = launch_redistribute_ln<TS, TM, NC>(grid, smem, s, x, mask, (const float*)w,         \
                                           (const float*)reps, (const float*)ls,            \
                                           (const float*)lb, sc, (float*)out, map, C, k,    \
                                           chunk, eps)
  RRT_DISPATCH(ts, TS, RRT_DISPATCH(tm, TM, RRT_BY_ROW4(C, RRT_K8)));
#undef RRT_K8
  return (int)err;
}
