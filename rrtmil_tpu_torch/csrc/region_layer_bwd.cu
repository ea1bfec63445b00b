// K7: the attention core's backward, and K2: the whole R-MSA TransLayer's
// backward built on it.
//
// K7 replaces rrtmil_tpu/ops/pallas/region_attn_bwd.py::
// region_attention_bwd_pallas (kernel body _bwd_kernel).  Per (region,
// head), with y = round(M_h round(q s)) (or round(q s) without EPEG):
//   Lc = y k^T (+ pb),  A = softmax(Lc),  out = A v;   given g = d(out):
//   dv = round(A)^T g,  dA = g v^T,  dLc = A * (dA - rowsum(dA * A)),
//   dY = round(dLc) k,  dq = s M^T round(dY) (or s dY),  dk = round(dLc)^T y,
//   dw[t] = sum_{r,i,j} round(dLc)[i,j] round(q k^T)[i+t-k//2, j],
//   db = sum dLc.
// q, k, v and g are read where they lie (Opnd: region, head and token-row
// strides, K2's grid token map), and dq, dk, dv written the same way.
//
// What bounds it on an H100: inside K2 (c16_r50, P = 144, EPEG k = 15,
// 4096 (region, head) pairs at B = 8) its ~6 GFLOP a slide of 64 x 64 x 64
// products; at K5's backward on c16_r50 and at brca_r50's one 512-wide head
// (P = 64: one key and one query tile per pair) launch latency and the
// latency of each block's few tiles.
//
// Design, bf16 products (the tensor cores: mma.sync m16n8k16, fragments by
// ldmatrix, tc.cuh's warp products; 4 warps of 16 rows per block; 64 x 64
// tiles in pairs through a 3-stage cp.async ring):
//  (1) query side, a block per (region, head, 64 queries, one 64-wide
//      chunk of dq, or two when hd / 64 is even): y and round(g) sit in
//      shared memory for the whole head width.  Pass 1 walks the key tiles for the forward's online max and
//      sum of Lc = y k^T (its exact expressions and product order, so A has
//      the forward's bits) and u = sum exp(Lc - m) dA with dA = g v^T, so
//      D = rowsum(dA * A) = u / l in fp32; pass 2 recomputes Lc and dA,
//      forms dLc, rounds it into A fragments in registers and accumulates
//      dY = round(dLc) k of its chunks.  With a single key tile (P <= 64)
//      pass 1 is dropped: the logits stay in registers.  With EPEG the
//      halo rows' round(round(q s) k^T) go through the tensor cores and the
//      k tap sums sum_ij round(dLc)[i,j] L[i+t,j] through the CUDA cores,
//      as per-block partials.  It also writes y (the key side's operand),
//      the row statistics (m, l, D) and dY (EPEG) or dq.
//  (2) key side, a block per (region, head, 64 keys, chunk oc of dk and
//      dv): k and v sit in shared memory for the whole head width; each
//      query tile's y and g stream through the ring, Lc^T = k y^T and
//      dA^T = v g^T (the same sums as the query side's, transposed), then
//      A^T and dLc^T from the saved statistics, rounded into fragments for
//      dv += round(A)^T g and dk += round(dLc)^T y.
//  (3) with EPEG, dq = s M^T round(dY) as the transposed k-tap pass; (4) the
//      tap and bias partials summed over the blocks in a fixed order.  No
//      atomics: every run gives the same bits.
// At hd > 64 each block owns one or two 64-wide chunks of the outputs and
// forms the logits over the whole width (a 16 x 512 fp32 accumulator per
// warp would need 256 registers a thread); two on the query side halve its
// blocks, which at brca_r50's hd = 512, B = 8 (192 blocks of ~188 KB of
// shared memory, one an SM) makes one wave of two (measured, PERF.md).
// f32 products (strict parity; TF32 would break it) keep the SIMT kernels
// below the tensor-core ones, on the same operand descriptions, with a
// three-pass query side.
// Head widths: multiples of 32 up to 512, EPEG up to 128.  A width that is
// not a multiple of 64 is held as head_chunks(hd) 64-wide chunks, the
// columns past hd zero-filled by every load and never stored (zero columns
// add exact zeros to every sum), so hd = 64 keeps its code and its bits.
// With EPEG at hd = 128 the query side holds the halo rows for the whole
// head width, and the tap sums' halo logits round(q s) k^T, which need the
// whole key tile, read a copy of it loaded beside the ring (the SIMT kernel
// sums them chunk by chunk); dY goes to scratch at the head's width.
//
// K2 replaces rrtmil_tpu/ops/pallas/region_layer.py::_layer_bwd_pallas
// (kernel body _layer_bwd_kernel): dx, d(LN scale, bias), dWq/dWk/dWv,
// dbq/dbk/dbv, the EPEG tap and bias grads, dWp and dbp of the R-MSA layer.
// What bounds it: the products, ~63 GFLOP a c16_r50 slide (qkv recompute,
// projection backward, qkv backward) against ~57 MB of x, g and dx.
// Design: a pipeline, like K1's forward.  The recompute runs K1's own
// entries (rl_ln_mask, rl_gemm, rl_attention in region_layer.cu); then
// rb_colsum forms round(g * mask) and the dbp partials; four products, the
// weight gradients o^T gm and z^T round(dqkv) (A^T B, split along the token
// axis into partials that rb_reduce sums in order) and the data gradients
// gm Wp^T and round(dqkv) Wqkv^T (A B^T); rb_attention_bwd the core above
// on the token map; rb_colsum again for dbqkv (the sum of the unrounded
// dqkv) and, with bf16 products, round(dqkv) into a bf16 copy, the TPU
// kernel's rounding point, which both dqkv products read; rb_ln_bwd the
// LayerNorm backward, one warp per token row, with the mask, the
// residual's g and per-warp dls/dlb partials.  With bf16 products the four
// products run on the warpgroup tensor cores (rb_gemm_tc, wgmma.cuh: TMA
// ring, operands read where they lie); with f32 products (strict parity)
// on the CUDA cores in fp32 (rb_gemm, common.cuh's SIMT product).
#include "wgmma.cuh"

using namespace rrt;

namespace {

// ---------------------------------------------------------------------------
// f32 products: the SIMT kernels (256 threads, 4 x 4 outputs a thread)
// ---------------------------------------------------------------------------
constexpr int BQ = 64, BK = 64, HD = 64;
constexpr int QS = HD + 4, PS = BK + 4;

// k (and v) of keys k0 .. k0 + 63 of region r (kp, vp: the head's chunk):
// Kt/Vt transposed [d][j], Ks row-major [j][d]; keys past P are zeros.
template <typename TI>
__device__ __forceinline__ void load_keys(const TI* kp, const Opnd& k, const TI* vp,
                                          const Opnd& v, const TokenMap& tm, int r, int k0,
                                          float* Kt, float* Ks, float* Vt, int cw) {
  for (int idx = threadIdx.x; idx < BK * HD; idx += blockDim.x) {
    const int j = idx / HD, d = idx % HD, p = k0 + j;
    float kv = 0.f, vv = 0.f;
    if (p < tm.P && d < cw) {
      kv = to_f(kp[row_of(tm, k, r, p) + d]);
      if (Vt) vv = to_f(vp[row_of(tm, v, r, p) + d]);
    }
    Kt[d * BK + j] = kv;
    if (Ks) Ks[j * HD + d] = kv;
    if (Vt) Vt[d * BK + j] = vv;
  }
}

// Ys = the query tile as the forward's core forms it: M_h (q s) with the
// k-tap pass (Hs holds the halo rows q0 - k//2 .. q0 + 63 + k - 1 - k//2 of
// q s), or q s itself; Gs = the incoming gradient's rows (qp, gp: the
// head's chunk, of which the first cw columns exist; the rest load as zeros)
template <typename TI>
__device__ __forceinline__ void load_queries(const TI* qp, const Opnd& q, const TI* gp,
                                             const Opnd& g, const TokenMap& tm, int r,
                                             int q0, float scale, const float* coef, int kk,
                                             float* Hs, float* Ys, float* Gs, int cw) {
  const int P = tm.P, tid = threadIdx.x;
  if (kk > 0) {
    const int pad = kk / 2, nh = BQ + kk - 1;
    for (int idx = tid; idx < nh * HD; idx += blockDim.x) {
      const int row = idx / HD, d = idx % HD, p = q0 - pad + row;
      Hs[idx] = (p >= 0 && p < P && d < cw) ? to_f(qp[row_of(tm, q, r, p) + d]) * scale : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < BQ * HD; idx += blockDim.x) {
      const int i = idx / HD, d = idx % HD;
      float acc = 0.f;
      for (int t = 0; t < kk; ++t) acc = fmaf(coef[t], Hs[(i + t) * HD + d], acc);
      Ys[i * QS + d] = acc;
    }
  } else {
    for (int idx = tid; idx < BQ * HD; idx += blockDim.x) {
      const int i = idx / HD, d = idx % HD, p = q0 + i;
      Ys[i * QS + d] = p < P && d < cw ? to_f(qp[row_of(tm, q, r, p) + d]) * scale : 0.f;
    }
  }
  for (int idx = tid; idx < BQ * HD; idx += blockDim.x) {
    const int i = idx / HD, d = idx % HD, p = q0 + i;
    Gs[i * QS + d] = p < P && d < cw ? to_f(gp[row_of(tm, g, r, p) + d]) : 0.f;
  }
}

// s[i][j] += Ys[ty*4+i] . K[tx*4+j] over one 64-wide chunk, the forward
// core's loop and order
__device__ __forceinline__ void tile_logits(const float* Ys, const float* Kt, int tx,
                                            int ty, float (&s)[4][4]) {
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    const float4 b = *reinterpret_cast<const float4*>(&Kt[d * BK + tx * 4]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = Ys[(ty * 4 + i) * QS + d];
      s[i][0] = fmaf(a, b.x, s[i][0]);
      s[i][1] = fmaf(a, b.y, s[i][1]);
      s[i][2] = fmaf(a, b.z, s[i][2]);
      s[i][3] = fmaf(a, b.w, s[i][3]);
    }
  }
}

// da[i][j] += G[ty*4+i] . V[tx*4+j] over one 64-wide chunk
__device__ __forceinline__ void tile_da(const float* Gs, const float* Vt, int tx, int ty,
                                        float (&da)[4][4]) {
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    const float4 b = *reinterpret_cast<const float4*>(&Vt[d * BK + tx * 4]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = Gs[(ty * 4 + i) * QS + d];
      da[i][0] = fmaf(a, b.x, da[i][0]);
      da[i][1] = fmaf(a, b.y, da[i][1]);
      da[i][2] = fmaf(a, b.z, da[i][2]);
      da[i][3] = fmaf(a, b.w, da[i][3]);
    }
  }
}

__device__ __forceinline__ void zero44(float (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
}

template <typename TM>
__device__ __forceinline__ void epeg_coef(const float* __restrict__ pw, int h, int kk,
                                          float* coef) {
  const int pad = kk / 2;
  for (int t = threadIdx.x; t < kk; t += blockDim.x)
    coef[t] = round_to<TM>(pw[h * kk + t] + (t == pad ? 1.f : 0.f));
}

size_t q_smem_bytes(int kk) {
  const int nh = kk > 0 ? BQ + kk - 1 : 0;
  return (size_t)(2 * BQ * QS + 3 * HD * BK + BQ * PS + nh * HD + nh * PS) * 4;
}
size_t kv_smem_bytes(int kk) {
  const int nh = kk > 0 ? BQ + kk - 1 : 0;
  return (size_t)(2 * HD * BK + 2 * BQ * QS + 2 * BQ * PS + nh * HD) * 4;
}

// (1) query side: row statistics, dY (or dq), the EPEG tap and bias partials
template <typename TI, typename TO>
__global__ void __launch_bounds__(256)
attn_bwd_q_kernel(Opnd q, Opnd k, Opnd v, Opnd g, Opnd dq, int H, int hd, TokenMap tm,
                  const float* __restrict__ pw, int kk, const float* __restrict__ pb,
                  float scale, float* __restrict__ stats, float* __restrict__ dy,
                  float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  const int nh = kk > 0 ? BQ + kk - 1 : 0;
  float* Ys = smem;               // [BQ][QS]
  float* Gs = Ys + BQ * QS;       // [BQ][QS]
  float* Kt = Gs + BQ * QS;       // [HD][BK]
  float* Ks = Kt + HD * BK;       // [BK][HD]
  float* Vt = Ks + BK * HD;       // [HD][BK]
  float* Ps = Vt + HD * BK;       // [BQ][PS]  dLc
  float* Hs = Ps + BQ * PS;       // [nh][HD]  q s halo
  float* Ls = Hs + nh * HD;       // [nh][PS]  q k^T of the halo rows
  __shared__ float coef[MAX_KK];
  __shared__ float dwacc[MAX_KK];
  __shared__ float red[BQ];

  const int P = tm.P;
  const int r = blockIdx.x / H, h = blockIdx.x % H, hw = fold_of(tm, r) * H + h;
  const int qt = blockIdx.y, q0 = qt * BQ;
  const int oc = blockIdx.z, nch = head_chunks(hd);   // this block's 64 columns of dq
  const int ow = min(HD, hd - oc * HD);                // of which exist
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const TI* qp = (const TI*)q.p + (long long)h * q.sh;
  const TI* kp = (const TI*)k.p + (long long)h * k.sh;
  const TI* vp = (const TI*)v.p + (long long)h * v.sh;
  const TI* gp = (const TI*)g.p + (long long)h * g.sh;

  if (kk > 0) {
    epeg_coef<float>(pw, hw, kk, coef);
    for (int t = tid; t < kk; t += blockDim.x) dwacc[t] = 0.f;
  }
  __syncthreads();
  if (nch == 1) load_queries<TI>(qp, q, gp, g, tm, r, q0, scale, coef, kk, Hs, Ys, Gs, hd);

  // s = y k^T (and da = g v^T) of key tile k0 over the whole head width,
  // chunk by chunk (the queries are reloaded per chunk when hd > 64); Ks
  // receives this block's chunk of k; with the EPEG tap sums (with_ks),
  // Ls = the halo rows' (q s) k^T, summed over the chunks in column order
  auto logits = [&](int k0, float (&s)[4][4], float (*da)[4][4], bool with_ks) {
    zero44(s);
    if (da) zero44(*da);
    for (int c = 0; c < nch; ++c) {
      const int cw = min(HD, hd - c * HD);
      __syncthreads();
      if (nch > 1)
        load_queries<TI>(qp + c * HD, q, gp + c * HD, g, tm, r, q0, scale, coef, kk, Hs, Ys,
                         Gs, cw);
      load_keys<TI>(kp + c * HD, k, vp + c * HD, v, tm, r, k0, Kt,
                    with_ks && c == oc ? Ks : nullptr, da ? Vt : nullptr, cw);
      __syncthreads();
      tile_logits(Ys, Kt, tx, ty, s);
      if (da) tile_da(Gs, Vt, tx, ty, *da);
      if (with_ks && kk > 0) {
        for (int idx = tid; idx < nh * BK; idx += blockDim.x) {
          const int hr = idx / BK, j = idx % BK;
          float acc = c == 0 ? 0.f : Ls[hr * PS + j];
#pragma unroll 8
          for (int d = 0; d < HD; ++d) acc = fmaf(Hs[hr * HD + d], Kt[d * BK + j], acc);
          Ls[hr * PS + j] = acc;
        }
      }
    }
  };

  const float bias = (kk > 0 && pb != nullptr) ? pb[hw] : 0.f;
  // dbrow: this thread's share of its 4 rows' sums of dLc (the bias
  // gradient), kept per row: each row of dLc sums to zero in exact
  // arithmetic, so a row's sum is taken whole before rows are added
  float mrow[4], srow[4], drow[4], dbrow[4], s[4][4], da[4][4], dyacc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = -INFINITY;
    srow[i] = 0.f;
    drow[i] = 0.f;
    dbrow[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) dyacc[i][c] = 0.f;
  }

  // pass 0: row max and sum, as the forward core computes them
  for (int k0 = 0; k0 < P; k0 += BK) {
    logits(k0, s, nullptr, false);
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
  }

  // pass 1: D = rowsum(dA * A)
  for (int k0 = 0; k0 < P; k0 += BK) {
    logits(k0, s, &da, false);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx * 4 + j < P)
          drow[i] += da[i][j] * (expf(s[i][j] + bias - mrow[i]) / srow[i]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) drow[i] = warp_sum(drow[i], 16);

  // pass 2: dLc, dY, the tap and bias sums (the halo logits Ls formed with
  // the logits, chunk by chunk)
  for (int k0 = 0; k0 < P; k0 += BK) {
    logits(k0, s, &da, true);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool row_ok = q0 + ty * 4 + i < P;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float dl = 0.f;
        if (row_ok && k0 + tx * 4 + j < P) {
          const float a = expf(s[i][j] + bias - mrow[i]) / srow[i];
          dl = a * (da[i][j] - drow[i]);
        }
        dbrow[i] += dl;
        Ps[(ty * 4 + i) * PS + tx * 4 + j] = dl;
      }
    }
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      const float4 kv = *reinterpret_cast<const float4*>(&Ks[j * HD + tx * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = Ps[(ty * 4 + i) * PS + j];
        dyacc[i][0] = fmaf(a, kv.x, dyacc[i][0]);
        dyacc[i][1] = fmaf(a, kv.y, dyacc[i][1]);
        dyacc[i][2] = fmaf(a, kv.z, dyacc[i][2]);
        dyacc[i][3] = fmaf(a, kv.w, dyacc[i][3]);
      }
    }
    if (kk > 0) {
      // tap t (one warp owns it): sum_ij dLc[i,j] L[i + t - k//2, j], whose
      // halo row is i + t
      for (int t = warp; t < kk; t += (int)(blockDim.x >> 5)) {
        float acc = 0.f;
        for (int e = lane; e < BQ * BK; e += 32) {
          const int i = e / BK, j = e % BK;
          acc = fmaf(Ps[i * PS + j], Ls[(i + t) * PS + j], acc);
        }
        acc = warp_sum(acc);
        if (lane == 0) dwacc[t] += acc;
      }
    }
    __syncthreads();
  }

  const long long rh = (long long)r * H + h;
  const long long rhp = (long long)gridDim.x * P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = q0 + ty * 4 + i;
    if (p >= P) continue;
    if (kk > 0) {
      float* o = dy + (rh * P + p) * hd + oc * HD + tx * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (tx * 4 + c < ow) o[c] = dyacc[i][c];
    } else {
      TO* o = (TO*)dq.p + row_of(tm, dq, r, p) + (long long)h * dq.sh + oc * HD + tx * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (tx * 4 + c < ow) o[c] = from_f<TO>(scale * dyacc[i][c]);
    }
    if (tx == 0 && oc == 0) {
      stats[rh * P + p] = mrow[i];
      stats[rhp + rh * P + p] = srow[i];
      stats[2 * rhp + rh * P + p] = drow[i];
    }
  }
  if (kk > 0) {
    // each row's sum over its keys (the 16 tx lanes), then the tile's 64
    // rows added in row order
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float row = warp_sum(dbrow[i], 16);
      if (tx == 0) red[ty * 4 + i] = row;
    }
    __syncthreads();
    const int R = gridDim.x / H;
    const long long slot = ((long long)h * R + r) * gridDim.y + qt;
    float* out = part + slot * (kk + 1);
    if (tid == 0) {
      float acc = 0.f;
      for (int i = 0; i < BQ; ++i) acc += red[i];
      out[kk] = acc;
    }
    for (int t = tid; t < kk; t += blockDim.x) out[t] = dwacc[t];
  }
}

// (2) key side: dk and dv of 64 keys, over every query tile
template <typename TI, typename TO>
__global__ void __launch_bounds__(256)
attn_bwd_kv_kernel(Opnd q, Opnd k, Opnd v, Opnd g, Opnd dk, Opnd dv, int H, int hd,
                   TokenMap tm, const float* __restrict__ pw, int kk,
                   const float* __restrict__ pb, float scale, const float* __restrict__ stats) {
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;               // [HD][BK]
  float* Vt = Kt + HD * BK;       // [HD][BK]
  float* Ys = Vt + HD * BK;       // [BQ][QS]
  float* Gs = Ys + BQ * QS;       // [BQ][QS]
  float* Pa = Gs + BQ * QS;       // [BQ][PS]  A
  float* Pd = Pa + BQ * PS;       // [BQ][PS]  dLc
  float* Hs = Pd + BQ * PS;       // [nh][HD]
  __shared__ float coef[MAX_KK];

  const int P = tm.P;
  const int r = blockIdx.x / H, h = blockIdx.x % H, hw = fold_of(tm, r) * H + h;
  const int k0 = blockIdx.y * BK;
  const int oc = blockIdx.z, nch = head_chunks(hd);   // this block's 64 columns of dk, dv
  const int ow = min(HD, hd - oc * HD);                // of which exist
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long rh = (long long)r * H + h;
  const long long rhp = (long long)gridDim.x * P;
  const TI* qp = (const TI*)q.p + (long long)h * q.sh;
  const TI* kp = (const TI*)k.p + (long long)h * k.sh;
  const TI* vp = (const TI*)v.p + (long long)h * v.sh;
  const TI* gp = (const TI*)g.p + (long long)h * g.sh;

  if (kk > 0) epeg_coef<float>(pw, hw, kk, coef);
  if (nch == 1) load_keys<TI>(kp, k, vp, v, tm, r, k0, Kt, nullptr, Vt, hd);
  const float bias = (kk > 0 && pb != nullptr) ? pb[hw] : 0.f;

  float s[4][4], da[4][4], dkacc[4][4], dvacc[4][4];
  zero44(dkacc);
  zero44(dvacc);

  for (int q0 = 0; q0 < P; q0 += BQ) {
    // the logits and dA over the whole head width, chunk by chunk; then
    // this block's chunk of the queries and of g for dk and dv
    zero44(s);
    zero44(da);
    for (int c = 0; c < nch; ++c) {
      const int cw = min(HD, hd - c * HD);
      __syncthreads();
      load_queries<TI>(qp + c * HD, q, gp + c * HD, g, tm, r, q0, scale, coef, kk, Hs, Ys,
                       Gs, cw);
      if (nch > 1)
        load_keys<TI>(kp + c * HD, k, vp + c * HD, v, tm, r, k0, Kt, nullptr, Vt, cw);
      __syncthreads();
      tile_logits(Ys, Kt, tx, ty, s);
      tile_da(Gs, Vt, tx, ty, da);
    }
    if (oc != nch - 1) {
      __syncthreads();
      load_queries<TI>(qp + oc * HD, q, gp + oc * HD, g, tm, r, q0, scale, coef, kk, Hs, Ys,
                       Gs, ow);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = q0 + ty * 4 + i;
      float m = 0.f, sum = 1.f, dsum = 0.f;
      if (p < P) {
        m = stats[rh * P + p];
        sum = stats[rhp + rh * P + p];
        dsum = stats[2 * rhp + rh * P + p];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = 0.f, dl = 0.f;
        if (p < P && k0 + tx * 4 + j < P) {
          a = expf(s[i][j] + bias - m) / sum;
          dl = a * (da[i][j] - dsum);
        }
        Pa[(ty * 4 + i) * PS + tx * 4 + j] = a;
        Pd[(ty * 4 + i) * PS + tx * 4 + j] = dl;
      }
    }
    __syncthreads();
    for (int i = 0; i < BQ; ++i) {
      const float4 g4 = *reinterpret_cast<const float4*>(&Gs[i * QS + tx * 4]);
      const float4 y4 = *reinterpret_cast<const float4*>(&Ys[i * QS + tx * 4]);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float pa = Pa[i * PS + ty * 4 + a], pd = Pd[i * PS + ty * 4 + a];
        dvacc[a][0] = fmaf(pa, g4.x, dvacc[a][0]);
        dvacc[a][1] = fmaf(pa, g4.y, dvacc[a][1]);
        dvacc[a][2] = fmaf(pa, g4.z, dvacc[a][2]);
        dvacc[a][3] = fmaf(pa, g4.w, dvacc[a][3]);
        dkacc[a][0] = fmaf(pd, y4.x, dkacc[a][0]);
        dkacc[a][1] = fmaf(pd, y4.y, dkacc[a][1]);
        dkacc[a][2] = fmaf(pd, y4.z, dkacc[a][2]);
        dkacc[a][3] = fmaf(pd, y4.w, dkacc[a][3]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int p = k0 + ty * 4 + a;
    if (p >= P) continue;
    TO* ko = (TO*)dk.p + row_of(tm, dk, r, p) + (long long)h * dk.sh + oc * HD + tx * 4;
    TO* vo = (TO*)dv.p + row_of(tm, dv, r, p) + (long long)h * dv.sh + oc * HD + tx * 4;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (tx * 4 + c >= ow) continue;
      ko[c] = from_f<TO>(dkacc[a][c]);
      vo[c] = from_f<TO>(dvacc[a][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 products: the tensor-core kernels (128 threads, 16 rows a warp)
// ---------------------------------------------------------------------------
constexpr int BST = 3;                  // ring stages of 64 x 64 tile pairs
constexpr int PAIR = 2 * TK * TRS;      // bf16 elements of one stage

// halo rows of the EPEG tap sums, in whole 16-row mma tiles, and enough for
// every warp's 32-column windows of round(dLc) L^T (tap t of query row i
// is column i + t: warp w reads rows 16 w .. 16 w + 32 n - 1 with 32 n >=
// 15 + kk)
__host__ __device__ inline int halo_rows(int kk) {
  if (kk <= 0) return 0;
  const int hr = ((TQ + kk - 1 + 15) / 16) * 16, win = 48 + 32 * ((kk + 15 + 31) / 32);
  return hr > win ? hr : win;
}
// the query side's shared memory: y and round(g) at the padded head width,
// the ring, with EPEG the halo rows (at the padded head width), their
// logits, round(dLc), and the taps by row, whose space also takes the whole
// key tile when the head has more than one chunk
int q_tc_smem_bytes(int hd, int kk) {
  const int hs = TD * head_chunks(hd) + 8, hr = halo_rows(kk);
  const int dg = TQ * kk * 4, kf = head_chunks(hd) > 1 ? TK * hs * 2 : 0;
  return (2 * TQ * hs + BST * PAIR + (kk > 0 ? hr * hs + hr * TRS + TQ * TRS : 0)) * 2 +
         (kk > 0 ? (dg > kf ? dg : kf) : 0);
}
int kv_tc_smem_bytes(int hd) { return (2 * TK * (TD * head_chunks(hd) + 8) + BST * PAIR) * 2; }

// (1) query side on the tensor cores; a block owns NC chunks of dq (oc0 ..).
// ONE: the head is one 64-wide chunk (hd <= 64), its strides and loops
// compile-time constants (hd = 64 is the main path's K2: the EPEG tap pass
// and the halo logits are in its inner loops)
template <typename TI, typename TO, int NC, bool ONE>
__global__ void __launch_bounds__(128)
attn_bwd_q_tc(Opnd q, Opnd k, Opnd v, Opnd g, Opnd dq, int H, int hd, TokenMap tm,
              const float* __restrict__ pw, int kk, const float* __restrict__ pb, float scale,
              float* __restrict__ stats, bf16* __restrict__ ys, bf16* __restrict__ dy,
              float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nch = ONE ? 1 : head_chunks(hd), QST = ONE ? TRS : nch * TD + 8;
  const int HR = halo_rows(kk);
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [TQ][QST]  y
  bf16* Gs = Qs + TQ * QST;                       // [TQ][QST]  round(g)
  bf16* ring = Gs + TQ * QST;                     // BST x (k tile, v tile)
  bf16* Hs = ring + BST * PAIR;                   // [HR][QST]  round(q s), rows q0 - k//2 ..
  bf16* Ls = Hs + (kk > 0 ? HR * QST : 0);        // [HR][TRS]  round(Hs k^T) of one key tile
  bf16* Ps = Ls + (kk > 0 ? HR * TRS : 0);        // [TQ][TRS]  round(dLc) of one key tile
  float* Dg = reinterpret_cast<float*>(Ps + (kk > 0 ? TQ * TRS : 0));  // [TQ][kk] taps by row
  bf16* Kf = reinterpret_cast<bf16*>(Dg);         // [TK][QST]  the key tile (nch > 1), Dg's space
  __shared__ float coef[MAX_KK], dwacc[MAX_KK], red[4];

  const int P = tm.P;
  const int r = blockIdx.x / H, h = blockIdx.x % H, hw = fold_of(tm, r) * H + h;
  const int qt = blockIdx.y, q0 = qt * TQ, oc0 = blockIdx.z * NC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, cq = (lane & 3) * 2;
  const TI* qp = (const TI*)q.p + (long long)h * q.sh;
  const TI* kp = (const TI*)k.p + (long long)h * k.sh;
  const TI* vp = (const TI*)v.p + (long long)h * v.sh;
  const TI* gp = (const TI*)g.p + (long long)h * g.sh;

  // y as the forward core forms it, and round(g), for the whole head width
  if (kk > 0) {
    const int pad = kk / 2;
    for (int t = tid; t < kk; t += 128) {
      coef[t] = round_to<bf16>(pw[hw * kk + t] + (t == pad ? 1.f : 0.f));
      dwacc[t] = 0.f;
    }
    load_tile<TI>(Hs, QST, qp, q, tm, r, q0 - pad, HR, nch * TD, scale, hd);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // the forward's k-tap sums, each in tap order; 4 independent chains a
    // thread (element idx of the tile at row idx / hp, column idx % hp of
    // both Hs and Qs, whose rows have one stride)
    const int hp = nch * TD;
    for (int i0 = tid; i0 < TQ * hp; i0 += 4 * 128) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      int at[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) at[u] = ((i0 + u * 128) / hp) * QST + (i0 + u * 128) % hp;
      for (int t = 0; t < kk; ++t) {
        const float c = coef[t];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          acc[u] = fmaf(c, __bfloat162float(Hs[at[u] + t * QST]), acc[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) Qs[at[u]] = __float2bfloat16(acc[u]);
    }
  } else {
    load_tile<TI>(Qs, QST, qp, q, tm, r, q0, TQ, nch * TD, scale, hd);
  }
  load_tile<TI>(Gs, QST, gp, g, tm, r, q0, TQ, nch * TD, 1.f, hd);

  // items: pass 1 (several key tiles only) = (k, v) chunk c of each key
  // tile; pass 2 = the same, then (c = nch + x) k chunk oc0 + x again for
  // each owned chunk but nch - 1, whose k tile the last chunk item holds
  const int nkt = (P + TK - 1) / TK, last = oc0 + NC - 1 == nch - 1;
  const int per = nch + NC - last, n1 = nkt > 1 ? nkt * nch : 0, total = n1 + nkt * per;
  auto locate = [&](int i, int& kt, int& c) {  // c >= nch: an extra item
    if (i < n1) {
      kt = i / nch; c = i % nch;
    } else {
      kt = (i - n1) / per; c = (i - n1) % per;
    }
  };
  Seg<TI> sg[8];
  auto fetch = [&](int i) {
    int kt, c;
    locate(i, kt, c);
    const int cc = c < nch ? c : oc0 + c - nch;
    bf16* T = ring + (i % BST) * PAIR;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int idx = tid + (u & 3) * 128, j = idx >> 3, s8 = idx & 7, p = kt * TK + j;
      const bool isv = u >= 4, ok = p < P && !(isv && c >= nch) && cc * TD + s8 * 8 < hd;
      const long long row = !ok ? 0 : isv ? row_of(tm, v, r, p) : row_of(tm, k, r, p);
      sg[u].fetch(&T[(isv ? TK * TRS : 0) + j * TRS + s8 * 8],
                  (isv ? vp : kp) + (ok ? row + cc * TD + s8 * 8 : 0), ok);
    }
  };
  auto store = [&](int i) {
    bf16* T = ring + (i % BST) * PAIR;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int idx = tid + (u & 3) * 128;
      sg[u].store(&T[(u >= 4 ? TK * TRS : 0) + (idx >> 3) * TRS + (idx & 7) * 8]);
    }
  };
  for (int i = 0; i < BST - 1; ++i) {
    if (i < total) {
      fetch(i);
      store(i);
    }
    cp_async_commit();
  }

  const float bias = (kk > 0 && pb != nullptr) ? pb[hw] : 0.f;
  const bf16* Qw = Qs + warp * 16 * QST;
  const bf16* Gw = Gs + warp * 16 * QST;
  float S[8][4], dA[8][4], dY[NC][8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
  float dbacc = 0.f;
  uint32_t Pd[4][4];
#pragma unroll
  for (int x = 0; x < NC; ++x) zero_acc(dY[x]);

  for (int i = 0; i < total; ++i) {
    cp_async_wait<BST - 2>();
    __syncthreads();
    const bool more = i + BST - 1 < total;
    if (more) fetch(i + BST - 1);
    int kt, c;
    locate(i, kt, c);
    const bf16* Kt = ring + (i % BST) * PAIR;
    const bf16* Vt = Kt + TK * TRS;
    if (c < nch) {
      if (c == 0) {
        zero_acc(S);
        zero_acc(dA);
      }
      mma_abt(S, Qw + c * TD, QST, Kt, TRS);
      mma_abt(dA, Gw + c * TD, QST, Vt, TRS);
    }
    if (c == nch - 1) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          S[nt][e] = kt * TK + nt * 8 + cq + (e & 1) < P ? S[nt][e] + bias : -INFINITY;
      if (i < n1 || nkt == 1) online_softmax(S, m, l, dA, u);
      if (i >= n1) {
        // dLc = A * (dA - D), rows and keys past P at 0; its bf16 rounding
        // as A fragments of dY += round(dLc) k
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hr = e >> 1;
            float dl = 0.f;
            if (q0 + warp * 16 + g8 + hr * 8 < P && kt * TK + nt * 8 + cq + (e & 1) < P) {
              const float a = expf(S[nt][e] - m[hr]) / l[hr];
              dl = a * (dA[nt][e] - u[hr] / l[hr]);
            }
            dbacc += dl;
            S[nt][e] = dl;
          }
        pack_frags(Pd, S);
        if (kk > 0) {
          // the tap sums of this key tile: with one chunk Kt is the whole k
          // tile, else the whole tile is loaded into Kf (Dg's space, free
          // until the taps by row are formed below)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr)
              store2(&Ps[(warp * 16 + g8 + hr * 8) * TRS + nt * 8 + cq], S[nt][2 * hr],
                     S[nt][2 * hr + 1]);
          const bf16* Kl = Kt;
          int kls = TRS;
          if (!ONE && nch > 1) {
            load_tile<TI>(Kf, QST, kp, k, tm, r, kt * TK, TK, nch * TD, 1.f, hd);
            cp_async_commit();
            cp_async_wait<0>();
            __syncthreads();
            Kl = Kf;
            kls = QST;
          }
          for (int mt = warp; mt < HR / 16; mt += 4) {
            float L[8][4];
            zero_acc(L);
            for (int cc = 0; cc < nch; ++cc)
              mma_abt(L, Hs + mt * 16 * QST + cc * TD, QST, Kl + cc * TD, kls);
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
#pragma unroll
              for (int hr = 0; hr < 2; ++hr)
                store2(&Ls[(mt * 16 + g8 + hr * 8) * TRS + nt * 8 + cq], L[nt][2 * hr],
                       L[nt][2 * hr + 1]);
          }
          __syncthreads();
          // M = round(dLc) L^T on the tensor cores, 32 halo rows a window;
          // Dg[i][t] = M[i][i + t]; then tap t sums its column of Dg over
          // the 64 rows in a fixed order
          for (int w0 = 0; w0 < 15 + kk; w0 += 32) {
            float M[8][4];
            zero_acc(M);
            mma_abt<2>(M, Ps + warp * 16 * TRS, TRS, Ls + (warp * 16 + w0) * TRS, TRS);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int row = g8 + (e >> 1) * 8, t = w0 + nt * 8 + cq + (e & 1) - row;
                if (t >= 0 && t < kk) Dg[(warp * 16 + row) * kk + t] = M[nt][e];
              }
          }
          __syncthreads();
          for (int t = warp; t < kk; t += 4) {
            const float acc = warp_sum(Dg[lane * kk + t] + Dg[(lane + 32) * kk + t]);
            if (lane == 0) dwacc[t] += acc;
          }
        }
        if (last) mma_pb(dY[NC - 1], Pd, Kt, TRS);
      }
    } else if (c >= nch) {
#pragma unroll
      for (int x = 0; x < NC; ++x)
        if (x == c - nch) mma_pb(dY[x], Pd, Kt, TRS);
    }
    if (more) store(i + BST - 1);
    cp_async_commit();
  }
  __syncthreads();

  const long long rh = (long long)r * H + h, rhp = (long long)gridDim.x * P;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int p = q0 + warp * 16 + g8 + hr * 8;
    if (p >= P) continue;
    if (oc0 == 0 && cq == 0) {
      stats[rh * P + p] = m[hr];
      stats[rhp + rh * P + p] = l[hr];
      stats[2 * rhp + rh * P + p] = u[hr] / l[hr];
    }
    if (kk > 0) {
      bf16* o = dy + (rh * P + p) * hd + oc0 * TD + cq;
#pragma unroll
      for (int x = 0; x < NC; ++x)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          if ((oc0 + x) * TD + nt * 8 + cq < hd)
            store2(o + x * TD + nt * 8, dY[x][nt][2 * hr], dY[x][nt][2 * hr + 1]);
    } else {
      TO* o = (TO*)dq.p + row_of(tm, dq, r, p) + (long long)h * dq.sh + oc0 * TD + cq;
#pragma unroll
      for (int x = 0; x < NC; ++x)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          if ((oc0 + x) * TD + nt * 8 + cq < hd)
            store2(o + x * TD + nt * 8, scale * dY[x][nt][2 * hr],
                   scale * dY[x][nt][2 * hr + 1]);
    }
  }
  // y, this block's chunks, for the key side
  for (int idx = tid; idx < TQ * NC * (TD / 8); idx += 128) {
    const int i = idx / (NC * TD / 8), s8 = idx % (NC * TD / 8), p = q0 + i;
    if (p < P && oc0 * TD + s8 * 8 < hd)
      *reinterpret_cast<uint4*>(&ys[(rh * P + p) * hd + oc0 * TD + s8 * 8]) =
          *reinterpret_cast<const uint4*>(&Qs[i * QST + oc0 * TD + s8 * 8]);
  }
  if (kk > 0) {
    dbacc = warp_sum(dbacc);
    if (lane == 0) red[warp] = dbacc;
    __syncthreads();
    const int R = gridDim.x / H;
    float* out = part + (((long long)h * R + r) * gridDim.y + qt) * (kk + 1);
    if (tid == 0) out[kk] = (red[0] + red[1]) + (red[2] + red[3]);
    for (int t = tid; t < kk; t += 128) out[t] = dwacc[t];
  }
}

// (2) key side on the tensor cores; y from the query side's copy ys
template <typename TI, typename TO>
__global__ void __launch_bounds__(128)
attn_bwd_kv_tc(Opnd k, Opnd v, Opnd g, Opnd dk, Opnd dv, const bf16* __restrict__ ys, int H,
               int hd, TokenMap tm, int kk, const float* __restrict__ pb,
               const float* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nch = head_chunks(hd), QST = nch * TD + 8;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [TK][QST]  round(k)
  bf16* Vs = Ks + TK * QST;                       // [TK][QST]  round(v)
  bf16* ring = Vs + TK * QST;                     // BST x (y tile, g tile)

  const int P = tm.P;
  const int r = blockIdx.x / H, h = blockIdx.x % H, hw = fold_of(tm, r) * H + h;
  const int k0 = blockIdx.y * TK, oc = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, cq = (lane & 3) * 2;
  const long long rh = (long long)r * H + h, rhp = (long long)gridDim.x * P;
  const TI* kp = (const TI*)k.p + (long long)h * k.sh;
  const TI* vp = (const TI*)v.p + (long long)h * v.sh;
  const TI* gp = (const TI*)g.p + (long long)h * g.sh;
  const bf16* yp = ys + rh * P * hd;
  load_tile<TI>(Ks, QST, kp, k, tm, r, k0, TK, nch * TD, 1.f, hd);
  load_tile<TI>(Vs, QST, vp, v, tm, r, k0, TK, nch * TD, 1.f, hd);

  // items: (y, g) chunk c of each query tile, then chunk oc again (c ==
  // nch) when chunk nch - 1 is not the block's own
  const int nqt = (P + TQ - 1) / TQ, xt = oc != nch - 1, per = nch + xt, total = nqt * per;
  Seg<bf16> sy[4];
  Seg<TI> sg[4];
  auto fetch = [&](int i) {
    const int qt = i / per, c = i % per, cc = c == nch ? oc : c;
    bf16* T = ring + (i % BST) * PAIR;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = tid + u * 128, j = idx >> 3, s8 = idx & 7, p = qt * TQ + j;
      const bool ok = p < P && cc * TD + s8 * 8 < hd;
      sy[u].fetch(&T[j * TRS + s8 * 8], yp + (ok ? (long long)p * hd + cc * TD + s8 * 8 : 0),
                  ok);
      sg[u].fetch(&T[TK * TRS + j * TRS + s8 * 8],
                  gp + (ok ? row_of(tm, g, r, p) + cc * TD + s8 * 8 : 0), ok);
    }
  };
  auto store = [&](int i) {
    bf16* T = ring + (i % BST) * PAIR;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = tid + u * 128;
      sy[u].store(&T[(idx >> 3) * TRS + (idx & 7) * 8]);
      sg[u].store(&T[TK * TRS + (idx >> 3) * TRS + (idx & 7) * 8]);
    }
  };
  for (int i = 0; i < BST - 1; ++i) {
    if (i < total) {
      fetch(i);
      store(i);
    }
    cp_async_commit();
  }

  const float bias = (kk > 0 && pb != nullptr) ? pb[hw] : 0.f;
  const bf16* Kw = Ks + warp * 16 * QST;
  const bf16* Vw = Vs + warp * 16 * QST;
  float LT[8][4], dAT[8][4], dK[8][4], dV[8][4];
  uint32_t Pa[4][4], Pd[4][4];
  zero_acc(dK);
  zero_acc(dV);

  for (int i = 0; i < total; ++i) {
    cp_async_wait<BST - 2>();
    __syncthreads();
    const bool more = i + BST - 1 < total;
    if (more) fetch(i + BST - 1);
    const int qt = i / per, c = i % per;
    const bf16* Yt = ring + (i % BST) * PAIR;
    const bf16* Gt = Yt + TK * TRS;
    if (c < nch) {
      if (c == 0) {
        zero_acc(LT);
        zero_acc(dAT);
      }
      mma_abt(LT, Kw + c * TD, QST, Yt, TRS);  // Lc^T: rows keys, columns queries
      mma_abt(dAT, Vw + c * TD, QST, Gt, TRS);
    }
    if (c == nch - 1) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int iq = qt * TQ + nt * 8 + cq + e1;
          const bool iok = iq < P;
          float mi = 0.f, li = 1.f, di = 0.f;
          if (iok) {
            mi = stats[rh * P + iq];
            li = stats[rhp + rh * P + iq];
            di = stats[2 * rhp + rh * P + iq];
          }
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int e = 2 * hr + e1;
            float a = 0.f, dl = 0.f;
            if (iok && k0 + warp * 16 + g8 + hr * 8 < P) {
              a = expf(LT[nt][e] + bias - mi) / li;
              dl = a * (dAT[nt][e] - di);
            }
            LT[nt][e] = a;
            dAT[nt][e] = dl;
          }
        }
      pack_frags(Pa, LT);
      pack_frags(Pd, dAT);
      if (!xt) {
        mma_pb(dV, Pa, Gt, TRS);
        mma_pb(dK, Pd, Yt, TRS);
      }
    } else if (c == nch) {
      mma_pb(dV, Pa, Gt, TRS);
      mma_pb(dK, Pd, Yt, TRS);
    }
    if (more) store(i + BST - 1);
    cp_async_commit();
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int p = k0 + warp * 16 + g8 + hr * 8;
    if (p >= P) continue;
    TO* ko = (TO*)dk.p + row_of(tm, dk, r, p) + (long long)h * dk.sh + oc * TD + cq;
    TO* vo = (TO*)dv.p + row_of(tm, dv, r, p) + (long long)h * dv.sh + oc * TD + cq;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (oc * TD + nt * 8 + cq >= hd) continue;
      store2(ko + nt * 8, dK[nt][2 * hr], dK[nt][2 * hr + 1]);
      store2(vo + nt * 8, dV[nt][2 * hr], dV[nt][2 * hr + 1]);
    }
  }
}

// (3) dq = scale * M_h^T round(dY): tap t of row i reads dY row i - t + k//2;
// dY (R*H*P, hd), a block per (region, head, 64 queries, 64-wide chunk)
template <typename TM, typename TO>
__global__ void __launch_bounds__(256)
attn_bwd_dq_kernel(const TM* __restrict__ dy, Opnd dq, int H, int hd, TokenMap tm,
                   const float* __restrict__ pw, int kk, float scale) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float coef[MAX_KK];
  const int P = tm.P;
  const int r = blockIdx.x / H, h = blockIdx.x % H, hw = fold_of(tm, r) * H + h;
  const int q0 = blockIdx.y * BQ, oc = blockIdx.z * HD, cw = min(HD, hd - oc);
  const int pad = kk / 2, nh = BQ + kk - 1, h0 = q0 - (kk - 1 - pad);
  const long long rh = (long long)r * H + h;
  epeg_coef<TM>(pw, hw, kk, coef);
  for (int idx = threadIdx.x; idx < nh * HD; idx += blockDim.x) {
    const int row = idx / HD, d = idx % HD, p = h0 + row;
    smem[idx] = (p >= 0 && p < P && d < cw) ? to_f(dy[(rh * P + p) * hd + oc + d]) : 0.f;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BQ * HD; idx += blockDim.x) {
    const int i = idx / HD, d = idx % HD, p = q0 + i;
    if (p >= P || d >= cw) continue;
    float acc = 0.f;
    for (int t = 0; t < kk; ++t) acc = fmaf(coef[t], smem[(i + kk - 1 - t) * HD + d], acc);
    ((TO*)dq.p)[row_of(tm, dq, r, p) + (long long)h * dq.sh + oc + d] = from_f<TO>(scale * acc);
  }
}

// (4) dw[h, t] and db[h]: the partials of every (region, query tile), in
// order; with F folds of nbf partials each (the regions of fold f are
// consecutive), fold f's own into dw[f, h, t] and db[f, h]
__global__ void __launch_bounds__(256)
attn_bwd_dw_kernel(const float* __restrict__ part, int nb, int nbf, int kk, int H, int F,
                   float* __restrict__ dw, float* __restrict__ db) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= F * H * (kk + 1)) return;
  const int fh = e / (kk + 1), t = e % (kk + 1), f = fh / H, h = fh % H;
  float acc = 0.f;
  for (int n = f * nbf; n < f * nbf + nbf; ++n)
    acc += part[((long long)h * nb + n) * (kk + 1) + t];
  if (t < kk) dw[fh * kk + t] = acc;
  else if (db) db[fh] = acc;
}

struct BwdArgs {
  Opnd q, k, v, g, dq, dk, dv;
  int R, H, hd;
  TokenMap tm;
  const float* pw;
  int kk;
  const float* pb;
  float scale;
  float* stats;
  void* ys;
  void* dy;
  float* part;
  float* dw;
  float* db;
  int qcols;  // dq chunks a query-side block owns (tensor cores): 1 or 2
};

template <typename TI, typename TO, int NC, bool ONE>
cudaError_t launch_bwd_tc(const BwdArgs& a, dim3 grid, cudaStream_t stream) {
  static int done_q = 0, done_kv = 0;
  const int sq = q_tc_smem_bytes(a.hd, a.kk), skv = kv_tc_smem_bytes(a.hd);
  cudaError_t err;
  if ((err = smem_optin(attn_bwd_q_tc<TI, TO, NC, ONE>, sq, done_q)) != cudaSuccess) return err;
  if ((err = smem_optin(attn_bwd_kv_tc<TI, TO>, skv, done_kv)) != cudaSuccess) return err;
  attn_bwd_q_tc<TI, TO, NC, ONE><<<dim3(grid.x, grid.y, grid.z / NC), 128, sq, stream>>>(
      a.q, a.k, a.v, a.g, a.dq, a.H, a.hd, a.tm, a.pw, a.kk, a.pb, a.scale, a.stats,
      (bf16*)a.ys, (bf16*)a.dy, a.part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attn_bwd_kv_tc<TI, TO><<<grid, 128, skv, stream>>>(a.k, a.v, a.g, a.dk, a.dv,
                                                     (const bf16*)a.ys, a.H, a.hd, a.tm, a.kk,
                                                     a.pb, a.stats);
  return cudaGetLastError();
}

// tm = bf16: the tensor-core kernels; tm = float: the SIMT ones
template <typename TI, typename TM, typename TO>
cudaError_t launch_attention_bwd(const BwdArgs& a, cudaStream_t stream) {
  const int nqt = (a.tm.P + BQ - 1) / BQ;
  const dim3 grid(a.R * a.H, nqt, head_chunks(a.hd));
  cudaError_t err;
  if (sizeof(TM) == 2) {
    err = a.qcols == 2                 ? launch_bwd_tc<TI, TO, 2, false>(a, grid, stream)
          : head_chunks(a.hd) == 1 ? launch_bwd_tc<TI, TO, 1, true>(a, grid, stream)
                                   : launch_bwd_tc<TI, TO, 1, false>(a, grid, stream);
    if (err != cudaSuccess) return err;
  } else {
    static int done_q = 0, done_kv = 0;
    const int sq = (int)q_smem_bytes(a.kk), skv = (int)kv_smem_bytes(a.kk);
    if ((err = smem_optin(attn_bwd_q_kernel<TI, TO>, sq, done_q)) != cudaSuccess) return err;
    if ((err = smem_optin(attn_bwd_kv_kernel<TI, TO>, skv, done_kv)) != cudaSuccess) return err;
    attn_bwd_q_kernel<TI, TO><<<grid, 256, sq, stream>>>(a.q, a.k, a.v, a.g, a.dq, a.H, a.hd,
                                                         a.tm, a.pw, a.kk, a.pb, a.scale,
                                                         a.stats, (float*)a.dy, a.part);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    attn_bwd_kv_kernel<TI, TO><<<grid, 256, skv, stream>>>(a.q, a.k, a.v, a.g, a.dk, a.dv, a.H,
                                                           a.hd, a.tm, a.pw, a.kk, a.pb,
                                                           a.scale, a.stats);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (a.kk > 0) {
    attn_bwd_dq_kernel<TM, TO><<<dim3(a.R * a.H, nqt, head_chunks(a.hd)), 256,
                                 (size_t)(BQ + a.kk - 1) * HD * 4, stream>>>(
        (const TM*)a.dy, a.dq, a.H, a.hd, a.tm, a.pw, a.kk, a.scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int F = a.tm.rf > 0 ? a.R / a.tm.rf : 1, n = F * a.H * (a.kk + 1);
    attn_bwd_dw_kernel<<<(n + 255) / 256, 256, 0, stream>>>(a.part, a.R * nqt, a.R / F * nqt,
                                                           a.kk, a.H, F, a.dw, a.db);
  }
  return cudaGetLastError();
}

// partial column sums of round-free v = A * mask (per chunk of `rows` rows),
// and optionally v rounded to TM: part[s, n] = sum_{rows of chunk s} v[m, n];
// the rows fall into gridDim.z folds of Mf, each split into gridDim.y
// chunks of its own (fold f's are chunks f gridDim.y .. (f + 1) gridDim.y
// - 1; one fold is the kernel as it was)
template <typename TA, typename TM>
__global__ void __launch_bounds__(256)
colsum_kernel(const TA* __restrict__ A, int lda, long long Mf, int N,
              const uint8_t* __restrict__ rowmask, TM* __restrict__ rounded, int ldo,
              int rows, float* __restrict__ part) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const long long f0 = blockIdx.z * Mf, r0 = f0 + (long long)blockIdx.y * rows;
  const long long r1 = min(f0 + Mf, r0 + rows);
  part += (long long)blockIdx.z * gridDim.y * N;
  float acc = 0.f;
  for (long long m = r0; m < r1; ++m) {
    float v = to_f(A[m * lda + n]);
    if (rowmask) v = v * (rowmask[m] ? 1.f : 0.f);
    acc += v;
    if (rounded) rounded[m * ldo + n] = from_f<TM>(v);
  }
  part[(long long)blockIdx.y * N + n] = acc;
}

// LayerNorm backward of z = mask * LN(x), one warp per token row, with the
// residual's gradient g added when given; every warp owns `rpw` rows and
// writes its dls / dlb partials (part[w, c] and part[S + w, c]).  The rows
// fall into gridDim.y folds of Mf, fold blockIdx.y with its LayerNorm scale
// (ls (F, C) row blockIdx.y) and its own warps (fold f's are warps f Sf ..
// f Sf + Sf - 1, Sf = ceil(Mf / rpw); one fold is the kernel as it was).
template <typename TS>
__global__ void __launch_bounds__(256)
ln_bwd_rows_kernel(const TS* __restrict__ x, const uint8_t* __restrict__ mask,
                   const float* __restrict__ ls, const float* __restrict__ dz,
                   const TS* __restrict__ g, TS* __restrict__ dx, float* __restrict__ part,
                   long long Mf, int C, float eps, int rpw) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const long long Sf = (Mf + rpw - 1) / rpw, S = gridDim.y * Sf;
  if (w >= Sf) return;
  const long long row0 = blockIdx.y * Mf;  // fold blockIdx.y's rows
  x += row0 * C;
  mask += row0;
  dz += row0 * C;
  dx += row0 * C;
  if (g) g += row0 * C;
  ls += blockIdx.y * C;
  part += blockIdx.y * Sf * C;
  float pls[CPL], plb[CPL], vals[CPL], dzh[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) { pls[i] = 0.f; plb[i] = 0.f; }
  const long long t1 = min(Mf, (w + 1) * rpw);
  for (long long t = w * rpw; t < t1; ++t) {
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      vals[i] = c < C ? to_f(x[t * C + c]) : 0.f;
    }
    float mu, rstd;
    warp_ln_stats(vals, C, lane, eps, mu, rstd);
    const float m = mask[t] ? 1.f : 0.f;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      if (c < C) {
        const float zhat = (vals[i] - mu) * rstd;
        const float dzs = dz[t * C + c] * m;
        pls[i] += dzs * zhat;
        plb[i] += dzs;
        dzh[i] = dzs * ls[c];
        vals[i] = zhat;
        s1 += dzh[i];
        s2 += dzh[i] * zhat;
      }
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      if (c < C) {
        float v = rstd * (dzh[i] - m1 - vals[i] * m2);
        if (g) v += to_f(g[t * C + c]);
        dx[t * C + c] = from_f<TS>(v);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    if (c < C) {
      part[w * C + c] = pls[i];
      part[(S + w) * C + c] = plb[i];
    }
  }
}

struct GemmArgs {
  const void* A; int lda; const void* B; int ldb; void* out; int ldc;
  int M, N, K, kchunk; long long zstride; int F; long long b_fs; cudaStream_t stream;
};

template <typename TA, typename TB, typename TM, typename TO>
int gemm_tr(int at, int bt, const GemmArgs& g) {
  if (at && !bt)
    return (int)launch_gemm_ex<TA, TB, TM, TO, true, false>(
        g.A, g.lda, g.B, g.ldb, g.out, g.ldc, g.M, g.N, g.K, g.kchunk, g.zstride, g.F,
        g.b_fs, g.stream);
  if (!at && bt)
    return (int)launch_gemm_ex<TA, TB, TM, TO, false, true>(
        g.A, g.lda, g.B, g.ldb, g.out, g.ldc, g.M, g.N, g.K, g.kchunk, g.zstride, g.F,
        g.b_fs, g.stream);
  return (int)cudaErrorInvalidValue;
}

template <typename TM>
int gemm_tm(int a32, int b32, int o32, int at, int bt, const GemmArgs& g) {
  if (a32) {
    if (b32) return o32 ? gemm_tr<float, float, TM, float>(at, bt, g)
                        : gemm_tr<float, float, TM, TM>(at, bt, g);
    return o32 ? gemm_tr<float, TM, TM, float>(at, bt, g)
               : gemm_tr<float, TM, TM, TM>(at, bt, g);
  }
  if (b32) return o32 ? gemm_tr<TM, float, TM, float>(at, bt, g)
                      : gemm_tr<TM, float, TM, TM>(at, bt, g);
  return o32 ? gemm_tr<TM, TM, TM, float>(at, bt, g) : gemm_tr<TM, TM, TM, TM>(at, bt, g);
}

}  // namespace

// out = round(A) round(B) with A^T (at) or B^T (bt); the A and B operands
// are float (a32 / b32) or of the mm dtype, out float (o32) or the mm dtype.
// F folds: at, each fold's K / F rows in chunks of their own (fold f's
// partials f ceil(K / F / kchunk) on); bt, fold f's M / F rows times its B,
// b_fs elements past fold 0's
extern "C" int rb_gemm(int tm, int a32, int b32, int o32, int at, int bt, const void* A,
                       int lda, const void* B, int ldb, void* out, int ldc, int M, int N,
                       int K, int kchunk, long long zstride, int F, long long b_fs,
                       void* stream) {
  const GemmArgs g{A, lda, B, ldb, out, ldc, M, N, K, kchunk, zstride, F, b_fs,
                   (cudaStream_t)stream};
  if (tm == 0) return gemm_tm<float>(a32, b32, o32, at, bt, g);
  if (tm == 1) return gemm_tm<bf16>(a32, b32, o32, at, bt, g);
  return (int)cudaErrorInvalidValue;
}

// bf16 products on the warpgroup tensor cores (wgmma.cuh): mn = 1, out =
// A^T B with A stored (K, M), B stored (K, N), the token axis K split into
// chunks of kchunk rows (a multiple of 64), chunk z written at out + z *
// zstride; mn = 0, out = A B^T with A stored (M, K), B stored (N, K).  A and
// B bf16; out float (o32) or bf16.  F folds as rb_gemm's: mn, each fold's
// K / F token rows in chunks of their own; else fold f's M / F rows times
// its B, b_fs elements past fold 0's.
extern "C" int rb_gemm_tc(int mn, int o32, const void* A, int lda, const void* B, int ldb,
                          void* out, int ldc, int M, int N, int K, int kchunk,
                          long long zstride, int F, long long b_fs, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (mn)
    return (int)(o32 ? wg::launch_gemm_wgmma<true, float>(A, lda, B, ldb, out, ldc, M, N, K,
                                                          kchunk, zstride, F, b_fs, s)
                     : wg::launch_gemm_wgmma<true, bf16>(A, lda, B, ldb, out, ldc, M, N, K,
                                                         kchunk, zstride, F, b_fs, s));
  return (int)(o32 ? wg::launch_gemm_wgmma<false, float>(A, lda, B, ldb, out, ldc, M, N, K,
                                                         kchunk, zstride, F, b_fs, s)
                   : wg::launch_gemm_wgmma<false, bf16>(A, lda, B, ldb, out, ldc, M, N, K,
                                                        kchunk, zstride, F, b_fs, s));
}

// Mf: rows per fold (0 or M: one fold; M a multiple of it)
extern "C" int rb_colsum(int ta, int tm, const void* A, int lda, long long M, int N,
                         const void* rowmask, void* rounded, int ldo, int rows, void* part,
                         long long Mf, void* stream) {
  if (Mf <= 0) Mf = M;
  if (rows <= 0 || M <= 0 || N <= 0 || M % Mf != 0) return (int)cudaErrorInvalidValue;
  dim3 grid((N + 255) / 256, (unsigned)((Mf + rows - 1) / rows), (unsigned)(M / Mf));
  RRT_DISPATCH(ta, TA, RRT_DISPATCH(tm, TM,
      colsum_kernel<TA, TM><<<grid, 256, 0, (cudaStream_t)stream>>>(
          (const TA*)A, lda, Mf, N, (const uint8_t*)rowmask, (TM*)rounded, ldo, rows,
          (float*)part)));
  return (int)cudaGetLastError();
}

// F folds: part (F, S, N) summed into out (F, N)
extern "C" int rb_reduce(const void* part, int S, long long N, void* out, int F,
                         void* stream) {
  return (int)launch_reduce_rows(part, S, N, out, (cudaStream_t)stream, F);
}

// Mf: rows per fold (0 or M: one fold), ls (F, C); part holds F * Sf dls
// partials, then F * Sf dlb partials, Sf = ceil(Mf / rpw)
extern "C" int rb_ln_bwd(int ts, const void* x, const void* mask, const void* ls,
                         const void* dz, const void* g, void* dx, void* part, long long M,
                         int C, float eps, int rpw, long long Mf, void* stream) {
  if (Mf <= 0) Mf = M;
  if (C > 32 * CPL || rpw <= 0 || M % Mf != 0) return (int)cudaErrorInvalidValue;
  const dim3 blocks((unsigned)(((Mf + rpw - 1) / rpw + 7) / 8), (unsigned)(M / Mf));
  RRT_DISPATCH(ts, TS,
      ln_bwd_rows_kernel<TS><<<blocks, 256, 0, (cudaStream_t)stream>>>(
          (const TS*)x, (const uint8_t*)mask, (const float*)ls, (const float*)dz,
          (const TS*)g, (TS*)dx, (float*)part, Mf, C, eps, rpw));
  return (int)cudaGetLastError();
}

// the attention core's backward on q, k, v, g (dtype ti) and into dq, dk,
// dv (dtype to), each described by (base, region stride, head stride,
// token-row stride); grid > 0 maps region r, token p to row token_of(r, p)
// of K2's (B, G*G) stream; hd a multiple of 32 (up to 128 with EPEG);
// qcols = the 64-wide dq chunks one query-side block owns with bf16
// products (1, or 2 when head_chunks(hd) is even).  Scratch:
// stats (3, R*H*P) f32; ys (R*H*P, hd) bf16 (tm = 1); with EPEG dy
// (R*H*P, hd) in the mm dtype and part (H, R*ceil(P/64), kk+1) f32, and the
// outputs dw (H, kk), db (H,) or null.  rf > 0: folds of rf regions, region
// r reading fold r / rf's taps pw (F, H, kk) and bias pb (F, H), and dw
// (F, H, kk), db (F, H) each fold's own sums.
extern "C" int rb_attention_bwd(int tm, int ti, int to, const void* q, long long q_sr,
                                long long q_sh, long long q_sp, const void* k, long long k_sr,
                                long long k_sh, long long k_sp, const void* v, long long v_sr,
                                long long v_sh, long long v_sp, const void* g, long long g_sr,
                                long long g_sh, long long g_sp, void* dq, long long dq_sr,
                                long long dq_sh, long long dq_sp, void* dk, long long dk_sr,
                                long long dk_sh, long long dk_sp, void* dv, long long dv_sr,
                                long long dv_sh, long long dv_sp, int R, int H, int hd, int P,
                                int grid, int rs, int qcols, const void* pw, int kk,
                                const void* pb, float scale, void* stats, void* ys, void* dy,
                                void* part, void* dw, void* db, int rf, void* stream) {
  if (hd <= 0 || hd % 32 != 0 || hd > MAX_HD || kk < 0 || kk > MAX_KK ||
      (kk > 0 && hd > MAX_EPEG_HD) || P <= 0 || stats == nullptr || (tm == 1 && ys == nullptr) ||
      qcols < 1 || qcols > 2 || head_chunks(hd) % qcols != 0)
    return (int)cudaErrorInvalidValue;
  if (kk > 0 && (pw == nullptr || dy == nullptr || part == nullptr || dw == nullptr))
    return (int)cudaErrorInvalidValue;
  if (rf < 0 || (rf > 0 && R % rf != 0)) return (int)cudaErrorInvalidValue;
  const BwdArgs a{Opnd{q, q_sr, q_sh, q_sp},    Opnd{k, k_sr, k_sh, k_sp},
                  Opnd{v, v_sr, v_sh, v_sp},    Opnd{g, g_sr, g_sh, g_sp},
                  Opnd{dq, dq_sr, dq_sh, dq_sp}, Opnd{dk, dk_sr, dk_sh, dk_sp},
                  Opnd{dv, dv_sr, dv_sh, dv_sp}, R, H, hd,
                  TokenMap{grid, rs, grid > 0 ? grid / rs : 0, P, rf},
                  (const float*)pw, kk, (const float*)pb, scale, (float*)stats, ys, dy,
                  (float*)part, (float*)dw, (float*)db, qcols};
  cudaError_t err = cudaErrorInvalidValue;
  RRT_DISPATCH(tm, TM, RRT_DISPATCH(ti, TI, RRT_DISPATCH(to, TO,
      err = launch_attention_bwd<TI, TM, TO>(a, (cudaStream_t)stream))));
  return (int)err;
}
