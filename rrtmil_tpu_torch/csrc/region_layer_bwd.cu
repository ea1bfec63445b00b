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
// What bounds it on an H100: at the c16_r50 train shape inside K5's backward,
// (B, 8, 64, 64), each (region, head) is ~2 MFLOP and ~40 KB, so launch
// latency bounds it; inside K2 (P = 144, EPEG k = 15) its ~6 GFLOP a slide
// make it compute-bound.  Design: flash-style recompute, never a P x P tile
// in memory, so P up to 961 (L = 60000) runs as it is.  Three kernels:
// (1) per 64 query rows: the row max and sum (the forward's exact two-pass
// code, so the softmax has the forward's bits), D = rowsum(dA * A), then
// dLc tile by tile into dY, the EPEG tap sums (only the k diagonals: the
// halo rows' q k^T are formed for each key tile and each tap is one
// 64 x 64 dot) and the bias sum, both as per-block partials; (2) per 64
// keys: dv and dk, looping over the query tiles with the saved row
// statistics; (3) with EPEG, dq = M^T dY as the transposed k-tap pass.  A
// fourth pass sums the tap and bias partials over the blocks in a fixed
// order: no atomics, so every run gives the same bits.  Rows are gathered
// through the same token map as K1's forward, so K2 runs the core on the
// (B, G*G) token order with no partition copy.  Head widths past 64 (up to
// 512, without EPEG: the CR-MSA of crmsa_heads=1 configs) keep the 64-wide
// register budget: each block owns one 64-wide chunk of the head's output
// columns (blockIdx.z); the logits, dA = g v^T and D sum over every chunk
// (queries and keys reloaded chunk by chunk), dq, dk and dv are per-chunk
// products.
//
// K2 replaces rrtmil_tpu/ops/pallas/region_layer.py::_layer_bwd_pallas
// (kernel body _layer_bwd_kernel): dx, d(LN scale, bias), dWq/dWk/dWv,
// dbq/dbk/dbv, the EPEG tap and bias grads, dWp and dbp of the R-MSA layer.
// What bounds it: the products, ~63 GFLOP a c16_r50 slide (qkv recompute,
// projection backward, qkv backward) against ~57 MB of x, g and dx.
// Design: a pipeline, like K1's forward.  The recompute runs K1's own
// entries (rl_ln_mask, rl_gemm, rl_attention in region_layer.cu); then
// rb_colsum forms round(g * mask) and the dbp partials; rb_gemm the weight
// gradients o^T gm and z^T round(dqkv) (A^T B, split along the token axis
// into partials that rb_reduce sums in order) and the data gradients
// gm Wp^T and round(dqkv) Wqkv^T (A B^T); rb_attention_bwd the core above
// on the token map; rb_ln_bwd the LayerNorm backward, one warp per token
// row, with the mask, the residual's g and per-warp dls/dlb partials.  The
// products run on the CUDA cores in fp32 (the rounding points are the TPU
// kernel's); tensor cores are later work, recorded in PERF.md.
#include "common.cuh"

using namespace rrt;

namespace {

constexpr int BQ = 64, BK = 64, HD = 64;
constexpr int QS = HD + 4, PS = BK + 4;

// k (and v) of keys k0 .. k0 + 63 of region r, head h: Kt/Vt transposed
// [d][j], Ks row-major [j][d]; keys past P are zeros.
template <typename TM>
__device__ __forceinline__ void load_keys(const TM* __restrict__ Y, int ldy, int kcol,
                                          int vcol, const TokenMap& tm, int r, int k0,
                                          float* Kt, float* Ks, float* Vt) {
  for (int idx = threadIdx.x; idx < BK * HD; idx += blockDim.x) {
    const int j = idx / HD, d = idx % HD, p = k0 + j;
    float kv = 0.f, vv = 0.f;
    if (p < tm.P) {
      const long long row = token_of(tm, r, p) * ldy;
      kv = to_f(Y[row + kcol + d]);
      if (Vt) vv = to_f(Y[row + vcol + d]);
    }
    Kt[d * BK + j] = kv;
    if (Ks) Ks[j * HD + d] = kv;
    if (Vt) Vt[d * BK + j] = vv;
  }
}

// Ys = the query tile as the forward's core forms it: round(M_h q) with the
// k-tap pass (Hs holds the halo rows q0 - k//2 .. q0 + 63 + k - 1 - k//2 of
// q), or q itself; Gs = the incoming gradient's rows.
template <typename TM>
__device__ __forceinline__ void load_queries(const TM* __restrict__ Y, int ldy, int qcol,
                                             const TM* __restrict__ G, int ldg, int gcol,
                                             const TokenMap& tm, int r, int q0,
                                             const float* coef, int kk, float* Hs,
                                             float* Ys, float* Gs) {
  const int P = tm.P, tid = threadIdx.x;
  if (kk > 0) {
    const int pad = kk / 2, nh = BQ + kk - 1;
    for (int idx = tid; idx < nh * HD; idx += blockDim.x) {
      const int row = idx / HD, d = idx % HD, p = q0 - pad + row;
      Hs[idx] = (p >= 0 && p < P) ? to_f(Y[token_of(tm, r, p) * ldy + qcol + d]) : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < BQ * HD; idx += blockDim.x) {
      const int i = idx / HD, d = idx % HD;
      float acc = 0.f;
      for (int t = 0; t < kk; ++t) acc = fmaf(coef[t], Hs[(i + t) * HD + d], acc);
      Ys[i * QS + d] = round_to<TM>(acc);
    }
  } else {
    for (int idx = tid; idx < BQ * HD; idx += blockDim.x) {
      const int i = idx / HD, d = idx % HD, p = q0 + i;
      Ys[i * QS + d] = p < P ? to_f(Y[token_of(tm, r, p) * ldy + qcol + d]) : 0.f;
    }
  }
  for (int idx = tid; idx < BQ * HD; idx += blockDim.x) {
    const int i = idx / HD, d = idx % HD, p = q0 + i;
    Gs[i * QS + d] = p < P ? to_f(G[token_of(tm, r, p) * ldg + gcol + d]) : 0.f;
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
template <typename TM, typename TO>
__global__ void __launch_bounds__(256)
attn_bwd_q_kernel(const TM* __restrict__ Y, int ldy, int kcol0, int vcol0,
                  const TM* __restrict__ G, int ldg, TO* __restrict__ D, int ldd,
                  int H, int hd, TokenMap tm, const float* __restrict__ pw, int kk,
                  const float* __restrict__ pb, float scale, float* __restrict__ stats,
                  TM* __restrict__ dy, float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  const int nh = kk > 0 ? BQ + kk - 1 : 0;
  float* Ys = smem;               // [BQ][QS]
  float* Gs = Ys + BQ * QS;       // [BQ][QS]
  float* Kt = Gs + BQ * QS;       // [HD][BK]
  float* Ks = Kt + HD * BK;       // [BK][HD]
  float* Vt = Ks + BK * HD;       // [HD][BK]
  float* Ps = Vt + HD * BK;       // [BQ][PS]  round(dLc)
  float* Hs = Ps + BQ * PS;       // [nh][HD]  q halo
  float* Ls = Hs + nh * HD;       // [nh][PS]  round(q k^T) of the halo rows
  __shared__ float coef[MAX_KK];
  __shared__ float dwacc[MAX_KK];
  __shared__ float red[256];

  const int P = tm.P;
  const int r = blockIdx.x / H, h = blockIdx.x % H;
  const int qt = blockIdx.y, q0 = qt * BQ;
  const int oc = blockIdx.z, nch = hd / HD;   // this block's 64 columns of dq
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int qcol = h * hd, kcol = kcol0 + h * hd, vcol = vcol0 + h * hd;

  if (kk > 0) {
    epeg_coef<TM>(pw, h, kk, coef);
    for (int t = tid; t < kk; t += blockDim.x) dwacc[t] = 0.f;
  }
  __syncthreads();
  if (nch == 1) load_queries<TM>(Y, ldy, qcol, G, ldg, qcol, tm, r, q0, coef, kk, Hs, Ys, Gs);

  // s = y k^T (and da = g v^T) of key tile k0 over the whole head width,
  // chunk by chunk (the queries are reloaded per chunk when hd > 64); Ks
  // receives this block's chunk of k
  auto logits = [&](int k0, float (&s)[4][4], float (*da)[4][4], bool with_ks) {
    zero44(s);
    if (da) zero44(*da);
    for (int c = 0; c < nch; ++c) {
      __syncthreads();
      if (nch > 1)
        load_queries<TM>(Y, ldy, qcol + c * HD, G, ldg, qcol + c * HD, tm, r, q0, coef, 0,
                         Hs, Ys, Gs);
      load_keys<TM>(Y, ldy, kcol + c * HD, vcol + c * HD, tm, r, k0, Kt,
                    with_ks && c == oc ? Ks : nullptr, da ? Vt : nullptr);
      __syncthreads();
      tile_logits(Ys, Kt, tx, ty, s);
      if (da) tile_da(Gs, Vt, tx, ty, *da);
    }
  };

  const float bias = (kk > 0 && pb != nullptr) ? pb[h] : 0.f;
  float mrow[4], srow[4], drow[4], s[4][4], da[4][4], dyacc[4][4];
  float dbacc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = -INFINITY;
    srow[i] = 0.f;
    drow[i] = 0.f;
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

  // pass 2: dLc, dY, the tap and bias sums (EPEG: hd = 64, one chunk)
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
        dbacc += dl;
        Ps[(ty * 4 + i) * PS + tx * 4 + j] = round_to<TM>(dl);
      }
    }
    if (kk > 0) {
      for (int idx = tid; idx < nh * BK; idx += blockDim.x) {
        const int hr = idx / BK, j = idx % BK;
        float acc = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) acc = fmaf(Hs[hr * HD + d], Kt[d * BK + j], acc);
        Ls[hr * PS + j] = round_to<TM>(acc);
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
      // tap t (one warp owns it): sum_ij round(dLc)[i,j] L[i + t - k//2, j],
      // whose halo row is i + t
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
      TM* o = dy + (rh * P + p) * HD + tx * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) o[c] = from_f<TM>(dyacc[i][c]);
    } else {
      TO* o = D + token_of(tm, r, p) * ldd + qcol + oc * HD + tx * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) o[c] = from_f<TO>(scale * dyacc[i][c]);
    }
    if (tx == 0 && oc == 0) {
      stats[rh * P + p] = mrow[i];
      stats[rhp + rh * P + p] = srow[i];
      stats[2 * rhp + rh * P + p] = drow[i];
    }
  }
  if (kk > 0) {
    red[tid] = dbacc;
    __syncthreads();
    const int R = gridDim.x / H;
    const long long slot = ((long long)h * R + r) * gridDim.y + qt;
    float* out = part + slot * (kk + 1);
    if (tid == 0) {
      float acc = 0.f;
      for (int i = 0; i < (int)blockDim.x; ++i) acc += red[i];
      out[kk] = acc;
    }
    for (int t = tid; t < kk; t += blockDim.x) out[t] = dwacc[t];
  }
}

// (2) key side: dk and dv of 64 keys, over every query tile
template <typename TM, typename TO>
__global__ void __launch_bounds__(256)
attn_bwd_kv_kernel(const TM* __restrict__ Y, int ldy, int kcol0, int vcol0,
                   const TM* __restrict__ G, int ldg, TO* __restrict__ D, int ldd,
                   int H, int hd, TokenMap tm, const float* __restrict__ pw, int kk,
                   const float* __restrict__ pb, const float* __restrict__ stats) {
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;               // [HD][BK]
  float* Vt = Kt + HD * BK;       // [HD][BK]
  float* Ys = Vt + HD * BK;       // [BQ][QS]
  float* Gs = Ys + BQ * QS;       // [BQ][QS]
  float* Pa = Gs + BQ * QS;       // [BQ][PS]  round(A)
  float* Pd = Pa + BQ * PS;       // [BQ][PS]  round(dLc)
  float* Hs = Pd + BQ * PS;       // [nh][HD]
  __shared__ float coef[MAX_KK];

  const int P = tm.P;
  const int r = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = blockIdx.y * BK;
  const int oc = blockIdx.z, nch = hd / HD;   // this block's 64 columns of dk, dv
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qcol = h * hd, kcol = kcol0 + h * hd, vcol = vcol0 + h * hd;
  const long long rh = (long long)r * H + h;
  const long long rhp = (long long)gridDim.x * P;

  if (kk > 0) epeg_coef<TM>(pw, h, kk, coef);
  if (nch == 1) load_keys<TM>(Y, ldy, kcol, vcol, tm, r, k0, Kt, nullptr, Vt);
  const float bias = (kk > 0 && pb != nullptr) ? pb[h] : 0.f;

  float s[4][4], da[4][4], dk[4][4], dv[4][4];
  zero44(dk);
  zero44(dv);

  for (int q0 = 0; q0 < P; q0 += BQ) {
    // the logits and dA over the whole head width, chunk by chunk; then
    // this block's chunk of the queries and of g for dk and dv
    zero44(s);
    zero44(da);
    for (int c = 0; c < nch; ++c) {
      __syncthreads();
      load_queries<TM>(Y, ldy, qcol + c * HD, G, ldg, qcol + c * HD, tm, r, q0, coef, kk,
                       Hs, Ys, Gs);
      if (nch > 1)
        load_keys<TM>(Y, ldy, kcol + c * HD, vcol + c * HD, tm, r, k0, Kt, nullptr, Vt);
      __syncthreads();
      tile_logits(Ys, Kt, tx, ty, s);
      tile_da(Gs, Vt, tx, ty, da);
    }
    if (oc != nch - 1) {
      __syncthreads();
      load_queries<TM>(Y, ldy, qcol + oc * HD, G, ldg, qcol + oc * HD, tm, r, q0, coef, kk,
                       Hs, Ys, Gs);
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
        Pa[(ty * 4 + i) * PS + tx * 4 + j] = round_to<TM>(a);
        Pd[(ty * 4 + i) * PS + tx * 4 + j] = round_to<TM>(dl);
      }
    }
    __syncthreads();
    for (int i = 0; i < BQ; ++i) {
      const float4 g4 = *reinterpret_cast<const float4*>(&Gs[i * QS + tx * 4]);
      const float4 y4 = *reinterpret_cast<const float4*>(&Ys[i * QS + tx * 4]);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float pa = Pa[i * PS + ty * 4 + a], pd = Pd[i * PS + ty * 4 + a];
        dv[a][0] = fmaf(pa, g4.x, dv[a][0]);
        dv[a][1] = fmaf(pa, g4.y, dv[a][1]);
        dv[a][2] = fmaf(pa, g4.z, dv[a][2]);
        dv[a][3] = fmaf(pa, g4.w, dv[a][3]);
        dk[a][0] = fmaf(pd, y4.x, dk[a][0]);
        dk[a][1] = fmaf(pd, y4.y, dk[a][1]);
        dk[a][2] = fmaf(pd, y4.z, dk[a][2]);
        dk[a][3] = fmaf(pd, y4.w, dk[a][3]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int p = k0 + ty * 4 + a;
    if (p >= P) continue;
    const long long row = token_of(tm, r, p) * ldd + oc * HD;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      D[row + kcol + tx * 4 + c] = from_f<TO>(dk[a][c]);
      D[row + vcol + tx * 4 + c] = from_f<TO>(dv[a][c]);
    }
  }
}

// (3) dq = scale * M_h^T round(dY): tap t of row i reads dY row i - t + k//2
template <typename TM, typename TO>
__global__ void __launch_bounds__(256)
attn_bwd_dq_kernel(const TM* __restrict__ dy, TO* __restrict__ D, int ldd, int H,
                   TokenMap tm, const float* __restrict__ pw, int kk, float scale) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float coef[MAX_KK];
  const int P = tm.P;
  const int r = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * BQ;
  const int pad = kk / 2, nh = BQ + kk - 1, h0 = q0 - (kk - 1 - pad);
  const long long rh = (long long)r * H + h;
  epeg_coef<TM>(pw, h, kk, coef);
  for (int idx = threadIdx.x; idx < nh * HD; idx += blockDim.x) {
    const int row = idx / HD, d = idx % HD, p = h0 + row;
    smem[idx] = (p >= 0 && p < P) ? to_f(dy[(rh * P + p) * HD + d]) : 0.f;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BQ * HD; idx += blockDim.x) {
    const int i = idx / HD, d = idx % HD, p = q0 + i;
    if (p >= P) continue;
    float acc = 0.f;
    for (int t = 0; t < kk; ++t) acc = fmaf(coef[t], smem[(i + kk - 1 - t) * HD + d], acc);
    D[token_of(tm, r, p) * ldd + h * HD + d] = from_f<TO>(scale * acc);
  }
}

// (4) dw[h, t] and db[h]: the partials of every (region, query tile), in order
__global__ void __launch_bounds__(256)
attn_bwd_dw_kernel(const float* __restrict__ part, int nb, int kk, int H,
                   float* __restrict__ dw, float* __restrict__ db) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= H * (kk + 1)) return;
  const int h = e / (kk + 1), t = e % (kk + 1);
  float acc = 0.f;
  for (int n = 0; n < nb; ++n) acc += part[((long long)h * nb + n) * (kk + 1) + t];
  if (t < kk) dw[h * kk + t] = acc;
  else if (db) db[h] = acc;
}

template <typename TM, typename TO>
cudaError_t launch_attention_bwd(const void* Y, int ldy, int kcol0, int vcol0,
                                 const void* G, int ldg, void* D, int ldd, int R, int H,
                                 int hd, TokenMap tm, const void* pw, int kk, const void* pb,
                                 float scale, void* stats, void* dy, void* part, void* dw,
                                 void* db, cudaStream_t stream) {
  const int nqt = (tm.P + BQ - 1) / BQ;
  const size_t sq = q_smem_bytes(kk), skv = kv_smem_bytes(kk);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_q_kernel<TM, TO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_kv_kernel<TM, TO>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)skv);
  if (err != cudaSuccess) return err;
  dim3 grid(R * H, nqt, hd / HD);
  attn_bwd_q_kernel<TM, TO><<<grid, 256, sq, stream>>>(
      (const TM*)Y, ldy, kcol0, vcol0, (const TM*)G, ldg, (TO*)D, ldd, H, hd, tm,
      (const float*)pw, kk, (const float*)pb, scale, (float*)stats, (TM*)dy,
      (float*)part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attn_bwd_kv_kernel<TM, TO><<<grid, 256, skv, stream>>>(
      (const TM*)Y, ldy, kcol0, vcol0, (const TM*)G, ldg, (TO*)D, ldd, H, hd, tm,
      (const float*)pw, kk, (const float*)pb, (const float*)stats);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (kk > 0) {
    attn_bwd_dq_kernel<TM, TO><<<dim3(R * H, nqt), 256, (size_t)(BQ + kk - 1) * HD * 4,
                                 stream>>>(
        (const TM*)dy, (TO*)D, ldd, H, tm, (const float*)pw, kk, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int n = H * (kk + 1);
    attn_bwd_dw_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
        (const float*)part, R * nqt, kk, H, (float*)dw, (float*)db);
  }
  return cudaGetLastError();
}

// partial column sums of round-free v = A * mask (per chunk of `rows` rows),
// and optionally v rounded to TM: part[s, n] = sum_{rows of chunk s} v[m, n]
template <typename TA, typename TM>
__global__ void __launch_bounds__(256)
colsum_kernel(const TA* __restrict__ A, int lda, long long M, int N,
              const uint8_t* __restrict__ rowmask, TM* __restrict__ rounded, int ldo,
              int rows, float* __restrict__ part) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const long long r0 = (long long)blockIdx.y * rows;
  const long long r1 = min(M, r0 + rows);
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
// writes its dls / dlb partials (part[w, c] and part[S + w, c]).
template <typename TS>
__global__ void __launch_bounds__(256)
ln_bwd_rows_kernel(const TS* __restrict__ x, const uint8_t* __restrict__ mask,
                   const float* __restrict__ ls, const float* __restrict__ dz,
                   const TS* __restrict__ g, TS* __restrict__ dx, float* __restrict__ part,
                   long long M, int C, float eps, int rpw) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const long long S = (M + rpw - 1) / rpw;
  if (w >= S) return;
  float pls[CPL], plb[CPL], vals[CPL], dzh[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) { pls[i] = 0.f; plb[i] = 0.f; }
  const long long t1 = min(M, (w + 1) * rpw);
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
  int M, N, K, kchunk; long long zstride; cudaStream_t stream;
};

template <typename TA, typename TB, typename TM, typename TO>
int gemm_tr(int at, int bt, const GemmArgs& g) {
  if (at && !bt)
    return (int)launch_gemm_ex<TA, TB, TM, TO, true, false>(
        g.A, g.lda, g.B, g.ldb, g.out, g.ldc, g.M, g.N, g.K, g.kchunk, g.zstride,
        g.stream);
  if (!at && bt)
    return (int)launch_gemm_ex<TA, TB, TM, TO, false, true>(
        g.A, g.lda, g.B, g.ldb, g.out, g.ldc, g.M, g.N, g.K, g.kchunk, g.zstride,
        g.stream);
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
// are float (a32 / b32) or of the mm dtype, out float (o32) or the mm dtype
extern "C" int rb_gemm(int tm, int a32, int b32, int o32, int at, int bt, const void* A,
                       int lda, const void* B, int ldb, void* out, int ldc, int M, int N,
                       int K, int kchunk, long long zstride, void* stream) {
  const GemmArgs g{A, lda, B, ldb, out, ldc, M, N, K, kchunk, zstride,
                   (cudaStream_t)stream};
  if (tm == 0) return gemm_tm<float>(a32, b32, o32, at, bt, g);
  if (tm == 1) return gemm_tm<bf16>(a32, b32, o32, at, bt, g);
  return (int)cudaErrorInvalidValue;
}

extern "C" int rb_colsum(int ta, int tm, const void* A, int lda, long long M, int N,
                         const void* rowmask, void* rounded, int ldo, int rows, void* part,
                         void* stream) {
  if (rows <= 0 || M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((N + 255) / 256, (unsigned)((M + rows - 1) / rows));
  RRT_DISPATCH(ta, TA, RRT_DISPATCH(tm, TM,
      colsum_kernel<TA, TM><<<grid, 256, 0, (cudaStream_t)stream>>>(
          (const TA*)A, lda, M, N, (const uint8_t*)rowmask, (TM*)rounded, ldo, rows,
          (float*)part)));
  return (int)cudaGetLastError();
}

extern "C" int rb_reduce(const void* part, int S, long long N, void* out, void* stream) {
  return (int)launch_reduce_rows(part, S, N, out, (cudaStream_t)stream);
}

extern "C" int rb_ln_bwd(int ts, const void* x, const void* mask, const void* ls,
                         const void* dz, const void* g, void* dx, void* part, long long M,
                         int C, float eps, int rpw, void* stream) {
  if (C > 32 * CPL || rpw <= 0) return (int)cudaErrorInvalidValue;
  const long long S = (M + rpw - 1) / rpw;
  const unsigned blocks = (unsigned)((S + 7) / 8);
  RRT_DISPATCH(ts, TS,
      ln_bwd_rows_kernel<TS><<<blocks, 256, 0, (cudaStream_t)stream>>>(
          (const TS*)x, (const uint8_t*)mask, (const float*)ls, (const float*)dz,
          (const TS*)g, (TS*)dx, (float*)part, M, C, eps, rpw));
  return (int)cudaGetLastError();
}

extern "C" int rb_attention_bwd(int tm, int to, const void* Y, int ldy, int kcol0,
                                int vcol0, const void* G, int ldg, void* D, int ldd, int R,
                                int H, int hd, int P, int grid, int rs, const void* pw,
                                int kk, const void* pb, float scale, void* stats, void* dy,
                                void* part, void* dw, void* db, void* stream) {
  if (hd <= 0 || hd % HD != 0 || hd > MAX_HD || kk < 0 || kk > MAX_KK || (kk > 0 && hd != HD))
    return (int)cudaErrorInvalidValue;
  if (kk > 0 && (pw == nullptr || dy == nullptr || part == nullptr || dw == nullptr))
    return (int)cudaErrorInvalidValue;
  TokenMap map{grid, rs, grid > 0 ? grid / rs : 0, P};
  cudaError_t err = cudaErrorInvalidValue;
  RRT_DISPATCH(tm, TM, RRT_DISPATCH(to, TO,
      err = launch_attention_bwd<TM, TO>(Y, ldy, kcol0, vcol0, G, ldg, D, ldd, R, H, hd, map,
                                         pw, kk, pb, scale, stats, dy, part, dw, db,
                                         (cudaStream_t)stream)));
  return (int)err;
}
