// K1: the whole R-MSA TransLayer forward, as a pipeline of three steps;
// K5 and K6 run on the same entries.
//
// Replaces rrtmil_tpu/ops/pallas/region_layer.py::_layer_fwd_pallas
// (kernel body _layer_kernel): LayerNorm -> mask -> region partition ->
// per-head qkv -> (I + T_h) q EPEG -> + pe_bias -> softmax -> AV -> out-proj
// -> region reverse -> mask -> + x.
//
// What bounds it on an H100: the products.  At the c16_r50 shape (G = 96,
// P = 144, C = 512, 8 heads of 64) a slide is ~22 GFLOP against ~40 MB of
// stream traffic, far above the card's ~295 FLOP/byte ridge; the qkv and
// output projections are 87% of the FLOPs.
//
// Design: it keeps the TPU kernel's rounding points and splits the layer
// where a Hopper block's 227 KB of shared memory ends.  (a) rl_ln_mask
// writes z = round(mask * LN(x)) in token order, and rl_gemm runs
// z @ Wqkv + b (region order does not matter to a per-token product).  (b)
// rl_attention gathers each region's rows through the partition map, does
// the k-tap EPEG pass on q and a two-pass softmax over 64-key tiles, so
// P up to 961 never needs a P x P tile, and writes the head outputs back in
// token order (the reverse).  (c) rl_gemm again: o @ Wp + bp, times the
// mask, plus the residual, in the stream dtype.  With bf16 products the
// product and the core run on the tensor cores (mma.sync, tc.cuh); with f32
// products on the CUDA cores in fp32 (common.cuh), for strict parity.
// Warpgroup products fed by TMA, and fusing (a)-(c), are later work.
//
// K5 (rrtmil_tpu/ops/pallas/region_block.py::_block_fwd_pallas, the whole
// InnerAttention on regions (R, P, C)) is rl_block: the same three steps in
// one call, reading x and the weights where they lie (x may be a strided
// view; wq/wk/wv and wp are views of the Linear weights), rounding x to the
// mm dtype as it loads it (the TPU kernel's z = x.astype(mm)), the core on
// the identity token map, the projection back into x's dtype.  On the
// c16_r50 path K5 is the cross-region attention over (B*k, 64, 512),
// ~0.14 GFLOP a slide: bound by reading its ~2.4 MB of weights and by
// launch latency, not by FLOPs; at brca_r50 it runs one 512-wide head.
//
// Folds (fold-parallel cross-validation): every entry takes a fold axis in
// one launch.  The rows (rl_ln_mask, rl_gemm) or regions (rl_attention,
// rl_block) fall into equal folds, and fold f reads weights of its own, f
// fold strides past fold 0's; no tile or block straddles two folds.  One
// fold (rows_f, rf = 0, Mf = M, strides 0) is the kernel as it was, bit for
// bit.
//
// K6 (rrtmil_tpu/ops/pallas/region_attn.py::_fused_fwd_pallas, the
// attention core alone on (R, H, P, hd)) is rl_attention itself on q, k, v
// and o as they lie, q scaled and rounded as it loads.  On the c16_r50
// train path it runs inside K5's backward at (B, 8, 64, 64), where launch
// latency and host time, not bytes or FLOPs, bound it.
#include "tc.cuh"

using namespace rrt;

// rows_f > 0: row t takes fold t / rows_f's LayerNorm (ls, lb (F, C))
extern "C" int rl_ln_mask(int ts, int tm, const void* x, const void* mask,
                          const void* ls, const void* lb, void* z, long long M,
                          int C, float eps, long long rows_f, void* stream) {
  if (rows_f == 0) rows_f = M;
  if (C > 32 * CPL || rows_f < 0 || M % rows_f != 0) return (int)cudaErrorInvalidValue;
  const dim3 blocks((unsigned)((rows_f + 7) / 8), (unsigned)(M / rows_f));
  RRT_DISPATCH(ts, TS, RRT_DISPATCH(tm, TM,
      ln_mask_kernel<TS, TM><<<blocks, 256, 0, (cudaStream_t)stream>>>(
          (const TS*)x, (const uint8_t*)mask, (const float*)ls,
          (const float*)lb, (TM*)z, rows_f, C, eps)));
  return (int)cudaGetLastError();
}

// out (M, N) row-major = A B (+ bias) (* rowmask) (+ resid): A row m at
// A + (m / aP) * a_sr + (m % aP) * a_sp; B in up to three column blocks of
// nper columns at B0, B1, B2, element (k, n) of each at (k / kdiv) * sk1 +
// (k % kdiv) * sk0 + (n / ndiv) * sn1 + (n % ndiv) * sn0; the bias in the
// same blocks (contiguous float32, or null).  Folds: rows of Mf each (Mf =
// M for one), fold f's B and bias b_fs and bias_fs elements past fold 0's.
extern "C" int rl_gemm(int ta, int tb, int tm, int to, const void* A, int aP,
                       long long a_sr, long long a_sp, const void* B0,
                       const void* B1, const void* B2, int nper, int kdiv,
                       long long sk1, long long sk0, int ndiv, long long sn1,
                       long long sn0, void* out, int ldc, int M, int N, int K,
                       const void* bias0, const void* bias1,
                       const void* bias2, const void* rowmask,
                       const void* resid, int ldr, int Mf, long long b_fs,
                       long long bias_fs, void* stream) {
  const RowsA a{A, aP, a_sr, a_sp};
  const Thirds b{{B0, B1, B2}, nper, kdiv, ndiv, sk1, sk0, sn1, sn0, b_fs};
  const Bias3 bias{{(const float*)bias0, (const float*)bias1, (const float*)bias2}, nper,
                   bias_fs};
  cudaError_t err = cudaErrorInvalidValue;
  RRT_DISPATCH(ta, TA, RRT_DISPATCH(tb, TB, RRT_DISPATCH(tm, TM, RRT_DISPATCH(to, TO,
      err = launch_gemm<TA, TB, TM, TO>(a, b, out, ldc, M, N, K, bias, rowmask,
                                        resid, ldr, (cudaStream_t)stream, Mf)))));
  return (int)err;
}

// the attention core on q, k, v (dtype ti) and o (dtype to), each described
// by (base, region stride, head stride, token-row stride); grid > 0 maps
// region r, token p to row token_of(r, p) of K1's (B, G*G) stream; rf > 0:
// region r takes fold r / rf's EPEG taps pw (F, H, kk) and bias pb (F, H)
extern "C" int rl_attention(int ti, int tm, int to, const void* q,
                            long long q_sr, long long q_sh, long long q_sp,
                            const void* k, long long k_sr, long long k_sh,
                            long long k_sp, const void* v, long long v_sr,
                            long long v_sh, long long v_sp, void* o,
                            long long o_sr, long long o_sh, long long o_sp,
                            int R, int H, int hd, int P, int grid, int rs,
                            float scale, const void* pw, int kk,
                            const void* pb, int rf, void* stream) {
  if (rf < 0 || (rf > 0 && R % rf != 0)) return (int)cudaErrorInvalidValue;
  const TokenMap map{grid, rs, grid > 0 ? grid / rs : 0, P, rf};
  const Opnd oq{q, q_sr, q_sh, q_sp}, ok{k, k_sr, k_sh, k_sp},
      ov{v, v_sr, v_sh, v_sp}, oo{o, o_sr, o_sh, o_sp};
  cudaError_t err = cudaErrorInvalidValue;
  RRT_DISPATCH(ti, TI, RRT_DISPATCH(tm, TM, RRT_DISPATCH(to, TO,
      err = launch_attention<TI, TM, TO>(oq, ok, ov, oo, R, H, hd, map, scale,
                                         pw, kk, pb, (cudaStream_t)stream))));
  return (int)err;
}

// K5 in one call: y = round(x) Wqkv + b (the mm dtype), o = attention(y),
// out = o Wp + bp (x's dtype).  x (R, P, C) at x + r * x_sr + p * x_sp;
// wq / wk / wv read as (C, H * hd) blocks and wp as (H * hd, C), each by its
// (kdiv, sk1, sk0, ndiv, sn1, sn0) as in rl_gemm; biases contiguous
// float32; y (R * P, 3 * H * hd) and o (R * P, H * hd) scratch in the mm
// dtype; out (R * P, C) contiguous.  Folds of rf regions (0: one fold):
// fold f's weights are w_fs (wq, wk, wv), b_fs (bq, bk, bv), p_fs (wp) and
// bp_fs (bp) elements past fold 0's, its taps pw (F, H, kk), pb (F, H)
extern "C" int rl_block(int ts, int tw, int tm, const void* x, long long x_sr,
                        long long x_sp, const void* wq, const void* wk,
                        const void* wv, int w_kdiv, long long w_sk1,
                        long long w_sk0, int w_ndiv, long long w_sn1,
                        long long w_sn0, const void* bq, const void* bk,
                        const void* bv, const void* pw, int kk, const void* pb,
                        const void* wp, int p_kdiv, long long p_sk1,
                        long long p_sk0, int p_ndiv, long long p_sn1,
                        long long p_sn0, const void* bp, void* y, void* o,
                        void* out, int R, int P, int C, int H, int hd, int rf,
                        long long w_fs, long long b_fs, long long p_fs,
                        long long bp_fs, void* stream) {
  if (rf < 0 || (rf > 0 && R % rf != 0)) return (int)cudaErrorInvalidValue;
  const int M = R * P, hh = H * hd, n = 3 * hh, Mf = (rf > 0 ? rf : R) * P;
  const cudaStream_t st = (cudaStream_t)stream;
  const RowsA xa{x, P, x_sr, x_sp};
  const Thirds wqkv{{wq, wk, wv}, hh, w_kdiv, w_ndiv, w_sk1, w_sk0, w_sn1, w_sn0, w_fs};
  const Bias3 bqkv{{(const float*)bq, (const float*)bk, (const float*)bv}, hh, b_fs};
  const TokenMap map{0, 1, 0, P, rf};
  const RowsA oa{o, 1, hh, 0};
  const Thirds wpb{{wp, nullptr, nullptr}, C, p_kdiv, p_ndiv, p_sk1, p_sk0, p_sn1, p_sn0, p_fs};
  const Bias3 bpb{{(const float*)bp, nullptr, nullptr}, C, bp_fs};
  const long long ry = (long long)P * n, ro = (long long)P * hh;
  cudaError_t err = cudaErrorInvalidValue;
  RRT_DISPATCH(ts, TS, RRT_DISPATCH(tw, TW, RRT_DISPATCH(tm, TM,
      err = launch_gemm<TS, TW, TM, TM>(xa, wqkv, y, n, M, n, C, bqkv, nullptr,
                                        nullptr, 0, st, Mf);
      if (err == cudaSuccess) {
        const TM* yy = (const TM*)y;
        err = launch_attention<TM, TM, TM>(
            Opnd{yy, ry, hd, n}, Opnd{yy + hh, ry, hd, n},
            Opnd{yy + 2 * hh, ry, hd, n}, Opnd{o, ro, hd, hh}, R, H, hd, map,
            1.f, pw, kk, pb, st);
      }
      if (err == cudaSuccess)
        err = launch_gemm<TM, TW, TM, TS>(oa, wpb, out, C, M, C, hh, bpb,
                                          nullptr, nullptr, 0, st, Mf))));
  return (int)err;
}
