// K1: the whole R-MSA TransLayer forward, as a pipeline of three steps.
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
// What this first design does about it: it keeps the TPU kernel's
// rounding points and splits the layer where a Hopper block's 227 KB of
// shared memory ends.  (a) rl_ln_mask writes z = round(mask * LN(x)) in
// token order, and rl_gemm runs z @ Wqkv + b as one 128x128-tiled product
// (region order does not matter to a per-token product).  (b)
// rl_attention gathers each region's rows through the partition map, does
// the k-tap EPEG pass on q and a two-pass softmax over 64-key tiles, so
// P up to 784 never needs a P x P tile, and writes the head outputs back in
// token order (the reverse).  (c) rl_gemm again: o @ Wp + bp, times the
// mask, plus the residual, in the stream dtype.  The products run on the
// CUDA cores in fp32; tensor cores (wgmma) and fusing (a)-(c) are later
// work, recorded in PERF.md.
//
// K5 (rrtmil_tpu/ops/pallas/region_block.py::_block_fwd_pallas, the whole
// InnerAttention on contiguous regions (R, P, C)) runs on the same three
// entries: rl_gemm rounds x to the mm dtype as it loads it (the TPU kernel's
// z = x.astype(mm)), rl_attention with grid = 0 takes the identity token map
// (row r * P + p), and rl_gemm projects back into x's dtype with no mask or
// residual.  On the c16_r50 path K5 is the cross-region attention over
// (B*k, 64, 512), ~0.14 GFLOP a slide: bound by reading its ~2.4 MB of
// weights and by launch latency, not by FLOPs.  In the unfused R-MSA
// structure (kk = 15, P = 144) it is bound by its products, like K1.
//
// K6 (rrtmil_tpu/ops/pallas/region_attn.py::_fused_fwd_pallas, the
// attention core alone on (R, H, P, hd)) is rl_attention itself: the wrapper
// packs round(q * scale), k and v as the columns of one (R * P, 3 * H * hd)
// matrix, and the core writes the head outputs in q's dtype (`to`).  On the
// c16_r50 train path it runs inside K5's backward at (B, 8, 64, 64), where
// launch latency, not bytes or FLOPs, bounds it.
#include "common.cuh"

using namespace rrt;

extern "C" int rl_ln_mask(int ts, int tm, const void* x, const void* mask,
                          const void* ls, const void* lb, void* z, long long M,
                          int C, float eps, void* stream) {
  if (C > 32 * CPL) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((M + 7) / 8);
  RRT_DISPATCH(ts, TS, RRT_DISPATCH(tm, TM,
      ln_mask_kernel<TS, TM><<<blocks, 256, 0, (cudaStream_t)stream>>>(
          (const TS*)x, (const uint8_t*)mask, (const float*)ls,
          (const float*)lb, (TM*)z, M, C, eps)));
  return (int)cudaGetLastError();
}

extern "C" int rl_gemm(int ta, int tm, int to, const void* A, int lda,
                       const void* B, int ldb, void* out, int ldc, int M, int N,
                       int K, const void* bias, const void* rowmask,
                       const void* resid, int ldr, void* stream) {
  cudaError_t err = cudaErrorInvalidValue;
  RRT_DISPATCH(ta, TA, RRT_DISPATCH(tm, TM, RRT_DISPATCH(to, TO,
      err = launch_gemm<TA, TM, TO>(A, lda, B, ldb, out, ldc, M, N, K, bias,
                                    rowmask, resid, ldr,
                                    (cudaStream_t)stream))));
  return (int)err;
}

extern "C" int rl_attention(int tm, int to, const void* Y, int ldy, int kcol0,
                            int vcol0, void* O, int ldo, int R, int H, int hd,
                            int P, int grid, int rs, const void* pw, int kk,
                            const void* pb, void* stream) {
  if (hd != 64 || kk < 0 || kk > MAX_KK) return (int)cudaErrorInvalidValue;
  TokenMap map{grid, rs, grid > 0 ? grid / rs : 0, P};
  cudaError_t err = cudaErrorInvalidValue;
  RRT_DISPATCH(tm, TM, RRT_DISPATCH(to, TO,
      err = launch_attention<TM, TO>(Y, ldy, kcol0, vcol0, O, ldo, R, H, map, pw,
                                     kk, pb, (cudaStream_t)stream)));
  return (int)err;
}
