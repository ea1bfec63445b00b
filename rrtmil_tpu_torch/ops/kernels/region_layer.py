"""K1 and K2: the whole R-MSA TransLayer, forward and backward, as CUDA
kernels.

K1 replaces `rrtmil_tpu/ops/pallas/region_layer.py::_layer_fwd_pallas`
(kernel body `_layer_kernel`, pallas_call at region_layer.py:231):

    LN (eps 1e-6, fast variance) -> mask -> region partition -> per-head
    qkv (scale folded into wq/bq) -> (I + T_h) q EPEG -> + pe_bias ->
    softmax -> AV -> out-proj -> region reverse -> mask -> + x

on the (B, G*G, C) stream, in x's dtype.  The CUDA source is
`csrc/region_layer.cu` (a three-step pipeline: LN + qkv product, attention
core, projection + residual; with bf16 products the product and the core
run on the tensor cores, `csrc/tc.cuh`), reading the weights where they lie.
Head widths: 64 in every canonical config; `--n_heads` 16 and 4 give 32 and
128, which the cores take with EPEG as without (any multiple of 32 up to 512
without it).

K2 replaces `region_layer.py::_layer_bwd_pallas` (kernel body
`_layer_bwd_kernel`, pallas_call at region_layer.py:554): from x, the
weights and g = d(out) it recomputes the layer and returns the gradients of
(x, ln_s, ln_b, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp), rounding where the
TPU kernel rounds (z, the qkv, the Toeplitz matrix, o, g * mask, d(o),
d(logits), d(qkv)).  Its CUDA source is `csrc/region_layer_bwd.cu`, with
K1's entries for the recompute; with bf16 products its four products (the
weight gradients o^T gm, z^T round(dqkv) and the data gradients gm Wp^T,
round(dqkv) Wqkv^T, `k2_product`) run on the warpgroup tensor cores
(`csrc/wgmma.cuh`).  The notes in both sources say what bounds
the kernels on an H100 and what the design does about it.

`region_layer_fused` is a `torch.autograd.Function` whose forward is K1 and
backward K2; on a CPU tensor both directions run the plain versions.  The
gradients of wq and bq are those of the pre-scaled tensors the caller
passed; autograd carries them through the caller's scaling.

Folds (`folds.py`): under `torch.func.vmap` the weights arrive stacked on a
leading fold axis (ln_s (K, C), wq (K, H, C, hd), ...) and x, mask with
each fold's bags in turn along the batch axis.  K1 and K2 then run once for
all K folds: each of their launches takes the rows a fold (B * G * G), and
K2 sums each fold's weight gradients over that fold's rows alone (its
split-K partials, column sums and LayerNorm partials never straddle two
folds), in the same fixed order as one fold's, into (K, ...) gradients.
"""
from __future__ import annotations

import torch

from ..regions import region_partition, region_reverse
from . import build, layout
from .common import LN_EPS, ln_bwd_plain, ln_mask_plain, ln_stats, mm_round
from .folds import (ROWS, WEIGHT, FoldFunction, fold_plain, folds,
                    vmap_rule)
from .region_attn import attention_core_plain, check_heads
from .region_attn_bwd import attention_bwd_core_plain, attention_bwd_launch
from .region_block import block_core_plain, qkv_args, qkv_weights

COLSUM_ROWS = 256    # rows of one partial column sum
LN_ROWS_PER_WARP = 32
SMS = 132            # streaming multiprocessors of an H100 SXM
TC_TILE = 128        # output tile side of the tensor-core product (wgmma.cuh)
TC_STEP = 64         # token rows one k step of it reads
TC_MIN_STEPS = 4     # k steps a chunk of the token split takes at least


def region_layer_plain(x, mask, ln_s, ln_b, wq, wk, wv, bq, bk, bv, pw, pb,
                       wp, bp, grid_side: int, region_size: int,
                       add_residual: bool,
                       mm_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K1 (same rounding points, fp32 sums)."""
    b, n, c = x.shape
    g, rs = grid_side, region_size
    xf = x.float()
    z = mm_round(ln_mask_plain(x, mask, ln_s, ln_b), mm_dtype)
    regions = region_partition(z.reshape(b, g, g, c), rs)
    y = block_core_plain(regions, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp,
                         mm_dtype)
    out = region_reverse(y, rs, g, g) * mask.float()[..., None]
    if add_residual:
        out = xf + out
    return out.to(x.dtype)


def region_layer_bwd_plain(x, mask, ln_s, ln_b, wq, wk, wv, bq, bk, bv, pw,
                           pb, wp, bp, g, grid_side: int, region_size: int,
                           add_residual: bool, mm_dtype=torch.bfloat16):
    """Plain PyTorch version of K2: the gradients of (x, ln_s, ln_b, wq, wk,
    wv, bq, bk, bv, pw, pb, wp, bp) given g = d(out); pw's and pb's are None
    when they are."""
    mmd = mm_dtype
    b, n, c = x.shape
    gs, rs = grid_side, region_size
    mf = mask.float()[..., None]
    zhat, rstd = ln_stats(x.float())
    z = mm_round((zhat * ln_s.float() + ln_b.float()) * mf, mmd)
    zr = region_partition(z.reshape(b, gs, gs, c), rs)          # (R, P, C)

    def heads(w, bb):
        y = torch.einsum("rpc,hcd->rhpd", zr, mm_round(w, mmd))
        return mm_round(y + bb.float()[None, :, None, :], mmd)

    q, k, v = heads(wq, bq), heads(wk, bk), heads(wv, bv)
    o = mm_round(attention_core_plain(q, k, v, pw, pb, mmd), mmd)
    gf = g.float()
    gm = gf * mf
    gr = region_partition(mm_round(gm, mmd).reshape(b, gs, gs, c), rs)
    dwp = torch.einsum("rhpd,rpc->hdc", o, gr)
    dbp = gm.reshape(-1, c).sum(0)
    g_o = mm_round(torch.einsum("rpc,hdc->rhpd", gr, mm_round(wp, mmd)), mmd)
    dq, dk, dv, dpw, dpb = attention_bwd_core_plain(q, k, v, g_o, pw, pb, mmd)
    grads, dzr = [], 0.0
    for d, w in ((dq, wq), (dk, wk), (dv, wv)):
        dm = mm_round(d, mmd)
        grads.append(torch.einsum("rpc,rhpd->hcd", zr, dm))
        dzr = dzr + torch.einsum("rhpd,hcd->rpc", dm, mm_round(w, mmd))
    dz = region_reverse(dzr, rs, gs, gs)
    dx, dls, dlb = ln_bwd_plain(dz * mf, zhat, rstd, ln_s)
    if add_residual:
        dx = dx + gf
    return (dx.to(x.dtype), dls, dlb, *grads, dq.sum((0, 2)), dk.sum((0, 2)),
            dv.sum((0, 2)), dpw, dpb, dwp, dbp)


def check_grid(x: torch.Tensor, mask: torch.Tensor, grid_side: int,
               region_size: int) -> None:
    b, n, c = x.shape
    if n != grid_side * grid_side or grid_side % region_size != 0:
        raise ValueError(f"stream of {n} tokens is not a {grid_side}^2 grid "
                         f"of {region_size}-wide regions")
    if mask.shape != (b, n) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool {(b, n)}")
    if c > 1024:
        raise ValueError(f"the row kernels take C <= 1024, not {c}")


def _params(ln_s, ln_b, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp):
    return dict(ln_s=ln_s, ln_b=ln_b, wq=wq, wk=wk, wv=wv, bq=bq, bk=bk,
                bv=bv, pw=pw, pb=pb, wp=wp, bp=bp)


# the fold forms (folds.py) of the Function's inputs, and of K2's
_LAYER_KINDS = (ROWS, ROWS) + (WEIGHT,) * 12 + (None,) * 4
_BWD_KINDS = _LAYER_KINDS[:14] + (ROWS,) + (None,) * 4
_BWD_OUT = (ROWS,) + (WEIGHT,) * 12


def _fs(t, nf: int) -> int:
    """The fold stride of a stacked weight (0 without folds)."""
    return t.stride(0) if nf else 0


def _fold0(t, nf: int):
    """Fold 0's weight (its layout is every fold's), or t itself."""
    return t[0] if nf and t is not None else t


def _recompute(lib, x, mask, ln_s, ln_b, wq, wk, wv, bq, bk, bv, pw, pb, gs,
               rs, mmd, s, nf: int = 0):
    """K1's first two steps: z = round(mask * LN(x)), the qkv matrix y and
    the head outputs o, all in the mm dtype and token order; with nf folds
    each fold's rows read its own weights."""
    b, n, c = x.shape
    h, _, hd = wq.shape[-3:]
    kk = check_heads(wq, _fold0(pw, nf))
    ts, tm = build.dtype_code(x.dtype), build.dtype_code(mmd)
    m, nq, hh = b * n, 3 * h * hd, h * hd
    rows_f, regions = (m // nf if nf else 0), b * (gs // rs) ** 2
    z = torch.empty((m, c), dtype=mmd, device=x.device)
    build.check(lib.rl_ln_mask(ts, tm, x.data_ptr(), mask.data_ptr(),
                               build.f32_param(ln_s, "ln_s"),
                               build.f32_param(ln_b, "ln_b"), z.data_ptr(), m,
                               c, LN_EPS, rows_f, s), "K1 layernorm")
    wptr, wdesc, bptr = qkv_args(*(_fold0(t, nf)
                                   for t in (wq, wk, wv, bq, bk, bv)))
    y = torch.empty((m, nq), dtype=mmd, device=x.device)
    build.check(lib.rl_gemm(tm, build.dtype_code(wq.dtype), tm, tm,
                            z.data_ptr(), 1, c, 0, *wptr, hh, *wdesc,
                            y.data_ptr(), nq, m, nq, c, *bptr, None, None, 0,
                            rows_f, _fs(wq, nf), _fs(bq, nf), s), "K1 qkv")
    o = torch.empty((m, hh), dtype=mmd, device=x.device)
    yp, esz = y.data_ptr(), y.element_size()
    build.check(lib.rl_attention(tm, tm, tm, yp, 0, hd, nq, yp + hh * esz, 0,
                                 hd, nq, yp + 2 * hh * esz, 0, hd, nq,
                                 o.data_ptr(), 0, hd, hh, regions,
                                 h, hd, rs * rs, gs, rs, 1.0,
                                 build.f32_param(pw, "pe_weight") if kk
                                 else None, kk,
                                 build.f32_param(pb, "pe_bias") if kk
                                 else None, regions // nf if nf else 0, s),
                "K1 attention")
    return z, y, o


def _launch(x, mask, ln_s, ln_b, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp,
            g, rs, add_residual, mmd):
    b, n, c = x.shape
    h, _, hd = wq.shape[-3:]
    nf = folds(ln_s, 1)
    check_grid(x, mask, g, rs)
    build.require_cuda({"x": x, "mask": mask},
                       _params(ln_s, ln_b, wq, wk, wv, bq, bk, bv, pw, pb, wp,
                               bp))
    lib = build.load("region_layer")
    s = build.stream_of(x)
    ts, tm = build.dtype_code(x.dtype), build.dtype_code(mmd)
    m, hh = b * n, h * hd
    _, _, o = _recompute(lib, x, mask, ln_s, ln_b, wq, wk, wv, bq, bk, bv, pw,
                         pb, g, rs, mmd, s, nf)
    out = torch.empty_like(x)
    build.check(lib.rl_gemm(tm, build.dtype_code(wp.dtype), tm, ts,
                            o.data_ptr(), 1, hh, 0, wp.data_ptr(), None, None,
                            c, *layout.proj_rows(_fold0(wp, nf)),
                            out.data_ptr(), c, m, c, hh,
                            build.f32_param(bp, "bp"), None, None,
                            mask.data_ptr(),
                            x.data_ptr() if add_residual else None, c,
                            m // nf if nf else 0, _fs(wp, nf), _fs(bp, nf), s),
                "K1 projection")
    region_layer_fused.launches += 1
    return out


def _split(m: int, tiles: int) -> int:
    """Rows of the token axis per partial product of the SIMT product (f32
    products): enough partials to give the card ~2 blocks an SM, none
    shorter than 256 rows; a multiple of 8."""
    chunks = max(1, min(-(-2 * SMS // tiles), -(-m // 256)))
    rows = -(-m // chunks)
    return -(-rows // 8) * 8


def token_split(m: int, tiles: int, sms: int = SMS) -> int:
    """Rows of the token axis per chunk of a weight gradient on the tensor
    cores (one block of 128 x 128 outputs an SM, `tiles` of them): the
    chunk count that minimises waves x (k steps a block + 2 for its
    partial's store), at most four waves, no chunk under TC_MIN_STEPS k
    steps; a multiple of TC_STEP, so no k step crosses two chunks."""
    steps = -(-m // TC_STEP)
    most = max(1, steps // TC_MIN_STEPS)
    best, best_cost = 1, None
    for chunks in range(1, min(most, max(1, 4 * sms // tiles)) + 1):
        cost = -(-tiles * chunks // sms) * (-(-steps // chunks) + 2)
        if best_cost is None or cost < best_cost:
            best, best_cost = chunks, cost
    return -(-steps // best) * TC_STEP


def _gemm(lib, tm, a, lda, b, ldb, out, ldc, m, n, k, *, at=False, bt=False,
          s=None, nf=0):
    """out = round(A) round(B) (A^T with at, B^T with bt); with at the token
    axis k is split into partials that are summed in order into `out`.
    bf16 products run on the tensor cores and read A and B as they are
    (bf16), f32 products on the SIMT product.  With nf folds: at, out (nf,
    m, n) holds each fold's own sum over its k / nf token rows; bt, the m
    rows fall into nf folds, each times its B (b (nf, n, k) contiguous)."""
    f = max(nf, 1)
    b_fs = b.stride(0) if nf and bt else 0
    if tm == 1:
        _gemm_tc(lib, a, lda, b, ldb, out, ldc, m, n, k, at, s, f, b_fs)
        return
    a32 = int(a.dtype == torch.float32)
    b32 = int(b.dtype == torch.float32)
    o32 = int(out.dtype == torch.float32)
    if not at:
        kchunk = -(-k // 8) * 8
        build.check(lib.rb_gemm(tm, a32, b32, o32, 0, int(bt), a.data_ptr(),
                                lda, b.data_ptr(), ldb, out.data_ptr(), ldc,
                                m, n, k, kchunk, 0, f, b_fs, s), "K2 product")
        return
    kchunk = _split(k // f, -(-m // 128) * -(-n // 128))
    parts = -(-(k // f) // kchunk)
    part = torch.empty((f * parts, m, n), dtype=torch.float32,
                       device=a.device)
    build.check(lib.rb_gemm(tm, a32, b32, 1, 1, int(bt), a.data_ptr(), lda,
                            b.data_ptr(), ldb, part.data_ptr(), n, m, n, k,
                            kchunk, m * n, f, 0, s), "K2 weight product")
    build.check(lib.rb_reduce(part.data_ptr(), parts, m * n, out.data_ptr(),
                              f, s), "K2 reduce")


def _gemm_tc(lib, a, lda, b, ldb, out, ldc, m, n, k, at, s, f=1, b_fs=0):
    """The bf16 product on the warpgroup tensor cores: A^T B (at: A (k, m),
    B (k, n), split along the token axis k) or A B^T (A (m, k), B (n, k));
    f folds as `_gemm`'s."""
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"the tensor-core product reads bfloat16 operands, "
                        f"not {a.dtype} and {b.dtype}")
    o32 = int(out.dtype == torch.float32)
    if not at:
        build.check(lib.rb_gemm_tc(0, o32, a.data_ptr(), lda, b.data_ptr(),
                                   ldb, out.data_ptr(), ldc, m, n, k,
                                   -(-k // TC_STEP) * TC_STEP, 0, f, b_fs, s),
                    "K2 product")
        return
    kchunk = token_split(k // f, -(-m // TC_TILE) * -(-n // TC_TILE))
    parts = -(-(k // f) // kchunk)
    part = out if parts == 1 else torch.empty((f * parts, m, n),
                                              dtype=torch.float32,
                                              device=a.device)
    build.check(lib.rb_gemm_tc(1, 1, a.data_ptr(), lda, b.data_ptr(), ldb,
                               part.data_ptr(), n if parts > 1 else ldc, m,
                               n, k, kchunk, m * n, f, 0, s),
                "K2 weight product")
    if parts > 1:
        build.check(lib.rb_reduce(part.data_ptr(), parts, m * n,
                                  out.data_ptr(), f, s), "K2 reduce")


def k2_product_plain(a, b, at: bool, out_dtype=torch.float32,
                     mm_dtype=torch.bfloat16):
    """Plain PyTorch version of K2's products: round(a)^T round(b) (at) or
    round(a) round(b)^T in float32, stored as out_dtype."""
    a, b = mm_round(a, mm_dtype).float(), mm_round(b, mm_dtype).float()
    return (a.t() @ b if at else a @ b.t()).to(out_dtype)


def k2_product(a, b, at: bool, out_dtype=torch.float32,
               mm_dtype=torch.bfloat16):
    """One of K2's products on its own (the wrapper of the kernels its
    backward launches): a^T b with at (a (m, M), b (m, N): a weight
    gradient, summed over the m tokens in chunks added in order), else
    a b^T (a (M, K), b (N, K): a data gradient); operands rounded to
    mm_dtype, fp32 sums, out_dtype out.  Contiguous operands; with bf16
    products they must be bf16 already (the tensor cores read them as they
    lie).  On CPU tensors the plain version."""
    if a.device.type == "cpu":
        return k2_product_plain(a, b, at, out_dtype, mm_dtype)
    build.require_cuda({"a": a, "b": b}, {})
    lib = build.load("region_layer_bwd")
    if at:
        (k, m), n = a.shape, b.shape[1]
    else:
        (m, k), n = a.shape, b.shape[0]
    if (b.shape[0] if at else b.shape[1]) != k:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} do not "
                         f"share the summed axis")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    _gemm(lib, build.dtype_code(mm_dtype), a, a.shape[1], b, b.shape[1], out,
          n, m, n, k, at=at, bt=not at, s=build.stream_of(a))
    return out


def _cols(t, ld, col, hd):
    """The attention operand at columns col .. of a token-row matrix t with
    row stride ld, head h at col + h * hd: (pointer, region, head,
    token-row strides); the token map locates the rows."""
    return (t.data_ptr() + col * t.element_size(), 0, hd, ld)


def _colsum(lib, tm, a, m, n, mask, rounded, s, nf=0):
    """sum over rows of a * mask (float32), and round(a * mask) into
    `rounded` when given; with nf folds each fold's own sum, (nf, n)."""
    f = max(nf, 1)
    parts = -(-(m // f) // COLSUM_ROWS)
    part = torch.empty((f * parts, n), dtype=torch.float32, device=a.device)
    build.check(lib.rb_colsum(build.dtype_code(a.dtype), tm, a.data_ptr(), n,
                              m, n, build.ptr(mask), build.ptr(rounded), n,
                              COLSUM_ROWS, part.data_ptr(), m // f, s),
                "K2 colsum")
    out = torch.empty((f, n) if nf else (n,), dtype=torch.float32,
                      device=a.device)
    build.check(lib.rb_reduce(part.data_ptr(), parts, n, out.data_ptr(), f,
                              s), "K2 reduce")
    return out


def _launch_bwd(x, mask, ln_s, ln_b, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp,
                g, gs, rs, add_residual, mmd):
    b, n, c = x.shape
    h, _, hd = wq.shape[-3:]
    nf = folds(ln_s, 1)
    lead = (nf,) if nf else ()
    check_grid(x, mask, gs, rs)
    if g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} does not match x")
    g = g.to(x.dtype).contiguous()
    build.require_cuda({"x": x, "mask": mask, "g": g},
                       _params(ln_s, ln_b, wq, wk, wv, bq, bk, bv, pw, pb, wp,
                               bp))
    rl = build.load("region_layer")
    rb = build.load("region_layer_bwd")
    s = build.stream_of(x)
    tm = build.dtype_code(mmd)
    m, nq, hh = b * n, 3 * h * hd, h * hd
    kk = check_heads(wq, _fold0(pw, nf))
    f32 = dict(dtype=torch.float32, device=x.device)
    z, y, o = _recompute(rl, x, mask, ln_s, ln_b, wq, wk, wv, bq, bk, bv, pw,
                         pb, gs, rs, mmd, s, nf)
    wqkv, _ = qkv_weights(wq, wk, wv, bq, bk, bv, mmd)
    # gm = round(g * mask), dbp = sum g * mask
    gmm = torch.empty((m, c), dtype=mmd, device=x.device)
    dbp = _colsum(rb, tm, g, m, c, mask, gmm, s, nf)
    # dWp = o^T gm, d(o) = round(gm Wp^T)
    dwp = torch.empty((*lead, hh, c), **f32)
    _gemm(rb, tm, o, hh, gmm, c, dwp, c, hh, c, m, at=True, s=s, nf=nf)
    wp2 = wp.reshape(*lead, hh, c).to(mmd).contiguous()
    go = torch.empty((m, hh), dtype=mmd, device=x.device)
    _gemm(rb, tm, gmm, c, wp2, c, go, hh, m, hh, c, bt=True, s=s, nf=nf)
    # the attention core's backward, on the token map: q, k, v are the
    # column blocks (0, hh, 2 hh) of the recomputed qkv y (row stride nq),
    # and dq, dk, dv go to the same columns of dqkv
    dqkv = torch.empty((m, nq), **f32)
    ops = [_cols(y, nq, col, hd) for col in (0, hh, 2 * hh)] \
        + [_cols(go, hh, 0, hd)] \
        + [_cols(dqkv, nq, col, hd) for col in (0, hh, 2 * hh)]
    regions = b * (gs // rs) ** 2
    dpw, dpb = attention_bwd_launch(rb, tm, tm, 0, ops, regions, h, hd,
                                    rs * rs, gs, rs, pw, pb, kk, 1.0,
                                    x.device, s, nf)
    # dbqkv = the sum of dqkv; with bf16 products round(dqkv) into a bf16
    # copy, which both products read (the tensor cores read bf16 as it lies)
    dqm = torch.empty((m, nq), dtype=mmd, device=x.device) \
        if mmd != torch.float32 else None
    dbqkv = _colsum(rb, tm, dqkv, m, nq, None, dqm, s, nf)
    dqm = dqkv if dqm is None else dqm
    # dWqkv = z^T round(dqkv), dz = round(dqkv) Wqkv^T
    dwqkv = torch.empty((*lead, c, nq), **f32)
    _gemm(rb, tm, z, c, dqm, nq, dwqkv, nq, c, nq, m, at=True, s=s, nf=nf)
    dz = torch.empty((m, c), **f32)
    _gemm(rb, tm, dqm, nq, wqkv, nq, dz, c, m, c, nq, bt=True, s=s, nf=nf)
    # the LayerNorm backward (+ g through the residual); each fold's warps
    # own its rows alone, so a fold's dls / dlb partials are its own
    f = max(nf, 1)
    parts = -(-(m // f) // LN_ROWS_PER_WARP)
    part = torch.empty((2, f * parts, c), **f32)
    dx = torch.empty_like(x)
    build.check(rb.rb_ln_bwd(build.dtype_code(x.dtype), x.data_ptr(),
                             mask.data_ptr(), build.f32_param(ln_s, "ln_s"),
                             dz.data_ptr(),
                             g.data_ptr() if add_residual else None,
                             dx.data_ptr(), part.data_ptr(), m, c, LN_EPS,
                             LN_ROWS_PER_WARP, m // f, s),
                "K2 layernorm backward")
    dln = torch.empty((2, *lead, c), **f32)
    for i in range(2):
        build.check(rb.rb_reduce(part[i].data_ptr(), parts, c,
                                 dln[i].data_ptr(), f, s), "K2 reduce")
    region_layer_bwd.launches += 1
    w3 = dwqkv.reshape(*lead, c, 3, h, hd).movedim(-3, 0).transpose(-3, -2)
    b3 = dbqkv.reshape(*lead, 3, h, hd).movedim(-3, 0)
    return (dx, dln[0], dln[1], w3[0].contiguous(), w3[1].contiguous(),
            w3[2].contiguous(), b3[0], b3[1], b3[2],
            dpw if pw is not None else None,
            dpb if (pw is not None and pb is not None) else None,
            dwp.reshape(*lead, h, hd, c), dbp)


def region_layer_bwd(x, mask, ln_s, ln_b, wq, wk, wv, bq, bk, bv, pw, pb, wp,
                     bp, g, grid_side: int, region_size: int,
                     add_residual: bool, mm_dtype=torch.bfloat16):
    """K2 for CUDA tensors, its plain version for CPU tensors: the
    gradients of (x, ln_s, ln_b, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp),
    each fold's own with folded weights."""
    args = (x, mask, ln_s, ln_b, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp, g,
            grid_side, region_size, add_residual, mm_dtype)
    if x.device.type == "cpu":
        return fold_plain(region_layer_bwd_plain, folds(ln_s, 1), args,
                          _BWD_KINDS, _BWD_OUT)
    if x.device.type != "cuda":
        raise ValueError(f"region_layer_bwd: no kernel for {x.device}")
    return _launch_bwd(*args)


class _RegionLayer(FoldFunction):
    """K1 forward, K2 backward (plain versions on the CPU); under vmap,
    one call for every fold."""

    @staticmethod
    def forward(x, mask, ln_s, ln_b, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp,
                grid_side, region_size, add_residual, mm_dtype):
        args = (x, mask, ln_s, ln_b, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp,
                grid_side, region_size, add_residual, mm_dtype)
        if x.device.type == "cpu":
            return fold_plain(region_layer_plain, folds(ln_s, 1), args,
                              _LAYER_KINDS, (ROWS,))
        return _launch(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:14])
        ctx.geom = inputs[14:]

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        grads = region_layer_bwd(*saved, g, *ctx.geom)
        return (grads[0], None, *grads[1:], None, None, None, None)

    @staticmethod
    def vmap(info, in_dims, *args):
        return vmap_rule(_RegionLayer.apply, info, in_dims, args,
                         _LAYER_KINDS)


def region_layer_fused(x, mask, ln_s, ln_b, wq, wk, wv, bq, bk, bv, pw, pb,
                       wp, bp, grid_side: int, region_size: int,
                       add_residual: bool,
                       mm_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x: (B, G*G, C) float32 or bfloat16; mask (B, G*G) bool; wq/wk/wv
    (H, C, hd) with wq/bq pre-scaled; bq/bk/bv (H, hd); pw (H, k) or None;
    pb (H,) or None; wp (H, hd, C); bp (C,).  Returns the post-layer stream
    (add_residual) or the masked attention branch, in x's dtype.  Under
    `torch.func.vmap` over folds every argument may carry the fold axis."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"region_layer_fused: no kernel for {x.device}")
    return _RegionLayer.apply(x, mask, ln_s, ln_b, wq, wk, wv, bq, bk, bv, pw,
                              pb, wp, bp, grid_side, region_size,
                              add_residual, mm_dtype)


region_layer_fused.launches = 0
region_layer_bwd.launches = 0
