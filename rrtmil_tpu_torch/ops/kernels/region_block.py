"""K5: the whole InnerAttention on regions, as a CUDA kernel.

Replaces `rrtmil_tpu/ops/pallas/region_block.py::_block_fwd_pallas`
(kernel body `_block_kernel`, pallas_call at region_block.py:200):

    y = proj( softmax((z Wq + bq)(z Wk + bk)^T with EPEG (+ pb))
              (z Wv + bv) ) Wp + bp,        z = x in the mm dtype

with the q scale folded into wq/bq by the caller.  x (R, P, C) -> (R, P, C)
in x's dtype.  It is one C call, `rl_block` in `csrc/region_layer.cu`: the
qkv product, the attention core with the identity token map and the
projection (with bf16 products all three on the tensor cores,
`csrc/tc.cuh`), reading x (which may be a strided view, as the B = 1
cross-region input is) and the weights where they lie: wq/wk/wv (H, C, hd)
and wp (H, hd, C) as `InnerAttention.kernel_weights()` hands them over,
views of the qkv and proj Linear weights.  The wrapper runs no torch op but
`torch.empty` for its output and scratch; the note in the CUDA source says
what bounds it on an H100 and what the design does about it.

`region_block_fused` is a `torch.autograd.Function`: its forward is K5 (the
plain version on a CPU tensor), its backward differentiates `block_ref`, the
qkv and projection products as torch ops around `region_attention_fused`
(K6 forward, K7 backward), exactly as the JAX package's `_bwd` differentiates
`_block_ref` (region_block.py:217-276).

Folds (`folds.py`): with weights stacked on a leading fold axis (wq (K, H,
C, hd), ...) and x holding each fold's regions in turn, K5 is one `rl_block`
call for every fold; its backward differentiates `block_ref` under
`torch.func.vmap` over the folds (one K6 and one K7 launch for all of them).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build, layout
from .common import mm_round
from .folds import (ROWS, WEIGHT, FoldFunction, fold_plain, folds,
                    vmap_rule)
from .region_attn import (attention_core_plain, check_heads,
                          region_attention_fused)

# the fold forms of the Function's inputs (folds.py)
_BLOCK_KINDS = (ROWS,) + (WEIGHT,) * 10 + (None,)


def block_core_plain(z: torch.Tensor, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp,
                     mm_dtype: torch.dtype) -> torch.Tensor:
    """The block's math on z (R, P, C) whose values are already in the mm
    dtype; returns the fp32 projection (R, P, C) before the output cast.
    Rounds to the mm dtype where the TPU kernel casts: q/k/v after the bias,
    the Toeplitz matrix and M q, the softmax, the head outputs."""
    mmd = mm_dtype

    def heads(w, b):
        y = torch.einsum("rpc,hcd->rhpd", z, mm_round(w, mmd))
        return mm_round(y + b.float()[None, :, None, :], mmd)

    q, k, v = heads(wq, bq), heads(wk, bk), heads(wv, bv)
    o = mm_round(attention_core_plain(q, k, v, pw, pb, mmd), mmd)
    return torch.einsum("rhpd,hdc->rpc", o, mm_round(wp, mmd)) + bp.float()


def region_block_plain(x, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp,
                       mm_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K5 (same arithmetic, fp32 sums)."""
    y = block_core_plain(mm_round(x, mm_dtype), wq, wk, wv, bq, bk, bv, pw, pb,
                         wp, bp, mm_dtype)
    return y.to(x.dtype)


def block_ref(x, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp,
              mm_dtype=torch.bfloat16) -> torch.Tensor:
    """The block as the JAX package's `_block_ref` writes it: the products
    as torch ops on mm-rounded operands with fp32 sums, the attention core
    through `region_attention_fused` at scale 1.0 (the scale is in wq/bq).
    Differentiable; K5's backward."""
    mmd = mm_dtype
    z = mm_round(x, mmd)

    def heads(w, b):
        return (torch.einsum("rpc,hcd->rhpd", z, mm_round(w, mmd))
                + b.float()[None, :, None, :])

    out = region_attention_fused(heads(wq, bq).to(mmd), heads(wk, bk).to(mmd),
                                 heads(wv, bv).to(mmd), pw, pb, 1.0, mmd)
    y = torch.einsum("rhpd,hdc->rpc", mm_round(out, mmd), mm_round(wp, mmd))
    return (y + bp.float()).to(x.dtype)


def qkv_weights(wq, wk, wv, bq, bk, bv, mm_dtype):
    """(H, C, hd) x3 -> one (C, 3*H*hd) mm-dtype matrix in the flax qkv column
    order (3, H, hd), and the (3*H*hd,) fp32 bias (K2's backward products);
    with a leading fold axis, (K, C, 3*H*hd) and (K, 3*H*hd)."""
    lead, c = wq.shape[:-3], wq.shape[-2]
    w = torch.stack([wq, wk, wv], -4).movedim(-2, -4).reshape(*lead, c, -1)
    b = torch.stack([bq, bk, bv], -3).reshape(*lead, -1)
    return w.to(mm_dtype).contiguous(), b.float().contiguous()


def qkv_args(wq, wk, wv, bq, bk, bv):
    """((wq, wk, wv) pointers, their shared (C, H * hd) description,
    (bq, bk, bv) pointers) for `rl_gemm` / `rl_block`."""
    desc = layout.qkv_cols(wq, "wq")
    ptrs = (wq.data_ptr(), wk.data_ptr(), wv.data_ptr())
    sq = layout.stride0(wq)
    if layout.stride0(wk) != sq or layout.stride0(wv) != sq \
            or (ptrs[1] | ptrs[2]) % layout.ALIGN:
        raise ValueError(f"wq, wk, wv must share one aligned layout, got "
                         f"strides {wq.stride()} {wk.stride()} {wv.stride()}")
    if wk.dtype != wq.dtype or wv.dtype != wq.dtype:
        raise TypeError("wq, wk, wv must share one dtype")
    return (ptrs, desc,
            (build.f32_param(bq, "bq"), build.f32_param(bk, "bk"),
             build.f32_param(bv, "bv")))


def _launch(x, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp, mmd):
    r, p, c = x.shape
    nf = folds(wq, 3)
    h, _, hd = wq.shape[-3:]
    w0 = [t[0] if nf and t is not None else t
          for t in (wq, wk, wv, bq, bk, bv, pw, pb, wp, bp)]
    kk = check_heads(w0[0], w0[6])
    dev = x.device
    if (wq.shape[-2] != c or w0[8].shape != (h, hd, c)
            or w0[9].shape != (c,) or (nf and r % nf)):
        raise ValueError(f"weights do not match x {tuple(x.shape)}")
    if wp.dtype != wq.dtype:
        raise TypeError("wp must have the qkv weights' dtype")
    build.same_device(dev, dict(wq=wq, wk=wk, wv=wv, bq=bq, bk=bk, bv=bv,
                                pw=pw, pb=pb, wp=wp, bp=bp))
    _, sr, sp = layout.rows(x)
    wptr, wdesc, bptr = qkv_args(*w0[:6])
    m, hh = r * p, h * hd
    scratch = torch.empty((m, 4 * hh), dtype=mmd, device=dev)  # y | o
    out = torch.empty((r, p, c), dtype=x.dtype, device=dev)
    lib = build.load("region_layer")
    fs = [t.stride(0) if nf else 0 for t in (wq, bq, wp, bp)]
    build.check(lib.rl_block(
        build.dtype_code(x.dtype), build.dtype_code(wq.dtype),
        build.dtype_code(mmd), x.data_ptr(), sr, sp, *wptr, *wdesc, *bptr,
        build.f32_param(pw, "pe_weight") if kk else None, kk,
        build.f32_param(pb, "pe_bias") if kk else None, wp.data_ptr(),
        *layout.proj_rows(w0[8]), build.f32_param(bp, "bp"),
        scratch.data_ptr(),
        scratch.data_ptr() + m * 3 * hh * scratch.element_size(),
        out.data_ptr(), r, p, c, h, hd, r // nf if nf else 0, *fs,
        build.stream_of(x)), "K5 block")
    region_block_fused.launches += 1
    return out


def _block_vjp(saved, g, mmd, nf: int = 0):
    """The gradients of block_ref's inputs `saved` (None kept) at g; with nf
    folds (x's regions split into nf equal runs, the weights stacked)
    block_ref runs under torch.func.vmap over the folds, so its K6 and K7
    run once for every fold."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(True)
                  for t in saved]
        if nf:
            x = leaves[0]
            y = torch.func.vmap(
                lambda x_, *w: block_ref(x_, *w, mm_dtype=mmd),
                in_dims=(0, *[None if t is None else 0 for t in leaves[1:]]))(
                x.reshape(nf, x.shape[0] // nf, *x.shape[1:]), *leaves[1:])
            g = g.reshape(y.shape)
        else:
            y = block_ref(*leaves, mm_dtype=mmd)
        live = [t for t in leaves if t is not None]
        grads = iter(torch.autograd.grad(y, live, g))
    return tuple(None if t is None else next(grads) for t in leaves)


class _RegionBlock(FoldFunction):
    """K5 forward; the backward differentiates block_ref (K6 + K7); under
    vmap, one call for every fold."""

    @staticmethod
    def forward(x, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp, mm_dtype):
        args = (x, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp, mm_dtype)
        if x.device.type == "cpu":
            return fold_plain(region_block_plain, folds(wq, 3), args,
                              _BLOCK_KINDS, (ROWS,))
        return _launch(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:11])
        ctx.mm_dtype = inputs[11]

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        return (*_block_vjp(saved, g, ctx.mm_dtype, folds(saved[1], 3)), None)

    @staticmethod
    def vmap(info, in_dims, *args):
        return vmap_rule(_RegionBlock.apply, info, in_dims, args,
                         _BLOCK_KINDS)


def region_block_fused(x, wq, wk, wv, bq, bk, bv, pw: Optional[torch.Tensor],
                       pb: Optional[torch.Tensor], wp, bp,
                       mm_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x: (R, P, C); wq/wk/wv: (H, C, hd) [wq, bq pre-scaled]; bq/bk/bv:
    (H, hd); pw: (H, kk) or None; pb: (H,) or None; wp: (H, hd, C); bp:
    (C,).  Returns (R, P, C) in x.dtype.  Under `torch.func.vmap` over folds
    every argument may carry the fold axis."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"region_block_fused: no kernel for {x.device}")
    return _RegionBlock.apply(x, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp,
                              mm_dtype)


region_block_fused.launches = 0
