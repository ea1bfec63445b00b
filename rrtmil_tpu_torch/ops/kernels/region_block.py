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
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build, layout
from .common import mm_round
from .region_attn import (attention_core_plain, check_heads,
                          region_attention_fused)


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
    order (3, H, hd), and the (3*H*hd,) fp32 bias (K2's backward products)."""
    c = wq.shape[1]
    w = torch.stack([wq, wk, wv]).permute(2, 0, 1, 3).reshape(c, -1)
    b = torch.stack([bq, bk, bv]).reshape(-1)
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
    h, _, hd = wq.shape
    kk = check_heads(wq, pw)
    dev = x.device
    if wq.shape[1] != c or wp.shape != (h, hd, c) or bp.shape != (c,):
        raise ValueError(f"weights do not match x {tuple(x.shape)}")
    if wp.dtype != wq.dtype:
        raise TypeError("wp must have the qkv weights' dtype")
    build.same_device(dev, dict(wq=wq, wk=wk, wv=wv, bq=bq, bk=bk, bv=bv,
                                pw=pw, pb=pb, wp=wp, bp=bp))
    _, sr, sp = layout.rows(x)
    wptr, wdesc, bptr = qkv_args(wq, wk, wv, bq, bk, bv)
    m, hh = r * p, h * hd
    scratch = torch.empty((m, 4 * hh), dtype=mmd, device=dev)  # y | o
    out = torch.empty((r, p, c), dtype=x.dtype, device=dev)
    lib = build.load("region_layer")
    build.check(lib.rl_block(
        build.dtype_code(x.dtype), build.dtype_code(wq.dtype),
        build.dtype_code(mmd), x.data_ptr(), sr, sp, *wptr, *wdesc, *bptr,
        build.f32_param(pw, "pe_weight") if kk else None, kk,
        build.f32_param(pb, "pe_bias") if kk else None, wp.data_ptr(),
        *layout.proj_rows(wp), build.f32_param(bp, "bp"), scratch.data_ptr(),
        scratch.data_ptr() + m * 3 * hh * scratch.element_size(),
        out.data_ptr(), r, p, c, h, hd, build.stream_of(x)),
        "K5 block")
    region_block_fused.launches += 1
    return out


class _RegionBlock(torch.autograd.Function):
    """K5 forward; the backward differentiates block_ref (K6 + K7)."""

    @staticmethod
    def forward(ctx, x, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp, mm_dtype):
        ctx.save_for_backward(x, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp)
        ctx.mm_dtype = mm_dtype
        if x.device.type == "cpu":
            return region_block_plain(x, wq, wk, wv, bq, bk, bv, pw, pb, wp,
                                      bp, mm_dtype)
        return _launch(x, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp, mm_dtype)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(True)
                      for t in saved]
            y = block_ref(*leaves, mm_dtype=ctx.mm_dtype)
            live = [t for t in leaves if t is not None]
            grads = iter(torch.autograd.grad(y, live, g))
        return (*[None if t is None else next(grads) for t in leaves], None)


def region_block_fused(x, wq, wk, wv, bq, bk, bv, pw: Optional[torch.Tensor],
                       pb: Optional[torch.Tensor], wp, bp,
                       mm_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x: (R, P, C); wq/wk/wv: (H, C, hd) [wq, bq pre-scaled]; bq/bk/bv:
    (H, hd); pw: (H, kk) or None; pb: (H,) or None; wp: (H, hd, C); bp:
    (C,).  Returns (R, P, C) in x.dtype."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"region_block_fused: no kernel for {x.device}")
    return _RegionBlock.apply(x, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp,
                              mm_dtype)


region_block_fused.launches = 0
