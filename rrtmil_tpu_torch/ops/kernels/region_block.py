"""K5: the whole InnerAttention on contiguous regions, as a CUDA kernel.

Replaces `rrtmil_tpu/ops/pallas/region_block.py::_block_fwd_pallas`
(kernel body `_block_kernel`, pallas_call at region_block.py:200):

    y = proj( softmax((z Wq + bq)(z Wk + bk)^T with EPEG (+ pb))
              (z Wv + bv) ) Wp + bp,        z = x in the mm dtype

with the q scale folded into wq/bq by the caller.  x (R, P, C) -> (R, P, C)
in x's dtype.  It runs on K1's entries in `csrc/region_layer.cu` (the
product, and the attention core with the identity token map); the note
there says what bounds it on an H100 and what the design does about it.

`region_block_fused` is a `torch.autograd.Function`: its forward is K5 (the
plain version on a CPU tensor), its backward differentiates `block_ref`, the
qkv and projection products as torch ops around `region_attention_fused`
(K6 forward, K7 backward), exactly as the JAX package's `_bwd` differentiates
`_block_ref` (region_block.py:217-276).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build
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
    order (3, H, hd), and the (3*H*hd,) fp32 bias."""
    c = wq.shape[1]
    w = torch.stack([wq, wk, wv]).permute(2, 0, 1, 3).reshape(c, -1)
    b = torch.stack([bq, bk, bv]).reshape(-1)
    return w.to(mm_dtype).contiguous(), b.float().contiguous()


def _launch(x, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp, mmd):
    r, p, c = x.shape
    h, _, hd = wq.shape
    kk = check_heads(wq, pw)
    build.require_cuda({"x": x}, dict(wq=wq, wk=wk, wv=wv, bq=bq, bk=bk,
                                      bv=bv, pw=pw, pb=pb, wp=wp, bp=bp))
    if wq.shape[1] != c or wp.shape != (h, hd, c) or bp.shape != (c,):
        raise ValueError(f"weights do not match x {tuple(x.shape)}")
    lib = build.load("region_layer")
    s = build.stream_of(x)
    tm = build.dtype_code(mmd)
    m, n, hh = r * p, 3 * h * hd, h * hd
    wqkv, bqkv = qkv_weights(wq, wk, wv, bq, bk, bv, mmd)
    y = torch.empty((m, n), dtype=mmd, device=x.device)
    build.check(lib.rl_gemm(build.dtype_code(x.dtype), tm, tm, x.data_ptr(), c,
                            wqkv.data_ptr(), n, y.data_ptr(), n, m, n, c,
                            bqkv.data_ptr(), None, None, 0, s), "K5 qkv")
    pw_f = pw.float().contiguous() if pw is not None else None
    pb_f = pb.float().contiguous() if (pw is not None and pb is not None) \
        else None
    o = torch.empty((m, hh), dtype=mmd, device=x.device)
    build.check(lib.rl_attention(tm, tm, y.data_ptr(), n, hh, 2 * hh,
                                 o.data_ptr(), hh, r, h, hd, p, 0, 0,
                                 build.ptr(pw_f), kk, build.ptr(pb_f), s),
                "K5 attention")
    wp2 = wp.reshape(hh, c).to(mmd).contiguous()
    bp_f = bp.float().contiguous()
    out = torch.empty_like(x)
    build.check(lib.rl_gemm(tm, tm, build.dtype_code(x.dtype), o.data_ptr(),
                            hh, wp2.data_ptr(), c, out.data_ptr(), c, m, c, hh,
                            bp_f.data_ptr(), None, None, 0, s),
                "K5 projection")
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
