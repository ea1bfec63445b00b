"""K5: the whole InnerAttention on contiguous regions, as a CUDA kernel.

Replaces `rrtmil_tpu/ops/pallas/region_block.py::_block_fwd_pallas`
(kernel body `_block_kernel`, pallas_call at region_block.py:200):

    y = proj( softmax((z Wq + bq)(z Wk + bk)^T with EPEG (+ pb))
              (z Wv + bv) ) Wp + bp,        z = x in the mm dtype

with the q scale folded into wq/bq by the caller.  x (R, P, C) -> (R, P, C)
in x's dtype.  It runs on K1's entries in `csrc/region_layer.cu` (the
product, and the attention core with the identity token map); the note
there says what bounds it on an H100 and what the design does about it.

`region_block_fused` launches the kernel for a CUDA tensor and runs
`region_block_plain` for a CPU tensor; any other device raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build
from .common import epeg_toeplitz, forward_only, mm_round

HEAD_DIM = 64      # the attention core's thread layout
MAX_KK = 128       # EPEG taps the core takes


def block_core_plain(z: torch.Tensor, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp,
                     mm_dtype: torch.dtype) -> torch.Tensor:
    """The block's math on z (R, P, C) whose values are already in the mm
    dtype; returns the fp32 projection (R, P, C) before the output cast.
    Rounds to the mm dtype where the TPU kernel casts: q/k/v after the bias,
    the Toeplitz matrix and M q, the softmax, the head outputs."""
    mmd = mm_dtype
    p = z.shape[1]

    def heads(w, b):
        y = torch.einsum("rpc,hcd->rhpd", z, mm_round(w, mmd))
        return mm_round(y + b.float()[None, :, None, :], mmd)

    q, k, v = heads(wq, bq), heads(wk, bk), heads(wv, bv)
    if pw is not None:
        m = mm_round(epeg_toeplitz(pw, p), mmd)
        q = mm_round(torch.einsum("hij,rhjd->rhid", m, q), mmd)
    logits = torch.einsum("rhid,rhjd->rhij", q, k)
    if pw is not None and pb is not None:
        logits = logits + pb.float()[None, :, None, None]
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    attn = mm_round(e / e.sum(-1, keepdim=True), mmd)
    o = mm_round(torch.einsum("rhij,rhjd->rhid", attn, v), mmd)
    return torch.einsum("rhpd,hdc->rpc", o, mm_round(wp, mmd)) + bp.float()


def region_block_plain(x, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp,
                       mm_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K5 (same arithmetic, fp32 sums)."""
    y = block_core_plain(mm_round(x, mm_dtype), wq, wk, wv, bq, bk, bv, pw, pb,
                         wp, bp, mm_dtype)
    return y.to(x.dtype)


def qkv_weights(wq, wk, wv, bq, bk, bv, mm_dtype):
    """(H, C, hd) x3 -> one (C, 3*H*hd) mm-dtype matrix in the flax qkv column
    order (3, H, hd), and the (3*H*hd,) fp32 bias."""
    c = wq.shape[1]
    w = torch.stack([wq, wk, wv]).permute(2, 0, 1, 3).reshape(c, -1)
    b = torch.stack([bq, bk, bv]).reshape(-1)
    return w.to(mm_dtype).contiguous(), b.float().contiguous()


def check_heads(wq, pw) -> int:
    h, _, hd = wq.shape
    if hd != HEAD_DIM:
        raise ValueError(f"the attention core takes head_dim {HEAD_DIM}, "
                         f"not {hd} (other widths: ROADMAP.md queue 2)")
    kk = 0 if pw is None else pw.shape[1]
    if kk > MAX_KK:
        raise ValueError(f"EPEG k={kk} exceeds the core's {MAX_KK} taps")
    return kk


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
    m, n, hh = r * p, 3 * h * hd, h * hd
    wqkv, bqkv = qkv_weights(wq, wk, wv, bq, bk, bv, mmd)
    y = torch.empty((m, n), dtype=mmd, device=x.device)
    build.check(lib.rl_gemm(build.dtype_code(x.dtype), build.dtype_code(mmd),
                            build.dtype_code(mmd), x.data_ptr(), c,
                            wqkv.data_ptr(), n, y.data_ptr(), n, m, n, c,
                            bqkv.data_ptr(), None, None, 0, s), "K5 qkv")
    pw_f = pw.float().contiguous() if pw is not None else None
    pb_f = pb.float().contiguous() if (pw is not None and pb is not None) \
        else None
    o = torch.empty((m, hh), dtype=mmd, device=x.device)
    build.check(lib.rl_attention(build.dtype_code(mmd), y.data_ptr(), n, hh,
                                 2 * hh, o.data_ptr(), hh, r, h, hd, p, 0, 0,
                                 build.ptr(pw_f), kk, build.ptr(pb_f), s),
                "K5 attention")
    wp2 = wp.reshape(hh, c).to(mmd).contiguous()
    bp_f = bp.float().contiguous()
    out = torch.empty_like(x)
    build.check(lib.rl_gemm(build.dtype_code(mmd), build.dtype_code(mmd),
                            build.dtype_code(x.dtype), o.data_ptr(), hh,
                            wp2.data_ptr(), c, out.data_ptr(), c, m, c, hh,
                            bp_f.data_ptr(), None, None, 0, s),
                "K5 projection")
    region_block_fused.launches += 1
    return out


def region_block_fused(x, wq, wk, wv, bq, bk, bv, pw: Optional[torch.Tensor],
                       pb: Optional[torch.Tensor], wp, bp,
                       mm_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x: (R, P, C); wq/wk/wv: (H, C, hd) [wq, bq pre-scaled]; bq/bk/bv:
    (H, hd); pw: (H, kk) or None; pb: (H,) or None; wp: (H, hd, C); bp:
    (C,).  Returns (R, P, C) in x.dtype."""
    if x.device.type == "cpu":
        return region_block_plain(x, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp,
                                  mm_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"region_block_fused: no kernel for {x.device}")
    forward_only("region_block_fused", x, wq, wk, wv, bq, bk, bv, pw, pb, wp,
                 bp)
    return _launch(x, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp, mm_dtype)


region_block_fused.launches = 0
