"""K6: the attention core with EPEG on (R, H, P, hd), as a CUDA kernel.

Replaces `rrtmil_tpu/ops/pallas/region_attn.py::_fused_fwd_pallas` (kernel
body `_kernel`, pallas_call at region_attn.py:189):

    Y = M_h round(q * scale)      (M_h = round(I + T_h), only with EPEG)
    A = softmax(round(Y) round(k)^T (+ pe_bias))
    out = round(A) round(v)        in q's dtype

K6 is an entry point on K1's attention core (`rl_attention` in
`csrc/region_layer.cu`): the wrapper packs round(q * scale), k and v as the
columns of one (R * P, 3 * H * hd) matrix and the core writes the head
outputs in q's dtype.  `region_attention_fused` is a `torch.autograd.Function`
whose backward is K7 (`region_attn_bwd.py`); on a CPU tensor both directions
run the plain versions, on a CUDA tensor the kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build
from .common import epeg_toeplitz, mm_round

HEAD_DIM = 64      # the attention core's thread layout
MAX_KK = 128       # EPEG taps the core takes


def check_heads(wq, pw) -> int:
    """The EPEG tap count, after checking the head width (wq: (H, C, hd) or
    any tensor whose last axis is hd)."""
    hd = wq.shape[-1]
    if hd != HEAD_DIM:
        raise ValueError(f"the attention core takes head_dim {HEAD_DIM}, "
                         f"not {hd} (other widths: ROADMAP.md queue 2)")
    kk = 0 if pw is None else pw.shape[1]
    if kk > MAX_KK:
        raise ValueError(f"EPEG k={kk} exceeds the core's {MAX_KK} taps")
    return kk


def attention_core_plain(q, k, v, pw, pb, mm_dtype) -> torch.Tensor:
    """The core on (R, H, P, hd) values already in the mm dtype (held as
    float32): round(M q) with EPEG, the logits (+ pb with EPEG), the softmax
    rounded to the mm dtype, and its product with v, returned in float32
    before any output rounding."""
    if pw is not None:
        m = mm_round(epeg_toeplitz(pw, q.shape[2]), mm_dtype)
        q = mm_round(torch.einsum("hij,rhjd->rhid", m, q), mm_dtype)
    logits = torch.einsum("rhid,rhjd->rhij", q, k)
    if pw is not None and pb is not None:
        logits = logits + pb.float()[None, :, None, None]
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    attn = mm_round(e / e.sum(-1, keepdim=True), mm_dtype)
    return torch.einsum("rhij,rhjd->rhid", attn, v)


def region_attention_plain(q, k, v, w, b, scale: float,
                           mm_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K6 (same rounding points, fp32 sums)."""
    o = attention_core_plain(mm_round(q.float() * scale, mm_dtype),
                             mm_round(k, mm_dtype), mm_round(v, mm_dtype), w,
                             b, mm_dtype)
    return o.to(q.dtype)


def check_qkv(q, k, v) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (R, H, P, hd) shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")


def pack_qkv(q, k, v, scale: float, mmd) -> torch.Tensor:
    """(R, H, P, hd) x 3 -> the core's (R * P, 3 * H * hd) operand in the mm
    dtype: row r * P + p, columns (q | k | v) x (H, hd), q scaled."""
    r, h, p, hd = q.shape
    y = torch.stack([(q.float() * scale).to(mmd), k.to(mmd), v.to(mmd)], 2)
    return y.permute(0, 3, 2, 1, 4).contiguous().reshape(r * p, 3 * h * hd)


def epeg_args(w, b, kk):
    pw_f = w.float().contiguous() if kk else None
    pb_f = b.float().contiguous() if (kk and b is not None) else None
    return pw_f, pb_f


def _launch(q, k, v, w, b, scale, mmd):
    check_qkv(q, k, v)
    r, h, p, hd = q.shape
    kk = check_heads(q, w)
    y = pack_qkv(q, k, v, scale, mmd)
    build.require_cuda({"y": y}, dict(q=q, k=k, v=v, w=w, b=b))
    lib = build.load("region_layer")
    pw_f, pb_f = epeg_args(w, b, kk)
    hh = h * hd
    o = torch.empty((r * p, hh), dtype=q.dtype, device=q.device)
    build.check(lib.rl_attention(build.dtype_code(mmd),
                                 build.dtype_code(q.dtype), y.data_ptr(),
                                 3 * hh, hh, 2 * hh, o.data_ptr(), hh, r, h,
                                 hd, p, 0, 0, build.ptr(pw_f), kk,
                                 build.ptr(pb_f), build.stream_of(q)),
                "K6 attention")
    region_attention_fused.launches += 1
    return o.reshape(r, p, h, hd).permute(0, 2, 1, 3).contiguous()


class _RegionAttention(torch.autograd.Function):
    """K6 forward, K7 backward (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, w, b, scale, mm_dtype):
        ctx.save_for_backward(q, k, v, w, b)
        ctx.scale, ctx.mm_dtype = scale, mm_dtype
        if q.device.type == "cpu":
            return region_attention_plain(q, k, v, w, b, scale, mm_dtype)
        return _launch(q, k, v, w, b, scale, mm_dtype)

    @staticmethod
    def backward(ctx, g):
        from .region_attn_bwd import region_attention_bwd
        q, k, v, w, b = ctx.saved_tensors
        dq, dk, dv, dw, db = region_attention_bwd(
            q, k, v, w, b, g.contiguous(), ctx.scale, ctx.mm_dtype)
        return dq, dk, dv, dw, db, None, None


def region_attention_fused(q, k, v, w: Optional[torch.Tensor],
                           b: Optional[torch.Tensor], scale: float,
                           mm_dtype: torch.dtype = torch.bfloat16):
    """q, k, v: (R, H, P, hd); w: (H, kk) EPEG taps or None; b: (H,) or
    None.  Returns (R, H, P, hd) in q's dtype."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"region_attention_fused: no kernel for {q.device}")
    return _RegionAttention.apply(q, k, v, w, b, scale, mm_dtype)


region_attention_fused.launches = 0
