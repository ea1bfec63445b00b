"""K6: the attention core with EPEG on (R, H, P, hd), as a CUDA kernel.

Replaces `rrtmil_tpu/ops/pallas/region_attn.py::_fused_fwd_pallas` (kernel
body `_kernel`, pallas_call at region_attn.py:189):

    Y = M_h round(q * scale)      (M_h = round(I + T_h), only with EPEG)
    A = softmax(round(Y) round(k)^T (+ pe_bias))
    out = round(A) round(v)        in q's dtype

K6 is an entry point on K1's attention core (`rl_attention` in
`csrc/region_layer.cu`; with bf16 products the tensor-core core of
`csrc/tc.cuh`): the core reads q, k and v where they lie, through their
(region, head, token) strides, scales and rounds q as it loads it, and
writes the head outputs straight into an (R, H, P, hd) tensor in q's dtype;
the wrapper runs no torch op but that allocation.  Head widths: any
multiple of 32 up to 512 without EPEG (the CR-MSA of `crmsa_heads=1`
configs: one 512-wide head; `--crmsa_heads 16`: 32), up to 128 with it
(`--n_heads` 16, 8, 4).  `region_attention_fused` is a
`torch.autograd.Function` whose backward is K7 (`region_attn_bwd.py`); on a
CPU tensor both directions run the plain versions, on a CUDA tensor the
kernels.  Folds (`folds.py`): q, k, v hold each fold's regions in turn; the
EPEG taps, when there are any, stack on a leading fold axis (w (K, H, kk),
b (K, H)) and region r reads fold r / (R / K)'s; one launch for all folds.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build, layout
from .common import epeg_toeplitz, mm_round
from .folds import (ROWS, WEIGHT, FoldFunction, fold_plain, folds,
                    vmap_rule)

HEAD_STEP = 32      # the cores take head widths that are multiples of it
MAX_HEAD_DIM = 512  # widest head the cores take (without EPEG)
MAX_EPEG_HEAD_DIM = 128  # widest head the cores take with EPEG
MAX_KK = 128       # EPEG taps the core takes
BLOCK_SMEM = 232448  # bytes of shared memory an H100 block may take


def bwd_query_smem(hd: int, kk: int) -> int:
    """Bytes of shared memory the attention backward's query-side block (K2,
    K7) takes with bf16 products at head width hd and kk EPEG taps
    (csrc/region_layer_bwd.cu q_tc_smem_bytes, its tiles TQ = TK = TD = 64,
    TRS = 72, a 3-stage ring of PAIR = 2 * 64 * 72)."""
    chunks = -(-hd // 64)
    hs = 64 * chunks + 8
    ring = 3 * 2 * 64 * 72
    if not kk:
        return (2 * 64 * hs + ring) * 2
    hr = max((64 + kk - 1 + 15) // 16 * 16, 48 + 32 * ((kk + 15 + 31) // 32))
    taps = max(64 * kk * 4, 64 * hs * 2 if chunks > 1 else 0)
    return (2 * 64 * hs + ring + hr * hs + hr * 72 + 64 * 72) * 2 + taps


def check_geometry(hd: int, kk: int) -> None:
    """Raise ValueError unless the attention cores (K1, K2, K5-K7) take head
    width hd with kk EPEG taps: a multiple of 32 up to 512 without EPEG, up
    to 128 with it, at most MAX_KK taps.  A wider EPEG head names the shared
    memory the backward would need where that is past a block's."""
    top = MAX_EPEG_HEAD_DIM if kk else MAX_HEAD_DIM
    if hd % HEAD_STEP or not HEAD_STEP <= hd <= top:
        why = ""
        if kk and not hd % HEAD_STEP and hd <= MAX_HEAD_DIM:
            smem = bwd_query_smem(hd, kk)
            why = (f" (the backward's query-side block would need {smem} "
                   f"bytes of shared memory, past the {BLOCK_SMEM} an H100 "
                   f"block takes)" if smem > BLOCK_SMEM else
                   " (no kernel instance is built for it)")
        raise ValueError(f"the attention core takes head_dim a multiple of "
                         f"{HEAD_STEP} up to {top}"
                         f"{' with EPEG' if kk else ''}, not {hd}{why}")
    if kk > MAX_KK:
        raise ValueError(f"EPEG k={kk} exceeds the core's {MAX_KK} taps")


def check_heads(wq, pw) -> int:
    """The EPEG tap count, after `check_geometry` of the head width (wq:
    (H, C, hd) or any tensor whose last axis is hd) and the taps."""
    kk = 0 if pw is None else pw.shape[1]
    check_geometry(wq.shape[-1], kk)
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


# the fold forms of the Function's inputs (folds.py)
_ATTN_KINDS = (ROWS, ROWS, ROWS, WEIGHT, WEIGHT, None, None)


def _launch(q, k, v, w, b, scale, mmd):
    check_qkv(q, k, v)
    r, h, p, hd = q.shape
    nf = folds(w, 2)
    kk = check_heads(q, w[0] if nf else w)
    if nf and r % nf:
        raise ValueError(f"{r} regions do not split into {nf} folds")
    dev = q.device
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype, got {q.dtype} "
                        f"{k.dtype} {v.dtype}")
    if k.device != dev or v.device != dev:
        raise ValueError(f"q, k, v must lie on one device, got {dev} "
                         f"{k.device} {v.device}")
    pw = pb = None
    if kk:
        build.same_device(dev, dict(w=w, b=b))
        pw, pb = build.f32_param(w, "pe_weight"), build.f32_param(b, "pe_bias")
    o = torch.empty((r, h, p, hd), dtype=q.dtype, device=dev)
    code = build.dtype_code(q.dtype)
    build.check(build.load("region_layer").rl_attention(
        code, build.dtype_code(mmd), code, q.data_ptr(), *layout.heads(q, "q"),
        k.data_ptr(), *layout.heads(k, "k"), v.data_ptr(),
        *layout.heads(v, "v"), o.data_ptr(), h * p * hd, p * hd, hd, r, h,
        hd, p, 0, 0, scale, pw, kk, pb, r // nf if nf else 0,
        build.stream_of(q)), "K6 attention")
    region_attention_fused.launches += 1
    return o


class _RegionAttention(FoldFunction):
    """K6 forward, K7 backward (plain versions on the CPU); under vmap,
    one call for every fold."""

    @staticmethod
    def forward(q, k, v, w, b, scale, mm_dtype):
        args = (q, k, v, w, b, scale, mm_dtype)
        if q.device.type == "cpu":
            return fold_plain(region_attention_plain, folds(w, 2), args,
                              _ATTN_KINDS, (ROWS,))
        return _launch(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:5])
        ctx.scale, ctx.mm_dtype = inputs[5], inputs[6]

    @staticmethod
    def backward(ctx, g):
        from .region_attn_bwd import region_attention_bwd
        q, k, v, w, b = ctx.saved_tensors
        dq, dk, dv, dw, db = region_attention_bwd(
            q, k, v, w, b, g.contiguous(), ctx.scale, ctx.mm_dtype)
        return dq, dk, dv, dw, db, None, None

    @staticmethod
    def vmap(info, in_dims, *args):
        return vmap_rule(_RegionAttention.apply, info, in_dims, args,
                         _ATTN_KINDS)


def region_attention_fused(q, k, v, w: Optional[torch.Tensor],
                           b: Optional[torch.Tensor], scale: float,
                           mm_dtype: torch.dtype = torch.bfloat16):
    """q, k, v: (R, H, P, hd); w: (H, kk) EPEG taps or None; b: (H,) or
    None.  Returns (R, H, P, hd) in q's dtype."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"region_attention_fused: no kernel for {q.device}")
    return _RegionAttention.apply(q, k, v, w, b, scale, mm_dtype)


region_attention_fused.launches = 0
