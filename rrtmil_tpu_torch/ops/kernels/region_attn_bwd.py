"""K7: the backward of the attention core with EPEG, as CUDA kernels.

Replaces `rrtmil_tpu/ops/pallas/region_attn_bwd.py::region_attention_bwd_pallas`
(kernel body `_bwd_kernel`, pallas_call at region_attn_bwd.py:193).  With
y = round(M_h round(q * scale)) (or round(q * scale)), A = softmax(y k^T + pb)
and g = d(out):

    dv = round(A)^T round(g)              dA = round(g) round(v)^T
    dLc = A * (dA - rowsum(dA * A))       dY = round(dLc) round(k)
    dq = scale * M_h^T round(dY)          (scale * dY without EPEG)
    dk = round(dLc)^T y
    dw[h, t] = sum_{r,i,j} round(dLc)[i, j] round(round(q s) k^T)[i+t-k//2, j]
    db[h] = sum dLc

dq, dk, dv come back in the primals' dtypes, dw and db in float32; dw and db
are None without EPEG (db also without a bias).  Head widths as K6's: a
multiple of 64 up to 512 without EPEG, 64 with it.  The CUDA source is
`csrc/region_layer_bwd.cu` (`rb_attention_bwd`), whose note says what bounds
it on an H100 and what the design does about it; K2 runs the same entry on
the R-MSA layer's token order.
"""
from __future__ import annotations

import torch

from . import build
from .common import epeg_toeplitz, mm_round
from .region_attn import check_heads, check_qkv

QUERY_TILE = 64    # rows of one block of the query-side kernel


def pack_qkv(q, k, v, scale: float, mmd) -> torch.Tensor:
    """(R, H, P, hd) x 3 -> the backward core's (R * P, 3 * H * hd) operand
    in the mm dtype: row r * P + p, columns (q | k | v) x (H, hd), q
    scaled."""
    r, h, p, hd = q.shape
    y = torch.stack([(q.float() * scale).to(mmd), k.to(mmd), v.to(mmd)], 2)
    return y.permute(0, 3, 2, 1, 4).contiguous().reshape(r * p, 3 * h * hd)


def attention_bwd_core_plain(q, k, v, g, pw, pb, mm_dtype):
    """The core's backward on (R, H, P, hd) values already in the mm dtype
    (held as float32), g included.  Returns float32 (dqs, dk, dv, dw, db):
    dqs = M^T round(dY) with EPEG or dY without, the gradient of the scaled
    q; dw (H, kk) and db (H,) are None without EPEG (db also without pb)."""
    mmd = mm_dtype
    p = q.shape[2]
    mt = None
    if pw is not None:
        mt = mm_round(epeg_toeplitz(pw, p), mmd)
        y = mm_round(torch.einsum("hij,rhjd->rhid", mt, q), mmd)
    else:
        y = q
    logits = torch.einsum("rhid,rhjd->rhij", y, k)
    if pw is not None and pb is not None:
        logits = logits + pb.float()[None, :, None, None]
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    attn = e / e.sum(-1, keepdim=True)
    dv = torch.einsum("rhij,rhid->rhjd", mm_round(attn, mmd), g)
    da = torch.einsum("rhid,rhjd->rhij", g, v)
    dlc = attn * (da - (da * attn).sum(-1, keepdim=True))
    dlcm = mm_round(dlc, mmd)
    dy = torch.einsum("rhij,rhjd->rhid", dlcm, k)
    dq = dy if mt is None else torch.einsum("hij,rhid->rhjd", mt,
                                            mm_round(dy, mmd))
    dk = torch.einsum("rhij,rhid->rhjd", dlcm, y)
    dw = db = None
    if pw is not None:
        kk = pw.shape[1]
        lpre = mm_round(torch.einsum("rhid,rhjd->rhij", q, k), mmd)
        s = torch.einsum("rhij,rhkj->hik", dlcm, lpre)
        dw = torch.stack([torch.diagonal(s, t - kk // 2, 1, 2).sum(-1)
                          for t in range(kk)], 1)
        if pb is not None:
            db = dlc.sum((0, 2, 3))
    return dq, dk, dv, dw, db


def region_attention_bwd_plain(q, k, v, w, b, g, scale: float,
                               mm_dtype=torch.bfloat16):
    """Plain PyTorch version of K7: (dq, dk, dv, dw, db)."""
    mmd = mm_dtype
    dqs, dk, dv, dw, db = attention_bwd_core_plain(
        mm_round(q.float() * scale, mmd), mm_round(k, mmd), mm_round(v, mmd),
        mm_round(g, mmd), w, b, mmd)
    return ((dqs * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dw,
            db)


def attention_bwd_launch(lib, tm, to, y, ldy, kcol0, vcol0, gg, ldg, d, ldd,
                         r, h, hd, p, grid, rs, w, b, kk, scale, stream):
    """rb_attention_bwd with its scratch; returns (dw, db) or (None, None)
    without EPEG.  `d` receives dq, dk, dv in the columns of `y`."""
    dev = y.device
    pw = build.f32_param(w, "pe_weight") if kk else None
    pb = build.f32_param(b, "pe_bias") if kk else None
    stats = torch.empty((3, r * h * p), dtype=torch.float32, device=dev)
    dy = part = dw = db = None
    if kk:
        nqt = -(-p // QUERY_TILE)
        dy = torch.empty((r * h * p, 64), dtype=y.dtype, device=dev)
        part = torch.empty((h, r * nqt, kk + 1), dtype=torch.float32,
                           device=dev)
        dw = torch.empty((h, kk), dtype=torch.float32, device=dev)
        if pb is not None:
            db = torch.empty((h,), dtype=torch.float32, device=dev)
    build.check(lib.rb_attention_bwd(
        tm, to, y.data_ptr(), ldy, kcol0, vcol0, gg.data_ptr(), ldg,
        d.data_ptr(), ldd, r, h, hd, p, grid, rs, pw, kk, pb, scale,
        stats.data_ptr(), build.ptr(dy),
        build.ptr(part), build.ptr(dw), build.ptr(db), stream),
        "K7 attention backward")
    return dw, db


def _launch(q, k, v, w, b, g, scale, mmd):
    check_qkv(q, k, v)
    if g.shape != q.shape:
        raise ValueError(f"g {tuple(g.shape)} does not match q "
                         f"{tuple(q.shape)}")
    r, h, p, hd = q.shape
    kk = check_heads(q, w)
    y = pack_qkv(q, k, v, scale, mmd)
    gg = g.to(mmd).permute(0, 2, 1, 3).contiguous().reshape(r * p, h * hd)
    build.require_cuda({"y": y, "g": gg}, dict(w=w, b=b))
    lib = build.load("region_layer_bwd")
    hh = h * hd
    d = torch.empty((r * p, 3 * hh), dtype=q.dtype, device=q.device)
    dw, db = attention_bwd_launch(
        lib, build.dtype_code(mmd), build.dtype_code(q.dtype), y, 3 * hh, hh,
        2 * hh, gg, hh, d, 3 * hh, r, h, hd, p, 0, 0, w, b, kk, scale,
        build.stream_of(q))
    region_attention_bwd.launches += 1
    dq, dk, dv = d.reshape(r, p, 3, h, hd).permute(2, 0, 3, 1, 4)
    return (dq.contiguous(), dk.to(k.dtype).contiguous(),
            dv.to(v.dtype).contiguous(), dw, db)


def region_attention_bwd(q, k, v, w, b, g, scale: float,
                         mm_dtype=torch.bfloat16):
    """(dq, dk, dv, dw, db) of `region_attention_fused`: the kernels for
    CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return region_attention_bwd_plain(q, k, v, w, b, g, scale, mm_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"region_attention_bwd: no kernel for {q.device}")
    return _launch(q, k, v, w, b, g, scale, mm_dtype)


region_attention_bwd.launches = 0
