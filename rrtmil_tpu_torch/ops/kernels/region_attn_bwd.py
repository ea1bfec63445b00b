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

dq, dk, dv come back in the primals' dtype, dw and db in float32; dw and db
are None without EPEG (db also without a bias).  Head widths as K6's: a
multiple of 32 up to 512 without EPEG, up to 128 with it.  The CUDA source is
`csrc/region_layer_bwd.cu` (`rb_attention_bwd`: with bf16 products on the
tensor cores, with f32 products on the CUDA cores), whose note says what
bounds it on an H100 and what the design does about it.  The kernels read
q, k, v and g where they lie, through their (region, head, token) strides
(`layout.heads`), and write dq, dk, dv straight into (R, H, P, hd) tensors:
the wrapper runs no torch op but `torch.empty`.  K2 runs the same entry on
the R-MSA layer's token order, on the columns of its recomputed qkv.  With
the taps stacked on a leading fold axis (`folds.py`), dw (K, H, kk) and db
(K, H) are each fold's own sums over its regions, from one launch.
"""
from __future__ import annotations

import torch

from . import build, layout
from .common import epeg_toeplitz, mm_round
from .folds import ROWS, WEIGHT, fold_plain, folds
from .region_attn import check_heads, check_qkv

QUERY_TILE = 64    # rows of one block of the query-side kernel
CHUNK = 64         # the cores' column chunk: a head is ceil(hd / 64) of them
# 64-wide dq chunks one query-side block owns with bf16 products when the
# head has an even number of them: half the blocks, each logit tile formed
# once for two chunks (at hd = 512, B = 8 one wave of blocks, not two);
# chip_smoke.py times 1 against 2 at hd = 512
DQ_CHUNKS = 2


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


def attention_bwd_launch(lib, tm, ti, to, ops, r, h, hd, p, grid, rs, w, b,
                         kk, scale, dev, stream, nf: int = 0):
    """rb_attention_bwd with its scratch; returns (dw, db) or (None, None)
    without EPEG.  `ops` holds the (pointer, region, head, token-row
    strides) descriptions of q, k, v, g (dtype code ti) and of dq, dk, dv
    (dtype code to); tm is the mm dtype code.  With nf folds (w (nf, H,
    kk)) dw and db are (nf, H, kk) and (nf, H)."""
    pw = build.f32_param(w, "pe_weight") if kk else None
    pb = build.f32_param(b, "pe_bias") if kk else None
    lead = (nf,) if nf else ()
    n = r * h * p
    stats = torch.empty((3, n), dtype=torch.float32, device=dev)
    ys = torch.empty((n, hd), dtype=torch.bfloat16, device=dev) if tm else None
    dy = part = dw = db = None
    if kk:
        nqt = -(-p // QUERY_TILE)
        dy = torch.empty((n, hd), device=dev,
                         dtype=torch.bfloat16 if tm else torch.float32)
        part = torch.empty((h, r * nqt, kk + 1), dtype=torch.float32,
                           device=dev)
        dw = torch.empty((*lead, h, kk), dtype=torch.float32, device=dev)
        if pb is not None:
            db = torch.empty((*lead, h), dtype=torch.float32, device=dev)
    qcols = DQ_CHUNKS if tm and -(-hd // CHUNK) % DQ_CHUNKS == 0 else 1
    build.check(lib.rb_attention_bwd(
        tm, ti, to, *[x for op in ops for x in op], r, h, hd, p, grid, rs,
        qcols, pw, kk, pb, scale, stats.data_ptr(), build.ptr(ys),
        build.ptr(dy), build.ptr(part), build.ptr(dw), build.ptr(db),
        r // nf if nf else 0, stream), "K7 attention backward")
    return dw, db


def _launch(q, k, v, w, b, g, scale, mmd):
    check_qkv(q, k, v)
    if g.shape != q.shape:
        raise ValueError(f"g {tuple(g.shape)} does not match q "
                         f"{tuple(q.shape)}")
    r, h, p, hd = q.shape
    nf = folds(w, 2)
    kk = check_heads(q, w[0] if nf else w)
    if nf and r % nf:
        raise ValueError(f"{r} regions do not split into {nf} folds")
    dev = q.device
    if k.dtype != q.dtype or v.dtype != q.dtype or g.dtype != q.dtype:
        raise TypeError(f"q, k, v, g must share one dtype, got {q.dtype} "
                        f"{k.dtype} {v.dtype} {g.dtype}")
    build.same_device(dev, dict(k=k, v=v, g=g, w=w if kk else None,
                                b=b if kk else None))
    ops = [(t.data_ptr(), *layout.heads(t, name))
           for name, t in (("q", q), ("k", k), ("v", v), ("g", g))]
    outs = [torch.empty((r, h, p, hd), dtype=q.dtype, device=dev)
            for _ in range(3)]
    ops += [(o.data_ptr(), h * p * hd, p * hd, hd) for o in outs]
    code = build.dtype_code(q.dtype)
    dw, db = attention_bwd_launch(
        build.load("region_layer_bwd"), build.dtype_code(mmd), code, code, ops,
        r, h, hd, p, 0, 0, w, b, kk, scale, dev, build.stream_of(q), nf)
    region_attention_bwd.launches += 1
    return (*outs, dw, db)


def region_attention_bwd(q, k, v, w, b, g, scale: float,
                         mm_dtype=torch.bfloat16):
    """(dq, dk, dv, dw, db) of `region_attention_fused`: the kernels for
    CUDA tensors, the plain version for CPU tensors; each fold's own dw, db
    with folded taps."""
    if q.device.type == "cpu":
        return fold_plain(region_attention_bwd_plain, folds(w, 2),
                          (q, k, v, w, b, g, scale, mm_dtype),
                          (ROWS,) * 3 + (WEIGHT,) * 2 + (ROWS, None, None),
                          (ROWS,) * 3 + (WEIGHT,) * 2)
    if q.device.type != "cuda":
        raise ValueError(f"region_attention_bwd: no kernel for {q.device}")
    return _launch(q, k, v, w, b, g, scale, mm_dtype)


region_attention_bwd.launches = 0
