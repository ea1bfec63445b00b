"""K3, K8, K10, K12 and K13: the CR-MSA layer's compress and redistribute,
as CUDA kernels, with the backwards K4, K9 and K11.

K3 `crmsa_compress_grid` replaces
`rrtmil_tpu/ops/pallas/crmsa_kernels.py::_compress_grid_pallas` (kernel body
`_compress_grid_kernel`, pallas_call at crmsa_kernels.py:325): LayerNorm +
mask + partition of the raw stream, then per region
logits = phi^T z^T (k, P), combine = softmax over P, dispatch = softmax over
k, mm = (logits - min) / (max - min + 1e-8); returns reps = combine @ z
(B, nR, k, C) f32 and w = mm * dispatch (B, nR, k, P) f32.

K8 `crmsa_redistribute_grid_ln` replaces `crmsa_kernels.py::_rgrid_ln_pallas`
(kernel body `_rgrid_ln_kernel`, pallas_call at crmsa_kernels.py:825):
w^T reps per region -> reverse -> mask -> + x -> + shortcut -> the
encoder-final LayerNorm -> mask, as the f32 encoder output.

The CUDA source is `csrc/crmsa.cu`; its note says what bounds each kernel on
an H100 and what the design does about it.  K3, K12 and K4 share the row
passes and layout of `csrc/crmsa.cuh`: each region's rows split over blocks
by `row_split`.  K8, K9 and K11 share its other layout, a warp a token row
and a lane four consecutive channels a group (16-byte loads), each region's
rows split over blocks (K8 by `k8_split`, K9 and K11 by `row_split`); K8 and
K9 form the stream value and its LayerNorm statistics with one device
function (`stream_ln`), so K9 recomputes K8's values bit for bit.

Their backwards: K4 `crmsa_compress_grid_bwd` replaces
`crmsa_kernels.py::_cgrid_bwd_pallas` (kernel body `_cgrid_bwd_kernel`,
pallas_call at crmsa_kernels.py:514) and K9 `crmsa_redistribute_grid_ln_bwd`
replaces `crmsa_kernels.py::_rgrid_ln_bwd_pallas` (kernel body
`_rgrid_ln_bwd_kernel`, pallas_call at crmsa_kernels.py:964); their CUDA
source is `csrc/crmsa_bwd.cu`.  The shortcut's gradient is K9's dx, the same
tensor (crmsa_kernels.py:1021).

K10 `crmsa_redistribute_grid` replaces `crmsa_kernels.py::
_redistribute_grid_pallas` (kernel body `_redistribute_grid_kernel`,
pallas_call at crmsa_kernels.py:594): K8 without the final LayerNorm,
x + mask * reverse(w^T reps) in x's dtype, or without x when add_residual is
False.  K11 `crmsa_redistribute_grid_bwd` replaces `_rgrid_bwd_pallas`
(kernel body `_rgrid_bwd_kernel`, pallas_call at crmsa_kernels.py:696): dw
and dreps of K10, as K9's kernel without the LayerNorm (one template); K10's
dx is g itself, or nothing, in its Function (crmsa_kernels.py:725).  K10's
source is `csrc/crmsa.cu`, K11's `csrc/crmsa_bwd.cu`.

K12 `crmsa_compress` replaces `_compress_pallas` (kernel body
`_compress_kernel`, pallas_call at crmsa_kernels.py:103): K3's math on
regions that are already partitioned, (R, P, C), with no LayerNorm or mask.
K13 `crmsa_redistribute` replaces `_redistribute_pallas` (kernel body
`_redistribute_kernel`, pallas_call at crmsa_kernels.py:165): w_r^T reps_r
as fp32 (R, P, C).  Both live in `csrc/crmsa.cu`.  As in the JAX package,
neither has a backward kernel: their Functions' backwards are autograd
through the plain forwards (`_compress_ref`, `_redistribute_ref`), which on
the card are PyTorch ops.

The forward wrappers are `torch.autograd.Function`s (K3 with K4, K8 with K9,
K10 with K11, K12 and K13 with the plain vjp).  Every wrapper launches its
kernel for a CUDA tensor and runs the plain version for a CPU tensor.

Folds (`folds.py`): under `torch.func.vmap` the streams hold each fold's
bags (K3, K4, K8, K9, K10, K11) or regions (K12, K13) in turn, and the
LayerNorms and phi stack on a leading fold axis (ln_s (K, C), phi (K, C,
k)).  Each kernel is one launch for all folds: K3 and K12 read each fold's
LayerNorm and phi, K8 its final LayerNorm, and K4 and K9 sum each fold's
dls, dlb, dphi over that fold's blocks alone, in one fold's order.  K10,
K11 and K13 carry no weights: the folds are more bags or regions to them.
K12's backward (autograd through its plain version) runs under
`torch.func.vmap` over the folds.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..regions import region_partition, region_reverse
from . import build
from .common import (LN_EPS, ln_bwd_plain, ln_fast, ln_mask_plain, ln_stats,
                     mm_round)
from .folds import (ROWS, WEIGHT, FoldFunction, fold_plain, folds,
                    vmap_rule)
from .region_layer import SMS, check_grid

MAX_K = 16  # representatives per region the kernels take (crmsa_k)
SPLIT_ROWS = 8           # rows a round of a split block takes (a warp each)
SPLIT_BLOCKS_PER_SM = 2  # blocks the row split gives every SM at least
K8_ROWS = 64             # token rows a K8 block takes at most (8 a warp)


def row_split(regions: int, p: int, sms: int = SMS) -> int:
    """Token rows of a region per block of the row-split kernels (K3, K4,
    K9, K11, K12): each region's p rows split over enough blocks that
    regions x blocks >= SPLIT_BLOCKS_PER_SM blocks an SM (or one block a
    round of SPLIT_ROWS rows, when p is too short for that); a multiple of
    SPLIT_ROWS.  Block i of a region takes rows i * chunk .. min(p, (i + 1)
    * chunk) - 1."""
    steps = -(-p // SPLIT_ROWS)
    need = max(1, -(-SPLIT_BLOCKS_PER_SM * sms // regions))
    return max(1, steps // need) * SPLIT_ROWS


def k8_split(regions: int, p: int, sms: int = SMS) -> int:
    """Token rows of a region per K8 block: `row_split`'s chunk, cut to
    K8_ROWS.  K8 sums nothing across rows, so a chunk costs only the
    staging of round(reps) and round(w) a block; the cap was picked from
    K8's device time at caps 16, 32, 64 and none on an H100 (PERF.md)."""
    return min(row_split(regions, p, sms), K8_ROWS)


def compress_grid_plain(x, mask, ln_s, ln_b, phi, grid_side: int,
                        region_size: int, mm_dtype=torch.bfloat16):
    """Plain PyTorch version of K3."""
    b, n, c = x.shape
    g, rs = grid_side, region_size
    nr = (g // rs) ** 2
    z = mm_round(ln_mask_plain(x, mask, ln_s, ln_b), mm_dtype)
    regions = region_partition(z.reshape(b, g, g, c), rs).reshape(b, nr, -1, c)
    logits = torch.einsum("brpc,ck->brkp", regions, mm_round(phi, mm_dtype))
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    combine = e / e.sum(-1, keepdim=True)
    ed = torch.exp(logits - logits.amax(-2, keepdim=True))
    dispatch = ed / ed.sum(-2, keepdim=True)
    lmin = logits.amin(-1, keepdim=True)
    lmax = logits.amax(-1, keepdim=True)
    mm = (logits - lmin) / (lmax - lmin + 1e-8)
    reps = torch.einsum("brkp,brpc->brkc", mm_round(combine, mm_dtype), regions)
    return reps, mm * dispatch


def redistribute_grid_ln_plain(x, mask, w, reps, ln_s, ln_b, shortcut,
                               grid_side: int, region_size: int,
                               mm_dtype=torch.bfloat16):
    """Plain PyTorch version of K8."""
    b, n, c = x.shape
    g, rs = grid_side, region_size
    nr, k = w.shape[1], w.shape[2]
    y = torch.einsum("brkp,brkc->brpc", mm_round(w, mm_dtype),
                     mm_round(reps, mm_dtype))
    y = region_reverse(y.reshape(b * nr, -1, c), rs, g, g)
    mf = mask.float()[..., None]
    out = x.float() + y * mf
    if shortcut is not None:
        out = out + shortcut.float()
    return ln_fast(out, ln_s, ln_b) * mf


def compress_grid_bwd_plain(x, mask, ln_s, ln_b, phi, dreps, dw,
                            grid_side: int, region_size: int,
                            mm_dtype=torch.bfloat16):
    """Plain PyTorch version of K4: (dx, dls, dlb, dphi) given d(reps) and
    d(w); the min and max gradients are split equally among ties.  The TPU
    kernel adds d_mm / rng and the min's - sum d_mm / rng as two terms that
    cancel for a region of one token (or of tied tokens only), where rng is
    1e-8: its gradient there is float32 rounding times 1e8.  This version
    takes their difference first, which is exact there and the same sum
    elsewhere (held to jax.vjp of the XLA reference in the tests)."""
    mmd = mm_dtype
    b, n, c = x.shape
    g, rs = grid_side, region_size
    nr = (g // rs) ** 2
    mf = mask.float()[..., None]
    zhat, rstd = ln_stats(x.float())
    z = mm_round((zhat * ln_s.float() + ln_b.float()) * mf, mmd)
    zr = region_partition(z.reshape(b, g, g, c), rs).reshape(b, nr, -1, c)
    logits = torch.einsum("brpc,ck->brkp", zr, mm_round(phi, mmd))
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    combine = e / e.sum(-1, keepdim=True)
    ed = torch.exp(logits - logits.amax(-2, keepdim=True))
    dispatch = ed / ed.sum(-2, keepdim=True)
    lmin = logits.amin(-1, keepdim=True)
    lmax = logits.amax(-1, keepdim=True)
    rng = lmax - lmin + 1e-8
    lz = logits - lmin
    drm = mm_round(dreps, mmd)
    dwf = dw.float()
    d_comb = torch.einsum("brkc,brpc->brkp", drm, zr)
    d_mm, d_disp = dwf * dispatch, dwf * (lz / rng)
    dl = combine * (d_comb - (d_comb * combine).sum(-1, keepdim=True))
    dl = dl + dispatch * (d_disp - (d_disp * dispatch).sum(-2, keepdim=True))
    # the min-max backward: d_mm / rng, minus the sum of d_mm (lz - rng) /
    # rng^2 on the min and plus - sum d_mm lz / rng^2 on the max, each split
    # equally among tied tokens; the first two are gathered as (d_mm -
    # sum d_mm / n_min) / rng, so a region whose tokens all tie (one token,
    # or only pad rows) cancels exactly instead of through two terms of
    # d_mm / 1e-8
    eqmin = (logits == lmin).float()
    eqmax = (logits == lmax).float()
    nmin = eqmin.sum(-1, keepdim=True)
    nmax = eqmax.sum(-1, keepdim=True)
    s3 = (d_mm * lz).sum(-1, keepdim=True)
    dl = dl + (d_mm - eqmin * d_mm.sum(-1, keepdim=True) / nmin) / rng
    dl = dl + (eqmin / nmin - eqmax / nmax) * s3 / (rng * rng)
    dlm = mm_round(dl, mmd)
    dzr = (torch.einsum("brkp,brkc->brpc", mm_round(combine, mmd), drm)
           + torch.einsum("brkp,ck->brpc", dlm, phi.float()))
    dphi = torch.einsum("brkp,brpc->ck", dlm, zr)
    dz = region_reverse(dzr.reshape(b * nr, -1, c), rs, g, g)
    dx, dls, dlb = ln_bwd_plain(dz * mf, zhat, rstd, ln_s)
    return dx.to(x.dtype), dls, dlb, dphi


def redistribute_grid_ln_bwd_plain(x, mask, w, reps, ln_s, ln_b, shortcut, g,
                                   grid_side: int, region_size: int,
                                   mm_dtype=torch.bfloat16):
    """Plain PyTorch version of K9: (dx, dw, dreps, dls, dlb, dshortcut)
    given g = d(out); dshortcut is dx itself (None without a shortcut)."""
    mmd = mm_dtype
    b, n, c = x.shape
    gs, rs = grid_side, region_size
    nr = w.shape[1]
    mf = mask.float()[..., None]
    y = torch.einsum("brkp,brkc->brpc", mm_round(w, mmd), mm_round(reps, mmd))
    out = x.float() + region_reverse(y.reshape(b * nr, -1, c), rs, gs, gs) * mf
    if shortcut is not None:
        out = out + shortcut.float()
    zhat, rstd = ln_stats(out)
    g_out, dls, dlb = ln_bwd_plain(g.float() * mf, zhat, rstd, ln_s)
    gr = region_partition(mm_round(g_out * mf, mmd).reshape(b, gs, gs, c),
                          rs).reshape(b, nr, -1, c)
    dw = torch.einsum("brkc,brpc->brkp", mm_round(reps, mmd), gr)
    dreps = torch.einsum("brkp,brpc->brkc", mm_round(w, mmd), gr)
    dx = g_out.to(x.dtype)
    return dx, dw, dreps, dls, dlb, (None if shortcut is None else dx)


def check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the CR-MSA kernels take 1..{MAX_K} "
                         f"representatives, not {k}")


def _compress_scratch(r, p, c, k, dev, per_row: int):
    """(scratch, part, chunk) of K3 / K12 on r regions of p rows: the row
    split, and one float32 allocation for the rows' scratch (per_row floats
    a row: K3's k logits and LayerNorm statistics, K12's k logits) and, with
    more than one chunk a region, the blocks' partial reps (parts, R, k, C);
    part is None with one chunk (reps are written in place)."""
    chunk = row_split(r, p)
    parts = -(-p // chunk)
    rows = r * per_row * p
    scratch = torch.empty((rows + (parts * r * k * c if parts > 1 else 0),),
                          dtype=torch.float32, device=dev)
    return scratch[:rows], (scratch[rows:] if parts > 1 else None), chunk


def _rgrid_bwd_buffers(r, p, c, k, dev, ln: bool = False, nf: int = 0):
    """(dw, dreps, dln, part, chunk) of K9 (ln) or K11 on r regions of p
    rows: the row split, and one float32 allocation for dw (r k p), dreps
    (r k c), K9's summed dls | dlb (2 c a fold; else None) and `part`: the
    blocks' dreps partials (chunks, r, k, c) when a region is more than one
    chunk (else the kernel writes dreps in place), then K9's dls | dlb
    partials (chunks * r, 2 c); None when empty."""
    chunk = row_split(r, p)
    parts = -(-p // chunk)
    sizes = (r * k * p, r * k * c, 2 * c * max(nf, 1) if ln else 0,
             (parts * r * k * c if parts > 1 else 0)
             + (parts * r * 2 * c if ln else 0))
    buf = torch.empty((sum(sizes),), dtype=torch.float32, device=dev)
    views, at = [], 0
    for n in sizes:
        views.append(buf[at:at + n] if n else None)
        at += n
    return (*views, chunk)


def _fold_split(b: int, nf: int) -> int:
    """The bags a fold of b bags in nf folds (0 without folds)."""
    if nf and b % nf:
        raise ValueError(f"{b} bags do not split into {nf} folds")
    return b // nf if nf else 0


def _launch_compress(x, mask, ln_s, ln_b, phi, g, rs, mmd):
    b, n, c = x.shape
    k = phi.shape[-1]
    bf = _fold_split(b, folds(phi, 2))
    check_grid(x, mask, g, rs)
    check_k(k)
    build.require_cuda({"x": x, "mask": mask},
                       dict(ln_s=ln_s, ln_b=ln_b, phi=phi))
    lib = build.load("crmsa")
    nr, p = (g // rs) ** 2, rs * rs
    ls, lb = ln_s.float().contiguous(), ln_b.float().contiguous()
    phi_f = phi.float().contiguous()
    reps = torch.empty((b, nr, k, c), dtype=torch.float32, device=x.device)
    w = torch.empty((b, nr, k, p), dtype=torch.float32, device=x.device)
    scratch, part, chunk = _compress_scratch(b * nr, p, c, k, x.device, k + 2)
    build.check(lib.cr_compress_grid(
        build.dtype_code(x.dtype), build.dtype_code(mmd), x.data_ptr(),
        mask.data_ptr(), ls.data_ptr(), lb.data_ptr(), phi_f.data_ptr(),
        reps.data_ptr(), w.data_ptr(), scratch.data_ptr(), build.ptr(part), b,
        g, rs, c, k, chunk, LN_EPS, bf, build.stream_of(x)), "K3 compress")
    crmsa_compress_grid.launches += 1
    return reps, w


def _check_redistribute(x, mask, w, reps, shortcut, g, rs):
    b, n, c = x.shape
    nr, k = w.shape[1], w.shape[2]
    check_grid(x, mask, g, rs)
    check_k(k)
    if (w.shape != (b, (g // rs) ** 2, k, rs * rs)
            or reps.shape != (b, nr, k, c)):
        raise ValueError(f"w {tuple(w.shape)} / reps {tuple(reps.shape)} do "
                         f"not match the {g}^2 grid of {rs}-wide regions")
    if shortcut is not None and (shortcut.shape != x.shape
                                 or shortcut.dtype != x.dtype):
        raise ValueError("shortcut must match x in shape and dtype")
    if w.dtype != torch.float32 or reps.dtype != torch.float32:
        raise TypeError("w and reps must be float32")


def _launch_redistribute(x, mask, w, reps, ln_s, ln_b, shortcut, g, rs, mmd):
    b, n, c = x.shape
    k = w.shape[2]
    bf = _fold_split(b, folds(ln_s, 1))
    _check_redistribute(x, mask, w, reps, shortcut, g, rs)
    build.require_cuda({"x": x, "mask": mask, "w": w, "reps": reps,
                        "shortcut": shortcut}, dict(ln_s=ln_s, ln_b=ln_b))
    _check_vector_rows(c, x, shortcut)
    lib = build.load("crmsa")
    ls, lb = ln_s.float().contiguous(), ln_b.float().contiguous()
    out = torch.empty((b, n, c), dtype=torch.float32, device=x.device)
    build.check(lib.cr_redistribute_ln(
        build.dtype_code(x.dtype), build.dtype_code(mmd), x.data_ptr(),
        mask.data_ptr(), w.data_ptr(), reps.data_ptr(), ls.data_ptr(),
        lb.data_ptr(), build.ptr(shortcut), out.data_ptr(), b, g, rs, c, k,
        k8_split(b * (g // rs) ** 2, rs * rs), LN_EPS, bf, build.stream_of(x)),
        "K8 redistribute")
    crmsa_redistribute_grid_ln.launches += 1
    return out


def _launch_compress_bwd(x, mask, ln_s, ln_b, phi, dreps, dw, g, rs, mmd):
    b, n, c = x.shape
    k = phi.shape[-1]
    nf = folds(phi, 2)
    bf = _fold_split(b, nf)
    check_grid(x, mask, g, rs)
    check_k(k)
    nr, p = (g // rs) ** 2, rs * rs
    if dreps.shape != (b, nr, k, c) or dw.shape != (b, nr, k, p):
        raise ValueError(f"dreps {tuple(dreps.shape)} / dw {tuple(dw.shape)} "
                         f"do not match the {g}^2 grid of {rs}-wide regions")
    dreps, dw = dreps.float().contiguous(), dw.float().contiguous()
    build.require_cuda({"x": x, "mask": mask, "dreps": dreps, "dw": dw},
                       dict(ln_s=ln_s, ln_b=ln_b, phi=phi))
    lib = build.load("crmsa_bwd")
    ls, lb = ln_s.float().contiguous(), ln_b.float().contiguous()
    phi_f = phi.float().contiguous()
    dx = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    r = b * nr
    chunk = row_split(r, p)
    parts = -(-p // chunk)
    # one allocation: the rows' scratch (logits, d_comb and the LayerNorm
    # backward's two row sums, k each, and the LayerNorm statistics), the
    # blocks' partials (parts * R, (2 + k) C) and the summed (dls | dlb |
    # dphi^T), one row a fold
    rows, wide = r * (4 * k + 2) * p, parts * r * (2 + k) * c
    scratch = torch.empty((rows + wide + max(nf, 1) * (2 + k) * c,), **f32)
    out = scratch[rows + wide:].view(max(nf, 1), 2 + k, c)
    build.check(lib.cb_compress_grid_bwd(
        build.dtype_code(x.dtype), build.dtype_code(mmd), x.data_ptr(),
        mask.data_ptr(), ls.data_ptr(), lb.data_ptr(), phi_f.data_ptr(),
        dreps.data_ptr(), dw.data_ptr(), dx.data_ptr(), scratch.data_ptr(),
        scratch[rows:].data_ptr(), out.data_ptr(), b, g, rs, c, k, chunk,
        LN_EPS, bf, build.stream_of(x)), "K4 compress backward")
    crmsa_compress_grid_bwd.launches += 1
    if not nf:
        out = out[0]
    return (dx, out[..., 0, :], out[..., 1, :],
            out[..., 2:, :].transpose(-1, -2))


def _launch_redistribute_bwd(x, mask, w, reps, ln_s, ln_b, shortcut, gout,
                             g, rs, mmd):
    b, n, c = x.shape
    nr, k, p = w.shape[1], w.shape[2], w.shape[3]
    nf = folds(ln_s, 1)
    bf = _fold_split(b, nf)
    _check_redistribute(x, mask, w, reps, shortcut, g, rs)
    if gout.shape != x.shape:
        raise ValueError(f"g {tuple(gout.shape)} does not match x")
    gout = gout.float().contiguous()
    build.require_cuda({"x": x, "mask": mask, "w": w, "reps": reps,
                        "shortcut": shortcut, "g": gout},
                       dict(ln_s=ln_s, ln_b=ln_b))
    _check_vector_rows(c, x, shortcut, gout)
    lib = build.load("crmsa_bwd")
    ls = ln_s.float().contiguous()
    dx = torch.empty_like(x)
    dw, dreps, out, part, chunk = _rgrid_bwd_buffers(b * nr, p, c, k,
                                                     x.device, ln=True, nf=nf)
    build.check(lib.cb_redistribute_ln_bwd(
        build.dtype_code(x.dtype), build.dtype_code(mmd), x.data_ptr(),
        mask.data_ptr(), w.data_ptr(), reps.data_ptr(), ls.data_ptr(),
        build.ptr(shortcut), gout.data_ptr(), dx.data_ptr(), dw.data_ptr(),
        dreps.data_ptr(), out.data_ptr(), part.data_ptr(), b, g, rs, c, k,
        chunk, LN_EPS, bf, build.stream_of(x)), "K9 redistribute backward")
    crmsa_redistribute_grid_ln_bwd.launches += 1
    out = out.view(nf, 2, c) if nf else out.view(2, c)
    return (dx, dw.view(b, nr, k, p), dreps.view(b, nr, k, c),
            out[..., 0, :], out[..., 1, :], None if shortcut is None else dx)


def _device(x, what: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for {x.device}")
    return x.device.type


# the fold forms (folds.py) of the Functions' inputs
_CGRID_KINDS = (ROWS, ROWS, WEIGHT, WEIGHT, WEIGHT, None, None, None)
_RGRID_LN_KINDS = (ROWS,) * 4 + (WEIGHT, WEIGHT, ROWS) + (None,) * 3


def crmsa_compress_grid_bwd(x, mask, ln_s, ln_b, phi, dreps, dw,
                            grid_side: int, region_size: int,
                            mm_dtype=torch.bfloat16):
    """K4 for CUDA tensors, its plain version for CPU tensors: (dx, dls,
    dlb, dphi) of `crmsa_compress_grid`, each fold's own with folds."""
    args = (x, mask, ln_s, ln_b, phi, dreps, dw, grid_side, region_size,
            mm_dtype)
    if _device(x, "crmsa_compress_grid_bwd") == "cpu":
        return fold_plain(compress_grid_bwd_plain, folds(phi, 2), args,
                          _CGRID_KINDS[:5] + (ROWS, ROWS, None, None, None),
                          (ROWS, WEIGHT, WEIGHT, WEIGHT))
    return _launch_compress_bwd(*args)


def crmsa_redistribute_grid_ln_bwd(x, mask, w, reps, ln_s, ln_b, shortcut, g,
                                   grid_side: int, region_size: int,
                                   mm_dtype=torch.bfloat16):
    """K9 for CUDA tensors, its plain version for CPU tensors: (dx, dw,
    dreps, dls, dlb, dshortcut) of `crmsa_redistribute_grid_ln`, each
    fold's own dls, dlb with folds."""
    args = (x, mask, w, reps, ln_s, ln_b, shortcut, g, grid_side,
            region_size, mm_dtype)
    if _device(x, "crmsa_redistribute_grid_ln_bwd") == "cpu":
        return fold_plain(redistribute_grid_ln_bwd_plain, folds(ln_s, 1),
                          args, _RGRID_LN_KINDS[:7] + (ROWS, None, None, None),
                          (ROWS, ROWS, ROWS, WEIGHT, WEIGHT, ROWS))
    return _launch_redistribute_bwd(*args)


class _CompressGrid(FoldFunction):
    """K3 forward, K4 backward (plain versions on the CPU); under vmap,
    one call for every fold."""

    @staticmethod
    def forward(x, mask, ln_s, ln_b, phi, grid_side, region_size, mm_dtype):
        args = (x, mask, ln_s, ln_b, phi, grid_side, region_size, mm_dtype)
        if x.device.type == "cpu":
            return fold_plain(compress_grid_plain, folds(phi, 2), args,
                              _CGRID_KINDS, (ROWS, ROWS))
        return _launch_compress(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:5])
        ctx.geom = inputs[5:]

    @staticmethod
    def vmap(info, in_dims, *args):
        return vmap_rule(_CompressGrid.apply, info, in_dims, args,
                         _CGRID_KINDS)

    @staticmethod
    def backward(ctx, dreps, dw):
        x, mask, ln_s, ln_b, phi = ctx.saved_tensors
        g, rs, mmd = ctx.geom
        # autograd hands None for an output nobody used
        b, nr, k = x.shape[0], (g // rs) ** 2, phi.shape[-1]
        if dreps is None:
            dreps = x.new_zeros((b, nr, k, x.shape[2]), dtype=torch.float32)
        if dw is None:
            dw = x.new_zeros((b, nr, k, rs * rs), dtype=torch.float32)
        dx, dls, dlb, dphi = crmsa_compress_grid_bwd(
            x, mask, ln_s, ln_b, phi, dreps, dw, g, rs, mmd)
        return dx, None, dls, dlb, dphi, None, None, None


class _RedistributeGridLN(FoldFunction):
    """K8 forward, K9 backward (plain versions on the CPU); under vmap,
    one call for every fold."""

    @staticmethod
    def forward(x, mask, w, reps, ln_s, ln_b, shortcut, grid_side,
                region_size, mm_dtype):
        args = (x, mask, w, reps, ln_s, ln_b, shortcut, grid_side,
                region_size, mm_dtype)
        if x.device.type == "cpu":
            return fold_plain(redistribute_grid_ln_plain, folds(ln_s, 1), args,
                              _RGRID_LN_KINDS, (ROWS,))
        return _launch_redistribute(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:7])
        ctx.geom = inputs[7:]

    @staticmethod
    def vmap(info, in_dims, *args):
        return vmap_rule(_RedistributeGridLN.apply, info, in_dims, args,
                         _RGRID_LN_KINDS)

    @staticmethod
    def backward(ctx, g):
        x, mask, w, reps, ln_s, ln_b, shortcut = ctx.saved_tensors
        dx, dw, dreps, dls, dlb, dsc = crmsa_redistribute_grid_ln_bwd(
            x, mask, w, reps, ln_s, ln_b, shortcut, g, *ctx.geom)
        return dx, None, dw, dreps, dls, dlb, dsc, None, None, None


def crmsa_compress_grid(x, mask, ln_s, ln_b, phi, grid_side: int,
                        region_size: int, mm_dtype=torch.bfloat16):
    """Raw stream (B, G*G, C) + mask -> (reps (B, nR, k, C), w (B, nR, k, P)),
    both float32; LayerNorm/mask/partition fused in.  phi: (C, k)."""
    _device(x, "crmsa_compress_grid")
    return _CompressGrid.apply(x, mask, ln_s, ln_b, phi, grid_side,
                               region_size, mm_dtype)


def crmsa_redistribute_grid_ln(x, mask, w, reps, ln_s, ln_b,
                               shortcut: Optional[torch.Tensor],
                               grid_side: int, region_size: int,
                               mm_dtype=torch.bfloat16):
    """Redistribution + residual (+ optional global shortcut) + the
    encoder-final LayerNorm + mask; returns the float32 encoder output
    (B, G*G, C).  w (B, nR, k, P) and reps (B, nR, k, C) are float32."""
    _device(x, "crmsa_redistribute_grid_ln")
    return _RedistributeGridLN.apply(x, mask, w, reps, ln_s, ln_b, shortcut,
                                     grid_side, region_size, mm_dtype)


# ---------------------------------------------------------------------------
# K12 / K13: compress and redistribute of already-partitioned regions
# ---------------------------------------------------------------------------

def compress_plain(x, phi, mm_dtype=torch.bfloat16):
    """Plain PyTorch version of K12 (`_compress_ref`): x (R, P, C), phi
    (C, k) -> (reps (R, k, C), w (R, k, P)), both float32.  Autograd through
    it is K12's backward: amin/amax split a tie's gradient equally, as
    jnp.min/max do (the bucket's zero rows tie at logit 0)."""
    xm = mm_round(x, mm_dtype)
    logits = torch.einsum("rpc,ck->rkp", xm, mm_round(phi, mm_dtype))
    combine = torch.softmax(logits, dim=-1)
    dispatch = torch.softmax(logits, dim=-2)
    lmin = logits.amin(-1, keepdim=True)
    lmax = logits.amax(-1, keepdim=True)
    mm = (logits - lmin) / (lmax - lmin + 1e-8)
    reps = torch.einsum("rkp,rpc->rkc", mm_round(combine, mm_dtype), xm)
    return reps, mm * dispatch


def redistribute_plain(w, reps, mm_dtype=torch.bfloat16):
    """Plain PyTorch version of K13 (`_redistribute_ref`, fp32 out):
    out_r = round(w_r)^T round(reps_r), (R, P, C)."""
    return torch.einsum("rkp,rkc->rpc", mm_round(w, mm_dtype),
                        mm_round(reps, mm_dtype))


def redistribute_grid_plain(x, mask, w, reps, grid_side: int,
                            region_size: int, add_residual: bool,
                            mm_dtype=torch.bfloat16):
    """Plain PyTorch version of K10 (`_redistribute_grid_ref`)."""
    b, n, c = x.shape
    nr = w.shape[1]
    y = torch.einsum("brkp,brkc->brpc", mm_round(w, mm_dtype),
                     mm_round(reps, mm_dtype))
    y = region_reverse(y.reshape(b * nr, -1, c), region_size, grid_side,
                       grid_side) * mask.float()[..., None]
    if add_residual:
        y = x.float() + y
    return y.to(x.dtype)


def redistribute_grid_bwd_plain(mask, w, reps, g, grid_side: int,
                                region_size: int, mm_dtype=torch.bfloat16):
    """Plain PyTorch version of K11 (`_rgrid_bwd_kernel`'s rounding): (dw,
    dreps) given g = d(out), with gm = round(g * mask)."""
    b, n, c = g.shape
    nr = w.shape[1]
    gm = mm_round(g.float() * mask.float()[..., None], mm_dtype)
    gr = region_partition(gm.reshape(b, grid_side, grid_side, c),
                          region_size).reshape(b, nr, -1, c)
    dw = torch.einsum("brkc,brpc->brkp", mm_round(reps, mm_dtype), gr)
    dreps = torch.einsum("brkp,brpc->brkc", mm_round(w, mm_dtype), gr)
    return dw, dreps


MAX_C = 1024   # channels the K8-K13 kernels take (32 x CPL in common.cuh)


def _check_vector_rows(c: int, *tensors) -> None:
    """K8-K11 and K13 move four channels a lane at a time: C % 4 == 0,
    C <= MAX_C and 16-byte aligned streams."""
    if c % 4 or c > MAX_C:
        raise ValueError(f"the redistribute kernels take C % 4 == 0 and "
                         f"C <= {MAX_C} channels, not {c}")
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError("the redistribute kernels need 16-byte aligned "
                             "streams")


def _check_regions(w, reps):
    if w.dim() != 3 or reps.dim() != 3 or w.shape[:2] != reps.shape[:2]:
        raise ValueError(f"w {tuple(w.shape)} / reps {tuple(reps.shape)} are "
                         f"not (R, k, P) / (R, k, C)")
    if w.dtype != torch.float32 or reps.dtype != torch.float32:
        raise TypeError("w and reps must be float32")
    check_k(w.shape[1])


def _launch_compress_regions(x, phi, mmd):
    r, p, c = x.shape
    k = phi.shape[-1]
    rf = _fold_split(r, folds(phi, 2))
    check_k(k)
    if c > MAX_C or phi.shape[-2] != c:
        raise ValueError(f"K12 takes phi (C, k) with C <= {MAX_C}, not "
                         f"{tuple(phi.shape)} for x {tuple(x.shape)}")
    build.require_cuda({"x": x}, dict(phi=phi))
    lib = build.load("crmsa")
    phi_f = phi.float().contiguous()
    reps = torch.empty((r, k, c), dtype=torch.float32, device=x.device)
    w = torch.empty((r, k, p), dtype=torch.float32, device=x.device)
    scratch, part, chunk = _compress_scratch(r, p, c, k, x.device, k)
    build.check(lib.cr_compress(
        build.dtype_code(x.dtype), build.dtype_code(mmd), x.data_ptr(),
        phi_f.data_ptr(), reps.data_ptr(), w.data_ptr(), scratch.data_ptr(),
        build.ptr(part), r, p, c, k, chunk, rf, build.stream_of(x)),
        "K12 compress")
    crmsa_compress.launches += 1
    return reps, w


def _launch_redistribute_regions(w, reps, mmd):
    _check_regions(w, reps)
    r, k, p = w.shape
    c = reps.shape[2]
    build.require_cuda({"w": w, "reps": reps}, {})
    _check_vector_rows(c)
    lib = build.load("crmsa")
    out = torch.empty((r, p, c), dtype=torch.float32, device=w.device)
    build.check(lib.cr_redistribute(
        build.dtype_code(torch.float32), build.dtype_code(mmd), None, None,
        w.data_ptr(), reps.data_ptr(), out.data_ptr(), r, 0, 1, p, c, k,
        build.stream_of(w)), "K13 redistribute")
    crmsa_redistribute.launches += 1
    return out


def _launch_redistribute_grid(x, mask, w, reps, g, rs, add_residual, mmd):
    b, n, c = x.shape
    k = w.shape[2]
    _check_redistribute(x, mask, w, reps, None, g, rs)
    build.require_cuda({"x": x, "mask": mask, "w": w, "reps": reps}, {})
    _check_vector_rows(c, x)
    lib = build.load("crmsa")
    out = torch.empty_like(x)
    build.check(lib.cr_redistribute(
        build.dtype_code(x.dtype), build.dtype_code(mmd),
        x.data_ptr() if add_residual else None, mask.data_ptr(), w.data_ptr(),
        reps.data_ptr(), out.data_ptr(), b * (g // rs) ** 2, g, rs, rs * rs, c,
        k, build.stream_of(x)), "K10 redistribute")
    crmsa_redistribute_grid.launches += 1
    return out


def _launch_redistribute_grid_bwd(mask, w, reps, gout, g, rs, mmd):
    b, n, c = gout.shape
    nr, k, p = w.shape[1], w.shape[2], w.shape[3]
    gout = gout.contiguous()
    _check_redistribute(gout, mask, w, reps, None, g, rs)
    build.require_cuda({"g": gout, "mask": mask, "w": w, "reps": reps}, {})
    _check_vector_rows(c, gout)
    lib = build.load("crmsa_bwd")
    dw, dreps, _, part, chunk = _rgrid_bwd_buffers(b * nr, p, c, k,
                                                   gout.device)
    build.check(lib.cb_redistribute_grid_bwd(
        build.dtype_code(gout.dtype), build.dtype_code(mmd), gout.data_ptr(),
        mask.data_ptr(), w.data_ptr(), reps.data_ptr(), dw.data_ptr(),
        dreps.data_ptr(), build.ptr(part), b, g, rs, c, k, chunk,
        build.stream_of(gout)), "K11 redistribute backward")
    crmsa_redistribute_grid_bwd.launches += 1
    return dw.view(b, nr, k, p), dreps.view(b, nr, k, c)


def _vjp(plain, inputs, needs, grads, mmd, nf: int = 0):
    """The gradients of `inputs` (those `needs` names) through plain(*inputs,
    mm_dtype=mmd) at `grads`; with nf folds (x's leading axis split into nf
    runs, the other inputs stacked) the plain version runs under
    torch.func.vmap over the folds."""
    inputs = [t.detach().requires_grad_(need) for t, need in
              zip(inputs, needs)]
    live = [t for t in inputs if t.requires_grad]
    if not live:
        return tuple(None for _ in inputs)
    with torch.enable_grad():
        if nf:
            x = inputs[0]
            out = torch.func.vmap(lambda *a: plain(*a, mm_dtype=mmd))(
                x.reshape(nf, x.shape[0] // nf, *x.shape[1:]), *inputs[1:])
            out = tuple(o.reshape(-1, *o.shape[2:]) for o in out)
        else:
            out = plain(*inputs, mm_dtype=mmd)
    got = iter(torch.autograd.grad(out, live, grads, allow_unused=True))
    return tuple(next(got) if t.requires_grad else None for t in inputs)


def _plain_vjp(plain, ctx, grads):
    """The backward of a Function whose gradient is autograd through its
    plain forward: the saved inputs, the plain forward recomputed."""
    return _vjp(plain, ctx.saved_tensors, ctx.needs_input_grad, grads,
                ctx.mmd)


class _Compress(FoldFunction):
    """K12 forward; backward the vjp of `compress_plain`; under vmap, one
    call for every fold (phi (K, C, k))."""

    @staticmethod
    def forward(x, phi, mm_dtype):
        if x.device.type == "cpu":
            return fold_plain(compress_plain, folds(phi, 2),
                              (x, phi, mm_dtype), (ROWS, WEIGHT, None),
                              (ROWS, ROWS))
        return _launch_compress_regions(x, phi, mm_dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], inputs[1])
        ctx.mmd = inputs[2]

    @staticmethod
    def vmap(info, in_dims, *args):
        return vmap_rule(_Compress.apply, info, in_dims, args,
                         (ROWS, WEIGHT, None))

    @staticmethod
    def backward(ctx, dreps, dw):
        x, phi = ctx.saved_tensors
        nf = folds(phi, 2)
        if not nf:
            return _plain_vjp(compress_plain, ctx, (dreps, dw)) + (None,)
        if dreps is None:
            dreps = torch.zeros((x.shape[0], phi.shape[-1], x.shape[2]),
                                device=x.device)
        if dw is None:
            dw = torch.zeros((x.shape[0], phi.shape[-1], x.shape[1]),
                             device=x.device)
        grads = _vjp(compress_plain, (x, phi), ctx.needs_input_grad[:2],
                     (dreps, dw), ctx.mmd, nf)
        return (*grads, None)


class _Redistribute(FoldFunction):
    """K13 forward; backward the vjp of `redistribute_plain`.  No
    weights: under vmap the folds' regions are one call's."""

    @staticmethod
    def forward(w, reps, mm_dtype):
        if w.device.type == "cpu":
            return redistribute_plain(w, reps, mm_dtype)
        return _launch_redistribute_regions(w, reps, mm_dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], inputs[1])
        ctx.mmd = inputs[2]

    @staticmethod
    def vmap(info, in_dims, *args):
        return vmap_rule(_Redistribute.apply, info, in_dims, args,
                         (ROWS, ROWS, None))

    @staticmethod
    def backward(ctx, g):
        return _plain_vjp(redistribute_plain, ctx, (g,)) + (None,)


def crmsa_redistribute_grid_bwd(mask, w, reps, g, grid_side: int,
                                region_size: int, mm_dtype=torch.bfloat16):
    """K11 for CUDA tensors, its plain version for CPU tensors: (dw, dreps)
    of `crmsa_redistribute_grid` given g = d(out)."""
    args = (mask, w, reps, g, grid_side, region_size, mm_dtype)
    if _device(g, "crmsa_redistribute_grid_bwd") == "cpu":
        return redistribute_grid_bwd_plain(*args)
    return _launch_redistribute_grid_bwd(*args)


class _RedistributeGrid(FoldFunction):
    """K10 forward, K11 backward (plain versions on the CPU).  dx is g
    itself with the residual; without it x gets no gradient (None, autograd's
    zero), as the JAX backward's zeros_like (crmsa_kernels.py:725).  No
    weights: under vmap the folds' bags are one call's."""

    @staticmethod
    def forward(x, mask, w, reps, grid_side, region_size, add_residual,
                mm_dtype):
        args = (x, mask, w, reps, grid_side, region_size, add_residual,
                mm_dtype)
        if x.device.type == "cpu":
            return redistribute_grid_plain(*args)
        return _launch_redistribute_grid(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, mask, w, reps, grid_side, region_size, add_residual, mmd = inputs
        ctx.save_for_backward(mask, w, reps)
        ctx.geom = (grid_side, region_size, mmd)
        ctx.add_residual, ctx.x_dtype = add_residual, x.dtype

    @staticmethod
    def vmap(info, in_dims, *args):
        return vmap_rule(_RedistributeGrid.apply, info, in_dims, args,
                         (ROWS,) * 4 + (None,) * 4)

    @staticmethod
    def backward(ctx, g):
        mask, w, reps = ctx.saved_tensors
        gs, rs, mmd = ctx.geom
        dw, dreps = crmsa_redistribute_grid_bwd(mask, w, reps, g, gs, rs, mmd)
        dx = g.to(ctx.x_dtype) if ctx.add_residual else None
        return dx, None, dw, dreps, None, None, None, None


def crmsa_compress(x, phi, mm_dtype=torch.bfloat16):
    """Partitioned regions x (R, P, C) and phi (C, k) -> (reps (R, k, C),
    w (R, k, P)), both float32."""
    _device(x, "crmsa_compress")
    return _Compress.apply(x, phi, mm_dtype)


def crmsa_redistribute(w, reps, mm_dtype=torch.bfloat16):
    """w (R, k, P) and reps (R, k, C), float32 -> out (R, P, C) float32."""
    _device(w, "crmsa_redistribute")
    return _Redistribute.apply(w, reps, mm_dtype)


def crmsa_redistribute_grid(x, mask, w, reps, grid_side: int,
                            region_size: int, add_residual: bool,
                            mm_dtype=torch.bfloat16):
    """Redistribution + mask (+ the layer residual) into the post-layer
    stream (B, G*G, C) in x's dtype; w (B, nR, k, P) and reps (B, nR, k, C)
    are float32."""
    _device(x, "crmsa_redistribute_grid")
    return _RedistributeGrid.apply(x, mask, w, reps, grid_side, region_size,
                                   add_residual, mm_dtype)


crmsa_compress_grid.launches = 0
crmsa_redistribute_grid_ln.launches = 0
crmsa_compress_grid_bwd.launches = 0
crmsa_redistribute_grid_ln_bwd.launches = 0
crmsa_compress.launches = 0
crmsa_redistribute.launches = 0
crmsa_redistribute_grid.launches = 0
crmsa_redistribute_grid_bwd.launches = 0
