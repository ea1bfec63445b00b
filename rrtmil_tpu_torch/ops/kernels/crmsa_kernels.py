"""K3 and K8: the CR-MSA layer's compress and redistribute, as CUDA kernels.

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
an H100 and what the design does about it.  Each wrapper launches its kernel
for a CUDA tensor and runs the plain version for a CPU tensor.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..regions import region_partition, region_reverse
from . import build
from .common import LN_EPS, forward_only, ln_fast, ln_mask_plain, mm_round
from .region_layer import check_grid

MAX_K = 8   # representatives per region the kernels take


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


def _check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the CR-MSA kernels take 1..{MAX_K} "
                         f"representatives, not {k}")


def _launch_compress(x, mask, ln_s, ln_b, phi, g, rs, mmd):
    b, n, c = x.shape
    k = phi.shape[1]
    check_grid(x, mask, g, rs)
    _check_k(k)
    build.require_cuda({"x": x, "mask": mask},
                       dict(ln_s=ln_s, ln_b=ln_b, phi=phi))
    lib = build.load("crmsa")
    nr, p = (g // rs) ** 2, rs * rs
    ls, lb = ln_s.float().contiguous(), ln_b.float().contiguous()
    phi_f = phi.float().contiguous()
    reps = torch.empty((b, nr, k, c), dtype=torch.float32, device=x.device)
    w = torch.empty((b, nr, k, p), dtype=torch.float32, device=x.device)
    build.check(lib.cr_compress_grid(
        build.dtype_code(x.dtype), build.dtype_code(mmd), x.data_ptr(),
        mask.data_ptr(), ls.data_ptr(), lb.data_ptr(), phi_f.data_ptr(),
        reps.data_ptr(), w.data_ptr(), b, g, rs, c, k, LN_EPS,
        build.stream_of(x)), "K3 compress")
    crmsa_compress_grid.launches += 1
    return reps, w


def _launch_redistribute(x, mask, w, reps, ln_s, ln_b, shortcut, g, rs, mmd):
    b, n, c = x.shape
    nr, k, p = w.shape[1], w.shape[2], w.shape[3]
    check_grid(x, mask, g, rs)
    _check_k(k)
    if (w.shape != (b, (g // rs) ** 2, k, rs * rs)
            or reps.shape != (b, nr, k, c)):
        raise ValueError(f"w {tuple(w.shape)} / reps {tuple(reps.shape)} do "
                         f"not match the {g}^2 grid of {rs}-wide regions")
    if shortcut is not None and (shortcut.shape != x.shape
                                 or shortcut.dtype != x.dtype):
        raise ValueError("shortcut must match x in shape and dtype")
    if w.dtype != torch.float32 or reps.dtype != torch.float32:
        raise TypeError("w and reps must be float32")
    build.require_cuda({"x": x, "mask": mask, "w": w, "reps": reps,
                        "shortcut": shortcut}, dict(ln_s=ln_s, ln_b=ln_b))
    lib = build.load("crmsa")
    ls, lb = ln_s.float().contiguous(), ln_b.float().contiguous()
    out = torch.empty((b, n, c), dtype=torch.float32, device=x.device)
    build.check(lib.cr_redistribute_ln(
        build.dtype_code(x.dtype), build.dtype_code(mmd), x.data_ptr(),
        mask.data_ptr(), w.data_ptr(), reps.data_ptr(), ls.data_ptr(),
        lb.data_ptr(), build.ptr(shortcut), out.data_ptr(), b, g, rs, c, k,
        LN_EPS, build.stream_of(x)), "K8 redistribute")
    crmsa_redistribute_grid_ln.launches += 1
    return out


def crmsa_compress_grid(x, mask, ln_s, ln_b, phi, grid_side: int,
                        region_size: int, mm_dtype=torch.bfloat16):
    """Raw stream (B, G*G, C) + mask -> (reps (B, nR, k, C), w (B, nR, k, P)),
    both float32; LayerNorm/mask/partition fused in.  phi: (C, k)."""
    if x.device.type == "cpu":
        return compress_grid_plain(x, mask, ln_s, ln_b, phi, grid_side,
                                   region_size, mm_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"crmsa_compress_grid: no kernel for {x.device}")
    forward_only("crmsa_compress_grid", x, ln_s, ln_b, phi)
    return _launch_compress(x, mask, ln_s, ln_b, phi, grid_side, region_size,
                            mm_dtype)


def crmsa_redistribute_grid_ln(x, mask, w, reps, ln_s, ln_b,
                               shortcut: Optional[torch.Tensor],
                               grid_side: int, region_size: int,
                               mm_dtype=torch.bfloat16):
    """Redistribution + residual (+ optional global shortcut) + the
    encoder-final LayerNorm + mask; returns the float32 encoder output
    (B, G*G, C).  w (B, nR, k, P) and reps (B, nR, k, C) are float32."""
    if x.device.type == "cpu":
        return redistribute_grid_ln_plain(x, mask, w, reps, ln_s, ln_b,
                                          shortcut, grid_side, region_size,
                                          mm_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"crmsa_redistribute_grid_ln: no kernel for "
                         f"{x.device}")
    forward_only("crmsa_redistribute_grid_ln", x, w, reps, ln_s, ln_b,
                 shortcut)
    return _launch_redistribute(x, mask, w, reps, ln_s, ln_b, shortcut,
                                grid_side, region_size, mm_dtype)


crmsa_compress_grid.launches = 0
crmsa_redistribute_grid_ln.launches = 0
