"""Helpers shared by the kernels' plain PyTorch versions and wrappers."""
from __future__ import annotations

import torch

LN_EPS = 1e-6


def mm_round(t: torch.Tensor, mm_dtype: torch.dtype) -> torch.Tensor:
    """`t` rounded to the product-input dtype, held as float32: the plain
    versions multiply these in fp32, which is exact for bf16 inputs, so they
    round where the kernels round and sum in fp32 as the kernels do."""
    if mm_dtype == torch.float32:
        return t.float()
    return t.to(mm_dtype).float()


def ln_fast(xf: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float = LN_EPS) -> torch.Tensor:
    """flax LayerNorm over the last axis with fast variance:
    var = max(0, E[x^2] - E[x]^2)."""
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    z = (xf - mu) * torch.rsqrt(var + eps)
    return z * scale.float() + bias.float()


def ln_mask_plain(x: torch.Tensor, mask: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    """mask * LN(x) in float32 (B, N, C)."""
    return ln_fast(x.float(), scale, bias, eps) * mask.float()[..., None]


def epeg_toeplitz(pw: torch.Tensor, p: int) -> torch.Tensor:
    """M_h = I + T_h (H, p, p) float32: the (k, 1) query-axis EPEG conv as a
    banded Toeplitz matrix; tap t of row i reads row i + t - k//2 (a
    cross-correlation, as torch's Conv2d), taps past the region read zeros."""
    h, kk = pw.shape
    pad = kk // 2
    idx = torch.arange(p, device=pw.device)
    diff = idx[None, :] - idx[:, None]                  # j - i
    m = torch.eye(p, device=pw.device, dtype=torch.float32).expand(h, p, p)
    m = m.clone()
    for t in range(kk):
        m += pw[:, t, None, None].float() * (diff == t - pad).float()
    return m


def ln_stats(xf: torch.Tensor, eps: float = LN_EPS):
    """(zhat, rstd) of the fast-variance LayerNorm over the last axis."""
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    rstd = torch.rsqrt(var + eps)
    return (xf - mu) * rstd, rstd


def ln_bwd_plain(dzs: torch.Tensor, zhat: torch.Tensor, rstd: torch.Tensor,
                 ls: torch.Tensor):
    """Backward of y = zhat * ls + lb (fast-variance LayerNorm) given dzs =
    dL/dy (..., C) in float32: returns (dx, dls, dlb), the parameter grads
    summed over every leading axis (region_layer.py:406-415,
    crmsa_kernels.py:470-476,:899-906)."""
    dzh = dzs * ls.float()
    m1 = dzh.mean(-1, keepdim=True)
    m2 = (dzh * zhat).mean(-1, keepdim=True)
    dx = rstd * (dzh - m1 - zhat * m2)
    c = dzs.shape[-1]
    return (dx, (dzs * zhat).reshape(-1, c).sum(0),
            dzs.reshape(-1, c).sum(0))

