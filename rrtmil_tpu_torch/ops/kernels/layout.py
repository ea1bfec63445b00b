"""Operand descriptions: how the CUDA kernels read a tensor where it lies.

The kernels take a base pointer and strides in elements, with unit stride
along one axis, instead of a packed copy (`csrc/common.cuh`, `RowsA`,
`Thirds`, `Opnd`).  Each helper here checks that the kernels can read the
tensor (16-byte aligned base, the other strides multiples of 8 elements, so
every 8-element row segment is one 16-byte load) and returns its
description; a size-1 axis gets stride 0.  `gather` rebuilds a tensor from a
description with `torch.as_strided`, which is how the tests check that a
description reads what the kernels must read.
"""
from __future__ import annotations

from typing import Tuple

import torch

ALIGN = 16     # bytes: one vector load / cp.async
SEG = 8        # elements a non-unit stride must be a multiple of


def _check(t: torch.Tensor, strides, what: str) -> None:
    if (t.data_ptr() % ALIGN) or any(x % SEG for x in strides):
        raise ValueError(f"{what}: the kernels read it in place and need a "
                         f"{ALIGN}-byte aligned base and strides that are "
                         f"multiples of {SEG}, got strides {t.stride()}")


def rows(x: torch.Tensor) -> Tuple[int, int, int]:
    """(P, sr, sp) of regions x (R, P, C) with unit channel stride: row
    m = (r, p) of the (R * P, C) product operand at r * sr + p * sp."""
    r, p, c = x.shape
    sr, sp, sc = x.stride()
    sr, sp = (0 if r == 1 else sr), (0 if p == 1 else sp)
    if sc != 1 and c != 1:
        raise ValueError(f"x: the channel axis must have stride 1, got "
                         f"strides {x.stride()}")
    if (x.data_ptr() % ALIGN) or (sr | sp) % SEG:
        _check(x, (sr, sp), "x")
    return p, sr, sp


def heads(t: torch.Tensor, what: str = "q") -> Tuple[int, int, int]:
    """(sr, sh, sp) of (R, H, P, hd) with unit stride along hd (a size-1
    axis gets stride 0).  Called once per operand on every K6 launch, so
    the common case is a few integer operations."""
    r, h, p, d = t.shape
    sr, sh, sp, sd = t.stride()
    sr, sh, sp = (0 if r == 1 else sr), (0 if h == 1 else sh), \
        (0 if p == 1 else sp)
    if sd != 1 and d != 1:
        raise ValueError(f"{what}: the head axis must have stride 1, got "
                         f"strides {t.stride()}")
    if (t.data_ptr() % ALIGN) or (sr | sh | sp) % SEG:
        _check(t, (sr, sh, sp), what)
    return sr, sh, sp


def _block(t, kdiv, sk1, sk0, ndiv, sn1, sn0, what):
    if 1 not in (sk0, sn0):
        raise ValueError(f"{what}: needs stride 1 along C or the head width, "
                         f"got strides {t.stride()}")
    _check(t, [s for s in (sk1, sk0, sn1, sn0) if s != 1], what)
    return kdiv, sk1, sk0, ndiv, sn1, sn0


def stride0(t):
    """t's strides with 0 for every size-1 axis (whose stride is never
    used)."""
    return tuple(0 if n == 1 else s for n, s in zip(t.shape, t.stride()))


def qkv_cols(w: torch.Tensor, what: str = "wq") -> Tuple[int, ...]:
    """w (H, C, hd) as the (C, H * hd) product operand B[c, h * hd + d] =
    w[h, c, d]: (kdiv, sk1, sk0, ndiv, sn1, sn0), element (k, n) at
    (k // kdiv) sk1 + (k % kdiv) sk0 + (n // ndiv) sn1 + (n % ndiv) sn0."""
    h, c, hd = w.shape
    sh, sc, sd = stride0(w)
    return _block(w, c, 0, sc, hd, sh, sd, what)


def proj_rows(wp: torch.Tensor) -> Tuple[int, ...]:
    """wp (H, hd, C) as the (H * hd, C) product operand B[h * hd + d, c] =
    wp[h, d, c], described as in `qkv_cols`."""
    h, hd, c = wp.shape
    sh, sd, sc = stride0(wp)
    return _block(wp, hd, sh, sd, c, 0, sc, "wp")


def gather(t: torch.Tensor, shape, desc) -> torch.Tensor:
    """The (K, N) product operand described by `desc` (from `qkv_cols` or
    `proj_rows`), gathered from t's storage with torch.as_strided."""
    k, n = shape
    kdiv, sk1, sk0, ndiv, sn1, sn0 = desc
    return torch.as_strided(t, (k // kdiv, kdiv, n // ndiv, ndiv),
                            (sk1, sk0, sn1, sn0),
                            t.storage_offset()).reshape(k, n)
