"""Position-embedding ablations of the RRT encoder (PEG / PPEG / SINCOS /
APE, `--pos` / `--pos_pos`).

Counterpart of `rrtmil_tpu/models/posemb.py` (reference
modules/emb_position.py).  The JAX package computes them in plain XLA
(depthwise convs, adds), outside any Pallas kernel, so the port runs them
as torch ops on either device.  Bags arrive padded to a bucket; PEG and
PPEG take the true `length`, work on the leading `length` rows (their
wrap-around padding copies real leading tokens up to the ceil-sqrt square)
and zero-extend back to the input's length.  SINCOS and APE follow the JAX
package's per-position semantics over the whole (square) input.  Every
output is contiguous: the R-MSA kernel (K1) reads the stream in place.

Conv weights are torch's Conv2d layout (C, 1, kh, kw), stored as raw
parameters under the flax names with `weight` for `kernel` (`weight`,
`proj_weight`, `proj1_weight`, `proj2_weight`; see convert.py).  The convs
and adds run in float32 and the result keeps x's dtype.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.inits import xavier_normal_


def square_wrap_pad(x: torch.Tensor, length: int):
    """Pad (B, L, C) to the ceil-sqrt square by wrapping leading tokens
    (emb_position.py:35-39,69-71).  Returns (padded, side, added rows)."""
    h = int(math.ceil(math.sqrt(length)))
    add = h * h - length
    if add > 0:
        x = torch.cat([x, x[:, :add]], dim=1)
    return x, h, add


def restore(x: torch.Tensor, length: int, out_length: int) -> torch.Tensor:
    x = x[:, :length]
    if out_length > length:
        x = F.pad(x, (0, 0, 0, out_length - length))
    return x


class DepthwiseConvs(nn.Module):
    """Depthwise conv kernels by name, each (C, 1, kh, kw) with a bias of
    (C,) when `bias`; flax's xavier_normal fans of a (kh, kw, 1, C)
    kernel."""

    def __init__(self, dim: int, kernels: Tuple[Tuple[str, int], ...],
                 bias: bool, conv_1d: bool):
        super().__init__()
        self.taps = []
        for name, k in kernels:
            kh, kw = (k, 1) if conv_1d else (k, k)
            self.register_parameter(f"{name}weight", nn.Parameter(
                torch.zeros(dim, 1, kh, kw)))
            self.register_parameter(f"{name}bias", nn.Parameter(
                torch.zeros(dim)) if bias else None)
            self.taps.append((name, kh, kw))

    def init_own_parameters(self, generator: torch.Generator) -> None:
        for name, kh, kw in self.taps:
            w = getattr(self, f"{name}weight")
            xavier_normal_(w, kh * kw, kh * kw * w.shape[0], generator)
            b = getattr(self, f"{name}bias")
            if b is not None:
                b.zero_()

    def conv(self, name: str, img: torch.Tensor) -> torch.Tensor:
        w = getattr(self, f"{name}weight")
        kh, kw = w.shape[2:]
        return F.conv2d(img, w, getattr(self, f"{name}bias"),
                        padding=(kh // 2, kw // 2), groups=img.shape[1])


class PEG(DepthwiseConvs):
    """One depthwise conv plus the identity (emb_position.py:60-82)."""

    def __init__(self, dim: int = 512, k: int = 7, bias: bool = True,
                 conv_1d: bool = False):
        super().__init__(dim, (("", k),), bias, conv_1d)

    def forward(self, x, length: Optional[int] = None):
        b, n, c = x.shape
        length = n if length is None else length
        xs, h, _ = square_wrap_pad(x[:, :length].float(), length)
        img = xs.transpose(1, 2).reshape(b, c, h, h)
        out = self.conv("", img) + img
        out = out.reshape(b, c, h * h).transpose(1, 2)
        return restore(out, length, n).to(x.dtype).contiguous()


class PPEG(DepthwiseConvs):
    """Pyramid PEG: parallel depthwise convs k / 5 / 3 plus the identity
    (emb_position.py:24-58), with the reference's H < 7 branch (zero rows
    up to a 7 x 7 square before the convs)."""

    def __init__(self, dim: int = 512, k: int = 7, bias: bool = True,
                 conv_1d: bool = False):
        super().__init__(dim, (("proj_", k), ("proj1_", 5), ("proj2_", 3)),
                         bias, conv_1d)

    def forward(self, x, length: Optional[int] = None):
        b, n, c = x.shape
        length = n if length is None else length
        xs, h, add = square_wrap_pad(x[:, :length].float(), length)
        if h < 7:
            xs = F.pad(xs, (0, 0, 0, 7 * 7 - (length + add)))
            h = 7
        img = xs.transpose(1, 2).reshape(b, c, h, h)
        out = img
        for name, _, _ in self.taps:
            out = out + self.conv(name, img)
        out = out.reshape(b, c, h * h).transpose(1, 2)
        return restore(out, length, n).to(x.dtype).contiguous()


def sincos_2d(embed_dim: int, grid_size: int) -> np.ndarray:
    """2-D sin-cos table (emb_position.py:90-135), float64."""
    def emb_1d(dim, pos):
        omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64)
                                / (dim / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_h = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_h, grid_h), axis=0).reshape(2, -1)
    return np.concatenate([emb_1d(embed_dim // 2, grid[0]),
                           emb_1d(embed_dim // 2, grid[1])], axis=1)


class SINCOS(nn.Module):
    """The fixed 2-D sin-cos embedding of each grid position added to the
    token there, on (B, N, C) with N a perfect square (the JAX package's
    intended semantics).  Each table is made once per (side, dtype,
    device) and kept."""

    def __init__(self, embed_dim: int = 512):
        super().__init__()
        self.embed_dim = embed_dim
        self._tables: Dict[tuple, torch.Tensor] = {}

    def forward(self, x, length: Optional[int] = None):
        h = int(round(math.sqrt(x.shape[1])))
        key = (h, x.dtype, x.device)
        if key not in self._tables:
            self._tables[key] = torch.from_numpy(
                sincos_2d(self.embed_dim, h)).to(x.device, x.dtype)
        return x + self._tables[key][None]


class APE(nn.Module):
    """A learned (num_patches, C) table added per position, zero past it
    (emb_position.py:163-171, the JAX package's semantics)."""

    def __init__(self, embed_dim: int = 512, num_patches: int = 64):
        super().__init__()
        self.absolute_pos_embed = nn.Parameter(torch.zeros(num_patches,
                                                           embed_dim))

    def init_own_parameters(self, generator: torch.Generator) -> None:
        """flax's truncated_normal(0.02): std 0.02 cut at +-2 std."""
        nn.init.trunc_normal_(self.absolute_pos_embed, 0.0, 0.02, -0.04,
                              0.04, generator=generator)

    def forward(self, x, length: Optional[int] = None):
        n = x.shape[1]
        t = self.absolute_pos_embed
        t = t[:n] if n <= t.shape[0] else F.pad(t, (0, 0, 0, n - t.shape[0]))
        return (x.float() + t[None]).to(x.dtype)


def build_pos_embedding(kind: str, dim: int, k: int, bias: bool,
                        conv_1d: bool) -> Optional[nn.Module]:
    """The encoder's `pos_embedding` for `kind`, None for 'none' (and for a
    kind the JAX package does not build, which it ignores alike)."""
    if kind == "ppeg":
        return PPEG(dim, k, bias, conv_1d)
    if kind == "peg":
        return PEG(dim, k, bias, conv_1d)
    if kind == "sincos":
        return SINCOS(dim)
    if kind == "ape":
        return APE(dim)
    return None
