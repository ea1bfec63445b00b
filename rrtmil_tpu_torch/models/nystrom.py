"""Nystrom-approximated self-attention.

Counterpart of `rrtmil_tpu/models/nystrom.py` (reference
modules/nystrom_attention.py:13-149), used by TransMIL and by the encoder's
`region_attn='ntrans'` / `attn_mode='ntrans'` ablations.  The JAX package
computes it in plain XLA (einsums, a Newton pseudo-inverse, a depthwise
conv), outside any Pallas kernel, so the port runs it as torch ops on
either device.

As in the JAX module:

* the input is padded at the FRONT to a multiple of `num_landmarks` and
  the output keeps its last n rows;
* the landmarks are segment means over l = ceil(n / m) tokens, n the
  length before the padding;
* the pseudo-inverse's starting scale is max(column sums) x max(row sums)
  over the whole tensor, every batch and every head together;
* the residual is a (33, 1) depthwise conv along the sequence axis of v,
  one group a head (`res_conv_weight`, torch's Conv2d layout (H, 1, 33, 1));
* dropout follows `to_out` only;
* `return_attn=True` also gives the first-row attention map;
* the reference's dead mask branch is left out.

The input is read in float32 (flax's Dense promotes a bf16 stream against
its float32 kernels), and the output is float32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import NystromConfig
from ..utils.inits import xavier_normal_
from .pool import dropout


def moore_penrose_pinv(x: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Newton-iteration pseudo-inverse of (..., m, m) (nystrom_attention.py:
    13-28); the starting scale takes the max over the whole tensor."""
    abs_x = x.abs()
    col = abs_x.sum(dim=-1)
    row = abs_x.sum(dim=-2)
    z = x.transpose(-1, -2) / (col.max() * row.max())
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    for _ in range(iters):
        xz = x @ z
        z = 0.25 * z @ (13 * eye - (xz @ (15 * eye - (xz @ (7 * eye - xz)))))
    return z


class NystromAttention(nn.Module):
    """(B, N, dim) -> (B, N, dim); `p` is the output dropout's rate."""

    def __init__(self, cfg: NystromConfig):
        super().__init__()
        self.cfg = cfg
        self.p = cfg.dropout
        inner = cfg.num_heads * cfg.head_dim
        self.to_qkv = nn.Linear(cfg.dim, 3 * inner, bias=False)
        self.to_out = nn.Linear(inner, cfg.dim)
        self.res_conv_weight = nn.Parameter(torch.zeros(
            cfg.num_heads, 1, cfg.residual_conv_kernel, 1)) \
            if cfg.residual else None

    def init_own_parameters(self, generator: torch.Generator) -> None:
        """xavier_normal with the fans of flax's (33, 1, 1, H) kernel."""
        if self.res_conv_weight is not None:
            kk = self.cfg.residual_conv_kernel
            xavier_normal_(self.res_conv_weight, kk, kk * self.cfg.num_heads,
                           generator)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                return_attn: bool = False):
        cfg = self.cfg
        x = x.float()
        b, n, _ = x.shape
        h, m, d = cfg.num_heads, cfg.num_landmarks, cfg.head_dim
        remainder = n % m
        if remainder > 0:
            x = F.pad(x, (0, 0, m - remainder, 0))
        n_pad = x.shape[1]

        qkv = self.to_qkv(x)
        q, k, v = (t.reshape(b, n_pad, h, d).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        q = q * d ** -0.5

        l = math.ceil(n / m)
        q_land = q.reshape(b, h, n_pad // l, l, d).sum(dim=-2) / l
        k_land = k.reshape(b, h, n_pad // l, l, d).sum(dim=-2) / l

        attn1 = torch.softmax(q @ k_land.transpose(-1, -2), dim=-1)
        attn2 = torch.softmax(q_land @ k_land.transpose(-1, -2), dim=-1)
        attn3 = torch.softmax(q_land @ k.transpose(-1, -2), dim=-1)
        attn2_inv = moore_penrose_pinv(attn2, cfg.pinv_iterations)
        out = (attn1 @ attn2_inv) @ (attn3 @ v)           # (b, h, n_pad, d)

        if self.res_conv_weight is not None:
            # the (kk, 1) conv over the sequence axis, run as a (1, kk) conv
            # over the last axis of v^T: torch's CPU depthwise conv backward
            # (oneDNN, torch 2.13) returns a wrong kernel gradient for a
            # (33, 1) kernel over 256 rows, the transposed form a right one
            kk = cfg.residual_conv_kernel
            res = F.conv2d(v.transpose(2, 3),
                           self.res_conv_weight.transpose(2, 3),
                           padding=(0, kk // 2), groups=h)
            out = out + res.transpose(2, 3)

        out = out.transpose(1, 2).reshape(b, n_pad, h * d)
        out = dropout(self.to_out(out), self.p, generator, self.training)
        out = out[:, -n:]                                 # drop the front pad
        if return_attn:
            a = (attn1[:, :, 0][:, :, None, :] @ attn2_inv) @ attn3
            return out, a[:, :, 0, -(n - 1):]
        return out
