"""MIL aggregation heads: AB-MIL attention pooling (ungated and gated),
masked mean and masked max; flax's dropout, which every model of the port
draws from its caller's `torch.Generator`.

Counterpart of `rrtmil_tpu/models/pool.py` (reference modules/datten.py:
5-101).  Bags arrive padded to a bucket length, so the softmax over
instances takes the boolean mask of true tokens; masked places are filled
with finfo(float32).min, not -inf (pool.py:26-30).  The scorers' dropout
(`dropout=True`) is flax's fixed p = 0.25 on the hidden activations, drawn
from the caller's `torch.Generator` in train mode.

Fold-parallel training (parallel/folds.py) runs a model under
`torch.func.vmap` over K folds and passes `FoldGenerators`, one generator a
fold, as the generator: each dropout then draws fold f's mask from
generator f, of that fold's own shape (`keep_mask`), so every fold draws
what its own sequential run draws.

Under sequence sharding (`sp_group`, a parallel.collectives.ShardGroup of
more than one rank) each rank holds a slab of the bag's tokens, and every
pool equals the unsharded one on the whole bag: the attention pools take a
stable global softmax (`sharded_attention_pool`), the mean sums its
numerator and count over the group, and the max gathers the ranks' local
maxima (pool.py:33-50,143-182).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import (ShardGroup, all_gather, all_reduce_sum,
                                    pmax_nograd)

_ACTS = {"relu": F.relu, "gelu": lambda x: F.gelu(x, approximate="none"),
         "tanh": torch.tanh}
SCORER_DROPOUT = 0.25


def masked_softmax(logits: torch.Tensor, mask: Optional[torch.Tensor],
                   dim: int = -1) -> torch.Tensor:
    if mask is not None:
        logits = torch.where(mask, logits,
                             torch.finfo(logits.dtype).min)
    return torch.softmax(logits, dim=dim)


def sharded_attention_pool(scores: torch.Tensor, x: torch.Tensor,
                           mask: Optional[torch.Tensor],
                           sg: ShardGroup) -> torch.Tensor:
    """Attention pooling of (B, 1, N_local) scores over (B, N_local, C)
    tokens sharded over `sg` (pool.py:33-50): the global max without a
    gradient (softmax is shift-invariant, so it only stabilises), then the
    psum of e @ x and of sum(e) -> (B, 1, C), the single-rank softmax
    pooling of the whole bag."""
    if mask is not None:
        scores = torch.where(mask[:, None, :], scores,
                             torch.finfo(scores.dtype).min)
    m = pmax_nograd(scores.amax(dim=-1, keepdim=True), sg)
    e = torch.exp(scores - m)
    if mask is not None:
        e = e * mask[:, None, :].to(e.dtype)
    num = all_reduce_sum(e @ x, sg)
    den = all_reduce_sum(e.sum(-1, keepdim=True), sg)
    return num / den


def _pool_scores(a, x, mask, sg):
    """softmax(a) @ x over the bag, on one rank or sharded over `sg`."""
    if sg is not None and sg.size > 1:
        return sharded_attention_pool(a, x, mask, sg)
    a = masked_softmax(a, None if mask is None else mask[:, None, :])
    return a @ x                                                 # (B, 1, C)


class FoldGenerators(tuple):
    """One torch.Generator a fold: the `generator` of a model run under
    torch.func.vmap over folds, fold f's masks drawn from element f."""


def _draw(x: torch.Tensor, keep: float, generator, per_sample: bool):
    if per_sample:   # one draw a sample: (B, 1, ..., 1) float32
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        return torch.empty(shape, device=x.device).bernoulli_(
            keep, generator=generator)
    return torch.empty_like(x).bernoulli_(keep, generator=generator)


class _FoldKeep(torch.autograd.Function):
    """A keep mask under vmap over folds: fold f's drawn from generator f
    with the shape and dtype of fold f's x, the folds' masks stacked."""

    @staticmethod
    def forward(x, keep, generators, per_sample):
        return _draw(x, keep, generators[0], per_sample)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, g):
        return None, None, None, None

    @staticmethod
    def vmap(info, in_dims, x, keep, generators, per_sample):
        d = in_dims[0]
        if len(generators) != info.batch_size:
            raise ValueError(f"{len(generators)} generators for "
                             f"{info.batch_size} folds")
        return torch.stack([
            _draw(x if d is None else x.select(d, f), keep, generators[f],
                  per_sample) for f in range(info.batch_size)]), 0


def keep_mask(x: torch.Tensor, keep: float, generator,
              per_sample: bool = False) -> torch.Tensor:
    """Bernoulli(keep) draws of x's shape (per_sample: one a sample along
    axis 0, float32) from `generator`, or fold by fold from
    `FoldGenerators`."""
    if generator is None:
        raise ValueError("dropout and drop_path in train mode draw their "
                         "masks from a torch.Generator: pass generator=")
    if isinstance(generator, FoldGenerators):
        return _FoldKeep.apply(x, keep, generator, per_sample)
    return _draw(x, keep, generator, per_sample)


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator],
            training: bool) -> torch.Tensor:
    """flax nn.Dropout: keep with probability 1 - p and scale by 1 / (1 - p);
    the mask is drawn from `generator` (on x's device)."""
    if not training or p == 0.0:
        return x
    keep = keep_mask(x, 1.0 - p, generator)
    return torch.where(keep.bool(), x / (1.0 - p), torch.zeros_like(x))


def _dropout(x, on: bool, generator, training: bool):
    return dropout(x, SCORER_DROPOUT if on else 0.0, generator, training)


class Attention(nn.Module):
    """2-layer attention scorer L=512 -> D=128 -> K=1 (datten.py:5-38)."""

    def __init__(self, input_dim: int = 512, act: str = "relu",
                 bias: bool = False, dropout: bool = False,
                 sp_group: Optional[ShardGroup] = None):
        super().__init__()
        self.fc1 = nn.Linear(input_dim, 128, bias=bias)
        self.fc2 = nn.Linear(128, 1, bias=bias)
        self.act = _ACTS[act]
        self.dropout = dropout
        self.sp_group = sp_group

    def forward(self, x, mask=None, generator=None):
        a = _dropout(self.act(self.fc1(x)), self.dropout, generator,
                     self.training)
        a = self.fc2(a).transpose(-1, -2)                        # (B, 1, N)
        return _pool_scores(a, x, mask, self.sp_group)           # (B, 1, C)


class AttentionGated(nn.Module):
    """Gated attention scorer (datten.py:40-83): act(a(x)) * sigmoid(b(x))
    -> c."""

    def __init__(self, input_dim: int = 512, act: str = "relu",
                 bias: bool = False, dropout: bool = False,
                 sp_group: Optional[ShardGroup] = None):
        super().__init__()
        self.attention_a = nn.Linear(input_dim, 128, bias=bias)
        self.attention_b = nn.Linear(input_dim, 128, bias=bias)
        self.attention_c = nn.Linear(128, 1, bias=bias)
        self.act = _ACTS[act]
        self.dropout = dropout
        self.sp_group = sp_group

    def forward(self, x, mask=None, generator=None):
        a = self.act(self.attention_a(x))
        b = torch.sigmoid(self.attention_b(x))
        a = _dropout(a, self.dropout, generator, self.training)
        b = _dropout(b, self.dropout, generator, self.training)
        g = self.attention_c(a * b).transpose(-1, -2)            # (B, 1, N)
        return _pool_scores(g, x, mask, self.sp_group)           # (B, 1, C)


class DAttention(nn.Module):
    """Dispatch wrapper (datten.py:85-101): returns pooled (B, C)."""

    def __init__(self, input_dim: int = 512, act: str = "relu",
                 gated: bool = False, bias: bool = False,
                 dropout: bool = False,
                 sp_group: Optional[ShardGroup] = None):
        super().__init__()
        cls = AttentionGated if gated else Attention
        self.attention = cls(input_dim, act, bias, dropout, sp_group)

    def forward(self, x, mask=None, generator=None):
        return self.attention(x, mask, generator).squeeze(1)


class MeanPool(nn.Module):
    """Masked mean over instances (reference modules/rrt.py:221); sharded
    over `sp_group`, the numerator and the count are summed over it."""

    def __init__(self, sp_group: Optional[ShardGroup] = None):
        super().__init__()
        self.sp_group = sp_group

    def forward(self, x, mask=None, **_):
        if mask is None:
            mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
        m = mask[..., None].to(x.dtype)
        num, den = (x * m).sum(1), m.sum(1)
        if self.sp_group is not None and self.sp_group.size > 1:
            num = all_reduce_sum(num, self.sp_group)
            den = all_reduce_sum(den, self.sp_group)
        return num / torch.clamp(den, min=1.0)


class MaxPool(nn.Module):
    """Masked max over instances (pool.py:164-182); sharded over `sp_group`,
    the ranks' (B, C) local maxima are gathered and reduced, which keeps the
    max differentiable (the winner's rank gets the gradient)."""

    def __init__(self, sp_group: Optional[ShardGroup] = None):
        super().__init__()
        self.sp_group = sp_group

    def forward(self, x, mask=None, **_):
        if mask is not None:
            x = torch.where(mask[..., None], x, torch.finfo(x.dtype).min)
        local = x.amax(dim=1)
        if self.sp_group is None or self.sp_group.size == 1:
            return local
        return all_gather(local[None], 0, self.sp_group).amax(dim=0)
