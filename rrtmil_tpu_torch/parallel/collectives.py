"""Collectives over the ranks of a process group, with the gradient rules of
`shard_map`'s transpose.

The JAX package differentiates through `shard_map`; the port runs one
process a rank, so each collective the sharded model calls is an autograd
Function here:

  * `all_gather(x, dim, sg)`: the ranks' x concatenated along `dim` in rank
    order (`lax.all_gather(..., tiled=True)`); its backward is the sum of
    every rank's cotangent (`all_reduce`), then this rank's slice: a
    reduce-scatter, which gloo lacks.
  * `all_reduce_sum(x, sg)`: the psum; its backward is the psum of the
    cotangent.
  * `pmax_nograd(x, sg)`: the element-wise max over the ranks of a detached
    x, the `pmax(stop_gradient(.))` of the sharded softmax
    (rrtmil_tpu/models/pool.py:42-44).

Gradient convention.  Every rank of a sequence-sharded group computes the
same (replicated) loss.  Parameters used after a collective (the pool's
head, the predictor, the cross-region attention) see the whole gradient on
every rank, those before it (the encoder's token-wise layers) only their own
tokens' share.  With the psum's backward a psum, each rank seeds its
backward with loss / world (`scaled_loss`), and `all_reduce_grads` then sums
every parameter's gradient over all ranks: a replicated part contributes
world x (1 / world) of its gradient, a token-wise part the sum of the
ranks' shares, and a data-parallel group's mean over its ranks' local
losses comes out as the loss's mean over the global batch.  The tests hold
this against the unsharded gradients.

Only `all_gather`, `all_reduce` and `broadcast` are used, on the tensors'
own device: NCCL takes CUDA tensors; gloo takes CPU tensors, and CUDA ones,
which it copies through host memory itself.  A group of one rank runs no
collective at all.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class ShardGroup:
    """A process group (None for a group of one rank without one), its size
    and this rank's index in it."""

    group: Optional[object] = None
    size: int = 1
    index: int = 0


SINGLE = ShardGroup()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, sg):
        ctx.dim, ctx.sg = dim, sg
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(sg.size)]
        dist.all_gather(parts, x, group=sg.group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.sg.group)
        return g.chunk(ctx.sg.size, ctx.dim)[ctx.sg.index], None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sg):
        ctx.sg = sg
        y = x.contiguous().clone()
        dist.all_reduce(y, group=sg.group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.sg.group)
        return g, None


def all_gather(x: torch.Tensor, dim: int, sg: ShardGroup) -> torch.Tensor:
    """The group's x (each of one shape) concatenated along `dim`."""
    return x if sg.size == 1 else _AllGather.apply(x, dim, sg)


def all_reduce_sum(x: torch.Tensor, sg: ShardGroup) -> torch.Tensor:
    """The sum of the group's x, on every rank (JAX's psum)."""
    return x if sg.size == 1 else _AllReduceSum.apply(x, sg)


def pmax_nograd(x: torch.Tensor, sg: ShardGroup) -> torch.Tensor:
    """The element-wise max of the group's x, without a gradient."""
    y = x.detach()
    if sg.size == 1:
        return y
    y = y.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=sg.group)
    return y


def scaled_loss(loss: torch.Tensor, world: int) -> torch.Tensor:
    """The loss each rank seeds its backward with (the module docstring)."""
    return loss / world


def all_reduce_grads(params: Iterable[torch.nn.Parameter],
                     group: Optional[object] = None) -> None:
    """Sum every parameter's gradient over the ranks of `group` (the world
    by default), in place, through one flat buffer a dtype.  Parameters
    without a gradient are skipped: every rank must have the same ones."""
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def broadcast_module(module: torch.nn.Module, src: int = 0,
                     group: Optional[object] = None) -> None:
    """Every parameter and buffer of `module` set to rank `src`'s, in place
    (parameters and buffers the same bits on every rank)."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src, group=group)


def broadcast_floats(values, device, src: int = 0) -> list:
    """Rank `src`'s list of floats on every rank (float64)."""
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=device)
    dist.broadcast(t, src=src)
    return t.tolist()
