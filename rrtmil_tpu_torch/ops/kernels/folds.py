"""The fold axis of fold-parallel cross-validation in the kernels' Functions.

`parallel/folds.py` runs one train step of K folds at once under
`torch.func.vmap`, over parameters stacked on a leading fold axis.  Each
kernel's `torch.autograd.Function` carries a `vmap` rule that moves the
fold axis to the front and applies the Function once more, outside vmap, to
the physical tensors, in one of two forms:

* rows (`batch_rows`): an activation's fold axis folded into its leading
  axis, (K, B, ...) -> (K * B, ...), fold f's rows f * B .. f * B + B - 1;
* weights (`batch_fold`): a weight's fold axis kept in front, (K, ...),
  contiguous, each fold's weights one fold stride after the last.

A Function sees the fold count in its weights' rank (`folds`), launches its
kernel once for every fold (the CUDA entries take the rows or regions a fold
and the weights' fold strides), and its backward, which autograd calls once
on the physical tensors, gives each fold's weight gradients their own sums.
A weight-free Function (K6 and K7 without EPEG, K10, K11, K13) needs the
rows alone: its kernels see a longer leading axis.  On the CPU a Function
calls `fold_plain`: the plain version itself without folds, else fold by
fold, stacked.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

ROWS, WEIGHT = "rows", "weight"


class FoldFunction(torch.autograd.Function):
    """Base of the kernels' Functions: the setup_context form that a `vmap`
    rule needs, `apply` taking every argument positionally.  Outside a
    torch.func transform it calls autograd's own apply directly:
    `torch.autograd.Function.apply` of a setup_context Function first binds
    the arguments to forward's signature through `inspect.signature`, tens
    of microseconds of host time a call, which the launch-bound kernels
    (K5, K6, K8, K13 at batch 1) would pay on every launch."""

    @classmethod
    def apply(cls, *args):
        if torch._C._are_functorch_transforms_active():
            return super().apply(*args)
        return super(torch.autograd.Function, cls).apply(*args)


def batch_rows(t: Optional[torch.Tensor], dim: Optional[int],
               k: int) -> Optional[torch.Tensor]:
    """t with its fold axis `dim` (None: shared by every fold) folded into
    its leading axis: (K * B, ...), contiguous."""
    if t is None:
        return None
    t = t.expand(k, *t.shape) if dim is None else t.movedim(dim, 0)
    return t.reshape(k * t.shape[1], *t.shape[2:]).contiguous()


def batch_fold(t: Optional[torch.Tensor], dim: Optional[int],
               k: int) -> Optional[torch.Tensor]:
    """t with its fold axis `dim` (None: shared) in front: (K, ...),
    contiguous."""
    if t is None:
        return None
    t = t.expand(k, *t.shape) if dim is None else t.movedim(dim, 0)
    return t.contiguous()


def unbatch(t: Optional[torch.Tensor], k: int) -> Optional[torch.Tensor]:
    """(K * B, ...) -> (K, B, ...); a weight's (K, ...) stays as it is."""
    if t is None:
        return None
    return t.reshape(k, t.shape[0] // k, *t.shape[1:])


def folds(w: Optional[torch.Tensor], rank: int) -> int:
    """The fold count of a weight whose one-fold rank is `rank`: its
    leading axis when it has one more, else 0 (no fold axis)."""
    if w is None or w.dim() == rank:
        return 0
    if w.dim() != rank + 1:
        raise ValueError(f"a weight of rank {rank} or {rank + 1} (folds "
                         f"first), not {tuple(w.shape)}")
    return w.shape[0]


def vmap_rule(apply: Callable, info, in_dims, args: Sequence, kinds):
    """The `vmap` staticmethod of a kernel's Function: `args` moved to the
    physical fold forms `kinds` names (ROWS, WEIGHT, or None for a
    non-tensor or an untouched argument), `apply` run once on them, and its
    outputs handed back with the fold axis in front."""
    k = info.batch_size
    phys = [batch_rows(a, d, k) if kind == ROWS
            else batch_fold(a, d, k) if kind == WEIGHT else a
            for a, d, kind in zip(args, in_dims, kinds)]
    out = apply(*phys)
    if isinstance(out, tuple):
        return tuple(unbatch(o, k) for o in out), tuple(0 for _ in out)
    return unbatch(out, k), 0


def fold_plain(fn: Callable, k: int, args: Sequence, kinds,
               out_kinds) -> tuple:
    """fn(*args) when k is 0 (no fold axis), else its fold form: fn on each
    fold's rows (ROWS: split along the leading axis) and weights (WEIGHT:
    [f]), the others passed as they are; outputs concatenated (ROWS) or
    stacked (WEIGHT), None kept.  Fold f's results are bit for bit the
    one-fold call's."""
    if not k:
        return fn(*args)
    def part(a, kind, f):
        if a is None or kind is None:
            return a
        if kind == WEIGHT:
            return a[f]
        n = a.shape[0] // k
        return a[f * n:(f + 1) * n]

    outs = [fn(*[part(a, kind, f) for a, kind in zip(args, kinds)])
            for f in range(k)]
    single = not isinstance(outs[0], tuple)
    if single:
        outs = [(o,) for o in outs]
    joined = []
    for i, kind in enumerate(out_kinds):
        vals = [o[i] for o in outs]
        if vals[0] is None:
            joined.append(None)
        elif kind == WEIGHT:
            joined.append(torch.stack(vals))
        else:
            joined.append(torch.cat(vals))
    return joined[0] if single else tuple(joined)
