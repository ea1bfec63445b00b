"""Fold-parallel cross-validation: one train step for all K folds at once.

Counterpart of `rrtmil_tpu/parallel/folds.py`.  The folds of a CV run are
independent, so the fold index is one more batch axis: the K fold models'
parameters are stacked on a leading fold axis (`stack_states`), and one step
runs the model under `torch.func.vmap` over that axis through
`torch.func.functional_call`, then one `.backward()` of the summed per-fold
losses.  Every kernel on the path runs once a step for all K folds (the
Functions' vmap rules, ops/kernels/folds.py), not K times.

Each fold keeps its own model, optimizer, schedule, early stopping and
checkpoints, as the sequential harness builds them: `stack_states`
re-points every fold model's parameters at its fold's slice of the stacked
tensors (no copy, no copy back), so a step's gradients land in each fold
model's `.grad` as views of the stacked gradient, and each engine's own
optimizer update (per-fold clipping, Adam's step counts, RAdam, Lookahead,
each fold's lr) writes the stacked parameters in place.

Dropout draws fold f's masks from fold f's engine generator
(`models.pool.FoldGenerators`), each of that fold's own shape, so a
fold-parallel step draws, fold by fold, what the sequential run draws.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
from torch import nn

from ..models.pool import FoldGenerators


def stack_states(models: Sequence[nn.Module]) -> Dict[str, torch.Tensor]:
    """The K models' parameters stacked on a leading fold axis, {name: (K,
    ...)}; every model's parameters become views of its fold's slice."""
    named = [dict(m.named_parameters()) for m in models]
    stacked = {}
    for name in named[0]:
        params = [d[name] for d in named]
        stacked[name] = torch.stack([p.detach() for p in params])
        for k, p in enumerate(params):
            p.data = stacked[name][k]
    return stacked


def unstack_states(stacked: Dict[str, torch.Tensor],
                   k: int) -> List[Dict[str, torch.Tensor]]:
    """Fold by fold, {name: fold f's parameters}, views of the stack."""
    return [{n: t[f] for n, t in stacked.items()} for f in range(k)]


def _fold_step(models: Sequence[nn.Module], stacked: Dict[str, torch.Tensor],
               length: int, head: Callable):
    """step(x, mask, *targets, generators): the model under vmap over the
    folds, head(model output, *targets) -> (loss, *more) a fold, one
    backward of the losses' sum, each fold's gradients into its model's
    .grad (views of the stacked gradients); returns head's outputs (K,
    ...), detached.  The buffers are stacked here, once."""
    template = models[0]
    named = [dict(m.named_buffers()) for m in models]
    buffers = {n: torch.stack([d[n] for d in named]) for n in named[0]}

    def step(x, mask, *targets, generators):
        template.train()
        gens = FoldGenerators(generators)

        def one(params, buffers, x, mask, *targets):
            out = torch.func.functional_call(
                template, (params, buffers), (x,),
                {"mask": mask, "length": length, "generator": gens})
            return head(out, *targets)

        leaves = {n: t.detach().requires_grad_(True)
                  for n, t in stacked.items()}
        out = torch.func.vmap(one)(leaves, buffers, x, mask, *targets)
        out[0].sum().backward()
        for name, leaf in leaves.items():
            g = leaf.grad
            for k, m in enumerate(models):
                m.get_parameter(name).grad = None if g is None else g[k]
        return tuple(o.detach() for o in out)

    return step


def make_fold_parallel_step(models: Sequence[nn.Module],
                            stacked: Dict[str, torch.Tensor],
                            loss_fn: Callable, length: int):
    """step(x (K, B, N, C), mask (K, B, N), labels (K, B), generators) ->
    losses (K,): each fold's loss_fn(logits, labels) (the logits alone, as
    the JAX step computes it, folds.py:53-55) and its gradients in its
    model's .grad, for its engine's own update.  `generators` is one
    torch.Generator a fold (the dropout masks in train mode)."""
    def head(out, labels):
        return (loss_fn(out[0] if isinstance(out, tuple) else out, labels),)
    step = _fold_step(models, stacked, length, head)
    return lambda x, mask, labels, generators: step(
        x, mask, labels, generators=generators)[0]


def make_fold_parallel_surv_step(models: Sequence[nn.Module],
                                 stacked: Dict[str, torch.Tensor],
                                 loss_fn: Callable, length: int):
    """Survival analog: step(x (K, 1, N, C), mask (K, 1, N), label (K, 1),
    censorship (K, 1), generators) -> (losses (K,), risks (K, 1)), the
    model giving (hazards, S), the loss loss_fn(hazards, S, label,
    censorship), the risk -sum(S); gradients as `make_fold_parallel_step`'s
    (each fold's lr is its engine's)."""
    def head(out, label, cens):
        hazards, surv = out
        return (loss_fn(hazards, surv, label, cens),
                -torch.sum(surv, dim=-1))
    step = _fold_step(models, stacked, length, head)
    return lambda x, mask, label, censorship, generators: step(
        x, mask, label, censorship, generators=generators)
