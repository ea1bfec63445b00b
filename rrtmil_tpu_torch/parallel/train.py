"""The multi-rank train step: data parallelism over bags and sequence
parallelism over tokens.

Counterpart of `rrtmil_tpu/parallel/train.py:34-72`.  Where the JAX package
annotates one program's shardings (GSPMD inserts the gradient all-reduce),
the port runs one process a rank: each dp rank takes its slice of the
batch (`mesh.global_array(x, mesh, ('dp', None, None))`), the loss is the
mean over the global batch, and the gradients are summed over the ranks
after each rank seeds its backward with loss / world
(`parallel.collectives`).  Parameters and the optimizer state stay
replicated: every rank applies the same update to the same bits.

With `mesh.sp > 1` the step runs the sequence-sharded twin of the model
(parallel/seqshard.py), which shares the model's parameters, on this rank's
slab (`global_array(x, mesh, ('dp', 'sp', None))`).  A full-sequence rank
(sp = 1) runs the model as it is, with its normal dispatch (K1-K9).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models.rrt import RRTMIL
from .collectives import all_reduce_grads, scaled_loss
from .mesh import Mesh
from .seqshard import (check_shardable, optimizer_step, sharded_config,
                       seqshard_value_and_grad)


def share_parameters(dst: torch.nn.Module, src: torch.nn.Module) -> None:
    """Point every parameter of `dst` at the parameter of the same name in
    `src` (the same tensors: an optimizer on `src` updates both)."""
    params = dict(src.named_parameters())
    for mod_name, mod in dst.named_modules():
        for name, p in list(mod._parameters.items()):
            if p is not None:
                mod._parameters[name] = params[
                    f"{mod_name}.{name}" if mod_name else name]


def sharded_twin(model: RRTMIL, mesh: Mesh) -> RRTMIL:
    """The sequence-sharded RRTMIL on this rank's sp group, sharing
    `model`'s parameters."""
    twin = RRTMIL(sharded_config(model.cfg, mesh.sp), mesh.sp_group)
    share_parameters(twin, model)
    return twin.to(mesh.device)


def make_sharded_train_step(model: torch.nn.Module, opt, loss_fn: Callable,
                            mesh: Mesh, length: int) -> Callable:
    """step(x, mask, labels, lr=None, generator=None) -> the loss over the
    global batch, from this rank's share of the batch (and slab, with
    sp > 1); `opt` is the optimizer on `model`'s parameters and `length`
    the bucket length of the bags."""
    if mesh.sp > 1:
        twin = sharded_twin(model, mesh)
        n_pad = check_shardable(length, twin.cfg.encoder, mesh.sp)
        return optimizer_step(seqshard_value_and_grad(
            twin, loss_fn, mesh, length, n_pad), opt)
    params = [p for p in model.parameters() if p.requires_grad]

    def value_and_grad(x, mask, labels, generator=None):
        model.train()
        for p in params:
            p.grad = None
        out = model(x, mask=mask, length=length, generator=generator)
        if isinstance(out, tuple):
            out = out[0]
        loss = loss_fn(out, labels)
        scaled_loss(loss, mesh.world).backward()
        if mesh.world > 1:
            all_reduce_grads(params)
            loss = loss.detach().clone()
            torch.distributed.all_reduce(loss)
            return loss / mesh.world, None
        return loss.detach(), None

    return optimizer_step(value_and_grad, opt)
