"""Sequence parallelism over the region axis: one bag's grid rows split
over the ranks of an sp group.

Counterpart of `rrtmil_tpu/parallel/seqshard.py:43-193`:

  * the bag's square grid is split into contiguous slabs of grid rows, one
    a rank, aligned to whole region-rows: R-MSA attention never crosses a
    region's edge, so every R-MSA layer runs on its slab alone;
  * CR-MSA compresses each region to `crmsa_k` representative tokens; the
    only collective of the encoder is an all-gather of those tokens (k x nR
    x C floats, 3 x 256 x 512 x 4 B = 1.5 MB for a 50k-patch bag at
    region_num 16), after which the cross-region attention runs replicated
    and each rank keeps its slice (models/rrt.py);
  * the attention pool takes a stable global softmax (models/pool.py).

Where the JAX package runs `shard_map` under one controller, the port runs
one process a rank (parallel/mesh.py): the functions here build the
sharded model on this rank's sp group and take this rank's slab (`x` of
(B_local, n_pad / sp, C)), returning the replicated outputs.  The dp axis
of the mesh splits the bags, as at seqshard.py:124-154: the loss is the
mean over the ranks' bags.  Gradients follow `parallel.collectives`: each
rank seeds its backward with loss / world and every gradient is summed over
all ranks, which gives the unsharded model's gradients.

Grid-matching note (seqshard.py:19-25): the sharded path evaluates both the
R-MSA and the CR-MSA layers on the unified `region_num`-aligned grid of
`sharded_bucket_for`, which for some lengths pads further than
`data.bucketing.bucket_for`; the port is held to the JAX package's sharded
path there, not to its unsharded model.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from ..config import RRTEncoderConfig, RRTMILConfig
from ..data.bucketing import _rounding_modulus, encoder_regions
from ..models.rrt import build_model
from ..ops.regions import grid_geometry
from .collectives import all_gather, all_reduce_grads, scaled_loss
from .mesh import Mesh


def sharded_config(cfg, sp: int, axis: str = "sp"):
    """A copy of an RRTEncoderConfig / RRTMILConfig with the sequence
    parallel fields set."""
    if isinstance(cfg, RRTMILConfig):
        return dataclasses.replace(
            cfg, encoder=sharded_config(cfg.encoder, sp, axis))
    return dataclasses.replace(cfg, sp_shards=sp, sp_axis=axis)


def check_shardable(length: int, cfg: RRTEncoderConfig, sp: int) -> int:
    """Raise unless a bag of `length` splits into whole region-rows on
    every layer across `sp` ranks; returns the (unified) padded length."""
    geoms = []
    if cfg.n_layers > 1 and cfg.attn_mode == "rmsa":
        geoms.append(grid_geometry(length, cfg.rmsa_layer().rmsa.region))
    if cfg.cr_msa:
        geoms.append(grid_geometry(length, cfg.crmsa_layer().crmsa.region))
    grid = max(g.grid for g in geoms)
    for g in geoms:
        if grid % (sp * g.region_size) != 0:
            raise ValueError(
                f"length {length}: grid {grid} not divisible into whole "
                f"region-rows (rs={g.region_size}) across sp={sp}")
    return grid * grid


def sharded_bucket_for(length: int, cfg: RRTEncoderConfig, sp: int):
    """(repr_length, data_length) of a bag on the sequence-sharded path:
    the grid side rounded up, at the layers' gcd granularity, until
    `check_shardable` takes it."""
    mods = [_rounding_modulus(r) for r in encoder_regions(cfg)]
    g = math.gcd(*mods) if len(mods) > 1 else mods[0]
    scfg = dataclasses.replace(cfg, sp_shards=sp, sp_axis=cfg.sp_axis or "sp")
    s = int(math.ceil(math.sqrt(length)))
    s_b = s + (-s) % g
    for _ in range(64):
        repr_length = s_b * s_b
        try:
            return repr_length, check_shardable(repr_length, scfg, sp)
        except ValueError:
            s_b += g
    raise ValueError(f"no shardable bucket for length {length} at sp={sp}")


def _sharded_model(model_cfg: RRTMILConfig, mesh: Mesh):
    """The sharded RRTMIL on this rank's sp group and device, with the
    weights its unsharded twin draws from seed 0 (every rank the same)."""
    return build_model(sharded_config(model_cfg, mesh.sp),
                       device=mesh.device, sp_group=mesh.sp_group)


def _check_slab(x, n_pad: int, mesh: Mesh) -> None:
    if x.shape[1] * mesh.sp != n_pad:
        raise ValueError(f"a slab of {x.shape[1]} tokens on {mesh.sp} ranks "
                         f"is not the {n_pad}-token bucket")


def _dp_mean(loss: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean over the dp ranks of a replicated scalar."""
    if mesh.dp == 1:
        return loss
    return all_gather(loss.detach().reshape(1), 0, mesh.dp_group).mean()


def seqshard_value_and_grad(model: torch.nn.Module, loss_fn: Callable,
                            mesh: Mesh, length: int, n_pad: int):
    """value_and_grad(x, mask, labels, generator=None) of a sharded model:
    the loss (the mean over the dp ranks' bags) and every parameter's
    gradient, the unsharded model's, left in `.grad`."""
    params = [p for p in model.parameters() if p.requires_grad]

    def value_and_grad(x, mask, labels, generator=None):
        _check_slab(x, n_pad, mesh)
        model.train()
        for p in params:
            p.grad = None
        out = model(x, mask=mask, length=length, generator=generator)
        loss = loss_fn(out, labels)
        scaled_loss(loss, mesh.world).backward()
        all_reduce_grads(params)
        return _dp_mean(loss.detach(), mesh), \
            {n: p.grad for n, p in model.named_parameters()}

    return value_and_grad


def make_seqshard_forward(model_cfg: RRTMILConfig, mesh: Mesh, length: int):
    """(model, forward, n_pad): the sharded RRTMIL (seeded weights; load
    others into it on every rank) and forward(x, mask) of this
    rank's slab -> the logits of every bag of the dp group, on every rank
    (eval mode, no gradient).  `length` is the bags' bucket length; n_pad
    the unified padded length the slabs split."""
    model = _sharded_model(model_cfg, mesh)
    n_pad = check_shardable(length, model.cfg.encoder, mesh.sp)

    @torch.no_grad()
    def forward(x, mask):
        _check_slab(x, n_pad, mesh)
        model.eval()
        out = model(x, mask=mask, length=length)
        return all_gather(out, 0, mesh.dp_group) if mesh.dp > 1 else out

    return model, forward, n_pad


def make_seqshard_value_and_grad(model_cfg: RRTMILConfig, mesh: Mesh,
                                 length: int, loss_fn: Callable):
    """(model, value_and_grad, n_pad): value_and_grad(x, mask, labels,
    generator=None) of this rank's slab and bags -> (loss, {name: grad}),
    dropout on (its masks drawn from `generator`)."""
    model = _sharded_model(model_cfg, mesh)
    n_pad = check_shardable(length, model.cfg.encoder, mesh.sp)
    return model, seqshard_value_and_grad(model, loss_fn, mesh, length,
                                          n_pad), n_pad


def make_seqshard_train_step(model_cfg: RRTMILConfig, mesh: Mesh,
                             length: int, tx: Callable, loss_fn: Callable):
    """(model, optimizer, step, n_pad): `tx(params)` builds the optimizer
    (e.g. `lambda p: train.optim.make_optimizer('adam', p, lr, wd)`); each
    rank updates its replica with the summed gradients, so the replicas
    stay equal.  step(x, mask, labels, lr=None, generator=None) -> loss."""
    model, value_and_grad, n_pad = make_seqshard_value_and_grad(
        model_cfg, mesh, length, loss_fn)
    optimizer = tx(model.parameters())
    return model, optimizer, optimizer_step(value_and_grad, optimizer), n_pad


def optimizer_step(value_and_grad: Callable, optimizer) -> Callable:
    """step(x, mask, labels, lr=None, generator=None): value_and_grad, then
    one update at `lr` (the optimizer's own when None); returns the loss."""
    def step(x, mask, labels, lr: Optional[float] = None, generator=None):
        loss, _ = value_and_grad(x, mask, labels, generator)
        if lr is not None:
            for group in optimizer.param_groups:
                group["lr"] = lr
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss

    return step
