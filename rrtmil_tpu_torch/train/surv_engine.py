"""Survival training engine: discrete-hazard models, censored c-index.

Counterpart of `rrtmil_tpu/train/surv_engine.py:29-241` (reference
Survival/models/RRTMIL/engine.py:10-135): per-epoch train and validate,
best-c-index tracking, the survival scheduler zoo stepped per epoch (step
gamma 0.1, ReduceLROnPlateau on the validation loss), batch-1 bags of up to
50k+ patches padded to their bucket (`bucket_for` / `pad_bag`), one update
per bag in the order `np.random.default_rng(seed).shuffle` gives (the JAX
engine's order), losses and risks kept on the device with one host sync per
epoch.  Dropout masks come from the engine's `torch.Generator` (seeded with
`cfg.seed`, on the engine's device).  Bags stay on the card after their
first transfer (`data/device_cache.py`, keyed by the bag's file path), so
later epochs skip the disk read, the pad and the copy; each epoch's
targets go to the device in one copy.

`SeqShardSurvivalEngine` (surv_engine.py:244-355) trains the long-bag
config with each bag's grid rows split over the ranks of an sp group
(parallel/seqshard.py): one engine a rank, each holding its slab of every
bag and a replica of the weights.
"""
from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..config import RRTEncoderConfig
from ..data.bucketing import BucketSpec, bucket_for, pad_bag
from ..data.device_cache import DeviceBagCache, cacheable
from ..models.rrt import RRTMIL, init_parameters
from ..models.survival import SurvivalHead, risk_score
from ..parallel.collectives import (all_reduce_grads, broadcast_floats,
                                    broadcast_module, scaled_loss)
from ..parallel.seqshard import sharded_bucket_for, sharded_config
from ..utils.device import resolve_device
from .losses import ce_surv_loss, nll_surv_loss
from .metrics import concordance_index_censored
from .optim import PlateauLR, fill_unreached_grads, lr_at, make_optimizer


@dataclasses.dataclass
class SurvivalEngineConfig:
    loss: str = "nll_surv"           # 'nll_surv' | 'ce_surv'
    loss_alpha: float = 0.0          # define_loss uses alpha=0 (loss.py:8-11)
    opt: str = "adam"
    lr: float = 2e-4
    weight_decay: float = 1e-5
    lr_schedule: str = "cosine"
    num_epochs: int = 30
    n_bins: int = 4
    seed: int = 1
    transfer_dtype: str = "float32"  # 'bfloat16' with the --amp configs
    device_cache: str = "auto"       # bags kept on the device after their
    # first transfer: 'on' | 'off' | 'auto' (= on when the device is CUDA);
    # survival bags (up to 50k+ patches, ~200 MB in fp32) are revisited
    # every epoch
    device_cache_bytes: int = 6 << 30  # its budget; bags past it stream


class SurvivalEngine:
    """Trains and validates a `SurvivalHead` on `device` (the card by
    default; raises when there is none unless device='cpu')."""

    def __init__(self, model: torch.nn.Module, cfg: SurvivalEngineConfig,
                 encoder_cfg: Optional[RRTEncoderConfig] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.encoder_cfg = encoder_cfg or RRTEncoderConfig(region_num=16)
        self.optimizer = make_optimizer(cfg.opt, self.model.parameters(),
                                        cfg.lr, cfg.weight_decay)
        loss_fn = nll_surv_loss if cfg.loss == "nll_surv" else ce_surv_loss
        self._loss = partial(loss_fn, alpha=cfg.loss_alpha)
        self._rng = np.random.default_rng(cfg.seed)
        # ReduceLROnPlateau on the validation loss (scheduler.py:10); the
        # reference calls scheduler.step() without the metric (engine.py:57),
        # a TypeError in torch, so this is its intended behaviour
        self._plateau = (PlateauLR(cfg.lr)
                         if cfg.lr_schedule == "plateau" else None)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        self._dcache: Optional[DeviceBagCache] = None

    def _device_cache(self) -> Optional[DeviceBagCache]:
        mode = self.cfg.device_cache
        if mode == "off" or (mode == "auto" and self.device.type != "cuda"):
            return None
        if self._dcache is None:
            self._dcache = DeviceBagCache(self.cfg.device_cache_bytes)
        return self._dcache

    def close(self) -> None:
        """Release the fold's device bag cache before the next fold."""
        if self._dcache is not None:
            self._dcache.clear()
            self._dcache = None

    def load_state_dict(self, state) -> None:
        """The model's weights from a `state_dict` (--resume)."""
        self.model.load_state_dict(state)

    def epoch_lr(self, epoch: int) -> float:
        """This epoch's lr: the survival zoo's schedules (step gamma 0.1,
        scheduler.py:8; plateau from the validation losses so far)."""
        if self._plateau is not None:
            return self._plateau.lr
        return lr_at(self.cfg.lr_schedule, self.cfg.lr, epoch,
                     self.cfg.num_epochs, step_gamma=0.1)

    def _prep(self, bag: np.ndarray):
        """One bag padded to its bucket: (x (1, N, D), mask (1, N), spec) on
        the engine's device."""
        spec = bucket_for(bag.shape[0], self.encoder_cfg)
        x, mask = pad_bag(bag.astype(np.float32), spec.data_length)
        x = torch.from_numpy(x[None])
        if self.cfg.transfer_dtype != "float32":
            x = x.to(getattr(torch, self.cfg.transfer_dtype))
        return (x.to(self.device), torch.from_numpy(mask[None]).to(self.device),
                spec)

    def _prep_indexed(self, dataset, idx: int):
        """(x, mask, spec, event, censorship, label) of bag `idx`: x and
        mask from the device bag cache when it holds them (no disk read, no
        copy), the metadata from the dataset's column arrays."""
        event = float(dataset.events[idx])
        censorship = int(dataset.censorship[idx])
        label = int(dataset.labels[idx])
        cache = self._device_cache() if cacheable(dataset, True) else None
        if cache is not None:
            hit = cache.get(dataset, idx)
            if hit is not None:
                x, mask, _, spec = hit
                return x, mask, spec, event, censorship, label
        x, mask, spec = self._prep(np.asarray(dataset[idx][1]))
        if cache is not None:
            cache.put(dataset, idx, x, mask,
                      torch.tensor([label], device=self.device), spec)
        return x, mask, spec, event, censorship, label

    def _epoch_targets(self, dataset, order: Sequence[int]):
        """Every bag's (label (1,), censorship (1,)) of an epoch, as views of
        two tensors sent to the device in one copy each."""
        order = np.asarray(order, dtype=np.int64)
        labels = torch.from_numpy(
            np.asarray(dataset.labels, np.int64)[order]).to(self.device)
        cens = torch.from_numpy(np.asarray(
            dataset.censorship, np.float32)[order]).to(self.device)
        return [(labels[j:j + 1], cens[j:j + 1]) for j in range(len(order))]

    def _train_step(self, x, mask, label, censorship, length: int):
        """Forward, backward and one optimizer update; (loss, risk (1,)) on
        the device."""
        hazards, survival = self.model(x, mask=mask, length=length,
                                       generator=self.generator)
        loss = self._loss(hazards, survival, label, censorship)
        loss.backward()
        fill_unreached_grads(self.model)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        return loss.detach(), risk_score(survival).detach()

    @torch.no_grad()
    def _eval_step(self, x, mask, label, censorship, length: int):
        hazards, survival = self.model(x, mask=mask, length=length)
        return (self._loss(hazards, survival, label, censorship),
                risk_score(survival))

    @staticmethod
    def _sync_meters(losses: List[torch.Tensor], risks: List[torch.Tensor]):
        """The epoch's one host sync: (summed loss, risks (n,))."""
        if not losses:
            return 0.0, np.zeros((0,), np.float32)
        return (float(torch.stack(losses).sum()),
                torch.cat(risks).float().cpu().numpy())

    def _run(self, step, dataset, order: Sequence[int]):
        losses, risks, censors, times = [], [], [], []
        for idx, targets in zip(order, self._epoch_targets(dataset, order)):
            x, mask, spec, event, censorship, label = self._prep_indexed(
                dataset, idx)
            loss, risk = step(x, mask, *targets, spec.repr_length)
            losses.append(loss)
            risks.append(risk)
            censors.append(censorship)
            times.append(event)
        total, risk_np = self._sync_meters(losses, risks)
        c_index = concordance_index_censored(
            1 - np.asarray(censors), np.asarray(times), risk_np)
        return total / max(len(order), 1), c_index

    def train_epoch(self, dataset, indices: Sequence[int], epoch: int):
        """One update per bag of `indices`, in the engine's shuffled order;
        returns (mean loss, c-index)."""
        order = list(indices)
        self._rng.shuffle(order)
        lr = self.epoch_lr(epoch)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        return self._run(self._train_step, dataset, order)

    def validate(self, dataset, indices: Sequence[int]):
        """(mean loss, c-index) over `indices`, dropout off."""
        self.model.eval()
        return self._run(self._eval_step, dataset, list(indices))

    def learning(self, dataset, train_idx, val_idx, logger=None,
                 checkpoint_fn: Optional[Callable] = None):
        """A whole fold (reference engine.py:24-60): returns (best c-index,
        its epoch, the state_dict at that epoch, on the CPU).  Each epoch's
        log line carries its train and validation bags/s (each phase ends
        in its one host sync)."""
        best_score, best_epoch = 0.0, 0
        best_state = {k: v.detach().cpu().clone()
                      for k, v in self.model.state_dict().items()}
        for epoch in range(self.cfg.num_epochs):
            t0 = time.perf_counter()
            tr_loss, tr_ci = self.train_epoch(dataset, train_idx, epoch)
            t1 = time.perf_counter()
            val_loss, val_ci = self.validate(dataset, val_idx)
            t2 = time.perf_counter()
            if self._plateau is not None:
                self._plateau.step(val_loss)
            if logger:
                logger.print(f"epoch {epoch}: train loss {tr_loss:.4f} "
                             f"ci {tr_ci:.4f} ({len(train_idx) / (t1 - t0):.2f}"
                             f" bags/s) | val loss {val_loss:.4f} ci "
                             f"{val_ci:.4f} ({len(val_idx) / (t2 - t1):.2f} "
                             f"bags/s)")
                logger.log({"train/loss": tr_loss, "train/c_index": tr_ci,
                            "val/loss": val_loss, "val/c_index": val_ci},
                           step=epoch)
            if val_ci > best_score:
                best_score, best_epoch = val_ci, epoch
                best_state = {k: v.detach().cpu().clone()
                              for k, v in self.model.state_dict().items()}
                if checkpoint_fn:
                    checkpoint_fn(epoch, val_ci, best_state)
        return best_score, best_epoch, best_state


class SeqShardSurvivalEngine(SurvivalEngine):
    """Sequence-sharded survival training (surv_engine.py:244-355): the
    SurvivalEngine's train_epoch / validate / learning with each bag split
    into whole region-rows over the ranks of `mesh`'s sp group, one engine
    a rank.

    The model is `SurvivalHead(RRTMIL)` of `model_cfg` made sharded, its
    weights those its unsharded twin draws from `seed` (the same modules),
    then rank 0's broadcast to every rank, so every replica holds the same
    bits.  `_prep` pads a bag to its sharded bucket (`sharded_bucket_for`)
    and keeps this rank's slab; the device cache holds slabs.  Each rank
    seeds its backward with loss / sp and sums the gradients over the group
    (parallel/collectives.py), so every replica takes the same update.
    Dropout masks come from a generator of rank r's own (JAX folds the axis
    index into the key, surv_engine.py:324-327); the bag order is the same
    on every rank.  `validate` runs on every rank (the forward needs the
    collectives), and its loss and c-index are rank 0's on every rank, so
    that every rank takes the same best-epoch and plateau decisions."""

    def __init__(self, model_cfg, cfg: SurvivalEngineConfig, mesh,
                 seed: int = 0):
        if mesh.dp != 1:
            raise ValueError(f"the sequence-sharded survival engine runs on "
                             f"a (1, sp) mesh, not ({mesh.dp}, {mesh.sp})")
        self.mesh = mesh
        self.sp = mesh.sp
        model = SurvivalHead(RRTMIL(sharded_config(model_cfg, self.sp),
                                    mesh.sp_group))
        init_parameters(model, torch.Generator().manual_seed(seed))
        super().__init__(model, cfg, model_cfg.encoder, device=mesh.device)
        if self.sp > 1:
            broadcast_module(self.model)
        rank_seed = np.random.SeedSequence([cfg.seed, mesh.sp_index])
        self.generator.manual_seed(int(rank_seed.generate_state(1)[0]))

    def load_state_dict(self, state) -> None:
        super().load_state_dict(state)
        if self.sp > 1:
            broadcast_module(self.model)

    def _prep(self, bag: np.ndarray):
        """One bag padded to its sharded bucket: this rank's slab (x (1,
        N / sp, D), mask (1, N / sp)) on the engine's device, and the
        bucket (`repr_length` the model's length)."""
        repr_length, data_length = sharded_bucket_for(
            bag.shape[0], self.encoder_cfg, self.sp)
        n = data_length // self.sp
        lo = self.mesh.sp_index * n
        slab = bag[lo:lo + n].astype(np.float32)
        x, mask = pad_bag(slab, n)
        x = torch.from_numpy(x[None])
        if self.cfg.transfer_dtype != "float32":
            x = x.to(getattr(torch, self.cfg.transfer_dtype))
        spec = BucketSpec(key=(int(np.sqrt(data_length)),),
                          repr_length=repr_length, data_length=data_length)
        return (x.to(self.device),
                torch.from_numpy(mask[None]).to(self.device), spec)

    def _train_step(self, x, mask, label, censorship, length: int):
        hazards, survival = self.model(x, mask=mask, length=length,
                                       generator=self.generator)
        loss = self._loss(hazards, survival, label, censorship)
        scaled_loss(loss, self.sp).backward()
        fill_unreached_grads(self.model)
        if self.sp > 1:
            all_reduce_grads(self.model.parameters(),
                             self.mesh.sp_group.group)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        return loss.detach(), risk_score(survival).detach()

    def validate(self, dataset, indices: Sequence[int]):
        loss, c_index = super().validate(dataset, indices)
        if self.sp > 1:
            loss, c_index = broadcast_floats([loss, c_index], self.device)
        return loss, c_index
