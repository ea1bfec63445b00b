"""Training and evaluation engine over bucketed bags.

Counterpart of `rrtmil_tpu/train/engine.py` for the classification path:
`EngineConfig`, `_batched_order` (greedy bucket-aware batching that keeps
the given order within a bucket), the Python `_assemble_host` batch
assembly, `train_epoch` (`_train_step` and `_apply_grads`: per-step
learning rate, global-norm clipping, gradient accumulation with the loss
pre-scaled by 1/accumulation_steps and one update per window, the short
tail window included), `_eval_step` and `evaluate`.  Per-step meters
and per-batch results stay on the device and are fetched in one sync per
epoch.  Dropout masks come from the engine's `torch.Generator` (seeded with
`cfg.seed`, on the engine's device); the train order from
`np.random.default_rng(cfg.seed)` or, with `fix_loader_random`, the
reference's fixed loader seed.  The device bag cache, the native loader,
augmentation and the aux-loss models are later slices (ROADMAP.md queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import RRTEncoderConfig
from ..data.bucketing import bucket_for, pad_bag
from ..utils.device import resolve_device
from .losses import bce_with_logits, cross_entropy
from .optim import lr_at, make_optimizer

# the reference's fixed DataLoader generator seed (main.py:125-130)
FIXED_LOADER_SEED = 7784414403328510413


@dataclasses.dataclass
class EngineConfig:
    loss: str = "ce"                 # 'ce' | 'bce'
    opt: str = "adam"
    lr: float = 2e-4
    weight_decay: float = 1e-5
    lr_schedule: str = "cosine"
    lr_supi: bool = False            # step the schedule per iteration
    num_epochs: int = 200
    batch_size: int = 1
    n_classes: int = 2
    cls_alpha: float = 1.0
    accumulation_steps: int = 1
    clip_grad: float = 0.0
    seed: int = 2021
    fix_loader_random: bool = False  # train order from the reference's fixed
    # loader seed instead of `seed` (forced on for camelyon16, main.py:731)


class Engine:
    """Drives one model through train and eval epochs on `device` (the card
    by default; raises when there is none unless device='cpu')."""

    def __init__(self, model: torch.nn.Module, cfg: EngineConfig,
                 encoder_cfg: Optional[RRTEncoderConfig] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.encoder_cfg = encoder_cfg or RRTEncoderConfig()
        self.optimizer = make_optimizer(cfg.opt, self.model.parameters(),
                                        cfg.lr, cfg.weight_decay)
        self._loss = cross_entropy if cfg.loss == "ce" else bce_with_logits
        self.global_iter = 0
        self._order_rng = np.random.default_rng(
            FIXED_LOADER_SEED if cfg.fix_loader_random else cfg.seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)

    # -- batching ----------------------------------------------------------

    def _batched_order(self, dataset, order: Sequence[int]) -> List[List[int]]:
        """Greedy bucket-aware batching that preserves the given order within
        each bucket.  batch_size=1 degenerates to the reference's order."""
        bsz = self.cfg.batch_size
        if bsz <= 1:
            return [[i] for i in order]
        length_of = getattr(dataset, "length",
                            lambda i: np.asarray(dataset[i][0]).shape[0])
        pending: Dict[Tuple, List[int]] = {}
        batches: List[List[int]] = []
        for i in order:
            spec = bucket_for(length_of(i), self.encoder_cfg)
            q = pending.setdefault(spec.key, [])
            q.append(i)
            if len(q) == bsz:
                batches.append(q.copy())
                q.clear()
        for q in pending.values():
            if q:
                batches.append(q)
        return batches

    def _assemble_host(self, dataset, indices: Sequence[int]):
        """(x, mask, labels, spec) numpy arrays on the host."""
        bags, labels, lengths = [], [], []
        for i in indices:
            bag, label = dataset[i]
            bag = np.asarray(bag, dtype=np.float32)
            if bag.ndim == 3:
                bag = bag[0]
            bags.append(bag)
            labels.append(label)
            lengths.append(bag.shape[0])
        spec = bucket_for(max(lengths), self.encoder_cfg)
        xs, masks = zip(*[pad_bag(b, spec.data_length) for b in bags])
        return (np.stack(xs), np.stack(masks),
                np.asarray(labels, dtype=np.int64), spec)

    def _make_batch(self, dataset, indices: Sequence[int]):
        x, mask, labels, spec = self._assemble_host(dataset, indices)
        dev = self.device
        return (torch.from_numpy(x).to(dev), torch.from_numpy(mask).to(dev),
                torch.from_numpy(labels).to(dev), spec)

    # -- train -------------------------------------------------------------

    def current_lr(self, epoch: int, iters_per_epoch: int) -> float:
        cfg = self.cfg
        if cfg.lr_supi:
            return lr_at(cfg.lr_schedule, cfg.lr, self.global_iter,
                         cfg.num_epochs * iters_per_epoch)
        return lr_at(cfg.lr_schedule, cfg.lr, epoch, cfg.num_epochs)

    def _train_step(self, x, mask, labels, length: int) -> torch.Tensor:
        """Forward and backward of one batch; the gradients add into .grad
        (accumulation).  Returns the total loss, on the device."""
        cfg = self.cfg
        logits = self.model(x, mask=mask, length=length,
                            generator=self.generator)
        total = cfg.cls_alpha * self._loss(logits, labels)
        if cfg.accumulation_steps > 1:
            total = total / cfg.accumulation_steps
        total.backward()
        return total.detach()

    def _apply_grads(self, lr: float) -> None:
        """One optimizer update at `lr`, after clipping the global gradient
        norm to clip_grad (scale min(1, clip / (norm + 1e-6)))."""
        cfg = self.cfg
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        if cfg.clip_grad > 0:
            grads = [p.grad for p in self.model.parameters()
                     if p.grad is not None]
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g.float()) for g in grads]))
            scale = torch.clamp(cfg.clip_grad / (norm + 1e-6), max=1.0)
            for g in grads:
                g.mul_(scale.to(g.dtype))
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    def train_epoch(self, dataset, epoch: int,
                    order: Optional[Sequence[int]] = None) -> float:
        """One epoch in `order` (else a permutation from the engine's order
        RNG), bucket-batched; returns the mean total loss.  One host sync, at
        the end."""
        cfg = self.cfg
        if order is None:
            order = self._order_rng.permutation(len(dataset))
        batches = self._batched_order(dataset, order)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        meters: List[torch.Tensor] = []
        acc_n = 0
        for bi, batch in enumerate(batches):
            x, mask, labels, spec = self._make_batch(dataset, batch)
            lr = self.current_lr(epoch, len(batches))
            meters.append(self._train_step(x, mask, labels, spec.repr_length))
            acc_n += 1
            # a short tail window gets its update too: its grads were
            # pre-scaled by 1/acc, so its bags weigh as loss/acc dictates
            if acc_n == cfg.accumulation_steps or bi == len(batches) - 1:
                self._apply_grads(lr)
                acc_n = 0
            self.global_iter += 1
        if not meters:
            return 0.0
        return float(torch.stack(meters).mean())

    # -- eval --------------------------------------------------------------

    @torch.no_grad()
    def _eval_step(self, x, mask, labels, length: int):
        logits = self.model(x, mask=mask, length=length).float()
        if self.cfg.loss == "ce":
            losses = -F.log_softmax(logits, dim=-1).gather(
                1, labels[:, None])[:, 0]
            return torch.softmax(logits, dim=-1)[:, 1], losses
        onehot = F.one_hot(labels, self.cfg.n_classes).float()
        losses = -torch.mean(onehot * F.logsigmoid(logits)
                             + (1 - onehot) * F.logsigmoid(-logits), dim=-1)
        return torch.sigmoid(logits)[:, 1], losses

    def evaluate(self, dataset, order: Optional[Sequence[int]] = None):
        """Returns (probs, labels, mean_loss) over the dataset, in batch
        order.  One host sync, after the last batch."""
        self.model.eval()
        order = list(order if order is not None else range(len(dataset)))
        probs_all, labels_all, losses_all = [], [], []
        for batch in self._batched_order(dataset, order):
            x, mask, labels, spec = self._make_batch(dataset, batch)
            probs, losses = self._eval_step(x, mask, labels, spec.repr_length)
            probs_all.append(probs)
            labels_all.append(labels)
            losses_all.append(losses)
        probs = torch.cat(probs_all).cpu().numpy()
        labels = torch.cat(labels_all).cpu().numpy()
        losses = torch.cat(losses_all).cpu().numpy()
        return probs, labels, float(np.mean(losses))
