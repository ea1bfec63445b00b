"""Evaluation engine over bucketed bags (the inference half).

Counterpart of the eval path of `rrtmil_tpu/train/engine.py`:
`EngineConfig` (the fields eval reads), `_batched_order` (greedy
bucket-aware batching that keeps the given order within a bucket), the
Python `_assemble_host` batch assembly, `_eval_step` (CE: softmax
probability of class 1 and per-bag NLL) and `evaluate`.
Per-batch results stay on the device and are fetched in one sync after the
last batch.  Training, the device bag cache and the native loader are later
slices (ROADMAP.md queue 1).
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


@dataclasses.dataclass
class EngineConfig:
    batch_size: int = 1


class Engine:
    """Drives one model through eval epochs on `device` (the card by
    default; raises when there is none unless device='cpu')."""

    def __init__(self, model: torch.nn.Module, cfg: EngineConfig,
                 encoder_cfg: Optional[RRTEncoderConfig] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.encoder_cfg = encoder_cfg or RRTEncoderConfig()

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

    # -- eval --------------------------------------------------------------

    @torch.no_grad()
    def _eval_step(self, x, mask, labels, length: int):
        logits = self.model(x, mask=mask, length=length).float()
        losses = -F.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
        return torch.softmax(logits, dim=-1)[:, 1], losses

    def evaluate(self, dataset, order: Optional[Sequence[int]] = None):
        """Returns (probs, labels, mean_loss) over the dataset, in batch
        order.  One host sync, after the last batch."""
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
