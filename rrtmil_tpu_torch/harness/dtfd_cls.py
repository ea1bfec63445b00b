"""Classification DTFD trainer (reference standalone DTFD/main.py:419-551).

Counterpart of `rrtmil_tpu/harness/dtfd_cls.py`.  The reference trains two
tiers with two Adams: loss0 = CE(pseudo-bag logits, the label repeated G
times), its gradient clipped per tier-1 submodule; loss1 = CE(tier-2
logits, label), whose gradient flows into tier 1 unclipped through the
distilled features and is clipped on the tier-2 classifier.  Adam is
elementwise and both share their settings, so one Adam over the union
steps the same:

  tier-1 grads = clip(d loss0), per group of TIER1_CLIP_GROUPS, + d loss1
  tier-2 grads = clip(d loss1), TIER2_KEYS as one group

each group clipped by its own global norm, scale min(1, max_norm / (norm +
1e-6)).  The JAX step applies the model twice under one dropout key, so
both losses see the same dropout masks; here one train forward gives both
losses and `torch.autograd.grad` takes their gradients from its graph.
The engine's global `clip_grad` does not apply (the JAX step ignores it),
and each bag takes its own update (`accumulation_steps` must be 1).

`evaluate` shuffles each bag's true instances before chunking
(DTFD/main.py:342), pad rows kept at the tail: a permutation from
`np.random.default_rng(seed + 0xD7FD)`, made anew in each call, so the
port draws the JAX package's permutations bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..models.dtfd import DTFD
from ..train.engine import Engine, EngineConfig
from ..train.losses import cross_entropy

TIER2_KEYS = ("u_attention", "u_classifier_fc")
# per-submodule clip groups of tier 1 (DTFD/main.py:523-525)
TIER1_CLIP_GROUPS = (("dim_fc1",), ("attention",),
                     ("classifier_kernel", "classifier_bias"))
EVAL_PERM_SEED = 0xD7FD       # added to the engine's seed


def eval_permutation(rng: np.random.Generator, true_len: int,
                     length: int) -> torch.Tensor:
    """The eval path's instance order: the true rows permuted, the pad rows
    after them in place."""
    return torch.from_numpy(np.concatenate([
        rng.permutation(true_len), np.arange(true_len, length)]))


def clip_groups(grads: Dict[str, torch.Tensor], groups,
                max_norm: float) -> None:
    """Scale each group's gradients (parameters named by their top-level
    module) by min(1, max_norm / (global norm + 1e-6)), in place."""
    for keys in groups:
        sub = [g for name, g in grads.items() if name.split(".")[0] in keys]
        if not sub:
            continue
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in sub]))
        scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
        for g in sub:
            g.mul_(scale)


class DTFDClassificationEngine(Engine):
    """Engine for DTFD(survival=False): train forward -> (pseudo logits (G,
    C), bag logits (1, C)); eval forward -> logits (1, C)."""

    def __init__(self, model: DTFD, cfg: EngineConfig, encoder_cfg=None,
                 grad_clipping: float = 5.0, device="cuda"):
        if cfg.batch_size != 1 or cfg.accumulation_steps != 1:
            raise ValueError("DTFD trains one bag a step: batch_size and "
                             "accumulation_steps must be 1")
        super().__init__(model, dataclasses.replace(cfg, clip_grad=0.0),
                         encoder_cfg, device=device)
        self.grad_clipping = grad_clipping

    def _train_step(self, x, mask, labels, length: int,
                    label: Optional[int] = None) -> torch.Tensor:
        """One forward, the two losses' gradients composed into `.grad`;
        meters (loss0 + loss1, loss1, loss0)."""
        self.last_ps = 0
        pseudo_logits, bag_logits = self.model(
            x, mask=mask, length=length, generator=self.generator,
            train=True)
        loss0 = cross_entropy(pseudo_logits,
                              labels[:1].expand(pseudo_logits.shape[0]))
        loss1 = cross_entropy(bag_logits, labels[:1])
        names, params = zip(*self.model.named_parameters())

        def grads(loss, retain):
            got = torch.autograd.grad(loss, params, retain_graph=retain,
                                      allow_unused=True)
            return {n: torch.zeros_like(p) if g is None else g
                    for n, p, g in zip(names, params, got)}
        g0, g1 = grads(loss0, True), grads(loss1, False)
        clip_groups(g0, TIER1_CLIP_GROUPS, self.grad_clipping)
        for n in names:
            if n.split(".")[0] not in TIER2_KEYS:
                g1[n] = g1[n] + g0[n]
        clip_groups(g1, (TIER2_KEYS,), self.grad_clipping)
        for n, p in zip(names, params):
            p.grad = g1[n]
        return torch.stack([loss0 + loss1, loss1, loss0]).detach().float()

    @torch.no_grad()
    def _eval_step_perm(self, x, mask, labels, perm, length: int):
        logits = self.model(x, mask=mask, length=length,
                            eval_perm=perm).float()
        losses = -F.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
        return torch.softmax(logits, dim=-1)[:, 1], losses

    def evaluate(self, dataset, order: Optional[Sequence[int]] = None):
        """(probs, labels, mean loss) over the dataset in `order`, each bag's
        instances permuted before chunking."""
        self.model.eval()
        order = list(order if order is not None else range(len(dataset)))
        rng = np.random.default_rng(self.cfg.seed + EVAL_PERM_SEED)
        probs_all, labels_all, losses_all = [], [], []
        batches: List[List[int]] = [[i] for i in order]
        for idx, (x, mask, labels, spec) in zip(
                order, self._batch_iter(dataset, batches, False)):
            perm = eval_permutation(rng, dataset.length(idx),
                                    spec.repr_length)
            probs, losses = self._eval_step_perm(x, mask, labels, perm,
                                                 spec.repr_length)
            probs_all.append(probs)
            labels_all.append(labels)
            losses_all.append(losses)
        return (torch.cat(probs_all).cpu().numpy(),
                torch.cat(labels_all).cpu().numpy(),
                float(np.mean(torch.cat(losses_all).cpu().numpy())))
