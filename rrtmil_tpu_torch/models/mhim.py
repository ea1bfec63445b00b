"""MHIM-MIL: masked hard instance mining with an EMA teacher.

Counterpart of `rrtmil_tpu/models/mhim.py` (reference Survival/models/MHIM/
network.py).  Student and teacher are the same network: `patch_to_emb`
(with a bias) -> activation -> dropout -> pooling encoder -> `predictor`.
The teacher's raw per-instance attention ranks the instances; the student
trains on a keep-mask (`build_keep_mask`) that drops a random `mask_ratio`
subset, the bottom `mask_ratio_l` by teacher attention and a scheduled
`mask_ratio_h` subset, folded into the pooling's softmax; a soft-target
cross entropy ties the student's bag feature to the teacher's
(`soft_target_ce`), and the teacher follows the student by EMA
(`ema_update`).

The pooling encoders (`baseline`): 'attn', gated attention without biases
(`attention_a` / `attention_b` / `attention_c`, `da_act` on the first
branch) whose softmax is masked by `mask & keep_mask`; 'selfattn', a cls
token drawn from N(0, 1), two Nystrom TransLayers (8 heads of `mlp_dim //
8`, `mlp_dim // 2` landmarks, output dropout 0.1) with TransMIL's PPEG
between them when the token count is a perfect square, masked tokens
zeroed (not gathered) and a zero attention map.  The survival harness
builds 'attn' only; 'selfattn' is reachable from no CLI.

The JAX package computes MHIM in plain XLA, outside any Pallas kernel, so
the port runs it as torch ops on either device.  The bag is read in
float32 (flax's Dense promotes a bf16 `--amp` bag).  `length` is taken
and ignored, as in the JAX module: the network reads every row it is
given, the mask selecting the true ones.

The keep-mask is split in two: `keep_mask_draws`, the uniform vectors from
an explicit `torch.Generator` (the JAX package draws them from
`jax.random`, so the draws differ between the frameworks), and the
deterministic `build_keep_mask`, which takes them with the teacher's
attention.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import NystromConfig
from ..train.losses import topk_stable
from .abmil import activation
from .nystrom import NystromAttention
from .pool import _ACTS, dropout, masked_softmax
from .rrt import LayerNorm
from .transmil import _PPEG


def cosine_schedule(base: float, final: float, epochs: int, niter_per_ep: int,
                    start_warmup: float = 0.0, warmup_epochs: int = 0
                    ) -> np.ndarray:
    """Reference cosine_scheduler (network.py:21-33 / utils.py:105-116)."""
    warmup = np.linspace(start_warmup, base, warmup_epochs * niter_per_ep) \
        if warmup_epochs > 0 else np.array([])
    iters = np.arange(epochs * niter_per_ep - len(warmup))
    sched = final + 0.5 * (base - final) * (1 + np.cos(np.pi * iters /
                                                       max(len(iters), 1)))
    return np.concatenate([warmup, sched])


def soft_target_ce(student: torch.Tensor, teacher: torch.Tensor,
                   temp_t: float = 1.0, temp_s: float = 1.0) -> torch.Tensor:
    """SoftTargetCrossEntropy_v2 (network.py:423-436), the teacher
    detached."""
    t = torch.softmax(teacher.detach() / temp_t, dim=-1)
    return torch.mean(torch.sum(-t * F.log_softmax(student / temp_s, dim=-1),
                                dim=-1))


class GatedPool(nn.Module):
    """The 'attn' baseline (network.py DAttention): gated attention pooling
    that also exposes the raw per-instance scores."""

    def __init__(self, dim: int = 512, act: str = "relu"):
        super().__init__()
        self.act = _ACTS[act]
        self.attention_a = nn.Linear(dim, 128, bias=False)
        self.attention_b = nn.Linear(dim, 128, bias=False)
        self.attention_c = nn.Linear(128, 1, bias=False)

    def forward(self, x, keep_mask=None, return_attn: bool = False,
                generator=None):
        a = self.act(self.attention_a(x))
        b = torch.sigmoid(self.attention_b(x))
        g = self.attention_c(a * b).transpose(-1, -2)         # (B, 1, N)
        gs = masked_softmax(g, None if keep_mask is None
                            else keep_mask[:, None, :])
        feat = (gs @ x)[:, 0]
        return (feat, g[:, 0]) if return_attn else feat


class SAttention(nn.Module):
    """The 'selfattn' baseline (network.py:320-409): cls token + two
    Nystrom TransLayers with PPEG between (on a square token count)."""

    def __init__(self, mlp_dim: int = 512, head: int = 8):
        super().__init__()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, mlp_dim))
        nys = NystromConfig(dim=mlp_dim, head_dim=mlp_dim // 8,
                            num_heads=head, num_landmarks=mlp_dim // 2,
                            dropout=0.1)
        self.layer1_norm = LayerNorm(mlp_dim)
        self.layer1_attn = NystromAttention(nys)
        self.pos_embedding = _PPEG(mlp_dim)
        self.layer2_norm = LayerNorm(mlp_dim)
        self.layer2_attn = NystromAttention(nys)
        self.norm = LayerNorm(mlp_dim)

    def init_own_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.cls_token.normal_(0.0, 1.0, generator=generator)

    def forward(self, x, keep_mask=None, return_attn: bool = False,
                generator=None):
        b, n, c = x.shape
        if keep_mask is not None:
            x = x * keep_mask[..., None].to(x.dtype)
        x = torch.cat([self.cls_token.expand(b, 1, c), x], dim=1)
        x = x + self.layer1_attn(self.layer1_norm(x), generator)
        side = int(math.ceil(math.sqrt(n)))
        if side * side == n:
            x = self.pos_embedding(x, side, side)
        x = x + self.layer2_attn(self.layer2_norm(x), generator)
        feat = self.norm(x)[:, 0]
        if return_attn:
            return feat, torch.zeros((b, n), dtype=feat.dtype,
                                     device=feat.device)
        return feat


class MHIM(nn.Module):
    """Student / teacher network (network.py:438-...): logits, then the bag
    feature with `return_feat`, then the raw attention with
    `return_attn`."""

    def __init__(self, input_dim: int = 1024, mlp_dim: int = 512,
                 n_classes: int = 4, dropout: float = 0.25, act: str = "relu",
                 da_act: str = "relu", baseline: str = "attn"):
        super().__init__()
        if baseline not in ("attn", "selfattn"):
            raise ValueError(f"baseline {baseline!r} is not 'attn' or "
                             f"'selfattn'")
        self.act, self.p = act, dropout
        self.patch_to_emb = nn.Linear(input_dim, mlp_dim)
        self.online_encoder = SAttention(mlp_dim) if baseline == "selfattn" \
            else GatedPool(mlp_dim, da_act)
        self.predictor = nn.Linear(mlp_dim, n_classes)

    def forward(self, x, mask=None, length: Optional[int] = None,
                keep_mask=None, generator: Optional[torch.Generator] = None,
                return_attn: bool = False, return_feat: bool = False):
        if x.dim() == 2:
            x = x[None]
        h = self.patch_to_emb(x.float())
        h = F.relu(h) if self.act == "relu" else activation("gelu", h)
        h = dropout(h, self.p, generator, self.training)
        km = mask
        if keep_mask is not None:
            km = keep_mask if km is None else (km & keep_mask)
        if return_attn:
            feat, attn = self.online_encoder(h, km, True, generator)
        else:
            feat, attn = self.online_encoder(h, km, False, generator), None
        out = [self.predictor(feat)]
        if return_feat:
            out.append(feat)
        if return_attn:
            out.append(attn)
        return tuple(out) if len(out) > 1 else out[0]


def mask_counts(length: int, mask_ratio: float, mask_ratio_l: float,
                mask_ratio_h: float) -> Tuple[int, int, int]:
    """(random, low-attention, high) drop counts: ceil(length * ratio)."""
    return tuple(int(math.ceil(length * r)) if r > 0 else 0
                 for r in (mask_ratio, mask_ratio_l, mask_ratio_h))


def keep_mask_draws(total_len: int, length: int, mask_ratio: float,
                    mask_ratio_h: float, mask_ratio_hr: float,
                    generator: torch.Generator, device=None):
    """The keep-mask's uniform draws over `total_len` rows: the random
    subset's, and the high subset's when it is random (`mask_ratio_hr` 0);
    None where `build_keep_mask` draws nothing."""
    k_rand, _, k_high = mask_counts(length, mask_ratio, 0.0, mask_ratio_h)

    def draw():
        return torch.rand(total_len, generator=generator, device=device)
    return (draw() if k_rand > 0 else None,
            draw() if k_high > 0 and mask_ratio_hr == 0.0 else None)


def build_keep_mask(draws, teacher_attn: torch.Tensor, length: int,
                    total_len: int, mask_ratio: float = 0.7,
                    mask_ratio_l: float = 0.2, mask_ratio_h: float = 0.0,
                    mask_ratio_hr: float = 0.0) -> torch.Tensor:
    """Boolean keep-mask over `total_len` rows (True: the student sees it),
    from `keep_mask_draws`' uniforms and the teacher's raw attention
    (rrtmil_tpu/models/mhim.py:186-223, the reference's get_mask,
    network.py:538-575): the rows below `length` are valid; drop the
    `ceil(length mask_ratio)` random rows (threshold rule: every score >=
    the k-th largest, ties kept), the `ceil(length mask_ratio_l)` lowest by
    teacher attention among the valid rows, and `ceil(length mask_ratio_h)`
    more (random when mask_ratio_hr is 0, else the highest by attention);
    ranks take ties by the lower index, as `jax.lax.top_k` does."""
    u_rand, u_high = draws
    dev = teacher_attn.device
    valid = torch.arange(total_len, device=dev) < length
    drop = torch.zeros(total_len, dtype=torch.bool, device=dev)
    k_rand, k_low, k_high = mask_counts(length, mask_ratio, mask_ratio_l,
                                        mask_ratio_h)
    if k_rand > 0:
        scores = torch.where(valid, u_rand, -1.0)
        drop |= scores >= topk_stable(scores, k_rand)[0][-1]
    if k_low > 0:
        att = torch.where(valid, teacher_attn, float("inf"))
        drop[topk_stable(-att, k_low)[1]] = True
    if k_high > 0:
        if mask_ratio_hr == 0.0:
            idx = topk_stable(torch.where(valid, u_high, -1.0), k_high)[1]
        else:
            idx = topk_stable(torch.where(valid, teacher_attn,
                                          float("-inf")), k_high)[1]
        drop[idx] = True
    return valid & ~drop


@torch.no_grad()
def ema_update(student: nn.Module, teacher: nn.Module,
               momentum: float) -> None:
    """teacher <- mm teacher + (1 - mm) student, in place, with mm and 1 - mm
    formed in float32 as the JAX package forms them (utils.py:15-24)."""
    mm = np.float32(momentum)
    rest = float(np.float32(1.0) - mm)
    for t, s in zip(teacher.parameters(), student.parameters()):
        t.mul_(float(mm)).add_(s * rest)
