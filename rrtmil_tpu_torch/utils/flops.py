"""Analytic MAC count of one RRT-MIL forward.

A copy of the counting half of `rrtmil_tpu/utils/flops.py` (which imports
the JAX package's geometry).  It replaces the reference's thop profile at
input (1, 9000, 1024) (reference flops.ipynb) and the hand-written
`InnerAttention.flops(N)` estimator (reference modules/rmsa.py:139-150).
One convention throughout: MACs; callers wanting FLOPs apply x2 on `total`.
"""
from __future__ import annotations

from typing import Dict

from ..config import RRTEncoderConfig, RRTMILConfig
from ..ops.regions import grid_geometry


def inner_attention_flops(n: int, dim: int, num_heads: int,
                          epeg_k: int = 0) -> int:
    """Reference rmsa.py:139-150 per-region estimate (+ EPEG conv taps)."""
    flops = n * dim * 3 * dim                      # qkv
    flops += num_heads * n * (dim // num_heads) * n  # q @ k^T
    flops += num_heads * n * n * (dim // num_heads)  # attn @ v
    flops += n * dim * dim                         # proj
    if epeg_k:
        flops += num_heads * n * n * epeg_k        # depthwise logit conv
    return flops


def rmsa_flops(length: int, cfg: RRTEncoderConfig) -> int:
    geom = grid_geometry(length, cfg.rmsa_layer().rmsa.region)
    per_region = inner_attention_flops(geom.tokens_per_region, cfg.dim,
                                       cfg.n_heads,
                                       cfg.epeg_k if cfg.epeg else 0)
    return geom.num_regions * per_region


def crmsa_flops(length: int, cfg: RRTEncoderConfig) -> int:
    geom = grid_geometry(length, cfg.crmsa_layer().crmsa.region)
    p, nr, k = geom.tokens_per_region, geom.num_regions, cfg.crmsa_k
    flops = nr * p * cfg.dim * k * 2               # phi logits + compress
    flops += inner_attention_flops(nr, cfg.dim, cfg.crmsa_heads) * k
    flops += nr * k * p * cfg.dim                  # redistribute
    return flops


def encoder_flops(length: int, cfg: RRTEncoderConfig) -> int:
    total = (cfg.n_layers - 1) * rmsa_flops(length, cfg)
    if cfg.cr_msa:
        total += crmsa_flops(length, cfg)
    return total


def rrtmil_flops(length: int, cfg: RRTMILConfig) -> Dict[str, int]:
    """Per-component MAC counts for one bag forward."""
    proj = length * cfg.input_dim * 512
    enc = encoder_flops(length, cfg.encoder)
    pool = length * 512 * 128 + length * 128
    head = 512 * cfg.n_classes
    return {"patch_to_emb": proj, "encoder": enc, "pool": pool, "head": head,
            "total": proj + enc + pool + head}


def train_flops(length: int, cfg: RRTMILConfig) -> int:
    """FLOPs of one bag's train step: forward + backward = 3 x the forward's
    2 x MACs (bench.py:229-230's convention)."""
    return 3 * 2 * rrtmil_flops(length, cfg)["total"]
