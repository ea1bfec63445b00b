"""Ragged-bag bucketing: static shapes with reference-exact numerics.

Counterpart of `rrtmil_tpu/data/bucketing.py`.  The reference pads every bag
of true length L to an H x W grid with H = W = ceil(sqrt(L)) rounded up to a
multiple of `region_num` (rmsa.py:175-202), so the grid side is constant over
whole intervals of L and the reference's own padding doubles as a bucketing
scheme:

  * bucket key  = the tuple of per-layer grid sides;
  * data length = the largest per-layer padded length (layers slice down);
  * repr length = s_bucket**2, a representative true length that yields the
    same geometry as every L in the bucket (passed to the model);
  * the true L only survives as the boolean token mask.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..config import RegionConfig, RRTEncoderConfig
from ..ops.regions import grid_geometry


def _rounding_modulus(region: RegionConfig) -> int:
    return region.region_size if region.region_size > 0 else region.region_num


def encoder_regions(cfg: RRTEncoderConfig) -> List[RegionConfig]:
    """The distinct region configs whose geometry the encoder evaluates."""
    regions = []
    if cfg.n_layers > 1 and cfg.attn_mode == "rmsa":
        regions.append(cfg.rmsa_layer().rmsa.region)
    if cfg.cr_msa:
        regions.append(cfg.crmsa_layer().crmsa.region)
    if not regions:
        regions.append(RegionConfig())
    return regions


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    key: Tuple[int, ...]   # per-layer grid sides
    repr_length: int       # `length` to pass to the model
    data_length: int       # pad bags to this many tokens

    @property
    def grid(self) -> int:
        return int(math.isqrt(self.data_length))


def bucket_for(length: int, cfg: RRTEncoderConfig) -> BucketSpec:
    regions = encoder_regions(cfg)
    g = math.gcd(*[_rounding_modulus(r) for r in regions]) if len(regions) > 1 \
        else _rounding_modulus(regions[0])
    s = int(math.ceil(math.sqrt(length)))
    s_bucket = s + (-s) % g
    repr_length = s_bucket * s_bucket
    geoms = [grid_geometry(repr_length, r) for r in regions]
    return BucketSpec(key=tuple(gm.grid for gm in geoms),
                      repr_length=repr_length,
                      data_length=max(gm.padded_length for gm in geoms))


def pad_bag(features: np.ndarray, data_length: int):
    """(L, D) -> ((data_length, D), bool mask (data_length,))."""
    l = features.shape[0]
    if l > data_length:
        raise ValueError(f"bag length {l} exceeds bucket {data_length}")
    out = np.zeros((data_length, features.shape[1]), dtype=features.dtype)
    out[:l] = features
    mask = np.zeros((data_length,), dtype=bool)
    mask[:l] = True
    return out, mask


def group_by_bucket(lengths: Sequence[int], cfg: RRTEncoderConfig
                    ) -> Dict[BucketSpec, List[int]]:
    """Map bucket -> indices of bags that fall in it (for batched steps)."""
    groups: Dict[BucketSpec, List[int]] = {}
    for idx, length in enumerate(lengths):
        spec = bucket_for(int(length), cfg)
        groups.setdefault(spec, []).append(idx)
    return groups
