"""Bag-level shuffle augmentations (reference utils.py:26-70).

A copy of `rrtmil_tpu/data/augment.py`: host-side index permutations drawn
from a numpy `Generator`, applied to the (L, D) bag before padding and
transfer, so the same generator state gives the same bag and leaves the
same state behind.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np


def patch_shuffle_indices(p: int, group: int,
                          rng: Optional[np.random.Generator] = None
                          ) -> np.ndarray:
    """2-D group-block shuffle on the ceil-sqrt grid (utils.py:26-56):
    partition the square grid into group x group blocks, permute the blocks,
    flatten back, keep only real-token indices."""
    rng = rng or np.random.default_rng()
    h = int(math.ceil(math.sqrt(p)))
    if group > h or group <= 0:
        return group_shuffle_indices(p, group, rng)
    h += (-h) % group
    ps = np.concatenate([np.arange(p), np.full(h * h - p, -1, dtype=np.int64)])
    ps = ps.reshape(group, h // group, group, h // group)
    ps = np.einsum("hpwq->hwpq", ps).reshape(group * group, h // group,
                                             h // group)
    ps = ps[rng.permutation(ps.shape[0])]
    ps = ps.reshape(group, group, h // group, h // group)
    ps = np.einsum("hwpq->hpwq", ps).reshape(h, h)
    return ps[ps >= 0].reshape(p)


def group_shuffle_indices(p: int, group: int,
                          rng: Optional[np.random.Generator] = None
                          ) -> np.ndarray:
    """1-D group shuffle (utils.py:58-70)."""
    rng = rng or np.random.default_rng()
    if 0 < group < p:
        pad = (-p) % group
        ps = np.concatenate([np.arange(p), np.full(pad, -1, dtype=np.int64)])
        ps = ps.reshape(group, -1)
        ps = ps[rng.permutation(group)]
        return ps[ps >= 0].reshape(p)
    return rng.permutation(p)


def patch_shuffle(bag: np.ndarray, group: int,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
    return bag[patch_shuffle_indices(bag.shape[0], group, rng)]


def group_shuffle(bag: np.ndarray, group: int,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
    return bag[group_shuffle_indices(bag.shape[0], group, rng)]
