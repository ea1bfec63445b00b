"""TCGA survival dataset: quartile-binned discrete hazards, multi-WSI bags.

Counterpart of `rrtmil_tpu/data/survival.py:26-125` (reference
Survival/datasets/TCGA_Survival.py):
  * `quantile_bins`: qcut the UNCENSORED event times into 4 quantile bins,
    then cut ALL rows by those bins widened to [min-eps, max+eps)
    (TCGA_Survival.py:52-63), in numpy;
  * `get_split`: the seeded (random.Random(1)) 80/20 split, in the
    reference's random.sample order (TCGA_Survival.py:21-33);
  * multi-WSI cases concatenate ';'-separated feature files
    (TCGA_Survival.py:35-39).

CSV schema (the reference's): columns Study, ID, Event, Status, WSI.
"""
from __future__ import annotations

import csv
import os
import random
from typing import List, Optional, Sequence

import numpy as np

from .datasets import feature_file_length, load_feature_file


def quantile_bins(event: np.ndarray, status: np.ndarray, n_bins: int = 4,
                  eps: float = 1e-6) -> np.ndarray:
    """The reference's qcut-then-cut labels (TCGA_Survival.py:52-61):
    integer bins in [0, n_bins), -1 for rows outside them."""
    event = np.asarray(event, dtype=np.float64)
    uncensored = event[np.asarray(status) == 1]
    # pandas qcut: linearly interpolated quantiles of the uncensored times
    qs = np.quantile(uncensored, np.linspace(0, 1, n_bins + 1))
    qs[-1] = event.max() + eps
    qs[0] = event.min() - eps
    # pd.cut(..., right=False): bins[i] <= x < bins[i+1]
    labels = np.searchsorted(qs, event, side="right") - 1
    labels[(event < qs[0]) | (event >= qs[-1])] = -1
    labels = np.clip(labels, -1, n_bins - 1)
    labels[~np.isfinite(event)] = -1
    return labels.astype(np.int64)


class SurvivalDataset:
    """Bags with (ID, features, event_time, censorship, label)."""

    def __init__(self, csv_file: str, folder: str = "plip",
                 root: Optional[str] = None, n_bins: int = 4):
        self.folder = folder
        self.root = root
        with open(csv_file) as f:
            rows = list(csv.DictReader(f))
        self.ids = [r["ID"] for r in rows]
        self.events = np.array([float(r["Event"]) for r in rows])
        self.status = np.array([int(float(r["Status"])) for r in rows])
        self.wsi_paths = [r["WSI"] for r in rows]
        self.labels = quantile_bins(self.events, self.status, n_bins)
        # censorship: 1 if no event was observed (TCGA_Survival.py:45)
        self.censorship = (self.status == 0).astype(np.int64)

    def __len__(self):
        return len(self.ids)

    def get_split(self, fold: int = 0, ratio: float = 0.2):
        """The reference's seeded split (TCGA_Survival.py:21-33):
        (train indices, validation indices)."""
        if not 0 <= fold <= 4:
            raise ValueError(f"fold {fold} is not in 0..4")
        rng = random.Random(1)
        sample_index = rng.sample(range(len(self)), len(self))
        num_split = round((len(self) - 1) * ratio)
        if fold < 1 / ratio - 1:
            val_split = sample_index[fold * num_split:(fold + 1) * num_split]
        else:
            val_split = sample_index[fold * num_split:]
        val_set = set(val_split)
        train_split = [i for i in sample_index if i not in val_set]
        return train_split, val_split

    def _resolve(self, path: str) -> List[str]:
        """On-disk paths of one CSV WSI entry ('resnet50' replaced by the
        feature folder, relative paths under `root`)."""
        out = []
        for p in path.replace("resnet50", self.folder).split(";"):
            if self.root is not None and not os.path.isabs(p):
                p = os.path.join(self.root, p)
            out.append(p)
        return out

    def resolved_path(self, idx: int) -> str:
        """Bag `idx`'s files as read, joined by ';' (its device cache key)."""
        return ";".join(self._resolve(self.wsi_paths[idx]))

    def read_wsi(self, path: str) -> np.ndarray:
        return np.concatenate([load_feature_file(p)
                               for p in self._resolve(path)], axis=0)

    def length(self, idx: int) -> int:
        """Bag `idx`'s patch count over its files (.npy headers alone)."""
        return sum(feature_file_length(p)
                   for p in self._resolve(self.wsi_paths[idx]))

    def __getitem__(self, idx: int):
        return (self.ids[idx], self.read_wsi(self.wsi_paths[idx]),
                float(self.events[idx]), int(self.censorship[idx]),
                int(self.labels[idx]))


class ArraySurvivalDataset(SurvivalDataset):
    """In-memory survival bags for tests and synthetic runs."""

    def __init__(self, bags: Sequence[np.ndarray], events: Sequence[float],
                 status: Sequence[int], n_bins: int = 4):
        self._bags = [np.asarray(b, np.float32) for b in bags]
        self.ids = [f"case_{i}" for i in range(len(bags))]
        self.wsi_paths = [f"mem://{i}" for i in range(len(bags))]
        self.events = np.asarray(events, np.float64)
        self.status = np.asarray(status, np.int64)
        self.labels = quantile_bins(self.events, self.status, n_bins)
        self.censorship = (self.status == 0).astype(np.int64)

    def resolved_path(self, idx: int) -> str:
        return self.wsi_paths[idx]      # mem://: keyed by the dataset's id

    def length(self, idx: int) -> int:
        return int(self._bags[idx].shape[0])

    def __getitem__(self, idx: int):
        return (self.ids[idx], self._bags[idx], float(self.events[idx]),
                int(self.censorship[idx]), int(self.labels[idx]))
