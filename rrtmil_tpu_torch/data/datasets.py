"""WSI feature-bag datasets.

Counterpart of the dataset half of `rrtmil_tpu/data/datasets.py` (reference
dataloader.py:162-203): `load_feature_file`, `read_label_csv`, `BagDataset`,
`C16Dataset` (root/pt/{slide}.pt|.npy|.npz + label.csv) and `ArrayDataset`.
Bags come back as numpy float32 (N, D); the engine buckets, pads and moves
them to the device.
"""
from __future__ import annotations

import csv
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def load_feature_file(path: str) -> np.ndarray:
    """Load one bag of patch features as float32 (N, D)."""
    if path.endswith(".npy"):
        feats = np.load(path)
    elif path.endswith(".npz"):
        with np.load(path) as z:
            feats = z[list(z.files)[0]]
    elif path.endswith(".pt"):
        feats = torch.load(path, map_location="cpu", weights_only=True).numpy()
    else:
        raise ValueError(f"unsupported feature file {path!r}")
    feats = np.asarray(feats, dtype=np.float32)
    if feats.ndim == 3 and feats.shape[0] == 1:
        feats = feats[0]
    return feats


def read_label_csv(csv_file: str) -> Tuple[np.ndarray, np.ndarray]:
    """(patients, labels) from label.csv (reference dataloader.py:18-28)."""
    patients, labels = [], []
    with open(csv_file) as f:
        for row in csv.reader(f):
            if not row:
                continue
            patients.append(row[0])
            labels.append(row[1])
    return (np.array(patients, dtype=object), np.array(labels, dtype=object))


class BagDataset:
    """Base: a sequence of (features (N, D) float32, label int) bags.

    `keep_same_psize`: resample every bag to exactly that many patches --
    random per access on the train split, deterministic per slide on eval
    (the JAX package's working interpretation, docs/PARITY.md)."""

    slide_path: List[str]
    slide_label: List[int]

    def __init__(self, persistence: bool = False, keep_same_psize: int = 0,
                 is_train: bool = False):
        self.persistence = persistence
        self.keep_same_psize = int(keep_same_psize)
        self.is_train = is_train
        self._psize_rng = np.random.default_rng(7784414403328510413)
        self._cache: List[Optional[np.ndarray]] = []

    def _finalize(self):
        self._cache = [None] * len(self.slide_path)
        if self.persistence:
            for i in range(len(self.slide_path)):
                self._cache[i] = load_feature_file(self.slide_path[i])

    def __len__(self):
        return len(self.slide_path)

    def _load(self, idx: int) -> np.ndarray:
        if self._cache[idx] is None:
            feats = load_feature_file(self.slide_path[idx])
            if self.persistence:
                self._cache[idx] = feats
            return feats
        return self._cache[idx]

    def _same_psize(self, feats: np.ndarray, idx: int) -> np.ndarray:
        p = self.keep_same_psize
        rng = self._psize_rng if self.is_train else \
            np.random.default_rng(1000003 * idx + 7)
        n = feats.shape[0]
        sel = rng.choice(n, size=p, replace=n < p)
        return feats[np.sort(sel)]

    def bag(self, idx: int) -> np.ndarray:
        feats = self._load(idx)
        if self.keep_same_psize > 0:
            feats = self._same_psize(feats, idx)
        return feats

    def __getitem__(self, idx: int):
        return self.bag(idx), self.slide_label[idx]

    def length(self, idx: int) -> int:
        """Bag length; .npy files answer from the header alone."""
        if self.keep_same_psize > 0:
            return self.keep_same_psize
        cached = self._cache[idx]
        if cached is not None:
            return int(cached.shape[0])
        path = self.slide_path[idx]
        if path.endswith(".npy"):
            with open(path, "rb") as f:
                version = np.lib.format.read_magic(f)
                shape, _, _ = np.lib.format._read_array_header(f, version)
            if len(shape) == 3 and shape[0] == 1:
                return int(shape[1])
            return int(shape[0])
        return int(self.bag(idx).shape[0])

    def lengths(self) -> List[int]:
        return [self.length(i) for i in range(len(self))]


class C16Dataset(BagDataset):
    """Camelyon16: root/pt/{slide}.pt (or .npy/.npz) per slide."""

    def __init__(self, file_names: Sequence[str], file_labels: Sequence,
                 root: str, persistence: bool = False,
                 keep_same_psize: int = 0, is_train: bool = False):
        super().__init__(persistence, keep_same_psize, is_train)
        subdir = os.path.join(root, "pt")
        self.slide_path = []
        for name in file_names:
            for ext in (".pt", ".npy", ".npz"):
                p = os.path.join(subdir, name + ext)
                if os.path.exists(p):
                    self.slide_path.append(p)
                    break
            else:
                raise FileNotFoundError(f"no feature file for slide {name!r}")
        self.slide_label = [int(l) for l in file_labels]
        self._finalize()


class ArrayDataset(BagDataset):
    """In-memory bags (testing / synthetic data)."""

    def __init__(self, bags: Sequence[np.ndarray], labels: Sequence[int],
                 keep_same_psize: int = 0, is_train: bool = False):
        super().__init__(persistence=False, keep_same_psize=keep_same_psize,
                         is_train=is_train)
        self._bags = [np.asarray(b, dtype=np.float32) for b in bags]
        self.slide_path = [f"mem://{i}" for i in range(len(bags))]
        self.slide_label = [int(l) for l in labels]
        self._cache = [None] * len(self._bags)

    def _load(self, idx: int) -> np.ndarray:
        return self._bags[idx]
