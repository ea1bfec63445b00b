"""WSI feature-bag datasets and CV splits.

Counterpart of `rrtmil_tpu/data/datasets.py` (reference dataloader.py):
`load_feature_file`, `read_label_csv`, the patient-stratified k-fold
(`stratified_kfold_indices`, `get_kfold`, :65-93) with the label-balanced
val split (`data_split`, :30-62), `BagDataset`, `C16Dataset`
(root/pt/{slide}.pt|.npy|.npz + label.csv, :162-203), `TCGADataset`
(patients matched to root/pt_files/, :108-160) and `ArrayDataset`.  The
splits draw from Python's global `random` and TCGA's `max_patch` from
numpy's global stream, as the JAX package does, so the same seeds give the
same bits.  Bags come back as numpy float32 (N, D); the engine buckets,
pads and moves them to the device.
"""
from __future__ import annotations

import csv
import os
import random
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


def feature_file_length(path: str) -> int:
    """The bag length of one feature file; a .npy file answers from its
    header alone."""
    if not path.endswith(".npy"):
        return int(load_feature_file(path).shape[0])
    shape = np.load(path, mmap_mode="r").shape     # maps, reads no rows
    return int(shape[1] if len(shape) == 3 and shape[0] == 1 else shape[0])


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


def stratified_kfold_indices(labels: Sequence, k: int
                             ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """StratifiedKFold(n_splits=k, shuffle=False) fold assignment, matching
    sklearn's allocation: per-class contiguous chunks distributed so each
    fold receives floor/ceil(count/k) of each class, ordered by fold."""
    labels = np.asarray(labels)
    # sklearn encodes classes by order of FIRST APPEARANCE in y.
    _, first_idx, y_inv = np.unique(labels, return_index=True,
                                    return_inverse=True)
    _, class_perm = np.unique(first_idx, return_inverse=True)
    y_idx = class_perm[y_inv]
    n_classes = len(first_idx)
    n = len(labels)
    y_order = np.sort(y_idx, kind="stable")
    allocation = np.asarray(
        [np.bincount(y_order[i::k], minlength=n_classes) for i in range(k)])
    test_folds = np.empty(n, dtype=int)
    for ci in range(n_classes):
        test_folds[y_idx == ci] = np.arange(k).repeat(allocation[:, ci])
    idx = np.arange(n)
    return [(idx[test_folds != f], idx[test_folds == f]) for f in range(k)]


def data_split(full_list: np.ndarray, ratio: float, shuffle: bool = True,
               label: Optional[np.ndarray] = None,
               label_balance_val: bool = True,
               rng: Optional[random.Random] = None):
    """Val/train split of fold-train indices (reference dataloader.py:30-62);
    shuffles with `rng`, else Python's global `random`."""
    rng = rng or random
    full_list = np.asarray(full_list)
    if label_balance_val and label is not None:
        _label = label[full_list]
        sub1, sub2 = [], []
        for _l in np.unique(_label):
            _list = list(full_list[_label == _l])
            offset = int(len(_list) * ratio)
            if shuffle:
                rng.shuffle(_list)
            sub1.extend(_list[:offset])
            sub2.extend(_list[offset:])
        return np.array(sub1, dtype=int), np.array(sub2, dtype=int)
    n_total = len(full_list)
    offset = int(n_total * ratio)
    if n_total == 0 or offset < 1:
        return np.array([], dtype=int), full_list
    items = list(full_list)
    if shuffle:
        rng.shuffle(items)
    return (np.array(items[:offset], dtype=int),
            np.array(items[offset:], dtype=int))


def get_kfold(k: int, patients: np.ndarray, labels: np.ndarray,
              val_ratio: float = 0.0, label_balance_val: bool = True,
              rng: Optional[random.Random] = None):
    """Patient-stratified CV splits (reference dataloader.py:65-93).
    Returns per-fold (train_p, train_l, test_p, test_l, val_p, val_l)."""
    folds = []
    for train_index, test_index in stratified_kfold_indices(labels, k):
        if val_ratio != 0.0:
            val_index, train_index = data_split(
                train_index, val_ratio, True, labels, label_balance_val, rng)
            x_val, y_val = patients[val_index], labels[val_index]
        else:
            x_val = np.array([], dtype=object)
            y_val = np.array([], dtype=object)
        folds.append((patients[train_index], labels[train_index],
                      patients[test_index], labels[test_index], x_val, y_val))
    return folds


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
            return feature_file_length(path)
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


class TCGADataset(BagDataset):
    """TCGA subtyping: match patients to slide files under root/pt_files/
    (reference dataloader.py:108-160); LUAD/IDC -> 0, else 1.  With
    `max_patch` > 0 every load keeps a random `max_patch` of the bag's
    patches, drawn from numpy's global stream."""

    def __init__(self, patient_names: Sequence[str], patient_labels: Sequence,
                 root: str, max_patch: int = -1, persistence: bool = False,
                 subtype: str = "nsclc", keep_same_psize: int = 0,
                 is_train: bool = False):
        super().__init__(persistence, keep_same_psize, is_train)
        self.max_patch = max_patch
        all_pts = sorted(os.listdir(os.path.join(root, "pt_files")))
        self.slide_path, raw_labels = [], []
        for patient, label in zip(patient_names, patient_labels):
            for slide in all_pts:
                if patient in slide:
                    self.slide_path.append(os.path.join(root, "pt_files",
                                                        slide))
                    raw_labels.append(label)
        pos = {"nsclc": "LUAD", "brca": "IDC"}[subtype.lower()]
        self.slide_label = [0 if l == pos else 1 for l in raw_labels]
        self._finalize()

    def _load(self, idx: int) -> np.ndarray:
        feats = super()._load(idx)
        if 0 < self.max_patch < feats.shape[0]:
            sel = np.random.permutation(feats.shape[0])[: self.max_patch]
            feats = feats[sel]
        return feats

    def length(self, idx: int) -> int:
        n = super().length(idx)
        if self.max_patch > 0 and self.keep_same_psize <= 0:
            n = min(n, self.max_patch)  # same_psize resamples to p last
        return n


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
