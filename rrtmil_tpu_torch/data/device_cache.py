"""Device-resident bag cache: pay the host-to-device transfer once, then
serve bags from device memory.

Counterpart of `rrtmil_tpu/data/device_cache.py`.  A WSI MIL dataset is
small enough to live on the card (Camelyon16-R50: ~400 bags x ~8k patches
x 1024 features is ~6.5 GB in bf16 against 80 GB), so after a bag's first
epoch its padded tensors stay on the device and later epochs (train and
eval) rebuild each batch with `torch.cat` on the device instead of
assembling and transferring it again.

An entry is one bag padded to its own bucket in the transfer dtype, with
its mask row and label: the per-slide slices a bucket-grouped batch
concatenates.  Key: the file path (a classification dataset's `slide_path`,
a survival dataset's resolved `wsi_paths` entry) when the dataset has a
stable on-disk identity and no per-access transform, so a slide shared by a
fold's train and test sets is cached once; else (dataset identity, index).
Datasets whose bag is redrawn on every access (same_psize train
resampling, tcga max_patch) are not cached at all: `cacheable(dataset,
train)` is the gate.

A byte budget caps device memory; once it is reached, later bags stream
uncached instead of exhausting the card.  Every mutation holds the lock:
the engine's prefetch threads call `get` / `put` concurrently.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

# (x (1, L, D), mask (1, L), label (1,)) on the device, and the BucketSpec
Entry = Tuple[Any, Any, Any, Any]


def cacheable(dataset, train: bool) -> bool:
    """False for datasets whose bag content is randomized per access:
    caching would freeze one draw and desync the dataset's RNG stream."""
    if getattr(dataset, "max_patch", -1) > 0:
        return False    # np.random subsample on every access (train + eval)
    if train and getattr(dataset, "keep_same_psize", 0) > 0:
        return False    # train-split resample per access; the eval-split
    return True         # resample is deterministic per slide -> cacheable


class DeviceBagCache:
    def __init__(self, budget_bytes: int):
        self.budget = int(budget_bytes)
        self.used = 0
        self.hits = 0
        self.misses = 0
        self._lock = threading.Lock()
        self._entries: Dict[Any, Entry] = {}
        # strong refs so a dataset's id() cannot be recycled by a new object
        # while its id-keyed entries are alive
        self._datasets: Dict[int, Any] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def _key(self, dataset, index: int):
        if getattr(dataset, "keep_same_psize", 0) <= 0:
            # survival datasets rewrite the CSV path (feature folder, root)
            # before loading: key on the resolved path, so two datasets with
            # another folder or root never share an entry
            rp = getattr(dataset, "resolved_path", None)
            paths = getattr(dataset, "slide_path", None)
            if paths is None:
                paths = getattr(dataset, "wsi_paths", None)
            p = (rp(index) if rp is not None
                 else paths[index] if paths is not None else None)
            # in-memory bags ("mem://{i}") are not stable across datasets:
            # two synthetic datasets sharing a cache would serve each other's
            # bags, so they take the id-keyed entry
            if isinstance(p, str) and not p.startswith("mem://"):
                return p
        return (id(dataset), index)

    def get(self, dataset, index: int) -> Optional[Entry]:
        with self._lock:
            e = self._entries.get(self._key(dataset, index))
            if e is None:
                self.misses += 1
                return None
            self.hits += 1
            return e

    def put(self, dataset, index: int, x, mask, label, spec) -> bool:
        nbytes = x.nbytes + mask.nbytes + label.nbytes
        key = self._key(dataset, index)
        with self._lock:
            if key in self._entries:
                return True
            if self.used + nbytes > self.budget:
                return False
            if isinstance(key, tuple):
                self._datasets[id(dataset)] = dataset
            self._entries[key] = (x, mask, label, spec)
            self.used += nbytes
            return True

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._datasets.clear()
            self.used = 0
