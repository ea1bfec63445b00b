"""The port's data layer against the JAX package on the CPU: the k-fold
splits, `TCGADataset`, the shuffle augmentations, `EarlyStopping`, and the
engine's batch routes (the device bag cache, the bfloat16 transfer).

Splits, listings, augmentation streams and early-stopping decisions are
held for equality: the port copies the JAX package's arithmetic on the
same Python / numpy random streams, so the same seeds give the same bits.
"""
import os
import types

import numpy as np
import pytest
import torch

from rrtmil_tpu.data import augment as jaugment
from rrtmil_tpu.data.datasets import TCGADataset as JTCGADataset
from rrtmil_tpu.harness.classification import make_splits as jmake_splits
from rrtmil_tpu.train.earlystop import EarlyStopping as JEarlyStopping
from rrtmil_tpu_torch.config import RRTEncoderConfig
from rrtmil_tpu_torch.data import augment
from rrtmil_tpu_torch.data.datasets import (ArrayDataset, C16Dataset,
                                            TCGADataset)
from rrtmil_tpu_torch.data.device_cache import DeviceBagCache, cacheable
from rrtmil_tpu_torch.harness.classification import make_splits
from rrtmil_tpu_torch.train.earlystop import EarlyStopping
from rrtmil_tpu_torch.train.engine import Engine, EngineConfig


def _write_labels(root, labels):
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "label.csv"), "w") as f:
        f.write("".join(f"patient_{i:03d},{l}\n"
                        for i, l in enumerate(labels)))


@pytest.mark.parametrize("seed", [0, 2021])
@pytest.mark.parametrize("kind", ["int", "str"])
@pytest.mark.parametrize("val_ratio", [0.0, 0.2])
@pytest.mark.parametrize("k", [2, 5])
def test_splits_are_jax_bits(tmp_path, k, val_ratio, kind, seed):
    """make_splits (seeded patient shuffle, stratified k-fold, the
    label-balanced val split) on 23 patients of unbalanced classes: every
    fold's six arrays equal the JAX package's, element and dtype."""
    rng = np.random.default_rng(seed + 1)
    labels = (rng.random(23) < 0.4).astype(int)
    if kind == "str":
        labels = np.where(labels == 1, "LUSC", "LUAD")
    _write_labels(str(tmp_path), labels)
    args = types.SimpleNamespace(seed=seed, dataset_root=str(tmp_path),
                                 cv_fold=k, val_ratio=val_ratio)
    want = jmake_splits(args)
    got = make_splits(args)
    assert len(got) == len(want) == k
    for fold_got, fold_want in zip(got, want):
        for a, b in zip(fold_got, fold_want):
            assert a.dtype == b.dtype
            assert a.tolist() == b.tolist()
    test_sets = np.concatenate([f[2] for f in got])
    assert sorted(test_sets.tolist()) == sorted(
        f"patient_{i:03d}" for i in range(23))


def test_tcga_dataset_matches_jax(tmp_path):
    """One synthetic root/pt_files/: patients with one, two or no slides,
    LUAD / LUSC labels.  The same slide listing and labels as the JAX
    package's, and with max_patch the same subsamples from numpy's global
    stream, load after load."""
    root = str(tmp_path)
    os.makedirs(os.path.join(root, "pt_files"))
    rng = np.random.default_rng(3)
    patients, labels = [], []
    for i in range(6):
        pid = f"TCGA-AB-{i:04d}"
        patients.append(pid)
        labels.append("LUAD" if i % 2 else "LUSC")
        for s in range(i % 3):
            bag = rng.standard_normal((int(rng.integers(20, 60)), 8))
            np.save(os.path.join(root, "pt_files", f"{pid}-0{s}Z.npy"),
                    bag.astype(np.float32))
    for max_patch in (-1, 25):
        jds = JTCGADataset(patients, labels, root, max_patch=max_patch)
        ds = TCGADataset(patients, labels, root, max_patch=max_patch)
        assert ds.slide_path == jds.slide_path and len(ds) == 6
        assert ds.slide_label == jds.slide_label
        assert [ds.length(i) for i in range(len(ds))] == \
            [jds.length(i) for i in range(len(jds))]
        for epoch in range(2):
            np.random.seed(epoch)
            want = [jds[i][0] for i in range(len(jds))]
            np.random.seed(epoch)
            got = [ds[i][0] for i in range(len(ds))]
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        assert cacheable(ds, False) == (max_patch <= 0)
    with pytest.raises(KeyError):
        TCGADataset(patients, labels, root, subtype="rcc")


@pytest.mark.parametrize("fn", ["patch_shuffle", "group_shuffle"])
@pytest.mark.parametrize("p,group", [(1, 0), (50, 0), (50, 3), (144, 4),
                                     (937, 8), (10, 40)])
def test_augmentations_match_jax(fn, p, group):
    """The same shuffled bag and the same Generator state after, three draws
    in a row (group 0 and groups past the grid fall back to a permutation)."""
    bag = np.arange(p * 3, dtype=np.float32).reshape(p, 3)
    g, jg = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        got = getattr(augment, fn)(bag, group, g)
        want = getattr(jaugment, fn)(bag, group, jg)
        np.testing.assert_array_equal(got, want)
        assert sorted(got[:, 0].tolist()) == bag[:, 0].tolist()
    assert g.bit_generator.state == jg.bit_generator.state


def test_early_stopping_matches_jax():
    """A scripted -AUC sequence past stop_epoch: the same improved /
    counter / early_stop sequence, and a state_dict round trip resumes it."""
    scores = [-0.5, -0.6, -0.55, -0.6, -0.58, -0.7, -0.69, -0.69, -0.68,
              -0.65, -0.6]
    es = EarlyStopping(patience=3, stop_epoch=4, save_best_model_stage=1)
    jes = JEarlyStopping(patience=3, stop_epoch=4, save_best_model_stage=1)
    trace = []
    for epoch, s in enumerate(scores):
        got, want = es(epoch, s), jes(epoch, s)
        assert got == want
        assert (es.counter, es.early_stop, es.best_score) == \
            (jes.counter, jes.early_stop, jes.best_score)
        trace.append(es.early_stop)
        if epoch == 6:
            saved = es.state_dict()
            assert saved == jes.state_dict()
    assert trace.index(True) == 8
    resumed = EarlyStopping()
    resumed.load_state_dict(saved)
    for epoch, s in enumerate(scores[7:], start=7):
        resumed(epoch, s)
    assert resumed.state_dict() == es.state_dict()


def _engine(**kw):
    enc = RRTEncoderConfig()
    model = torch.nn.Linear(4, 2)
    return Engine(model, EngineConfig(**kw), enc, device="cpu")


def _bags(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, 4)).astype(np.float32) for n in lengths]


def test_device_cache_serves_later_epochs(tmp_path):
    """device_cache='on' (on the CPU device here; 'auto' keeps it off
    there): the first pass over a C16Dataset misses and stores every bag,
    the second hits every bag and gives the host assembly's batches, batch
    size 2 rebuilt by concatenation; a second dataset over the same files
    hits the entries keyed by path; the budget stops storing at its edge."""
    os.makedirs(tmp_path / "pt")
    bags = _bags((70, 100, 200, 250, 90))
    names = [f"s{i}" for i in range(len(bags))]
    for n, b in zip(names, bags):
        np.save(tmp_path / "pt" / f"{n}.npy", b)
    ds = C16Dataset(names, [0, 1, 0, 1, 1], str(tmp_path))
    assert _engine(device_cache="auto")._device_cache() is None
    eng = _engine(device_cache="on", batch_size=2, num_workers=0)
    batches = eng._batched_order(ds, range(len(ds)))
    first = [eng._make_batch(ds, b) for b in batches]
    cache = eng._dcache
    assert (cache.hits, cache.misses, len(cache)) == (0, 5, 5)
    second = [eng._make_batch(ds, b) for b in batches]
    assert (cache.hits, cache.misses) == (5, 5)
    for b, (x1, m1, l1, s1), (x2, m2, l2, s2) in zip(batches, first, second):
        x, m, l, s = eng._assemble_host(ds, b, False)
        assert s1 == s2 == s
        for got, want in ((x1, x), (x2, x), (m2, m), (l2, l)):
            np.testing.assert_array_equal(got.numpy(), want)
    other = C16Dataset(names[:2], [0, 1], str(tmp_path))
    eng._make_batch(other, [0])
    assert cache.hits == 6 and len(cache) == 5
    eng.close()
    assert eng._dcache is None

    small = DeviceBagCache(budget_bytes=3 * 256 * 4 * 4)
    x = torch.zeros(1, 256, 4)
    m, l = torch.ones(1, 256, dtype=torch.bool), torch.zeros(1)
    puts = [small.put(ds, i, x, m, l, None) for i in range(4)]
    assert puts == [True, True, False, False] and len(small) == 2


def test_cache_bypassed_for_augmentation_and_redrawn_bags():
    """Augmented train batches and per-access resampled datasets never
    touch the cache; eval batches of the same engine do."""
    ds = ArrayDataset(_bags((70, 80)), [0, 1])
    eng = _engine(device_cache="on", patch_shuffle=True, num_workers=0)
    eng._make_batch(ds, [0], train=True)
    assert eng._dcache is None
    eng._make_batch(ds, [0], train=False)
    assert eng._dcache.misses == 1
    resampled = ArrayDataset(_bags((70, 80)), [0, 1], keep_same_psize=50,
                             is_train=True)
    assert not cacheable(resampled, True) and cacheable(resampled, False)


def test_bfloat16_transfer_rounds_on_the_host():
    """transfer_dtype='bfloat16' (--amp): the batch's x is the float32 host
    array rounded to bfloat16 (nearest even), the mask and labels as
    before; an unknown dtype is refused."""
    ds = ArrayDataset(_bags((70, 100)), [0, 1])
    eng = _engine(transfer_dtype="bfloat16", batch_size=2)
    x, mask, labels, spec = eng._make_batch(ds, [0, 1])
    xh, mh, lh, _ = eng._assemble_host(ds, [0, 1], False)
    assert x.dtype == torch.bfloat16
    assert torch.equal(x, torch.from_numpy(xh).to(torch.bfloat16))
    assert torch.equal(mask, torch.from_numpy(mh))
    assert labels.tolist() == [0, 1] and x.shape[1] == spec.data_length
    with pytest.raises(ValueError, match="transfer_dtype"):
        _engine(transfer_dtype="float16")
