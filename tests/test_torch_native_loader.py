"""The engine's native loader tier against its Python tier and the JAX
package's loader, on the CPU.

`data/native_loader.py` builds `native/bag_loader.cpp` under
`rrtmil_tpu_torch/build/` and never touches `native/`.  For `<f4` and `<f2`
files, batches of the native tier equal the Python tier's bit for bit
(x, mask, labels, bucket) in float32 and bfloat16 (--amp), and equal the
JAX package's `native_loader.fill_batch` (built with its own flags into a
temporary directory, never its tracked library).  3-D, `<f8` and
Fortran-order files, and datasets whose bags the Python `__getitem__`
resamples, take the Python tier, and the tier counter shows it.  An
engine's train and evaluate epochs through the native tier give the Python
tier's losses, probabilities and weights bit for bit.  Two racing first
builds leave one good library; a failed build raises with the compiler's
output.
"""
import os
import threading

import numpy as np
import pytest
import torch

from rrtmil_tpu.data import native_loader as jnl
from rrtmil_tpu_torch.config import RRTEncoderConfig
from rrtmil_tpu_torch.data import native_loader
from rrtmil_tpu_torch.data.datasets import C16Dataset, TCGADataset
from rrtmil_tpu_torch.models import zoo
from rrtmil_tpu_torch.train.engine import Engine, EngineConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENGTHS = (70, 100, 250, 37, 300, 90)


def write_set(root, dtype="<f4", lengths=LENGTHS, dim=24, seed=0):
    """camelyon16 layout: root/pt/s{i}.npy in `dtype`, labels i % 2."""
    os.makedirs(os.path.join(root, "pt"), exist_ok=True)
    rng = np.random.default_rng(seed)
    names = []
    for i, n in enumerate(lengths):
        a = (rng.standard_normal((n, dim)) * 3).astype(np.dtype(dtype))
        np.save(os.path.join(root, "pt", f"s{i}.npy"), a)
        names.append(f"s{i}")
    return C16Dataset(names, [i % 2 for i in range(len(names))], root)


def engine(model=None, **kw):
    kw.setdefault("device_cache", "off")
    return Engine(model or torch.nn.Linear(4, 2), EngineConfig(**kw),
                  RRTEncoderConfig(), device="cpu")


def bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_library_is_built_under_the_port_build_dir():
    native = os.path.join(REPO, "native")
    before = {n: os.stat(os.path.join(native, n)).st_mtime_ns
              for n in os.listdir(native)}
    lib = native_loader.load()
    path = native_loader.library_path()
    assert path.parent == native_loader.PKG_DIR / "build"
    assert path.exists() and lib._name == str(path)
    assert path.name.startswith("libbag_loader-")
    assert {n: os.stat(os.path.join(native, n)).st_mtime_ns
            for n in os.listdir(native)} == before


@pytest.mark.parametrize("descr", ["<f4", "<f2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_native_batches_equal_the_python_tier_and_jax(tmp_path, monkeypatch,
                                                      descr, dtype):
    ds = write_set(str(tmp_path), descr)
    eng = engine(transfer_dtype=dtype)
    monkeypatch.setattr(jnl, "_LIB", str(tmp_path / "jax_lib.so"))
    monkeypatch.setattr(jnl, "_lib", None)
    monkeypatch.setattr(jnl, "_build_failed", False)
    for batch in ([0, 1, 2], [3], [4, 5]):
        assert eng.native_ok(ds, batch, True)
        x, mask, labels, spec = eng._assemble_native(ds, batch)
        xh, mh, lh, sh = eng._assemble_host(ds, batch, True)
        assert spec == sh and x.dtype == getattr(torch, dtype)
        want = torch.from_numpy(xh).to(x.dtype)
        assert torch.equal(bits(x), bits(want))
        assert torch.equal(mask, torch.from_numpy(mh))
        assert labels.tolist() == lh.tolist()
        jx, jmask, jrows = jnl.fill_batch([ds.slide_path[i] for i in batch],
                                          spec.data_length, 24, dtype=dtype)
        np.testing.assert_array_equal(
            bits(x).numpy(), jx.view(np.int16) if dtype == "bfloat16"
            else jx)
        np.testing.assert_array_equal(mask.numpy(), jmask)
        assert jrows.tolist() == [LENGTHS[i] for i in batch]


def _odd_files(root):
    """(name, array) of files the C++ parser cannot read as numpy does."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((60, 24))
    return [("three_d", a[None].astype(np.float32)),
            ("f8", a),
            ("fortran", np.asfortranarray(a.astype(np.float32)))]


def test_other_files_take_the_python_tier(tmp_path):
    ds = write_set(str(tmp_path), lengths=(80, 90))
    for name, a in _odd_files(tmp_path):
        np.save(tmp_path / "pt" / f"{name}.npy", a)
    odd = C16Dataset(["s0", "three_d", "f8", "fortran"], [0, 1, 0, 1],
                     str(tmp_path))
    eng = engine(num_workers=0)
    assert eng.native_ok(odd, [0], False)
    for i in (1, 2, 3):
        assert not eng.native_ok(odd, [i], False)
        assert not eng.native_ok(odd, [0, i], False)
        x, *_ = eng._make_batch(odd, [i])
        np.testing.assert_array_equal(x.numpy(), eng._assemble_host(
            odd, [i], False)[0])
    assert eng.tier_batches == {"cache": 0, "native": 0, "python": 3}
    eng._make_batch(odd, [0])
    assert eng.tier_batches["native"] == 1
    # resampled bags, augmentation and exact mode stay in Python
    resampled = C16Dataset(["s0", "s1"], [0, 1], str(tmp_path),
                           keep_same_psize=50)
    assert not eng.native_ok(resampled, [0], False)
    kept = C16Dataset(["s0", "s1"], [0, 1], str(tmp_path), persistence=True)
    assert not eng.native_ok(kept, [0], False)
    assert not engine(patch_shuffle=True).native_ok(ds, [0], True)
    assert engine(patch_shuffle=True).native_ok(ds, [0], False)
    assert not engine(exact=True).native_ok(ds, [0], False)
    os.makedirs(tmp_path / "tcga" / "pt_files")
    np.save(tmp_path / "tcga" / "pt_files" / "p0-01Z.npy",
            np.zeros((40, 24), np.float32))
    tcga = TCGADataset(["p0"], ["LUAD"], str(tmp_path / "tcga"),
                       max_patch=20)
    assert not eng.native_ok(tcga, [0], False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_epochs_through_either_tier_agree(tmp_path, monkeypatch,
                                                 dtype):
    """attmil (input 24, dropout on) trained one epoch at batch 2 with two
    prefetch threads, then evaluated, with the device cache on: the native
    run's step losses, probabilities and weights equal the Python run's;
    the counters show which tier served each batch."""
    ds = write_set(str(tmp_path), dtype="<f2" if dtype == "float32"
                   else "<f4")
    runs = {}
    for tier in ("native", "python"):
        if tier == "python":
            monkeypatch.setattr(Engine, "native_ok", lambda *a: False)
        model = zoo.build_model("attmil", input_dim=24, device="cpu", seed=0)
        eng = engine(model, batch_size=2, num_workers=2, device_cache="on",
                     transfer_dtype=dtype)
        losses = []
        orig = eng._train_step

        def step(*a, _orig=orig, **k):
            out = _orig(*a, **k)
            losses.append(out.clone())
            return out
        eng._train_step = step
        eng.train_epoch(ds, 0, order=list(range(len(ds))))
        probs, _, loss = eng.evaluate(ds)
        runs[tier] = (torch.stack(losses), probs, loss,
                      [p.detach().clone() for p in model.parameters()],
                      dict(eng.tier_batches))
    nat, py = runs["native"], runs["python"]
    assert torch.equal(nat[0], py[0])
    np.testing.assert_array_equal(nat[1], py[1])
    assert nat[2] == py[2]
    assert all(torch.equal(a, b) for a, b in zip(nat[3], py[3]))
    n_batches = 4          # six bags, two buckets, batch 2 in bucket order
    assert nat[4] == {"cache": n_batches, "native": n_batches, "python": 0}
    assert py[4] == {"cache": n_batches, "native": 0, "python": n_batches}


def test_tier_counter_under_many_prefetch_threads(tmp_path):
    """More prefetch threads than cores, a short switch interval: every
    batch counted once, and every batch equal to the Python tier's."""
    import sys
    ds = write_set(str(tmp_path), lengths=(40, 50, 60, 70) * 6, dim=8)
    eng = engine(batch_size=1, num_workers=2 * (os.cpu_count() or 4))
    batches = eng._batched_order(ds, range(len(ds)))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = list(eng._batch_iter(ds, batches, False))
    finally:
        sys.setswitchinterval(old)
    assert eng.tier_batches == {"cache": 0, "native": len(ds), "python": 0}
    for b, (x, *_) in zip(batches, got):
        np.testing.assert_array_equal(x.numpy(),
                                      eng._assemble_host(ds, b, False)[0])


def test_racing_builds_leave_one_library(tmp_path):
    gate = threading.Barrier(2)
    out = []

    def one():
        gate.wait()
        out.append(native_loader.build(build_dir=tmp_path))
    threads = [threading.Thread(target=one) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(out) == 2 and out[0] == out[1]
    assert os.listdir(tmp_path) == [out[0].name]
    import ctypes
    lib = ctypes.CDLL(str(out[0]))
    lib.bag_num_rows.restype = ctypes.c_longlong
    np.save(tmp_path.parent / "probe.npy", np.zeros((7, 3), np.float32))
    assert lib.bag_num_rows(str(tmp_path.parent / "probe.npy").encode()) == 7


def test_failed_build_raises_with_the_compiler_output(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("int main( {\n")
    with pytest.raises(RuntimeError, match="error"):
        native_loader.build(source=src, build_dir=tmp_path / "build")
    assert os.listdir(tmp_path / "build") == []
