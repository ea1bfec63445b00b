"""The port reads the JAX package's `.msgpack` weights, on the CPU.

`train/flax_msgpack.py` decodes what flax's `to_bytes` writes without flax
or msgpack; `train/checkpoint.load_params` on a `.msgpack` file returns
`convert.flax_to_torch` of the tree, bit for bit: for c16_r50's RRTMIL and
a zoo model saved by the JAX package's `save_params`, in float32 and
bfloat16, and with flax's chunked arrays (its chunk size patched down so
that small arrays are chunked).  Every msgpack type flax can write decodes
to what flax's own reader gives.  The survival CLI's `--evaluate --resume`
over a JAX results directory (`fold_{k}/model_best_*.msgpack`) gives the
JAX package's c-indices, and `resume_path` takes a fold's last `.pt`
before its last `.msgpack`.  The committed fixture under
tests/fixtures/jax_weights/ is what tests/fixtures/make_jax_weights.py
writes, and the port reproduces the JAX outputs stored with it.
"""
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

import survival_main as jcli
from rrtmil_tpu.config import c16_r50 as jax_c16_r50
from rrtmil_tpu.harness import survival as jsurvival
from rrtmil_tpu.models import zoo as jzoo
from rrtmil_tpu.models.rrt import RRTMIL as JRRTMIL
from rrtmil_tpu.train.checkpoint import save_params as jax_save_params
from rrtmil_tpu.train.surv_engine import \
    SurvivalEngineConfig as JSurvivalEngineConfig
from rrtmil_tpu_torch import survival_main as cli
from rrtmil_tpu_torch.config import c16_r50
from rrtmil_tpu_torch.convert import flax_to_torch
from rrtmil_tpu_torch.harness import survival
from rrtmil_tpu_torch.models import zoo
from rrtmil_tpu_torch.models.rrt import RRTMIL
from rrtmil_tpu_torch.models.survival import SurvivalHead
from rrtmil_tpu_torch.models.mean_max import MeanMIL
from rrtmil_tpu_torch.train import flax_msgpack
from rrtmil_tpu_torch.train.checkpoint import load_params

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


def assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k, t in want.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
        assert torch.equal(got[k].view(torch.int16) if t.dtype ==
                           torch.bfloat16 else got[k],
                           t.view(torch.int16) if t.dtype == torch.bfloat16
                           else t), k


@functools.lru_cache(maxsize=None)
def _c16_tree():
    x = jnp.zeros((1, 64, 1024))
    return jax.jit(lambda: JRRTMIL(jax_c16_r50()).init(
        jax.random.PRNGKey(0), x, mask=jnp.ones((1, 64), bool),
        length=64))()["params"]


@functools.lru_cache(maxsize=None)
def _clam_tree():
    x = jnp.zeros((1, 64, 24))
    return jax.jit(lambda: jzoo.build_model("clam_mb", input_dim=24).init(
        jax.random.PRNGKey(1), x, mask=jnp.ones((1, 64), bool), length=64,
        labels=jnp.zeros((1,), jnp.int32)))()["params"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_save_params_reads_back_as_flax_to_torch(tmp_path, dtype):
    """c16_r50's RRTMIL (input 1024) and CLAM_MB: every tensor equal,
    bfloat16 too; the float32 RRTMIL loads into the port's module."""
    for name, tree in (("rrtmil", _c16_tree()), ("clam_mb", _clam_tree())):
        if dtype == "bfloat16":
            tree = jax.tree.map(lambda a: a.astype(jnp.bfloat16), tree)
        path = str(tmp_path / f"{name}.msgpack")
        jax_save_params(path, tree)
        got = load_params(path)
        assert_same(got, flax_to_torch(jax.tree.map(np.asarray, tree)))
        assert all(t.dtype == getattr(torch, dtype) for t in got.values())
        if name == "rrtmil" and dtype == "float32":
            RRTMIL(c16_r50()).load_state_dict(got)
        if name == "clam_mb" and dtype == "float32":
            zoo.build_model("clam_mb", input_dim=24, device="cpu") \
                .load_state_dict(got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_arrays(tmp_path, monkeypatch, dtype):
    """flax splits an array over MAX_CHUNK_SIZE bytes into a map of flat
    chunks; patched to 4 KiB, c16_r50's larger weights are chunked."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 4096)
    tree = jax.tree.map(lambda a: a.astype(dtype), _c16_tree())
    path = str(tmp_path / "chunked.msgpack")
    jax_save_params(path, tree)
    raw = open(path, "rb").read()
    assert flax_msgpack.CHUNKED.encode() in raw
    assert_same(load_params(path),
                flax_to_torch(jax.tree.map(np.asarray, tree)))


def _same_value(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            _same_value(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same_value(a, b)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and (got == want or (
            got != got and want != want)), (got, want)


def test_every_msgpack_type_flax_writes():
    """Integers of every width, floats, strings and binaries of every
    length class, nil, booleans, nested arrays and maps of 16 and 70000
    entries, numpy scalars, complex and arrays of several dtypes: decoded as
    flax's `msgpack_restore` decodes them."""
    tree = {
        "ints": [0, 5, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63,
                 -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1,
                 -2 ** 63],
        "floats": [0.5, -1e300, float("inf")],
        "strings": ["", "a" * 31, "b" * 32, "c" * 256, "d" * 65536, "é"],
        "bytes": [b"", b"x" * 300, b"y" * 70000],
        "misc": [None, True, False, 1.5 + 2j],
        "list16": list(range(16)),
        "big": {str(i): i for i in range(70000)},
        "map16": {f"k{i}": i for i in range(16)},
        "scalars": [np.float32(1.25), np.int64(-7), np.float16(3.0)],
        "arrays": {"f4": np.arange(12, dtype=np.float32).reshape(3, 4),
                   "i8": np.arange(-3, 3, dtype=np.int64),
                   "u1": np.arange(5, dtype=np.uint8),
                   "b": np.array([True, False]),
                   "f2": np.ones((2, 2), np.float16),
                   "empty": np.zeros((0, 3), np.float32),
                   "scalar": np.array(2.5, np.float64)},
    }
    raw = serialization.msgpack_serialize(tree)
    _same_value(flax_msgpack.decode(raw), serialization.msgpack_restore(raw))
    with pytest.raises(ValueError, match="after the value"):
        flax_msgpack.decode(raw + b"\x00")


# -- the survival CLI over a JAX results directory ---------------------------

D_IN = 32


def _write_cases(root, n=10, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    rows = ["Study,ID,Event,Status,WSI"]
    for i in range(n):
        risk = rng.uniform()
        bag = rng.standard_normal((int(rng.integers(40, 120)), D_IN))
        bag[: len(bag) // 8] += 2.0 * risk
        p = os.path.join(root, f"case_{i}.npy")
        np.save(p, bag.astype(np.float32))
        rows.append(f"syn,case_{i},{2000 * (1.05 - risk):.1f},"
                    f"{int(i % 4 != 3)},{p}")
    with open(os.path.join(root, "syn.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    return os.path.join(root, "syn.csv")


def _args(parser_mod, csv_file, out, **kw):
    args = parser_mod.parse_args(["--excel_file", csv_file, "--results_dir",
                                  out, "--input_dim", str(D_IN),
                                  "--model", "MeanMIL", "--evaluate",
                                  "--no_log"])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def test_evaluate_resume_over_a_jax_results_directory(tmp_path):
    """Each fold's weights as the JAX harness saves them (a MeanMIL
    SurvivalHead from its engine's init, one seed a fold); the JAX CLI and
    the port's each evaluate them: the same c-index a fold."""
    csv_file = _write_cases(str(tmp_path / "data"))
    res = tmp_path / "jax_results"
    for fold in range(5):
        model, enc = jsurvival.build_survival_model("MeanMIL", D_IN)
        engine = jsurvival.make_survival_engine(
            "MeanMIL", model, JSurvivalEngineConfig(), enc)
        state = engine.init(jax.random.PRNGKey(100 + fold), 64, D_IN)
        os.makedirs(res / f"fold_{fold}")
        jax_save_params(str(res / f"fold_{fold}" /
                            f"model_best_0.{fold}000_{fold}.msgpack"),
                        state.params)
    want = jsurvival.run_survival_cv(_args(jcli, csv_file,
                                           str(tmp_path / "jev"),
                                           resume=str(res)))
    got = survival.run_survival_cv(_args(cli, csv_file, str(tmp_path / "ev"),
                                         resume=str(res), device="cpu"))
    assert len(set(want.cindex[1:6])) > 1
    assert got.cindex == want.cindex


def test_resume_path_takes_pt_before_msgpack(tmp_path):
    fold = tmp_path / "fold_0"
    os.makedirs(fold)
    assert survival.resume_path(str(tmp_path), 0) == ""
    for name in ("model_best_0.1000_1.msgpack", "model_best_0.9000_0.msgpack"):
        (fold / name).write_bytes(b"")
    assert survival.resume_path(str(tmp_path), 0).endswith(
        "model_best_0.9000_0.msgpack")
    (fold / "model_best_0.2000_3.pt").write_bytes(b"")
    assert survival.resume_path(str(tmp_path), 0).endswith(
        "model_best_0.2000_3.pt")
    assert survival.resume_path(str(fold / "x.msgpack"), 0) == \
        str(fold / "x.msgpack")


# -- the committed fixture ---------------------------------------------------

def test_committed_fixture_is_what_its_script_writes(tmp_path):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_jax_weights", os.path.join(FIXTURES, "make_jax_weights.py"))
    maker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maker)
    maker.write(str(tmp_path))
    here = os.path.join(FIXTURES, "jax_weights")
    for name in ("attmil.msgpack", "survival_meanmil.msgpack"):
        assert open(tmp_path / name, "rb").read() == \
            open(os.path.join(here, name), "rb").read(), name
    with np.load(tmp_path / "outputs.npz") as a, \
            np.load(os.path.join(here, "outputs.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6)


def test_port_reproduces_the_fixture_outputs():
    """attmil and the survival MeanMIL from the fixture's `.msgpack` files:
    their outputs on the stored bags within 1e-5 of the JAX package's."""
    here = os.path.join(FIXTURES, "jax_weights")
    attmil = zoo.build_model("attmil", input_dim=64, device="cpu")
    attmil.load_state_dict(load_params(os.path.join(here, "attmil.msgpack")))
    surv = SurvivalHead(MeanMIL(64, 4)).eval()
    surv.load_state_dict(load_params(os.path.join(here,
                                                  "survival_meanmil.msgpack")))
    with np.load(os.path.join(here, "outputs.npz")) as f:
        for i in range(3):
            n = f[f"x_{i}"].shape[0]
            x = torch.zeros((1, int(f[f"rows_{i}"]), 64))
            x[0, :n] = torch.from_numpy(f[f"x_{i}"])
            mask = torch.arange(x.shape[1])[None] < n
            with torch.no_grad():
                logits = attmil(x, mask=mask, length=n)
                hazards, s = surv(x, mask=mask, length=n)
            for got, key in ((logits, "logits"), (hazards, "hazards"),
                             (s, "survival")):
                np.testing.assert_allclose(got.numpy(), f[f"{key}_{i}"],
                                           rtol=0, atol=1e-5)
