"""The port's infrastructure against the JAX package: region geometry,
bucketing, partition/reverse, the weight converter, datasets, metrics, MAC
counts, and the rule that the port never loads JAX."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rrtmil_tpu.config import RegionConfig as JRegionConfig
from rrtmil_tpu.config import RRTEncoderConfig as JEncoderConfig
from rrtmil_tpu.config import c16_r50 as jax_c16_r50
from rrtmil_tpu.data import bucketing as jbucketing
from rrtmil_tpu.data import datasets as jdatasets
from rrtmil_tpu.models.rrt import RRTMIL as JRRTMIL
from rrtmil_tpu.ops import regions as jregions
from rrtmil_tpu.train import metrics as jmetrics
from rrtmil_tpu.utils import flops as jflops
from rrtmil_tpu_torch import config as tconfig
from rrtmil_tpu_torch.convert import flax_to_torch, torch_to_flax
from rrtmil_tpu_torch.data import bucketing, datasets
from rrtmil_tpu_torch.models.rrt import RRTMIL, build_model
from rrtmil_tpu_torch.ops import regions
from rrtmil_tpu_torch.train import metrics
from rrtmil_tpu_torch.train.engine import Engine, EngineConfig
from rrtmil_tpu_torch.utils import flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REGION_CASES = [dict(region_num=8), dict(region_num=16),
                dict(region_num=8, min_region_num=500, min_region_ratio=0.3),
                dict(region_size=12)]


@pytest.mark.parametrize("kw", REGION_CASES)
def test_geometry_matches_jax_for_every_length(kw):
    tc, jc = tconfig.RegionConfig(**kw), JRegionConfig(**kw)
    for length in range(1, 60001):
        assert (dataclasses.astuple(regions.grid_geometry(length, tc))
                == dataclasses.astuple(jregions.grid_geometry(length, jc))), \
            length


@pytest.mark.parametrize("region_num", [8, 16])
def test_bucket_for_matches_jax_for_every_length(region_num):
    tc = tconfig.RRTEncoderConfig(region_num=region_num)
    jc = JEncoderConfig(region_num=region_num)
    for length in range(1, 60001):
        assert (dataclasses.astuple(bucketing.bucket_for(length, tc))
                == dataclasses.astuple(jbucketing.bucket_for(length, jc))), \
            length


def test_pad_bag_and_group_by_bucket_match_jax():
    rng = np.random.default_rng(0)
    lengths = rng.integers(1, 3000, 40)
    tc, jc = tconfig.c16_r50().encoder, jax_c16_r50().encoder
    got = {dataclasses.astuple(k): v
           for k, v in bucketing.group_by_bucket(lengths, tc).items()}
    want = {dataclasses.astuple(k): v
            for k, v in jbucketing.group_by_bucket(lengths, jc).items()}
    assert got == want
    bag = rng.standard_normal((37, 5)).astype(np.float32)
    for a, b in zip(bucketing.pad_bag(bag, 64), jbucketing.pad_bag(bag, 64)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        bucketing.pad_bag(bag, 36)


@pytest.mark.parametrize("b,g,rs", [(2, 16, 4), (1, 96, 12), (3, 8, 1)])
def test_partition_reverse_round_trip_and_match_jax(b, g, rs):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, g, g, 6)).astype(np.float32)
    got = regions.region_partition(torch.from_numpy(x), rs)
    want = jregions.region_partition(jnp.asarray(x), rs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = regions.region_reverse(got, rs, g, g)
    np.testing.assert_array_equal(back.numpy(), x.reshape(b, g * g, 6))
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jregions.region_reverse(want, rs, g, g)))


def test_pad_to_grid_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 50, 3)).astype(np.float32)
    geom = regions.grid_geometry(50, tconfig.RegionConfig())
    jgeom = jregions.grid_geometry(50, JRegionConfig())
    np.testing.assert_array_equal(
        regions.pad_to_grid(torch.from_numpy(x), geom).numpy(),
        np.asarray(jregions.pad_to_grid(jnp.asarray(x), jgeom)))


def test_config_tree_matches_jax():
    from rrtmil_tpu import config as jconfig
    assert set(tconfig.CANONICAL_CONFIGS) == set(jconfig.CANONICAL_CONFIGS)
    for name, fn in tconfig.CANONICAL_CONFIGS.items():
        assert (dataclasses.asdict(fn())
                == dataclasses.asdict(jconfig.CANONICAL_CONFIGS[name]()))


@pytest.fixture(scope="module")
def c16_params():
    """A c16_r50 flax param tree as `model.init` gives it."""
    model = JRRTMIL(jax_c16_r50())
    x = jnp.zeros((1, 64, 1024), jnp.float32)
    return jax.jit(lambda k: model.init({"params": k}, x, length=64))(
        jax.random.PRNGKey(0))["params"]


def test_convert_round_trips_c16_r50_exactly(c16_params):
    sd = flax_to_torch(c16_params)
    model = RRTMIL(tconfig.c16_r50())
    model.load_state_dict(sd, strict=True)
    assert sd["online_encoder.layer0.attn.attn.pe_weight"].shape == (8, 15)
    assert sd["online_encoder.layer0.attn.attn.qkv.weight"].shape == (1536, 512)
    assert sd["online_encoder.cr_msa.attn.phi"].shape == (512, 1)
    back = torch_to_flax(model.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(c16_params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), flat_b[path],
                                      err_msg=str(path))


def test_fresh_init_distributions_match_jax(c16_params):
    """Seeded init draws from the JAX package's distributions: truncated
    xavier_normal std per kernel, zero biases, U(+-1/sqrt(k)) phi."""
    model = build_model(tconfig.c16_r50(), device="cpu", seed=3)
    ours = torch_to_flax(model.state_dict())
    flat_j = jax.tree_util.tree_flatten_with_path(c16_params)[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
    for path, leaf in flat_j:
        a, b = np.asarray(leaf), flat_t[path]
        assert a.shape == b.shape, path
        if np.all(a == a.flat[0]):                    # zeros / ones
            np.testing.assert_array_equal(a, b, err_msg=str(path))
        elif a.size >= 4096:
            assert abs(a.std() - b.std()) < 0.05 * a.std(), path
            assert np.abs(b).max() <= 2.0 * a.std() / 0.879 * 1.01, path


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfig.c16_r50()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(model, EngineConfig())
    assert Engine(model, EngineConfig(), device="cpu").device.type == "cpu"


def test_datasets_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    (tmp_path / "pt").mkdir()
    names = []
    for i, n in enumerate((5, 9, 3)):
        np.save(tmp_path / "pt" / f"s{i}.npy",
                rng.standard_normal((n, 4)).astype(np.float32))
        names.append(f"s{i}")
    with open(tmp_path / "label.csv", "w") as f:
        f.write("s0,0\ns1,1\n\ns2,1\n")
    p_t, l_t = datasets.read_label_csv(str(tmp_path / "label.csv"))
    p_j, l_j = jdatasets.read_label_csv(str(tmp_path / "label.csv"))
    assert list(p_t) == list(p_j) and list(l_t) == list(l_j)
    for kw in ({}, {"keep_same_psize": 4}):
        dt = datasets.C16Dataset(p_t, l_t, str(tmp_path), **kw)
        dj = jdatasets.C16Dataset(p_j, l_j, str(tmp_path), **kw)
        assert dt.lengths() == dj.lengths()
        for i in range(len(dt)):
            np.testing.assert_array_equal(dt[i][0], dj[i][0])
            assert dt[i][1] == dj[i][1]
    bags = [rng.standard_normal((n, 4)) for n in (7, 2)]
    at, aj = datasets.ArrayDataset(bags, [1, 0]), jdatasets.ArrayDataset(
        bags, [1, 0])
    assert at.lengths() == aj.lengths() == [7, 2]
    np.testing.assert_array_equal(at[0][0], aj[0][0])


def test_metrics_and_flops_match_jax():
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 2, 50)
    scores = rng.uniform(size=50)
    assert metrics.five_scores(labels, scores) == \
        jmetrics.five_scores(labels, scores)
    for length in (37, 937, 9000, 30000):
        assert flops.rrtmil_flops(length, tconfig.c16_r50()) == \
            jflops.rrtmil_flops(length, jax_c16_r50())


def test_port_imports_no_jax():
    """Importing every module of the port, and chip_smoke.py, loads neither
    jax nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import rrtmil_tpu_torch\n"
        "for m in pkgutil.walk_packages(rrtmil_tpu_torch.__path__,"
        " 'rrtmil_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'rrtmil_tpu' or k.startswith('rrtmil_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
