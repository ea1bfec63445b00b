"""The port's sequence-sharded survival engine and CLI route against the
JAX package's on the CPU.

The port runs as 2 gloo ranks on the CPU (one launch for the module:
tests/_torch_seqshard_ranks.py); the JAX package's SeqShardSurvivalEngine
runs `shard_map` on 2 of the conftest's virtual CPU devices.  The case is
tests/test_seqshard.py's (268-338): survival RRTMIL at input 24, region_num
16, EPEG k 9, CR-MSA k 3, dropout off, bags of 230-1010 patches whose
sharded buckets have grids 16 and 32 (the same as their unsharded ones),
one epoch on five bags and validate on three, from the JAX package's init;
the port with float32 products.

Tolerances as there (JAX's sharded engine against its unsharded one):
against the port's unsharded SurvivalEngine from the same weights, losses
rtol 2e-5 and c-indices 1e-6.  Against the JAX package's sharded engine
the c-indices 1e-6, the gradients of one bag through the engine's slab
atol 5e-5 (at the JAX engine's trained weights) and their loss rtol 2e-5,
and the epoch's losses within 1e-4 of max(1, |loss|), the port's engine
tolerance against JAX (tests/test_torch_survival.py): after five Adam steps
the unsharded port is 2.2e-5 (relative) from JAX's unsharded and sharded
engines too, Adam's sign-sized steps on rounding-noise gradients.  The CLI
route: `run_survival_cv` with `sp_shards=2` on each rank, on
tests/test_seqshard.py's 10-case set (340-376): 5 finite folds and one
results CSV.
"""
import csv
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rrtmil_tpu.config import RRTEncoderConfig as JEncoderConfig
from rrtmil_tpu.config import RRTMILConfig as JRRTMILConfig
from rrtmil_tpu.data.survival import ArraySurvivalDataset as JArrayDataset
from rrtmil_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rrtmil_tpu.train.surv_engine import SeqShardSurvivalEngine as JEngine
from rrtmil_tpu.train.surv_engine import \
    SurvivalEngineConfig as JEngineConfig
from rrtmil_tpu_torch.config import RRTEncoderConfig, RRTMILConfig
from rrtmil_tpu_torch.convert import flax_to_torch
from rrtmil_tpu_torch.data.survival import ArraySurvivalDataset
from rrtmil_tpu_torch.models.rrt import RRTMIL
from rrtmil_tpu_torch.models.survival import SurvivalHead
from rrtmil_tpu_torch.parallel.mesh import launch
from rrtmil_tpu_torch.train.surv_engine import (SurvivalEngine,
                                                SurvivalEngineConfig)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_seqshard_ranks as ranks  # noqa: E402

SP = 2
D_IN = 24
# tests/test_seqshard.py's bag lengths without its grid-48 pair (one
# compile of each JAX step a bucket is most of this module's time)
LENGTHS = (230, 250, 950, 1000, 240, 980, 245, 1010)


def _jcfg():
    return JRRTMILConfig(input_dim=D_IN, n_classes=4, dropout=0.0,
                         encoder=JEncoderConfig(region_num=16, epeg_k=9,
                                                crmsa_k=3, dropout=0.0))


def _tcfg():
    return RRTMILConfig(input_dim=D_IN, n_classes=4, dropout=0.0,
                        encoder=RRTEncoderConfig(region_num=16, epeg_k=9,
                                                 crmsa_k=3, dropout=0.0,
                                                 mm_dtype="float32"))


def _data(seed=0):
    rng = np.random.default_rng(seed)
    bags = [rng.normal(size=(n, D_IN)).astype(np.float32) for n in LENGTHS]
    return bags, rng.uniform(10, 1000, len(bags)), \
        rng.integers(0, 2, len(bags))


def _write_cli_set(root):
    """tests/test_seqshard.py's 10 synthetic cases (input 16) on disk."""
    rng = np.random.default_rng(5)
    (root / "plip").mkdir()
    rows = []
    for i in range(10):
        n = int(rng.integers(200, 256))
        np.save(root / "plip" / f"case_{i}.npy",
                rng.normal(size=(n, 16)).astype(np.float32))
        rows.append({"Study": "syn", "ID": f"case_{i}",
                     "Event": float(rng.uniform(10, 1000)),
                     "Status": int(rng.integers(0, 2)),
                     "WSI": f"plip/case_{i}.npy"})
    with open(root / "syn.csv", "w", newline="") as fp:
        w = csv.DictWriter(fp, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return SimpleNamespace(
        excel_file=str(root / "syn.csv"), folder="plip",
        dataset_root=str(root), seed=1, model="RRTMIL", optimizer="Adam",
        scheduler="cosine", num_epoch=1, lr=2e-4, weight_decay=1e-5,
        loss="nll_surv", input_dim=16, epeg_k=9, crmsa_k=3, no_log=True,
        results_dir=str(root / "results"), sp_shards=SP, resume="",
        evaluate=False, device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seqshard_engine")
    data = _data()
    idx = list(range(len(LENGTHS)))
    train_idx, val_idx = idx[:5], idx[5:]
    kw = dict(num_epochs=1, seed=3)
    mesh = jax_make_mesh(dp=1, sp=SP, devices=jax.devices()[:SP])
    jeng = JEngine(_jcfg(), JEngineConfig(**kw), mesh)
    state = jeng.init(jax.random.PRNGKey(3), 1000, D_IN)
    init = flax_to_torch(state.params)
    jds = JArrayDataset(*data)
    state, jtl, jtc = jeng.train_epoch(state, jds, train_idx, 0,
                                       jax.random.PRNGKey(11))
    jvl, jvc = jeng.validate(state.params, jds, val_idx)

    _, bag, _, cen, label = jds[0]
    x, mask, spec = jeng._prep(np.asarray(bag))
    lbl = jnp.asarray([label], jnp.int32)
    cns = jnp.asarray([cen], jnp.float32)

    def loss(p):
        h, s = jeng._shard_apply(p, x, mask, spec.repr_length, True,
                                 jax.random.PRNGKey(0))
        return jeng._loss(h, s, lbl, cns)

    gl, grads = jax.jit(jax.value_and_grad(loss))(state.params)

    args = _write_cli_set(tmp)
    cases = {
        "engine": {"kind": "engine", "sp": SP, "cfg": _tcfg(),
                   "ecfg": SurvivalEngineConfig(**kw), "params": init,
                   "data": data, "train_idx": train_idx,
                   "val_idx": val_idx, "grad_bag": 0,
                   "grad_params": flax_to_torch(state.params)},
        "survival_cv": {"kind": "survival_cv", "args": args}}
    in_path, out_path = str(tmp / "cases.pt"), str(tmp / "results.pt")
    torch.save(cases, in_path)
    launch(ranks.run, SP, device="cpu", args=(in_path, out_path),
           threads=2)
    port = torch.load(out_path, weights_only=False)
    model = SurvivalHead(RRTMIL(_tcfg()))
    model.load_state_dict(init)
    single = SurvivalEngine(model, SurvivalEngineConfig(**kw),
                            _tcfg().encoder, device="cpu")
    ds = ArraySurvivalDataset(*data)
    ref = {"train": (jtl, jtc), "val": (jvl, jvc), "grad_loss": float(gl),
           "grads": flax_to_torch(grads),
           "single_train": single.train_epoch(ds, train_idx, 0),
           "single_val": single.validate(ds, val_idx)}
    return ref, port, args


def test_seqshard_engine_epoch_and_validate_match_jax(runs):
    ref, port, _ = runs
    for phase in ("train", "val"):
        (loss, ci), (jloss, jci) = port["engine"][phase], ref[phase]
        assert abs(loss - jloss) <= 1e-4 * max(1.0, abs(jloss)), \
            (phase, loss, jloss)
        assert ci == pytest.approx(jci, abs=1e-6), phase


def test_seqshard_engine_matches_the_unsharded_engine(runs):
    ref, port, _ = runs
    for phase in ("train", "val"):
        (loss, ci), (sloss, sci) = port["engine"][phase], \
            ref[f"single_{phase}"]
        np.testing.assert_allclose(loss, sloss, rtol=2e-5, err_msg=phase)
        assert ci == pytest.approx(sci, abs=1e-6), phase


def test_seqshard_engine_gradients_match_jax(runs):
    ref, port, _ = runs
    got = port["engine"]
    np.testing.assert_allclose(got["grad_loss"], ref["grad_loss"],
                               rtol=2e-5)
    assert set(got["grads"]) == set(ref["grads"])
    for name, want in ref["grads"].items():
        np.testing.assert_allclose(got["grads"][name], want.numpy(),
                                   atol=5e-5, err_msg=name)


def test_run_survival_cv_with_sp_shards(runs):
    """5 finite folds, the mean and std, and one results CSV (rank 0's)."""
    _, port, args = runs
    cindex = port["survival_cv"]["cindex"]
    assert len(cindex) == 8 and cindex[0] == "cindex"
    assert np.isfinite(np.asarray(cindex[1:], float)).all()
    out = os.listdir(args.results_dir)
    assert [f for f in out if f.endswith(".csv")] == ["results_RRTMIL.csv"]
    assert sorted(f for f in out if f.startswith("fold_")) == \
        [f"fold_{k}" for k in range(5)]
