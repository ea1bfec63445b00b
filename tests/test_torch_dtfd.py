"""The port's DTFD against the JAX package on the CPU: the pseudo-bag
boundaries, the train and eval forwards of the three distill modes (a
bag padded to its bucket whose last pseudo-bag holds pad rows alone, the
eval path's permutation), the gradients of both tiers' losses, one
`DTFDClassificationEngine` epoch with its per-group clipping biting and its
permuted evaluation, `DTFDSurvivalEngine`'s surrogate steps and permuted
validation, the converter's round trip, and both CLIs end to end.

Weights: the port's seeded init carried to JAX by convert.py.  Dropout:
the JAX DTFD fixes its three at 0.25, so the engine tests give its module
a flax namespace whose Dropout has rate 0 (the package is not touched) and
set the port's `p` to 0.  Tolerances: forwards 1e-5 absolute, gradients
1e-4 of max(1, max|jax|), losses 1e-5, parameters after Adam within its
drift bound (2 lr a step; a weight whose gradient is rounding noise, the
attention scorers' last bias, may step the other way), probabilities and
validation losses 1e-4.
"""
import dataclasses
import math
import os

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from rrtmil_tpu.data.datasets import ArrayDataset as JArrayDataset
from rrtmil_tpu.data.survival import ArraySurvivalDataset as JArraySurv
from rrtmil_tpu.harness import dtfd_cls as jdtfd_cls
from rrtmil_tpu.harness import survival as jsurvival
from rrtmil_tpu.models import dtfd as jdtfd
from rrtmil_tpu.train.engine import EngineConfig as JEngineConfig
from rrtmil_tpu.train.engine import TrainState
from rrtmil_tpu.train.surv_engine import \
    SurvivalEngineConfig as JSurvivalEngineConfig
from rrtmil_tpu_torch import main as cli
from rrtmil_tpu_torch import survival_main as scli
from rrtmil_tpu_torch.convert import flax_to_torch, torch_to_flax
from rrtmil_tpu_torch.data.datasets import (ArrayDataset,
                                            feature_file_length,
                                            load_feature_file)
from rrtmil_tpu_torch.data.survival import (ArraySurvivalDataset,
                                            SurvivalDataset)
from rrtmil_tpu_torch.harness import classification, dtfd_cls, survival
from rrtmil_tpu_torch.models import zoo
from rrtmil_tpu_torch.models.dtfd import DTFD, pseudo_bag_slices
from rrtmil_tpu_torch.train.engine import EngineConfig
from rrtmil_tpu_torch.train.surv_engine import SurvivalEngineConfig

from test_torch_harness import _Interrupt, _args, _engine_class, _write_c16
from test_torch_survival_cli import _write_survival_csv

D_IN = 32
# the attention scorers' last bias shifts a whole softmax: its gradient is
# zero in exact arithmetic, rounding noise on both sides
NOISE_ONLY = ("attention.attention_weights.bias",)


class _NoDropoutNN:
    """flax.linen with Dropout at rate 0, for the JAX DTFD module."""

    def __getattr__(self, name):
        return getattr(fnn, name)

    @staticmethod
    def Dropout(rate, **kw):
        return fnn.Dropout(0.0, **kw)


def close(got, want, what, tol=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max() / max(1.0, float(np.abs(want).max()))
    assert err <= tol, f"{what}: scaled error {err:.3e}"


def params_after_adam(model, want, lr, steps):
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        scale = max(1.0, float(np.abs(ref).max()))
        diff = np.abs(p.detach().numpy() - ref) / scale
        assert diff.max() <= 2 * steps * lr * 1.01 / scale, name
        if not name.endswith(NOISE_ONLY):
            assert (diff > 1e-5 + 1e-4 * np.abs(ref) / scale).mean() \
                <= 1e-3, name


def bags(lengths, seed, d=D_IN):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((n, d)).astype(np.float32) for n in lengths]
    for i, b in enumerate(out):
        b[: len(b) // 8] += 0.5 * (i % 2)
    return out


def to_jax(model):
    return jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))


@pytest.mark.parametrize("group", [1, 3, 4, 8])
def test_pseudo_bag_slices_match_jax(group):
    for length in (1, 7, 8, 63, 64, 256, 577, 9216):
        got = pseudo_bag_slices(length, group)
        assert got == jdtfd.pseudo_bag_slices(length, group)
        assert got[0][0] == 0 and got[-1][1] == length


@pytest.mark.parametrize("distill", ["MaxMinS", "MaxS", "AFS"])
def test_forwards_and_gradients_match_jax(distill):
    """A 37-patch bag padded to 80 rows and read over 64 (the bucket's
    repr_length), 4 pseudo-bags of 16: the last holds pad rows alone.  The
    train path (dropout off) and the eval path with a permutation of the
    true rows within 1e-5; the gradients of loss0 (the pseudo-bags' CE
    against the label repeated) and loss1 (the bag's CE) within 1e-4; a
    bf16 bag gives float32 outputs equal to those on its values in
    float32."""
    kw = dict(input_dim=D_IN, n_classes=2, survival=False, group=4,
              distill=distill, instance_per_group=2)
    model = zoo.seeded(DTFD(**kw), "cpu", 3)
    jmodel = jdtfd.DTFD(**kw)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 80, D_IN)).astype(np.float32)
    mask = np.arange(80)[None] < 37
    x[~mask] = 0.0
    perm = np.concatenate([rng.permutation(37), np.arange(37, 64)])
    label = 1

    @jax.jit
    def jrun(p, xx, mm, pp):
        def losses(q):
            pl, bl = jmodel.apply({"params": q}, xx, mask=mm, length=64,
                                  deterministic=True, train=True)
            ce0 = -jnp.mean(jax.nn.log_softmax(pl, -1)[:, label])
            ce1 = -jax.nn.log_softmax(bl, -1)[0, label]
            return ce0, ce1, pl, bl
        g0 = jax.grad(lambda q: losses(q)[0])(p)
        g1 = jax.grad(lambda q: losses(q)[1])(p)
        ev = jmodel.apply({"params": p}, xx, mask=mm, length=64,
                          deterministic=True, train=False, eval_perm=pp)
        return losses(p), g0, g1, ev

    (jl0, jl1, jpl, jbl), jg0, jg1, jev = jrun(
        to_jax(model), jnp.asarray(x), jnp.asarray(mask), jnp.asarray(perm))
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    pl, bl = model(xt, mask=mt, length=64, train=True)
    assert pl.shape == (4, 2) and bl.shape == (1, 2)
    np.testing.assert_allclose(pl.detach().numpy(), np.asarray(jpl), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(bl.detach().numpy(), np.asarray(jbl), rtol=0,
                               atol=1e-5)
    with torch.no_grad():
        ev = model(xt, mask=mt, length=64, eval_perm=torch.from_numpy(perm))
        ident = model(xt, mask=mt, length=64)
    np.testing.assert_allclose(ev.numpy(), np.asarray(jev), rtol=0,
                               atol=1e-5)
    if distill != "AFS":
        assert not torch.allclose(ev, ident, atol=1e-6)
    else:
        # a bf16 (--amp) bag is read in float32, as flax's Dense promotes it
        with torch.no_grad():
            x16 = xt.to(torch.bfloat16)
            ev16 = model(x16, mask=mt, length=64, eval_perm=torch.from_numpy(
                perm))
            assert ev16.dtype == torch.float32 and torch.equal(
                ev16, model(x16.float(), mask=mt, length=64,
                            eval_perm=torch.from_numpy(perm)))
    lab = torch.tensor([label])
    loss0 = torch.nn.functional.cross_entropy(pl, lab.expand(4))
    loss1 = torch.nn.functional.cross_entropy(bl, lab)
    assert abs(loss0.item() - float(jl0)) <= 1e-5
    assert abs(loss1.item() - float(jl1)) <= 1e-5
    names, params = zip(*model.named_parameters())
    for loss, jg, what in ((loss0, jg0, "loss0"), (loss1, jg1, "loss1")):
        got = torch.autograd.grad(loss, params, retain_graph=True,
                                  allow_unused=True)
        want = flax_to_torch(jg)
        assert set(want) == set(names)
        for n, g in zip(names, got):
            g = torch.zeros_like(want[n]) if g is None else g
            close(g.numpy(), want[n].numpy(), f"{what} grad {n}")


def test_classification_engine_matches_jax(monkeypatch):
    """Two DTFDClassificationEngine steps (AFS, the CLI's default, 4
    pseudo-bags, dropout off, bags of 100 and 120 patches: one bucket) with grad_clipping low enough that every group is clipped, against
    the JAX engine's `_train_step`: the mean meters within 1e-5, every
    parameter within Adam's drift bound; then `evaluate` (each bag's
    permuted instances) within 1e-4."""
    monkeypatch.setattr(jdtfd, "nn", _NoDropoutNN())
    clip = 1e-3
    norms = []
    orig = dtfd_cls.clip_groups

    def spy(grads, groups, max_norm):
        for keys in groups:
            norms.append(math.sqrt(sum(
                float((g.double() ** 2).sum()) for n, g in grads.items()
                if n.split(".")[0] in keys)))
        orig(grads, groups, max_norm)
    monkeypatch.setattr(dtfd_cls, "clip_groups", spy)

    kw = dict(input_dim=D_IN, n_classes=2, survival=False, group=4,
              distill="AFS", instance_per_group=1)
    train, labels = bags((100, 120), 7), [1, 0]
    model = zoo.seeded(DTFD(**kw), "cpu", 5)
    model.p = 0.0
    params = to_jax(model)
    jeng = jdtfd_cls.DTFDClassificationEngine(
        jdtfd.DTFD(**kw), JEngineConfig(num_workers=0), grad_clipping=clip)
    state = TrainState(params=params, opt_state=jeng.tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    state, jloss = jeng.train_epoch(state, JArrayDataset(train, labels), 0,
                                    jax.random.PRNGKey(0), order=[0, 1])
    eng = dtfd_cls.DTFDClassificationEngine(
        model, EngineConfig(num_workers=0), grad_clipping=clip,
        device="cpu")
    loss = eng.train_epoch(ArrayDataset(train, labels), 0, order=[0, 1])
    assert len(norms) == 2 * 4 and min(norms) > 10 * clip, norms
    assert abs(loss - jloss) <= 1e-5 * max(1.0, abs(jloss)), (loss, jloss)
    params_after_adam(model, flax_to_torch(state.params), eng.cfg.lr, 2)

    evbags = bags((70, 150, 250), 8)
    jprobs, jlabels, jev = jeng.evaluate(state.params,
                                         JArrayDataset(evbags, [0, 1, 1]))
    probs, labs, ev = eng.evaluate(ArrayDataset(evbags, [0, 1, 1]))
    np.testing.assert_allclose(probs, jprobs, rtol=0, atol=1e-4)
    assert np.array_equal(labs, jlabels) and abs(ev - jev) <= 1e-4


def test_engine_refuses_more_than_one_bag_a_step():
    model = zoo.seeded(DTFD(input_dim=D_IN, survival=False), "cpu")
    with pytest.raises(ValueError, match="one bag a step"):
        dtfd_cls.DTFDClassificationEngine(
            model, EngineConfig(accumulation_steps=2), device="cpu")


def test_survival_engine_matches_jax(monkeypatch):
    """DTFDSurvivalEngine: one epoch (two surrogate steps on bags of 70 and
    150 patches at repr_length 256, dropout off) against the JAX engine's,
    the epoch loss within 1e-5 and every parameter within Adam's drift
    bound; `validate` (a permutation of each bag's true rows from seed +
    0xD7FD) loss within 1e-4 and the same c-index, and the same numbers
    again with the device bag cache on, from a first and a cached read."""
    monkeypatch.setattr(jdtfd, "nn", _NoDropoutNN())
    tr = bags((70, 150), 4)
    va = bags((90, 200, 120), 5)
    events, status = [300.0, 900.0], [1, 1]
    vevents, vstatus = [100.0, 700.0, 400.0], [1, 0, 1]
    model, enc = survival.build_survival_model("DTFD", D_IN, device="cpu",
                                               seed=6)
    model.p = 0.0
    params = to_jax(model)
    jmodel, jenc = jsurvival.build_survival_model("DTFD", D_IN)
    jeng = jsurvival.make_survival_engine(
        "DTFD", jmodel, JSurvivalEngineConfig(num_epochs=1), jenc)
    state = TrainState(params=params, opt_state=jeng.tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    state, jloss, _ = jeng.train_epoch(state, JArraySurv(tr, events, status),
                                       [0, 1], 0, jax.random.PRNGKey(1))
    eng = survival.make_survival_engine(
        "DTFD", model, SurvivalEngineConfig(num_epochs=1), enc, device="cpu")
    assert isinstance(eng, survival.DTFDSurvivalEngine)
    loss, _ = eng.train_epoch(ArraySurvivalDataset(tr, events, status),
                              [0, 1], 0)
    assert abs(loss - jloss) <= 1e-5 * max(1.0, abs(jloss)), (loss, jloss)
    params_after_adam(model, flax_to_torch(state.params), eng.cfg.lr, 2)
    jv = jeng.validate(state.params, JArraySurv(va, vevents, vstatus),
                       [0, 1, 2])
    vds = ArraySurvivalDataset(va, vevents, vstatus)
    v = eng.validate(vds, [0, 1, 2])
    assert abs(v[0] - jv[0]) <= 1e-4 and v[1] == jv[1], (v, jv)
    eng.cfg = dataclasses.replace(eng.cfg, device_cache="on")
    assert eng.validate(vds, [0, 1, 2]) == v == eng.validate(vds, [0, 1, 2])
    assert eng._dcache.hits == 3 and eng._dcache.misses == 3


def test_bag_lengths_come_from_the_file_headers(tmp_path):
    """The true lengths DTFD's evaluations permute: a survival case's
    length sums its files' .npy headers (case 2 is two files) and equals
    the bag it reads; a (1, N, D) file counts N."""
    ds = SurvivalDataset(_write_survival_csv(str(tmp_path / "s"), 4))
    assert [ds.length(i) for i in range(4)] == \
        [ds[i][1].shape[0] for i in range(4)]
    assert ";" in ds.wsi_paths[2]
    path = str(tmp_path / "one.npy")
    np.save(path, np.zeros((1, 33, 8), np.float32))
    assert feature_file_length(path) == load_feature_file(path).shape[0] == 33


@pytest.mark.parametrize("survival_mode", [False, True])
def test_converter_round_trip(survival_mode):
    kw = dict(input_dim=D_IN, n_classes=4 if survival_mode else 2,
              survival=survival_mode, group=8 if survival_mode else 4)
    params = jax.jit(lambda k: jdtfd.DTFD(**kw).init(
        {"params": k, "dropout": k}, jnp.zeros((1, 64, D_IN)), length=64,
        train=True))(jax.random.PRNGKey(0))["params"]
    sd = flax_to_torch(params)
    model = DTFD(**kw)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    assert model.classifier_kernel.shape == (512, kw["n_classes"])
    back = torch_to_flax(sd)
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        assert np.array_equal(node, np.asarray(leaf)), path


def test_both_clis_train_save_resume_and_evaluate(tmp_path):
    """`python -m rrtmil_tpu_torch.main --model dtfd` (fold 1 of 2, one
    epoch, rolling and best checkpoints written) and `survival_main
    --model DTFD` (5 folds x 1 epoch), then `--evaluate --resume` over the
    latter's directory: every fold that saved weights gives its best
    c-index again."""
    _write_c16(str(tmp_path / "c16"), n=8, dim=D_IN)
    out = tmp_path / "m"
    metrics = cli.main(["--model", "dtfd", "--dataset_root",
                        str(tmp_path / "c16"), "--model_path", str(out),
                        "--input_dim", str(D_IN), "--cv_fold", "2",
                        "--fold_start", "1", "--num_epoch", "1",
                        "--distill_type", "MaxMinS", "--device", "cpu"])
    assert all(len(metrics[k]) == 1 and np.isfinite(metrics[k]).all()
               for k in ("acs", "auc", "pre", "rec", "fs"))
    saved = {p.name for p in (out / "mil_new_c16" / "default").iterdir()}
    assert {"ckp.pt", "ckp_host.pkl"} <= saved

    csv_file = _write_survival_csv(str(tmp_path / "surv"), dim=D_IN)
    res = str(tmp_path / "s")
    common = ["--excel_file", csv_file, "--model", "DTFD", "--input_dim",
              str(D_IN), "--device", "cpu"]
    meter = scli.main(common + ["--num_epoch", "1", "--results_dir", res])
    best = meter.cindex[1:6]
    assert all(np.isfinite(best))
    again = scli.main(common + ["--evaluate", "--resume", res,
                                "--results_dir", str(tmp_path / "e")])
    kept = [k for k in range(5) if os.listdir(os.path.join(res,
                                                           f"fold_{k}"))]
    assert kept and all(again.cindex[1 + k] == best[k] for k in kept)


def test_classification_resume_continues_like_an_uninterrupted_run(
        tmp_path, monkeypatch):
    """`--model dtfd` cut in fold 0 before its epoch 1 and restarted with
    --auto_resume (dropout on, --patch_shuffle) equals an uninterrupted
    run handed the train order the resumed epoch draws (the JAX package's
    order stream restarts after a resume): the same metrics, best-AUC and
    final weights and final stream states, fold 1 included."""
    _write_c16(str(tmp_path / "data"), n=8, dim=D_IN)
    over = dict(model="dtfd", num_epoch=2, device="cpu")
    interrupted, resumed, reference = {}, {}, {}
    name = "DTFDClassificationEngine"
    base = dtfd_cls.DTFDClassificationEngine
    monkeypatch.setattr(classification, name, _engine_class(
        interrupted, stop_at=(0, 1), base=base))
    with pytest.raises(_Interrupt):
        classification.run_cv(_args(cli, tmp_path, "resume", **over))
    monkeypatch.setattr(classification, name, _engine_class(resumed,
                                                            base=base))
    res_args = _args(cli, tmp_path, "resume", auto_resume=True, **over)
    m_res = classification.run_cv(res_args)
    first = interrupted[("order", 0, 0)]
    assert resumed[("order", 0, 1)] == first
    monkeypatch.setattr(classification, name, _engine_class(
        reference, order_at=((0, 1), first), base=base))
    ref_args = _args(cli, tmp_path, "reference", **over)
    assert classification.run_cv(ref_args) == m_res
    for fold in range(2):
        assert resumed[("rng", fold)] == reference[("rng", fold)]
        assert torch.equal(resumed[("torch_rng", fold)],
                           reference[("torch_rng", fold)])
        got, want = resumed[("final", fold)], reference[("final", fold)]
        assert all(torch.equal(got[k], want[k]) for k in want)
