"""The port's MHIM-MIL against the JAX package on the CPU: the cosine
schedules and the soft-target CE, the keep-mask (fed the uniform draws
JAX's `jax.random` gives for the same key, so both sides must return the
same boolean mask), the 'attn' network's forward and gradients under a
keep-mask, the 'selfattn' baseline at a square and a non-square token
count, one `MHIMSurvivalEngine` epoch (the student after Adam, the EMA
teacher, validation), the teacher on `--resume`, the converter's round
trip and the survival CLI end to end.

Weights: the port's seeded init carried to JAX by convert.py; dropout 0
on both sides.  Tolerances: schedules and the CE 1e-6, forwards 1e-5
('selfattn' 1e-4: two Nystrom layers), gradients 1e-4 of max(1,
max|jax|), the epoch loss 1e-5, the student within Adam's drift bound (2
lr a step) with at most 1e-3 of each tensor past 1e-5, the teacher within
1e-6 (it moves 1 - mm of the way).
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rrtmil_tpu.data.survival import ArraySurvivalDataset as JArraySurv
from rrtmil_tpu.harness import survival as jsurvival
from rrtmil_tpu.models import mhim as jmhim
from rrtmil_tpu.train.engine import TrainState
from rrtmil_tpu.train.surv_engine import \
    SurvivalEngineConfig as JSurvivalEngineConfig
from rrtmil_tpu_torch import survival_main as scli
from rrtmil_tpu_torch.convert import flax_to_torch, torch_to_flax
from rrtmil_tpu_torch.data.survival import ArraySurvivalDataset
from rrtmil_tpu_torch.harness import survival
from rrtmil_tpu_torch.models import mhim, zoo
from rrtmil_tpu_torch.train.surv_engine import SurvivalEngineConfig

from test_torch_survival_cli import _write_survival_csv

D_IN = 32


def close(got, want, what, tol=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max() / max(1.0, float(np.abs(want).max()))
    assert err <= tol, f"{what}: scaled error {err:.3e}"


def to_jax(model):
    return jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))


def jax_draws(key, total_len, length, mask_ratio, mask_ratio_h,
              mask_ratio_hr=0.0):
    """The uniforms `build_keep_mask(key, ...)` draws inside, recomputed
    from its own splits."""
    k_rand, _, k_high = mhim.mask_counts(length, mask_ratio, 0.0,
                                         mask_ratio_h)
    u_rand = u_high = None
    if k_rand > 0:
        r1, key = jax.random.split(key)
        u_rand = torch.from_numpy(np.array(jax.random.uniform(
            r1, (total_len,))))
    if k_high > 0 and mask_ratio_hr == 0.0:
        r2, key = jax.random.split(key)
        u_high = torch.from_numpy(np.array(jax.random.uniform(
            r2, (total_len,))))
    return u_rand, u_high


def test_cosine_schedule_and_soft_target_ce_match_jax():
    for args, kw in (((0.02, 0.0, 3, 7), {}),
                     ((0.9999, 1.0, 2, 5), {"start_warmup": 1.0}),
                     ((0.5, 0.1, 4, 3), {"warmup_epochs": 1}),
                     ((0.3, 0.0, 1, 1), {})):
        got = mhim.cosine_schedule(*args, **kw)
        want = jmhim.cosine_schedule(*args, **kw)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    rng = np.random.default_rng(0)
    s, t = (rng.standard_normal((3, 16)).astype(np.float32) for _ in "ab")
    for temps in ((1.0, 1.0), (0.5, 2.0)):
        got = mhim.soft_target_ce(torch.from_numpy(s), torch.from_numpy(t),
                                  *temps)
        want = jmhim.soft_target_ce(jnp.asarray(s), jnp.asarray(t), *temps)
        assert abs(got.item() - float(want)) <= 1e-6
    st = torch.from_numpy(s).requires_grad_()
    tt = torch.from_numpy(t).requires_grad_()
    mhim.soft_target_ce(st, tt).backward()
    assert tt.grad is None and st.grad.abs().sum() > 0


@pytest.mark.parametrize("length,total,ratios,hr,ties", [
    (150, 200, (0.7, 0.2, 0.02), 0.0, False),
    (150, 200, (0.7, 0.2, 0.02), 0.5, True),
    (64, 64, (0.7, 0.2, 0.0), 0.0, True),
    (37, 80, (0.5, 0.0, 0.1), 0.0, False),
    (256, 300, (0.0, 0.3, 0.05), 0.0, True),
    (9, 16, (0.7, 0.2, 0.02), 0.0, False)])
def test_keep_mask_matches_jax(length, total, ratios, hr, ties):
    """The keep-mask core on JAX's draws for the same key equals
    `build_keep_mask`'s mask; pad rows are never kept, and at least the
    random subset's count is dropped.  Tied teacher attention (values
    rounded to one decimal) exercises the lower-index rule."""
    key = jax.random.PRNGKey(length + total)
    attn = np.random.default_rng(length).normal(size=(total,))
    attn = (np.round(attn, 1) if ties else attn).astype(np.float32)
    want = np.asarray(jmhim.build_keep_mask(key, jnp.asarray(attn), length,
                                            total, *ratios, hr))
    got = mhim.build_keep_mask(
        jax_draws(key, total, length, ratios[0], ratios[2], hr),
        torch.from_numpy(attn), length, total, *ratios, hr)
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    assert not got[length:].any()
    k_rand = mhim.mask_counts(length, *ratios)[0]
    assert int(got.sum()) <= length - k_rand


def test_attn_forward_and_gradients_match_jax():
    """The 'attn' network on a bag padded to 80 rows (75 true) under a
    keep-mask: logits, bag feature and raw attention within 1e-5; the
    gradients of a survival-style loss plus the soft-target CE against a
    fixed teacher feature within 1e-4."""
    model = zoo.seeded(mhim.MHIM(input_dim=D_IN, dropout=0.0), "cpu", 3)
    jmodel = jmhim.MHIM(input_dim=D_IN, dropout=0.0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 80, D_IN)).astype(np.float32)
    mask = np.arange(80)[None] < 75
    keep = rng.uniform(size=(1, 80)) > 0.4
    tea = rng.standard_normal((1, 512)).astype(np.float32)

    @jax.jit
    def jrun(p):
        def loss(q):
            lg, feat, att = jmodel.apply(
                {"params": q}, jnp.asarray(x), mask=jnp.asarray(mask),
                keep_mask=jnp.asarray(keep), return_attn=True,
                return_feat=True)
            total = jnp.sum(jax.nn.sigmoid(lg)) + jmhim.soft_target_ce(
                feat, jnp.asarray(tea))
            return total, (lg, feat, att)
        return jax.value_and_grad(loss, has_aux=True)(p)

    (jl, jout), jg = jrun(to_jax(model))
    out = model(torch.from_numpy(x), mask=torch.from_numpy(mask),
                keep_mask=torch.from_numpy(keep), return_attn=True,
                return_feat=True)
    assert [o.shape for o in out] == [(1, 4), (1, 512), (1, 80)]
    for got, want in zip(out, jout):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5)
    loss = torch.sigmoid(out[0]).sum() + mhim.soft_target_ce(
        out[1], torch.from_numpy(tea))
    assert abs(loss.item() - float(jl)) <= 1e-5
    loss.backward()
    want = flax_to_torch(jg)
    assert set(want) == {n for n, _ in model.named_parameters()}
    for n, p in model.named_parameters():
        close(p.grad.numpy(), want[n].numpy(), f"grad {n}")
    with torch.no_grad():
        only = model(torch.from_numpy(x), mask=torch.from_numpy(
            mask & keep))
    np.testing.assert_allclose(only.numpy(), out[0].detach().numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [64, 37])
def test_selfattn_forward_matches_jax(n):
    """The 'selfattn' baseline (reachable from no CLI) at 64 tokens (8 x 8:
    PPEG runs) and 37 (it does not), masked tokens zeroed: logits and bag
    feature within 1e-4, the attention map zeros."""
    model = zoo.seeded(mhim.MHIM(input_dim=D_IN, dropout=0.0,
                                 baseline="selfattn"), "cpu", 4)
    cls = model.online_encoder.cls_token
    assert 0.5 < cls.std().item() < 1.5
    jmodel = jmhim.MHIM(input_dim=D_IN, dropout=0.0, baseline="selfattn")
    rng = np.random.default_rng(n)
    x = rng.standard_normal((1, n, D_IN)).astype(np.float32)
    keep = rng.uniform(size=(1, n)) > 0.3
    jout = jax.jit(lambda p: jmodel.apply(
        {"params": p}, jnp.asarray(x), keep_mask=jnp.asarray(keep),
        return_attn=True, return_feat=True))(to_jax(model))
    with torch.no_grad():
        out = model(torch.from_numpy(x), keep_mask=torch.from_numpy(keep),
                    return_attn=True, return_feat=True)
    for got, want in zip(out, jout):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4)
    assert out[2].shape == (1, n) and not out[2].any()


def test_engine_epoch_matches_jax(monkeypatch):
    """One MHIMSurvivalEngine epoch (two steps on bags of 70 and 150
    patches at repr_length 256, dropout off, niter_per_ep 2) against the
    JAX engine's, each step's keep-mask built from the draws JAX makes for
    that step's key: the epoch loss within 1e-5, the student within Adam's
    drift bound, the EMA teacher within 1e-6 (and moved), the step count
    carried; then validation within 1e-4 and the same c-index.  The
    engine's device bag cache is on: the train steps fill it, validation
    is served from it."""
    tr = [np.random.default_rng(s).standard_normal((n, D_IN)).astype(
        np.float32) for s, n in ((1, 70), (2, 150))]
    events, status = [300.0, 900.0], [1, 0]
    model, enc = survival.build_survival_model("MHIM-MIL", D_IN,
                                               device="cpu", seed=5)
    model.p = 0.0
    params = to_jax(model)
    jeng = jsurvival.make_survival_engine(
        "MHIM-MIL", jmhim.MHIM(input_dim=D_IN, dropout=0.0),
        JSurvivalEngineConfig(num_epochs=1), enc, niter_per_ep=2)
    state = TrainState(params=params, opt_state=jeng.tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    jeng.teacher_params = jax.tree.map(jnp.copy, params)
    key = jax.random.PRNGKey(3)
    state, jloss, _ = jeng.train_epoch(state, JArraySurv(tr, events, status),
                                       [0, 1], 0, key)

    eng = survival.make_survival_engine(
        "MHIM-MIL", model, SurvivalEngineConfig(num_epochs=1,
                                                device_cache="on"),
        enc, device="cpu", niter_per_ep=2)
    assert isinstance(eng, survival.MHIMSurvivalEngine)
    ds = ArraySurvivalDataset(tr, events, status)
    np.testing.assert_array_equal(eng.mrh_sche, jeng.mrh_sche)
    np.testing.assert_array_equal(eng.mm_sche, jeng.mm_sche)
    teacher0 = {k: v.clone() for k, v in eng.teacher.state_dict().items()}
    calls = []

    def draws(total_len, length, mask_ratio, mask_ratio_h, hr, gen, dev):
        r_mask = jax.random.split(jax.random.fold_in(key, len(calls)))[0]
        calls.append((total_len, length, mask_ratio_h))
        return jax_draws(r_mask, total_len, length, mask_ratio,
                         mask_ratio_h, hr)
    monkeypatch.setattr(mhim, "keep_mask_draws", draws)
    loss, _ = eng.train_epoch(ds, [0, 1], 0)
    assert len(eng._dcache) == 2 and eng._dcache.hits == 0
    assert len(calls) == 2 and eng._iter == 2 and \
        {c[1] for c in calls} == {256}, calls
    assert [c[2] for c in calls] == [round(float(v), 4)
                                     for v in eng.mrh_sche]
    assert abs(loss - jloss) <= 1e-5 * max(1.0, abs(jloss)), (loss, jloss)
    want = flax_to_torch(state.params)
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        scale = max(1.0, float(np.abs(ref).max()))
        diff = np.abs(p.detach().numpy() - ref) / scale
        assert diff.max() <= 2 * 2 * eng.cfg.lr * 1.01 / scale, name
        assert (diff > 1e-5 + 1e-4 * np.abs(ref) / scale).mean() <= 1e-3, \
            name
    jteacher = flax_to_torch(jeng.teacher_params)
    moved = 0.0
    for name, t in eng.teacher.named_parameters():
        assert not t.requires_grad
        np.testing.assert_allclose(t.numpy(), jteacher[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
        moved = max(moved, (t - teacher0[name]).abs().max().item())
    assert moved > 0
    jv = jeng.validate(state.params, JArraySurv(tr, events, status), [0, 1])
    v = eng.validate(ds, [0, 1])
    assert eng._dcache.hits == 2
    assert abs(v[0] - jv[0]) <= 1e-4 and v[1] == jv[1], (v, jv)


def test_resume_loads_the_student_alone():
    """--resume's `load_state_dict` replaces the student's weights and
    leaves the teacher at its copy of the initial student; the engine
    optimizes the student alone."""
    model, enc = survival.build_survival_model("MHIM-MIL", D_IN,
                                               device="cpu", seed=1)
    eng = survival.make_survival_engine("MHIM-MIL", model,
                                        SurvivalEngineConfig(), enc,
                                        device="cpu")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    other = survival.build_survival_model("MHIM-MIL", D_IN, device="cpu",
                                          seed=2)[0].state_dict()
    eng.load_state_dict(other)
    for k, v in eng.model.state_dict().items():
        assert torch.equal(v, other[k])
        assert torch.equal(eng.teacher.state_dict()[k], init[k])
    opt = {id(p) for g in eng.optimizer.param_groups for p in g["params"]}
    assert opt == {id(p) for p in eng.model.parameters()}


@pytest.mark.parametrize("baseline", ["attn", "selfattn"])
def test_converter_round_trip(baseline):
    jm = jmhim.MHIM(input_dim=D_IN, baseline=baseline)
    params = jax.jit(lambda k: jm.init(k, jnp.zeros((1, 49, D_IN))))(
        jax.random.PRNGKey(0))["params"]
    sd = flax_to_torch(params)
    model = mhim.MHIM(input_dim=D_IN, baseline=baseline)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    back = torch_to_flax(sd)
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        assert np.array_equal(node, np.asarray(leaf)), path


def test_survival_cli_trains_saves_resumes_and_evaluates(tmp_path):
    """`survival_main --model MHIM-MIL` (5 folds x 1 epoch), then
    `--evaluate --resume` over its directory: every fold that saved weights
    gives its best c-index again (the student's weights; validation never
    reads the teacher)."""
    csv_file = _write_survival_csv(str(tmp_path / "surv"), dim=D_IN)
    res = str(tmp_path / "s")
    common = ["--excel_file", csv_file, "--model", "MHIM-MIL",
              "--input_dim", str(D_IN), "--device", "cpu"]
    meter = scli.main(common + ["--num_epoch", "1", "--results_dir", res])
    best = meter.cindex[1:6]
    assert all(np.isfinite(best))
    again = scli.main(common + ["--evaluate", "--resume", res,
                                "--results_dir", str(tmp_path / "e")])
    kept = [k for k in range(5) if os.listdir(os.path.join(res,
                                                           f"fold_{k}"))]
    assert kept and all(again.cindex[1 + k] == best[k] for k in kept)
    saved = torch.load(os.path.join(res, f"fold_{kept[0]}", os.listdir(
        os.path.join(res, f"fold_{kept[0]}"))[0]), weights_only=True)
    assert set(saved) == set(survival.build_survival_model(
        "MHIM-MIL", D_IN, device="cpu")[0].state_dict())
