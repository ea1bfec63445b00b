"""The port's survival path against the JAX package on the CPU: K12 and K13
(the non-grid CR-MSA compress and redistribute) against their Pallas kernels
in interpret mode and their Functions' gradients against `jax.vjp`; the
survival losses, bins, split and plateau schedule; `SurvivalHead(RRTMIL)`
hazards, survival and every parameter gradient; two epochs of
`SurvivalEngine`.

survival_default() trains R-MSA at region_num 16 while CR-MSA keeps 8, so a
bucket whose R-MSA grid exceeds the CR-MSA grid (L = 300: grids 32 and 24)
runs the CR-MSA layer unfused, through K12 -> K5 -> K13; L = 150 (grids 16
and 16) runs the fused K3 -> K5 -> K8.  JAX's RRTMIL hard-codes its 512-wide
patch embedding (rrt.py:850), so the encoder stays 512 wide with 8 heads of
64; the input width is cut to 32.  The JAX model runs its XLA path with fp32
products, the port its kernels' plain versions.

Tolerances on max|port - jax| over max(1, max|jax|): 1e-4 for fp32 products
(the same arithmetic summed in another order), 2e-2 for bf16 products (a sum
next to a bf16 rounding boundary rounds the other way).  Parameters after
Adam steps: at most 1e-3 of a tensor's elements past 1e-5, none past
2 x steps x lr x 1.01 (PERF.md, Adam's drift bound); pe_bias and the key
third of each qkv bias, whose gradients are zero in exact arithmetic, are
left out there.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rrtmil_tpu.config import survival_default as jax_survival_default
from rrtmil_tpu.data.bucketing import bucket_for as jax_bucket_for
from rrtmil_tpu.data.survival import ArraySurvivalDataset as JArraySurvDataset
from rrtmil_tpu.data.survival import SurvivalDataset as JSurvivalDataset
from rrtmil_tpu.data.survival import quantile_bins as jax_quantile_bins
from rrtmil_tpu.models.rrt import RRTMIL as JRRTMIL
from rrtmil_tpu.models.survival import SurvivalHead as JSurvivalHead
from rrtmil_tpu.ops.pallas import crmsa_kernels as jck
from rrtmil_tpu.train import losses as jlosses
from rrtmil_tpu.train import optim as joptim
from rrtmil_tpu.train.engine import TrainState
from rrtmil_tpu.train.surv_engine import SurvivalEngine as JSurvivalEngine
from rrtmil_tpu.train.surv_engine import \
    SurvivalEngineConfig as JSurvivalEngineConfig
from rrtmil_tpu_torch.config import survival_default
from rrtmil_tpu_torch.convert import flax_to_torch, torch_to_flax
from rrtmil_tpu_torch.data.bucketing import bucket_for
from rrtmil_tpu_torch.data.survival import (ArraySurvivalDataset,
                                            SurvivalDataset, quantile_bins)
from rrtmil_tpu_torch.models import rrt
from rrtmil_tpu_torch.models.rrt import RRTMIL
from rrtmil_tpu_torch.models.survival import SurvivalHead, risk_score
from rrtmil_tpu_torch.ops.kernels import crmsa_kernels as ck
from rrtmil_tpu_torch.train import losses, optim
from rrtmil_tpu_torch.train.surv_engine import (SurvivalEngine,
                                                SurvivalEngineConfig)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
D_IN = 32


def _scaled_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _close(got, want, mm, what=""):
    err = _scaled_err(got, want)
    assert err <= TOL[mm], f"{what} {mm}: scaled error {err:.3e}"


def _regions(rng, r=6, p=9, c=128):
    """(R, P, C) regions with zero rows (the bucket's pad tokens after the
    mask): their logits tie at 0, at the min or the max of a region."""
    x = rng.standard_normal((r, p, c)).astype(np.float32)
    x[1, 4:] = 0.0
    x[3, :2] = 0.0
    x[5] = 0.0                                  # every logit ties
    return x


# ---------------------------------------------------------------------------
# K12 / K13
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stream,mm", [("float32", "float32"),
                                       ("float32", "bfloat16"),
                                       ("bfloat16", "bfloat16")])
def test_k12_k13_plain_match_pallas(stream, mm):
    rng = np.random.default_rng(1)
    x = _regions(rng)
    phi = rng.uniform(-0.6, 0.6, (128, 3)).astype(np.float32)
    (jsd, tsd), (jmm, tmm) = DT[stream], DT[mm]
    jreps, jw = jck._compress_pallas(jnp.asarray(x, jsd), jnp.asarray(phi),
                                     mm_dtype=jmm, interpret=True)
    xt = torch.from_numpy(x).to(tsd)
    reps, w = ck.crmsa_compress(xt, torch.from_numpy(phi), mm_dtype=tmm)
    assert reps.dtype == w.dtype == torch.float32
    _close(reps, jreps, mm, "K12 reps")
    _close(w, jw, mm, "K12 w")
    att = rng.standard_normal(np.asarray(jreps).shape).astype(np.float32)
    jout = jck._redistribute_pallas(jw, jnp.asarray(att), jnp.float32,
                                    mm_dtype=jmm, interpret=True)
    out = ck.crmsa_redistribute(torch.from_numpy(np.array(jw)),
                                torch.from_numpy(att), mm_dtype=tmm)
    _close(out, jout, mm, "K13")


def test_k12_k13_function_gradients_match_jax_vjp(monkeypatch):
    """The Functions' backwards (autograd through the plain forwards) against
    jax.vjp of crmsa_compress / crmsa_redistribute (the vjp of the XLA
    references), ties included: the min and max gradients split equally.
    fp32 products: JAX's CPU backend has no bf16 x bf16 -> f32 product for
    the vjp's dots."""
    monkeypatch.setenv("RRTMIL_PALLAS_INTERPRET", "1")
    mm = "float32"
    rng = np.random.default_rng(2)
    x = _regions(rng)
    phi = rng.uniform(-0.6, 0.6, (128, 3)).astype(np.float32)
    g_reps = rng.standard_normal((6, 3, 128)).astype(np.float32)
    g_w = rng.standard_normal((6, 3, 9)).astype(np.float32)
    jmm, tmm = DT[mm]
    _, vjp = jax.vjp(lambda a, b: jck.crmsa_compress(a, b, jmm),
                     jnp.asarray(x), jnp.asarray(phi))
    jdx, jdphi = vjp((jnp.asarray(g_reps), jnp.asarray(g_w)))
    xt = torch.from_numpy(x).requires_grad_(True)
    pt = torch.from_numpy(phi).requires_grad_(True)
    reps, w = ck.crmsa_compress(xt, pt, mm_dtype=tmm)
    dx, dphi = torch.autograd.grad((reps, w), (xt, pt),
                                   (torch.from_numpy(g_reps),
                                    torch.from_numpy(g_w)))
    _close(dx, jdx, mm, "K12 dx")
    _close(dphi, jdphi, mm, "K12 dphi")

    wv = rng.uniform(0, 1, (6, 3, 9)).astype(np.float32)
    rv = rng.standard_normal((6, 3, 128)).astype(np.float32)
    g = rng.standard_normal((6, 9, 128)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jck.crmsa_redistribute(a, b, jnp.float32,
                                                         jmm),
                     jnp.asarray(wv), jnp.asarray(rv))
    jdw, jdr = vjp(jnp.asarray(g))
    wt = torch.from_numpy(wv).requires_grad_(True)
    rt = torch.from_numpy(rv).requires_grad_(True)
    dw, dr = torch.autograd.grad(ck.crmsa_redistribute(wt, rt, mm_dtype=tmm),
                                 (wt, rt), torch.from_numpy(g))
    _close(dw, jdw, mm, "K13 dw")
    _close(dr, jdr, mm, "K13 dreps")


def test_k12_ties_split_the_min_max_gradient_equally():
    """A region of identical rows: every logit ties at both the min and the
    max, so their gradient splits evenly and the phi gradient stays
    finite."""
    x = torch.ones((1, 4, 128)).requires_grad_(True)
    phi = torch.linspace(-1, 1, 128 * 2).reshape(128, 2).requires_grad_(True)
    reps, w = ck.crmsa_compress(x, phi, mm_dtype=torch.float32)
    dx, dphi = torch.autograd.grad(w.sum(), (x, phi))
    assert torch.isfinite(dx).all() and torch.isfinite(dphi).all()
    np.testing.assert_allclose(dx[0, 0].numpy(), dx[0, 3].numpy(), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# losses, bins, split, plateau schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alpha", [0.0, 0.4])
@pytest.mark.parametrize("name", ["nll_surv_loss", "ce_surv_loss"])
def test_survival_losses_match_jax(name, alpha):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((16, 4)).astype(np.float32) * 3
    logits[0] = 40.0                         # hazards at 1: the clamps bite
    logits[1] = -12.0                        # S just below 1
    hazards = 1.0 / (1.0 + np.exp(-logits))
    survival = np.cumprod(1.0 - hazards, axis=-1).astype(np.float32)
    label = rng.integers(0, 4, 16)
    cens = (rng.uniform(size=16) < 0.4).astype(np.float32)
    want = getattr(jlosses, name)(jnp.asarray(hazards), jnp.asarray(survival),
                                  jnp.asarray(label), jnp.asarray(cens),
                                  alpha=alpha)
    got = getattr(losses, name)(torch.from_numpy(hazards.astype(np.float32)),
                                torch.from_numpy(survival),
                                torch.from_numpy(label),
                                torch.from_numpy(cens), alpha=alpha)
    assert abs(got.item() - float(want)) <= 1e-5 * max(1.0, abs(float(want)))


def test_bins_split_and_datasets_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    events = np.round(rng.uniform(10, 3000, 23), 1)
    status = (rng.uniform(size=23) < 0.7).astype(np.int64)
    np.testing.assert_array_equal(quantile_bins(events, status),
                                  jax_quantile_bins(events, status))
    rows = ["Study,ID,Event,Status,WSI"]
    for i in range(23):
        a, b = f"resnet50/c{i}a.npy", f"resnet50/c{i}b.npy"
        os.makedirs(tmp_path / "plip", exist_ok=True)
        for j, name in enumerate((a, b)):
            np.save(tmp_path / name.replace("resnet50", "plip"),
                    np.full((3 + j, 4), i, np.float32))
        rows.append(f"s,case{i},{events[i]},{status[i]},{a};{b}")
    csv_file = tmp_path / "surv.csv"
    csv_file.write_text("\n".join(rows) + "\n")
    ds = SurvivalDataset(str(csv_file), root=str(tmp_path))
    jds = JSurvivalDataset(str(csv_file), root=str(tmp_path))
    np.testing.assert_array_equal(ds.labels, jds.labels)
    np.testing.assert_array_equal(ds.censorship, jds.censorship)
    for fold in range(5):
        assert ds.get_split(fold) == jds.get_split(fold)
    for i in (0, 7, 22):
        got, want = ds[i], jds[i]
        assert got[0] == want[0] and got[2:] == want[2:]
        np.testing.assert_array_equal(got[1], want[1])
        assert got[1].shape == (7, 4)
    bags = [np.zeros((2, 4), np.float32)] * 23
    mem, jmem = (ArraySurvivalDataset(bags, events, status),
                 JArraySurvDataset(bags, events, status))
    np.testing.assert_array_equal(mem.labels, jmem.labels)
    assert mem[3][2:] == jmem[3][2:]


def test_plateau_and_step_schedules_match_jax():
    vals = [5.0, 4.0, 4.0, 3.99, 4.1, 4.2, 4.3, 4.4, 4.5, 4.6, 4.7, 2.0,
            2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0]
    p, jp = optim.PlateauLR(1e-3), joptim.PlateauLR(1e-3)
    assert [p.step(v) for v in vals] == [jp.step(v) for v in vals]
    assert p.lr < 1e-3
    eng = SurvivalEngine(torch.nn.Linear(2, 2), SurvivalEngineConfig(
        lr_schedule="step", num_epochs=10, lr=1e-3), device="cpu")
    assert [eng.epoch_lr(e) for e in range(10)] == [
        joptim.lr_at("step", 1e-3, e, 10, step_gamma=0.1) for e in range(10)]


# ---------------------------------------------------------------------------
# SurvivalHead(RRTMIL) and SurvivalEngine
# ---------------------------------------------------------------------------

def _cfgs(dropout=0.0):
    """(jax config, port config): survival_default at input width 32, fp32
    products, dropout off, the JAX model on its XLA path."""
    def one(fn, backend):
        cfg = fn()
        enc = dataclasses.replace(cfg.encoder, backend=backend,
                                  mm_dtype="float32", dropout=dropout)
        return dataclasses.replace(cfg, input_dim=D_IN, dropout=dropout,
                                   encoder=enc)
    return one(jax_survival_default, "xla"), one(survival_default, "auto")


@pytest.fixture(scope="module")
def params():
    """A flax init of JAX's SurvivalHead(RRTMIL) (submodule 'backbone')."""
    jcfg, _ = _cfgs()
    model = JSurvivalHead(JRRTMIL(jcfg))
    x = jnp.zeros((1, 64, D_IN), jnp.float32)
    return jax.jit(lambda k: model.init({"params": k}, x, length=64))(
        jax.random.PRNGKey(5))["params"]


def _port(tcfg, params):
    model = SurvivalHead(RRTMIL(tcfg))
    model.load_state_dict(flax_to_torch(params))
    return model


def test_convert_round_trips_the_survival_tree(params):
    _, tcfg = _cfgs()
    model = _port(tcfg, params)
    back = torch_to_flax(model.state_dict())
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(got)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf))
    assert all(k.startswith("backbone.") for k in model.state_dict())


def _bag(length, seed):
    spec = jax_bucket_for(length, _cfgs()[0].encoder)
    rng = np.random.default_rng(seed)
    x = np.zeros((1, spec.data_length, D_IN), np.float32)
    x[0, :length] = rng.standard_normal((length, D_IN))
    mask = np.zeros((1, spec.data_length), bool)
    mask[0, :length] = True
    return x, mask, spec


@pytest.mark.parametrize("length,grids", [(300, (32, 24)), (150, (16, 16))])
def test_survival_model_and_gradients_match_jax(params, length, grids,
                                                monkeypatch):
    """Hazards, survival, the loss and every parameter gradient; the
    mismatched bucket goes through K12 and K13, the matched one through K3
    and K8."""
    jcfg, tcfg = _cfgs()
    x, mask, spec = _bag(length, seed=length)
    assert spec.key == grids
    assert dataclasses.astuple(bucket_for(length, tcfg.encoder)) == \
        dataclasses.astuple(spec)
    label, cens = np.array([2]), np.array([0.0], np.float32)
    jmodel = JSurvivalHead(JRRTMIL(jcfg))

    def loss(p):
        h, s = jmodel.apply({"params": p}, jnp.asarray(x),
                            mask=jnp.asarray(mask), length=spec.repr_length)
        return jlosses.nll_surv_loss(h, s, jnp.asarray(label),
                                     jnp.asarray(cens), alpha=0.0), (h, s)

    (jl, (jh, js)), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    calls = []
    for name in ("crmsa_compress", "crmsa_redistribute", "crmsa_compress_grid",
                 "crmsa_redistribute_grid_ln"):
        def spy(*a, _orig=getattr(rrt, name), _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(rrt, name, spy)
    model = _port(tcfg, params).train()
    h, s = model(torch.from_numpy(x), mask=torch.from_numpy(mask),
                 length=spec.repr_length)
    tl = losses.nll_surv_loss(h, s, torch.from_numpy(label),
                              torch.from_numpy(cens), alpha=0.0)
    tl.backward()
    assert calls == (["crmsa_compress", "crmsa_redistribute"]
                     if grids[0] != grids[1] else
                     ["crmsa_compress_grid", "crmsa_redistribute_grid_ln"])
    _close(h.detach(), jh, "float32", "hazards")
    _close(s.detach(), js, "float32", "survival")
    assert abs(tl.item() - float(jl)) <= 1e-5 * max(1.0, abs(float(jl)))
    want = flax_to_torch(jg)
    for name, p in model.named_parameters():
        g = p.grad.numpy()
        if "pe_bias" in name:             # zero in exact arithmetic
            assert np.abs(g - want[name].numpy()).max() <= 1e-5, name
            continue
        _close(g, want[name].numpy(), "float32", name)


def test_survival_engine_two_epochs_match_jax(params):
    """Two epochs of train_epoch + validate (batch 1, the engines' shared
    shuffle, Adam with L2 decay, the cosine schedule, dropout off): the
    losses, the c-indices, the validation risks and every parameter."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(6)
    lengths = (290, 310, 300, 320, 295)              # one bucket: grids 32/24
    bags = [rng.standard_normal((n, D_IN)).astype(np.float32) for n in lengths]
    events, status = [120.0, 340.0, 80.0, 900.0, 410.0], [1, 0, 1, 1, 0]
    train_idx, val_idx = [0, 1, 2, 3], [4, 0]
    kw = dict(lr=1e-3, num_epochs=2, seed=3)
    eng = SurvivalEngine(_port(tcfg, params), SurvivalEngineConfig(**kw),
                         tcfg.encoder, device="cpu")
    jeng = JSurvivalEngine(JSurvivalHead(JRRTMIL(jcfg)),
                           JSurvivalEngineConfig(**kw), jcfg.encoder)
    jparams = jax.tree.map(jnp.array, params)       # the JAX step donates
    state = TrainState(params=jparams, opt_state=jeng.tx.init(jparams),
                       step=jnp.zeros((), jnp.int32))
    ds = ArraySurvivalDataset(bags, events, status)
    jds = JArraySurvDataset(bags, events, status)
    for epoch in range(2):
        state, jtl, jtc = jeng.train_epoch(state, jds, train_idx, epoch,
                                           jax.random.PRNGKey(epoch))
        tl, tc = eng.train_epoch(ds, train_idx, epoch)
        jvl, jvc = jeng.validate(state.params, jds, val_idx)
        vl, vc = eng.validate(ds, val_idx)
        for got, want in ((tl, jtl), (vl, jvl)):
            assert abs(got - want) <= 1e-4 * max(1.0, abs(want)), (epoch, got,
                                                                   want)
        assert (tc, vc) == (jtc, jvc)
    for idx in val_idx:
        x, mask, spec, _, c, lab = eng._prep_indexed(ds, idx)
        _, jrisk = jeng._eval_step(state.params, jnp.asarray(x.numpy()),
                                   jnp.asarray(mask.numpy()),
                                   jnp.asarray([lab]), jnp.asarray([c], float),
                                   spec.repr_length)
        with torch.no_grad():
            risk = risk_score(eng.model(x, mask=mask,
                                        length=spec.repr_length)[1])
        _close(risk, jrisk, "float32", "risk")
    want = flax_to_torch(state.params)
    steps, lr = 8, kw["lr"]
    for name, p in eng.model.named_parameters():
        got, ref = p.detach().numpy(), want[name].numpy()
        if "pe_bias" in name:
            continue
        if name.endswith("qkv.bias"):
            third = got.shape[0] // 3
            got = np.concatenate([got[:third], got[2 * third:]])
            ref = np.concatenate([ref[:third], ref[2 * third:]])
        scale = max(1.0, float(np.abs(ref).max()))
        diff = np.abs(got - ref) / scale
        miss = diff > 1e-5 + 1e-4 * np.abs(ref) / scale
        assert miss.mean() <= 1e-3, f"{name}: {miss.sum()} of {miss.size}"
        assert diff.max() <= 2 * steps * lr * 1.01 / scale, name
