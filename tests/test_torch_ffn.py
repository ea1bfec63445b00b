"""The FFN and stochastic-depth TransLayer of the port against the JAX
package on the CPU: K10 (the CR-MSA redistribution without the final
LayerNorm) and K11 (its backward) against their Pallas kernels in interpret
mode; c16_r50 with `ffn=True` (logits and every parameter gradient); the
DropPath semantics; where drop_path routes the fused layers in train mode;
the converter on a tree with `norm2` / `mlp`.

With the FFN, the final LayerNorm cannot ride the CR-MSA redistribution
(an FFN follows it), so the fused CR-MSA layer writes its stream through
K10 in eval and in training (rrt.py:694-717,797-801).  JAX's RRTMIL
hard-codes its 512-wide patch embedding (rrt.py:850), so the encoder stays
512 wide with 8 heads of 64 and the input width is cut to 64.

Tolerances on max|port - jax| over max(1, max|jax|): 1e-4 for fp32 products
(the same arithmetic summed in another order), 2e-2 for bf16 products (a sum
next to a bf16 rounding boundary rounds the other way).  Gradients that are
zero in exact arithmetic (pe_bias's) are held in absolute terms only.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rrtmil_tpu.config import c16_r50 as jax_c16_r50
from rrtmil_tpu.data.bucketing import bucket_for as jax_bucket_for
from rrtmil_tpu.models.rrt import RRTMIL as JRRTMIL
from rrtmil_tpu.ops.pallas.crmsa_kernels import (_redistribute_grid_pallas,
                                                 _rgrid_bwd_pallas)
from rrtmil_tpu_torch.config import c16_r50
from rrtmil_tpu_torch.convert import flax_to_torch, torch_to_flax
from rrtmil_tpu_torch.models import rrt
from rrtmil_tpu_torch.models.rrt import RRTMIL, drop_path
from rrtmil_tpu_torch.ops.kernels import crmsa_kernels as ck

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
C, G, RS, K = 128, 8, 4, 3
D_IN = 64


def _close(got, want, mm, what=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got = np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= TOL[mm], f"{what} {mm}: scaled error {err:.3e}"


def _grid_case(rng, lengths=(40, 25), g_side=G, rs=RS, k=K, tie=False):
    """A (B, G*G, C) stream with pad rows, w and reps of an rs-wide grid,
    and an upstream gradient g (not zero on pad rows); with `tie`, w takes
    one value a representative on pad rows (as K3 gives rows whose logits
    tie)."""
    b, n, nr = len(lengths), g_side * g_side, (g_side // rs) ** 2
    mask = np.zeros((b, n), bool)
    for i, l in enumerate(lengths):
        mask[i, :l] = True
    x = rng.standard_normal((b, n, C)).astype(np.float32) * mask[..., None]
    w = rng.uniform(0, 1, (b, nr, k, rs * rs)).astype(np.float32)
    if tie:
        m = g_side // rs
        pad = ~mask.reshape(b, m, rs, m, rs).transpose(0, 1, 3, 2, 4) \
            .reshape(b, nr, 1, rs * rs)
        w = np.where(pad, w[:, :1, :, :1], w)
    reps = rng.standard_normal((b, nr, k, C)).astype(np.float32)
    g = rng.standard_normal((b, n, C)).astype(np.float32)
    return x, mask, w, reps, g


# ---------------------------------------------------------------------------
# K10 / K11 against the Pallas kernels
# ---------------------------------------------------------------------------

# K10 / K11 cases (P, k, stream, mm, add_residual): the first six on the
# 8-grid of 4-wide regions (P = 16, k = 3); then P in {1, 9, 144}
# (ck.row_split's region sizes: one token, rows not a multiple of 8,
# c16_r50's) with k in {1, 3, 5, 8}, the second bag's last row of regions
# pad rows but one token (masked; their w tied), and bf16 streams
RGRID_GEOMS = {1: (8, 1), 9: (12, 3), 144: (24, 12)}   # P: (G, rs)
RGRID_CASES = [pytest.param(16, K, st, mm, res, id=f"{st}-{mm}-{res}")
               for res in (True, False)
               for st, mm in (("float32", "float32"), ("float32", "bfloat16"),
                              ("bfloat16", "bfloat16"))]
RGRID_CASES += [pytest.param(p, k, "float32", "float32", k in (1, 5),
                             id=f"P{p}-k{k}")
                for p in RGRID_GEOMS for k in (1, 3, 5, 8)]
RGRID_CASES += [pytest.param(*c, id="P{}-k{}-{}-{}-{}".format(*c)) for c in (
    (9, 3, "float32", "bfloat16", True),
    (144, 5, "bfloat16", "bfloat16", False))]


@pytest.mark.parametrize("p,k,stream,mm,add_residual", RGRID_CASES)
def test_k10_k11_plain_match_pallas(p, k, stream, mm, add_residual):
    if p == 16:
        g_side, rs = G, RS
        x, mask, w, reps, g = _grid_case(np.random.default_rng(1))
    else:
        g_side, rs = RGRID_GEOMS[p]
        n = g_side * g_side
        x, mask, w, reps, g = _grid_case(
            np.random.default_rng(50 + p + k), (n, n - rs * g_side + 1),
            g_side, rs, k, tie=True)
    (jsd, tsd), (jmm, tmm) = DT[stream], DT[mm]
    jx, jg = jnp.asarray(x, jsd), jnp.asarray(g, jsd)
    tx = torch.from_numpy(x).to(tsd)
    got = ck.crmsa_redistribute_grid(tx, torch.from_numpy(mask),
                                     torch.from_numpy(w),
                                     torch.from_numpy(reps), g_side, rs,
                                     add_residual, mm_dtype=tmm)
    assert got.dtype == tsd
    if p == 16:   # K10 against its Pallas kernel (the region-size cases hold
        # K11, the kernel whose rows they split, and keep the suite short)
        want = _redistribute_grid_pallas(
            jx, jnp.asarray(mask), jnp.asarray(w), jnp.asarray(reps),
            grid_side=g_side, region_size=rs, add_residual=add_residual,
            mm_dtype=jmm, interpret=True)
        _close(got, want, mm, "K10")
    jdw, jdreps = _rgrid_bwd_pallas(jnp.asarray(mask), jnp.asarray(w),
                                    jnp.asarray(reps), jg, grid_side=g_side,
                                    region_size=rs, mm_dtype=jmm,
                                    interpret=True)
    tg = torch.from_numpy(g).to(tsd)
    dw, dreps = ck.crmsa_redistribute_grid_bwd(
        torch.from_numpy(mask), torch.from_numpy(w), torch.from_numpy(reps),
        tg, g_side, rs, mm_dtype=tmm)
    _close(dw, jdw, mm, f"K11 dw P={p} k={k}")
    _close(dreps, jdreps, mm, f"K11 dreps P={p} k={k}")
    # the Function: K10 forward, K11 backward, dx = g or nothing
    xs = tx.clone().requires_grad_(True)
    ws = torch.from_numpy(w).requires_grad_(True)
    rt = torch.from_numpy(reps).requires_grad_(True)
    out = ck.crmsa_redistribute_grid(xs, torch.from_numpy(mask), ws, rt,
                                     g_side, rs, add_residual, mm_dtype=tmm)
    dx, dw2, dr2 = torch.autograd.grad(out, (xs, ws, rt), tg,
                                       allow_unused=True)
    assert torch.equal(dw2, dw) and torch.equal(dr2, dreps)
    assert torch.equal(dx, tg) if add_residual else dx is None


@pytest.mark.parametrize("regions,p", [(64, 144), (512, 144), (64, 1),
                                       (64, 9), (64, 729), (512, 961)])
@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("ln", [False, True])
def test_rgrid_bwd_buffers_hold_each_gradient_once(regions, p, k, ln):
    """K11's (ln False) and K9's launch buffers: one allocation holds dw,
    dreps, K9's dls | dlb and, only when a region is more than one
    row_split chunk, the blocks' dreps partials (and K9's dls | dlb
    partials)."""
    dw, dreps, dln, part, chunk = ck._rgrid_bwd_buffers(
        regions, p, C, k, "cpu", ln=ln)
    assert chunk == ck.row_split(regions, p)
    parts = -(-p // chunk)
    assert dw.numel() == regions * k * p
    assert dreps.numel() == regions * k * C
    assert (dln is None) != ln and (not ln or dln.numel() == 2 * C)
    want = (parts * regions * k * C if parts > 1 else 0) \
        + (parts * regions * 2 * C if ln else 0)
    assert (part is None) == (want == 0)
    assert part is None or part.numel() == want
    views = [v for v in (dw, dreps, dln, part) if v is not None]
    assert all(v.untyped_storage().data_ptr()
               == dw.untyped_storage().data_ptr() for v in views)


def test_k10_function_matches_autograd_of_its_plain_forward():
    """K11's dw and dreps are the gradient of K10's plain forward: in fp32
    the rounding points are identities, so autograd through the plain
    forward is the reference."""
    rng = np.random.default_rng(2)
    x, mask, w, reps, g = _grid_case(rng)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, reps)]
    m = torch.from_numpy(mask)
    for add_residual in (True, False):
        args = (leaves[0], m, leaves[1], leaves[2], G, RS, add_residual)
        got = torch.autograd.grad(
            ck.crmsa_redistribute_grid(*args, mm_dtype=torch.float32), leaves,
            torch.from_numpy(g), allow_unused=True)
        want = torch.autograd.grad(
            ck.redistribute_grid_plain(*args, mm_dtype=torch.float32), leaves,
            torch.from_numpy(g), allow_unused=True)
        for a, b in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        if add_residual:
            torch.testing.assert_close(got[0], want[0])
        else:
            assert got[0] is None


# ---------------------------------------------------------------------------
# c16_r50 with the FFN
# ---------------------------------------------------------------------------

def _cfgs(backend, mm="float32", drop=0.0):
    """(jax config, port config): c16_r50 with ffn=True at input width 64,
    dropout `drop` everywhere (off by default)."""
    def one(fn, be):
        cfg = fn()
        enc = dataclasses.replace(cfg.encoder, backend=be, mm_dtype=mm,
                                  ffn=True, dropout=drop)
        return dataclasses.replace(cfg, input_dim=D_IN, dropout=drop,
                                   encoder=enc)
    return one(jax_c16_r50, backend), one(c16_r50, "auto")


@pytest.fixture(scope="module")
def params():
    jcfg, _ = _cfgs("xla")
    x = jnp.zeros((1, 64, D_IN), jnp.float32)
    return jax.jit(lambda k: JRRTMIL(jcfg).init({"params": k}, x, length=64))(
        jax.random.PRNGKey(4))["params"]


def _batch(lengths, enc, seed):
    spec = jax_bucket_for(max(lengths), enc)
    rng = np.random.default_rng(seed)
    x = np.zeros((len(lengths), spec.data_length, D_IN), np.float32)
    mask = np.zeros((len(lengths), spec.data_length), bool)
    for i, n in enumerate(lengths):
        x[i, :n] = rng.standard_normal((n, D_IN))
        mask[i, :n] = True
    return x, mask, spec.repr_length


def _port(tcfg, params):
    model = RRTMIL(tcfg)
    model.load_state_dict(flax_to_torch(params))
    return model


def test_convert_round_trips_the_ffn_tree(params):
    _, tcfg = _cfgs("xla")
    model = _port(tcfg, params)
    names = set(model.state_dict())
    for layer in ("layer0", "cr_msa"):
        for leaf in ("norm2.weight", "norm2.bias", "mlp.fc1.weight",
                     "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias"):
            assert f"online_encoder.{layer}.{leaf}" in names
    assert model.online_encoder.layer0.mlp.fc1.weight.shape == (2048, 512)
    back = torch_to_flax(model.state_dict())
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(got)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf))


@pytest.mark.parametrize("backend,mm", [("pallas", "bfloat16"),
                                        ("xla", "float32")])
def test_ffn_logits_match_jax(params, backend, mm, monkeypatch):
    """The port's fused structure (K1 -> FFN, K3 -> K5 -> K10 -> FFN -> the
    final LayerNorm) against JAX's Pallas kernels in interpret mode (bf16
    products; fp32 in the gradient test below) and its XLA path; two bags of
    one bucket, padded."""
    monkeypatch.setenv("RRTMIL_PALLAS_INTERPRET", "1")
    jcfg, tcfg = _cfgs(backend, mm)
    x, mask, length = _batch((200, 150), jcfg.encoder, seed=3)
    want = jax.jit(lambda p, a, m: JRRTMIL(jcfg).apply(
        {"params": p}, a, mask=m, length=length))(params, jnp.asarray(x),
                                                  jnp.asarray(mask))
    model = _port(tcfg, params).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x), mask=torch.from_numpy(mask),
                    length=length)
    _close(got, want, mm, "logits")


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_ffn_gradients_match_jax(params, backend, monkeypatch):
    """Every parameter gradient of a CE loss, the port's fused structure
    (K2, K4, K5 -> K6/K7, K11 and the FFN through autograd) against JAX's
    XLA path and its Pallas kernels' custom_vjps in interpret mode, fp32
    products."""
    monkeypatch.setenv("RRTMIL_PALLAS_INTERPRET", "1")
    jcfg, tcfg = _cfgs(backend)
    x, mask, length = _batch((200, 150), jcfg.encoder, seed=4)
    labels = np.array([1, 0])

    def loss(p):
        logits = JRRTMIL(jcfg).apply({"params": p}, jnp.asarray(x),
                                     mask=jnp.asarray(mask), length=length)
        logp = jax.nn.log_softmax(logits, -1)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(labels)[:, None],
                                             -1)), logits

    (jl, jlogits), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    model = _port(tcfg, params).train()
    calls = []
    for name in ("crmsa_redistribute_grid", "crmsa_redistribute_grid_ln"):
        def spy(*a, _orig=getattr(rrt, name), _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(rrt, name, spy)
    logits = model(torch.from_numpy(x), mask=torch.from_numpy(mask),
                   length=length, generator=torch.Generator())
    assert calls == ["crmsa_redistribute_grid"]
    _close(logits, jlogits, "float32", "logits")
    tl = torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels))
    tl.backward()
    assert abs(tl.item() - float(jl)) <= 1e-5
    want = flax_to_torch(jg)
    for name, p in model.named_parameters():
        if "pe_bias" in name:
            assert np.abs(p.grad.numpy() - want[name].numpy()).max() <= 1e-5
            continue
        _close(p.grad.numpy(), want[name].numpy(), "float32", name)


# ---------------------------------------------------------------------------
# DropPath and the routing of stochastic depth
# ---------------------------------------------------------------------------

def test_drop_path_semantics():
    x = torch.randn(64, 5, 3) + 3.0
    gen = torch.Generator().manual_seed(0)
    assert drop_path(x, 0.3, gen, False) is x          # eval: identity
    assert drop_path(x, 0.0, gen, True) is x           # rate 0: identity
    y = drop_path(x, 0.25, gen, True)
    kept = (y != 0).flatten(1)
    per_sample = kept.all(1) | (~kept).all(1)
    assert per_sample.all()                            # one draw per sample
    k = kept.all(1)
    assert 0 < k.sum() < 64
    torch.testing.assert_close(y[k], x[k] / 0.75)      # scaled by 1 / keep
    y2 = drop_path(x, 0.25, torch.Generator().manual_seed(0), True)
    assert torch.equal(y, y2)                          # from the generator
    with pytest.raises(ValueError, match="Generator"):
        drop_path(x, 0.25, None, True)


@pytest.mark.parametrize("ffn", [False, True])
def test_train_mode_drop_path_routes_outside_k1_and_k10(ffn, monkeypatch):
    """With drop_path > 0 in train mode, K1 runs with add_residual=False and
    the branch is dropped outside it (rrt.py:644-656); the CR-MSA layer runs
    K10 with add_residual=False, and the final LayerNorm runs outside,
    never in K8 (rrt.py:662-680,797-801).  In eval mode drop_path does
    nothing: K1 keeps its residual and the final LayerNorm rides K8 (or,
    with the FFN, K10 carries the residual and the LayerNorm follows the
    FFN)."""
    _, tcfg = _cfgs("xla")
    tcfg = dataclasses.replace(tcfg, encoder=dataclasses.replace(
        tcfg.encoder, drop_path=0.2, ffn=ffn))
    events = []
    for name in ("region_layer_fused", "crmsa_redistribute_grid",
                 "crmsa_redistribute_grid_ln", "_apply_final_ln",
                 "drop_path"):
        def spy(*a, _orig=getattr(rrt, name), _name=name, **k):
            events.append((_name, a))
            return _orig(*a, **k)
        monkeypatch.setattr(rrt, name, spy)
    model = RRTMIL(tcfg)
    x, mask, length = _batch((150,), tcfg.encoder, seed=9)
    x, mask = torch.from_numpy(x), torch.from_numpy(mask)
    with torch.no_grad():
        model.train()(x, mask=mask, length=length,
                      generator=torch.Generator().manual_seed(0))
    names = [n for n, _ in events]
    k1 = [a for n, a in events if n == "region_layer_fused"]
    k10 = [a for n, a in events if n == "crmsa_redistribute_grid"]
    assert len(k1) == 1 and k1[0][16] is False            # add_residual
    assert len(k10) == 1 and k10[0][6] is False
    assert "crmsa_redistribute_grid_ln" not in names
    assert names.count("_apply_final_ln") == 1
    assert names.count("drop_path") == (4 if ffn else 2)
    events.clear()
    with torch.no_grad():
        model.eval()(x, mask=mask, length=length)
    names = [n for n, _ in events]
    k1 = [a for n, a in events if n == "region_layer_fused"]
    assert k1[0][16] is True
    if ffn:
        k10 = [a for n, a in events if n == "crmsa_redistribute_grid"]
        assert len(k10) == 1 and k10[0][6] is True
        assert "crmsa_redistribute_grid_ln" not in names
        assert names.count("_apply_final_ln") == 1
    else:
        assert "crmsa_redistribute_grid" not in names
        assert "crmsa_redistribute_grid_ln" in names
        assert "_apply_final_ln" not in names
