"""The port's c16_r50 model and Engine.evaluate against the JAX package, with
the weights carried by convert.py.

JAX's RRTMIL hard-codes its 512-wide patch embedding (rrt.py:850), so the
encoder stays 512 wide with 8 heads of 64 in every case; the reduced cases
cut the input width to 64 and the bags to a few hundred patches.  Every bag
is masked and bucket-padded as the engines pad it.

Tolerances on max|port - jax| over max(1, max|jax|):
  * mm float32: 1e-4 -- the same fp32 arithmetic, summed in another order;
  * mm bfloat16 (the JAX kernels' default): 2e-2 -- the same bf16 rounding
    points, with sums that land near a rounding boundary rounding the other
    way.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rrtmil_tpu.config import c16_r50 as jax_c16_r50
from rrtmil_tpu.data.bucketing import bucket_for as jax_bucket_for
from rrtmil_tpu.data.datasets import ArrayDataset as JArrayDataset
from rrtmil_tpu.models.rrt import RRTMIL as JRRTMIL
from rrtmil_tpu.train.engine import Engine as JEngine
from rrtmil_tpu.train.engine import EngineConfig as JEngineConfig
from rrtmil_tpu_torch.config import c16_r50
from rrtmil_tpu_torch.convert import flax_to_torch
from rrtmil_tpu_torch.data.datasets import ArrayDataset
from rrtmil_tpu_torch.models.rrt import RRTMIL
from rrtmil_tpu_torch.train.engine import Engine, EngineConfig

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _cfgs(input_dim, backend, mm, port_backend=None, compute="float32"):
    """(jax config, port config) of c16_r50 with the given knobs."""
    def one(fn, be):
        cfg = fn()
        enc = dataclasses.replace(cfg.encoder, backend=be, mm_dtype=mm,
                                  compute_dtype=compute)
        return dataclasses.replace(cfg, input_dim=input_dim, encoder=enc)
    return one(jax_c16_r50, backend), one(c16_r50, port_backend or backend)


_PARAMS = {}


def _params(jcfg, seed=0):
    """Flax params of the config's shapes.  Backend and mm dtype do not
    change the tree, and the input width changes only patch_to_emb's kernel,
    so one init per seed serves all: another width gets a seeded xavier-
    normal kernel in its place."""
    if seed not in _PARAMS:
        cfg = dataclasses.replace(jcfg, input_dim=64, encoder=dataclasses
                                  .replace(jcfg.encoder, backend="xla"))
        model = JRRTMIL(cfg)
        x = jnp.zeros((1, 64, 64), jnp.float32)
        _PARAMS[seed] = jax.jit(lambda k: model.init(
            {"params": k}, x, length=64))(jax.random.PRNGKey(seed))["params"]
    params = _PARAMS[seed]
    d = jcfg.input_dim
    if d == 64:
        return params
    rng = np.random.default_rng(seed)
    kernel = rng.standard_normal((d, 512)) * np.sqrt(2.0 / (d + 512))
    emb = dict(params["patch_to_emb"], kernel=jnp.asarray(kernel, jnp.float32))
    return {**params, "patch_to_emb": emb}


def _batch(lengths, input_dim, enc, seed):
    spec = jax_bucket_for(max(lengths), enc)
    rng = np.random.default_rng(seed)
    x = np.zeros((len(lengths), spec.data_length, input_dim), np.float32)
    mask = np.zeros((len(lengths), spec.data_length), bool)
    for i, n in enumerate(lengths):
        x[i, :n] = rng.standard_normal((n, input_dim))
        mask[i, :n] = True
    return x, mask, spec.repr_length


def _jax_logits(jcfg, params, x, mask, length, interpret):
    """JAX logits, jitted (one compile is cheaper than op-by-op dispatch);
    mask None runs the JAX model unmasked."""
    model = JRRTMIL(jcfg)
    old = os.environ.get("RRTMIL_PALLAS_INTERPRET")
    os.environ["RRTMIL_PALLAS_INTERPRET"] = "1" if interpret else "0"
    try:
        fn = jax.jit(lambda p, x, m: model.apply(
            {"params": p}, x, mask=m, length=length, deterministic=True))
        out = fn(params, jnp.asarray(x),
                 None if mask is None else jnp.asarray(mask))
    finally:
        if old is None:
            os.environ.pop("RRTMIL_PALLAS_INTERPRET")
        else:
            os.environ["RRTMIL_PALLAS_INTERPRET"] = old
    return np.asarray(out)


def _port_logits(tcfg, params, x, mask, length):
    model = RRTMIL(tcfg).eval()
    model.load_state_dict(flax_to_torch(params))
    with torch.no_grad():
        return model(torch.from_numpy(x),
                     mask=None if mask is None else torch.from_numpy(mask),
                     length=length).numpy()


def _close(got, want, mm):
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= TOL[mm], f"{mm}: scaled error {err:.3e}"


# (bag lengths, input width, JAX backend, mm dtype, port backend, stream
# dtype):
#   pallas -- JAX's fused kernels in interpret mode vs the port's fused
#             structure (the kernels' plain versions);
#   xla    -- JAX's unfused XLA path vs the port's unfused structure, or
#             vs the port's fused structure (port backend 'auto').
CASES = [
    ((200, 150), 64, "pallas", "float32", None, "float32"),
    ((937,), 64, "pallas", "bfloat16", None, "float32"),
    ((200,), 64, "pallas", "bfloat16", None, "bfloat16"),   # --amp
    ((937, 700), 64, "xla", "float32", None, "float32"),
    ((200,), 64, "xla", "float32", "auto", "float32"),
    ((200,), 1024, "xla", "float32", "auto", "float32"),    # full width
]


@pytest.mark.parametrize("lengths,input_dim,backend,mm,port_backend,stream",
                         CASES)
def test_rrtmil_logits_match_jax(lengths, input_dim, backend, mm,
                                 port_backend, stream):
    jcfg, tcfg = _cfgs(input_dim, backend, mm, port_backend, stream)
    params = _params(jcfg)
    x, mask, length = _batch(lengths, input_dim, jcfg.encoder, seed=len(CASES))
    want = _jax_logits(jcfg, params, x, mask, length,
                       interpret=backend == "pallas")
    got = _port_logits(tcfg, params, x, mask, length)
    _close(got, want, mm)


def test_fused_path_calls_each_kernel_wrapper_once(monkeypatch):
    """The fused structure runs K1 -> K3 -> K5 -> K8, once each."""
    _, tcfg = _cfgs(64, "auto", "float32")
    import rrtmil_tpu_torch.models.rrt as rrt
    calls = []
    for name in ("region_layer_fused", "crmsa_compress_grid",
                 "region_block_fused", "crmsa_redistribute_grid_ln"):
        def spy(*a, _orig=getattr(rrt, name), _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(rrt, name, spy)
    model = RRTMIL(tcfg).eval()
    x, mask, length = _batch((150,), 64, tcfg.encoder, seed=0)
    with torch.no_grad():
        model(torch.from_numpy(x), mask=torch.from_numpy(mask), length=length)
    assert calls == ["region_layer_fused", "crmsa_compress_grid",
                     "region_block_fused", "crmsa_redistribute_grid_ln"]


@pytest.mark.parametrize("backend,mm,want", [
    ("xla", "bfloat16", torch.float32), ("xla", "float32", torch.float32),
    ("auto", "bfloat16", torch.bfloat16), ("pallas", "float32", torch.float32)])
def test_products_dtype_follows_the_backend(monkeypatch, backend, mm, want):
    """Backend 'xla' rounds no product (the JAX package's XLA formulation),
    so its kernels get float32 products on either device, whatever
    mm_dtype says; the fused backends get mm_dtype.  The unfused CR-MSA
    hands K12 and K13 that dtype."""
    import rrtmil_tpu_torch.models.rrt as rrt
    _, tcfg = _cfgs(64, backend, mm)
    assert rrt.products_dtype(tcfg.encoder.crmsa_layer().crmsa.attn) == want
    assert rrt.products_dtype(tcfg.encoder.rmsa_layer().rmsa.attn) == want
    seen = []
    for name in ("crmsa_compress", "crmsa_redistribute"):
        def spy(*a, _orig=getattr(rrt, name), **k):
            seen.append(a[-1])
            return _orig(*a, **k)
        monkeypatch.setattr(rrt, name, spy)
    x, _, _ = _batch((150,), 64, tcfg.encoder, seed=0)
    with torch.no_grad():
        RRTMIL(tcfg).eval()(torch.from_numpy(x[:, :150]))   # unfused CR-MSA
    assert seen == [want, want]


def test_unmasked_input_matches_jax():
    """Called without a mask, both models run the unfused structure on the
    unpadded bag (the encoder pads inside each layer); the port's
    InnerAttention runs K5's plain version there."""
    jcfg, tcfg = _cfgs(64, "xla", "float32", "auto")
    params = _params(jcfg)
    x, _, _ = _batch((150,), 64, jcfg.encoder, seed=1)
    x = x[:, :150]
    want = _jax_logits(jcfg, params, x, None, None, interpret=False)
    got = _port_logits(tcfg, params, x, None, None)
    _close(got, want, "float32")


def test_engine_evaluate_matches_jax():
    """Engine.evaluate (bucketed batches of 2) on an ArrayDataset: the
    probabilities and the mean loss against the JAX Engine."""
    jcfg, tcfg = _cfgs(64, "xla", "float32", "auto")
    params = _params(jcfg, seed=1)
    rng = np.random.default_rng(7)
    lengths = (37, 150, 60, 200, 90)
    bags = [rng.standard_normal((n, 64)).astype(np.float32) for n in lengths]
    labels = [0, 1, 1, 0, 1]
    jeng = JEngine(JRRTMIL(jcfg), JEngineConfig(batch_size=2, num_workers=0),
                   jcfg.encoder)
    jp, jl, jloss = jeng.evaluate(params, JArrayDataset(bags, labels))
    model = RRTMIL(tcfg)
    model.load_state_dict(flax_to_torch(params))
    eng = Engine(model, EngineConfig(batch_size=2), tcfg.encoder,
                 device="cpu")
    tp, tl, tloss = eng.evaluate(ArrayDataset(bags, labels))
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(tp, jp, rtol=1e-4, atol=1e-5)
    assert abs(tloss - jloss) <= 1e-4 * max(1.0, abs(jloss))
