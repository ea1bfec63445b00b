"""The EPEG ablations, attention-probability dropout and the pooling kinds
against the JAX package on the CPU.

InnerAttention (dim 32, 2 heads of 16, regions of 25 tokens, EPEG k = 5)
with each EPEG variant: 'attn' 1-D and 2-D, 'value_bf' and 'value_af' each
1-D and 2-D, an unknown kind (no positional term, no taps, as in JAX), and
no EPEG; then a whole RRTMIL (input 32, c16_r50's encoder at dim 512, 8 x
64 heads, k = 15) with each ablation on a bag of 600 patches (regions of
16 tokens).  The port runs its 'auto' backend with float32 products (K5's
plain version where JAX's `fusable` holds, the XLA formulation as torch
ops elsewhere), the JAX package its XLA path.  Output and every gradient
within 1e-4 of max(1, max|jax|).

Attention dropout: at rate 0 train mode gives eval's bits; one generator
state gives the same bits twice; given the keep-mask the port drew, the
output and gradients equal the JAX module's with flax's Dropout handed
that mask.  The converter maps each tap layout to the port's and back
exactly.  A `pool.kind` other than 'attn' is the masked mean on both sides.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.linen import stochastic

from rrtmil_tpu.config import EPEGConfig as JEPEG
from rrtmil_tpu.config import InnerAttentionConfig as JInnerCfg
from rrtmil_tpu.config import PoolConfig as JPool
from rrtmil_tpu.config import c16_r50 as jax_c16_r50
from rrtmil_tpu.data.bucketing import bucket_for
from rrtmil_tpu.models.rrt import InnerAttention as JInnerAttention
from rrtmil_tpu.models.rrt import RRTMIL as JRRTMIL
from rrtmil_tpu_torch.config import EPEGConfig, InnerAttentionConfig, \
    PoolConfig, c16_r50
from rrtmil_tpu_torch.convert import flax_to_torch, torch_to_flax
from rrtmil_tpu_torch.models.rrt import (RRTMIL, InnerAttention,
                                         fused_layer_ok, fusable,
                                         init_parameters)
from rrtmil_tpu_torch.ops import epeg

TOL = 1e-4
# (tag, EPEG fields or None for no EPEG)
VARIANTS = [
    ("attn", dict(kind="attn")),
    ("attn_2d", dict(kind="attn", two_d=True)),
    ("value_bf", dict(kind="value_bf")),
    ("value_bf_2d", dict(kind="value_bf", two_d=True)),
    ("value_af", dict(kind="value_af")),
    ("value_af_2d", dict(kind="value_af", two_d=True)),
    ("value_af_nobias", dict(kind="value_af", bias=False)),
    ("unknown_kind", dict(kind="value_mid")),
    ("off", None),
]
ABLATIONS = [("value_bf", dict(epeg_type="value_bf")),
             ("value_af", dict(epeg_type="value_af")),
             ("attn_2d", dict(epeg_2d=True)),
             ("value_af_2d", dict(epeg_type="value_af", epeg_2d=True)),
             ("unknown_kind", dict(epeg_type="value_mid"))]


def close(got, want, what, tol=TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(1.0, float(np.abs(want).max()))
    assert err <= tol, f"{what}: scaled error {err:.3e}"


def inner_cfgs(fields, attn_dropout=0.0):
    kw = dict(dim=32, num_heads=2, head_dim=16, attn_dropout=attn_dropout,
              mm_dtype="float32")
    ep = (dict(enabled=False) if fields is None
          else dict(enabled=True, k=5, **fields))
    return (InnerAttentionConfig(epeg=EPEGConfig(**ep), backend="auto", **kw),
            JInnerCfg(epeg=JEPEG(**ep), backend="xla", **kw))


def seeded(module, seed):
    init_parameters(module, torch.Generator().manual_seed(seed))
    return module


def jax_params(module):
    return jax.tree.map(jnp.asarray, torch_to_flax(module.state_dict()))


def check_grads(module, want_grads, x_grad, jdx):
    close(x_grad, jdx, "dx")
    want = flax_to_torch(want_grads)
    assert sorted(want) == sorted(n for n, _ in module.named_parameters())
    for name, p in module.named_parameters():
        close(p.grad.numpy(), want[name].numpy(), f"{name} grad")


def inner_case(cfg, jcfg, seed, train=False, generator=None, rng=None):
    """Port InnerAttention vs JAX on (3, 25, 32): output and gradients of
    sum(out * w); `rng` is the JAX dropout key of a train-mode run."""
    model = seeded(InnerAttention(cfg), seed)
    model.train(train)
    jmodel = JInnerAttention(jcfg)
    params = jax_params(model)
    jshapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((3, 25, 32))))["params"]
    assert jax.tree.map(np.shape, params) == jax.tree.map(
        lambda a: a.shape, jshapes)
    r = np.random.default_rng(seed + 1)
    x = r.standard_normal((3, 25, 32)).astype(np.float32)
    w = r.standard_normal((3, 25, 32)).astype(np.float32)

    def jloss(p, xx):
        out = jmodel.apply({"params": p}, xx, deterministic=not train,
                           rngs=None if rng is None else {"dropout": rng})
        return jnp.sum(out * w), out

    (_, jout), (jgrads, jdx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = model(xt, generator)
    close(out.detach().numpy(), jout, "output")
    (out * torch.from_numpy(w)).sum().backward()
    check_grads(model, jgrads, xt.grad.numpy(), jdx)
    return model


@pytest.mark.parametrize("tag,fields", VARIANTS, ids=[v[0] for v in VARIANTS])
def test_inner_attention_matches_jax(tag, fields):
    cfg, jcfg = inner_cfgs(fields)
    model = inner_case(cfg, jcfg, seed=len(tag))
    has_taps = fields is not None and fields["kind"] != "value_mid"
    assert (model.pe_weight is not None) == has_taps
    assert fusable(cfg) == (tag in ("attn", "off"))


def _models(fields, pool=None):
    """(port RRTMIL, JAX RRTMIL) at input 32 with c16_r50's encoder and
    `fields`, dropout 0, float32 products; the port's seeded weights."""
    base, jbase = c16_r50(), jax_c16_r50()
    kw = dict(dropout=0.0, mm_dtype="float32", **fields)
    cfg = dataclasses.replace(
        base, input_dim=32, dropout=0.0,
        encoder=dataclasses.replace(base.encoder, backend="auto", **kw),
        pool=PoolConfig(**pool) if pool else base.pool)
    jcfg = dataclasses.replace(
        jbase, input_dim=32, dropout=0.0,
        encoder=dataclasses.replace(jbase.encoder, backend="xla", **kw),
        pool=JPool(**pool) if pool else jbase.pool)
    return seeded(RRTMIL(cfg), 3), JRRTMIL(jcfg), jcfg


def _bag(n, jcfg, seed):
    spec = bucket_for(n, jcfg.encoder)
    r = np.random.default_rng(seed)
    x = np.zeros((1, spec.data_length, 32), np.float32)
    x[0, :n] = r.standard_normal((n, 32))
    mask = np.zeros((1, spec.data_length), bool)
    mask[0, :n] = True
    return x, mask, spec.repr_length


def model_case(fields, pool=None, n=600):
    model, jmodel, jcfg = _models(fields, pool)
    params = jax_params(model)
    x, mask, length = _bag(n, jcfg, 4)
    jshapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(x), mask=jnp.asarray(mask),
        length=length))["params"]
    assert jax.tree.map(np.shape, params) == jax.tree.map(
        lambda a: a.shape, jshapes)

    def jloss(p, xx):
        out = jmodel.apply({"params": p}, xx, mask=jnp.asarray(mask),
                           length=length, deterministic=True)
        return jnp.sum(out * jnp.arange(1.0, 3.0)), out

    (_, jout), (jgrads, jdx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = model(xt, mask=torch.from_numpy(mask), length=length)
    close(out.detach().numpy(), jout, "logits")
    (out * torch.arange(1.0, 3.0)).sum().backward()
    check_grads(model, jgrads, xt.grad.numpy(), jdx)
    return model, x, mask, length


@pytest.mark.parametrize("tag,fields", ABLATIONS, ids=[a[0] for a in ABLATIONS])
def test_rrtmil_ablation_matches_jax(tag, fields):
    """The whole model; its R-MSA layer leaves K1 (`fused_layer_ok` is
    JAX's gate), its CR-MSA layer keeps K3 -> K5 -> K8."""
    model, x, mask, length = model_case(fields)
    layer = model.online_encoder.layer0
    assert not fused_layer_ok(layer.cfg, torch.from_numpy(x), mask, length)
    cr = model.online_encoder.cr_msa.attn.attn
    assert cr.pe_weight is None and fusable(cr.cfg)


@pytest.mark.parametrize("kind", ["avg", "max"])
def test_non_attn_pooling_is_the_masked_mean(kind):
    """JAX's RRTMIL takes any pool kind but 'attn' as MeanPool."""
    model, *_ = model_case({}, pool=dict(kind=kind), n=150)
    assert type(model.pool_fn).__name__ == "MeanPool"


@pytest.mark.parametrize("tag,fields", VARIANTS[:-2],
                         ids=[v[0] for v in VARIANTS[:-2]])
def test_converter_maps_every_tap_layout_both_ways(tag, fields):
    cfg, jcfg = inner_cfgs(fields)
    model = seeded(InnerAttention(cfg), 1)
    ch = 2 if fields["kind"] == "attn" else 32
    kw = 5 if fields.get("two_d") else 1
    tree = torch_to_flax(model.state_dict())
    assert tree["pe_kernel"].shape == (5, kw, 1, ch)
    want = (ch, 5) if kw == 1 else (ch, 5, 5)
    assert tuple(model.pe_weight.shape) == want
    # tap (i, j) of channel c is the kernel's [i, j, 0, c] on both sides
    np.testing.assert_array_equal(
        tree["pe_kernel"][:, :, 0, :],
        epeg.taps_2d(model.pe_weight.detach()).permute(1, 2, 0).numpy())
    back = flax_to_torch(tree)
    for name, t in model.state_dict().items():
        assert torch.equal(back[name], t), name


def test_dropout_rate_zero_and_the_same_generator():
    """Rate 0 in train mode gives eval's bits; a positive rate draws its
    mask from the generator: one state gives the same bits twice, another
    state other bits."""
    cfg, _ = inner_cfgs(dict(kind="value_af"))
    model = seeded(InnerAttention(cfg), 2)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 25, 32)).astype(np.float32))
    with torch.no_grad():
        want = model.eval()(x)
        got = model.train()(x, torch.Generator().manual_seed(5))
        assert torch.equal(got, want)
        cfg2, _ = inner_cfgs(dict(kind="value_af"), attn_dropout=0.3)
        drop = InnerAttention(cfg2)
        drop.load_state_dict(model.state_dict())
        drop.train()
        a = drop(x, torch.Generator().manual_seed(5))
        b = drop(x, torch.Generator().manual_seed(5))
        c = drop(x, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not fusable(cfg2)
    with pytest.raises(ValueError, match="generator"):
        drop(x)


@pytest.mark.parametrize("tag,fields", [("attn", dict(kind="attn")),
                                        ("value_bf", dict(kind="value_bf"))])
def test_dropout_keep_mask_matches_jax_given_the_mask(tag, fields,
                                                      monkeypatch):
    """Train mode at rate 0.3: the port's mask, drawn again from a copy of
    its generator, handed to flax's Dropout; output and gradients equal.
    (The 1-D 'attn' kind with dropout is not `fusable`, so it too takes the
    XLA formulation.)"""
    cfg, jcfg = inner_cfgs(fields, attn_dropout=0.3)
    g = torch.Generator().manual_seed(11)
    mask = torch.empty((3, 2, 25, 25)).bernoulli_(
        0.7, generator=torch.Generator().set_state(g.get_state()))
    monkeypatch.setattr(stochastic, "random", types.SimpleNamespace(
        bernoulli=lambda rng, p, shape: jnp.asarray(mask.bool().numpy())))
    inner_case(cfg, jcfg, seed=7, train=True, generator=g,
               rng=jax.random.PRNGKey(0))


def test_value_pe_channel_order():
    """The value image's channel c is d * h + head: a tap set that is the
    identity on one channel moves exactly that (head, d) entry."""
    b_, h, n, hd = 1, 2, 9, 3
    v = torch.arange(b_ * h * n * hd, dtype=torch.float32).reshape(
        b_, h, n, hd)
    w = torch.zeros(h * hd, 3)
    d, head = 2, 1
    w[d * h + head, 1] = 1.0                    # centre tap, channel d*h+head
    pe = epeg.value_pe(v, w, None)
    flat = epeg.value_pe(v, w, None, flat=True)
    c = d * h + head
    # value_bf reads channel c back as (c // hd, c % hd); value_af adds it
    # onto column c of the (head * hd + d) output
    want = torch.zeros_like(v)
    want[:, c // hd, :, c % hd] = v[:, head, :, d]
    assert torch.equal(pe, want)
    assert torch.equal(flat[..., c], v[:, head, :, d])
    assert flat.abs().sum() == v[:, head, :, d].abs().sum()
    with pytest.raises(ValueError, match="square"):
        epeg.value_pe(v[:, :, :8], w, None)
