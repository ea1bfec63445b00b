"""The port's training path against the JAX package on the CPU: every
parameter gradient of the c16_r50 model, three `Engine.train_epoch` steps,
the schedules, clipping and accumulation, and where dropout falls.

The port's fused structure runs the kernels' plain versions in both
directions on the CPU (K1/K2, K3/K4, K5 via K6/K7, K8/K9); the JAX model
runs its XLA path with fp32 products, the weights carried by convert.py.
JAX's RRTMIL hard-codes its 512-wide patch embedding (rrt.py:850), so the
encoder stays 512 wide with 8 heads of 64; the input width is cut to 64 and
the bags to a few hundred patches, masked and bucket-padded.

Tolerances: gradients and parameters within rtol 1e-4 / atol 1e-5 after
scaling both by max(1, max|jax|) (the same fp32 arithmetic summed in another
order); losses within 1e-5 of max(1, |jax|), or 1e-4 once Adam steps have
run (see below: a few weights step the other way).  Two gradients are zero in
exact arithmetic, because a key-constant logit shift cancels in the softmax:
pe_bias's and the key third of each qkv bias.  Both sides give rounding
noise there, held in absolute terms only; in the train-step comparison those
parameters are left out, since Adam turns that noise into lr-sized steps of
either sign that cannot change a logit.  For the same reason a weight whose
gradient is itself at the noise level can step the other way: after n Adam
steps at rate lr, at most 1e-3 of a tensor's elements may miss the limit,
and none by more than 2 n lr x 1.01 (Adam's bias-corrected early steps stay
below 1.0034 lr).
"""
import dataclasses

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from rrtmil_tpu.config import c16_r50 as jax_c16_r50
from rrtmil_tpu.data.bucketing import bucket_for as jax_bucket_for
from rrtmil_tpu.data.datasets import ArrayDataset as JArrayDataset
from rrtmil_tpu.models.rrt import RRTMIL as JRRTMIL
from rrtmil_tpu.train import optim as joptim
from rrtmil_tpu.train.engine import Engine as JEngine
from rrtmil_tpu.train.engine import EngineConfig as JEngineConfig
from rrtmil_tpu.train.engine import TrainState
from rrtmil_tpu_torch.config import c16_r50
from rrtmil_tpu_torch.convert import flax_to_torch, torch_to_flax
from rrtmil_tpu_torch.data.datasets import ArrayDataset
from rrtmil_tpu_torch.models import rrt
from rrtmil_tpu_torch.models.rrt import RRTMIL, init_parameters
from rrtmil_tpu_torch.train import optim
from rrtmil_tpu_torch.train.engine import Engine, EngineConfig

D_IN = 64
ATOL_ONLY = ("pe_bias",)


def _cfgs(dropout=0.0):
    """(jax config, port config): c16_r50 at input width 64, fp32 products,
    the JAX model on its XLA path and the port on its fused structure."""
    def one(fn, backend):
        cfg = fn()
        enc = dataclasses.replace(cfg.encoder, backend=backend,
                                  mm_dtype="float32", dropout=dropout)
        return dataclasses.replace(cfg, input_dim=D_IN, dropout=dropout,
                                   encoder=enc)
    return one(jax_c16_r50, "xla"), one(c16_r50, "auto")


@pytest.fixture(scope="module")
def params():
    """A seeded c16_r50 init (the JAX package's distributions, as
    tests/test_torch_regions.py checks) as a flax param tree."""
    _, tcfg = _cfgs()
    model = RRTMIL(tcfg)
    init_parameters(model, torch.Generator().manual_seed(3))
    return jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))


def _port_model(tcfg, params):
    model = RRTMIL(tcfg)
    model.load_state_dict(flax_to_torch(params))
    return model


def _batch(lengths, enc, seed):
    spec = jax_bucket_for(max(lengths), enc)
    rng = np.random.default_rng(seed)
    x = np.zeros((len(lengths), spec.data_length, D_IN), np.float32)
    mask = np.zeros((len(lengths), spec.data_length), bool)
    for i, n in enumerate(lengths):
        x[i, :n] = rng.standard_normal((n, D_IN))
        mask[i, :n] = True
    return x, mask, spec.repr_length


def _close(got, want, name, rtol=1e-4, atol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    if any(k in name for k in ATOL_ONLY):
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)
        return
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=rtol,
                               atol=atol, err_msg=name)


def test_model_gradients_match_jax(params):
    """One batch of two bags, L = 937 and L = 200, padded to the 937 bucket
    (B = 1 runs in the train-step test)."""
    jcfg, tcfg = _cfgs()
    lengths = (937, 200)
    x, mask, length = _batch(lengths, jcfg.encoder, seed=2)
    labels = np.arange(len(lengths)) % 2
    jmodel = JRRTMIL(jcfg)

    def loss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x),
                              mask=jnp.asarray(mask), length=length,
                              deterministic=True)
        logp = jax.nn.log_softmax(logits, -1)
        return -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(labels)[:, None], -1))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(params)
    model = _port_model(tcfg, params).train()
    logits = model(torch.from_numpy(x), mask=torch.from_numpy(mask),
                   length=length)
    tloss = torch.nn.functional.cross_entropy(logits,
                                              torch.from_numpy(labels))
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= 1e-5
    want = flax_to_torch(jgrads)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        assert p.grad is not None, name
        _close(p.grad.numpy(), want[name].numpy(), name)


def test_three_train_steps_match_jax(params):
    """Engine.train_epoch over three bags of one bucket (batch size 1, a
    fixed order, dropout 0, Adam with L2 decay, the cosine schedule) against
    the JAX Engine from the same init: the mean loss and every parameter."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(11)
    bags = [rng.standard_normal((n, D_IN)).astype(np.float32)
            for n in (180, 200, 150)]
    labels = [1, 0, 1]
    kw = dict(batch_size=1, lr=1e-3, weight_decay=1e-5, lr_schedule="cosine",
              num_epochs=4)
    order = [2, 0, 1]
    eng = Engine(_port_model(tcfg, params), EngineConfig(**kw), tcfg.encoder,
                 device="cpu")
    params = jax.tree.map(jnp.array, params)     # the JAX step donates them
    jeng = JEngine(JRRTMIL(jcfg), JEngineConfig(num_workers=0, **kw),
                   jcfg.encoder)
    state = TrainState(params=params, opt_state=jeng.tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    state, jloss = jeng.train_epoch(state, JArrayDataset(bags, labels), 1,
                                    jax.random.PRNGKey(0), order=order)
    tloss = eng.train_epoch(ArrayDataset(bags, labels), 1, order=order)
    assert eng.global_iter == jeng.global_iter == 3
    assert abs(tloss - jloss) <= 1e-4 * max(1.0, abs(jloss)), (tloss, jloss)
    want = flax_to_torch(state.params)
    for name, p in eng.model.named_parameters():
        got, ref = p.detach().numpy(), want[name].numpy()
        if "pe_bias" in name:
            continue
        if name.endswith("qkv.bias"):                 # drop the key third
            third = got.shape[0] // 3
            got = np.concatenate([got[:third], got[2 * third:]])
            ref = np.concatenate([ref[:third], ref[2 * third:]])
        _close_adam(got, ref, name, kw["lr"], 3)


def _close_adam(got, ref, name, lr, steps, rtol=1e-4, atol=1e-5):
    scale = max(1.0, float(np.abs(ref).max()))
    diff = np.abs(got - ref) / scale
    miss = diff > atol + rtol * np.abs(ref) / scale
    assert miss.mean() <= 1e-3, f"{name}: {miss.sum()} of {miss.size} miss"
    assert diff.max() <= 2 * steps * lr * 1.01 / scale, \
        f"{name}: {diff.max():.3e}"


@pytest.mark.parametrize("schedule", ["cosine", "step", "const"])
def test_schedules_match_jax(schedule):
    for t in (0, 1, 7, 50, 99, 100, 130):
        assert optim.lr_at(schedule, 2e-4, t, 100) == \
            joptim.lr_at(schedule, 2e-4, t, 100)
    assert optim.cosine_lr(1e-3, 3, 10, 1e-5) == \
        joptim.cosine_lr(1e-3, 3, 10, 1e-5)
    assert optim.step_lr(1e-3, 6, 5.0, 0.1) == joptim.step_lr(1e-3, 6, 5.0, 0.1)
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.make_optimizer("nadam", [torch.zeros(1)], 1e-3)


class _JTiny(fnn.Module):
    """Masked mean pooling and a classifier: the engine's mechanics on a
    model with one cheap compile."""

    @fnn.compact
    def __call__(self, x, mask=None, length=None, deterministic=True):
        m = mask[..., None].astype(x.dtype)
        return fnn.Dense(2, name="fc")((x * m).sum(1) / m.sum(1))


class _TTiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(D_IN, 2)

    def forward(self, x, mask=None, length=None, generator=None):
        m = mask[..., None].to(x.dtype)
        return self.fc((x * m).sum(1) / m.sum(1))


@pytest.mark.parametrize("opt,acc,clip,supi", [("adam", 2, 0.05, False),
                                                ("adamw", 1, 0.0, True)])
def test_clip_accumulation_and_tail_window_match_jax(opt, acc, clip, supi):
    """Five bags, accumulation over 2 (two full windows and a one-bag tail
    window, each one update), global-norm clipping that bites, the cosine
    schedule per epoch or per iteration: losses and weights as the JAX
    Engine's."""
    rng = np.random.default_rng(5)
    bags = [(rng.standard_normal((n, D_IN)) + i % 2).astype(np.float32)
            for i, n in enumerate((30, 50, 40, 70, 20))]
    labels = [i % 2 for i in range(5)]
    kw = dict(opt=opt, lr=5e-2, weight_decay=1e-2, accumulation_steps=acc,
              clip_grad=clip, lr_supi=supi, num_epochs=3, batch_size=1,
              seed=4)
    jmodel = _JTiny()
    p = jmodel.init({"params": jax.random.PRNGKey(1)},
                    jnp.zeros((1, 8, D_IN)), mask=jnp.ones((1, 8), bool))
    p = p["params"]
    jeng = JEngine(jmodel, JEngineConfig(num_workers=0, **kw))
    state = TrainState(params=p, opt_state=jeng.tx.init(p),
                       step=jnp.zeros((), jnp.int32))
    model = _TTiny()
    model.load_state_dict(flax_to_torch(p))
    eng = Engine(model, EngineConfig(**kw), device="cpu")
    for epoch in range(2):
        state, jloss = jeng.train_epoch(state, JArrayDataset(bags, labels),
                                        epoch, jax.random.PRNGKey(0))
        tloss = eng.train_epoch(ArrayDataset(bags, labels), epoch)
        assert abs(tloss - jloss) <= 1e-5, (epoch, tloss, jloss)
    want = flax_to_torch(state.params)
    for name, t in model.named_parameters():
        _close(t.detach().numpy(), want[name].numpy(), name)


def test_train_mode_dropout_falls_outside_k1_and_after_k5(monkeypatch):
    """In train mode the R-MSA layer calls K1 without the residual and drops
    out its branch before adding it, K5's output is dropped out, and the
    patch embedding is dropped out before the mask (rrt.py:644-656,181-182,
    856); eval mode runs none of it.  Pad rows stay exact zeros."""
    _, tcfg = _cfgs(dropout=0.1)
    tcfg = dataclasses.replace(tcfg, dropout=0.25)
    events = []

    def spy(name, fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            events.append((name, a, out))
            return out
        monkeypatch.setattr(rrt, name, wrapped)

    for name in ("region_layer_fused", "region_block_fused", "dropout"):
        spy(name, getattr(rrt, name))
    model = RRTMIL(tcfg)
    x, mask, length = _batch((150,), tcfg.encoder, seed=9)
    x, mask = torch.from_numpy(x), torch.from_numpy(mask)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        ev = model.eval()(x, mask=mask, length=length)
        events.clear()
        tr = model.train()(x, mask=mask, length=length, generator=gen)
    drops = [(a[1], a[0]) for n, a, _ in events if n == "dropout"]
    k1 = [a for n, a, _ in events if n == "region_layer_fused"]
    k5 = [out for n, _, out in events if n == "region_block_fused"]
    assert len(k1) == 1 and k1[0][16] is False         # add_residual
    assert [p for p, _ in drops] == [0.25, 0.1, 0.1]
    assert drops[2][1] is k5[0]                         # after K5
    assert not torch.allclose(tr, ev) and torch.isfinite(tr).all()
    with pytest.raises(ValueError, match="Generator"):
        model(x, mask=mask, length=length)
    # stochastic depth in train mode runs (tests/test_torch_ffn.py checks
    # its routing through K1 and K10)
    deep = dataclasses.replace(tcfg, encoder=dataclasses.replace(
        tcfg.encoder, drop_path=0.1))
    with torch.no_grad():
        out = RRTMIL(deep).train()(x, mask=mask, length=length, generator=gen)
    assert torch.isfinite(out).all()
