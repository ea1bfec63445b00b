"""The gated attention pooling (RRT-MIL with PoolConfig(gated=True)), the
pooling scorers' dropout, and the top-k SVM family (CLAM's smooth top-1
instance loss with its per-sample hard / smooth switch, the hard and smooth
top-k losses over the log-space ESP DP) against the JAX package on the
CPU: values and gradients within 1e-4 of max(1, max|jax|) (the helpers of
tests/test_torch_zoo.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rrtmil_tpu.config import c16_r50 as jax_c16_r50
from rrtmil_tpu.models.rrt import RRTMIL as JRRTMIL
from rrtmil_tpu.train import losses as jlosses
from rrtmil_tpu_torch.config import PoolConfig, c16_r50
from rrtmil_tpu_torch.convert import flax_to_torch, torch_to_flax
from rrtmil_tpu_torch.models.rrt import RRTMIL, init_parameters
from rrtmil_tpu_torch.train import losses

from test_torch_zoo import D_IN, bag, close, total_loss


# -- RRT-MIL with the gated pooling --------------------------------------------

def test_rrtmil_gated_pooling_matches_jax():
    """RRT-MIL with PoolConfig(gated=True) (the port's DAttention raised on
    it before): logits and every gradient, c16_r50 at input 24, fp32
    products."""
    def cfg(fn, backend):
        c = fn()
        return dataclasses.replace(
            c, input_dim=D_IN, dropout=0.0,
            pool=dataclasses.replace(c.pool, gated=True),
            encoder=dataclasses.replace(c.encoder, backend=backend,
                                        mm_dtype="float32", dropout=0.0))
    jcfg, tcfg = cfg(jax_c16_r50, "xla"), cfg(c16_r50, "auto")
    assert isinstance(tcfg.pool, PoolConfig) and tcfg.pool.gated
    model = RRTMIL(tcfg)
    init_parameters(model, torch.Generator().manual_seed(7))
    params = jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))
    assert "attention_a" in params["pool_fn"]["attention"]
    x, mask, length = bag(150, seed=4)
    jm = JRRTMIL(jcfg)
    lab = jnp.asarray([1])

    def jloss(p):
        lg = jm.apply({"params": p}, jnp.asarray(x), mask=jnp.asarray(mask),
                      length=length, deterministic=True)
        return total_loss("rrtmil", lg, lab, "jax")

    want_loss, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    loss = total_loss("rrtmil", model(torch.from_numpy(x),
                                      mask=torch.from_numpy(mask),
                                      length=length),
                      torch.tensor([1]), "torch")
    close(loss.item(), want_loss, "loss")
    loss.backward()
    want = flax_to_torch(jgrads)
    for pname, p in model.named_parameters():
        if "pe_bias" in pname or pname.endswith("qkv.bias"):
            continue             # zero in exact arithmetic: rounding noise
        close(p.grad.numpy(), want[pname], pname)


def test_scorer_dropout_draws_from_the_generator():
    """The pooling scorers' dropout (p = 0.25) in train mode: masks from the
    caller's generator, identical for one seed, none in eval mode."""
    from rrtmil_tpu_torch.models.pool import DAttention
    for gated in (False, True):
        pool = DAttention(32, gated=gated, dropout=True).train()
        x = torch.randn(1, 50, 32)
        a = pool(x, generator=torch.Generator().manual_seed(1))
        b = pool(x, generator=torch.Generator().manual_seed(1))
        c = pool(x, generator=torch.Generator().manual_seed(2))
        assert torch.equal(a, b) and not torch.equal(a, c)
        with pytest.raises(ValueError, match="generator"):
            pool(x)
        assert torch.equal(pool.eval()(x), pool(x))


# -- the top-k SVM family -------------------------------------------------------

def _svm_inputs(seed, n=13, c=6, spread=1.0):
    rng = np.random.default_rng(seed)
    s = (rng.standard_normal((n, c)) * spread).astype(np.float32)
    return s, rng.integers(0, c, n)


@pytest.mark.parametrize("fn,kw", [
    ("smooth_top1_svm", {}), ("smooth_top1_svm", {"alpha": 0.5, "tau": 2.0}),
    ("max_top1_svm", {}), ("max_topk_svm", {"k": 3}),
    ("smooth_topk_svm", {"k": 2}), ("smooth_topk_svm", {"k": 3, "tau": 0.5})])
def test_svm_losses_and_gradients_match_jax(fn, kw):
    """Values and gradients on random scores (every sample smooth) and on
    scores with a sample past the hard / smooth switch (a top-1 lead of
    1e3-scale, and for top-k a k-th to (k+1)-th gap past k tau log 1e3)."""
    s, y = _svm_inputs(0)
    big = s.copy()
    big[0, 2] += 60.0          # top-1 lead > log(1e3): the hard form
    big[1, :3] += 200.0        # top-3 lead: hard for every k <= 3
    for scores in (s, big):
        want, jg = jax.jit(jax.value_and_grad(
            lambda v: getattr(jlosses, fn)(v, jnp.asarray(y), **kw)))(
                jnp.asarray(scores))
        t = torch.tensor(scores, requires_grad=True)
        got = getattr(losses, fn)(t, torch.from_numpy(y), **kw)
        got.backward()
        close(got.item(), want, fn)
        close(t.grad.numpy(), jg, f"{fn} grad")


def test_smooth_top1_switch_is_per_sample():
    """One sample past the threshold takes the hard hinge, the others the
    smooth form, as JAX's `jnp.where` takes them."""
    s = np.array([[0.0, 7.5], [0.0, 1.0], [3.0, 0.0]], np.float32)
    y = np.array([1, 1, 0])
    t = torch.from_numpy(s)
    hard = (t + losses._delta(t, torch.from_numpy(y), 1.0)).max(1).values \
        - t.gather(1, torch.from_numpy(y)[:, None])[:, 0]
    smooth = torch.logsumexp(t + losses._delta(t, torch.from_numpy(y), 1.0),
                             1) - t.gather(1, torch.from_numpy(y)[:, None])[:, 0]
    want = (hard[0] + smooth[1] + smooth[2]) / 3
    got = losses.smooth_top1_svm(t, torch.from_numpy(y))
    assert torch.allclose(got, want, atol=0, rtol=1e-6)
    close(got.item(), jlosses.smooth_top1_svm(jnp.asarray(s), jnp.asarray(y)),
          "switch")


def test_log_esp_matches_jax():
    x = np.random.default_rng(2).standard_normal((4, 7)).astype(np.float32)
    close(losses.log_esp(torch.from_numpy(x), 4).numpy(),
          jlosses.log_esp(jnp.asarray(x), 4), "log_esp")
