"""The port's survival optimizers against the JAX package on the CPU: the
reference's RAdam ('radam', 'plainradam'), SGD with momentum 0.9 and
Lookahead(Adam) against `rrtmil_tpu.train.optim.make_optimizer` on the same
seeded parameters and gradients over 16 steps (past RAdam's N_sma >= 5
switch at step 6 and Lookahead's syncs at steps 6 and 12), the lr changing
every step; the golden torch trajectories of the reference optimizers
(tests/goldens/optim_trajectories.npz) at tests/test_optim_parity.py's
tolerances (rtol 2e-5, atol 2e-6); a state_dict round trip.

The JAX package's convention is p_new = p - lr * tx.update(g, state, p,
lr=lr); the port's optimizers read the lr from their param groups, where the
engines set it.  Both form RAdam's N_sma and rectification in float32;
the reference forms them in float64, 0.6% apart at steps 6-12, within the
golden trajectories' tolerance.
"""
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rrtmil_tpu.train import optim as joptim
from rrtmil_tpu_torch.train import optim

GOLDEN = "tests/goldens/optim_trajectories.npz"
RTOL, ATOL = 2e-5, 2e-6
STEPS = 16
SHAPES = {"b": (3,), "w": (4, 3)}


def _stream(seed=0):
    rng = np.random.default_rng(seed)
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    lrs = [1e-2 * (1.0 + 0.5 * float(np.sin(t))) for t in range(STEPS)]
    return init, grads, lrs


def _port(name, init, wd):
    params = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in init.items()}
    return params, optim.make_optimizer(name, list(params.values()), 1e-3, wd)


def _step(opt, params, grads, lr):
    for group in opt.param_groups:
        group["lr"] = lr
    for k, p in params.items():
        p.grad = torch.tensor(grads[k])
    opt.step()
    opt.zero_grad(set_to_none=True)


@pytest.mark.parametrize("name", ["radam", "plainradam", "sgd", "lookahead"])
def test_optimizers_match_jax(name):
    init, grads, lrs = _stream()
    wd = 1e-2
    tx = joptim.make_optimizer(name, weight_decay=wd)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    params, opt = _port(name, init, wd)
    for t in range(STEPS):
        lr = jnp.float32(lrs[t])
        upd, state = tx.update({k: jnp.asarray(v) for k, v in grads[t].items()},
                               state, jparams, lr=lr)
        jparams = jax.tree.map(lambda p, u: p - lr * u, jparams, upd)
        _step(opt, params, grads[t], lrs[t])
        for k in SHAPES:
            np.testing.assert_allclose(
                params[k].detach().numpy(), np.asarray(jparams[k]),
                rtol=RTOL, atol=ATOL, err_msg=f"{name} step {t + 1} {k}")


@pytest.mark.parametrize("name,golden", [("radam", "radam"),
                                         ("plainradam", "radam"),
                                         ("lookahead", "lookahead")])
def test_golden_trajectories(name, golden):
    data = np.load(GOLDEN)
    lr = float(data["lr"])
    params, opt = _port(name, {k: data[f"{golden}_init_{k}"] for k in SHAPES},
                        float(data["wd"]))
    for t in range(int(data["steps"])):
        _step(opt, params, {k: data[f"{golden}_grads_{k}"][t]
                            for k in SHAPES}, lr)
        for k in SHAPES:
            np.testing.assert_allclose(
                params[k].detach().numpy(), data[f"{golden}_traj_{k}"][t],
                rtol=RTOL, atol=ATOL, err_msg=f"{name} step {t + 1} {k}")


def test_sgd_first_step_uses_the_gradient_as_its_buffer():
    """JAX's trace(0.9) starts from zeros, so its first buffer is the
    (decayed) gradient itself, as torch's SGD with dampening 0."""
    init, grads, _ = _stream(1)
    params, opt = _port("sgd", init, 1e-2)
    _step(opt, params, grads[0], 0.1)
    for k in SHAPES:
        want = init[k] - 0.1 * (grads[0][k] + 1e-2 * init[k])
        np.testing.assert_allclose(params[k].detach().numpy(), want,
                                   rtol=1e-6, atol=1e-7)


def test_lookahead_first_sync_only_seeds_the_slow_buffer():
    init, grads, _ = _stream(2)
    params, opt = _port("lookahead", init, 0.0)
    ref, inner = _port("adam", init, 0.0)
    for t in range(12):
        _step(opt, params, grads[t], 1e-2)
        _step(inner, ref, grads[t], 1e-2)
        if t < 11:              # through the first sync: Adam's weights
            for k in SHAPES:
                assert torch.equal(params[k], ref[k]), (t, k)
    assert opt.synced and opt.count == 0
    # the second sync pulled the weights halfway back to the slow buffer
    assert not torch.equal(params["w"], ref["w"])


@pytest.mark.parametrize("name", ["radam", "plainradam", "sgd", "lookahead"])
def test_state_dict_round_trip(name):
    """Eight steps, the optimizer's state_dict through torch.save /
    torch.load(weights_only=True) into a fresh optimizer on a copy of the
    weights, then eight more steps on both: the same bits."""
    init, grads, lrs = _stream(3)
    params, opt = _port(name, init, 1e-2)
    for t in range(8):
        _step(opt, params, grads[t], lrs[t])
    buf = io.BytesIO()
    torch.save(opt.state_dict(), buf)
    buf.seek(0)
    params2, opt2 = _port(name, {k: p.detach().numpy().copy()
                                 for k, p in params.items()}, 1e-2)
    opt2.load_state_dict(torch.load(buf, weights_only=True))
    for t in range(8, STEPS):
        _step(opt, params, grads[t], lrs[t])
        _step(opt2, params2, grads[t], lrs[t])
    for k in SHAPES:
        assert torch.equal(params[k], params2[k]), k
