"""The port's Nystrom attention against the JAX package's on the CPU: the
Newton pseudo-inverse, the forward with its front padding and landmark
means, the first-row attention map, and every gradient, at n in {1, 37,
256, 300} (no padding, padding of 219 and 255 rows, two tokens a
landmark).

Weights: the port's seeded init carried to the JAX module by convert.py;
inputs from a numpy seed.  Tolerance: max|port - jax| over max(1,
max|jax|) within 1e-4 for outputs and gradients.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rrtmil_tpu.config import NystromConfig as JNystromConfig
from rrtmil_tpu.models.nystrom import NystromAttention as JNystrom
from rrtmil_tpu.models.nystrom import moore_penrose_pinv as jpinv
from rrtmil_tpu_torch.config import NystromConfig
from rrtmil_tpu_torch.convert import flax_to_torch, torch_to_flax
from rrtmil_tpu_torch.models.nystrom import NystromAttention, \
    moore_penrose_pinv
from rrtmil_tpu_torch.models.rrt import init_parameters

TOL = 1e-4
DIM, HD, HEADS, LANDMARKS = 64, 16, 4, 256


def close(got, want, what, tol=TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max() / max(1.0, float(np.abs(want).max()))
    assert err <= tol, f"{what}: scaled error {err:.3e}"


def pair(seed=0, residual=True):
    kw = dict(dim=DIM, head_dim=HD, num_heads=HEADS,
              num_landmarks=LANDMARKS, residual=residual)
    model = NystromAttention(NystromConfig(**kw))
    init_parameters(model, torch.Generator().manual_seed(seed))
    params = jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))
    return model, JNystrom(JNystromConfig(**kw)), params


def test_pinv_matches_jax_with_one_scale_for_the_whole_tensor():
    """The starting scale takes max(col) * max(row) over every batch and
    head: scaling one head's matrix changes the others' results."""
    rng = np.random.default_rng(0)
    x = rng.random((2, 3, 16, 16)).astype(np.float32)
    x /= x.sum(-1, keepdims=True)
    close(moore_penrose_pinv(torch.from_numpy(x)).numpy(),
          jpinv(jnp.asarray(x)), "pinv")
    y = x.copy()
    y[1, 2] *= 4.0
    a = moore_penrose_pinv(torch.from_numpy(x))
    b = moore_penrose_pinv(torch.from_numpy(y))
    assert not torch.allclose(a[0, 0], b[0, 0])
    close(b.numpy(), jpinv(jnp.asarray(y)), "pinv, one head scaled")


@pytest.mark.parametrize("n", [1, 37, 256, 300])
def test_forward_attention_map_and_gradients_match_jax(n):
    model, jmodel, params = pair()
    x = np.random.default_rng(n).standard_normal((2, n, DIM)) \
        .astype(np.float32)
    w = np.cos(np.arange(DIM, dtype=np.float32))

    def jloss(p, xx):
        out, attn = jmodel.apply({"params": p}, xx, return_attn=True)
        return jnp.sum(out * w), (out, attn)

    (_, (jout, jattn)), (jgrads, jdx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_()
    out, attn = model(xt, return_attn=True)
    assert out.shape == (2, n, DIM) and out.dtype == torch.float32
    assert attn.shape == (2, HEADS, LANDMARKS if n == 1 else n - 1)
    close(out.detach().numpy(), jout, f"output at n={n}")
    close(attn.detach().numpy(), jattn, f"attention map at n={n}")
    (model(xt) * torch.from_numpy(w)).sum().backward()
    close(xt.grad.numpy(), jdx, f"dx at n={n}")
    want = flax_to_torch(jgrads)
    assert set(want) == {k for k, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        close(p.grad.numpy(), want[name].numpy(), f"{name} grad at n={n}")


def test_front_padding_keeps_the_last_rows():
    """Zero rows before a bag change nothing about its last rows only when
    they are the front padding itself: a bag of 37 tokens equals the last
    37 rows of the same bag zero-padded at the front to 256."""
    model, _, _ = pair(seed=1, residual=False)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 37, DIM)).astype(np.float32))
    padded = torch.cat([torch.zeros(1, LANDMARKS - 37, DIM), x], dim=1)
    with torch.no_grad():
        torch.testing.assert_close(model(x), model(padded)[:, -37:],
                                   rtol=0, atol=1e-6)


def test_output_dropout_draws_from_the_generator():
    model, _, _ = pair()
    model.p = 0.5
    model.train()
    x = torch.randn(1, 40, DIM)
    a = model(x, torch.Generator().manual_seed(3))
    b = model(x, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="generator"):
        model(x)
    model.eval()
    assert torch.equal(model(x), model(x))
