"""The encoder geometries of test_torch_geometry.py (`--n_heads 16` / `4`
with EPEG k = 15 and without it, `--crmsa_heads 16`, `--crmsa_k 12`) with
bfloat16 products: the port's logits on the kernels' plain versions within
2e-2 of max(1, max|jax|) of the JAX model's with its Pallas kernels in
interpret mode (a sum next to a bf16 rounding boundary rounds the other
way), on the same two bags and weights.
"""
import pytest
import torch

import jax
import jax.numpy as jnp

from rrtmil_tpu.config import c16_r50 as jax_c16_r50
from rrtmil_tpu.models.rrt import RRTMIL as JRRTMIL
from rrtmil_tpu_torch.config import c16_r50
from rrtmil_tpu_torch.convert import flax_to_torch
from rrtmil_tpu_torch.models.rrt import RRTMIL
from test_torch_geometry import (CASES, TOL, _batch, _cfg, _jax_init,
                                 _scaled_err, interpret)  # noqa: F401


@pytest.mark.parametrize("case", list(CASES))
def test_geometry_logits_with_bf16_products_match_jax(case, interpret):
    jcfg, tcfg = _cfg(jax_c16_r50, case, "bfloat16"), \
        _cfg(c16_r50, case, "bfloat16")
    params = _jax_init(jcfg)
    x, mask, length = _batch(jcfg)
    model = JRRTMIL(jcfg)
    want = jax.jit(lambda p, x, m: model.apply(
        {"params": p}, x, mask=m, length=length, deterministic=True))(
        params, jnp.asarray(x), jnp.asarray(mask))
    port = RRTMIL(tcfg).eval()
    port.load_state_dict(flax_to_torch(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x), mask=torch.from_numpy(mask),
                   length=length)
    err = _scaled_err(got.numpy(), want)
    assert err <= TOL["bfloat16"], f"{case} bf16 logits: {err:.3e}"
