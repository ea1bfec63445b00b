"""The attention-MIL zoo with the R2T encoder injected (`--only_rrt_enc`)
against the JAX package on the CPU: ABMIL, GatedABMIL and DSMIL here,
CLAM_SB and CLAM_MB in tests/test_torch_zoo_clam.py, with c16_r50's
encoder (dim 512, 8 x 64 heads, EPEG k = 15, CR-MSA k = 1, the global
shortcut; one R-MSA layer and the CR-MSA layer), input width 24, bags of
37-300 patches padded to their bucket.

The port's encoder takes its fused structure, whose kernels run their plain
versions on the CPU (K1 / K2, K3 / K4, K5 via K6 / K7, K8 / K9), on the
stem's output; the JAX encoder runs its XLA path with fp32 products.
Forward and every gradient within 1e-4 of max(1, max|jax|), as in
tests/test_torch_zoo.py, whose helpers these tests share.
"""
import dataclasses

import pytest

from rrtmil_tpu.config import c16_r50 as jax_c16_r50
from rrtmil_tpu_torch.config import c16_r50

from test_torch_zoo import bag, check_against_jax, pair


def encoders():
    """(port encoder config, JAX encoder config), dropout 0."""
    return (dataclasses.replace(c16_r50().encoder, backend="auto",
                                mm_dtype="float32", dropout=0.0),
            dataclasses.replace(jax_c16_r50().encoder, backend="xla",
                                mm_dtype="float32", dropout=0.0))


def check_with_encoder(name, subtyping, n):
    enc, jenc = encoders()
    model, jmodel, params = pair(name, rrt=enc, jrrt=jenc,
                                 subtyping=subtyping, seed=6)
    assert "rrt" in (params["feature"] if "feature" in params else params)
    x, mask, length = bag(n, seed=n, enc=jenc)
    check_against_jax(name, model, jmodel, params, x, mask, length,
                      label=n % 2)


@pytest.mark.parametrize("name,n", [("attmil", 300), ("gattmil", 150),
                                    ("dsmil", 300)])
def test_zoo_with_encoder_matches_jax(name, n):
    check_with_encoder(name, False, n)
