"""CLAM_SB and CLAM_MB with the R2T encoder injected (`--only_rrt_enc`)
against the JAX package on the CPU, subtyping on and off, on bags of 37-300
patches: the set-up and tolerances of tests/test_torch_zoo_rrt.py (c16_r50's
encoder, input width 24, forward and every gradient within 1e-4 of max(1,
max|jax|)); an instance classifier outside the bag's branch keeps
`grad=None` where JAX's gradient is all zero.
"""
import pytest

from test_torch_zoo_rrt import check_with_encoder


@pytest.mark.parametrize("name,subtyping,n", [
    ("clam_sb", False, 200), ("clam_sb", True, 37), ("clam_mb", False, 37),
    ("clam_mb", True, 300)])
def test_clam_with_encoder_matches_jax(name, subtyping, n):
    check_with_encoder(name, subtyping, n)
