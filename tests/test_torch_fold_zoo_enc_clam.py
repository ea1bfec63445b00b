"""`--fold_parallel --only_rrt_enc` for CLAM-MB: no label reaches the
fold step, so its instance branch stays out of the fold step's loss; the
ragged tail's own engine step takes it on the bag's host label.
Against the JAX package's `run_cv_fold_parallel`, as
test_torch_fold_zoo_enc.py holds AttMIL.
"""
import pytest

from test_torch_fold_zoo import check_harness
from test_torch_fold_zoo_enc import check_enc_steps, check_gradients, enc_runs

MODELS = ("clam_mb",)


@pytest.fixture(scope="module", params=MODELS)
def zoo_runs(request, tmp_path_factory):
    return enc_runs(request, tmp_path_factory)


def test_fold_zoo_enc_steps_match_jax(zoo_runs):
    """Each fold-parallel step's per-fold losses, the encoder under vmap
    (test_torch_fold_zoo_enc.check_enc_steps)."""
    check_enc_steps(zoo_runs)


def test_fold_zoo_enc_harness_matches_jax(zoo_runs):
    """Each fold's validation, test, five scores and final parameters
    (test_torch_fold_zoo.check_harness)."""
    check_harness(zoo_runs)


def test_fold_zoo_enc_gradients(zoo_runs):
    """Where each fold step's gradients go
    (test_torch_fold_zoo_enc.check_gradients)."""
    check_gradients(zoo_runs)
