"""`--fold_parallel` for CLAM-SB, CLAM-MB and DSMIL against the JAX
package's `run_cv_fold_parallel`, on the CPU, as test_torch_fold_zoo.py
holds the other zoo models: no label reaches a fold step, so CLAM's
instance branch and DSMIL's max-instance stream stay out of its loss; the
ragged tail's own engine step takes them (CLAM's on the bag's host label),
with the loss weights and batch 1 the harness forces.
"""
import pytest

from test_torch_fold_zoo import check_harness, check_steps, runs_of

MODELS = ("clam_sb", "clam_mb", "dsmil")


@pytest.fixture(scope="module", params=MODELS)
def zoo_runs(request, tmp_path_factory):
    return runs_of(request, tmp_path_factory)


def test_fold_zoo_steps_match_jax(zoo_runs):
    """Each fold-parallel step's per-fold losses against the JAX
    package's make_fold_parallel_step (test_torch_fold_zoo.check_steps)."""
    check_steps(zoo_runs)


def test_fold_zoo_harness_matches_jax(zoo_runs):
    """Each fold's validation, test, five scores and final parameters
    against the JAX package's run_cv_fold_parallel
    (test_torch_fold_zoo.check_harness)."""
    check_harness(zoo_runs)
