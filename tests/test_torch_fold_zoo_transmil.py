"""`--fold_parallel` for TransMIL against the JAX package's
`run_cv_fold_parallel`, on the CPU, as test_torch_fold_zoo.py holds the
other zoo models: inside a fold step its bag is zero-extended to the
step's bucket (the side of its square from the bucket's host length); the
ragged tail's own engine step runs in exact mode.
"""
import pytest

from test_torch_fold_zoo import check_harness, check_steps, runs_of

MODELS = ("transmil",)


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
