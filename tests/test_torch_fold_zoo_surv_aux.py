"""`--fold_parallel` for the survival CLAM_SB, CLAM_MB and DSMIL (bag
logits alone under `SurvivalHead`; CLAM's instance classifiers, which flax
never makes there, stay without gradients) against the JAX package's
`run_survival_fold_parallel`, on the CPU, as test_torch_fold_zoo_surv.py
holds the other survival models.
"""
import pytest

from test_torch_fold_zoo_surv import (check_surv_harness, check_surv_steps,
                                      surv_runs_of)


@pytest.fixture(scope="module", params=["CLAM_SB", "CLAM_MB", "DSMIL"])
def surv_zoo_runs(request, tmp_path_factory):
    return surv_runs_of(request, tmp_path_factory)


def test_fold_surv_zoo_steps_match_jax(surv_zoo_runs):
    """test_torch_fold_zoo_surv.check_surv_steps"""
    check_surv_steps(surv_zoo_runs)


def test_fold_surv_zoo_harness_matches_jax(surv_zoo_runs):
    """test_torch_fold_zoo_surv.check_surv_harness"""
    check_surv_harness(surv_zoo_runs)
