"""`--fold_parallel` for the survival TransMIL (cls token at std 1e-6, the
bucket's rows) against the JAX package's `run_survival_fold_parallel`, on
the CPU, as test_torch_fold_zoo_surv.py holds the other survival models,
on 7 cases, not 10: its steps are the costliest of the zoo on the CPU, and
the file is held under a minute.
"""
import pytest

from test_torch_fold_zoo_surv import (check_surv_harness, check_surv_steps,
                                      surv_runs_of)


@pytest.fixture(scope="module", params=["TransMIL"])
def surv_zoo_runs(request, tmp_path_factory):
    return surv_runs_of(request, tmp_path_factory, cases=7)


def test_fold_surv_zoo_steps_match_jax(surv_zoo_runs):
    """test_torch_fold_zoo_surv.check_surv_steps"""
    check_surv_steps(surv_zoo_runs)


def test_fold_surv_zoo_harness_matches_jax(surv_zoo_runs):
    """test_torch_fold_zoo_surv.check_surv_harness"""
    check_surv_harness(surv_zoo_runs)
