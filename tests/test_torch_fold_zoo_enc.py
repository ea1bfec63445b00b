"""`--fold_parallel` for zoo models with `--only_rrt_enc` against the JAX
package's `run_cv_fold_parallel`, on the CPU: AttMIL here, CLAM-MB and
DSMIL in test_torch_fold_zoo_enc_clam.py / _enc_dsmil.py (one file each
under a minute), each with the R²T encoder (512 wide, 2 layers, EPEG k = 9, CR-MSA k = 1)
between its stem and its head, run under `torch.func.vmap` over the
folds, as test_torch_fold_zoo.py holds the zoo without it (the same five
bags in two buckets, a ragged tail, dropout off, one epoch).  The port's
encoder takes f32 products, as the JAX package's XLA route on the CPU does.

Per model: the step losses and evaluations within 1e-4, the five scores
equal, the final parameters within Adam's drift bound of JAX's
(test_torch_fold_zoo.check_steps / check_harness).  DSMIL's fold step
sends no gradient into the encoder: its bag stream reads the encoder's
output only through the critical instance's argmax, and no label reaches
the fold step, so its max-instance stream stays out of the loss.
"""
import dataclasses

import pytest

from rrtmil_tpu_torch.harness import classification, fold_parallel
from test_torch_fold_zoo import check_harness, check_steps, runs_of

MODELS = ("attmil",)


def f32_encoder(mp):
    orig = classification.encoder_config_from_args
    mp.setattr(classification, "encoder_config_from_args",
               lambda args: dataclasses.replace(orig(args),
                                                mm_dtype="float32"))


def recording_grads(store, mp):
    """After each port fold step: the largest |gradient| of the folds'
    encoder parameters and of the rest."""
    orig = fold_parallel.make_fold_parallel_step

    def make(models, *a, **k):
        step = orig(models, *a, **k)

        def recorded(*sa, **sk):
            out = step(*sa, **sk)
            big = {"rrt": 0.0, "rest": 0.0}
            for m in models:
                for name, p in m.named_parameters():
                    key = "rrt" if "rrt" in name.split(".") else "rest"
                    if p.grad is not None:
                        big[key] = max(big[key], p.grad.abs().max().item())
            store.append(big)
            return out
        return recorded
    mp.setattr(fold_parallel, "make_fold_parallel_step", make)


def enc_runs(request, tmp_path_factory):
    """runs_of for the fixture's model with --only_rrt_enc, f32 products
    in the port's encoder, each port fold step's largest gradients."""
    grads = []
    with pytest.MonkeyPatch.context() as mp:
        f32_encoder(mp)
        recording_grads(grads, mp)
        rec = runs_of(request, tmp_path_factory, only_rrt_enc=True)
    rec["grads"] = grads
    rec["model"] = request.param
    return rec


def check_enc_steps(rec):
    assert any("rrt" in n.split(".") for n, _ in
               rec["models"][0].named_parameters())
    check_steps(rec)


def check_gradients(rec):
    assert len(rec["grads"]) == 2
    for big in rec["grads"]:
        assert big["rest"] > 0
        if rec["model"] == "dsmil":
            assert big["rrt"] == 0
        else:
            assert big["rrt"] > 0


@pytest.fixture(scope="module", params=MODELS)
def zoo_runs(request, tmp_path_factory):
    return enc_runs(request, tmp_path_factory)


def test_fold_zoo_enc_steps_match_jax(zoo_runs):
    """Each fold-parallel step's per-fold losses, the encoder under vmap,
    against the JAX package's make_fold_parallel_step."""
    check_enc_steps(zoo_runs)


def test_fold_zoo_enc_harness_matches_jax(zoo_runs):
    """Each fold's validation, test, five scores and final parameters,
    the encoder's included, against the JAX package's
    run_cv_fold_parallel."""
    check_harness(zoo_runs)


def test_fold_zoo_enc_gradients(zoo_runs):
    """Every fold step sends gradients into the stem and head; into the
    encoder too, except DSMIL's, which sends none there."""
    check_gradients(zoo_runs)
