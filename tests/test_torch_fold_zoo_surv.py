"""`--fold_parallel` for the rest of the survival zoo against the JAX
package, on the CPU: MaxMIL, AttMIL and IBMIL here, CLAM_SB, CLAM_MB and
DSMIL in test_torch_fold_zoo_surv_aux.py, TransMIL in
test_torch_fold_zoo_surv_transmil.py (one file each under a minute).

For each model (under `SurvivalHead`): the JAX package's
`run_survival_fold_parallel` and the port's over folds 1 and 3 of ten bags
of 40-120 patches (bags of different buckets in one step, zero-extended to
the larger; ragged tails through each fold's own engine), one epoch,
dropout off (TransMIL's fixed Nystrom rate too), every fold from JAX's
initial weights.

Per model: every fold-parallel step's per-fold losses (the first from one
initialisation for both folds) within 1e-4 of max(1, max|jax|); each
fold's validation loss within 1e-4 and its c-index equal; the CV meter and
the results CSV's bytes equal; each fold's final parameters within Adam's
drift bound (2 lr a step) of JAX's.  One JAX run a model, shared by its
tests through a module fixture.  Also: DTFD, MHIM-MIL and --sp_shards > 1
are refused before any work, as in JAX.
"""
import os

import numpy as np
import pytest
import torch

import jax

import survival_main as jscli
from rrtmil_tpu.harness import survival as jsurvival
from rrtmil_tpu.models import nystrom as jnystrom
from rrtmil_tpu.models import zoo as jzoo
from rrtmil_tpu.parallel import folds as jfolds
from rrtmil_tpu.train.surv_engine import SurvivalEngine as JSurvivalEngine
from rrtmil_tpu_torch import survival_main as scli
from rrtmil_tpu_torch.convert import flax_to_torch
from rrtmil_tpu_torch.harness import survival
from rrtmil_tpu_torch.models import nystrom, zoo
from rrtmil_tpu_torch.models.survival import SurvivalHead
from rrtmil_tpu_torch.parallel import folds as pfolds
from rrtmil_tpu_torch.train.surv_engine import SurvivalEngine
from test_torch_fold_zoo import NoDropoutNN

D_IN = 32
FOLDS = [1, 3]
MODELS = ("MaxMIL", "AttMIL", "IBMIL")


def write_survival_csv(root, n=10, dim=D_IN, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    rows = ["Study,ID,Event,Status,WSI"]
    for i in range(n):
        risk = rng.uniform()
        bag = rng.standard_normal((int(rng.integers(40, 120)), dim)).astype(
            np.float32)
        bag[: len(bag) // 8] += 2.0 * risk
        path = os.path.join(root, f"case_{i}.npy")
        np.save(path, bag)
        rows.append(f"syn,case_{i},{2000 * (1.05 - risk):.1f},"
                    f"{int(i % 4 != 3)},{path}")
    with open(os.path.join(root, "syn.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    return os.path.join(root, "syn.csv")


def recording_steps(mod, store, mp, at):
    orig = mod.make_fold_parallel_surv_step

    def make(*a, **k):
        step = orig(*a, **k)

        def recorded(*sa, **sk):
            out = step(*sa, **sk)
            store.append(np.asarray(out[at]))
            return out
        return recorded
    mp.setattr(mod, "make_fold_parallel_surv_step", make)


def recording_validate(cls, store, mp, at):
    orig = cls.validate

    def validate(self, *a, **k):
        out = orig(self, *a, **k)
        store.append(tuple(float(v) for v in out[at:at + 2]))
        return out
    mp.setattr(cls, "validate", validate)


def surv_runs(tmp, model, cases=10):
    """Both packages' run_survival_fold_parallel for `model` on `cases`
    cases: each side's step losses, validations, meter, results CSV and
    final parameters."""
    csv_file = write_survival_csv(str(tmp / "data"), n=cases)
    rec = {k: [] for k in ("jinit", "jloss", "jval", "jstates", "loss", "val",
                           "models")}
    argv = ["--excel_file", csv_file, "--input_dim", str(D_IN),
            "--num_epoch", "1", "--no_log", "--fold_parallel",
            "--model", model]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnystrom, "nn", NoDropoutNN())
        mp.setattr(nystrom, "dropout", lambda x, p, generator, training: x)
        orig_init, orig_build = JSurvivalEngine.init, jzoo.build_model
        orig_unstack = jfolds.unstack_states

        def init(self, *a, **k):
            state = orig_init(self, *a, **k)
            rec["jinit"].append(jax.tree.map(np.array, state.params))
            return state

        def unstack(stacked, k):
            states = orig_unstack(stacked, k)
            rec["jstates"] = [jax.tree.map(np.array, s.params)
                              for s in states]
            return states
        mp.setattr(JSurvivalEngine, "init", init)
        mp.setattr(jfolds, "unstack_states", unstack)
        mp.setattr(jzoo, "build_model", lambda *a, **k: orig_build(
            *a, **{**k, "dropout": 0.0}))
        recording_steps(jfolds, rec["jloss"], mp, 1)
        recording_validate(JSurvivalEngine, rec["jval"], mp, 0)
        rec["jmeter"] = jsurvival.run_survival_fold_parallel(
            jscli.parse_args(argv + ["--results_dir", str(tmp / "jax")]),
            folds=FOLDS)

        def build(name, n_features, device, seed, **kw):
            name_l = survival.model_key(name)
            model = SurvivalHead(zoo.build_model(
                name_l, input_dim=n_features, n_classes=4, dropout=0.0,
                device=device, seed=seed))
            # CLAM's instance classifiers: flax makes none where no label
            # reaches the branch, as in survival
            missing, unexpected = model.load_state_dict(
                flax_to_torch(rec["jinit"][0]), strict=False)
            assert not unexpected and all(".instance_classifier_" in k
                                          for k in missing), missing
            rec["models"].append(model)
            return model, survival.survival_rrtmil_config(n_features).encoder
        mp.setattr(survival, "build_survival_model", build)
        recording_steps(pfolds, rec["loss"], mp, 0)
        recording_validate(SurvivalEngine, rec["val"], mp, 0)
        rec["meter"] = survival.run_survival_fold_parallel(scli.parse_args(
            argv + ["--results_dir", str(tmp / "port"), "--device", "cpu"]),
            folds=FOLDS)
        rec["lr"] = scli.parse_args(argv).lr
        rec["csv"] = [open(str(tmp / side / f"results_{model}.csv"),
                           "rb").read() for side in ("jax", "port")]
    return rec


def surv_runs_of(request, tmp_path_factory, cases=10):
    """surv_runs for the fixture's model on one intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return surv_runs(tmp_path_factory.mktemp(f"surv_{request.param}"),
                         request.param, cases)
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=MODELS)
def surv_zoo_runs(request, tmp_path_factory):
    return surv_runs_of(request, tmp_path_factory)


def test_fold_surv_zoo_steps_match_jax(surv_zoo_runs):
    """Each fold-parallel step's per-fold losses against the JAX package's
    make_fold_parallel_surv_step, from one initialisation."""
    check_surv_steps(surv_zoo_runs)


def check_surv_steps(rec):
    assert len(rec["jinit"]) == 2
    jax.tree.map(np.testing.assert_array_equal, *rec["jinit"])
    assert len(rec["loss"]) == len(rec["jloss"]) >= 2
    for got, want in zip(rec["loss"], rec["jloss"]):
        assert got.shape == want.shape == (2,)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * max(1, np.abs(want).max()))


def test_fold_surv_zoo_harness_matches_jax(surv_zoo_runs):
    """Each fold's validation loss and c-index, the CV meter, the results
    CSV and each fold's final parameters against the JAX package's
    run_survival_fold_parallel."""
    check_surv_harness(surv_zoo_runs)


def check_surv_harness(rec):
    assert len(rec["val"]) == len(rec["jval"]) == len(FOLDS)
    for (loss, ci), (jloss, jci) in zip(rec["val"], rec["jval"]):
        assert abs(loss - jloss) <= 1e-4 * max(1.0, abs(jloss))
        assert ci == jci
    assert (rec["meter"].cindex, rec["meter"].epochs) == \
        (rec["jmeter"].cindex, rec["jmeter"].epochs)
    assert rec["csv"][0] == rec["csv"][1]
    steps = len(rec["loss"]) + 2     # the fold-parallel steps and a tail
    for m, want in zip(rec["models"], rec["jstates"]):
        ref = flax_to_torch(want)
        for name, p in m.named_parameters():
            if name not in ref:       # CLAM's instance classifiers
                assert p.grad is None, name
                continue
            diff = (p.detach() - ref[name]).abs().max().item()
            assert diff <= 2 * rec["lr"] * steps * 1.01, (name, diff)


@pytest.mark.parametrize("model,over", [("DTFD", []), ("MHIM-MIL", []),
                                        ("RRTMIL", ["--sp_shards", "2"])])
def test_fold_parallel_refuses_before_any_work(tmp_path, monkeypatch, model,
                                               over):
    monkeypatch.setattr(survival, "SurvivalDataset", lambda *a, **k: (
        pytest.fail("work began before the model was refused")))
    with pytest.raises(ValueError, match="fold_parallel"):
        scli.main(["--excel_file", str(tmp_path / "none.csv"), "--model",
                   model, "--fold_parallel", "--device", "cpu",
                   "--results_dir", str(tmp_path / "out")] + over)
