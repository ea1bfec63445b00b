"""`--fold_parallel` for the rest of the classification zoo against the JAX
package, on the CPU: attmil, gattmil, meanmil, maxmil and ibmil here,
clam_sb, clam_mb and dsmil in test_torch_fold_zoo_aux.py, transmil in
test_torch_fold_zoo_transmil.py (one file each under a minute).

For each model: the JAX package's `run_cv_fold_parallel` and the port's on one set
of five bags in two buckets (2 folds: 2 and 3 train bags, a ragged tail
through the longer fold's own engine, where CLAM's instance loss and
DSMIL's max-instance stream enter the loss), one epoch, dropout off (the
fixed rates of gattmil's stem and TransMIL's Nystrom layers too), the
port's folds from JAX's initial weights.  Inside a fold step the model
sees no label, and TransMIL its bag zero-extended to the step's bucket.

Per model: every fold-parallel step's per-fold losses within 1e-4 of
max(1, max|jax|); each fold's validation and test probabilities and
validation loss within 1e-4, labels and the five scores equal; each fold's
final parameters within Adam's drift bound (2 lr a step) of JAX's.  One
JAX run a model, shared by its tests through a module fixture.  Also:
`--fold_parallel --model dtfd` is refused before any work, as in JAX.
"""
import os

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax

import main as jcli
from rrtmil_tpu.harness import fold_parallel as jfold_parallel
from rrtmil_tpu.models import abmil as jabmil
from rrtmil_tpu.models import nystrom as jnystrom
from rrtmil_tpu.train.engine import Engine as JEngine
from rrtmil_tpu_torch import main as cli
from rrtmil_tpu_torch.convert import flax_to_torch
from rrtmil_tpu_torch.harness import fold_parallel
from rrtmil_tpu_torch.models import abmil, nystrom
from rrtmil_tpu_torch.train.engine import Engine

D_IN = 32
LENGTHS = (40, 120, 40, 120, 120)   # buckets of 64 and 256 rows
MODELS = ("attmil", "gattmil", "meanmil", "maxmil", "ibmil")


class NoDropoutNN:
    """flax.linen with Dropout at rate 0: the JAX modules' fixed rates."""

    def __getattr__(self, name):
        return getattr(fnn, name)

    @staticmethod
    def Dropout(rate, **kw):
        return fnn.Dropout(0.0, **kw)


def no_dropout(mp):
    """Dropout off on both sides, the fixed rates included."""
    for mod in (jabmil, jnystrom):
        mp.setattr(mod, "nn", NoDropoutNN())
    for mod in (abmil, nystrom):
        mp.setattr(mod, "dropout", lambda x, p, generator, training: x)


def write_c16(root, lengths, dim=D_IN, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "pt"))
    signal = rng.normal(size=(dim,))
    rows = []
    for i, n in enumerate(lengths):
        bag = rng.normal(size=(n, dim)).astype(np.float32)
        if i % 2:
            bag[: n // 8] += 0.5 * signal
        np.save(os.path.join(root, "pt", f"slide_{i:03d}.npy"), bag)
        rows.append(f"slide_{i:03d},{i % 2}\n")
    with open(os.path.join(root, "label.csv"), "w") as f:
        f.write("".join(rows))


def cli_args(parser_mod, tmp, title, **overrides):
    args = parser_mod.build_parser().parse_args([])
    args.dataset_root = str(tmp / "data")
    args.model_path = str(tmp / "out")
    args.title = title
    args.input_dim, args.cv_fold, args.num_epoch = D_IN, 2, 1
    args.epeg_k, args.crmsa_k, args.n_trans_layers = 9, 1, 2
    args.no_log, args.dropout, args.trans_drop_out = True, 0.0, 0.0
    for k, v in overrides.items():
        setattr(args, k, v)
    return parser_mod.postprocess_args(args)


def recording(cls, store, mp):
    orig = cls.evaluate

    def evaluate(self, *a, **k):
        out = orig(self, *a, **k)
        store.append(out)
        return out
    mp.setattr(cls, "evaluate", evaluate)


def recording_steps(mod, store, mp, jax_side):
    orig = mod.make_fold_parallel_step

    def make(*a, **k):
        step = orig(*a, **k)

        def recorded(*sa, **sk):
            out = step(*sa, **sk)
            store.append(np.asarray(out[1] if jax_side else out))
            return out
        return recorded
    mp.setattr(mod, "make_fold_parallel_step", make)


def fold_runs(tmp, model, **over):
    """Both packages' run_cv_fold_parallel on LENGTHS for `model`: each
    side's step losses, evaluates and final fold parameters, the port's
    padded steps and ragged-tail steps, and the step count of each fold."""
    write_c16(str(tmp / "data"), LENGTHS)
    over = dict(model=model, **over)
    rec = {k: [] for k in ("jinit", "jloss", "jeval", "jstates", "loss",
                           "eval", "pads", "tail", "models")}
    with pytest.MonkeyPatch.context() as mp:
        no_dropout(mp)
        orig_init, orig_unstack = JEngine.init, jfold_parallel.unstack_states

        def init(self, *a, **k):
            state = orig_init(self, *a, **k)
            rec["jinit"].append(jax.tree.map(np.array, state.params))
            return state

        def unstack(stacked, k):
            states = orig_unstack(stacked, k)
            rec["jstates"] = [jax.tree.map(np.array, s.params)
                              for s in states]
            return states
        mp.setattr(JEngine, "init", init)
        mp.setattr(jfold_parallel, "unstack_states", unstack)
        recording(JEngine, rec["jeval"], mp)
        recording_steps(jfold_parallel, rec["jloss"], mp, jax_side=True)
        rec["jmetrics"] = jfold_parallel.run_cv_fold_parallel(
            cli_args(jcli, tmp, "jax", **over))

        orig_stack, orig_pad = fold_parallel.stack_states, \
            fold_parallel.pad_stack

        def stack(models):
            for m in models:
                m.load_state_dict(flax_to_torch(rec["jinit"][0]))
            rec["models"] = models
            return orig_stack(models)

        def pad(parts, n):
            rec["pads"].append(([p[0].shape[1] for p in parts], n))
            return orig_pad(parts, n)
        orig_train = Engine._train_step

        def train_step(self, *a, **k):
            rec["tail"].append(self.fold)
            return orig_train(self, *a, **k)
        mp.setattr(fold_parallel, "stack_states", stack)
        mp.setattr(fold_parallel, "pad_stack", pad)
        mp.setattr(Engine, "_train_step", train_step)
        recording(Engine, rec["eval"], mp)
        recording_steps(fold_parallel, rec["loss"], mp, jax_side=False)
        rec["metrics"] = fold_parallel.run_cv_fold_parallel(cli_args(
            cli, tmp, "port", device="cpu", fold_parallel=True, **over))
        rec["lr"] = cli_args(cli, tmp, "lr").lr
    return rec


def check_steps(rec):
    assert len(rec["jinit"]) == 2
    jax.tree.map(np.testing.assert_array_equal, *rec["jinit"])
    assert any(len(set(lens)) > 1 for lens, _ in rec["pads"])
    assert rec["tail"] == [1]
    assert len(rec["loss"]) == len(rec["jloss"]) == 2
    for got, want in zip(rec["loss"], rec["jloss"]):
        assert got.shape == want.shape == (2,)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * max(1, np.abs(want).max()))


def check_harness(rec):
    assert len(rec["eval"]) == len(rec["jeval"]) == 4
    for (p, lab, loss), (jp, jlab, jloss) in zip(rec["eval"], rec["jeval"]):
        assert lab.tolist() == jlab.tolist()
        np.testing.assert_allclose(p, jp, rtol=0, atol=1e-4)
        assert abs(loss - jloss) <= 1e-4 * max(1.0, abs(jloss))
    for key in ("acs", "auc", "pre", "rec", "fs"):
        assert rec["metrics"][key] == rec["jmetrics"][key], key
    steps = (3, 3)     # fold 0: 2 fold-parallel steps; fold 1: and its tail
    for k, (m, want) in enumerate(zip(rec["models"], rec["jstates"])):
        ref = flax_to_torch(want)
        for name, p in m.named_parameters():
            diff = (p.detach() - ref[name]).abs().max().item()
            assert diff <= 2 * rec["lr"] * steps[k] * 1.01, (k, name, diff)


def runs_of(request, tmp_path_factory, **over):
    """fold_runs for the fixture's model, on one intra-op thread (the
    fold-parallel CPU path is many small ops, and under the test runner's
    workers their thread pools oversubscribe the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fold_runs(tmp_path_factory.mktemp(f"fold_{request.param}"),
                         request.param, **over)
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=MODELS)
def zoo_runs(request, tmp_path_factory):
    return runs_of(request, tmp_path_factory)


def test_fold_zoo_steps_match_jax(zoo_runs):
    """Each fold-parallel step's per-fold losses against the JAX package's
    make_fold_parallel_step: one initialisation for both folds, bags of two
    buckets zero-extended to the larger, the ragged tail through fold 1's
    own engine."""
    check_steps(zoo_runs)


def test_fold_zoo_harness_matches_jax(zoo_runs):
    """Each fold's validation and test (final weights under --no_log), its
    five scores and its final parameters against the JAX package's
    run_cv_fold_parallel."""
    check_harness(zoo_runs)


def test_fold_parallel_refuses_dtfd_before_any_work(tmp_path, monkeypatch):
    monkeypatch.setattr(fold_parallel, "make_splits", lambda *a: (
        pytest.fail("work began before --model dtfd was refused")))
    with pytest.raises(ValueError, match="unknown model 'dtfd'"):
        fold_parallel.run_cv_fold_parallel(cli_args(
            cli, tmp_path, "dtfd", model="dtfd", device="cpu",
            fold_parallel=True))
    with pytest.raises(ValueError, match="unknown model 'dtfd'"):
        jfold_parallel.build_model_from_args(cli_args(
            jcli, tmp_path, "jdtfd", model="dtfd"))
