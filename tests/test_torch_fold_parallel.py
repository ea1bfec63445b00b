"""Fold-parallel cross-validation (--fold_parallel) in the port, on the CPU.

The step against each fold's own step (losses, one Adam step), and the
harnesses end to end: `run_cv_fold_parallel` (parallel/folds.py's
step: the model under `torch.func.vmap` over stacked fold parameters, one
backward of the summed losses, each fold's engine updating its own
parameters, views of the stack) against the port's sequential `run_cv`
(equal lengths, dropout on: one generator a fold; a ragged epoch tail) and
against the JAX package's `run_cv_fold_parallel` (RRTMIL, dropout off, bags
in two buckets, each step's bags zero-extended to its largest bucket, a
ragged tail); the survival RRTMIL step against the JAX package's
`make_fold_parallel_surv_step` (three folds of distinct weights, a bucket
whose grids differ: K12 / K13); `run_survival_fold_parallel` against the
JAX package's.  The input is 32 wide, the encoder 512 wide, 2 layers, one
epoch where the test allows it; each JAX run is made once a module.

Tolerances: port against port, step losses within rtol 2e-5, parameters
within Adam's drift bound, test metrics within 1e-6 and probabilities
within 1e-5; port against JAX (XLA with fp32 products against the plain
versions at fp32 products), step losses, probabilities, risks and
gradients within 1e-4 of max(1, max|jax|), metrics and c-indices equal.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import main as jcli
import survival_main as jscli
from rrtmil_tpu.config import survival_default as jax_survival_default
from rrtmil_tpu.data.bucketing import bucket_for as jax_bucket_for
from rrtmil_tpu.harness import classification as jclassification
from rrtmil_tpu.harness import fold_parallel as jfold_parallel
from rrtmil_tpu.harness import survival as jsurvival
from rrtmil_tpu.models import zoo as jzoo
from rrtmil_tpu.models.rrt import RRTMIL as JRRTMIL
from rrtmil_tpu.models.survival import SurvivalHead as JSurvivalHead
from rrtmil_tpu.parallel import folds as jfolds
from rrtmil_tpu.train import losses as jlosses
from rrtmil_tpu.train.engine import Engine as JEngine
from rrtmil_tpu.train.engine import TrainState
from rrtmil_tpu.train.surv_engine import SurvivalEngine as JSurvivalEngine
from rrtmil_tpu_torch import main as cli
from rrtmil_tpu_torch import survival_main as scli
from rrtmil_tpu_torch.config import survival_default
from rrtmil_tpu_torch.convert import flax_to_torch
from rrtmil_tpu_torch.harness import classification, fold_parallel, survival
from rrtmil_tpu_torch.models.mean_max import MeanMIL
from rrtmil_tpu_torch.models.rrt import RRTMIL
from rrtmil_tpu_torch.models.survival import SurvivalHead
from rrtmil_tpu_torch.parallel import folds as pfolds
from rrtmil_tpu_torch.train import losses
from rrtmil_tpu_torch.train.engine import Engine

D_IN = 32
FOLDS = [1, 3]   # the survival harnesses' folds


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the fold-parallel CPU path is many small ops,
    and under the test runner's parallel workers their thread pools
    oversubscribe the cores (a 2 s test took 145 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- (d) the classification harness ------------------------------------------

def _write_c16(root, lengths, dim=D_IN, seed=0):
    """camelyon16's layout: bags of `lengths` patches, a planted signal in
    the odd ones."""
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


def _args(parser_mod, tmp_path, title, **overrides):
    args = parser_mod.build_parser().parse_args([])
    args.dataset_root = str(tmp_path / "data")
    args.model_path = str(tmp_path / "out")
    args.title = title
    args.input_dim, args.cv_fold, args.num_epoch = D_IN, 2, 1
    args.epeg_k, args.crmsa_k, args.n_trans_layers = 9, 1, 2
    args.no_log = True
    for k, v in overrides.items():
        setattr(args, k, v)
    return parser_mod.postprocess_args(args)


def _recording(cls, store, monkeypatch):
    orig = cls.evaluate

    def evaluate(self, *a, **k):
        out = orig(self, *a, **k)
        store.append(out)
        return out
    monkeypatch.setattr(cls, "evaluate", evaluate)


def _f32_products(monkeypatch):
    orig = classification.model_config_from_args

    def model_cfg(args):
        cfg = orig(args)
        return dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, mm_dtype="float32"))
    monkeypatch.setattr(classification, "model_config_from_args", model_cfg)


def test_run_cv_fold_parallel_matches_run_cv(tmp_path, monkeypatch):
    """Equal-length bags (one bucket), 2 folds of 5 (2 and 3 train bags: a
    ragged tail through its fold's own engine), 2 epochs: the
    fold-parallel harness's every fold test metrics within 1e-6 of the
    sequential harness's, its test probabilities within 1e-5 (the vmapped
    products sum in another order than one fold's, ~1e-7 a step, which ten
    Adam steps grow to 2.6e-6), dropout on (the sequential harness seeds
    each fold's generator as the fold-parallel one does)."""
    dropout, epochs = 0.25, 2
    _write_c16(str(tmp_path / "data"), [120] * 5)
    _f32_products(monkeypatch)
    over = dict(dropout=dropout, trans_drop_out=dropout, cv_fold=2,
                num_epoch=epochs)
    evals = []
    _recording(Engine, evals, monkeypatch)
    seq = classification.run_cv(_args(cli, tmp_path, "seq", device="cpu",
                                      **over))
    par = fold_parallel.run_cv_fold_parallel(_args(
        cli, tmp_path, "par", device="cpu", fold_parallel=True, **over))
    # sequential: each fold's validations then its test; fold-parallel:
    # each epoch's validations, then the folds' tests
    n = 2 * (epochs + 1)
    assert len(evals) == 2 * n
    for (p, l, _), (sp, sl, _) in zip(evals[-2:],
                                      evals[epochs:n:epochs + 1]):
        assert l.tolist() == sl.tolist()
        np.testing.assert_allclose(p, sp, rtol=0, atol=1e-5)
    for key in ("acs", "auc", "pre", "rec", "fs"):
        np.testing.assert_allclose(par[key], seq[key], atol=1e-6)


# -- (b) the step against each fold's own step ------------------------------

def test_fold_parallel_step_matches_sequential_steps():
    """c16_r50's RRTMIL (input 32, 2 layers, fp32 products, dropout on), 3
    folds of distinct weights, one step on bags of one bucket: each fold's
    loss within rtol 2e-5 of the same fold's own batch-1 step (its
    generator seeded alike), and its parameters after one Adam step within
    Adam's drift bound of the sequential ones: none past 2 lr, and at most
    1e-3 of a tensor's elements past 1e-5 but in pe_bias and the key third
    of each qkv bias, whose gradients are zero in exact arithmetic."""
    from rrtmil_tpu_torch.config import c16_r50
    from rrtmil_tpu_torch.data.bucketing import bucket_for
    from rrtmil_tpu_torch.models.rrt import build_model
    from rrtmil_tpu_torch.train.losses import cross_entropy
    base = c16_r50()
    enc = dataclasses.replace(base.encoder, n_layers=2, mm_dtype="float32")
    cfg = dataclasses.replace(base, input_dim=D_IN, encoder=enc)
    lengths, lr = (100, 120, 90), 1e-3
    spec = bucket_for(max(lengths), cfg.encoder)
    rng = np.random.default_rng(3)
    x = np.zeros((3, 1, spec.data_length, D_IN), np.float32)
    mask = np.zeros((3, 1, spec.data_length), bool)
    for k, n in enumerate(lengths):
        x[k, 0, :n] = rng.standard_normal((n, D_IN))
        mask[k, 0, :n] = True
    x, mask = torch.from_numpy(x), torch.from_numpy(mask)
    labels = torch.tensor([[0], [1], [1]])

    def models():
        return [build_model(cfg, device="cpu", seed=s) for s in range(3)]

    seq = models()
    seq_losses = []
    for k, m in enumerate(seq):
        m.train()
        opt = torch.optim.Adam(m.parameters(), lr=lr)
        out = m(x[k], mask=mask[k], length=spec.repr_length,
                generator=torch.Generator().manual_seed(10 + k))
        loss = cross_entropy(out[0] if isinstance(out, tuple) else out,
                             labels[k])
        loss.backward()
        opt.step()
        seq_losses.append(loss.item())
    par = models()
    step = pfolds.make_fold_parallel_step(par, pfolds.stack_states(par),
                                          cross_entropy, spec.repr_length)
    losses = step(x, mask, labels,
                  [torch.Generator().manual_seed(10 + k) for k in range(3)])
    np.testing.assert_allclose(losses.numpy(), seq_losses, rtol=2e-5)
    for m in par:
        torch.optim.Adam(m.parameters(), lr=lr).step()
    for m, ms in zip(par, seq):
        for (name, p), q in zip(m.named_parameters(), ms.parameters()):
            diff = (p.detach() - q.detach()).abs()
            assert diff.max() <= 2 * lr * 1.01, name
            if "pe_bias" in name:        # a gradient of rounding noise
                continue
            if name.endswith("qkv.bias"):   # the key third: likewise
                third = diff.shape[0] // 3
                diff = torch.cat([diff[:third], diff[2 * third:]])
            assert (diff > 1e-5).float().mean() <= 1e-3, name


# -- (c, d) against the JAX package: the step and the harness ----------------

LENGTHS = (40, 120, 40, 120, 120)   # buckets of 64 and 256 rows


def _recording_steps(mod, store, mp, jax_side):
    """mod.make_fold_parallel_step's steps with each step's per-fold losses
    appended to `store`."""
    orig = mod.make_fold_parallel_step

    def make(*a, **k):
        step = orig(*a, **k)

        def recorded(*sa, **sk):
            out = step(*sa, **sk)
            store.append(np.asarray(out[1] if jax_side else out))
            return out
        return recorded
    mp.setattr(mod, "make_fold_parallel_step", make)


@pytest.fixture(scope="module")
def cv_runs(tmp_path_factory):
    """The JAX package's run_cv_fold_parallel and the port's on one set of
    five bags in two buckets (2 folds: 2 and 3 train bags, a ragged tail),
    RRTMIL, 1 epoch, dropout off, the port's folds from JAX's initial
    weights: each side's step losses and evaluates, the port's padded
    steps and its ragged-tail steps."""
    tmp = tmp_path_factory.mktemp("fold_cv")
    _write_c16(str(tmp / "data"), LENGTHS)
    over = dict(dropout=0.0, trans_drop_out=0.0)
    rec = {k: [] for k in ("jinit", "jloss", "jeval", "loss", "eval", "pads",
                           "tail")}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        orig_init = JEngine.init

        def init(self, *a, **k):
            state = orig_init(self, *a, **k)
            rec["jinit"].append(jax.tree.map(np.array, state.params))
            return state
        mp.setattr(JEngine, "init", init)
        _recording(JEngine, rec["jeval"], mp)
        _recording_steps(jfold_parallel, rec["jloss"], mp, jax_side=True)
        rec["jmetrics"] = jfold_parallel.run_cv_fold_parallel(
            _args(jcli, tmp, "jax", **over))

        _f32_products(mp)
        mp.setattr(classification, "build_model",
                   lambda cfg, device, seed: RRTMIL(cfg).to(device))
        orig_stack, orig_pad = fold_parallel.stack_states, \
            fold_parallel.pad_stack

        def stack(models):
            for m in models:
                m.load_state_dict(flax_to_torch(rec["jinit"][0]))
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
        _recording(Engine, rec["eval"], mp)
        _recording_steps(fold_parallel, rec["loss"], mp, jax_side=False)
        rec["metrics"] = fold_parallel.run_cv_fold_parallel(_args(
            cli, tmp, "port", device="cpu", fold_parallel=True, **over))
    torch.set_num_threads(threads)
    return rec


def test_fold_parallel_step_matches_jax(cv_runs):
    """Every fold-parallel step's per-fold losses within 1e-4 of the JAX
    package's make_fold_parallel_step, from one initialisation (the JAX
    harness's, equal for both folds), one step on bags of two buckets
    zero-extended to the larger."""
    assert len(cv_runs["jinit"]) == 2
    jax.tree.map(np.testing.assert_array_equal, *cv_runs["jinit"])
    assert any(len(set(lens)) > 1 for lens, _ in cv_runs["pads"])
    assert len(cv_runs["loss"]) == len(cv_runs["jloss"]) >= 2
    for got, want in zip(cv_runs["loss"], cv_runs["jloss"]):
        assert got.shape == want.shape == (2,)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * max(1, np.abs(want).max()))


def test_run_cv_fold_parallel_matches_jax(cv_runs):
    """Each fold's validation and its test (final weights under --no_log)
    within 1e-4 of the JAX package's run_cv_fold_parallel, labels equal,
    the five scores of each fold equal, after the fold-parallel steps and
    the ragged tail through the longer fold's engine."""
    assert cv_runs["tail"] == [1]
    assert len(cv_runs["eval"]) == len(cv_runs["jeval"]) == 4
    for (p, lab, loss), (jp, jlab, jloss) in zip(cv_runs["eval"],
                                                 cv_runs["jeval"]):
        assert lab.tolist() == jlab.tolist()
        np.testing.assert_allclose(p, jp, rtol=0, atol=1e-4)
        assert abs(loss - jloss) <= 1e-4
    for key in ("acs", "auc", "pre", "rec", "fs"):
        assert cv_runs["metrics"][key] == cv_runs["jmetrics"][key], key


def test_fold_parallel_surv_step_matches_jax():
    """survival_default's RRTMIL (input 32, fp32 products, dropout off), 3
    folds of distinct weights on a bucket whose grids differ (32 / 24: K12
    and K13), one fold's bag from the 16 x 16 bucket zero-extended to it:
    each fold's loss, risk and every parameter gradient within 1e-4 of the
    JAX package's make_fold_parallel_surv_step (an identity optimizer at
    lr 1, so its update is the gradient)."""
    def cfg(fn, backend):
        c = fn()
        return dataclasses.replace(c, input_dim=D_IN, dropout=0.0,
                                   encoder=dataclasses.replace(
                                       c.encoder, backend=backend,
                                       mm_dtype="float32", dropout=0.0))
    jcfg, tcfg = cfg(jax_survival_default, "xla"), cfg(survival_default,
                                                       "auto")
    lengths = (290, 310, 150)
    spec = jax_bucket_for(300, jcfg.encoder)
    assert spec.key == (32, 24) and jax_bucket_for(150, jcfg.encoder).key \
        == (16, 16)
    rng = np.random.default_rng(7)
    x = np.zeros((3, 1, spec.data_length, D_IN), np.float32)
    mask = np.zeros((3, 1, spec.data_length), bool)
    for k, n in enumerate(lengths):
        x[k, 0, :n] = rng.standard_normal((n, D_IN))
        mask[k, 0, :n] = True
    label = np.array([[2], [0], [3]])
    cens = np.array([[0.0], [1.0], [0.0]], np.float32)

    jmodel = JSurvivalHead(JRRTMIL(jcfg))
    init = jax.jit(lambda key: jmodel.init(
        {"params": key}, jnp.zeros((1, 64, D_IN)), length=64)["params"])
    params = [init(jax.random.PRNGKey(5 + k)) for k in range(3)]
    tx = optax.identity()
    stacked = jfolds.stack_states([TrainState(
        params=p, opt_state=tx.init(p), step=jnp.zeros((), jnp.int32))
        for p in params])
    jstep = jfolds.make_fold_parallel_surv_step(
        jmodel, tx, lambda *a: jlosses.nll_surv_loss(*a, alpha=0.0),
        spec.repr_length)
    new, jl, jrisk = jstep(stacked, jnp.asarray(x), jnp.asarray(mask),
                           jnp.asarray(label, jnp.int32), jnp.asarray(cens),
                           jnp.ones(3), jnp.stack([jax.random.PRNGKey(0)] * 3))
    jgrads = jax.tree.map(lambda a, b: np.asarray(a - b), stacked.params,
                          new.params)

    models = []
    for p in params:
        m = SurvivalHead(RRTMIL(tcfg))
        m.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, p)))
        models.append(m)
    step = pfolds.make_fold_parallel_surv_step(
        models, pfolds.stack_states(models),
        lambda *a: losses.nll_surv_loss(*a, alpha=0.0), spec.repr_length)
    loss, risk = step(torch.from_numpy(x), torch.from_numpy(mask),
                      torch.from_numpy(label), torch.from_numpy(cens),
                      [torch.Generator() for _ in models])
    np.testing.assert_allclose(loss.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-4 * max(1, np.abs(jl).max()))
    np.testing.assert_allclose(risk.numpy(), np.asarray(jrisk), rtol=0,
                               atol=1e-4 * max(1, np.abs(jrisk).max()))
    for k, m in enumerate(models):
        want = flax_to_torch(jax.tree.map(lambda g: g[k], jgrads))
        for name, p in m.named_parameters():
            got, ref = p.grad.numpy(), want[name].numpy()
            if "pe_bias" in name:             # zero in exact arithmetic
                assert np.abs(got - ref).max() <= 1e-5, (k, name)
                continue
            scale = max(1.0, float(np.abs(ref).max()))
            np.testing.assert_allclose(got / scale, ref / scale, rtol=0,
                                       atol=1e-4, err_msg=f"{k} {name}")


# -- (e) the survival harness ------------------------------------------------

def _write_survival_csv(root, n=10, dim=D_IN, seed=0):
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


def test_run_survival_fold_parallel_matches_jax(tmp_path, monkeypatch):
    """MeanMIL (dropout 0) over folds 1 and 3 at once (both packages take
    a fold list), 2 epochs, each fold from JAX's initial weights: each
    fold's best c-index and epoch equal to the JAX package's
    run_survival_fold_parallel, the same results CSV, and the best weights
    saved as .pt files."""
    csv_file = _write_survival_csv(str(tmp_path / "data"))
    jinit = []
    orig_init, orig_build = JSurvivalEngine.init, jzoo.build_model

    def init(self, *a, **k):
        state = orig_init(self, *a, **k)
        jinit.append(jax.tree.map(np.array, state.params))
        return state
    monkeypatch.setattr(JSurvivalEngine, "init", init)
    monkeypatch.setattr(jzoo, "build_model", lambda *a, **k: orig_build(
        *a, **{**k, "dropout": 0.0}))
    argv = ["--excel_file", csv_file, "--input_dim", str(D_IN),
            "--num_epoch", "2", "--no_log", "--fold_parallel"]
    jmeter = jsurvival.run_survival_fold_parallel(jscli.parse_args(
        argv + ["--results_dir", str(tmp_path / "jax")]), folds=FOLDS)

    def build(name, n_features, device, seed, **kw):
        model = SurvivalHead(MeanMIL(n_features, 4, dropout=0.0))
        model.load_state_dict(flax_to_torch(jinit[0]))
        return model, survival.survival_rrtmil_config(n_features).encoder
    monkeypatch.setattr(survival, "build_survival_model", build)
    out = str(tmp_path / "port")
    meter = survival.run_survival_fold_parallel(scli.parse_args(
        argv + ["--results_dir", out, "--device", "cpu"]), folds=FOLDS)
    assert (meter.cindex, meter.epochs) == (jmeter.cindex, jmeter.epochs)
    assert open(os.path.join(out, "results_MeanMIL.csv"), "rb").read() == \
        open(str(tmp_path / "jax" / "results_MeanMIL.csv"), "rb").read()
    for k in FOLDS:
        fold_dir = os.path.join(out, f"fold_{k}")
        # a fold whose best c-index stays 0 saves nothing, as in JAX
        assert os.path.isdir(fold_dir) == os.path.isdir(
            str(tmp_path / "jax" / f"fold_{k}"))
        if os.path.isdir(fold_dir):
            assert all(f.endswith(".pt") for f in os.listdir(fold_dir))
