"""The port's survival CLI and harness against the JAX package on the CPU:
MeanMIL / MaxMIL, the flag surface, the refusals, `CVMeter`, and
`run_survival_cv` end to end.

`run_survival_cv` runs MeanMIL over all five folds on both sides (dropout 0,
each fold from JAX's initial weights carried through convert.py).  RRTMIL
(input 32, the encoder 512 wide) would have JAX compile its steps again for
every fold's engine, so it is held over one fold's `SurvivalEngine.learning`
instead, under RAdam (a bucket whose grids differ: K12 / K13's plain
versions) and under Lookahead (a matched bucket: K3 / K8's), 12 steps each
(Lookahead's first sync seeds its slow buffer, the second moves the
weights).

Tolerances: logits and gradients 1e-4 of max(1, max|jax|); every epoch's
summed losses and risks (train and validation) 1e-4; c-indices equal, which
holds where no two risks of a validation set lie within 1e-4 of each other:
the test asserts that on its data.  The learning runs at the CLI's lr, 2e-4
(its readings stay below 1e-5); at 1e-3 Lookahead's inner Adam turns the
two sides' rounding-level gradient differences on near-zero gradient
entries (CR-MSA value weights of a mostly padded grid) into lr-sized steps,
and after 12 steps the losses stand 1.7e-4 apart.
"""
import argparse
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import survival_main as jcli
from rrtmil_tpu.config import survival_default as jax_survival_default
from rrtmil_tpu.data.survival import ArraySurvivalDataset as JArraySurvDataset
from rrtmil_tpu.harness import survival as jsurvival
from rrtmil_tpu.models import zoo as jzoo
from rrtmil_tpu.models.mean_max import MaxMIL as JMaxMIL
from rrtmil_tpu.models.mean_max import MeanMIL as JMeanMIL
from rrtmil_tpu.models.rrt import RRTMIL as JRRTMIL
from rrtmil_tpu.models.survival import SurvivalHead as JSurvivalHead
from rrtmil_tpu.train.engine import TrainState
from rrtmil_tpu.train.surv_engine import SurvivalEngine as JSurvivalEngine
from rrtmil_tpu.train.surv_engine import \
    SurvivalEngineConfig as JSurvivalEngineConfig
from rrtmil_tpu_torch import survival_main as cli
from rrtmil_tpu_torch.config import survival_default
from rrtmil_tpu_torch.convert import flax_to_torch
from rrtmil_tpu_torch.data.survival import ArraySurvivalDataset
from rrtmil_tpu_torch.harness import survival
from rrtmil_tpu_torch.models import zoo
from rrtmil_tpu_torch.models.mean_max import MaxMIL, MeanMIL
from rrtmil_tpu_torch.models.rrt import RRTMIL
from rrtmil_tpu_torch.models.survival import SurvivalHead
from rrtmil_tpu_torch.train.surv_engine import (SurvivalEngine,
                                                SurvivalEngineConfig)

D_IN = 32
TOL = 1e-4


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(1.0, float(np.abs(want).max()))
    assert err <= TOL, f"{what}: scaled error {err:.3e}"


# -- MeanMIL / MaxMIL ---------------------------------------------------------

@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("jcls,cls", [(JMeanMIL, MeanMIL), (JMaxMIL, MaxMIL)])
def test_mean_max_match_jax(jcls, cls, masked):
    """Logits and every parameter gradient, weights carried by
    convert.flax_to_torch, dropout 0; the masked bags end in pad rows."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 40, D_IN)).astype(np.float32)
    mask = np.ones((2, 40), bool)
    mask[0, 31:], mask[1, 17:] = False, False
    x *= mask[..., None]
    m = mask if masked else None
    g = rng.standard_normal((2, 4)).astype(np.float32)
    jmodel = jcls(input_dim=D_IN, n_classes=4, dropout=0.0)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]

    def f(p):
        out = jmodel.apply({"params": p}, jnp.asarray(x),
                           mask=None if m is None else jnp.asarray(m))
        return jnp.sum(out * g), out
    (_, jout), jgrad = jax.value_and_grad(f, has_aux=True)(params)
    model = cls(input_dim=D_IN, n_classes=4, dropout=0.0)
    model.load_state_dict(flax_to_torch(params))
    out = model(torch.from_numpy(x),
                mask=None if m is None else torch.from_numpy(m))
    (out * torch.from_numpy(g)).sum().backward()
    _close(out.detach(), jout, "logits")
    want = flax_to_torch(jgrad)
    for name, p in model.named_parameters():
        _close(p.grad, want[name].numpy(), name)


# -- flags, refusals, CVMeter -------------------------------------------------

def _jax_parser(monkeypatch):
    """The root survival_main.py's parser (it builds one inside
    parse_args)."""
    seen = []
    orig = argparse.ArgumentParser.parse_args

    def parse(self, *a, **k):
        seen.append(self)
        return orig(self, *a, **k)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    jcli.parse_args(["--results_dir", "x"])
    monkeypatch.undo()
    return seen[0]


def test_flag_surface_is_survival_main_pys_plus_device(monkeypatch):
    jp, p = _jax_parser(monkeypatch), cli.build_parser()
    jactions = {a.dest: a for a in jp._actions if a.dest != "help"}
    actions = {a.dest: a for a in p._actions if a.dest != "help"}
    assert set(actions) == set(jactions) | {"device"}
    assert actions["device"].default == "cuda"
    for dest, ja in jactions.items():
        a = actions[dest]
        assert (a.option_strings, a.default, a.choices, a.type, a.nargs) == \
            (ja.option_strings, ja.default, ja.choices, ja.type, ja.nargs), \
            dest
    want = vars(jcli.parse_args(["--excel_file", "/d/tcga_x.csv"]))
    got = vars(cli.parse_args(["--excel_file", "/d/tcga_x.csv"]))
    assert got.pop("device") == "cuda"
    # the default results_dir carries the time of day
    assert got.pop("results_dir")[:-22] == want.pop("results_dir")[:-22]
    assert got == want


@pytest.mark.parametrize("name,item", [("TransMIL", None), ("IBMIL", None),
                                       ("DTFD", "f"), ("MHIM-MIL", "g")])
def test_unported_models_name_their_roadmap_item(name, item):
    """Every survival name of items 8(b), 8(e), 8(f) and 8(g) builds and
    runs on a masked bag: TransMIL and IBMIL under SurvivalHead, four
    hazards; DTFD (its own (hazards, S)) and MHIM-MIL (logits) bare, each
    through the engine of its own, one train step and a validation."""
    model, enc = survival.build_survival_model(name, D_IN, device="cpu")
    x, mask = torch.randn(1, 64, D_IN), torch.ones(1, 64, dtype=bool)
    if item is None:
        with torch.no_grad():
            assert model(x, mask=mask, length=64)[0].shape == (1, 4)
        return
    assert not isinstance(model, SurvivalHead)
    with torch.no_grad():
        out = model(x, mask=mask, length=64)
    out = out if item == "f" else torch.sigmoid(out)
    assert (out[0] if item == "f" else out).shape == (1, 4)
    eng = survival.make_survival_engine(
        name, model, SurvivalEngineConfig(num_epochs=1), enc, device="cpu",
        niter_per_ep=2)
    assert type(eng).__name__ == {"f": "DTFDSurvivalEngine",
                                  "g": "MHIMSurvivalEngine"}[item]
    rng = np.random.default_rng(0)
    ds = ArraySurvivalDataset([rng.standard_normal((n, D_IN)).astype(
        np.float32) for n in (50, 90)], [100.0, 500.0], [1, 1])
    loss, _ = eng.train_epoch(ds, [0, 1], 0)
    vloss, ci = eng.validate(ds, [0, 1])
    assert np.isfinite(loss) and np.isfinite(vloss) and ci in (0.0, 1.0)


@pytest.mark.parametrize("name,cls", [("AttMIL", "ABMIL"),
                                      ("CLAM_SB", "CLAM_SB"),
                                      ("CLAM_MB", "CLAM_MB"),
                                      ("DSMIL", "DSMIL")])
def test_zoo_backbones_build_and_run_on_the_cpu(name, cls):
    """The zoo's survival backbones (no encoder, as the JAX package builds
    them) under SurvivalHead: four hazards and survivals in (0, 1] for a
    masked bag, seeded weights."""
    model, enc = survival.build_survival_model(name, D_IN, device="cpu",
                                               seed=1)
    assert type(model.backbone).__name__ == cls and enc.region_num == 16
    x = torch.randn(1, 50, D_IN)
    mask = torch.arange(50)[None] < 41
    with torch.no_grad():
        hazards, surv = model(x, mask=mask)
    assert hazards.shape == surv.shape == (1, 4)
    assert torch.all((surv > 0) & (surv <= 1)) and torch.isfinite(
        hazards).all()


def test_refusals_name_their_roadmap_items(tmp_path):
    """mhim is no zoo name (an unknown model there, as in the JAX
    registry); DTFD and MHIM-MIL get their own engines; --sp_shards > 1
    takes RRTMIL's config alone, as in the JAX package; --fold_parallel
    with a model it does not know or with --sp_shards 2 raises naming item
    9, and tells a DTFD or MHIM-MIL user that the JAX package does not run
    it there either."""
    with pytest.raises(ValueError, match="unknown model 'mhim'"):
        zoo.build_model("mhim", device="cpu")
    assert isinstance(survival.make_survival_engine(
        "DTFD", torch.nn.Linear(2, 2), SurvivalEngineConfig(),
        device="cpu"), survival.DTFDSurvivalEngine)
    with pytest.raises(TypeError, match="takes the RRTMILConfig"):
        survival.make_survival_engine("RRTMIL", torch.nn.Linear(2, 2),
                                      SurvivalEngineConfig(), sp_shards=2,
                                      device="cpu")
    with pytest.raises(ValueError, match="--model DTFD.*RRTMIL alone"):
        survival.make_survival_engine("DTFD", torch.nn.Linear(2, 2),
                                      SurvivalEngineConfig(), sp_shards=2,
                                      device="cpu")
    with pytest.raises(ValueError, match="--model nope: unknown model"):
        cli.main(["--fold_parallel", "--model", "nope", "--results_dir",
                  str(tmp_path)])
    with pytest.raises(ValueError, match="incompatible with --sp_shards 2.*"
                                         "item 9"):
        cli.main(["--fold_parallel", "--sp_shards", "2", "--model", "RRTMIL",
                  "--results_dir", str(tmp_path)])
    for name in ("MHIM-MIL", "DTFD"):
        with pytest.raises(ValueError, match=f"--model {name}.*SurvivalEngine "
                                             f"zoo only.*as in the JAX"):
            cli.main(["--fold_parallel", "--model", name,
                      "--results_dir", str(tmp_path)])
    with pytest.raises(ValueError, match="unknown model"):
        survival.build_survival_model("nope", D_IN, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--excel_file", "x.csv", "--results_dir",
                      str(tmp_path)])


def test_fold_parallel_cli_runs_an_epoch(tmp_path):
    """`survival_main --fold_parallel` (the default MeanMIL) trains the five
    folds at once for one CPU epoch and writes the results CSV."""
    csv_file = _write_survival_csv(str(tmp_path / "data"))
    out = str(tmp_path / "out")
    # one intra-op thread: the fold-parallel CPU path is many small ops,
    # whose thread pools oversubscribe the cores under parallel workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        meter = cli.main(["--fold_parallel", "--excel_file", csv_file,
                          "--results_dir", out, "--input_dim", str(D_IN),
                          "--num_epoch", "1", "--no_log", "--device",
                          "cpu"])
    finally:
        torch.set_num_threads(threads)
    assert len(meter.cindex) == 1 + 5 + 2 and meter.epochs == ["epoch"] + \
        [0] * 5
    assert os.path.exists(os.path.join(out, "results_MeanMIL.csv"))


def test_cv_meter_writes_the_same_bytes(tmp_path):
    scores = [0.61234, 0.5, 0.77777, 1.0, 0.33333]
    meters = (survival.CVMeter(5), jsurvival.CVMeter(5))
    for m in meters:
        for e, s in enumerate(scores):
            m.update(s, e * 3)
    for m, name in zip(meters, ("port", "jax")):
        m.save(str(tmp_path / name))
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()


def test_survival_rrtmil_config_and_model_match_jax():
    for amp in (False, True):
        got = survival.survival_rrtmil_config(D_IN, epeg_k=9, crmsa_k=1,
                                              amp=amp)
        want = jsurvival.survival_rrtmil_config(D_IN, epeg_k=9, crmsa_k=1,
                                                amp=amp)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    model, enc = survival.build_survival_model("MeanMIL", D_IN,
                                               device="cpu", seed=3)
    assert isinstance(model, SurvivalHead)
    assert isinstance(model.backbone, MeanMIL)
    assert enc == survival.build_survival_model("RRTMIL", D_IN, device="cpu",
                                                seed=3)[1]
    again, _ = survival.build_survival_model("MeanMIL", D_IN, device="cpu",
                                             seed=3)
    for k, v in model.state_dict().items():
        assert torch.equal(v, again.state_dict()[k]), k


# -- run_survival_cv and learning against the JAX package --------------------

def _write_survival_csv(root, n=10, dim=D_IN, seed=0):
    """The reference's CSV over small bags (40-120 patches: one bucket),
    a planted risk on each bag's first eighth; case 2 is two files joined
    by ';'."""
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    rows = ["Study,ID,Event,Status,WSI"]
    for i in range(n):
        risk = rng.uniform()
        length = int(rng.integers(40, 120))
        bag = rng.standard_normal((length, dim)).astype(np.float32)
        bag[: length // 8] += 2.0 * risk
        paths = [os.path.join(root, f"case_{i}_{j}.npy")
                 for j in range(2 if i == 2 else 1)]
        for p, part in zip(paths, np.array_split(bag, len(paths))):
            np.save(p, part)
        rows.append(f"syn,case_{i},{2000 * (1.05 - risk):.1f},"
                    f"{int(i % 4 != 3)},{';'.join(paths)}")
    csv_file = os.path.join(root, "syn.csv")
    with open(csv_file, "w") as f:
        f.write("\n".join(rows) + "\n")
    return csv_file


def _recorder(cls, store):
    """`cls._sync_meters` (each epoch's one host sync, train and validation
    alike) recording its (summed loss, risks)."""
    orig = cls._sync_meters

    def sync(losses, risks):
        out = orig(losses, risks)
        store.append((float(out[0]), np.asarray(out[1], np.float32)))
        return out
    return staticmethod(sync)


def _assert_same_epochs(got, want, n_val):
    """Every recorded epoch's summed loss and risks within TOL; each
    validation set's risks apart by more than TOL (so equal c-indices are
    expected)."""
    assert len(got) == len(want)
    for i, ((loss, risks), (jloss, jrisks)) in enumerate(zip(got, want)):
        _close(loss, jloss, f"epoch record {i} loss")
        _close(risks, jrisks, f"epoch record {i} risks")
        if len(jrisks) == n_val:
            gaps = np.abs(jrisks[:, None] - jrisks[None, :])
            assert gaps[~np.eye(len(jrisks), dtype=bool)].min() > TOL, \
                f"epoch record {i}: two risks within {TOL}: {jrisks}"


def _surv_args(parser_mod, csv_file, out, **kw):
    args = parser_mod.parse_args(["--excel_file", csv_file, "--results_dir",
                                  out, "--input_dim", str(D_IN),
                                  "--num_epoch", "2", "--no_log"])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def test_run_survival_cv_matches_jax(tmp_path, monkeypatch):
    """MeanMIL over the five folds, two epochs each (Adam, cosine), dropout
    0, every fold from JAX's initial weights: each epoch's losses and risks
    within 1e-4, the per-fold best c-index and epoch equal, the same
    results CSV; then --evaluate --resume on the port's own .pt files gives
    each fold that saved weights its best c-index again."""
    csv_file = _write_survival_csv(str(tmp_path / "data"))
    jinit, jrec, rec = [], [], []
    orig_init, orig_build = JSurvivalEngine.init, jzoo.build_model

    def init(self, *a, **k):
        state = orig_init(self, *a, **k)
        jinit.append(jax.tree.map(np.array, state.params))
        return state
    monkeypatch.setattr(JSurvivalEngine, "init", init)
    monkeypatch.setattr(jzoo, "build_model", lambda *a, **k: orig_build(
        *a, **{**k, "dropout": 0.0}))
    monkeypatch.setattr(JSurvivalEngine, "_sync_meters",
                        _recorder(JSurvivalEngine, jrec))
    jmeter = jsurvival.run_survival_cv(
        _surv_args(jcli, csv_file, str(tmp_path / "jax")))
    assert len(jinit) == 5

    def build(name, n_features, device, seed, **kw):
        model = SurvivalHead(MeanMIL(n_features, 4, dropout=0.0))
        model.load_state_dict(flax_to_torch(jinit[0]))
        return model, survival.survival_rrtmil_config(n_features).encoder
    monkeypatch.setattr(survival, "build_survival_model", build)
    monkeypatch.setattr(SurvivalEngine, "_sync_meters",
                        _recorder(SurvivalEngine, rec))
    out = str(tmp_path / "port")
    meter = survival.run_survival_cv(_surv_args(cli, csv_file, out,
                                                device="cpu"))
    _assert_same_epochs(rec, jrec, n_val=2)
    assert (meter.cindex, meter.epochs) == (jmeter.cindex, jmeter.epochs)
    assert open(os.path.join(out, "results_MeanMIL.csv"), "rb").read() == \
        open(str(tmp_path / "jax" / "results_MeanMIL.csv"), "rb").read()

    saved = [bool(os.listdir(os.path.join(out, f"fold_{k}")))
             for k in range(5)]
    assert any(saved)
    assert all(f.endswith(".pt") for k in range(5)
               for f in os.listdir(os.path.join(out, f"fold_{k}")))
    again = survival.run_survival_cv(_surv_args(
        cli, csv_file, str(tmp_path / "ev"), device="cpu", evaluate=True,
        resume=out))
    assert [c for c, s in zip(again.cindex[1:6], saved) if s] == \
        [c for c, s in zip(meter.cindex[1:6], saved) if s]
    assert not any(f.startswith("fold_")
                   for f in os.listdir(tmp_path / "ev"))


def _rrtmil_cfgs():
    """survival_default at input 32, dropout 0, float32 products; the JAX
    model on its XLA path."""
    def one(fn, backend):
        cfg = fn()
        enc = dataclasses.replace(cfg.encoder, backend=backend,
                                  mm_dtype="float32", dropout=0.0)
        return dataclasses.replace(cfg, input_dim=D_IN, dropout=0.0,
                                   encoder=enc)
    return one(jax_survival_default, "xla"), one(survival_default, "auto")


@pytest.mark.parametrize("opt,lengths", [
    ("radam", (290, 310, 300, 320, 295, 305, 315, 298)),     # grids 32 / 24
    ("lookahead", (150, 140, 160, 145, 155, 135, 165, 148))])  # 16 / 16
def test_rrtmil_fold_learning_matches_jax(opt, lengths):
    """One fold's `learning` (2 epochs of 6 train bags, 2 validation bags)
    from the same weights: every epoch's losses and risks within 1e-4, the
    best c-index and its epoch equal."""
    jcfg, tcfg = _rrtmil_cfgs()
    rng = np.random.default_rng(7)
    bags = [rng.standard_normal((n, D_IN)).astype(np.float32)
            for n in lengths]
    for i, b in enumerate(bags):
        b[: len(b) // 8] += 0.3 * i
    events = [300.0 * (8 - i) + 17.0 * i for i in range(8)]
    status = [1, 1, 0, 1, 1, 1, 0, 1]
    train_idx, val_idx = [0, 2, 3, 5, 6, 7], [1, 4]
    kw = dict(opt=opt, lr=2e-4, num_epochs=2, seed=3)
    jmodel = JSurvivalHead(JRRTMIL(jcfg))
    params = jax.jit(lambda k: jmodel.init(
        {"params": k}, jnp.zeros((1, 64, D_IN)), length=64))(
        jax.random.PRNGKey(5))["params"]
    jeng = JSurvivalEngine(jmodel, JSurvivalEngineConfig(**kw), jcfg.encoder)
    model = SurvivalHead(RRTMIL(tcfg))
    model.load_state_dict(flax_to_torch(params))
    eng = SurvivalEngine(model, SurvivalEngineConfig(**kw), tcfg.encoder,
                         device="cpu")
    jrec, rec = [], []
    jorig, orig = JSurvivalEngine._sync_meters, SurvivalEngine._sync_meters
    try:
        JSurvivalEngine._sync_meters = _recorder(JSurvivalEngine, jrec)
        SurvivalEngine._sync_meters = _recorder(SurvivalEngine, rec)
        state = TrainState(params=params, opt_state=jeng.tx.init(params),
                           step=jnp.zeros((), jnp.int32))
        jbest = jeng.learning(state, JArraySurvDataset(bags, events, status),
                              train_idx, val_idx)
        best = eng.learning(ArraySurvivalDataset(bags, events, status),
                            train_idx, val_idx)
    finally:
        JSurvivalEngine._sync_meters = staticmethod(jorig)
        SurvivalEngine._sync_meters = staticmethod(orig)
    _assert_same_epochs(rec, jrec, n_val=2)
    assert best[:2] == jbest[:2]
    if opt == "lookahead":
        assert eng.optimizer.synced and eng.optimizer.count == 0
