"""The port's classification CLI and harness against the JAX package on the
CPU: the flag surface, the engine's augmentation and order streams, the
nsclc_plip model (`crmsa_mlp`), `run_cv` end to end, the resume semantics
and the refusals.

Tolerances: the JAX package's `auto` backend runs XLA with float32
products on the CPU, so the port runs its kernels' plain versions at
mm_dtype float32.  Logits and gradients within 1e-4 of max(1, max|jax|)
(rtol 1e-4, atol 1e-5 after that scaling; pe_bias, whose gradient is
rounding noise on both sides, atol only); engine losses 1e-5; run_cv's
probabilities and mean losses 1e-4 after two epochs of Adam from the same
weights (a weight whose gradient is rounding noise can step the other way,
2 lr at most, and changes no logit), and the five scores equal.
"""
import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

import main as jcli
from rrtmil_tpu.config import nsclc_plip as jax_nsclc_plip
from rrtmil_tpu.data.bucketing import bucket_for as jax_bucket_for
from rrtmil_tpu.data.datasets import ArrayDataset as JArrayDataset
from rrtmil_tpu.harness import classification as jclassification
from rrtmil_tpu.models.rrt import RRTMIL as JRRTMIL
from rrtmil_tpu.train.engine import Engine as JEngine
from rrtmil_tpu.train.engine import EngineConfig as JEngineConfig
from rrtmil_tpu.train.engine import TrainState
from rrtmil_tpu_torch import main as cli
from rrtmil_tpu_torch.config import nsclc_plip
from rrtmil_tpu_torch.convert import flax_to_torch, torch_to_flax
from rrtmil_tpu_torch.data.datasets import ArrayDataset
from rrtmil_tpu_torch.harness import classification
from rrtmil_tpu_torch.models import rrt
from rrtmil_tpu_torch.models.rrt import RRTMIL, init_parameters
from rrtmil_tpu_torch.train.engine import (FIXED_LOADER_SEED, Engine,
                                           EngineConfig)

D_IN = 32


def _write_c16(root, n=12, dim=D_IN, seed=0):
    """tests/test_harness.py's synthetic camelyon16 layout, every bag in one
    bucket (65-256 patches: a 16 x 16 grid), so the JAX side compiles each
    step once a fold."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "pt"))
    signal = rng.normal(size=(dim,))
    signal /= np.linalg.norm(signal)
    rows = []
    for i in range(n):
        length = int(rng.integers(70, 250))
        bag = rng.normal(size=(length, dim)).astype(np.float32)
        if i % 2:
            bag[: length // 8] += 2.5 * signal
        np.save(os.path.join(root, "pt", f"slide_{i:03d}.npy"), bag)
        rows.append(f"slide_{i:03d},{i % 2}\n")
    with open(os.path.join(root, "label.csv"), "w") as f:
        f.write("".join(rows))


def _args(parser_mod, tmp_path, title, **overrides):
    args = parser_mod.build_parser().parse_args([])
    args.dataset_root = str(tmp_path / "data")
    args.model_path = str(tmp_path / "out")
    args.title = title
    args.input_dim, args.cv_fold, args.num_epoch = D_IN, 2, 2
    args.epeg_k, args.crmsa_k = 9, 1
    args.patch_shuffle = True
    for k, v in overrides.items():
        setattr(args, k, v)
    return parser_mod.postprocess_args(args)


def _close(got, want, name, rtol=1e-4, atol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    if "pe_bias" in name:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)
        return
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=rtol,
                               atol=atol, err_msg=name)


# -- the CLI surface ---------------------------------------------------------

def test_flag_surface_is_main_pys_plus_device(tmp_path):
    """Every flag of the JAX package's main.py with its default (the
    store_false inversions included), plus --device; the same post-parse
    overrides for camelyon16 and tcga."""
    jp, p = jcli.build_parser(), cli.build_parser()
    jflags = {s for a in jp._actions for s in a.option_strings}
    flags = {s for a in p._actions for s in a.option_strings}
    assert flags == jflags | {"--device"}
    want, got = vars(jp.parse_args([])), vars(p.parse_args([]))
    assert got.pop("device") == "cuda" and got == want
    inverted = ["--epeg", "--cr_msa", "--qkv_bias", "--epeg_bias",
                "--early_stopping"]
    assert not any(vars(p.parse_args(inverted))[f[2:]] for f in inverted)
    for datasets in ("camelyon16", "tcga"):
        argv = ["--datasets", datasets, "--model_path", str(tmp_path)]
        a = cli.postprocess_args(p.parse_args(argv))
        ja = jcli.postprocess_args(jp.parse_args(argv))
        assert {k: v for k, v in vars(a).items() if k != "device"} == \
            vars(ja)


def test_amp_maps_to_bf16_compute_and_transfer():
    args = cli.build_parser().parse_args(["--amp", "--crmsa_mlp"])
    enc = classification.encoder_config_from_args(args)
    ecfg = classification.engine_config_from_args(args)
    assert enc.compute_dtype == "bfloat16" and enc.crmsa_mlp
    assert ecfg.transfer_dtype == "bfloat16"
    assert ecfg.device_cache_bytes == 6 << 30
    plain = classification.engine_config_from_args(
        cli.build_parser().parse_args([]))
    assert plain.transfer_dtype == "float32" and plain.num_workers == 2


@pytest.mark.parametrize("argv,err,match", [
    (["--model", "mhim"], ValueError, "unknown model"),
    (["--model", "dtfd"], None, None),
    (["--fold_parallel", "--model", "dtfd"], ValueError,
     "unknown model 'dtfd'"),
    (["--device", "cuda"], RuntimeError, "no CUDA device"),
    (["--fold_parallel"], None, None),
    (["--fold_parallel", "--accumulation_steps", "2"], ValueError,
     "accumulation_steps"),
    (["--fold_parallel", "--lr_supi"], ValueError, "lr_supi"),
    (["--fold_parallel", "--auto_resume"], ValueError, "auto_resume")])
def test_refusals(tmp_path, monkeypatch, argv, err, match):
    """mhim (a survival model alone, as in the JAX registry) fails as an
    unknown model; --fold_parallel with dtfd (an unknown zoo name on the
    JAX package's fold-parallel path), with accumulation, a per-iteration
    schedule or --auto_resume, and the card when there is none raise, each
    before any work; dtfd runs one fold on the CPU, and --fold_parallel (the
    default rrtmil) both folds at once, one epoch."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if err is None:
        _write_c16(str(tmp_path / "c16"), n=8)
        threads = torch.get_num_threads()
        if "--fold_parallel" in argv:
            # the fold-parallel CPU path is many small ops, whose thread
            # pools oversubscribe the cores under parallel test workers
            torch.set_num_threads(1)
        try:
            metrics = cli.main(argv + [
                "--model_path", str(tmp_path), "--dataset_root",
                str(tmp_path / "c16"), "--input_dim", str(D_IN),
                "--cv_fold", "2", "--fold_start", "1", "--num_epoch", "1",
                "--device", "cpu"])
        finally:
            torch.set_num_threads(threads)
        # --fold_start picks the sequential harness's first fold; the folds
        # trained at once are all of them, as in the JAX package
        n = 2 if "--fold_parallel" in argv else 1
        assert len(metrics["auc"]) == n and np.isfinite(metrics["auc"]).all()
        return
    with pytest.raises(err, match=match):
        cli.main(argv + ["--model_path", str(tmp_path),
                         "--dataset_root", str(tmp_path / "absent")])


# -- the engine's streams ----------------------------------------------------

class _JTiny(fnn.Module):
    @fnn.compact
    def __call__(self, x, mask=None, length=None, deterministic=True):
        m = mask[..., None].astype(x.dtype)
        pooled = (x * m).sum(1) / m.sum(1)
        # order-sensitive: the first patches weigh more, so the shuffle shows
        w = 1.0 / (1.0 + jnp.arange(x.shape[1], dtype=x.dtype))[None, :, None]
        first = (x * m * w).sum(1)
        return fnn.Dense(2, name="fc")(jnp.concatenate([pooled, first], -1))


class _TTiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(2 * 8, 2)

    def forward(self, x, mask=None, length=None, generator=None):
        m = mask[..., None].to(x.dtype)
        w = 1.0 / (1.0 + torch.arange(x.shape[1], dtype=x.dtype))[None, :,
                                                                   None]
        pooled = (x * m).sum(1) / m.sum(1)
        return self.fc(torch.cat([pooled, (x * m * w).sum(1)], -1))


@pytest.mark.parametrize("aug,group,fixed", [("patch_shuffle", 0, False),
                                             ("patch_shuffle", 4, True),
                                             ("group_shuffle", 3, False)])
def test_engine_streams_match_jax(aug, group, fixed):
    """Two epochs with a shuffle augmentation, the train order drawn from
    the engine (one stream with the augmentations unless fix_loader_random
    pins it): the same losses and the same `_rng` / order states after."""
    rng = np.random.default_rng(7)
    bags = [(rng.standard_normal((n, 8)) + i % 2).astype(np.float32)
            for i, n in enumerate((70, 90, 120, 200, 80))]
    labels = [i % 2 for i in range(5)]
    kw = {aug: True, "shuffle_group": group, "fix_loader_random": fixed,
          "lr": 1e-2, "num_epochs": 3, "seed": 11}
    jmodel = _JTiny()
    p = jmodel.init({"params": jax.random.PRNGKey(1)},
                    jnp.zeros((1, 8, 8)), mask=jnp.ones((1, 8), bool))
    p = p["params"]
    jeng = JEngine(jmodel, JEngineConfig(**kw))
    state = TrainState(params=p, opt_state=jeng.tx.init(p),
                       step=jnp.zeros((), jnp.int32))
    model = _TTiny()
    model.load_state_dict(flax_to_torch(p))
    eng = Engine(model, EngineConfig(**kw), device="cpu")
    for epoch in range(2):
        state, jloss = jeng.train_epoch(state, JArrayDataset(bags, labels),
                                        epoch, jax.random.PRNGKey(0))
        loss = eng.train_epoch(ArrayDataset(bags, labels), epoch)
        assert abs(loss - jloss) <= 1e-5, (epoch, loss, jloss)
    assert eng._rng.bit_generator.state == jeng._rng.bit_generator.state
    assert eng._order_rng.bit_generator.state == \
        jeng._order_rng.bit_generator.state
    assert (eng._order_rng is eng._rng) == (not fixed)


# -- nsclc_plip (crmsa_mlp) --------------------------------------------------

def _nsclc_cfgs(input_dim=64, compute="float32"):
    def one(fn, backend):
        cfg = fn()
        enc = dataclasses.replace(cfg.encoder, backend=backend,
                                  mm_dtype="float32", dropout=0.0,
                                  compute_dtype=compute)
        return dataclasses.replace(cfg, input_dim=input_dim, dropout=0.0,
                                   encoder=enc)
    return one(jax_nsclc_plip, "xla"), one(nsclc_plip, "auto")


def _nsclc_batch(enc, lengths=(937, 200), seed=2):
    spec = jax_bucket_for(max(lengths), enc)
    rng = np.random.default_rng(seed)
    x = np.zeros((len(lengths), spec.data_length, 64), np.float32)
    mask = np.zeros((len(lengths), spec.data_length), bool)
    for i, n in enumerate(lengths):
        x[i, :n] = rng.standard_normal((n, 64))
        mask[i, :n] = True
    return x, mask, spec.repr_length


def test_nsclc_plip_logits_and_gradients_match_jax(monkeypatch):
    """nsclc_plip (EPEG k = 13, CR-MSA k = 3 with one 512-wide head and the
    phi MLP) at input width 64, two bags of 937 and 200 patches in one
    bucket: the logits and every parameter's gradient against the JAX
    package (backend 'xla', float32 products).  The port's R-MSA layer runs
    K1 (its plain version here), the CR-MSA layer the XLA route around K5,
    never K3 / K8 / K12 / K13."""
    jcfg, tcfg = _nsclc_cfgs()
    model = RRTMIL(tcfg)
    init_parameters(model, torch.Generator().manual_seed(4))
    params = jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))
    assert {"phi_fc1", "phi_fc2"} <= set(
        params["online_encoder"]["cr_msa"]["attn"])
    x, mask, length = _nsclc_batch(jcfg.encoder)
    labels = np.array([1, 0])
    jmodel = JRRTMIL(jcfg)

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x),
                              mask=jnp.asarray(mask), length=length,
                              deterministic=True)
        logp = jax.nn.log_softmax(logits, -1)
        return -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(labels)[:, None], -1)), logits

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)

    calls = []
    for name in ("region_layer_fused", "region_block_fused",
                 "crmsa_compress_grid", "crmsa_compress",
                 "crmsa_redistribute", "crmsa_redistribute_grid",
                 "crmsa_redistribute_grid_ln"):
        def spy(*a, _fn=getattr(rrt, name), _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(rrt, name, spy)
    model = RRTMIL(tcfg).train()
    model.load_state_dict(flax_to_torch(params))
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    assert not rrt.fused_crmsa_ok(tcfg.encoder.crmsa_layer(), xt, mt, length)
    logits = model(xt, mask=mt, length=length)
    loss = torch.nn.functional.cross_entropy(logits,
                                             torch.from_numpy(labels))
    loss.backward()
    assert sorted(calls) == ["region_block_fused", "region_layer_fused"]
    _close(logits.detach().numpy(), np.asarray(jlogits), "logits")
    assert abs(loss.item() - float(jloss)) <= 1e-5
    want = flax_to_torch(jgrads)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, prm in got.items():
        _close(prm.grad.numpy(), want[name].numpy(), name)


def test_nsclc_plip_amp_forward_matches_jax():
    """--amp: flax's Dense promotes a bfloat16 stream against float32
    kernels to float32 (so the phi MLP's logits are float32, as the port
    computes them), and the bf16 forward of nsclc_plip stays within bf16
    rounding (2e-2 of max(1, max|jax|)) of the JAX package's."""
    dense = fnn.Dense(4, use_bias=False)
    xb = jnp.ones((2, 8), jnp.bfloat16)
    out = dense.apply(dense.init(jax.random.PRNGKey(0), xb), xb)
    assert out.dtype == jnp.float32
    jcfg, tcfg = _nsclc_cfgs(compute="bfloat16")
    model = RRTMIL(tcfg)
    init_parameters(model, torch.Generator().manual_seed(5))
    params = jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))
    x, mask, length = _nsclc_batch(jcfg.encoder, lengths=(600,))
    jmodel = JRRTMIL(jcfg)
    want = jax.jit(lambda p: jmodel.apply(
        {"params": p}, jnp.asarray(x), mask=jnp.asarray(mask), length=length,
        deterministic=True))(params)
    with torch.no_grad():
        got = model(torch.from_numpy(x), mask=torch.from_numpy(mask),
                    length=length)
    _close(got.numpy(), np.asarray(want), "logits", rtol=0, atol=2e-2)


# -- run_cv ------------------------------------------------------------------

def _recording(cls, store):
    """`cls` with every `evaluate` result appended to `store`."""
    orig = cls.evaluate

    def evaluate(self, *a, **k):
        out = orig(self, *a, **k)
        store.append(out)
        return out
    return evaluate


def test_run_cv_matches_jax(tmp_path, monkeypatch):
    """The JAX package's run_cv and the port's on one synthetic camelyon16
    set (2 folds, 2 epochs, dropout 0, --patch_shuffle), each fold starting
    from JAX's initial weights carried through convert.py: every evaluate
    (each epoch's validation and the final test with the fold's best-AUC
    weights) within 1e-4, the five scores of each fold equal, and the
    checkpoint families written."""
    _write_c16(str(tmp_path / "data"))
    over = dict(dropout=0.0, trans_drop_out=0.0)
    jinit, jevals, evals = [], [], []
    orig_init = JEngine.init

    def init(self, *a, **k):
        state = orig_init(self, *a, **k)
        jinit.append(jax.tree.map(np.array, state.params))
        return state
    monkeypatch.setattr(JEngine, "init", init)
    monkeypatch.setattr(JEngine, "evaluate", _recording(JEngine, jevals))
    jmetrics = jclassification.run_cv(_args(jcli, tmp_path, "jax", **over))
    assert len(jinit) == 2
    jax.tree.map(np.testing.assert_array_equal, jinit[0], jinit[1])

    def model_cfg(args):
        cfg = orig_cfg(args)
        return dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, mm_dtype="float32"))

    def build(cfg, device, seed):
        model = RRTMIL(cfg)
        model.load_state_dict(flax_to_torch(jinit[0]))
        return model.to(device).eval()
    orig_cfg = classification.model_config_from_args
    monkeypatch.setattr(classification, "model_config_from_args", model_cfg)
    monkeypatch.setattr(classification, "build_model", build)
    monkeypatch.setattr(Engine, "evaluate", _recording(Engine, evals))
    args = _args(cli, tmp_path, "port", device="cpu", **over)
    metrics = classification.run_cv(args)

    assert len(evals) == len(jevals) == 2 * 3
    for (p, l, loss), (jp, jl, jloss) in zip(evals, jevals):
        assert l.tolist() == jl.tolist()
        np.testing.assert_allclose(p, jp, rtol=0, atol=1e-4)
        assert abs(loss - jloss) <= 1e-4
    for key in ("acs", "auc", "pre", "rec", "fs"):
        assert metrics[key] == jmetrics[key], key
    for fold in range(2):
        assert os.path.exists(os.path.join(
            args.model_path, f"fold_{fold}_model_best_auc.pt"))
    assert {"ckp.pt", "ckp_host.pkl"} <= set(os.listdir(args.model_path))


class _Interrupt(Exception):
    pass


def _engine_class(record, stop_at=None, order_at=None, base=Engine):
    """A harness Engine (or `base`) recording each train epoch's order and
    the weights after it and, at each fold's close, its streams' states;
    raising `_Interrupt` at (fold, epoch) `stop_at`; training (fold, epoch)
    `order_at[0]` in the order `order_at[1]`."""
    class Recorder(base):
        def train_epoch(self, dataset, epoch, order=None):
            if (self.fold, epoch) == stop_at:
                raise _Interrupt
            if order_at is not None and (self.fold, epoch) == order_at[0]:
                order = order_at[1]
            if order is None:
                g = np.random.default_rng()
                g.bit_generator.state = copy.deepcopy(
                    self._order_rng.bit_generator.state)
                record[("order", self.fold, epoch)] = \
                    g.permutation(len(dataset)).tolist()
            loss = super().train_epoch(dataset, epoch, order)
            # the weights after the fold's last epoch (close() sees the
            # best-AUC weights the final test loaded)
            record[("final", self.fold)] = copy.deepcopy(
                self.model.state_dict())
            return loss

        def close(self):
            record[("rng", self.fold)] = self._rng.bit_generator.state
            record[("torch_rng", self.fold)] = self.generator.get_state()
            super().close()
    return Recorder


def test_resume_keeps_the_jax_semantics(tmp_path, monkeypatch):
    """A run (dropout on, --patch_shuffle) interrupted in fold 0 after its
    epoch 0 and restarted with --auto_resume ends as the JAX package's
    semantics say: the uninterrupted run in every respect but one, the
    train order of the resumed epoch, which restarts from the order
    stream's first permutation (JAX restores `_rng` into a new object and
    keeps the order stream that Engine.__init__ made).  So it equals an
    uninterrupted run handed that order: the same best-AUC and final
    weights, metrics and final generator and `_rng` states, fold 1
    included."""
    _write_c16(str(tmp_path / "data"))
    interrupted, resumed, reference = {}, {}, {}
    monkeypatch.setattr(classification, "Engine",
                        _engine_class(interrupted, stop_at=(0, 1)))
    with pytest.raises(_Interrupt):
        classification.run_cv(_args(cli, tmp_path, "resume", device="cpu"))
    monkeypatch.setattr(classification, "Engine", _engine_class(resumed))
    res_args = _args(cli, tmp_path, "resume", device="cpu", auto_resume=True)
    m_res = classification.run_cv(res_args)

    perms = np.random.default_rng(FIXED_LOADER_SEED)
    first, second = (perms.permutation(6).tolist() for _ in range(2))
    # the quirk: the resumed epoch redraws epoch 0's order, not epoch 1's
    assert interrupted[("order", 0, 0)] == first
    assert resumed[("order", 0, 1)] == first != second
    assert ("order", 0, 0) not in resumed

    monkeypatch.setattr(classification, "Engine", _engine_class(
        reference, order_at=((0, 1), first)))
    ref_args = _args(cli, tmp_path, "reference", device="cpu")
    m_ref = classification.run_cv(ref_args)
    assert reference[("order", 0, 0)] == first
    assert reference[("order", 1, 1)] == resumed[("order", 1, 1)] == second
    assert m_res == m_ref
    for fold in range(2):
        assert resumed[("rng", fold)] == reference[("rng", fold)]
        assert torch.equal(resumed[("torch_rng", fold)],
                           reference[("torch_rng", fold)])
        name = f"fold_{fold}_model_best_auc.pt"
        for got, want in (
                (torch.load(os.path.join(res_args.model_path, name)),
                 torch.load(os.path.join(ref_args.model_path, name))),
                (resumed[("final", fold)], reference[("final", fold)])):
            assert got.keys() == want.keys()
            for k in got:
                assert torch.equal(got[k], want[k]), (fold, k)
