"""The port's TransMIL against the JAX package on the CPU: logits and every
gradient on bags of {30, 37, 300} patches at input width 64 (wrap-padded
squares of 6, 7 and 18: 6, 12 and 24 copied rows), the wrap pad's copies
of real tokens, the classification and survival cls-token std, the
engine's exact mode (one bag a batch, padded to its true length, no device
cache), and two dropout-off train steps through the classification
harness's pieces (`build_model_from_args`, `engine_config_from_args`)
against the JAX harness's.

Weights: the port's seeded init carried to JAX by convert.py.  Dropout
off on both sides: the port in eval mode (autograd runs either way), JAX
with deterministic=True; for the train steps the Nystrom layers' fixed
0.1 dropout is set to 0 on both sides (JAX's through the config its
layers build).  Tolerances: logits 1e-5 absolute (the JAX package's own
bound against the reference is 6e-4, tests/test_zoo_parity.py:95-97; the
two agree to ~1e-6), gradients 1e-4 of max(1, max|jax|), train losses
1e-4, parameters after Adam within its drift bound.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import main as jcli
from rrtmil_tpu.config import NystromConfig as JNystromConfig
from rrtmil_tpu.data.datasets import ArrayDataset as JArrayDataset
from rrtmil_tpu.harness import classification as jclassification
from rrtmil_tpu.models import transmil as jtransmil
from rrtmil_tpu.train.engine import Engine as JEngine
from rrtmil_tpu.train.engine import TrainState
from rrtmil_tpu_torch import main as cli
from rrtmil_tpu_torch.convert import flax_to_torch, torch_to_flax
from rrtmil_tpu_torch.data.datasets import ArrayDataset
from rrtmil_tpu_torch.harness import classification, survival
from rrtmil_tpu_torch.models import zoo
from rrtmil_tpu_torch.models.nystrom import NystromAttention
from rrtmil_tpu_torch.train.engine import Engine, EngineConfig

from test_torch_harness import _args

D_IN = 64


def close(got, want, what, tol=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max() / max(1.0, float(np.abs(want).max()))
    assert err <= tol, f"{what}: scaled error {err:.3e}"


def no_attn_dropout(model):
    for m in model.modules():
        if isinstance(m, NystromAttention):
            m.p = 0.0
    return model


def bags(lengths, seed, d=D_IN):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((n, d)).astype(np.float32) for n in lengths]
    for i, b in enumerate(out):
        b[: len(b) // 8] += 0.5 * (i % 2)
    return out


@pytest.mark.parametrize("n", [30, 37, 300])
def test_logits_and_gradients_match_jax(n):
    model = zoo.build_model("transmil", input_dim=D_IN, device="cpu", seed=n)
    params = jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))
    jmodel = jtransmil.TransMIL(input_dim=D_IN, n_classes=2)
    x = bags([n], n)[0][None]

    def jloss(p):
        lg = jmodel.apply({"params": p}, jnp.asarray(x), deterministic=True)
        return -jax.nn.log_softmax(lg, -1)[0, 1], lg

    (jl, jlogits), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    logits = model(torch.from_numpy(x))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=0, atol=1e-5)
    loss = -torch.log_softmax(logits, -1)[0, 1]
    assert abs(loss.item() - float(jl)) <= 1e-5
    loss.backward()
    want = flax_to_torch(jgrads)
    assert set(want) == {k for k, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        close(p.grad.numpy(), want[name].numpy(), f"{name} grad at n={n}")


def test_bf16_bag_is_read_in_float32_as_flax_promotes_it():
    """--amp sends bf16 bags; flax's Dense promotes a bf16 input against
    its float32 kernel to float32, so TransMIL runs in float32 on the
    bag's bf16 values: the port's logits equal its logits on the same
    values in float32, and JAX's on the bf16 bag within 1e-5."""
    model = zoo.build_model("transmil", input_dim=D_IN, device="cpu", seed=4)
    params = jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))
    x = torch.from_numpy(bags([37], 4)[0][None]).to(torch.bfloat16)
    with torch.no_grad():
        got = model(x)
        assert got.dtype == torch.float32
        assert torch.equal(got, model(x.float()))
    want = jax.jit(lambda p, xx: jtransmil.TransMIL(
        input_dim=D_IN, n_classes=2).apply({"params": p}, xx))(
        params, jnp.asarray(x.float().numpy(), jnp.bfloat16))
    assert want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_wrap_pad_copies_real_tokens_and_length_selects_rows():
    """The square's extra rows are the bag's leading real tokens after
    fc1 (not zeros), behind the cls token; `length` keeps the leading
    rows of a longer input, so trailing rows change nothing."""
    model = zoo.build_model("transmil", input_dim=D_IN, device="cpu", seed=1)
    seen = []
    model.layer1.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    x = torch.from_numpy(bags([37], 2)[0][None])
    with torch.no_grad():
        out = model(x)
        h = seen[0]
        assert h.shape == (1, 1 + 49, 512)
        assert torch.equal(h[:, 0], model.cls_token[:, 0])
        assert torch.equal(h[:, 38:], h[:, 1:13]) and h[:, 38:].abs().sum() > 0
        longer = torch.cat([x, torch.randn(1, 20, D_IN)], dim=1)
        torch.testing.assert_close(model(longer, length=37), out, rtol=0,
                                   atol=0)


def test_cls_token_std_classification_and_survival():
    cls = zoo.build_model("transmil", input_dim=D_IN, device="cpu").cls_token
    assert 0.8 < cls.std().item() < 1.2
    head, _ = survival.build_survival_model("TransMIL", D_IN, device="cpu")
    s = head.backbone.cls_token
    assert 0 < s.abs().max().item() < 1e-5 and s.std().item() > 3e-7
    assert head.backbone.requires_exact


def test_exact_mode_pads_each_bag_to_its_length_and_skips_the_cache():
    """Exact mode: one bag a batch whatever batch_size says, padded to its
    true length (`length` = that length, the mask all True), and the
    device bag cache never consulted, even when forced on."""
    lengths = (30, 37, 300, 5)
    ds = ArrayDataset(bags(lengths, 3), [0, 1, 0, 1])
    model = zoo.build_model("transmil", input_dim=D_IN, device="cpu")
    eng = Engine(model, EngineConfig(batch_size=4, exact=True,
                                     device_cache="on", num_workers=0),
                 device="cpu")
    batches = eng._batched_order(ds, [2, 0, 3, 1])
    assert batches == [[2], [0], [3], [1]]
    for b in batches:
        x, mask, labels, spec = eng._make_batch(ds, b, train=True)
        n = lengths[b[0]]
        assert x.shape == (1, n, D_IN) and mask.all()
        assert spec.repr_length == spec.data_length == n
    assert eng._dcache is None
    probs, labels, loss = eng.evaluate(ds)
    assert probs.shape == (4,) and np.isfinite(loss) and eng._dcache is None
    bucketed = Engine(model, EngineConfig(batch_size=4, num_workers=0),
                      device="cpu")
    x = bucketed._make_batch(ds, [0], train=False)[0]
    assert x.shape[1] > 30


def test_harness_sets_exact_mode_for_transmil_only(tmp_path):
    for name, exact in (("transmil", True), ("attmil", False)):
        args = cli.postprocess_args(cli.build_parser().parse_args(
            ["--model", name, "--model_path", str(tmp_path)]))
        assert classification.engine_config_from_args(args).exact == exact
        model, _ = classification.build_model_from_args(args, "cpu")
        assert getattr(model, "requires_exact", False) == exact


def test_two_train_steps_through_the_harness_match_jax(tmp_path,
                                                       monkeypatch):
    """Two batch-1 Adam steps (bags of 45 and 120 patches, dropout off)
    from the same weights, each side's model and engine config from its
    own harness: the mean loss within 1e-4, every parameter within Adam's
    drift bound, and the evaluate afterwards within 1e-4."""
    monkeypatch.setattr(jtransmil, "NystromConfig", lambda **kw:
                        JNystromConfig(**{**kw, "dropout": 0.0}))
    over = dict(model="transmil", dropout=0.0, input_dim=D_IN,
                patch_shuffle=False)
    train = bags((45, 120), 7)
    labels = [0, 1]
    jargs = _args(jcli, tmp_path, "jax", **over)
    jmodel, jenc = jclassification.build_model_from_args(jargs)
    jcfg = jclassification.engine_config_from_args(jargs)
    jcfg.num_workers = 0
    assert jcfg.exact
    jeng = JEngine(jmodel, jcfg, encoder_cfg=jenc)

    args = _args(cli, tmp_path, "port", device="cpu", **over)
    model, enc = classification.build_model_from_args(args, "cpu")
    no_attn_dropout(model)
    params = jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))
    state = TrainState(params=params, opt_state=jeng.tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    state, jloss = jeng.train_epoch(state, JArrayDataset(train, labels), 0,
                                    jax.random.PRNGKey(0), order=[0, 1])
    jprobs, _, jeval = jeng.evaluate(state.params,
                                     JArrayDataset(train, labels))

    ecfg = classification.engine_config_from_args(args)
    assert ecfg.exact and dataclasses.asdict(ecfg)["batch_size"] == 1
    eng = Engine(model, ecfg, enc, device="cpu")
    loss = eng.train_epoch(ArrayDataset(train, labels), 0, order=[0, 1])
    assert abs(loss - jloss) <= 1e-4 * max(1.0, abs(jloss)), (loss, jloss)
    want = flax_to_torch(state.params)
    for name, p in eng.model.named_parameters():
        ref = want[name].numpy()
        scale = max(1.0, float(np.abs(ref).max()))
        diff = np.abs(p.detach().numpy() - ref) / scale
        assert diff.max() <= 2 * 2 * ecfg.lr * 1.01 / scale, name
        assert (diff > 1e-5 + 1e-4 * np.abs(ref) / scale).mean() <= 1e-3, \
            name
    probs, _, ev = eng.evaluate(ArrayDataset(train, labels))
    np.testing.assert_allclose(probs, jprobs, rtol=0, atol=1e-4)
    assert abs(ev - jeval) <= 1e-4


def test_both_clis_train_and_evaluate_transmil(tmp_path):
    """`python -m rrtmil_tpu_torch.main --model transmil` (2 folds x 1
    epoch) and `survival_main --model TransMIL` (5 folds x 1 epoch) on the
    CPU: finite metrics and c-indices."""
    from rrtmil_tpu_torch import survival_main as scli

    from test_torch_harness import _write_c16
    from test_torch_survival_cli import _write_survival_csv
    _write_c16(str(tmp_path / "c16"), n=8, dim=D_IN)
    metrics = cli.main(["--model", "transmil", "--dataset_root",
                        str(tmp_path / "c16"), "--model_path",
                        str(tmp_path / "m"), "--input_dim", str(D_IN),
                        "--cv_fold", "2", "--num_epoch", "1", "--device",
                        "cpu"])
    assert all(np.isfinite(metrics[k]).all() and len(metrics[k]) == 2
               for k in ("acs", "auc", "pre", "rec", "fs"))
    csv_file = _write_survival_csv(str(tmp_path / "surv"))
    meter = scli.main(["--excel_file", csv_file, "--results_dir",
                       str(tmp_path / "s"), "--model", "TransMIL",
                       "--input_dim", "32", "--num_epoch", "1", "--device",
                       "cpu"])
    assert len(meter.cindex) == 1 + 5 + 2
    assert all(np.isfinite(c) for c in meter.cindex[1:])
