"""The zoo through the port's engines against the JAX package's on the CPU:
CLAM's and DSMIL's train steps under the aux-model contract (the loss
weights, CLAM's instance loss on the host label, DSMIL's max-instance
criterion), CLAM's absent instance classifiers in Adam, DSMIL's
`ds_average` evaluation and its warm start, and the survival backbones
(AttMIL, CLAM_SB, CLAM_MB, DSMIL under `SurvivalHead`).

Weights: the port's seeded init, carried to JAX by convert.py; dropout 0
on both sides.  Tolerances as in tests/test_torch_train.py: losses within
1e-4 of max(1, |jax|) after Adam steps, parameters within Adam's drift
bound (at most 1e-3 of a tensor's elements past rtol 1e-4 / atol 1e-5 of
its scale, none by more than 2 n lr x 1.01), probabilities and risks 1e-4.
The bias of an attention scorer's last layer shifts every logit of a
softmax row alike, so its gradient is zero in exact arithmetic and
rounding noise on both sides; Adam turns that noise into lr-sized steps of
either sign, so those biases are held to the drift bound alone.
JAX's optimizer counts steps per leaf and skips a CLAM instance classifier
whose gradient is all zero; torch's Adam keeps a per-parameter `step` and
skips a parameter whose gradient is None: the counts must agree.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rrtmil_tpu.config import c16_r50 as jax_c16_r50
from rrtmil_tpu.data.datasets import ArrayDataset as JArrayDataset
from rrtmil_tpu.data.survival import ArraySurvivalDataset as JArraySurv
from rrtmil_tpu.harness import survival as jsurvival
from rrtmil_tpu.models import dsmil as jdsmil
from rrtmil_tpu.models import zoo as jzoo
from rrtmil_tpu.models.survival import SurvivalHead as JSurvivalHead
from rrtmil_tpu.train import optim as joptim
from rrtmil_tpu.train.engine import Engine as JEngine
from rrtmil_tpu.train.engine import EngineConfig as JEngineConfig
from rrtmil_tpu.train.engine import TrainState
from rrtmil_tpu.train.surv_engine import SurvivalEngine as JSurvivalEngine
from rrtmil_tpu.train.surv_engine import \
    SurvivalEngineConfig as JSurvivalEngineConfig
from rrtmil_tpu_torch.config import c16_r50
from rrtmil_tpu_torch.convert import flax_to_torch, torch_to_flax
from rrtmil_tpu_torch.data.datasets import ArrayDataset
from rrtmil_tpu_torch.data.survival import ArraySurvivalDataset
from rrtmil_tpu_torch.harness import survival
from rrtmil_tpu_torch.models import zoo
from rrtmil_tpu_torch.models.dsmil import load_warm_start
from rrtmil_tpu_torch.models.survival import SurvivalHead, risk_score
from rrtmil_tpu_torch.train.engine import Engine, EngineConfig
from rrtmil_tpu_torch.train.surv_engine import (SurvivalEngine,
                                                SurvivalEngineConfig)

D_IN = 24


def close(got, want, what, tol=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(1.0, float(np.abs(want).max()))
    assert err <= tol, f"{what}: scaled error {err:.3e}"


NOISE_ONLY = ("attn_net.attention_c.bias", "attn_net.fc2.bias")


def close_adam(got, ref, name, lr, steps, rtol=1e-4, atol=1e-5):
    scale = max(1.0, float(np.abs(ref).max()))
    diff = np.abs(got - ref) / scale
    miss = diff > atol + rtol * np.abs(ref) / scale
    assert name in NOISE_ONLY or miss.mean() <= 1e-3, \
        f"{name}: {miss.sum()} of {miss.size} miss"
    assert diff.max() <= 2 * steps * lr * 1.01 / scale, \
        f"{name}: {diff.max():.3e}"


def jax_counts(opt_state):
    """JAX's per-leaf Adam step counts, keyed by the port's parameter
    names."""
    st = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, joptim.TorchAdamState))
        if isinstance(s, joptim.TorchAdamState)][0]
    out = {}
    for path, v in jax.tree_util.tree_leaves_with_path(st.count):
        keys = [p.key for p in path]
        leaf = {"kernel": "weight", "scale": "weight"}.get(keys[-1], keys[-1])
        out[".".join(keys[:-1] + [leaf])] = int(v)
    return out


def bags_of(lengths, seed, d=D_IN):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((n, d)).astype(np.float32) for n in lengths]
    for i, b in enumerate(out):
        b[: len(b) // 8] += 0.5 * (i % 2)
    return out


@pytest.mark.parametrize("name,subtyping", [("clam_sb", False),
                                            ("clam_mb", True),
                                            ("dsmil", False)])
def test_three_aux_steps_match_jax(name, subtyping):
    """Three batch-1 steps of one bucket (labels 1, 1, 0), Adam with L2
    decay, the reference's forced loss weights: the mean loss, every
    parameter, and each parameter's Adam step count (CLAM without
    subtyping: instance_classifier_1 two steps, _0 one; with subtyping
    three each)."""
    bags = bags_of((180, 200, 150), seed=1)
    labels = [1, 1, 0]
    cls_a, aux_a = zoo.LOSS_WEIGHT_OVERRIDES[name]
    kw = dict(batch_size=1, lr=1e-3, weight_decay=1e-5, lr_schedule="cosine",
              num_epochs=4, cls_alpha=cls_a, aux_alpha=aux_a,
              aux_mode=zoo.aux_mode(name))
    enc = c16_r50().encoder
    model = zoo.build_model(name, input_dim=D_IN, dropout=0.0,
                            subtyping=subtyping, device="cpu", seed=2)
    params = jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))
    jk = {"subtyping": subtyping} if name.startswith("clam") else {}
    jeng = JEngine(jzoo.build_model(name, input_dim=D_IN, dropout=0.0, **jk),
                   JEngineConfig(num_workers=0, **kw), jax_c16_r50().encoder)
    state = TrainState(params=params, opt_state=jeng.tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    state, jloss = jeng.train_epoch(state, JArrayDataset(bags, labels), 1,
                                    jax.random.PRNGKey(0), order=[0, 1, 2])
    eng = Engine(model, EngineConfig(**kw), enc, device="cpu")
    tloss = eng.train_epoch(ArrayDataset(bags, labels), 1, order=[0, 1, 2])
    assert abs(tloss - jloss) <= 1e-4 * max(1.0, abs(jloss)), (tloss, jloss)
    want = flax_to_torch(state.params)
    counts = jax_counts(state.opt_state)
    for pname, p in eng.model.named_parameters():
        close_adam(p.detach().numpy(), want[pname].numpy(), pname, 1e-3, 3)
        step = eng.optimizer.state.get(p, {}).get("step")
        assert (0 if step is None else int(step)) == counts[pname], pname
    if name == "clam_sb":
        assert counts["instance_classifier_1.weight"] == 2
        assert counts["instance_classifier_0.weight"] == 1
    if name == "clam_mb":
        assert counts["instance_classifier_0.weight"] == 3


def test_clam_out_of_class_classifier_keeps_grad_none():
    """A camelyon16 CLAM step (subtyping off) on a bag of class 0: the class
    1 instance classifier never enters the graph, its grad stays None and
    Adam makes no state for it; every other parameter has a gradient."""
    model = zoo.build_model("clam_sb", input_dim=D_IN, dropout=0.0,
                            device="cpu", seed=0)
    eng = Engine(model, EngineConfig(aux_mode="loss", cls_alpha=0.7,
                                     aux_alpha=0.3), c16_r50().encoder,
                 device="cpu")
    seen = {}
    orig = eng._apply_grads

    def apply(lr):
        seen.update({n: p.grad is not None
                     for n, p in eng.model.named_parameters()})
        orig(lr)
    eng._apply_grads = apply
    eng.train_epoch(ArrayDataset(bags_of((90,), 3), [0]), 0, order=[0])
    absent = sorted(n for n, has in seen.items() if not has)
    assert absent == ["instance_classifier_1.bias",
                      "instance_classifier_1.weight"]
    p1 = model.instance_classifier_1.weight
    assert p1 not in eng.optimizer.state and p1.grad is None


def test_aux_engine_config_checks():
    with pytest.raises(ValueError, match="ds_average"):
        Engine(torch.nn.Linear(2, 2), EngineConfig(ds_average=True),
               device="cpu")
    with pytest.raises(ValueError, match="one bag at a time"):
        Engine(torch.nn.Linear(2, 2), EngineConfig(aux_mode="loss",
                                                   batch_size=2),
               device="cpu")


@pytest.mark.parametrize("ds_average", [False, True])
def test_dsmil_evaluate_matches_jax(ds_average):
    """DSMIL's evaluate: probabilities (with ds_average the mean of the bag
    and max-instance softmaxes) and the mean loss on the bag logits."""
    bags = bags_of((60, 130, 250), seed=4)
    labels = [0, 1, 1]
    model = zoo.build_model("dsmil", input_dim=D_IN, device="cpu", seed=5)
    params = jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))
    kw = dict(aux_mode="logits", ds_average=ds_average)
    jeng = JEngine(jzoo.build_model("dsmil", input_dim=D_IN),
                   JEngineConfig(num_workers=0, **kw), jax_c16_r50().encoder)
    jp, jl, jloss = jeng.evaluate(params, JArrayDataset(bags, labels))
    p, lab, loss = Engine(model, EngineConfig(**kw), c16_r50().encoder,
                          device="cpu").evaluate(ArrayDataset(bags, labels))
    assert lab.tolist() == jl.tolist()
    close(p, jp, "probabilities")
    close(loss, jloss, "loss")


@pytest.mark.parametrize("ext", ["npz", "pth"])
def test_dsmil_warm_start_matches_jax(tmp_path, ext):
    """--dsmil_init from a file the test writes (torch's layout, with the
    passing_v keys the model lacks): only b_classifier.q changes, as JAX's
    load_warm_start changes it."""
    rng = np.random.default_rng(6)
    sd = {"b_classifier.q.weight": rng.standard_normal((128, 512)),
          "b_classifier.q.bias": rng.standard_normal(128),
          "b_classifier.v.1.weight": rng.standard_normal((512, 512))}
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    path = str(tmp_path / f"dsmil_init.{ext}")
    if ext == "npz":
        np.savez(path, **sd)
    else:
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    model = zoo.build_model("dsmil", input_dim=D_IN, device="cpu", seed=7)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    want = flax_to_torch(jdsmil.load_warm_start(
        torch_to_flax(before), path))
    load_warm_start(model, path)
    after = model.state_dict()
    for k, v in after.items():
        assert torch.equal(v, want[k]), k
        assert torch.equal(v, before[k]) == (not k.startswith(
            "b_classifier.q.")), k
    assert torch.equal(after["b_classifier.q.weight"],
                       torch.from_numpy(sd["b_classifier.q.weight"]))


# -- survival backbones ------------------------------------------------------

@pytest.mark.parametrize("name", ["AttMIL", "CLAM_SB", "CLAM_MB", "DSMIL"])
def test_survival_backbones_match_jax(name):
    """build_survival_model's SurvivalHead(backbone) against JAX's: hazards,
    survival and risks on two bags, dropout inactive."""
    model, enc = survival.build_survival_model(name, D_IN, device="cpu",
                                               seed=8)
    jmodel, jenc = jsurvival.build_survival_model(name, D_IN)
    assert (enc.region_num, enc.epeg_k, enc.crmsa_k) == \
        (jenc.region_num, jenc.epeg_k, jenc.crmsa_k)
    params = jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))
    for n, seed in ((70, 1), (333, 2)):
        x = bags_of((n,), seed)[0][None]
        jh, js = jax.jit(lambda p: jmodel.apply(
            {"params": p}, jnp.asarray(x), deterministic=True))(params)
        with torch.no_grad():
            h, s = model(torch.from_numpy(x))
        close(h.numpy(), jh, f"{name} hazards")
        close(risk_score(s).numpy(), -jnp.sum(js, -1), f"{name} risk")


def test_survival_dsmil_learning_matches_jax():
    """DSMIL under SurvivalHead through one epoch of 4 bags and validation:
    its instance classifier is reached only through the critical
    instance's argmax, so JAX differentiates it to zero and still steps it
    (L2 decay); the port gives it a zero gradient for the same step.
    Losses, risks and every parameter against JAX's engine."""
    bags = bags_of((120, 90, 200, 150, 170, 80), seed=9)
    events = [900.0, 700.0, 500.0, 300.0, 200.0, 100.0]
    status = [1, 0, 1, 1, 0, 1]
    kw = dict(lr=1e-3, weight_decay=1e-2, num_epochs=1, seed=3)
    enc = survival.build_survival_model("DSMIL", D_IN, device="cpu")[1]
    model = SurvivalHead(zoo.build_model("dsmil", input_dim=D_IN,
                                         n_classes=4, dropout=0.0,
                                         device="cpu", seed=9))
    jmodel = JSurvivalHead(jzoo.build_model("dsmil", input_dim=D_IN,
                                            n_classes=4, dropout=0.0))
    params = jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))
    jeng = JSurvivalEngine(jmodel, JSurvivalEngineConfig(**kw),
                           jsurvival.build_survival_model("DSMIL", D_IN)[1])
    state = TrainState(params=params, opt_state=jeng.tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    state, jloss, _ = jeng.train_epoch(state, JArraySurv(bags, events,
                                                         status),
                                       [0, 1, 2, 3], 0,
                                       jax.random.PRNGKey(0))
    eng = SurvivalEngine(model, SurvivalEngineConfig(**kw), enc,
                         device="cpu")
    loss, _ = eng.train_epoch(ArraySurvivalDataset(bags, events, status),
                              [0, 1, 2, 3], 0)
    close(loss, jloss, "train loss")
    want = flax_to_torch(state.params)
    for pname, p in eng.model.named_parameters():
        close_adam(p.detach().numpy(), want[pname].numpy(), pname, 1e-3, 4)
    assert eng.optimizer.state[model.backbone.i_classifier.weight][
        "step"] == 4
    jv = jeng.validate(state.params, JArraySurv(bags, events, status), [4, 5])
    v = eng.validate(ArraySurvivalDataset(bags, events, status), [4, 5])
    close(v[0], jv[0], "validation loss")


def test_survival_refusals_name_their_items():
    """Every survival name builds: TransMIL and IBMIL (items 8(b), 8(e))
    under SurvivalHead, DTFD and MHIM-MIL (items 8(f), 8(g)) bare, without
    an encoder, as the JAX factory builds them; an unknown name raises."""
    for name in ("TransMIL", "IBMIL"):
        head, _ = survival.build_survival_model(name, D_IN, device="cpu")
        assert isinstance(head, SurvivalHead)
    for name, cls in (("DTFD", "DTFD"), ("MHIM-MIL", "MHIM")):
        model, enc = survival.build_survival_model(name, D_IN, device="cpu")
        assert type(model).__name__ == cls and enc.region_num == 16
    with pytest.raises(ValueError, match="unknown model"):
        survival.build_survival_model("MHIM-X", D_IN, device="cpu")
