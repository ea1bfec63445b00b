"""The port's sequence sharding against the JAX package's on the CPU.

The port runs as 2 gloo ranks on the CPU (`parallel.mesh.launch`, one
launch for the module, every case in it: tests/_torch_seqshard_ranks.py);
the JAX package runs `shard_map` on the conftest's virtual CPU devices.
The inputs are seeded numpy, the JAX parameters carried across by
`convert.flax_to_torch`.  Config: tests/test_seqshard.py's `_cfg()`
(input 32, R-MSA region_num 16, EPEG k 9, CR-MSA k 3, dropout off) at
length 1000 (grid 32, 1024 tokens, 512 a rank); the port with float32
products, as the JAX model's XLA path on the CPU.

Tolerances are the JAX package's own (tests/test_seqshard.py:49,192-196):
forward atol 3e-5, loss rtol 3e-5, gradients atol 5e-5; the sharded
MaxPool's value and gradient 1e-6; the dp = 2 step's three losses within
1e-5 of max(1, |loss|) against tests/_mp_case.run_case on a dp = 2 mesh,
and within 1e-6 of the unsharded port's in one process.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from rrtmil_tpu.config import RRTEncoderConfig as JEncoderConfig
from rrtmil_tpu.config import RRTMILConfig as JRRTMILConfig
from rrtmil_tpu.config import c16_r50 as jax_c16_r50
from rrtmil_tpu.data.bucketing import bucket_for as jax_bucket_for
from rrtmil_tpu.models import RRTMIL as JRRTMIL
from rrtmil_tpu.models.pool import MaxPool as JMaxPool
from rrtmil_tpu.parallel import seqshard as jseqshard
from rrtmil_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rrtmil_tpu.train.losses import cross_entropy as jax_cross_entropy
from rrtmil_tpu_torch.config import RRTEncoderConfig, RRTMILConfig, c16_r50
from rrtmil_tpu_torch.convert import flax_to_torch
from rrtmil_tpu_torch.parallel import seqshard
from rrtmil_tpu_torch.parallel.mesh import launch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_seqshard_ranks as ranks  # noqa: E402
from _mp_case import run_case  # noqa: E402

SP = 2
LENGTH = 1000
D_IN = 32


def _jcfg():
    return JRRTMILConfig(
        input_dim=D_IN, dropout=0.0,
        encoder=JEncoderConfig(region_num=16, epeg_k=9, crmsa_k=3,
                               dropout=0.0))


def _tcfg():
    return RRTMILConfig(
        input_dim=D_IN, dropout=0.0,
        encoder=RRTEncoderConfig(region_num=16, epeg_k=9, crmsa_k=3,
                                 dropout=0.0, mm_dtype="float32"))


def _inputs(n_pad, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, n_pad, D_IN), dtype=np.float32)
    mask = (np.arange(n_pad) < LENGTH)[None]
    return x, mask, np.array([1], np.int32)


def _jax_sharded(jcfg, x, mask, labels, mesh, forward=True):
    """(params, logits or None, loss, grads) of the JAX package's sharded
    forward and value_and_grad."""
    params = jax.jit(lambda k: JRRTMIL(jcfg).init(
        {"params": k}, x, mask=mask, length=LENGTH, deterministic=True))(
        jax.random.PRNGKey(0))["params"]
    logits = None
    with mesh:
        if forward:
            _, fwd, _ = jseqshard.make_seqshard_forward(jcfg, mesh, LENGTH)
            logits = np.asarray(fwd(params, x, mask))
        _, vag, _ = jseqshard.make_seqshard_value_and_grad(
            jcfg, mesh, LENGTH, jax_cross_entropy)
        loss, grads = jax.jit(vag)(params, x, mask, labels,
                                   jax.random.PRNGKey(7))
    return params, logits, float(loss), grads


def _mp_case_params():
    """The parameters and batch of tests/_mp_case.run_case (its own
    init), for the port's dp step."""
    cfg = dataclasses.replace(jax_c16_r50(), input_dim=16, dropout=0.0)
    cfg = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, dropout=0.0))
    spec = jax_bucket_for(64, cfg.encoder)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, spec.data_length, 16)).astype(np.float32)
    mask = np.broadcast_to(np.arange(spec.data_length)[None] < 64,
                           (8, spec.data_length)).copy()
    labels = (np.arange(8) % 2).astype(np.int64)
    key = jax.random.PRNGKey(0)
    params = JRRTMIL(cfg).init({"params": key, "dropout": key},
                               jnp.asarray(x[:1]), mask=jnp.asarray(mask[:1]),
                               length=spec.repr_length,
                               deterministic=True)["params"]
    tcfg = dataclasses.replace(c16_r50(), input_dim=16, dropout=0.0)
    tcfg = dataclasses.replace(tcfg, encoder=dataclasses.replace(
        tcfg.encoder, dropout=0.0, mm_dtype="float32"))
    return {"kind": "steps", "dp": 2, "sp": 1, "cfg": tcfg,
            "params": flax_to_torch(params), "x": x, "mask": mask,
            "labels": labels, "length": spec.repr_length, "lr": 1e-3,
            "steps": 3}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through the JAX package, then the port's one launch."""
    tmp = tmp_path_factory.mktemp("seqshard")
    jcfg = _jcfg()
    n_pad = jseqshard.check_shardable(LENGTH, dataclasses.replace(
        jcfg.encoder, sp_shards=SP, sp_axis="sp"), SP)
    x, mask, labels = _inputs(n_pad)
    mesh = jax_make_mesh(dp=1, sp=SP, devices=jax.devices()[:SP])
    params, logits, loss, grads = _jax_sharded(jcfg, x, mask, labels, mesh)

    xm = np.random.default_rng(1).standard_normal((1, 64, 16)).astype(
        np.float32)
    mm = (np.arange(64) < 50)[None]
    local = shard_map(lambda a, b: JMaxPool(axis_name="sp").apply(
        {}, a, mask=b), mesh=mesh, in_specs=(P(None, "sp", None),
                                             P(None, "sp")),
        out_specs=P(None, None))
    mp_loss, mp_grad = jax.jit(jax.value_and_grad(
        lambda a: jnp.sum(local(a, mm) ** 2)))(xm)

    dp_case = _mp_case_params()
    dp_losses, _ = run_case(jax_make_mesh(dp=2, sp=1,
                                          devices=jax.devices()[:2]))

    sd = flax_to_torch(params)
    tcfg = _tcfg()
    common = {"cfg": tcfg, "params": sd, "x": x, "mask": mask,
              "labels": labels.astype(np.int64), "length": LENGTH,
              "dp": 1, "sp": SP}
    cases = {"forward": {"kind": "forward", **common},
             "value_and_grad": {"kind": "value_and_grad", **common},
             "train_step": {"kind": "train_step", **common},
             "max_pool": {"kind": "max_pool", "x": xm, "mask": mm, "sp": SP},
             "dp_steps": dp_case}
    in_path, out_path = str(tmp / "cases.pt"), str(tmp / "results.pt")
    torch.save(cases, in_path)
    launch(ranks.run, 2, device="cpu", args=(in_path, out_path),
           threads=2)
    port = torch.load(out_path, weights_only=False)
    jax_ref = {"n_pad": n_pad, "logits": logits, "loss": loss,
               "grads": flax_to_torch(grads), "max_pool": (float(mp_loss),
                                                           np.asarray(mp_grad)),
               "dp_losses": dp_losses, "dp_case": dp_case}
    return jax_ref, port


def test_seqshard_forward_matches_jax(runs):
    ref, port = runs
    assert port["forward"]["n_pad"] == ref["n_pad"] == 1024
    np.testing.assert_allclose(port["forward"]["logits"], ref["logits"],
                               atol=3e-5)


def test_seqshard_value_and_grad_matches_jax(runs):
    ref, port = runs
    got = port["value_and_grad"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=3e-5)
    assert set(got["grads"]) == set(ref["grads"])
    for name, want in ref["grads"].items():
        np.testing.assert_allclose(got["grads"][name], want.numpy(),
                                   atol=5e-5, err_msg=name)


def test_seqshard_train_step_loss_and_update(runs):
    """make_seqshard_train_step: the step's loss is the sharded loss (JAX's,
    rtol 3e-5), and its Adam update moves the parameters by at most lr
    (a first step's |m / sqrt(v)| <= 1)."""
    ref, port = runs
    got = port["train_step"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=3e-5)
    assert 0 < np.abs(got["delta"]).max() <= 2e-4 * 1.01, got["param"]


def test_sharded_max_pool_matches_jax(runs):
    ref, port = runs
    want_loss, want_grad = ref["max_pool"]
    np.testing.assert_allclose(port["max_pool"]["loss"], want_loss,
                               rtol=1e-6)
    np.testing.assert_allclose(port["max_pool"]["grad"], want_grad,
                               atol=1e-6)


def _single_process_steps(case):
    """The same steps in this process, unsharded, on the whole batch: each
    step's loss and the parameters after them."""
    from rrtmil_tpu_torch.models.rrt import RRTMIL
    from rrtmil_tpu_torch.train import losses
    from rrtmil_tpu_torch.train.optim import make_optimizer
    model = RRTMIL(case["cfg"])
    model.load_state_dict(case["params"])
    model.train()
    opt = make_optimizer("adam", model.parameters(), case["lr"], 0.0)
    x, mask, y = (torch.from_numpy(case[k]) for k in ("x", "mask", "labels"))
    out = []
    for _ in range(case["steps"]):
        loss = losses.cross_entropy(
            model(x, mask=mask, length=case["length"]), y)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        out.append(float(loss.detach()))
    return out, {k: p.detach().numpy() for k, p in model.named_parameters()}


def test_dp_step_matches_jax_mp_case(runs):
    """make_sharded_train_step at dp = 2 (each rank 4 of the 8 bags)
    against the JAX package's dp-sharded step: three Adam steps' losses,
    each within 1e-5 of max(1, |loss|) (the loss falls to 0.049 by the
    third step, where Adam's sign-sized steps on rounding-noise gradients
    leave the unsharded port 3e-6 from JAX too); and against the same three
    steps of the unsharded port in one process, within 1e-6."""
    ref, port = runs
    got = np.asarray(port["dp_steps"]["losses"])
    want = np.asarray(ref["dp_losses"])
    assert (np.abs(got - want) <= 1e-5 * np.maximum(1.0, np.abs(want))).all(), \
        (got, want)
    np.testing.assert_allclose(got, _single_process_steps(ref["dp_case"])[0],
                               rtol=1e-6)


def test_check_shardable_rejects_misaligned():
    cfg = dataclasses.replace(_tcfg().encoder, region_num=8, sp_shards=16,
                              sp_axis="sp")
    with pytest.raises(ValueError):
        seqshard.check_shardable(200, cfg, 16)


@pytest.mark.parametrize("sp", [2, 4])
def test_sharded_bucket_for_matches_jax(sp):
    """The sharded bucket of every length in a range, survival_default's
    encoder and _cfg()'s, against the JAX package's; no ranks."""
    from rrtmil_tpu.config import survival_default as jsd
    from rrtmil_tpu_torch.config import survival_default as tsd
    for jenc, tenc in ((jsd().encoder, tsd().encoder),
                       (_jcfg().encoder, _tcfg().encoder)):
        for length in list(range(1, 3000, 37)) + [45000, 50000, 60000]:
            assert seqshard.sharded_bucket_for(length, tenc, sp) == \
                jseqshard.sharded_bucket_for(length, jenc, sp), length
            n = seqshard.sharded_bucket_for(length, tenc, sp)[0]
            assert seqshard.check_shardable(n, seqshard.sharded_config(
                tenc, sp), sp) == jseqshard.check_shardable(
                n, jseqshard.sharded_config(jenc, sp), sp)


def test_a_failing_rank_stops_the_launch():
    """Rank 1 raises while rank 0 waits in a collective: the launch raises
    (rank 1's error, or rank 0's lost connection to it, whichever the
    launcher sees first), well inside the process group's timeout."""
    import time
    t0 = time.perf_counter()
    with pytest.raises(torch.multiprocessing.ProcessRaisedException):
        launch(ranks.fail_on_rank_one, 2, device="cpu")
    assert time.perf_counter() - t0 < 60


def test_sp_shards_cli_refuses_before_spawning(tmp_path, monkeypatch):
    """`survival_main --sp_shards 2` spawns nothing for a model but RRTMIL,
    nor, without a card, for the default --device cuda: it raises first."""
    from rrtmil_tpu_torch import survival_main as cli
    from rrtmil_tpu_torch.parallel import mesh
    monkeypatch.setattr(mesh, "launch", lambda *a, **k: pytest.fail(
        "ranks were spawned before the refusal"))
    common = ["--excel_file", str(tmp_path / "none.csv"), "--sp_shards", "2",
              "--results_dir", str(tmp_path / "out")]
    with pytest.raises(ValueError, match="--model MeanMIL.*RRTMIL alone"):
        cli.main(common + ["--model", "MeanMIL", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(common + ["--model", "RRTMIL"])
