"""The port's sequence sharding over 4 ranks against the JAX package's on
the CPU: the forward, loss and gradients at sp = 4 with the attention
pool, the gated attention pool and the mean pool (tests/test_seqshard.py:
151-200, which found the last two pooling the local shard only before
they were made sp-exact), and with the CR-MSA phi MLP (`crmsa_mlp`, whose
sharded layer gathers the representatives around torch ops); and
`make_sharded_train_step` on a (2, 2) mesh (two bags, each over two
ranks) against the unsharded port's steps in one process: the first loss
rtol 1e-6, the second within 1e-4 of max(1, |loss|) and the parameters
within Adam's drift bound (2 x steps x lr x 1.01), since Adam's sign-sized
first steps turn the sharded sums' other rounding on noise-level gradients
into steps of up to lr either way.  One launch of 4 gloo ranks for the module; the JAX package on
4 of the conftest's virtual CPU devices; tests/test_torch_seqshard.py's
config, inputs and tolerances (forward atol 3e-5, loss rtol 3e-5,
gradients atol 5e-5).
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax

from rrtmil_tpu.config import PoolConfig as JPoolConfig
from rrtmil_tpu.parallel import seqshard as jseqshard
from rrtmil_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rrtmil_tpu_torch.config import PoolConfig
from rrtmil_tpu_torch.convert import flax_to_torch
from rrtmil_tpu_torch.parallel.mesh import launch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_seqshard_ranks as ranks  # noqa: E402
from test_torch_seqshard import (LENGTH, _inputs, _jax_sharded,  # noqa: E402
                                 _jcfg, _single_process_steps, _tcfg)

SP = 4
POOLS = {"gated": dict(kind="attn", gated=True), "avg": dict(kind="avg")}
VARIANTS = ["attn", "gated", "avg", "mlp"]


def _variant(name):
    jcfg, tcfg = _jcfg(), _tcfg()
    if name in POOLS:
        return (dataclasses.replace(jcfg, pool=JPoolConfig(**POOLS[name])),
                dataclasses.replace(tcfg, pool=PoolConfig(**POOLS[name])))
    if name == "mlp":
        return tuple(dataclasses.replace(c, encoder=dataclasses.replace(
            c.encoder, crmsa_mlp=True)) for c in (jcfg, tcfg))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seqshard_pools")
    mesh = jax_make_mesh(dp=1, sp=SP, devices=jax.devices()[:SP])
    n_pad = jseqshard.check_shardable(LENGTH, dataclasses.replace(
        _jcfg().encoder, sp_shards=SP, sp_axis="sp"), SP)
    x, mask, labels = _inputs(n_pad, seed=2)
    ref, cases = {}, {}
    for name in VARIANTS:
        jcfg, tcfg = _variant(name)
        params, logits, loss, grads = _jax_sharded(
            jcfg, x, mask, labels, mesh, forward=True)
        ref[name] = {"logits": logits, "loss": loss,
                     "grads": flax_to_torch(grads)}
        common = {"cfg": tcfg, "params": flax_to_torch(params), "x": x,
                  "mask": mask, "labels": labels.astype(np.int64),
                  "length": LENGTH, "dp": 1, "sp": SP}
        cases[f"{name}_forward"] = {"kind": "forward", **common}
        cases[f"{name}_value_and_grad"] = {"kind": "value_and_grad",
                                           **common}
    x2 = np.concatenate([x, _inputs(n_pad, seed=3)[0]])
    cases["dp_sp_steps"] = {
        "kind": "steps", "dp": 2, "sp": 2, "cfg": _tcfg(),
        "params": cases["attn_forward"]["params"], "x": x2,
        "mask": np.repeat(mask, 2, 0), "labels": np.array([0, 1]),
        "length": LENGTH, "lr": 1e-3, "steps": 2}
    ref["dp_sp_steps"] = _single_process_steps(cases["dp_sp_steps"])
    in_path, out_path = str(tmp / "cases.pt"), str(tmp / "results.pt")
    torch.save(cases, in_path)
    launch(ranks.run, SP, device="cpu", args=(in_path, out_path), threads=2)
    return ref, torch.load(out_path, weights_only=False)


@pytest.mark.parametrize("pool", VARIANTS)
def test_seqshard_forward_at_sp4_matches_jax(runs, pool):
    ref, port = runs
    assert port[f"{pool}_forward"]["n_pad"] == 1024
    np.testing.assert_allclose(port[f"{pool}_forward"]["logits"],
                               ref[pool]["logits"], atol=3e-5)


@pytest.mark.parametrize("pool", VARIANTS)
def test_seqshard_pool_value_and_grad_at_sp4_match_jax(runs, pool):
    ref, port = runs
    got = port[f"{pool}_value_and_grad"]
    np.testing.assert_allclose(got["loss"], ref[pool]["loss"], rtol=3e-5)
    assert set(got["grads"]) == set(ref[pool]["grads"])
    for name, want in ref[pool]["grads"].items():
        np.testing.assert_allclose(got["grads"][name], want.numpy(),
                                   atol=5e-5, err_msg=name)


def test_dp_sp_step_matches_the_unsharded_steps(runs):
    """make_sharded_train_step on a (2, 2) mesh (the sequence-sharded twin
    sharing the model's parameters) against two Adam steps of the
    unsharded port on both bags in one process."""
    ref, port = runs
    got = port["dp_sp_steps"]
    (l1, l2), params = ref["dp_sp_steps"]
    np.testing.assert_allclose(got["losses"][0], l1, rtol=1e-6)
    assert abs(got["losses"][1] - l2) <= 1e-4 * max(1.0, abs(l2))
    for name, want in params.items():
        diff = np.abs(got["params"][name] - want).max()
        assert diff <= 2 * 2 * 1e-3 * 1.01, (name, diff)
