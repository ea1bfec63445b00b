"""The encoder geometries of `--n_heads 16` / `--n_heads 4` (R-MSA head
widths 32 and 128, with EPEG k = 15 and without it), `--crmsa_heads 16`
(CR-MSA head width 32) and `--crmsa_k 12`, against the JAX package on the
CPU, and the CLIs' refusal of the geometries the card's kernels do not take.

c16_r50's encoder cut to 2 layers (one R-MSA, one CR-MSA layer) over a
32-wide input (JAX hard-codes the 512-wide encoder), two bags in one
bucket-padded batch: the port's model on the kernels' plain versions
against the JAX model with its Pallas kernels in interpret mode, from one
set of weights.  The case with EPEG at `--n_heads 16` also carries
`--crmsa_heads 16` and `--crmsa_k 12` (one JAX compile for the three).
The logits and the gradients of every parameter with float32 products
within 1e-4 of max(1, max|jax|) here; the logits with bfloat16 products in
test_torch_geometry_bf16.py (JAX's CPU backend cannot run a bf16 x bf16 ->
f32 dot inside a vjp).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rrtmil_tpu.config import c16_r50 as jax_c16_r50
from rrtmil_tpu.data.bucketing import bucket_for as jax_bucket_for
from rrtmil_tpu.models.rrt import RRTMIL as JRRTMIL
from rrtmil_tpu_torch import main as cli
from rrtmil_tpu_torch import survival_main as scli
from rrtmil_tpu_torch.config import RRTEncoderConfig, c16_r50
from rrtmil_tpu_torch.convert import flax_to_torch
from rrtmil_tpu_torch.harness import classification, survival
from rrtmil_tpu_torch.models.rrt import RRTMIL, kernel_geometry_error

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
D_IN = 32
LENGTHS = (200, 130)
CASES = {
    "n_heads16_epeg_crmsa_heads16_k12": dict(n_heads=16, crmsa_heads=16,
                                             crmsa_k=12),
    "n_heads16": dict(n_heads=16, epeg=False),
    "n_heads4_epeg": dict(n_heads=4),
    "n_heads4": dict(n_heads=4, epeg=False),
}


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _cfg(fn, case, mm):
    base = fn()
    enc = dataclasses.replace(base.encoder, n_layers=2, epeg_k=15,
                              backend="pallas", mm_dtype=mm, **CASES[case])
    return dataclasses.replace(base, input_dim=D_IN, encoder=enc)


def _batch(cfg):
    spec = jax_bucket_for(max(LENGTHS), cfg.encoder)
    rng = np.random.default_rng(16)
    x = np.zeros((2, spec.data_length, D_IN), np.float32)
    mask = np.zeros((2, spec.data_length), bool)
    for i, n in enumerate(LENGTHS):
        x[i, :n] = rng.standard_normal((n, D_IN))
        mask[i, :n] = True
    return x, mask, spec.repr_length


@pytest.fixture(scope="module")
def interpret():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RRTMIL_PALLAS_INTERPRET", "1")
        yield


def _jax_init(jcfg):
    init = JRRTMIL(dataclasses.replace(jcfg, encoder=dataclasses.replace(
        jcfg.encoder, backend="xla")))
    return jax.jit(lambda k: init.init(
        {"params": k}, jnp.zeros((1, 64, D_IN), jnp.float32), length=64))(
        jax.random.PRNGKey(16))["params"]


@pytest.mark.parametrize("case", list(CASES))
def test_geometry_logits_and_gradients_match_jax(case, interpret):
    """float32 products: the logits and every parameter's gradient of
    sum(logits * c) against jax.value_and_grad of the JAX model (its Pallas
    kernels in interpret mode, their custom vjps)."""
    jcfg, tcfg = _cfg(jax_c16_r50, case, "float32"), \
        _cfg(c16_r50, case, "float32")
    params = _jax_init(jcfg)
    x, mask, length = _batch(jcfg)
    cot = np.random.default_rng(17).standard_normal((2, 2)).astype(np.float32)
    model = JRRTMIL(jcfg)

    def loss(p, x, m):
        logits = model.apply({"params": p}, x, mask=m, length=length,
                             deterministic=True)
        return jnp.sum(logits * cot), logits
    (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, jnp.asarray(x), jnp.asarray(mask))
    port = RRTMIL(tcfg).eval()
    port.load_state_dict(flax_to_torch(params))
    got = port(torch.from_numpy(x), mask=torch.from_numpy(mask),
               length=length)
    (got * torch.from_numpy(cot)).sum().backward()
    err = _scaled_err(got.detach().numpy(), want)
    assert err <= TOL["float32"], f"{case} logits: {err:.3e}"
    want_g = flax_to_torch(jax.tree.map(np.asarray, jgrads))
    for name, p in port.named_parameters():
        err = _scaled_err(p.grad.numpy(), want_g[name].numpy())
        assert err <= TOL["float32"], f"{case} d{name}: {err:.3e}"


# ---------------------------------------------------------------------------
# what the card's kernels do not take: refused by the CLIs before any work
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("over,ok", [
    (dict(), True), (dict(n_heads=16), True), (dict(n_heads=4), True),
    (dict(n_heads=2, epeg=False), True), (dict(crmsa_heads=16), True),
    (dict(crmsa_k=16), True), (dict(n_heads=2), False),
    (dict(n_heads=1), False), (dict(n_heads=32), False),
    (dict(n_heads=3), False), (dict(crmsa_heads=32), False),
    (dict(crmsa_k=17), False), (dict(epeg_k=129), False)])
def test_kernel_geometry_error_names_the_roadmap_item(over, ok):
    err = kernel_geometry_error(RRTEncoderConfig(**over))
    if ok:
        assert err is None
    else:
        assert "ROADMAP.md queue 3 item 1" in err


def test_shared_memory_is_named_where_it_is_the_reason():
    err = kernel_geometry_error(RRTEncoderConfig(n_heads=1))
    assert "358912 bytes of shared memory" in err


@pytest.mark.parametrize("argv", [["--n_heads", "1"], ["--crmsa_k", "17"],
                                  ["--model", "attmil", "--only_rrt_enc",
                                   "--crmsa_heads", "32"]])
def test_classification_cli_refuses_before_any_work(tmp_path, argv,
                                                    monkeypatch):
    """On the card (--device cuda) the CLI raises before it reads a bag;
    on the CPU the plain versions run the same flags."""
    monkeypatch.setattr(classification, "make_splits", lambda *a: (
        pytest.fail("work began before the geometry was refused")))
    args = cli.build_parser().parse_args(
        ["--dataset_root", str(tmp_path / "none"), "--model_path",
         str(tmp_path / "out"), "--device", "cuda"] + argv)
    with pytest.raises(ValueError, match="ROADMAP.md queue 3 item 1"):
        classification.run_cv(cli.postprocess_args(args))
    args.device = "cpu"
    classification.check_args(args)


def test_survival_cli_refuses_before_any_work(tmp_path, monkeypatch):
    monkeypatch.setattr(survival, "SurvivalDataset", lambda *a, **k: (
        pytest.fail("work began before the geometry was refused")))
    for fold_parallel in ([], ["--fold_parallel"]):
        with pytest.raises(ValueError, match="ROADMAP.md queue 3 item 1"):
            scli.main(["--excel_file", str(tmp_path / "none.csv"),
                       "--model", "RRTMIL", "--crmsa_k", "20",
                       "--results_dir", str(tmp_path / "out"),
                       "--device", "cuda"] + fold_parallel)
