"""The port's attention-MIL zoo against the JAX package on the CPU, without
the injected encoder: ABMIL, GatedABMIL, CLAM_SB / CLAM_MB (subtyping on
and off, a bag with fewer real tokens than k_sample), DSMIL and the
converter's round trip of every new parameter tree (the gated pooling and
the top-k SVM family: tests/test_torch_zoo_losses.py).

Inputs come from a numpy seed; the port's weights are its seeded init
carried to the JAX model by convert.py.  Both sides run with dropout
inactive (the port in eval mode, JAX with deterministic=True; autograd
runs either way).  Bags are padded to their bucket with a mask, as the
engines pad them.

Tolerances on max|port - jax| over max(1, max|jax|): 1e-4 on logits,
losses and every gradient.  A CLAM instance classifier outside the bag's
branch keeps `grad=None` in the port, where JAX returns an all-zero
gradient (and its optimizer treats the leaf as absent).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rrtmil_tpu.config import c16_r50 as jax_c16_r50
from rrtmil_tpu.data.bucketing import bucket_for
from rrtmil_tpu.models import zoo as jzoo
from rrtmil_tpu_torch.convert import flax_to_torch, torch_to_flax
from rrtmil_tpu_torch.models import zoo

D_IN = 24
TOL = 1e-4
ZOO = ("attmil", "gattmil", "clam_sb", "clam_mb", "dsmil")


def close(got, want, what, tol=TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max() / max(1.0, float(np.abs(want).max()))
    assert err <= tol, f"{what}: scaled error {err:.3e}"


def bag(n, seed, d=D_IN, enc=None):
    """One bag of n patches padded to its bucket: (x (1, L, d), mask (1, L),
    repr_length)."""
    spec = bucket_for(n, enc or jax_c16_r50().encoder)
    rng = np.random.default_rng(seed)
    x = np.zeros((1, spec.data_length, d), np.float32)
    x[0, :n] = rng.standard_normal((n, d))
    mask = np.zeros((1, spec.data_length), bool)
    mask[0, :n] = True
    return x, mask, spec.repr_length


def pair(name, rrt=None, jrrt=None, subtyping=False, seed=3, d=D_IN):
    """(port model in eval mode, JAX model, JAX params from the port's
    seeded init)."""
    model = zoo.build_model(name, input_dim=d, rrt_cfg=rrt,
                            subtyping=subtyping, device="cpu", seed=seed)
    kw = {"subtyping": subtyping} if name.startswith("clam") else {}
    jmodel = jzoo.build_model(name, input_dim=d, rrt=jrrt, **kw)
    params = jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))
    return model, jmodel, params


def total_loss(name, out, labels, xp):
    """The engine's objective for one bag: CE on the logits, plus CLAM's
    instance loss (0.7 / 0.3) or DSMIL's max-instance CE (0.5 / 0.5)."""
    ce = (lambda lg: -jnp.mean(jnp.take_along_axis(
        jax.nn.log_softmax(lg, -1), labels[:, None], -1))) if xp == "jax" \
        else (lambda lg: torch.nn.functional.cross_entropy(lg, labels))
    if not isinstance(out, tuple):
        return ce(out)
    if name.startswith("clam"):
        return 0.7 * ce(out[0]) + 0.3 * out[1]
    return 0.5 * ce(out[0]) + 0.5 * ce(out[1])


def check_against_jax(name, model, jmodel, params, x, mask, length,
                      label=1):
    """Forward (eval logits, the train forward's outputs and loss) and every
    gradient, port vs JAX."""
    clam = name.startswith("clam")
    jlab = jnp.asarray([label])
    jkw = {"labels": jlab} if clam else {}

    def jfwd(p, **kw):
        return jmodel.apply({"params": p}, jnp.asarray(x),
                            mask=jnp.asarray(mask), length=length,
                            deterministic=True, **kw)

    jeval, jout = jax.jit(lambda p: (jfwd(p), jfwd(p, **jkw)))(params)
    jeval = jeval[0] if isinstance(jeval, tuple) else jeval
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: total_loss(name, jfwd(p, **jkw), jlab, "jax")))(params)

    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    with torch.no_grad():
        teval = model(xt, mask=mt, length=length)
    teval = teval[0] if isinstance(teval, tuple) else teval
    close(teval.numpy(), jeval, f"{name} eval logits")
    out = model(xt, mask=mt, length=length,
                **({"label": label} if clam else {}))
    if isinstance(out, tuple):
        for i in range(2):
            close(out[i].detach().numpy(), jout[i], f"{name} output {i}")
        assert int(out[2]) == int(jout[2]) == x.shape[1]
    tloss = total_loss(name, out, torch.tensor([label]), "torch")
    close(tloss.item(), jloss, f"{name} loss")
    tloss.backward()
    want = flax_to_torch(jgrads)
    for pname, p in model.named_parameters():
        if pname not in want:        # an instance classifier JAX never made
            assert p.grad is None, pname
            continue
        if p.grad is None:
            assert clam and "instance_classifier" in pname, pname
            assert not np.any(want[pname].numpy()), pname
            continue
        close(p.grad.numpy(), want[pname], f"{name} grad {pname}")
    return model


CASES = [("attmil", False), ("gattmil", False), ("dsmil", False),
         ("clam_sb", False), ("clam_sb", True), ("clam_mb", False),
         ("clam_mb", True)]


@pytest.mark.parametrize("name,subtyping", CASES)
def test_zoo_model_matches_jax(name, subtyping):
    """Each model at input 24 on a bag of 300 patches in its 324 bucket,
    CLAM with subtyping off (one instance classifier trains, the other keeps
    grad=None) and on (both train)."""
    model, jmodel, params = pair(name, subtyping=subtyping)
    x, mask, length = bag(300, seed=1)
    check_against_jax(name, model, jmodel, params, x, mask, length,
                      label=1)
    if name.startswith("clam"):
        other = model.instance_classifier_0.weight.grad
        assert (other is not None) == subtyping


@pytest.mark.parametrize("name", ["clam_sb", "clam_mb"])
def test_clam_bag_with_fewer_real_tokens_than_k_sample(name):
    """5 real patches in a bucket of pad rows: the top and bottom 8 take
    every real row and pad rows tied at finfo.min, chosen by the lower
    index as jax.lax.top_k chooses them."""
    model, jmodel, params = pair(name, subtyping=True, seed=4)
    x, mask, length = bag(5, seed=2)
    assert x.shape[1] > 8
    check_against_jax(name, model, jmodel, params, x, mask, length,
                      label=0)


def test_topk_rows_breaks_ties_as_jax_top_k():
    from rrtmil_tpu.models.clam import _topk_select
    from rrtmil_tpu_torch.models.clam import topk_rows
    rng = np.random.default_rng(0)
    h = rng.standard_normal((40, 6)).astype(np.float32)
    s = np.round(rng.uniform(size=40), 1).astype(np.float32)   # many ties
    m = np.arange(40) < 13
    for largest in (True, False):
        want = _topk_select(jnp.asarray(h), jnp.asarray(s), jnp.asarray(m),
                            8, largest)
        got = topk_rows(torch.from_numpy(h), torch.from_numpy(s),
                        torch.from_numpy(m), 8, largest)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dsmil_unmasked_call():
    """DSMIL without a mask (every row real), on a 2-D bag."""
    model, jmodel, params = pair("dsmil", seed=5)
    x = np.random.default_rng(3).standard_normal((57, D_IN)).astype(
        np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    want = jax.jit(lambda p: jmodel.apply({"params": p}, jnp.asarray(x),
                                          deterministic=True))(params)
    for i in range(2):
        close(got[i].numpy(), want[i], f"output {i}")


# -- the converter -----------------------------------------------------------------

@pytest.mark.parametrize("name", ZOO)
def test_converter_round_trip_of_zoo_trees(name):
    """torch -> flax -> torch gives the same tensors bit for bit, and the
    flax tree has the JAX model's structure and shapes: bias-less Dense
    layers, instance_classifier_{i}, classifier_{c}, DSMIL's raw
    (C, C, 512) fcc_kernel and fcc_bias."""
    model = zoo.build_model(name, input_dim=D_IN, device="cpu", seed=1)
    sd = model.state_dict()
    tree = torch_to_flax(sd)
    back = flax_to_torch(tree)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    kw = {"labels": jnp.zeros((1,), jnp.int32)} if name.startswith("clam") \
        else {}
    jparams = jax.eval_shape(lambda: jzoo.build_model(
        name, input_dim=D_IN).init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 37, D_IN)), **kw))["params"]
    got = jax.tree_util.tree_map(np.shape, tree)
    assert got == jax.tree_util.tree_map(lambda a: a.shape, jparams)
    if name == "gattmil":
        assert "bias" not in tree["attention_a"] and \
            "bias" not in tree["attention_c"]
    if name == "dsmil":
        assert tree["b_classifier"]["fcc_kernel"].shape == (2, 2, 512)
        bound = 1.0 / np.sqrt(2 * 512)
        w = sd["b_classifier.fcc_kernel"]
        assert 0 < w.abs().max() <= bound and w.std() > bound / 3


def test_seeded_init_is_reproducible_and_seed_dependent():
    a = zoo.build_model("clam_mb", input_dim=D_IN, device="cpu", seed=2)
    b = zoo.build_model("clam_mb", input_dim=D_IN, device="cpu", seed=2)
    c = zoo.build_model("clam_mb", input_dim=D_IN, device="cpu", seed=3)
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert not torch.equal(a.fc.weight, c.fc.weight)


@pytest.mark.parametrize("name,item", [("transmil", None),
                                       ("ibmil", None),
                                       ("dtfd", "8\\(f\\)"),
                                       ("mhim", "8\\(g\\)")])
def test_unported_names_name_their_own_item(name, item):
    """transmil and ibmil (items 8(b), 8(e)) are zoo names and build; dtfd
    and mhim (items 8(f), 8(g)) train through engines of their own and,
    as in the JAX registry, are no zoo names: `build_model` fails on them
    as on any unknown name."""
    if item is None:
        assert name in zoo.model_names()
        model = zoo.build_model(name, input_dim=D_IN, device="cpu")
        with torch.no_grad():
            assert model(torch.randn(1, 40, D_IN)).shape == (1, 2)
        return
    assert name not in zoo.model_names()
    with pytest.raises(ValueError, match=f"unknown model {name!r}"):
        zoo.build_model(name, device="cpu")
