"""The encoder's variants against the JAX package on the CPU: each position
embedding (`--pos` ppeg / peg / sincos / ape) at `--pos_pos` -1 and 0
with n_layers 2 and 3, and Nystrom attention inside the regions
(`--region_attn ntrans`) or over the stream (`--attn ntrans`).

The encoder is c16_r50's (dim 512, 8 x 64 heads, EPEG k = 15, CR-MSA k =
1, the global shortcut), dropout 0, on a bag of 150 patches padded to its
bucket with a mask; the port takes its fused structure (the kernels' plain
versions on the CPU, float32 products), the JAX encoder its XLA path.
Output and every gradient within 1e-4 of max(1, max|jax|).  With
n_layers 2 and pos_pos 0 the embedding applies nowhere: neither side has
`pos_embedding` params.  The Nystrom cases use region_num 2 and 2 heads of
16 (`trans_dim`): every region is padded to 256 landmarks on both sides.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rrtmil_tpu.config import PosEmbedConfig as JPos
from rrtmil_tpu.config import c16_r50 as jax_c16_r50
from rrtmil_tpu.data.bucketing import bucket_for
from rrtmil_tpu.models.rrt import RRTEncoder as JRRTEncoder
from rrtmil_tpu_torch.config import PosEmbedConfig, c16_r50
from rrtmil_tpu_torch.convert import flax_to_torch, torch_to_flax
from rrtmil_tpu_torch.models import posemb
from rrtmil_tpu_torch.models.rrt import RRTEncoder, init_parameters

TOL = 1e-4
KINDS = ("ppeg", "peg", "sincos", "ape")


def close(got, want, what, tol=TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(1.0, float(np.abs(want).max()))
    assert err <= tol, f"{what}: scaled error {err:.3e}"


def encoders(**kw):
    """(port encoder config, JAX encoder config): c16_r50's, dropout 0,
    float32 products, with `kw` (a `pos` given as a dict)."""
    pos = kw.pop("pos", None)
    enc = dataclasses.replace(c16_r50().encoder, backend="auto",
                              mm_dtype="float32", dropout=0.0, **kw)
    jenc = dataclasses.replace(jax_c16_r50().encoder, backend="xla",
                               mm_dtype="float32", dropout=0.0, **kw)
    if pos is not None:
        enc = dataclasses.replace(enc, pos=PosEmbedConfig(**pos))
        jenc = dataclasses.replace(jenc, pos=JPos(**pos))
    return enc, jenc


def bag(n, jenc, seed):
    spec = bucket_for(n, jenc)
    rng = np.random.default_rng(seed)
    x = np.zeros((1, spec.data_length, 512), np.float32)
    x[0, :n] = rng.standard_normal((n, 512))
    mask = np.zeros((1, spec.data_length), bool)
    mask[0, :n] = True
    return x, mask, spec.repr_length


def check(enc, jenc, n=150, seed=0):
    """Encoder output and every gradient of sum(out * w), port vs JAX;
    returns the port's parameter names."""
    model = RRTEncoder(enc)
    init_parameters(model, torch.Generator().manual_seed(seed))
    params = jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))
    jmodel = JRRTEncoder(jenc)
    jshapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 512)),
        mask=jnp.ones((1, 64), bool), length=64))["params"]
    assert jax.tree.map(np.shape, params) == jax.tree.map(
        lambda a: a.shape, jshapes)
    x, mask, length = bag(n, jenc, seed + 1)
    w = np.random.default_rng(seed + 2).standard_normal(x.shape) \
        .astype(np.float32)

    def jfwd(p, xx):
        return jmodel.apply({"params": p}, xx, mask=jnp.asarray(mask),
                            length=length, deterministic=True)

    def jloss(p, xx):
        out = jfwd(p, xx)
        return jnp.sum(out * w), out

    (_, jout), (jgrads, jdx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = model(xt, mask=torch.from_numpy(mask), length=length)
    close(out.detach().numpy(), jout, "encoder output")
    (out * torch.from_numpy(w)).sum().backward()
    close(xt.grad.numpy(), jdx, "dx")
    want = flax_to_torch(jgrads)
    for name, p in model.named_parameters():
        close(p.grad.numpy(), want[name].numpy(), f"{name} grad")
    return [k for k, _ in model.named_parameters()]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("pos_pos,n_layers", [(-1, 2), (-1, 3), (0, 3)])
def test_position_embedding_matches_jax(kind, pos_pos, n_layers):
    enc, jenc = encoders(n_layers=n_layers,
                         pos=dict(kind=kind, pos_pos=pos_pos))
    names = check(enc, jenc, seed=n_layers)
    own = [k for k in names if k.startswith("pos_embedding.")]
    assert bool(own) == (kind in ("ppeg", "peg", "ape"))


@pytest.mark.parametrize("kind", KINDS)
def test_default_depth_at_pos_pos_0_builds_no_embedding(kind):
    """n_layers 2, pos_pos 0: the embedding would sit before layer 1,
    which does not exist; no module and no params on either side, and the
    output is the encoder's without it."""
    enc, jenc = encoders(pos=dict(kind=kind, pos_pos=0))
    model = RRTEncoder(enc)
    assert model.pos_embedding is None
    assert not any(k.startswith("pos_embedding") for k in model.state_dict())
    jshapes = jax.eval_shape(lambda: JRRTEncoder(jenc).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 512)),
        mask=jnp.ones((1, 64), bool), length=64))["params"]
    assert "pos_embedding" not in jshapes
    plain = RRTEncoder(encoders()[0])
    init_parameters(plain, torch.Generator().manual_seed(0))
    model.load_state_dict(plain.state_dict())
    x, mask, length = bag(100, jenc, 3)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    with torch.no_grad():
        assert torch.equal(model(xt, mt, length), plain(xt, mt, length))


@pytest.mark.parametrize("where", ["region_attn", "attn_mode"])
def test_nystrom_variants_match_jax(where):
    """Nystrom inside each region (R-MSA layer unfused, the CR-MSA layer
    fused) or over the whole stream (the R-MSA layers replaced)."""
    enc, jenc = encoders(region_num=2, n_heads=2, trans_dim=16,
                         **{where: "ntrans"})
    names = check(enc, jenc, n=37, seed=5)
    assert "layer0.attn.to_qkv.weight" in names or \
        "layer0.attn.attn.to_qkv.weight" in names


def test_wrap_pad_copies_leading_tokens_and_restores_the_length():
    x = torch.arange(2 * 10 * 3, dtype=torch.float32).reshape(2, 10, 3)
    xs, side, add = posemb.square_wrap_pad(x[:, :7], 7)
    assert (side, add) == (3, 2)
    assert torch.equal(xs[:, 7:], x[:, :2])
    out = posemb.restore(xs, 7, 10)
    assert torch.equal(out[:, :7], x[:, :7]) and not out[:, 7:].any()


@pytest.mark.parametrize("cls_name", ["PPEG", "PEG"])
@pytest.mark.parametrize("conv_1d", [False, True])
def test_conv_embeddings_below_a_7x7_square_match_jax(cls_name, conv_1d):
    """PPEG's H < 7 branch (zero rows up to 7 x 7 before the convs) and
    PEG, at 20 true rows of a 30-row input (a 5 x 5 wrap-padded square),
    with 2-D and 1-D kernels."""
    from rrtmil_tpu.models import posemb as jposemb
    module = getattr(posemb, cls_name)(64, 7, True, conv_1d)
    init_parameters(module, torch.Generator().manual_seed(1))
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            torch.nn.init.normal_(p, generator=torch.Generator()
                                  .manual_seed(2))
    params = jax.tree.map(jnp.asarray, torch_to_flax(module.state_dict()))
    x = np.random.default_rng(4).standard_normal((2, 30, 64)) \
        .astype(np.float32)
    want = getattr(jposemb, cls_name)(64, 7, True, conv_1d).apply(
        {"params": params}, jnp.asarray(x), length=20)
    with torch.no_grad():
        got = module(torch.from_numpy(x), length=20)
    close(got.numpy(), want, f"{cls_name} conv_1d={conv_1d}", tol=1e-5)
    assert not got[:, 20:].any()
    # the R-MSA kernel reads the stream in place: a square input of its
    # full length comes back contiguous too
    with torch.no_grad():
        assert module(torch.from_numpy(x[:, :25])).is_contiguous()


@pytest.mark.parametrize("case", ["transmil", "ibmil", "ppeg", "peg",
                                  "sincos", "ape", "ntrans"])
def test_converter_round_trips_every_new_tree(case):
    """torch_to_flax(flax_to_torch(p)) == p for the JAX tree of TransMIL,
    IBMIL with prototypes, and RRTMIL with each --pos kind (pos_pos -1) or
    Nystrom regions; flax_to_torch(p) loads into the port's model
    strictly, so every name and layout maps."""
    from rrtmil_tpu.models import zoo as jzoo
    from rrtmil_tpu_torch.config import RRTMILConfig
    from rrtmil_tpu_torch.models import zoo

    conf = np.ones((3, 512), np.float32)
    if case in ("transmil", "ibmil"):
        kw = {"confounders": conf} if case == "ibmil" else {}
        model = zoo.build_model(case, input_dim=16, device="cpu", **kw)
        jmodel = jzoo.build_model(case, input_dim=16, confounders=tuple(
            map(tuple, conf.tolist())) if kw else None)
    else:
        over = dict(pos=dict(kind=case, pos_pos=-1)) if case != "ntrans" \
            else dict(region_attn="ntrans")
        enc, jenc = encoders(**over)
        model = zoo.build_model("rrtmil", rrtmil_cfg=RRTMILConfig(
            input_dim=16, encoder=enc), device="cpu")
        jmodel = jzoo.build_model("rrtmil", input_dim=16, rrt=jenc)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 16)),
        mask=jnp.ones((1, 64), bool), length=64))["params"]
    rng = np.random.default_rng(0)
    p = jax.tree.map(lambda s: rng.standard_normal(s.shape)
                     .astype(np.float32), shapes)
    sd = flax_to_torch(p)
    model.load_state_dict(sd, strict=True)
    back = torch_to_flax(sd)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(p)
    jax.tree.map(np.testing.assert_array_equal, back, p)
