"""Head width 512 (the CR-MSA of `crmsa_heads=1` configs such as brca_r50)
and the kernels' in-place operand descriptions, against the JAX package on
the CPU.

* brca_r50's model (EPEG k = 17 in R-MSA, CR-MSA k = 3 with one 512-wide
  head) on a masked, bucket-padded batch of two bags, logits against the
  JAX model with its Pallas kernels in interpret mode;
* K5 (`region_block_fused`) with one 512-wide head: the forward against
  `_block_fwd_pallas` in interpret mode, the gradients against the vjp of
  `_block_ref` (whose attention core is the Pallas forward and backward in
  interpret mode), as region_block.py's own `_bwd` differentiates it;
* K6 / K7's plain versions at hd = 512 against the Pallas kernels;
* `layout`: each description, gathered back with torch.as_strided, is the
  tensor the kernels must read, for every layout the model passes.

Tolerances on max|port - jax| over max(1, max|jax|): 1e-4 with float32
products (the same fp32 arithmetic summed in another order), 2e-2 with
bfloat16 products (a sum next to a bf16 rounding boundary rounds the other
way).  JAX's CPU backend cannot run a bf16 x bf16 -> f32 dot inside a vjp,
so the gradients are held in float32 products only.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rrtmil_tpu.config import brca_r50 as jax_brca_r50
from rrtmil_tpu.data.bucketing import bucket_for as jax_bucket_for
from rrtmil_tpu.models.rrt import RRTMIL as JRRTMIL
from rrtmil_tpu.ops.pallas.region_attn import _fused_fwd_pallas
from rrtmil_tpu.ops.pallas.region_attn_bwd import region_attention_bwd_pallas
from rrtmil_tpu.ops.pallas.region_block import _block_fwd_pallas, _block_ref
from rrtmil_tpu_torch.config import InnerAttentionConfig, brca_r50
from rrtmil_tpu_torch.convert import flax_to_torch
from rrtmil_tpu_torch.models.rrt import RRTMIL, InnerAttention
from rrtmil_tpu_torch.ops.kernels import layout
from rrtmil_tpu_torch.ops.kernels import region_attn as ra
from rrtmil_tpu_torch.ops.kernels import region_attn_bwd as rab
from rrtmil_tpu_torch.ops.kernels import region_block as rb

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MM = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
C, HD = 128, 512          # one 512-wide head over C = 128 (C % 128 == 0)
BLOCK_GRADS = ("dx", "dwq", "dwk", "dwv", "dbq", "dbk", "dbv", "dwp", "dbp")


def _close(got, want, mm, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= TOL[mm], f"{what} {mm}: scaled error {err:.3e}"


def _interpret(monkeypatch):
    monkeypatch.setenv("RRTMIL_PALLAS_INTERPRET", "1")


# ---------------------------------------------------------------------------
# the whole model at brca_r50's encoder settings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
def test_brca_r50_logits_match_jax(mm, monkeypatch):
    """brca_r50 cut to a 64-wide input (JAX hard-codes the 512-wide
    encoder), bags of 937 and 700 patches in one bucket-padded batch."""
    def cfg_of(fn, backend):
        cfg = fn()
        return dataclasses.replace(cfg, input_dim=64, encoder=dataclasses
                                   .replace(cfg.encoder, backend=backend,
                                            mm_dtype=mm))
    jcfg, tcfg = cfg_of(jax_brca_r50, "pallas"), cfg_of(brca_r50, "pallas")
    assert tcfg.encoder.crmsa_layer().crmsa.attn.resolved_head_dim == 512
    init = JRRTMIL(dataclasses.replace(jcfg, encoder=dataclasses.replace(
        jcfg.encoder, backend="xla")))
    params = jax.jit(lambda k: init.init(
        {"params": k}, jnp.zeros((1, 64, 64), jnp.float32), length=64))(
        jax.random.PRNGKey(4))["params"]
    lengths = (937, 700)
    spec = jax_bucket_for(max(lengths), jcfg.encoder)
    rng = np.random.default_rng(4)
    x = np.zeros((2, spec.data_length, 64), np.float32)
    mask = np.zeros((2, spec.data_length), bool)
    for i, n in enumerate(lengths):
        x[i, :n] = rng.standard_normal((n, 64))
        mask[i, :n] = True
    _interpret(monkeypatch)
    model = JRRTMIL(jcfg)
    want = jax.jit(lambda p, x, m: model.apply(
        {"params": p}, x, mask=m, length=spec.repr_length,
        deterministic=True))(params, jnp.asarray(x), jnp.asarray(mask))
    port = RRTMIL(tcfg).eval()
    port.load_state_dict(flax_to_torch(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x), mask=torch.from_numpy(mask),
                   length=spec.repr_length)
    _close(got.numpy(), want, mm, "brca_r50 logits")


# ---------------------------------------------------------------------------
# K5, K6, K7 with one 512-wide head
# ---------------------------------------------------------------------------

def _block_inputs(rng, r=3, p=16):
    s = np.sqrt(2.0 / (C + HD))
    f = lambda *shape, sc=s: (rng.standard_normal(shape) * sc).astype(
        np.float32)
    scale = HD ** -0.5
    x = rng.standard_normal((r, p, C)).astype(np.float32)
    w = (f(1, C, HD) * scale, f(1, C, HD), f(1, C, HD),
         f(1, HD, sc=0.05) * scale, f(1, HD, sc=0.05), f(1, HD, sc=0.05),
         None, None, f(1, HD, C), f(C, sc=0.05))
    return x, w


@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
def test_k5_forward_at_head_width_512_matches_pallas(mm):
    x, w = _block_inputs(np.random.default_rng(30))
    jmm, tmm = MM[mm]
    want = _block_fwd_pallas(jnp.asarray(x), *[None if a is None else
                                               jnp.asarray(a) for a in w],
                             mm_dtype=jmm, interpret=True)
    got = rb.region_block_fused(torch.from_numpy(x),
                                *[None if a is None else torch.from_numpy(a)
                                  for a in w], mm_dtype=tmm)
    _close(got.numpy(), want, mm, "K5 hd=512")


def test_k5_gradients_at_head_width_512_match_jax(monkeypatch):
    """The port's K5 backward (autograd through `block_ref`, K6 and K7's
    plain versions) against jax.vjp of `_block_ref` (the Pallas core and its
    backward in interpret mode), float32 products."""
    rng = np.random.default_rng(31)
    x, w = _block_inputs(rng)
    g = rng.standard_normal(x.shape).astype(np.float32)
    _interpret(monkeypatch)
    diff = (x,) + w[:6] + w[8:]          # without the absent EPEG taps

    def f(x_, wq, wk, wv, bq, bk, bv, wp, bp):
        return _block_ref(x_, wq, wk, wv, bq, bk, bv, None, None, wp, bp,
                          mm_dtype=jnp.float32)
    _, vjp = jax.vjp(f, *[jnp.asarray(a) for a in diff])
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in diff]
    y = rb.region_block_fused(*leaves[:7], None, None, *leaves[7:],
                              mm_dtype=torch.float32)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    for name, a, b in zip(BLOCK_GRADS, got, want):
        _close(a.numpy(), b, "float32", f"K5 hd=512 {name}")


@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
def test_k6_k7_plain_at_head_width_512_match_pallas(mm):
    rng = np.random.default_rng(32)
    q, k, v, g = (rng.standard_normal((3, 1, 16, HD)).astype(np.float32)
                  for _ in range(4))
    scale = HD ** -0.5
    jmm, tmm = MM[mm]
    j = [jnp.asarray(a) for a in (q, k, v)]
    t = [torch.from_numpy(a) for a in (q, k, v)]
    want = _fused_fwd_pallas(*j, None, None, scale=scale, mm_dtype=jmm,
                             interpret=True)
    got = ra.region_attention_fused(*t, None, None, scale, tmm)
    _close(got.numpy(), want, mm, "K6 hd=512")
    want = region_attention_bwd_pallas(*j, None, None, jnp.asarray(g),
                                       scale=scale, mm_dtype=jmm,
                                       interpret=True)
    got = rab.region_attention_bwd(*t, None, None, torch.from_numpy(g), scale,
                                   tmm)
    for name, a, b in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        _close(a.numpy(), b, mm, f"K7 hd=512 {name}")
    assert got[3] is None and got[4] is None


@pytest.mark.parametrize("hd,kk,ok", [(64, 15, True), (128, 0, True),
                                      (512, 0, True), (128, 15, True),
                                      (32, 0, True), (32, 15, True),
                                      (96, 0, True), (96, 15, True),
                                      (256, 15, False), (512, 15, False),
                                      (80, 0, False), (16, 0, False),
                                      (576, 0, False)])
def test_head_widths_the_cores_take(hd, kk, ok):
    """Any multiple of 32 up to 512 without EPEG, up to 128 with it, for
    every caller (K1 / K2 included: --n_heads 16, 8 and 4 give 32, 64 and
    128); a width that is no multiple of 32, past 512, or past 128 with
    EPEG raises.  Past 128 taps raises too."""
    w = torch.zeros(1, 8, hd)
    pw = torch.zeros(1, kk) if kk else None
    if ok:
        assert ra.check_heads(w, pw) == kk
    else:
        with pytest.raises(ValueError, match="head_dim"):
            ra.check_heads(w, pw)
    with pytest.raises(ValueError, match="taps"):
        ra.check_heads(torch.zeros(1, 8, 64), torch.zeros(1, ra.MAX_KK + 1))


# ---------------------------------------------------------------------------
# operand descriptions
# ---------------------------------------------------------------------------

def _module(h, hd):
    torch.manual_seed(h)
    mod = InnerAttention(InnerAttentionConfig(dim=512, num_heads=h,
                                              head_dim=hd))
    with torch.no_grad():
        mod.qkv.bias.normal_()
        mod.proj.bias.normal_()
    return mod


def _weight_layouts():
    """(name, wq, wk, wv, wp) as the model hands them to K5
    (`kernel_weights()`: views of the Linear weights, 8 x 64 and 1 x 512
    heads) and as contiguous tensors."""
    out = []
    for h, hd in ((8, 64), (1, 512)):
        wq, wk, wv, *_, wp, _ = _module(h, hd).kernel_weights()
        out.append((f"kernel_weights {h}x{hd}", wq, wk, wv, wp))
        out.append((f"contiguous {h}x{hd}", *(t.detach().contiguous()
                                              for t in (wq, wk, wv, wp))))
    return out


@pytest.mark.parametrize("i", range(4))
def test_weight_descriptions_gather_the_weights(i):
    name, wq, wk, wv, wp = _weight_layouts()[i]
    h, c, hd = wq.shape
    for w in (wq, wk, wv):
        got = layout.gather(w, (c, h * hd), layout.qkv_cols(w))
        assert torch.equal(got, w.permute(1, 0, 2).reshape(c, h * hd)), name
    got = layout.gather(wp, (h * hd, c), layout.proj_rows(wp))
    assert torch.equal(got, wp.reshape(h * hd, c)), name
    if name.startswith("kernel_weights"):
        # views of the Linear weights: wk / wv share qkv.weight's storage
        assert wk.untyped_storage().data_ptr() == \
            wv.untyped_storage().data_ptr()
        assert layout.qkv_cols(wk) == layout.qkv_cols(wq)


def test_kernel_weights_reach_k5_without_a_copy(monkeypatch):
    """What K5's wrapper hands `rl_block`: the weights' own pointers (wk
    one 512 x 512 block into qkv.weight) with their shared description, and
    the B = 1 cross-region view's own strides."""
    mod = _module(1, 512)
    w = mod.kernel_weights()
    x = torch.randn(1, 64, 3, 512).transpose(1, 2).reshape(3, 64, 512)
    assert not x.is_contiguous()
    assert layout.rows(x) == (64, 512, 3 * 512)
    ptrs, desc, _ = rb.qkv_args(*w[:6])
    assert ptrs == (w[0].data_ptr(), w[1].data_ptr(), w[2].data_ptr())
    assert w[1].data_ptr() == mod.qkv.weight.data_ptr() + 512 * 512 * 4
    assert desc == layout.qkv_cols(w[0])


@pytest.mark.parametrize("case", ["contiguous", "cross_region_b1",
                                  "packed_heads", "k7_operands"])
def test_row_and_head_descriptions_gather_the_tensor(case):
    """x (R, P, C) rows and q (R, H, P, hd) heads as the model passes them:
    contiguous, the B = 1 cross-region view (k = 3 rows of 64 regions),
    q / k / v as views of one packed (R, P, 3, H, hd) tensor, and K7's
    operands: q / k / v so, 128 wide, with g an (R, H, P, hd) view of an
    (R, P, H, hd) tensor that is not contiguous."""
    if case in ("packed_heads", "k7_operands"):
        h, hd = (4, 64) if case == "packed_heads" else (2, 128)
        packed = torch.randn(2, 16, 3, h, hd)
        heads = [packed[:, :, i].permute(0, 2, 1, 3) for i in range(3)]
        if case == "k7_operands":
            g = torch.randn(2, 16, h, hd).permute(0, 2, 1, 3)
            assert not g.is_contiguous()
            heads.append(g)
        for q in heads:
            sr, sh, sp = layout.heads(q)
            got = torch.as_strided(q, q.shape, (sr, sh, sp, 1),
                                   q.storage_offset())
            assert torch.equal(got, q)
        return
    x = torch.randn(3, 64, 512) if case == "contiguous" else \
        torch.randn(1, 64, 3, 512).transpose(1, 2).reshape(3, 64, 512)
    p, sr, sp = layout.rows(x)
    assert p == 64
    got = torch.as_strided(x, x.shape, (sr, sp, 1), x.storage_offset())
    assert torch.equal(got, x)


def test_descriptions_refuse_what_the_kernels_cannot_read():
    with pytest.raises(ValueError, match="stride 1"):
        layout.rows(torch.randn(2, 16, 64).transpose(1, 2))
    with pytest.raises(ValueError, match="multiples of 8"):
        layout.heads(torch.randn(2, 1, 16, 68)[..., :64])
    with pytest.raises(ValueError, match="aligned"):
        layout.rows(torch.randn(2 * 16 * 64 + 1)[1:].reshape(2, 16, 64))
