"""The port's four kernels (K1, K3, K5, K8) against the JAX package's Pallas
kernels run in interpret mode, on the same numpy-seeded inputs.

On the CPU each wrapper runs its kernel's plain PyTorch version, so these
tests hold the plain versions -- and through them the arithmetic and the
rounding points the CUDA kernels share -- to the TPU kernels.
tests/test_torch_gpu.py holds the CUDA kernels to the plain versions on a
card.

Tolerances (on max|port - jax| over max(1, max|jax|)):
  * mm float32: 1e-4 -- the same fp32 products, summed in another order;
  * mm bfloat16: 2e-2 -- both round to bf16 at the same points, but a sum
    that lands next to a bf16 rounding boundary rounds the other way (q,
    the softmax, the head outputs), ~2^-8 relative.
C = 128 throughout: the JAX wrappers need C % 128 == 0.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rrtmil_tpu.ops.pallas.crmsa_kernels import (_compress_grid_pallas,
                                                 _rgrid_ln_pallas)
from rrtmil_tpu.ops.pallas.region_block import _block_fwd_pallas
from rrtmil_tpu.ops.pallas.region_layer import _layer_fwd_pallas
from rrtmil_tpu_torch.ops.kernels import crmsa_kernels as ck
from rrtmil_tpu_torch.ops.kernels import region_block as rb
from rrtmil_tpu_torch.ops.kernels import region_layer as rl

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MM = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
C, H, HD = 128, 2, 64


def _close(got, want, mm: str, what: str = ""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= TOL[mm], f"{what} {mm}: scaled error {err:.3e}"


def _stream(rng, b, g, lengths):
    """(B, G*G, C) stream with zero pad rows, its bool mask."""
    n = g * g
    mask = np.zeros((b, n), bool)
    for i, l in enumerate(lengths):
        mask[i, :l] = True
    x = rng.standard_normal((b, n, C)).astype(np.float32) * mask[..., None]
    return x, mask


def _weights(rng, kk, c=C, h=H, hd=HD):
    s = np.sqrt(2.0 / (c + h * hd))
    f = lambda *shape, sc=s: (rng.standard_normal(shape) * sc).astype(np.float32)
    scale = hd ** -0.5
    wq, wk, wv = f(h, c, hd), f(h, c, hd), f(h, c, hd)
    bq, bk, bv = f(h, hd, sc=0.05), f(h, hd, sc=0.05), f(h, hd, sc=0.05)
    pw = f(h, kk, sc=0.3) if kk else None
    pb = f(h, sc=0.1) if kk else None
    return (wq * scale, wk, wv, bq * scale, bk, bv, pw, pb, f(h, hd, c),
            f(c, sc=0.05))


def _ln(rng, c=C):
    return ((1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
            (0.1 * rng.standard_normal(c)).astype(np.float32))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


# (grid side, region side, batch lengths): P > 1, pad tokens, B = 2 with two
# true lengths, and the one-token regions of the smallest bucket
GEOMS = [(16, 4, (200, 150)), (8, 1, (37,))]


@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
@pytest.mark.parametrize("kk", [15, 0])
@pytest.mark.parametrize("geom", GEOMS)
def test_k1_region_layer_plain_matches_pallas(geom, kk, mm):
    g, rs, lengths = geom
    rng = np.random.default_rng(1)
    x, mask = _stream(rng, len(lengths), g, lengths)
    ls, lb = _ln(rng)
    w = _weights(rng, kk)
    jmm, tmm = MM[mm]
    want = _layer_fwd_pallas(_j(x), _j(mask), _j(ls), _j(lb),
                             *[_j(a) for a in w], grid_side=g, region_size=rs,
                             add_residual=True, mm_dtype=jmm, interpret=True)
    got = rl.region_layer_fused(_t(x), _t(mask), _t(ls), _t(lb),
                                *[_t(a) for a in w], g, rs, True, tmm)
    _close(got, want, mm, "K1")


@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 3])
def test_k3_compress_grid_plain_matches_pallas(k, mm):
    g, rs, lengths = GEOMS[0]
    rng = np.random.default_rng(2)
    x, mask = _stream(rng, len(lengths), g, lengths)
    ls, lb = _ln(rng)
    phi = rng.uniform(-1, 1, (C, k)).astype(np.float32)
    jmm, tmm = MM[mm]
    reps_j, w_j = _compress_grid_pallas(_j(x), _j(mask), _j(ls), _j(lb),
                                        _j(phi), grid_side=g, region_size=rs,
                                        mm_dtype=jmm, interpret=True)
    reps_t, w_t = ck.crmsa_compress_grid(_t(x), _t(mask), _t(ls), _t(lb),
                                         _t(phi), g, rs, tmm)
    _close(reps_t, reps_j, mm, "K3 reps")
    _close(w_t, w_j, mm, "K3 w")


@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,kk", [(64, 0), (16, 15)])
def test_k5_region_block_plain_matches_pallas(p, kk, mm):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, p, C)).astype(np.float32)
    w = _weights(rng, kk)
    jmm, tmm = MM[mm]
    want = _block_fwd_pallas(_j(x), *[_j(a) for a in w], mm_dtype=jmm,
                             interpret=True)
    got = rb.region_block_fused(_t(x), *[_t(a) for a in w], tmm)
    _close(got, want, mm, "K5")


# K8 cases (P, k, shortcut, stream, mm): the first four on GEOMS[0] (P =
# 16); then P in {1, 9, 144} (ck.row_split's region sizes: one token, rows
# not a multiple of 8, c16_r50's) with k in {1, 3, 5, 8}, the second bag's
# last row of regions pad rows but one token (masked, their w tied), and
# bf16 streams
K8_GEOMS = {1: (8, 1), 9: (12, 3), 144: (24, 12)}   # P: (G, rs)
K8_CASES = [pytest.param(16, 1, sc, "float32", mm, id=f"{sc}-{mm}")
            for sc in (True, False) for mm in ("float32", "bfloat16")]
K8_CASES += [pytest.param(p, k, k in (1, 5), "float32", "float32",
                          id=f"P{p}-k{k}")
             for p in K8_GEOMS for k in (1, 3, 5, 8)]
K8_CASES += [pytest.param(*c, id="P{}-k{}-{}-{}-{}".format(*c)) for c in (
    (9, 3, True, "float32", "bfloat16"), (144, 5, False, "float32", "bfloat16"),
    (144, 1, True, "bfloat16", "bfloat16"), (9, 8, False, "bfloat16", "bfloat16"))]


def _k8_inputs(p, k, with_shortcut, seed):
    """x (pad rows zero), mask, w (U(0, 1); tied on pad rows), reps, the
    LayerNorm and the shortcut on two bags; P = 16 keeps GEOMS[0]'s bags."""
    rng = np.random.default_rng(seed)
    if p == 16:
        g, rs, lengths = GEOMS[0]
        x, mask = _stream(rng, len(lengths), g, lengths)
    else:
        g, rs = K8_GEOMS[p]
        n = g * g
        mask = np.ones((2, n), bool)
        mask[1, n - rs * g + 1:] = False
        x = rng.standard_normal((2, n, C)).astype(np.float32) * mask[..., None]
    b, nr = x.shape[0], (g // rs) ** 2
    w = rng.uniform(0, 1, (b, nr, k, rs * rs)).astype(np.float32)
    if p != 16:
        pad = ~mask.reshape(b, g // rs, rs, g // rs, rs).transpose(
            0, 1, 3, 2, 4).reshape(b, nr, 1, rs * rs)
        w = np.where(pad, w[:, :1, :, :1], w)
    reps = rng.standard_normal((b, nr, k, C)).astype(np.float32)
    ls, lb = _ln(rng)
    sc = (rng.standard_normal(x.shape).astype(np.float32) * mask[..., None]
          if with_shortcut else None)
    return x, mask, w, reps, ls, lb, sc, g, rs


@pytest.mark.parametrize("p,k,with_shortcut,stream,mm", K8_CASES)
def test_k8_redistribute_grid_ln_plain_matches_pallas(p, k, with_shortcut,
                                                      stream, mm):
    x, mask, w, reps, ls, lb, sc, g, rs = _k8_inputs(
        p, k, with_shortcut, 4 if p == 16 else 40 + p + k)
    jsd, tsd = MM[stream]
    jmm, tmm = MM[mm]
    want = _rgrid_ln_pallas(_j(x).astype(jsd), _j(mask), _j(w), _j(reps),
                            _j(ls), _j(lb),
                            None if sc is None else _j(sc).astype(jsd),
                            grid_side=g, region_size=rs, mm_dtype=jmm,
                            interpret=True)
    got = ck.crmsa_redistribute_grid_ln(
        _t(x).to(tsd), _t(mask), _t(w), _t(reps), _t(ls), _t(lb),
        None if sc is None else _t(sc).to(tsd), g, rs, tmm)
    assert got.dtype == torch.float32
    assert (got[~_t(mask)] == 0).all()
    _close(got, want, mm, f"K8 P={p} k={k} {stream} stream")


@pytest.mark.parametrize("c,ok", [(512, True), (1024, True), (4, True),
                                  (130, False), (510, False), (1028, False),
                                  (2048, False)])
def test_vector_rows_check_takes_what_k8_to_k11_take(c, ok):
    """K8-K11 and K13 move four channels a lane at a time: their launchers
    call `_check_vector_rows`, which raises ValueError for C % 4 != 0 and
    for C > 1024 (the launchers run only on a card, so the check is called
    here directly) and for a stream that is not 16-byte aligned."""
    x = torch.zeros(c + 1)
    if ok:
        ck._check_vector_rows(c, x[:c])
        with pytest.raises(ValueError, match="aligned"):
            ck._check_vector_rows(c, x[1:])
    else:
        with pytest.raises(ValueError, match="C % 4 == 0"):
            ck._check_vector_rows(c, x[:c])


def test_bf16_stream_k1_plain_matches_pallas():
    """The --amp pair: bf16 stream, bf16 products."""
    g, rs, lengths = GEOMS[0]
    rng = np.random.default_rng(5)
    x, mask = _stream(rng, len(lengths), g, lengths)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    ls, lb = _ln(rng)
    w = _weights(rng, 15)
    want = _layer_fwd_pallas(_j(x).astype(jnp.bfloat16), _j(mask), _j(ls),
                             _j(lb), *[_j(a) for a in w], grid_side=g,
                             region_size=rs, add_residual=True,
                             mm_dtype=jnp.bfloat16, interpret=True)
    got = rl.region_layer_fused(_t(x).to(torch.bfloat16), _t(mask), _t(ls),
                                _t(lb), *[_t(a) for a in w], g, rs, True,
                                torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _close(got.float(), want.astype(jnp.float32), "bfloat16", "K1 bf16")


def test_wrappers_refuse_devices_without_kernel():
    """A tensor on neither the CPU nor a CUDA card never reaches plain code."""
    x = torch.zeros((1, 64, C), device="meta")
    mask = torch.ones((1, 64), dtype=torch.bool, device="meta")
    ls = torch.ones(C, device="meta")
    w = [None if a is None else torch.from_numpy(a).to("meta")
         for a in _weights(np.random.default_rng(0), 0)]
    with pytest.raises(ValueError):
        rl.region_layer_fused(x, mask, ls, ls, *w, 8, 4, True)
    with pytest.raises(ValueError):
        rb.region_block_fused(x, *w)
    with pytest.raises(ValueError):
        ck.crmsa_compress_grid(x, mask, ls, ls, ls[:, None], 8, 4)
