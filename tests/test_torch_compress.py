"""The CR-MSA compression (K3 on the stream, K12 on partitioned regions) and
its backward K4 at the region sizes the row split reaches, against the JAX
package's Pallas kernels run in interpret mode, on the same numpy-seeded
inputs; and the row split the wrappers launch with.

On the CPU each wrapper runs its kernel's plain PyTorch version, so these
tests hold the plain versions -- the arithmetic and rounding points the
CUDA kernels share -- to the TPU kernels; tests/test_torch_gpu.py holds the
CUDA kernels to the plain versions on a card.

Geometries: P in {1, 9, 144, 729} tokens a region, k in {1, 3, 5, 8}
representatives; the second bag's last row of regions is pad rows but for
one token, so its logits tie at 0 (the min and max gradients split among
ties); a bf16 stream.  C = 128 (the JAX wrappers need C % 128 == 0); P =
729 is one region a bag, to keep interpret mode short.

Tolerances on max|port - jax| over max(1, max|jax|): 1e-4 with float32
products (another summation order), 2e-2 with bfloat16 (a sum near a bf16
rounding boundary rounds the other way).

At P = 1 (a region of one token) the TPU backward's min-max terms are d_mm
/ 1e-8 and minus the same sum, and its gradient there is float32 rounding
times 1e8; the port takes their difference first.  There K4 is held to
jax.vjp of the XLA reference (`_compress_grid_ref`), whose autodiff cancels
the two terms exactly, with float32 products (JAX's CPU backend has no bf16
x bf16 -> f32 product in a vjp).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rrtmil_tpu.ops.pallas.crmsa_kernels import (_cgrid_bwd_pallas,
                                                 _compress_grid_pallas,
                                                 _compress_grid_ref,
                                                 _compress_pallas)
from rrtmil_tpu_torch.ops.kernels import crmsa_kernels as ck
from rrtmil_tpu_torch.ops.kernels import region_layer as rl

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
C = 128
GEOMS = {1: (8, 1), 9: (12, 3), 144: (24, 12), 729: (27, 27)}  # P: (G, rs)
KS = (1, 3, 5, 8)


def _close(got, want, mm: str, what: str):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= TOL[mm], f"{what} {mm}: scaled error {err:.3e}"


def _inputs(p, k, seed):
    """Two bags on the G x G grid of P-token regions: x (pad rows zero),
    mask, LayerNorm scale and bias, phi (C, k) of the init's U(+-1/sqrt(k)),
    d(reps) and d(w)."""
    g, rs = GEOMS[p]
    rng = np.random.default_rng(seed)
    n, nr = g * g, (g // rs) ** 2
    mask = np.ones((2, n), bool)
    mask[1, n - rs * g + 1:] = False
    x = rng.standard_normal((2, n, C)).astype(np.float32) * mask[..., None]
    ls = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    lb = (0.1 * rng.standard_normal(C)).astype(np.float32)
    phi = (rng.uniform(-1, 1, (C, k)) / np.sqrt(k)).astype(np.float32)
    dreps = (0.1 * rng.standard_normal((2, nr, k, C))).astype(np.float32)
    dw = (0.1 * rng.standard_normal((2, nr, k, p))).astype(np.float32)
    return x, mask, ls, lb, phi, dreps, dw, g, rs


def _stream(x, stream):
    jsd, tsd = DT[stream]
    return jnp.asarray(x, jsd), torch.from_numpy(x).to(tsd)


CASES = [(p, k, "float32", "float32") for p in GEOMS for k in KS]
CASES += [(9, 3, "float32", "bfloat16"), (144, 5, "float32", "bfloat16"),
          (729, 8, "float32", "bfloat16"), (144, 1, "bfloat16", "bfloat16"),
          (729, 3, "bfloat16", "bfloat16")]


@pytest.mark.parametrize("p,k,stream,mm", CASES)
def test_k3_compress_grid_plain_matches_pallas(p, k, stream, mm):
    x, mask, ls, lb, phi, _, _, g, rs = _inputs(p, k, 100 * p + k)
    xj, xt = _stream(x, stream)
    jmm, tmm = DT[mm]
    want = _compress_grid_pallas(xj, jnp.asarray(mask), jnp.asarray(ls),
                                 jnp.asarray(lb), jnp.asarray(phi),
                                 grid_side=g, region_size=rs, mm_dtype=jmm,
                                 interpret=True)
    got = ck.crmsa_compress_grid(xt, torch.from_numpy(mask),
                                 torch.from_numpy(ls), torch.from_numpy(lb),
                                 torch.from_numpy(phi), g, rs, tmm)
    for name, a, b in zip(("reps", "w"), got, want):
        _close(a, b, mm, f"K3 {name} P={p} k={k} {stream} stream")


@pytest.mark.parametrize("p,k,stream,mm", [c for c in CASES if c[0] > 1])
def test_k4_compress_grid_bwd_plain_matches_pallas(p, k, stream, mm):
    x, mask, ls, lb, phi, dreps, dw, g, rs = _inputs(p, k, 200 * p + k)
    xj, xt = _stream(x, stream)
    jmm, tmm = DT[mm]
    want = _cgrid_bwd_pallas(xj, jnp.asarray(mask), jnp.asarray(ls),
                             jnp.asarray(lb), jnp.asarray(phi),
                             jnp.asarray(dreps), jnp.asarray(dw),
                             grid_side=g, region_size=rs, mm_dtype=jmm,
                             interpret=True)
    got = ck.crmsa_compress_grid_bwd(
        xt, *(torch.from_numpy(a) for a in (mask, ls, lb, phi, dreps, dw)),
        g, rs, tmm)
    for name, a, b in zip(("dx", "dls", "dlb", "dphi"), got, want):
        _close(a, b, mm, f"K4 {name} P={p} k={k} {stream} stream")


@pytest.mark.parametrize("k", KS)
def test_k4_at_one_token_a_region_matches_the_vjp_of_the_reference(k):
    """P = 1: every region's one token is its min and its max."""
    x, mask, ls, lb, phi, dreps, dw, g, rs = _inputs(1, k, 300 + k)
    ref = lambda *a: _compress_grid_ref(*a, grid_side=g, region_size=rs,
                                        mm_dtype=jnp.float32)
    jm = jnp.asarray(mask)
    _, vjp = jax.vjp(lambda xx, s, b, f: ref(xx, jm, s, b, f),
                     *(jnp.asarray(a) for a in (x, ls, lb, phi)))
    want = vjp((jnp.asarray(dreps), jnp.asarray(dw)))
    got = ck.crmsa_compress_grid_bwd(
        *(torch.from_numpy(a) for a in (x, mask, ls, lb, phi, dreps, dw)),
        g, rs, torch.float32)
    for name, a, b in zip(("dx", "dls", "dlb", "dphi"), got, want):
        _close(a, b, "float32", f"K4 {name} P=1 k={k}")


@pytest.mark.parametrize("p,k,stream,mm",
                         [(1, 3, "float32", "float32"),
                          (9, 8, "float32", "float32"),
                          (729, 5, "float32", "float32"),
                          (9, 1, "float32", "bfloat16"),
                          (729, 3, "bfloat16", "bfloat16")])
def test_k12_compress_plain_matches_pallas(p, k, stream, mm):
    """K12 on partitioned regions, one of them all pad rows and one all pad
    rows but a token (their logits tie at 0)."""
    rng = np.random.default_rng(400 + p + k)
    x = rng.standard_normal((6, p, C)).astype(np.float32)
    x[4] = 0.0
    x[5, 1:] = 0.0
    phi = (rng.uniform(-1, 1, (C, k)) / np.sqrt(k)).astype(np.float32)
    xj, xt = _stream(x, stream)
    jmm, tmm = DT[mm]
    want = _compress_pallas(xj, jnp.asarray(phi), mm_dtype=jmm,
                            interpret=True)
    got = ck.crmsa_compress(xt, torch.from_numpy(phi), mm_dtype=tmm)
    for name, a, b in zip(("reps", "w"), got, want):
        _close(a, b, mm, f"K12 {name} P={p} k={k} {stream} stream")


@pytest.mark.parametrize("regions,p", [(64, 144), (512, 144), (64, 729),
                                       (64, 961), (1024, 961), (64, 9),
                                       (64, 1), (2, 729)])
@pytest.mark.parametrize("k", [1, 8])
def test_compress_row_split_covers_each_region_and_fills_the_card(regions, p,
                                                                  k):
    """The launch plan of K3 / K12 (K4 takes the same chunks): every row of
    a region in exactly one chunk and no chunk past the region's end; a B =
    1 slide (64 regions of 144) and the 45000-patch survival bag (64 of
    729) put at least two blocks on every SM, and so does every shape whose
    regions are long enough; K3's rows' scratch takes R (k + 2) P floats, the
    partials (chunks, R, k, C) exist only with more than one chunk."""
    scratch, part, chunk = ck._compress_scratch(regions, p, C, k, "cpu",
                                                k + 2)
    assert chunk % ck.SPLIT_ROWS == 0 and chunk > 0
    parts = -(-p // chunk)
    covered = np.zeros(p, int)
    for i in range(parts):
        p0, p1 = i * chunk, min(p, (i + 1) * chunk)
        assert p0 < p1 <= p
        covered[p0:p1] += 1
    assert (covered == 1).all()
    blocks = regions * parts
    if (regions, p) in ((64, 144), (64, 729)):
        assert blocks >= 2 * rl.SMS
    assert blocks >= ck.SPLIT_BLOCKS_PER_SM * rl.SMS \
        or chunk == ck.SPLIT_ROWS
    assert scratch.numel() == regions * (k + 2) * p
    assert (part is None) == (parts == 1)
    if part is not None:
        assert part.numel() == parts * regions * k * C
