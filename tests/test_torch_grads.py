"""The port's backward kernels (K2, K4, K7, K9) and K6 against the JAX
package's Pallas kernels run in interpret mode, on the same numpy-seeded
inputs; and each autograd Function of the port on the CPU.

On the CPU each wrapper runs its kernel's plain PyTorch version, so these
tests hold the plain versions -- and through them the arithmetic and the
rounding points the CUDA kernels share -- to the TPU kernels.
tests/test_torch_gpu.py holds the CUDA kernels to the plain versions on a
card.

Tolerances on max|port - jax| over max(1, max|jax|):
  * mm float32: 1e-4 -- the same fp32 products, summed in another order;
  * mm bfloat16: 2e-2 -- both round to bf16 at the same points, but a sum
    that lands next to a bf16 rounding boundary rounds the other way.
Gradients that are zero in exact arithmetic (the key bias and the EPEG
bias: key-constant logit shifts cancel in the softmax) are rounding noise on
both sides; under the same scaled limit they are compared in absolute terms.
C = 128, H = 2, hd = 64 throughout (the JAX wrappers need C % 128 == 0);
the streams hold bucket-pad tokens.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rrtmil_tpu.ops.pallas.crmsa_kernels import (_cgrid_bwd_pallas,
                                                 _rgrid_ln_bwd_pallas)
from rrtmil_tpu.ops.pallas.region_attn import _fused_fwd_pallas
from rrtmil_tpu.ops.pallas.region_attn_bwd import region_attention_bwd_pallas
from rrtmil_tpu.ops.pallas.region_layer import _layer_bwd_pallas
from rrtmil_tpu_torch.ops.kernels import crmsa_kernels as ck
from rrtmil_tpu_torch.ops.kernels import region_attn as ra
from rrtmil_tpu_torch.ops.kernels import region_attn_bwd as rab
from rrtmil_tpu_torch.ops.kernels import region_block as rb
from rrtmil_tpu_torch.ops.kernels import region_layer as rl
from rrtmil_tpu_torch.ops.kernels.common import ln_mask_plain, mm_round
from rrtmil_tpu_torch.ops.regions import region_partition

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MM = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
C, H, HD = 128, 2, 64
G, RS, LENGTHS = 8, 4, (40, 25)     # P = 16; batch 1 has all-pad regions
LAYER_GRADS = ("dx", "dls", "dlb", "dwq", "dwk", "dwv", "dbq", "dbk", "dbv",
               "dpw", "dpb", "dwp", "dbp")


def _close(got, want, mm: str, what: str = ""):
    if want is None:
        assert got is None, what
        return
    got = np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= TOL[mm], f"{what} {mm}: scaled error {err:.3e}"


def _stream(rng, g=G, lengths=LENGTHS):
    n = g * g
    mask = np.zeros((len(lengths), n), bool)
    for i, l in enumerate(lengths):
        mask[i, :l] = True
    x = rng.standard_normal((len(lengths), n, C)).astype(np.float32)
    return x * mask[..., None], mask


def _weights(rng, kk):
    s = np.sqrt(2.0 / (C + H * HD))
    f = lambda *shape, sc=s: (rng.standard_normal(shape) * sc).astype(np.float32)
    scale = HD ** -0.5
    wq, wk, wv = f(H, C, HD), f(H, C, HD), f(H, C, HD)
    bq, bk, bv = f(H, HD, sc=0.05), f(H, HD, sc=0.05), f(H, HD, sc=0.05)
    pw = f(H, kk, sc=0.3) if kk else None
    pb = f(H, sc=0.1) if kk else None
    return (wq * scale, wk, wv, bq * scale, bk, bv, pw, pb, f(H, HD, C),
            f(C, sc=0.05))


def _ln(rng):
    return ((1 + 0.1 * rng.standard_normal(C)).astype(np.float32),
            (0.1 * rng.standard_normal(C)).astype(np.float32))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a, grad=False):
    if a is None:
        return None
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_(True) if grad else t


# ---------------------------------------------------------------------------
# plain backwards against the Pallas backwards (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
@pytest.mark.parametrize("kk", [3, 0])
def test_k2_region_layer_bwd_plain_matches_pallas(kk, mm):
    """Both residual modes against one Pallas run without the residual: the
    TPU kernel's add_residual only adds g to dx (region_layer.py:414-415),
    so the residual mode is held to that dx + g."""
    rng = np.random.default_rng(10 + kk)
    x, mask = _stream(rng)
    ls, lb = _ln(rng)
    w = _weights(rng, kk)
    g = (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    jmm, tmm = MM[mm]
    want = _layer_bwd_pallas(_j(x), _j(mask), _j(ls), _j(lb),
                             *[_j(a) for a in w], _j(g), grid_side=G,
                             region_size=RS, add_residual=False,
                             mm_dtype=jmm, interpret=True)
    for add_residual in (False, True):
        got = rl.region_layer_bwd(_t(x), _t(mask), _t(ls), _t(lb),
                                  *[_t(a) for a in w], _t(g), G, RS,
                                  add_residual, tmm)
        dx = want[0] + _j(g) if add_residual else want[0]
        for name, a, b in zip(LAYER_GRADS, got, (dx, *want[1:])):
            _close(a, b, mm, f"K2 {name} add_residual={add_residual}")


@pytest.mark.parametrize("kk,bias,mm", [(3, True, "float32"),
                                        (3, True, "bfloat16"),
                                        (3, False, "float32"),
                                        (0, False, "float32"),
                                        (0, False, "bfloat16")])
def test_k6_k7_region_attention_plain_match_pallas(kk, bias, mm):
    """Without EPEG the bias is not read (region_attn.py:141): the kk = 0
    case also runs the port with a bias and requires the same results."""
    rng = np.random.default_rng(20 + kk)
    q, k, v, g = (rng.standard_normal((2, H, 16, HD)).astype(np.float32)
                  for _ in range(4))
    w = (0.3 * rng.standard_normal((H, kk))).astype(np.float32) if kk else None
    b = (0.1 * rng.standard_normal(H)).astype(np.float32) if bias else None
    scale = HD ** -0.5
    jmm, tmm = MM[mm]
    want = _fused_fwd_pallas(_j(q), _j(k), _j(v), _j(w), _j(b), scale=scale,
                             mm_dtype=jmm, interpret=True)
    got6 = ra.region_attention_fused(_t(q), _t(k), _t(v), _t(w), _t(b), scale,
                                     tmm)
    _close(got6, want, mm, "K6")
    want = region_attention_bwd_pallas(_j(q), _j(k), _j(v), _j(w), _j(b),
                                       _j(g), scale=scale, mm_dtype=jmm,
                                       interpret=True)
    got = rab.region_attention_bwd(_t(q), _t(k), _t(v), _t(w), _t(b), _t(g),
                                   scale, tmm)
    for name, a, b_ in zip(("dq", "dk", "dv", "dw", "db"), got, want):
        _close(a, b_, mm, f"K7 {name}")
    if kk == 0:
        bb = _t(np.ones(H, np.float32))
        assert torch.equal(ra.region_attention_fused(
            _t(q), _t(k), _t(v), None, bb, scale, tmm), got6)
        for a, b_ in zip(rab.region_attention_bwd(
                _t(q), _t(k), _t(v), None, bb, _t(g), scale, tmm), got):
            assert (a is None and b_ is None) or torch.equal(a, b_)


def _tied_compress_inputs(rng, k):
    """A stream, LN params and phi whose logits tie: in each real region two
    tokens share the max and two the min of logit row 0 (their x rows are
    copies), and batch 1's all-pad regions tie every token at logit 0."""
    x, mask = _stream(rng)
    ls, lb = _ln(rng)
    phi = rng.uniform(-1, 1, (C, k)).astype(np.float32)
    xt = torch.from_numpy(x)
    idx = torch.arange(G * G).reshape(1, G, G, 1).float()
    tok = region_partition(idx, RS).reshape(-1, RS * RS).long()   # (nR, P)
    for bi in range(len(LENGTHS)):
        for r in range(tok.shape[0]):
            real = [int(t) for t in tok[r] if mask[bi, t]]
            if len(real) < 4:
                continue
            z = ck.ln_fast(xt[bi, real], torch.from_numpy(ls),
                           torch.from_numpy(lb))
            logit = (z @ torch.from_numpy(phi[:, 0])).numpy()
            order = np.argsort(logit)
            lo, hi = real[order[0]], real[order[-1]]
            x[bi, real[order[1]]] = x[bi, lo]
            x[bi, real[order[-2]]] = x[bi, hi]
    return x, mask, ls, lb, phi


@pytest.mark.parametrize("k,mm", [(1, "float32"), (1, "bfloat16"),
                                  (3, "float32")])
def test_k4_compress_grid_bwd_plain_matches_pallas_with_ties(k, mm):
    rng = np.random.default_rng(30 + k)
    x, mask, ls, lb, phi = _tied_compress_inputs(rng, k)
    nr, p = (G // RS) ** 2, RS * RS
    dreps = (0.1 * rng.standard_normal((2, nr, k, C))).astype(np.float32)
    dw = (0.1 * rng.standard_normal((2, nr, k, p))).astype(np.float32)
    jmm, tmm = MM[mm]
    z = mm_round(ln_mask_plain(_t(x), _t(mask), _t(ls), _t(lb)), tmm)
    zr = region_partition(z.reshape(2, G, G, C), RS).reshape(2, -1, RS * RS, C)
    logit = torch.einsum("brpc,c->brp", zr, mm_round(_t(phi[:, 0]), tmm))
    real = torch.from_numpy(mask).float().reshape(2, G, G, 1)
    real = region_partition(real, RS).reshape(2, -1, RS * RS).all(-1)
    for ext in (logit.amin(-1, keepdim=True), logit.amax(-1, keepdim=True)):
        assert ((logit == ext).sum(-1)[real] >= 2).any(), "no tie"
    want = _cgrid_bwd_pallas(_j(x), _j(mask), _j(ls), _j(lb), _j(phi),
                             _j(dreps), _j(dw), grid_side=G, region_size=RS,
                             mm_dtype=jmm, interpret=True)
    got = ck.crmsa_compress_grid_bwd(_t(x), _t(mask), _t(ls), _t(lb),
                                     _t(phi), _t(dreps), _t(dw), G, RS, tmm)
    for name, a, b in zip(("dx", "dls", "dlb", "dphi"), got, want):
        _close(a, b, mm, f"K4 {name}")


@pytest.mark.parametrize("with_shortcut,mm", [(True, "float32"),
                                              (True, "bfloat16"),
                                              (False, "float32")])
def test_k9_redistribute_grid_ln_bwd_plain_matches_pallas(with_shortcut, mm):
    rng = np.random.default_rng(40)
    x, mask = _stream(rng)
    nr, p = (G // RS) ** 2, RS * RS
    w = rng.uniform(0, 1, (2, nr, 1, p)).astype(np.float32)
    reps = rng.standard_normal((2, nr, 1, C)).astype(np.float32)
    ls, lb = _ln(rng)
    sc = (rng.standard_normal(x.shape).astype(np.float32) * mask[..., None]
          if with_shortcut else None)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jmm, tmm = MM[mm]
    want = _rgrid_ln_bwd_pallas(_j(x), _j(mask), _j(w), _j(reps), _j(ls),
                                _j(lb), _j(g), _j(sc), grid_side=G,
                                region_size=RS, mm_dtype=jmm, interpret=True)
    got = ck.crmsa_redistribute_grid_ln_bwd(_t(x), _t(mask), _t(w), _t(reps),
                                            _t(ls), _t(lb), _t(sc), _t(g), G,
                                            RS, tmm)
    for name, a, b in zip(("dx", "dw", "dreps", "dls", "dlb"), got, want):
        _close(a, b, mm, f"K9 {name}")
    assert (got[5] is got[0]) if with_shortcut else got[5] is None


# ---------------------------------------------------------------------------
# the autograd Functions on the CPU
# ---------------------------------------------------------------------------

def _grads_match(fn, inputs, g, backward, names, mm="float32"):
    """torch.autograd.grad through `fn` equals the plain backward, input by
    input (each gradient reaches the right input)."""
    out = fn(*inputs)
    live = [t for t in inputs if isinstance(t, torch.Tensor)
            and t.requires_grad]
    grads = torch.autograd.grad(out, live, g, allow_unused=True)
    want = [w for w in backward if w is not None]
    assert len(grads) == len(want), (len(grads), len(want))
    for name, a, b in zip(names, grads, want):
        _close(a.detach().numpy(), b.detach().numpy(), mm, name)


def test_autograd_functions_route_every_gradient():
    rng = np.random.default_rng(50)
    x, mask = _stream(rng)
    ls, lb = _ln(rng)
    w = _weights(rng, 3)
    g = (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    tm = torch.float32
    # K1 -> K2, both residual modes
    for add in (True, False):
        args = [_t(x, True), _t(mask), _t(ls, True), _t(lb, True),
                *[_t(a, True) for a in w]]
        want = rl.region_layer_bwd(*[a.detach() for a in args], _t(g), G, RS,
                                   add, tm)
        _grads_match(lambda *a: rl.region_layer_fused(*a, G, RS, add, tm),
                     args, _t(g), want,
                     [f"K2 {n} res={add}" for n in LAYER_GRADS])
    # K6 -> K7
    qkv = [_t(rng.standard_normal((2, H, 16, HD)).astype(np.float32), True)
           for _ in range(3)]
    gq = _t(rng.standard_normal((2, H, 16, HD)).astype(np.float32))
    pw, pb = _t(w[6], True), _t(w[7], True)
    want = rab.region_attention_bwd(*[a.detach() for a in qkv], pw.detach(),
                                    pb.detach(), gq, 0.5, tm)
    _grads_match(lambda *a: ra.region_attention_fused(*a, 0.5, tm),
                 [*qkv, pw, pb], gq, want, ["dq", "dk", "dv", "dw", "db"])
    # K3 -> K4
    phi = _t(rng.uniform(-1, 1, (C, 1)).astype(np.float32), True)
    args = [_t(x, True), _t(mask), _t(ls, True), _t(lb, True), phi]
    reps, wt = ck.crmsa_compress_grid(*args, G, RS, tm)
    dr, dw = torch.randn_like(reps), torch.randn_like(wt)
    grads = torch.autograd.grad((reps, wt), [args[0], args[2], args[3], phi],
                                (dr, dw))
    want = ck.crmsa_compress_grid_bwd(*[a.detach() for a in args], dr, dw, G,
                                      RS, tm)
    for name, a, b in zip(("dx", "dls", "dlb", "dphi"), grads, want):
        _close(a.numpy(), b.numpy(), "float32", f"K4 {name}")
    # K8 -> K9, the shortcut's gradient is dx
    nr, p = (G // RS) ** 2, RS * RS
    args = [_t(x, True), _t(mask),
            _t(rng.uniform(0, 1, (2, nr, 1, p)).astype(np.float32), True),
            _t(rng.standard_normal((2, nr, 1, C)).astype(np.float32), True),
            _t(ls, True), _t(lb, True), _t(x * 0.5, True)]
    want = ck.crmsa_redistribute_grid_ln_bwd(*[a.detach() for a in args],
                                             _t(g), G, RS, tm)
    _grads_match(lambda *a: ck.crmsa_redistribute_grid_ln(*a, G, RS, tm),
                 args, _t(g), want,
                 ["dx", "dw", "dreps", "dls", "dlb", "dshortcut"])


@pytest.mark.parametrize("kk", [0, 3])
def test_plain_backwards_equal_autograd_of_plain_forwards(kk):
    """In float32 the rounding points vanish, so each plain backward must be
    the exact derivative of its plain forward: an independent check of the
    hand-derived formulas (K2; K5 through block_ref, K6 and K7)."""
    rng = np.random.default_rng(60 + kk)
    x, mask = _stream(rng)
    ls, lb = _ln(rng)
    w = _weights(rng, kk)
    g = (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    args = [_t(x, True), _t(mask), _t(ls, True), _t(lb, True),
            *[_t(a, True) for a in w]]
    out = rl.region_layer_plain(*args, G, RS, True, torch.float32)
    live = [a for a in args if a is not None and a.requires_grad]
    want = torch.autograd.grad(out, live, _t(g))
    got = [t for t in rl.region_layer_bwd(*[None if a is None else a.detach()
                                            for a in args], _t(g), G, RS,
                                          True, torch.float32)
           if t is not None]
    names = [n for n, t in zip(LAYER_GRADS, rl.region_layer_bwd(
        *[None if a is None else a.detach() for a in args], _t(g), G, RS,
        True, torch.float32)) if t is not None]
    assert len(names) == len(got) == len(want)
    for name, a, b in zip(names, got, want):
        _close(a.numpy(), b.numpy(), "float32", f"K2 vs autograd {name}")
    # K5: its autograd Function (block_ref + K6/K7) vs autograd of its plain
    xr = _t(rng.standard_normal((2, 16, C)).astype(np.float32), True)
    wts = [_t(a, True) for a in w]
    gr = _t(rng.standard_normal((2, 16, C)).astype(np.float32))
    live = [xr] + [a for a in wts if a is not None]
    got = torch.autograd.grad(rb.region_block_fused(xr, *wts, torch.float32),
                              live, gr)
    want = torch.autograd.grad(rb.region_block_plain(xr, *wts, torch.float32),
                               live, gr)
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a.numpy(), b.numpy(), "float32", f"K5 grad {i}")


@pytest.mark.parametrize("m,tiles", [(73728, 16), (73728, 48), (9224, 16),
                                     (9224, 48), (405000, 48), (1000, 16),
                                     (37, 48), (1, 16)])
def test_k2_token_split_covers_the_tokens_and_fills_the_card(m, tiles):
    """K2's weight gradients on the tensor cores split the m tokens into
    chunks: every token in exactly one chunk, every chunk but the last a
    whole number of the product's 64-row k steps (no k step crosses two
    chunks), and the blocks fill their waves of the card to >= 90% unless
    the chunks are already as short as the planner allows."""
    rows = rl.token_split(m, tiles)
    assert rows % rl.TC_STEP == 0
    parts = -(-m // rows)
    bounds = [(i * rows, min(m, (i + 1) * rows)) for i in range(parts)]
    assert bounds[0][0] == 0 and bounds[-1][1] == m
    assert all(b0 < b1 for b0, b1 in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    blocks = tiles * parts
    fill = blocks / (-(-blocks // rl.SMS) * rl.SMS)
    most = max(1, -(-m // rl.TC_STEP) // rl.TC_MIN_STEPS)
    assert fill >= 0.9 or parts >= min(most, 4 * rl.SMS // tiles)


@pytest.mark.parametrize("regions,p", [(64, 144), (512, 144), (64, 961),
                                       (64, 729), (64, 9), (128, 1),
                                       (16, 961), (1024, 9), (64, 1),
                                       (512, 961), (2, 729)])
def test_k9_row_split_covers_the_rows_and_fills_the_card(regions, p):
    """K9 and K11 split each region's p token rows over blocks: every row
    in exactly one block, each block's share a multiple of the 8 rows a
    step takes (the last may be short), and at least two blocks an SM
    unless every block is already down to one step.  K8 takes the same
    chunk cut to K8_ROWS, so it splits at least as finely."""
    rows = ck.row_split(regions, p)
    assert ck.k8_split(regions, p) == min(rows, ck.K8_ROWS)
    assert ck.K8_ROWS % ck.SPLIT_ROWS == 0
    assert rows % ck.SPLIT_ROWS == 0 and rows > 0
    parts = -(-p // rows)
    covered = np.zeros(p, int)
    for i in range(parts):
        covered[i * rows:min(p, (i + 1) * rows)] += 1
    assert (covered == 1).all()
    assert regions * parts >= ck.SPLIT_BLOCKS_PER_SM * rl.SMS \
        or rows == ck.SPLIT_ROWS
