"""The fold axis in the kernels' autograd Functions, on the CPU.

Fold-parallel training runs the model under `torch.func.vmap` over K folds
whose weights are stacked on a leading axis; each kernel's Function has a
`vmap` rule that applies it once to the physical, fold-stacked tensors
(ops/kernels/folds.py).  Here each of the eight Functions (K1/K2, K5, K6/K7
with and without EPEG taps, K3/K4, K8/K9, K12, K13, K10/K11) runs under vmap
with K = 3 folds of distinct weights and is held against three separate
calls: the outputs and every input's gradient (seeded cotangents) within
1e-6 of max(1, max|separate|).  On the CPU the Functions run their plain
versions, fold by fold, so this checks the rules' plumbing: which axis is a
fold's rows and which a fold's weights, and how the outputs and gradients
come back.  The dropout masks' fold rule (`FoldGenerators`) is checked
against each fold's own generator, and convert.py's stacked weights both
ways.
"""
import numpy as np
import pytest
import torch

from rrtmil_tpu_torch.models.pool import FoldGenerators, dropout
from rrtmil_tpu_torch.models.rrt import drop_path
from rrtmil_tpu_torch.ops.kernels.crmsa_kernels import (
    crmsa_compress, crmsa_compress_grid, crmsa_redistribute,
    crmsa_redistribute_grid, crmsa_redistribute_grid_ln)
from rrtmil_tpu_torch.ops.kernels.folds import (ROWS, WEIGHT, fold_plain,
                                                folds)
from rrtmil_tpu_torch.ops.kernels.region_attn import region_attention_fused
from rrtmil_tpu_torch.ops.kernels.region_block import region_block_fused
from rrtmil_tpu_torch.ops.kernels.region_layer import region_layer_fused

K = 3
TOL = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the fold forms are many small ops, and under
    the test runner's parallel workers their thread pools oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
G, RS, C, H, HD, KK = 8, 4, 64, 2, 64, 5   # 8 x 8 grid of 4-wide regions
N, P, NR, KR = G * G, RS * RS, (G // RS) ** 2, 2


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy(
        (scale * rng.standard_normal(shape)).astype(np.float32))


def _mask(rng, b, n):
    m = np.ones((b, n), bool)
    m[:, n - int(rng.integers(1, n // 4)):] = False
    return torch.from_numpy(m)


def _layer_args(rng):
    return [_t(rng, 1, N, C), _mask(rng, 1, N), 1 + _t(rng, C, scale=0.1),
            _t(rng, C, scale=0.1), *[_t(rng, H, C, HD, scale=0.1)
                                    for _ in range(3)],
            *[_t(rng, H, HD, scale=0.1) for _ in range(3)],
            _t(rng, H, KK, scale=0.2), _t(rng, H, scale=0.1),
            _t(rng, H, HD, C, scale=0.1), _t(rng, C, scale=0.1)]


def _block_args(rng):
    a = _layer_args(rng)
    return [_t(rng, 4, P, C)] + a[4:]


def _attn_args(rng, taps):
    q, k, v = (_t(rng, 4, H, P, HD) for _ in range(3))
    return [q, k, v, _t(rng, H, KK, scale=0.2) if taps else None,
            _t(rng, H, scale=0.1) if taps else None]


def _cgrid_args(rng):
    return [_t(rng, 1, N, C), _mask(rng, 1, N), 1 + _t(rng, C, scale=0.1),
            _t(rng, C, scale=0.1), _t(rng, C, KR, scale=0.3)]


def _rgrid_args(rng, ln):
    out = [_t(rng, 1, N, C), _mask(rng, 1, N), _t(rng, 1, NR, KR, P).abs(),
           _t(rng, 1, NR, KR, C)]
    if ln:
        out += [1 + _t(rng, C, scale=0.1), _t(rng, C, scale=0.1),
                _t(rng, 1, N, C)]
    return out


CASES = {
    "K1/K2 region_layer_fused": (
        _layer_args, lambda *a: region_layer_fused(*a, G, RS, True,
                                                   torch.bfloat16)),
    "K5 region_block_fused": (
        _block_args, lambda *a: region_block_fused(*a, torch.bfloat16)),
    "K6/K7 region_attention_fused, EPEG": (
        lambda rng: _attn_args(rng, True),
        lambda *a: region_attention_fused(*a, 0.125, torch.bfloat16)),
    "K6/K7 region_attention_fused": (
        lambda rng: _attn_args(rng, False),
        lambda q, k, v, w, b: region_attention_fused(q, k, v, None, None,
                                                     0.125, torch.float32)),
    "K3/K4 crmsa_compress_grid": (
        _cgrid_args, lambda *a: crmsa_compress_grid(*a, G, RS,
                                                    torch.bfloat16)),
    "K8/K9 crmsa_redistribute_grid_ln": (
        lambda rng: _rgrid_args(rng, True),
        lambda x, m, w, r, ls, lb, sc: crmsa_redistribute_grid_ln(
            x, m, w, r, ls, lb, sc, G, RS, torch.bfloat16)),
    "K12 crmsa_compress": (
        lambda rng: [_t(rng, 4, P, C), _t(rng, C, KR, scale=0.3)],
        lambda x, phi: crmsa_compress(x, phi, torch.bfloat16)),
    "K13 crmsa_redistribute": (
        lambda rng: [_t(rng, 4, KR, P).abs(), _t(rng, 4, KR, C)],
        lambda w, r: crmsa_redistribute(w, r, torch.bfloat16)),
    "K10/K11 crmsa_redistribute_grid": (
        lambda rng: _rgrid_args(rng, False),
        lambda x, m, w, r: crmsa_redistribute_grid(x, m, w, r, G, RS, True,
                                                   torch.bfloat16)),
}


def _outs(o):
    return o if isinstance(o, tuple) else (o,)


def _close(got, want, what):
    got, want = got.detach().float(), want.detach().float()
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max()) / scale
    assert err <= TOL, f"{what}: {err:.3e} > {TOL}"


@pytest.mark.parametrize("name", list(CASES))
def test_function_under_vmap_matches_separate_calls(name):
    """Forward and every gradient of K folds under vmap against K calls."""
    make, fn = CASES[name]
    rng = np.random.default_rng(7)
    per_fold = [make(rng) for _ in range(K)]
    cots = None
    want = []
    for args in per_fold:
        leaves = [None if a is None else
                  a.clone().requires_grad_(a.is_floating_point())
                  for a in args]
        out = _outs(fn(*leaves))
        if cots is None:
            cots = [[_t(rng, *o.shape) for o in out] for _ in range(K)]
        loss = sum((o.float() * c).sum()
                   for o, c in zip(out, cots[len(want)]))
        live = [a for a in leaves if a is not None and a.requires_grad]
        want.append((out, torch.autograd.grad(loss, live)))

    stacked = [None if args[0] is None else
               torch.stack([a[i] for a in per_fold]).requires_grad_(
                   per_fold[0][i].is_floating_point())
               for i, args in enumerate(zip(*per_fold))]
    dims = tuple(None if s is None else 0 for s in stacked)
    out = _outs(torch.func.vmap(fn, in_dims=dims)(*stacked))
    loss = sum((o.float() * torch.stack([c[i] for c in cots])).sum()
               for i, o in enumerate(out))
    live = [s for s in stacked if s is not None and s.requires_grad]
    grads = torch.autograd.grad(loss, live)
    for f in range(K):
        for i, o in enumerate(out):
            _close(o[f], want[f][0][i], f"{name} fold {f} output {i}")
        for j, g in enumerate(grads):
            _close(g[f], want[f][1][j], f"{name} fold {f} gradient {j}")


def test_fold_plain_and_folds():
    """fold_plain splits rows, indexes weights, keeps None, and its fold f
    is the one-fold call's bits; folds reads the fold count off a rank."""
    x, w = torch.arange(12.).reshape(6, 2), torch.arange(6.).reshape(3, 2)
    got = fold_plain(lambda a, b, c: (a * b, None, b.sum()), 3, (x, w, None),
                     (ROWS, WEIGHT, None), (ROWS, ROWS, WEIGHT))
    assert torch.equal(got[0], x * w.repeat_interleave(2, 0))
    assert got[1] is None and torch.equal(got[2], w.sum(1))
    assert folds(w, 1) == 3 and folds(w, 2) == 0 and folds(w[None], 2) == 1
    assert folds(None, 1) == 0
    with pytest.raises(ValueError, match="rank 1 or 2"):
        folds(torch.zeros(1, 1, 1), 1)


def test_stacked_weights_convert_both_ways():
    """convert.py's stacked forms: the port's fold-stacked parameters of
    three seeded c16_r50 models to the JAX package's stacked fold trees
    (each fold the flax tree `torch_to_flax` makes) and back, exactly."""
    import dataclasses
    from rrtmil_tpu_torch.config import c16_r50
    from rrtmil_tpu_torch.convert import (flax_stacked_to_torch,
                                          torch_stacked_to_flax, torch_to_flax)
    from rrtmil_tpu_torch.models.rrt import RRTMIL, init_parameters
    from rrtmil_tpu_torch.parallel.folds import stack_states
    cfg = c16_r50()
    cfg = dataclasses.replace(cfg, input_dim=16, encoder=dataclasses.replace(
        cfg.encoder, n_layers=2))
    models = []
    for f in range(K):
        models.append(RRTMIL(cfg))
        init_parameters(models[-1], torch.Generator().manual_seed(f))
    stacked = stack_states(models)
    tree = torch_stacked_to_flax(stacked)
    one = torch_to_flax(models[1].state_dict())
    leaf = lambda t, path: t if not path else leaf(t[path[0]], path[1:])
    for path in (("patch_to_emb", "kernel"),
                 ("online_encoder", "layer0", "attn", "attn", "pe_kernel")):
        np.testing.assert_array_equal(leaf(tree, path)[1], leaf(one, path))
    back = flax_stacked_to_torch(tree, K)
    assert back.keys() == stacked.keys()
    assert all(torch.equal(back[n], t) for n, t in stacked.items())


@pytest.mark.parametrize("kind", ["dropout", "drop_path"])
def test_fold_masks_are_each_folds_own_draws(kind):
    """Under vmap, FoldGenerators draws fold f's mask from generator f with
    fold f's shape: the masks the folds would draw alone."""
    x = torch.randn(K, 2, 5, 4)

    def apply(t, gen):
        if kind == "dropout":
            return dropout(t, 0.5, gen, True)
        return drop_path(t, 0.5, gen, True)

    gens = FoldGenerators(torch.Generator().manual_seed(s) for s in (1, 2, 3))
    got = torch.func.vmap(lambda t: apply(t, gens))(x)
    for f in range(K):
        want = apply(x[f], torch.Generator().manual_seed(f + 1))
        assert torch.equal(got[f], want)
    with pytest.raises(ValueError, match="2 generators for 3 folds"):
        torch.func.vmap(lambda t: apply(t, FoldGenerators(list(gens)[:2])))(x)
