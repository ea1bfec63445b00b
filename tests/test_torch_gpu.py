"""The port's CUDA kernels on a card, against their plain PyTorch versions.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

(`--noconftest` skips tests/conftest.py, which configures JAX).  Without a
CUDA card the `gpu` tests skip.  Tolerances on max|kernel - plain| over
max(1, max|plain|): 1e-4 for float32 products (another summation order),
2e-2 for bfloat16 products (a sum near a bf16 rounding boundary rounds the
other way).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from rrtmil_tpu_torch.config import (InnerAttentionConfig, brca_plip,
                                     brca_r50, c16_plip, c16_r50, nsclc_r50,
                                     survival_default)
from rrtmil_tpu_torch.data.datasets import ArrayDataset
from rrtmil_tpu_torch.data.survival import ArraySurvivalDataset
from rrtmil_tpu_torch.models.rrt import InnerAttention, build_model
from rrtmil_tpu_torch.models.survival import SurvivalHead
from rrtmil_tpu_torch.ops.kernels import build
from rrtmil_tpu_torch.ops.kernels import crmsa_kernels as ck
from rrtmil_tpu_torch.ops.kernels import region_attn as ra
from rrtmil_tpu_torch.ops.kernels import region_attn_bwd as rab
from rrtmil_tpu_torch.ops.kernels import region_block as rb
from rrtmil_tpu_torch.ops.kernels import region_layer as rl
from rrtmil_tpu_torch.ops.regions import region_partition
from rrtmil_tpu_torch.train.engine import Engine, EngineConfig
from rrtmil_tpu_torch.train.surv_engine import (SurvivalEngine,
                                                SurvivalEngineConfig)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# K2's gradients that are zero in exact arithmetic (a key-constant logit
# shift cancels in the softmax), by output position: the key bias and the
# EPEG bias; rounding noise on both sides, with the absolute limit the
# autograd checks of chip_smoke.py hold them to in float32
K2_NOISE_GRADS = (7, 10)
NOISE_ABS = 3e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, mm, what):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    got, want = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(got).all(), what
    err = (got - want).abs().max().item() / max(1.0, want.abs().max().item())
    assert err <= TOL[mm], f"{what}: scaled error {err:.3e}"


def _case(dev, sdt, g=24, rs=12, c=128, h=2, hd=64, seed=0):
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: (torch.randn(s, generator=gen) * sc).to(dev)
    n = g * g
    mask = torch.zeros((2, n), dtype=torch.bool)
    mask[0, :500], mask[1, :300] = True, True
    mask = mask.to(dev)
    x = (r(2, n, c) * mask[..., None]).to(sdt)
    s = (2.0 / (c + h * hd)) ** 0.5

    def weights(kk):
        return (r(h, c, hd, sc=s / 8), r(h, c, hd, sc=s), r(h, c, hd, sc=s),
                r(h, hd, sc=0.05), r(h, hd, sc=0.05), r(h, hd, sc=0.05),
                r(h, kk, sc=0.3) if kk else None, r(h, sc=0.1) if kk else None,
                r(h, hd, c, sc=s), r(c, sc=0.05))
    ln = (1 + r(c, sc=0.1), r(c, sc=0.1))
    return x, mask, ln, weights, r(c, 1), r(4, 64, c).to(sdt)


@pytest.mark.gpu
@pytest.mark.parametrize("sdt,mm", [(torch.float32, torch.bfloat16),
                                    (torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16)])
def test_cuda_kernels_match_plain(sdt, mm):
    """Every kernel against its plain version on the same inputs, the
    cotangents drawn from a generator seeded with 0.  K2's key-bias and
    EPEG-bias gradients (K2_NOISE_GRADS) are zero in exact arithmetic: both
    sides return rounding noise there, held to NOISE_ABS absolute as
    chip_smoke.py holds its noise leaves (or TOL, if that is larger: bf16
    products); every other output to TOL."""
    _kernels_match_plain(_cuda(), sdt, mm, seed=0)


def _kernels_match_plain(dev, sdt, mm, seed):
    """test_cuda_kernels_match_plain's checks with cotangents seeded by
    `seed`; returns K2's noise readings by case and output."""
    g, rs = 24, 12
    x, mask, (ls, lb), weights, phi, regions = _case(dev, sdt)
    reps, wgt = ck.compress_grid_plain(x, mask, ls, lb, phi, g, rs, mm)
    gen = torch.Generator(device=dev).manual_seed(seed)
    gx = torch.randn(x.shape, generator=gen, device=dev).to(sdt)
    q, k, v, ga = (r.reshape(2, 2, 64, 64).to(sdt)
                   for r in torch.randn(4, 2 * 2 * 64 * 64, generator=gen,
                                        device=dev))
    w15 = weights(15)
    cases = [
        ("K2", rl.region_layer_bwd, rl.region_layer_bwd_plain,
         (x, mask, ls, lb, *w15, gx, g, rs, True)),
        ("K2 branch", rl.region_layer_bwd, rl.region_layer_bwd_plain,
         (x, mask, ls, lb, *weights(0), gx, g, rs, False)),
        ("K4", ck.crmsa_compress_grid_bwd, ck.compress_grid_bwd_plain,
         (x, mask, ls, lb, phi, reps * 0.1, wgt * 0.1, g, rs)),
        ("K6", ra.region_attention_fused, ra.region_attention_plain,
         (q, k, v, w15[6], w15[7], 0.125)),
        ("K7", rab.region_attention_bwd, rab.region_attention_bwd_plain,
         (q, k, v, w15[6], w15[7], ga, 0.125)),
        ("K9", ck.crmsa_redistribute_grid_ln_bwd,
         ck.redistribute_grid_ln_bwd_plain,
         (x, mask, wgt, reps, ls, lb, x, gx.float(), g, rs)),
        ("K1", rl.region_layer_fused, rl.region_layer_plain,
         (x, mask, ls, lb, *weights(15), g, rs, True)),
        ("K1 branch", rl.region_layer_fused, rl.region_layer_plain,
         (x, mask, ls, lb, *weights(0), g, rs, False)),
        ("K3", ck.crmsa_compress_grid, ck.compress_grid_plain,
         (x, mask, ls, lb, phi, g, rs)),
        ("K5", rb.region_block_fused, rb.region_block_plain,
         (regions, *weights(0))),
        ("K5 k=15", rb.region_block_fused, rb.region_block_plain,
         (regions, *weights(15))),
        ("K8", ck.crmsa_redistribute_grid_ln, ck.redistribute_grid_ln_plain,
         (x, mask, wgt, reps, ls, lb, x, g, rs)),
    ]
    # K2's attention backward on ragged token maps: P = 9 (64 regions of a
    # 24-grid) and P = 961 (one region of a 31-grid), EPEG k = 15
    for gg, rr in ((24, 3), (31, 31)):
        x2, m2, (ls2, lb2), wts2, _, _ = _case(dev, sdt, g=gg, rs=rr, seed=gg)
        cases.append((f"K2 P={rr * rr}", rl.region_layer_bwd,
                      rl.region_layer_bwd_plain,
                      (x2, m2, ls2, lb2, *wts2(15),
                       torch.randn(x2.shape, generator=gen,
                                   device=dev).to(sdt), gg, rr, True)))
    noise = {}
    for what, fn, plain, args in cases:
        got, want = fn(*args, mm_dtype=mm), plain(*args, mm_dtype=mm)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(
                got if isinstance(got, tuple) else (got,),
                want if isinstance(want, tuple) else (want,))):
            if a is None or b is None:
                assert a is None and b is None, what
                continue
            assert a.is_cuda
            if what.startswith("K2") and i in K2_NOISE_GRADS:
                err = (a.float() - b.float()).abs().max().item()
                scale = max(1.0, b.float().abs().max().item())
                noise[f"{what} gradient {i}"] = err
                assert err <= max(NOISE_ABS, TOL[mm] * scale), \
                    f"{what} gradient {i}: {err:.3e} > {NOISE_ABS}"
                continue
            _close(a, b, mm, what)
    return noise


@pytest.mark.gpu
def test_cuda_k2_noise_gradients_over_seeds():
    """test_cuda_kernels_match_plain's float32 case (f32 stream and
    products) over 8 seeded cotangent draws: K2's key-bias and EPEG-bias
    gradients within NOISE_ABS in every draw, every other output within
    TOL; the readings are printed (`-rP` shows them)."""
    dev = _cuda()
    readings = [_kernels_match_plain(dev, torch.float32, torch.float32, seed)
                for seed in range(8)]
    for key in readings[0]:
        print(f"{key}: |kernel - plain| by seed " + ", ".join(
            f"{r[key]:.3e}" for r in readings))


@pytest.mark.gpu
@pytest.mark.parametrize("sdt,mm", [(torch.float32, torch.bfloat16),
                                    (torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("rs", [12, 3])
def test_cuda_k10_to_k13_match_plain(sdt, mm, rs):
    """K10 (both residual modes), K11, K12 (zero rows: tied logits) and K13
    against their plain versions, at P = 144 and P = 9."""
    dev = _cuda()
    g, k, c = 24, 3, 128
    x, mask, _, _, _, _ = _case(dev, sdt)
    gen = torch.Generator().manual_seed(5)
    nr, p = (g // rs) ** 2, rs * rs
    w = torch.rand((2, nr, k, p), generator=gen).to(dev)
    reps = torch.randn((2, nr, k, c), generator=gen).to(dev)
    gx = torch.randn((2, g * g, c), generator=gen).to(dev).to(sdt)
    regions = torch.randn((2 * nr, p, c), generator=gen)
    regions[1, p // 2:] = 0.0
    regions[3] = 0.0
    regions = regions.to(dev).to(sdt)
    phi = (torch.rand((c, k), generator=gen) - 0.5).to(dev)
    cases = [
        ("K10", ck.crmsa_redistribute_grid, ck.redistribute_grid_plain,
         (x, mask, w, reps, g, rs, True)),
        ("K10 branch", ck.crmsa_redistribute_grid, ck.redistribute_grid_plain,
         (x, mask, w, reps, g, rs, False)),
        ("K11", ck.crmsa_redistribute_grid_bwd,
         ck.redistribute_grid_bwd_plain, (mask, w, reps, gx, g, rs)),
        ("K12", ck.crmsa_compress, ck.compress_plain, (regions, phi)),
        ("K13", ck.crmsa_redistribute, ck.redistribute_plain,
         (w.reshape(2 * nr, k, p), reps.reshape(2 * nr, k, c))),
    ]
    for what, fn, plain, args in cases:
        got, want = fn(*args, mm_dtype=mm), plain(*args, mm_dtype=mm)
        torch.cuda.synchronize()
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert a.is_cuda
            _close(a, b, mm, what)


@pytest.mark.gpu
def test_cuda_wrappers_raise_on_geometry_they_cannot_take():
    """Head width 256 with EPEG (past the cores' 128), a head width that
    is no multiple of 32, a grid the regions do not tile, and k = 17
    representatives (past the CR-MSA kernels' 16) raise before a launch."""
    dev = _cuda()
    for h, hd in ((1, 256), (2, 80)):
        x, mask, (ls, lb), weights, phi, regions = _case(dev, torch.float32,
                                                         hd=hd, h=h)
        with pytest.raises(ValueError, match="head_dim"):
            rl.region_layer_fused(x, mask, ls, lb, *weights(15), 24, 12, True)
    x, mask, (ls, lb), weights, phi, regions = _case(dev, torch.float32)
    with pytest.raises(ValueError, match="grid"):
        rl.region_layer_fused(x, mask, ls, lb, *weights(15), 24, 7, True)
    with pytest.raises(ValueError, match="representatives"):
        ck.crmsa_compress_grid(x, mask, ls, lb, phi.repeat(1, 17), 24, 12)


@pytest.mark.gpu
def test_engine_on_card_goes_through_every_kernel():
    """Every batch of a c16_r50 evaluation on the card launches K1, K3, K5
    and K8, and the probabilities match the CPU run of the same weights."""
    _cuda()
    cfg = c16_r50()
    rng = np.random.default_rng(8)
    bags = [rng.standard_normal((n, 1024)).astype(np.float32)
            for n in (37, 937, 2213, 2000)]
    ds = ArrayDataset(bags, [0, 1, 0, 1])
    model = build_model(cfg, seed=0)
    eng = Engine(model, EngineConfig(batch_size=2), cfg.encoder)
    fns = (rl.region_layer_fused, ck.crmsa_compress_grid,
           rb.region_block_fused, ck.crmsa_redistribute_grid_ln)
    for f in fns:
        f.launches = 0
    probs, _, loss = eng.evaluate(ds)
    n_batches = len(eng._batched_order(ds, range(len(ds))))
    assert [f.launches for f in fns] == [n_batches] * 4
    cpu = build_model(cfg, device="cpu", seed=0)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    probs_c, _, loss_c = Engine(cpu, EngineConfig(batch_size=2), cfg.encoder,
                                device="cpu").evaluate(ds)
    # random weights keep the probabilities near 0.5: hold them far tighter
    # than that spread (the card measures ~4e-5 on the c16_r50 bags)
    np.testing.assert_allclose(probs, probs_c, rtol=0, atol=1e-3)
    assert abs(loss - loss_c) < 1e-3


@pytest.mark.gpu
def test_train_step_on_card_goes_through_every_kernel():
    """One Engine.train_epoch step of c16_r50 (dropout off, fp32 products,
    TF32 off) on the card launches each of the nine kernels once; its loss
    and the updated parameters match the CPU run of the same weights.  A
    weight whose gradient is at the noise level may take Adam's sign-like
    first step the other way: at most 1e-3 of a tensor's elements may miss
    1e-5, none by more than 2 lr; pe_bias and the key third of each qkv bias
    (gradients zero in exact arithmetic) are left out."""
    _cuda()
    base = c16_r50()
    cfg = dataclasses.replace(base, dropout=0.0, encoder=dataclasses.replace(
        base.encoder, dropout=0.0, mm_dtype="float32"))
    rng = np.random.default_rng(9)
    ds = ArrayDataset([rng.standard_normal((937, 1024)).astype(np.float32)],
                      [1])
    fns = (rl.region_layer_fused, rl.region_layer_bwd, ck.crmsa_compress_grid,
           ck.crmsa_compress_grid_bwd, rb.region_block_fused,
           ra.region_attention_fused, rab.region_attention_bwd,
           ck.crmsa_redistribute_grid_ln, ck.crmsa_redistribute_grid_ln_bwd)
    for f in fns:
        f.launches = 0
    model = build_model(cfg, seed=0)
    eng = Engine(model, EngineConfig(), cfg.encoder)
    loss = eng.train_epoch(ds, 0, order=[0])
    assert [f.launches for f in fns] == [1] * 9
    cpu = build_model(cfg, device="cpu", seed=0)
    loss_c = Engine(cpu, EngineConfig(), cfg.encoder,
                    device="cpu").train_epoch(ds, 0, order=[0])
    assert abs(loss - loss_c) <= 1e-4 * max(1.0, abs(loss_c))
    lr = eng.cfg.lr
    ref = dict(cpu.named_parameters())
    for name, p in model.named_parameters():
        if "pe_bias" in name:
            continue
        a, b = p.detach().cpu(), ref[name].detach()
        if name.endswith("qkv.bias"):
            t = a.shape[0] // 3
            a, b = torch.cat([a[:t], a[2 * t:]]), torch.cat([b[:t], b[2 * t:]])
        d = (a - b).abs()
        assert d.max().item() <= 2 * lr * 1.01, name
        assert (d > 1e-5 + 1e-4 * b.abs()).float().mean().item() <= 1e-3, name


@pytest.mark.gpu
def test_survival_epoch_on_card_goes_through_k12_k13():
    """One SurvivalEngine epoch of survival_default (dropout off, fp32
    products, TF32 off) on the card: the 1500-patch bag (R-MSA grid 48,
    CR-MSA grid 40) runs K12 and K13, the 1000-patch bag (grids 32 and 32)
    K3 and K8; the epoch's loss matches the CPU run of the same weights."""
    _cuda()
    base = survival_default()
    cfg = dataclasses.replace(base, dropout=0.0, encoder=dataclasses.replace(
        base.encoder, dropout=0.0, mm_dtype="float32"))
    rng = np.random.default_rng(10)
    ds = ArraySurvivalDataset(
        [rng.standard_normal((n, 1024)).astype(np.float32)
         for n in (1500, 1000)], [300.0, 700.0], [1, 0])
    fns = (ck.crmsa_compress, ck.crmsa_redistribute, ck.crmsa_compress_grid,
           ck.crmsa_redistribute_grid_ln, rl.region_layer_fused,
           rl.region_layer_bwd, rb.region_block_fused)
    for f in fns:
        f.launches = 0
    model = SurvivalHead(build_model(cfg, seed=0))
    eng = SurvivalEngine(model, SurvivalEngineConfig(num_epochs=1),
                         cfg.encoder)
    loss, _ = eng.train_epoch(ds, [0, 1], 0)
    assert [f.launches for f in fns] == [1, 1, 1, 1, 2, 2, 2]
    cpu = SurvivalHead(build_model(cfg, device="cpu", seed=0))
    loss_c, _ = SurvivalEngine(cpu, SurvivalEngineConfig(num_epochs=1),
                               cfg.encoder, device="cpu").train_epoch(
                                   ds, [0, 1], 0)
    assert abs(loss - loss_c) <= 1e-4 * max(1.0, abs(loss_c))


def _k567(args5, args6, args7, mm, what):
    """K5, K6 and K7 on the given inputs against their plain versions."""
    for name, fn, plain, args in (
            ("K5", rb.region_block_fused, rb.region_block_plain, args5),
            ("K6", ra.region_attention_fused, ra.region_attention_plain,
             args6),
            ("K7", rab.region_attention_bwd, rab.region_attention_bwd_plain,
             args7)):
        if args is None:
            continue
        got, want = fn(*args, mm_dtype=mm), plain(*args, mm_dtype=mm)
        torch.cuda.synchronize()
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            if a is None or b is None:
                assert a is None and b is None, what
                continue
            assert a.is_cuda
            _close(a, b, mm, f"{name} {what}")


PAIRS = [(torch.float32, torch.bfloat16), (torch.float32, torch.float32),
         (torch.bfloat16, torch.bfloat16)]


@pytest.mark.gpu
@pytest.mark.parametrize("sdt,mm", PAIRS)
@pytest.mark.parametrize("p", [1, 9, 63, 65, 961])
def test_cuda_k5_k6_k7_at_ragged_region_sizes(sdt, mm, p):
    """Ragged P (masked key columns, partial query tiles), EPEG k = 15."""
    dev = _cuda()
    gen = torch.Generator().manual_seed(p)
    r = lambda *s, sc=1.0: (torch.randn(s, generator=gen) * sc).to(dev)
    h, hd, c = 2, 64, 128
    s = (2.0 / (c + h * hd)) ** 0.5
    pw, pb = r(h, 15, sc=0.3), r(h, sc=0.1)
    w = (r(h, c, hd, sc=s / 8), r(h, c, hd, sc=s), r(h, c, hd, sc=s),
         r(h, hd, sc=0.05), r(h, hd, sc=0.05), r(h, hd, sc=0.05), pw, pb,
         r(h, hd, c, sc=s), r(c, sc=0.05))
    q, k, v, g = (r(2, h, p, hd).to(sdt) for _ in range(4))
    _k567((r(2, p, c).to(sdt), *w), (q, k, v, pw, pb, 0.125),
          (q, k, v, pw, pb, g, 0.125), mm, f"P={p}")


@pytest.mark.gpu
@pytest.mark.parametrize("sdt,mm", PAIRS)
@pytest.mark.parametrize("hd", [128, 256, 512])
def test_cuda_k5_k6_k7_at_head_width_512(sdt, mm, hd):
    """brca_r50's CR-MSA shape: one 512-wide head over 64 regions, R = 6,
    and the other head widths the cores take (128, 256) at the same shape;
    a head width that is no multiple of 32 or past 512 raises, as does hd
    = 256 with EPEG."""
    dev = _cuda()
    gen = torch.Generator().manual_seed(hd)
    r = lambda *s, sc=1.0: (torch.randn(s, generator=gen) * sc).to(dev)
    c = 512
    s = (2.0 / (c + hd)) ** 0.5
    w = (r(1, c, hd, sc=s / 22), r(1, c, hd, sc=s), r(1, c, hd, sc=s),
         r(1, hd, sc=0.05), r(1, hd, sc=0.05), r(1, hd, sc=0.05), None, None,
         r(1, hd, c, sc=s), r(c, sc=0.05))
    q, k, v, g = (r(6, 1, 64, hd).to(sdt) for _ in range(4))
    _k567((r(6, 64, c).to(sdt), *w), (q, k, v, None, None, hd ** -0.5),
          (q, k, v, None, None, g, hd ** -0.5), mm, f"hd={hd}")
    for bad, pw in ((576, None), (80, None), (256, r(1, 15))):
        x = r(2, 1, 16, bad)
        with pytest.raises(ValueError, match="head_dim"):
            ra.region_attention_fused(x, x, x, pw, None, 1.0, mm)


@pytest.mark.gpu
@pytest.mark.parametrize("sdt,mm", PAIRS)
@pytest.mark.parametrize("h,hd", [(8, 64), (1, 512)])
def test_cuda_k5_k6_k7_read_strided_inputs_in_place(sdt, mm, h, hd):
    """As the model passes them: K5 on the B = 1 cross-region view (k = 3
    rows of 64 regions, strides (C, 3C, 1)) with an InnerAttention's
    `kernel_weights()` (views of the Linear weights); K6 and K7 on q, k, v
    that are views of one packed (R, P, 3, H, hd) tensor."""
    dev = _cuda()
    torch.manual_seed(hd)
    mod = InnerAttention(InnerAttentionConfig(dim=512, num_heads=h,
                                              head_dim=hd)).to(dev)
    with torch.no_grad():
        mod.qkv.bias.normal_(0, 0.05)
        mod.proj.bias.normal_(0, 0.05)
    gen = torch.Generator().manual_seed(h)
    x = torch.randn((1, 64, 3, 512), generator=gen).to(dev).to(sdt)
    x = x.transpose(1, 2).reshape(3, 64, 512)
    assert not x.is_contiguous()
    packed = torch.randn((4, 64, 3, h, hd), generator=gen).to(dev).to(sdt)
    q, k, v = (packed[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    g = torch.randn((4, 64, h, hd), generator=gen).to(dev).to(sdt) \
        .permute(0, 2, 1, 3)
    with torch.no_grad():
        _k567((x, *mod.kernel_weights()), (q, k, v, None, None, hd ** -0.5),
              (q, k, v, None, None, g, hd ** -0.5), mm, f"strided {h}x{hd}")


@pytest.mark.gpu
@pytest.mark.parametrize("config", [brca_r50, nsclc_r50, c16_plip, brca_plip])
def test_brca_r50_on_card_goes_through_every_kernel(config):
    """brca_r50 (CR-MSA: one 512-wide head) and the canonical configs that
    reach the kernels at settings c16_r50 does not (nsclc_r50: EPEG k = 21,
    CR-MSA k = 5, no shortcut into K8 / K9; c16_plip: k = 9, CR-MSA k = 3,
    input width 512; brca_plip: input width 512): an evaluation and one
    train step (dropout off, fp32 products, TF32 off) on the card launch
    K1, K3, K5, K8 every batch and K1-K9 every step; probabilities and the
    step's loss match the CPU run of the same weights."""
    _cuda()
    base = config()
    cfg = dataclasses.replace(base, dropout=0.0, encoder=dataclasses.replace(
        base.encoder, dropout=0.0, mm_dtype="float32"))
    rng = np.random.default_rng(11)
    ds = ArrayDataset([rng.standard_normal((n, cfg.input_dim))
                       .astype(np.float32) for n in (937, 2213)], [0, 1])
    fns = (rl.region_layer_fused, rl.region_layer_bwd, ck.crmsa_compress_grid,
           ck.crmsa_compress_grid_bwd, rb.region_block_fused,
           ra.region_attention_fused, rab.region_attention_bwd,
           ck.crmsa_redistribute_grid_ln, ck.crmsa_redistribute_grid_ln_bwd)
    model = build_model(cfg, seed=0)
    cpu = build_model(cfg, device="cpu", seed=0)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    for f in fns:
        f.launches = 0
    probs, _, _ = Engine(model, EngineConfig(batch_size=1),
                         cfg.encoder).evaluate(ds)
    assert [f.launches for f in fns] == [2, 0, 2, 0, 2, 0, 0, 2, 0]
    probs_c, _, _ = Engine(cpu, EngineConfig(batch_size=1), cfg.encoder,
                           device="cpu").evaluate(ds)
    np.testing.assert_allclose(probs, probs_c, rtol=0, atol=1e-3)
    for f in fns:
        f.launches = 0
    loss = Engine(model, EngineConfig(), cfg.encoder).train_epoch(
        ds, 0, order=[0])
    assert [f.launches for f in fns] == [1] * 9
    loss_c = Engine(cpu, EngineConfig(), cfg.encoder,
                    device="cpu").train_epoch(ds, 0, order=[0])
    assert abs(loss - loss_c) <= 1e-4 * max(1.0, abs(loss_c))


def _twice(fn, args, mm):
    """fn's outputs on args, after checking a second call gives the same
    bits (every cross-block sum is taken in a fixed order, no atomics)."""
    got, again = fn(*args, mm_dtype=mm), fn(*args, mm_dtype=mm)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    again = again if isinstance(again, tuple) else (again,)
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b), \
            "two calls on the same inputs differ"
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("mm", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 37, 9216 + 8, 73728])
def test_cuda_k2_products_match_plain(mm, m):
    """K2's four products on their own, at c16_r50's (and brca_r50's) R-MSA
    widths (C = 512, 8 x 64 heads) and ragged token counts m: the weight
    gradients o^T gm (512 x 512) and z^T round(dqkv) (512 x 1536), summed
    over the m tokens in chunks, and the data gradients gm Wp^T (bf16 out)
    and round(dqkv) Wqkv^T (f32 out).  bf16 products run on the warpgroup
    tensor cores, f32 products on the SIMT product."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(m)
    r = lambda *s: torch.randn(s, generator=gen, device=dev).to(mm)
    cases = (("dWp", (r(m, 512), r(m, 512), True, torch.float32)),
             ("dWqkv", (r(m, 512), r(m, 1536), True, torch.float32)),
             ("d(o)", (r(m, 512), r(512, 512), False, mm)),
             ("dz", (r(m, 1536), r(512, 1536), False, torch.float32)))
    for what, args in cases:
        (got,) = _twice(rl.k2_product, args, mm)
        _close(got, rl.k2_product_plain(*args, mm_dtype=mm), mm,
               f"{what} m={m}")


@pytest.mark.gpu
@pytest.mark.parametrize("sdt,mm", PAIRS)
@pytest.mark.parametrize("kk", [15, 21])
@pytest.mark.parametrize("add_residual", [True, False])
def test_cuda_k1_k2_at_c16_r50_width(sdt, mm, kk, add_residual):
    """K1's forward and K2's gradients at the R-MSA layer's full width (C =
    512, 8 x 64 heads, P = 144, EPEG k = 15 as c16_r50 and 21 as nsclc_r50)
    against their plain versions, both residual modes; K2 gives the same
    bits on a second call.  The key-bias and EPEG-bias gradients are zero in
    exact arithmetic, so both sides return rounding noise there: they are
    held to twice the plain version's own distance from its float32-product
    run, or NOISE_ABS, whichever is larger."""
    dev = _cuda()
    x, mask, (ls, lb), weights, _, _ = _case(dev, sdt, c=512, h=8, seed=kk)
    w = weights(kk)
    gx = torch.randn(x.shape, generator=torch.Generator(device=dev)
                     .manual_seed(kk), device=dev).to(sdt)
    args = (x, mask, ls, lb, *w, 24, 12, add_residual)
    (out,) = _twice(rl.region_layer_fused, args, mm)
    _close(out, rl.region_layer_plain(*args, mm_dtype=mm), mm, "K1")
    args = (x, mask, ls, lb, *w, gx, 24, 12, add_residual)
    got = _twice(rl.region_layer_bwd, args, mm)
    want = rl.region_layer_bwd_plain(*args, mm_dtype=mm)
    exact = rl.region_layer_bwd_plain(*args, mm_dtype=torch.float32)
    what = f"K2 k={kk} add_residual={add_residual}"
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None or b is None:
            assert a is None and b is None
            continue
        if i in K2_NOISE_GRADS:
            own = (b.float() - exact[i].float()).abs().max().item()
            err = (a.float() - b.float()).abs().max().item()
            assert err <= max(NOISE_ABS, 2 * own), \
                f"{what} gradient {i}: {err:.3e} past the noise {own:.3e}"
            continue
        _close(a, b, mm, what)


@pytest.mark.gpu
@pytest.mark.parametrize("sdt,mm", PAIRS)
@pytest.mark.parametrize("p", [1, 9, 144, 729, 961])
@pytest.mark.parametrize("b", [1, 8])
def test_cuda_k9_at_ragged_region_sizes(sdt, mm, p, b):
    """K9 on 64 regions a bag of p tokens each (B = 1: each region's rows
    split over several blocks; B = 8: one block a region), C = 512, with
    k in {1, 3, 5, 8} representatives, with and without the shortcut,
    against its plain version; the same bits on a second call."""
    dev = _cuda()
    rs = int(round(p ** 0.5))
    g = 8 * rs
    gen = torch.Generator(device=dev).manual_seed(p + b)
    r = lambda *s, sc=1.0: torch.randn(s, generator=gen, device=dev) * sc
    n = g * g
    mask = torch.arange(n, device=dev)[None].expand(b, n) < n - 3 * rs
    x = (r(b, n, 512) * mask[..., None]).to(sdt)
    sc = (r(b, n, 512) * mask[..., None]).to(sdt)
    ls, lb = 1 + r(512, sc=0.1), r(512, sc=0.1)
    for k in (1, 3, 5, 8):
        w = torch.rand((b, 64, k, p), generator=gen, device=dev)
        reps, gout = r(b, 64, k, 512), r(b, n, 512, sc=0.1)
        for short in (sc, None):
            args = (x, mask, w, reps, ls, lb, short, gout, g, rs)
            got = _twice(ck.crmsa_redistribute_grid_ln_bwd, args, mm)
            want = ck.redistribute_grid_ln_bwd_plain(*args, mm_dtype=mm)
            for a, c in zip(got, want):
                if a is None or c is None:
                    assert a is None and c is None
                    continue
                _close(a, c, mm, f"K9 P={p} k={k} B={b} "
                                 f"shortcut={short is not None}")


@pytest.mark.gpu
@pytest.mark.parametrize("sdt,mm", PAIRS)
@pytest.mark.parametrize("p", [1, 9, 144, 729, 961])
@pytest.mark.parametrize("b", [1, 8])
def test_cuda_k8_k11_at_ragged_region_sizes(sdt, mm, p, b):
    """K8 and K11 on 64 regions a bag of p tokens each (each region's rows
    split over blocks: K8 by ck.k8_split, K11 by ck.row_split), C = 512,
    with k in {1, 3, 5, 8}; the last row of regions pad rows but one token,
    masked (K8 writes 0 there, K11's gm is 0 there) and tied (w one value a
    representative there); K8 with and without the shortcut.  Against the
    plain versions, the same bits on a second call."""
    dev = _cuda()
    rs = int(round(p ** 0.5))
    g = 8 * rs
    gen = torch.Generator(device=dev).manual_seed(20 * p + b)
    r = lambda *s, sc=1.0: torch.randn(s, generator=gen, device=dev) * sc
    n = g * g
    mask = (torch.arange(n, device=dev) < n - rs * g + 1)[None].expand(b, n) \
        .contiguous()
    pad = ~region_partition(mask.reshape(b, g, g, 1), rs).reshape(b, 64, 1, p)
    x = (r(b, n, 512) * mask[..., None]).to(sdt)
    sc = (r(b, n, 512) * mask[..., None]).to(sdt)
    ls, lb = 1 + r(512, sc=0.1), r(512, sc=0.1)
    gout = r(b, n, 512, sc=0.1).to(sdt)
    for k in (1, 3, 5, 8):
        w = torch.rand((b, 64, k, p), generator=gen, device=dev)
        w = torch.where(pad, w[:, :1, :, :1], w).contiguous()
        reps = r(b, 64, k, 512)
        for short in (sc, None):
            args = (x, mask, w, reps, ls, lb, short, g, rs)
            (out,) = _twice(ck.crmsa_redistribute_grid_ln, args, mm)
            assert (out[~mask] == 0).all()
            _close(out, ck.redistribute_grid_ln_plain(*args, mm_dtype=mm),
                   mm, f"K8 P={p} k={k} B={b} shortcut={short is not None}")
        args = (mask, w, reps, gout, g, rs)
        got = _twice(ck.crmsa_redistribute_grid_bwd, args, mm)
        want = ck.redistribute_grid_bwd_plain(*args, mm_dtype=mm)
        for a, c in zip(got, want):
            _close(a, c, mm, f"K11 P={p} k={k} B={b}")


@pytest.mark.gpu
@pytest.mark.parametrize("sdt,mm", PAIRS)
@pytest.mark.parametrize("p,c", [(1, 512), (9, 512), (144, 512), (729, 512),
                                 (961, 512), (9, 130)])
@pytest.mark.parametrize("b", [1, 8])
def test_cuda_compress_at_ragged_region_sizes(sdt, mm, p, c, b):
    """K3 and K4 on 64 regions a bag of p tokens each (B = 1: each region's
    rows split over blocks; B = 8: one block a region) with k in {1, 3, 5,
    8}, the last row of regions pad rows but one token (their logits tie at
    0), and K12 on the same regions partitioned; C = 130 takes the
    element-wise loads (rows not a whole number of 16-byte groups).
    Against the plain versions, the same bits on a second call."""
    dev = _cuda()
    rs = int(round(p ** 0.5))
    g = 8 * rs
    gen = torch.Generator(device=dev).manual_seed(10 * p + b)
    r = lambda *s, sc=1.0: torch.randn(s, generator=gen, device=dev) * sc
    n = g * g
    mask = (torch.arange(n, device=dev) < n - rs * g + 1)[None].expand(b, n) \
        .contiguous()
    x = (r(b, n, c) * mask[..., None]).to(sdt)
    ls, lb = 1 + r(c, sc=0.1), r(c, sc=0.1)
    regions = region_partition(x.reshape(b, g, g, c), rs).reshape(-1, p, c)
    for k in (1, 3, 5, 8):
        phi = (torch.rand((c, k), generator=gen, device=dev) * 2 - 1) \
            / k ** 0.5
        dreps, dw = r(b, 64, k, c, sc=0.1), r(b, 64, k, p, sc=0.1)
        for what, fn, plain, args in (
                ("K3", ck.crmsa_compress_grid, ck.compress_grid_plain,
                 (x, mask, ls, lb, phi, g, rs)),
                ("K4", ck.crmsa_compress_grid_bwd, ck.compress_grid_bwd_plain,
                 (x, mask, ls, lb, phi, dreps, dw, g, rs)),
                ("K12", ck.crmsa_compress, ck.compress_plain,
                 (regions, phi))):
            got = _twice(fn, args, mm)
            want = plain(*args, mm_dtype=mm)
            for a, w in zip(got, want):
                _close(a, w, mm, f"{what} P={p} C={c} k={k} B={b}")


@pytest.mark.gpu
def test_xla_backend_on_card_matches_cpu():
    """c16_r50 with backend 'xla' (the unfused structure) and the default
    mm_dtype (bfloat16): on the card its kernels (K5, K12, K13) run with
    float32 products, as the XLA formulation rounds no product, so the
    logits match the CPU 'xla' path at 1e-4 (TF32 off), masked and not."""
    dev = _cuda()
    base = c16_r50()
    cfg = dataclasses.replace(base, encoder=dataclasses.replace(
        base.encoder, backend="xla"))
    assert cfg.encoder.mm_dtype == "bfloat16"
    model = build_model(cfg, seed=0).eval()
    cpu = build_model(cfg, device="cpu", seed=0).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    gen = torch.Generator().manual_seed(12)
    x = torch.randn((2, 2304, 1024), generator=gen)
    mask = torch.ones((2, 2304), dtype=torch.bool)
    mask[1, 2213:] = False
    x = x * mask[..., None]
    fns = (rb.region_block_fused, ck.crmsa_compress, ck.crmsa_redistribute)
    for f in fns:
        f.launches = 0
    with torch.no_grad():
        for xb, kw in ((x[:1, :2213], {}),
                       (x, dict(mask=mask, length=2304))):
            got = model(xb.to(dev), **{k: v.to(dev) if torch.is_tensor(v)
                                       else v for k, v in kw.items()})
            want = cpu(xb, **kw)
            _close(got.float().cpu(), want.float(), torch.float32,
                   f"xla logits {tuple(xb.shape)}")
    assert all(f.launches >= 2 for f in fns)


def _write_cli_set(root, tcga, dim, n=8, seed=0):
    """A small synthetic set in camelyon16's layout (root/pt/, label.csv of
    slide,0|1) or TCGA's (root/pt_files/, patient,LUAD|LUSC)."""
    rng = np.random.default_rng(seed)
    sub = "pt_files" if tcga else "pt"
    os.makedirs(os.path.join(root, sub))
    rows = []
    for i in range(n):
        bag = rng.standard_normal((int(rng.integers(300, 1200)), dim))
        name = f"TCGA-SM-{i:04d}" if tcga else f"slide_{i:03d}"
        np.save(os.path.join(root, sub, name + ("-01Z" if tcga else "")
                             + ".npy"), bag.astype(np.float32))
        label = ("LUSC" if i % 2 else "LUAD") if tcga else i % 2
        rows.append(f"{name},{label}\n")
    with open(os.path.join(root, "label.csv"), "w") as f:
        f.write("".join(rows))


@pytest.mark.gpu
@pytest.mark.parametrize("flags,tcga,launched", [
    (["--crmsa_k", "1", "--all_shortcut"], False, range(9)),
    (["--datasets", "tcga", "--epeg_k", "13", "--crmsa_k", "3",
      "--crmsa_heads", "1", "--all_shortcut", "--crmsa_mlp"], True,
     (0, 1, 4, 5, 6))])
def test_cli_on_card_goes_through_its_kernels(tmp_path, flags, tcga,
                                              launched):
    """`python -m rrtmil_tpu_torch.main` on the card (2 folds, 2 epochs,
    input width 64): c16_r50's flags launch K1-K9 and no other kernel,
    nsclc_plip's (crmsa_mlp) K1, K2, K5, K6 and K7 only; the second epoch's
    bags come from the device cache; the metrics are finite and the
    best-AUC weights written."""
    _cuda()
    from rrtmil_tpu_torch import main as cli
    from rrtmil_tpu_torch.harness import classification
    root = str(tmp_path / "data")
    _write_cli_set(root, tcga, 64)
    fns = (rl.region_layer_fused, rl.region_layer_bwd, ck.crmsa_compress_grid,
           ck.crmsa_compress_grid_bwd, rb.region_block_fused,
           ra.region_attention_fused, rab.region_attention_bwd,
           ck.crmsa_redistribute_grid_ln, ck.crmsa_redistribute_grid_ln_bwd,
           ck.crmsa_redistribute_grid, ck.crmsa_redistribute_grid_bwd,
           ck.crmsa_compress, ck.crmsa_redistribute)
    hits = []

    class Recorder(classification.Engine):
        def train_epoch(self, dataset, epoch, order=None):
            before = self._dcache.hits if self._dcache is not None else 0
            loss = super().train_epoch(dataset, epoch, order)
            hits.append((epoch, self._dcache.hits - before, len(dataset)))
            return loss

    orig = classification.Engine
    classification.Engine = Recorder
    for f in fns:
        f.launches = 0
    try:
        metrics = cli.main(flags + [
            "--input_dim", "64", "--cv_fold", "2", "--num_epoch", "2",
            "--dataset_root", root, "--model_path", str(tmp_path / "out"),
            "--title", "t"])
    finally:
        classification.Engine = orig
    assert [i for i, f in enumerate(fns) if f.launches] == list(launched)
    second = [(h, n) for epoch, h, n in hits if epoch == 1]
    assert len(hits) == 4 and [h for h, _ in second] == [n for _, n in second]
    assert all(np.isfinite(metrics["auc"]))
    out = tmp_path / "out" / "mil_new_c16" / "t"
    assert (out / "fold_1_model_best_auc.pt").exists()


def test_kernel_libraries_build_into_an_ignored_directory():
    """The nvcc outputs land in rrtmil_tpu_torch/build/, which git ignores,
    under names that change with the sources and flags."""
    path = build.library_path("region_layer")
    assert path.parent == build.BUILD_DIR
    rel = os.path.relpath(build.BUILD_DIR, REPO)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert rel + "/" in f.read().split()
    assert path.name.startswith("libregion_layer-")
    assert build.library_path("crmsa") != build.library_path("region_layer")
    assert set(build.SOURCES) == {
        p[:-3] for p in os.listdir(build.CSRC_DIR) if p.endswith(".cu")}
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def _write_survival_set(root, dim, lengths=(150, 300, 80, 400, 200, 120, 350,
                                            90, 260, 170), seed=0):
    """A TCGA-survival CSV (Study, ID, Event, Status, WSI) over small bags:
    300, 350 and 400 patches bucket to R-MSA / CR-MSA grids that differ
    (K12 / K13), the others to matched ones (K3 / K8); case 1 is two files
    joined by ';'."""
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    rows = ["Study,ID,Event,Status,WSI"]
    for i, n in enumerate(lengths):
        risk = rng.uniform()
        bag = rng.standard_normal((n, dim)).astype(np.float32)
        bag[: n // 10] += 0.5 * risk
        paths = [os.path.join(root, f"case_{i}_{j}.npy")
                 for j in range(2 if i == 1 else 1)]
        for j, part in enumerate(np.array_split(bag, len(paths))):
            np.save(paths[j], part)
        rows.append(f"syn,case_{i},{2000 * (1.05 - risk):.1f},"
                    f"{int(i % 3 != 2)},{';'.join(paths)}")
    csv_file = os.path.join(root, "syn.csv")
    with open(csv_file, "w") as f:
        f.write("\n".join(rows) + "\n")
    return csv_file


@pytest.mark.gpu
def test_survival_cli_on_card_goes_through_its_kernels(tmp_path):
    """`python -m rrtmil_tpu_torch.survival_main` on the card (5 folds, 2
    epochs, input width 64): RRTMIL launches K1-K9, K12 and K13 and never
    K10 / K11; the second epoch's bags come from the device cache; the best
    weights and the results CSV are written; --evaluate --resume reproduces
    each saved fold's best c-index; MeanMIL launches no kernel."""
    _cuda()
    from rrtmil_tpu_torch import survival_main as cli
    from rrtmil_tpu_torch.harness import survival
    csv_file = _write_survival_set(str(tmp_path / "data"), 64)
    fns = (rl.region_layer_fused, rl.region_layer_bwd, ck.crmsa_compress_grid,
           ck.crmsa_compress_grid_bwd, rb.region_block_fused,
           ra.region_attention_fused, rab.region_attention_bwd,
           ck.crmsa_redistribute_grid_ln, ck.crmsa_redistribute_grid_ln_bwd,
           ck.crmsa_redistribute_grid, ck.crmsa_redistribute_grid_bwd,
           ck.crmsa_compress, ck.crmsa_redistribute)
    hits, best, val_ci = [], [], []

    class Recorder(survival.SurvivalEngine):
        def train_epoch(self, dataset, indices, epoch):
            before = self._dcache.hits if self._dcache is not None else 0
            out = super().train_epoch(dataset, indices, epoch)
            hits.append((epoch, self._dcache.hits - before, len(indices)))
            return out

        def validate(self, dataset, indices):
            out = super().validate(dataset, indices)
            val_ci.append(out[1])
            return out

        def learning(self, *a, **k):
            out = super().learning(*a, **k)
            best.append(out[0])
            return out

    def run(model, out, *extra):
        for f in fns:
            f.launches = 0
        meter = cli.main(["--model", model, "--input_dim", "64",
                          "--num_epoch", "2", "--excel_file", csv_file,
                          "--results_dir", str(tmp_path / out), *extra])
        return meter, [i for i, f in enumerate(fns) if f.launches]

    orig = survival.SurvivalEngine
    survival.SurvivalEngine = Recorder
    try:
        meter, launched = run("RRTMIL", "a")
        assert launched == list(range(9)) + [11, 12]
        assert len(hits) == 10 and all(h == n for e, h, n in hits if e == 1)
        assert (tmp_path / "a" / "results_RRTMIL.csv").exists()
        assert all(np.isfinite(meter.cindex[1:]))
        val_ci.clear()
        _, launched = run("RRTMIL", "e", "--evaluate", "--resume",
                          str(tmp_path / "a"))
        saved = [bool(os.listdir(tmp_path / "a" / f"fold_{k}"))
                 for k in range(5)]
        assert any(saved)
        assert [c for c, s in zip(val_ci, saved) if s] == \
            [b for b, s in zip(best, saved) if s]
        _, launched = run("MeanMIL", "f")
        assert launched == []
    finally:
        survival.SurvivalEngine = orig


ZOO = ("attmil", "gattmil", "clam_sb", "clam_mb", "dsmil")
_ALL_KERNELS = lambda: (
    rl.region_layer_fused, rl.region_layer_bwd, ck.crmsa_compress_grid,
    ck.crmsa_compress_grid_bwd, rb.region_block_fused,
    ra.region_attention_fused, rab.region_attention_bwd,
    ck.crmsa_redistribute_grid_ln, ck.crmsa_redistribute_grid_ln_bwd,
    ck.crmsa_redistribute_grid, ck.crmsa_redistribute_grid_bwd,
    ck.crmsa_compress, ck.crmsa_redistribute)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ZOO)
def test_zoo_with_encoder_on_card_matches_cpu(name):
    """Each zoo model with c16_r50's encoder injected (input 64, dropout
    0), one bag of 2213 patches in its bucket: the card's logits, loss and
    every gradient against the CPU's plain versions from the same weights
    (1e-4, f32 products, TF32 off); the forward launches K1, K3, K5 and K8,
    forward and backward K1-K9, and no other kernel."""
    from rrtmil_tpu_torch.data.bucketing import bucket_for
    from rrtmil_tpu_torch.models import zoo
    dev = _cuda()
    enc = dataclasses.replace(c16_r50().encoder, mm_dtype="float32",
                              dropout=0.0)
    kw = dict(input_dim=64, dropout=0.0, rrt_cfg=enc, subtyping=True, seed=0)
    card = zoo.build_model(name, **kw)
    cpu = zoo.build_model(name, device="cpu", **kw)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    spec = bucket_for(2213, enc)
    gen = torch.Generator().manual_seed(5)
    x = torch.zeros((1, spec.data_length, 64))
    x[0, :2213] = torch.randn((2213, 64), generator=gen)
    mask = torch.arange(spec.data_length)[None] < 2213
    label = torch.tensor([1])
    fns = _ALL_KERNELS()

    def step(model, d):
        for f in fns:
            f.launches = 0
        with torch.no_grad():
            out = model(x.to(d), mask=mask.to(d), length=spec.repr_length)
        fwd = [i for i, f in enumerate(fns) if f.launches]
        kw = {"label": 1} if name.startswith("clam") else {}
        out = model(x.to(d), mask=mask.to(d), length=spec.repr_length, **kw)
        ce = torch.nn.functional.cross_entropy
        if isinstance(out, tuple):
            aux = out[1] if name.startswith("clam") else ce(out[1],
                                                            label.to(d))
            loss = ce(out[0], label.to(d)) + aux
        else:
            loss = ce(out, label.to(d))
        loss.backward()
        return fwd, [i for i, f in enumerate(fns) if f.launches], loss
    fwd, both, loss = step(card, dev)
    assert fwd == [0, 2, 4, 7] and both == list(range(9))
    _, _, want = step(cpu, "cpu")
    assert abs(loss.item() - want.item()) <= 1e-4 * max(1.0, abs(want.item()))
    grads = {n: p.grad for n, p in cpu.named_parameters()}
    for n, p in card.named_parameters():
        if grads[n] is None:
            assert p.grad is None, n
            continue
        _close(p.grad.cpu(), grads[n], torch.float32, n)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ZOO)
def test_zoo_cli_on_card_goes_through_k1_to_k9(tmp_path, name):
    """`python -m rrtmil_tpu_torch.main --model {name} --only_rrt_enc` on
    the card (2 folds, 1 epoch, input width 64): K1-K9 and no other kernel,
    finite metrics."""
    _cuda()
    from rrtmil_tpu_torch import main as cli
    root = str(tmp_path / "data")
    _write_cli_set(root, False, 64)
    fns = _ALL_KERNELS()
    for f in fns:
        f.launches = 0
    metrics = cli.main(["--model", name, "--only_rrt_enc", "--crmsa_k", "1",
                        "--all_shortcut", "--input_dim", "64", "--cv_fold",
                        "2", "--num_epoch", "1", "--dataset_root", root,
                        "--model_path", str(tmp_path / "out")])
    assert [i for i, f in enumerate(fns) if f.launches] == list(range(9))
    assert all(np.isfinite(metrics["auc"]))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["AttMIL", "CLAM_SB", "CLAM_MB", "DSMIL"])
def test_survival_zoo_on_card_launches_no_kernel(tmp_path, name):
    """The survival CLI's zoo backbones (no encoder) on the card: 5 folds x
    1 epoch, finite c-indices, no kernel launched."""
    _cuda()
    from rrtmil_tpu_torch import survival_main as cli
    csv_file = _write_survival_set(str(tmp_path / "data"), 64)
    fns = _ALL_KERNELS()
    for f in fns:
        f.launches = 0
    meter = cli.main(["--model", name, "--input_dim", "64", "--num_epoch",
                      "1", "--excel_file", csv_file, "--results_dir",
                      str(tmp_path / "out")])
    assert not any(f.launches for f in fns)
    assert all(np.isfinite(meter.cindex[1:]))


def _grads_close(card, cpu, tol, skip=()):
    """Every gradient of `card` within `tol` of `cpu`'s, scaled by max(1,
    max|cpu|); returns the worst scaled error."""
    grads = {n: p.grad for n, p in cpu.named_parameters()}
    worst = 0.0
    for n, p in card.named_parameters():
        if n in skip:
            continue
        got, want = p.grad.float().cpu(), grads[n]
        err = (got - want).abs().max().item() / max(1.0,
                                                    want.abs().max().item())
        assert err <= tol, f"{n}: scaled error {err:.3e}"
        worst = max(worst, err)
    return worst


@pytest.mark.gpu
def test_transmil_on_card_matches_cpu():
    """TransMIL (input 64, every dropout off) on one bag of 2213 patches at
    its true length: the card's logits, loss and every gradient against the
    CPU's from the same weights (1e-4, f32, TF32 off: the Newton
    pseudo-inverse amplifies the two sides' rounding, which stayed far
    below that in chip_smoke.py's run at full width), no kernel launched,
    the same bits from a second forward."""
    from rrtmil_tpu_torch.models import zoo
    from rrtmil_tpu_torch.models.nystrom import NystromAttention
    dev = _cuda()
    card = zoo.build_model("transmil", input_dim=64, dropout=0.0, seed=3)
    cpu = zoo.build_model("transmil", input_dim=64, dropout=0.0,
                          device="cpu", seed=3)
    for m in list(card.modules()) + list(cpu.modules()):
        if isinstance(m, NystromAttention):
            m.p = 0.0
    x = torch.randn((1, 2213, 64), generator=torch.Generator().manual_seed(1))
    fns = _ALL_KERNELS()
    for f in fns:
        f.launches = 0
    with torch.no_grad():
        a, b = card(x.to(dev)), card(x.to(dev))
    assert torch.equal(a, b)
    losses = []
    for model, d in ((card, dev), (cpu, "cpu")):
        logits = model(x.to(d))
        loss = torch.nn.functional.cross_entropy(logits, torch.tensor(
            [1], device=d))
        loss.backward()
        losses.append((logits.detach().cpu(), loss.item()))
    assert not any(f.launches for f in fns)
    torch.testing.assert_close(losses[0][0], losses[1][0], rtol=0, atol=1e-4)
    assert abs(losses[0][1] - losses[1][1]) <= 1e-4
    print(f"transmil card vs CPU: logits "
          f"{(losses[0][0] - losses[1][0]).abs().max().item():.3e}, "
          f"gradients (scaled) {_grads_close(card, cpu, 1e-4):.3e}")


@pytest.mark.gpu
@pytest.mark.parametrize("enc", [False, True])
def test_ibmil_on_card_matches_cpu(enc):
    """IBMIL (input 64, dropout 0) with four prototypes, without and with
    c16_r50's encoder injected, on one bag of 2213 patches in its bucket:
    logits, loss and every gradient against the CPU (1e-4, f32 products,
    TF32 off; W_k's bias, whose gradient is rounding noise, left out); with
    the encoder the forward launches K1, K3, K5, K8 and forward and
    backward K1-K9, without it no kernel."""
    from rrtmil_tpu_torch.data.bucketing import bucket_for
    from rrtmil_tpu_torch.models import zoo
    dev = _cuda()
    rrt = dataclasses.replace(c16_r50().encoder, mm_dtype="float32",
                              dropout=0.0)
    conf = torch.randn((4, 512), generator=torch.Generator().manual_seed(2))
    kw = dict(input_dim=64, dropout=0.0, rrt_cfg=rrt if enc else None,
              confounders=conf.numpy(), seed=0)
    card = zoo.build_model("ibmil", **kw)
    cpu = zoo.build_model("ibmil", device="cpu", **kw)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    spec = bucket_for(2213, rrt)
    x = torch.zeros((1, spec.data_length, 64))
    x[0, :2213] = torch.randn((2213, 64),
                              generator=torch.Generator().manual_seed(5))
    mask = torch.arange(spec.data_length)[None] < 2213
    fns = _ALL_KERNELS()

    def step(model, d):
        for f in fns:
            f.launches = 0
        with torch.no_grad():
            model(x.to(d), mask=mask.to(d), length=spec.repr_length)
        fwd = [i for i, f in enumerate(fns) if f.launches]
        out = model(x.to(d), mask=mask.to(d), length=spec.repr_length)
        loss = torch.nn.functional.cross_entropy(out, torch.tensor(
            [1], device=d))
        loss.backward()
        return fwd, [i for i, f in enumerate(fns) if f.launches], loss
    fwd, both, loss = step(card, dev)
    assert (fwd, both) == (([0, 2, 4, 7], list(range(9))) if enc
                           else ([], []))
    _, _, want = step(cpu, "cpu")
    assert abs(loss.item() - want.item()) <= 1e-4 * max(1.0, abs(want.item()))
    _grads_close(card, cpu, 1e-4, skip=("W_k.bias",))


@pytest.mark.gpu
def test_nystrom_pinv_on_card_matches_cpu():
    """The Newton pseudo-inverse of TransMIL's landmark attention (8 heads
    of 256 x 256 softmax rows) on the card against the CPU, f32 (TF32 off):
    within 1e-3 of max(1, max|cpu|), and the same bits on a second call."""
    from rrtmil_tpu_torch.models.nystrom import moore_penrose_pinv
    dev = _cuda()
    logits = torch.randn((1, 8, 256, 256),
                         generator=torch.Generator().manual_seed(0)) * 3
    a = torch.softmax(logits, dim=-1)
    want = moore_penrose_pinv(a)
    got = moore_penrose_pinv(a.to(dev))
    assert torch.equal(got, moore_penrose_pinv(a.to(dev)))
    err = (got.cpu() - want).abs().max().item() / max(
        1.0, want.abs().max().item())
    print(f"pinv card vs CPU: scaled error {err:.3e}")
    assert err <= 1e-3, f"pinv: scaled error {err:.3e}"


@pytest.mark.gpu
def test_exact_mode_batches_on_card():
    """The engine's exact mode on the card: one bag a batch whatever
    batch_size says, on the device at its true length with an all-True
    mask, the device bag cache never made (even when forced on), and an
    evaluate that launches no kernel for TransMIL."""
    from rrtmil_tpu_torch.models import zoo
    dev = _cuda()
    rng = np.random.default_rng(0)
    lengths = (30, 937, 300)
    ds = ArrayDataset([rng.standard_normal((n, 64)).astype(np.float32)
                       for n in lengths], [0, 1, 0])
    model = zoo.build_model("transmil", input_dim=64)
    eng = Engine(model, EngineConfig(batch_size=4, exact=True,
                                     device_cache="on"))
    assert eng._batched_order(ds, [1, 2, 0]) == [[1], [2], [0]]
    for i, n in enumerate(lengths):
        x, mask, labels, spec = eng._make_batch(ds, [i], train=True)
        assert x.is_cuda and x.shape == (1, n, 64) and bool(mask.all())
        assert spec.repr_length == spec.data_length == n
    fns = _ALL_KERNELS()
    for f in fns:
        f.launches = 0
    probs, _, loss = eng.evaluate(ds)
    assert probs.shape == (3,) and np.isfinite(loss)
    assert eng._dcache is None and not any(f.launches for f in fns)


@pytest.mark.gpu
@pytest.mark.parametrize("surv", [False, True])
def test_dtfd_on_card_matches_cpu(surv):
    """DTFD (input 64, dropout off; classification: 4 pseudo-bags, MaxMinS;
    survival: 8, MaxMinS) on a 2213-patch bag read over its bucket's 2304
    rows: the train path's outputs and both tiers' loss gradients, and the
    eval path with a permutation of the true rows, against the CPU from
    the same weights (1e-4, f32, TF32 off); no kernel launched, the same
    bits from a second eval forward."""
    from rrtmil_tpu_torch.models import zoo
    from rrtmil_tpu_torch.models.dtfd import DTFD
    dev = _cuda()
    kw = dict(input_dim=64, n_classes=4 if surv else 2, survival=surv,
              group=8 if surv else 4, distill="MaxMinS")
    card = zoo.seeded(DTFD(**kw), dev, 3)
    cpu = zoo.seeded(DTFD(**kw), "cpu", 3)
    card.p = cpu.p = 0.0
    x = torch.zeros((1, 2400, 64))
    x[0, :2213] = torch.randn((2213, 64),
                              generator=torch.Generator().manual_seed(1))
    mask = torch.arange(2400)[None] < 2213
    perm = torch.cat([torch.randperm(
        2213, generator=torch.Generator().manual_seed(2)),
        torch.arange(2213, 2304)])
    fns = _ALL_KERNELS()
    for f in fns:
        f.launches = 0
    outs = []
    for model, d in ((card, dev), (cpu, "cpu")):
        out = model(x.to(d), mask=mask.to(d), length=2304, train=True)
        loss = out[-1].sum() + out[1].sum() if surv else \
            out[0].logsumexp(-1).sum() + out[1][0, 1]
        loss.backward()
        with torch.no_grad():
            ev = model(x.to(d), mask=mask.to(d), length=2304, eval_perm=perm)
            if model is card:
                again = model(x.to(d), mask=mask.to(d), length=2304,
                              eval_perm=perm)
                assert all(torch.equal(a, b) for a, b in zip(
                    ev if surv else (ev,), again if surv else (again,)))
        outs.append([t.detach().float().cpu() for t in out] +
                    ([t.cpu() for t in ev] if surv else [ev.cpu()]))
    assert not any(f.launches for f in fns)
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    _grads_close(card, cpu, 1e-4, skip=("attention.attention_weights.bias",
                                       "u_attention.attention_weights.bias"))


@pytest.mark.gpu
@pytest.mark.parametrize("baseline,n", [("attn", 9000), ("selfattn", 1024),
                                        ("selfattn", 1000)])
def test_mhim_on_card_matches_cpu(baseline, n):
    """MHIM (input 64, dropout 0): the teacher's feature and raw attention
    on the card against the CPU, a keep-mask built on the card from them
    and handed to the CPU, the student's logits, loss (survival loss plus
    the soft-target CE) and every gradient against the CPU (1e-4, f32,
    TF32 off); 'selfattn' at 1024 tokens (32 x 32: PPEG runs) and 1000;
    no kernel launched."""
    from rrtmil_tpu_torch.models import mhim, zoo
    from rrtmil_tpu_torch.train.losses import nll_surv_loss
    dev = _cuda()
    kw = dict(input_dim=64, dropout=0.0, baseline=baseline)
    card = zoo.seeded(mhim.MHIM(**kw), dev, 4)
    cpu = zoo.seeded(mhim.MHIM(**kw), "cpu", 4)
    x = torch.randn((1, n, 64), generator=torch.Generator().manual_seed(5))
    mask = torch.arange(n)[None] < n - 37
    fns = _ALL_KERNELS()
    for f in fns:
        f.launches = 0
    with torch.no_grad():
        tea = [card(x.to(dev), mask=mask.to(dev), return_attn=True,
                    return_feat=True),
               cpu(x, mask=mask, return_attn=True, return_feat=True)]
    for a, b in zip(*tea):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4)
    gen = torch.Generator(device=dev).manual_seed(6)
    keep = mhim.build_keep_mask(
        mhim.keep_mask_draws(n, n - 20, 0.7, 0.02, 0.0, gen, dev),
        tea[0][2][0], n - 20, n, 0.7, 0.2, 0.02).cpu()
    assert 0 < int(keep.sum()) < n - 37
    losses = []
    for model, d, t in ((card, dev, tea[0]), (cpu, "cpu", tea[1])):
        logits, feat = model(x.to(d), mask=mask.to(d),
                             keep_mask=keep[None].to(d), return_feat=True)
        hazards = torch.sigmoid(logits)
        surv = torch.cumprod(1 - hazards, dim=-1)
        loss = nll_surv_loss(hazards, surv, torch.tensor([2], device=d),
                             torch.tensor([0.0], device=d)) + \
            0.5 * mhim.soft_target_ce(feat, t[1])
        loss.backward()
        losses.append(loss.item())
    assert not any(f.launches for f in fns)
    assert abs(losses[0] - losses[1]) <= 1e-4
    # PPEG runs on a square token count alone
    unused = {n for n, p in cpu.named_parameters() if p.grad is None}
    assert unused == {n for n, p in card.named_parameters()
                      if p.grad is None}
    assert bool(unused) == (baseline == "selfattn" and n != 1024)
    _grads_close(card, cpu, 1e-4, skip=unused)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["DTFD", "MHIM-MIL"])
def test_dtfd_mhim_survival_cli_on_card(tmp_path, name):
    """The survival CLI's DTFD and MHIM-MIL on the card: 5 folds x 2
    epochs, no kernel launched, then --evaluate --resume: every fold that
    saved weights gives its best c-index again."""
    _cuda()
    from rrtmil_tpu_torch import survival_main as cli
    csv_file = _write_survival_set(str(tmp_path / "data"), 64)
    fns = _ALL_KERNELS()
    for f in fns:
        f.launches = 0
    res = str(tmp_path / "out")
    common = ["--model", name, "--input_dim", "64", "--excel_file",
              csv_file]
    meter = cli.main(common + ["--num_epoch", "2", "--results_dir", res])
    again = cli.main(common + ["--evaluate", "--resume", res,
                               "--results_dir", str(tmp_path / "ev")])
    assert not any(f.launches for f in fns)
    kept = [k for k in range(5) if os.listdir(os.path.join(res,
                                                           f"fold_{k}"))]
    assert kept and all(again.cindex[1 + k] == meter.cindex[1 + k]
                        for k in kept)


@pytest.mark.gpu
def test_dtfd_classification_cli_on_card(tmp_path):
    """`rrtmil_tpu_torch.main --model dtfd` on the card: 2 folds x 2
    epochs on 12 small bags, finite metrics, no kernel launched."""
    _cuda()
    from rrtmil_tpu_torch import main as cli
    rng = np.random.default_rng(0)
    root = tmp_path / "c16"
    os.makedirs(root / "pt")
    rows = []
    for i in range(12):
        bag = rng.standard_normal((int(rng.integers(100, 900)), 64))
        bag[:20] += 0.5 * (i % 2)
        np.save(root / "pt" / f"s{i:02d}.npy", bag.astype(np.float32))
        rows.append(f"s{i:02d},{i % 2}\n")
    (root / "label.csv").write_text("".join(rows))
    fns = _ALL_KERNELS()
    for f in fns:
        f.launches = 0
    metrics = cli.main(["--model", "dtfd", "--dataset_root", str(root),
                        "--model_path", str(tmp_path / "m"), "--input_dim",
                        "64", "--cv_fold", "2", "--num_epoch", "2"])
    assert not any(f.launches for f in fns)
    assert all(np.isfinite(metrics[k]).all() for k in ("acs", "auc"))


# -- the EPEG ablations, the native loader tier, JAX weights ----------------

EPEG_ABLATIONS = {"value_bf": {"epeg_type": "value_bf"},
                  "value_af": {"epeg_type": "value_af"},
                  "attn_2d": {"epeg_2d": True},
                  "value_af_2d": {"epeg_type": "value_af", "epeg_2d": True}}


@pytest.mark.gpu
@pytest.mark.parametrize("tag", list(EPEG_ABLATIONS))
def test_epeg_ablation_on_card_matches_cpu(tag):
    """c16_r50 (input 64, dropout off, float32 products) with each EPEG
    ablation on a bag of 2213 patches: logits and every gradient against
    the CPU (1e-4, f32, TF32 off); the R-MSA layer runs torch ops (K1 / K2 never), the CR-MSA
    layer K3, K5, K8 once a forward and K4, K6, K7, K9 once a backward; a
    second forward and backward gives the same bits."""
    from rrtmil_tpu_torch.data.bucketing import bucket_for
    dev = _cuda()
    base = c16_r50()
    cfg = dataclasses.replace(base, input_dim=64, dropout=0.0,
                              encoder=dataclasses.replace(
                                  base.encoder, dropout=0.0,
                                  mm_dtype="float32", **EPEG_ABLATIONS[tag]))
    card = build_model(cfg, device=dev, seed=2)
    cpu = build_model(cfg, device="cpu", seed=2)
    spec = bucket_for(2213, cfg.encoder)
    x = torch.zeros((1, spec.data_length, 64))
    x[0, :2213] = torch.randn((2213, 64),
                              generator=torch.Generator().manual_seed(4))
    mask = (torch.arange(spec.data_length) < 2213)[None]
    fns = _ALL_KERNELS()
    runs = []
    for model, d in ((card, dev), (card, dev), (cpu, "cpu")):
        for f in fns:
            f.launches = 0
        model.zero_grad(set_to_none=True)
        logits = model(x.to(d), mask=mask.to(d), length=spec.repr_length)
        fwd = [f.launches for f in fns]
        torch.nn.functional.cross_entropy(logits, torch.tensor(
            [1], device=d)).backward()
        runs.append((logits.detach().cpu(), fwd, [f.launches for f in fns],
                     [p.grad.detach().cpu().clone()
                      for p in model.parameters()]))
    once = lambda idx: [1 if i in idx else 0 for i in range(13)]
    assert runs[0][1] == once((2, 4, 7))
    assert runs[0][2] == once(range(2, 9))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][3], runs[1][3]))
    torch.testing.assert_close(runs[0][0], runs[2][0], rtol=0, atol=1e-4)
    print(f"epeg {tag} card vs CPU: gradients (scaled) "
          f"{_grads_close(card, cpu, 1e-4):.3e}")


def _npy_set(root, descr, lengths=(937, 2213, 300, 9000)):
    from rrtmil_tpu_torch.data.datasets import C16Dataset
    os.makedirs(os.path.join(root, "pt"))
    rng = np.random.default_rng(0)
    for i, n in enumerate(lengths):
        np.save(os.path.join(root, "pt", f"s{i}.npy"),
                rng.standard_normal((n, 64)).astype(descr))
    return C16Dataset([f"s{i}" for i in range(len(lengths))],
                      [i % 2 for i in range(len(lengths))], root)


@pytest.mark.gpu
@pytest.mark.parametrize("descr", ["<f4", "<f2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_native_tier_on_card(tmp_path, descr, dtype):
    """The native tier on a CUDA engine: its device batches equal the
    Python tier's bit for bit; it fills one pinned buffer a thread, reused
    across batches once it holds the largest; an engine's two epochs with
    the device cache on serve every miss natively and every later batch
    from the cache."""
    dev = _cuda()
    ds = _npy_set(str(tmp_path), descr)
    eng = Engine(torch.nn.Linear(4, 2), EngineConfig(
        device_cache="off", transfer_dtype=dtype, num_workers=0),
        c16_r50().encoder, device=dev)
    bufs = set()
    for b in ([3], [0], [1], [2], [0, 2]):       # the largest first
        got = eng._make_batch(ds, b)
        bufs.add(eng._staging.buf.data_ptr())
        x, m, lab, spec = eng._assemble_host(ds, b, False)
        want = eng._transfer(torch.from_numpy(x).to(getattr(torch, dtype)),
                             torch.from_numpy(m), torch.from_numpy(lab),
                             spec)
        assert got[3] == spec and got[0].is_cuda
        for a, w in zip(got[:3], want[:3]):
            assert a.dtype == w.dtype and torch.equal(a, w)
    assert eng._staging.buf.is_pinned() and len(bufs) == 1
    assert eng.tier_batches == {"cache": 0, "native": 5, "python": 0}
    from rrtmil_tpu_torch.models import zoo
    model = zoo.build_model("attmil", input_dim=64, device=dev)
    eng = Engine(model, EngineConfig(device_cache="on", transfer_dtype=dtype,
                                     batch_size=2), c16_r50().encoder,
                 device=dev)
    for epoch in range(2):
        eng.train_epoch(ds, epoch)
    n = len(eng._batched_order(ds, range(len(ds))))
    assert eng.tier_batches == {"cache": n, "native": n, "python": 0}
    assert eng._dcache.misses == len(ds)


@pytest.mark.gpu
def test_jax_weights_on_card():
    """The committed fixture of JAX-written `.msgpack` weights on the card:
    attmil's logits and the survival MeanMIL's hazards within 1e-4 of the
    JAX package's CPU outputs."""
    from rrtmil_tpu_torch.models import zoo
    from rrtmil_tpu_torch.models.mean_max import MeanMIL
    from rrtmil_tpu_torch.train.checkpoint import load_params
    dev = _cuda()
    fix = os.path.join(REPO, "tests", "fixtures", "jax_weights")
    attmil = zoo.build_model("attmil", input_dim=64, device=dev)
    attmil.load_state_dict(load_params(os.path.join(fix, "attmil.msgpack")))
    surv = SurvivalHead(MeanMIL(64, 4)).to(dev).eval()
    surv.load_state_dict(load_params(os.path.join(
        fix, "survival_meanmil.msgpack")))
    with np.load(os.path.join(fix, "outputs.npz")) as f:
        for i in range(3):
            n = f[f"x_{i}"].shape[0]
            x = torch.zeros((1, int(f[f"rows_{i}"]), 64))
            x[0, :n] = torch.from_numpy(f[f"x_{i}"])
            x, mask = x.to(dev), (torch.arange(x.shape[1]) < n)[None].to(dev)
            with torch.no_grad():
                logits = attmil(x, mask=mask, length=n)
                hazards, _ = surv(x, mask=mask, length=n)
            np.testing.assert_allclose(logits.cpu().numpy(), f[f"logits_{i}"],
                                       rtol=0, atol=1e-4)
            np.testing.assert_allclose(hazards.cpu().numpy(),
                                       f[f"hazards_{i}"], rtol=0, atol=1e-4)


# -- fold-parallel cross-validation (the fold axis in the kernels) -----------

FOLD_FNS = (rl.region_layer_fused, rl.region_layer_bwd,
            ck.crmsa_compress_grid, ck.crmsa_compress_grid_bwd,
            rb.region_block_fused, ra.region_attention_fused,
            rab.region_attention_bwd, ck.crmsa_redistribute_grid_ln,
            ck.crmsa_redistribute_grid_ln_bwd, ck.crmsa_redistribute_grid,
            ck.crmsa_redistribute_grid_bwd, ck.crmsa_compress,
            ck.crmsa_redistribute)


def _fold_cases(dev, sdt, mm, nf):
    """(name, fn, per-fold argument lists) of the eight Functions at the
    c16_r50-like shape of `_case` (G = 24, P = 144, C = 128, 2 heads of
    64), each fold with weights of its own."""
    g, rs = 24, 12
    per = [_case(dev, sdt, seed=f) for f in range(nf)]
    gen = torch.Generator().manual_seed(11)
    r = lambda *s: torch.randn(s, generator=gen).to(dev)
    nr, p = (g // rs) ** 2, rs * rs

    def wl(f, kk):
        return list(per[f][3](kk))
    return [
        ("K1/K2", lambda *a: rl.region_layer_fused(*a, g, rs, True, mm),
         [[per[f][0], per[f][1], *per[f][2], *wl(f, 15)]
          for f in range(nf)]),
        ("K5", lambda *a: rb.region_block_fused(*a, mm),
         [[per[f][5], *wl(f, 0)] for f in range(nf)]),
        ("K6/K7 EPEG", lambda *a: ra.region_attention_fused(*a, 0.125, mm),
         [[r(4, 2, 64, 64).to(sdt) for _ in range(3)]
          + wl(f, 15)[6:8] for f in range(nf)]),
        ("K3/K4", lambda *a: ck.crmsa_compress_grid(*a, g, rs, mm),
         [[per[f][0], per[f][1], *per[f][2], per[f][4]]
          for f in range(nf)]),
        ("K8/K9", lambda x, m, w, reps, ls, lb, sc:
         ck.crmsa_redistribute_grid_ln(x, m, w, reps, ls, lb, sc, g, rs, mm),
         [[per[f][0], per[f][1], r(2, nr, 1, p).abs(), r(2, nr, 1, 128),
           *per[f][2], per[f][0]] for f in range(nf)]),
        ("K10/K11", lambda x, m, w, reps: ck.crmsa_redistribute_grid(
            x, m, w, reps, g, rs, True, mm),
         [[per[f][0], per[f][1], r(2, nr, 1, p).abs(), r(2, nr, 1, 128)]
          for f in range(nf)]),
        ("K12", lambda x, phi: ck.crmsa_compress(x, phi, mm),
         [[per[f][5], per[f][4]] for f in range(nf)]),
        ("K13", lambda w, reps: ck.crmsa_redistribute(w, reps, mm),
         [[r(4, 1, 64).abs(), r(4, 1, 128)] for f in range(nf)]),
    ]


def _fold_run(fn, per_fold, cots):
    """fn under vmap over the stacked folds: (outputs, input gradients)."""
    stacked = [None if a[0] is None else
               torch.stack(a).requires_grad_(a[0].is_floating_point())
               for a in zip(*per_fold)]
    dims = tuple(None if s is None else 0 for s in stacked)
    out = torch.func.vmap(fn, in_dims=dims)(*stacked)
    out = out if isinstance(out, tuple) else (out,)
    loss = sum((o.float() * c).sum() for o, c in zip(out, cots))
    live = [s for s in stacked if s is not None and s.requires_grad]
    return [o.detach() for o in out], torch.autograd.grad(loss, live)


@pytest.mark.gpu
@pytest.mark.parametrize("sdt,mm", [(torch.float32, torch.bfloat16),
                                    (torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16)])
def test_fold_kernels_match_per_fold_launches(sdt, mm):
    """Each of the eight Functions under vmap over 3 folds of distinct
    weights on the card: one launch of each kernel for all folds, the
    outputs and gradients within TOL of each fold's own launches, and the
    same bits on a second call."""
    dev, nf = _cuda(), 3
    for name, fn, per_fold in _fold_cases(dev, sdt, mm, nf):
        _fold_form_matches(dev, mm, name, fn, per_fold)


def _fold_form_matches(dev, mm, name, fn, per_fold):
    """fn under vmap over len(per_fold) folds: one launch of each kernel
    for all folds, the same bits on a second call, and each fold's outputs
    and gradients within TOL of the fold's own launches (K1/K2's
    K2_NOISE_GRADS within NOISE_ABS)."""
    nf = len(per_fold)
    gen = torch.Generator(device=dev).manual_seed(3)
    probe = fn(*per_fold[0])
    probe = probe if isinstance(probe, tuple) else (probe,)
    cots = [torch.randn((nf, *o.shape), generator=gen, device=dev)
            for o in probe]
    for f in FOLD_FNS:
        f.launches = 0
    out, grads = _fold_run(fn, per_fold, cots)
    launched = [f.launches for f in FOLD_FNS if f.launches]
    assert launched and all(n == 1 for n in launched), (name, launched)
    out2, grads2 = _fold_run(fn, per_fold, cots)
    for a, b in zip(out + list(grads), out2 + list(grads2)):
        assert torch.equal(a, b), f"{name}: not the same bits twice"
    for f in range(nf):
        leaves = [None if a is None else
                  a.clone().requires_grad_(a.is_floating_point())
                  for a in per_fold[f]]
        want = fn(*leaves)
        want = want if isinstance(want, tuple) else (want,)
        loss = sum((o.float() * c[f]).sum() for o, c in zip(want, cots))
        wgrads = torch.autograd.grad(
            loss, [a for a in leaves if a is not None and a.requires_grad])
        for i, (a, b) in enumerate(zip(out, want)):
            _close(a[f], b.detach(), mm, f"{name} fold {f} output {i}")
        for i, (a, b) in enumerate(zip(grads, wgrads)):
            if name.startswith("K1/K2") and i in (7, 10):  # K2_NOISE_GRADS
                err = (a[f] - b).abs().max().item()
                assert err <= max(NOISE_ABS, TOL[mm]), (name, i, err)
                continue
            _close(a[f], b, mm, f"{name} fold {f} gradient {i}")


@pytest.mark.gpu
def test_fold_parallel_step_on_card_matches_cpu():
    """One fold-parallel step of c16_r50 (3 folds of distinct weights,
    dropout off, fp32 products, TF32 off) on the card launches each of K1-K9
    once, not once a fold; its per-fold losses and gradients match the same
    step on the CPU."""
    from rrtmil_tpu_torch.parallel.folds import (make_fold_parallel_step,
                                                 stack_states)
    from rrtmil_tpu_torch.train.losses import cross_entropy
    _cuda()
    base = c16_r50()
    cfg = dataclasses.replace(base, dropout=0.0, encoder=dataclasses.replace(
        base.encoder, dropout=0.0, mm_dtype="float32"))
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 1, 1024, 1024)).astype(
        np.float32))
    mask = torch.ones((3, 1, 1024), dtype=torch.bool)
    mask[1, :, 937:] = False
    labels = torch.tensor([[0], [1], [1]])
    grads = {}
    for dev in ("cuda", "cpu"):
        models = [build_model(cfg, device=dev, seed=s) for s in range(3)]
        stacked = stack_states(models)
        step = make_fold_parallel_step(models, stacked, cross_entropy, 1024)
        fns = FOLD_FNS[:9]
        for f in fns:
            f.launches = 0
        losses = step(x.to(dev), mask.to(dev), labels.to(dev),
                      [torch.Generator(device=dev) for _ in range(3)])
        if dev == "cuda":
            assert [f.launches for f in fns] == [1] * 9
        grads[dev] = (losses.cpu(), [[p.grad.detach().cpu()
                                      for p in m.parameters()]
                                     for m in models])
    (lc, gc), (lp, gp) = grads["cuda"], grads["cpu"]
    np.testing.assert_allclose(lc.numpy(), lp.numpy(), rtol=1e-4, atol=1e-5)
    names = [n for n, _ in build_model(cfg, device="cpu").named_parameters()]
    for f in range(3):
        for name, a, b in zip(names, gc[f], gp[f]):
            if "pe_bias" in name or "qkv.bias" in name:
                continue
            scale = max(1.0, b.abs().max().item())
            assert (a - b).abs().max().item() <= 1e-3 * scale, (f, name)


# -- the geometries of --n_heads 16 / 4, --crmsa_heads 16, --crmsa_k 12 ------

@pytest.mark.gpu
@pytest.mark.parametrize("sdt,mm", PAIRS)
@pytest.mark.parametrize("h,hd", [(4, 32), (2, 128)])
@pytest.mark.parametrize("kk", [0, 15])
def test_cuda_k1_k2_at_head_widths_32_and_128(sdt, mm, h, hd, kk):
    """K1's forward and K2's gradients at head width 32 (--n_heads 16) and
    128 (--n_heads 4), with EPEG k = 15 and without it, against their plain
    versions, the same bits on a second call, and in their 5-fold form (each
    fold's weights its own) against each fold's own launches."""
    dev = _cuda()
    x, mask, (ls, lb), weights, _, _ = _case(dev, sdt, h=h, hd=hd, seed=hd)
    w = weights(kk)
    gx = torch.randn(x.shape, generator=torch.Generator(device=dev)
                     .manual_seed(hd), device=dev).to(sdt)
    args = (x, mask, ls, lb, *w, 24, 12, True)
    (out,) = _twice(rl.region_layer_fused, args, mm)
    _close(out, rl.region_layer_plain(*args, mm_dtype=mm), mm, f"K1 hd={hd}")
    args = (x, mask, ls, lb, *w, gx, 24, 12, True)
    got = _twice(rl.region_layer_bwd, args, mm)
    want = rl.region_layer_bwd_plain(*args, mm_dtype=mm)
    exact = rl.region_layer_bwd_plain(*args, mm_dtype=torch.float32)
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None or b is None:
            assert a is None and b is None
            continue
        if i in K2_NOISE_GRADS:
            own = (b.float() - exact[i].float()).abs().max().item()
            err = (a.float() - b.float()).abs().max().item()
            assert err <= max(NOISE_ABS, 2 * own), (hd, kk, i, err, own)
            continue
        _close(a, b, mm, f"K2 hd={hd} k={kk} output {i}")
    per = [_case(dev, sdt, h=h, hd=hd, seed=f) for f in range(5)]
    _fold_form_matches(
        dev, mm, f"K1/K2 hd={hd} k={kk}",
        lambda *a: rl.region_layer_fused(*a, 24, 12, True, mm),
        [[c[0], c[1], *c[2], *c[3](kk)] for c in per])


@pytest.mark.gpu
@pytest.mark.parametrize("sdt,mm", PAIRS)
@pytest.mark.parametrize("kk", [0, 15])
def test_cuda_k5_k6_k7_at_head_width_32(sdt, mm, kk):
    """--crmsa_heads 16: K5 over (B k, 64, 512) with 16 heads of 32, K6 and
    K7 on (R, 16, 64, 32) (with EPEG k = 15 too, as K1 / K2 reach them at
    --n_heads 16), and K6 / K7 at hd = 96 (three 32-wide thirds of two
    chunks), against their plain versions; the same bits on a second call;
    K5 and K6 / K7 in their 5-fold form."""
    dev = _cuda()
    gen = torch.Generator().manual_seed(32 + kk)
    r = lambda *s, sc=1.0: (torch.randn(s, generator=gen) * sc).to(dev)
    h, hd, c = 16, 32, 512
    s = (2.0 / (c + h * hd)) ** 0.5

    def wts(kk):
        return (r(h, c, hd, sc=s / 6), r(h, c, hd, sc=s), r(h, c, hd, sc=s),
                r(h, hd, sc=0.05), r(h, hd, sc=0.05), r(h, hd, sc=0.05),
                r(h, kk, sc=0.3) if kk else None,
                r(h, sc=0.1) if kk else None, r(h, hd, c, sc=s),
                r(c, sc=0.05))
    w = wts(kk)
    q, k, v, g = (r(6, h, 64, hd).to(sdt) for _ in range(4))
    x5 = r(6, 64, c).to(sdt)
    _k567((x5, *w), (q, k, v, w[6], w[7], hd ** -0.5),
          (q, k, v, w[6], w[7], g, hd ** -0.5), mm, f"hd=32 k={kk}")
    _twice(rb.region_block_fused, (x5, *w), mm)
    _twice(ra.region_attention_fused, (q, k, v, w[6], w[7], hd ** -0.5), mm)
    _twice(rab.region_attention_bwd,
           (q, k, v, w[6], w[7], g, hd ** -0.5), mm)
    q3, k3, v3, g3 = (r(3, 2, 40, 96).to(sdt) for _ in range(4))
    pw3 = r(2, kk, sc=0.3) if kk else None
    pb3 = r(2, sc=0.1) if kk else None
    if not kk:
        _k567(None, (q3, k3, v3, pw3, pb3, 96 ** -0.5),
              (q3, k3, v3, pw3, pb3, g3, 96 ** -0.5), mm, "hd=96")
    _fold_form_matches(dev, mm, f"K5 hd=32 k={kk}",
                       lambda *a: rb.region_block_fused(*a, mm),
                       [[r(6, 64, c).to(sdt), *wts(kk)] for _ in range(5)])
    _fold_form_matches(
        dev, mm, f"K6/K7 hd=32 k={kk}",
        lambda *a: ra.region_attention_fused(*a, hd ** -0.5, mm),
        [[r(6, h, 64, hd).to(sdt) for _ in range(3)] + list(wts(kk)[6:8])
         for _ in range(5)])


@pytest.mark.gpu
@pytest.mark.parametrize("sdt,mm", PAIRS)
@pytest.mark.parametrize("k", [12, 16])
def test_cuda_crmsa_kernels_at_k_12_and_16(sdt, mm, k):
    """--crmsa_k 12 and the kernels' new bound 16: K3 / K4 and K8 / K9 on
    the grid (P = 144), K10 (both residual modes) / K11, K12 (zero rows) and
    K13 against their plain versions, the same bits on a second call, and
    K3/K4, K8/K9, K10/K11, K12 and K13 in their 5-fold form."""
    dev = _cuda()
    g, rs, c = 24, 12, 128
    nr, p = (g // rs) ** 2, rs * rs
    gen = torch.Generator().manual_seed(k)
    r = lambda *s: torch.randn(s, generator=gen).to(dev)

    def fold(f):
        x, mask, (ls, lb), _, _, regions = _case(dev, sdt, seed=f)
        phi = ((torch.rand((c, k), generator=gen) - 0.5) * 0.2).to(dev)
        w = torch.rand((2, nr, k, p), generator=gen).to(dev)
        return x, mask, ls, lb, phi, w, r(2, nr, k, c), regions
    x, mask, ls, lb, phi, w, reps, regions = fold(0)
    regions = regions.clone()
    regions[1, 32:] = 0
    gx = r(2, g * g, c).to(sdt)
    reps_c, w_c = ck.compress_grid_plain(x, mask, ls, lb, phi, g, rs, mm)
    cases = [
        ("K3", ck.crmsa_compress_grid, ck.compress_grid_plain,
         (x, mask, ls, lb, phi, g, rs)),
        ("K4", ck.crmsa_compress_grid_bwd, ck.compress_grid_bwd_plain,
         (x, mask, ls, lb, phi, reps_c * 0.1, w_c * 0.1, g, rs)),
        ("K8", ck.crmsa_redistribute_grid_ln, ck.redistribute_grid_ln_plain,
         (x, mask, w, reps, ls, lb, x, g, rs)),
        ("K9", ck.crmsa_redistribute_grid_ln_bwd,
         ck.redistribute_grid_ln_bwd_plain,
         (x, mask, w, reps, ls, lb, x, gx.float(), g, rs)),
        ("K10", ck.crmsa_redistribute_grid, ck.redistribute_grid_plain,
         (x, mask, w, reps, g, rs, True)),
        ("K10 branch", ck.crmsa_redistribute_grid, ck.redistribute_grid_plain,
         (x, mask, w, reps, g, rs, False)),
        ("K11", ck.crmsa_redistribute_grid_bwd,
         ck.redistribute_grid_bwd_plain, (mask, w, reps, gx, g, rs)),
        ("K12", ck.crmsa_compress, ck.compress_plain, (regions, phi)),
        ("K13", ck.crmsa_redistribute, ck.redistribute_plain,
         (w.reshape(2 * nr, k, p), reps.reshape(2 * nr, k, c))),
    ]
    for what, fn, plain, args in cases:
        got = _twice(fn, args, mm)
        want = plain(*args, mm_dtype=mm)
        for a, b in zip(got, want if isinstance(want, tuple) else (want,)):
            if a is None or b is None:
                assert a is None and b is None, what
                continue
            assert a.is_cuda
            _close(a, b, mm, f"{what} k={k}")
    per = [fold(f) for f in range(5)]
    for name, fn, args in (
            ("K3/K4", lambda *a: ck.crmsa_compress_grid(*a, g, rs, mm),
             [[f[0], f[1], f[2], f[3], f[4]] for f in per]),
            ("K8/K9", lambda x, m, w, reps, ls, lb, sc:
             ck.crmsa_redistribute_grid_ln(x, m, w, reps, ls, lb, sc, g, rs,
                                           mm),
             [[f[0], f[1], f[5], f[6], f[2], f[3], f[0]] for f in per]),
            ("K10/K11", lambda x, m, w, reps: ck.crmsa_redistribute_grid(
                x, m, w, reps, g, rs, True, mm),
             [[f[0], f[1], f[5], f[6]] for f in per]),
            ("K12", lambda x, phi: ck.crmsa_compress(x, phi, mm),
             [[f[7], f[4]] for f in per]),
            ("K13", lambda w, reps: ck.crmsa_redistribute(w, reps, mm),
             [[f[5].reshape(2 * nr, k, p), f[6].reshape(2 * nr, k, c)]
              for f in per])):
        _fold_form_matches(dev, mm, f"{name} k={k}", fn, args)


# -- sequence sharding and the dp step over 2 ranks sharing the card ---------

SEQ_KERNELS = ("K5", "K6", "K7", "K12", "K13")
SEQ_BAG = 9000        # sharded bucket 96 x 96, 4608 tokens a rank


@pytest.fixture(scope="module")
def seqshard_card(tmp_path_factory):
    """tests/_torch_seqshard_ranks.card_seqshard on 2 ranks of the card
    (gloo: NCCL takes one rank a device): every rank's records."""
    _cuda()
    import sys
    from rrtmil_tpu_torch.parallel.mesh import launch
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import _torch_seqshard_ranks as ranks
    build.build_all()
    out = str(tmp_path_factory.mktemp("seqshard") / "ranks.pt")
    launch(ranks.card_seqshard, 2, device="cuda", args=(out, SEQ_BAG))
    return torch.load(out, weights_only=False)


@pytest.mark.gpu
def test_seqshard_on_card_matches_unsharded(seqshard_card):
    """survival_default (f32 products, dropout off) at 9000 patches over 2
    ranks: the hazards, loss and every gradient within 1e-4 (scaled) of the
    unsharded model on the same card and weights; pe_bias and the key third
    of each qkv bias (zero in exact arithmetic) within NOISE_ABS."""
    rec = seqshard_card[0]
    _close(rec["hazards"], rec["ref_hazards"], torch.float32, "hazards")
    assert abs(rec["loss"] - rec["ref_loss"]) <= 1e-4 * max(
        1.0, abs(rec["ref_loss"]))
    for name, want in rec["ref_grads"].items():
        got = rec["grads"][name]
        if "pe_bias" in name:
            assert (got - want).abs().max().item() <= NOISE_ABS, name
            continue
        if name.endswith("qkv.bias"):
            t = want.shape[0] // 3
            assert (got[t:2 * t] - want[t:2 * t]).abs().max().item() <= \
                NOISE_ABS, name
            got, want = (torch.cat([v[:t], v[2 * t:]]) for v in (got, want))
        _close(got, want, torch.float32, name)


@pytest.mark.gpu
def test_seqshard_on_card_launches_k5_k7_k12_k13(seqshard_card):
    """Each rank's sharded forward and value_and_grad: K5 (R-MSA regions
    and the cross-region attention, forward and train), K6 / K7 (K5's
    backward), K12 / K13, and none of K1-K4 or K8-K11."""
    for rank, rec in enumerate(seqshard_card):
        counts = rec["launches"]
        assert all(counts[k] >= 1 for k in SEQ_KERNELS), (rank, counts)
        assert not any(v for k, v in counts.items()
                       if k not in SEQ_KERNELS), (rank, counts)


@pytest.mark.gpu
def test_dp_step_on_card_matches_one_process(seqshard_card):
    """make_sharded_train_step at dp = 2 (c16_r50, f32 products, one
    2213-patch bag a rank) against one process at B = 2: two steps' losses
    within 1e-4, parameters within Adam's drift bound (2 x 2 steps x lr x
    1.01); each rank launches K1-K9 every step and nothing else."""
    for rank, rec in enumerate(seqshard_card):
        counts = rec["dp_launches"]
        assert all(counts[f"K{i}"] >= 2 for i in range(1, 10)), counts
        assert not any(counts[f"K{i}"] for i in range(10, 14)), counts
    (got, params), (want, ref) = seqshard_card[0]["dp"], \
        seqshard_card[0]["dp_ref"]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert seqshard_card[1]["dp"][0] == got
    for name, p in params.items():
        assert (p - ref[name]).abs().max().item() <= 2 * 2 * 2e-4 * 1.01, \
            name


@pytest.mark.gpu
def test_survival_cli_sp_shards_on_card(tmp_path):
    """`python -m rrtmil_tpu_torch.survival_main --model RRTMIL --sp_shards
    2` as a process on the card (input 64, 5 folds x 1 epoch): it prints
    the backend rule on each rank, exits 0, and writes one results CSV with
    a finite c-index in every fold."""
    import subprocess
    import sys
    _cuda()
    csv_file = _write_survival_set(str(tmp_path / "data"), 64)
    out = str(tmp_path / "out")
    proc = subprocess.run(
        [sys.executable, "-m", "rrtmil_tpu_torch.survival_main", "--model",
         "RRTMIL", "--sp_shards", "2", "--input_dim", "64", "--num_epoch",
         "1", "--excel_file", csv_file, "--results_dir", out],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("] backend gloo") == 2, proc.stdout[-2000:]
    assert [f for f in os.listdir(out) if f.endswith(".csv")] == \
        ["results_RRTMIL.csv"]
    with open(os.path.join(out, "results_RRTMIL.csv")) as f:
        cindex = [float(v) for v in f.read().splitlines()[2].split(",")[1:6]]
    assert np.isfinite(cindex).all()
