"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # the whole run (one card)
    python3 chip_smoke.py --quick    # phases 0-2 only: build + kernel checks

Phases (each passes or the script exits non-zero; nothing is caught):

0. device: `nvidia-smi` name and power limit, TF32 off for matmul and cuDNN;
1. build: nvcc of every `rrtmil_tpu_torch/csrc/*.cu` (one process each, in
   parallel), with -Xptxas -v;
2. kernels: the nine kernels K1-K9 at the c16_r50 main-path shapes (K2 in
   both residual modes; K6 and K7 also at P = 144 with EPEG k = 15), in the
   three stream/mm dtype pairs, against their plain PyTorch versions on the
   card, K1-K5 and K8-K9 also at the largest bucket (L = 60000); then each
   autograd Function's gradients against autograd through its plain forward
   (f32/f32);
3. main paths: a seeded c16_r50 model through `Engine(device="cuda")
   .evaluate` on bags of {37, 937, 2213, 9000, 9000, 30000} patches and
   through `Engine.train_epoch` (dropout on) on bags of {937, 2213, 9000,
   9000, 30000, 30000} patches, batch size 2, with every kernel's launch
   counter set to 0 just before each path and read just after (every batch
   and step must launch all of its kernels); evaluate's probabilities and
   two dropout-off train steps against the same weights on the CPU (f32 and
   bf16 products);
4. times: each kernel (CUDA events) at the B = 1 and B = 8 main-path shapes
   beside its bound, its plain version's time and, where one PyTorch call
   computes the same function, that call's time (K5:
   `F.multi_head_attention_forward`; K6 and K7: `scaled_dot_product_attention`
   forward, and its backward through autograd); forward slides/s at L = 9000
   for B in {1, 4, 8} and train slides/s for B in {1, 8}, with peak memory;
5. profile: torch.profiler over three B = 8 forwards and one B = 8 train
   step, device time by kernel and the device's busy share.

Prints the `{"kernels": [...]}` line, the card's name and power limit, and
as its last line `{"ok": true, "device": {...}}`.  Writes the full report
to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 CUDA
# cores, HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
DTYPE_PAIRS = [(torch.float32, torch.bfloat16), (torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16)]
# tolerance on max|kernel - plain| / max(1, max|plain|), by mm dtype: fp32
# sums in another order; in bf16 a sum that lands near a rounding boundary
# rounds the other way (q, softmax, head outputs), ~2^-8 relative
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# c16_r50 probabilities and mean loss, card kernels vs CPU plain versions:
# random weights put the probabilities within ~0.1 of 0.5, so the limit sits
# far below that spread (measured gap ~4e-5)
PROB_TOL = 1e-3
# the library call rounds at other points than K5 (bf16 output, unnormalised
# bf16 probabilities); this only checks that it computes the same function
LIBRARY_TOL = 5e-2
# Adam's bias-corrected step |m / sqrt(v)| stays below 1.0034 lr in its
# first steps (at most 1 in the first), so two runs whose gradients differ
# in sign can drift apart by at most 2 * ADAM_STEP * lr a step
ADAM_STEP = 1.01
BAG_LENGTHS = (37, 937, 2213, 9000, 9000, 30000)
TRAIN_BAGS = (937, 2213, 9000, 9000, 30000, 30000)
TPU_KERNELS = {
    "K1 region_layer_fused": ("rrtmil_tpu/ops/pallas/region_layer.py:44",
                              "_layer_fwd_pallas",
                              "rrtmil_tpu_torch/csrc/region_layer.cu"),
    "K2 region_layer_bwd": ("rrtmil_tpu/ops/pallas/region_layer.py:248",
                            "_layer_bwd_pallas",
                            "rrtmil_tpu_torch/csrc/region_layer_bwd.cu"),
    "K3 crmsa_compress_grid": ("rrtmil_tpu/ops/pallas/crmsa_kernels.py:228",
                               "_compress_grid_pallas",
                               "rrtmil_tpu_torch/csrc/crmsa.cu"),
    "K4 crmsa_compress_grid_bwd": (
        "rrtmil_tpu/ops/pallas/crmsa_kernels.py:381", "_cgrid_bwd_pallas",
        "rrtmil_tpu_torch/csrc/crmsa_bwd.cu"),
    "K5 region_block_fused": ("rrtmil_tpu/ops/pallas/region_block.py:44",
                              "_block_fwd_pallas",
                              "rrtmil_tpu_torch/csrc/region_layer.cu"),
    "K6 region_attention_fused": ("rrtmil_tpu/ops/pallas/region_attn.py:115",
                                  "_fused_fwd_pallas",
                                  "rrtmil_tpu_torch/csrc/region_layer.cu"),
    "K7 region_attention_bwd": (
        "rrtmil_tpu/ops/pallas/region_attn_bwd.py:51",
        "region_attention_bwd_pallas",
        "rrtmil_tpu_torch/csrc/region_layer_bwd.cu"),
    "K8 crmsa_redistribute_grid_ln": (
        "rrtmil_tpu/ops/pallas/crmsa_kernels.py:752", "_rgrid_ln_pallas",
        "rrtmil_tpu_torch/csrc/crmsa.cu"),
    "K9 crmsa_redistribute_grid_ln_bwd": (
        "rrtmil_tpu/ops/pallas/crmsa_kernels.py:859", "_rgrid_ln_bwd_pallas",
        "rrtmil_tpu_torch/csrc/crmsa_bwd.cu"),
}
FORWARD = ("K1 region_layer_fused", "K3 crmsa_compress_grid",
           "K5 region_block_fused", "K8 crmsa_redistribute_grid_ln")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def dname(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


# ---------------------------------------------------------------------------
# inputs at the main-path shapes
# ---------------------------------------------------------------------------

def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _randn(shape, g, scale=1.0):
    return torch.randn(shape, generator=g) * scale


def stream_inputs(b, g_side, c, length, seed, dev):
    g = _gen(seed)
    n = g_side * g_side
    mask = (torch.arange(n) < length)[None].expand(b, n).clone()
    mask[-1, length - 37:] = False          # a second true length
    x = _randn((b, n, c), g) * mask[..., None]
    return x.to(dev), mask.to(dev), g


def layer_weights(c, h, hd, kk, g, dev):
    s = (2.0 / (c + h * hd)) ** 0.5
    scale = hd ** -0.5
    w = [_randn((h, c, hd), g, s) for _ in range(3)]
    b = [_randn((h, hd), g, 0.02) for _ in range(3)]
    pw = _randn((h, kk), g, 0.3) if kk else None
    pb = _randn((h,), g, 0.1) if kk else None
    wp = _randn((h, hd, c), g, s)
    bp = _randn((c,), g, 0.02)
    ws = (w[0] * scale, w[1], w[2], b[0] * scale, b[1], b[2], pw, pb, wp, bp)
    return tuple(None if t is None else t.to(dev) for t in ws)


def ln_params(c, g, dev):
    return ((1.0 + _randn((c,), g, 0.1)).to(dev), _randn((c,), g, 0.1).to(dev))


def kernel_cases(b, dev, stream_dtype, G=96, length=9000):
    """{kernel: (wrapper, plain version, args)} at the c16_r50 main path shape
    for batch b (by default a 9000-patch bag: G = 96, C = 512, H = 8 x 64,
    P = 144, EPEG k = 15, CR-MSA k = 1 over 64 regions; K6 and K7 as K5's
    backward runs them, on (b, 8, 64, 64) at scale 1 without EPEG)."""
    from rrtmil_tpu_torch.ops.kernels import crmsa_kernels as ck
    from rrtmil_tpu_torch.ops.kernels import region_attn as ra
    from rrtmil_tpu_torch.ops.kernels import region_attn_bwd as rab
    from rrtmil_tpu_torch.ops.kernels import region_block as rb
    from rrtmil_tpu_torch.ops.kernels import region_layer as rl

    RS, C, H, HD, KK = G // 8, 512, 8, 64, 15
    x, mask, g = stream_inputs(b, G, C, length, 100 + b, dev)
    x = x.to(stream_dtype)
    ls, lb = ln_params(C, g, dev)
    w1 = layer_weights(C, H, HD, KK, g, dev)
    phi = _randn((C, 1), g, 1.0).to(dev)
    nr, p = (G // RS) ** 2, RS * RS
    reps = _randn((b, nr, 1, C), g, 1.0).to(dev)
    wgt = torch.rand((b, nr, 1, p), generator=g).to(dev)
    sc = (_randn((b, G * G, C), g) * mask.cpu()[..., None]).to(dev) \
        .to(stream_dtype)
    w5 = layer_weights(C, H, HD, 0, g, dev)
    x5 = _randn((b, nr, C), g).to(dev).to(stream_dtype)
    gx = (_randn((b, G * G, C), g, 0.1)).to(dev).to(stream_dtype)
    g32 = _randn((b, G * G, C), g, 0.1).to(dev)
    dreps = _randn((b, nr, 1, C), g, 0.1).to(dev)
    dwg = _randn((b, nr, 1, p), g, 0.1).to(dev)
    q, k, v, ga = (_randn((b, H, nr, HD), g).to(dev).to(stream_dtype)
                   for _ in range(4))
    return {
        "K1 region_layer_fused": (
            rl.region_layer_fused, rl.region_layer_plain,
            (x, mask, ls, lb, *w1, G, RS, True)),
        "K2 region_layer_bwd": (
            rl.region_layer_bwd, rl.region_layer_bwd_plain,
            (x, mask, ls, lb, *w1, gx, G, RS, True)),
        "K2 region_layer_bwd (add_residual=False)": (
            rl.region_layer_bwd, rl.region_layer_bwd_plain,
            (x, mask, ls, lb, *w1, gx, G, RS, False)),
        "K4 crmsa_compress_grid_bwd": (
            ck.crmsa_compress_grid_bwd, ck.compress_grid_bwd_plain,
            (x, mask, ls, lb, phi, dreps, dwg, G, RS)),
        "K6 region_attention_fused": (
            ra.region_attention_fused, ra.region_attention_plain,
            (q, k, v, None, None, 1.0)),
        "K7 region_attention_bwd": (
            rab.region_attention_bwd, rab.region_attention_bwd_plain,
            (q, k, v, None, None, ga, 1.0)),
        "K9 crmsa_redistribute_grid_ln_bwd": (
            ck.crmsa_redistribute_grid_ln_bwd,
            ck.redistribute_grid_ln_bwd_plain,
            (x, mask, wgt, reps, ls, lb, sc, g32, G, RS)),
        "K3 crmsa_compress_grid": (
            ck.crmsa_compress_grid, ck.compress_grid_plain,
            (x, mask, ls, lb, phi, G, RS)),
        "K5 region_block_fused": (
            rb.region_block_fused, rb.region_block_plain, (x5, *w5)),
        "K8 crmsa_redistribute_grid_ln": (
            ck.crmsa_redistribute_grid_ln, ck.redistribute_grid_ln_plain,
            (x, mask, wgt, reps, ls, lb, sc, G, RS)),
    }


def extra_cases(dev, stream_dtype):
    """K5 as the unfused R-MSA structure runs it, and K6 / K7 as K2 runs
    their core: P = 144, EPEG k = 15 (with pe_bias)."""
    from rrtmil_tpu_torch.ops.kernels import region_attn as ra
    from rrtmil_tpu_torch.ops.kernels import region_attn_bwd as rab
    from rrtmil_tpu_torch.ops.kernels import region_block as rb
    g = _gen(7)
    x = _randn((128, 144, 512), g).to(dev).to(stream_dtype)
    q, k, v, ga = (_randn((16, 8, 144, 64), g).to(dev).to(stream_dtype)
                   for _ in range(4))
    pw, pb = _randn((8, 15), g, 0.3).to(dev), _randn((8,), g, 0.1).to(dev)
    return {
        "K5 region_block_fused (P=144, k=15)": (
            rb.region_block_fused, rb.region_block_plain,
            (x, *layer_weights(512, 8, 64, 15, g, dev))),
        "K6 region_attention_fused (P=144, k=15)": (
            ra.region_attention_fused, ra.region_attention_plain,
            (q, k, v, pw, pb, 0.125)),
        "K7 region_attention_bwd (P=144, k=15)": (
            rab.region_attention_bwd, rab.region_attention_bwd_plain,
            (q, k, v, pw, pb, ga, 0.125)),
    }


def work_of(name, b, stream_dtype, mm_dtype):
    """(flops, bytes) the function needs at the main-path shape for batch b:
    each input read once, each output written once; the products the
    algorithm needs (the EPEG pass as its 15 taps)."""
    G, RS, C, H, HD, KK = 96, 12, 512, 8, 64, 15
    n, p, nr = G * G, RS * RS, (G // RS) ** 2
    si, mi = torch.tensor([], dtype=stream_dtype).element_size(), \
        torch.tensor([], dtype=mm_dtype).element_size()
    hh = H * HD
    if name.startswith("K1"):
        r = b * nr
        flops = r * H * (3 * 2 * p * C * HD + 2 * KK * p * HD
                         + 2 * 2 * p * p * HD + 2 * p * HD * C)
        byts = 2 * b * n * C * si + b * n + 4 * C * H * HD * mi + 4 * 4 * C
    elif name.startswith("K2"):
        # recompute (qkv, logits + AV, EPEG taps), projection backward (dWp,
        # d(o)), core backward (dv, dA, dY, dk, the pre-EPEG logits and
        # their k diagonals, the transposed taps), qkv backward (dWqkv, dz)
        per_region = (2 * p * C * 3 * hh
                      + H * (4 * p * p * HD + 2 * KK * p * HD)
                      + 4 * p * hh * C
                      + H * (8 * p * p * HD + 2 * p * p * HD + 2 * KK * p * p
                             + 2 * KK * p * HD)
                      + 4 * p * 3 * hh * C)
        flops = b * nr * per_region
        byts = (3 * b * n * C * si + b * n + 4 * C * hh * mi
                + 4 * C * hh * 4 + H * KK * 4 * 2 + 8 * C * 4)
    elif name.startswith("K4"):
        # logits, d(combine), dz (two terms), dphi with k = 1
        flops = b * nr * 5 * 2 * p * C
        byts = (2 * b * n * C * si + b * n + b * nr * (C + p) * 4
                + 3 * 4 * C + 4 * C * 4)
    elif name.startswith("K6"):
        flops = b * H * 4 * nr * nr * HD
        byts = 4 * b * H * nr * HD * si
    elif name.startswith("K7"):
        # the logits again, dv, dA, dY, dk
        flops = b * H * 10 * nr * nr * HD
        byts = 7 * b * H * nr * HD * si
    elif name.startswith("K9"):
        # the stream's w^T reps again, dw, dreps with k = 1
        flops = b * nr * 6 * p * C
        byts = (b * n * C * (3 * si + 4) + b * n + 2 * b * nr * (C + p) * 4
                + 4 * C * 4)
    elif name.startswith("K3"):
        flops = b * nr * 2 * (2 * p * C)
        byts = b * n * C * si + b * n + 3 * 4 * C + b * nr * (C + p) * 4
    elif name.startswith("K5"):
        r, pp = b, nr
        flops = r * H * (3 * 2 * pp * C * HD + 2 * 2 * pp * pp * HD
                         + 2 * pp * HD * C)
        byts = 2 * r * pp * C * si + 4 * C * H * HD * mi + 4 * 4 * C
    elif name.startswith("K8"):
        flops = b * nr * 2 * p * C
        byts = (2 * b * n * C * si + b * n + b * nr * (C + p) * 4
                + b * n * C * 4 + 2 * 4 * C)
    else:
        raise ValueError(f"no work count for {name}")
    return flops, byts


def bound_ms(flops, byts, mm_dtype):
    t_ops = flops / PEAK_FLOPS[mm_dtype]
    t_bytes = byts / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def compare(fn, plain, args, mmd):
    got = _as_tuple(fn(*args, mm_dtype=mmd))
    want = _as_tuple(plain(*args, mm_dtype=mmd))
    torch.cuda.synchronize()
    err, rel = 0.0, 0.0
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} outputs != {len(want)}")
    for a, b in zip(got, want):
        if a is None or b is None:
            if (a is None) != (b is None):
                raise AssertionError("an output is None on one side only")
            continue
        if not a.is_cuda:
            raise AssertionError("the kernel's output is not on the card")
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{tuple(a.shape)} {a.dtype} != "
                                 f"{tuple(b.shape)} {b.dtype}")
        a, b = a.float(), b.float()
        if not torch.isfinite(a).all():
            raise AssertionError("kernel output is not finite")
        e = (a - b).abs().max().item()
        err = max(err, e)
        rel = max(rel, e / max(1.0, b.abs().max().item()))
    return err, rel


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    smi = nvidia_smi_line()
    log(f"[0] nvidia-smi: {smi}")
    log(f"[0] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[0] TF32 off: matmul.allow_tf32=False cudnn.allow_tf32=False")
    return smi


def phase_build():
    from rrtmil_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    info = build.build_all(verbose=True)
    secs = time.perf_counter() - t0
    for name, rec in info.items():
        log(f"[1] nvcc {name}.cu: {rec['seconds']:.1f} s")
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"      {line.strip()}")
    log(f"[1] build: {secs:.1f} s for {len(info)} sources")
    return secs


def phase_kernels(dev):
    errors = {}
    for sdt, mdt in DTYPE_PAIRS:
        pair = f"{dname(sdt)}/{dname(mdt)}"
        cases = kernel_cases(2, dev, sdt)
        cases.update(extra_cases(dev, sdt))
        for name, (fn, plain, args) in cases.items():
            err, rel = compare(fn, plain, args, mdt)
            ok = rel <= TOL[mdt]
            log(f"[2] {name:40s} {pair:17s} max_abs_err {err:.3e} "
                f"scaled {rel:.3e} tol {TOL[mdt]:.0e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} {pair} disagrees with its plain "
                                     f"version: {rel:.3e} > {TOL[mdt]}")
            key = name.split(" (")[0]
            errors.setdefault(key, {})[pair + ("" if key == name else " "
                                               + name[len(key) + 2:-1])] = err
    # the largest c16_r50 bucket: L = 60000 -> G = 248, P = 31 x 31 = 961
    sdt, mdt = DTYPE_PAIRS[0]
    for name, (fn, plain, args) in kernel_cases(1, dev, sdt, G=248,
                                                length=60000).items():
        if name.startswith(("K6", "K7")) or "(" in name:
            continue
        err, rel = compare(fn, plain, args, mdt)
        log(f"[2] {name:40s} L=60000 P=961 max_abs_err {err:.3e} scaled "
            f"{rel:.3e} tol {TOL[mdt]:.0e} {'ok' if rel <= TOL[mdt] else 'FAIL'}")
        if rel > TOL[mdt]:
            raise AssertionError(f"{name} at L=60000 disagrees with its plain "
                                 f"version: {rel:.3e} > {TOL[mdt]}")
        errors[name]["float32/bfloat16 L=60000"] = err
        torch.cuda.empty_cache()
    errors["autograd"] = autograd_checks(dev)
    torch.cuda.empty_cache()
    return errors


def autograd_checks(dev):
    """Each autograd Function's gradients on the card (its backward kernel)
    against autograd through its plain forward, f32 stream and products:
    K1 -> K2 (both residual modes), K3 -> K4, K5 -> block_ref (K6, K7),
    K6 -> K7 (with EPEG), K8 -> K9."""
    from rrtmil_tpu_torch.ops.kernels import crmsa_kernels as ck
    from rrtmil_tpu_torch.ops.kernels import region_attn as ra
    from rrtmil_tpu_torch.ops.kernels import region_block as rb
    from rrtmil_tpu_torch.ops.kernels import region_layer as rl
    mmd = torch.float32
    cases = kernel_cases(2, dev, torch.float32)
    ex = extra_cases(dev, torch.float32)
    checks = {
        "K1->K2": (rl.region_layer_fused, rl.region_layer_plain,
                   cases["K1 region_layer_fused"][2]),
        "K1->K2 add_residual=False": (
            rl.region_layer_fused, rl.region_layer_plain,
            cases["K1 region_layer_fused"][2][:-1] + (False,)),
        "K3->K4": (ck.crmsa_compress_grid, ck.compress_grid_plain,
                   cases["K3 crmsa_compress_grid"][2]),
        "K5->K6,K7": (rb.region_block_fused, rb.region_block_plain,
                      cases["K5 region_block_fused"][2]),
        "K6->K7 (P=144, k=15)": (
            ra.region_attention_fused, ra.region_attention_plain,
            ex["K6 region_attention_fused (P=144, k=15)"][2]),
        "K8->K9": (ck.crmsa_redistribute_grid_ln,
                   ck.redistribute_grid_ln_plain,
                   cases["K8 crmsa_redistribute_grid_ln"][2]),
    }
    out = {}
    for name, (fn, plain, args) in checks.items():
        leaves = [a.detach().clone().requires_grad_(True)
                  if isinstance(a, torch.Tensor) and a.is_floating_point()
                  else a for a in args]
        live = [a for a in leaves if isinstance(a, torch.Tensor)
                and a.requires_grad]
        y = _as_tuple(fn(*leaves, mm_dtype=mmd))
        gs = [torch.randn_like(t) for t in y]
        got = torch.autograd.grad(y, live, gs, allow_unused=True)
        want = torch.autograd.grad(_as_tuple(plain(*leaves, mm_dtype=mmd)),
                                   live, gs, allow_unused=True)
        torch.cuda.synchronize()
        rel = 0.0
        for a, b in zip(got, want):
            if a is None or b is None:
                if (a is None) != (b is None):
                    raise AssertionError(f"{name}: a gradient is missing")
                continue
            rel = max(rel, (a - b).abs().max().item()
                      / max(1.0, b.abs().max().item()))
        ok = rel <= TOL[mmd]
        log(f"[2] autograd {name:28s} float32/float32 grads vs autograd of "
            f"the plain forward: scaled {rel:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: gradients disagree: {rel:.3e}")
        out[name] = rel
    return out


def reset_counters():
    from rrtmil_tpu_torch.ops.kernels import crmsa_kernels as ck
    from rrtmil_tpu_torch.ops.kernels import region_block as rb
    from rrtmil_tpu_torch.ops.kernels import region_layer as rl
    fns = {"K1 region_layer_fused": rl.region_layer_fused,
           "K3 crmsa_compress_grid": ck.crmsa_compress_grid,
           "K5 region_block_fused": rb.region_block_fused,
           "K8 crmsa_redistribute_grid_ln": ck.crmsa_redistribute_grid_ln}
    for f in fns.values():
        f.launches = 0
    return fns


def all_counters():
    """The nine kernels' wrappers, keyed as in TPU_KERNELS."""
    from rrtmil_tpu_torch.ops.kernels import crmsa_kernels as ck
    from rrtmil_tpu_torch.ops.kernels import region_attn as ra
    from rrtmil_tpu_torch.ops.kernels import region_attn_bwd as rab
    from rrtmil_tpu_torch.ops.kernels import region_block as rb
    from rrtmil_tpu_torch.ops.kernels import region_layer as rl
    fns = (rl.region_layer_fused, rl.region_layer_bwd, ck.crmsa_compress_grid,
           ck.crmsa_compress_grid_bwd, rb.region_block_fused,
           ra.region_attention_fused, rab.region_attention_bwd,
           ck.crmsa_redistribute_grid_ln, ck.crmsa_redistribute_grid_ln_bwd)
    return dict(zip(TPU_KERNELS, fns))


def phase_main_path(dev):
    from rrtmil_tpu_torch.config import c16_r50
    from rrtmil_tpu_torch.data.datasets import ArrayDataset
    from rrtmil_tpu_torch.models.rrt import build_model
    from rrtmil_tpu_torch.train.engine import Engine, EngineConfig

    cfg = c16_r50()
    rng = np.random.default_rng(0)
    bags = [rng.standard_normal((n, cfg.input_dim), dtype=np.float32)
            for n in BAG_LENGTHS]
    labels = [i % 2 for i in range(len(bags))]
    ds = ArrayDataset(bags, labels)
    model = build_model(cfg, device=dev, seed=0)
    ecfg = EngineConfig(batch_size=2)
    fns = reset_counters()
    per_batch = []

    class CountingEngine(Engine):
        """Records each kernel's launches in every batch."""

        def _eval_step(self, *a, **k):
            before = {n: f.launches for n, f in fns.items()}
            out = super()._eval_step(*a, **k)
            per_batch.append({n: f.launches - before[n]
                              for n, f in fns.items()})
            return out

    engine = CountingEngine(model, ecfg, cfg.encoder, device=dev)
    n_batches = len(engine._batched_order(ds, range(len(ds))))
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs, labs, loss = engine.evaluate(ds)
    secs = time.perf_counter() - t0
    launches = {k: f.launches for k, f in fns.items()}
    log(f"[3] Engine.evaluate on {len(ds)} bags in {n_batches} batches: "
        f"{secs:.2f} s, mean loss {loss:.6f}, launches {launches}")
    if len(per_batch) != n_batches or any(
            v < 1 for counts in per_batch for v in counts.values()):
        raise AssertionError(f"a batch missed a kernel: {per_batch}")
    if not (np.isfinite(probs).all() and probs.shape == (len(ds),)):
        raise AssertionError(f"bad probabilities {probs}")

    cpu_model = build_model(cfg, device="cpu", seed=0)
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    t0 = time.perf_counter()
    probs_c, labs_c, loss_c = Engine(cpu_model, ecfg, cfg.encoder,
                                     device="cpu").evaluate(ds)
    cpu_secs = time.perf_counter() - t0
    diff = float(np.abs(probs - probs_c).max())
    log(f"[3] CPU plain versions: {cpu_secs:.1f} s, mean loss {loss_c:.6f}; "
        f"max |probs card - probs cpu| {diff:.3e} (tol {PROB_TOL})")
    log(f"[3] probs card {np.round(probs, 5).tolist()}")
    if not np.array_equal(labs, labs_c) or diff > PROB_TOL \
            or abs(loss - loss_c) > PROB_TOL:
        raise AssertionError("card and CPU disagree on the main path")
    return {"batches": n_batches, "seconds": secs, "launches": launches,
            "max_prob_diff": diff, "loss": loss, "loss_cpu": loss_c,
            "probs": probs.tolist()}


def phase_train(dev):
    """Engine.train_epoch on c16_r50 at full width, dropout on, batch size 2:
    every kernel's counter set to 0 just before the epoch and read just
    after, each step required to launch all nine."""
    from rrtmil_tpu_torch.config import c16_r50
    from rrtmil_tpu_torch.data.datasets import ArrayDataset
    from rrtmil_tpu_torch.models.rrt import build_model
    from rrtmil_tpu_torch.train.engine import Engine, EngineConfig

    cfg = c16_r50()
    rng = np.random.default_rng(1)
    bags = [rng.standard_normal((n, cfg.input_dim), dtype=np.float32)
            for n in TRAIN_BAGS]
    ds = ArrayDataset(bags, [i % 2 for i in range(len(bags))])
    model = build_model(cfg, device=dev, seed=0)
    fns = all_counters()
    per_step, losses = [], []

    class CountingEngine(Engine):
        """Records each kernel's launches and the loss of every step."""

        def _train_step(self, *a, **k):
            before = {n: f.launches for n, f in fns.items()}
            out = super()._train_step(*a, **k)
            per_step.append({n: f.launches - before[n]
                             for n, f in fns.items()})
            losses.append(out)
            return out

    engine = CountingEngine(model, EngineConfig(batch_size=2), cfg.encoder,
                            device=dev)
    order = list(range(len(ds)))
    n_steps = len(engine._batched_order(ds, order))
    for f in fns.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = engine.train_epoch(ds, 0, order=order)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {n: f.launches for n, f in fns.items()}
    step_losses = [float(x) for x in losses]
    log(f"[3] Engine.train_epoch on bags {TRAIN_BAGS} in {n_steps} steps "
        f"(dropout on): {secs:.2f} s, mean loss {loss:.6f}, step losses "
        f"{np.round(step_losses, 6).tolist()}")
    log(f"[3] train launches {launches}")
    if len(per_step) != n_steps or any(
            v < 1 for counts in per_step for v in counts.values()):
        raise AssertionError(f"a train step missed a kernel: {per_step}")
    if not (np.isfinite(loss) and np.isfinite(step_losses).all()):
        raise AssertionError(f"the train loss is not finite: {step_losses}")
    if not all(torch.isfinite(p).all() for p in model.parameters()):
        raise AssertionError("a parameter is not finite after training")
    return {"steps": n_steps, "seconds": secs, "launches": launches,
            "per_step": per_step, "loss": loss, "step_losses": step_losses}


def _adam_params_close(got, want, lr, steps, frac):
    """Parameters after `steps` Adam steps: a weight whose gradient is at the
    noise level may step the other way (Adam's first steps are sign-like),
    so at most `frac` of a tensor's elements may differ by more than 1e-5
    (scaled), none by more than 2 * steps * lr * ADAM_STEP.  pe_bias and
    the key third of each qkv bias have gradients that are zero in exact
    arithmetic and are left out."""
    worst_frac, worst = 0.0, 0.0
    for name, a in got.items():
        b = want[name]
        if "pe_bias" in name:
            continue
        if name.endswith("qkv.bias"):
            t = a.shape[0] // 3
            a, b = torch.cat([a[:t], a[2 * t:]]), torch.cat([b[:t], b[2 * t:]])
        d = (a - b).abs()
        worst = max(worst, d.max().item())
        worst_frac = max(worst_frac, (d > 1e-5 + 1e-4 * b.abs()).float()
                         .mean().item())
    ok = worst <= 2 * steps * lr * ADAM_STEP and (frac is None
                                              or worst_frac <= frac)
    return ok, worst, worst_frac


def phase_train_vs_cpu(dev):
    """Two train steps with dropout off on small bags, on the card and on
    the CPU from the same weights: the step losses, the first step's
    gradients and the parameters after both updates, in f32/f32 (TF32 off)
    and with bf16 products."""
    import dataclasses
    from rrtmil_tpu_torch.config import c16_r50
    from rrtmil_tpu_torch.data.datasets import ArrayDataset
    from rrtmil_tpu_torch.models.rrt import build_model
    from rrtmil_tpu_torch.train.engine import Engine, EngineConfig

    base = c16_r50()
    rng = np.random.default_rng(2)
    ds = ArrayDataset([rng.standard_normal((n, base.input_dim),
                                           dtype=np.float32)
                       for n in (937, 2213)], [0, 1])
    ecfg = EngineConfig(batch_size=2)
    out = {}
    for mm in ("float32", "bfloat16"):
        tol = TOL[torch.float32 if mm == "float32" else torch.bfloat16]
        cfg = dataclasses.replace(base, dropout=0.0, encoder=dataclasses
                                  .replace(base.encoder, dropout=0.0,
                                           mm_dtype=mm))
        runs = {}
        for key, d in (("card", dev), ("cpu", "cpu")):
            rec = {"losses": [], "grads": None}

            class Recording(Engine):
                def _train_step(self, *a, **k):
                    loss = super()._train_step(*a, **k)
                    rec["losses"].append(float(loss))
                    return loss

                def _apply_grads(self, lr):
                    if rec["grads"] is None:
                        rec["grads"] = {n: p.grad.detach().float().cpu()
                                        for n, p in
                                        self.model.named_parameters()}
                    super()._apply_grads(lr)

            model = build_model(cfg, device=d, seed=0)
            t0 = time.perf_counter()
            Recording(model, ecfg, cfg.encoder, device=d).train_epoch(
                ds, 0, order=[0, 1])
            rec["seconds"] = time.perf_counter() - t0
            rec["params"] = {n: p.detach().float().cpu()
                             for n, p in model.named_parameters()}
            runs[key] = rec
        card, cpu = runs["card"], runs["cpu"]
        dloss = max(abs(a - b) for a, b in zip(card["losses"], cpu["losses"]))
        dgrad = max((card["grads"][n] - g).abs().max().item()
                    / max(1.0, g.abs().max().item())
                    for n, g in cpu["grads"].items())
        ok_p, dparam, frac = _adam_params_close(
            card["params"], cpu["params"], ecfg.lr, 2,
            1e-3 if mm == "float32" else None)
        ok = dloss <= tol * max(1.0, max(map(abs, cpu["losses"]))) \
            and dgrad <= tol and ok_p
        log(f"[3] train card vs CPU, dropout off, {mm} products: step losses "
            f"{np.round(card['losses'], 6).tolist()} vs "
            f"{np.round(cpu['losses'], 6).tolist()} (max diff {dloss:.3e}); "
            f"first-step grads scaled {dgrad:.3e} (tol {tol:.0e}); params "
            f"after 2 steps max diff {dparam:.3e} (bound "
            f"{4 * ecfg.lr * ADAM_STEP:.2e}), "
            f"share past 1e-5 {frac:.2e}; card {card['seconds']:.1f} s, CPU "
            f"{cpu['seconds']:.1f} s {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"train steps on the card and the CPU "
                                 f"disagree ({mm} products)")
        out[mm] = {"loss_diff": dloss, "grad_scaled_err": dgrad,
                   "param_max_diff": dparam, "param_share_past": frac,
                   "card_losses": card["losses"], "cpu_losses": cpu["losses"]}
    return out


def k5_library_call(args, mmd):
    """One PyTorch call computing K5 at kk = 0: multi-head self-attention
    with in- and out-projection, on x and weights cast to the mm dtype
    beforehand.  wq/bq arrive with the q scale folded in; the library applies
    it itself, so it gets them unscaled.  Timed only: the port never calls
    it."""
    import torch.nn.functional as F
    x, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp = args
    if pw is not None:
        raise ValueError("no library call computes K5 with EPEG")
    h, c, hd = wq.shape
    scale = hd ** -0.5
    lin = lambda w: w.permute(0, 2, 1).reshape(h * hd, c)
    in_w = torch.cat([lin(wq) / scale, lin(wk), lin(wv)]).to(mmd)
    in_b = torch.cat([bq.reshape(-1) / scale, bk.reshape(-1),
                      bv.reshape(-1)]).to(mmd)
    out_w = wp.reshape(h * hd, c).t().contiguous().to(mmd)
    out_b = bp.to(mmd)
    q = x.to(mmd).transpose(0, 1)          # (P, R, C): sequence first

    def call():
        return F.multi_head_attention_forward(
            q, q, q, c, h, in_w, in_b, None, None, False, 0.0, out_w, out_b,
            training=False, need_weights=False)[0]
    return call


def attention_library_calls(args, mmd):
    """K6 and K7 at kk = 0 as one PyTorch call: scaled_dot_product_attention
    at scale 1 on q, k, v cast to the mm dtype beforehand, and its backward
    through autograd (the K7 library time is the forward-plus-backward call
    minus the forward).  Timed only: the port never calls it."""
    import torch.nn.functional as F
    q, k, v, w, b, g, scale = args
    if w is not None:
        raise ValueError("no library call computes the core with EPEG")
    qm, km, vm = (t.to(mmd).detach().requires_grad_(True) for t in (q, k, v))
    gm = g.to(mmd)

    def fwd():
        return F.scaled_dot_product_attention(qm, km, vm, scale=scale)

    def fwd_bwd():
        return torch.autograd.grad(fwd(), (qm, km, vm), gm)
    return fwd, fwd_bwd


def _library_check(name, got, want):
    rel = max((a.float() - b.float()).abs().max().item()
              / max(1.0, b.float().abs().max().item())
              for a, b in zip(got, want))
    log(f"[4] {name} library call vs plain: scaled {rel:.3e} "
        f"(tol {LIBRARY_TOL})")
    if rel > LIBRARY_TOL:
        raise AssertionError(f"the library call does not compute {name}'s "
                             f"function: {rel:.3e}")


def phase_times(dev):
    rows = {}
    for b in (1, 8):
        cases = kernel_cases(b, dev, torch.float32)
        for name, (fn, plain, args) in cases.items():
            if "(" in name:
                continue
            mmd = torch.bfloat16
            ms = time_ms(lambda: fn(*args, mm_dtype=mmd))
            plain_ms = time_ms(lambda: plain(*args, mm_dtype=mmd), iters=5,
                               warmup=1)
            lib_ms = None
            if name.startswith("K5"):
                lib = k5_library_call(args, mmd)
                _library_check(name, (lib().transpose(0, 1),),
                               (plain(*args, mm_dtype=mmd),))
                lib_ms = time_ms(lib)
            if name.startswith(("K6", "K7")):
                q, k, v, _, _, g, _ = cases["K7 region_attention_bwd"][2]
                fwd, fwd_bwd = attention_library_calls(
                    (q, k, v, None, None, g, 1.0), mmd)
                if name.startswith("K6"):
                    _library_check(name, (fwd(),),
                                   (plain(*args, mm_dtype=mmd),))
                    lib_ms = time_ms(fwd)
                else:
                    _library_check(name, fwd_bwd(),
                                   plain(*args, mm_dtype=mmd)[:3])
                    lib_ms = max(0.0, time_ms(fwd_bwd) - time_ms(fwd))
            flops, byts = work_of(name, b, torch.float32, mmd)
            bms, by = bound_ms(flops, byts, mmd)
            rows.setdefault(name, {})[str(b)] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                "bound_by": by, "library_ms": lib_ms, "flops": flops,
                "bytes": byts}
            log(f"[4] {name:32s} B={b}: {ms:.4f} ms (plain {plain_ms:.4f}, "
                f"bound {bms:.4f} by {by}, library "
                f"{'none' if lib_ms is None else f'{lib_ms:.4f}'})")
        torch.cuda.empty_cache()
    return rows


def phase_throughput(dev):
    from rrtmil_tpu_torch.config import c16_r50
    from rrtmil_tpu_torch.data.bucketing import bucket_for
    from rrtmil_tpu_torch.models.rrt import build_model
    from rrtmil_tpu_torch.utils.flops import rrtmil_flops

    cfg = c16_r50()
    model = build_model(cfg, device=dev, seed=0)
    spec = bucket_for(9000, cfg.encoder)
    flops = 2 * rrtmil_flops(9000, cfg)["total"]
    out = {}
    for b in (1, 4, 8):
        g = _gen(b)
        x = torch.zeros((b, spec.data_length, cfg.input_dim))
        x[:, :9000] = _randn((b, 9000, cfg.input_dim), g)
        x = x.to(dev)
        mask = (torch.arange(spec.data_length) < 9000)[None].expand(b, -1) \
            .contiguous().to(dev)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            ms = time_ms(lambda: model(x, mask=mask, length=spec.repr_length),
                         iters=10, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rate = b / (ms / 1e3)
        out[str(b)] = {"ms_per_batch": ms, "slides_per_s": rate,
                       "peak_mem_gib": peak,
                       "achieved_tflops": rate * flops / 1e12}
        log(f"[4] forward L=9000 B={b}: {ms:.3f} ms/batch, {rate:.2f} "
            f"slides/s, {rate * flops / 1e12:.2f} TFLOP/s, peak {peak:.2f} GiB")
        del x, mask
    return out


def train_setup(dev, b):
    """A seeded c16_r50 train engine on the card (dropout on) and one batch
    of b 9000-patch bags, device-resident; returns (engine, step, spec)."""
    from rrtmil_tpu_torch.config import c16_r50
    from rrtmil_tpu_torch.data.bucketing import bucket_for
    from rrtmil_tpu_torch.models.rrt import build_model
    from rrtmil_tpu_torch.train.engine import Engine, EngineConfig

    cfg = c16_r50()
    spec = bucket_for(9000, cfg.encoder)
    eng = Engine(build_model(cfg, device=dev, seed=0),
                 EngineConfig(batch_size=b), cfg.encoder, device=dev)
    eng.model.train()
    g = _gen(b)
    x = torch.zeros((b, spec.data_length, cfg.input_dim))
    x[:, :9000] = _randn((b, 9000, cfg.input_dim), g)
    x = x.to(dev)
    mask = (torch.arange(spec.data_length) < 9000)[None].expand(b, -1) \
        .contiguous().to(dev)
    labels = (torch.arange(b) % 2).to(dev)

    def step():
        eng._train_step(x, mask, labels, spec.repr_length)
        eng._apply_grads(eng.cfg.lr)
    return eng, step, cfg


def phase_train_throughput(dev):
    """Train slides/s at L = 9000 (forward, backward and the Adam update,
    dropout on) for B in {1, 8}, with peak memory and useful TFLOP/s from
    utils.flops.train_flops."""
    from rrtmil_tpu_torch.utils.flops import train_flops
    out = {}
    for b in (1, 8):
        eng, step, cfg = train_setup(dev, b)
        flops = train_flops(9000, cfg)
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(step, iters=5, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rate = b / (ms / 1e3)
        out[str(b)] = {"ms_per_step": ms, "slides_per_s": rate,
                       "peak_mem_gib": peak,
                       "achieved_tflops": rate * flops / 1e12}
        log(f"[4] train L=9000 B={b}: {ms:.3f} ms/step, {rate:.2f} slides/s, "
            f"{rate * flops / 1e12:.2f} TFLOP/s, peak {peak:.2f} GiB")
        del eng, step
        torch.cuda.empty_cache()
    return out


def phase_profile(dev, b=8, iters=3, train=False):
    """torch.profiler over `iters` forwards (or train steps) at L = 9000,
    batch b: device time by kernel name and the device's busy share of the
    window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from rrtmil_tpu_torch.config import c16_r50
    from rrtmil_tpu_torch.data.bucketing import bucket_for
    from rrtmil_tpu_torch.models.rrt import build_model

    if train:
        _, fn, _ = train_setup(dev, b)
        grad = torch.enable_grad
    else:
        cfg = c16_r50()
        model = build_model(cfg, device=dev, seed=0)
        spec = bucket_for(9000, cfg.encoder)
        x = torch.zeros((b, spec.data_length, cfg.input_dim), device=dev)
        x[:, :9000] = torch.randn((b, 9000, cfg.input_dim), device=dev)
        mask = (torch.arange(spec.data_length, device=dev) < 9000)[None] \
            .expand(b, -1).contiguous()

        def fn():
            model(x, mask=mask, length=spec.repr_length)
        grad = torch.no_grad
    what = "train step" if train else "forward"
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with grad():
        with profile(activities=acts):          # starts the tracer up
            fn()
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: the ops that launch them carry the same device time
    rows = [(ev.key, ev.self_device_time_total / 1e3 / iters)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) * iters
    top = 16 if train else 12
    for name, ms in rows[:top]:
        log(f"[5] {ms:9.4f} ms/{what}  {name[:90]}")
    log(f"[5] B={b}: kernels {busy / iters:.3f} ms per {what}; the "
        f"profiled window {wall_ms / iters:.3f} ms per {what} (busy share "
        f"{busy / wall_ms:.3f}, profiler overhead included)"
        if rows else "[5] the profiler recorded no device time")
    return {"batch": b, "what": what, "wall_ms_per_iter": wall_ms / iters,
            "kernel_ms_per_iter": busy / iters,
            "busy_share": busy / wall_ms if rows else None,
            "top": [{"kernel": n, "ms_per_iter": ms} for n, ms in rows[:top]]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="phases 0-2 only (build and kernel checks)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        sys.exit(2)
    from rrtmil_tpu_torch.ops.kernels import build  # noqa: F401  (repo check)

    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    smi = phase_device()
    report = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
              "build_s": phase_build(), "errors": phase_kernels(dev)}
    if not args.quick:
        report["main_path"] = phase_main_path(dev)
        report["train"] = phase_train(dev)
        report["train_vs_cpu"] = phase_train_vs_cpu(dev)
        report["times"] = phase_times(dev)
        report["throughput"] = phase_throughput(dev)
        report["train_throughput"] = phase_train_throughput(dev)
        report["profile"] = phase_profile(dev)
        report["train_profile"] = phase_profile(dev, iters=1, train=True)
    report["seconds"] = time.perf_counter() - t_start

    kernels = []
    for name, (replaces, jax_fn, source) in TPU_KERNELS.items():
        errs = report["errors"][name]
        eval_n = report.get("main_path", {}).get("launches", {}).get(name)
        train_n = report.get("train", {}).get("launches", {}).get(name, 0)
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "jax_function": jax_fn,
               "launches": train_n,
               "launches_by_path": {"train_epoch": train_n,
                                    "evaluate": eval_n},
               "max_abs_err": max(errs.values()), "max_abs_err_by_dtype": errs}
        t = report.get("times", {}).get(name)
        if t:
            row.update({k: t["8"][k] for k in ("ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")})
            row["by_batch"] = {b: {k: v for k, v in rec.items()
                                   if k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")}
                               for b, rec in t.items()}
        kernels.append(row)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/chip_smoke.json", "w") as f:
        json.dump({**report, "kernels": kernels}, f, indent=1)
    log(f"total {report['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
