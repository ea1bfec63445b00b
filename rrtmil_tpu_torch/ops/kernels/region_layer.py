"""K1: the whole R-MSA TransLayer forward, as CUDA kernels.

Replaces `rrtmil_tpu/ops/pallas/region_layer.py::_layer_fwd_pallas`
(kernel body `_layer_kernel`, pallas_call at region_layer.py:231):

    LN (eps 1e-6, fast variance) -> mask -> region partition -> per-head
    qkv (scale folded into wq/bq) -> (I + T_h) q EPEG -> + pe_bias ->
    softmax -> AV -> out-proj -> region reverse -> mask -> + x

on the (B, G*G, C) stream, in x's dtype.  The CUDA source is
`csrc/region_layer.cu` (a three-step pipeline: LN + qkv product, attention
core, projection + residual); its note says what bounds it on an H100 and
what the design does about it.

`region_layer_fused` launches the kernels for a CUDA tensor (through the
`torch.autograd.Function` shell, whose backward -- K2 -- is the next
slice) and runs `region_layer_plain` for a CPU tensor.
"""
from __future__ import annotations

import torch

from ..regions import region_partition, region_reverse
from . import build
from .common import LN_EPS, ln_mask_plain, mm_round
from .region_block import block_core_plain, check_heads, qkv_weights


def region_layer_plain(x, mask, ln_s, ln_b, wq, wk, wv, bq, bk, bv, pw, pb,
                       wp, bp, grid_side: int, region_size: int,
                       add_residual: bool,
                       mm_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K1 (same rounding points, fp32 sums)."""
    b, n, c = x.shape
    g, rs = grid_side, region_size
    xf = x.float()
    z = mm_round(ln_mask_plain(x, mask, ln_s, ln_b), mm_dtype)
    regions = region_partition(z.reshape(b, g, g, c), rs)
    y = block_core_plain(regions, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp,
                         mm_dtype)
    out = region_reverse(y, rs, g, g) * mask.float()[..., None]
    if add_residual:
        out = xf + out
    return out.to(x.dtype)


def check_grid(x: torch.Tensor, mask: torch.Tensor, grid_side: int,
               region_size: int) -> None:
    b, n, c = x.shape
    if n != grid_side * grid_side or grid_side % region_size != 0:
        raise ValueError(f"stream of {n} tokens is not a {grid_side}^2 grid "
                         f"of {region_size}-wide regions")
    if mask.shape != (b, n) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool {(b, n)}")
    if c > 1024:
        raise ValueError(f"the row kernels take C <= 1024, not {c}")


def _launch(x, mask, ln_s, ln_b, wq, wk, wv, bq, bk, bv, pw, pb, wp, bp,
            g, rs, add_residual, mmd):
    b, n, c = x.shape
    h, _, hd = wq.shape
    check_grid(x, mask, g, rs)
    kk = check_heads(wq, pw)
    build.require_cuda({"x": x, "mask": mask},
                       dict(ln_s=ln_s, ln_b=ln_b, wq=wq, wk=wk, wv=wv, bq=bq,
                            bk=bk, bv=bv, pw=pw, pb=pb, wp=wp, bp=bp))
    lib = build.load("region_layer")
    s = build.stream_of(x)
    ts, tm = build.dtype_code(x.dtype), build.dtype_code(mmd)
    m, nq, hh = b * n, 3 * h * hd, h * hd
    ls, lb = ln_s.float().contiguous(), ln_b.float().contiguous()
    z = torch.empty((m, c), dtype=mmd, device=x.device)
    build.check(lib.rl_ln_mask(ts, tm, x.data_ptr(), mask.data_ptr(),
                               ls.data_ptr(), lb.data_ptr(), z.data_ptr(), m,
                               c, LN_EPS, s), "K1 layernorm")
    wqkv, bqkv = qkv_weights(wq, wk, wv, bq, bk, bv, mmd)
    y = torch.empty((m, nq), dtype=mmd, device=x.device)
    build.check(lib.rl_gemm(tm, tm, tm, z.data_ptr(), c, wqkv.data_ptr(), nq,
                            y.data_ptr(), nq, m, nq, c, bqkv.data_ptr(), None,
                            None, 0, s), "K1 qkv")
    pw_f = pw.float().contiguous() if pw is not None else None
    pb_f = pb.float().contiguous() if (pw is not None and pb is not None) \
        else None
    o = torch.empty((m, hh), dtype=mmd, device=x.device)
    build.check(lib.rl_attention(tm, y.data_ptr(), nq, hh, 2 * hh,
                                 o.data_ptr(), hh, b * (g // rs) ** 2, h, hd,
                                 rs * rs, g, rs, build.ptr(pw_f), kk,
                                 build.ptr(pb_f), s), "K1 attention")
    wp2 = wp.reshape(hh, c).to(mmd).contiguous()
    bp_f = bp.float().contiguous()
    out = torch.empty_like(x)
    build.check(lib.rl_gemm(tm, tm, ts, o.data_ptr(), hh, wp2.data_ptr(), c,
                            out.data_ptr(), c, m, c, hh, bp_f.data_ptr(),
                            mask.data_ptr(),
                            x.data_ptr() if add_residual else None, c, s),
                "K1 projection")
    region_layer_fused.launches += 1
    return out


class _RegionLayer(torch.autograd.Function):
    """Autograd shell of K1 on the card; its backward is K2."""

    @staticmethod
    def forward(ctx, x, mask, ln_s, ln_b, wq, wk, wv, bq, bk, bv, pw, pb, wp,
                bp, grid_side, region_size, add_residual, mm_dtype):
        return _launch(x, mask, ln_s, ln_b, wq, wk, wv, bq, bk, bv, pw, pb,
                       wp, bp, grid_side, region_size, add_residual, mm_dtype)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "region_layer_fused backward (K2, region_layer.py::"
            "_layer_bwd_pallas) is the next slice: ROADMAP.md queue 2")


def region_layer_fused(x, mask, ln_s, ln_b, wq, wk, wv, bq, bk, bv, pw, pb,
                       wp, bp, grid_side: int, region_size: int,
                       add_residual: bool,
                       mm_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x: (B, G*G, C) float32 or bfloat16; mask (B, G*G) bool; wq/wk/wv
    (H, C, hd) with wq/bq pre-scaled; bq/bk/bv (H, hd); pw (H, k) or None;
    pb (H,) or None; wp (H, hd, C); bp (C,).  Returns the post-layer stream
    (add_residual) or the masked attention branch, in x's dtype."""
    if x.device.type == "cpu":
        return region_layer_plain(x, mask, ln_s, ln_b, wq, wk, wv, bq, bk, bv,
                                  pw, pb, wp, bp, grid_side, region_size,
                                  add_residual, mm_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"region_layer_fused: no kernel for {x.device}")
    return _RegionLayer.apply(x, mask, ln_s, ln_b, wq, wk, wv, bq, bk, bv, pw,
                              pb, wp, bp, grid_side, region_size,
                              add_residual, mm_dtype)


region_layer_fused.launches = 0
