"""RRT: regional re-embedding transformer, PyTorch port.

Counterpart of `rrtmil_tpu/models/rrt.py`: InnerAttention with every
EPEG variant (1-D or 2-D 'attn', 'value_bf', 'value_af', or none) and
attention-probability dropout, RegionAttention, CrossRegionAttention with
phi or the phi MLP (`crmsa_mlp`), the fused CR-MSA attention, DropPath,
Mlp, TransLayer (with the optional FFN), RRTEncoder and RRTMIL;
the Nystrom variants (`region_attn='ntrans'` inside each region,
`attn_mode='ntrans'` over the stream, models/nystrom.py) and the position
embeddings (`pos`, models/posemb.py), which the JAX package computes in
plain XLA and the port as torch ops on either device.
Parameters keep the flax tree's names (state_dict keys are the flax paths
joined by '.', see convert.py); tensors keep torch's layouts (Linear weight
(out, in)); the EPEG taps are stored as `pe_weight` (C, k) for a (k, 1)
kernel, the layout the kernels take, or (C, k, k) for a 2-D one (C the
heads for 'attn', h * hd for the value convs; ops/epeg.py).

Two structures, as in the JAX package:

* fused (backend 'auto' or 'pallas', a mask, and a stream at the layer's
  padded length): the R-MSA layer is one call of K1 (`region_layer_fused`);
  the CR-MSA layer is K3 -> the cross-region InnerAttention (K5) -> K8 with
  the encoder-final LayerNorm and the global shortcut, or -> K10 (the
  redistribution without the LayerNorm) when an FFN follows the layer or
  stochastic depth is on in train mode.
* unfused (backend 'xla', no mask, or a stream longer than the layer's
  grid, as every survival bucket whose R-MSA grid exceeds the CR-MSA grid):
  the module-by-module formulation.  Its InnerAttention is K5, and its
  CrossRegionAttention takes the structure of the JAX package's fused
  non-grid CR-MSA (rrt.py:366-390): partition -> K12 -> the cross-region
  InnerAttention -> K13 -> reverse.

On a CUDA tensor every route launches the hand-written kernels, whatever
the backend (`crmsa_mlp`'s phi MLP, dual softmax and einsums are torch ops
on either device, as the JAX package runs them in XLA outside any Pallas
kernel): the JAX package's 'xla' backend never reaches a Pallas kernel
(rrt.py:150-151), but the port runs no eager code on the card, so there
'xla' selects only the unfused structure, and its kernels run with float32
products (`products_dtype`), which round nothing, as the XLA einsums.  On a
CPU tensor the kernels' plain versions run, and backend 'xla' keeps the JAX
package's XLA formulation of InnerAttention; its CrossRegionAttention is
K12/K13's plain versions with float32 products.

The JAX package's TPU gates (layer_fusable_geometry, crmsa_fusable_geometry,
legal_cb) have no counterpart: the kernels take every geometry of these
configs and raise on one they cannot take.  Its configuration gates do:
InnerAttention runs K5 only where JAX's `fusable` holds (1-D 'attn' EPEG or
none, and no attention dropout: `fusable`), and the R-MSA layer is one K1 call
only under the same EPEG condition (`fused_layer_ok`); the other EPEG
variants and attention dropout run the JAX package's XLA formulation as
torch ops on either device, as JAX runs XLA there (rrt.py:218-273).  An
`epeg.kind` outside 'attn', 'value_bf', 'value_af' adds no positional term
and has no taps, as in JAX.

Sequence sharding (`sp_shards > 1` in the config, the sp group's
`parallel.collectives.ShardGroup` handed to the modules as `sp_group`; the
JAX package's `shard_map` branches, rrt.py:294-325,350-440,868-882): each
rank holds `grid // sp` whole grid rows of the bag.  The R-MSA layer
partitions its slab and reverses it with `grid // sp` rows, LayerNorm ->
K5 a region -> residual; the CR-MSA layer compresses its own `nR // sp`
regions (K12), all-gathers the (B, k, nR_local, C) representatives along
the region axis, runs the cross-region InnerAttention (K5) replicated,
keeps its own slice and redistributes it (K13), K12 and K13 with float32
products, as JAX's float32 einsums there (its fused kernels need sp = 1,
rrt.py:366-369).  `fused_layer_ok` and `fused_crmsa_ok` are False under
sp, so K1-K4 and K8-K11 never see a slab; the pool takes the sp group
(models/pool.py).  Position embeddings and the stream-wide Nystrom
attention would read across the slabs' edges and raise under sp.

`model.train()` plays the role of the JAX package's `deterministic=False`:
dropout and stochastic depth go where the JAX model puts them (after
`patch_to_emb` and its activation; on the R-MSA branch outside K1, which
then runs with add_residual=False, whenever projection dropout or drop_path
is on; after K5's output; after the projection in the unfused
InnerAttention; inside the Mlp; per sample on each residual branch, where a
fused CR-MSA layer then runs K10 with add_residual=False and adds the
branch outside).  Masks come from the `torch.Generator` the caller passes
as `generator=`; there is no global RNG.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import (CRMSAConfig, InnerAttentionConfig, RMSAConfig,
                      RRTEncoderConfig, RRTMILConfig, TransLayerConfig)
from ..ops.epeg import epeg_logit_conv, value_pe
from ..ops.kernels.common import ln_fast
from ..ops.kernels.crmsa_kernels import (crmsa_compress, crmsa_compress_grid,
                                         crmsa_redistribute,
                                         crmsa_redistribute_grid,
                                         crmsa_redistribute_grid_ln)
from ..ops.kernels.region_block import region_block_fused
from ..ops.kernels.region_layer import region_layer_fused
from ..ops.regions import grid_geometry, region_partition, region_reverse
from ..parallel.collectives import ShardGroup, all_gather
from ..utils.device import resolve_device
from ..utils.inits import crmsa_phi_init_, xavier_normal_
from .nystrom import NystromAttention
from .pool import DAttention, MeanPool, dropout, keep_mask
from .posemb import build_pos_embedding

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def drop_path(x: torch.Tensor, rate: float,
              generator: Optional[torch.Generator],
              training: bool) -> torch.Tensor:
    """Per-sample stochastic depth (timm DropPath, rrt.py:71-84): each
    sample's branch is kept with probability 1 - rate and scaled by
    1 / (1 - rate); the (B, 1, ..., 1) mask is drawn from `generator`."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    m = keep_mask(x, keep, generator, per_sample=True)
    return torch.where(m.bool(), x / keep, torch.zeros_like(x))


def _slab_rows(geom, sp: int) -> int:
    """The grid rows of one rank's slab; raises unless the grid splits into
    whole region-rows over `sp` ranks (rrt.py:300-304)."""
    if geom.grid % (sp * geom.region_size) != 0:
        raise ValueError(
            f"seqshard: grid {geom.grid} must split into whole region-rows "
            f"across sp={sp} (region_size={geom.region_size})")
    return geom.grid // sp


def _check_group(sp: int, sp_group: Optional[ShardGroup]) -> None:
    if sp > 1 and (sp_group is None or sp_group.size != sp):
        raise ValueError(f"sp_shards={sp} needs the sp group of {sp} ranks "
                         f"(sp_group=, parallel/mesh.make_mesh)")


def _fit_length(x: torch.Tensor, target: int) -> torch.Tensor:
    """Slice or zero-pad the token axis of (B, N, C) to `target`."""
    n = x.shape[1]
    if n == target:
        return x
    if n > target:
        return x[:, :target]
    return F.pad(x, (0, 0, 0, target - n))


class LayerNorm(nn.Module):
    """flax nn.LayerNorm(dtype=float32): fast variance, eps 1e-6, fp32 out."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return ln_fast(x.float(), self.weight, self.bias)


class Mlp(nn.Module):
    """FFN block fc1 -> act -> dropout -> fc2 -> dropout (rrt.py:87-106),
    exact (erf) GELU."""

    def __init__(self, dim: int, hidden: int, act: str = "gelu",
                 p: float = 0.0):
        super().__init__()
        self.act, self.p = act, p
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = self.fc1(x)
        # any act but 'gelu' is ReLU, as in the JAX Mlp
        x = F.gelu(x, approximate="none") if self.act == "gelu" else F.relu(x)
        x = dropout(x, self.p, generator, self.training)
        return dropout(self.fc2(x), self.p, generator, self.training)


def fusable(cfg: InnerAttentionConfig) -> bool:
    """JAX's `fusable` (rrt.py:148-149): no EPEG or the 1-D 'attn' kind, and
    no attention dropout; only then does InnerAttention run K5."""
    ep = cfg.epeg
    return ((not ep.enabled or (ep.kind == "attn" and not ep.two_d))
            and cfg.attn_dropout == 0.0)


GEOMETRY_ITEM = "ROADMAP.md queue 3 item 1"


def kernel_geometry_error(enc: RRTEncoderConfig) -> Optional[str]:
    """Why the card's kernels cannot run this encoder's attention geometry
    (the head widths of R-MSA and CR-MSA, the EPEG taps, crmsa_k), or None:
    the kernels' own checks (`region_attn.check_geometry`,
    `crmsa_kernels.check_k`) on its flags.  The JAX package runs every
    geometry, falling back to XLA where its kernels refuse one; the port
    runs nothing eager on the card, so the CLIs refuse these before any
    work."""
    from ..ops.kernels.crmsa_kernels import check_k
    from ..ops.kernels.region_attn import check_geometry
    layers = []
    if enc.n_layers > 1 and enc.attn_mode == "rmsa" and \
            enc.region_attn == "native":
        layers.append(("R-MSA", f"--n_heads {enc.n_heads}",
                       enc.rmsa_layer().rmsa.attn))
    if enc.cr_msa:
        layers.append(("CR-MSA", f"--crmsa_heads {enc.crmsa_heads}",
                       enc.crmsa_layer().crmsa.attn))
    try:
        if enc.cr_msa:
            what = f"--crmsa_k {enc.crmsa_k}: CR-MSA"
            check_k(enc.crmsa_k)
        for name, flag, a in layers:
            if not fusable(a):
                continue      # torch ops on either device (ops/epeg.py)
            what = f"{flag}: {name}"
            check_geometry(a.resolved_head_dim,
                           a.epeg.k if a.epeg.enabled else 0)
    except ValueError as err:
        return f"{what}: {err}; see {GEOMETRY_ITEM}"
    return None


def check_kernel_geometry(enc: RRTEncoderConfig, device) -> None:
    """Raise ValueError, before any work, when `device` is not the CPU
    and its kernels cannot run the encoder's geometry
    (`kernel_geometry_error`); the CPU's plain versions run every one."""
    if str(device) == "cpu":
        return
    err = kernel_geometry_error(enc)
    if err is not None:
        raise ValueError(f"not on the card: {err}")


class InnerAttention(nn.Module):
    """Scaled-dot-product MHSA over one region's tokens, with EPEG
    (reference modules/rmsa.py:56-134).  Input (B_, N, C).

    EPEG kinds (`cfg.epeg`): 'attn' adds the depthwise conv of the logits,
    (k, 1) or 2-D (k, k); 'value_bf' adds the value conv to v before the AV
    product; 'value_af' adds it, flat, to the output before the projection
    (ops/epeg.py, with the reference's channel order); any other kind adds
    nothing.  `attn_dropout` drops attention probabilities in train mode,
    its mask drawn from the caller's generator."""

    def __init__(self, cfg: InnerAttentionConfig):
        super().__init__()
        ep = cfg.epeg
        self.cfg = cfg
        h, hd = cfg.num_heads, cfg.resolved_head_dim
        self.qkv = nn.Linear(cfg.dim, 3 * h * hd, bias=cfg.qkv_bias)
        self.proj = nn.Linear(h * hd, cfg.dim)
        self.pe_weight, self.pe_bias = None, None
        if ep.enabled and ep.kind in ("attn", "value_bf", "value_af"):
            ch = h if ep.kind == "attn" else h * hd
            taps = (ep.k, ep.k) if ep.two_d and ep.k > 1 else (ep.k,)
            self.pe_weight = nn.Parameter(torch.zeros(ch, *taps))
            self.pe_bias = nn.Parameter(torch.zeros(ch)) if ep.bias else None

    def kernel_weights(self):
        """The kernels' weight layout (region_block.py:168-180): wq/wk/wv
        (H, C, hd) with the q scale folded into wq/bq, biases (H, hd), the
        EPEG taps (H, k) and bias (H,), wp (H, hd, C) and bp (C,)."""
        cfg = self.cfg
        h, hd = cfg.num_heads, cfg.resolved_head_dim
        c = self.qkv.in_features
        w3 = self.qkv.weight.reshape(3, h, hd, c).transpose(-1, -2)
        b = self.qkv.bias if self.qkv.bias is not None else \
            torch.zeros(3 * h * hd, device=w3.device)
        b3 = b.reshape(3, h, hd)
        wp = self.proj.weight.t().reshape(h, hd, cfg.dim)
        return (w3[0] * cfg.scale, w3[1], w3[2], b3[0] * cfg.scale, b3[1],
                b3[2], self.pe_weight, self.pe_bias, wp, self.proj.bias)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        cdt = _dtype(cfg.compute_dtype)
        if fusable(cfg) and (x.is_cuda or cfg.backend != "xla"):
            out = region_block_fused(x.to(cdt), *self.kernel_weights(),
                                     mm_dtype=products_dtype(cfg))
        else:
            out = self._forward_xla(x, cdt, generator)
        return dropout(out, cfg.proj_dropout, generator, self.training)

    def _forward_xla(self, x, cdt, generator):
        """The JAX package's XLA formulation (rrt.py:218-273): on the CPU
        for backend 'xla', and on either device for what is not `fusable`.
        The EPEG convs run in float32, as flax promotes a bf16 value image
        against its float32 taps."""
        cfg = self.cfg
        ep = cfg.epeg
        kind = ep.kind if ep.enabled else None
        b_, n, _ = x.shape
        h, hd = cfg.num_heads, cfg.resolved_head_dim
        bias = None if self.qkv.bias is None else self.qkv.bias.to(cdt)
        qkv = F.linear(x.to(cdt), self.qkv.weight.to(cdt), bias)
        qkv = qkv.reshape(b_, n, 3, h, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * cfg.scale, qkv[1], qkv[2]
        attn = torch.einsum("bhid,bhjd->bhij", q.float(), k.float())
        if kind == "attn":
            attn = attn + epeg_logit_conv(attn, self.pe_weight, self.pe_bias)
        attn = torch.softmax(attn, dim=-1)
        attn = dropout(attn, cfg.attn_dropout, generator, self.training)
        v_in = v
        if kind == "value_bf":
            v = v.float() + value_pe(v, self.pe_weight, self.pe_bias)
        out = torch.einsum("bhij,bhjd->bhid", attn.to(v.dtype).float(),
                           v.float())
        out = out.transpose(1, 2).reshape(b_, n, h * hd).to(cdt)
        if kind == "value_af":
            out = out.float() + value_pe(v_in, self.pe_weight, self.pe_bias,
                                         flat=True)
        return F.linear(out.to(cdt), self.proj.weight.to(cdt),
                        self.proj.bias.to(cdt))


def products_dtype(cfg: InnerAttentionConfig) -> torch.dtype:
    """The products dtype of the kernels of a layer of `cfg`, on either
    device: float32 for backend 'xla', whose XLA formulation rounds no
    product (the JAX package's rrt.py:150,366), else cfg.mm_dtype."""
    return torch.float32 if cfg.backend == "xla" else _dtype(cfg.mm_dtype)


class RegionAttention(nn.Module):
    """R-MSA: square-grid partition -> per-region MHSA (or Nystrom
    attention, `region_attn='ntrans'`) -> merge (reference
    modules/rmsa.py:152-230).  `length` is the true bag length; the output
    has the input's length.  Under sequence sharding the input is this
    rank's slab of `grid // sp` whole grid rows (no collective: regions
    never cross a slab's edge)."""

    def __init__(self, cfg: RMSAConfig):
        super().__init__()
        if cfg.region_attn not in ("native", "ntrans"):
            raise ValueError(f"region_attn={cfg.region_attn!r} is not one of "
                             f"'native', 'ntrans'")
        self.cfg = cfg
        # 'ntrans': Nystrom attention inside each region (rrt.py:314-316),
        # torch ops on either device as the JAX package's XLA
        self.attn = (NystromAttention(cfg.nystrom)
                     if cfg.region_attn == "ntrans"
                     else InnerAttention(cfg.attn))

    def forward(self, x, length: Optional[int] = None,
                generator: Optional[torch.Generator] = None):
        b, n_in, c = x.shape
        length = n_in if length is None else length
        geom = grid_geometry(length, self.cfg.region)
        rs = geom.region_size
        sp = self.cfg.region.sp_shards
        rows = _slab_rows(geom, sp) if sp > 1 else geom.grid
        x = _fit_length(x, rows * geom.grid).reshape(b, rows, geom.grid, c)
        regions = self.attn(region_partition(x, rs), generator)
        out = region_reverse(regions, rs, rows, geom.grid)
        return _fit_length(out, n_in)


class CrossRegionAttention(nn.Module):
    """CR-MSA: compress each region to crmsa_k representative tokens, one
    MHSA across regions, redistribute (reference modules/rmsa.py:232-337).
    `forward` is the module formulation, K12 -> InnerAttention -> K13
    (rrt.py:366-390), for every backend; backend 'xla' on the CPU runs it
    with float32 products, which is the XLA einsums of rrt.py:392-440.
    `fused` is the JAX package's `_CRMSAFusedAttn` (rrt.py:531-572) on the
    same parameters.

    With `crmsa_mlp` the phi logits come from phi_fc1 (C -> C/4, no bias)
    -> tanh -> phi_fc2 (C/4 -> k, no bias), and the layer always takes the
    JAX package's XLA route (rrt.py:392-440, never fused there): the dual
    softmax, the min-max and the compress / redistribute einsums run as
    torch ops in float32 (flax's Dense and einsum promote a bf16 stream
    against float32 weights to float32), around the cross-region
    InnerAttention (K5 on the card).

    Under sequence sharding (`sp_group`) the input is this rank's slab: it
    compresses its own regions, and the cross-region attention runs on the
    representatives of every rank's regions (`_cross_region`); K12 and K13
    run with float32 products."""

    def __init__(self, cfg: CRMSAConfig,
                 sp_group: Optional[ShardGroup] = None):
        super().__init__()
        _check_group(cfg.region.sp_shards, sp_group)
        self.cfg = cfg
        self.sp_group = sp_group
        c, kk = cfg.attn.dim, cfg.crmsa_k
        if cfg.crmsa_mlp:
            self.phi = None
            self.phi_fc1 = nn.Linear(c, c // 4, bias=False)
            self.phi_fc2 = nn.Linear(c // 4, kk, bias=False)
        else:
            self.phi = nn.Parameter(torch.zeros(c, kk))
        self.attn = InnerAttention(cfg.attn)

    def _cross_region(self, reps, generator):
        """The cross-region InnerAttention on (B, k, nR, C) representatives
        of this rank's regions -> (B, k, nR, C).  Sharded, the group's
        representatives are gathered along the region axis (the attention
        runs replicated on every rank, rrt.py:413-428) and this rank's
        regions' slice is kept."""
        b, kk, nr, c = reps.shape
        sg = self.sp_group
        if sg is not None and sg.size > 1:
            full = all_gather(reps, 2, sg)
            out = self.attn(full.reshape(b * kk, nr * sg.size, c), generator)
            return out.reshape(b, kk, nr * sg.size, c).narrow(
                2, sg.index * nr, nr)
        # a view when B = 1, and K5 reads its input in place
        return self.attn(reps.reshape(b * kk, nr, c),
                         generator).reshape(b, kk, nr, c)

    def _forward_mlp(self, regions, generator):
        """The XLA route on (B, nR, P, C) regions -> (B * nR, P, C) float32."""
        b, nr, p, c = regions.shape
        regions = regions.float()
        t = torch.tanh(F.linear(regions, self.phi_fc1.weight))
        logits = F.linear(t, self.phi_fc2.weight).transpose(-1, -2)
        combine = torch.softmax(logits, dim=-1)         # over tokens
        dispatch = torch.softmax(logits, dim=-2)        # over k
        lmin = logits.amin(dim=-1, keepdim=True)
        lmax = logits.amax(dim=-1, keepdim=True)
        dispatch_mm = (logits - lmin) / (lmax - lmin + 1e-8)
        reps = torch.einsum("brpc,brkp->bkrc", regions, combine)
        reps = self._cross_region(reps, generator)
        out = torch.einsum("bkrc,brkp->brpc", reps.float(),
                           dispatch_mm * dispatch)
        return out.reshape(b * nr, p, c)

    def forward(self, x, length: Optional[int] = None,
                generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        b, n_in, c = x.shape
        length = n_in if length is None else length
        geom = grid_geometry(length, cfg.region)
        rs, kk = geom.region_size, cfg.crmsa_k
        sp = cfg.region.sp_shards
        rows = _slab_rows(geom, sp) if sp > 1 else geom.grid
        nr = geom.num_regions // sp
        x = _fit_length(x, rows * geom.grid).reshape(b, rows, geom.grid, c)
        if cfg.crmsa_mlp:
            regions = region_partition(x, rs).reshape(b, nr, -1, c)
            out = self._forward_mlp(regions, generator)
            return _fit_length(region_reverse(out, rs, rows, geom.grid), n_in)
        # the XLA einsums (rrt.py:392-440) round nothing: K12/K13 at float32
        # products are that formulation, as is the sharded path's
        mmd = torch.float32 if sp > 1 else products_dtype(cfg.attn)
        reps, w = crmsa_compress(region_partition(x, rs), self.phi, mmd)
        # (B*nR, k, C) -> (B, k, nR, C) and back
        reps = self._cross_region(reps.reshape(b, nr, kk, c).transpose(1, 2),
                                  generator).transpose(1, 2)
        out = crmsa_redistribute(w, reps.reshape(b * nr, kk, c).float()
                                 .contiguous(), mmd)
        out = region_reverse(out, rs, rows, geom.grid)
        return _fit_length(out, n_in)

    def fused(self, x, mask, ln_s, ln_b, length: int, add_residual: bool,
              final_ln=None, final_shortcut=None, generator=None):
        """K3 -> cross-region InnerAttention (K5) -> K8 with the layer
        residual, the global shortcut and the encoder-final LayerNorm + mask
        (the fp32 encoder output), or, without final_ln, -> K10: the
        post-layer stream in x's dtype, with or without the residual."""
        cfg = self.cfg
        b, _, c = x.shape
        geom = grid_geometry(length, cfg.region)
        kk, nr = cfg.crmsa_k, geom.num_regions
        mmd = _dtype(cfg.attn.mm_dtype)
        reps, w = crmsa_compress_grid(x, mask, ln_s, ln_b, self.phi, geom.grid,
                                      geom.region_size, mmd)
        # a view when B = 1, read in place by K5
        reps = self.attn(reps.transpose(1, 2).reshape(b * kk, nr, c),
                         generator)
        reps = reps.reshape(b, kk, nr, c).transpose(1, 2).float().contiguous()
        if final_ln is not None:
            return crmsa_redistribute_grid_ln(x, mask, w, reps, final_ln[0],
                                              final_ln[1], final_shortcut,
                                              geom.grid, geom.region_size, mmd)
        return crmsa_redistribute_grid(x, mask, w, reps, geom.grid,
                                       geom.region_size, add_residual, mmd)


def _fused_backend(attn_cfg: InnerAttentionConfig) -> bool:
    return attn_cfg.backend in ("auto", "pallas")


def fused_layer_ok(cfg: TransLayerConfig, x, mask, length: int) -> bool:
    """Counterpart of TransLayer._fused_layer_ok (rrt.py:603-628): True when
    the R-MSA layer runs as one K1 call (never with Nystrom regions)."""
    if cfg.attn_mode != "rmsa" or mask is None:
        return False
    if cfg.rmsa.region_attn == "ntrans" or cfg.rmsa.region.sp_shards != 1:
        return False
    a = cfg.rmsa.attn
    ep = a.epeg
    if ep.enabled and (ep.kind != "attn" or ep.two_d):
        return False
    if a.attn_dropout != 0.0 or not _fused_backend(a):
        return False
    return x.shape[1] == grid_geometry(length, cfg.rmsa.region).padded_length


def branch_outside(cfg: TransLayerConfig, training: bool) -> bool:
    """The `outside` rule of the fused R-MSA branch (rrt.py:644-645): in
    train mode with projection dropout or stochastic depth, K1 returns the
    masked branch without the residual (add_residual=False), and dropout,
    drop_path and the residual run outside it."""
    return training and (cfg.rmsa.attn.proj_dropout > 0 or cfg.drop_path > 0)


def crmsa_branch_outside(cfg: TransLayerConfig, training: bool) -> bool:
    """The `outside` rule of the fused CR-MSA branch (rrt.py:668): with
    stochastic depth in train mode, K10 returns the branch without the
    residual, and drop_path, the residual and any final LayerNorm run
    outside."""
    return training and cfg.drop_path > 0


def fused_crmsa_ok(cfg: TransLayerConfig, x, mask, length: int) -> bool:
    """Counterpart of fused_crmsa_ok (rrt.py:491-513): True when the CR-MSA
    layer runs as K3 -> K5 -> K8 (never on a slab, rrt.py:499)."""
    if cfg.attn_mode != "crmsa" or mask is None or cfg.crmsa.crmsa_mlp:
        return False
    if cfg.crmsa.region.sp_shards != 1:
        return False
    if not _fused_backend(cfg.crmsa.attn):
        return False
    return x.shape[1] == grid_geometry(length, cfg.crmsa.region).padded_length


def _apply_final_ln(x, mask, scale, bias):
    """Encoder-final LayerNorm + mask on explicit params (rrt.py:516-528)."""
    z = ln_fast(x.float(), scale, bias)
    return z if mask is None else z * mask[..., None].float()


class TransLayer(nn.Module):
    """Pre-LN block x + DropPath(attn(LN(x))), then the optional FFN
    x + DropPath(mask * Mlp(LN2(x))); the mask is applied after the
    LayerNorm and after the branch so pad rows enter attention as zeros and
    the stream stays zero on them (reference modules/rrt.py:43-131, JAX
    rrt.py:682-754)."""

    def __init__(self, cfg: TransLayerConfig,
                 sp_group: Optional[ShardGroup] = None):
        super().__init__()
        self.cfg = cfg
        self.norm = LayerNorm(cfg.dim)
        if cfg.attn_mode == "rmsa":
            self.attn = RegionAttention(cfg.rmsa)
        elif cfg.attn_mode == "crmsa":
            self.attn = CrossRegionAttention(cfg.crmsa, sp_group)
        elif cfg.attn_mode == "ntrans":
            # Nystrom attention over the whole stream (rrt.py:732-734)
            self.attn = NystromAttention(cfg.nystrom)
        else:
            raise ValueError(f"attn_mode={cfg.attn_mode!r} is not one of "
                             f"'rmsa', 'crmsa', 'ntrans'")
        if cfg.ffn:
            self.norm2 = LayerNorm(cfg.dim)
            self.mlp = Mlp(cfg.dim, int(cfg.dim * cfg.mlp_ratio), cfg.ffn_act,
                           cfg.dropout)

    def _compute_dtype(self) -> torch.dtype:
        cfg = self.cfg
        if cfg.attn_mode == "ntrans":
            return torch.float32
        a = cfg.rmsa.attn if cfg.attn_mode == "rmsa" else cfg.crmsa.attn
        return _dtype(a.compute_dtype)

    def _fused_rmsa_branch(self, x, mask, length: int, generator):
        cfg = self.cfg
        a = cfg.rmsa.attn
        geom = grid_geometry(length, cfg.rmsa.region)
        outside = branch_outside(cfg, self.training)
        out = region_layer_fused(
            x, mask, self.norm.weight, self.norm.bias,
            *self.attn.attn.kernel_weights(), geom.grid, geom.region_size,
            not outside, _dtype(a.mm_dtype))
        if not outside:
            return out
        z = dropout(out, a.proj_dropout, generator, True)
        return x + drop_path(z, cfg.drop_path, generator, True)

    def _fused_crmsa_branch(self, x, mask, length: int, final_ln,
                            final_shortcut, generator):
        cfg = self.cfg
        outside = crmsa_branch_outside(cfg, self.training)
        out = self.attn.fused(x, mask, self.norm.weight, self.norm.bias,
                              length, not outside,
                              None if outside else final_ln,
                              None if outside else final_shortcut, generator)
        if not outside:
            return out
        out = x + drop_path(out, cfg.drop_path, generator, True)
        if final_ln is not None:
            if final_shortcut is not None:
                out = out + final_shortcut
            out = _apply_final_ln(out, mask, *final_ln)
        return out

    def _ffn(self, x, m, generator):
        z = self.mlp(self.norm2(x), generator)
        if m is not None:
            z = z * m
        return x + drop_path(z, self.cfg.drop_path, generator, self.training)

    def forward(self, x, mask=None, length: Optional[int] = None,
                final_ln=None, final_shortcut=None,
                generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        m = None if mask is None else mask[..., None].to(x.dtype)
        length_r = x.shape[1] if length is None else length
        fused_rmsa = fused_layer_ok(cfg, x, mask, length_r)
        fused_crmsa = (not fused_rmsa
                       and fused_crmsa_ok(cfg, x, mask, length_r))
        if fused_rmsa or fused_crmsa:
            # final_ln rides K8 only when no FFN follows the layer
            ln_inside = fused_crmsa and not cfg.ffn and final_ln is not None
            if fused_rmsa:
                x = self._fused_rmsa_branch(x, mask, length_r, generator)
            else:
                x = self._fused_crmsa_branch(
                    x, mask, length_r, final_ln if ln_inside else None,
                    final_shortcut if ln_inside else None, generator)
            if cfg.ffn:
                x = self._ffn(x, m, generator)
            if final_ln is not None and not ln_inside:
                if final_shortcut is not None:
                    x = x + final_shortcut
                x = _apply_final_ln(x, mask, *final_ln)
            return x
        z = self.norm(x).to(self._compute_dtype())
        if m is not None:
            z = z * m
        if cfg.attn_mode == "ntrans":
            z = self.attn(z, generator)
        else:
            z = self.attn(z, length=length, generator=generator)
        if m is not None:
            z = z * m
        x = x + drop_path(z, cfg.drop_path, generator, self.training)
        if cfg.ffn:
            x = self._ffn(x, m, generator)
        if final_ln is not None:
            if final_shortcut is not None:
                x = x + final_shortcut
            x = _apply_final_ln(x, mask, *final_ln)
        return x


class RRTEncoder(nn.Module):
    """(n_layers-1) R-MSA (or Nystrom, `attn_mode='ntrans'`) TransLayers ->
    1 CR-MSA TransLayer -> optional global shortcut -> LayerNorm (reference
    modules/rrt.py:133-202), with the optional position embedding
    (`pos_embedding`, models/posemb.py) before layer 0 at `pos_pos = -1`
    and before layer 1 at `pos_pos = 0` (rrt.py:776-786), the rows masked
    after it.  Where it applies nowhere (`pos_pos = 0` with n_layers = 2,
    the default depth) the module is not built, as flax makes no params
    for a module never called.  Under sequence sharding (`sp_group`) it takes
    this rank's slab of the bag."""

    def __init__(self, cfg: RRTEncoderConfig,
                 sp_group: Optional[ShardGroup] = None):
        super().__init__()
        if cfg.attn_mode not in ("rmsa", "ntrans"):
            raise ValueError(f"attn_mode={cfg.attn_mode!r} is not one of "
                             f"'rmsa', 'ntrans'")
        self.cfg = cfg
        self.n_rmsa = cfg.n_layers - 1
        p = cfg.pos
        applies = p.pos_pos == -1 or (p.pos_pos == 0 and self.n_rmsa > 1)
        self.pos_embedding = build_pos_embedding(
            p.kind, cfg.dim, p.k, p.bias, p.conv_1d) if applies else None
        if cfg.sp_shards > 1 and (self.pos_embedding is not None or
                                  cfg.attn_mode == "ntrans"):
            raise ValueError(f"sp_shards={cfg.sp_shards}: the position "
                             f"embedding and attn_mode 'ntrans' read across "
                             f"the slabs' edges; they run unsharded only")
        _check_group(cfg.sp_shards, sp_group)
        for i in range(self.n_rmsa):
            self.add_module(f"layer{i}", TransLayer(cfg.rmsa_layer()))
        self.cr_msa = (TransLayer(cfg.crmsa_layer(), sp_group)
                       if cfg.cr_msa else None)
        self.norm = LayerNorm(cfg.dim)

    def _pos(self, x, mask, length: int):
        x = self.pos_embedding(x, length=length)
        return x if mask is None else x * mask[..., None].to(x.dtype)

    def forward(self, x, mask=None, length: Optional[int] = None,
                generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        squeeze = x.dim() == 2
        if squeeze:
            x = x[None]
        length = x.shape[1] if length is None else length
        x_shortcut = x
        pos_pos = cfg.pos.pos_pos if self.pos_embedding is not None else None
        if pos_pos == -1:
            x = self._pos(x, mask, length)
        for i in range(self.n_rmsa):
            if i == 1 and pos_pos == 0:
                x = self._pos(x, mask, length)
            x = getattr(self, f"layer{i}")(x, mask=mask, length=length,
                                           generator=generator)
        if self.cr_msa is not None:
            final_ln = (self.norm.weight, self.norm.bias)
            cl = self.cr_msa.cfg
            # the final LayerNorm rides K8's stream write when nothing (FFN,
            # train-mode drop_path) separates it from the layer (rrt.py:797-809)
            if (not cl.ffn and not (self.training and cl.drop_path > 0)
                    and fused_crmsa_ok(cl, x, mask, length)):
                x = self.cr_msa(x, mask=mask, length=length, final_ln=final_ln,
                                final_shortcut=(x_shortcut if cfg.all_shortcut
                                                else None),
                                generator=generator)
                return x[0] if squeeze else x
            x = self.cr_msa(x, mask=mask, length=length, generator=generator)
        if cfg.all_shortcut:
            x = x + x_shortcut
        x = _apply_final_ln(x, mask, self.norm.weight, self.norm.bias)
        return x[0] if squeeze else x


class RRTMIL(nn.Module):
    """Linear(input_dim -> 512) + act -> RRTEncoder -> attention pooling ->
    classifier (reference modules/rrt.py:204-246).  With
    `cfg.encoder.sp_shards > 1` it runs on this rank's slab of each bag,
    `sp_group` its sp group, and returns the whole bag's logits on every
    rank; `length` (the bag's bucket length) is then required."""

    def __init__(self, cfg: RRTMILConfig,
                 sp_group: Optional[ShardGroup] = None):
        super().__init__()
        self.cfg = cfg
        self.patch_to_emb = nn.Linear(cfg.input_dim, 512)
        self.online_encoder = RRTEncoder(cfg.encoder, sp_group)
        p = cfg.pool
        # any kind but 'attn' is the masked mean, as in JAX (rrt.py:867-879)
        self.pool_fn = (DAttention(cfg.encoder.dim, p.act, p.gated, p.bias,
                                   p.dropout, sp_group)
                        if p.kind == "attn" else MeanPool(sp_group))
        self.predictor = nn.Linear(cfg.encoder.dim, cfg.n_classes)

    def forward(self, x, mask=None, length: Optional[int] = None,
                generator: Optional[torch.Generator] = None):
        """`generator` draws the dropout masks in train mode."""
        cfg = self.cfg
        if x.dim() == 2:
            x = x[None]
        if length is None and cfg.encoder.sp_shards > 1:
            raise ValueError("a sequence-sharded RRTMIL takes the bag's "
                             "length: its input is one rank's slab")
        length = x.shape[1] if length is None else length
        cdt = _dtype(cfg.encoder.compute_dtype)
        w = self.patch_to_emb
        x = F.linear(x.to(cdt), w.weight.to(cdt), w.bias.to(cdt))
        if cfg.act == "relu":
            x = F.relu(x)
        elif cfg.act == "gelu":
            x = F.gelu(x, approximate="none")
        x = dropout(x, cfg.dropout, generator, self.training)
        if mask is not None:
            # bucket-pad rows enter the encoder as exact zeros (rrt.py:857-861)
            x = x * mask[..., None].to(x.dtype)
        x = self.online_encoder(x, mask=mask, length=length,
                                generator=generator).float()
        feat = self.pool_fn(x, mask=mask, generator=generator)
        return self.predictor(feat)


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Fresh init with the JAX package's distributions (utils/inits.py):
    xavier_normal kernels with flax's fans, zero biases, LayerNorm ones and
    zeros, EPEG taps with the fans of flax's (kh, kw, 1, C) kernel,
    U(+-1/sqrt(k)) for phi, and a module's `init_own_parameters(generator)`
    for its raw parameters; drawn in module order."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                xavier_normal_(mod.weight, mod.in_features, mod.out_features,
                               generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, InnerAttention) and mod.pe_weight is not None:
                # flax's fans of the (kh, kw, 1, C) kernel
                ch, taps = mod.pe_weight.shape[0], mod.pe_weight[0].numel()
                xavier_normal_(mod.pe_weight, taps, ch * taps, generator)
                if mod.pe_bias is not None:
                    mod.pe_bias.zero_()
            elif isinstance(mod, CrossRegionAttention) and mod.phi is not None:
                crmsa_phi_init_(mod.phi, mod.cfg.crmsa_k, generator)
            elif hasattr(mod, "init_own_parameters"):
                # a module's own raw parameters (DSMIL's Conv1d head)
                mod.init_own_parameters(generator)


def build_model(cfg: RRTMILConfig, device="cuda", seed: int = 0,
                sp_group: Optional[ShardGroup] = None) -> RRTMIL:
    """An RRTMIL in eval mode with seeded weights, on `device` (the card by
    default; raises when there is none unless device='cpu'); `.train()`
    switches dropout on.  A sequence-sharded config (`sp_group`) draws the
    same weights as its unsharded twin: the modules are the same."""
    dev = resolve_device(device)
    model = RRTMIL(cfg, sp_group)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
