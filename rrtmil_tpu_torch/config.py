"""Typed configuration tree for the PyTorch/CUDA RRT-MIL port.

A copy of `rrtmil_tpu/config.py` (same dataclasses, same defaults, same
canonical configs) so that the port never imports the JAX package.

The reference (DearCaat/RRT-MIL) threads ~70 flat argparse kwargs through four
levels of constructors (reference main.py:654-695 -> modules/rrt.py:134,44 ->
modules/rmsa.py:57).  Here the same leaves live in a frozen dataclass tree so
that configs are hashable and
self-documenting.

Defaults mirror the reference's *effective* defaults, including the inverted
`store_false` booleans of reference main.py:635,667,683-684 (epeg, cr_msa,
qkv_bias, epeg_bias all default ON).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RegionConfig:
    """Square-grid region partition knobs (reference modules/rmsa.py:152-202)."""

    region_num: int = 8       # grid side is padded up to a multiple of this
    region_size: int = 0      # >0: fixed region side, region_num derived instead
    min_region_num: int = 0   # fall back to near-global attention below this L
    min_region_ratio: float = 0.0  # fall back when pad > L/(ratio+1e-8)
    # Sequence parallelism (parallel/seqshard.py): when sp_shards > 1 the
    # module runs inside shard_map on a contiguous slab of grid rows; the
    # CR-MSA all-gathers its compressed tokens over `sp_axis`.
    sp_shards: int = 1
    sp_axis: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class EPEGConfig:
    """EPEG conv-on-logits position encoding (reference modules/rmsa.py:72-87)."""

    enabled: bool = True
    k: int = 15
    two_d: bool = False       # 2-D (k,k) conv ablation instead of (k,1)
    bias: bool = True
    kind: str = "attn"        # 'attn' | 'value_bf' | 'value_af'


@dataclasses.dataclass(frozen=True)
class InnerAttentionConfig:
    """Per-region MHSA (reference modules/rmsa.py:56-137)."""

    dim: int = 512
    num_heads: int = 8
    head_dim: Optional[int] = None      # None -> dim // num_heads
    qkv_bias: bool = True
    qk_scale: Optional[float] = None    # None -> head_dim ** -0.5
    attn_dropout: float = 0.0
    proj_dropout: float = 0.0
    epeg: EPEGConfig = EPEGConfig(enabled=False)
    compute_dtype: str = "float32"
    backend: str = "auto"               # 'auto' | 'pallas': the fused
    # structure (hand-written CUDA kernels on a CUDA tensor, their plain
    # PyTorch versions on a CPU tensor); 'xla': the unfused module structure
    # (on a CUDA tensor its inner attention still runs the K5 kernel, and
    # the CR-MSA K12 / K13, with float32 products whatever mm_dtype says:
    # the XLA formulation rounds no product).
    epeg_fold: bool = False             # fold the (k,1) EPEG conv into q
    # before the fused kernel (exact: the query-axis conv commutes with the
    # key matmul, ops/epeg.epeg_fold_q) so the kernel runs its plain
    # attention path; only affects the fused backend.  Default OFF: the
    # fold's 15-tap fp32 pass over q costs ~6 ms/step at the flagship
    # batch-8 shape on v5e, vs ~0.1 ms for the in-kernel VMEM shift-and-add
    # (round-3 profile, tools/profile_fwd.py).  Env override RRTMIL_EPEG_FOLD
    # =1/0 wins either way — read at TRACE time (like RRTMIL_PALLAS_RB /
    # RRTMIL_PALLAS_INTERPRET), so it must be set before the first
    # jit-compile of the apply fn to take effect.
    mm_dtype: str = "bfloat16"          # product input dtype of the fused
    # kernels (accumulation is always fp32); 'float32' for parity runs.

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.dim // self.num_heads

    @property
    def scale(self) -> float:
        return self.qk_scale if self.qk_scale is not None else self.resolved_head_dim ** -0.5


@dataclasses.dataclass(frozen=True)
class NystromConfig:
    """Nystrom-approximated attention (reference modules/nystrom_attention.py:32-66)."""

    dim: int = 512
    head_dim: int = 64
    num_heads: int = 8
    num_landmarks: int = 256
    pinv_iterations: int = 6
    residual: bool = True
    residual_conv_kernel: int = 33
    dropout: float = 0.0


@dataclasses.dataclass(frozen=True)
class RMSAConfig:
    """R-MSA: region partition + InnerAttention (reference modules/rmsa.py:152-230)."""

    attn: InnerAttentionConfig = InnerAttentionConfig()
    region: RegionConfig = RegionConfig()
    region_attn: str = "native"  # 'native' | 'ntrans' (Nystrom ablation)
    nystrom: NystromConfig = NystromConfig()


@dataclasses.dataclass(frozen=True)
class CRMSAConfig:
    """CR-MSA: cross-region attention (reference modules/rmsa.py:232-337)."""

    attn: InnerAttentionConfig = InnerAttentionConfig()
    region: RegionConfig = RegionConfig()
    crmsa_k: int = 3
    crmsa_mlp: bool = False


@dataclasses.dataclass(frozen=True)
class TransLayerConfig:
    """Pre-LN transformer block (reference modules/rrt.py:43-131)."""

    dim: int = 512
    attn_mode: str = "rmsa"   # 'rmsa' | 'crmsa' | 'ntrans'
    rmsa: RMSAConfig = RMSAConfig()
    crmsa: CRMSAConfig = CRMSAConfig()
    nystrom: NystromConfig = NystromConfig()
    drop_path: float = 0.0
    ffn: bool = False
    ffn_act: str = "gelu"
    mlp_ratio: float = 4.0
    dropout: float = 0.1      # ffn dropout (reference drop_out)


@dataclasses.dataclass(frozen=True)
class PosEmbedConfig:
    """Optional position-embedding ablations (reference modules/emb_position.py)."""

    kind: str = "none"        # 'none' | 'peg' | 'ppeg' | 'sincos' | 'ape'
    k: int = 7
    bias: bool = True
    conv_1d: bool = False
    pos_pos: int = 0          # -1: before layer 0; 0: between layers 0 and 1


@dataclasses.dataclass(frozen=True)
class RRTEncoderConfig:
    """The RRT re-embedding encoder (reference modules/rrt.py:133-202).

    Construction rules mirrored from the reference:
      - `n_layers - 1` R-MSA TransLayers, then one CR-MSA TransLayer.
      - EPEG applies to the R-MSA layers only; the CR-MSA TransLayer is built
        without passing `epeg`, so its InnerAttention has epeg disabled
        (reference modules/rrt.py:148 vs :144).
      - CR-MSA's InnerAttention uses `crmsa_heads` heads with
        head_dim = dim // crmsa_heads (reference modules/rrt.py:148,80).
    """

    dim: int = 512            # mlp_dim in the reference
    n_layers: int = 2
    n_heads: int = 8
    crmsa_heads: int = 8
    region_num: int = 8
    region_size: int = 0
    min_region_num: int = 0
    min_region_ratio: float = 0.0
    attn_mode: str = "rmsa"   # attention used in the first n_layers-1 layers
    region_attn: str = "native"  # R-MSA per-region attention: 'native'
    # (InnerAttention) | 'ntrans' (NystromAttention inside each region, the
    # reference's --region_attn ablation, main.py:184 -> rmsa.py:167-173)
    epeg: bool = True
    epeg_k: int = 15
    epeg_2d: bool = False
    epeg_bias: bool = True
    epeg_type: str = "attn"
    cr_msa: bool = True
    crmsa_k: int = 3
    crmsa_mlp: bool = False
    all_shortcut: bool = False
    qkv_bias: bool = True
    dropout: float = 0.1      # trans_dropout: proj dropout inside attention
    drop_path: float = 0.0
    ffn: bool = False
    ffn_act: str = "gelu"
    mlp_ratio: float = 4.0
    trans_dim: int = 64       # head_dim for the 'ntrans' ablation only
    pos: PosEmbedConfig = PosEmbedConfig()
    sp_shards: int = 1        # sequence-parallel shards (parallel/seqshard.py)
    sp_axis: Optional[str] = None
    compute_dtype: str = "float32"   # 'float32' | 'bfloat16': activation /
    # matmul dtype for the encoder stack (params stay fp32; LayerNorm and
    # softmax always compute in fp32).  bfloat16 halves the stream's bytes.
    backend: str = "auto"     # 'auto' | 'pallas' | 'xla': see
    # InnerAttentionConfig.backend.
    mm_dtype: str = "bfloat16"  # fused-kernel MXU input dtype (see
    # InnerAttentionConfig.mm_dtype); 'float32' for strict parity runs.

    def rmsa_layer(self) -> TransLayerConfig:
        region = RegionConfig(
            region_num=self.region_num, region_size=self.region_size,
            min_region_num=self.min_region_num, min_region_ratio=self.min_region_ratio,
            sp_shards=self.sp_shards, sp_axis=self.sp_axis)
        attn = InnerAttentionConfig(
            dim=self.dim, num_heads=self.n_heads, head_dim=self.dim // self.n_heads,
            qkv_bias=self.qkv_bias, proj_dropout=self.dropout,
            compute_dtype=self.compute_dtype, backend=self.backend,
            mm_dtype=self.mm_dtype,
            epeg=EPEGConfig(enabled=self.epeg, k=self.epeg_k, two_d=self.epeg_2d,
                            bias=self.epeg_bias, kind=self.epeg_type))
        nys = NystromConfig(dim=self.dim, head_dim=self.trans_dim,
                            num_heads=self.n_heads, dropout=self.dropout)
        return TransLayerConfig(
            dim=self.dim, attn_mode=self.attn_mode,
            rmsa=RMSAConfig(attn=attn, region=region, nystrom=nys,
                            region_attn=self.region_attn),
            nystrom=nys,
            drop_path=self.drop_path, ffn=self.ffn, ffn_act=self.ffn_act,
            mlp_ratio=self.mlp_ratio, dropout=self.dropout)

    def crmsa_layer(self) -> TransLayerConfig:
        # Reference rrt.py:148 builds the CR-MSA TransLayer WITHOUT epeg or
        # n_region kwargs -> TransLayer defaults: epeg=False, n_region=8.
        region = RegionConfig(region_num=8, region_size=0,
                              min_region_num=0, min_region_ratio=0.0,
                              sp_shards=self.sp_shards, sp_axis=self.sp_axis)
        attn = InnerAttentionConfig(
            dim=self.dim, num_heads=self.crmsa_heads,
            head_dim=self.dim // self.crmsa_heads,
            qkv_bias=self.qkv_bias, proj_dropout=self.dropout,
            compute_dtype=self.compute_dtype, backend=self.backend,
            mm_dtype=self.mm_dtype,
            epeg=EPEGConfig(enabled=False))
        return TransLayerConfig(
            dim=self.dim, attn_mode="crmsa",
            crmsa=CRMSAConfig(attn=attn, region=region,
                              crmsa_k=self.crmsa_k, crmsa_mlp=self.crmsa_mlp),
            drop_path=self.drop_path, ffn=self.ffn, ffn_act=self.ffn_act,
            mlp_ratio=self.mlp_ratio, dropout=self.dropout)


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    """MIL aggregation head (reference modules/datten.py)."""

    kind: str = "attn"        # 'attn' | 'avg' | 'max'
    act: str = "relu"         # da_act: 'relu' | 'gelu' | 'tanh'
    gated: bool = False
    bias: bool = False
    dropout: bool = False


@dataclasses.dataclass(frozen=True)
class RRTMILConfig:
    """Full RRT-MIL model (reference modules/rrt.py:204-246)."""

    input_dim: int = 1024
    n_classes: int = 2
    act: str = "relu"
    dropout: float = 0.25
    encoder: RRTEncoderConfig = RRTEncoderConfig()
    pool: PoolConfig = PoolConfig()


# ---------------------------------------------------------------------------
# Canonical configs (reference README.md:78-132, modules/rrt.py:252-258)
# ---------------------------------------------------------------------------

def c16_r50() -> RRTMILConfig:
    return RRTMILConfig(
        input_dim=1024,
        encoder=RRTEncoderConfig(epeg_k=15, crmsa_k=1, crmsa_heads=8, all_shortcut=True))


def c16_plip() -> RRTMILConfig:
    return RRTMILConfig(
        input_dim=512,
        encoder=RRTEncoderConfig(epeg_k=9, crmsa_k=3, crmsa_heads=8, all_shortcut=True))


def nsclc_r50() -> RRTMILConfig:
    return RRTMILConfig(
        input_dim=1024, encoder=RRTEncoderConfig(epeg_k=21, crmsa_k=5, crmsa_heads=8))


def nsclc_plip() -> RRTMILConfig:
    return RRTMILConfig(
        input_dim=512,
        encoder=RRTEncoderConfig(epeg_k=13, crmsa_k=3, crmsa_heads=1,
                                 all_shortcut=True, crmsa_mlp=True))


def brca_r50() -> RRTMILConfig:
    return RRTMILConfig(
        input_dim=1024, encoder=RRTEncoderConfig(epeg_k=17, crmsa_k=3, crmsa_heads=1))


def brca_plip() -> RRTMILConfig:
    return RRTMILConfig(
        input_dim=512,
        encoder=RRTEncoderConfig(epeg_k=15, crmsa_k=1, crmsa_heads=8, all_shortcut=True))


def survival_default(epeg_k: int = 15, crmsa_k: int = 3) -> RRTMILConfig:
    # Survival harness uses region_num=16 (reference Survival/main.py:125).
    return RRTMILConfig(
        input_dim=1024, n_classes=4,
        encoder=RRTEncoderConfig(region_num=16, epeg_k=epeg_k, crmsa_k=crmsa_k))


CANONICAL_CONFIGS = {
    "c16_r50": c16_r50,
    "c16_plip": c16_plip,
    "nsclc_r50": nsclc_r50,
    "nsclc_plip": nsclc_plip,
    "brca_r50": brca_r50,
    "brca_plip": brca_plip,
}
