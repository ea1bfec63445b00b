"""Square-grid region geometry, partition and reverse (PyTorch).

Counterpart of `rrtmil_tpu/ops/regions.py:58-119`, with the same reference
semantics (modules/rmsa.py:175-202 `RegionAttntion.padding`):

    H = W = ceil(sqrt(L));  H += (-H) % region_num          # grid side
    region_size = H // region_num
    pad bag with ZEROS to H*W tokens; the zero tokens ATTEND (they are not
    masked) and are sliced off after the attention (rmsa.py:227-228).

Geometry is plain Python on the static bag length; partition and reverse are
views/permutes of tensors.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..config import RegionConfig


@dataclasses.dataclass(frozen=True)
class RegionGeometry:
    """Resolved grid geometry for a bag of true length `length`."""

    length: int        # true token count L
    grid: int          # H == W, the square grid side
    region_size: int   # tokens per region side
    region_num: int    # regions per grid side (grid // region_size)

    @property
    def padded_length(self) -> int:
        return self.grid * self.grid

    @property
    def pad(self) -> int:
        return self.padded_length - self.length

    @property
    def tokens_per_region(self) -> int:
        return self.region_size * self.region_size

    @property
    def num_regions(self) -> int:
        return self.region_num * self.region_num


def grid_geometry(length: int, cfg: RegionConfig) -> RegionGeometry:
    """Reference rmsa.py:175-198 `padding`, shapes only, including the
    `min_region_num` / `min_region_ratio` fallback to one global region
    (rmsa.py:193-198); with the default 0/0 config the fallback never
    triggers because the threshold is L/1e-8."""
    side = int(math.ceil(math.sqrt(length)))
    if cfg.region_size > 0:
        side += (-side) % cfg.region_size
        region_size = cfg.region_size
        region_num = side // region_size
    else:
        side += (-side) % cfg.region_num
        region_num = cfg.region_num
        region_size = side // region_num

    pad = side * side - length
    if pad > length / (cfg.min_region_ratio + 1e-8) or length < cfg.min_region_num:
        side = int(math.ceil(math.sqrt(length)))
        side += (-side) % 2
        region_size = side
        region_num = 1
    return RegionGeometry(length=length, grid=side,
                          region_size=region_size, region_num=region_num)


def pad_to_grid(x: torch.Tensor, geom: RegionGeometry) -> torch.Tensor:
    """Zero-pad (B, L, C) to (B, H*W, C) (rmsa.py:199-200)."""
    if geom.pad == 0:
        return x
    return F.pad(x, (0, 0, 0, geom.pad))


def region_partition(x: torch.Tensor, region_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (num_regions*B, region_size**2, C): row-major over the
    (H/rs, W/rs) region grid, batch-major overall (rmsa.py:28-39)."""
    b, h, w, c = x.shape
    rs = region_size
    x = x.reshape(b, h // rs, rs, w // rs, rs, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, rs * rs, c)


def region_reverse(regions: torch.Tensor, region_size: int, h: int,
                   w: int) -> torch.Tensor:
    """(num_regions*B, region_size**2, C) -> (B, H*W, C) (rmsa.py:41-54)."""
    rs = region_size
    c = regions.shape[-1]
    b = regions.shape[0] * rs * rs // (h * w)
    x = regions.reshape(b, h // rs, w // rs, rs, rs, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * w, c)
