"""Model factory by the reference's CLI names.

Counterpart of `rrtmil_tpu/models/zoo.py:26-88` (reference
main.py:138-222): `build_model(name, ...)` for the models the port has,
RRT-MIL and the Mean / Max MIL baselines, with seeded weights drawn from
the JAX package's distributions (`models/rrt.init_parameters`).  Every other
name of the JAX package's registry raises.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import PoolConfig, RRTEncoderConfig, RRTMILConfig
from ..utils.device import resolve_device
from . import rrt
from .mean_max import MaxMIL, MeanMIL

_PORTED = {"rrtmil": None, "meanmil": MeanMIL, "maxmil": MaxMIL}
# the JAX package's other names: the zoo is a later slice
_NOT_PORTED = ("attmil", "gattmil", "clam_sb", "clam_mb", "dsmil",
               "transmil", "ibmil", "dtfd", "mhim")
ZOO_ITEM = "ROADMAP.md queue 1 item 8"


def model_names():
    return sorted(_PORTED)


def build_model(name: str, input_dim: int = 1024, n_classes: int = 2,
                dropout: float = 0.25, act: str = "relu",
                rrt_cfg: Optional[RRTEncoderConfig] = None,
                rrtmil_cfg: Optional[RRTMILConfig] = None,
                device="cuda", seed: int = 0) -> nn.Module:
    """A zoo model in eval mode with weights seeded by `seed`, on `device`
    (the card by default; raises when there is none unless device='cpu')."""
    name = name.lower()
    if name in _NOT_PORTED:
        raise ValueError(f"model {name!r} is not ported yet: the zoo is "
                         f"{ZOO_ITEM}")
    if name not in _PORTED:
        raise ValueError(f"unknown model {name!r}; choose from "
                         f"{model_names()}")
    if name == "rrtmil":
        cfg = rrtmil_cfg or RRTMILConfig(
            input_dim=input_dim, n_classes=n_classes, act=act,
            dropout=dropout, encoder=rrt_cfg or RRTEncoderConfig(),
            pool=PoolConfig())
        return rrt.build_model(cfg, device=device, seed=seed)
    dev = resolve_device(device)
    model = _PORTED[name](input_dim=input_dim, n_classes=n_classes, act=act,
                          dropout=dropout, rrt=rrt_cfg)
    rrt.init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
