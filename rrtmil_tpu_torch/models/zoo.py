"""Model factory by the reference's CLI names.

Counterpart of `rrtmil_tpu/models/zoo.py:22-91` (reference main.py:
138-222): `build_model(name, ...)` with seeded weights drawn from the JAX
package's distributions (`models/rrt.init_parameters`), `aux_mode(name)`
(how the engine reads a model's train forward) and the harness's forced
loss weights.  Every zoo model but TransMIL takes an optional injected
RRT encoder config (`rrt=`, the `--only_rrt_enc` path); IBMIL takes its
confounder prototypes (`confounders=`), TransMIL its cls token's init std
(`cls_token_std=`, 1e-6 in survival).  As in the JAX registry, DTFD and
MHIM are not zoo names: they train through engines of their own
(harness/dtfd_cls.py, harness/survival.py), and their harnesses build them
with `seeded`.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import PoolConfig, RRTEncoderConfig, RRTMILConfig
from ..utils.device import resolve_device
from . import rrt
from .abmil import ABMIL, GatedABMIL
from .clam import CLAM_MB, CLAM_SB
from .dsmil import DSMIL
from .ibmil import IBMIL
from .mean_max import MaxMIL, MeanMIL
from .transmil import TransMIL

# model name -> (class, aux_mode)
#   aux_mode: None     - the forward returns logits
#             'loss'   - with a label, (logits, aux loss, ps) (CLAM)
#             'logits' - (logits, aux logits, ps); the engine applies the
#                        criterion to the aux logits (DSMIL)
_REGISTRY = {
    "rrtmil": (None, None),
    "attmil": (ABMIL, None),
    "gattmil": (GatedABMIL, None),
    "clam_sb": (CLAM_SB, "loss"),
    "clam_mb": (CLAM_MB, "loss"),
    "dsmil": (DSMIL, "logits"),
    "transmil": (TransMIL, None),
    "meanmil": (MeanMIL, None),
    "maxmil": (MaxMIL, None),
    "ibmil": (IBMIL, None),
}

# loss weights forced by the reference harness (main.py:213-214,719-726)
LOSS_WEIGHT_OVERRIDES = {
    "clam_sb": (0.7, 0.3),
    "clam_mb": (0.7, 0.3),
    "dsmil": (0.5, 0.5),
}


def seeded(model: nn.Module, device="cuda", seed: int = 0) -> nn.Module:
    """`model` with fresh weights drawn from the JAX package's distributions
    (`rrt.init_parameters`, seeded by `seed`), in eval mode on `device`
    (the card by default; raises when there is none unless device='cpu')."""
    dev = resolve_device(device)
    rrt.init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def model_names():
    return sorted(_REGISTRY)


def aux_mode(name: str) -> Optional[str]:
    entry = _REGISTRY.get(name.lower())
    return entry[1] if entry else None


def build_model(name: str, input_dim: int = 1024, n_classes: int = 2,
                dropout: float = 0.25, act: str = "relu",
                rrt_cfg: Optional[RRTEncoderConfig] = None,
                rrtmil_cfg: Optional[RRTMILConfig] = None,
                subtyping: bool = False, confounders=None,
                cls_token_std: float = 1.0, device="cuda",
                seed: int = 0) -> nn.Module:
    """A zoo model in eval mode with weights seeded by `seed`, on `device`
    (the card by default; raises when there is none unless device='cpu').
    `subtyping` is CLAM's out-of-class instance loss; `confounders` IBMIL's
    (P, 512) prototypes; `cls_token_std` TransMIL's cls-token init.
    TransMIL takes no injected encoder (`rrt_cfg` is ignored, as in the
    JAX package)."""
    name = name.lower()
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; choose from "
                         f"{model_names()}")
    if name == "rrtmil":
        cfg = rrtmil_cfg or RRTMILConfig(
            input_dim=input_dim, n_classes=n_classes, act=act,
            dropout=dropout, encoder=rrt_cfg or RRTEncoderConfig(),
            pool=PoolConfig())
        return rrt.build_model(cfg, device=device, seed=seed)
    kwargs = {"rrt": rrt_cfg}
    if aux_mode(name) == "loss":
        kwargs["subtyping"] = subtyping
    elif name == "ibmil":
        kwargs["confounders"] = confounders
    elif name == "transmil":
        kwargs = {"cls_token_std": cls_token_std}
    return seeded(_REGISTRY[name][0](input_dim=input_dim,
                                     n_classes=n_classes, act=act,
                                     dropout=dropout, **kwargs),
                  device, seed)
