"""Carry weights between the JAX package's flax param tree and the port.

`flax_to_torch(params)` takes the nested dict that `model.init(...)
["params"]` gives (leaves are arrays) and returns a state_dict for the
port's module of the same name (models/rrt.py): the flax path joined by '.',
with torch's layouts:

  * Dense `kernel` (in, out)      <-> Linear `weight` (out, in)
  * LayerNorm `scale` / `bias`    <-> `weight` / `bias`
  * EPEG `pe_kernel` (k, 1, 1, H) <-> `pe_weight` (H, k), the kernels'
    layout (w = kernel[:, 0, 0, :].T)
  * a depthwise conv kernel `kernel` / `*_kernel` (kh, kw, 1, C) <->
    `weight` / `*_weight` (C, 1, kh, kw), torch's Conv2d layout: Nystrom's
    `res_conv_kernel`, the PPEGs' `proj*_kernel`, PEG's `kernel`
  * `phi` (C, k), `pe_bias` (H,), Dense and conv `bias`, `cls_token`,
    `absolute_pos_embed` and other leaves (DSMIL's `fcc_kernel`, rank 3)
    are unchanged.

The qkv column order (C, 3, H, hd) is the same on both sides (rrt.py:642),
so the Linear weight's rows are (3, H, hd).  `torch_to_flax` inverts it
exactly.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix):
        for key, val in tree.items():
            if hasattr(val, "items"):
                walk(val, prefix + [key])
                continue
            a = np.asarray(val)
            if key == "pe_kernel":
                if a.ndim != 4 or a.shape[1:3] != (1, 1):
                    raise ValueError(f"{'/'.join(prefix)}: pe_kernel "
                                     f"{a.shape} is not a (k, 1, 1, H) tap set")
                name, a = "pe_weight", a[:, 0, 0, :].T
            elif key == "kernel" and a.ndim == 2:
                name, a = "weight", a.T
            elif key == "kernel" or (key.endswith("_kernel") and a.ndim == 4):
                if a.ndim != 4 or a.shape[2] != 1:
                    raise ValueError(f"{'/'.join(prefix + [key])}: {a.shape} "
                                     f"is not a Dense or depthwise conv "
                                     f"kernel")
                name, a = key[:-len("kernel")] + "weight", \
                    a.transpose(3, 2, 0, 1)
            elif key == "scale":
                name = "weight"
            else:
                name = key
            out[".".join(prefix + [name])] = torch.from_numpy(np.array(a))

    walk(params, [])
    return out


def torch_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for dotted, t in state_dict.items():
        *path, name = dotted.split(".")
        a = t.detach().cpu().numpy()
        if name == "pe_weight":
            name, a = "pe_kernel", a.T[:, None, None, :]
        elif name.endswith("weight") and a.ndim == 4:
            name, a = name[:-len("weight")] + "kernel", a.transpose(2, 3, 1, 0)
        elif name == "weight":
            name, a = ("kernel", a.T) if a.ndim == 2 else ("scale", a)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(a)
    return tree
