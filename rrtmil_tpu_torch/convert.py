"""Carry weights between the JAX package's flax param tree and the port.

`flax_to_torch(params)` takes the nested dict that `model.init(...)
["params"]` gives (leaves are arrays) and returns a state_dict for the
port's module of the same name (models/rrt.py): the flax path joined by '.',
with torch's layouts:

  * Dense `kernel` (in, out)      <-> Linear `weight` (out, in)
  * LayerNorm `scale` / `bias`    <-> `weight` / `bias`
  * EPEG `pe_kernel` (kh, kw, 1, C) <-> `pe_weight` (C, kh) when kw = 1,
    the kernels' layout (w = kernel[:, 0, 0, :].T), else (C, kh, kw): the
    1-D logit taps (k, 1, 1, H), the 2-D ones (k, k, 1, H) and the value
    convs' (k, 1 or k, 1, h * hd) (ops/epeg.py)
  * a depthwise conv kernel `kernel` / `*_kernel` (kh, kw, 1, C) <->
    `weight` / `*_weight` (C, 1, kh, kw), torch's Conv2d layout: Nystrom's
    `res_conv_kernel`, the PPEGs' `proj*_kernel`, PEG's `kernel`
  * `phi` (C, k), `pe_bias` (H,), Dense and conv `bias`, `cls_token`,
    `absolute_pos_embed` and other leaves (DSMIL's `fcc_kernel`, rank 3)
    are unchanged.

The qkv column order (C, 3, H, hd) is the same on both sides (rrt.py:642),
so the Linear weight's rows are (3, H, hd).  A bfloat16 leaf stays
bfloat16.  `torch_to_flax` inverts it exactly (a bfloat16 tensor comes back
as float32).

The stacked forms carry fold-parallel training's weights: the tree of the
JAX package's `parallel.folds.stack_states` (every leaf with a leading fold
axis) to the port's stacked parameters {name: (K, ...)}
(`parallel.folds.stack_states`), fold by fold, and back.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch


def _bfloat16_bits(val) -> Optional[np.ndarray]:
    """The uint16 bits of a bfloat16 leaf (a JAX or ml_dtypes array, or the
    bits train/flax_msgpack.py decodes), else None."""
    if getattr(val, "bfloat16_bits", False) or \
            getattr(getattr(val, "dtype", None), "name", "") == "bfloat16":
        return np.asarray(val).view(np.uint16)
    return None


def flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix):
        for key, val in tree.items():
            if hasattr(val, "items"):
                walk(val, prefix + [key])
                continue
            bits = _bfloat16_bits(val)
            a = np.asarray(val) if bits is None else bits
            if key == "pe_kernel":
                if a.ndim != 4 or a.shape[2] != 1:
                    raise ValueError(f"{'/'.join(prefix)}: pe_kernel "
                                     f"{a.shape} is not a (kh, kw, 1, C) tap "
                                     f"set")
                a = a[:, :, 0, :].transpose(2, 0, 1)
                name, a = "pe_weight", a[:, :, 0] if a.shape[2] == 1 else a
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
            t = torch.from_numpy(np.array(a))
            if bits is not None:
                t = t.view(torch.int16).view(torch.bfloat16)
            out[".".join(prefix + [name])] = t

    walk(params, [])
    return out


def torch_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for dotted, t in state_dict.items():
        *path, name = dotted.split(".")
        t = t.detach().cpu()
        a = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        if name == "pe_weight":
            a = a[:, :, None] if a.ndim == 2 else a
            name, a = "pe_kernel", a.transpose(1, 2, 0)[:, :, None, :]
        elif name.endswith("weight") and a.ndim == 4:
            name, a = name[:-len("weight")] + "kernel", a.transpose(2, 3, 1, 0)
        elif name == "weight":
            name, a = ("kernel", a.T) if a.ndim == 2 else ("scale", a)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(a)
    return tree


def _fold_leaf(tree: Mapping, f: int) -> dict:
    return {k: _fold_leaf(v, f) if hasattr(v, "items") else np.asarray(v)[f]
            for k, v in tree.items()}


def flax_stacked_to_torch(params: Mapping, k: int) -> Dict[str, torch.Tensor]:
    """A stacked flax param tree of k folds -> {name: (k, ...)}."""
    folds = [flax_to_torch(_fold_leaf(params, f)) for f in range(k)]
    return {n: torch.stack([d[n] for d in folds]) for n in folds[0]}


def torch_stacked_to_flax(stacked: Mapping[str, torch.Tensor]) -> dict:
    """{name: (k, ...)} -> the stacked flax param tree of k folds."""
    k = next(iter(stacked.values())).shape[0]
    folds = [torch_to_flax({n: t[f] for n, t in stacked.items()})
             for f in range(k)]

    def stack(trees):
        return {key: stack([t[key] for t in trees])
                if isinstance(trees[0][key], dict)
                else np.stack([t[key] for t in trees]) for key in trees[0]}
    return stack(folds)
