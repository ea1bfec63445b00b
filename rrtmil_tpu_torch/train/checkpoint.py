"""Checkpoint / resume with every RNG stream.

Counterpart of `rrtmil_tpu/train/checkpoint.py` (reference main.py:358-379):
the model's and optimizer's `state_dict`s go through `torch.save`, the host
state (epoch and fold counters, the engine's numpy Generator state and its
torch.Generator state, the early stopper, the best scores and the metric
lists) through pickle, so `--auto_resume` continues the run where it
stopped.  Two families, as in the reference:

  * the rolling full-resume checkpoint `ckp.pt` + `ckp_host.pkl`, every
    epoch;
  * the per-fold best-AUC weights `fold_{k}_model_best_auc.pt`
    (main.py:330-344), reloaded for the fold's final test.

The survival harness keeps weights only (`save_params` / `load_params`, the
JAX package's `train/checkpoint.py:38-46`): a `state_dict` through
`torch.save`, read back with `weights_only=True`.  The port writes `.pt`;
`load_params` also reads the JAX package's weights, the `.msgpack` files
flax's `to_bytes` writes of a param tree (train/flax_msgpack.py decodes
them without flax), as the `state_dict` that `convert.flax_to_torch` makes
of the tree.  A JAX train state (`ckp.msgpack`, with its optax state) is
not read: it has no torch counterpart.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import torch

from ..convert import flax_to_torch
from . import flax_msgpack


def _own(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each tensor in storage of its own on the CPU: torch.save writes a
    view's whole storage, and a fold-parallel model's parameters are views
    of every fold's stacked tensors."""
    return {k: v.detach().to("cpu", copy=True) for k, v in state_dict.items()}


def save_params(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    torch.save(_own(state_dict), path)


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """A `state_dict` on the CPU: written by `save_params`, or, from a
    `.msgpack` file, the JAX package's param tree through
    `convert.flax_to_torch`."""
    if path.endswith(".msgpack"):
        return flax_to_torch(flax_msgpack.read(path))
    return torch.load(path, map_location="cpu", weights_only=True)


def load_host_state(path: str) -> Dict[str, Any]:
    """The host payload of a rolling checkpoint.  It is a pickle: read only
    a checkpoint this program wrote."""
    with open(path, "rb") as f:
        return pickle.load(f)


class FoldCheckpointer:
    """The reference's two-family checkpoint policy for one CV run."""

    def __init__(self, model_dir: str):
        self.model_dir = model_dir
        os.makedirs(model_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.model_dir, name)

    # rolling full-resume checkpoint ---------------------------------------

    def save_rolling(self, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer,
                     host: Dict[str, Any]) -> None:
        torch.save({"model": model.state_dict(),
                    "optimizer": optimizer.state_dict()}, self._path("ckp.pt"))
        with open(self._path("ckp_host.pkl"), "wb") as f:
            pickle.dump(host, f)

    def has_rolling(self) -> bool:
        return (os.path.exists(self._path("ckp.pt"))
                and os.path.exists(self._path("ckp_host.pkl")))

    def load_rolling(self, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
        """Loads the model and optimizer in place; returns the host state."""
        dev = next(model.parameters()).device
        state = torch.load(self._path("ckp.pt"), map_location=dev,
                           weights_only=True)
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state["optimizer"])
        return load_host_state(self._path("ckp_host.pkl"))

    # per-fold best weights -------------------------------------------------

    def best_path(self, fold: int) -> str:
        return self._path(f"fold_{fold}_model_best_auc.pt")

    def save_best(self, fold: int, model: torch.nn.Module) -> None:
        torch.save(_own(model.state_dict()), self.best_path(fold))

    def load_best(self, fold: int, model: torch.nn.Module) -> None:
        dev = next(model.parameters()).device
        model.load_state_dict(torch.load(self.best_path(fold),
                                         map_location=dev, weights_only=True))
