"""Ranks on a (dp, sp) grid: the process group's bring-up, the grid's
subgroups, each rank's slice of a host array, and the launcher.

Counterpart of `rrtmil_tpu/parallel/mesh.py`.  The JAX package runs one
controller over N devices under `shard_map`; the port runs one process a
rank (`launch`, torch.multiprocessing with the 'spawn' start method), rank
r on `cuda:(r % device_count)` or on the CPU.  The grid's axes keep the JAX
names:

  * `dp`: data parallelism over bags; the ranks of one dp group hold the
    same token slab of different bags, and gradients are summed over them;
  * `sp`: sequence parallelism over a bag's region-rows; the ranks of one
    sp group share a bag (parallel/seqshard.py).

Rank r sits at (r // sp, r % sp).

Backend rule (`choose_backend`): NCCL when every rank has a card of its own;
gloo when ranks share a card, since NCCL refuses two ranks on one device
(gloo takes the CUDA tensors in `all_gather`, `all_reduce` and `broadcast`
and copies them through host memory itself); gloo on the CPU.  Each rank
prints the rule it took, once, and a failure of the backend it chose is
raised, never caught.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..utils.device import resolve_device
from .collectives import SINGLE, ShardGroup

# how long a rank waits in a collective for the others before it raises
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)
_RANK_DEVICE = {}     # this process's rank device, set when it joins


def rank_device(rank: int, device="cuda") -> torch.device:
    """Rank r's device: `cuda:(r % device_count)`, or the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def choose_backend(world_size: int, device) -> tuple:
    """(backend, why) for `world_size` ranks placed by `rank_device`."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo", "ranks on the CPU"
    cards = torch.cuda.device_count()
    if cards >= world_size:
        return "nccl", f"a card a rank ({world_size} ranks, {cards} cards)"
    return "gloo", (f"{world_size} ranks share {cards} card(s): NCCL takes "
                    f"one rank a device")


def initialize_multiprocess(init_method: str, world_size: int, rank: int,
                            device="cuda",
                            timeout: datetime.timedelta = DEFAULT_TIMEOUT
                            ) -> torch.device:
    """Join the process group as `rank` of `world_size` (init_method such
    as 'tcp://localhost:PORT'), with the backend rule's choice and an
    explicit timeout; returns this rank's device."""
    dev = rank_device(rank, device)
    backend, why = choose_backend(world_size, dev)
    print(f"[rank {rank}/{world_size}] backend {backend} ({why}) on {dev}",
          flush=True)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout)
    _RANK_DEVICE["device"] = dev
    return dev


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place on the (dp, sp) grid, its device and its two
    groups: `sp_group` (the sp ranks that share its bags) and `dp_group`
    (the dp ranks that hold the same token slab)."""

    dp: int
    sp: int
    rank: int
    device: torch.device
    sp_group: ShardGroup
    dp_group: ShardGroup

    @property
    def world(self) -> int:
        return self.dp * self.sp

    @property
    def dp_index(self) -> int:
        return self.rank // self.sp

    @property
    def sp_index(self) -> int:
        return self.rank % self.sp

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "sp": self.sp}


def make_mesh(dp: Optional[int] = None, sp: int = 1,
              device=None) -> Mesh:
    """This rank's (dp, sp) mesh over the process group's ranks (dp
    defaults to world // sp); without a process group, the one-rank mesh
    on `device`.  The device defaults to the one this rank joined on.  Every
    rank must call it, in the same order as any other group it makes."""
    if not dist.is_initialized():
        if (dp or 1) * sp != 1:
            raise ValueError(f"a ({dp}, {sp}) mesh needs a process group "
                             f"(initialize_multiprocess / launch)")
        return local_mesh(device or "cuda")
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp is None:
        dp = world // sp
    if dp * sp != world:
        raise ValueError(f"dp*sp = {dp}*{sp} != {world} ranks")
    if device is None:
        device = _RANK_DEVICE["device"]
    d, s = rank // sp, rank % sp
    sp_group = dp_group = None
    for i in range(dp):                       # every rank makes every group
        g = dist.new_group([i * sp + j for j in range(sp)])
        if i == d:
            sp_group = ShardGroup(g, sp, s)
    for j in range(sp):
        g = dist.new_group([i * sp + j for i in range(dp)])
        if j == s:
            dp_group = ShardGroup(g, dp, d)
    return Mesh(dp, sp, rank, torch.device(device), sp_group, dp_group)


def local_mesh(device="cuda") -> Mesh:
    """The one-rank mesh on `device`: no process group, no collective (a
    rank of a group can run a model of its own on it)."""
    return Mesh(1, 1, 0, resolve_device(device), SINGLE, SINGLE)


def global_array(data, mesh: Mesh, spec: Sequence[Optional[str]],
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """This rank's slice of a host array (numpy or a CPU tensor) that every
    rank holds whole, on this rank's device: axis i split over the mesh
    axis spec[i] ('dp', 'sp' or None for whole), in rank order."""
    t = torch.as_tensor(np.asarray(data)) if not torch.is_tensor(data) \
        else data
    for axis, name in enumerate(spec):
        if name is None:
            continue
        n, idx = mesh.shape[name], getattr(mesh, f"{name}_index")
        if t.shape[axis] % n:
            raise ValueError(f"axis {axis} of {tuple(t.shape)} does not "
                             f"split over {name} = {n}")
        t = t.chunk(n, axis)[idx]
    t = t.contiguous()
    return t.to(mesh.device, dtype=dtype) if dtype is not None \
        else t.to(mesh.device)


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, fn: Callable, world_size: int, init_method: str,
                device, timeout, threads, args) -> None:
    if threads:
        torch.set_num_threads(threads)
    initialize_multiprocess(init_method, world_size, rank, device, timeout)
    try:
        fn(rank, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world_size: int, device="cuda", args=(),
           timeout: datetime.timedelta = DEFAULT_TIMEOUT,
           threads: Optional[int] = None) -> None:
    """Run fn(rank, *args) in `world_size` processes (start method 'spawn',
    a free localhost port), each in the process group first; `threads` sets
    each rank's intra-op threads (on the CPU, by default, the host's cores
    shared out).  `fn` must be importable by name.  If a rank fails, the
    others are stopped and the error is raised here; a rank left waiting
    in a collective raises after `timeout`."""
    if torch.device(device).type == "cuda":
        resolve_device(device)
    elif threads is None:
        threads = max(1, (os.cpu_count() or 1) // world_size)
    mp.spawn(_rank_entry, args=(fn, world_size,
                                f"tcp://localhost:{free_port()}", device,
                                timeout, threads, tuple(args)),
             nprocs=world_size, join=True, start_method="spawn")
