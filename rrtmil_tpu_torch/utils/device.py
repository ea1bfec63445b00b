"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The entry points run on the card unless the caller asks for the CPU;
    asking for CUDA with no card raises instead of falling back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu on the CLI) to run the kernels' "
                           "plain PyTorch versions")
    return dev
