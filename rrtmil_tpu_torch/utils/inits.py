"""Parameter initializers with the JAX package's distributions.

Counterpart of `rrtmil_tpu/utils/inits.py`.  Every draw comes from an
explicit `torch.Generator`:

  * `xavier_normal_`: flax's `xavier_normal()` (variance_scaling(1.0,
    "fan_avg", "truncated_normal")): a normal truncated at +-2 sigma whose
    sigma is sqrt(2 / (fan_in + fan_out)) / 0.8796 so that the truncated
    variance is 2 / (fan_in + fan_out).  Fans follow flax's layout of the
    kernel, passed in explicitly.
  * zeros for biases, ones/zeros for LayerNorm.
  * `crmsa_phi_init_`: U(+-1/sqrt(crmsa_k)) (reference rmsa.py:254-259).
"""
from __future__ import annotations

import math

import torch

# stddev of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def xavier_normal_(t: torch.Tensor, fan_in: int, fan_out: int,
                   generator: torch.Generator) -> torch.Tensor:
    std = math.sqrt(2.0 / (fan_in + fan_out)) / _TRUNC_STD
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                           generator=generator)


def crmsa_phi_init_(t: torch.Tensor, crmsa_k: int,
                    generator: torch.Generator) -> torch.Tensor:
    """kaiming_uniform(a=sqrt(5)) on a (dim, crmsa_k) tensor: torch computes
    fan_in = size(1) = crmsa_k, so bound = 1/sqrt(crmsa_k)."""
    bound = 1.0 / math.sqrt(crmsa_k)
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)
