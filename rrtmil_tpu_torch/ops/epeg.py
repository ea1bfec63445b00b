"""EPEG's depthwise convolutions, as torch ops on either device.

Counterpart of `rrtmil_tpu/ops/epeg.py:23-93` for what the R-MSA layer's
InnerAttention needs outside the kernels:

  * `epeg_logit_conv`: the EPEG conv on the raw attention logits (B_, H, N,
    N), the logit map read as an image whose channels are the heads: 1-D, a
    (k, 1) kernel along the query axis with zero padding (k//2, 0)
    (reference rmsa.py:83,106-108); 2-D, a (k, k) kernel with padding k//2
    on both axes (rmsa.py:78).  Returns the term added to the logits.
  * `value_pe`: the 'value_bf' / 'value_af' ablations' conv on the values
    (B_, h, N, hd) read as a (B_, hd * h, s, s) image, s * s = N
    (rmsa.py:114-129), with the reference's channel order: the image is
    v.transpose(0, 3, 1, 2), so its channel c is d * h + head; 'value_bf'
    reads the result back as (B_, h, hd, N) and 'value_af' adds it flat,
    channel c onto the output's column c (whose own order is head * hd + d).
  * `depthwise_conv2d`: the grouped conv under both, on NCHW images.

Tap layout, the port's (convert.py maps flax's (kh, kw, 1, C) kernels to
it): `weight` (C, kh) for a (kh, 1) kernel, (C, kh, kw) otherwise.  Tap
(i, j) reads pixel (y + i - kh//2, x + j - kw//2): a cross-correlation, as
torch's conv2d and flax's conv compute it.

A (kh, 1) kernel runs as the (1, kh) conv over the image's transpose: torch
2.13's CPU (oneDNN) depthwise backward gives a wrong kernel gradient for
some (k, 1) shapes (found with Nystrom's (33, 1) conv, models/nystrom.py),
and the transposed form is right on both devices.  The 1-D logit conv runs
as k shifted adds along the query axis, the arithmetic of the kernels'
plain versions (`epeg_fold_q` is not needed: K1 / K2 / K5-K7 take the taps
in their own layout).  Everything here computes in float32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def taps_2d(weight: torch.Tensor) -> torch.Tensor:
    """The (C, kh, kw) view of a tap set stored as (C, kh) or (C, kh, kw)."""
    return weight[..., None] if weight.dim() == 2 else weight


def depthwise_conv2d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped 'same' conv of x (B, C, H, W) with taps `weight` (C, kh) or
    (C, kh, kw), zero padding (kh//2, kw//2), plus `bias` (C,); float32."""
    w = taps_2d(weight).float()
    c, kh, kw = w.shape
    x = x.float()
    if kw == 1:
        # (kh, 1) over x == ((1, kh) over x^T)^T: see the module docstring
        out = F.conv2d(x.transpose(2, 3), w.reshape(c, 1, 1, kh),
                       padding=(0, kh // 2), groups=c).transpose(2, 3)
    else:
        out = F.conv2d(x, w[:, None], padding=(kh // 2, kw // 2), groups=c)
    if bias is not None:
        out = out + bias.float()[None, :, None, None]
    return out


def epeg_logit_conv(attn: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The EPEG term of the logits attn (B_, H, N, N): 1-D for taps (H, k),
    2-D for (H, k, k); plus pe_bias (H,) when given."""
    if weight.dim() == 3:
        return depthwise_conv2d(attn, weight, bias)
    attn = attn.float()
    kk = weight.shape[1]
    pad = kk // 2
    n = attn.shape[2]
    padded = F.pad(attn, (0, 0, pad, pad))
    w = weight.float()
    pe = torch.zeros_like(attn)
    for t in range(kk):
        pe = pe + w[None, :, t, None, None] * padded[:, :, t:t + n]
    if bias is not None:
        pe = pe + bias.float()[None, :, None, None]
    return pe


def value_pe(v: torch.Tensor, weight: torch.Tensor,
             bias: Optional[torch.Tensor], flat: bool = False
             ) -> torch.Tensor:
    """The value conv of v (B_, h, N, hd) with taps (h * hd, kh[, kw]):
    (B_, h, N, hd) for 'value_bf', (B_, N, h * hd) for 'value_af' (`flat`);
    float32.  Raises unless N is a perfect square."""
    b_, h, n, hd = v.shape
    ch = h * hd
    s = int(math.ceil(math.sqrt(n)))
    if s * s != n:
        raise ValueError("value EPEG requires square region token count")
    img = v.permute(0, 3, 1, 2).reshape(b_, ch, s, s)   # channel d * h + head
    pe = depthwise_conv2d(img, weight, bias)
    if flat:
        return pe.reshape(b_, ch, n).transpose(1, 2)
    return pe.reshape(b_, h, hd, n).transpose(2, 3)
