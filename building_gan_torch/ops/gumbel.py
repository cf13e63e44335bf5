"""Gumbel-softmax with straight-through hard one-hot sampling.

``label_soft = softmax((logits + g) / tau)`` and
``label_hard = one_hot(argmax(label_soft)) - label_soft.detach() + label_soft``,
so the forward emits a hard one-hot while gradients flow through the soft
sample.  The Gumbel noise ``g`` is passed in, or drawn from a
``torch.Generator`` as ``-log(-log u)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gumbel_noise(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """Standard Gumbel noise from ``generator`` (u clamped away from 0 and 1)."""
    dev = generator.device if device is None else device
    u = torch.rand(tuple(shape), generator=generator, device=dev, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    u = u.clamp(min=tiny, max=1.0 - 2**-24)
    return -torch.log(-torch.log(u))


def gumbel_softmax_st(
    logits: torch.Tensor,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    tau: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(label_hard, label_soft)``; hard carries the ST gradient."""
    if noise is None:
        if generator is None:
            raise ValueError("gumbel_softmax_st needs the noise or a generator")
        noise = gumbel_noise(logits.shape, generator, device=logits.device)
    g = noise.to(device=logits.device, dtype=logits.dtype)
    label_soft = torch.softmax((logits + g) / tau, dim=-1)
    idx = label_soft.argmax(dim=-1)
    hard = F.one_hot(idx, logits.shape[-1]).to(logits.dtype)
    label_hard = hard - label_soft.detach() + label_soft
    return label_hard, label_soft
