"""Normal sampling by the paired Box-Muller transform.

The same transform as ``building_gan_tpu/ops/rng.py::normal_box_muller``:
two uniforms per output pair, ``r = sqrt(-2 log u1)``, ``theta = 2 pi u2``,
both ``r cos theta`` and ``r sin theta`` used.  The uniforms come from an
explicit ``torch.Generator`` (torch cannot replay JAX's threefry streams, so
the two packages draw different numbers from the same seed; tests hand both
sides the same z).
"""

from __future__ import annotations

import math

import torch


def box_muller(u1: torch.Tensor, u2: torch.Tensor, shape) -> torch.Tensor:
    """Paired transform of uniforms: u1 in (0, 1], u2 in [0, 1), each of half the size."""
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = (2.0 * math.pi) * u2
    if shape and shape[-1] % 2 == 0:
        return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1).reshape(shape)
    n = math.prod(shape)
    return torch.cat([r * torch.cos(theta), r * torch.sin(theta)])[:n].reshape(shape)


def normal_box_muller(shape, generator: torch.Generator) -> torch.Tensor:
    """Float32 N(0, 1) sample of ``shape`` from ``generator`` (on its device), paired Box-Muller."""
    shape = tuple(shape)
    if shape and shape[-1] % 2 == 0:
        half = shape[:-1] + (shape[-1] // 2,)
    else:
        half = ((math.prod(shape) + 1) // 2,)
    dev = generator.device
    # u1 in (0, 1]: 1 - uniform[0, 1) keeps log() finite
    u1 = 1.0 - torch.rand(half, generator=generator, device=dev, dtype=torch.float32)
    u2 = torch.rand(half, generator=generator, device=dev, dtype=torch.float32)
    return box_muller(u1, u2, shape)
