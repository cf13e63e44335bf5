"""MLP unit of the generator: Linear -> LayerNorm -> LeakyReLU(0.2), at the input's dtype.

The LayerNorm epsilon is flax's default, 1e-6 (torch's default is 1e-5).
``mlp_stack`` flattens a run of blocks into one ``nn.Sequential`` so that a
block's Linear sits at index 3i and its LayerNorm at 3i+1: the reference
``state_dict`` layout (``matched_features_encoder.{3i}.weight``, ...).

Parameters stay float32 and are cast at use, as flax ``Dense(dtype=...)`` and
``LayerNorm(dtype=...)`` do: ``Dense`` computes in its input's dtype (the
caller casts the model's inputs to the compute dtype once, on entry), and
``LayerNorm`` takes its statistics and applies its scale and bias in float32
(flax's ``_compute_stats`` and ``_normalize`` promote to at least f32) and
rounds the result to the input's dtype.  On f32 inputs both are exactly
``nn.Linear`` and ``nn.LayerNorm``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

LAYER_NORM_EPS = 1e-6
LEAKY_SLOPE = 0.2


class Dense(nn.Linear):
    """``nn.Linear`` at its input's dtype: weight and bias cast to it at use."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` in float32 (or wider) whatever its input's dtype, output in that dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, torch.float32)
        y = F.layer_norm(x.to(dt), self.normalized_shape, self.weight.to(dt), self.bias.to(dt),
                         self.eps)
        return y.to(x.dtype)


class MLPBlock(nn.Sequential):
    """Linear -> LayerNorm(eps=1e-6) -> LeakyReLU(0.2)."""

    def __init__(self, in_features: int, features: int):
        super().__init__(
            Dense(in_features, features),
            LayerNorm(features, eps=LAYER_NORM_EPS),
            nn.LeakyReLU(LEAKY_SLOPE),
        )


def mlp_stack(in_features: int, widths: Sequence[int]) -> nn.Sequential:
    """MLPBlocks of the given output widths, flattened into one Sequential."""
    layers = []
    for w in widths:
        layers.extend(MLPBlock(in_features, w))
        in_features = w
    return nn.Sequential(*layers)
