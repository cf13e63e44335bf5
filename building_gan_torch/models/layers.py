"""MLP unit of the generator: Linear -> LayerNorm -> LeakyReLU(0.2).

The LayerNorm epsilon is flax's default, 1e-6 (torch's default is 1e-5).
``mlp_stack`` flattens a run of blocks into one ``nn.Sequential`` so that a
block's Linear sits at index 3i and its LayerNorm at 3i+1: the reference
``state_dict`` layout (``matched_features_encoder.{3i}.weight``, ...).
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

LAYER_NORM_EPS = 1e-6
LEAKY_SLOPE = 0.2


class MLPBlock(nn.Sequential):
    """Linear -> LayerNorm(eps=1e-6) -> LeakyReLU(0.2)."""

    def __init__(self, in_features: int, features: int):
        super().__init__(
            nn.Linear(in_features, features),
            nn.LayerNorm(features, eps=LAYER_NORM_EPS),
            nn.LeakyReLU(LEAKY_SLOPE),
        )


def mlp_stack(in_features: int, widths: Sequence[int]) -> nn.Sequential:
    """MLPBlocks of the given output widths, flattened into one Sequential."""
    layers = []
    for w in widths:
        layers.extend(MLPBlock(in_features, w))
        in_features = w
    return nn.Sequential(*layers)
