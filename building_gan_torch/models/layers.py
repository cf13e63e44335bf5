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

The edge-list layers of the packed layout follow: ``GraphNorm`` over
segments, the conv registry (``GATConv``, ``GATv2Conv``, ``GCNConv``,
``GraphConv``; ``get_conv``) and ``HourglassGNN``, after
``building_gan_tpu/models/layers.py``.  Their parameters carry the grid
layers' names (``models/grid_layers.py``), and the hourglass names its layers
``module_{4i}`` (conv) and ``module_{4i+1}`` (norm) as ``GridHourglass`` does,
so one ``state_dict`` loads into both layouts.  Their dtypes are the JAX
layers': each conv's GEMMs run at the stack's compute dtype (the dtype of the
hourglass's input), its aggregation promotes to f32 (the f32 softmax weights,
degrees and edge masks), and GraphNorm returns its input's dtype.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import dropout
from ..ops import segment as seg
from ..ops.message_passing import gat_aggregate, softmax_aggregate
from ..ops.stencil import leaky_relu

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


def hourglass_channels(hidden_dim: int, repeat: int, min_channels: int = 1) -> list[int]:
    """The hourglass schedule: ``repeat`` halvings then ``repeat`` doublings,
    each clamped at ``min_channels`` (1 = the reference schedule).

    hidden 128, repeat 7 -> [64, 32, 16, 8, 4, 2, 1, 2, 4, ..., 128].
    """
    if not 1 <= min_channels <= hidden_dim:
        raise ValueError(
            f"HOURGLASS_MIN_CHANNELS must be in [1, hidden_dim={hidden_dim}], "
            f"got {min_channels}"
        )
    channels = []
    c = hidden_dim
    for _ in range(repeat):
        c //= 2
        channels.append(max(c, min_channels))
    for _ in range(repeat):
        c *= 2
        channels.append(max(c, min_channels))
    return channels


def glorot_att(features: int) -> nn.Parameter:
    """A (1, heads=1, C) attention vector, glorot-uniform as a (C, 1) kernel (flax's init)."""
    bound = math.sqrt(6.0 / (features + 1))
    return nn.Parameter(torch.empty(1, 1, features).uniform_(-bound, bound))


def conv_class(registry: dict, conv_type: str):
    """The conv class registered as ``conv_type``; an unknown name raises (reference models.py:22-31)."""
    if conv_type not in registry:
        raise ValueError(f"Invalid conv_type: {conv_type}")
    return registry[conv_type]


# ---------------------------------------------------------------------------
# the packed edge-list layout
# ---------------------------------------------------------------------------


def _f32(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


class GraphNorm(nn.Module):
    """GraphNorm with learned mean scale over segments (PyG ``GraphNorm``, per graph).

    One-pass moments with f32 statistics, as the JAX layer and the grid
    layer compute them: ``s = E[x] * mean_scale``, ``var = E[x^2] - 2 s E[x] +
    s^2``, output ``x * scale + shift`` in x's dtype.  ``mask`` keeps padded
    nodes out of the statistics; their output is not masked here (the
    hourglass zeroes them).  ``segment_ids=None`` takes the statistics over
    every node of the pack: the reference's GraphNorm without a batch vector
    (quirk Q5).
    """

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.mean_scale = nn.Parameter(torch.ones(features))

    def forward(self, x, segment_ids, num_segments: int | None, mask=None):
        dt = _f32(x.dtype)
        xf = x.to(dt)
        w = None if mask is None else mask.to(dt)
        if segment_ids is None:
            w = torch.ones_like(xf[:, 0]) if w is None else w
            denom = w.sum().clamp(min=1.0)
            mean = (xf * w[:, None]).sum(0, keepdim=True) / denom
            ex2 = (xf * xf * w[:, None]).sum(0, keepdim=True) / denom
        else:
            mean = seg.gather(seg.segment_mean(xf, segment_ids, num_segments, weights=w),
                              segment_ids)
            ex2 = seg.gather(seg.segment_mean(xf * xf, segment_ids, num_segments, weights=w),
                             segment_ids)
        s = mean * self.mean_scale
        var = torch.clamp(ex2 - 2.0 * s * mean + s * s, min=0.0)
        inv = self.weight * torch.rsqrt(var + self.eps)
        return x * inv.to(x.dtype) + (self.bias - s * inv).to(x.dtype)


class GATConv(nn.Module):
    """Single-head GAT over a padded edge list (PyG GATConv defaults)."""

    def __init__(self, in_features: int, features: int, negative_slope: float = 0.2):
        super().__init__()
        self.negative_slope = negative_slope
        self.lin = nn.Linear(in_features, features, bias=False)
        self.att_src = glorot_att(features)
        self.att_dst = glorot_att(features)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, src, dst, edge_mask, dtype: torch.dtype | None = None):
        dt = x.dtype if dtype is None else dtype
        h = F.linear(x.to(dt), self.lin.weight.to(dt))
        hf = h.to(_f32(dt))
        a_src = hf @ self.att_src.reshape(-1).to(hf.dtype)
        a_dst = hf @ self.att_dst.reshape(-1).to(hf.dtype)
        out = gat_aggregate(h, a_src, a_dst, src, dst, edge_mask, self.negative_slope)
        return out + self.bias


class GATv2Conv(nn.Module):
    """Single-head GATv2 over a padded edge list (PyG GATv2Conv, share_weights=False)."""

    def __init__(self, in_features: int, features: int, negative_slope: float = 0.2):
        super().__init__()
        self.negative_slope = negative_slope
        self.lin_l = Dense(in_features, features)
        self.lin_r = Dense(in_features, features)
        self.att = glorot_att(features)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, src, dst, edge_mask, dtype: torch.dtype | None = None):
        dt = x.dtype if dtype is None else dtype
        h_l = self.lin_l(x.to(dt))  # source
        h_r = self.lin_r(x.to(dt))  # target
        pf = _f32(dt)
        att = self.att.reshape(-1).to(pf)
        h_src = seg.gather(h_l, src)
        e = leaky_relu(h_src + seg.gather(h_r, dst), self.negative_slope).to(pf) @ att
        e_self = leaky_relu(h_l + h_r, self.negative_slope).to(pf) @ att
        return softmax_aggregate(e, e_self, h_src, h_l, dst, edge_mask) + self.bias


class GCNConv(nn.Module):
    """GCN with symmetric normalisation over A + I (PyG GCNConv)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.lin = Dense(in_features, features, bias=False)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, src, dst, edge_mask, dtype: torch.dtype | None = None):
        dt = x.dtype if dtype is None else dtype
        n = x.shape[0]
        h = self.lin(x.to(dt))
        dinv = torch.rsqrt(seg.segment_sum(edge_mask, dst, n) + 1.0)  # + the self loop
        w = seg.gather(dinv, src) * seg.gather(dinv, dst) * edge_mask
        out = seg.segment_sum(w[:, None] * seg.gather(h, src), dst, n) + (dinv * dinv)[:, None] * h
        return out + self.bias


class GraphConv(nn.Module):
    """GraphConv: ``lin_root(x_i) + lin_rel(sum_j x_j)`` (PyG GraphConv, aggr='add');
    the bias on ``lin_rel`` as PyG keeps it, added to the self term as the JAX layer does."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.lin_rel = Dense(in_features, features)
        self.lin_root = Dense(in_features, features, bias=False)

    def forward(self, x, src, dst, edge_mask, dtype: torch.dtype | None = None):
        dt = x.dtype if dtype is None else dtype
        xd = x.to(dt)
        h_nbr = F.linear(xd, self.lin_rel.weight.to(dt))
        agg = seg.segment_sum(edge_mask[:, None] * seg.gather(h_nbr, src), dst, x.shape[0])
        return F.linear(xd, self.lin_root.weight.to(dt), self.lin_rel.bias.to(dt)) + agg


CONV_REGISTRY = {
    "GCNCONV": GCNConv,
    "GRAPHCONV": GraphConv,
    "GATCONV": GATConv,
    "GATV2CONV": GATv2Conv,
}


def get_conv(conv_type: str):
    """The edge-list conv class by name (reference ``models.py:22-31``)."""
    return conv_class(CONV_REGISTRY, conv_type)


class HourglassGNN(nn.Module):
    """Hourglass of conv -> GraphNorm -> ReLU -> dropout layers over a padded edge list.

    The channel schedule is ``hourglass_channels``.  Layer i's conv is
    ``module_{4i}``, its norm ``module_{4i+1}`` (the grid hourglass's names).
    The norm's statistics are per graph (segment ids, with the padding in its
    own segment), or over the whole pack with ``batch_level_graphnorm`` (quirk
    Q5), and padded rows are zeroed after every norm: the padding's
    segment has no statistics (var = 0), and its ``1 / sqrt(eps)`` scale would
    otherwise compound to inf / NaN over the layers.  In training mode each
    layer's dropout is the Philox byte mask of ``ops/dropout.py`` under
    ``keys[i]``, over (NV, hidden) at the stack's padded width.
    """

    def __init__(self, hidden_dim: int, repeat: int, min_channels: int = 1,
                 conv_type: str = "GATCONV", dropout_rate: float = 0.2,
                 batch_level_graphnorm: bool = False):
        super().__init__()
        conv_cls = get_conv(conv_type)
        self.conv_type = conv_type
        self.batch_level_graphnorm = batch_level_graphnorm
        self.hidden_dim = hidden_dim
        self.dropout_rate = dropout_rate
        self.channels = hourglass_channels(hidden_dim, repeat, min_channels)
        cin = hidden_dim
        for i, ch in enumerate(self.channels):
            self.add_module(f"module_{4 * i}", conv_cls(cin, ch))
            self.add_module(f"module_{4 * i + 1}", GraphNorm(ch))
            cin = ch

    def layers(self):
        for i in range(len(self.channels)):
            yield getattr(self, f"module_{4 * i}"), getattr(self, f"module_{4 * i + 1}")

    def forward(self, x, src, dst, edge_mask, graph_id, num_segments: int, node_mask,
                deterministic: bool = True, keys: torch.Tensor | None = None):
        """x (NV, hidden) at the compute dtype -> (NV, hidden).

        ``keys`` (L, 2) int64: the per-layer Philox keys, needed when
        ``deterministic`` is False and the rate is above 0.
        """
        drop_on = not deterministic and dropout.drop_levels(self.dropout_rate) > 0
        if drop_on and keys is None:
            raise ValueError("training-mode dropout needs per-layer Philox keys")
        dt = x.dtype
        if self.batch_level_graphnorm:
            graph_id = num_segments = None
        for i, (conv, norm) in enumerate(self.layers()):
            x = conv(x, src, dst, edge_mask, dtype=dt)
            x = norm(x, graph_id, num_segments, mask=node_mask) * node_mask[:, None]
            x = torch.relu(x)
            if drop_on:
                x = dropout.dropout(x[None], keys[i], self.dropout_rate, width=self.hidden_dim)[0]
        return x
