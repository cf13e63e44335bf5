"""Grid-layout layers: GraphNorm, the conv registry, the hourglass stack, matched pooling.

Each mirrors its counterpart in ``building_gan_tpu/models/grid_layers.py``
on the flattened-row layout ``(B, R, C)``, R = F*Y*X, at the dtype of their
input (the compute dtype; parameters stay float32 and are cast at use, score
and statistics math runs in float32).  Submodules and
parameters are named after the reference ``state_dict`` layout
(``encoder.module_{4i}.lin.weight``, ``encoder.module_{4i+1}.mean_scale``,
...), so converted weights load with ``load_state_dict`` unchanged.

The conv registry (``GRID_CONV_REGISTRY``) holds the reference's four convs
by name, their parameters named as PyG names them: GATConv (``lin``,
``att_src``, ``att_dst``, ``bias``), GATv2Conv (``lin_l``, ``lin_r``, ``att``,
``bias``), GCNConv (``lin``, ``bias``) and GraphConv (``lin_rel`` with the
layer's one bias, ``lin_root``).  The edge-list layers (``models/layers.py``)
carry the same names, so one ``state_dict`` loads into both layouts.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import dropout, stencil
from ..ops.hourglass import hourglass_channel_pairs
from ..parallel import sp as floor
from .layers import Dense, conv_class, glorot_att, hourglass_channels


def graph_norm(
    x: torch.Tensor,  # (B, R, C)
    mask: torch.Tensor,  # (B, R)
    weight: torch.Tensor,
    bias: torch.Tensor,
    mean_scale: torch.Tensor,
    eps: float = 1e-5,
    gid: torch.Tensor | None = None,  # (B, R) building index within the slot
    num_graphs: int = 1,
    batch_level: bool = False,
    sp: floor.FloorShard | None = None,
) -> torch.Tensor:
    """GraphNorm with learned mean scale, statistics per slot or per (slot, gid), or
    (``batch_level``, the reference's quirk Q5) over every masked cell of the batch.

    One-pass moments, as the JAX package computes them:
    ``s = E[x] * mean_scale``, ``var = E[x^2] - 2 s E[x] + s^2``,
    ``y = x * w / sqrt(var + eps) + (b - s * w / sqrt(var + eps))``.
    Masked cells take no part in the statistics and come out as 0.  The
    statistics are taken in float32 (or in x's dtype when it is wider);
    ``scale`` and ``shift`` are then rounded to x's dtype and applied in it,
    as ``building_gan_tpu/models/grid_layers.py::GridGraphNorm`` does.  With
    K > 1 the squares are taken in f32 too, as the JAX package's jitted layer
    computes them (XLA keeps the f32 product inside its one-hot einsum) and
    as the fused kernels do: squares rounded to bf16 can make a near-constant
    building's variance 0, and its gradient penalty ~1e6 (one 2-cell
    building of a K = 6 slot did).

    With a floor shard ``sp`` the sums and counts are this rank's partial ones, summed
    over the ranks (one f32 all-reduce) before the moments.
    """
    dt = torch.promote_types(x.dtype, torch.float32)
    m = mask.to(dt)[..., None]
    if gid is not None and num_graphs > 1 and not batch_level:
        oh = F.one_hot(gid.long().clamp(min=0), num_graphs).to(dt)
        oh = oh * ((gid >= 0) & (gid < num_graphs)).to(dt)[..., None] * m  # (B, R, K)
        counts = oh.sum(dim=1)  # (B, K)
        xf = x.to(dt)
        s1 = torch.einsum("brk,brc->bkc", oh, xf)
        s2 = torch.einsum("brk,brc->bkc", oh, xf * xf)
        if sp is not None:
            s1, s2, counts = floor.all_reduce_sum(sp, s1, s2, counts)
        counts = counts.clamp(min=1.0)
        mean = s1 / counts[..., None]
        ex2 = s2 / counts[..., None]
        s = mean * mean_scale
        var = torch.clamp(ex2 - 2.0 * s * mean + s * s, min=0.0)
        inv = weight * torch.rsqrt(var + eps)
        both = torch.cat([inv, bias - s * inv], dim=-1).to(x.dtype)  # (B, K, 2C)
        # a one-hot select: exact in any dtype
        t = torch.einsum("brk,bkc->brc", oh, both.to(dt)).to(x.dtype)
        C = inv.shape[-1]
        return x * t[..., :C] + t[..., C:]
    axes = (0, 1) if batch_level else (1,)  # the batch's cells, or each slot's
    denom = mask.to(dt).sum(dim=axes, keepdim=True)[..., None]
    xf = x.to(dt)
    s1 = (xf * m).sum(dim=axes, keepdim=True)
    s2 = (xf * xf * m).sum(dim=axes, keepdim=True)
    if sp is not None:
        s1, s2, denom = floor.all_reduce_sum(sp, s1, s2, denom)
    denom = denom.clamp(min=1.0)
    mean = s1 / denom
    ex2 = s2 / denom
    s = mean * mean_scale
    var = torch.clamp(ex2 - 2.0 * s * mean + s * s, min=0.0)
    inv = weight * torch.rsqrt(var + eps)
    return (x * inv.to(x.dtype) + (bias - s * inv).to(x.dtype)) * m.to(x.dtype)


class GridGraphNorm(nn.Module):
    """GraphNorm over grid cells (per slot, or per building with a gid plane)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.mean_scale = nn.Parameter(torch.ones(features))

    def forward(self, x, mask, gid=None, num_graphs: int = 1, batch_level: bool = False,
                sp=None):
        return graph_norm(
            x, mask, self.weight, self.bias, self.mean_scale, self.eps, gid, num_graphs,
            batch_level, sp,
        )


class GridGATConv(nn.Module):
    """Single-head GAT over the 6-neighbourhood (PyG GATConv defaults).

    ``a_src`` and ``a_dst`` come from the folded GEMM ``x @ [W, W att_src,
    W att_dst]``, as in the JAX layer; the fused kernel takes them from
    ``(x W) . att`` instead (same value, other rounding).  The folded
    weights are cast to x's dtype (the compute dtype) and the GEMM runs in it.
    """

    def __init__(self, in_features: int, features: int, negative_slope: float = 0.2):
        super().__init__()
        self.negative_slope = negative_slope
        self.lin = nn.Linear(in_features, features, bias=False)
        self.att_src = glorot_att(features)  # torch layout of the reference: (1, heads=1, C)
        self.att_dst = glorot_att(features)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, mask, grid_shape, gid=None, sp=None):
        w = self.lin.weight.t()  # (in, out)
        C = w.shape[1]
        wa = torch.cat(
            [w, w @ self.att_src.reshape(C, 1), w @ self.att_dst.reshape(C, 1)], dim=1
        ).to(x.dtype)
        ha = x @ wa
        h = ha[..., :C]
        fn = stencil.stencil_gat_flat if sp is None else functools.partial(
            floor.stencil_gat_sp, sp=sp)
        out = fn(h, ha[..., C], ha[..., C + 1], mask, grid_shape,
                 negative_slope=self.negative_slope, gid=gid)
        return out + self.bias.to(out.dtype)


class GridGATv2Conv(nn.Module):
    """Single-head GATv2 over the 6-neighbourhood (PyG GATv2Conv, share_weights=False).

    ``lin_l`` transforms the source, ``lin_r`` the target, both with a bias;
    the scores are ``att . LeakyReLU(h_l[j] + h_r[i])``.
    """

    def __init__(self, in_features: int, features: int, negative_slope: float = 0.2):
        super().__init__()
        self.negative_slope = negative_slope
        self.lin_l = Dense(in_features, features)
        self.lin_r = Dense(in_features, features)
        self.att = glorot_att(features)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, mask, grid_shape, gid=None, sp=None):
        fn = stencil.stencil_gatv2_flat if sp is None else functools.partial(
            floor.stencil_gatv2_sp, sp=sp)
        out = fn(self.lin_l(x), self.lin_r(x), self.att.reshape(-1), mask, grid_shape,
                 negative_slope=self.negative_slope, gid=gid)
        return out + self.bias.to(out.dtype)


class GridGCNConv(nn.Module):
    """GCN over the 6-neighbourhood with symmetric normalisation over A + I (PyG GCNConv)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.lin = Dense(in_features, features, bias=False)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, mask, grid_shape, gid=None, sp=None):
        fn = stencil.stencil_gcn_flat if sp is None else functools.partial(
            floor.stencil_gcn_sp, sp=sp)
        out = fn(self.lin(x), mask, grid_shape, gid=gid)
        return out + self.bias.to(out.dtype)


class GridGraphConv(nn.Module):
    """GraphConv over the 6-neighbourhood: ``lin_root(x_i) + lin_rel(sum_j x_j)`` (PyG GraphConv).

    PyG keeps the layer's one bias on ``lin_rel``; the JAX package keeps it on
    its self term (``lin_self``).  The output is the same sum, computed as the
    JAX layer orders it: ``(W_root x + b) + sum_j W_rel x_j``.  The self term
    is not masked here: the norm's masked statistics and its masked output
    take care of padded cells.
    """

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.lin_rel = Dense(in_features, features)
        self.lin_root = Dense(in_features, features, bias=False)

    def forward(self, x, mask, grid_shape, gid=None, sp=None):
        fn = stencil.stencil_sum_flat if sp is None else functools.partial(
            floor.stencil_sum_sp, sp=sp)
        agg = fn(F.linear(x, self.lin_rel.weight.to(x.dtype)), mask, grid_shape, gid=gid)
        h_self = F.linear(x, self.lin_root.weight.to(x.dtype), self.lin_rel.bias.to(x.dtype))
        return h_self + agg


GRID_CONV_REGISTRY = {
    "GCNCONV": GridGCNConv,
    "GRAPHCONV": GridGraphConv,
    "GATCONV": GridGATConv,
    "GATV2CONV": GridGATv2Conv,
}


class GridHourglass(nn.Module):
    """Hourglass of conv -> GraphNorm -> ReLU -> dropout layers, the conv by name.

    Layer i's conv is ``module_{4i}`` and its norm ``module_{4i+1}``; the
    reference's ReLU and Dropout at ``4i+2``, ``4i+3`` hold no parameters.
    In training mode (``deterministic=False``) each layer's dropout is the
    Philox byte-threshold mask of ``ops/dropout.py`` under that layer's key
    ``keys[i]``, counted over the stack's padded width ``hidden_dim``: the
    same mask the fused kernels draw from the same keys.  Only a GATCONV
    stack with per-building statistics has fused kernels
    (``models/fast_train.py``, ``models/fast_infer.py``); the other convs, and
    ``batch_level_graphnorm`` (quirk Q5: every norm's statistics over the whole
    batch), run this module.
    """

    def __init__(self, hidden_dim: int, repeat: int, min_channels: int = 1,
                 conv_type: str = "GATCONV", dropout_rate: float = 0.2,
                 batch_level_graphnorm: bool = False):
        super().__init__()
        conv_cls = conv_class(GRID_CONV_REGISTRY, conv_type)
        self.conv_type = conv_type
        self.batch_level_graphnorm = batch_level_graphnorm
        self.hidden_dim = hidden_dim
        self.dropout_rate = dropout_rate
        self.channels = hourglass_channels(hidden_dim, repeat, min_channels)
        self.channel_pairs = hourglass_channel_pairs(hidden_dim, repeat, min_channels)
        cin = hidden_dim
        for i, ch in enumerate(self.channels):
            self.add_module(f"module_{4 * i}", conv_cls(cin, ch))
            self.add_module(f"module_{4 * i + 1}", GridGraphNorm(ch))
            cin = ch

    def layers(self):
        for i in range(len(self.channels)):
            yield getattr(self, f"module_{4 * i}"), getattr(self, f"module_{4 * i + 1}")

    def forward(self, x, mask, grid_shape, gid=None, num_graphs: int = 1,
                deterministic: bool = True, keys: torch.Tensor | None = None, sp=None):
        """x (B, R, hidden) on the flattened-row layout -> (B, R, hidden).

        ``keys`` (L, 2) int64: the per-layer Philox keys, needed when
        ``deterministic`` is False and the rate is above 0.  With a floor shard
        ``sp`` (``parallel/sp.py``) x, mask and gid are this rank's floors
        (``grid_shape`` theirs): the convs run their halo stencils, the norms sum
        their statistics over the ranks, and the dropout masks are the slot's own
        at this rank's rows.
        """
        drop_on = not deterministic and dropout.drop_levels(self.dropout_rate) > 0
        if drop_on and keys is None:
            raise ValueError("training-mode dropout needs per-layer Philox keys")
        rows = None
        if sp is not None:
            sp = sp.with_planes(mask, gid)  # the padded mask and gid, exchanged once
            rows = sp.rows(grid_shape[1] * grid_shape[2])
        for i, (conv, norm) in enumerate(self.layers()):
            x = conv(x, mask, grid_shape, gid=gid, sp=sp)
            x = torch.relu(norm(x, mask, gid=gid, num_graphs=num_graphs,
                                batch_level=self.batch_level_graphnorm, sp=sp))
            if drop_on:
                x = dropout.dropout(x, keys[i], self.dropout_rate, width=self.hidden_dim,
                                    rows=rows)
        return x


def grid_type_matched_pooling(
    local_x: torch.Tensor,  # (B, NL, C)
    local_type: torch.Tensor,  # (B, NL)
    local_mask: torch.Tensor,  # (B, NL)
    voxel_type: torch.Tensor,  # (B, R) or (B, F, Y, X)
    num_classes: int,
    local_gid: torch.Tensor | None = None,  # (B, NL)
    gid: torch.Tensor | None = None,  # like voxel_type
    num_graphs: int = 1,
    batch_level: bool = False,
) -> torch.Tensor:
    """Per-cell mean of the program nodes of the cell's type (and building).

    A per-(graph, type) mean table built with one einsum, read back with a
    one-hot matmul.  Multi-building slots key the table on (building, type).
    ``batch_level`` (the reference's quirk Q1) keys it on the type alone, over
    every slot of the batch (the gid planes are then not read, as in the JAX
    function).  Sums in float32, the table rounded to ``local_x``'s dtype (the
    caller casts it to the compute dtype), as the JAX function does.
    """
    B = voxel_type.shape[0]
    cells = tuple(voxel_type.shape[1:])
    C = local_x.shape[-1]
    lx = local_x.float()
    lm = local_mask.float()[..., None]

    if gid is not None and num_graphs > 1 and not batch_level:
        kt = num_graphs * num_classes
        key_l = local_gid.long() * num_classes + local_type.long()
        onehot_l = F.one_hot(key_l, kt).float() * lm
        sums = torch.einsum("bnt,bnc->btc", onehot_l, lx)
        counts = onehot_l.sum(dim=1)
        table = sums / counts.clamp(min=1.0)[..., None] * (counts > 0)[..., None]
        key_v = (gid.long() * num_classes + voxel_type.long()).reshape(B, -1)
        out = torch.einsum("brt,btc->brc", F.one_hot(key_v, kt).float(), table)
        return out.reshape((B,) + cells + (C,)).to(local_x.dtype)

    onehot_l = F.one_hot(local_type.long(), num_classes).float() * lm
    sums = torch.einsum("bnt,bnc->btc", onehot_l, lx)
    counts = onehot_l.sum(dim=1)
    if batch_level:
        sums, counts = sums.sum(0, keepdim=True), counts.sum(0, keepdim=True)
    table = sums / counts.clamp(min=1.0)[..., None] * (counts > 0)[..., None]
    table = table.expand(B, -1, -1)
    onehot_v = F.one_hot(voxel_type.reshape(B, -1).long(), num_classes).float()
    out = torch.einsum("brt,btc->brc", onehot_v, table)
    return out.reshape((B,) + cells + (C,)).to(local_x.dtype)
