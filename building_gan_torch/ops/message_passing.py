"""GAT message passing over explicit edge lists (the packed edge-list layout).

Port of ``building_gan_tpu/ops/message_passing.py::gat_aggregate_xla``, the
single-head PyG GATConv aggregation with ``add_self_loops=True``::

    e_ij  = LeakyReLU(a_src[j] + a_dst[i])    for each edge j -> i
    e_ii  = LeakyReLU(a_src[i] + a_dst[i])    the implicit self loop
    alpha = softmax over {e_ij : j in N(i)} and e_ii
    out_i = sum_j alpha_ij h_j + alpha_ii h_i

The self loop is analytic (no extra edges).  ``softmax_aggregate`` is the
softmax-weighted sum that GATConv and GATv2Conv share, with the JAX layers'
arithmetic: the masked max shift, the numerator and denominator summed, the
denominator floored at 1e-16.  The shift carries no gradient (the softmax
does not depend on it), so the gradient penalty's double backward never
differentiates the max.  The JAX package keeps this path as a parity
oracle, not a fast path: here it is plain PyTorch (``index_add_``), on the
CPU and on the card alike.
"""

from __future__ import annotations

import torch

from . import segment as seg
from .stencil import leaky_relu


def softmax_aggregate(
    e: torch.Tensor,  # (E,) edge scores
    e_self: torch.Tensor,  # (N,) self-loop scores
    h_src: torch.Tensor,  # (E, C) the message of each edge
    h_self: torch.Tensor,  # (N, C) the message of each self loop
    dst: torch.Tensor,  # (E,) edge destinations
    edge_mask: torch.Tensor,  # (E,) 1 real, 0 padding
) -> torch.Tensor:
    """``out_i = sum_j alpha_ij h_src[j] + alpha_ii h_self[i]``, alpha the softmax over node
    i's real in-edges and its self loop."""
    n = h_self.shape[0]
    with torch.no_grad():
        m = torch.maximum(seg.segment_max(e, dst, n, mask=edge_mask), e_self)
    exp_e = torch.exp(e - seg.gather(m, dst)) * edge_mask  # (E,)
    exp_self = torch.exp(e_self - m)  # (N,)
    denom = seg.segment_sum(exp_e, dst, n) + exp_self
    num = seg.segment_sum(exp_e[:, None] * h_src, dst, n) + exp_self[:, None] * h_self
    return num / denom.clamp(min=1e-16)[:, None]


def gat_aggregate(
    h: torch.Tensor,  # (N, C) transformed node features
    a_src: torch.Tensor,  # (N,) per-node source attention scalar
    a_dst: torch.Tensor,  # (N,) per-node destination attention scalar
    src: torch.Tensor,  # (E,) edge sources
    dst: torch.Tensor,  # (E,) edge destinations
    edge_mask: torch.Tensor,  # (E,) 1 real, 0 padding
    negative_slope: float = 0.2,
) -> torch.Tensor:
    e = leaky_relu(seg.gather(a_src, src) + seg.gather(a_dst, dst), negative_slope)  # (E,)
    e_self = leaky_relu(a_src + a_dst, negative_slope)  # (N,)
    return softmax_aggregate(e, e_self, seg.gather(h, src), h, dst, edge_mask)
