"""Type-matched pooling on the packed edge-list layout.

Port of ``building_gan_tpu/ops/pooling.py::type_matched_pooling`` (per
graph): every voxel node receives the mean feature of its graph's program
nodes of the same type (reference ``models.py:122-129``), through one
segment mean keyed on ``graph_id * NUM_CLASSES + type``.  Padded nodes carry
graph id G, a dummy segment.  A (graph, type) with no program node gives
zeros.  ``batch_level=True`` is the reference's own merged-batch mean (quirk
Q1): every voxel node receives the mean of all the pack's program nodes of
its type, across graphs.
"""

from __future__ import annotations

import torch

from ..config import NUM_CLASSES
from . import segment as seg


def type_matched_pooling(
    local_x: torch.Tensor,  # (NL, C) program node features
    local_type: torch.Tensor,  # (NL,)
    local_graph_id: torch.Tensor,  # (NL,); padded nodes -> num_graphs
    local_mask: torch.Tensor,  # (NL,)
    voxel_type: torch.Tensor,  # (NV,)
    voxel_graph_id: torch.Tensor,  # (NV,); padded nodes -> num_graphs
    num_graphs: int,  # graph slots G (the padding is segment G)
    batch_level: bool = False,
) -> torch.Tensor:
    """(NV, C) matched features, in ``local_x``'s dtype."""
    if batch_level:
        sums = seg.segment_sum(local_x * local_mask[:, None], local_type, NUM_CLASSES)
        counts = seg.segment_sum(local_mask, local_type, NUM_CLASSES)
        means = sums / counts.clamp(min=1.0)[:, None] * (counts > 0).to(local_x.dtype)[:, None]
        return seg.gather(means, voxel_type)
    n_seg = (num_graphs + 1) * NUM_CLASSES
    local_seg = local_graph_id * NUM_CLASSES + local_type
    sums = seg.segment_sum(local_x * local_mask[:, None], local_seg, n_seg)
    counts = seg.segment_sum(local_mask, local_seg, n_seg)
    means = sums / counts.clamp(min=1.0)[:, None] * (counts > 0).to(local_x.dtype)[:, None]
    return seg.gather(means, voxel_graph_id * NUM_CLASSES + voxel_type)
