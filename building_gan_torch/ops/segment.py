"""Masked segment ops over padded graph packs.

Port of ``building_gan_tpu/ops/segment.py``: the scatter primitives of the
packed edge-list layout, with a fixed ``num_segments`` and padding handled by
masks.  Sums are ``index_add_`` (atomics on CUDA, so a sum is not bit
reproducible there; its accumulation dtype is the values'), the max is
``scatter_reduce("amax")``, and a gather by index is ``gather``.

Conventions, as in the JAX package:

- edges are 1-D ``src`` / ``dst`` index vectors (int64) with a float
  ``edge_mask`` (1 real, 0 padding); padded edges point at node 0 and their
  contributions are multiplied by the mask, or floored at ``NEG_INF`` for the
  max;
- padded nodes live in a dummy segment (graph id G), or are masked after the op.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # a finite stand-in for -inf: a masked or empty segment's max stays finite


def _expand(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return w.reshape(w.shape + (1,) * (like.dim() - w.dim()))


def gather(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``values[index]`` along the first axis, as ``index_select``.

    Its backward is an ``index_add_``.  The backward of ``values[index]`` is an
    accumulating ``index_put_``, whose CUDA kernel sorts the indices and walks a
    run of equal indices serially; every padding edge of a pack points at node
    0, so that run held ~150k edges of a pack at the default budgets (an edge
    step took 7-19 s on an H100, chip_smoke.py phase 10).
    """
    return values.index_select(0, index)


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sum the rows of ``values`` into ``num_segments`` buckets, in ``values``' dtype."""
    out = values.new_zeros((num_segments,) + tuple(values.shape[1:]))
    return out.index_add(0, segment_ids, values)


def segment_mean(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Weighted mean per segment; an empty segment gives 0, not NaN."""
    if weights is not None:
        values = values * _expand(weights, values)
        counts = segment_sum(weights, segment_ids, num_segments)
    else:
        counts = segment_sum(values.new_ones(values.shape[0]), segment_ids, num_segments)
    sums = segment_sum(values, segment_ids, num_segments)
    return sums / _expand(counts.clamp(min=1.0), sums)


def segment_max(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Max per segment; masked entries take no part, and a segment with none gives ``NEG_INF``."""
    if mask is not None:
        values = torch.where(_expand(mask, values) > 0, values, torch.full_like(values, NEG_INF))
    out = values.new_full((num_segments,) + tuple(values.shape[1:]), NEG_INF)
    index = _expand(segment_ids, values).expand_as(values)
    return out.scatter_reduce(0, index, values, reduce="amax", include_self=True)

