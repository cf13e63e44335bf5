"""Dense-grid batch layout: buildings on an (F, Y, X) grid of cells.

Voxel graphs are irregular grids (every node has a unique ``location =
(floor, iy, ix)`` and its neighbours are the face-adjacent occupied cells),
so a batch of buildings is laid out as dense blocks::

    x        (B, F, Y, X, 12)  per-cell features
    type     (B, F, Y, X)      program labels
    mask     (B, F, Y, X)      cell occupancy
    dimension(B, F, Y, X, 3)   raw (z, y, x) cell dims

and message passing becomes a 6-point stencil (``ops/stencil.py``).  The
local program graph stays a padded node list: it is only pooled by type.

``GridBatch`` is a plain dataclass of tensors.  ``pack_grid`` places one
building per slot (K=1), which is what the server uses.  A multi-building
batch (K>1) carries a per-cell ``gid`` plane and ``local_gid`` node tags, and
its graph-level fields are (B, K).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..config import Configuration
from .preprocess import LocalGraph, VoxelGraph


@dataclasses.dataclass
class GridBatch:
    """Fixed-shape dense batch of buildings on an (F, Y, X) grid."""

    x: torch.Tensor  # (B, F, Y, X, 12) f32
    type: torch.Tensor  # (B, F, Y, X) int64
    mask: torch.Tensor  # (B, F, Y, X) f32
    dimension: torch.Tensor  # (B, F, Y, X, 3) f32

    local_x: torch.Tensor  # (B, NL, 17) f32
    local_type: torch.Tensor  # (B, NL) int64
    local_mask: torch.Tensor  # (B, NL) f32

    graph_mask: torch.Tensor  # (B,) f32, or (B, K) when multi-packed
    far: torch.Tensor  # (B,) or (B, K)
    site_area: torch.Tensor  # (B,) or (B, K)

    gid: torch.Tensor | None = None  # (B, F, Y, X) int64 building index in slot
    local_gid: torch.Tensor | None = None  # (B, NL) int64

    @property
    def batch_size(self) -> int:
        return self.mask.shape[0]

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        return tuple(self.mask.shape[1:4])

    @property
    def graphs_per_slot(self) -> int:
        """K: max buildings per grid slot (1 in single-building packing)."""
        return 1 if self.gid is None else self.graph_mask.shape[1]

    def to(self, device) -> "GridBatch":
        return GridBatch(
            **{
                f.name: None if getattr(self, f.name) is None else getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
            }
        )

    @classmethod
    def from_numpy(cls, **arrays) -> "GridBatch":
        """Build from numpy arrays (integer planes become int64 tensors)."""
        out = {}
        for name, a in arrays.items():
            if a is None:
                out[name] = None
                continue
            a = np.asarray(a)
            dtype = torch.int64 if np.issubdtype(a.dtype, np.integer) else torch.float32
            out[name] = torch.as_tensor(a).to(dtype)
        return cls(**out)


def pack_grid(
    samples: Sequence[Tuple[LocalGraph, VoxelGraph]],
    cfg: Configuration,
    batch_slots: int | None = None,
) -> GridBatch:
    """Place up to ``batch_slots`` buildings into a dense grid batch (on the CPU)."""
    F, Y, X = cfg.GRID_SHAPE
    B = batch_slots if batch_slots is not None else cfg.GRID_BATCH
    NL = cfg.GRID_LOCAL_NODES
    if len(samples) > B:
        raise ValueError(f"{len(samples)} samples > {B} slots")

    x = np.zeros((B, F, Y, X, 12), np.float32)
    typ = np.zeros((B, F, Y, X), np.int32)
    mask = np.zeros((B, F, Y, X), np.float32)
    dim = np.zeros((B, F, Y, X, 3), np.float32)
    local_x = np.zeros((B, NL, 17), np.float32)
    local_type = np.zeros((B, NL), np.int32)
    local_mask = np.zeros((B, NL), np.float32)
    graph_mask = np.zeros(B, np.float32)
    far = np.zeros(B, np.float32)
    site_area = np.ones(B, np.float32)

    for b, (local, voxel) in enumerate(samples):
        loc = voxel.location
        if not (loc >= 0).all() or not (loc < np.array([F, Y, X])).all():
            raise ValueError(
                f"building {voxel.data_number} exceeds grid shape {cfg.GRID_SHAPE}: "
                f"max location {loc.max(axis=0)}"
            )
        f_, y_, x_ = loc[:, 0], loc[:, 1], loc[:, 2]
        x[b, f_, y_, x_] = voxel.x
        typ[b, f_, y_, x_] = voxel.types
        mask[b, f_, y_, x_] = 1.0
        dim[b, f_, y_, x_] = voxel.dimension

        n = local.x.shape[0]
        if n > NL:
            raise ValueError(f"building {local.data_number}: {n} local nodes > {NL}")
        local_x[b, :n] = local.x
        local_type[b, :n] = local.types
        local_mask[b, :n] = 1.0

        graph_mask[b] = 1.0
        far[b] = voxel.far
        site_area[b] = voxel.site_area

    return GridBatch.from_numpy(
        x=x, type=typ, mask=mask, dimension=dim,
        local_x=local_x, local_type=local_type, local_mask=local_mask,
        graph_mask=graph_mask, far=far, site_area=site_area,
    )
