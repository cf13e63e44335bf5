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
building per slot (K=1), which is what the server uses.  ``pack_grid_multi``
and ``pack_grid_multi_from_slots`` (the 3D first-fit-decreasing packer the
train step uses) place up to K buildings a slot: such a batch carries a
per-cell ``gid`` plane and ``local_gid`` node tags, and its graph-level
fields are (B, K).  ``grid_compatible`` checks that a building's edge list is
its cells' face adjacency; ``stack_grid_batches`` stacks batches on a new
leading (device) axis.
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

    # the accessors a ``PackedBatch`` shares, so losses, metrics and steps need no branch
    @property
    def cell_type(self) -> torch.Tensor:
        return self.type

    @property
    def cell_mask(self) -> torch.Tensor:
        return self.mask

    @property
    def cell_area(self) -> torch.Tensor:
        """Each cell's (y, x) floor area, from its raw dimensions."""
        return self.dimension[..., 1] * self.dimension[..., 2]

    def per_graph_sum(self, values: torch.Tensor) -> torch.Tensor:
        """Sum per-cell ``values`` per building: (B,), or (B, K) when multi-packed."""
        if self.gid is not None and self.graphs_per_slot > 1:
            oh = torch.nn.functional.one_hot(self.gid.long(), self.graphs_per_slot)
            return torch.einsum("bfyxk,bfyx->bk", oh.to(values.dtype), values)
        return values.sum((1, 2, 3))

    @property
    def metric_graphs(self) -> dict:
        """How ``compute_metrics`` finds the buildings: per slot, or per (slot, gid)."""
        return {"gid": self.gid, "num_graphs_per_slot": self.graphs_per_slot}

    def to(self, device, non_blocking: bool = False) -> "GridBatch":
        return GridBatch(
            **{
                f.name: None if getattr(self, f.name) is None
                else getattr(self, f.name).to(device, non_blocking=non_blocking)
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


def grid_compatible(voxel: VoxelGraph, grid_shape: Tuple[int, int, int]) -> bool:
    """True iff locations are unique, within shape, and the edge list equals
    the face adjacency of the occupied cells."""
    loc = voxel.location
    F, Y, X = grid_shape
    if loc.shape[0] == 0:
        return False
    if loc.min() < 0 or (loc >= np.array([F, Y, X])).any():
        return False
    keys = set(map(tuple, loc.tolist()))
    if len(keys) != loc.shape[0]:
        return False
    index = {tuple(l): i for i, l in enumerate(loc.tolist())}
    implied = set()
    for i, (f, y, x) in enumerate(loc.tolist()):
        for df, dy, dx in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)):
            nb = (f + df, y + dy, x + dx)
            if nb in index:
                implied.add((i, index[nb]))
    actual = set(map(tuple, voxel.edge_index.T.tolist()))
    return implied == actual


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


class _Slot:
    """One grid slot being filled by the 3D first-fit packer.

    Two packing modes (``Configuration.GRID_PACK_MODE``):

    - ``"bbox_gap"``: occupancy is tracked on a grid padded by 1 on the
      positive faces; each placement reserves its bounding box plus a 1-cell
      margin on the +f/+y/+x sides, so two buildings never touch.
    - ``"cell"``: occupancy is the buildings' actual cells, no margin:
      buildings may touch, which the gid-aware stencils and kernels allow (a
      face between two gids is not an edge).
    """

    def __init__(self, shape: Tuple[int, int, int], mode: str = "bbox_gap"):
        self.shape = shape
        self.mode = mode
        if mode == "cell":
            self.occ = np.zeros(shape, bool)
        else:
            self.occ = np.zeros((shape[0] + 1, shape[1] + 1, shape[2] + 1), bool)
        self.placed: list = []  # (sample index, offset (f0, y0, x0))
        self.local_used = 0  # program-graph nodes consumed in this slot

    def try_place_cells(self, pat: np.ndarray) -> Tuple[int, int, int] | None:
        """First anchor where the building's actual cells hit no occupied cell.

        The conflicts are counted in int32.  The JAX package counts them in uint8
        (``building_gan_tpu/data/grid.py:193``), where 256 conflicting cells wrap
        to 0 and a building is placed over another one; real-scale buildings
        (up to 1584 cells) reach that.
        """
        F, Y, X = self.shape
        pf, py, px = pat.shape
        if pf > F or py > Y or px > X:
            return None
        win = np.lib.stride_tricks.sliding_window_view(self.occ, pat.shape)
        conflicts = np.einsum(
            "abcijk,ijk->abc", win.astype(np.int32), pat.astype(np.int32), optimize=True
        )
        anchors = np.argwhere(conflicts == 0)
        if anchors.size == 0:
            return None
        f0, y0, x0 = (int(v) for v in anchors[0])
        self.occ[f0 : f0 + pf, y0 : y0 + py, x0 : x0 + px] |= pat
        return f0, y0, x0

    def try_place(self, ext: Tuple[int, int, int]) -> Tuple[int, int, int] | None:
        """First anchor (lexicographic f, y, x) whose ext+1 window is empty."""
        F, Y, X = self.shape
        ef, ey, ex = ext
        if ef > F or ey > Y or ex > X:
            return None
        # summed-area table over the padded occupancy grid
        s = np.zeros((F + 2, Y + 2, X + 2), np.int32)
        s[1:, 1:, 1:] = self.occ.cumsum(0).cumsum(1).cumsum(2)
        wf, wy, wx = ef + 1, ey + 1, ex + 1
        nf, ny, nx = F - ef + 1, Y - ey + 1, X - ex + 1
        win = (
            s[wf : wf + nf, wy : wy + ny, wx : wx + nx]
            - s[:nf, wy : wy + ny, wx : wx + nx]
            - s[wf : wf + nf, :ny, wx : wx + nx]
            - s[wf : wf + nf, wy : wy + ny, :nx]
            + s[:nf, :ny, wx : wx + nx]
            + s[:nf, wy : wy + ny, :nx]
            + s[wf : wf + nf, :ny, :nx]
            - s[:nf, :ny, :nx]
        )
        anchors = np.argwhere(win == 0)
        if anchors.size == 0:
            return None
        f0, y0, x0 = (int(v) for v in anchors[0])
        self.occ[f0 : f0 + wf, y0 : y0 + wy, x0 : x0 + wx] = True
        return f0, y0, x0


def _cell_pattern(voxel: VoxelGraph, ext: Tuple[int, int, int]) -> np.ndarray:
    pat = np.zeros(ext, bool)
    loc = voxel.location
    pat[loc[:, 0], loc[:, 1], loc[:, 2]] = True
    return pat


def _first_fit_decreasing(
    samples: Sequence[Tuple[LocalGraph, VoxelGraph]],
    shape: Tuple[int, int, int],
    K: int,
    max_slots: int | None = None,
    local_budget: int | None = None,
    mode: str = "bbox_gap",
) -> list | None:
    """First-fit-decreasing 3D packing (by bounding-box volume); opens slots as needed.

    ``local_budget`` caps the program-graph nodes per slot (the packed
    ``GRID_LOCAL_NODES`` width): a slot that cannot absorb a building's local
    nodes is skipped.  Returns the filled ``_Slot``s, or None if more than
    ``max_slots`` would be needed.
    """
    order = sorted(
        range(len(samples)),
        key=lambda i: -int(np.prod(samples[i][1].location.max(axis=0) + 1)),
    )
    slots: list[_Slot] = []
    for i in order:
        ext = tuple(int(e) for e in samples[i][1].location.max(axis=0) + 1)
        pat = _cell_pattern(samples[i][1], ext) if mode == "cell" else None
        nl = samples[i][0].x.shape[0]
        if local_budget is not None and nl > local_budget:
            raise ValueError(
                f"building {samples[i][1].data_number}: {nl} local nodes exceed "
                f"GRID_LOCAL_NODES={local_budget}"
            )
        placed = False
        for slot in slots:
            if len(slot.placed) >= K:
                continue
            if local_budget is not None and slot.local_used + nl > local_budget:
                continue
            off = slot.try_place_cells(pat) if mode == "cell" else slot.try_place(ext)
            if off is not None:
                slot.placed.append((i, off))
                slot.local_used += nl
                placed = True
                break
        if not placed:
            if max_slots is not None and len(slots) >= max_slots:
                return None
            slot = _Slot(shape, mode=mode)
            off = slot.try_place_cells(pat) if mode == "cell" else slot.try_place(ext)
            if off is None:
                raise ValueError(f"building ext {ext} exceeds grid shape {shape}")
            slot.placed.append((i, off))
            slot.local_used += nl
            slots.append(slot)
    return slots


def plan_packing_slots(
    samples: Sequence[Tuple[LocalGraph, VoxelGraph]], cfg: Configuration
) -> list:
    """Greedy packing plan over an unbounded slot count (a list of ``_Slot``).

    Slice it into windows of ``GRID_BATCH`` slots and fill each with
    :func:`pack_grid_multi_from_slots` for fixed-shape batches.
    """
    return _first_fit_decreasing(
        samples, cfg.GRID_SHAPE, cfg.GRID_SLOT_GRAPHS,
        local_budget=cfg.GRID_LOCAL_NODES, mode=cfg.GRID_PACK_MODE,
    )


def plan_packing(
    samples: Sequence[Tuple[LocalGraph, VoxelGraph]], cfg: Configuration
) -> list[list[int]]:
    """Index view of :func:`plan_packing_slots`: sample indices per slot."""
    return [[i for i, _ in s.placed] for s in plan_packing_slots(samples, cfg)]


def pack_grid_multi(
    samples: Sequence[Tuple[LocalGraph, VoxelGraph]],
    cfg: Configuration,
    batch_slots: int | None = None,
    graphs_per_slot: int | None = None,
) -> GridBatch:
    """3D-bin-pack buildings into grid slots, up to K buildings a slot (on the CPU).

    Placement follows ``cfg.GRID_PACK_MODE`` (see ``_Slot``).  Raises if the
    buildings do not fit in ``batch_slots`` slots.  Features keep their
    per-building values; only the placement indices are offset.
    """
    F, Y, X = cfg.GRID_SHAPE
    B = batch_slots if batch_slots is not None else cfg.GRID_BATCH
    K = graphs_per_slot if graphs_per_slot is not None else cfg.GRID_SLOT_GRAPHS
    slots = _first_fit_decreasing(
        samples, (F, Y, X), K, max_slots=B, local_budget=cfg.GRID_LOCAL_NODES,
        mode=cfg.GRID_PACK_MODE,
    )
    if slots is None:
        raise ValueError(
            f"pack_grid_multi: {len(samples)} buildings do not fit "
            f"in {B} slots of {cfg.GRID_SHAPE} with K={K}"
        )
    return pack_grid_multi_from_slots(samples, slots, cfg, batch_slots=B, graphs_per_slot=K)


def pack_grid_multi_from_slots(
    samples: Sequence[Tuple[LocalGraph, VoxelGraph]],
    slots: Sequence[_Slot],
    cfg: Configuration,
    batch_slots: int | None = None,
    graphs_per_slot: int | None = None,
) -> GridBatch:
    """Fill a K > 1 ``GridBatch`` (gid and local_gid planes) from slot placements."""
    F, Y, X = cfg.GRID_SHAPE
    B = batch_slots if batch_slots is not None else cfg.GRID_BATCH
    K = graphs_per_slot if graphs_per_slot is not None else cfg.GRID_SLOT_GRAPHS
    NL = cfg.GRID_LOCAL_NODES
    if len(slots) > B:
        raise ValueError(f"{len(slots)} planned slots exceed {B} batch slots")
    slots = list(slots) + [_Slot((F, Y, X)) for _ in range(B - len(slots))]

    x = np.zeros((B, F, Y, X, 12), np.float32)
    typ = np.zeros((B, F, Y, X), np.int32)
    mask = np.zeros((B, F, Y, X), np.float32)
    dim = np.zeros((B, F, Y, X, 3), np.float32)
    gid = np.zeros((B, F, Y, X), np.int32)
    local_x = np.zeros((B, NL, 17), np.float32)
    local_type = np.zeros((B, NL), np.int32)
    local_mask = np.zeros((B, NL), np.float32)
    local_gid = np.zeros((B, NL), np.int32)
    graph_mask = np.zeros((B, K), np.float32)
    far = np.zeros((B, K), np.float32)
    site_area = np.ones((B, K), np.float32)

    for b, slot in enumerate(slots):
        nl_used = 0
        for k, (i, (f0, y0, x0)) in enumerate(slot.placed):
            local, voxel = samples[i]
            loc = voxel.location
            f_, y_, x_ = loc[:, 0] + f0, loc[:, 1] + y0, loc[:, 2] + x0
            x[b, f_, y_, x_] = voxel.x
            typ[b, f_, y_, x_] = voxel.types
            mask[b, f_, y_, x_] = 1.0
            dim[b, f_, y_, x_] = voxel.dimension
            gid[b, f_, y_, x_] = k

            n = local.x.shape[0]
            if nl_used + n > NL:
                raise ValueError(
                    f"slot {b}: local nodes overflow ({nl_used}+{n} > {NL}); "
                    "raise GRID_LOCAL_NODES for multi-building slots"
                )
            local_x[b, nl_used : nl_used + n] = local.x
            local_type[b, nl_used : nl_used + n] = local.types
            local_mask[b, nl_used : nl_used + n] = 1.0
            local_gid[b, nl_used : nl_used + n] = k
            nl_used += n

            graph_mask[b, k] = 1.0
            far[b, k] = voxel.far
            site_area[b, k] = voxel.site_area

    return GridBatch.from_numpy(
        x=x, type=typ, mask=mask, dimension=dim,
        local_x=local_x, local_type=local_type, local_mask=local_mask,
        graph_mask=graph_mask, far=far, site_area=site_area,
        gid=gid, local_gid=local_gid,
    )


def stack_grid_batches(batches: Sequence[GridBatch]) -> GridBatch:
    """Stack batches of one shape on a new leading axis (one batch a device)."""
    first = batches[0]
    return GridBatch(**{
        f.name: None if getattr(first, f.name) is None
        else torch.stack([getattr(b, f.name) for b in batches])
        for f in dataclasses.fields(GridBatch)
    })
