"""Fixed-budget packing of irregular building graphs: the packed edge-list layout.

Port of ``building_gan_tpu/data/batching.py``.  The reference merges a list
of graphs with PyG ``Batch.from_data_list`` (``building_gan/src/data.py:
156-163``); here up to ``PACK_GRAPHS`` buildings go into one pack, padded to
exactly ``PACK_LOCAL_NODES`` / ``PACK_VOXEL_NODES`` nodes and
``PACK_LOCAL_EDGES`` / ``PACK_VOXEL_EDGES`` edges, so every pack of a run has
one shape.  This is the layout for buildings that do not fit ``GRID_SHAPE``.

Padding, as in the JAX package:

- padded nodes carry ``graph_id == PACK_GRAPHS`` (a dummy segment) and mask 0;
- padded edges point at node 0 with ``edge_mask`` 0;
- edges are sorted by destination (stable), so a node's incoming edges are one run.

The packing loop is the JAX package's, on numpy; ``PackedBatch`` holds the
result as CPU tensors (integer arrays as int64), moved by ``.to(device)``
like the grid layout's ``GridBatch``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..config import Configuration
from ..ops.segment import segment_sum
from .preprocess import LocalGraph, VoxelGraph


@dataclasses.dataclass
class PackedBatch:
    """One fixed-shape pack of up to G buildings; every tensor is padded."""

    # program graph (17 node features, reference data.py:24-33)
    local_x: torch.Tensor  # (NL, 17) f32
    local_type: torch.Tensor  # (NL,) int64
    local_graph_id: torch.Tensor  # (NL,) int64; padded -> G
    local_mask: torch.Tensor  # (NL,) f32
    local_src: torch.Tensor  # (EL,) int64
    local_dst: torch.Tensor  # (EL,) int64
    local_edge_mask: torch.Tensor  # (EL,) f32

    # voxel graph (12 node features, reference data.py:56-64)
    voxel_x: torch.Tensor  # (NV, 12) f32
    voxel_type: torch.Tensor  # (NV,) int64
    voxel_graph_id: torch.Tensor  # (NV,) int64; padded -> G
    voxel_mask: torch.Tensor  # (NV,) f32
    voxel_src: torch.Tensor  # (EV,) int64
    voxel_dst: torch.Tensor  # (EV,) int64
    voxel_edge_mask: torch.Tensor  # (EV,) f32
    voxel_dimension: torch.Tensor  # (NV, 3) f32: raw (z, y, x) cell dims, for FAR

    # per graph
    graph_mask: torch.Tensor  # (G,) f32
    far: torch.Tensor  # (G,) f32
    site_area: torch.Tensor  # (G,) f32

    @property
    def num_graph_slots(self) -> int:
        return self.graph_mask.shape[-1]

    @property
    def num_voxel_slots(self) -> int:
        return self.voxel_mask.shape[-1]

    # the accessors a ``GridBatch`` shares, so losses, metrics and steps need no branch
    @property
    def cell_type(self) -> torch.Tensor:
        return self.voxel_type

    @property
    def cell_mask(self) -> torch.Tensor:
        return self.voxel_mask

    @property
    def cell_area(self) -> torch.Tensor:
        """Each voxel's (y, x) floor area, from its raw dimensions."""
        return self.voxel_dimension[:, 1] * self.voxel_dimension[:, 2]

    def per_graph_sum(self, values: torch.Tensor) -> torch.Tensor:
        """Sum per-voxel ``values`` per building: (G,), the padding's segment G dropped."""
        g = self.num_graph_slots
        return segment_sum(values, self.voxel_graph_id, g + 1)[:g]

    @property
    def metric_graphs(self) -> dict:
        """How ``compute_metrics`` finds the buildings: by voxel graph id."""
        return {"graph_id": self.voxel_graph_id}

    def to(self, device, non_blocking: bool = False) -> "PackedBatch":
        return PackedBatch(**{f.name: getattr(self, f.name).to(device, non_blocking=non_blocking)
                              for f in dataclasses.fields(self)})

    @classmethod
    def from_numpy(cls, **arrays) -> "PackedBatch":
        """Build from numpy arrays (integer arrays become int64 tensors, the rest f32)."""
        out = {}
        for name, a in arrays.items():
            a = np.asarray(a)
            dtype = torch.int64 if np.issubdtype(a.dtype, np.integer) else torch.float32
            out[name] = torch.as_tensor(a).to(dtype)
        return cls(**out)


def _fits(counts: Tuple[int, ...], budgets: Tuple[int, ...]) -> bool:
    return all(c <= b for c, b in zip(counts, budgets))


def pack_budgets(cfg: Configuration) -> Tuple[int, int, int, int, int]:
    """(graphs, local nodes, local edges, voxel nodes, voxel edges) a pack may hold."""
    return (cfg.PACK_GRAPHS, cfg.PACK_LOCAL_NODES, cfg.PACK_LOCAL_EDGES, cfg.PACK_VOXEL_NODES,
            cfg.PACK_VOXEL_EDGES)


def pack_need(local: LocalGraph, voxel: VoxelGraph) -> Tuple[int, int, int, int, int]:
    """What one building takes of each budget, in ``pack_budgets``' order."""
    return (1, local.x.shape[0], local.edge_index.shape[1], voxel.x.shape[0],
            voxel.edge_index.shape[1])


def pack_graphs(
    samples: Sequence[Tuple[LocalGraph, VoxelGraph]],
    cfg: Configuration,
) -> List[PackedBatch]:
    """Greedy first-fit packing in the given order: a new pack when the next building
    does not fit.  A building over a budget on its own raises."""
    budgets = pack_budgets(cfg)
    packs: List[List[Tuple[LocalGraph, VoxelGraph]]] = []
    cur: List[Tuple[LocalGraph, VoxelGraph]] = []
    cur_counts = (0, 0, 0, 0, 0)
    for local, voxel in samples:
        need = pack_need(local, voxel)
        if not _fits(need, budgets):
            raise ValueError(
                f"building {voxel.data_number} exceeds pack budgets: need={need}, budgets={budgets}"
            )
        new_counts = tuple(c + n for c, n in zip(cur_counts, need))
        if _fits(new_counts, budgets):
            cur.append((local, voxel))
            cur_counts = new_counts
        else:
            packs.append(cur)
            cur = [(local, voxel)]
            cur_counts = need
    if cur:
        packs.append(cur)
    return [pack_one(p, cfg) for p in packs]


def _pad_edges(edges: List[np.ndarray], budget: int):
    """Concatenated (2, E) edges sorted by destination (stable), padded to ``budget``."""
    e = np.concatenate(edges, axis=1) if edges else np.zeros((2, 0), dtype=np.int32)
    e = e[:, np.argsort(e[1], kind="stable")]
    ne = e.shape[1]
    src = np.zeros(budget, dtype=np.int32)
    dst = np.zeros(budget, dtype=np.int32)
    mask = np.zeros(budget, dtype=np.float32)
    src[:ne] = e[0]
    dst[:ne] = e[1]
    mask[:ne] = 1.0
    return src, dst, mask


def pack_one(samples: Sequence[Tuple[LocalGraph, VoxelGraph]], cfg: Configuration) -> PackedBatch:
    """One ``PackedBatch`` from a list of (local, voxel) samples that fits the budgets."""
    G = cfg.PACK_GRAPHS
    NL, EL = cfg.PACK_LOCAL_NODES, cfg.PACK_LOCAL_EDGES
    NV, EV = cfg.PACK_VOXEL_NODES, cfg.PACK_VOXEL_EDGES
    if len(samples) > G:
        raise ValueError(f"{len(samples)} buildings for a pack of {G}")

    local_x = np.zeros((NL, samples[0][0].x.shape[1]), dtype=np.float32)
    local_type = np.zeros(NL, dtype=np.int32)
    local_graph_id = np.full(NL, G, dtype=np.int32)
    local_mask = np.zeros(NL, dtype=np.float32)
    local_edges = []

    voxel_x = np.zeros((NV, samples[0][1].x.shape[1]), dtype=np.float32)
    voxel_type = np.zeros(NV, dtype=np.int32)
    voxel_graph_id = np.full(NV, G, dtype=np.int32)
    voxel_mask = np.zeros(NV, dtype=np.float32)
    voxel_dimension = np.zeros((NV, 3), dtype=np.float32)
    voxel_edges = []

    graph_mask = np.zeros(G, dtype=np.float32)
    far = np.zeros(G, dtype=np.float32)
    site_area = np.ones(G, dtype=np.float32)  # 1 keeps the FAR division benign on padding

    nl = nv = 0
    for gi, (local, voxel) in enumerate(samples):
        n = local.x.shape[0]
        local_x[nl: nl + n] = local.x
        local_type[nl: nl + n] = local.types
        local_graph_id[nl: nl + n] = gi
        local_mask[nl: nl + n] = 1.0
        if local.edge_index.shape[1]:
            local_edges.append(local.edge_index + nl)
        nl += n

        m = voxel.x.shape[0]
        voxel_x[nv: nv + m] = voxel.x
        voxel_type[nv: nv + m] = voxel.types
        voxel_graph_id[nv: nv + m] = gi
        voxel_mask[nv: nv + m] = 1.0
        voxel_dimension[nv: nv + m] = voxel.dimension
        if voxel.edge_index.shape[1]:
            voxel_edges.append(voxel.edge_index + nv)
        nv += m

        graph_mask[gi] = 1.0
        far[gi] = voxel.far
        site_area[gi] = voxel.site_area

    l_src, l_dst, l_emask = _pad_edges(local_edges, EL)
    v_src, v_dst, v_emask = _pad_edges(voxel_edges, EV)
    return PackedBatch.from_numpy(
        local_x=local_x, local_type=local_type, local_graph_id=local_graph_id,
        local_mask=local_mask, local_src=l_src, local_dst=l_dst, local_edge_mask=l_emask,
        voxel_x=voxel_x, voxel_type=voxel_type, voxel_graph_id=voxel_graph_id,
        voxel_mask=voxel_mask, voxel_src=v_src, voxel_dst=v_dst, voxel_edge_mask=v_emask,
        voxel_dimension=voxel_dimension, graph_mask=graph_mask, far=far, site_area=site_area,
    )


def stack_packs(packs: Sequence[PackedBatch]) -> PackedBatch:
    """Stack packs on a new leading axis (one pack a device)."""
    return PackedBatch(**{f.name: torch.stack([getattr(p, f.name) for p in packs])
                          for f in dataclasses.fields(PackedBatch)})
