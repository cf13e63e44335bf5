"""Ingest the reference's processed ``.pt`` dataset into the port.

Port of ``building_gan_tpu/data/ingest.py``.  The reference pipeline saves
each building as two pickled class instances (``{num}_local.pt`` /
``{num}_voxel.pt`` — `building_gan/src/data.py:457-461`,
``torch.save(LocalGraphData(...))``).  A user holding that processed dataset
can drop it straight into the port: :func:`convert_reference_processed`
rewrites every pair as the NPZ schema (``data/preprocess.py::save_local`` /
``save_voxel``), after which ``data/pipeline.py::GraphDataset`` loads them.

Unpickling does NOT require the reference package: stub classes are
registered under the pickled module paths, and torch restores instance
``__dict__``s onto them.
"""

from __future__ import annotations

import os
import sys
import types
from typing import Tuple

import numpy as np
import torch

from .preprocess import LocalGraph, VoxelGraph, save_local, save_voxel

# module paths the reference classes may have been pickled under
_REF_MODULE_PATHS = ("building_gan.src.data", "src.data")


class _RefStub:
    """Attribute bag standing in for the reference's pickled data classes."""

    def __init__(self, *args, **kwargs):  # never called by pickle
        pass


def _install_reference_stubs() -> None:
    """Register LocalGraphData/VoxelGraphData stubs so torch.load resolves
    the pickled globals without the reference package installed."""
    for path in _REF_MODULE_PATHS:
        parts = path.split(".")
        for i in range(1, len(parts) + 1):
            name = ".".join(parts[:i])
            if name not in sys.modules:
                sys.modules[name] = types.ModuleType(name)
        mod = sys.modules[path]
        for cls_name in ("LocalGraphData", "VoxelGraphData"):
            if not hasattr(mod, cls_name):
                setattr(mod, cls_name, type(cls_name, (_RefStub,), {}))


def _np(t, dtype=None):
    arr = t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)
    return arr.astype(dtype) if dtype is not None else arr


def load_reference_pt_pair(local_path: str, voxel_path: str) -> Tuple[LocalGraph, VoxelGraph]:
    """Load one reference ``(_local.pt, _voxel.pt)`` pair into the port's containers.

    Field mapping mirrors the reference constructors (`data.py:16-77`):
    ``LocalGraphData.x`` columns are [onehot(7) | ratio*onehot(7) | far |
    floor_norm | site_norm]; ``VoxelGraphData.x`` columns are
    [coord(3)/40 | dim(3)/10 | loc(3)/40 | far | floor_norm | site_norm].
    ``far`` is recovered from its x column (the reference stores it only
    there).
    """
    _install_reference_stubs()
    ref_l = torch.load(local_path, map_location="cpu", weights_only=False)
    ref_v = torch.load(voxel_path, map_location="cpu", weights_only=False)

    lx = _np(ref_l.x, np.float32)
    local = LocalGraph(
        x=lx,
        types=_np(ref_l.local_graph_types, np.int32),
        types_onehot=_np(ref_l.local_graph_types_onehot, np.float32),
        type_ratio_per_node=_np(ref_l.local_graph_type_ratio_per_node, np.float32),
        edge_index=_np(ref_l.edge_index, np.int32),
        floor_levels=_np(ref_l.local_graph_floor_levels, np.int32),
        center=_np(ref_l.local_graph_center, np.float32),
        type_ids=_np(ref_l.local_graph_type_ids, np.int32),
        far=float(lx[0, 14]) if lx.shape[0] else 0.0,
        site_area=float(_np(ref_l.site_area).reshape(-1)[0]),
        data_number=str(ref_l.data_number),
    )

    vx = _np(ref_v.x, np.float32)
    voxel = VoxelGraph(
        x=vx,
        types=_np(ref_v.voxel_graph_types, np.int32),
        types_onehot=_np(ref_v.voxel_graph_types_onehot, np.float32),
        edge_index=_np(ref_v.edge_index, np.int32),
        floor_levels=_np(ref_v.voxel_graph_floor_levels, np.int32),
        coordinate=_np(ref_v.voxel_graph_node_coordinate, np.float32),
        dimension=_np(ref_v.voxel_graph_node_dimension, np.float32),
        location=_np(ref_v.voxel_graph_location, np.int32),
        node_ratio=_np(ref_v.voxel_graph_node_ratio, np.float32),
        far=float(vx[0, 9]) if vx.shape[0] else 0.0,
        site_area=float(_np(ref_v.site_area).reshape(-1)[0]),
        data_number=str(ref_v.data_number),
    )
    assert local.data_number == voxel.data_number
    return local, voxel


def convert_reference_processed(
    src_dir: str,
    dst_dir: str,
    local_suffix: str = "_local.pt",
    voxel_suffix: str = "_voxel.pt",
    compress: bool = False,
) -> int:
    """Convert a directory of reference ``.pt`` pairs to the port's NPZ layout.

    Returns the number of converted buildings.
    """
    locals_ = sorted(
        (f for f in os.listdir(src_dir) if f.endswith(local_suffix)),
        key=lambda f: int(f.split("_")[0]),
    )
    os.makedirs(dst_dir, exist_ok=True)
    n = 0
    for lf in locals_:
        num = lf[: -len(local_suffix)]
        vf = f"{num}{voxel_suffix}"
        vpath = os.path.join(src_dir, vf)
        if not os.path.exists(vpath):
            raise FileNotFoundError(f"missing voxel pair for {lf}: {vf}")
        local, voxel = load_reference_pt_pair(os.path.join(src_dir, lf), vpath)
        save_local(os.path.join(dst_dir, f"{num}_local.npz"), local, compress=compress)
        save_voxel(os.path.join(dst_dir, f"{num}_voxel.npz"), voxel, compress=compress)
        n += 1
    return n
