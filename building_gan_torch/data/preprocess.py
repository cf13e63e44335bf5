"""Building JSON triplet -> numpy arrays (the port's own copy).

The same feature layout as ``building_gan_tpu/data/preprocess.py`` and the
reference preprocessor: 17-dim local node features
``[types_onehot(7), types_onehot * global_type_ratio(7), far, floor/10,
site_area/1600]`` and 12-dim voxel features ``[coordinate/42(3),
dimension/11(3), location/11(3), far, floor/10, site_area/1600]``; legacy
VOID_OLD labels become VOID; edge lists sorted by (src, dst).

The NPZ files use the JAX package's keys, so a file written by either
package loads in the other.  ``create_dataset`` parses the JSON with the
standard library (the JAX package's native C++ parser is not ported).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Tuple

import numpy as np

from ..config import NUM_CLASSES, VOID, VOID_OLD, Configuration


@dataclasses.dataclass
class LocalGraph:
    """Program graph of one building (reference LocalGraphData, data.py:16-45)."""

    x: np.ndarray  # (N, 17) float32
    types: np.ndarray  # (N,) int32
    types_onehot: np.ndarray  # (N, 7) float32
    type_ratio_per_node: np.ndarray  # (N, 7) float32
    edge_index: np.ndarray  # (2, E) int32 — [src; dst]
    floor_levels: np.ndarray  # (N,) int32
    center: np.ndarray  # (N, 3) float32 (z, y, x)
    type_ids: np.ndarray  # (N,) int32
    far: float
    site_area: float
    data_number: str


@dataclasses.dataclass
class VoxelGraph:
    """Voxel graph of one building (reference VoxelGraphData, data.py:48-77)."""

    x: np.ndarray  # (N, 12) float32
    types: np.ndarray  # (N,) int32
    types_onehot: np.ndarray  # (N, 7) float32
    edge_index: np.ndarray  # (2, E) int32
    floor_levels: np.ndarray  # (N,) int32
    coordinate: np.ndarray  # (N, 3) float32 (z, y, x)
    dimension: np.ndarray  # (N, 3) float32 (z, y, x)
    location: np.ndarray  # (N, 3) int32 (floor, iy, ix)
    node_ratio: np.ndarray  # (N, 1) float32 — dataset ratio of this node's type
    far: float
    site_area: float
    data_number: str


def _edges_from_neighbors(keys: List[tuple], neighbor_lists: List[List[tuple]]) -> np.ndarray:
    """Neighbor key lists -> (2, E) edge_index sorted by (src, dst).

    Equivalent to the reference dense-adjacency ``.nonzero().t()`` trick
    (`data.py:257-266`) without materializing the N^2 matrix.  Duplicate
    neighbor entries collapse (the dense matrix is binary).
    """
    index = {k: i for i, k in enumerate(keys)}
    pairs = set()
    for i, neighbors in enumerate(neighbor_lists):
        for nb in neighbors:
            pairs.add((i, index[tuple(nb)]))
    if not pairs:
        return np.zeros((2, 0), dtype=np.int32)
    arr = np.array(sorted(pairs), dtype=np.int32)  # row-major = (src, dst) order
    return arr.T


def process_building(
    global_graph_data: dict,
    local_graph_data: dict,
    voxel_graph_data: dict,
    configuration: Configuration,
    data_number: str,
) -> Tuple[LocalGraph, VoxelGraph]:
    """One building's JSON triplet -> (LocalGraph, VoxelGraph) arrays.

    Mirrors `DataCreatorHelper.process_data` (reference data.py:216-391).
    """
    cfg = configuration

    # --- global graph (reference data.py:269-278) ---
    far = float(global_graph_data["far"])
    site_area = float(global_graph_data["site_area"])
    site_area_normalized = site_area / cfg.NORMALIZATION_FACTOR_SITE

    type_ratio = np.zeros(NUM_CLASSES, dtype=np.float32)
    for global_node in global_graph_data["global_node"]:
        type_ratio[global_node["type"]] = global_node["proportion"]

    # --- local graph (reference data.py:225-266) ---
    local_nodes = local_graph_data["node"]
    n_local = len(local_nodes)
    local_keys = []
    local_types = np.zeros(n_local, dtype=np.int32)
    local_type_ids = np.zeros(n_local, dtype=np.int32)
    local_floors = np.zeros(n_local, dtype=np.int32)
    local_centers = np.zeros((n_local, 3), dtype=np.float32)
    local_neighbors = []
    for i, node in enumerate(local_nodes):
        local_keys.append((node["floor"], node["type"], node["type_id"]))
        local_types[i] = node["type"]
        local_type_ids[i] = node["type_id"]
        local_floors[i] = node["floor"]
        local_centers[i] = node["center"]
        local_neighbors.append(node["neighbors"])

    local_edge_index = _edges_from_neighbors(local_keys, local_neighbors)

    local_onehot = np.zeros((n_local, NUM_CLASSES), dtype=np.float32)
    local_onehot[np.arange(n_local), local_types] = 1.0
    local_ratio_per_node = local_onehot * type_ratio[None, :]
    local_floor_norm = local_floors.astype(np.float32) / cfg.NORMALIZATION_FACTOR_FLOOR_LEVEL

    # 17-dim feature (reference data.py:24-33)
    local_x = np.concatenate(
        [
            local_onehot,
            local_ratio_per_node,
            np.full((n_local, 1), far, dtype=np.float32),
            local_floor_norm[:, None],
            np.full((n_local, 1), site_area_normalized, dtype=np.float32),
        ],
        axis=1,
    ).astype(np.float32)

    local = LocalGraph(
        x=local_x,
        types=local_types,
        types_onehot=local_onehot,
        type_ratio_per_node=local_ratio_per_node,
        edge_index=local_edge_index,
        floor_levels=local_floors,
        center=local_centers,
        type_ids=local_type_ids,
        far=far,
        site_area=site_area,
        data_number=data_number,
    )

    # --- voxel graph (reference data.py:281-352) ---
    voxel_nodes = voxel_graph_data["voxel_node"]
    n_voxel = len(voxel_nodes)
    voxel_keys = []
    voxel_types = np.zeros(n_voxel, dtype=np.int32)
    voxel_floors = np.zeros(n_voxel, dtype=np.int32)
    voxel_coord = np.zeros((n_voxel, 3), dtype=np.float32)
    voxel_dim = np.zeros((n_voxel, 3), dtype=np.float32)
    voxel_loc = np.zeros((n_voxel, 3), dtype=np.int32)
    voxel_neighbors = []
    type_counts = np.zeros(NUM_CLASSES, dtype=np.float32)
    for i, node in enumerate(voxel_nodes):
        voxel_keys.append(tuple(node["location"]))
        t = node["type"]
        if t == VOID_OLD:  # legacy remap (reference data.py:307-308)
            t = VOID
        voxel_types[i] = t
        type_counts[t] += 1
        voxel_floors[i] = node["location"][0]
        voxel_coord[i] = node["coordinate"]
        voxel_dim[i] = node["dimension"]
        voxel_loc[i] = node["location"]
        voxel_neighbors.append(node["neighbors"])

    voxel_edge_index = _edges_from_neighbors(voxel_keys, voxel_neighbors)

    voxel_node_ratio_vec = type_counts / n_voxel  # (7,) dataset ratios (data.py:323)
    voxel_onehot = np.zeros((n_voxel, NUM_CLASSES), dtype=np.float32)
    voxel_onehot[np.arange(n_voxel), voxel_types] = 1.0
    # per-node scalar: ratio of this node's own type (reference data.py:76-77)
    node_ratio = (voxel_onehot * voxel_node_ratio_vec[None, :]).max(axis=1, keepdims=True)

    voxel_floor_norm = voxel_floors.astype(np.float32) / cfg.NORMALIZATION_FACTOR_FLOOR_LEVEL
    features9 = np.concatenate(
        [
            voxel_coord / cfg.NORMALIZATION_FACTOR_COORDINATE,
            voxel_dim / cfg.NORMALIZATION_FACTOR_DIMENSION,
            voxel_loc.astype(np.float32) / cfg.NORMALIZATION_FACTOR_LOCATION,
        ],
        axis=1,
    )
    # 12-dim feature (reference data.py:56-64)
    voxel_x = np.concatenate(
        [
            features9,
            np.full((n_voxel, 1), far, dtype=np.float32),
            voxel_floor_norm[:, None],
            np.full((n_voxel, 1), site_area_normalized, dtype=np.float32),
        ],
        axis=1,
    ).astype(np.float32)

    voxel = VoxelGraph(
        x=voxel_x,
        types=voxel_types,
        types_onehot=voxel_onehot,
        edge_index=voxel_edge_index,
        floor_levels=voxel_floors,
        coordinate=voxel_coord,
        dimension=voxel_dim,
        location=voxel_loc,
        node_ratio=node_ratio.astype(np.float32),
        far=far,
        site_area=site_area,
        data_number=data_number,
    )

    return local, voxel


# --- NPZ serialization -------------------------------------------------------

def save_local(path: str, g: LocalGraph, compress: bool = False) -> None:
    (np.savez_compressed if compress else np.savez)(
        path,
        x=g.x,
        types=g.types,
        types_onehot=g.types_onehot,
        type_ratio_per_node=g.type_ratio_per_node,
        edge_index=g.edge_index,
        floor_levels=g.floor_levels,
        center=g.center,
        type_ids=g.type_ids,
        far=np.float32(g.far),
        site_area=np.float32(g.site_area),
        data_number=np.str_(g.data_number),
    )


def load_local(path: str) -> LocalGraph:
    with np.load(path) as z:
        return LocalGraph(
            x=z["x"],
            types=z["types"],
            types_onehot=z["types_onehot"],
            type_ratio_per_node=z["type_ratio_per_node"],
            edge_index=z["edge_index"],
            floor_levels=z["floor_levels"],
            center=z["center"],
            type_ids=z["type_ids"],
            far=float(z["far"]),
            site_area=float(z["site_area"]),
            data_number=str(z["data_number"]),
        )


def save_voxel(path: str, g: VoxelGraph, compress: bool = False) -> None:
    (np.savez_compressed if compress else np.savez)(
        path,
        x=g.x,
        types=g.types,
        types_onehot=g.types_onehot,
        edge_index=g.edge_index,
        floor_levels=g.floor_levels,
        coordinate=g.coordinate,
        dimension=g.dimension,
        location=g.location,
        node_ratio=g.node_ratio,
        far=np.float32(g.far),
        site_area=np.float32(g.site_area),
        data_number=np.str_(g.data_number),
    )


def load_voxel(path: str) -> VoxelGraph:
    with np.load(path) as z:
        return VoxelGraph(
            x=z["x"],
            types=z["types"],
            types_onehot=z["types_onehot"],
            edge_index=z["edge_index"],
            floor_levels=z["floor_levels"],
            coordinate=z["coordinate"],
            dimension=z["dimension"],
            location=z["location"],
            node_ratio=z["node_ratio"],
            far=float(z["far"]),
            site_area=float(z["site_area"]),
            data_number=str(z["data_number"]),
        )


# --- dataset creation (reference DataCreator.create, data.py:398-461) --------

def _sorted_json_files(directory: str) -> List[str]:
    files = [os.path.join(directory, d) for d in os.listdir(directory)]
    return sorted(files, key=lambda x: int(os.path.basename(x).replace(".json", "").split("_")[-1]))


def _process_one(args) -> int:
    gp, lp, vp, cfg, use_native = args
    num_g = os.path.basename(gp).replace(".json", "").split("_")[-1]
    num_l = os.path.basename(lp).replace(".json", "").split("_")[-1]
    num_v = os.path.basename(vp).replace(".json", "").split("_")[-1]
    if not num_g == num_l == num_v:
        raise ValueError(f"mismatched building files: {gp}, {lp}, {vp}")
    data_number = "".join(s for s in os.path.basename(gp) if s.isdigit())

    if use_native:
        from ..native import parser as native_parser

        g_data, l_data, v_data = native_parser.parse_triplet(gp, lp, vp)
    else:
        with open(gp) as f:
            g_data = json.load(f)
        with open(lp) as f:
            l_data = json.load(f)
        with open(vp) as f:
            v_data = json.load(f)

    local, voxel = process_building(g_data, l_data, v_data, cfg, data_number)
    save_local(os.path.join(cfg.SAVE_DATA_PATH, f"{data_number}{cfg.LOCAL_DATA_SUFFIX}"), local)
    save_voxel(os.path.join(cfg.SAVE_DATA_PATH, f"{data_number}{cfg.VOXEL_DATA_SUFFIX}"), voxel)
    return 1


def create_dataset(
    configuration: Configuration,
    verbose: bool = True,
    use_native: bool = True,
    workers: int = 0,
) -> int:
    """Process every raw JSON triplet under ``DATA_PATH`` to NPZ pairs in
    ``SAVE_DATA_PATH``; returns the count.

    ``use_native`` parses the JSON with the C++ parser (``native/parser.py``,
    built at first use, here in the calling process before any worker starts;
    a failed build raises), else with Python's ``json``: the same NPZ files.
    ``workers > 1`` spreads the buildings over a pool of that many processes.
    """
    cfg = configuration
    global_files = _sorted_json_files(cfg.GLOBAL_GRAPH_DATA_PATH)
    local_files = _sorted_json_files(cfg.LOCAL_GRAPH_DATA_PATH)
    voxel_files = _sorted_json_files(cfg.VOXEL_GRAPH_DATA_PATH)
    if not len(global_files) == len(local_files) == len(voxel_files):
        raise ValueError(
            f"{len(global_files)} global, {len(local_files)} local and {len(voxel_files)} voxel "
            f"files under {cfg.DATA_PATH}"
        )

    os.makedirs(cfg.SAVE_DATA_PATH, exist_ok=True)
    if use_native:
        from ..native import parser as native_parser

        native_parser.load()  # one build, before the workers load it

    tasks = [(gp, lp, vp, cfg, use_native)
             for gp, lp, vp in zip(global_files, local_files, voxel_files)]
    n = 0
    if workers and workers > 1:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(workers) as pool:
            for r in pool.imap_unordered(_process_one, tasks, chunksize=32):
                n += r
                if verbose and n % 1000 == 0:
                    print(f"processed {n}/{len(tasks)}")
    else:
        for t in tasks:
            n += _process_one(t)
            if verbose and n % 1000 == 0:
                print(f"processed {n}/{len(tasks)}")
    return n
