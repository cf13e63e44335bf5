"""Synthetic buildings in the reference raw-data JSON schema (the port's copy).

Same generator, same seeds and same output as
``building_gan_tpu/data/synthetic.py``: ``generate_building(seed)`` returns
``(global_json, local_json, voxel_json)`` dicts with irregular per-axis cell
widths, a vertical service core, a ground-floor lobby, offices, a roof
mechanical room and setback voids; ``generate_building_real_scale`` draws
buildings at the reference dataset's statistics (grids up to (11, 12, 12));
``write_dataset`` writes a raw dataset in the reference directory layout.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

from ..config import (
    ELEVATOR,
    LOBBY_CORRIDOR,
    MECHANICAL_ROOM,
    NUM_CLASSES,
    OFFICE,
    RESTROOM,
    STAIRS,
    VOID,
)


def _irregular_divisions(
    rng: np.random.Generator,
    n: int,
    min_d: int = 3,
    max_d: int = 11,
    budget: int | None = None,
) -> List[int]:
    """n cell widths, each in [min_d, max_d] (reference dims range 3-11).

    With ``budget``, the total extent is kept <= budget (the reference
    coordinate range is 0-42, `analyze.py:104-106`), shrinking the per-cell
    cap as cells are consumed.
    """
    divs = []
    remaining = budget if budget is not None else n * max_d
    for i in range(n):
        cap = max_d if budget is None else min(max_d, remaining - min_d * (n - i - 1))
        cap = max(cap, min_d)
        divs.append(int(rng.integers(min_d, cap + 1)))
        remaining -= divs[-1]
    return divs


def generate_building(
    seed: int,
    nx_range: Tuple[int, int] = (3, 6),
    ny_range: Tuple[int, int] = (3, 6),
    nf_range: Tuple[int, int] = (3, 10),
    coordinate_budget: int | None = None,
) -> Tuple[dict, dict, dict]:
    """Generate one building: (global_json, local_json, voxel_json) dicts.

    Ranges are inclusive.  Defaults produce small test buildings (<= 10
    floors x 6 x 6 cells); see :func:`generate_building_real_scale` for
    reference-statistics-scale buildings.
    """
    rng = np.random.default_rng(seed)

    nx = int(rng.integers(nx_range[0], nx_range[1] + 1))
    ny = int(rng.integers(ny_range[0], ny_range[1] + 1))
    n_floors = int(rng.integers(nf_range[0], nf_range[1] + 1))

    x_divs = _irregular_divisions(rng, nx, budget=coordinate_budget)
    y_divs = _irregular_divisions(rng, ny, budget=coordinate_budget)
    z_divs = _irregular_divisions(rng, n_floors, min_d=3, max_d=4, budget=coordinate_budget)

    x_offsets = np.concatenate([[0], np.cumsum(x_divs)])
    y_offsets = np.concatenate([[0], np.cumsum(y_divs)])
    z_offsets = np.concatenate([[0], np.cumsum(z_divs)])

    # Site slightly larger than footprint; clamp into the reference range.
    footprint = float(x_offsets[-1] * y_offsets[-1])
    site_area = float(np.clip(footprint * rng.uniform(1.0, 1.4), 324.0, 1600.0))

    # Program assignment per (floor, iy, ix).
    core_ix = int(rng.integers(0, nx))
    core_iy = int(rng.integers(0, ny))
    stair_ix = (core_ix + 1) % nx
    rest_iy = (core_iy + 1) % ny

    # Upper-floor setback: floors >= setback_floor lose the outer ring to VOID.
    setback_floor = int(rng.integers(max(1, n_floors - 3), n_floors + 1))

    types = np.empty((n_floors, ny, nx), dtype=np.int64)
    for f in range(n_floors):
        for iy in range(ny):
            for ix in range(nx):
                if f >= setback_floor and (ix in (0, nx - 1) or iy in (0, ny - 1)):
                    t = VOID
                elif ix == core_ix and iy == core_iy:
                    t = ELEVATOR
                elif ix == stair_ix and iy == core_iy:
                    t = STAIRS
                elif ix == core_ix and iy == rest_iy:
                    t = RESTROOM
                elif f == n_floors - 1 and ix == stair_ix and iy == rest_iy:
                    t = MECHANICAL_ROOM
                elif f == 0 and (ix == core_ix or iy == core_iy):
                    t = LOBBY_CORRIDOR
                elif f > 0 and iy == core_iy:
                    t = LOBBY_CORRIDOR  # corridor band on every floor
                else:
                    t = OFFICE
                types[f, iy, ix] = t
    # Sprinkle a few random voids inside office space for irregularity.
    n_random_void = int(rng.integers(0, max(2, (nx * ny) // 4)))
    for _ in range(n_random_void):
        f = int(rng.integers(0, n_floors))
        iy = int(rng.integers(0, ny))
        ix = int(rng.integers(0, nx))
        if types[f, iy, ix] == OFFICE:
            types[f, iy, ix] = VOID

    # --- voxel graph ---
    voxel_nodes = []
    for f in range(n_floors):
        for iy in range(ny):
            for ix in range(nx):
                loc = [f, iy, ix]
                neighbors = []
                for df, diy, dix in ((0, 0, 1), (0, 0, -1), (0, 1, 0), (0, -1, 0), (1, 0, 0), (-1, 0, 0)):
                    nf, niy, nix = f + df, iy + diy, ix + dix
                    if 0 <= nf < n_floors and 0 <= niy < ny and 0 <= nix < nx:
                        neighbors.append([nf, niy, nix])
                voxel_nodes.append(
                    {
                        "location": loc,
                        "coordinate": [int(z_offsets[f]), int(y_offsets[iy]), int(x_offsets[ix])],
                        "dimension": [int(z_divs[f]), int(y_divs[iy]), int(x_divs[ix])],
                        "type": int(types[f, iy, ix]),
                        "neighbors": neighbors,
                    }
                )

    # FAR must equal sum(dim_y * dim_x over non-void voxels) / site_area
    # (reference analyze.py:76-79).
    gfa = 0.0
    for vn in voxel_nodes:
        if vn["type"] != VOID:
            gfa += vn["dimension"][1] * vn["dimension"][2]
    far = gfa / site_area

    # --- local program graph: one room node per (floor, type) present ---
    local_nodes_map: Dict[Tuple[int, int], dict] = {}
    for vn in voxel_nodes:
        t = vn["type"]
        if t == VOID:
            continue
        f = vn["location"][0]
        key = (f, t)
        if key not in local_nodes_map:
            local_nodes_map[key] = {
                "floor": f,
                "type": t,
                "type_id": 0,
                "centers": [],
                "neighbors": [],
            }
        cz = vn["coordinate"][0] + vn["dimension"][0] / 2.0
        cy = vn["coordinate"][1] + vn["dimension"][1] / 2.0
        cx = vn["coordinate"][2] + vn["dimension"][2] / 2.0
        local_nodes_map[key]["centers"].append((cz, cy, cx))

    local_keys = sorted(local_nodes_map.keys())
    for key in local_keys:
        node = local_nodes_map[key]
        centers = np.array(node.pop("centers"))
        node["center"] = [float(c) for c in centers.mean(axis=0)]

    # Room adjacency: rooms on the same floor are all linked through the
    # corridor; same-type rooms on adjacent floors are linked vertically.
    key_set = set(local_keys)
    for f, t in local_keys:
        node = local_nodes_map[(f, t)]
        for t2 in range(NUM_CLASSES):
            if t2 != t and (f, t2) in key_set:
                node["neighbors"].append([f, t2, 0])
        for f2 in (f - 1, f + 1):
            if (f2, t) in key_set:
                node["neighbors"].append([f2, t, 0])

    local_nodes = [local_nodes_map[k] for k in local_keys]

    # --- global graph: per-type target proportions over non-void voxels ---
    counts = np.zeros(NUM_CLASSES, dtype=np.float64)
    for vn in voxel_nodes:
        counts[vn["type"]] += 1
    proportions = counts / counts.sum()
    global_nodes = [
        {"type": t, "proportion": float(proportions[t])}
        for t in range(NUM_CLASSES)
        if counts[t] > 0
    ]

    global_json = {"far": float(far), "site_area": float(site_area), "global_node": global_nodes}
    local_json = {"node": local_nodes}
    voxel_json = {"voxel_node": voxel_nodes}
    return global_json, local_json, voxel_json


def generate_building_real_scale(seed: int) -> Tuple[dict, dict, dict]:
    """A building matching the REFERENCE dataset statistics (`analyze.py:99-110`):
    grids up to (11, 12, 12), ~400 voxel nodes on average, coordinates <= 42.
    """
    return generate_building(
        seed,
        nx_range=(4, 12),
        ny_range=(4, 12),
        nf_range=(3, 11),
        coordinate_budget=42,
    )


def write_dataset(root: str, num_buildings: int, seed: int = 0) -> None:
    """Write a synthetic raw dataset in the reference directory layout.

    Creates ``{root}/global_graph_data/graph_global_NNNNNN.json``,
    ``{root}/local_graph_data/graph_local_NNNNNN.json`` and
    ``{root}/voxel_data/voxel_NNNNNN.json``; building i is
    ``generate_building(seed * 1_000_003 + i)``.
    """
    paths = {
        "global_graph_data": "graph_global_{:06d}.json",
        "local_graph_data": "graph_local_{:06d}.json",
        "voxel_data": "voxel_{:06d}.json",
    }
    for sub in paths:
        os.makedirs(os.path.join(root, sub), exist_ok=True)

    for i in range(num_buildings):
        g, l, v = generate_building(seed * 1_000_003 + i)
        for sub, payload in zip(paths, (g, l, v)):
            with open(os.path.join(root, sub, paths[sub].format(i)), "w") as f:
                json.dump(payload, f)
