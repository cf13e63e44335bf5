"""Dataset analyzer: per-type stats, value ranges, FAR invariant.

Port of ``building_gan_tpu/utils/analyze.py`` (host only: json and the
standard library), which re-implements the reference analysis tool
(`building_gan/src/analyze.py`):
scans the raw JSON triplets, counts voxel types, gathers the ranges that
justify the normalization constants (site area, dimension, location,
coordinate, floor), and asserts ``far == GFA / site_area`` per building
(reference `analyze.py:76-79`).
"""

from __future__ import annotations

import json
from collections import Counter

from ..config import Configuration, NUM_CLASSES, PROGRAM_NAMES, VOID, VOID_OLD
from ..data.preprocess import _sorted_json_files


def analyze_dataset(cfg: Configuration, far_tolerance: float = 1e-3) -> dict:
    global_files = _sorted_json_files(cfg.GLOBAL_GRAPH_DATA_PATH)
    voxel_files = _sorted_json_files(cfg.VOXEL_GRAPH_DATA_PATH)
    assert len(global_files) == len(voxel_files)

    type_counts = Counter()
    total_voxels = 0
    site_areas, floors, coords, dims, locs = [], [], [], [], []

    for gp, vp in zip(global_files, voxel_files):
        with open(gp) as f:
            g = json.load(f)
        with open(vp) as f:
            v = json.load(f)

        site_area = g["site_area"]
        site_areas.append(site_area)
        gfa = 0.0
        for node in v["voxel_node"]:
            t = node["type"]
            if t == VOID_OLD:
                t = VOID
            type_counts[t] += 1
            total_voxels += 1
            floors.append(node["location"][0])
            coords.extend(node["coordinate"])
            dims.extend(node["dimension"])
            locs.extend(node["location"])
            if t != VOID:
                gfa += node["dimension"][1] * node["dimension"][2]

        far_computed = gfa / site_area
        assert abs(far_computed - g["far"]) < far_tolerance, (
            f"FAR invariant violated in {gp}: {g['far']} vs computed {far_computed}"
        )

    stats = {
        "num_buildings": len(global_files),
        "total_voxel_nodes": total_voxels,
        "avg_voxels_per_building": total_voxels / max(len(global_files), 1),
        "type_ratios": {
            PROGRAM_NAMES[t]: type_counts.get(t, 0) / max(total_voxels, 1)
            for t in range(NUM_CLASSES)
        },
        "site_area_range": (min(site_areas), max(site_areas)),
        "floor_range": (min(floors), max(floors)),
        "coordinate_range": (min(coords), max(coords)),
        "dimension_range": (min(dims), max(dims)),
        "location_range": (min(locs), max(locs)),
    }

    print(f"buildings           : {stats['num_buildings']}")
    print(f"total voxel nodes   : {stats['total_voxel_nodes']}")
    print(f"avg voxels/building : {stats['avg_voxels_per_building']:.1f}")
    for name, r in stats["type_ratios"].items():
        print(f"  {name:<16s}: {r * 100:.2f}%")
    print(f"site area range     : {stats['site_area_range']}")
    print(f"floor range         : {stats['floor_range']}")
    print(f"coordinate range    : {stats['coordinate_range']}")
    print(f"dimension range     : {stats['dimension_range']}")
    print(f"location range      : {stats['location_range']}")
    print("FAR invariant       : OK (all buildings)")
    return stats
