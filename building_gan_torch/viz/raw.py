"""Raw-dataset visualization — renders buildings straight from JSON.

Port of ``building_gan_tpu/viz/raw.py`` (host only; matplotlib imported
inside the functions).  Equivalent of the reference
``notebooks/data-visualization.ipynb`` (which is stale in the reference — it
references ProgramMap attributes that no longer exist, SURVEY.md Q4): 4 panels
per building — local program graph, typed voxel volumes, the irregular grid,
and the ground-floor partition in plan view.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from ..config import COLORS, VOID, VOID_OLD
from .render import _require, _voxel_faces


def render_raw_building(
    global_json: dict,
    local_json: dict,
    voxel_json: dict,
    title: Optional[str] = None,
    save_path: Optional[str] = None,
    show: bool = False,
):
    _require("matplotlib")
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    fig = plt.figure(figsize=(16, 4))
    if title:
        fig.suptitle(title)
    ax_graph = fig.add_subplot(1, 4, 1, projection="3d")
    ax_vox = fig.add_subplot(1, 4, 2, projection="3d")
    ax_grid = fig.add_subplot(1, 4, 3, projection="3d")
    ax_plan = fig.add_subplot(1, 4, 4)

    ax_graph.set_title("Program graph")
    ax_vox.set_title(f"Voxels (far={global_json['far']:.2f})")
    ax_grid.set_title("Irregular grid")
    ax_plan.set_title("Ground floor plan")

    # program graph
    centers = {}
    for node in local_json["node"]:
        key = (node["floor"], node["type"], node["type_id"])
        centers[key] = node["center"]
    for node in local_json["node"]:
        z0, y0, x0 = node["center"]
        for nb in node["neighbors"]:
            z1, y1, x1 = centers[tuple(nb)]
            ax_graph.plot([x0, x1], [y0, y1], [z0, z1], color="gray", alpha=0.3, lw=0.5)
        ax_graph.scatter(x0, y0, z0, c=COLORS[node["type"]], s=12)

    # voxels
    for vn in voxel_json["voxel_node"]:
        t = vn["type"]
        if t == VOID_OLD:
            t = VOID
        faces = _voxel_faces(vn["coordinate"], vn["dimension"])
        vox = Poly3DCollection(faces, alpha=0.05 if t == VOID else 0.9)
        vox.set_facecolor(COLORS[t])
        ax_vox.add_collection3d(vox)

        grid = Poly3DCollection(faces, alpha=0.15)
        grid.set_facecolor("white")
        grid.set_edgecolor("gray")
        ax_grid.add_collection3d(grid)

        if vn["location"][0] == 0:  # ground floor plan view
            zc, yc, xc = vn["coordinate"]
            zd, yd, xd = vn["dimension"]
            ax_plan.add_patch(
                plt.Rectangle(
                    (xc, yc), xd, yd,
                    facecolor=COLORS[t], edgecolor="gray",
                    alpha=0.2 if t == VOID else 0.9,
                )
            )

    import numpy as np

    coords = np.array([vn["coordinate"] for vn in voxel_json["voxel_node"]], float)
    dims = np.array([vn["dimension"] for vn in voxel_json["voxel_node"]], float)
    hi = (coords + dims).max(axis=0)
    lo = coords.min(axis=0)
    for ax in (ax_graph, ax_vox, ax_grid):
        ax.set_box_aspect([1, 1, 1])
        ax.set_proj_type("ortho")
        ax._axis3don = False
        ax.set_xlim(lo[2], hi[2])
        ax.set_ylim(lo[1], hi[1])
        ax.set_zlim(lo[0], hi[0])
    ax_plan.set_xlim(lo[2], hi[2])
    ax_plan.set_ylim(lo[1], hi[1])
    ax_plan.set_aspect("equal")

    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=100)
    if show:
        plt.show()
    plt.close(fig)
    return save_path


def render_raw_samples(cfg, indices, out_dir: str) -> list:
    """Render several raw buildings by index; returns written paths."""
    from ..data.preprocess import _sorted_json_files

    gfs = _sorted_json_files(cfg.GLOBAL_GRAPH_DATA_PATH)
    lfs = _sorted_json_files(cfg.LOCAL_GRAPH_DATA_PATH)
    vfs = _sorted_json_files(cfg.VOXEL_GRAPH_DATA_PATH)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in indices:
        with open(gfs[i]) as f:
            g = json.load(f)
        with open(lfs[i]) as f:
            l = json.load(f)
        with open(vfs[i]) as f:
            v = json.load(f)
        num = os.path.basename(gfs[i]).replace(".json", "").split("_")[-1]
        p = os.path.join(out_dir, f"raw_{num}.png")
        render_raw_building(g, l, v, title=f"building {num}", save_path=p)
        paths.append(p)
    return paths
