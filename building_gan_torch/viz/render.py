"""Qualitative evaluation: 5-panel 3D renders of program graph + volumes.

Port of ``building_gan_tpu/viz/render.py``, which re-implements the reference
visualization (`building_gan/src/trainer.py:52-289`): for a sampled building,
draw (1) the local program graph, (2) the irregular voxel grid, (3) the
ground-truth volumes, (4) the generated volumes, best of ``iteration`` z
restarts by macro F1, and (5) a program-type legend; stack several samples
into one image strip for the scalar log.

What the device does and what the host draws are split:

- ``best_of_k`` packs the building into one slot (``pack_grid(...,
  batch_slots=1)``, or ``pack_one`` on the edge layout), moves it to
  ``trainer.device`` and runs ``trainer.generate`` once a restart: on the
  fused route that is one hourglass launch a restart.  The restarts draw z
  and the Gumbel noise from one ``torch.Generator`` on that device, seeded
  0.  Torch cannot replay JAX's threefry keys, so a restart's labels differ
  from the JAX package's;
- ``draw_one`` is the 5-panel figure, on the host (matplotlib Agg).

``evaluate_qualitatively`` picks its samples with the host RNG
``np.random.default_rng(0 if epoch is None else epoch)``, as the JAX
package does, so both pick the same buildings.  matplotlib and Pillow are
imported inside the functions that need them.
"""

from __future__ import annotations

import io
from typing import Optional

import numpy as np
import torch

from ..config import COLORS, PROGRAM_NAMES, VOID
from ..data.batching import pack_one
from ..train.metrics import compute_metrics


def _require(*packages: str) -> None:
    """Import ``packages`` (matplotlib, PIL) or raise an ImportError naming the missing one
    and the flag that skips rendering."""
    import importlib

    for name in packages:
        try:
            importlib.import_module(name)
        except ImportError as e:
            raise ImportError(
                f"{name} is not installed: renders need matplotlib and Pillow (the CLI's test "
                "renders test samples unless given --num-samples-to-viz 0)") from e


def _voxel_faces(coord, dim):
    """12 quad faces of the box at coord (z, y, x) with dims (z, y, x)."""
    z, y, x = coord
    dz, dy, dx = dim
    v = [
        [x, y, z], [x + dx, y, z], [x + dx, y + dy, z], [x, y + dy, z],
        [x, y, z + dz], [x + dx, y, z + dz], [x + dx, y + dy, z + dz], [x, y + dy, z + dz],
    ]
    return [
        [v[0], v[1], v[2], v[3]],
        [v[4], v[5], v[6], v[7]],
        [v[0], v[1], v[5], v[4]],
        [v[2], v[3], v[7], v[6]],
        [v[1], v[2], v[6], v[5]],
        [v[0], v[3], v[7], v[4]],
    ]


@torch.no_grad()
def best_of_k(trainer, local_graph, voxel_graph, iteration: int = 1):
    """The generated types of one building, best of ``iteration`` restarts by macro F1
    (reference trainer.py:52-96) -> (types (N,) numpy, f1).

    Keeps the reference's rule: the first restart is taken, a later one only if its F1
    is strictly higher.
    """
    cfg, dev = trainer.configuration, trainer.device
    if cfg.LAYOUT == "grid":
        from ..data.grid import pack_grid

        batch = pack_grid([(local_graph, voxel_graph)], cfg, batch_slots=1)
        loc = torch.as_tensor(voxel_graph.location.astype(np.int64), device=dev)
    else:
        batch = pack_one([(local_graph, voxel_graph)], cfg)
        loc = None
    batch = batch.to(dev)
    n_real = voxel_graph.x.shape[0]
    y_true = torch.as_tensor(voxel_graph.types.astype(np.int64), device=dev)
    ones = torch.ones(n_real, device=dev)
    graph_id = torch.zeros(n_real, dtype=torch.int64, device=dev)
    generator = torch.Generator(device=dev).manual_seed(0)

    best_f1 = 0.0
    types_generated = None
    for _ in range(max(iteration, 1)):
        _, label_hard, _ = trainer.generate(batch, generator)
        pred_full = label_hard.argmax(-1)
        pred = pred_full[0, loc[:, 0], loc[:, 1], loc[:, 2]] if loc is not None else pred_full[:n_real]
        f1 = float(compute_metrics(y_true, pred, ones, torch.ones(1, device=dev),
                                   graph_id=graph_id)["f1"])
        if types_generated is None or f1 > best_f1:
            best_f1 = f1
            types_generated = pred
    return types_generated.cpu().numpy(), best_f1


def draw_one(
    local_graph,
    voxel_graph,
    types_generated,
    f1: float,
    epoch: Optional[int],
    title: Optional[str] = None,
    show: bool = False,
    to_pil: bool = False,
):
    """The 5-panel figure of one building and its generated types (reference
    trainer.py:98-194); a PIL image when ``to_pil``, else None."""
    _require("matplotlib")
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from matplotlib.patches import Patch
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    n_real = voxel_graph.x.shape[0]
    fig = plt.figure(figsize=(20, 5))
    if title is not None:
        fig.suptitle(title, fontsize=16)

    ax_graph = fig.add_subplot(1, 5, 1, projection="3d")
    ax_grid = fig.add_subplot(1, 5, 2, projection="3d")
    ax_gt = fig.add_subplot(1, 5, 3, projection="3d")
    ax_gen = fig.add_subplot(1, 5, 4, projection="3d")
    ax_leg = fig.add_subplot(1, 5, 5, projection="3d")

    ax_graph.set_title("Graph\n")
    ax_grid.set_title(f"Irregular Voxel Grid (nodes: {n_real})\n")
    ax_gt.set_title("Ground Truth\n")
    ax_gen.set_title(f"{epoch}, Generated, (f1: {f1:.4f})\n")
    ax_leg.set_title("Legend\n")

    # program graph edges + nodes (centers are (z, y, x))
    centers = local_graph.center
    for s, t in local_graph.edge_index.T:
        zs, ys, xs = centers[s]
        zt, yt, xt = centers[t]
        ax_graph.plot([xs, xt], [ys, yt], [zs, zt], color="gray", alpha=0.3, linewidth=0.5)
    for li in range(centers.shape[0]):
        z, y, x = centers[li]
        ax_graph.scatter(x, y, z, c=COLORS[int(local_graph.types[li])], s=10)

    for ni in range(n_real):
        faces = _voxel_faces(voxel_graph.coordinate[ni], voxel_graph.dimension[ni])
        t_real = int(voxel_graph.types[ni])
        t_gen = int(types_generated[ni])

        grid = Poly3DCollection(faces, alpha=0.2)
        grid.set_facecolor("white")
        grid.set_edgecolor("gray")
        ax_grid.add_collection3d(grid)

        gt = Poly3DCollection(faces, alpha=0.035 if t_real == VOID else 1.0)
        gt.set_facecolor(COLORS[t_real])
        ax_gt.add_collection3d(gt)

        gen = Poly3DCollection(faces, alpha=0.035 if t_gen == VOID else 1.0)
        gen.set_facecolor(COLORS[t_gen])
        ax_gen.add_collection3d(gen)

    ax_leg.legend(
        handles=[
            Patch(facecolor=COLORS[p], label=PROGRAM_NAMES[p].replace("_", " ").title())
            for p in COLORS
        ],
        fontsize=7,
        frameon=False,
        loc="upper center",
    )

    maxc = (voxel_graph.coordinate + voxel_graph.dimension).max(axis=0)
    minc = voxel_graph.coordinate.min(axis=0)
    for ax in (ax_graph, ax_grid, ax_gt, ax_gen, ax_leg):
        ax.set_box_aspect([1, 1, 1])
        ax.set_proj_type("ortho")
        ax._axis3don = False
        ax.set_xlim(minc[2], maxc[2])
        ax.set_ylim(minc[1], maxc[1])
        ax.set_zlim(minc[0], maxc[0])

    if show:
        plt.show()

    if to_pil:
        from PIL import Image

        buf = io.BytesIO()
        fig.savefig(buf, format="png", bbox_inches="tight")
        plt.close(fig)
        buf.seek(0)
        return Image.open(buf)
    plt.close(fig)
    return None


def visualize_one(
    trainer,
    local_graph,
    voxel_graph,
    epoch: Optional[int],
    iteration: int = 1,
    show: bool = False,
    title: Optional[str] = None,
    to_pil: bool = False,
):
    """Render one building; best-of-``iteration`` z restarts by macro F1
    (reference trainer.py:52-194)."""
    _require("matplotlib", *(("PIL",) if to_pil else ()))
    types_generated, best_f1 = best_of_k(trainer, local_graph, voxel_graph, iteration)
    return draw_one(local_graph, voxel_graph, types_generated, best_f1, epoch,
                    title=title, show=show, to_pil=to_pil)


def evaluate_qualitatively(
    trainer,
    epoch: Optional[int],
    iteration: int = 1,
    num_samples_to_viz: int = 2,
    to_tensor: bool = False,
    use_test_dataset: bool = False,
    show: bool = False,
):
    """Multi-sample image strip (reference trainer.py:196-289).

    Returns a CHW uint8 numpy array when ``to_tensor`` (``add_image``'s
    format), else a PIL image.
    """
    _require("matplotlib", "PIL")
    rng = np.random.default_rng(0 if epoch is None else epoch)
    loaders = trainer.dataloaders
    train_samples = loaders.train_dataloader.samples
    if use_test_dataset and loaders.test_dataloader is not None:
        val_samples = loaders.test_dataloader.samples
        val_name = "test"
    elif loaders.validation_dataloader is not None:
        val_samples = loaders.validation_dataloader.samples
        val_name = "validation"
    else:
        val_samples = train_samples
        val_name = "train"

    figs = []
    for _ in range(num_samples_to_viz):
        if not use_test_dataset:
            ti = int(rng.integers(len(train_samples)))
            local, voxel = train_samples[ti]
            figs.append(
                visualize_one(
                    trainer, local, voxel, epoch, iteration,
                    title=None if epoch is None else f"train at epoch: {epoch}\n",
                    to_pil=True, show=show,
                )
            )
        vi = int(rng.integers(len(val_samples)))
        local, voxel = val_samples[vi]
        figs.append(
            visualize_one(
                trainer, local, voxel, epoch, iteration,
                title=None if epoch is None else f"{val_name} at epoch: {epoch}\n",
                to_pil=True, show=show,
            )
        )

    from PIL import Image

    width, height = figs[0].size
    merged = Image.new("RGB", (width, height * len(figs)))
    for i, f in enumerate(figs):
        merged.paste(f, (0, i * height))

    if to_tensor:
        arr = np.array(merged)
        return np.transpose(arr, (2, 0, 1)).astype(np.uint8)
    return merged
