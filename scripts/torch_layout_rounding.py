"""How much of the grid-vs-edge distance is each layout's own f32 rounding.

On ``chip_smoke.py``'s phase 10c inputs (the first 16 real-scale buildings,
the config of record's widths, weights from ``torch.manual_seed(cfg.SEED)``
moved by 0.05 noise, the same z in both layouts), runs the port's grid and
edge generators at f32 and in f64 and prints the grid-vs-edge logit
distance at each precision and each layout's f32 distance from its own f64
run, on real cells.  ``--f64-norm-sums`` runs the edge GraphNorm's segment
sums in f64 (the moments then rounded to f32), to show what those sums
cost.

    python scripts/torch_layout_rounding.py --device cuda --conv GATV2CONV
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the buildings)
from building_gan_torch.config import Configuration  # noqa: E402
from building_gan_torch.data import pack_grid  # noqa: E402
from building_gan_torch.data.batching import pack_graphs  # noqa: E402
from building_gan_torch.models import layers as LY  # noqa: E402
from building_gan_torch.models.generator import VoxelGNNGenerator  # noqa: E402
from building_gan_torch.models.grid_layers import GridHourglass  # noqa: E402
from building_gan_torch.models.grid_models import (  # noqa: E402
    GridVoxelGNNDiscriminator, GridVoxelGNNGenerator,
)
from building_gan_torch.ops import segment as seg  # noqa: E402


def norm_f64_sums(self, x, segment_ids, num_segments: int, mask=None):
    """``LY.GraphNorm.forward`` with its segment sums in f64, the moments rounded to f32."""
    dt = torch.promote_types(x.dtype, torch.float32)
    x64 = x.to(torch.float64)
    w = None if mask is None else mask.to(torch.float64)
    mean, ex2 = (seg.gather(seg.segment_mean(v, segment_ids, num_segments, weights=w).to(dt),
                            segment_ids) for v in (x64, x64 * x64))
    s = mean * self.mean_scale
    var = torch.clamp(ex2 - 2.0 * s * mean + s * s, min=0.0)
    inv = self.weight * torch.rsqrt(var + self.eps)
    return x * inv.to(x.dtype) + (self.bias - s * inv).to(x.dtype)


def as_f64(model, batch):
    m = copy.deepcopy(model).double()
    m.compute_dtype = torch.float64
    return m, dataclasses.replace(batch, **{
        k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
        for k, v in vars(batch).items()})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--conv", default="GATV2CONV")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--f64-norm-sums", action="store_true")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(chip_smoke.card_line(), flush=True)  # nvidia-smi's name and power limit
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    if args.f64_norm_sums:
        LY.GraphNorm.forward = norm_f64_sums
    n_buildings = chip_smoke.PARITY_BUILDINGS
    chip_smoke.TRAIN_BUILDINGS = n_buildings
    cfg = Configuration(COMPUTE_DTYPE="float32", GENERATOR_CONV_TYPE=args.conv,
                        DISCRIMINATOR_CONV_TYPE=args.conv)
    samples = list(chip_smoke.train_samples())
    pack = pack_graphs(samples, cfg)[0].to(dev)
    gb = pack_grid(samples, cfg, batch_slots=n_buildings).to(dev)
    nv = pack.voxel_x.shape[0]
    g = torch.Generator(device=dev).manual_seed(5)
    z_e = torch.randn(nv, cfg.Z_DIM, generator=g, device=dev) * pack.voxel_mask[:, None]
    cells, offset = [], 0
    for b, (_, voxel) in enumerate(samples):
        n = voxel.x.shape[0]
        f, y, x = (torch.as_tensor(a, device=dev) for a in voxel.location.astype(np.int64).T)
        cells.append((b, f, y, x))
        offset += n
    z_g = torch.zeros(tuple(gb.mask.shape) + (cfg.Z_DIM,), device=dev)
    o = 0
    for b, f, y, x in cells:
        z_g[b, f, y, x] = z_e[o: o + f.numel()]
        o += f.numel()

    torch.manual_seed(cfg.SEED)  # as chip_smoke.py's layout_parity
    grid = GridVoxelGNNGenerator(cfg).to(dev)
    critic = GridVoxelGNNDiscriminator(cfg).to(dev)
    with torch.no_grad():
        for m in (grid, critic):
            for p in m.parameters():
                p.add_(0.05 * torch.randn_like(p))
    edge = VoxelGNNGenerator(cfg).to(dev)
    edge.load_state_dict(grid.state_dict())
    assert isinstance(grid.encoder, GridHourglass)

    out = {}
    for prec in ("f32", "f64"):
        (gm, gbb), (em, pk) = ((grid, gb), (edge, pack)) if prec == "f32" else (
            as_f64(grid, gb), as_f64(edge, pack))
        zg, ze = (z_g, z_e) if prec == "f32" else (z_g.double(), z_e.double())
        with torch.no_grad():
            lg = gm(gbb, zg, gumbel_noise=torch.zeros(tuple(gb.mask.shape) + (7,), device=dev,
                                                      dtype=zg.dtype))[0]
            le = em(pk, ze, gumbel_noise=torch.zeros(nv, 7, device=dev, dtype=ze.dtype))[0]
        out[prec] = (torch.cat([lg[b, f, y, x] for b, f, y, x in cells]).double(),
                     le[:offset].double())
        print(f"{args.conv} {prec}: grid vs edge logits max abs "
              f"{(out[prec][0] - out[prec][1]).abs().max().item():.4g} over {offset} real cells",
              flush=True)
    for i, name in enumerate(("grid", "edge")):
        print(f"{args.conv} {name} f32 vs its f64 run: max abs "
              f"{(out['f32'][i] - out['f64'][i]).abs().max().item():.4g}"
              f"{' (edge norm sums in f64)' if args.f64_norm_sums else ''}", flush=True)


if __name__ == "__main__":
    main()
