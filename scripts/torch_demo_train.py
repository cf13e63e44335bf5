"""Training-quality assay of the PyTorch port: the counterpart of scripts/demo_train.py.

Synthesises a 10k-style dataset (``write_dataset``), preprocesses it with the
native JSON parser (``create_dataset(workers=8)``), then trains the grid
models at the configuration of record's widths on a (10, 6, 6) grid with the
port's ``Trainer`` and prints the test split's scores.  The flags are
demo_train.py's, plus ``--device`` (default ``cuda``; ``cpu`` to run on the
host).  ``--compute-dtype`` takes any COMPUTE_DTYPE the port computes in
(bfloat16 by default, float32, float16).  ``--prng``, ``--device-resident`` and
``--device-resident-compositions`` are accepted and do nothing: they schedule
TPU work, as the port's ``Configuration`` fields of the same names
(``PRNG_IMPL``, ``DEVICE_RESIDENT_DATA``, ...) do.

Resume: the trainer resumes from ``--log-dir`` when it holds a checkpoint
(``states.pt`` / ``states_latest.pt`` and their ``.meta.json``), so a long
run continues across calls when its log dir is seeded with the last call's
files; ``--ckpt-latest-interval`` sets how often the latest one is written.

Usage: python scripts/torch_demo_train.py [--buildings 2048] [--epochs 60]
       [--grid-batch 512] [--compute-dtype float16] [--device cuda] [...]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--buildings", type=int, default=2048)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--grid-batch", type=int, default=512)
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "bgt_torch_demo"),
                    help="dataset and run directory (default: bgt_torch_demo in the temp dir)")
    ap.add_argument("--log-dir", default=None, help="the run's log dir (default: ROOT/runs/demo)")
    ap.add_argument("--batch-level-quirks", action="store_true",
                    help="reference parity mode: Q1 batch-level matching + Q5 batch-level GraphNorm")
    ap.add_argument("--prng", default="auto",
                    help="PRNG_IMPL; accepted for demo_train.py's command lines, read by nothing")
    ap.add_argument("--compute-dtype", default=None,
                    help="override COMPUTE_DTYPE (bfloat16 default; float32; float16)")
    ap.add_argument("--gp-dtype", default=None,
                    help="critic dtype inside the GP branch: compute (default) | float32")
    ap.add_argument("--seed", type=int, default=None,
                    help="override config SEED (default 777) for repeat runs")
    ap.add_argument("--ckpt-latest-interval", type=int, default=25,
                    help="crash-recovery checkpoint every N epochs (0 = off; "
                         "best-gated saves always on)")
    ap.add_argument("--device-resident-compositions", type=int, default=1,
                    help="DEVICE_RESIDENT_COMPOSITIONS; accepted, read by nothing")
    ap.add_argument("--device-resident", action="store_true",
                    help="DEVICE_RESIDENT_DATA; accepted, read by nothing")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def make_config(args):
    """demo_train.py's Configuration, as the port's."""
    from building_gan_torch.config import Configuration

    return Configuration(
        DATA_PATH=os.path.join(args.root, "raw"),
        SAVE_DATA_PATH=os.path.join(args.root, "processed"),
        EPOCHS=args.epochs,
        GRID_SHAPE=(10, 6, 6),
        GRID_BATCH=args.grid_batch,
        GRID_LOCAL_NODES=64,
        LOG_DIR=os.path.join(args.root, "runs"),
        BATCH_LEVEL_MATCHING=args.batch_level_quirks,
        BATCH_LEVEL_GRAPHNORM=args.batch_level_quirks,
        PRNG_IMPL=args.prng,
        DEVICE_RESIDENT_DATA=args.device_resident,
        DEVICE_RESIDENT_COMPOSITIONS=args.device_resident_compositions,
        CKPT_LATEST_INTERVAL=args.ckpt_latest_interval,
        **({"COMPUTE_DTYPE": args.compute_dtype} if args.compute_dtype else {}),
        **({"GP_DTYPE": args.gp_dtype} if args.gp_dtype else {}),
        **({"SEED": args.seed} if args.seed is not None else {}),
    )


def main(argv=None) -> dict:
    args = parse_args(argv)
    import torch

    from building_gan_torch.data.pipeline import GraphDataLoaders
    from building_gan_torch.data.preprocess import create_dataset
    from building_gan_torch.data.synthetic import write_dataset
    from building_gan_torch.models.grid_models import GridVoxelGNNDiscriminator, GridVoxelGNNGenerator
    from building_gan_torch.train.trainer import Trainer

    cfg = make_config(args)
    cfg.require_ported_dtype("torch_demo_train.py")
    proc = cfg.SAVE_DATA_PATH
    if not os.path.isdir(proc) or len(os.listdir(proc)) < 2 * args.buildings:
        print(f"synthesizing {args.buildings} buildings...", flush=True)
        write_dataset(cfg.DATA_PATH, args.buildings, seed=0)
        create_dataset(cfg, verbose=True, workers=8)

    loaders = GraphDataLoaders(cfg)
    torch.manual_seed(cfg.SEED)  # the models' initial weights, as the port's CLI draws them
    gen, disc = GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg)
    log_dir = args.log_dir or os.path.join(args.root, "runs", "demo")
    trainer = Trainer(gen, disc, loaders, cfg, log_dir=log_dir, device=args.device)
    trainer.train()
    out = trainer.test(num_samples_to_viz=0)
    print("TEST:", out, flush=True)
    return out


if __name__ == "__main__":
    main()
