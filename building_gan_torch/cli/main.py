"""Command-line entry points of the port: synth / preprocess / ingest / analyze / train /
sanity / viz / test.

Port of ``building_gan_tpu/cli/main.py``: every entry point takes flags
named after the configuration fields, with the configuration's defaults.
``--device`` (default ``cuda``) takes the place of ``--platform``: the
trainer runs on the card unless asked for the CPU.

    python -m building_gan_torch.cli.main synth --data-path data/raw --num 100
    python -m building_gan_torch.cli.main preprocess --data-path data/raw --save-data-path data/npz
    python -m building_gan_torch.cli.main ingest --src ref/processed --dst data/npz
    python -m building_gan_torch.cli.main analyze --data-path data/raw
    python -m building_gan_torch.cli.main train --save-data-path data/npz --log-dir runs/a \\
        --epochs 1000
    python -m building_gan_torch.cli.main sanity --save-data-path data/npz --epochs 5000
    python -m building_gan_torch.cli.main viz --data-path data/raw --num 6 --out-dir viz_out
    python -m building_gan_torch.cli.main test --save-data-path data/npz --log-dir runs/a

``ingest`` converts the reference's processed ``.pt`` pairs to NPZ (without
the reference package), ``analyze`` prints the raw dataset's statistics and
checks its FAR invariant, ``sanity`` is the reference's single-building
overfit harness (``Configuration(sanity_checking=True)``: building
``DATA_POINT``, one slot, no checkpoint, the best epoch's image in the
log), ``viz`` renders raw buildings to PNGs, and ``test`` prints the test
split's scores and then renders ``--num-samples-to-viz`` test buildings (10,
as in the JAX package; 0 renders none).  Renders need matplotlib and Pillow.
``--layout edges`` trains and tests on the packed edge-list layout (the
``--pack-*`` budgets), ``--conv-type`` picks the generator's and the
critic's conv (GATCONV, the default, is the one with fused CUDA kernels on
the grid; GCNCONV, GRAPHCONV and GATV2CONV run as plain PyTorch).
``--generator-arch transformer`` trains the grid transformer generator
against the grid critic (on the grid layout, as in the JAX package; the edge
layout keeps the hourglass generator), ``--batch-level-matching`` and
``--batch-level-graphnorm`` turn on the reference's merged-batch quirks Q1
and Q5, and ``--grid-buckets 6x6x6,8x8x8,11x12x12`` packs each building at
its smallest fitting grid shape.
``COMPUTE_DTYPE`` defaults to bfloat16 (f32 parameters, bf16 activations), as
in the JAX package; ``--compute-dtype float32`` computes in f32.  As in the
JAX CLI, float16 is not a choice here: it comes in through ``Configuration``
(and ``scripts/torch_demo_train.py --compute-dtype float16``).  A checkpoint
holds f32 parameters at any dtype.  ``train``, ``sanity`` and ``test`` take
``--mesh-data N`` (data parallelism, ``parallel/dp.py``): above 1 the CLI
starts N ranks itself, one process each (``torch.multiprocessing``, spawn),
rank r on ``cuda:r`` over NCCL, or on the CPU over gloo with ``--device cpu``;
they meet through a file store in a temporary directory.  On the card the
parent builds the CUDA sources once before it starts them, and touches no
card itself; more ranks than visible cards raises, naming both counts.
``--use-pallas``, ``--device-resident`` and ``--pack-gemms`` schedule TPU work
in the JAX package; here they are accepted and change nothing.

    python -m building_gan_torch.cli.main train --save-data-path data/npz --log-dir runs/a \\
        --mesh-data 4
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time


def _add_config_overrides(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data-path", default=None, help="raw data root (DATA_PATH)")
    p.add_argument("--save-data-path", default=None, help="processed data dir (SAVE_DATA_PATH)")
    p.add_argument("--log-dir", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None, help="graphs per step (BATCH_SIZE)")
    p.add_argument("--n-critic", type=int, default=None)
    p.add_argument("--conv-type", default=None, choices=["GCNCONV", "GRAPHCONV", "GATCONV", "GATV2CONV"])
    p.add_argument("--data-slicer", type=int, default=None)
    p.add_argument("--pack-graphs", type=int, default=None)
    p.add_argument("--pack-voxel-nodes", type=int, default=None)
    p.add_argument("--pack-voxel-edges", type=int, default=None)
    p.add_argument("--pack-local-nodes", type=int, default=None)
    p.add_argument("--pack-local-edges", type=int, default=None)
    p.add_argument("--mesh-data", type=int, default=None,
                   help="data-parallel ranks (MESH_DATA): one process and one card each")
    p.add_argument("--layout", default=None, choices=["grid", "edges"], help="compute layout (LAYOUT)")
    p.add_argument("--generator-arch", default=None, choices=["hourglass", "transformer"], help="GENERATOR_ARCH")
    p.add_argument("--batch-level-matching", action="store_true", help="quirk Q1 parity")
    p.add_argument("--batch-level-graphnorm", action="store_true", help="quirk Q5 parity")
    p.add_argument("--use-pallas", action="store_true", help="USE_PALLAS (no effect in the port)")
    p.add_argument("--compute-dtype", default=None, choices=["bfloat16", "float32"], help="COMPUTE_DTYPE")
    p.add_argument("--slot-graphs", type=int, default=None, help="buildings bin-packed per grid slot (GRID_SLOT_GRAPHS)")
    p.add_argument("--grid-local-nodes", type=int, default=None, help="packed local-node width per slot (GRID_LOCAL_NODES)")
    p.add_argument("--grid-buckets", default=None,
                   help="comma-separated FxYxX shapes (GRID_BUCKETS)")
    p.add_argument("--device-resident", action="store_true",
                   help="DEVICE_RESIDENT_DATA (no effect in the port)")
    p.add_argument("--device-resident-compositions", type=int, default=None,
                   help="DEVICE_RESIDENT_COMPOSITIONS (no effect in the port)")
    p.add_argument("--ckpt-latest-interval", type=int, default=None,
                   help="crash-recovery checkpoint every N epochs (CKPT_LATEST_INTERVAL; 0 = off)")
    p.add_argument("--pack-gemms", action="store_true", help="PACK_NARROW_GEMMS (no effect in the port)")
    p.add_argument("--hourglass-min-channels", type=int, default=None,
                   help="clamp the hourglass channel halving at this floor "
                        "(HOURGLASS_MIN_CHANNELS; 1 = reference schedule)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train and test on (default cuda; cpu to run without a GPU)")


def _build_config(args):
    from ..config import Configuration

    cfg = Configuration()
    mapping = {
        "data_path": "DATA_PATH",
        "save_data_path": "SAVE_DATA_PATH",
        "log_dir": "LOG_DIR",
        "epochs": "EPOCHS",
        "seed": "SEED",
        "batch_size": "BATCH_SIZE",
        "n_critic": "N_CRITIC",
        "data_slicer": "DATA_SLICER",
        "pack_graphs": "PACK_GRAPHS",
        "pack_voxel_nodes": "PACK_VOXEL_NODES",
        "pack_voxel_edges": "PACK_VOXEL_EDGES",
        "pack_local_nodes": "PACK_LOCAL_NODES",
        "pack_local_edges": "PACK_LOCAL_EDGES",
        "mesh_data": "MESH_DATA",
        "layout": "LAYOUT",
        "generator_arch": "GENERATOR_ARCH",
        "compute_dtype": "COMPUTE_DTYPE",
        "slot_graphs": "GRID_SLOT_GRAPHS",
        "grid_local_nodes": "GRID_LOCAL_NODES",
        "device_resident_compositions": "DEVICE_RESIDENT_COMPOSITIONS",
        "ckpt_latest_interval": "CKPT_LATEST_INTERVAL",
        "hourglass_min_channels": "HOURGLASS_MIN_CHANNELS",
    }
    overrides = {}
    for arg_name, field in mapping.items():
        v = getattr(args, arg_name, None)
        if v is not None:
            overrides[field] = v
    if getattr(args, "conv_type", None):
        overrides["GENERATOR_CONV_TYPE"] = args.conv_type
        overrides["DISCRIMINATOR_CONV_TYPE"] = args.conv_type
    for flag, field in (("batch_level_matching", "BATCH_LEVEL_MATCHING"),
                        ("batch_level_graphnorm", "BATCH_LEVEL_GRAPHNORM"),
                        ("use_pallas", "USE_PALLAS"),
                        ("device_resident", "DEVICE_RESIDENT_DATA"),
                        ("pack_gemms", "PACK_NARROW_GEMMS")):
        if getattr(args, flag, False):
            overrides[field] = True
    if getattr(args, "grid_buckets", None):
        overrides["GRID_BUCKETS"] = tuple(
            tuple(int(d) for d in shape.split("x")) for shape in args.grid_buckets.split(",")
        )
    return cfg.replace(**overrides) if overrides else cfg


def cmd_synth(args):
    from ..data.synthetic import write_dataset

    root = args.data_path or _build_config(args).DATA_PATH
    write_dataset(root, args.num, seed=args.seed or 0)
    print(f"wrote {args.num} synthetic buildings under {root}")


def cmd_preprocess(args):
    from ..data.preprocess import create_dataset

    cfg = _build_config(args)
    t0 = time.time()
    n = create_dataset(cfg, workers=getattr(args, "workers", 0))
    dt = time.time() - t0
    print(f"processed {n} buildings in {dt:.1f}s ({n / max(dt, 1e-9):.2f} it/s)")


def cmd_ingest(args):
    """Convert the reference's processed ``.pt`` dataset into the NPZ layout
    (reference `data.py:457-461` torch.save pairs -> GraphDataset-loadable)."""
    from ..data.ingest import convert_reference_processed

    n = convert_reference_processed(args.src, args.dst, compress=args.compress)
    print(f"converted {n} buildings: {args.src} -> {args.dst}")


def cmd_analyze(args):
    from ..utils.analyze import analyze_dataset

    analyze_dataset(_build_config(args))


def _trainer_config(args, sanity: bool):
    cfg = _build_config(args)
    if sanity:  # as Configuration(sanity_checking=True): one building (DATA_POINT), one slot
        cfg = cfg.replace(SANITY_CHECKING=True)
    cfg.require_ported_dtype(f"building_gan_torch {args.cmd}")  # before the data loads
    return cfg


def _make_trainer(args, cfg, device, group=None):
    """The trainer of ``cfg`` on ``device``; with ``group``, its rank's (the rank's packs)."""
    import torch

    from ..data.pipeline import GraphDataLoaders
    from ..models.discriminator import VoxelGNNDiscriminator
    from ..models.generator import VoxelGNNGenerator
    from ..models.grid_models import GridVoxelGNNDiscriminator, GridVoxelGNNGenerator
    from ..models.transformer import GridTransformerGenerator
    from ..train.trainer import Trainer

    if group is None:
        loaders = GraphDataLoaders(cfg)
    else:
        loaders = GraphDataLoaders(cfg, n_device_batches=group.size(), rank=group.rank())
    torch.manual_seed(cfg.SEED)  # the models' initial weights, alike on every rank
    if cfg.LAYOUT == "grid":
        G = GridTransformerGenerator if cfg.GENERATOR_ARCH == "transformer" else GridVoxelGNNGenerator
        gen, disc = G(cfg), GridVoxelGNNDiscriminator(cfg)
    else:  # the packed edge-list layout
        gen, disc = VoxelGNNGenerator(cfg), VoxelGNNDiscriminator(cfg)
    return Trainer(gen, disc, loaders, cfg, log_dir=args.log_dir, device=device, group=group)


def _act(trainer, args, action: str) -> None:
    if action == "test":
        trainer.test(num_samples_to_viz=args.num_samples_to_viz, show=args.show)
    else:
        trainer.train()


def _rank_main(rank: int, n: int, store_path: str, args, cfg, action: str, threads: int) -> None:
    """One data-parallel rank of the CLI (a spawned process): join the group, then the
    trainer on the rank's device and packs."""
    import torch

    from ..parallel import mesh

    device_type = torch.device(args.device).type
    if device_type == "cpu":  # the ranks share the parent's threads
        torch.set_num_threads(max(1, threads // n))
    group = mesh.init_data_group(rank, n, store_path, device_type)
    try:
        _act(_make_trainer(args, cfg, mesh.rank_device(rank, device_type), group), args, action)
    finally:
        mesh.destroy_data_group()


def _run(args, action: str, sanity: bool = False) -> None:
    """``action`` ("train" or "test") on one device, or on ``--mesh-data`` ranks."""
    import torch

    from ..parallel import mesh

    cfg = _trainer_config(args, sanity)
    n = cfg.MESH_DATA
    if n <= 1:
        _act(_make_trainer(args, cfg, args.device), args, action)
        return
    device_type = torch.device(args.device).type
    mesh.check_ranks(n, device_type)
    if device_type == "cuda":
        from ..ops import _build

        _build.build_all()  # once, here, so the ranks load the built libraries
    with tempfile.TemporaryDirectory(prefix="bgt_ranks_") as d:
        torch.multiprocessing.spawn(
            _rank_main, nprocs=n, join=True,
            args=(n, os.path.join(d, "store"), args, cfg, action, torch.get_num_threads()))


def cmd_train(args):
    _run(args, "train")


def cmd_sanity(args):
    _run(args, "train", sanity=True)


def cmd_viz(args):
    from ..viz.raw import render_raw_samples

    paths = render_raw_samples(_build_config(args), list(range(args.num)), args.out_dir)
    print("\n".join(paths))


def cmd_test(args):
    _run(args, "test")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="building_gan_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("synth", help="generate a synthetic raw dataset")
    p.add_argument("--num", type=int, default=100)
    _add_config_overrides(p)
    p.set_defaults(fn=cmd_synth)

    p = sub.add_parser("preprocess", help="raw JSON -> NPZ pairs")
    p.add_argument("--workers", type=int, default=0, help="host-parallel worker processes")
    _add_config_overrides(p)
    p.set_defaults(fn=cmd_preprocess)

    p = sub.add_parser("ingest", help="reference processed .pt pairs -> NPZ dataset")
    p.add_argument("--src", required=True, help="directory of {num}_local.pt/{num}_voxel.pt")
    p.add_argument("--dst", required=True, help="output directory for NPZ pairs")
    p.add_argument("--compress", action="store_true")
    p.set_defaults(fn=cmd_ingest)

    p = sub.add_parser("analyze", help="dataset statistics + FAR invariant check")
    _add_config_overrides(p)
    p.set_defaults(fn=cmd_analyze)

    p = sub.add_parser("train", help="full training run")
    _add_config_overrides(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("sanity", help="single-datum overfit harness")
    _add_config_overrides(p)
    p.set_defaults(fn=cmd_sanity)

    p = sub.add_parser("viz", help="render raw buildings from JSON (data-visualization notebook)")
    p.add_argument("--num", type=int, default=6)
    p.add_argument("--out-dir", default="viz_out")
    _add_config_overrides(p)
    p.set_defaults(fn=cmd_viz)

    p = sub.add_parser("test", help="test-split metrics + qualitative eval")
    p.add_argument("--num-samples-to-viz", type=int, default=10,
                   help="test samples to render (needs matplotlib and Pillow; 0 renders none)")
    p.add_argument("--show", action="store_true")
    _add_config_overrides(p)
    p.set_defaults(fn=cmd_test)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
