#!/usr/bin/env python3
"""Where a floor-sharded train step's time goes on the card, beside the one-card plain step.

    python3 scripts/torch_sp_profile.py [--ranks 2] [--dtype float32]

Takes ``chip_smoke.py``'s phase-14 batch (the train batch's 256 real-scale
buildings packed K = 6 at (12, 12, 12)) and models (the config of record's
widths, weights from its seed, SGD), then runs on cuda:0 the one-card plain
step (``make_train_step(..., fused=False)``) and on ``--ranks`` cards, one NCCL
process each, the floor-sharded step (``parallel/sp.py::make_sp_train_step``).
For each: two warm-up steps, one step with its host synchronisations counted
(``torch.cuda.set_sync_debug_mode``), then one step under ``torch.profiler``:
wall ms (host clock, synchronised), device busy ms (the sum of the trace's
device rows), CPU ops launched, the top CPU ops by self time and the top device
rows.  Prints the one-card block, then rank 0's and every rank's wall ms.
Needs ``--ranks`` CUDA devices.
"""

import argparse
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402  (the phase-14 batch, models and helpers)


def profiled(step, batch, dev) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(2):
        step(batch, gen)
    _, syncs, where = cs.count_syncs(lambda: step(batch, gen))
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(batch, gen)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t) * 1e3
    ka = prof.key_averages()
    device = sorted(((e.key, e.self_device_time_total / 1e3) for e in ka
                     if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                    key=lambda kv: -kv[1])
    cpu = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in ka
                  if e.device_type == DeviceType.CPU), key=lambda kv: -kv[1])
    return {"ms": ms, "busy": sum(v for _, v in device), "syncs": syncs,
            "where": where.most_common(4), "device": device[:12], "cpu": cpu[:15],
            "ops": sum(c for _, _, c in cpu)}


def report(label, r, card) -> None:
    print(f"{label}: step {r['ms']:.1f} ms, device busy {r['busy']:.1f} ms "
          f"({100 * r['busy'] / r['ms']:.1f}%), {r['ops']} CPU ops, host syncs {r['syncs']} "
          f"{r['where']} on {card}")
    for k, v, c in r["cpu"]:
        print(f"  cpu    {v:9.2f} ms  x{c:<6d} {k[:90]}")
    for k, v in r["device"]:
        print(f"  device {v:9.2f} ms  {k[:100]}")


def rank_main(rank, n, store, cfg, batch, out_dir):
    from building_gan_torch.parallel import mesh, sp

    torch.backends.cuda.matmul.allow_tf32 = False
    group = mesh.init_data_group(rank, n, store, "cuda")
    dev = mesh.rank_device(rank, "cuda")
    try:
        state = cs.sp_state(cfg, dev, cfg.COMPUTE_DTYPE)
        step = sp.make_sp_train_step(cfg, state, sp.make_floor_shard(group, cs.SP_GRID[0]))
        torch.save(profiled(step, batch.to(dev), dev), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        mesh.destroy_data_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    args = ap.parse_args()
    if torch.cuda.device_count() < args.ranks:
        print(f"needs {args.ranks} CUDA devices, has {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    from building_gan_torch.ops import _build
    from building_gan_torch.train.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(("gat_train",))
    card = cs.card_line()
    cfg, batch = cs.sp_batch()
    cfg = cs.sp_cfg(cfg, args.dtype)
    dev = torch.device("cuda", 0)
    state = cs.sp_state(cfg, dev, args.dtype)
    report(f"one card, plain step ({args.dtype})",
           profiled(make_train_step(cfg, state, fused=False), batch.to(dev), dev), card)
    del state
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="bgt_sp_profile_") as out_dir:
        torch.multiprocessing.spawn(rank_main, nprocs=args.ranks, join=True,
                                    args=(args.ranks, os.path.join(out_dir, "store"), cfg, batch,
                                          out_dir))
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                 for r in range(args.ranks)]
    report(f"floor-sharded step, rank 0 of {args.ranks} NCCL ranks ({args.dtype})", ranks[0], card)
    print("every rank's profiled step: " + ", ".join(f"{r['ms']:.1f} ms" for r in ranks))
    return 0


if __name__ == "__main__":
    sys.exit(main())
