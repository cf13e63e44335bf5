#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (building_gan_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --steps N   # only N train steps, timed (to compare trees)
    python3 chip_smoke.py --dp   # only phase 13 (data parallelism; NCCL across
        # the cards too on a host of 2 to 4)
    python3 chip_smoke.py --sp   # only phase 14 (floor sharding; NCCL on 2 and 4
        # cards too on a host of 4)
    python3 chip_smoke.py --f16   # only phases 15 and 16 (float16, the native runtime)
    python3 chip_smoke.py --time-hourglass [DIR]   # only the serving kernel, timed;
        # DIR: a checkout whose building_gan_torch is timed instead (to compare trees)

Phases, one short output line or a few each:
  1. the card (nvidia-smi name and power limit) and the torch version;
  2. build csrc/hourglass.cu and csrc/gat_train.cu with nvcc, one process
     each, in parallel (plain C interfaces, loaded with ctypes); build
     seconds and each kernel's ptxas registers and shared memory;
  3. the hourglass kernel against its plain PyTorch version on the card, at
     the config of record's widths (hidden 128, repeat 7, grid (11,12,12),
     16 slots), one building per slot (K=1) and four (K=4);
  4. the main path: InferenceServer at the config of record, random weights
     from a seed, >= 32 requests of real-scale synthetic buildings from
     several threads; outputs checked, served-alone == served-in-a-batch,
     fused logits == the plain generator's, kernel launches counted;
  5. the kernel and its plain version timed with CUDA events at the server's
     shapes, against the card's bound; the kernel's launches a stack call,
     the cluster size it chooses, CTAs, shared memory, registers and spills
     (ptxas), and for every cluster size that fits the clusters the card
     holds at once (cudaOccupancyMaxActiveClusters) and the time, in turns;
     its device time by layer and by phase (each CTA's %globaltimer at its
     trace points); then the serving main path again at the JAX package's
     default COMPUTE_DTYPE, bfloat16 (the kernel's bf16 storage): the same
     checks, p50 / p99 and buildings/s beside the f32 figures, and the kernel
     and its plain bf16 twin timed at bf16;
  6. the training layer's kernels (csrc/gat_train.cu, forward and backward)
     against their plain version at full width on packed real-scale
     buildings (K=6, dropout on, the same Philox keys): the generator stack
     (Cmax 128, 14 layers) and the critic stack (Cmax 64, 6 layers), output
     and gx / gW / gatt / gvec, each stack whole and each layer alone on the
     kernel's own activations (the stack equal to the chain of layer calls
     bit for bit), on every slot of the train batch; one layer's keep
     mask read back bit for bit; then all three kernels with bf16 storage
     against their plain bf16 twins and f64: the hourglass at the server's
     shapes (K=1, K=4), both training stacks forward and backward (K=6,
     dropout on) each layer alone on the kernel's activations, and the
     generator's two odd-width layers (2 -> 1, 1 -> 2) alone at K=3;
  7. the training main path: 256 real-scale synthetic buildings packed at
     K=6 ("cell" mode), random weights from a seed, 3 WGAN-GP train steps
     (N_CRITIC=5, f32) through train/step.py; losses and metrics finite,
     150 forward and 80 backward layer launches a step, and 30 launches of
     the Philox dropout-byte kernel (the plain gradient-penalty critic
     pass's masks, one a critic layer); each step's peak device memory;
     those masks held bit for bit against ops/dropout.py::keep_mask at the
     step's critic shapes, and the step timed in turns with keep_mask's int64
     Philox patched back into that pass (as before the port drew those masks
     on the card) and with the kernel; then 3 steps at the JAX package's
     defaults (COMPUTE_DTYPE bfloat16, GP_DTYPE "compute") with the same
     launch checks, one at GP_DTYPE "float32", and the f32 and bf16 steps in
     turns (ms, real voxel nodes/s, peak device memory);
  8. train-step time and nodes/s, and the stacks' forward and backward
     kernels against their plain versions and their bounds, at the step's
     shapes and trained weights (the kernel stacks also held against the
     plain version in f64 there, each layer alone on the kernel's
     activations, and whole at f32); each stack's device time by sub-kernel
     (torch.profiler) and each layer's forward and backward time; the step
     traced with the int64 masks and with the kernel: the int64 kernels must
     be gone from the kernel path's trace; the stacks again with bf16
     storage; the eval step at f32 and at bf16 (its launches, in turns); the
     bf16 step traced too (device busy share, top kernels);
  9. the trainer: 256 real-scale buildings as raw JSON, then the CLI in
     subprocesses on the card (preprocess; train 2 epochs at the config of
     record with a latest checkpoint each epoch; train again to 3 epochs,
     which resumes from the latest checkpoint; test, rendering one test
     building where matplotlib and Pillow import), once with
     --compute-dtype float32 and once at the defaults (bf16); checkpoints,
     metas and scalar tags checked; then in process a Trainer on the f32 log
     dir: one eval step and Trainer.generate with their kernel launches
     counted, generate's
     logits against the plain generator's, one train and one validation
     epoch with their host syncs counted (torch.cuda.set_sync_debug_mode),
     seconds an epoch, ms an eval batch, checkpoint write and resume seconds,
     and the eval step's peak device memory;
  10. the conv registry and the edge layout, plain PyTorch on the card (no
     kernel of their own): (a) GATV2CONV, GCNCONV and GRAPHCONV on phase 7's
     batch, 2 train steps at bf16 and 2 at f32 each (finite, no hourglass or
     training-layer launch, every dropout mask's bytes from the Philox kernel,
     step ms, real voxel nodes/s, peak device memory), an eval step, and a
     server answering 16 requests from 4 threads (alone == batched); (b) the
     same 512 buildings packed at the JAX default budgets (the pack count and
     each budget's fill), the fullest pack through 2 bf16 steps for each of the
     four convs (GATCONV also 1 at f32); (c) grid-vs-edge parity for the four
     convs: one state_dict in both layouts, 16 buildings, f32, deterministic
     algorithms, the same z, logits and scores on real cells within rtol 5e-3 /
     atol 1e-3; (d) the CLI on phase 9's buildings: train --layout edges (1
     epoch) and test, train --conv-type GCNCONV (1 epoch);
  11. the reference's other training modes, the transformer generator,
     GRID_BUCKETS and the router, at the config of record's widths: (a) the
     BCE losses (USE_WGANGP=False) on phase 7's batch, 2 bf16 steps and 1 f32
     step, 150 / 80 training-layer launches and no dropout-byte launch (no
     penalty: every critic pass fused); (b) BATCH_LEVEL_MATCHING, 2 bf16 steps
     with phase 7's launches, then both batch-level flags, 2 bf16 steps with no
     layer-kernel launch; (c) the transformer generator (hidden 128, 4 blocks
     of 4 heads) against the GATCONV critic, 2 bf16 steps and 1 f32 step with
     66 / 66 training-layer launches, an eval step, and one K = 6 slot's
     buildings each alone against inside the slot (f32, within 1e-3); (d) the
     512 buildings through the GRID_BUCKETS loader at (6,6,6), (8,8,8) and
     (11,12,12), K = 6: at each bucket shape the hourglass (f32, bf16) by the
     f64 rules, its cluster size and time, both training stacks layer by
     layer (f32, bf16), the generator stack timed, one bf16 train step; then
     the CLI's train --grid-buckets (1 epoch) and test; (e) a RoutingServer
     over GATCONV servers of grids (8,8,8) and (11,12,12): 32 requests of
     mixed sizes from 8 threads routed by size, one by name, a weight swap
     mid-stream (none dropped, later requests on the new version), alone ==
     batched, one hourglass launch a batch, p50 / p99 a server;
  12. the reference's other surfaces on phase 9's buildings: (a) the CLI's
     sanity --epochs 20 in process at the config of record and f32 (building
     DATA_POINT in one slot, K=1: 150 / 80 / 30 launches a step, losses
     finite, no checkpoint, the reference tags, the best epoch's image, or
     "render skipped" where matplotlib or Pillow is missing); (b) at that one
     slot the hourglass (f32, bf16) and both training stacks (f32, bf16) layer
     by layer by the f64 rules, timed against their bounds, and 3 f32 steps;
     (c) best_of_k, 3 restarts, on a Trainer on phase 9's f32 log dir: one
     hourglass launch a restart, the F1 kept the restarts' best; where
     matplotlib and Pillow import, a rendered CHW uint8 strip; (d) analyze on
     the raw JSON (the FAR invariant) and ingest of 4 buildings written as the
     reference's .pt pairs, bit-equal to their NPZ files; (e) the bf16 step's
     roofline share (utils/roofline.py, the H100's published peaks) at phase
     7's batch;
  13. data parallelism (parallel/mesh.py, parallel/dp.py), f32 then bf16: the
     train batch's 107 slots as two packs of GRID_BATCH 54; two ranks sharing
     the card as threads over gloo (CUDA tensors): (a) the same pack on both
     and (b) a pack and a null pack against the one-device step, (c) the two
     uneven packs against a sequential oracle weighting each pack's gradients
     by its real cells before each Adam update (metrics rtol 1e-4 / atol
     1e-5, parameters 1e-4 / 1e-6), the replicas equal bit for bit after 3
     steps, 150 / 80 / 30 launches a rank a step, a null pack finite through
     the kernels, step ms, nodes/s and all-reduce ms; NCCL at one rank (a
     step against one device, host syncs); a Trainer of two thread ranks on
     phase 9's buildings (1 epoch, rank 0's checkpoint and log, test, its
     eval launches a rank); on a host of 2-4 cards NCCL with one rank a card
     (spawned processes): the same checks, the kernels on the last card with
     card 0 current, times, and the CLI's train / test --mesh-data N; on one
     card a line saying why that part did not run;
  14. floor sharding (parallel/sp.py) at the config of record's widths, the
     train batch's 256 buildings packed K=6 at (12, 12, 12) (100 slots), SGD:
     two gloo ranks sharing the card as threads (CUDA tensors): the four halo
     stencils against the unsharded ones (forward bit for bit, first- and
     second-order input gradients within 1e-6 of scale), the generator forward
     at f32 and bf16 against one card's by the f64 rules, the step at f32 (2
     steps), bf16 and f64, with N_CRITIC 5 and 0, against the one-card plain
     step (make_train_step(..., fused=False)) by the f64 rule (sp_hold), the
     f64 steps within SP_F64_REL / SP_F64_PURE, the replicas equal bit for
     bit, 0 / 0 / 0 / 180 launches a rank a step, step ms, the collectives' ms
     and calls, peak memory; on a host of 2-4 cards (``--sp``) the same with
     NCCL on 2 and on 4 cards, one rank process a card (6 and 3 floors each);
     on one card a line saying why that part did not run;
  15. COMPUTE_DTYPE float16 at the config of record's widths: (a) all three
     kernels with f16 storage against their plain f16 twins and f64 (as phase
     6's bf16 checks: the hourglass at the server's shapes, K=1 and K=4; both
     training stacks each layer alone on the kernel's activations at the train
     batch's 107 slots, K=6, dropout on, the stack equal to the chain bit for
     bit); (b) the serving main path at f16 (48 requests, alone == batched, the
     launches), the fused f16 generator against the f64 generator within 4x the
     plain f16 generator's distance plus 1e-3, the plain f16 generator with
     cuBLAS's reduced-precision f16 reductions on and off, the kernel timed;
     (c) 3 f16 train steps at GP_DTYPE "compute" (150 / 80 / 30 launches; a
     non-finite metric is printed and recorded, not raised: f16's range is a
     property of the dtype) and one at "float32", ms, real voxel nodes/s, peak
     memory; the stacks timed and held at the step's weights; one f16 eval
     batch; (d) one f16 step of the edge layout and of the transformer: finite,
     their launches;
  16. the native host runtime: create_dataset on phase 9's raw buildings with
     the C++ JSON parser and with Python's json, every NPZ array bit-equal (and
     to phase 9's CLI preprocess); the NativeBatcher against the PyBatcher on
     one scripted sequence of submits; the batcher the phase-4 server ran on;
  17. the run's seconds and a {"kernels": [...]} line: each kernel at f32, bf16
     and f16 storage ("dtype"), launches from that dtype's main path;
  18. the server stopped, every thread joined, and the result line last.

Every kernel is held against its plain version run in float64, the gradients
too, by two rules: its max abs error within 4x the plain float32 version's own,
plus 1e-4; and its norm-relative error within 4x the plain float32 version's
own, plus 1e-4.  With bf16 or f16 storage the plain version is the twin at
that dtype (f32 math, the same roundings) and the f64 reference rounds to it
where the kernel stores (each layer's output, and gx): the twin's distance
from it is f32 rounding alone, where it moves a value across a rounding
boundary, so the max abs rule also allows one ulp of that dtype (bf16: 8
significant bits, f16: 11) at the largest value.  The
training kernels are held so layer by layer on the kernel's own activations,
at the train step's 105 slots, the stack equal to the chain of layer calls
bit for bit; at f32 also as whole stacks.  A whole 16-bit stack is
not held by the rules: its rounding flips compound through the narrow
GraphNorm layers (its distances are printed).
Parity phases run f32 with TF32 off (torch.backends.cuda.matmul.allow_tf32
and torch.backends.cudnn.allow_tf32 both False).  Any failure is an uncaught
exception and a non-zero exit.  Without a CUDA device it exits 1 at once.
"""

import functools
import gc
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 without tensor cores (the kernel uses no TF32)
# The kernel is held against the plain version run in float64 on the same
# inputs: its max abs error must be at most ROUNDING_FACTOR times that of the
# plain version run in float32, plus ROUNDING_ATOL.  A fixed tolerance does not
# fit: the stack's 1-channel GraphNorm layers (hourglass 128 -> 1 -> 128) can
# magnify f32 rounding to ~1e-2 on a few outputs of order 10, while an indexing
# or statistics fault moves outputs by their own size.
ROUNDING_FACTOR, ROUNDING_ATOL = 4.0, 1e-4
REL_ATOL = 1e-4  # norm-relative error allowed beyond ROUNDING_FACTOR x the plain f32 version's
LOGITS_ATOL = 1e-3  # fused vs plain generator logits, f32 both
BF16 = torch.bfloat16
F16 = torch.float16
HALF_DTYPES = (BF16, F16)  # the kernels' 16-bit storage types
REQUESTS, CLIENTS, MAX_BATCH = 48, 16, 16
REQUEST_TIMEOUT_S = 120.0


def say(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, iters: int) -> float:
    """Device ms a call of fn, CUDA events around iters calls.  The garbage collector
    is run before and kept off during the window (as timeit does): a collection in
    the window stalls the host, the device idles, and the events count the idle."""
    gc.collect()
    gc.disable()
    try:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
    finally:
        gc.enable()
    return start.elapsed_time(end) / iters


def bound_of(B, R, chans, cmax, K, act_bytes=4):
    """(bound_ms, bound_by, bytes, flops) of one hourglass call on an H100 SXM.

    Bytes: x and out (B, R, cmax) at ``act_bytes`` an element (4: f32, 2:
    bf16 or f16), the mask plane, the gid plane when K > 1, and the packed f32
    weights, each moved once.  Operations at the real
    ci x co widths: the GEMM (2 ci co a row), the two scores (4 co), the
    7-way aggregate (14 co) and GraphNorm statistics and apply (6 co).
    """
    L = len(chans)
    nbytes = act_bytes * 2 * B * R * cmax + 4 * (B * R * (2 if K > 1 else 1) + L * cmax * (cmax + 6))
    flops = sum(B * R * (2 * ci * co + 24 * co) for ci, co in chans)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


# The training slice: real-scale buildings packed K=6 (as bench.py), 3 steps.  The train
# batch packs the first TRAIN_BATCH_BUILDINGS of the TRAIN_BUILDINGS (~105 slots): all 512
# take 190 slots since the cell packer stopped placing buildings over each other.
TRAIN_BUILDINGS, TRAIN_BATCH_BUILDINGS, TRAIN_SLOT_GRAPHS, TRAIN_STEPS = 512, 256, 6, 3
GRAD_NAMES = ("gx", "gW", "gatt", "gvec")
DROPOUT_RATE = 0.2


def ulp16(t, dtype=BF16) -> float:
    """One ulp of the 16-bit storage dtype (bf16: 8 significant bits, f16: 11) at the
    largest |value| of t."""
    m = t.abs().max().item()
    nmant = round(-math.log2(torch.finfo(dtype).eps))  # stored significand bits: 7, 10
    return 2.0 ** (math.floor(math.log2(m)) - nmant) if m > 0 else 0.0


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def f64_rule(got, want, want64):
    """Hold one kernel output against its plain version run in f64, by two rules.

    The plain version is the kernel's twin at its storage dtype: f32, or the
    16-bit twin (bf16 or f16: f32 math, the same roundings).  At a 16-bit
    storage the f64 reference takes the same 16-bit inputs and rounds to that
    dtype where the kernel stores (``Store16``), so the twin's distance from it
    is f32 rounding alone.  Max abs: |kernel - f64| <= ROUNDING_FACTOR * |plain
    - f64| + ROUNDING_ATOL, plus, for an output stored in 16 bits, one ulp of
    that dtype at the largest value: where f32 rounding moves a value across a
    rounding boundary the stored value moves by one ulp, in the kernel or the
    twin or neither.
    Norm-relative: ||kernel - f64|| / ||f64|| <= ROUNDING_FACTOR * (the same of
    plain) + REL_ATOL; a few cells where f32 rounding flips a ReLU (or a bf16
    rounding) barely move it, a missing or wrong term does.  Returns (ok,
    report, kernel's max abs error against f64).
    """
    g64, p64 = got.double(), want.double()
    err = (got.double() - p64).abs().max().item()
    err_k64 = (g64 - want64).abs().max().item()
    err_p64 = (p64 - want64).abs().max().item()
    limit = ROUNDING_FACTOR * err_p64 + ROUNDING_ATOL + (
        ulp16(want64, want.dtype) if want.dtype in HALF_DTYPES else 0.0)
    norm = max(want64.norm().item(), 1e-300)
    rel_k = (g64 - want64).norm().item() / norm
    rel_p = (p64 - want64).norm().item() / norm
    rel_limit = ROUNDING_FACTOR * rel_p + REL_ATOL
    ok = bool(torch.isfinite(got).all().item()) and err_k64 <= limit and rel_k <= rel_limit
    pl = "plain " + ("f32" if want.dtype == torch.float32 else dtype_name(want.dtype))
    report = (f"(max |f64| {want64.abs().max().item():.3e}): vs {pl} {err:.3e}; vs f64 max abs: "
              f"kernel {err_k64:.3e}, {pl} {err_p64:.3e}, limit {limit:.3e}; norm-relative: "
              f"kernel {rel_k:.2e}, {pl} {rel_p:.2e}, limit {rel_limit:.2e} "
              f"{'ok' if ok else 'FAIL'}")
    return ok, report, err_k64


def train_bound(B, R, chans, cmax, backward, dropout, act_bytes=4):
    """(bound_ms, bound_by, bytes, ops) of one training stack pass (one launch a layer).

    Summed over the layers.  Bytes the layer function must move, once each:
    forward, x (ci channels) and the planes (8 floats a row) and the packed
    weights in, y (cmax) out; backward, x, gy (co), the planes and the weights
    in, gx (cmax) and the weight grads out; the activations x, y, gy and gx at
    ``act_bytes`` an element (4: f32, 2: bf16 or f16), the rest f32.  What the kernels save in the
    forward for the backward is their design, not the function's, and is not
    counted.  Operations at the real ci x co widths: 2 ci co a row forward
    and 4 ci co backward, plus the elementwise work (28 co + 40 a row forward,
    50 co + 40 backward) and ~100 integer operations an element for the
    Philox dropout bytes.
    """
    rows = B * R
    nbytes = flops = 0
    wbytes = 4 * (cmax * cmax + 6 * cmax)
    for ci, co in chans:
        rng = 100 * co if dropout else 0
        if backward:
            nbytes += rows * (act_bytes * (co + cmax + ci) + 4 * 8) + 2 * wbytes
            flops += rows * (4 * ci * co + 50 * co + 40 + rng)
        else:
            nbytes += rows * (act_bytes * (ci + cmax) + 4 * 8) + wbytes
            flops += rows * (2 * ci * co + 28 * co + 40 + rng)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


@functools.lru_cache(maxsize=None)
def train_samples():
    """The 512 real-scale buildings (seeds 0-511, as bench.py), processed, on the host."""
    from building_gan_torch.config import Configuration
    from building_gan_torch.data import generate_building_real_scale, process_building

    cfg0 = Configuration()
    return tuple(process_building(*generate_building_real_scale(i), cfg0, f"{i:06d}")
                 for i in range(TRAIN_BUILDINGS))


def train_cfg():
    """The train phases' configuration: the config of record at f32, K = 6 cell packing."""
    from building_gan_torch.config import Configuration

    max_local = max(s[0].x.shape[0] for s in train_samples()[:TRAIN_BATCH_BUILDINGS])
    return Configuration(
        COMPUTE_DTYPE="float32", GRID_SHAPE=(11, 12, 12), GRID_SLOT_GRAPHS=TRAIN_SLOT_GRAPHS,
        GRID_LOCAL_NODES=int(np.ceil(TRAIN_SLOT_GRAPHS * max_local / 64.0)) * 64,
        GRID_PACK_MODE="cell", ENCODER_DROPOUT_RATE=DROPOUT_RATE,
    )


@functools.lru_cache(maxsize=None)
def train_slots():
    """plan_packing_slots of the train batch's buildings (~5 s on the host), once."""
    from building_gan_torch.data import plan_packing_slots

    return tuple(plan_packing_slots(list(train_samples()[:TRAIN_BATCH_BUILDINGS]), train_cfg()))


def train_batch():
    """(cfg, batch on the CPU): the first TRAIN_BATCH_BUILDINGS real-scale buildings,
    plan_packing_slots + pack_grid_multi_from_slots."""
    from building_gan_torch.data import pack_grid_multi_from_slots

    cfg, slots = train_cfg(), train_slots()
    return cfg, pack_grid_multi_from_slots(list(train_samples()[:TRAIN_BATCH_BUILDINGS]), slots, cfg,
                                           batch_slots=len(slots))


def perturbed_stack(hidden, repeat, gen, dev):
    """Random hourglass weights (seeded), GraphNorm and biases moved off their inits."""
    from building_gan_torch.models.grid_layers import GridHourglass
    from building_gan_torch.ops.hourglass import pack_gat_weights

    with torch.random.fork_rng(devices=[]):  # the module's own init, seeded from gen
        torch.manual_seed(int(torch.randint(2**31, (1,), generator=gen)))
        enc = GridHourglass(hidden, repeat)
    with torch.no_grad():
        for conv, norm in enc.layers():
            n = conv.bias.numel()
            u = lambda lo, hi: lo + (hi - lo) * torch.rand(n, generator=gen)  # noqa: E731
            conv.bias.copy_(u(-0.3, 0.3))
            norm.weight.copy_(u(0.5, 1.5))
            norm.bias.copy_(u(-0.3, 0.3))
            norm.mean_scale.copy_(u(0.5, 1.5))
        packed = [t.to(dev).contiguous() for t in pack_gat_weights(enc)]
    return packed, enc.channel_pairs


def with_grads(fn, leaves, gy):
    """(y, grads of sum(y * gy) w.r.t. leaves), leaves copied as fresh autograd leaves."""
    leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    y = fn(*leaves)
    return y.detach(), torch.autograd.grad(y, leaves, gy)


class Store16(torch.autograd.Function):
    """Identity that rounds to a 16-bit dtype and back, forward and backward: in an f64
    reference, where a 16-bit kernel stores (a layer's output; its gx)."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.to(dtype).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None


def stores(storage):
    """t -> t as a kernel with ``storage`` activations stores it: a wider t rounded
    to that dtype both ways at 16-bit storage (``Store16``), else t itself."""
    if storage not in HALF_DTYPES:
        return lambda t: t
    return lambda t: t if t.dtype == storage else Store16.apply(t, storage)


def stack_fns(planes, keys, grid, K, chans, storage=torch.float32):
    """(kernel stack, plain stack) as functions of (x, Ws, atts, vecs), dropout on.

    The plain stack keeps one layer's autograd graph alive at a time
    (torch.utils.checkpoint recomputes each layer in the backward), so it runs
    in f64 at the step's 105 slots; the dropout masks are keyed, so the
    recomputation draws the same bits.  Its input and each layer's output
    pass through ``stores(storage)``: an f64 run rounds where a kernel with
    ``storage`` activations stores.
    """
    from torch.utils.checkpoint import checkpoint

    from building_gan_torch.ops import dropout as drop
    from building_gan_torch.ops import gat_train as gt

    levels = drop.drop_levels(DROPOUT_RATE)
    store = stores(storage)

    def fused(x, Ws, atts, vecs):
        return gt.hourglass_train(x, planes, Ws, atts, vecs, keys, grid, K, DROPOUT_RATE, False,
                                  chans=chans)

    def plain(x, Ws, atts, vecs):
        x = store(x)
        for l in range(Ws.shape[0]):
            x = store(checkpoint(gt.layer_plain, x, planes, Ws[l], atts[l], vecs[l], keys[l], grid,
                                 K, levels, use_reentrant=False))
        return x

    return fused, plain


def kernel_branches(leaves, planes, key, grid, ci, co, K, levels):
    """The branches one forward kernel took, for ``layer_plain(..., branches=)``.

    A ReLU or LeakyReLU argument within f32 rounding of 0 can fall on the
    other side in the kernel than in f64; its gradient then differs by a
    whole term in one cell.  A layer alone has a few such cells in 10^7, so
    its references take the kernel's branches: ReLU on where the kernel's
    saved bit says so (keyed, its f32 z > 0, kept: a dropped cell has no
    gradient either way; not y > 0, since at f16 storage a positive z below
    2^-25 stores as y = 0), LeakyReLU slope 1 where the kernel's scores sum
    to >= 0.  Returns (branches, cells where
    the kernel's ReLU differs from f64's sign, LeakyReLU arguments that do).
    """
    from building_gan_torch.ops import gat_train as gt
    from building_gan_torch.ops.stencil import shift

    x, w, att, vec = leaves
    meta = (ci, co, K, levels, tuple(grid), 0.2, 1e-5)
    offs = gt.flat_offsets(grid)
    with torch.no_grad():
        y, saved = gt.launch_forward(gt._load(), torch.cuda.current_stream(x.device).cuda_stream,
                                     x, planes, w, att, vec, key, meta)
        views = gt.saved_views(gt._load(), saved, x.shape, meta)
        a_s, a_d = views["scores"][0], views["scores"][1]
        leaky = torch.stack([shift(a_s, 1, o) + a_d >= 0 for o in offs] + [a_s + a_d >= 0])
        # channel c's bit: bit c // V of the row's word c % V (csrc/gat_train.cu, fwd_apply)
        words = views["bits"]
        ch = torch.arange(y.shape[-1], device=y.device)
        relu = ((words[..., ch % words.shape[-1]] >> (ch // words.shape[-1]).to(torch.int32)) & 1
                ).bool() & (ch < co)
        y64 = gt.layer_plain(x.double(), planes, w.double(), att.double(), vec.double(), key, grid,
                             K, levels)
        h64 = x.double() @ w.double()
        s64, d64 = (h64 * att[0].double()).sum(-1), (h64 * att[1].double()).sum(-1)
        leaky64 = torch.stack([shift(s64, 1, o) + d64 >= 0 for o in offs] + [s64 + d64 >= 0])
        live = torch.cat([planes[..., :6].movedim(-1, 0), planes[None, ..., 6]]) > 0
        n_relu = int((relu != (y64 > 0)).sum())
        n_leaky = int(((leaky != leaky64) & live).sum())
    return (relu, leaky), n_relu, n_leaky


def hold(label, names, got, want, want64):
    """f64_rule on each named output; prints each, raises on a failure; -> largest max abs err vs f64."""
    worst = 0.0
    for what, a, b, c in zip(names, got, want, want64):
        ok, report, err_k64 = f64_rule(a, b, c)
        say(f"{label} {what} {report}")
        if not ok:
            raise AssertionError(f"gat_train kernel disagrees with its plain version: {label} {what}")
        worst = max(worst, err_k64)
    return worst


def hold_chain(label, x, gy, planes, weights, keys, grid, K, chans, layers, stack=None):
    """The kernel's ``layers`` each alone on the kernel's own activations, by both f64
    rules: forward on the kernel's output of the layer below (x for the first),
    backward on gy.  One layer does not compound rounding, so both rules are
    tight there at every storage type (x's; at 16 bits the f64 reference rounds
    where the kernel stores, ``stores``); the references take the kernel's
    branches.  ``stack``: (y, grads) of the kernel stack over every layer on (x,
    weights) and gy, which must equal bit for bit the chain of layer calls, each
    layer's backward fed the kernel's gx of the layer above.  Raises on a
    failure; returns (fwd err, bwd err), the kernel's largest max abs errors
    against f64.
    """
    from building_gan_torch.ops import dropout as drop
    from building_gan_torch.ops import gat_train as gt

    Ws, atts, vecs = weights
    levels = drop.drop_levels(DROPOUT_RATE)
    store = stores(x.dtype)
    xs = {layers[0]: x}
    with torch.no_grad():
        for l in layers:
            xs[l + 1] = gt.fused_layer(xs[l], planes, Ws[l], atts[l], vecs[l], keys[l], grid,
                                       *chans[l], K, levels)
    fwd_err = bwd_err = 0.0
    worst, flips, g, kgrads, same = {}, [0, 0], gy, {}, True
    for l in reversed(layers):
        ci, co = chans[l]
        leaves = (xs[l], Ws[l], atts[l], vecs[l])
        branches, n_relu, n_leaky = kernel_branches(leaves, planes, keys[l], grid, ci, co, K, levels)
        flips = [flips[0] + n_relu, flips[1] + n_leaky]

        def one(x_, W_, a_, v_):
            return gt.fused_layer(x_, planes, W_, a_, v_, keys[l], grid, ci, co, K, levels)

        def one_plain(x_, W_, a_, v_):
            return store(gt.layer_plain(store(x_), planes, W_, a_, v_, keys[l], grid, K, levels,
                                        branches=branches))

        got = with_grads(one, leaves, gy)
        want = with_grads(one_plain, leaves, gy)
        want64 = with_grads(one_plain, [t.double() for t in leaves], gy.double())
        torch.cuda.synchronize()
        if got[0].dtype != x.dtype or got[1][0].dtype != x.dtype:
            raise AssertionError(f"{label} layer {l}: y / gx {got[0].dtype} / {got[1][0].dtype}, "
                                 f"expected {x.dtype}")
        same = same and torch.equal(got[0], xs[l + 1])
        for what, a, b, c in zip(("y",) + GRAD_NAMES, [got[0], *got[1]],
                                 [want[0], *want[1]], [want64[0], *want64[1]]):
            ok, report, err_k64 = f64_rule(a, b, c)
            if not ok:
                say(f"{label} layer {l} ({ci} -> {co}) {what} {report}")
                raise AssertionError(f"gat_train kernel disagrees with its plain version: "
                                     f"{label} layer {l} {what}")
            rel = (a.double() - c).norm().item() / max(c.norm().item(), 1e-300)
            of_max = err_k64 / max(c.abs().max().item(), 1e-300)
            w = worst.get(what, (0.0, 0.0, 0.0))
            worst[what] = (max(w[0], err_k64), max(w[1], rel), max(w[2], of_max))
            if what == "y":
                fwd_err = max(fwd_err, err_k64)
            else:
                bwd_err = max(bwd_err, err_k64)
        del got, want, want64, branches
        if stack is not None:  # the chain's backward: the kernel's gx of the layer above
            _, (g, *kgrads[l]) = with_grads(one, leaves, g)
    if stack is not None:
        y_s, (gx_s, *gw_s) = stack
        same = (same and torch.equal(y_s, xs[layers[-1] + 1]) and torch.equal(gx_s, g)
                and all(torch.equal(a[l], b) for l in layers for a, b in zip(gw_s, kgrads[l])))
    if not same:
        raise AssertionError(f"{label}: the kernel stack or a repeated layer call differs from "
                             "the chain of layer calls")
    del xs, kgrads
    torch.cuda.empty_cache()
    dt = str(x.dtype).replace("torch.", "")
    say(f"{label}, {dt}: each of layers {layers[0]}-{layers[-1]} alone on the kernel's own "
        f"activations ({x.shape[0]} slots, K={K}) within both rules"
        + (", the stack's output and gradients equal to the chain of layer calls' bit for bit"
           if stack else "")
        + f"; the references take the kernel's branches (it took the other branch than f64 at "
        f"{flips[0]} ReLU and {flips[1]} LeakyReLU arguments); worst kernel vs f64 (max abs, "
        "norm-relative, max abs / max |f64|): "
        + ", ".join(f"{k} {a:.2e} {r:.2e} {q:.2e}" for k, (a, r, q) in worst.items()))
    return fwd_err, bwd_err


def distances(label, got, want, want64):
    """Print, and hold nothing: a whole 16-bit stack's norm-relative distances, kernel vs
    its twin, twin vs f64 with the stores, kernel vs f64, for y and the grads."""
    rel = lambda a, b: ((a.double() - b.double()).norm() / b.double().norm()).item()  # noqa: E731
    say(f"{label}, whole stack (not held; held layer by layer below), norm-relative kernel vs twin "
        "/ twin vs f64 / kernel vs f64: " + ", ".join(
            f"{k} {rel(a, b):.2e} / {rel(b, c):.2e} / {rel(a, c):.2e}" for k, a, b, c in zip(
                ("y",) + GRAD_NAMES, [got[0], *got[1]], [want[0], *want[1]],
                [want64[0], *want64[1]])))


def check_train_kernels(batch, dev):
    """Training kernels vs plain at full width on every slot of the train batch.

    For the generator stack (Cmax 128, 14 layers) and the critic stack (Cmax
    64, 6 layers): the whole stack, then each layer on the kernel's own
    activations (``hold_chain``).  Returns (fwd err, bwd err), the kernel's largest max abs
    errors against f64.
    """
    from building_gan_torch.ops import dropout as drop
    from building_gan_torch.ops import gat_train as gt

    grid, K = batch.grid_shape, batch.graphs_per_slot
    planes = gt.build_planes(batch.mask, batch.gid, grid)
    B, R = planes.shape[:2]
    levels = drop.drop_levels(DROPOUT_RATE)
    gen = torch.Generator().manual_seed(11)
    kgen = torch.Generator(device=dev).manual_seed(12)
    fwd_err = bwd_err = 0.0
    for name, hidden, repeat in (("generator", 128, 7), ("critic", 64, 3)):
        (Ws, atts, vecs), chans = perturbed_stack(hidden, repeat, gen, dev)
        keys = drop.draw_keys(len(chans), kgen)
        x = torch.randn(B, R, hidden, generator=gen).to(dev)
        gy = torch.randn(B, R, hidden, generator=gen).to(dev)
        fused, plain = stack_fns(planes, keys, grid, K, chans)
        leaves = (x, Ws, atts, vecs)
        label = f"train kernel {name} stack (Cmax {hidden}, {len(chans)} layers, K={K}, {B} slots)"
        got = with_grads(fused, leaves, gy)
        want = with_grads(plain, leaves, gy)
        want64 = with_grads(plain, [t.double() for t in leaves], gy.double())
        torch.cuda.synchronize()
        fwd_err = max(fwd_err, hold(label, ("y",), got[:1], want[:1], want64[:1]))
        bwd_err = max(bwd_err, hold(label, GRAD_NAMES, got[1], want[1], want64[1]))
        del want, want64
        errs = hold_chain(f"train kernel {name}", x, gy, planes, (Ws, atts, vecs), keys, grid, K,
                          chans, range(len(chans)), stack=got)
        fwd_err, bwd_err = max(fwd_err, errs[0]), max(bwd_err, errs[1])
        del got

        if name == "generator":  # one layer's keep mask, read back from its output
            ci, co = chans[0]
            args = (x, planes, Ws[0], atts[0], vecs[0])
            with torch.no_grad():
                y0 = gt.fused_layer(*args, None, grid, ci, co, K, 0)
                y1 = gt.fused_layer(*args, keys[0], grid, ci, co, K, levels)
            live = y0 > 0
            keep_k = (y1 != 0)[live]
            keep_p = drop.keep_mask(tuple(y0.shape), keys[0], levels, device=dev)[live]
            scaled_ok = torch.equal(y1[live & (y1 != 0)], (y0 * drop.keep_scale(levels))[live & (y1 != 0)])
            n = B * R * hidden
            bytes_k = gt.dropout_bytes_cuda(n, keys[0]).to(torch.int64)
            bytes_p = drop.random_bytes(torch.arange(n, device=dev), keys[0])
            same = torch.equal(keep_k, keep_p) and scaled_ok and torch.equal(bytes_k, bytes_p)
            say(f"train kernel dropout: layer 0 keep mask {int(keep_k.sum())}/{keep_k.numel()} kept "
                f"({keep_k.float().mean().item():.4f}, expect {1 - levels / 256:.4f}); kernel == plain "
                f"bit for bit: {same}; Philox bytes of {n} elements equal: {torch.equal(bytes_k, bytes_p)}")
            if not same:
                raise AssertionError("the kernel's dropout mask differs from the plain version's")
            del y0, y1, keep_k, keep_p, bytes_k, bytes_p
    return fwd_err, bwd_err


def hourglass_stored64(x, mask, Ws, atts, vecs, chans, gid, K):
    """The plain hourglass in f64 on 16-bit x, a layer at a time, each layer's output
    rounded to x's dtype as the 16-bit kernel stores it: its f64 reference."""
    from building_gan_torch.ops import hourglass as hg

    y = x.double()
    for l in range(len(chans)):
        y = hg.hourglass_plain(y, mask, Ws[l:l + 1].double(), atts[l:l + 1].double(),
                               vecs[l:l + 1].double(), chans[l:l + 1], gid, K).to(x.dtype).double()
    return y


def check_16bit_kernels(batch, hg_inputs, dev, dtype=BF16):
    """The three kernels with 16-bit storage (``dtype``, bf16 or f16) at full width, each
    against its plain twin at that dtype (the same roundings, f32 math) and the plain
    version run in f64 on the same inputs, rounded where the kernel stores, by the f64
    rules.

    The serving hourglass at the server's shapes (K = 1 and K = 4); the generator
    (Cmax 128, 14 layers) and critic (Cmax 64, 6 layers) training stacks on every
    slot of the train batch (K = 6, dropout on), forward and gx / gW / gatt / gvec,
    each layer on the kernel's own activations (``hold_chain``; the whole stack's
    distances printed, not held); then the generator stack's two odd-width layers
    (2 -> 1, 1 -> 2) alone at K = 3, whose 16-bit rows are 2 and 4 bytes.
    Returns {kernel: largest max abs error against f64}.
    """
    from building_gan_torch.ops import dropout as drop
    from building_gan_torch.ops import gat_train as gt
    from building_gan_torch.ops import hourglass as hg

    errs = {"hourglass_fwd": 0.0, "gat_train_fwd": 0.0, "gat_train_bwd": 0.0}
    x_hg, masks, Ws, atts, vecs, chans = hg_inputs
    dn = {BF16: "bf16", F16: "f16"}[dtype]
    for K, mask, gid in masks:
        args = (x_hg.to(dtype), mask, Ws, atts, vecs, chans, gid, K)
        got = hg.hourglass_cuda(*args)
        twin = hg.hourglass_plain(*args)
        want64 = hourglass_stored64(*args)
        torch.cuda.synchronize()
        if got.dtype != dtype:
            raise AssertionError(f"the {dn} hourglass returned {got.dtype}")
        ok, report, err = f64_rule(got, twin, want64)
        say(f"{dn} kernel hourglass K={K} ({x_hg.shape[0]} slots; plain = the {dn} twin) {report}")
        if not ok:
            raise AssertionError(f"{dn} hourglass kernel disagrees with its plain version at K={K}")
        errs["hourglass_fwd"] = max(errs["hourglass_fwd"], err)
        del got, twin, want64

    grid, K = batch.grid_shape, batch.graphs_per_slot
    planes = gt.build_planes(batch.mask, batch.gid, grid)
    B, R = planes.shape[:2]
    gen = torch.Generator().manual_seed(31)
    kgen = torch.Generator(device=dev).manual_seed(32)
    for name, hidden, repeat in (("generator", 128, 7), ("critic", 64, 3)):
        weights, tchans = perturbed_stack(hidden, repeat, gen, dev)
        keys = drop.draw_keys(len(tchans), kgen)
        x = torch.randn(B, R, hidden, generator=gen).to(dev, dtype)
        gy = torch.randn(B, R, hidden, generator=gen).to(dev, dtype)
        fused, plain = stack_fns(planes, keys, grid, K, tchans, dtype)
        leaves = (x, *weights)
        label = (f"{dn} train kernel {name} stack (Cmax {hidden}, {len(tchans)} layers, K={K}, "
                 f"{B} slots; plain = the {dn} twin)")
        got = with_grads(fused, leaves, gy)
        if got[0].dtype != dtype or got[1][0].dtype != dtype:
            raise AssertionError(f"the {dn} {name} stack returned {got[0].dtype} / {got[1][0].dtype}")
        want = with_grads(plain, leaves, gy)
        want64 = with_grads(plain, [t.double() for t in leaves], gy.double())
        torch.cuda.synchronize()
        distances(label, got, want, want64)
        del want, want64
        torch.cuda.empty_cache()
        layer_errs = [hold_chain(f"{dn} train kernel {name}", x, gy, planes, weights, keys, grid, K,
                                 tchans, range(len(tchans)), stack=got)]
        del got
        if name == "generator":
            # the odd widths at K = 3: the 2 -> 1 and 1 -> 2 layers, gid folded to 3 keys; the
            # first one's input zero beyond its 2 channels, as a stack hands it over (the
            # kernel reads x[:, :ci] only; the plain GEMM would take a gW row from the rest)
            xl = torch.zeros_like(x)
            xl[..., :tchans[6][0]] = x[..., :tchans[6][0]]
            layer_errs.append(hold_chain(
                f"{dn} train kernel odd width: generator", xl, gy,
                gt.build_planes(batch.mask, batch.gid % 3, grid), weights, keys, grid, 3, tchans,
                range(6, 8)))
        for fe, be in layer_errs:
            errs["gat_train_fwd"] = max(errs["gat_train_fwd"], fe)
            errs["gat_train_bwd"] = max(errs["gat_train_bwd"], be)
    return errs


def train_phase(cfg, batch, dev, steps=TRAIN_STEPS, nonfinite=None):
    """The training main path: ``steps`` steps at full width at the config's dtypes;
    -> (state, step ms, launches).  The launch counts are set to 0 first.  A step with
    non-finite metrics raises, or with a ``nonfinite`` list is recorded there as
    (step, names) and printed (f16's range: a property of the dtype, not a fault)."""
    from building_gan_torch.models.grid_models import GridVoxelGNNDiscriminator, GridVoxelGNNGenerator
    from building_gan_torch.ops import gat_train as gt
    from building_gan_torch.ops import hourglass as hg
    from building_gan_torch.train.state import create_train_state
    from building_gan_torch.train.step import make_train_step

    torch.manual_seed(cfg.SEED)
    state = create_train_state(cfg, GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg),
                               device=dev)
    step = make_train_step(cfg, state)
    gen = torch.Generator(device=dev).manual_seed(0)
    Lg, Ld = len(state.generator.encoder.channels), len(state.discriminator.encoder.channels)
    # forward and backward layer launches, and the GP pass's dropout-byte draws (one a critic layer)
    want = (cfg.N_CRITIC * (Lg + 2 * Ld) + Lg + Ld, cfg.N_CRITIC * 2 * Ld + Ld + Lg, cfg.N_CRITIC * Ld)
    step_ms = []
    for c in (gt.fwd_launches, gt.bwd_launches, gt.bytes_launches, hg.launches):
        c.reset()
    peak = []
    tag = f"{cfg.COMPUTE_DTYPE}, GP {cfg.GP_DTYPE}"
    for i in range(steps):
        f0, b0, d0 = gt.fwd_launches.value, gt.bwd_launches.value, gt.bytes_launches.value
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        m = step(batch, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        peak.append(torch.cuda.max_memory_allocated(dev) / 2**30)
        got = (gt.fwd_launches.value - f0, gt.bwd_launches.value - b0, gt.bytes_launches.value - d0)
        bad = [k for k, v in m.items() if not torch.isfinite(v).all().item()]
        say(f"train step {i + 1} ({tag}): {step_ms[-1]:.1f} ms, g_loss {m['g_loss'].item():.5f}, "
            f"d_loss {m['d_loss'].item():.5f}, f1 {m['f1'].item():.4f}, f1_min {m['f1_min'].item():.4f}, "
            f"accuracy {m['accuracy'].item():.4f}; layer launches fwd {got[0]} bwd {got[1]}, "
            f"dropout-byte launches {got[2]} (expect {want[0]} / {want[1]} / {want[2]}); peak device "
            f"memory {peak[-1]:.3f} GiB (torch.cuda.max_memory_allocated)")
        if bad and nonfinite is None:
            raise AssertionError(f"train step {i + 1}: non-finite {bad}")
        if bad:
            nonfinite.append((i + 1, bad))
            say(f"train step {i + 1} ({tag}): NON-FINITE {bad} (recorded)")
        if got != want:
            raise AssertionError(f"train step {i + 1}: {got} layer launches, expected {want}")
    launches = (gt.fwd_launches.value, gt.bwd_launches.value)
    if min(launches + (gt.bytes_launches.value,)) < 1:
        raise AssertionError("the train path never launched a gat_train kernel")
    return state, step_ms, launches


def dtype_turns(runs, batch, dev, card):
    """Train steps of each {dtype: (cfg, state)} in turns (f32, bf16, bf16, f32, twice): ms on
    the host clock between synchronisations, real voxel nodes/s and peak device memory."""
    from building_gan_torch.train.step import make_train_step

    steps = {dt: make_train_step(cfg, st) for dt, (cfg, st) in runs.items()}
    g = torch.Generator(device=dev).manual_seed(13)
    ms, peak = {dt: [] for dt in runs}, {dt: 0.0 for dt in runs}
    for dt in ("float32", "bfloat16", "bfloat16", "float32") * 2:
        torch.cuda.reset_peak_memory_stats(dev)
        _, t = wall_ms(lambda: steps[dt](batch, g))
        ms[dt].append(t)
        peak[dt] = max(peak[dt], torch.cuda.max_memory_allocated(dev) / 2**30)
    n_real = int(batch.mask.sum().item())
    for dt, v in ms.items():
        med = float(np.median(v))
        say(f"train in turns ({dt}): steps {' '.join(f'{t:.1f}' for t in v)} ms, median {med:.1f} "
            f"ms, {n_real / (med / 1e3):.1f} real voxel nodes/s, peak device memory {peak[dt]:.3f} GiB "
            f"on {card}")
    return ms, peak


def eval_turns(runs, batch, dev, card):
    """The eval step of each {dtype: (cfg, state)} on the train batch: its kernel launches
    (one hourglass, the critic's layers forward), finite metrics, and CUDA-event ms in
    turns (f32, bf16, bf16, f32)."""
    from building_gan_torch.ops import gat_train as gt
    from building_gan_torch.ops import hourglass as hg
    from building_gan_torch.train.step import make_eval_step

    g = torch.Generator(device=dev).manual_seed(14)
    evals, times = {}, {dt: [] for dt in runs}
    for dt, (cfg, st) in runs.items():
        evals[dt] = make_eval_step(cfg, st)
        h0, f0 = hg.launches.value, gt.fwd_launches.value
        m = evals[dt](batch, g)
        torch.cuda.synchronize()
        got = (hg.launches.value - h0, gt.fwd_launches.value - f0)
        want = (1, len(st.discriminator.encoder.channels))
        bad = [k for k, v in m.items() if not torch.isfinite(v).all().item()]
        say(f"eval step ({dt}, {batch.mask.shape[0]} slots): launches hourglass {got[0]}, training "
            f"forward {got[1]} (expect {want[0]} and {want[1]}); g_loss {m['g_loss'].item():.5f}, f1 "
            f"{m['f1'].item():.4f}")
        if got != want or bad:
            raise AssertionError(f"eval step ({dt}): launches {got}, non-finite {bad}")
    for dt in ("float32", "bfloat16", "bfloat16", "float32"):
        times[dt].append(timed_ms(lambda: evals[dt](batch, g), 3))
    say("eval step ms in turns (CUDA events, 3 calls): " + ", ".join(
        f"{dt} {' '.join(f'{t:.2f}' for t in v)}" for dt, v in times.items()) + f" on {card}")
    return times


def time_train_stacks(state, batch, dev, card, act_dtype=torch.float32):
    """Forward and backward of the generator and critic stacks at the step's shapes, in turns.

    With the step's trained weights, the kernel stack is also held against the
    plain version run in f64 by both rules: each layer on the kernel's own
    activations, the stack equal to the chain of layer calls bit for bit
    (``hold_chain``), and at f32 the whole stack too.  The activations (x, y,
    gy, gx) in ``act_dtype`` (f32, or a 16-bit storage, whose plain stack is
    the twin at that dtype and whose f64 reference rounds where the kernel stores);
    then each stack's sub-kernel and layer times (stack_profile).
    Returns ({stack: {"fwd"/"bwd": (ms, plain ms, bound ms, bound by)}},
    (fwd err, bwd err)).
    """
    from building_gan_torch.ops import dropout as drop
    from building_gan_torch.ops import gat_train as gt
    from building_gan_torch.ops.hourglass import pack_gat_weights

    grid, K = batch.grid_shape, batch.graphs_per_slot
    planes = gt.build_planes(batch.mask, batch.gid, grid)
    B, R = planes.shape[:2]
    levels = drop.drop_levels(DROPOUT_RATE)
    gen = torch.Generator(device=dev).manual_seed(21)
    out, fwd_err, bwd_err = {}, 0.0, 0.0
    for name, enc in (("generator", state.generator.encoder), ("critic", state.discriminator.encoder)):
        with torch.no_grad():
            Ws, atts, vecs = (t.contiguous() for t in pack_gat_weights(enc))
        cmax, chans = enc.hidden_dim, enc.channel_pairs
        keys = drop.draw_keys(len(chans), gen)
        x = torch.randn(B, R, cmax, generator=gen, device=dev).to(act_dtype)
        gy = torch.randn(B, R, cmax, generator=gen, device=dev).to(act_dtype)
        fused, _ = stack_fns(planes, keys, grid, K, chans)

        def plain(x_, W_, a_, v_):  # the whole graph kept, as autograd runs it
            return gt.hourglass_train_plain(x_, planes, W_, a_, v_, keys, grid, K, levels)

        leaves = [t.clone().requires_grad_(True) for t in (x, Ws, atts, vecs)]
        with torch.no_grad():
            for _ in range(2):
                fused(*leaves)
                plain(*leaves)
            torch.cuda.synchronize()
            pf1 = timed_ms(lambda: plain(*leaves), 2)
            kf1 = timed_ms(lambda: fused(*leaves), 5)
            kf2 = timed_ms(lambda: fused(*leaves), 5)
            pf2 = timed_ms(lambda: plain(*leaves), 2)
        yk = fused(*leaves)
        yp = plain(*leaves)
        back = lambda y: torch.autograd.grad(y, leaves, gy, retain_graph=True)  # noqa: E731
        gk, gp = back(yk), back(yp)
        torch.cuda.synchronize()
        pb1 = timed_ms(lambda: back(yp), 2)
        kb1 = timed_ms(lambda: back(yk), 5)
        kb2 = timed_ms(lambda: back(yk), 5)
        pb2 = timed_ms(lambda: back(yp), 2)
        got, want = (yk.detach(), gk), (yp.detach(), gp)
        del yk, yp, gp
        torch.cuda.empty_cache()
        dt = str(act_dtype).replace("torch.", "")
        if act_dtype == torch.float32:  # a 16-bit stack compounds its rounding flips (check_16bit_kernels)
            want64 = with_grads(stack_fns(planes, keys, grid, K, chans)[1],
                                [t.double() for t in leaves], gy.double())
            label = (f"train stacks at the step's weights, {dt}: {name} ({len(chans)} layers, Cmax "
                     f"{cmax}, {B} slots)")
            fwd_err = max(fwd_err, hold(label, ("y",), got[:1], want[:1], want64[:1]))
            bwd_err = max(bwd_err, hold(label, GRAD_NAMES, got[1], want[1], want64[1]))
            del want64
        del want, leaves
        torch.cuda.empty_cache()
        errs = hold_chain(f"train stacks at the step's weights: {name}", x, gy, planes,
                          (Ws, atts, vecs), keys, grid, K, chans, range(len(chans)), stack=got)
        fwd_err, bwd_err = max(fwd_err, errs[0]), max(bwd_err, errs[1])
        del got, gk
        act_bytes = torch.finfo(act_dtype).bits // 8
        fb = train_bound(B, R, chans, cmax, False, True, act_bytes)
        bb = train_bound(B, R, chans, cmax, True, True, act_bytes)
        kf, kb = (kf1 + kf2) / 2, (kb1 + kb2) / 2
        say(f"time: {name} stack, {dt} ({len(chans)} layers, Cmax {cmax}, {B} slots) forward: kernel "
            f"{kf1:.3f}/{kf2:.3f} ms, plain {pf1:.3f}/{pf2:.3f} ms, bound {fb[0]:.4f} ms ({fb[1]}), "
            f"{100 * fb[0] / kf:.2f}% of bound on {card}")
        say(f"time: {name} stack, {dt}, backward: kernel {kb1:.3f}/{kb2:.3f} ms, plain {pb1:.3f}/{pb2:.3f} ms, "
            f"bound {bb[0]:.4f} ms ({bb[1]}), {100 * bb[0] / kb:.2f}% of bound; bytes fwd {fb[2]} "
            f"bwd {bb[2]}, ops fwd {fb[3]} bwd {bb[3]}")
        out[name] = {"fwd": (kf, (pf1 + pf2) / 2, fb[0], fb[1]),
                     "bwd": (kb, (pb1 + pb2) / 2, bb[0], bb[1])}
        with torch.no_grad():
            stack_profile(f"{name} ({dt})", planes, Ws, atts, vecs, keys, grid, K, chans, x, gy)
        torch.cuda.empty_cache()
    return out, (fwd_err, bwd_err)


def stack_profile(name, planes, Ws, atts, vecs, keys, grid, K, chans, x, gy):
    """Where one stack's kernel time goes, forward and backward, at the step's shapes.

    Each layer's forward and backward launch (``launch_forward`` /
    ``launch_backward``, as ``_FusedLayer`` calls them) on the kernel stack's
    own activations: timed with CUDA events (3 calls each), then run once
    under torch.profiler for the device time of each sub-kernel.  Prints the
    stack's device time by sub-kernel (summed over its layers) and each
    layer's times; returns {kernel: (ms, launches)}.  These launches go around
    the wrappers and are not counted.
    """
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from building_gan_torch.ops import dropout as drop
    from building_gan_torch.ops import gat_train as gt

    lib, stream = gt._load(), torch.cuda.current_stream().cuda_stream
    levels = drop.drop_levels(DROPOUT_RATE)
    metas = [(ci, co, K, levels, tuple(grid), 0.2, 1e-5) for ci, co in chans]

    def fwd(l, xl):
        return gt.launch_forward(lib, stream, xl, planes, Ws[l], atts[l], vecs[l], keys[l], metas[l])

    def bwd(l, xl, saved):
        return gt.launch_backward(lib, stream, gy, xl, planes, Ws[l], atts[l], vecs[l], keys[l],
                                  saved, metas[l])

    def short(key):
        m = re.search(r"::(\w+(?:<[^>]*>)?)\(", key)
        return m.group(1) if m else key[:60]

    per_layer, total = [], {}
    with torch.no_grad():
        xl = x
        for l, (ci, co) in enumerate(chans):
            y, saved = fwd(l, xl)
            bwd(l, xl, saved)
            f_ms = timed_ms(lambda: fwd(l, xl), 3)
            b_ms = timed_ms(lambda: bwd(l, xl, saved), 3)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fwd(l, xl)
                bwd(l, xl, saved)
                torch.cuda.synchronize()
            kernels = {}
            for e in prof.key_averages():
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                    k = short(e.key)
                    ms, n = kernels.get(k, (0.0, 0))
                    kernels[k] = (ms + e.self_device_time_total / 1e3, n + e.count)
            for k, (ms, n) in kernels.items():
                tms, tn = total.get(k, (0.0, 0))
                total[k] = (tms + ms, tn + n)
            per_layer.append((ci, co, f_ms, b_ms, kernels))
            del saved
            xl = y
        del xl, y
        torch.cuda.empty_cache()
    for what, label in (("fwd_", "forward"), ("bwd_", "backward")):
        rows = sorted(((k, v) for k, v in total.items() if k.startswith(what)), key=lambda kv: -kv[1][0])
        say(f"sub-kernels: {name} stack {label} ({len(chans)} layers), device ms by kernel "
            f"(launches), torch.profiler, total {sum(v[0] for _, v in rows):.3f} ms:")
        for k, (ms, n) in rows:
            say(f"  {ms:8.3f} ms {n:4d}x  {k}")
    say(f"layers: {name} stack, ms a layer call, CUDA events (forward / backward), then device ms "
        "by sub-kernel:")
    for l, (ci, co, f_ms, b_ms, kernels) in enumerate(per_layer):
        parts = " ".join(f"{k.split('_')[1]} {ms:.4f}" for k, (ms, _) in kernels.items())
        say(f"  layer {l:2d} {ci:3d} -> {co:3d}: {f_ms:.4f} / {b_ms:.4f}; {parts}")
    say(f"  sum: {sum(p[2] for p in per_layer):.3f} / {sum(p[3] for p in per_layer):.3f} ms")
    return total


def wall_ms(fn):
    """(result, ms) of fn on the host clock between two synchronisations."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, (time.perf_counter() - t) * 1e3


def train_breakdown(state, cfg, batch, dev):
    """Where one train step's time goes: its parts run one at a time, as train/step.py runs them.

    Returns {part: ms} for one critic update and for the generator update.
    """
    from building_gan_torch.models import fast_train as FT
    from building_gan_torch.ops import gat_train as gt
    from building_gan_torch.ops.dropout import draw_keys
    from building_gan_torch.ops.rng import normal_box_muller
    from building_gan_torch.train import losses as L
    from building_gan_torch.train import metrics as M

    gen_m, disc_m = state.generator, state.discriminator
    g = torch.Generator(device=dev).manual_seed(5)
    mask = batch.mask
    planes = gt.build_planes(mask, batch.gid, batch.grid_shape)
    types_onehot = torch.nn.functional.one_hot(batch.type.long(), 7).float() * mask[..., None]
    Lg, Ld = len(gen_m.encoder.channels), len(disc_m.encoder.channels)
    zshape = tuple(mask.shape) + (cfg.Z_DIM,)

    def gen_fwd():
        z = normal_box_muller(zshape, g)
        return FT.generator_apply_fused(gen_m, cfg, batch, z, generator=g, keys=draw_keys(Lg, g),
                                        planes=planes)

    def critic(keys):
        return lambda lbl: FT.discriminator_apply_fused(disc_m, cfg, batch, lbl, keys, planes=planes)

    parts = {}
    with torch.no_grad():
        (_, hard, soft), parts["critic: generator forward (no grad)"] = wall_ms(gen_fwd)
    keys = draw_keys(Ld, g)
    eps = torch.rand(tuple(mask.shape) + (1,), generator=g, device=dev)
    state.opt_d.zero_grad(set_to_none=True)
    wgan, parts["critic: real + fake fused forward"] = wall_ms(
        lambda: L.masked_mean(critic(keys)(hard), mask) - L.masked_mean(critic(keys)(types_onehot), mask))
    _, parts["critic: real + fake backward (kernels)"] = wall_ms(lambda: wgan.backward())
    gp, parts["critic: GP plain forward + input grad"] = wall_ms(lambda: L.gradient_penalty(
        lambda lbl: disc_m(batch, lbl, deterministic=False, keys=keys), types_onehot, soft, mask,
        cfg.LAMBDA_GP, eps=eps))
    _, parts["critic: GP double backward (plain)"] = wall_ms(lambda: gp.backward())
    _, parts["critic: Adam step"] = wall_ms(state.opt_d.step)

    state.opt_g.zero_grad(set_to_none=True)
    (logits, hard, _), parts["G: generator fused forward"] = wall_ms(gen_fwd)
    keys = draw_keys(Ld, g)
    (g_loss, _), parts["G: critic fused forward + losses"] = wall_ms(
        lambda: L.generator_loss(critic(keys), batch, logits, hard, cfg))
    _, parts["G: backward (critic + generator kernels)"] = wall_ms(
        lambda: g_loss.backward(inputs=list(gen_m.parameters())))
    _, parts["G: Adam step"] = wall_ms(state.opt_g.step)
    _, parts["G: metrics"] = wall_ms(lambda: M.compute_metrics(
        batch.type, hard.detach().argmax(-1), mask, batch.graph_mask, gid=batch.gid,
        num_graphs_per_slot=batch.graphs_per_slot))
    return parts


GAT_TRAIN_KERNELS = ("fwd_gemm_kernel", "fwd_attend_kernel", "fwd_apply_kernel", "bwd_norm_kernel",
                     "bwd_rows_kernel", "bwd_gather_kernel", "bwd_finalize_kernel")


def profile_step(step, batch, dev):
    """Device busy time and top kernels of one train step under torch.profiler.

    Only the trace's device rows (kernels, copies) are summed: a CPU op's
    device time is that of the kernels it launched, which have rows of their
    own.  Returns (wall ms, device ms or None, gat_train kernels' ms,
    [(kernel, ms), ...]); None when the trace shows no device time.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(6)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, ms = wall_ms(lambda: step(batch, g))
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda kv: -kv[1])
    busy = sum(v for _, v in rows)
    ours = sum(v for k, v in rows if any(f"{n}(" in k or f"{n}<" in k for n in GAT_TRAIN_KERNELS))
    return ms, (busy if busy > 0 else None), ours, rows


def int64_philox_ms(rows) -> float:
    """Device ms of the int64 bitwise / shift kernels in a trace: ops/dropout.py::keep_mask's
    Philox arithmetic (no other op of the step does int64 bit arithmetic)."""
    return sum(v for k, v in rows if "long" in k and ("Bitwise" in k or "shift" in k))


def int64_elementwise_ms(rows) -> float:
    """Device ms of every int64 elementwise kernel in a trace: keep_mask's Philox adds and
    multiplies too, and the little index arithmetic of the pooling and metrics."""
    return sum(v for k, v in rows if "<long" in k and "elementwise" in k)


def _int64_keep(shape, key, levels, width, device, rows=None):
    """The GP pass's mask as before the repair: keep_mask's int64 Philox, on the card."""
    from building_gan_torch.ops import dropout as drop

    return drop.keep_mask(shape, key, levels, width, device, rows)


def repair_check(state, cfg, batch, dev, card):
    """The GP pass's dropout masks come from the Philox kernel, bit-equal to keep_mask.

    One critic layer's mask at the step's shapes; then the step timed in turns
    with keep_mask's int64 Philox patched back into that pass (as before the
    repair) and with the kernel, before any profiler has run in this process.
    Returns {"int64": [ms, ms], "kernel": [ms, ms]}.
    """
    import math

    from building_gan_torch.ops import dropout as drop
    from building_gan_torch.train.step import make_train_step

    B, R, C = batch.mask.shape[0], math.prod(batch.grid_shape), cfg.DISCRIMINATOR_HIDDEN_DIM
    levels = drop.drop_levels(cfg.ENCODER_DROPOUT_RATE)
    key = drop.draw_keys(1, torch.Generator(device=dev).manual_seed(8))[0]
    kept = drop.dropout(torch.ones(B, R, C, device=dev), key, cfg.ENCODER_DROPOUT_RATE, width=C) != 0
    same = torch.equal(kept, drop.keep_mask((B, R, C), key, levels, C, dev))
    say(f"repair: GP-pass dropout mask of one critic layer ({B} x {R} x {C}) from the Philox kernel "
        f"== keep_mask bit for bit: {same} ({kept.float().mean().item():.4f} kept)")
    if not same:
        raise AssertionError("the GP pass's dropout mask differs from keep_mask's")

    kernel_keep = drop._keep
    step = make_train_step(cfg, state)
    g = torch.Generator(device=dev).manual_seed(9)
    times = {"int64": [], "kernel": []}
    try:
        for which in ("int64", "kernel", "kernel", "int64"):
            drop._keep = _int64_keep if which == "int64" else kernel_keep
            times[which].append(wall_ms(lambda: step(batch, g))[1])
    finally:
        drop._keep = kernel_keep
    say(f"repair: step ms in turns (int64, kernel, kernel, int64): {times['int64'][0]:.1f}, "
        f"{times['kernel'][0]:.1f}, {times['kernel'][1]:.1f}, {times['int64'][1]:.1f} on {card} "
        "(host clock; recorded, not claimed)")
    return times


def repair_trace(state, cfg, batch, dev, kernel_trace):
    """The step traced with keep_mask's int64 Philox in the GP pass, beside
    ``kernel_trace`` (profile_step's result for the kernel path): the int64
    kernels must be gone from the kernel path's trace."""
    from building_gan_torch.ops import dropout as drop
    from building_gan_torch.train.step import make_train_step

    kernel_keep = drop._keep
    drop._keep = _int64_keep
    try:
        int64_trace = profile_step(make_train_step(cfg, state), batch, dev)
    finally:
        drop._keep = kernel_keep
    for label, (ms, busy, _, rows) in (("before the repair (keep_mask's int64 Philox in the GP pass)",
                                        int64_trace), ("after (the Philox kernel)", kernel_trace)):
        busy_s = "not measured" if busy is None else f"{busy:.1f} ms"
        say(f"repair: step traced {label}: wall {ms:.1f} ms, device busy {busy_s}, int64 bitwise "
            f"and shift kernels {int64_philox_ms(rows):.1f} ms, all int64 elementwise kernels "
            f"{int64_elementwise_ms(rows):.1f} ms; top device kernels:")
        for name, v in rows[:8]:
            say(f"  device {v:8.2f} ms  {name[:110]}")
    if kernel_trace[3] and int64_philox_ms(kernel_trace[3]) > 0:
        raise AssertionError("the train step's trace still shows keep_mask's int64 kernels")
    if int64_trace[3] and int64_philox_ms(int64_trace[3]) <= 0:
        raise AssertionError("the int64 Philox kernels were not found in the trace of the int64 path")


# The trainer phase: the CLI on the card over real-scale buildings (cut from
# the 512 of the step phases to keep the phase near 90 s), then a Trainer in process.
TRAINER_BUILDINGS, TRAINER_SLOT_GRAPHS, TRAINER_BATCH_IN_PROCESS = 256, 6, 16
META_KEYS = ("epoch_start", "epoch_end", "best_f1_score", "f1_score_train", "f1_score_validation",
             "f1_score_min_train", "f1_score_min_validation", "f1_score_min_weightedsum",
             "recall_score_train", "recall_score_validation", "accuracy_score_train",
             "accuracy_score_validation")
LATEST_META_KEYS = ("epoch_start", "epoch_end", "best_f1_score", "is_latest")
REFERENCE_TAGS = (
    "g_loss_train", "d_loss_train", "g_loss_validation", "f1_score_train", "f1_score_validation",
    "f1_score_min_train", "f1_score_min_validation", "f1_score_min_weightedsum",
    "precision_score_train", "precision_score_validation", "recall_score_train",
    "recall_score_validation", "accuracy_score_train", "accuracy_score_validation",
)
TEST_METRICS = ("f1_score_test", "f1_score_min_test", "precision_score_test", "recall_score_test",
                "accuracy_score_test")


def write_raw(root, n):
    """n real-scale buildings (seeds 0..n-1) as raw JSON in the reference layout (as
    data/synthetic.py::write_dataset lays it out); -> the most program nodes of one."""
    import os

    from building_gan_torch.data import generate_building_real_scale

    layout = (("global_graph_data", "graph_global_{:06d}.json"),
              ("local_graph_data", "graph_local_{:06d}.json"), ("voxel_data", "voxel_{:06d}.json"))
    for sub, _ in layout:
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    max_local = 0
    for i in range(n):
        parts = generate_building_real_scale(i)
        max_local = max(max_local, len(parts[1]["node"]))
        for (sub, fmt), payload in zip(layout, parts):
            with open(os.path.join(root, sub, fmt.format(i)), "w") as f:
                json.dump(payload, f)
    return max_local


def run_cli(args, label, timeout_s=600):
    """``python -m building_gan_torch.cli.main *args`` in a subprocess from the repo root,
    with this tree first on PYTHONPATH; raises with its output's tail on failure."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "building_gan_torch.cli.main", *args], cwd=here,
                          env=env, capture_output=True, text=True, timeout=timeout_s)
    seconds = time.perf_counter() - t
    if proc.returncode != 0:
        say(proc.stdout[-3000:])
        say(proc.stderr[-3000:])
        raise AssertionError(f"CLI {label} exited {proc.returncode}")
    return proc.stdout, seconds


def count_syncs(fn):
    """(fn(), synchronizing CUDA calls it made, {python location: count}) with
    torch.cuda.set_sync_debug_mode("warn") around it."""
    import warnings
    from collections import Counter

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    import linecache

    def source(w):
        return linecache.getline(w.filename, w.lineno).strip()

    # the mode switch itself can be reported once, at torch's own set call: not the work's
    syncs = [w for w in caught if "synchroniz" in str(w.message)
             and "set_sync_debug_mode" not in source(w)]
    return out, len(syncs), Counter(
        f"{'/'.join(w.filename.split('/')[-2:])}:{w.lineno} ({source(w)[:60]})" for w in syncs)


def epoch_lines(out):
    """{epoch: {name: value}} from the trainer's "epoch N: g_loss=... f1=a/b ..." lines."""
    import re

    got = {}
    for ln in out.splitlines():
        m = re.match(r"epoch (\d+): (.*)", ln)
        if m:
            vals = {}
            for k, v in re.findall(r"(\w+)=(\S+)", m.group(2)):
                for tag, x in zip(("train", "validation"), v.split("/")):
                    vals[f"{k}_{tag}" if "/" in v else k] = float(x)
            got[int(m.group(1))] = vals
    return got


def cli_flow(common, run, tag, card):
    """The CLI on the card with the flags ``common``: train 2 epochs (checkpoints, metas
    and the reference tags checked), train to 3 (a resume from the latest checkpoint),
    test; every loss and score finite."""
    import os
    import re

    from building_gan_torch.checkpoint import ckpt
    from building_gan_torch.train.writer import JSONL_FILE, read_jsonl

    out, s_train = run_cli(["train", "--epochs", "2"] + common, "train --epochs 2")
    epochs = epoch_lines(out)
    times = [(f, float(x)) for f, x in re.findall(r"function (\w+) took ([\d.e-]+) seconds", out)]
    writer_line = next((ln for ln in out.splitlines() if ln.startswith("Scalar log:")), "")
    say(f"trainer ({tag}): CLI train --epochs 2 {s_train:.1f} s (process included); {writer_line}")
    for e, vals in sorted(epochs.items()):
        say(f"trainer ({tag}): epoch {e}: " + ", ".join(f"{k} {v:.4f}" for k, v in vals.items()))
    if sorted(epochs) != [1, 2]:
        raise AssertionError(f"train ran epochs {sorted(epochs)}, expected [1, 2]")
    if not all(np.isfinite(v) for vals in epochs.values() for v in vals.values()):
        raise AssertionError("a loss or score of the CLI's training is not finite")
    for f, m, keys in ((ckpt.STATE_FILE, ckpt.META_FILE, META_KEYS),
                       (ckpt.LATEST_STATE_FILE, ckpt.LATEST_META_FILE, LATEST_META_KEYS)):
        meta = ckpt.read_meta(run, f, m)
        if meta is None or set(meta) != set(keys):
            raise AssertionError(f"{f} / {m}: meta {meta}, expected the keys {keys}")
    if os.path.exists(os.path.join(run, JSONL_FILE)):
        scalars = {(r["tag"], r["step"]) for r in read_jsonl(run) if r["kind"] == "scalar"}
        missing = [(t, e) for t in REFERENCE_TAGS for e in (1, 2) if (t, e) not in scalars]
    else:  # tensorboardX's event file: the tags are in its bytes
        blob = b"".join(open(os.path.join(run, f), "rb").read() for f in os.listdir(run)
                        if f.startswith("events.out.tfevents"))
        missing = [t for t in REFERENCE_TAGS if t.encode() not in blob]
    if missing:
        raise AssertionError(f"scalar log lacks {missing[:5]}")
    step2 = torch.load(os.path.join(run, ckpt.LATEST_STATE_FILE), weights_only=True)["step"]
    say(f"trainer ({tag}): states.pt, states_latest.pt and both metas written with the JAX package's "
        f"keys; the 14 reference tags logged for epochs 1-2; step count {step2}")

    out, s_resume = run_cli(["train", "--epochs", "3"] + common, "train --epochs 3")
    epochs = epoch_lines(out)
    step3 = torch.load(os.path.join(run, ckpt.LATEST_STATE_FILE), weights_only=True)["step"]
    resumed = "Loaded latest states" in out
    say(f"trainer ({tag}): CLI train --epochs 3 {s_resume:.1f} s: resumed from the latest states: "
        f"{resumed}; ran epochs {sorted(epochs)}; step count {step2} -> {step3}")
    times += [(f, float(x)) for f, x in re.findall(r"function (\w+) took ([\d.e-]+) seconds", out)]
    if not resumed or sorted(epochs) != [3] or step3 != step2 + step2 // 2:
        raise AssertionError("the resumed run did not continue from the latest checkpoint")

    viz = viz_flags(1 if tag == "float32" else 0, f"trainer ({tag})")
    out, s_test = run_cli(["test"] + viz + common, "test")
    test = {k: float(v) for k, v in re.findall(r"(\w+_test): (\S+)", out)}
    say(f"trainer ({tag}): CLI test {s_test:.1f} s: " + ", ".join(f"{k} {v:.4f}" for k, v in test.items()))
    if set(test) != set(TEST_METRICS) or not all(np.isfinite(v) for v in test.values()):
        raise AssertionError(f"test printed {test}")
    rendered = [ln for ln in out.splitlines() if ln.startswith("rendered ")]
    if viz[1] != "0":
        say(f"trainer ({tag}): CLI test: {rendered[0] if rendered else 'no render line'}")
        if not rendered:
            raise AssertionError("test --num-samples-to-viz 1 rendered nothing")
    for f in ("_train_each_epoch", "_validate_each_epoch"):
        ts = [x for g, x in times if g == f]
        say(f"trainer ({tag}): {f} seconds (CLI runs, epochs 1-3, the first pays the set-up): "
            + ", ".join(f"{x:.3f}" for x in ts) + f" on {card}")


def trainer_phase(dev, card, root):
    """The trainer slice on the card: the CLI in subprocesses, then a Trainer in process,
    its raw and processed buildings under ``root`` (``root``/raw, ``root``/npz).

    Returns (the CLI's flags for the processed set at the config of record, {kernel:
    launches} of the in-process trainer path (eval step, generate, one train and one
    validation epoch))."""
    import math
    import os

    from building_gan_torch.checkpoint import ckpt
    from building_gan_torch.config import Configuration
    from building_gan_torch.data.pipeline import GraphDataLoaders
    from building_gan_torch.models.grid_models import GridVoxelGNNDiscriminator, GridVoxelGNNGenerator
    from building_gan_torch.ops import gat_train as gt
    from building_gan_torch.ops import hourglass as hg
    from building_gan_torch.ops.rng import normal_box_muller
    from building_gan_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    raw, npz, run = (os.path.join(root, d) for d in ("raw", "npz", "run"))
    max_local = write_raw(raw, TRAINER_BUILDINGS)
    local_nodes = int(math.ceil(TRAINER_SLOT_GRAPHS * max_local / 64.0)) * 64
    out, s_pre = run_cli(["preprocess", "--data-path", raw, "--save-data-path", npz], "preprocess")
    say(f"trainer: {TRAINER_BUILDINGS} real-scale buildings written as JSON; CLI preprocess "
        f"{s_pre:.1f} s: {out.strip().splitlines()[-1]}")
    common = ["--save-data-path", npz, "--log-dir", run, "--device", "cuda", "--compute-dtype",
              "float32", "--slot-graphs", str(TRAINER_SLOT_GRAPHS), "--grid-local-nodes",
              str(local_nodes), "--ckpt-latest-interval", "1"]
    cli_flow(common, run, "float32", card)
    # the JAX package's defaults: no --compute-dtype (bf16), GP_DTYPE "compute"
    run_b = os.path.join(root, "run_bf16")
    default = ["--save-data-path", npz, "--log-dir", run_b, "--device", "cuda",
               "--slot-graphs", str(TRAINER_SLOT_GRAPHS), "--grid-local-nodes", str(local_nodes),
               "--ckpt-latest-interval", "1"]
    cli_flow(default, run_b, "defaults (bfloat16)", card)

    # in process, on the same log dir: kernel launches, syncs, times, memory
    cfg = Configuration(SAVE_DATA_PATH=npz, COMPUTE_DTYPE="float32", EPOCHS=3,
                        GRID_SLOT_GRAPHS=TRAINER_SLOT_GRAPHS, GRID_LOCAL_NODES=local_nodes,
                        GRID_BATCH=TRAINER_BATCH_IN_PROCESS)
    torch.manual_seed(cfg.SEED)
    trainer = Trainer(GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg),
                      GraphDataLoaders(cfg), cfg, log_dir=run, device=dev)
    Ld = len(trainer.discriminator.encoder.channels)
    batch = next(iter(trainer.dataloaders.test_dataloader)).to(dev)
    counters = {"hourglass_fwd": hg.launches, "gat_train_fwd": gt.fwd_launches,
                "gat_train_bwd": gt.bwd_launches, "dropout_bytes": gt.bytes_launches}
    for c in counters.values():
        c.reset()
    g = torch.Generator(device=dev).manual_seed(3)
    logits, hard, _ = trainer.generate(batch, g)
    torch.cuda.synchronize()
    gen_launches = (hg.launches.value, gt.fwd_launches.value)
    g = torch.Generator(device=dev).manual_seed(3)
    z = normal_box_muller(tuple(batch.mask.shape) + (cfg.Z_DIM,), g)
    with torch.no_grad():
        plain, plain_hard, _ = trainer.generator(batch, z, generator=g)
    lerr = (logits - plain).abs().max().item()
    real = batch.mask > 0
    agree = (hard.argmax(-1) == plain_hard.argmax(-1))[real].float().mean().item()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    metrics = trainer.eval_step(batch, torch.Generator(device=dev).manual_seed(4))
    torch.cuda.synchronize()
    eval_peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
    eval_launches = (hg.launches.value - gen_launches[0], gt.fwd_launches.value - gen_launches[1])
    say(f"trainer: Trainer.generate on a test batch ({batch.mask.shape[0]} slots): launches "
        f"hourglass {gen_launches[0]}, training forward {gen_launches[1]}; logits vs the plain "
        f"generator's max abs {lerr:.3e} (tol {LOGITS_ATOL}), labels equal on {100 * agree:.3f}% "
        "of real cells")
    say(f"trainer: one eval step: launches hourglass {eval_launches[0]}, training forward "
        f"{eval_launches[1]} (expect 1 and {Ld}); g_loss {metrics['g_loss'].item():.5f}, f1 "
        f"{metrics['f1'].item():.4f}; peak device memory above the start {eval_peak:.3f} GiB")
    if gen_launches != (1, 0) or eval_launches != (1, Ld):
        raise AssertionError("the eval path did not launch the kernels as expected")
    if not (np.isfinite(lerr) and lerr <= LOGITS_ATOL):
        raise AssertionError("Trainer.generate's logits disagree with the plain generator's")
    if not all(torch.isfinite(v).all().item() for v in metrics.values()):
        raise AssertionError("the eval step's metrics are not finite")
    # what an autograd-recording fused critic keeps, against the eval step's no_grad pass
    from building_gan_torch.models import fast_train as FT

    label = torch.nn.functional.one_hot(batch.type.long(), 7).float()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    with torch.enable_grad():
        scores = FT.discriminator_apply_fused(trainer.discriminator, cfg, batch, label,
                                              deterministic=True)
        kept = (torch.cuda.memory_allocated(dev) - base) / 2**30
    del scores
    say(f"trainer: the fused critic forward with autograd on keeps {kept:.3f} GiB for its "
        "backward; the eval step (no_grad) keeps none of it: its peak above is one layer's")

    ms_eval = timed_ms(lambda: trainer.eval_step(batch, g), 5)
    say(f"trainer: eval step {ms_eval:.2f} ms a batch of {batch.mask.shape[0]} slots "
        f"(CUDA events, 5 calls) on {card}")

    n_val = trainer.dataloaders.validation_dataloader.num_packs_per_epoch()
    n_train = trainer.dataloaders.train_dataloader.num_packs_per_epoch()
    t = time.perf_counter()
    _, syncs_val, where_val = count_syncs(lambda: trainer._validate_each_epoch(3))
    s_val = time.perf_counter() - t
    t = time.perf_counter()
    _, syncs_tr, where_tr = count_syncs(lambda: trainer._train_each_epoch(3))
    s_tr = time.perf_counter() - t
    say(f"trainer: host syncs an epoch (torch.cuda.set_sync_debug_mode): train {syncs_tr} over "
        f"{n_train} batches {dict(where_tr.most_common(4))}, validation {syncs_val} over {n_val} "
        f"batches {dict(where_val.most_common(4))}; seconds an epoch here (GRID_BATCH "
        f"{TRAINER_BATCH_IN_PROCESS}): train {s_tr:.2f}, validation {s_val:.2f} on {card}")

    save_dir = os.path.join(root, "ckpt_timing")
    t = time.perf_counter()
    ckpt.save_latest(save_dir, trainer.state, {"epoch_start": 4})
    s_save = time.perf_counter() - t
    t = time.perf_counter()
    ckpt.load_latest(save_dir, trainer.state, map_location=dev)
    torch.cuda.synchronize()
    s_load = time.perf_counter() - t
    size = os.path.getsize(os.path.join(save_dir, ckpt.LATEST_STATE_FILE)) / 2**20
    say(f"trainer: checkpoint write {s_save:.3f} s, resume (load onto the card) {s_load:.3f} s, "
        f"{size:.1f} MiB")
    launches = {k: c.value for k, c in counters.items()}
    say(f"trainer: launches on the in-process trainer path {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the trainer path was never launched: {launches}")
    say(f"phase: trainer {time.perf_counter() - t_phase:.1f} s")
    grid_flags = ["--save-data-path", npz, "--device", "cuda", "--slot-graphs",
                  str(TRAINER_SLOT_GRAPHS), "--grid-local-nodes", str(local_nodes)]
    return grid_flags, launches


# Phase 10: the conv registry (GATV2CONV, GCNCONV, GRAPHCONV) on the grid and the packed
# edge-list layout (all four convs), at the config of record's widths.  None of these
# paths has a fused kernel: they run the plain modules on the card.
REGISTRY_CONVS = ("GATV2CONV", "GCNCONV", "GRAPHCONV")
EDGE_CONVS = ("GATCONV",) + REGISTRY_CONVS
REGISTRY_STEPS, PARITY_BUILDINGS, REGISTRY_REQUESTS, REGISTRY_CLIENTS = 2, 16, 16, 4
PARITY_RTOL, PARITY_ATOL = 5e-3, 1e-3  # grid vs edge, the JAX package's (tests/test_grid.py)


FUSED_STEP = (0, 150, 80, 30)  # a fused WGAN-GP step's launches at the config of record


def layer_launches():
    """(hourglass, training forward, training backward, dropout-byte) launch counts so far."""
    from building_gan_torch.ops import gat_train as gt
    from building_gan_torch.ops import hourglass as hg

    return (hg.launches.value, gt.fwd_launches.value, gt.bwd_launches.value,
            gt.bytes_launches.value)


def step_launches(cfg, state, fused=True):
    """(hourglass, training forward, training backward, dropout-byte) launches one train step of
    ``state`` makes, from the step's structure: N_CRITIC critic updates, each a stop-grad
    generator forward, the critic on real and fake labels and (WGAN-GP only) the plain
    critic inside the penalty, then the G update's generator and critic.  A fused model
    launches its layers' kernels (backward where a gradient flows: the critic updates' and
    the G update's critic, the G update's generator); a plain one draws each dropout site's
    bytes with the Philox kernel.  ``fused=False``: the step's plain route (a floor-sharded
    rank's, or ``make_train_step(..., fused=False)``), 0 training-layer launches."""
    from building_gan_torch.models.fast_infer import fused_route

    n, gp = cfg.N_CRITIC, int(cfg.USE_WGANGP)
    gf = int(fused and fused_route(state.generator))
    df = int(fused and fused_route(state.discriminator))
    Lg, Ld = state.generator.dropout_sites, state.discriminator.dropout_sites
    return (0, (n + 1) * Lg * gf + (2 * n + 1) * Ld * df, Lg * gf + (2 * n + 1) * Ld * df,
            (n + 1) * Lg * (1 - gf) + (2 * n + 1) * Ld * (1 - df) + n * Ld * gp)


def counted_steps(cfg, batch, dev, steps, tag, card, want=None):
    """``steps`` train steps of fresh models (weights from torch.manual_seed(cfg.SEED)) on
    ``batch``, the models by cfg.LAYOUT and cfg.GENERATOR_ARCH: each step finite, with
    ``want`` (hourglass, training forward, backward, dropout-byte) launches (default:
    ``step_launches``); -> (state, step ms, peak GiB)."""
    from building_gan_torch.models.discriminator import VoxelGNNDiscriminator
    from building_gan_torch.models.generator import VoxelGNNGenerator
    from building_gan_torch.models.grid_models import GridVoxelGNNDiscriminator, GridVoxelGNNGenerator
    from building_gan_torch.models.transformer import GridTransformerGenerator
    from building_gan_torch.train.state import create_train_state
    from building_gan_torch.train.step import make_train_step

    if cfg.LAYOUT != "grid":
        G, D = VoxelGNNGenerator, VoxelGNNDiscriminator
    else:
        G = GridTransformerGenerator if cfg.GENERATOR_ARCH == "transformer" else GridVoxelGNNGenerator
        D = GridVoxelGNNDiscriminator
    torch.manual_seed(cfg.SEED)
    state = create_train_state(cfg, G(cfg), D(cfg), device=dev)
    want = step_launches(cfg, state) if want is None else want
    step = make_train_step(cfg, state)
    gen = torch.Generator(device=dev).manual_seed(0)
    n_real = int(batch.cell_mask.sum().item())
    ms, peak = [], []
    for i in range(steps):
        before = layer_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        m, t = wall_ms(lambda: step(batch, gen))
        ms.append(t)
        peak.append(torch.cuda.max_memory_allocated(dev) / 2**30)
        got = tuple(b - a for a, b in zip(before, layer_launches()))
        bad = [k for k, v in m.items() if not torch.isfinite(v).all().item()]
        say(f"{tag} step {i + 1}: {t:.1f} ms, {n_real / (t / 1e3):.1f} real voxel nodes/s, peak "
            f"device memory {peak[-1]:.3f} GiB; g_loss {m['g_loss'].item():.5f}, d_loss "
            f"{m['d_loss'].item():.5f}, f1 {m['f1'].item():.4f}; launches hourglass {got[0]}, "
            f"training forward {got[1]}, backward {got[2]}, dropout bytes {got[3]} (expect "
            f"{want}) on {card}")
        if bad:
            raise AssertionError(f"{tag} step {i + 1}: non-finite {bad}")
        if got != tuple(want):
            raise AssertionError(f"{tag} step {i + 1}: launches {got}, expected {want}")
    return state, ms, peak


def plain_steps(cfg, batch, dev, steps, tag, card):
    """``steps`` train steps of fresh plain models on ``batch``, the grid's or the edge list's
    by cfg.LAYOUT: each step finite, no layer-kernel launch (hourglass, training forward or
    backward), every dropout mask's bytes from the Philox kernel (each critic update's
    generator, real, fake and GP passes, then the G update's generator and critic passes);
    -> (state, step ms, peak GiB)."""
    Lg, Ld = 2 * cfg.GENERATOR_ENCODER_REPEAT, 2 * cfg.DISCRIMINATOR_ENCODER_REPEAT
    want = (0, 0, 0, cfg.N_CRITIC * (Lg + 3 * Ld) + Lg + Ld)
    state, ms, peak = counted_steps(cfg, batch, dev, steps, tag, card, want)
    if step_launches(cfg, state) != want:
        raise AssertionError(f"{tag}: a model took the fused route")
    return state, ms, peak


def grid_convs(cfg_t, batch_t, dev, card):
    """(a): each other conv of the registry on phase 7's batch (105 slots, K=6): 2 steps at
    the JAX default bf16 and 2 at f32, one eval step, and a server answering 16 requests
    from 4 threads; no kernel of the GATCONV path is launched."""
    from building_gan_torch.config import Configuration
    from building_gan_torch.data import generate_building_real_scale, process_building
    from building_gan_torch.train.step import make_eval_step

    serve_cfg = Configuration()  # the JAX defaults: bf16, grid (11, 12, 12)
    seeds = list(range(1000, 1000 + REGISTRY_REQUESTS))
    samples = [process_building(*generate_building_real_scale(s), serve_cfg, str(s)) for s in seeds]
    threads = []
    for conv in REGISTRY_CONVS:
        cfg = cfg_t.replace(GENERATOR_CONV_TYPE=conv, DISCRIMINATOR_CONV_TYPE=conv)
        cfg_b = cfg.replace(COMPUTE_DTYPE="bfloat16")
        state, ms, peak = plain_steps(cfg_b, batch_t, dev, REGISTRY_STEPS, f"grid {conv} (bfloat16)",
                                      card)
        plain_steps(cfg, batch_t, dev, REGISTRY_STEPS, f"grid {conv} (float32)", card)
        before = layer_launches()
        m, t = wall_ms(lambda: make_eval_step(cfg_b, state)(
            batch_t, torch.Generator(device=dev).manual_seed(1)))
        got = tuple(b - a for a, b in zip(before, layer_launches()))
        bad = [k for k, v in m.items() if not torch.isfinite(v).all().item()]
        say(f"grid {conv} (bfloat16) eval step: {t:.1f} ms, g_loss {m['g_loss'].item():.5f}, f1 "
            f"{m['f1'].item():.4f}; launches {got} (expect none)")
        if bad or any(got):
            raise AssertionError(f"grid {conv} eval step: non-finite {bad}, launches {got}")
        del state
        served = serve(serve_cfg.replace(GENERATOR_CONV_TYPE=conv), samples, seeds, dev, card,
                       requests=REGISTRY_REQUESTS, clients=REGISTRY_CLIENTS)
        threads += served["threads"] + [served["server"]._thread]
        torch.cuda.empty_cache()
    return threads


@functools.lru_cache(maxsize=None)
def edge_packs():
    """(cfg, the 512 buildings' packs at the JAX default budgets on the CPU, host s)."""
    from building_gan_torch.config import Configuration
    from building_gan_torch.data.batching import pack_graphs

    cfg = Configuration(LAYOUT="edges", ENCODER_DROPOUT_RATE=DROPOUT_RATE)
    t = time.perf_counter()
    packs = pack_graphs(list(train_samples()), cfg)
    return cfg, tuple(packs), time.perf_counter() - t


def fullest_edge_pack(dev):
    """(edge cfg, the pack with the most real voxel nodes, on ``dev``)."""
    cfg, packs, _ = edge_packs()
    return cfg, max(packs, key=lambda p: float(p.voxel_mask.sum())).to(dev)


def edge_layout(dev, card):
    """(b): the 512 buildings packed at the JAX default budgets; the fullest pack through 2
    steps at bf16 for each conv (GATCONV also 1 at f32)."""
    from building_gan_torch.data.batching import pack_budgets, pack_need

    samples = list(train_samples())
    cfg, packs, seconds = edge_packs()
    budgets = pack_budgets(cfg)
    names = ("graphs", "local nodes", "local edges", "voxel nodes", "voxel edges")
    need = np.array([pack_need(*s) for s in samples]).sum(0)
    say(f"edges: {len(samples)} buildings in {len(packs)} packs at the JAX default budgets "
        f"({seconds:.1f} s on the host); the set needs "
        + ", ".join(f"{n} {int(v)}" for n, v in zip(names, need)))
    for i, p in enumerate(packs):
        used = (int(p.graph_mask.sum()), int(p.local_mask.sum()), int(p.local_edge_mask.sum()),
                int(p.voxel_mask.sum()), int(p.voxel_edge_mask.sum()))
        say(f"edges: pack {i} fill " + ", ".join(
            f"{n} {u}/{b} ({100 * u / b:.1f}%)" for n, u, b in zip(names, used, budgets)))
    _, batch = fullest_edge_pack(dev)
    for conv in EDGE_CONVS:
        c = cfg.replace(GENERATOR_CONV_TYPE=conv, DISCRIMINATOR_CONV_TYPE=conv)
        plain_steps(c, batch, dev, REGISTRY_STEPS, f"edges {conv} (bfloat16)", card)
        if conv == "GATCONV":
            plain_steps(c.replace(COMPUTE_DTYPE="float32"), batch, dev, 1,
                        f"edges {conv} (float32)", card)
        torch.cuda.empty_cache()


def layout_parity(dev, card):
    """(c): for each conv, one state_dict in the grid and the edge models, the first 16
    buildings, f32 (TF32 off), deterministic algorithms, the same z: logits and scores on
    real cells within the JAX package's grid-vs-edge tolerance."""
    from building_gan_torch.config import Configuration
    from building_gan_torch.data import pack_grid
    from building_gan_torch.data.batching import pack_graphs
    from building_gan_torch.models.discriminator import VoxelGNNDiscriminator
    from building_gan_torch.models.generator import VoxelGNNGenerator
    from building_gan_torch.models.grid_models import GridVoxelGNNDiscriminator, GridVoxelGNNGenerator

    cfg0 = Configuration(COMPUTE_DTYPE="float32")
    samples = list(train_samples())[:PARITY_BUILDINGS]
    pack = pack_graphs(samples, cfg0)[0].to(dev)
    gb = pack_grid(samples, cfg0, batch_slots=PARITY_BUILDINGS).to(dev)
    nv = pack.voxel_x.shape[0]
    g = torch.Generator(device=dev).manual_seed(5)
    z_e = torch.randn(nv, cfg0.Z_DIM, generator=g, device=dev) * pack.voxel_mask[:, None]
    label_e = torch.nn.functional.one_hot(pack.voxel_type, 7).float() * pack.voxel_mask[:, None]
    cells, offset = [], 0
    for b, (_, voxel) in enumerate(samples):
        n = voxel.x.shape[0]
        f, y, x = (torch.as_tensor(a, device=dev) for a in voxel.location.astype(np.int64).T)
        cells.append((b, f, y, x, offset, n))
        offset += n
    z_g = torch.zeros(tuple(gb.mask.shape) + (cfg0.Z_DIM,), device=dev)
    label_g = torch.zeros(tuple(gb.mask.shape) + (7,), device=dev)
    for b, f, y, x, o, n in cells:
        z_g[b, f, y, x] = z_e[o: o + n]
        label_g[b, f, y, x] = label_e[o: o + n]

    def on_cells(grid_out):
        return torch.cat([grid_out[b, f, y, x] for b, f, y, x, _, _ in cells])

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for conv in EDGE_CONVS:
            cfg = cfg0.replace(GENERATOR_CONV_TYPE=conv, DISCRIMINATOR_CONV_TYPE=conv)
            torch.manual_seed(cfg.SEED)
            grid = (GridVoxelGNNGenerator(cfg).to(dev), GridVoxelGNNDiscriminator(cfg).to(dev))
            with torch.no_grad():
                for m in grid:  # GraphNorm parameters and biases off their inits
                    for p in m.parameters():
                        p.add_(0.05 * torch.randn_like(p))
            edge = (VoxelGNNGenerator(cfg).to(dev), VoxelGNNDiscriminator(cfg).to(dev))
            for e, m in zip(edge, grid):
                e.load_state_dict(m.state_dict())
            with torch.no_grad():
                logits_g = on_cells(grid[0](gb, z_g, gumbel_noise=torch.zeros_like(label_g))[0])
                logits_e = edge[0](pack, z_e, gumbel_noise=torch.zeros(nv, 7, device=dev))[0][:offset]
                score_g = on_cells(grid[1](gb, label_g))
                score_e = edge[1](pack, label_e)[:offset]
            for name, got, want in (("logits", logits_g, logits_e), ("scores", score_g, score_e)):
                diff = (got - want).abs()
                excess = (diff - (PARITY_ATOL + PARITY_RTOL * want.abs())).max().item()
                say(f"parity {conv} {name}: grid vs edges max abs {diff.max().item():.3e} over "
                    f"{offset} real cells (scale {want.abs().max().item():.3f}); tolerance rtol "
                    f"{PARITY_RTOL} atol {PARITY_ATOL}, margin {-excess:.3e}")
                if not (torch.isfinite(got).all().item() and excess <= 0):
                    raise AssertionError(f"grid and edge layouts disagree: {conv} {name}")
            del grid, edge
    finally:
        torch.use_deterministic_algorithms(False)


def registry_cli(grid_flags, root, card):
    """(d): the CLI on phase 9's processed buildings (``root``/npz): train --layout edges 1
    epoch then test (the JAX default budgets), and train --conv-type GCNCONV 1 epoch on the
    grid with phase 9's grid flags."""
    import os
    import re

    npz = os.path.join(root, "npz")
    for tag, flags, test in (
        ("--layout edges", ["--save-data-path", npz, "--device", "cuda", "--layout", "edges"], True),
        ("--conv-type GCNCONV", grid_flags + ["--conv-type", "GCNCONV"], False),
    ):
        run = os.path.join(root, "run_" + re.sub(r"\W+", "_", tag))
        out, s_train = run_cli(["train", "--epochs", "1", "--log-dir", run] + flags, f"train {tag}")
        epochs = epoch_lines(out)
        say(f"cli {tag}: train --epochs 1 {s_train:.1f} s (process included): "
            + ", ".join(f"{k} {v:.4f}" for k, v in epochs.get(1, {}).items()) + f" on {card}")
        if sorted(epochs) != [1] or not all(np.isfinite(v) for v in epochs[1].values()):
            raise AssertionError(f"CLI train {tag}: epochs {epochs}")
        if test:
            out, s_test = run_cli(["test", "--log-dir", run] + viz_flags(0, f"cli {tag}") + flags,
                                  f"test {tag}")
            got = {k: float(v) for k, v in re.findall(r"(\w+_test): (\S+)", out)}
            say(f"cli {tag}: test {s_test:.1f} s: " + ", ".join(f"{k} {v:.4f}" for k, v in got.items()))
            if set(got) != set(TEST_METRICS) or not all(np.isfinite(v) for v in got.values()):
                raise AssertionError(f"CLI test {tag} printed {got}")


def registry_phase(cfg_t, batch_t, grid_flags, root, dev, card):
    """Phase 10: the conv registry and the edge layout; -> the server and client threads it
    started (all stopped)."""
    t_phase = time.perf_counter()
    t = time.perf_counter()
    threads = grid_convs(cfg_t, batch_t, dev, card)
    say(f"phase 10a: grid convs {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    edge_layout(dev, card)
    say(f"phase 10b: edge layout {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    layout_parity(dev, card)
    say(f"phase 10c: grid vs edge parity {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    registry_cli(grid_flags, root, card)
    say(f"phase 10d: CLI {time.perf_counter() - t:.1f} s")
    say(f"phase: conv registry and edge layout {time.perf_counter() - t_phase:.1f} s")
    return threads


# Phase 11: the reference's other training modes (the BCE losses, the batch-level quirks), the
# transformer generator, GRID_BUCKETS and the router, at the config of record's widths.
MODE_STEPS = 2
BUCKETS = ((6, 6, 6), (8, 8, 8), (11, 12, 12))
BUCKET_EXTRA_SEEDS = range(2000, 2400)  # default-scale buildings for a bucket the 512 leave empty
ROUTER_GRIDS = {"small": (8, 8, 8), "big": (11, 12, 12)}
ROUTER_REQUESTS, ROUTER_CLIENTS, ROUTER_SWAP_AFTER = 32, 8, 12  # each client: 2 requests, the swap, 2


def mode_steps(cfg_t, batch_t, dev, card):
    """(a) the BCE losses (USE_WGANGP=False): 2 bf16 steps and 1 f32 step, every critic pass
    fused (no penalty: no plain pass, no dropout-byte launch); (b) BATCH_LEVEL_MATCHING alone,
    2 bf16 steps with phase 7's launches, then both batch-level flags, 2 bf16 steps, every
    layer plain (180 dropout-byte launches a step)."""
    cfg_tb = cfg_t.replace(COMPUTE_DTYPE="bfloat16")
    n_real = int(batch_t.mask.sum().item())
    for tag, cfg, steps, want in (
        ("BCE (bfloat16)", cfg_tb.replace(USE_WGANGP=False), MODE_STEPS, (0, 150, 80, 0)),
        ("BCE (float32)", cfg_t.replace(USE_WGANGP=False), 1, (0, 150, 80, 0)),
        ("batch-level matching (bfloat16)", cfg_tb.replace(BATCH_LEVEL_MATCHING=True), MODE_STEPS,
         (0, 150, 80, 30)),
        ("batch-level matching and GraphNorm (bfloat16)",
         cfg_tb.replace(BATCH_LEVEL_MATCHING=True, BATCH_LEVEL_GRAPHNORM=True), MODE_STEPS,
         (0, 0, 0, 180)),
    ):
        state, ms, peak = counted_steps(cfg, batch_t, dev, steps, tag, card, want)
        if step_launches(cfg, state) != want:
            raise AssertionError(f"{tag}: the step's structure gives {step_launches(cfg, state)}")
        say(f"{tag}: steps {' '.join(f'{t:.1f}' for t in ms)} ms, {n_real / (ms[-1] / 1e3):.1f} real "
            f"voxel nodes/s (last step), peak device memory {max(peak):.3f} GiB on {card}")
        del state
        torch.cuda.empty_cache()


def transformer_steps(cfg_t, batch_t, dev, card):
    """(c) the transformer generator at the config of record's widths (hidden 128, 4 blocks of
    4 heads) against the GATCONV critic (hidden 64, repeat 3): 2 bf16 steps and 1 f32 step
    (66 forward and 66 backward training-layer launches, 78 dropout-byte launches: the
    generator's 8 sites in 6 forwards and the penalty's 30), an eval step (the critic's 6
    forward launches, no hourglass), then one building's logits alone against the same
    building in its K = 6 slot (f32, deterministic): the port keeps a slot's buildings apart."""
    from building_gan_torch.data import pack_grid, pack_grid_multi_from_slots
    from building_gan_torch.models.transformer import GridTransformerGenerator
    from building_gan_torch.train.step import make_eval_step

    cfg = cfg_t.replace(COMPUTE_DTYPE="bfloat16", GENERATOR_ARCH="transformer", TRANSFORMER_LAYERS=4,
                        TRANSFORMER_HEADS=4)
    n_real = int(batch_t.mask.sum().item())
    for tag, c, steps in (("transformer (bfloat16)", cfg, MODE_STEPS),
                          ("transformer (float32)", cfg.replace(COMPUTE_DTYPE="float32"), 1)):
        state, ms, peak = counted_steps(c, batch_t, dev, steps, tag, card, (0, 66, 66, 78))
        if step_launches(c, state) != (0, 66, 66, 78):
            raise AssertionError(f"{tag}: the step's structure gives {step_launches(c, state)}")
        say(f"{tag}: steps {' '.join(f'{t:.1f}' for t in ms)} ms, {n_real / (ms[-1] / 1e3):.1f} real "
            f"voxel nodes/s (last step), peak device memory {max(peak):.3f} GiB ({batch_t.mask.shape[0]} "
            f"slots, no cut) on {card}")
        if c.COMPUTE_DTYPE == "bfloat16":
            before = layer_launches()
            m, t = wall_ms(lambda: make_eval_step(c, state)(batch_t,
                                                            torch.Generator(device=dev).manual_seed(1)))
            got = tuple(b - a for a, b in zip(before, layer_launches()))
            bad = [k for k, v in m.items() if not torch.isfinite(v).all().item()]
            say(f"{tag} eval step: {t:.1f} ms, g_loss {m['g_loss'].item():.5f}, f1 {m['f1'].item():.4f}; "
                f"launches {got} (expect (0, 6, 0, 0))")
            if bad or got != (0, 6, 0, 0):
                raise AssertionError(f"{tag} eval step: non-finite {bad}, launches {got}")
            weights = state.generator.state_dict()
        del state
        torch.cuda.empty_cache()

    samples, slots = list(train_samples()[:TRAIN_BATCH_BUILDINGS]), train_slots()
    slot = max(slots, key=lambda s: len(s.placed))
    cfg32 = cfg.replace(COMPUTE_DTYPE="float32")
    model = GridTransformerGenerator(cfg32).to(dev).eval()
    model.load_state_dict(weights)
    b6 = pack_grid_multi_from_slots(samples, [slot], cfg32, batch_slots=1).to(dev)
    g = torch.Generator(device=dev).manual_seed(21)
    z6 = torch.randn(tuple(b6.mask.shape) + (cfg.Z_DIM,), generator=g, device=dev)
    worst = 0.0
    with torch.no_grad():
        out6 = model(b6, z6, gumbel_noise=torch.zeros(tuple(b6.mask.shape) + (7,), device=dev))[0]
        for i, (f0, y0, x0) in slot.placed:
            b1 = pack_grid([samples[i]], cfg32, batch_slots=1).to(dev)
            f, y, x = (torch.as_tensor(a, device=dev) for a in samples[i][1].location.astype(np.int64).T)
            z1 = torch.zeros(tuple(b1.mask.shape) + (cfg.Z_DIM,), device=dev)
            z1[0, f, y, x] = z6[0, f + f0, y + y0, x + x0]
            out1 = model(b1, z1, gumbel_noise=torch.zeros(tuple(b1.mask.shape) + (7,), device=dev))[0]
            worst = max(worst, (out1[0, f, y, x] - out6[0, f + f0, y + y0, x + x0]).abs().max().item())
    say(f"transformer: each of the {len(slot.placed)} buildings of a K={cfg.GRID_SLOT_GRAPHS} slot alone "
        f"(K=1) against inside its slot, f32, deterministic: logits max abs {worst:.3e} (tol "
        f"{LOGITS_ATOL})")
    if not (np.isfinite(worst) and worst <= LOGITS_ATOL):
        raise AssertionError("the transformer's buildings of one slot do not stay apart")


def bucket_kernels(tag, batch, dev, card):
    """At one batch's shapes (a bucket's packed slots, or phase 12's one slot): the hourglass at
    f32 and bf16 against its plain version by the f64 rules (phase 3, 6b), the cluster size it
    chooses, and its time at each; the generator (Cmax 128) and critic (Cmax 64) training
    stacks at f32 and bf16 each layer alone on the kernel's own activations, the stack equal
    to the chain (``hold_chain``), and the generator stack's forward and backward timed.
    Raises on a failure."""
    from building_gan_torch.ops import dropout as drop
    from building_gan_torch.ops import gat_train as gt
    from building_gan_torch.ops import hourglass as hg

    grid, K = batch.grid_shape, batch.graphs_per_slot
    B, R = batch.mask.shape[0], int(np.prod(grid))
    gen = torch.Generator().manual_seed(41)
    kgen = torch.Generator(device=dev).manual_seed(42)
    planes = gt.build_planes(batch.mask, batch.gid, grid)
    (Ws, atts, vecs), chans = perturbed_stack(128, 7, gen, dev)
    x = torch.randn((B,) + tuple(grid) + (128,), generator=gen).to(dev)
    mask, gid = batch.mask.contiguous(), None if batch.gid is None else batch.gid.contiguous()
    for dt in (torch.float32, BF16):
        args = (x.to(dt), mask, Ws, atts, vecs, chans, gid, K)
        with torch.no_grad():
            got = hg.hourglass_cuda(*args)
            want = hg.hourglass_plain(*args)
            want64 = (hourglass_stored64(*args) if dt == BF16 else hg.hourglass_plain(
                *(a.double() if torch.is_tensor(a) and a.is_floating_point() else a for a in args)))
        torch.cuda.synchronize()
        ok, report, err = f64_rule(got, want, want64)
        say(f"{tag}: hourglass {str(dt)[6:]} ({B} slots, K={K}) {report}")
        if not ok:
            raise AssertionError(f"{tag}: the hourglass kernel disagrees with its plain version at {dt}")
        del got, want, want64
        with torch.no_grad():
            hg.hourglass_cuda(*args)
            ms = timed_ms(lambda: hg.hourglass_cuda(*args), 10)
        bound = bound_of(B, R, chans, 128, K, act_bytes=4 if dt == torch.float32 else 2)
        say(f"{tag}: hourglass kernel {str(dt)[6:]} {ms:.4f} ms (CUDA events, 10 launches), bound "
            f"{bound[0]:.4f} ms ({bound[1]}), cluster {hg.cluster_size(B, R, 128, K, chans)} CTAs a "
            f"slot on {card}")
    for name, hidden, repeat in (("generator", 128, 7), ("critic", 64, 3)):
        weights, tchans = perturbed_stack(hidden, repeat, gen, dev)
        keys = drop.draw_keys(len(tchans), kgen)
        for dt in (torch.float32, BF16):
            xs = torch.randn(B, R, hidden, generator=gen).to(dev, dt)
            gy = torch.randn(B, R, hidden, generator=gen).to(dev, dt)
            fused, _ = stack_fns(planes, keys, grid, K, tchans, dt)
            stack = with_grads(fused, (xs, *weights), gy)
            hold_chain(f"{tag}: {name}", xs, gy, planes, weights, keys, grid, K, tchans,
                       range(len(tchans)), stack=stack)
            del stack
            if name == "generator" and dt == torch.float32:
                leaves = [t.clone().requires_grad_(True) for t in (xs, *weights)]
                with torch.no_grad():
                    fused(*leaves)
                    kf = timed_ms(lambda: fused(*leaves), 5)
                y = fused(*leaves)
                back = lambda: torch.autograd.grad(y, leaves, gy, retain_graph=True)  # noqa: E731
                back()
                kb = timed_ms(back, 5)
                fb = train_bound(B, R, tchans, hidden, False, True)
                bb = train_bound(B, R, tchans, hidden, True, True)
                say(f"{tag}: generator stack (14 layers) forward {kf:.3f} ms (bound {fb[0]:.4f}, "
                    f"{fb[1]}), backward {kb:.3f} ms (bound {bb[0]:.4f}, {bb[1]}) on {card}")
                del y, leaves
            torch.cuda.empty_cache()


def bucket_phase(cfg_t, grid_flags, root, dev, card):
    """(d) GRID_BUCKETS: the 512 buildings through the bucket loader at K = 6 and GRID_BATCH
    64 (buildings, slots and batches a bucket); on each bucket's first batch
    ``bucket_kernels`` and one bf16 train step with phase 7's launches; then ``train
    --grid-buckets ... --slot-graphs 6`` for one epoch and ``test`` on phase 9's buildings."""
    import os

    from building_gan_torch.data import generate_building, process_building
    from building_gan_torch.data.pipeline import PackedLoader

    cfg = cfg_t.replace(GRID_BUCKETS=BUCKETS)
    samples = list(train_samples())
    t = time.perf_counter()
    batches = PackedLoader(samples, cfg, shuffle=False)._make_batches(samples)
    for shape in BUCKETS:
        if any(b.grid_shape == shape for b in batches):
            continue
        smaller = [b for b in BUCKETS if np.prod(b) < np.prod(shape)]
        extra = []
        for seed in BUCKET_EXTRA_SEEDS:
            s = process_building(*generate_building(seed), cfg, f"{seed:06d}")
            e = s[1].location.max(axis=0) + 1
            if (e <= shape).all() and not any((e <= b).all() for b in smaller):
                extra.append(s)
            if len(extra) == 12:
                break
        say(f"buckets: the 512 buildings leave {shape} empty; {len(extra)} default-scale synthetic "
            f"buildings (seeds from {BUCKET_EXTRA_SEEDS.start}) added for it")
        samples += extra
        batches = PackedLoader(samples, cfg, shuffle=False)._make_batches(samples)
    by_shape = {shape: [b for b in batches if b.grid_shape == shape] for shape in BUCKETS}
    say(f"buckets: {len(samples)} buildings at GRID_BUCKETS={BUCKETS}, K={cfg.GRID_SLOT_GRAPHS}, "
        f"GRID_BATCH {cfg.GRID_BATCH} ({time.perf_counter() - t:.1f} s on the host): " + ", ".join(
            f"{shape}: {sum(int(b.graph_mask.sum()) for b in bs)} buildings in "
            f"{sum(int((b.graph_mask.sum(1) > 0).sum()) for b in bs)} slots, {len(bs)} batches"
            for shape, bs in by_shape.items()))
    if sum(int(b.graph_mask.sum()) for b in batches) != len(samples) or not all(by_shape.values()):
        raise AssertionError(f"the bucket loader gave shapes {[b.grid_shape for b in batches]}")
    for shape, bs in by_shape.items():
        b = bs[0]
        tag = f"bucket {shape} ({b.mask.shape[0]} slots, fill {100 * float(b.mask.sum()) / b.mask.numel():.1f}%)"
        batch = b.to(dev)
        bucket_kernels(tag, batch, dev, card)
        counted_steps(cfg.replace(COMPUTE_DTYPE="bfloat16"), batch, dev, 1, f"bucket {shape} (bfloat16)",
                      card, FUSED_STEP)
        del batch
        torch.cuda.empty_cache()
    flags = grid_flags + ["--grid-buckets", ",".join("x".join(map(str, s)) for s in BUCKETS)]
    run = os.path.join(root, "run_buckets")
    out, s_train = run_cli(["train", "--epochs", "1", "--log-dir", run] + flags, "train --grid-buckets")
    epochs = epoch_lines(out)
    say(f"cli --grid-buckets: train --epochs 1 {s_train:.1f} s (process included): "
        + ", ".join(f"{k} {v:.4f}" for k, v in epochs.get(1, {}).items()) + f" on {card}")
    if sorted(epochs) != [1] or not all(np.isfinite(v) for v in epochs[1].values()):
        raise AssertionError(f"CLI train --grid-buckets: epochs {epochs}")
    out, s_test = run_cli(["test", "--log-dir", run] + viz_flags(0, "cli --grid-buckets") + flags,
                          "test --grid-buckets")
    got = {k: float(v) for k, v in re.findall(r"(\w+_test): (\S+)", out)}
    say(f"cli --grid-buckets: test {s_test:.1f} s: " + ", ".join(f"{k} {v:.4f}" for k, v in got.items()))
    if set(got) != set(TEST_METRICS) or not all(np.isfinite(v) for v in got.values()):
        raise AssertionError(f"CLI test --grid-buckets printed {got}")


def router_phase(dev, card):
    """(e) RoutingServer: GATCONV servers of grids (8, 8, 8) and (11, 12, 12) at the JAX
    defaults, 32 requests of mixed sizes from 8 threads: each lands on the smallest grid that
    holds it, one more by name; the big model's weights swapped mid-stream (each client
    sends half its requests, the swap starts after 12 answers with the rest of that half in
    flight, and the clients send their second half once it returns: no request dropped,
    the second half served by the new version); alone == batched; one hourglass launch a
    batch on each server; p50 / p99 a server; stop() joins them all.  Returns the server and
    client threads."""
    from building_gan_torch.config import Configuration
    from building_gan_torch.models.grid_models import GridVoxelGNNGenerator
    from building_gan_torch.ops import hourglass as hg
    from building_gan_torch.serving import RoutingServer

    samples = list(train_samples())
    fits = {i: bool((s[1].location.max(axis=0) + 1 <= ROUTER_GRIDS["small"]).all())
            for i, s in enumerate(samples)}
    small_ids = [i for i in fits if fits[i]][:ROUTER_REQUESTS // 2]
    big_ids = [i for i in fits if not fits[i]][:ROUTER_REQUESTS // 2]
    order = [i for pair in zip(small_ids, big_ids) for i in pair]
    if len(order) != ROUTER_REQUESTS:
        raise AssertionError(f"{len(small_ids)} buildings fit {ROUTER_GRIDS['small']} and "
                             f"{len(big_ids)} do not: too few for {ROUTER_REQUESTS} requests")
    cfg = Configuration()
    torch.manual_seed(7)
    w0 = GridVoxelGNNGenerator(cfg).state_dict()
    torch.manual_seed(8)
    w1 = GridVoxelGNNGenerator(cfg).state_dict()
    router = RoutingServer()
    hg.launches.reset()
    kw = dict(max_batch=MAX_BATCH, max_delay_ms=5.0, device=dev)
    servers = {"big": router.add_model("big", cfg, w0, **kw),
               "small": router.add_model("small", cfg.replace(GRID_SHAPE=ROUTER_GRIDS["small"]), w0, **kw)}
    threads = [s._thread for s in servers.values()]
    try:
        for name in servers:  # warm-up
            router.infer(*samples[small_ids[0]], model=name, seed=0, timeout_s=REQUEST_TIMEOUT_S)
        for s in servers.values():
            s.batch_sizes.clear()
        for i in order:
            want = servers["small" if fits[i] else "big"]
            if router.route(samples[i][1]) is not want:
                raise AssertionError(f"request {i} routed to the wrong grid")
        results, latency, sent, errors = {}, {}, {}, []
        lock, swapped = threading.Lock(), threading.Event()

        def client(idx):
            try:
                for n, i in enumerate(idx):
                    if n == len(idx) // 2 and not swapped.wait(timeout=REQUEST_TIMEOUT_S):
                        raise TimeoutError("the weight swap did not return")
                    t = time.perf_counter()
                    with lock:
                        sent[i] = t
                    r = router.infer(*samples[i], seed=i, timeout_s=REQUEST_TIMEOUT_S)
                    with lock:
                        latency[i] = time.perf_counter() - t
                        results[i] = r
            except Exception as e:  # noqa: BLE001 - re-raised by the main thread
                with lock:
                    errors.append(e)

        clients = [threading.Thread(target=client, args=(order[c::ROUTER_CLIENTS],))
                   for c in range(ROUTER_CLIENTS)]
        threads += clients
        for th in clients:
            th.start()
        deadline = time.perf_counter() + REQUEST_TIMEOUT_S
        while len(results) < ROUTER_SWAP_AFTER and not errors and time.perf_counter() < deadline:
            time.sleep(0.001)
        with lock:
            in_flight = len(sent) - len(results)
        t0 = time.perf_counter()
        version = router.swap_params("big", w1)
        t_swap = time.perf_counter()
        swap_ms = (t_swap - t0) * 1e3
        swapped.set()
        for th in clients:
            th.join(timeout=REQUEST_TIMEOUT_S * 2)
        if any(th.is_alive() for th in clients):
            raise TimeoutError("a router client thread did not finish")
        if errors:
            raise errors[0]
        if len(results) != ROUTER_REQUESTS:
            raise AssertionError(f"{len(results)} of {ROUTER_REQUESTS} requests answered")
        for i, r in results.items():
            n = samples[i][1].x.shape[0]
            if r["logits"].shape != (n, 7) or not np.isfinite(r["logits"]).all():
                raise AssertionError(f"request {i}: bad output")
        served = {k: sum(s.batch_sizes) for k, s in servers.items()}
        routed = {"small": sum(fits[i] for i in order), "big": sum(not fits[i] for i in order)}
        after = [i for i in order if not fits[i] and sent[i] > t_swap]
        stale = [i for i in after if results[i]["params_version"] != version]
        say(f"router: {ROUTER_REQUESTS} requests from {ROUTER_CLIENTS} threads, routed {routed}, served "
            f"{served}; swap to version {version} after {ROUTER_SWAP_AFTER} answers with {in_flight} "
            f"requests in flight, {swap_ms:.1f} ms; {len(after)} big requests sent after it, "
            f"{len(stale)} of them served by the old weights; versions served "
            f"{sorted(set(r['params_version'] for r in results.values()))}")
        if served != routed or stale or not after or version != 1:
            raise AssertionError("the router misrouted, dropped or served stale weights")
        named = router.infer(*samples[small_ids[0]], model="big", seed=5, timeout_s=REQUEST_TIMEOUT_S)
        if sum(servers["big"].batch_sizes) != routed["big"] + 1 or named["params_version"] != version:
            raise AssertionError("the named route did not reach the big model")
        alone_diff = 0.0
        for i in (small_ids[0], after[-1]):
            alone = router.infer(*samples[i], seed=i, timeout_s=REQUEST_TIMEOUT_S)
            if not np.array_equal(alone["types"], results[i]["types"]):
                raise AssertionError(f"request {i}: types served alone differ from batched")
            alone_diff = max(alone_diff, float(np.abs(alone["logits"] - results[i]["logits"]).max()))
        batches = sum(len(s.batch_sizes) for s in servers.values()) + len(servers)  # + warm-ups
        launches = hg.launches.value
        for name, s in servers.items():
            lat = np.array([latency[i] for i in order if fits[i] == (name == "small")]) * 1e3
            say(f"router ({name}, grid {s.configuration.GRID_SHAPE}): {len(s.batch_sizes)} batches "
                f"{list(s.batch_sizes)}, latency p50 {np.percentile(lat, 50):.1f} ms p99 "
                f"{np.percentile(lat, 99):.1f} ms on {card}")
        say(f"router: alone == batched types, logits max diff {alone_diff:.1e}; hourglass launches "
            f"{launches} for {batches} batches; models {router.models()}")
        if launches != batches or min(len(s.batch_sizes) for s in servers.values()) < 1:
            raise AssertionError("a router server did not launch the hourglass once a batch")
    finally:
        router.stop()
    if any(th.is_alive() for th in threads):
        raise AssertionError("a router server or client thread is still running")
    return threads


def modes_phase(cfg_t, batch_t, grid_flags, root, dev, card):
    """Phase 11: modes, transformer, buckets and router; -> the threads it started (stopped)."""
    t_phase = time.perf_counter()
    t = time.perf_counter()
    mode_steps(cfg_t, batch_t, dev, card)
    say(f"phase 11a-b: BCE and batch-level steps {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    transformer_steps(cfg_t, batch_t, dev, card)
    say(f"phase 11c: transformer {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    bucket_phase(cfg_t, grid_flags, root, dev, card)
    say(f"phase 11d: buckets {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    threads = router_phase(dev, card)
    say(f"phase 11e: router {time.perf_counter() - t:.1f} s")
    say(f"phase: modes, transformer, buckets and router {time.perf_counter() - t_phase:.1f} s")
    return threads


# Phase 12: the reference's other surfaces: the sanity harness and the kernels on one slot,
# best-of-k renders on the card, analyze and ingest, and the bf16 step's roofline share.
SANITY_EPOCHS, RENDER_RESTARTS, INGEST_BUILDINGS = 20, 3, 4


def have_renderer() -> bool:
    """Whether matplotlib and Pillow import here (the renders need both)."""
    try:
        import matplotlib  # noqa: F401
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


def viz_flags(n: int, label: str):
    """``test``'s --num-samples-to-viz: n where matplotlib and Pillow import, else 0; says which."""
    m = n if have_renderer() else 0
    say(f"{label}: test --num-samples-to-viz {m}"
        + ("" if m == n else " (matplotlib or Pillow does not import here)"))
    return ["--num-samples-to-viz", str(m)]


def cli_in_process(args):
    """``building_gan_torch.cli.main(args)`` in this process, its standard output captured;
    -> (output, seconds).  The output is printed again if it raises."""
    import contextlib
    import io

    from building_gan_torch.cli import main as cli

    buf = io.StringIO()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            cli.main(args)
    except BaseException:
        say(buf.getvalue()[-3000:])
        raise
    return buf.getvalue(), time.perf_counter() - t


def sanity_cli(npz, local_nodes, root, dev, card):
    """(a) ``sanity --epochs 20`` through the CLI in this process (its kernel launches counted)
    on phase 9's processed buildings at the config of record and f32: building DATA_POINT in
    one slot (GRID_BATCH 1, K=1), one step an epoch, each with the fused step's launches;
    losses finite; no checkpoint; the reference tags logged; the best epoch's image recorded,
    or "render skipped" printed where matplotlib or Pillow is missing (no hourglass launch
    then)."""
    import os

    from building_gan_torch.checkpoint import ckpt
    from building_gan_torch.train.writer import JSONL_FILE, read_jsonl

    run = os.path.join(root, "run_sanity")
    before = layer_launches()
    out, seconds = cli_in_process(
        ["sanity", "--save-data-path", npz, "--log-dir", run, "--device", dev.type,
         "--compute-dtype", "float32", "--epochs", str(SANITY_EPOCHS), "--grid-local-nodes",
         str(local_nodes)])
    got = tuple(b - a for a, b in zip(before, layer_launches()))
    epochs = epoch_lines(out)
    renders = out.count("Best f1 score updated")
    skipped = [ln for ln in out.splitlines() if ln.startswith("render skipped")]
    # a render draws one train sample and (no validation split in sanity mode) one more
    want = (0 if skipped else 2 * renders,) + tuple(SANITY_EPOCHS * v for v in FUSED_STEP[1:])
    times = [float(x) for x in re.findall(r"function _train_each_epoch took ([\d.e-]+) seconds", out)]
    last = epochs.get(SANITY_EPOCHS, {})
    say(f"sanity: CLI sanity --epochs {SANITY_EPOCHS} {seconds:.1f} s in process: epoch 1 "
        f"f1 {epochs.get(1, {}).get('f1_train', float('nan')):.4f}, epoch {SANITY_EPOCHS} f1 "
        f"{last.get('f1_train', float('nan')):.4f} g_loss {last.get('g_loss', float('nan')):.4f} "
        f"d_loss {last.get('d_loss', float('nan')):.4f}; {renders} best-epoch renders "
        f"({len(skipped)} skipped{': ' + skipped[0][:120] if skipped else ''}); launches "
        f"hourglass {got[0]}, training forward {got[1]}, backward {got[2]}, dropout bytes "
        f"{got[3]} (expect {want}); train epoch s (median of 2-{SANITY_EPOCHS}) "
        f"{float(np.median(times[1:])):.3f} on {card}")
    if sorted(epochs) != list(range(1, SANITY_EPOCHS + 1)):
        raise AssertionError(f"sanity ran epochs {sorted(epochs)}")
    if not all(np.isfinite(v) for vals in epochs.values() for v in vals.values()):
        raise AssertionError("a loss or score of the sanity run is not finite")
    if got != want:
        raise AssertionError(f"sanity: launches {got}, expected {want}")
    if ckpt.exists(run) or os.path.exists(os.path.join(run, ckpt.LATEST_STATE_FILE)):
        raise AssertionError("sanity mode wrote a checkpoint")
    if os.path.exists(os.path.join(run, JSONL_FILE)):
        records = read_jsonl(run)
        tags = {(r["tag"], r["step"]) for r in records if r["kind"] == "scalar"}
        missing = [t for t in REFERENCE_TAGS if (t, SANITY_EPOCHS) not in tags]
        images = [r for r in records if r["kind"] == "image"]
        shapes = [tuple(np.load(os.path.join(run, r["file"])).shape) for r in images]
    else:  # tensorboardX's event file
        blob = b"".join(open(os.path.join(run, f), "rb").read() for f in os.listdir(run)
                        if f.startswith("events.out.tfevents"))
        missing = [t for t in REFERENCE_TAGS if t.encode() not in blob]
        shapes = [None] * sum(f"epoch_{e}".encode() in blob for e in epochs)
    say(f"sanity: no checkpoint written; the reference tags logged; {len(shapes)} images "
        f"recorded {shapes[:3]}")
    if missing:
        raise AssertionError(f"the sanity log lacks {missing[:5]}")
    if len(shapes) != (0 if skipped else renders) or not (renders or skipped):
        raise AssertionError(f"sanity: {len(shapes)} images for {renders} best epochs")


def write_reference_pairs(dst, samples):
    """Pickle each (local, voxel) as the reference pipeline does (data.py:457-461): stand-in
    classes LocalGraphData / VoxelGraphData under ``src.data`` holding torch tensors under the
    reference's attribute names (data.py:16-77).  The stand-ins are gone again when this
    returns, so unpickling must resolve them without the reference package."""
    import os
    import types

    names = ("src", "src.data")
    saved = {k: sys.modules.pop(k) for k in names if k in sys.modules}
    try:
        mod = types.ModuleType("src.data")
        sys.modules["src"], sys.modules["src.data"] = types.ModuleType("src"), mod
        for name in ("LocalGraphData", "VoxelGraphData"):
            cls = type(name, (), {})
            cls.__module__, cls.__qualname__ = "src.data", name
            setattr(mod, name, cls)
        t = torch.as_tensor
        for local, voxel in samples:
            ref_l, ref_v = mod.LocalGraphData(), mod.VoxelGraphData()
            ref_l.__dict__.update(
                x=t(local.x), local_graph_types=t(local.types).long(),
                local_graph_types_onehot=t(local.types_onehot),
                local_graph_type_ratio_per_node=t(local.type_ratio_per_node),
                edge_index=t(local.edge_index).long(), local_graph_floor_levels=t(local.floor_levels).long(),
                local_graph_center=t(local.center), local_graph_type_ids=t(local.type_ids).long(),
                site_area=t([local.site_area]), data_number=local.data_number)
            ref_v.__dict__.update(
                x=t(voxel.x), voxel_graph_types=t(voxel.types).long(),
                voxel_graph_types_onehot=t(voxel.types_onehot), edge_index=t(voxel.edge_index).long(),
                voxel_graph_floor_levels=t(voxel.floor_levels).long(),
                voxel_graph_node_coordinate=t(voxel.coordinate),
                voxel_graph_node_dimension=t(voxel.dimension), voxel_graph_location=t(voxel.location).long(),
                voxel_graph_node_ratio=t(voxel.node_ratio), site_area=t([voxel.site_area]),
                data_number=voxel.data_number)
            torch.save(ref_l, os.path.join(dst, f"{local.data_number}_local.pt"))
            torch.save(ref_v, os.path.join(dst, f"{local.data_number}_voxel.pt"))
    finally:
        for k in names:
            sys.modules.pop(k, None)
        sys.modules.update(saved)


def analyze_and_ingest(raw, npz, root, card):
    """(d) ``analyze`` on phase 9's raw JSON (the FAR invariant holds); ``ingest`` of the
    first INGEST_BUILDINGS processed buildings written as the reference's ``.pt`` pairs gives
    back their NPZ arrays bit for bit."""
    import os

    from building_gan_torch.config import Configuration
    from building_gan_torch.data.preprocess import load_local, load_voxel

    out, s_an = cli_in_process(["analyze", "--data-path", raw])
    lines = out.strip().splitlines()
    say(f"analyze: {s_an:.2f} s: " + "; ".join(ln.strip() for ln in lines[:3] + lines[-1:]))
    if "FAR invariant       : OK" not in out:
        raise AssertionError("analyze did not report the FAR invariant")
    cfg = Configuration()
    nums = sorted(f[: -len(cfg.LOCAL_DATA_SUFFIX)] for f in os.listdir(npz)
                  if f.endswith(cfg.LOCAL_DATA_SUFFIX))[:INGEST_BUILDINGS]
    files = [f"{n}{sfx}" for n in nums for sfx in (cfg.LOCAL_DATA_SUFFIX, cfg.VOXEL_DATA_SUFFIX)]
    src, dst = os.path.join(root, "reference_pt"), os.path.join(root, "ingested")
    os.makedirs(src)
    write_reference_pairs(src, [(load_local(os.path.join(npz, f"{n}{cfg.LOCAL_DATA_SUFFIX}")),
                                 load_voxel(os.path.join(npz, f"{n}{cfg.VOXEL_DATA_SUFFIX}")))
                                for n in nums])
    out, s_in = cli_in_process(["ingest", "--src", src, "--dst", dst])
    differ = []
    for f in files:
        with np.load(os.path.join(npz, f)) as a, np.load(os.path.join(dst, f)) as b:
            if sorted(a.files) != sorted(b.files):
                differ.append((f, "keys"))
            differ += [(f, k) for k in a.files
                       if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k])]
    say(f"ingest: {s_in:.2f} s: {out.strip()}; {len(files)} NPZ files against phase 9's: "
        f"{'bit-equal' if not differ else differ[:4]}")
    if differ or sorted(os.listdir(dst)) != sorted(files):
        raise AssertionError(f"ingest did not give back phase 9's arrays: {differ[:4]}")


def render_phase(npz, local_nodes, run, dev, card):
    """(c) ``best_of_k`` with RENDER_RESTARTS restarts on a Trainer built on phase 9's f32 log
    dir: one hourglass launch a restart, the F1 kept the largest of the restarts' own, the
    types those of the first restart reaching it; its device time; then, where matplotlib
    and Pillow import, evaluate_qualitatively's strip of one test building (CHW uint8)."""
    from building_gan_torch.config import Configuration
    from building_gan_torch.data.pipeline import GraphDataLoaders
    from building_gan_torch.models.grid_models import GridVoxelGNNDiscriminator, GridVoxelGNNGenerator
    from building_gan_torch.ops import hourglass as hg
    from building_gan_torch.train import metrics as M
    from building_gan_torch.train.trainer import Trainer
    from building_gan_torch.viz import render

    cfg = Configuration(SAVE_DATA_PATH=npz, COMPUTE_DTYPE="float32", EPOCHS=3,
                        GRID_SLOT_GRAPHS=TRAINER_SLOT_GRAPHS, GRID_LOCAL_NODES=local_nodes,
                        GRID_BATCH=TRAINER_BATCH_IN_PROCESS)
    torch.manual_seed(cfg.SEED)
    trainer = Trainer(GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg),
                      GraphDataLoaders(cfg), cfg, log_dir=run, device=dev)
    local, voxel = trainer.dataloaders.validation_dataloader.samples[0]
    outputs, generate = [], trainer.generate

    def recorded(batch, generator):
        out = generate(batch, generator)
        outputs.append(out[1].argmax(-1)[0].clone())
        return out

    trainer.generate = recorded
    h0 = hg.launches.value
    torch.cuda.synchronize()
    t = time.perf_counter()
    types, f1 = render.best_of_k(trainer, local, voxel, iteration=RENDER_RESTARTS)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    launches = hg.launches.value - h0
    trainer.generate = generate
    loc = torch.as_tensor(voxel.location, device=dev).long()
    y_true = torch.as_tensor(voxel.types, device=dev).long()
    n = y_true.shape[0]
    preds = [o[loc[:, 0], loc[:, 1], loc[:, 2]] for o in outputs]
    f1s = [float(M.compute_metrics(y_true, p, torch.ones(n, device=dev), torch.ones(1, device=dev),
                                   graph_id=torch.zeros(n, dtype=torch.long, device=dev))["f1"])
           for p in preds]
    first_best = f1s.index(max(f1s))
    say(f"best_of_k: building {voxel.data_number} ({n} voxels), {RENDER_RESTARTS} restarts on "
        f"phase 9's f32 weights: F1s {', '.join(f'{v:.4f}' for v in f1s)}, kept {f1:.4f}; "
        f"hourglass launches {launches} (expect {RENDER_RESTARTS}); {ms:.2f} ms (host clock, "
        f"synchronised; packing and the F1 syncs included) on {card}")
    if launches != RENDER_RESTARTS or len(outputs) != RENDER_RESTARTS:
        raise AssertionError(f"best_of_k launched the hourglass {launches} times")
    if f1 != max(f1s) or not np.array_equal(types, preds[first_best].cpu().numpy()):
        raise AssertionError(f"best_of_k kept F1 {f1}, not the restarts' best {max(f1s)}")
    if not have_renderer():
        say("render: matplotlib or Pillow does not import here: no figure drawn (the device "
            "part above is checked either way)")
        return
    t = time.perf_counter()
    strip = render.evaluate_qualitatively(trainer, epoch=None, num_samples_to_viz=1,
                                          to_tensor=True, use_test_dataset=True)
    say(f"render: evaluate_qualitatively, one test building: a {strip.shape} {strip.dtype} strip "
        f"in {time.perf_counter() - t:.1f} s (host drawing included)")
    if strip.dtype != np.uint8 or strip.ndim != 3 or strip.shape[0] != 3:
        raise AssertionError(f"evaluate_qualitatively returned {strip.shape} {strip.dtype}")


def one_slot(npz, local_nodes, dev, card):
    """(b) the sanity building (DATA_POINT of phase 9's set) in one slot, K=1: the kernels by
    ``bucket_kernels`` (hourglass f32 and bf16, both training stacks layer by layer, timed
    against their bounds), then 3 f32 train steps with the fused step's launches; -> step ms."""
    from building_gan_torch.config import Configuration
    from building_gan_torch.data import pack_grid
    from building_gan_torch.data.pipeline import GraphDataset

    cfg = Configuration(sanity_checking=True, SAVE_DATA_PATH=npz, COMPUTE_DTYPE="float32",
                        GRID_LOCAL_NODES=local_nodes)
    [sample] = GraphDataset(cfg).samples
    batch = pack_grid([sample], cfg, batch_slots=1).to(dev)
    tag = (f"one slot (building {sample[1].data_number}, {sample[1].x.shape[0]} voxels, "
           f"DATA_POINT {cfg.DATA_POINT})")
    bucket_kernels(tag, batch, dev, card)
    return counted_steps(cfg, batch, dev, 3, "one-slot step (float32)", card, FUSED_STEP)[1]


def roofline_line(cfg_tb, batch_t, bf16_ms, card):
    """(e) the bf16 train step's roofline share at phase 7's batch: the work model's floor
    (utils/roofline.py, the H100's published peaks) over the median bf16 step of phase 7's
    turns."""
    from building_gan_torch.utils.roofline import attainable

    B, R = batch_t.mask.shape[0], int(np.prod(batch_t.grid_shape))
    n_real = int(batch_t.mask.sum().item())
    a = attainable(cfg_tb, B * R, n_real)
    med = float(np.median(bf16_ms))
    say(f"roofline: bf16 step at phase 7's batch ({B} slots x {R} cells, {n_real} real nodes): "
        f"floor {a['floor_ms']} ms ({a['binding_resource']}; realistic {a['floor_realistic_ms']} "
        f"ms, {a['binding_resource_realistic']}) over the median step {med:.1f} ms = "
        f"{100 * a['floor_ms'] / med:.2f}% ({100 * a['floor_realistic_ms'] / med:.2f}% realistic); "
        f"attainable {a['attainable_nodes_per_sec']:.0f} nodes/s against "
        f"{n_real / (med / 1e3):.0f}; bars mxu {a['t_mxu_ms']} / vpu {a['t_vpu_ms']} / trans "
        f"{a['t_trans_ms']} / hbm {a['t_hbm_ms']} ms at the published H100 peaks on {card}")


def surfaces_phase(cfg_tb, batch_t, bf16_ms, grid_flags, root, dev, card):
    """Phase 12: the reference's other surfaces on phase 9's buildings (``root``)."""
    import os

    t_phase = time.perf_counter()
    npz, raw = os.path.join(root, "npz"), os.path.join(root, "raw")
    local_nodes = int(grid_flags[grid_flags.index("--grid-local-nodes") + 1])
    t = time.perf_counter()
    sanity_cli(npz, local_nodes, root, dev, card)
    say(f"phase 12a: sanity {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    ms = one_slot(npz, local_nodes, dev, card)
    say(f"phase 12b: one slot {time.perf_counter() - t:.1f} s; one-slot f32 steps "
        f"{' '.join(f'{v:.1f}' for v in ms)} ms")
    t = time.perf_counter()
    render_phase(npz, local_nodes, os.path.join(root, "run"), dev, card)
    say(f"phase 12c: best_of_k {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    analyze_and_ingest(raw, npz, root, card)
    say(f"phase 12d: analyze and ingest {time.perf_counter() - t:.1f} s")
    roofline_line(cfg_tb, batch_t, bf16_ms, card)
    say(f"phase: other surfaces {time.perf_counter() - t_phase:.1f} s")


# Phase 13: data parallelism (parallel/mesh.py, parallel/dp.py) at the config of record, f32
# then bf16: two ranks sharing the card through a gloo group (threads of this process), NCCL
# at one rank, and on a host of 2 to 4 cards NCCL at one rank a card (spawned processes).
DP_SLOTS, DP_STEPS, DP_MAX_CARDS = 54, 3, 4  # GRID_BATCH a rank: the 107 slots in 2 packs
DP_KEYS = ("g_loss", "d_loss", "g_loss_adv", "g_loss_ratio", "g_loss_ratio_void", "g_loss_far",
           "g_loss_label", "f1", "f1_min", "precision", "recall", "accuracy")
DP_UNEVEN_KEYS = ("g_loss", "d_loss", "f1", "f1_min", "precision", "recall", "accuracy")
DP_RTOL, DP_ATOL, DP_PARAM_ATOL = 1e-4, 1e-5, 1e-6  # tests/test_parallel.py's


def dev_sync(dev) -> None:
    """Wait for ``dev``'s work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dp_packs(cfg_t):
    """(cfg at GRID_BATCH DP_SLOTS, the train batch's slots as two packs of DP_SLOTS slots on
    the CPU: the first 54, then the other 53 and an empty slot)."""
    from building_gan_torch.data import pack_grid_multi_from_slots

    cfg = cfg_t.replace(GRID_BATCH=DP_SLOTS)
    slots, samples = train_slots(), list(train_samples()[:TRAIN_BATCH_BUILDINGS])
    packs = [pack_grid_multi_from_slots(samples, slots[i:i + DP_SLOTS], cfg, batch_slots=DP_SLOTS)
             for i in range(0, len(slots), DP_SLOTS)]
    if len(packs) != 2:
        raise AssertionError(f"{len(slots)} slots made {len(packs)} packs of {DP_SLOTS}, expected 2")
    return cfg, packs


DP_INIT_LOCK = threading.Lock()  # ranks as threads share torch's default generator


def dp_state(cfg, dev):
    """Fresh models from torch.manual_seed(cfg.SEED) on ``dev``: the same weights in every rank."""
    from building_gan_torch.models.grid_models import GridVoxelGNNDiscriminator, GridVoxelGNNGenerator
    from building_gan_torch.train.state import create_train_state

    with DP_INIT_LOCK:
        torch.manual_seed(cfg.SEED)
        return create_train_state(cfg, GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg),
                                  device=dev)


def dp_params(state, device=None):
    return {f"{m}.{k}": p.detach().to(device or p.device, copy=True)
            for m in ("generator", "discriminator") for k, p in getattr(state, m).named_parameters()}


def launches_here():
    """(hourglass, training forward, backward, dropout-byte) launches of the calling thread."""
    from building_gan_torch.ops import gat_train as gt
    from building_gan_torch.ops import hourglass as hg

    return tuple(c.in_this_thread for c in (hg.launches, gt.fwd_launches, gt.bwd_launches,
                                            gt.bytes_launches))


def dp_rank_run(cfg, pack, dev, group, steps):
    """``steps`` parallel steps of fresh models on this rank's ``pack``, every rank drawing from
    a generator seeded 0 (fold_device_rng=False); -> step 1's metrics and parameters, the
    last step's parameters, each step's launches and ms (host clock, synchronised), the
    pack's real cells and the state."""
    from building_gan_torch.parallel import dp

    state = dp_state(cfg, dev)
    step = dp.make_parallel_train_step(cfg, state, group, fold_device_rng=False)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"launches": [], "ms": [], "cells": int(pack.cell_mask.sum().item())}
    for i in range(steps):
        before = launches_here()
        dev_sync(dev)
        t = time.perf_counter()
        m = step(pack, gen)
        dev_sync(dev)
        out["ms"].append((time.perf_counter() - t) * 1e3)
        out["launches"].append(tuple(b - a for a, b in zip(before, launches_here())))
        if not all(torch.isfinite(v).all().item() for v in m.values()):
            raise AssertionError(f"a parallel step's metrics are not finite: {m}")
        if i == 0:
            out["metrics"] = {k: m[k].item() for k in DP_KEYS}
            out["cm"] = m["confusion_matrix"].cpu()
            out["params"] = dp_params(state)
    out["final"] = dp_params(state)
    out["state"] = state
    return out


def dp_one_device(cfg, pack, dev):
    """The one-device step on ``pack`` from the same weights and draws: (metrics, parameters)."""
    from building_gan_torch.train.step import make_train_step

    state = dp_state(cfg, dev)
    m = make_train_step(cfg, state)(pack, torch.Generator(device=dev).manual_seed(0))
    return {k: m[k].item() for k in DP_KEYS}, dp_params(state), m["confusion_matrix"].cpu()


def dp_repeats(cfg, pack, dev) -> bool:
    """Whether the one-device step, run twice from the same weights and draws, repeats bit
    for bit: the DP checks' tight parameter tolerance needs it (Adam turns the sign of a
    gradient's rounding noise into a +-lr step; scripts/torch_step_determinism.py)."""
    a, b = (dp_one_device(cfg, pack, dev)[1] for _ in range(2))
    return all(torch.equal(v, b[k]) for k, v in a.items())


def dp_oracle(cfg, packs, dev):
    """One step over ``packs`` in sequence: each of the N_CRITIC + 1 updates' gradients and
    losses the packs' real-cell-weighted mean, each pack drawing from the generator's
    state at the update's start (the step's own losses, ``make_update_losses``);
    -> (metrics, parameters, confusion matrix)."""
    from building_gan_torch.ops.gat_train import build_planes
    from building_gan_torch.train import metrics as TM
    from building_gan_torch.train.step import make_update_losses, needs_planes

    state = dp_state(cfg, dev)
    critic_loss, generator_loss = make_update_losses(cfg, state)
    gen = torch.Generator(device=dev).manual_seed(0)
    w = [float(p.cell_mask.sum().item()) for p in packs]
    planes = [build_planes(p.cell_mask, p.gid, p.grid_shape) if needs_planes(state) else None
              for p in packs]

    def update(loss_fn, module, opt):
        leaves = list(module.parameters())
        start, grads, outs = gen.get_state(), [], []
        for pack, pl in zip(packs, planes):
            gen.set_state(start)
            for p in leaves:
                p.grad = None
            with torch.autograd.set_multithreading_enabled(False):  # as the step
                out = loss_fn(pack, pl, gen)
                (out[0] if isinstance(out, tuple) else out).backward(inputs=leaves)
            grads.append([p.grad.clone() for p in leaves])
            outs.append(out)
        for i, p in enumerate(leaves):  # in f64, as the step's all-reduce
            p.grad = (sum(wp * g[i].double() for wp, g in zip(w, grads)) / sum(w)).float()
        opt.step()
        return outs

    d_losses = []
    for _ in range(cfg.N_CRITIC):
        losses = [o.item() for o in update(critic_loss, state.discriminator, state.opt_d)]
        d_losses.append(sum(wp * v for wp, v in zip(w, losses)) / sum(w))
    outs = update(generator_loss, state.generator, state.opt_g)
    ms = [TM.compute_metrics(p.cell_type, o[2].detach().argmax(-1), p.cell_mask, p.graph_mask,
                             **p.metric_graphs) for p, o in zip(packs, outs)]
    cm = sum(m["confusion_matrix"] for m in ms)
    metrics = {"d_loss": float(np.mean(d_losses)),
               "g_loss": sum(wp * o[0].item() for wp, o in zip(w, outs)) / sum(w),
               **{k: v.item() for k, v in TM.scores_from_cm(cm).items()},
               "f1_min": min(m["f1_min"].item() for m in ms)}
    return metrics, dp_params(state), cm.cpu()


def dp_close(label, got, want, keys, copies=1):
    """A rank's step 1 against the one-device step or the oracle: metrics within rtol 1e-4 /
    atol 1e-5, parameters within rtol 1e-4 / atol 1e-6, the confusion matrix ``copies``
    times the reference's (the same pack on that many ranks)."""
    (gm, gp, gcm), (wm, wp, wcm) = got, want
    m_ratio = max(abs(gm[k] - wm[k]) / (DP_ATOL + DP_RTOL * abs(wm[k])) for k in keys)
    p_ratio = max(((gp[k].to(v.device) - v).abs() / (DP_PARAM_ATOL + DP_RTOL * v.abs())).max().item()
                  for k, v in wp.items())
    p_abs = max((gp[k].to(v.device) - v).abs().max().item() for k, v in wp.items())
    same_cm = torch.equal(gcm.cpu(), copies * wcm.cpu())
    ok = m_ratio <= 1.0 and p_ratio <= 1.0 and same_cm
    say(f"{label}: metrics at {m_ratio:.3g} of their tolerance, parameters at {p_ratio:.3g} (max "
        f"abs diff {p_abs:.3e}), confusion matrix equal: {same_cm} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the parallel step disagrees with its reference")


def dp_null_finite(cfg, pack, dev, tag):
    """A null pack's losses and gradients through the fused kernels: finite."""
    from building_gan_torch.data.pipeline import null_like
    from building_gan_torch.ops.gat_train import build_planes
    from building_gan_torch.train.step import make_update_losses

    state = dp_state(cfg, dev)
    critic_loss, generator_loss = make_update_losses(cfg, state)
    null, gen = null_like(pack), torch.Generator(device=dev).manual_seed(0)
    planes = build_planes(null.cell_mask, null.gid, null.grid_shape)
    before = launches_here()
    with torch.autograd.set_multithreading_enabled(False):  # the backward counted here, as the step
        d_loss = critic_loss(null, planes, gen)
        d_loss.backward()
        g_loss, aux, _ = generator_loss(null, planes, gen)
        g_loss.backward(inputs=list(state.generator.parameters()))
    dev_sync(dev)
    got = tuple(b - a for a, b in zip(before, launches_here()))
    bad = [k for m in ("generator", "discriminator") for k, p in getattr(state, m).named_parameters()
           if p.grad is None or not torch.isfinite(p.grad).all().item()]
    finite = (torch.isfinite(d_loss).item() and torch.isfinite(g_loss).item()
              and all(torch.isfinite(v).item() for v in aux.values()))
    say(f"dp ({tag}): a null pack (0 real cells) through the kernels: d_loss {d_loss.item():.5f}, "
        f"g_loss {g_loss.item():.5f}, launches (hourglass, forward, backward, bytes) {got}; "
        f"losses finite {finite}, non-finite gradients {len(bad)}")
    if not finite or bad or (null.cell_mask.is_cuda and min(got[1:3]) < 1):
        raise AssertionError(f"dp ({tag}): a null pack's losses or gradients are not finite "
                             f"through the kernels ({bad[:3]})")


def dp_allreduce_ms(cfg, state, group, dev, reps=5):
    """(ms, bytes) of one step's gradient all-reduces alone: N_CRITIC of the critic's f64
    buffer and one of the generator's (gradients, losses and w), host clock around
    synchronised reps."""
    import torch.distributed as dist

    nd = sum(p.numel() for p in state.discriminator.parameters()) + 2
    ng = sum(p.numel() for p in state.generator.parameters()) + 8
    f64 = torch.float64
    bufs = ([torch.zeros(nd, device=dev, dtype=f64) for _ in range(cfg.N_CRITIC)]
            + [torch.zeros(ng, device=dev, dtype=f64)])
    for b in bufs:
        dist.all_reduce(b, group=group)
    dev_sync(dev)
    t = time.perf_counter()
    for _ in range(reps):
        for b in bufs:
            dist.all_reduce(b, group=group)
    dev_sync(dev)
    return (time.perf_counter() - t) * 1e3 / reps, 8 * (cfg.N_CRITIC * nd + ng)


def dp_check_runs(label, runs, want, ref_keys, launches_want, copies=1):
    """Every rank's step 1 against ``want``, and every step's launches."""
    for r, o in enumerate(runs):
        dp_close(f"{label} rank {r}", (o["metrics"], o["params"], o["cm"]), want, ref_keys, copies)
        if any(tuple(got) != tuple(launches_want) for got in o["launches"]):
            raise AssertionError(f"{label} rank {r}: launches {o['launches']} a step, expected "
                                 f"{launches_want}")


def dp_replicas_equal(label, runs):
    same = all(torch.equal(o["final"][k].cpu(), v.cpu()) for o in runs[1:]
               for k, v in runs[0]["final"].items())
    say(f"{label}: every rank's parameters equal bit for bit after {DP_STEPS} steps: {same}")
    if not same:
        raise AssertionError(f"{label}: the replicas drifted apart")


def dp_shared_card(cfg, packs, dev, card, tag):
    """Two ranks on one card, threads of this process over a gloo group (CUDA tensors):
    (a) the same pack on both, (b) a pack and a null pack, each against the one-device
    step; (c) the two uneven packs against the oracle, 3 steps, the replicas equal;
    launches a rank; a null pack through the kernels.  -> (reference, oracle)."""
    from building_gan_torch.data.pipeline import null_like
    from building_gan_torch.parallel import mesh

    p0, p1 = packs
    null = null_like(p0)
    want_launches = step_launches(cfg, dp_state(cfg, dev))
    ref = dp_one_device(cfg, p0, dev)
    say(f"dp ({tag}): the one-device step repeats bit for bit: {dp_repeats(cfg, p0, dev)}")
    oracle = dp_oracle(cfg, [p0, p1], dev)

    def run(mine, steps):
        return mesh.thread_ranks(2, lambda r, g: dp_rank_run(cfg, mine[r], dev, g, steps))

    ra, rb, rc = run([p0, p0], 1), run([p0, null], 1), run([p0, p1], DP_STEPS)
    label = f"dp ({tag}, 2 gloo ranks on one card)"
    dp_check_runs(f"{label} (a) the same pack on both", ra, ref, DP_KEYS, want_launches, 2)
    dp_check_runs(f"{label} (b) a pack and a null pack", rb, ref, DP_KEYS, want_launches)
    dp_check_runs(f"{label} (c) packs of {rc[0]['cells']} and {rc[1]['cells']} real cells against "
                  "the oracle", rc, oracle, DP_UNEVEN_KEYS, want_launches)
    dp_replicas_equal(label, rc)
    dp_null_finite(cfg, p0, dev, tag)
    ar = mesh.thread_ranks(2, lambda r, g: dp_allreduce_ms(cfg, rc[r]["state"], g, dev))
    step_ms = float(np.mean([np.mean(o["ms"][1:]) for o in rc]))
    cells = sum(o["cells"] for o in rc)
    say(f"{label}: launches a rank a step (hourglass, forward, backward, bytes) "
        f"{tuple(rc[0]['launches'][0])} (expect {tuple(want_launches)}); step {step_ms:.1f} ms "
        f"(steps 2-{DP_STEPS}, mean over ranks), {cells / (step_ms / 1e3):.1f} real voxel nodes/s "
        f"summed over ranks; all-reduce {max(a[0] for a in ar):.2f} ms a step ({ar[0][1] / 2**20:.2f} "
        f"MiB, gloo over CUDA tensors) on {card} (two ranks on one card: correctness, not scaling)")
    del ra, rb, rc
    return ref, oracle


def dp_nccl_one_rank(cfg, packs, ref, one_ms, dev, card, tag):
    """NCCL at one rank in this process: init, two steps (step 1 against the one-device
    step), the weighted all-reduce timed, the step's host syncs against the one-device step's."""
    import os

    from building_gan_torch.parallel import dp, mesh
    from building_gan_torch.train.step import make_train_step

    with tempfile.TemporaryDirectory(prefix="bgt_nccl_") as d:
        t = time.perf_counter()
        group = mesh.init_data_group(0, 1, os.path.join(d, "store"), "cuda")
        s_init = time.perf_counter() - t
        try:
            o = dp_rank_run(cfg, packs[0], dev, group, 2)
            dp_close(f"dp ({tag}, NCCL, 1 rank) against one device",
                     (o["metrics"], o["params"], o["cm"]), ref, DP_KEYS)
            ar_ms, nbytes = dp_allreduce_ms(cfg, o["state"], group, dev)
            gen = torch.Generator(device=dev).manual_seed(1)
            step_dp = dp.make_parallel_train_step(cfg, o["state"], group)
            step_1 = make_train_step(cfg, o["state"])
            _, syncs_dp, where = count_syncs(lambda: step_dp(packs[0], gen))
            _, syncs_1, _ = count_syncs(lambda: step_1(packs[0], gen))
        finally:
            mesh.destroy_data_group()
    say(f"dp ({tag}, NCCL, 1 rank): init {s_init:.2f} s, step {o['ms'][1]:.1f} ms (one device "
        f"{one_ms:.1f} ms), launches "
        f"{tuple(o['launches'][1])}; all-reduce {ar_ms:.3f} ms a step ({nbytes / 2**20:.2f} MiB); "
        f"host syncs a step {syncs_dp} (one device: {syncs_1}) {dict(where.most_common(3))} on {card}")
    if syncs_dp > syncs_1:
        raise AssertionError(f"the NCCL step syncs the host {syncs_dp} times, one device {syncs_1}")


def dp_card_rank(rank, n, store, cfgs, packs, out_dir, device_type):
    """One rank a card (a spawned process): for each dtype, (a), (b) and (c) as on one card
    with n ranks (null packs beyond the real ones), saved to out_dir/rank{rank}.pt."""
    import os

    from building_gan_torch.data.pipeline import null_like
    from building_gan_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = mesh.init_data_group(rank, n, store, device_type)
    dev = mesh.rank_device(rank, device_type)
    try:
        p0, p1 = (p.to(dev) for p in packs)
        null = null_like(p0)
        mine = {"a": p0, "b": p0 if rank == 0 else null, "c": (p0, p1, null)[min(rank, 2)]}
        res = {}
        for tag, cfg in cfgs.items():
            res[(tag, "repeats")] = dp_repeats(cfg, p0, dev)
            for name, steps in (("a", 2), ("b", 1), ("c", DP_STEPS)):
                o = dp_rank_run(cfg, mine[name], dev, group, steps)
                if name == "c":
                    o["allreduce"] = dp_allreduce_ms(cfg, o["state"], group, dev)
                del o["state"]
                o["params"] = {k: v.cpu() for k, v in o["params"].items()}
                o["final"] = {k: v.cpu() for k, v in o["final"].items()}
                res[(tag, name)] = o
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        mesh.destroy_data_group()


def dp_last_card(batch, n, card):
    """The three kernels on the last card while the current device stays card 0: each
    against its plain version by the f64 rules (the generator's training stack whole,
    forward and backward, at f32 on 8 slots; the hourglass), the Philox bytes bit for bit,
    and the stack's results equal bit for bit to the same call's on card 0."""
    from building_gan_torch.ops import dropout as drop
    from building_gan_torch.ops import gat_train as gt
    from building_gan_torch.ops import hourglass as hg

    last = torch.device("cuda", n - 1)
    if torch.cuda.current_device() != 0:
        raise AssertionError("the current device is not card 0")
    grid, K = batch.grid_shape, batch.graphs_per_slot
    gen = torch.Generator().manual_seed(21)
    (Ws, atts, vecs), chans = perturbed_stack(128, 7, gen, "cpu")
    keys = drop.draw_keys(len(chans), torch.Generator().manual_seed(22))
    B, R = 8, math.prod(grid)
    x = torch.randn(B, R, 128, generator=gen)
    gy = torch.randn(B, R, 128, generator=gen)
    before = (hg.launches.value, gt.fwd_launches.value, gt.bwd_launches.value, gt.bytes_launches.value)
    results = {}
    for dev in (torch.device("cuda", 0), last):
        mask, gid = batch.mask[:B].to(dev), batch.gid[:B].to(dev)
        planes = gt.build_planes(mask, gid, grid)
        leaves = [t.to(dev) for t in (x, Ws, atts, vecs)]
        fused, plain = stack_fns(planes, keys.to(dev), grid, K, chans)
        got = with_grads(fused, leaves, gy.to(dev))
        results[dev.index] = got
        if dev == last:
            if got[0].device != last or torch.cuda.current_device() != 0:
                raise AssertionError("the stack's output is not on the last card")
            want = with_grads(plain, leaves, gy.to(dev))
            want64 = with_grads(plain, [t.double() for t in leaves], gy.to(dev).double())
            label = f"dp last card (cuda:{last.index}) generator stack (8 slots, K={K})"
            hold(label, ("y",), got[:1], want[:1], want64[:1])
            hold(label, GRAD_NAMES, got[1], want[1], want64[1])
            xh = torch.randn(B, *grid, 128, generator=gen).to(dev)
            m5 = mask.reshape(B, *grid).contiguous()
            args = (xh, m5, Ws.to(dev), atts.to(dev), vecs.to(dev), chans, None, 1)
            ok, report, _ = f64_rule(hg.hourglass_cuda(*args), hg.hourglass_plain(*args),
                                     hg.hourglass_plain(*(a.double() if torch.is_tensor(a)
                                                          and a.is_floating_point() else a
                                                          for a in args)))
            say(f"dp last card (cuda:{last.index}) hourglass {report}")
            nb = B * R * 128
            same_bytes = torch.equal(gt.dropout_bytes_cuda(nb, keys[0].to(dev)).to(torch.int64),
                                     drop.random_bytes(torch.arange(nb, device=dev), keys[0].to(dev)))
            if not ok or not same_bytes:
                raise AssertionError(f"a kernel on cuda:{last.index} disagrees with its plain version")
    a, b = results[0], results[last.index]
    same = torch.equal(a[0].cpu(), b[0].cpu()) and all(torch.equal(u.cpu(), v.cpu())
                                                        for u, v in zip(a[1], b[1]))
    after = (hg.launches.value, gt.fwd_launches.value, gt.bwd_launches.value, gt.bytes_launches.value)
    say(f"dp last card: launches {tuple(y - x_ for x_, y in zip(before, after))} (hourglass, forward, "
        f"backward, bytes) with card 0 current; the stack on cuda:{last.index} equal to cuda:0's "
        f"bit for bit: {same}; Philox bytes equal: {same_bytes} on {card}")
    if not same:
        raise AssertionError("the kernels give other results on the last card than on card 0")


def dp_cli(n, grid_flags, root, card):
    """train --mesh-data n --epochs 1, then test --mesh-data n, through the CLI."""
    import os
    import re

    from building_gan_torch.checkpoint import ckpt

    run = os.path.join(root, f"run_dp{n}")
    common = grid_flags + ["--log-dir", run, "--compute-dtype", "float32", "--mesh-data", str(n)]
    out, s_train = run_cli(["train", "--epochs", "1"] + common, f"train --mesh-data {n}")
    epochs = epoch_lines(out)
    out_t, s_test = run_cli(["test", "--num-samples-to-viz", "0"] + common, f"test --mesh-data {n}")
    test = {k: float(v) for k, v in re.findall(r"(\w+_test): (\S+)", out_t)}
    say(f"dp CLI: train --mesh-data {n} --epochs 1 {s_train:.1f} s (processes included): epoch 1 "
        + ", ".join(f"{k} {v:.4f}" for k, v in epochs.get(1, {}).items())
        + f"; test --mesh-data {n} {s_test:.1f} s: "
        + ", ".join(f"{k} {v:.4f}" for k, v in test.items()) + f" on {card}")
    if (sorted(epochs) != [1] or out.count("epoch 1:") != 1 or not ckpt.exists(run)
            or set(test) != set(TEST_METRICS) or not all(np.isfinite(v) for v in test.values())
            or out_t.count("f1_score_test") != 1):
        raise AssertionError(f"the CLI at --mesh-data {n} did not train and test as expected")


def dp_cards(cfgs, packs, refs, grid_flags, root, dev, card):
    """NCCL with one rank a card on 2 to 4 cards: the checks of ``dp_shared_card`` with n
    ranks, the kernels on the last card, times, and the CLI at --mesh-data n."""
    import os

    n = min(torch.cuda.device_count(), DP_MAX_CARDS)
    out_dir = tempfile.mkdtemp(prefix="bgt_dp_cards_", dir=root)
    t = time.perf_counter()
    torch.multiprocessing.spawn(dp_card_rank, nprocs=n, join=True, args=(
        n, os.path.join(out_dir, "store"), cfgs, packs, out_dir, dev.type))
    s_spawn = time.perf_counter() - t
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(n)]
    for tag, cfg in cfgs.items():
        ref, oracle = refs[tag]
        want_launches = step_launches(cfg, dp_state(cfg, dev))
        label = f"dp ({tag}, NCCL, {n} ranks, one a card)"
        say(f"{label}: each rank's one-device step repeats bit for bit: "
            f"{[r[(tag, 'repeats')] for r in ranks]}")
        dp_check_runs(f"{label} (a) the same pack on each", [r[(tag, "a")] for r in ranks], ref,
                      DP_KEYS, want_launches, n)
        dp_check_runs(f"{label} (b) a pack and {n - 1} null packs", [r[(tag, "b")] for r in ranks],
                      ref, DP_KEYS, want_launches)
        rc = [r[(tag, "c")] for r in ranks]
        dp_check_runs(f"{label} (c) the two uneven packs and {n - 2} null packs against the oracle",
                      rc, oracle, DP_UNEVEN_KEYS, want_launches)
        dp_replicas_equal(label, rc)
        ra = [r[(tag, "a")] for r in ranks]
        step_ms = max(o["ms"][1] for o in ra)
        cells = sum(o["cells"] for o in ra)
        ar = max(o["allreduce"][0] for o in rc)
        say(f"{label}: step {step_ms:.1f} ms (step 2 of (a), the slowest rank; one card's "
            f"{refs['ms'][tag]:.1f}), {cells / (step_ms / 1e3):.1f} real voxel nodes/s summed over "
            f"ranks ({n} packs of {ra[0]['cells']}); all-reduce {ar:.3f} ms a step "
            f"({rc[0]['allreduce'][1] / 2**20:.2f} MiB) on {card}")
    say(f"dp: {n} rank processes {s_spawn:.1f} s (start, both dtypes' checks)")
    dp_last_card(packs[0], n, card)
    dp_cli(n, grid_flags, root, card)


def dp_data(root):
    """TRAINER_BUILDINGS real-scale buildings as JSON, preprocessed by the CLI; -> grid flags."""
    import os

    raw, npz = os.path.join(root, "raw"), os.path.join(root, "npz")
    max_local = write_raw(raw, TRAINER_BUILDINGS)
    run_cli(["preprocess", "--data-path", raw, "--save-data-path", npz], "preprocess")
    local_nodes = int(math.ceil(TRAINER_SLOT_GRAPHS * max_local / 64.0)) * 64
    return ["--save-data-path", npz, "--device", "cuda", "--slot-graphs", str(TRAINER_SLOT_GRAPHS),
            "--grid-local-nodes", str(local_nodes)]


def dp_trainer(grid_flags, root, dev, card):
    """Two ranks as threads on one card, each a ``Trainer`` with its gloo group on the
    processed buildings at GRID_BATCH DP_SLOTS, f32: one epoch (rank 0 writes the
    checkpoint and the scalar log), then ``test()``; the replicas and scores alike, and
    each rank's eval launches counted."""
    import os

    from building_gan_torch.checkpoint import ckpt
    from building_gan_torch.config import Configuration
    from building_gan_torch.data.pipeline import GraphDataLoaders
    from building_gan_torch.models.grid_models import GridVoxelGNNDiscriminator, GridVoxelGNNGenerator
    from building_gan_torch.parallel import mesh
    from building_gan_torch.train.trainer import Trainer

    flags = dict(zip(grid_flags[::2], grid_flags[1::2]))
    cfg = Configuration(SAVE_DATA_PATH=flags["--save-data-path"], COMPUTE_DTYPE="float32", EPOCHS=1,
                        GRID_SLOT_GRAPHS=int(flags["--slot-graphs"]), MESH_DATA=2,
                        GRID_LOCAL_NODES=int(flags["--grid-local-nodes"]), GRID_BATCH=DP_SLOTS)
    run = os.path.join(root, "run_dp_threads")

    def rank(r, group):
        with DP_INIT_LOCK:
            torch.manual_seed(cfg.SEED)
            gen, disc = GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg)
        tr = Trainer(gen, disc, GraphDataLoaders(cfg, n_device_batches=2, rank=r), cfg,
                     log_dir=run, device=dev, group=group)
        t = time.perf_counter()
        tr.train()
        s_train = time.perf_counter() - t
        before = launches_here()
        scores = tr.test()
        launches = tuple(b - a for a, b in zip(before, launches_here()))
        groups = -(-tr.dataloaders.test_dataloader.num_packs_per_epoch() // 2)
        per_batch = (1, len(tr.discriminator.encoder.channels)) if dev.type == "cuda" else (0, 0)
        return (s_train, scores, dp_params(tr.state, "cpu"), tr.state.step, launches,
                (groups * per_batch[0], groups * per_batch[1], 0, 0))

    res = mesh.thread_ranks(2, rank)
    logs = [f for f in os.listdir(run) if f.startswith("events.out.tfevents") or f == "scalars.jsonl"]
    same = all(torch.equal(res[1][2][k], v) for k, v in res[0][2].items())
    alike = res[0][1] == res[1][1] and res[0][3] == res[1][3]
    want = res[0][5]
    say(f"dp Trainer (2 gloo ranks on one card, f32): one epoch {res[0][0]:.1f} / {res[1][0]:.1f} s, "
        f"{res[0][3]} step(s); checkpoint {ckpt.exists(run)}, scalar logs {len(logs)}; replicas "
        f"equal bit for bit {same}; test scores alike on both ranks {alike}: "
        + ", ".join(f"{k} {v:.4f}" for k, v in res[0][1].items())
        + f"; test's launches a rank (hourglass, forward, backward, bytes) {res[0][4]} / "
        f"{res[1][4]} (expect {want}: one hourglass and the critic's layers a batch) on {card}")
    if not (ckpt.exists(run) and len(logs) == 1 and same and alike and res[0][4] == res[1][4] == want
            and all(np.isfinite(v) for v in res[0][1].values())):
        raise AssertionError("the data-parallel Trainer on one card did not run as expected")


def dp_phase(cfg_t, grid_flags, root, dev, card):
    """Phase 13 (``--dp`` runs it alone): data parallelism at the config of record."""
    from building_gan_torch.train.step import make_train_step

    t_phase = time.perf_counter()
    cfg, packs = dp_packs(cfg_t)
    cfgs = {"float32": cfg, "bfloat16": cfg.replace(COMPUTE_DTYPE="bfloat16")}
    packs_dev = [p.to(dev) for p in packs]
    say(f"dp: the train batch's {sum(int(p.cell_mask.amax((1, 2, 3)).gt(0).sum()) for p in packs)} "
        f"slots as two packs of {DP_SLOTS} (real cells {[int(p.cell_mask.sum()) for p in packs]})")
    refs = {"ms": {}}
    for tag, c in cfgs.items():
        refs[tag] = dp_shared_card(c, packs_dev, dev, card, tag)
        step = make_train_step(c, dp_state(c, dev))
        gen = torch.Generator(device=dev).manual_seed(0)
        step(packs_dev[0], gen)
        refs["ms"][tag] = wall_ms(lambda: step(packs_dev[0], gen))[1]
        dp_nccl_one_rank(c, packs_dev, refs[tag][0], refs["ms"][tag], dev, card, tag)
    dp_trainer(grid_flags, root, dev, card)
    say(f"phase: dp on one card {time.perf_counter() - t_phase:.1f} s")
    n = torch.cuda.device_count()
    if n < 2:
        say(f"dp: NCCL across cards did not run: this host has {n} CUDA device (needs 2 to "
            f"{DP_MAX_CARDS}; `python3 chip_smoke.py --dp` on such a host runs it)")
        return
    t_phase = time.perf_counter()
    dp_cards(cfgs, packs, refs, grid_flags, root, dev, card)
    say(f"phase: dp across {min(n, DP_MAX_CARDS)} cards {time.perf_counter() - t_phase:.1f} s")


def phase_only(run) -> int:
    """One phase alone (``--dp``, ``--sp``): builds the kernels, runs ``run(root, dev, card)``
    in a temporary directory, then prints the run's seconds and the result line."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from building_gan_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = card_line()
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    _build.build_all(("hourglass", "gat_train"))
    root = tempfile.mkdtemp(prefix="bgt_phase_")
    try:
        run(root, dev, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    say(f"total: {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def f16_only() -> int:
    """``python3 chip_smoke.py --f16``: only phases 15 and 16 (makes the serving inputs, the
    train batch and phase 9's raw and processed buildings itself; phase 16 reads the f16
    server's batcher)."""
    def run(root, dev, card):
        cfg, ref_model, packed, seeds, samples, batch, zgen, z, x_hg = serving_inputs(dev)
        masks = hourglass_masks(batch, zgen, dev)
        args_k1 = (x_hg, masks[0][1], packed["Ws"], packed["atts"], packed["vecs"], packed["chans"],
                   None, 1)
        hg_inputs = (x_hg, masks, packed["Ws"], packed["atts"], packed["vecs"], packed["chans"])
        cfg_t, batch_t = train_batch()
        dp_data(root)
        f16 = f16_phase((cfg, ref_model, samples, seeds, batch, z, args_k1), hg_inputs, cfg_t,
                        batch_t.to(dev), dev, card)
        native_phase(root, f16["served"]["server"], card)

    return phase_only(run)


def dp_only() -> int:
    """``python3 chip_smoke.py --dp``: only phase 13 (packs the train batch and writes its own
    processed buildings for the Trainer and the CLI)."""
    return phase_only(lambda root, dev, card: dp_phase(train_cfg(), dp_data(root), root, dev, card))


# Phase 14: floor sharding (parallel/sp.py) at the config of record's widths on (12, 12, 12), the
# train batch's buildings packed K = 6: two gloo ranks sharing the card (threads of this process),
# and on a host of 2 to 4 cards NCCL with one rank a card (spawned processes).  Every step of the
# phase runs SGD (tests/test_sp.py's reason: Adam turns rounding-level sign flips of near-zero
# gradients into +-lr steps, which would hide the comparison).
SP_GRID, SP_MAX_CARDS, SP_STENCIL_SLOTS, SP_LR = (12, 12, 12), 4, 16, 1e-2
SP_KEYS = ("g_loss", "d_loss", "g_loss_adv", "g_loss_ratio", "g_loss_ratio_void", "g_loss_far", "f1",
           "precision", "recall", "accuracy")
SP_METRIC_RTOL = 5e-3  # tests/test_sp.py's
SP_UPDATE_REL = 3e-3  # the critic's update, or the generator's with no critic update: tests/test_sp.py's
# The f64 sharded step against the f64 one-card step: (critic, generator) with N_CRITIC critic
# updates, and the generator with none.  The f64 runs keep the models' f32 casts (logits and
# labels, the penalty's input gradient, the losses), where a reassociated f64 sum flips an f32
# ulp now and then; the critic updates amplify it (the first card run: rel 5.4e-7 and 5.3e-4 on
# two ranks).  A dropped halo plane, a double-counted shard or a wrong reduction moves them at
# 1e-2 to 1.
SP_F64_REL, SP_F64_PURE = (1e-5, 1e-2), 1e-5
SP_DTYPES = {"float32": torch.float32, "bfloat16": BF16, "float64": torch.float64}


@functools.lru_cache(maxsize=None)
def sp_batch():
    """(cfg, batch on the CPU): the train batch's TRAIN_BATCH_BUILDINGS buildings planned and
    packed K = 6 at (12, 12, 12) (F = 12 divides over 2 and 4 ranks; the config of record's
    11 floors do not)."""
    from building_gan_torch.data import pack_grid_multi_from_slots, plan_packing_slots

    cfg = train_cfg().replace(GRID_SHAPE=SP_GRID)
    samples = list(train_samples()[:TRAIN_BATCH_BUILDINGS])
    slots = plan_packing_slots(samples, cfg)
    return cfg, pack_grid_multi_from_slots(samples, slots, cfg, batch_slots=len(slots))


def sp_cfg(cfg, dtype):
    """The configuration of a dtype tag: f32 and f64 runs compute at f32 in the configuration
    (an f64 run's modules are made f64 by ``sp_state``)."""
    return cfg.replace(COMPUTE_DTYPE="bfloat16" if dtype == "bfloat16" else "float32")


def sp_on(batch, dev, dtype):
    """``batch`` on ``dev``, its float fields in f64 for an f64 run."""
    import dataclasses

    batch = batch.to(dev)
    if dtype != "float64":
        return batch
    return dataclasses.replace(batch, **{k: v.double() for k, v in vars(batch).items()
                                         if torch.is_tensor(v) and v.is_floating_point()})


def sp_state(cfg, dev, dtype):
    """Fresh models from torch.manual_seed(cfg.SEED) on ``dev`` (computing in f64 for an f64 run),
    each with SGD(SP_LR)."""
    from building_gan_torch.models.grid_models import GridVoxelGNNDiscriminator, GridVoxelGNNGenerator
    from building_gan_torch.train.state import TrainState

    with DP_INIT_LOCK:
        torch.manual_seed(cfg.SEED)
        gen, disc = GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg)
    for m in (gen, disc):
        m.to(dev)
        if dtype == "float64":
            m.double()
            m.compute_dtype = torch.float64
    return TrainState(gen, disc, torch.optim.SGD(gen.parameters(), lr=SP_LR),
                      torch.optim.SGD(disc.parameters(), lr=SP_LR))


def sp_params(state):
    """(generator, critic) parameters, copied to the host."""
    return tuple([p.detach().cpu().clone() for p in m.parameters()]
                 for m in (state.generator, state.discriminator))


def sp_distance(p0, pa, pb):
    """(relative distance, cosine) of the updates pa - p0 and pb - p0, each one vector, in f64."""
    ua = torch.cat([(a.double() - o.double()).reshape(-1) for o, a in zip(p0, pa)])
    ub = torch.cat([(b.double() - o.double()).reshape(-1) for o, b in zip(p0, pb)])
    rel = ((ua - ub).norm() / ua.norm().clamp(min=1e-300)).item()
    cos = (ua @ ub / (ua.norm() * ub.norm()).clamp(min=1e-300)).item()
    return rel, cos


def sp_launches(cfg, state, dev):
    """(hourglass, training forward, backward, dropout-byte) launches of one floor-sharded step a
    rank: the plain route's (``step_launches``), none on the CPU, where the dropout masks are
    drawn in int64 tensor arithmetic."""
    return tuple(v * (dev.type == "cuda") for v in step_launches(cfg, state, fused=False))


def sp_peak(dev, reset=False):
    """The card's peak allocated GiB since the last reset (0 on the CPU)."""
    if dev.type != "cuda":
        return 0.0
    if reset:
        torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.max_memory_allocated(dev) / 2**30


def sp_one_card(cfg, batch, dev, dtype):
    """The one-card plain step (``make_train_step(..., fused=False)``, the floor-sharded step's
    route) from the phase's weights and draws: step 1's metrics and parameters, then step 2
    timed, with the card's peak memory."""
    from building_gan_torch.train.step import make_train_step

    b = sp_on(batch, dev, dtype)
    state = sp_state(cfg, dev, dtype)
    p0 = sp_params(state)
    step = make_train_step(cfg, state, fused=False)
    gen = torch.Generator(device=dev).manual_seed(0)
    m = step(b, gen)
    out = {"p0": p0, "p1": sp_params(state), "metrics": {k: m[k].item() for k in SP_KEYS},
           "cm": m["confusion_matrix"].cpu()}
    sp_peak(dev, reset=True)
    dev_sync(dev)
    t = time.perf_counter()
    step(b, gen)
    dev_sync(dev)
    out["ms"], out["peak"] = (time.perf_counter() - t) * 1e3, sp_peak(dev)
    return out


def sp_rank_run(cfg, batch, dev, group, dtype, steps, timed=True):
    """``steps`` floor-sharded steps of fresh models on this rank of ``group`` (every rank drawing
    from a generator seeded 0), then (``timed``) one more with the collectives timed
    (``FloorShard.timed``);
    -> step 1's metrics and parameters, the last parameters, each step's launches and ms (host
    clock, synchronised), the timed step's collectives, the card's peak memory."""
    from building_gan_torch.parallel import sp

    b = sp_on(batch, dev, dtype)
    state = sp_state(cfg, dev, dtype)
    shard = sp.make_floor_shard(group, SP_GRID[0])
    step = sp.make_sp_train_step(cfg, state, shard)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"launches": [], "ms": [], "want": sp_launches(cfg, state, dev)}
    sp_peak(dev, reset=True)
    for i in range(steps):
        before = launches_here()
        dev_sync(dev)
        t = time.perf_counter()
        m = step(b, gen)
        dev_sync(dev)
        out["ms"].append((time.perf_counter() - t) * 1e3)
        out["launches"].append(tuple(a - z for z, a in zip(before, launches_here())))
        if not all(torch.isfinite(v).all().item() for v in m.values()):
            raise AssertionError(f"a floor-sharded step's metrics are not finite: {m}")
        if i == 0:
            out["metrics"] = {k: m[k].item() for k in SP_KEYS}
            out["cm"] = m["confusion_matrix"].cpu()
            out["p1"] = sp_params(state)
    out["final"] = sp_params(state)
    out["peak"] = sp_peak(dev)
    if timed:
        shard.timed = True
        shard.reset_stats()
        step(b, gen)
        out["exchange"] = {k: dict(v) for k, v in shard.stats.items()}
    out["cells"] = int(batch.mask[:, shard.f0:shard.f0 + shard.fs].sum().item())
    return out


def sp_forward(cfg, batch, dev, group, dtype):
    """This rank's floors of the deterministic generator forward (``sp_generator_apply``), joined
    over the ranks: logits on the host (z from a generator seeded 5, zero Gumbel noise)."""
    from building_gan_torch.parallel import sp

    b = sp_on(batch, dev, dtype)
    state = sp_state(cfg, dev, dtype)
    z, noise = sp_noise(cfg, batch, dev)
    shard = sp.make_floor_shard(group, SP_GRID[0])
    logits, _, _ = sp.sp_generator_apply(state.generator, shard)(b, z, gumbel_noise=noise)
    return sp.gather_floors(logits, shard).cpu()


def sp_noise(cfg, batch, dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    z = torch.randn(tuple(batch.mask.shape) + (cfg.Z_DIM,), generator=gen, device=dev)
    return z, torch.zeros(tuple(batch.mask.shape) + (7,), device=dev)


def sp_forward_one_card(cfg, batch, dev, dtype):
    b = sp_on(batch, dev, dtype)
    state = sp_state(cfg, dev, dtype)
    z, noise = sp_noise(cfg, batch, dev)
    with torch.no_grad():
        logits, _, _ = state.generator(b, z, gumbel_noise=noise)
    return logits.cpu()


def sp_hold(label, r, o, ref, ref64, pure):
    """One rank's step 1 (``o``) against the one-card plain step at its dtype (``ref``) by the
    f64 rule: its distance from the one-card f64 step (``ref64``) at most ROUNDING_FACTOR times
    the one-card step's own, plus tests/test_sp.py's limit: each metric (rtol / atol 5e-3) and
    the critic's update (rel 3e-3), or with no critic update (``pure``) the generator's.  The
    generator's update after critic updates is printed, not held: its gradient is the critic's
    input gradient, which amplifies the critic's rounding ~500 times (tests/test_sp.py), so
    only the f64 runs hold it.  -> the metrics' largest difference from ``ref``."""
    bad = []
    for k in SP_KEYS:
        err, err_ref = abs(o["metrics"][k] - ref64["metrics"][k]), abs(ref["metrics"][k] - ref64["metrics"][k])
        if err > ROUNDING_FACTOR * err_ref + SP_METRIC_RTOL * (1 + abs(ref64["metrics"][k])):
            bad.append(k)
    i = 0 if pure else 1
    err = sp_distance(ref64["p0"][i], ref64["p1"][i], o["p1"][i])[0]
    err_ref = sp_distance(ref64["p0"][i], ref64["p1"][i], ref["p1"][i])[0]
    limit = ROUNDING_FACTOR * err_ref + SP_UPDATE_REL
    if err > limit:
        bad.append("generator" if pure else "critic")
    rel, cos = sp_distance(ref["p0"][i], ref["p1"][i], o["p1"][i])
    report = (f"{'generator (no critic update)' if pure else 'critic'} update against one card rel "
              f"{rel:.3e} cos {cos:.7f}; against the f64 one-card step rel {err:.3e} (one card's "
              f"{err_ref:.3e}, limit {limit:.3e})")
    if not pure:
        g = [sp_distance(ref64["p0"][0], ref64["p1"][0], x["p1"][0]) for x in (o, ref)]
        rel_g, cos_g = sp_distance(ref["p0"][0], ref["p1"][0], o["p1"][0])
        report += (f"; generator update (not held) against one card rel {rel_g:.3e} cos {cos_g:.5f}, "
                   f"against f64 rel {g[0][0]:.3e} (one card's {g[1][0]:.3e})")
    cm_cells = int((o["cm"] != ref["cm"]).sum().item())
    launches_ok = all(tuple(x) == tuple(o["want"]) for x in o["launches"])
    if r == 0 or bad or not launches_ok:
        say(f"{label} rank {r}: {report}; metrics beyond the rule {bad}; confusion-matrix cells "
            f"differing {cm_cells}; launches a step {o['launches']} (expect {tuple(o['want'])})")
    if bad or not launches_ok:
        raise AssertionError(f"{label} rank {r}: the floor-sharded step disagrees with one card "
                             f"({bad}) or launched {o['launches']}")
    return max(abs(o["metrics"][k] - ref["metrics"][k]) for k in SP_KEYS)


def sp_check_step(label, runs, refs, dtype, pure_runs, f64_runs):
    """Every rank's step 1 against the one-card plain step (``sp_hold``), with critic updates
    and without (``pure_runs``, N_CRITIC = 0); the f64 runs against the f64 one-card step within
    ``SP_F64_REL`` and ``SP_F64_PURE``.  The replicas bit-equal after the last step."""
    worst = max(sp_hold(label, r, o, refs[dtype], refs["float64"], False) for r, o in enumerate(runs))
    worst_pure = max(sp_hold(label + " N_CRITIC 0", r, o, refs[dtype, "pure"], refs["float64", "pure"], True)
                     for r, o in enumerate(pure_runs))
    same = all(torch.equal(a, b) for o in runs[1:] for pa, pb in zip(o["final"], runs[0]["final"])
               for a, b in zip(pa, pb))
    if not same:
        raise AssertionError(f"{label}: the replicas drifted apart")
    for tag, ref64, f64s, limits in (("", refs["float64"], f64_runs[0], SP_F64_REL),
                                     (" N_CRITIC 0", refs["float64", "pure"], f64_runs[1],
                                      (0.0, SP_F64_PURE))):
        for r, o in enumerate(f64s):
            rel_d = sp_distance(ref64["p0"][1], ref64["p1"][1], o["p1"][1])[0] if not tag else 0.0
            rel_g = sp_distance(ref64["p0"][0], ref64["p1"][0], o["p1"][0])[0]
            bad = rel_d > limits[0] or rel_g >= limits[1]
            if r == 0 or bad:
                say(f"{label} rank {r}{tag}, f64 against the f64 one-card step: critic rel "
                    f"{rel_d:.3e}, generator rel {rel_g:.3e} (limits {limits})")
            if bad:
                raise AssertionError(f"{label} rank {r}{tag}: the f64 floor-sharded step disagrees")
    say(f"{label}: every rank within its limits (largest metric difference from one card "
        f"{worst:.3e}, {worst_pure:.3e} at N_CRITIC 0); replicas equal bit for bit after "
        f"{len(runs[0]['ms'])} steps")


def sp_times(label, runs, ref, card):
    """Step ms (the slowest rank's last untimed step), real voxel nodes/s, the timed step's
    halo-exchange and all-reduce ms (the slowest rank's), peak memory and launches a rank."""
    step_ms = max(o["ms"][-1] for o in runs)
    cells = sum(o["cells"] for o in runs)
    ex = [o["exchange"] for o in runs]
    part = {k: (max(e.get(k, {}).get("ms", 0.0) for e in ex), ex[0].get(k, {}).get("calls", 0),
                ex[0].get(k, {}).get("bytes", 0) / 2**20) for k in ("halo", "sum", "grads")}
    say(f"{label}: step {step_ms:.1f} ms (the slowest rank; one card's plain step {ref['ms']:.1f} ms, "
        f"peak {ref['peak']:.3f} GiB), {cells / (step_ms / 1e3):.1f} real voxel nodes/s ({cells} "
        f"real cells); a timed step's collectives (each between two synchronisations): halo "
        f"exchange {part['halo'][0]:.1f} ms ({part['halo'][1]} calls, {part['halo'][2]:.1f} MiB a "
        f"rank), statistic and loss all-reduce {part['sum'][0]:.1f} ms ({part['sum'][1]} calls, "
        f"{part['sum'][2]:.2f} MiB), gradient all-reduce {part['grads'][0]:.1f} ms "
        f"({part['grads'][1]} calls, {part['grads'][2]:.2f} MiB); peak device memory a rank "
        f"{max(o['peak'] for o in runs):.3f} GiB; launches a rank a step {tuple(runs[0]['launches'][-1])} "
        f"on {card}")
    return step_ms


def sp_stencils(batch, dev, card):
    """The four halo stencils at one layer's shapes (SP_STENCIL_SLOTS slots of the batch, its
    mask and gid, random features of 32 channels) on two gloo ranks on CUDA tensors: the
    forward equal to the unsharded stencil bit for bit, the first- and second-order input
    gradients within 1e-6 of their scale."""
    from building_gan_torch.ops import stencil
    from building_gan_torch.parallel import mesh, sp

    B, R, C = min(SP_STENCIL_SLOTS, batch.mask.shape[0]), math.prod(SP_GRID), 32
    gen = torch.Generator(device=dev).manual_seed(9)
    mask = batch.mask[:B].reshape(B, R).to(dev)
    gid = batch.gid[:B].reshape(B, R).to(dev)
    h = torch.randn(B, R, C, generator=gen, device=dev) * mask[..., None]
    ins = {"h": h, "h2": torch.randn(B, R, C, generator=gen, device=dev),
           "a_src": torch.randn(B, R, generator=gen, device=dev),
           "a_dst": torch.randn(B, R, generator=gen, device=dev)}
    att, gy = torch.randn(C, generator=gen, device=dev), torch.randn(B, R, C, generator=gen, device=dev)
    uses = {"gat": ("h", "a_src", "a_dst"), "gcn": ("h",), "sum": ("h",), "gatv2": ("h", "h2")}
    plane = SP_GRID[1] * SP_GRID[2]

    def call(op, xs, m, grid, g, shard=None):
        kw = {} if shard is None else {"sp": shard}
        fn = getattr(stencil, f"stencil_{op}_flat") if shard is None else getattr(sp, f"stencil_{op}_sp")
        if op == "gatv2":
            return fn(xs[0], xs[1], att, m, grid, gid=g, **kw)
        return fn(*xs, m, grid, gid=g, **kw)

    def orders(fn, xs, g_y):
        xs = [x.clone().requires_grad_(True) for x in xs]
        y = fn(xs)
        g1 = torch.autograd.grad((y * y * g_y).sum(), xs, create_graph=True)
        g2 = torch.autograd.grad(sum((g * g).sum() for g in g1), xs)
        return [y.detach()] + [g.detach() for g in g1] + list(g2)

    worst = 0.0
    for op, names in uses.items():
        xs = [ins[k] for k in names]
        with torch.autograd.set_multithreading_enabled(False):
            want = orders(lambda v: call(op, v, mask, SP_GRID, gid), xs, gy)

        def rank(r, group):
            shard = sp.make_floor_shard(group, SP_GRID[0])
            loc = [shard.local(x, 1, plane) for x in xs]
            with torch.autograd.set_multithreading_enabled(False):
                got = orders(lambda v: call(op, v, shard.local(mask, 1, plane), (shard.fs,) + SP_GRID[1:],
                                            shard.local(gid, 1, plane), shard), loc,
                             shard.local(gy, 1, plane))
            return [sp.gather_floors(v, shard) for v in got]

        for got in mesh.thread_ranks(2, rank):
            if not torch.equal(got[0], want[0]):
                raise AssertionError(f"sp stencil {op}: the sharded forward is not the unsharded one")
            for a, b in zip(got[1:], want[1:]):
                err = ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                worst = max(worst, err)
                if err > 1e-6:
                    raise AssertionError(f"sp stencil {op}: gradients {err:.3e} of their scale apart")
    say(f"sp stencils (gat, gcn, sum, gatv2 with gid; {B} slots of {SP_GRID}, {C} channels; 2 gloo "
        f"ranks on CUDA tensors): forward equal bit for bit, first- and second-order input "
        f"gradients within {worst:.2e} of their scale (limit 1e-6) on {card}")


def sp_forward_check(cfg, batch, dev, card, dtype, n, group_fn):
    """The floor-sharded generator forward on n ranks against the one-card plain forward by the
    f64 rules (``f64_rule``: the one card's forward at the dtype as the plain version)."""
    c = sp_cfg(cfg, dtype)
    want = sp_forward_one_card(c, batch, dev, dtype)
    want64 = sp_forward_one_card(c, batch, dev, "float64")
    got = group_fn(lambda r, g: sp_forward(c, batch, dev, g, dtype))[0]
    ok, report, _ = f64_rule(got, want, want64)
    say(f"sp generator forward ({dtype}, {n} ranks) against one card {report}")
    if not ok:
        raise AssertionError(f"sp generator forward ({dtype}, {n} ranks) disagrees with one card")


def sp_shared_card(cfg, batch, dev, card):
    """Two gloo ranks on one card (threads of this process, CUDA tensors): the stencils; the
    generator forward at f32 and bf16; the step at f32 (2 steps), bf16 and f64 against the
    one-card plain step; times.  -> the one-card references by dtype."""
    from building_gan_torch.parallel import mesh

    t = time.perf_counter()
    sp_stencils(batch, dev, card)
    two = lambda fn: mesh.thread_ranks(2, fn)  # noqa: E731
    for dtype in ("float32", "bfloat16"):
        sp_forward_check(cfg, batch, dev, card, dtype, 2, two)
    say(f"sp: stencils and forward {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    refs = sp_references(cfg, batch, dev)
    say(f"sp: one-card references (f32, bf16, f64; N_CRITIC {cfg.N_CRITIC} and 0) "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    runs64 = [two(lambda r, g: sp_rank_run(c, batch, dev, g, "float64", 1, timed=False))
              for c in (sp_cfg(cfg, "float64"), sp_cfg(cfg, "float64").replace(N_CRITIC=0))]
    say(f"sp: f64 sharded steps {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        c = sp_cfg(cfg, dtype)  # the replicas held after 2 f32 steps, 1 bf16 step for time
        runs = two(lambda r, g: sp_rank_run(c, batch, dev, g, dtype, 2 if dtype == "float32" else 1))
        pure = two(lambda r, g: sp_rank_run(c.replace(N_CRITIC=0), batch, dev, g, dtype, 1,
                                            timed=False))
        label = f"sp ({dtype}, 2 gloo ranks on one card)"
        sp_check_step(label, runs, refs, dtype, pure, runs64 if dtype == "float32" else ([], []))
        sp_times(label + " (correctness, not scaling: the ranks share the card)", runs,
                 refs[dtype], card)
        say(f"sp: {dtype} sharded steps {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        del runs, pure
    return refs


def sp_references(cfg, batch, dev):
    """The one-card plain steps by dtype (f32, bf16, f64), with critic updates and without
    (``(dtype, "pure")``, N_CRITIC = 0)."""
    refs = {}
    for d in SP_DTYPES:
        refs[d] = sp_one_card(sp_cfg(cfg, d), batch, dev, d)
        refs[d, "pure"] = sp_one_card(sp_cfg(cfg, d).replace(N_CRITIC=0), batch, dev, d)
    return refs


def sp_card_rank(rank, n, store, cfg, batch, out_dir, device_type):
    """One rank a card (a spawned process), NCCL: the forward, then the step at f32, bf16 and
    f64, saved to out_dir/rank{rank}.pt."""
    import os

    from building_gan_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = mesh.init_data_group(rank, n, store, device_type)
    dev = mesh.rank_device(rank, device_type)
    try:
        res = {f"forward_{d}": sp_forward(sp_cfg(cfg, d), batch, dev, group, d)
               for d in ("float32", "bfloat16")}
        for dtype in SP_DTYPES:
            c, f64 = sp_cfg(cfg, dtype), dtype == "float64"
            res[dtype] = sp_rank_run(c, batch, dev, group, dtype, 1 if f64 else 2, timed=not f64)
            res[dtype, "pure"] = sp_rank_run(c.replace(N_CRITIC=0), batch, dev, group, dtype, 1,
                                             timed=False)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        mesh.destroy_data_group()


def sp_cards(cfg, batch, refs, root, dev, card):
    """NCCL with one rank a card on 2 and on 4 cards (6 and 3 floors a rank): the forward and the
    step against the one-card references, times."""
    import os

    have = min(torch.cuda.device_count(), SP_MAX_CARDS)
    fwd = {d: (sp_forward_one_card(sp_cfg(cfg, d), batch, dev, d),
               sp_forward_one_card(sp_cfg(cfg, d), batch, dev, "float64")) for d in ("float32", "bfloat16")}
    for n in (k for k in (2, 4) if k <= have):
        out_dir = tempfile.mkdtemp(prefix=f"bgt_sp{n}_", dir=root)
        t = time.perf_counter()
        torch.multiprocessing.spawn(sp_card_rank, nprocs=n, join=True, args=(
            n, os.path.join(out_dir, "store"), cfg, batch, out_dir, dev.type))
        s_spawn = time.perf_counter() - t
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(n)]
        label = f"sp (NCCL, {n} ranks, one a card, {SP_GRID[0] // n} floors each)"
        for d in ("float32", "bfloat16"):
            ok, report, _ = f64_rule(ranks[0][f"forward_{d}"], *fwd[d])
            say(f"{label} generator forward ({d}) against one card {report}")
            if not ok or not all(torch.equal(r[f"forward_{d}"], ranks[0][f"forward_{d}"]) for r in ranks):
                raise AssertionError(f"{label}: the generator forward ({d}) disagrees")
        f64 = ([r["float64"] for r in ranks], [r["float64", "pure"] for r in ranks])
        for dtype in ("float32", "bfloat16"):
            runs = [r[dtype] for r in ranks]
            sp_check_step(f"{label} ({dtype})", runs, refs, dtype, [r[dtype, "pure"] for r in ranks],
                          f64 if dtype == "float32" else ([], []))
            sp_times(f"{label} ({dtype})", runs, refs[dtype], card)
        say(f"{label}: {n} rank processes {s_spawn:.1f} s (start, the forward, f32 / bf16 / f64 "
            "steps with and without critic updates)")


def sp_phase(root, dev, card):
    """Phase 14 (``--sp`` runs it alone): floor sharding at the config of record's widths."""
    t_phase = time.perf_counter()
    t = time.perf_counter()
    cfg, batch = sp_batch()
    say(f"sp: the train batch's {TRAIN_BATCH_BUILDINGS} buildings in {batch.mask.shape[0]} slots of "
        f"{SP_GRID} at K={batch.graphs_per_slot} ({int(batch.mask.sum())} real cells; {time.perf_counter() - t:.1f} s "
        f"on the host)")
    refs = sp_shared_card(cfg, batch, dev, card)
    say(f"phase: sp on one card {time.perf_counter() - t_phase:.1f} s")
    n = torch.cuda.device_count()
    if n < 2:
        say(f"sp: NCCL across cards did not run: this host has {n} CUDA device (needs 2 to "
            f"{SP_MAX_CARDS}; `python3 chip_smoke.py --sp` on such a host runs it)")
        return
    t_phase = time.perf_counter()
    sp_cards(cfg, batch, refs, root, dev, card)
    say(f"phase: sp across cards {time.perf_counter() - t_phase:.1f} s")


def sp_only() -> int:
    """``python3 chip_smoke.py --sp``: only phase 14 (packs the train batch at (12, 12, 12))."""
    return phase_only(sp_phase)


def serve(cfg, samples, seeds, dev, card, requests=REQUESTS, clients=CLIENTS):
    """The serving main path at cfg's dtype and conv: InferenceServer at the config of record,
    weights from torch.manual_seed(7), ``requests`` requests from ``clients`` threads;
    outputs checked, served alone == served in a batch, the hourglass launches counted
    from 0 (at least one at GENERATOR_CONV_TYPE GATCONV, whose server must take the fused
    route; none at any other conv, whose server must not).
    Returns the server (stopped), its client threads and the measurements."""
    from building_gan_torch.models.grid_models import GridVoxelGNNGenerator
    from building_gan_torch.ops import hourglass as hg
    from building_gan_torch.serving import InferenceServer

    torch.manual_seed(7)
    weights = GridVoxelGNNGenerator(cfg).state_dict()
    server = InferenceServer(cfg, weights, max_batch=MAX_BATCH, max_delay_ms=5.0, device=dev)
    fused = cfg.GENERATOR_CONV_TYPE == "GATCONV"
    if fused != (server._weights[1] is not None):
        raise AssertionError(f"the {cfg.GENERATOR_CONV_TYPE} server took the "
                             f"{'plain' if fused else 'fused'} route")
    tag = cfg.COMPUTE_DTYPE if cfg.GENERATOR_CONV_TYPE == "GATCONV" else (
        f"{cfg.COMPUTE_DTYPE}, {cfg.GENERATOR_CONV_TYPE}")
    hg.launches.reset()
    server.start()
    try:
        server.infer(*samples[0], seed=seeds[0], timeout_s=REQUEST_TIMEOUT_S)  # warm-up
        server.batch_sizes.clear()
        results, latency, errors = {}, [], []
        lock = threading.Lock()

        def client(idx):
            try:
                for i in idx:
                    t = time.perf_counter()
                    r = server.infer(*samples[i], seed=seeds[i], timeout_s=REQUEST_TIMEOUT_S)
                    with lock:
                        latency.append(time.perf_counter() - t)
                        results[i] = r
            except Exception as e:  # noqa: BLE001 - re-raised by the main thread
                with lock:
                    errors.append(e)

        threads = [
            threading.Thread(target=client, args=(range(c, requests, clients),))
            for c in range(clients)
        ]
        t_all = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=REQUEST_TIMEOUT_S * 2)
        wall = time.perf_counter() - t_all
        if any(th.is_alive() for th in threads):
            raise TimeoutError("a client thread did not finish")
        if errors:
            raise errors[0]
        if len(results) != requests:
            raise AssertionError(f"{len(results)} of {requests} requests answered")
        batch_sizes = list(server.batch_sizes)
        for i, r in results.items():
            n = samples[i][1].x.shape[0]
            if r["logits"].shape != (n, 7) or r["types"].shape != (n,):
                raise AssertionError(f"request {i}: bad output shape {r['logits'].shape}")
            if not np.isfinite(r["logits"]).all():
                raise AssertionError(f"request {i}: non-finite logits")
            if not ((r["types"] >= 0) & (r["types"] < 7)).all():
                raise AssertionError(f"request {i}: types outside [0, 7)")
        alone_diff = 0.0
        for i in (0, 1, requests - 1):
            alone = server.infer(*samples[i], seed=seeds[i], timeout_s=REQUEST_TIMEOUT_S)
            if not np.array_equal(alone["types"], results[i]["types"]):
                raise AssertionError(f"request {i}: types served alone differ from batched")
            alone_diff = max(alone_diff, float(np.abs(alone["logits"] - results[i]["logits"]).max()))
        launches = hg.launches.value
    finally:
        server.stop()
    if fused and launches < 1:
        raise AssertionError(f"the served path ({tag}) never launched the hourglass kernel")
    if not fused and launches:
        raise AssertionError(f"the plain served path ({tag}) launched the hourglass kernel")
    lat = np.sort(np.array(latency)) * 1e3
    out = {"server": server, "threads": threads, "launches": launches,
           "p50": float(np.percentile(lat, 50)), "p99": float(np.percentile(lat, 99)),
           "bps": requests / wall, "results": results}
    say(f"serve ({tag}): {requests} requests, {clients} clients, batches {batch_sizes}")
    say(f"serve ({tag}): latency p50 {out['p50']:.1f} ms p99 {out['p99']:.1f} ms, "
        f"{out['bps']:.1f} buildings/s on {card}")
    say(f"serve ({tag}): alone == batched types; logits max diff {alone_diff:.1e}; "
        f"kernel launches {launches} ({'one per batch' if fused else 'the plain generator'})")
    return out


def serving_inputs(dev):
    """The serve smoke's inputs: (cfg, ref_model, packed, seeds, samples, batch, zgen, z, x_hg).

    The config of record (f32), its generator with weights from
    torch.manual_seed(cfg.SEED), REQUESTS real-scale buildings (seeds 1000-),
    the first MAX_BATCH of them packed, and the hourglass's input for that
    batch, (MAX_BATCH, F, Y, X, 128).
    """
    from building_gan_torch.config import Configuration
    from building_gan_torch.data import generate_building_real_scale, pack_grid, process_building
    from building_gan_torch.models import fast_infer
    from building_gan_torch.models.grid_models import GridVoxelGNNGenerator

    cfg = Configuration(COMPUTE_DTYPE="float32")
    F, Y, X = cfg.GRID_SHAPE
    torch.manual_seed(cfg.SEED)
    ref_model = GridVoxelGNNGenerator(cfg).to(dev).eval()
    packed = fast_infer.prepare(ref_model, cfg)
    seeds = list(range(1000, 1000 + REQUESTS))
    samples = [process_building(*generate_building_real_scale(s), cfg, str(s)) for s in seeds]
    batch = pack_grid(samples[:MAX_BATCH], cfg, batch_slots=MAX_BATCH).to(dev)
    zgen = torch.Generator(device=dev).manual_seed(1)
    z = torch.randn(MAX_BATCH, F, Y, X, cfg.Z_DIM, generator=zgen, device=dev)
    with torch.no_grad():
        x_hg = ref_model.encode(batch, z)[0].reshape(MAX_BATCH, F, Y, X, -1).contiguous()
    return cfg, ref_model, packed, seeds, samples, batch, zgen, z, x_hg


def hourglass_masks(batch, zgen, dev):
    """The hourglass checks' (K, mask, gid) at the server's shapes: the serve batch's own
    buildings (K = 1), and a random 60% mask in four quadrant keys (K = 4)."""
    B, F, Y, X = batch.mask.shape
    mask_k4 = (torch.rand(B, F, Y, X, generator=zgen, device=dev) < 0.6).float()
    iy = torch.arange(Y, device=dev)[:, None].expand(Y, X)
    ix = torch.arange(X, device=dev)[None, :].expand(Y, X)
    gid_k4 = ((ix >= X // 2).long() + 2 * (iy >= Y // 2).long()).expand(B, F, Y, X)
    return ((1, batch.mask.contiguous(), None), (4, mask_k4, gid_k4.contiguous()))


def hourglass_layout(args, card):
    """The serving kernel at the server's shapes: launches a stack call, the cluster it
    chooses and the others that fit (shared memory, clusters the card holds at once,
    time in turns with the chosen one), registers, and the device time by layer and
    phase from a traced launch.  Returns the launches of one stack call."""
    from building_gan_torch.ops import _build
    from building_gan_torch.ops import hourglass as hg

    x, mask, Ws, atts, vecs, chans = args[:6]
    B, F, Y, X, cmax = x.shape
    R, L = F * Y * X, len(chans)
    lib = hg._load()
    cc = hg.c_chans(chans)
    C = hg.cluster_size(B, R, cmax, 1, chans)
    before = hg.launches.value
    with torch.no_grad():
        hg.hourglass_cuda(*args)
    torch.cuda.synchronize()
    per_call = hg.launches.value - before
    say(f"hourglass kernel: {per_call} launch a stack call of {L} layers; it chooses a cluster of "
        f"{C} CTAs a slot ({(R + C - 1) // C} rows each), {B * C} CTAs for {B} slots, "
        f"{lib.hg_smem_bytes(R, cmax, 1, cc, L, C)} bytes of shared memory a CTA")
    for line in _build.build_log.get("hourglass", (0.0, []))[1]:
        say("hourglass kernel ptxas:", line[:160])
    sizes = [c for c in range(1, 17) if lib.hg_smem_bytes(R, cmax, 1, cc, L, c) <= 232448]
    say("hourglass kernel: cluster sizes that fit, (CTAs, rows a CTA, bytes a CTA, clusters the card "
        "holds at once by cudaOccupancyMaxActiveClusters): " + ", ".join(
            f"({c}, {(R + c - 1) // c}, {lib.hg_smem_bytes(R, cmax, 1, cc, L, c)}, "
            f"{lib.hg_max_active_clusters(R, cmax, 1, cc, L, c)})" for c in sizes))
    with torch.no_grad():
        for c in sizes:
            hg.hourglass_cuda(*args, cluster=c)
        torch.cuda.synchronize()
        times = {}
        for c in sizes + sizes[::-1]:
            times.setdefault(c, []).append(timed_ms(lambda: hg.hourglass_cuda(*args, cluster=c), 10))
    say(f"hourglass kernel ms by cluster size (CUDA events, 10 launches, in turns, on {card}): " +
        ", ".join(f"{c}: {a:.4f}/{b:.4f}" for c, (a, b) in times.items()) + f"; chosen {C}")

    # a traced launch (after a warm one): each CTA's clock at its trace points
    npts = 1 + 8 * L
    trace = torch.zeros(B * C * npts, dtype=torch.int64, device=x.device)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(2):
        rc = lib.hg_forward(x.data_ptr(), mask.data_ptr(), None, 1, Ws.data_ptr(), atts.data_ptr(),
                            vecs.data_ptr(), cc, L, B, F, Y, X, cmax, 0.2, 1e-5,
                            out.data_ptr(), None, 0, C, trace.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"traced hourglass launch failed: {lib.hg_error_string(rc).decode()}")
    torch.cuda.synchronize()
    t = trace.reshape(B * C, npts).double().cpu() / 1e6  # ms
    pts = t[:, 1:].reshape(B * C, L, 8)
    names = ("GEMM+scores+barrier", "softmax", "aggregate", "stats", "barrier", "merge", "norm+ReLU")
    say(f"hourglass kernel by layer (device ms, mean over the {B * C} CTAs, %globaltimer): a CTA "
        f"spans {(t[:, -1] - t[:, 0]).mean().item():.4f} ms, all CTAs "
        f"{(t[:, -1].max() - t[:, 0].min()).item():.4f} ms; prologue (x, row metadata, counts) "
        f"{(pts[:, 0, 0] - t[:, 0]).mean().item():.4f}")
    say("  layer  ci ->  co   total  " + "  ".join(names))
    for l, (ci, co) in enumerate(chans):
        parts = [(pts[:, l, i + 1] - pts[:, l, i]).mean().item() for i in range(7)]
        say(f"  {l:5d} {ci:3d} -> {co:3d}  {sum(parts):.4f}  " + "  ".join(f"{v:.4f}" for v in parts))
    tot = [(pts[:, :, i + 1] - pts[:, :, i]).sum(1).mean().item() for i in range(7)]
    say("  sum over layers: " + ", ".join(f"{n} {v:.4f}" for n, v in zip(names, tot)) + " ms")
    return per_call


def time_hourglass_only(tree) -> int:
    """``python3 chip_smoke.py --time-hourglass [DIR]``: the serving kernel alone at the
    server's shapes, CUDA events over 3 x 50 launches; DIR's building_gan_torch
    instead of this one's when given (a tree to compare, e.g. the parent commit
    unpacked by git archive).  One "hourglass-time" line; no checks, no result line."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import os

    if tree:
        sys.path.insert(0, os.path.abspath(tree))
    from building_gan_torch.ops import hourglass as hg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _, _, packed, _, _, batch, _, _, x_hg = serving_inputs(dev)
    args = (x_hg, batch.mask.contiguous(), packed["Ws"], packed["atts"], packed["vecs"],
            packed["chans"], None, 1)
    with torch.no_grad():
        for _ in range(3):
            hg.hourglass_cuda(*args)
        torch.cuda.synchronize()
        ms = [timed_ms(lambda: hg.hourglass_cuda(*args), 50) for _ in range(3)]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(hg.__file__))))
    say(f"hourglass-time: {root}: kernel {' '.join(f'{m:.4f}' for m in ms)} ms (50 launches "
        f"each, CUDA events) on {card_line()}")
    return 0


def finite_params(state) -> bool:
    return all(bool(torch.isfinite(p).all()) for m in (state.generator, state.discriminator)
               for p in m.parameters())


def f64_generator(model, dev):
    """A copy of a grid generator computing in f64 (its parameters f64)."""
    import copy

    m = copy.deepcopy(model).to(dev).double()
    m.compute_dtype = torch.float64
    return m


def as_f64_batch(batch):
    import dataclasses

    return dataclasses.replace(batch, **{k: v.double() for k, v in vars(batch).items()
                                         if torch.is_tensor(v) and v.is_floating_point()})


def f16_serving(serving, dev, card):
    """(b) the serving main path at f16, then on the serve batch the fused f16 generator
    (fast_infer: the f16 hourglass kernel) and the plain f16 generator against the f64
    generator on the same weights, z and noise: |fused - f64| <= ROUNDING_FACTOR x
    |plain - f64| + LOGITS_ATOL; the plain f16 generator's distance from f64 with cuBLAS's
    reduced-precision f16 reductions on (PyTorch's default) and off; the kernel and its
    plain f16 twin timed.  -> (served, hourglass (ms, plain ms, bound ms, bound by))."""
    from building_gan_torch.models import fast_infer
    from building_gan_torch.models.grid_models import GridVoxelGNNGenerator
    from building_gan_torch.ops import hourglass as hg

    cfg, ref_model, samples, seeds, batch, z, args = serving
    cfg_h = cfg.replace(COMPUTE_DTYPE="float16")
    served = serve(cfg_h, samples, seeds, dev, card)
    model = GridVoxelGNNGenerator(cfg_h).to(dev).eval()
    model.load_state_dict(ref_model.state_dict())
    noise = torch.zeros(z.shape[:-1] + (7,), device=dev)
    with torch.no_grad():
        fused, _, _ = fast_infer.infer(model, fast_infer.prepare(model, cfg_h), batch, z,
                                       gumbel_noise=noise)
        plain, _, _ = model(batch, z, gumbel_noise=noise)
        ref64, _, _ = f64_generator(ref_model, dev)(as_f64_batch(batch), z.double(),
                                                     gumbel_noise=noise.double())
        flag = torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction
        try:
            torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = not flag
            other, _, _ = model(batch, z, gumbel_noise=noise)
        finally:
            torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = flag
    torch.cuda.synchronize()
    dist = lambda a: (a.double() - ref64).abs().max().item()  # noqa: E731
    err_f, err_p, err_o = dist(fused), dist(plain), dist(other)
    limit = ROUNDING_FACTOR * err_p + LOGITS_ATOL
    say(f"f16 generator on the serve batch ({batch.mask.shape[0]} slots), logits max abs vs the f64 "
        f"generator (max |f64| {ref64.abs().max().item():.3e}): fused {err_f:.3e}, plain f16 "
        f"{err_p:.3e}, limit {limit:.3e} {'ok' if err_f <= limit else 'FAIL'}; fused vs plain "
        f"{(fused - plain).abs().max().item():.3e}")
    say(f"f16 cuBLAS reductions: the plain f16 generator's logits max abs vs f64 with "
        f"allow_fp16_reduced_precision_reduction {flag} (the default, the port's setting) "
        f"{err_p:.3e}, {not flag} {err_o:.3e}; norm-relative "
        f"{((plain.double() - ref64).norm() / ref64.norm()).item():.3e} / "
        f"{((other.double() - ref64).norm() / ref64.norm()).item():.3e}")
    if not (torch.isfinite(fused).all().item() and err_f <= limit):
        raise AssertionError("fused f16 generator logits disagree with the plain f16 generator")
    del model, ref64
    args_h = (args[0].to(F16),) + args[1:]
    with torch.no_grad():
        for _ in range(3):
            hg.hourglass_cuda(*args_h)
            hg.hourglass_plain(*args_h)
        torch.cuda.synchronize()
        p1 = timed_ms(lambda: hg.hourglass_plain(*args_h), 10)
        k1 = timed_ms(lambda: hg.hourglass_cuda(*args_h), 20)
        kb = timed_ms(lambda: hg.hourglass_cuda(*((args[0].to(BF16),) + args[1:])), 20)
        k2 = timed_ms(lambda: hg.hourglass_cuda(*args_h), 20)
        p2 = timed_ms(lambda: hg.hourglass_plain(*args_h), 10)
    B, F, Y, X, cmax = args[0].shape
    bound = bound_of(B, F * Y * X, args[5], cmax, 1, act_bytes=2)
    ms = (k1 + k2) / 2
    say(f"time: f16 hourglass kernel {k1:.3f}/{k2:.3f} ms (bf16 between: {kb:.3f}), plain f16 "
        f"{p1:.3f}/{p2:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]}), {100 * bound[0] / ms:.2f}% of "
        f"bound on {card}")
    return served, (ms, (p1 + p2) / 2, bound[0], bound[1])


def f16_phase(serving, hg_inputs, cfg_t, batch_t, dev, card):
    """Phase 15: COMPUTE_DTYPE float16 at the config of record's widths.

    (a) the three kernels at f16 storage against their plain f16 twins and the
    storage-rounded f64 reference (``check_16bit_kernels``); (b) the f16 serve
    (``f16_serving``); (c) 3 f16 train steps at GP_DTYPE "compute" on the train
    batch (150 / 80 / 30 launches; non-finite metrics recorded, not raised) and
    one at GP_DTYPE "float32", the stacks timed and held layer by layer at the
    step's weights, one f16 eval batch; (d) one f16 step of the edge layout (phase
    10's fullest pack) and of the transformer generator (phase 11's batch): finite,
    their launches.  -> {"errs", "hourglass", "stacks", "launches", "served",
    "nonfinite"}.
    """
    from building_gan_torch.ops import gat_train as gt
    from building_gan_torch.ops import hourglass as hg
    from building_gan_torch.train.step import make_eval_step

    t = time.perf_counter()
    errs = check_16bit_kernels(batch_t, hg_inputs, dev, F16)
    say(f"phase 15a: f16 kernel checks {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    served, hg_time = f16_serving(serving, dev, card)
    say(f"phase 15b: f16 serve {time.perf_counter() - t:.1f} s; served on "
        f"{type(served['server']._batcher).__name__}")

    t = time.perf_counter()
    cfg_h = cfg_t.replace(COMPUTE_DTYPE="float16")
    nonfinite = []
    state_h, step_ms, launches = train_phase(cfg_h, batch_t, dev, nonfinite=nonfinite)
    bytes_launches = gt.bytes_launches.value
    peak_h = torch.cuda.max_memory_allocated(dev) / 2**30
    n_real = int(batch_t.mask.sum().item())
    step_s = float(np.mean(step_ms[1:])) / 1e3
    say(f"train: {TRAIN_STEPS} f16 steps (GP compute): step {step_s * 1e3:.1f} ms (mean of steps "
        f"2-{TRAIN_STEPS}), {n_real / step_s:.1f} real voxel nodes/s, peak device memory {peak_h:.3f} "
        f"GiB; non-finite steps {nonfinite or 'none'} on {card}")
    gp32_nonfinite = []
    train_phase(cfg_h.replace(GP_DTYPE="float32"), batch_t, dev, steps=1, nonfinite=gp32_nonfinite)
    nonfinite += [("GP float32",) + tuple(n) for n in gp32_nonfinite]
    if not finite_params(state_h):  # time and hold the stacks on finite weights
        from building_gan_torch.models.grid_models import GridVoxelGNNDiscriminator, GridVoxelGNNGenerator
        from building_gan_torch.train.state import create_train_state

        say("f16: the trained weights are not finite; the stacks are timed on fresh weights")
        torch.manual_seed(cfg_h.SEED)
        state_h = create_train_state(cfg_h, GridVoxelGNNGenerator(cfg_h),
                                     GridVoxelGNNDiscriminator(cfg_h), device=dev)
    stacks, (fe, be) = time_train_stacks(state_h, batch_t, dev, card, F16)
    errs["gat_train_fwd"] = max(errs["gat_train_fwd"], fe)
    errs["gat_train_bwd"] = max(errs["gat_train_bwd"], be)
    h0, f0 = hg.launches.value, gt.fwd_launches.value
    m, ms = wall_ms(lambda: make_eval_step(cfg_h, state_h)(batch_t,
                                                           torch.Generator(device=dev).manual_seed(14)))
    got = (hg.launches.value - h0, gt.fwd_launches.value - f0)
    want = (1, len(state_h.discriminator.encoder.channels))
    bad = [k for k, v in m.items() if not torch.isfinite(v).all().item()]
    say(f"eval step (float16, {batch_t.mask.shape[0]} slots): {ms:.1f} ms; launches hourglass {got[0]}, "
        f"training forward {got[1]} (expect {want[0]} and {want[1]}); g_loss {m['g_loss'].item():.5f}, "
        f"f1 {m['f1'].item():.4f}; non-finite {bad or 'none'}")
    if got != want:
        raise AssertionError(f"f16 eval step: launches {got}, expected {want}")
    if bad:
        nonfinite.append(("eval", bad))
    del state_h
    torch.cuda.empty_cache()
    say(f"phase 15c: f16 train steps, stacks and eval {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    cfg_e, pack = fullest_edge_pack(dev)
    plain_steps(cfg_e.replace(COMPUTE_DTYPE="float16"), pack, dev, 1, "edges GATCONV (float16)", card)
    del pack
    cfg_x = cfg_t.replace(COMPUTE_DTYPE="float16", GENERATOR_ARCH="transformer", TRANSFORMER_LAYERS=4,
                          TRANSFORMER_HEADS=4)
    counted_steps(cfg_x, batch_t, dev, 1, "transformer (float16)", card, (0, 66, 66, 78))
    torch.cuda.empty_cache()
    say(f"phase 15d: f16 edge and transformer steps {time.perf_counter() - t:.1f} s")
    return {"errs": errs, "hourglass": hg_time, "stacks": stacks, "launches": launches,
            "bytes_launches": bytes_launches, "served": served, "nonfinite": nonfinite}


def native_phase(root, server, card):
    """Phase 16: the native host runtime.  (a) create_dataset on phase 9's raw buildings
    with the native JSON parser and with use_native=False: every array of every NPZ
    file bit-equal, and equal to the CLI's (phase 9, native by default); (b) the
    NativeBatcher against the PyBatcher on one scripted sequence of submits: the same
    batches; (c) the batcher the phase-4 server ran on."""
    import os

    from building_gan_torch.config import Configuration
    from building_gan_torch.data.preprocess import create_dataset
    from building_gan_torch.serving import batcher as B

    raw = os.path.join(root, "raw")
    dirs, secs = {}, {}
    for name, native in (("native", True), ("python", False)):
        dirs[name] = os.path.join(root, f"npz_{name}")
        t = time.perf_counter()
        n = create_dataset(Configuration(DATA_PATH=raw, SAVE_DATA_PATH=dirs[name]), verbose=False,
                           use_native=native)
        secs[name] = time.perf_counter() - t
    names = sorted(os.listdir(dirs["native"]))
    same = 0
    for other in (dirs["python"], os.path.join(root, "npz")):
        if sorted(os.listdir(other)) != names:
            raise AssertionError(f"native and {other} hold different files")
        for fname in names:
            with np.load(os.path.join(dirs["native"], fname)) as a, np.load(os.path.join(other, fname)) as b:
                if a.files != b.files or any(a[k].dtype != b[k].dtype or a[k].shape != b[k].shape
                                             or a[k].tobytes() != b[k].tobytes() for k in a.files):
                    raise AssertionError(f"{fname}: the native NPZ differs from {other}'s")
            same += 1
    say(f"native: create_dataset of {n} raw buildings (one process): native parser {secs['native']:.2f} "
        f"s, json {secs['python']:.2f} s; {len(names)} NPZ files, every array bit-equal between the two "
        f"and to phase 9's CLI preprocess ({same} comparisons)")

    def scripted(b):
        got = []
        for group in ([0, 1, 2], list(range(3, 10)), [10], list(range(11, 16))):
            for i in group:
                b.submit(i)
            while b.pending():
                got.append(b.next_batch(poll_timeout_us=100_000))
        b.complete([i for batch in got for i in batch])
        for i in range(16):
            b.wait(i, timeout_us=1_000_000)
        b.close()
        return got

    kw = dict(max_batch=4, max_delay_us=1000)
    native_b, plain_b = scripted(B.NativeBatcher(**kw)), scripted(B.PyBatcher(**kw))
    say(f"native: NativeBatcher batches {native_b}, PyBatcher {plain_b}: "
        f"{'the same' if native_b == plain_b else 'DIFFERENT'}")
    if native_b != plain_b:
        raise AssertionError("the native batcher's batches differ from the Python batcher's")
    kind = type(server._batcher).__name__
    say(f"native: the phase-4 server ran on {kind} (building_gan_torch/native/batcher.cc), its "
        f"handle freed at stop: {server._batcher._h is None}")
    if kind != "NativeBatcher" or server._batcher._h is not None:
        raise AssertionError(f"the phase-4 server ran on {kind}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from building_gan_torch.data import pack_grid
    from building_gan_torch.models import fast_infer
    from building_gan_torch.ops import _build
    from building_gan_torch.ops import gat_train as gt
    from building_gan_torch.ops import hourglass as hg
    from building_gan_torch.train.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. the card
    card = card_line()
    say(card)  # exactly as nvidia-smi --query-gpu=name,power.limit prints it
    say(f"torch {torch.__version__} cuda {torch.version.cuda} devices {torch.cuda.device_count()}")

    # 2. build both sources at once, one nvcc each
    t0 = time.perf_counter()
    _build.build_all(("hourglass", "gat_train"))
    hg._load()
    gt._load()
    say(f"build: {time.perf_counter() - t0:.1f} s for both (nvcc in parallel + ctypes)")
    for name in ("hourglass", "gat_train"):
        seconds, usage = _build.build_log.get(name, (0.0, []))
        say(f"build: {name}.cu {seconds:.1f} s")
        for line in usage:
            say("ptxas:", line[:140])

    # 3. kernel vs plain at full width, K=1 (real buildings) and K=4
    t_phase = time.perf_counter()
    cfg, ref_model, packed, seeds, samples, batch, zgen, z, x_hg = serving_inputs(dev)
    F, Y, X = cfg.GRID_SHAPE
    chans = packed["chans"]
    cmax = cfg.GENERATOR_HIDDEN_DIM
    masks = hourglass_masks(batch, zgen, dev)
    mask_k1 = masks[0][1]
    max_abs_err = 0.0  # kernel vs the plain version in f64, the quantity checked
    for K, mask, gid in masks:
        args = (x_hg, mask, packed["Ws"], packed["atts"], packed["vecs"], chans, gid, K)
        got = hg.hourglass_cuda(*args)
        want = hg.hourglass_plain(*args)
        want64 = hg.hourglass_plain(
            *(a.double() if torch.is_tensor(a) and a.is_floating_point() else a for a in args)
        )
        torch.cuda.synchronize()
        ok, report, err_k64 = f64_rule(got, want, want64)
        say(f"kernel K={K} {report}")
        if not ok:
            raise AssertionError(f"hourglass kernel disagrees with its plain version at K={K}")
        max_abs_err = max(max_abs_err, err_k64)

    # fused generator vs the plain generator on the same batch, z and noise
    noise = torch.zeros(MAX_BATCH, F, Y, X, 7, device=dev)
    with torch.no_grad():
        fused, _, _ = fast_infer.infer(ref_model, packed, batch, z, gumbel_noise=noise)
        plain, _, _ = ref_model(batch, z, gumbel_noise=noise)
    torch.cuda.synchronize()
    lerr = (fused - plain).abs().max().item()
    say(f"generator: fused vs plain logits max_abs {lerr:.3e} (tol {LOGITS_ATOL})")
    if not (torch.isfinite(fused).all().item() and lerr <= LOGITS_ATOL):
        raise AssertionError("fused generator logits disagree with the plain generator")

    say(f"phase: hourglass checks {time.perf_counter() - t_phase:.1f} s")

    # 4. the main path: the server
    t_phase = time.perf_counter()
    served = serve(cfg, samples, seeds, dev, card)
    server, threads, main_launches = served["server"], served["threads"], served["launches"]
    say(f"phase: serve {time.perf_counter() - t_phase:.1f} s")

    # 5. timing at the server's shapes (K=1), plain and kernel in turns
    t_phase = time.perf_counter()
    args = args_k1 = (x_hg, mask_k1, packed["Ws"], packed["atts"], packed["vecs"], chans, None, 1)
    with torch.no_grad():
        for _ in range(3):
            hg.hourglass_cuda(*args)
            hg.hourglass_plain(*args)
        torch.cuda.synchronize()
        p1 = timed_ms(lambda: hg.hourglass_plain(*args), 10)
        k1 = timed_ms(lambda: hg.hourglass_cuda(*args), 20)
        k2 = timed_ms(lambda: hg.hourglass_cuda(*args), 20)
        p2 = timed_ms(lambda: hg.hourglass_plain(*args), 10)
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    R = F * Y * X
    bound_ms, bound_by, nbytes, flops = bound_of(MAX_BATCH, R, chans, cmax, 1)
    say(f"time: kernel {k1:.3f}/{k2:.3f} ms, plain {p1:.3f}/{p2:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}) on {card}")
    say(f"time: kernel {nbytes / ms / 1e6:.1f} GB/s, {flops / ms / 1e6:.1f} GFLOP/s; "
        f"{100 * bound_ms / ms:.2f}% of bound")
    per_call = hourglass_layout(args, card)
    if per_call != 1:
        raise AssertionError(f"the hourglass stack took {per_call} launches, expected 1")

    # 5b. where one served batch's time goes (host clock around synchronised steps)
    def wall(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t) * 1e3

    model, packed_s = server._weights
    for _ in range(2):  # the second pass is the one printed
        b_cpu, t_pack = wall(lambda: pack_grid(samples[:MAX_BATCH], cfg, batch_slots=MAX_BATCH))
        b_dev, t_h2d = wall(lambda: b_cpu.to(dev))
        (zz, gg), t_noise = wall(lambda: server._noise(seeds[:MAX_BATCH]))
        out, t_infer = wall(lambda: fast_infer.infer(model, packed_s, b_dev, zz, gumbel_noise=gg))
        _, t_d2h = wall(lambda: [o.cpu() for o in out])
    say(f"batch of {MAX_BATCH}: pack {t_pack:.2f} ms, to card {t_h2d:.2f}, noise {t_noise:.2f}, "
        f"infer {t_infer:.2f} (hourglass kernel {ms:.2f}), back {t_d2h:.2f}")

    say(f"phase: hourglass timing and batch breakdown {time.perf_counter() - t_phase:.1f} s")

    # 5c. the serving main path at the JAX package's default COMPUTE_DTYPE (bf16): the
    # kernel's bf16 storage, served beside the f32 figures; the kernel timed at bf16
    t_phase = time.perf_counter()
    cfg_b = cfg.replace(COMPUTE_DTYPE="bfloat16")
    served_b = serve(cfg_b, samples, seeds, dev, card)
    threads = threads + served_b["threads"]
    servers = [server, served_b["server"]]
    agree = np.mean([float((served_b["results"][i]["types"] == served["results"][i]["types"]).mean())
                     for i in served["results"]])
    ldiff = max(float(np.abs(served_b["results"][i]["logits"] - served["results"][i]["logits"]).max())
                for i in served["results"])
    say(f"serve: bf16 against f32: p50 {served_b['p50']:.1f} / {served['p50']:.1f} ms, p99 "
        f"{served_b['p99']:.1f} / {served['p99']:.1f} ms, {served_b['bps']:.1f} / {served['bps']:.1f} "
        f"buildings/s; the same types on {100 * agree:.2f}% of voxels, logits max diff {ldiff:.3f}")
    args_b = (x_hg.to(BF16),) + args[1:]
    with torch.no_grad():
        for _ in range(3):
            hg.hourglass_cuda(*args_b)
            hg.hourglass_plain(*args_b)
        torch.cuda.synchronize()
        p1 = timed_ms(lambda: hg.hourglass_plain(*args_b), 10)
        k1 = timed_ms(lambda: hg.hourglass_cuda(*args_b), 20)
        k2 = timed_ms(lambda: hg.hourglass_cuda(*args), 20)
        k3 = timed_ms(lambda: hg.hourglass_cuda(*args_b), 20)
        p2 = timed_ms(lambda: hg.hourglass_plain(*args_b), 10)
    ms_b, plain_ms_b = (k1 + k3) / 2, (p1 + p2) / 2
    bound_b = bound_of(MAX_BATCH, R, chans, cmax, 1, act_bytes=2)
    say(f"time: bf16 hourglass kernel {k1:.3f}/{k3:.3f} ms (f32 between: {k2:.3f}), plain bf16 "
        f"{p1:.3f}/{p2:.3f} ms, bound {bound_b[0]:.4f} ms ({bound_b[1]}), {100 * bound_b[0] / ms_b:.2f}% "
        f"of bound; cluster {hg.cluster_size(MAX_BATCH, R, cmax, 1, chans)} CTAs a slot (shared "
        f"memory holds f32 rows at either storage) on {card}")
    say(f"phase: serve at bf16 {time.perf_counter() - t_phase:.1f} s")

    # 6. the training kernels against their plain version at full width
    t_phase = time.perf_counter()
    cfg_t, batch_t = train_batch()
    n_real = int(batch_t.mask.sum().item())
    fill = 100.0 * n_real / batch_t.mask.numel()
    say(f"train data: {TRAIN_BATCH_BUILDINGS} buildings in {batch_t.mask.shape[0]} slots of "
        f"{cfg_t.GRID_SHAPE} at K={batch_t.graphs_per_slot}, {n_real} real nodes, fill {fill:.1f}% "
        f"({time.perf_counter() - t_phase:.1f} s on the host)")
    batch_t = batch_t.to(dev)
    t_phase = time.perf_counter()
    fwd_err, bwd_err = check_train_kernels(batch_t, dev)
    say(f"phase: train kernel checks {time.perf_counter() - t_phase:.1f} s")

    # 6b. all three kernels with bf16 storage, against their plain bf16 twins and f64
    t_phase = time.perf_counter()
    hg_inputs = (x_hg, masks, packed["Ws"], packed["atts"], packed["vecs"], chans)
    bf16_errs = check_16bit_kernels(batch_t, hg_inputs, dev)
    say(f"phase: bf16 kernel checks {time.perf_counter() - t_phase:.1f} s")

    # 7. the training main path
    t_phase = time.perf_counter()
    state, step_ms, (fwd_launches, bwd_launches) = train_phase(cfg_t, batch_t, dev)
    step_s = float(np.mean(step_ms[1:])) / 1e3
    say(f"train: {TRAIN_STEPS} steps (G {cfg_t.GENERATOR_ENCODER_REPEAT}x{cfg_t.GENERATOR_HIDDEN_DIM}, "
        f"D {cfg_t.DISCRIMINATOR_ENCODER_REPEAT}x{cfg_t.DISCRIMINATOR_HIDDEN_DIM}, N_CRITIC "
        f"{cfg_t.N_CRITIC}, f32): step {step_s * 1e3:.1f} ms (mean of steps 2-{TRAIN_STEPS}), "
        f"{n_real / step_s:.1f} real voxel nodes/s on {card}")
    say(f"phase: train steps {time.perf_counter() - t_phase:.1f} s; launches fwd {fwd_launches} "
        f"bwd {bwd_launches}")

    # 7b. the repair: the GP pass's dropout masks from the Philox kernel, and the
    # step in turns with the int64 masks (before any profiler runs here)
    t_phase = time.perf_counter()
    repair_check(state, cfg_t, batch_t, dev, card)
    say(f"phase: repair check {time.perf_counter() - t_phase:.1f} s")

    # 7c. the training main path at the JAX package's defaults: COMPUTE_DTYPE bf16 with
    # GP_DTYPE "compute" (3 steps), then one step at GP_DTYPE "float32"; then the f32 and
    # bf16 steps in turns in this process (f32, bf16, bf16, f32, twice)
    t_phase = time.perf_counter()
    cfg_tb = cfg_t.replace(COMPUTE_DTYPE="bfloat16")
    state_b, _, (fwd_launches_b, bwd_launches_b) = train_phase(cfg_tb, batch_t, dev)
    train_phase(cfg_tb.replace(GP_DTYPE="float32"), batch_t, dev, steps=1)
    turns_ms, _ = dtype_turns({"float32": (cfg_t, state), "bfloat16": (cfg_tb, state_b)}, batch_t,
                              dev, card)
    say(f"phase: bf16 train steps {time.perf_counter() - t_phase:.1f} s; launches fwd "
        f"{fwd_launches_b} bwd {bwd_launches_b} in the 3 bf16 steps")

    # 8. the stacks timed at the step's shapes
    t_phase = time.perf_counter()
    stacks, (fwd_err2, bwd_err2) = time_train_stacks(state, batch_t, dev, card)
    fwd_err, bwd_err = max(fwd_err, fwd_err2), max(bwd_err, bwd_err2)
    say(f"phase: train stack timing {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    stacks_b, (fwd_err_b, bwd_err_b) = time_train_stacks(state_b, batch_t, dev, card, BF16)
    bf16_errs["gat_train_fwd"] = max(bf16_errs["gat_train_fwd"], fwd_err_b)
    bf16_errs["gat_train_bwd"] = max(bf16_errs["gat_train_bwd"], bwd_err_b)
    eval_turns({"float32": (cfg_t, state), "bfloat16": (cfg_tb, state_b)}, batch_t, dev, card)
    say(f"phase: bf16 train stack timing and eval {time.perf_counter() - t_phase:.1f} s")

    # 8b. where a train step's time goes: host clock around each part, then a trace
    t_phase = time.perf_counter()
    parts = train_breakdown(state, cfg_t, batch_t, dev)
    crit = sum(v for k, v in parts.items() if k.startswith("critic"))
    gupd = sum(v for k, v in parts.items() if k.startswith("G"))
    say(f"train step parts (host clock, one critic update and the G update, on {card}):")
    for k, v in parts.items():
        say(f"  {k}: {v:.2f} ms")
    say(f"  sum: {cfg_t.N_CRITIC} x critic update {crit:.2f} + G update {gupd:.2f} = "
        f"{cfg_t.N_CRITIC * crit + gupd:.2f} ms (measured step {step_s * 1e3:.1f} ms)")
    kernel_trace = profile_step(make_train_step(cfg_t, state), batch_t, dev)
    prof_ms, busy_ms, ours_ms, top = kernel_trace
    if busy_ms is None:
        say("train step trace: the profiler shows no device time; device busy share not measured")
    else:
        say(f"train step trace: wall {prof_ms:.1f} ms under the profiler, device busy {busy_ms:.1f} ms "
            f"({100 * busy_ms / prof_ms:.1f}%), idle {100 * (1 - busy_ms / prof_ms):.1f}%; "
            f"gat_train kernels {ours_ms:.1f} ms ({100 * ours_ms / busy_ms:.1f}% of busy)")
        for name, v in top[:15]:
            say(f"  device {v:8.2f} ms  {name[:110]}")
    prof_b, busy_b, ours_b, top_b = profile_step(make_train_step(cfg_tb, state_b), batch_t, dev)
    if busy_b is None:
        say("train step trace (bf16): the profiler shows no device time; not measured")
    else:
        say(f"train step trace (bf16): wall {prof_b:.1f} ms under the profiler, device busy "
            f"{busy_b:.1f} ms ({100 * busy_b / prof_b:.1f}%), idle {100 * (1 - busy_b / prof_b):.1f}%; "
            f"gat_train kernels {ours_b:.1f} ms ({100 * ours_b / busy_b:.1f}% of busy)")
        for name, v in top_b[:10]:
            say(f"  device {v:8.2f} ms  {name[:110]}")

    repair_trace(state, cfg_t, batch_t, dev, kernel_trace)
    say(f"phase: train breakdown and traces {time.perf_counter() - t_phase:.1f} s")
    del state, state_b
    torch.cuda.empty_cache()

    # 9. the trainer slice: CLI subprocesses on the card, then a Trainer in process; its
    # processed buildings stay for phase 10's CLI runs
    root = tempfile.mkdtemp(prefix="bgt_trainer_")
    try:
        grid_flags, _ = trainer_phase(dev, card, root)

        # 10. the conv registry and the edge layout: plain modules on the card
        threads += registry_phase(cfg_t, batch_t, grid_flags, root, dev, card)

        # 11. the other training modes, the transformer generator, GRID_BUCKETS and the router
        threads += modes_phase(cfg_t, batch_t, grid_flags, root, dev, card)

        # 12. the reference's other surfaces: sanity and the kernels on one slot, best-of-k,
        # analyze and ingest, the bf16 step's roofline share
        surfaces_phase(cfg_tb, batch_t, turns_ms["bfloat16"], grid_flags, root, dev, card)

        # 13. data parallelism: two gloo ranks sharing the card, NCCL at one rank, and on a
        # host of several cards NCCL at one rank a card with the CLI's --mesh-data
        dp_phase(cfg_t, grid_flags, root, dev, card)

        # 14. floor sharding: two gloo ranks sharing the card, and on a host of several
        # cards NCCL at one rank a card
        sp_phase(root, dev, card)

        # 15. COMPUTE_DTYPE float16: the kernels' f16 storage, the serve, the steps
        t_phase = time.perf_counter()
        f16 = f16_phase((cfg, ref_model, samples, seeds, batch, z, args_k1), hg_inputs, cfg_t,
                        batch_t, dev, card)
        threads += f16["served"]["threads"]
        servers.append(f16["served"]["server"])
        say(f"phase: float16 {time.perf_counter() - t_phase:.1f} s")

        # 16. the native host runtime: the JSON parser on phase 9's buildings, the batcher
        t_phase = time.perf_counter()
        native_phase(root, server, card)
        say(f"phase: native host runtime {time.perf_counter() - t_phase:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # 17. kernels line: the training kernels' times are one generator stack
    # (14 layer launches) at the step's shapes; each kernel at f32, bf16 and f16 storage,
    # launches from that dtype's main path (the server's, 3 train steps)
    kernels = []
    for dt, launches_hg, errs, hg_t, stk, (fl, bl) in (
        ("float32", main_launches, {"hourglass_fwd": max_abs_err, "gat_train_fwd": fwd_err,
                                    "gat_train_bwd": bwd_err},
         (ms, plain_ms, bound_ms, bound_by), stacks["generator"], (fwd_launches, bwd_launches)),
        ("bfloat16", served_b["launches"], bf16_errs, (ms_b, plain_ms_b, bound_b[0], bound_b[1]),
         stacks_b["generator"], (fwd_launches_b, bwd_launches_b)),
        ("float16", f16["served"]["launches"], f16["errs"], f16["hourglass"],
         f16["stacks"]["generator"], f16["launches"]),
    ):
        sfx = {"float32": "", "bfloat16": "_bf16", "float16": "_f16"}[dt]
        kernels.append({
            "name": "hourglass_fwd" + sfx, "route": "cuda", "dtype": dt,
            "source": "building_gan_torch/csrc/hourglass.cu",
            "replaces": "building_gan_tpu/ops/pallas/hourglass.py:92",
            "launches": launches_hg, "max_abs_err": errs["hourglass_fwd"],
            "ms": hg_t[0], "plain_ms": hg_t[1], "bound_ms": hg_t[2], "bound_by": hg_t[3],
            "library_ms": None,
        })
        for kname, line, launches, (k_ms, p_ms, b_ms, b_by) in (
            ("gat_train_fwd", 175, fl, stk["fwd"]),
            ("gat_train_bwd", 208, bl, stk["bwd"]),
        ):
            kernels.append({
                "name": kname + sfx, "route": "cuda", "dtype": dt,
                "source": "building_gan_torch/csrc/gat_train.cu",
                "replaces": f"building_gan_tpu/ops/pallas/gat_train.py:{line}",
                "launches": launches, "max_abs_err": errs[kname], "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            })
    say(f"total: {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))

    # 18. result line, last
    if any(srv._thread.is_alive() for srv in servers) or any(th.is_alive() for th in threads):
        raise AssertionError("a server or client thread is still running")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def steps_only(n: int) -> int:
    """``python3 chip_smoke.py --steps N``: only the train step, N + 1 steps (the first
    is set-up), each host-timed between synchronisations, with its peak device
    memory.  For comparing two trees in one call, in turns (no checks, no result line).
    """
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from building_gan_torch.models.grid_models import GridVoxelGNNDiscriminator, GridVoxelGNNGenerator
    from building_gan_torch.train.state import create_train_state
    from building_gan_torch.train.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg, batch = train_batch()
    batch = batch.to(dev)
    torch.manual_seed(cfg.SEED)
    state = create_train_state(cfg, GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg),
                               device=dev)
    step = make_train_step(cfg, state)
    gen = torch.Generator(device=dev).manual_seed(0)
    ms, peak = [], []
    for _ in range(n + 1):
        torch.cuda.reset_peak_memory_stats(dev)
        _, t = wall_ms(lambda: step(batch, gen))
        ms.append(t)
        peak.append(torch.cuda.max_memory_allocated(dev) / 2**30)
    n_real = int(batch.mask.sum().item())
    say(f"steps: {' '.join(f'{t:.1f}' for t in ms[1:])} ms; median {float(np.median(ms[1:])):.1f} ms, "
        f"{n_real / (float(np.median(ms[1:])) / 1e3):.1f} real voxel nodes/s; peak device memory "
        f"{max(peak[1:]):.3f} GiB on {card_line()}")
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--steps":
        sys.exit(steps_only(int(sys.argv[2])))
    if len(sys.argv) == 2 and sys.argv[1] == "--dp":
        sys.exit(dp_only())
    if len(sys.argv) == 2 and sys.argv[1] == "--sp":
        sys.exit(sp_only())
    if len(sys.argv) == 2 and sys.argv[1] == "--f16":
        sys.exit(f16_only())
    if len(sys.argv) in (2, 3) and sys.argv[1] == "--time-hourglass":
        sys.exit(time_hourglass_only(sys.argv[2] if len(sys.argv) == 3 else None))
    sys.exit(main())
