#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (building_gan_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one short output line or a few each:
  1. the card (nvidia-smi name and power limit) and the torch version;
  2. build csrc/hourglass.cu with nvcc (plain C interface, loaded with ctypes);
  3. the hourglass kernel against its plain PyTorch version on the card, at
     the config of record's widths (hidden 128, repeat 7, grid (11,12,12),
     16 slots), one building per slot (K=1) and four (K=4);
  4. the main path: InferenceServer at the config of record, random weights
     from a seed, >= 32 requests of real-scale synthetic buildings from
     several threads; outputs checked, served-alone == served-in-a-batch,
     fused logits == the plain generator's, kernel launches counted;
  5. the kernel and its plain version timed with CUDA events at the server's
     shapes, against the card's bound;
  6. a {"kernels": [...]} line;
  7. the server stopped, every thread joined, and the result line last.

The kernel is held against its plain version run in float64 (tolerance:
within 4x the plain float32 version's own rounding error, plus 1e-4).
Parity phases run f32 with TF32 off (torch.backends.cuda.matmul.allow_tf32
and torch.backends.cudnn.allow_tf32 both False).  Any failure is an uncaught
exception and a non-zero exit.  Without a CUDA device it exits 1 at once.
"""

import json
import subprocess
import sys
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
LOGITS_ATOL = 1e-3  # fused vs plain generator logits, f32 both
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
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_of(B, R, chans, cmax, K):
    """(bound_ms, bound_by, bytes, flops) of one hourglass call on an H100 SXM.

    Bytes: x and out (B, R, cmax) f32, the mask plane, the gid plane when
    K > 1, and the packed weights, each moved once.  Operations at the real
    ci x co widths: the GEMM (2 ci co a row), the two scores (4 co), the
    7-way aggregate (14 co) and GraphNorm statistics and apply (6 co).
    """
    L = len(chans)
    nbytes = 4 * (2 * B * R * cmax + B * R * (2 if K > 1 else 1) + L * cmax * (cmax + 6))
    flops = sum(B * R * (2 * ci * co + 24 * co) for ci, co in chans)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from building_gan_torch.config import Configuration
    from building_gan_torch.data import generate_building_real_scale, pack_grid, process_building
    from building_gan_torch.models import fast_infer
    from building_gan_torch.models.grid_models import GridVoxelGNNGenerator
    from building_gan_torch.ops import _build
    from building_gan_torch.ops import hourglass as hg
    from building_gan_torch.serving import InferenceServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. the card
    card = card_line()
    say(card)  # exactly as nvidia-smi --query-gpu=name,power.limit prints it
    say(f"torch {torch.__version__} cuda {torch.version.cuda} devices {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    hg._load()
    say(f"build: hourglass.cu {time.perf_counter() - t0:.1f} s (nvcc + ctypes)")
    for line in _build.build_log.get("hourglass", (0, []))[1]:
        say("ptxas:", line.split(":", 1)[-1].strip()[:110])

    # 3. kernel vs plain at full width, K=1 (real buildings) and K=4
    cfg = Configuration(COMPUTE_DTYPE="float32")
    F, Y, X = cfg.GRID_SHAPE
    torch.manual_seed(cfg.SEED)
    ref_model = GridVoxelGNNGenerator(cfg).to(dev).eval()
    packed = fast_infer.prepare(ref_model, cfg)
    chans = packed["chans"]
    cmax = cfg.GENERATOR_HIDDEN_DIM
    seeds = list(range(1000, 1000 + REQUESTS))
    samples = [process_building(*generate_building_real_scale(s), cfg, str(s)) for s in seeds]
    batch = pack_grid(samples[:MAX_BATCH], cfg, batch_slots=MAX_BATCH).to(dev)
    zgen = torch.Generator(device=dev).manual_seed(1)
    z = torch.randn(MAX_BATCH, F, Y, X, cfg.Z_DIM, generator=zgen, device=dev)
    with torch.no_grad():
        x_hg = ref_model.encode(batch, z)[0].reshape(MAX_BATCH, F, Y, X, cmax).contiguous()
    mask_k1 = batch.mask.contiguous()
    mask_k4 = (torch.rand(MAX_BATCH, F, Y, X, generator=zgen, device=dev) < 0.6).float()
    iy = torch.arange(Y, device=dev)[:, None].expand(Y, X)
    ix = torch.arange(X, device=dev)[None, :].expand(Y, X)
    gid_k4 = ((ix >= X // 2).long() + 2 * (iy >= Y // 2).long()).expand(MAX_BATCH, F, Y, X)
    max_abs_err = 0.0  # kernel vs the plain version in f64, the quantity checked
    for K, mask, gid in ((1, mask_k1, None), (4, mask_k4, gid_k4.contiguous())):
        args = (x_hg, mask, packed["Ws"], packed["atts"], packed["vecs"], chans, gid, K)
        got = hg.hourglass_cuda(*args)
        want = hg.hourglass_plain(*args)
        want64 = hg.hourglass_plain(
            *(a.double() if torch.is_tensor(a) and a.is_floating_point() else a for a in args)
        )
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        err_k64 = (got.double() - want64).abs().max().item()
        err_p64 = (want.double() - want64).abs().max().item()
        limit = ROUNDING_FACTOR * err_p64 + ROUNDING_ATOL
        ok = torch.isfinite(got).all().item() and err_k64 <= limit
        say(f"kernel K={K}: vs plain f32 max_abs {err:.3e}; vs plain f64: kernel {err_k64:.3e}, "
            f"plain f32 {err_p64:.3e}, limit {limit:.3e} {'ok' if ok else 'FAIL'}")
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

    # 4. the main path: the server
    torch.manual_seed(7)
    weights = GridVoxelGNNGenerator(cfg).state_dict()
    server = InferenceServer(cfg, weights, max_batch=MAX_BATCH, max_delay_ms=5.0, device=dev)
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
            threading.Thread(target=client, args=(range(c, REQUESTS, CLIENTS),))
            for c in range(CLIENTS)
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
        if len(results) != REQUESTS:
            raise AssertionError(f"{len(results)} of {REQUESTS} requests answered")
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
        for i in (0, 1, REQUESTS - 1):
            alone = server.infer(*samples[i], seed=seeds[i], timeout_s=REQUEST_TIMEOUT_S)
            if not np.array_equal(alone["types"], results[i]["types"]):
                raise AssertionError(f"request {i}: types served alone differ from batched")
            alone_diff = max(alone_diff, float(np.abs(alone["logits"] - results[i]["logits"]).max()))
        main_launches = hg.launches.value
    finally:
        server.stop()
    if main_launches < 1:
        raise AssertionError("the served path never launched the hourglass kernel")
    lat = np.sort(np.array(latency)) * 1e3
    say(f"serve: {REQUESTS} requests, {CLIENTS} clients, batches {batch_sizes}")
    say(f"serve: latency p50 {np.percentile(lat, 50):.1f} ms p99 {np.percentile(lat, 99):.1f} ms, "
        f"{REQUESTS / wall:.1f} buildings/s on {card}")
    say(f"serve: alone == batched types; logits max diff {alone_diff:.1e}; "
        f"kernel launches {main_launches} (one per batch)")

    # 5. timing at the server's shapes (K=1), plain and kernel in turns
    args = (x_hg, mask_k1, packed["Ws"], packed["atts"], packed["vecs"], chans, None, 1)
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

    # 6. kernels line
    say(json.dumps({"kernels": [{
        "name": "hourglass_fwd", "route": "cuda",
        "source": "building_gan_torch/csrc/hourglass.cu",
        "replaces": "building_gan_tpu/ops/pallas/hourglass.py:92",
        "launches": main_launches, "max_abs_err": max_abs_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }]}))

    # 7. result line, last
    if server._thread.is_alive() or any(th.is_alive() for th in threads):
        raise AssertionError("a server or client thread is still running")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
