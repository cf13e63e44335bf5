"""The port's batcher and inference server, on the CPU.

The server runs the generator through ``fast_infer`` (the plain hourglass on
the CPU).  Its outputs are compared with themselves: one building served
alone and in a batch must agree exactly (per-request noise, per-slot
statistics), and a swapped-in checkpoint must serve what a server started on
it serves.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from building_gan_torch.config import Configuration
from building_gan_torch.models.grid_models import GridVoxelGNNGenerator
from building_gan_torch.serving import InferenceServer
from building_gan_torch.serving.batcher import PyBatcher

from test_torch_layers import port_cfg
from test_train import tiny_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)


def test_batcher_forms_batches():
    b = PyBatcher(max_batch=4, max_delay_us=50_000)
    for i in range(6):
        b.submit(i)
    first = b.next_batch()
    second = b.next_batch()
    assert len(first) == 4 and len(second) == 2
    assert sorted(first + second) == list(range(6))
    b.complete(first + second)
    for i in range(6):
        b.wait(i, timeout_us=1_000_000)
    assert b.pending() == 0
    b.shutdown()
    with pytest.raises(RuntimeError):
        b.submit(99)
    with pytest.raises(StopIteration):
        b.next_batch()


def test_batcher_deadline_and_shutdown_unblock():
    b = PyBatcher(max_batch=64, max_delay_us=30_000)
    b.submit(0)
    t0 = time.monotonic()
    assert b.next_batch(poll_timeout_us=500_000) == [0]
    assert time.monotonic() - t0 < 0.4  # closed by the deadline, not the poll timeout
    with pytest.raises(TimeoutError):
        b.wait(7, timeout_us=10_000)
    errs = []

    def waiter():
        try:
            b.wait(123, timeout_us=10_000_000)
        except RuntimeError:
            pass
        except Exception as e:  # pragma: no cover
            errs.append(e)

    th = threading.Thread(target=waiter)
    th.start()
    time.sleep(0.05)
    b.shutdown()
    th.join(timeout=5)
    assert not th.is_alive() and not errs


@pytest.fixture(scope="module")
def serve_cfg(small_cfg):
    return port_cfg(tiny_cfg(
        small_cfg, LAYOUT="grid", GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=64,
        COMPUTE_DTYPE="float32",
    ))


def _weights(cfg, seed):
    torch.manual_seed(seed)
    return GridVoxelGNNGenerator(cfg).state_dict()


@pytest.fixture(scope="module")
def server(serve_cfg):
    srv = InferenceServer(
        serve_cfg, _weights(serve_cfg, 0), max_batch=4, max_delay_ms=20.0, device="cpu"
    ).start()
    yield srv
    srv.stop()


def _await_pending(server, n, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while server._batcher.pending() < n:
        assert time.monotonic() < deadline, f"{server._batcher.pending()} of {n} requests queued"
        time.sleep(0.005)


def test_server_alone_equals_batched(serve_cfg, synthetic_samples):
    """Four requests from four threads, queued before the executor starts, so they
    form one batch whatever the host's load; then each alone, bit for bit."""
    samples = synthetic_samples[:4]
    results = [None] * len(samples)
    server = InferenceServer(serve_cfg, _weights(serve_cfg, 0), max_batch=4, max_delay_ms=20.0,
                             device="cpu")

    def worker(i):
        results[i] = server.infer(*samples[i], seed=100 + i, timeout_s=120.0)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(samples))]
    for th in threads:
        th.start()
    try:
        _await_pending(server, len(samples))
        server.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        assert all(r is not None for r in results)
        assert server.batch_sizes == [4]
        alone = [server.infer(local, voxel, seed=100 + i, timeout_s=120.0)
                 for i, (local, voxel) in enumerate(samples)]
        other = server.infer(*samples[0], seed=999, timeout_s=120.0)
    finally:
        server.stop()
    assert server.batch_sizes == [4, 1, 1, 1, 1, 1]
    for i, (local, voxel) in enumerate(samples):
        alone_i = alone[i]
        n = voxel.x.shape[0]
        assert alone_i["logits"].shape == (n, 7) and alone_i["types"].shape == (n,)
        np.testing.assert_array_equal(alone_i["types"], results[i]["types"])
        np.testing.assert_allclose(alone_i["logits"], results[i]["logits"], rtol=0, atol=1e-6)
        assert ((alone_i["types"] >= 0) & (alone_i["types"] < 7)).all()
    assert not np.array_equal(other["label_soft"], results[0]["label_soft"])  # seed matters


def test_server_rejects_at_submit_and_survives_poison(server, synthetic_samples):
    local, voxel = synthetic_samples[0]
    big = dataclasses.replace(
        voxel, location=voxel.location + np.array([0, 0, 100], voxel.location.dtype)
    )
    with pytest.raises(ValueError, match="exceeds the server grid"):
        server.infer(local, big, seed=5)
    many = dataclasses.replace(local, x=np.zeros((65, 17), np.float32))
    with pytest.raises(ValueError, match="GRID_LOCAL_NODES"):
        server.infer(many, voxel, seed=5)
    poison = dataclasses.replace(voxel, x=voxel.x[:, :5].copy())  # wrong feature width
    with pytest.raises(RuntimeError, match="inference batch failed"):
        server.infer(local, poison, seed=9, timeout_s=120.0)
    ok = server.infer(local, voxel, seed=9, timeout_s=120.0)
    assert ok["logits"].shape == (voxel.x.shape[0], 7)


def test_server_swap_params(serve_cfg, synthetic_samples):
    local, voxel = synthetic_samples[1]
    wa, wb = _weights(serve_cfg, 0), _weights(serve_cfg, 1)
    srv = InferenceServer(serve_cfg, wa, max_batch=4, max_delay_ms=5.0, device="cpu").start()
    try:
        before = srv.infer(local, voxel, seed=7, timeout_s=120.0)
        assert srv.swap_params(wb) == 1
        after = srv.infer(local, voxel, seed=7, timeout_s=120.0)
    finally:
        srv.stop()
    assert not srv._thread.is_alive()
    assert not np.allclose(before["logits"], after["logits"])
    oracle = InferenceServer(serve_cfg, wb, max_batch=4, max_delay_ms=5.0, device="cpu").start()
    try:
        want = oracle.infer(local, voxel, seed=7, timeout_s=120.0)
    finally:
        oracle.stop()
    np.testing.assert_array_equal(after["logits"], want["logits"])


@pytest.mark.parametrize("dtype,raises", [("bfloat16", False), ("float16", False), ("float32", False),
                                          ("float64", True)])
def test_server_takes_float32_and_bfloat16(serve_cfg, dtype, raises):
    """float32, bf16 (the default) and float16 are served at that dtype; a name the port
    does not compute in is refused, naming the field."""
    cfg = serve_cfg.replace(COMPUTE_DTYPE=dtype)
    weights = _weights(serve_cfg, 0)
    if raises:
        with pytest.raises(ValueError, match=f"COMPUTE_DTYPE='{dtype}' is not ported"):
            InferenceServer(cfg, weights, max_batch=2, device="cpu")
    else:
        srv = InferenceServer(cfg, weights, max_batch=2, device="cpu")
        model, _ = srv._weights
        assert model.compute_dtype == getattr(torch, dtype)
        assert {p.dtype for p in model.parameters()} == {torch.float32}


def test_server_takes_the_default_config():
    cfg = Configuration()
    assert cfg.COMPUTE_DTYPE == "bfloat16"
    torch.manual_seed(0)
    srv = InferenceServer(cfg, GridVoxelGNNGenerator(cfg).state_dict(), device="cpu")
    assert srv._weights[0].compute_dtype == torch.bfloat16
