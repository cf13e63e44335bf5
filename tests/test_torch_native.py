"""The port's native host runtime and the assay script (CPU).

- ``create_dataset`` with the native JSON parser (``native/buildingjson.cc``,
  built at first use by the host compiler) and with ``use_native=False``: every
  array of every NPZ file bit-equal between the two, and to the JAX package's
  ``create_dataset(use_native=True)`` on the same raw buildings; in one
  process and with a pool of two workers.
- A failed native build raises with the compiler's output (no quiet fallback).
- The micro-batcher's semantics, as tests/test_serving.py holds the JAX
  package's, for the C++ ``NativeBatcher`` and its Python twin ``PyBatcher``
  alike: size-triggered batches then the drain, the deadline closing a
  partial batch, ``close`` with blocked waiters; and one scripted sequence of
  submits giving both the same batches.  The server runs on the native
  batcher, and ``stop`` frees its handle.
- ``scripts/torch_demo_train.py`` end to end on the CPU at tiny widths for 2
  epochs: synthesis, the native parser under a pool, the trainer, the test
  split's scores; then a second call resumes from its log dir.

Everything compared here is bytes or integer ids: tolerance 0.
"""

import importlib.util
import os
import threading
import time

import numpy as np
import pytest

from building_gan_tpu.config import Configuration as JConfiguration
from building_gan_tpu.data import preprocess as jpre

from building_gan_torch.data import preprocess as tpre
from building_gan_torch.data import synthetic as tsyn
from building_gan_torch.ops import _build
from building_gan_torch.serving import batcher as B

from test_torch_layers import port_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

N_BUILDINGS = 12
BATCHERS = [B.NativeBatcher, B.PyBatcher]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _npz_arrays(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def assert_npz_dirs_bit_equal(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) == 2 * N_BUILDINGS
    for name in names:
        x, y = _npz_arrays(os.path.join(a, name)), _npz_arrays(os.path.join(b, name))
        assert x.keys() == y.keys(), name
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, (name, k)
            assert x[k].tobytes() == y[k].tobytes(), (name, k)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("native_raw")
    tsyn.write_dataset(str(root), N_BUILDINGS, seed=5)
    return str(root)


@pytest.mark.parametrize("workers", [0, 2])
def test_native_create_dataset_is_bit_equal_to_python_and_jax(raw, tmp_path, workers):
    out = {}
    for name, native in (("native", True), ("python", False)):
        cfg = port_cfg(JConfiguration(DATA_PATH=raw, SAVE_DATA_PATH=str(tmp_path / name)))
        assert tpre.create_dataset(cfg, verbose=False, use_native=native, workers=workers) == N_BUILDINGS
        out[name] = cfg.SAVE_DATA_PATH
    jcfg = JConfiguration(DATA_PATH=raw, SAVE_DATA_PATH=str(tmp_path / "jax"))
    assert jpre.create_dataset(jcfg, verbose=False, use_native=True) == N_BUILDINGS
    assert_npz_dirs_bit_equal(out["native"], out["python"])
    assert_npz_dirs_bit_equal(out["native"], jcfg.SAVE_DATA_PATH)


def test_native_parser_reads_what_json_reads(raw):
    import json

    from building_gan_torch.native import parser

    path = os.path.join(raw, "voxel_data", sorted(os.listdir(os.path.join(raw, "voxel_data")))[0])
    with open(path) as f:
        assert parser.parse_file(path) == json.load(f)
    with pytest.raises(RuntimeError, match="native JSON parse failed"):
        parser.parse_file(os.path.join(raw, "no_such_file.json"))


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """A compiler that fails: the build raises with its output, and nothing is loaded."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="host C\\+\\+ compiler failed on batcher.cc"):
        _build.load_host("batcher")
    assert not [f for f in os.listdir(tmp_path / "build") if f.endswith(".so")]


# --- the micro-batcher, native and Python --------------------------------------------------

@pytest.mark.parametrize("cls", BATCHERS)
def test_batcher_forms_batches(cls):
    b = cls(max_batch=4, max_delay_us=50_000)
    for i in range(6):
        b.submit(i)
    first = b.next_batch()
    second = b.next_batch()
    assert sorted(first + second) == list(range(6))
    assert len(first) == 4 and len(second) == 2  # size-triggered then drain
    b.complete(first + second)
    for i in range(6):
        b.wait(i, timeout_us=1_000_000)
    assert b.pending() == 0
    b.shutdown()
    with pytest.raises((RuntimeError, StopIteration)):
        b.submit(99)
    with pytest.raises(StopIteration):
        b.next_batch(poll_timeout_us=1000)
    b.close()


@pytest.mark.parametrize("cls", BATCHERS)
def test_batcher_deadline_closes_partial_batch(cls):
    b = cls(max_batch=64, max_delay_us=30_000)
    b.submit(0)
    t0 = time.monotonic()
    got = b.next_batch(poll_timeout_us=500_000)
    assert got == [0]
    assert time.monotonic() - t0 < 0.4  # closed by deadline, not poll timeout
    assert b.next_batch(poll_timeout_us=1000) == []  # an idle poll
    with pytest.raises(TimeoutError):
        b.wait(0, timeout_us=1000)
    b.close()


@pytest.mark.parametrize("cls", BATCHERS)
def test_batcher_close_with_blocked_waiters(cls):
    """close() while threads are blocked unblocks them (batcher.cc sb_destroy waits for
    its waiters to drain before it frees the queue)."""
    b = cls(max_batch=4, max_delay_us=50_000)
    errs = []

    def waiter():
        try:
            b.wait(123, timeout_us=10_000_000)
        except RuntimeError:
            pass
        except Exception as e:  # pragma: no cover
            errs.append(e)

    def fetcher():
        try:
            b.next_batch(poll_timeout_us=10_000_000)
        except StopIteration:
            pass
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=waiter), threading.Thread(target=fetcher)]
    for t in threads:
        t.start()
    time.sleep(0.05)  # let both block
    b.close()
    for t in threads:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in threads)
    assert not errs


def scripted_batches(b):
    """One scripted sequence of submits and fetches: every fetch after its submits are
    queued, so the batches depend on the size rule and the queue order alone."""
    got = []
    for group in ([0, 1, 2], [3, 4, 5, 6, 7, 8, 9], [10], [11, 12, 13, 14, 15]):
        for i in group:
            b.submit(i)
        while b.pending():
            got.append(b.next_batch(poll_timeout_us=100_000))
    b.complete([i for batch in got for i in batch])
    for i in range(16):
        b.wait(i, timeout_us=1_000_000)
    b.close()
    return got


def test_native_batcher_gives_the_python_batches():
    kw = dict(max_batch=4, max_delay_us=1000)
    native, plain = scripted_batches(B.NativeBatcher(**kw)), scripted_batches(B.PyBatcher(**kw))
    assert native == plain == [[0, 1, 2], [3, 4, 5, 6], [7, 8, 9], [10], [11, 12, 13, 14], [15]]


def test_server_runs_on_the_native_batcher(small_cfg):
    import torch

    from building_gan_torch.models.grid_models import GridVoxelGNNGenerator
    from building_gan_torch.serving import InferenceServer

    from test_train import tiny_cfg

    cfg = port_cfg(tiny_cfg(small_cfg, LAYOUT="grid", GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=64))
    torch.manual_seed(0)
    sd = GridVoxelGNNGenerator(cfg).state_dict()
    srv = InferenceServer(cfg, sd, max_batch=2, device="cpu").start()
    assert isinstance(srv._batcher, B.NativeBatcher)
    srv.stop()
    assert srv._batcher._h is None  # the handle is freed


# --- the assay script ----------------------------------------------------------------------

def test_torch_demo_train_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    """scripts/torch_demo_train.py at tiny widths (its Configuration with the widths
    replaced), 2 epochs on 12 buildings; then one more epoch resumed from its log dir."""
    spec = importlib.util.spec_from_file_location(
        "torch_demo_train", os.path.join(ROOT, "scripts", "torch_demo_train.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    tiny = dict(GENERATOR_ENCODER_REPEAT=1, GENERATOR_HIDDEN_DIM=16, LOCAL_ENCODER_HIDDEN_DIM=16,
                Z_DIM=8, GENERATOR_MLP_ENCODER_REPEAT=1, LOCAL_GRAPH_ENCODER_REPEAT=1,
                DISCRIMINATOR_ENCODER_REPEAT=1, DISCRIMINATOR_HIDDEN_DIM=16, N_CRITIC=1)
    make_config = script.make_config
    monkeypatch.setattr(script, "make_config", lambda a: make_config(a).replace(**tiny))
    monkeypatch.setitem(__import__("sys").modules, "tensorboardX", None)
    args = ["--buildings", str(N_BUILDINGS), "--epochs", "2", "--grid-batch", "4",
            "--root", str(tmp_path), "--device", "cpu", "--compute-dtype", "float16",
            "--prng", "rbg", "--device-resident", "--device-resident-compositions", "2",
            "--ckpt-latest-interval", "1"]
    out = script.main(args)
    text = capsys.readouterr().out
    assert "epoch 1:" in text and "epoch 2:" in text and "TEST:" in text
    assert np.isfinite(out["f1"]) and 0.0 <= out["f1"] <= 1.0
    processed = os.listdir(tmp_path / "processed")
    assert len(processed) == 2 * N_BUILDINGS
    log_dir = tmp_path / "runs" / "demo"
    assert (log_dir / "states_latest.pt").exists()
    script.main(args[:3] + ["3"] + args[4:])  # resumes at epoch 3
    text = capsys.readouterr().out
    assert "Loaded latest states" in text and "epoch 3:" in text and "epoch 1:" not in text
