"""``GRID_BUCKETS`` and the routing server: the port against the JAX package (CPU).

- ``GraphDataLoaders`` with grid buckets, one building a slot (K = 1) and
  two (K = 2, each bucket packing into slots of its own shape), and K = 2
  stacked two packs a group (only packs of one shape share a group, null
  packs complete it): over two epochs the same split, the same packs in the
  same order, every array equal to the JAX package's (exact);
- a building that fits no bucket raises, as in the JAX package; buildings
  that fit none fail the grid check against the largest bucket;
- a ``Trainer`` epoch over batches of two grid shapes (train and
  validation), and ``test``;
- ``RoutingServer``: named routing, a default route, ``swap_params`` through
  the router (the swapped model serves what a server started on the new
  weights serves, within 1e-6), ``models()``, routing by size to the smallest
  grid that fits, ``remove_model`` and ``stop``;
- ``train --grid-buckets ... --slot-graphs 2`` for one epoch and ``test`` on
  the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from building_gan_tpu.config import Configuration as JConfiguration
from building_gan_tpu.data import pipeline as jpipe
from building_gan_tpu.data import preprocess as jpre
from building_gan_tpu.data import synthetic as jsyn

from building_gan_torch.checkpoint import ckpt
from building_gan_torch.cli import main as cli
from building_gan_torch.data import pipeline as tpipe
from building_gan_torch.data.grid import GridBatch
from building_gan_torch.models.grid_models import GridVoxelGNNDiscriminator, GridVoxelGNNGenerator
from building_gan_torch.serving import RoutingServer
from building_gan_torch.train.trainer import Trainer

from test_torch_layers import port_cfg
from test_torch_trainer import TINY
from test_train import tiny_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

BUCKETS = ((5, 6, 6), (8, 6, 6), (10, 8, 8))
N_BUILDINGS = 16


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """(raw dir, processed dir) of 16 synthetic buildings, written by the JAX package."""
    root = tmp_path_factory.mktemp("bucket_data")
    cfg = JConfiguration(DATA_PATH=str(root / "raw"), SAVE_DATA_PATH=str(root / "npz"))
    jsyn.write_dataset(cfg.DATA_PATH, N_BUILDINGS, seed=3)
    jpre.create_dataset(cfg, verbose=False, use_native=False)
    return cfg.DATA_PATH, cfg.SAVE_DATA_PATH


def _bucket_cfg(npz, K):
    return JConfiguration(SAVE_DATA_PATH=npz, SEED=5, LAYOUT="grid", GRID_SHAPE=(10, 8, 8),
                          GRID_BUCKETS=BUCKETS, GRID_BATCH=3, GRID_SLOT_GRAPHS=K,
                          GRID_PACK_MODE="cell", GRID_LOCAL_NODES=128)


def _assert_batches_equal(jb, tb, where):
    assert isinstance(tb, GridBatch)
    for f in dataclasses.fields(GridBatch):
        j, t = getattr(jb, f.name), getattr(tb, f.name)
        assert (j is None) == (t is None), f"{where} {f.name}"
        if j is not None:
            j = np.asarray(j)
            assert j.shape == tuple(t.shape) and np.array_equal(j, t.numpy()), f"{where} {f.name}"


@pytest.mark.parametrize("K,groups", [(1, None), (2, None), (2, 2)], ids=["k1", "k2", "k2_stacked2"])
def test_bucket_loaders_match_jax(K, groups, dataset):
    _, npz = dataset
    jcfg = _bucket_cfg(npz, K)
    jl = jpipe.GraphDataLoaders(jcfg, n_device_batches=groups)
    tl = tpipe.GraphDataLoaders(port_cfg(jcfg), n_device_batches=groups)
    assert np.array_equal(jl.train_indices, tl.train_indices)
    shapes = set()
    for epoch in range(2):
        for split in ("train", "validation", "test"):
            jb = list(getattr(jl, f"{split}_dataloader"))
            tb = list(getattr(tl, f"{split}_dataloader"))
            assert len(jb) == len(tb) > 0, (epoch, split)
            for i, (a, b) in enumerate(zip(jb, tb)):
                _assert_batches_equal(a, b, f"epoch {epoch} {split} pack {i}")
                shapes.add(tuple(b.mask.shape[-3:]))
    assert len(shapes) >= 2 and shapes <= set(BUCKETS)
    assert tl.train_dataloader.num_packs_per_epoch() == jl.train_dataloader.num_packs_per_epoch()


def test_a_building_that_fits_no_bucket_raises(synthetic_samples, dataset):
    """Routing raises on a building that fits no bucket, with the JAX package's message; the
    loaders' grid check (against the largest bucket) refuses buildings first."""
    buckets = ((5, 6, 6), (8, 6, 6))
    fit = [s for s in synthetic_samples if (s[1].location.max(axis=0) + 1 <= (8, 6, 6)).all()]
    assert 0 < len(fit) < len(synthetic_samples)
    jcfg = JConfiguration(LAYOUT="grid", GRID_BUCKETS=buckets, GRID_BATCH=2, GRID_LOCAL_NODES=64)
    for loader in (jpipe.PackedLoader(fit, jcfg), tpipe.PackedLoader(fit, port_cfg(jcfg))):
        assert len(loader._make_batches(fit)) > 0
        with pytest.raises(ValueError, match=r"building \S+ \(extent \[.*\]\) fits no bucket in"):
            loader._make_batches(synthetic_samples)
    _, npz = dataset
    with pytest.raises(ValueError, match="not grid-compatible"):
        tpipe.GraphDataLoaders(port_cfg(_bucket_cfg(npz, 1).replace(GRID_BUCKETS=((3, 3, 3),))))


@pytest.fixture
def bucket_trainer(dataset, tmp_path):
    _, npz = dataset
    cfg = port_cfg(_bucket_cfg(npz, 2)).replace(
        COMPUTE_DTYPE="float32", EPOCHS=1, **{k: v for k, v in TINY.items()
                                            if k not in ("GRID_SHAPE", "GRID_BATCH",
                                                         "GRID_SLOT_GRAPHS")})
    torch.manual_seed(0)
    return Trainer(GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg),
                   tpipe.GraphDataLoaders(cfg), cfg, log_dir=str(tmp_path / "run"), device="cpu")


def test_trainer_epoch_over_two_grid_shapes(bucket_trainer):
    trainer = bucket_trainer
    seen = {"train": [], "eval": []}
    step, evaluate = trainer.train_step, trainer.eval_step

    def record(kind, fn):
        def wrapped(batch, gen, **kw):
            seen[kind].append(tuple(batch.mask.shape[1:]))
            return fn(batch, gen, **kw)
        return wrapped

    trainer.train_step, trainer.eval_step = record("train", step), record("eval", evaluate)
    trainer.train()
    assert len(set(seen["train"])) >= 2 and len(set(seen["eval"])) >= 2, seen
    assert ckpt.exists(trainer.log_dir)
    out = trainer.test()
    assert all(np.isfinite(v) for v in out.values()) and 0.0 <= out["f1"] <= 1.0
    assert trainer.state.step == len(seen["train"])


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def serve_cfg(small_cfg):
    return port_cfg(tiny_cfg(small_cfg, LAYOUT="grid", GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=64,
                             COMPUTE_DTYPE="float32"))


def _weights(cfg, seed):
    torch.manual_seed(seed)
    return GridVoxelGNNGenerator(cfg).state_dict()


def test_router_named_models_and_swap(serve_cfg, synthetic_samples):
    wa, wb = _weights(serve_cfg, 0), _weights(serve_cfg, 1)
    local, voxel = synthetic_samples[0]
    router = RoutingServer()
    kw = dict(max_batch=4, max_delay_ms=5.0, device="cpu")
    try:
        router.add_model("a", serve_cfg, wa, **kw)
        router.add_model("b", serve_cfg, wb, **kw)
        with pytest.raises(ValueError, match="already registered"):
            router.add_model("a", serve_cfg, wa, **kw)
        ra = router.infer(local, voxel, model="a", seed=3)
        rb = router.infer(local, voxel, model="b", seed=3)
        assert not np.allclose(ra["logits"], rb["logits"])
        rdef = router.infer(local, voxel, seed=3)  # fits both grids: the first registered
        np.testing.assert_allclose(rdef["logits"], ra["logits"], rtol=0, atol=1e-6)
        assert router.swap_params("a", wb) == 1
        ra2 = router.infer(local, voxel, model="a", seed=3)
        np.testing.assert_allclose(ra2["logits"], rb["logits"], rtol=0, atol=1e-6)
        snap = router.models()
        assert snap["a"]["params_version"] == 1 and snap["b"]["params_version"] == 0
        assert snap["a"]["default"] and snap["a"]["grid_shape"] == (10, 8, 8)
        assert snap["a"]["batches_served"] == 3
        with pytest.raises(KeyError, match="no model 'nope'"):
            router.infer(local, voxel, model="nope")
        router.remove_model("a")
        assert set(router.models()) == {"b"} and router.models()["b"]["default"]
    finally:
        router.stop()
    assert router.models() == {}


def test_router_routes_by_size(serve_cfg, synthetic_samples):
    small_shape = (5, 6, 6)
    w = _weights(serve_cfg, 0)
    fits_small = next(s for s in synthetic_samples
                      if (s[1].location.max(axis=0) + 1 <= small_shape).all())
    needs_big = next(s for s in synthetic_samples
                     if (s[1].location.max(axis=0) + 1 > small_shape).any())
    router = RoutingServer()
    try:
        big = router.add_model("big", serve_cfg, w, max_batch=4, max_delay_ms=5.0, device="cpu")
        small = router.add_model("small", serve_cfg.replace(GRID_SHAPE=small_shape), w,
                                 max_batch=4, max_delay_ms=5.0, device="cpu")
        assert router.route(fits_small[1]) is small and router.route(needs_big[1]) is big
        r_small = router.infer(*fits_small, seed=5)
        assert (len(small.batch_sizes), len(big.batch_sizes)) == (1, 0)
        r_big = router.infer(*needs_big, seed=5)
        assert (len(small.batch_sizes), len(big.batch_sizes)) == (1, 1)
        assert r_small["types"].shape == (fits_small[1].x.shape[0],)
        assert r_big["types"].shape == (needs_big[1].x.shape[0],)
        assert np.isfinite(r_small["logits"]).all() and np.isfinite(r_big["logits"]).all()
    finally:
        router.stop()
    for srv in (big, small):
        assert not srv._thread.is_alive()


def test_server_swap_matches_a_fresh_server(serve_cfg, synthetic_samples):
    """What the router's swap relies on: after swap_params a server serves as one started on
    the new weights."""
    local, voxel = synthetic_samples[1]
    wa, wb = _weights(serve_cfg, 2), _weights(serve_cfg, 3)
    kw = dict(max_batch=4, max_delay_ms=5.0, device="cpu")
    router = RoutingServer()
    try:
        router.add_model("m", serve_cfg, wa, **kw)
        router.swap_params("m", wb)
        got = router.infer(local, voxel, model="m", seed=9)
        router.add_model("fresh", serve_cfg, wb, **kw)
        want = router.infer(local, voxel, model="fresh", seed=9)
    finally:
        router.stop()
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got["types"], want["types"])


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_trains_and_tests_with_grid_buckets(dataset, tmp_path, monkeypatch, capsys):
    _, npz = dataset
    build = cli._build_config
    monkeypatch.setattr(cli, "_build_config", lambda args: build(args).replace(
        **{k: v for k, v in TINY.items() if k not in ("GRID_SLOT_GRAPHS", "GRID_LOCAL_NODES")}))
    run = str(tmp_path / "run")
    common = ["--save-data-path", npz, "--log-dir", run, "--device", "cpu", "--grid-buckets",
              ",".join("x".join(map(str, b)) for b in BUCKETS), "--slot-graphs", "2",
              "--grid-local-nodes", "128"]
    cli.main(["train", "--epochs", "1"] + common)
    assert "epoch 1:" in capsys.readouterr().out and ckpt.exists(run)
    cli.main(["test", "--num-samples-to-viz", "0"] + common)
    values = [float(ln.split(":")[1]) for ln in capsys.readouterr().out.splitlines() if "_test:" in ln]
    assert len(values) == 5 and all(np.isfinite(v) for v in values)


def test_cell_packer_keeps_buildings_apart():
    """K = 6 cell packing of real-scale buildings: every building's cells in its slot carry
    its own gid, and the batch's mask counts every cell of every building.  The JAX package's
    packer counts a window's conflicting cells in uint8, so 256 conflicts read as none and a
    building lands on another one: on the same buildings its batch loses cells (ROADMAP
    Queue C item 13); the port counts in int32."""
    from building_gan_tpu.data import grid as jgrid

    from building_gan_torch.config import Configuration
    from building_gan_torch.data import generate_building_real_scale, process_building
    from building_gan_torch.data import grid as tgrid

    samples = [process_building(*generate_building_real_scale(i), Configuration(), f"{i:06d}")
               for i in range(40)]
    cells = sum(s[1].x.shape[0] for s in samples)
    cfg = Configuration(GRID_SLOT_GRAPHS=6, GRID_PACK_MODE="cell", GRID_LOCAL_NODES=512)
    slots = tgrid.plan_packing_slots(samples, cfg)
    batch = tgrid.pack_grid_multi_from_slots(samples, slots, cfg, batch_slots=len(slots))
    assert int(batch.mask.sum()) == cells
    for b, slot in enumerate(slots):
        for k, (i, (f0, y0, x0)) in enumerate(slot.placed):
            f, y, x = samples[i][1].location.astype(int).T
            assert (batch.gid[b, f + f0, y + y0, x + x0] == k).all(), (b, k)
    jcfg = JConfiguration(GRID_SLOT_GRAPHS=6, GRID_PACK_MODE="cell", GRID_LOCAL_NODES=512)
    jslots = jgrid.plan_packing_slots(samples, jcfg)
    jbatch = jgrid.pack_grid_multi_from_slots(samples, jslots, jcfg, batch_slots=len(jslots))
    assert float(np.asarray(jbatch.mask).sum()) < cells  # the reference's overlap
