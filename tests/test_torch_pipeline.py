"""The port's data pipeline against the JAX package's (CPU).

- NPZ files written by either package load in the other, arrays equal.
- ``write_dataset`` writes the same raw JSON, and ``create_dataset`` the
  same NPZ arrays (in one process and with a pool of two), as JAX's.
- ``GraphDataLoaders`` on one processed dir, grid layout, K = 1 and K = 3
  (and K = 3 stacked two packs a group): the same split indices, and over
  two epochs the same packs in the same order, every array equal.
- ``grid_compatible``, ``stack_grid_batches`` and ``null_like`` against JAX.
- ``GraphDataLoaders`` at ``LAYOUT="edges"``: ``PackedBatch``es equal to
  the JAX package's packs, in the same order, unstacked and two a group.
- ``prefetch`` hands a producer's exception to the consumer.  (Grid buckets:
  tests/test_torch_buckets.py.)

Everything here is integer bookkeeping or a copy of float32 arrays, so every
comparison is exact (tolerance 0).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from building_gan_tpu.config import Configuration as JConfiguration
from building_gan_tpu.data import grid as jgrid
from building_gan_tpu.data import pipeline as jpipe
from building_gan_tpu.data import preprocess as jpre
from building_gan_tpu.data import synthetic as jsyn

from building_gan_torch.data import grid as tgrid
from building_gan_torch.data import pipeline as tpipe
from building_gan_torch.data import preprocess as tpre
from building_gan_torch.data import synthetic as tsyn
from building_gan_torch.data.batching import PackedBatch
from building_gan_torch.data.grid import GridBatch

from test_torch_layers import port_batch, port_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

N_BUILDINGS = 16


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """(raw dir, processed dir) written by the JAX package."""
    root = tmp_path_factory.mktemp("jax_data")
    cfg = JConfiguration(DATA_PATH=str(root / "raw"), SAVE_DATA_PATH=str(root / "npz"))
    jsyn.write_dataset(cfg.DATA_PATH, N_BUILDINGS, seed=3)
    jpre.create_dataset(cfg, verbose=False, use_native=False)
    return cfg.DATA_PATH, cfg.SAVE_DATA_PATH


def _assert_graphs_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


def _assert_batches_equal(jb, tb: GridBatch, where=""):
    for f in dataclasses.fields(GridBatch):
        j, t = getattr(jb, f.name), getattr(tb, f.name)
        assert (j is None) == (t is None), f"{where} {f.name}"
        if j is not None:
            j = np.asarray(j)
            assert j.shape == tuple(t.shape), f"{where} {f.name}"
            assert np.array_equal(j, t.numpy()), f"{where} {f.name}"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_written_by_either_package_loads_in_the_other(writer, dataset, tmp_path):
    _, npz = dataset
    save = {"jax": (jpre.save_local, jpre.save_voxel), "port": (tpre.save_local, tpre.save_voxel)}
    load = {"jax": (jpre.load_local, jpre.load_voxel), "port": (tpre.load_local, tpre.load_voxel)}
    reader = "port" if writer == "jax" else "jax"
    for num in ("000000", "000005"):
        local = jpre.load_local(os.path.join(npz, f"{num}_local.npz"))
        voxel = jpre.load_voxel(os.path.join(npz, f"{num}_voxel.npz"))
        for compress in (False, True):
            lp, vp = str(tmp_path / f"{num}_{compress}_l.npz"), str(tmp_path / f"{num}_{compress}_v.npz")
            save[writer][0](lp, local, compress=compress)
            save[writer][1](vp, voxel, compress=compress)
            _assert_graphs_equal(load[reader][0](lp), local)
            _assert_graphs_equal(load[reader][1](vp), voxel)


@pytest.mark.parametrize("workers", [0, 2])
def test_write_and_create_dataset_match_jax(workers, dataset, tmp_path):
    raw, npz = dataset
    cfg = port_cfg(JConfiguration(DATA_PATH=str(tmp_path / "raw"), SAVE_DATA_PATH=str(tmp_path / "npz")))
    tsyn.write_dataset(cfg.DATA_PATH, N_BUILDINGS, seed=3)
    for sub in ("global_graph_data", "local_graph_data", "voxel_data"):
        names = sorted(os.listdir(os.path.join(raw, sub)))
        assert names == sorted(os.listdir(os.path.join(cfg.DATA_PATH, sub)))
        for name in names:
            with open(os.path.join(raw, sub, name)) as a, open(os.path.join(cfg.DATA_PATH, sub, name)) as b:
                assert json.load(a) == json.load(b), name
    assert tpre.create_dataset(cfg, verbose=False, workers=workers) == N_BUILDINGS
    assert sorted(os.listdir(npz)) == sorted(os.listdir(cfg.SAVE_DATA_PATH))
    for name in os.listdir(npz):
        load = jpre.load_local if name.endswith("_local.npz") else jpre.load_voxel
        _assert_graphs_equal(load(os.path.join(cfg.SAVE_DATA_PATH, name)), load(os.path.join(npz, name)))


def _loader_cfgs(npz, K):
    jcfg = JConfiguration(SAVE_DATA_PATH=npz, GRID_SHAPE=(10, 8, 8), GRID_BATCH=3, SEED=11,
                          GRID_SLOT_GRAPHS=K, GRID_PACK_MODE="cell", GRID_LOCAL_NODES=64 * K)
    return jcfg, port_cfg(jcfg)


@pytest.mark.parametrize("K,groups", [(1, None), (3, None), (3, 2)], ids=["k1", "k3", "k3_stacked2"])
def test_loaders_match_jax(K, groups, dataset):
    _, npz = dataset
    jcfg, tcfg = _loader_cfgs(npz, K)
    jl = jpipe.GraphDataLoaders(jcfg, n_device_batches=groups)
    tl = tpipe.GraphDataLoaders(tcfg, n_device_batches=groups)
    for split in ("train", "validation", "test"):
        j, t = getattr(jl, f"{split}_indices"), getattr(tl, f"{split}_indices")
        assert np.array_equal(j, t), split
        assert len(t) > 0, split
    n_batches = 0
    for epoch in range(2):
        for split in ("train", "validation", "test"):
            jb = list(getattr(jl, f"{split}_dataloader"))
            tb = list(getattr(tl, f"{split}_dataloader"))
            assert len(jb) == len(tb) > 0, (epoch, split)
            for i, (a, b) in enumerate(zip(jb, tb)):
                _assert_batches_equal(a, b, f"epoch {epoch} {split} batch {i}")
            n_batches += len(tb)
    assert tl.train_dataloader.num_packs_per_epoch() == jl.train_dataloader.num_packs_per_epoch()
    assert n_batches >= 6


def test_grid_compatible_matches_jax(dataset):
    _, npz = dataset
    voxel = tpre.load_voxel(os.path.join(npz, "000002_voxel.npz"))
    dropped_edge = dataclasses.replace(voxel, edge_index=voxel.edge_index[:, 1:])
    loc = voxel.location.copy()
    loc[1] = loc[0]
    duplicated = dataclasses.replace(voxel, location=loc)
    cases = [(voxel, (10, 8, 8)), (voxel, (2, 2, 2)), (dropped_edge, (10, 8, 8)),
             (duplicated, (10, 8, 8))]
    got = [tgrid.grid_compatible(v, s) for v, s in cases]
    assert got == [jgrid.grid_compatible(v, s) for v, s in cases]
    assert got == [True, False, False, False]


def test_stack_and_null_like_match_jax(dataset):
    _, npz = dataset
    jcfg, _ = _loader_cfgs(npz, 3)
    samples = [(jpre.load_local(os.path.join(npz, f"{i:06d}_local.npz")),
                jpre.load_voxel(os.path.join(npz, f"{i:06d}_voxel.npz"))) for i in range(6)]
    packs = [jgrid.pack_grid_multi(samples[i:i + 3], jcfg, batch_slots=2) for i in (0, 3)]
    _assert_batches_equal(jgrid.stack_grid_batches(packs),
                          tgrid.stack_grid_batches([port_batch(p) for p in packs]))
    _assert_batches_equal(jpipe.null_like(packs[0]), tpipe.null_like(port_batch(packs[0])))


def test_prefetch_hands_on_the_producers_error():
    def items():
        yield 1
        yield 2
        raise ValueError("packing failed")

    got = []
    with pytest.raises(ValueError, match="packing failed"):
        for item in tpipe.prefetch(items()):
            got.append(item)
    assert got == [1, 2]
    assert list(tpipe.prefetch(iter(range(5)), size=1)) == list(range(5))


@pytest.mark.parametrize("groups", [None, 2], ids=["packs", "stacked2"])
def test_edge_loaders_match_jax(groups, dataset):
    """LAYOUT="edges": the loaders yield PackedBatches, the JAX package's packs bit for bit
    in the same order over two epochs (packs of at most 3 buildings)."""
    _, npz = dataset
    jcfg = JConfiguration(SAVE_DATA_PATH=npz, SEED=11, LAYOUT="edges", PACK_GRAPHS=3,
                          PACK_LOCAL_NODES=256, PACK_LOCAL_EDGES=2048, PACK_VOXEL_NODES=2048,
                          PACK_VOXEL_EDGES=16384)
    jl = jpipe.GraphDataLoaders(jcfg, n_device_batches=groups)
    tl = tpipe.GraphDataLoaders(port_cfg(jcfg), n_device_batches=groups)
    assert np.array_equal(jl.test_indices, tl.test_indices)
    n_batches = 0
    for epoch in range(2):
        for split in ("train", "validation", "test"):
            jb = list(getattr(jl, f"{split}_dataloader"))
            tb = list(getattr(tl, f"{split}_dataloader"))
            assert len(jb) == len(tb) > 0, (epoch, split)
            for a, b in zip(jb, tb):
                assert isinstance(b, PackedBatch)
                for f in dataclasses.fields(PackedBatch):
                    j, tt = np.asarray(getattr(a, f.name)), getattr(b, f.name)
                    assert j.shape == tuple(tt.shape) and np.array_equal(j, tt.numpy()), f.name
                    assert tt.device.type == "cpu"
            n_batches += len(tb)
    assert tl.train_dataloader.num_packs_per_epoch() == jl.train_dataloader.num_packs_per_epoch()
    assert n_batches >= 6


def test_loader_yields_cpu_tensors(dataset):
    _, npz = dataset
    _, tcfg = _loader_cfgs(npz, 3)
    batch = next(iter(tpipe.GraphDataLoaders(tcfg).train_dataloader))
    assert all(t is None or t.device.type == "cpu" for t in vars(batch).values())
    assert batch.gid.dtype == torch.int64 and batch.graphs_per_slot == 3
