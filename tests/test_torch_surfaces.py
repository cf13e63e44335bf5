"""The reference's other surfaces in the port, held against the JAX package (CPU).

- ``analyze_dataset``: the same stats dict and printout; a corrupted FAR raises in both.
- ``convert_reference_processed`` (and the CLI's ``ingest``): NPZ files bit-equal to the
  JAX package's and to the buildings' own, from the same stand-in ``.pt`` pairs
  (``chip_smoke.write_reference_pairs``: classes ``LocalGraphData`` / ``VoxelGraphData``
  under ``src.data`` with the reference's attribute names), each package resolving the
  pickled classes without them.
- ``render_raw_building`` (the CLI's ``viz``): the PNG decoded equals JAX's pixel for pixel.
- ``visualize_one`` with stub trainers whose ``generate`` returns the same one-hot labels
  in both packages, 3 restarts: the same F1 and a pixel-equal figure, grid and edges.
- ``evaluate_qualitatively``: the same sample picks as JAX, a CHW uint8 strip of the
  same shape.
- ``sanity``: the same building as JAX's loader (``DATA_POINT``); the CLI trains 2
  epochs, writes no checkpoint and records the best epoch's image; ``test
  --num-samples-to-viz 2`` renders a strip.
- ``set_seed``, ``SPLIT_RATIOS``, ``trace``; the roofline model equal to JAX's field for
  field at the config of record, a tiny config and ``HOURGLASS_MIN_CHANNELS`` 8.

Synthetic buildings at test sizes: a render takes ~2-3 s for ~150 voxels.
"""

import dataclasses
import json
import os
import sys
import types
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from building_gan_tpu.config import Configuration as JConfiguration
from building_gan_tpu.data import ingest as jingest
from building_gan_tpu.data.pipeline import GraphDataLoaders as JLoaders
from building_gan_tpu.train import metrics as JM
from building_gan_tpu.utils import analyze as janalyze
from building_gan_tpu.utils import roofline as jroofline
from building_gan_tpu.viz import raw as jraw
from building_gan_tpu.viz import render as jrender

from building_gan_torch.checkpoint import ckpt
from building_gan_torch.cli import main as cli
from building_gan_torch.config import Configuration
from building_gan_torch.data import ingest, preprocess
from building_gan_torch.data.pipeline import GraphDataLoaders
from building_gan_torch.data.synthetic import write_dataset
from building_gan_torch.train import writer as W
from building_gan_torch.utils import analyze, profiling, roofline
from building_gan_torch.viz import render

from chip_smoke import write_reference_pairs
from test_torch_trainer import TINY
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

REF_MODULES = ("src", "src.data", "building_gan", "building_gan.src", "building_gan.src.data")


@pytest.fixture(scope="module")
def raw_root(tmp_path_factory):
    """10 synthetic buildings (seed 0: 72-300 voxels) as raw JSON, and processed."""
    root = tmp_path_factory.mktemp("surfaces")
    raw_dir, npz = str(root / "raw"), str(root / "npz")
    write_dataset(raw_dir, 10, seed=0)
    preprocess.create_dataset(Configuration(DATA_PATH=raw_dir, SAVE_DATA_PATH=npz), verbose=False)
    return raw_dir, npz


# ---------------------------------------------------------------------------
# analyze
# ---------------------------------------------------------------------------


def test_analyze_matches_jax(raw_root, capsys):
    raw_dir, _ = raw_root
    got = analyze.analyze_dataset(Configuration(DATA_PATH=raw_dir))
    printed = capsys.readouterr().out
    want = janalyze.analyze_dataset(JConfiguration(DATA_PATH=raw_dir))
    assert got == want
    assert printed == capsys.readouterr().out
    cli.main(["analyze", "--data-path", raw_dir])
    assert capsys.readouterr().out == printed and "FAR invariant       : OK" in printed


def test_analyze_far_violation_raises_in_both(tmp_path):
    root = str(tmp_path / "raw")
    write_dataset(root, 2, seed=9)
    gp = os.path.join(root, "global_graph_data", "graph_global_000001.json")
    with open(gp) as f:
        g = json.load(f)
    g["far"] = g["far"] * 2 + 1
    with open(gp, "w") as f:
        json.dump(g, f)
    with pytest.raises(AssertionError, match="FAR invariant violated"):
        analyze.analyze_dataset(Configuration(DATA_PATH=root))
    with pytest.raises(AssertionError, match="FAR invariant violated"):
        janalyze.analyze_dataset(JConfiguration(DATA_PATH=root))


# ---------------------------------------------------------------------------
# ingest
# ---------------------------------------------------------------------------


class _ForeignModules:
    """Hide (and afterwards restore) the modules the reference's classes are pickled under."""

    def __enter__(self):
        self.saved = {k: sys.modules.pop(k) for k in REF_MODULES if k in sys.modules}
        return self

    def __exit__(self, *exc):
        for k in REF_MODULES:
            sys.modules.pop(k, None)
        sys.modules.update(self.saved)


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "compressed"])
def test_ingest_matches_jax_bit_for_bit(synthetic_samples, tmp_path, compress):
    src = tmp_path / "pt"
    src.mkdir()
    samples = [(dataclasses.replace(l, data_number=f"{i:06d}"),
                dataclasses.replace(v, data_number=f"{i:06d}"))
               for i, (l, v) in enumerate(synthetic_samples[:4])]
    write_reference_pairs(str(src), samples)
    dst_t, dst_j = str(tmp_path / "torch"), str(tmp_path / "jax")
    with _ForeignModules():  # each package resolves the pickled classes on its own
        flags = ["--compress"] if compress else []
        cli.main(["ingest", "--src", str(src), "--dst", dst_t] + flags)
    with _ForeignModules():
        assert jingest.convert_reference_processed(str(src), dst_j, compress=compress) == 4
    assert sorted(os.listdir(dst_t)) == sorted(os.listdir(dst_j)) and len(os.listdir(dst_t)) == 8
    for f in os.listdir(dst_j):
        with np.load(os.path.join(dst_t, f)) as a, np.load(os.path.join(dst_j, f)) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in b.files:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (f, k)
    # and the buildings' own NPZ files, bit for bit (far comes back from x's far column)
    src_npz = tmp_path / "original"
    src_npz.mkdir()
    for local, voxel in samples:
        preprocess.save_local(str(src_npz / f"{local.data_number}_local.npz"), local)
        preprocess.save_voxel(str(src_npz / f"{local.data_number}_voxel.npz"), voxel)
    for f in os.listdir(dst_t):
        with np.load(os.path.join(dst_t, f)) as a, np.load(str(src_npz / f)) as b:
            for k in b.files:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (f, k)


def test_ingest_stub_resolution_without_reference_package(tmp_path):
    with _ForeignModules():
        mod = types.ModuleType("src.data")
        sys.modules["src"], sys.modules["src.data"] = types.ModuleType("src"), mod

        class LocalGraphData:
            pass

        LocalGraphData.__module__, LocalGraphData.__qualname__ = "src.data", "LocalGraphData"
        mod.LocalGraphData = LocalGraphData
        obj = LocalGraphData()
        obj.payload = np.arange(3)
        path = str(tmp_path / "x.pt")
        torch.save(obj, path)
    with _ForeignModules():
        ingest._install_reference_stubs()
        loaded = torch.load(path, map_location="cpu", weights_only=False)
        assert type(loaded).__name__ == "LocalGraphData"
        assert issubclass(type(loaded), ingest._RefStub)
        np.testing.assert_array_equal(loaded.payload, np.arange(3))


# ---------------------------------------------------------------------------
# renders
# ---------------------------------------------------------------------------


def _pixels(img) -> np.ndarray:
    if isinstance(img, str):
        with Image.open(img) as f:
            return np.array(f.convert("RGBA"))
    return np.array(img.convert("RGBA"))


def test_raw_render_matches_jax(raw_root, tmp_path):
    raw_dir, _ = raw_root
    out_t, out_j = str(tmp_path / "torch"), str(tmp_path / "jax")
    cli.main(["viz", "--data-path", raw_dir, "--num", "1", "--out-dir", out_t])  # building 0
    [want] = jraw.render_raw_samples(JConfiguration(DATA_PATH=raw_dir), [0], out_j)
    got = os.path.join(out_t, os.path.basename(want))
    a, b = _pixels(got), _pixels(want)
    assert a.shape == b.shape and np.array_equal(a, b)


def _labels(voxel, restarts, seed=0):
    """``restarts`` typed label vectors of a building: the truth with a share flipped."""
    rng = np.random.default_rng(seed)
    out = []
    for share in np.linspace(0.6, 0.2, restarts):
        t = voxel.types.copy()
        flip = rng.random(t.shape[0]) < share
        t[flip] = rng.integers(0, 7, int(flip.sum()))
        out.append(t)
    return out


def _label_planes(labels, voxel, cfg):
    """One-hot label_hard as each layout's generator returns it: (1, F, Y, X, 7) on the grid,
    (PACK_VOXEL_NODES, 7) on edges (the building's nodes first)."""
    if cfg.LAYOUT == "grid":
        plane = np.zeros((1,) + tuple(cfg.GRID_SHAPE) + (7,), np.float32)
        loc = voxel.location
        plane[0, loc[:, 0], loc[:, 1], loc[:, 2], labels] = 1.0
        return plane
    plane = np.zeros((cfg.PACK_VOXEL_NODES, 7), np.float32)
    plane[np.arange(labels.shape[0]), labels] = 1.0
    return plane


class _Stub:
    """A trainer whose ``generate`` returns fixed label planes in turn, as JAX or torch arrays."""

    def __init__(self, cfg, planes, to):
        self.configuration, self.device = cfg, torch.device("cpu")
        self.planes, self.to, self.calls = planes, to, 0

    def generate(self, batch, key_or_generator):
        out = self.to(self.planes[self.calls % len(self.planes)])
        self.calls += 1
        return None, out, None


@pytest.mark.parametrize("layout", ["grid", "edges"])
def test_visualize_one_matches_jax(synthetic_samples, layout):
    kw = dict(LAYOUT=layout, PACK_GRAPHS=4, PACK_LOCAL_NODES=256, PACK_LOCAL_EDGES=2048,
              PACK_VOXEL_NODES=2048, PACK_VOXEL_EDGES=16384)
    cfg, jcfg = Configuration(**kw), JConfiguration(**kw)
    jlocal, jvoxel = min(synthetic_samples, key=lambda s: s[1].x.shape[0])
    local = preprocess.LocalGraph(**dataclasses.asdict(jlocal))
    voxel = preprocess.VoxelGraph(**dataclasses.asdict(jvoxel))
    labels = _labels(voxel, 3)
    planes = [_label_planes(t, voxel, cfg) for t in labels]

    port = _Stub(cfg, planes, torch.as_tensor)
    types_gen, f1 = render.best_of_k(port, local, voxel, iteration=3)
    n = voxel.x.shape[0]
    f1s = [float(JM.compute_metrics(jnp.array(voxel.types), jnp.array(t), jnp.ones(n),
                                    jnp.zeros(n, jnp.int32), jnp.ones(1))["f1"]) for t in labels]
    best = next(i for i, v in enumerate(f1s) if v == max(f1s))
    assert port.calls == 3 and f1 == pytest.approx(f1s[best], abs=1e-6)
    assert np.array_equal(types_gen, labels[best])

    got = render.visualize_one(_Stub(cfg, planes, torch.as_tensor), local, voxel, 4, iteration=3,
                               title="train at epoch: 4\n", to_pil=True)
    want = jrender.visualize_one(_Stub(jcfg, planes, jnp.asarray), jlocal, jvoxel, 4, iteration=3,
                                 title="train at epoch: 4\n", to_pil=True)
    a, b = _pixels(got), _pixels(want)
    assert a.shape == b.shape and np.array_equal(a, b)


def test_evaluate_qualitatively_picks_as_jax(synthetic_samples, monkeypatch):
    """The same buildings, titles and restarts in the same order as JAX, and a CHW uint8
    strip of the same shape (the drawing itself is held above)."""
    picks = {"torch": [], "jax": []}

    def recorder(tag):
        def visualize_one(trainer, local, voxel, epoch, iteration=1, show=False, title=None,
                          to_pil=False):
            picks[tag].append((voxel.data_number, epoch, iteration, title))
            return Image.new("RGB", (6, 4), (len(picks[tag]) * 20, 0, 0))
        return visualize_one

    monkeypatch.setattr(render, "visualize_one", recorder("torch"))
    monkeypatch.setattr(jrender, "visualize_one", recorder("jax"))
    samples = [(dataclasses.replace(l, data_number=f"{i}"), dataclasses.replace(v, data_number=f"{i}"))
               for i, (l, v) in enumerate(synthetic_samples)]

    def trainer(val, test):
        loader = lambda s: None if s is None else SimpleNamespace(samples=s)  # noqa: E731
        return SimpleNamespace(dataloaders=SimpleNamespace(
            train_dataloader=loader(samples[:5]), validation_dataloader=loader(val),
            test_dataloader=loader(test)))

    for val, test, kw in (
        (samples[5:7], samples[7:], dict(epoch=3, num_samples_to_viz=2)),
        (samples[5:7], samples[7:], dict(epoch=None, num_samples_to_viz=3, use_test_dataset=True)),
        (None, None, dict(epoch=12, num_samples_to_viz=2, iteration=2)),
    ):
        got = render.evaluate_qualitatively(trainer(val, test), to_tensor=True, **kw)
        want = jrender.evaluate_qualitatively(trainer(val, test), to_tensor=True, **kw)
        assert picks["torch"] == picks["jax"] and picks["torch"]
        assert got.dtype == np.uint8 and got.shape == want.shape and np.array_equal(got, want)
        picks["torch"].clear()
        picks["jax"].clear()


def test_render_needs_matplotlib_and_says_so(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib is not installed.*--num-samples-to-viz 0"):
        render.evaluate_qualitatively(SimpleNamespace(), epoch=1)


# ---------------------------------------------------------------------------
# sanity and test through the CLI
# ---------------------------------------------------------------------------


@pytest.fixture
def tiny_cli(monkeypatch):
    build = cli._build_config
    monkeypatch.setattr(cli, "_build_config", lambda args: build(args).replace(
        **{k: v for k, v in TINY.items() if k not in ("GRID_SLOT_GRAPHS", "GRID_LOCAL_NODES")}))
    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # the JSON-lines log
    return cli


def test_sanity_picks_jaxs_building_and_records_an_image(raw_root, tiny_cli, tmp_path, capsys):
    _, npz = raw_root
    for point in (None, 3):
        got = GraphDataLoaders(Configuration(SAVE_DATA_PATH=npz, DATA_POINT=point,
                                             sanity_checking=True))
        want = JLoaders(JConfiguration(SAVE_DATA_PATH=npz, DATA_POINT=point, sanity_checking=True))
        assert [v.data_number for _, v in got.train_dataloader.samples] == [
            v.data_number for _, v in want.train_dataloader.samples]
        assert len(got.train_dataloader.samples) == 1 and got.test_dataloader is None

    run = str(tmp_path / "sanity")
    tiny_cli.main(["sanity", "--save-data-path", npz, "--log-dir", run, "--device", "cpu",
                   "--epochs", "2", "--compute-dtype", "float32"])
    out = capsys.readouterr().out
    assert "epoch 1:" in out and "epoch 2:" in out and "render skipped" not in out
    assert not ckpt.exists(run) and not os.path.exists(os.path.join(run, ckpt.LATEST_STATE_FILE))
    records = W.read_jsonl(run)
    steps = {r["step"] for r in records if r["kind"] == "scalar" and r["tag"] == "f1_score_train"}
    assert steps == {1, 2}
    images = [r for r in records if r["kind"] == "image"]
    assert len(images) == out.count("Best f1 score updated") >= 1
    for r in images:
        img = np.load(os.path.join(run, r["file"]))
        assert r["tag"] == f"epoch_{r['step']}" and img.dtype == np.uint8
        assert list(img.shape) == r["shape"] and img.shape[0] == 3 and img.shape[1] > 200


def test_cli_test_renders_test_samples(raw_root, tiny_cli, tmp_path, capsys, monkeypatch):
    _, npz = raw_root
    common = ["--save-data-path", npz, "--log-dir", str(tmp_path / "run"), "--device", "cpu",
              "--compute-dtype", "float32"]
    tiny_cli.main(["test", "--num-samples-to-viz", "2"] + common)
    out = capsys.readouterr().out
    assert "f1_score_test:" in out and "rendered 2 test samples: a (3, " in out
    with monkeypatch.context() as m:  # the scores come first, then the error naming the
        m.setitem(sys.modules, "PIL", None)  # package and the flag
        with pytest.raises(ImportError, match="PIL is not installed.*--num-samples-to-viz 0"):
            tiny_cli.main(["test", "--num-samples-to-viz", "1"] + common)
    assert "f1_score_test:" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# small pieces
# ---------------------------------------------------------------------------


def test_set_seed_and_split_ratios_agree_with_jax(capsys):
    assert Configuration().SPLIT_RATIOS == JConfiguration().SPLIT_RATIOS == (0.65, 0.25, 0.10)
    cfg = Configuration(TRAIN_SPLIT_RATIO=0.5, VALIDATION_SPLIT_RATIO=0.3, TEST_SPLIT_RATIO=0.2)
    assert cfg.SPLIT_RATIOS == JConfiguration(TRAIN_SPLIT_RATIO=0.5, VALIDATION_SPLIT_RATIO=0.3,
                                              TEST_SPLIT_RATIO=0.2).SPLIT_RATIOS
    for seed in (None, 5):
        Configuration.set_seed(seed)
        got = capsys.readouterr().out.splitlines()
        draws = (np.random.rand(3).tolist(), torch.rand(2).tolist())
        JConfiguration.set_seed(seed)
        want = capsys.readouterr().out.splitlines()
        assert np.random.rand(3).tolist() == draws[0]  # numpy seeded alike
        assert got[:3] == want[:3] and "torch.Generator" in got[3]
        torch.manual_seed(777 if seed is None else seed)
        assert torch.rand(2).tolist() == draws[1]


def test_trace_writes_a_trace_file(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        torch.ones(64).mul(2).sum()
    with open(os.path.join(log_dir, profiling.TRACE_FILE)) as f:
        assert "traceEvents" in json.load(f)


def test_runtime_calculator_is_the_trainers(capsys):
    from building_gan_torch.train import trainer

    assert trainer.runtime_calculator is profiling.runtime_calculator
    assert profiling.runtime_calculator(lambda: 3)() == 3
    assert "took" in capsys.readouterr().out


ROOFLINE_CONFIGS = {
    "record": {},
    "tiny": {k: v for k, v in TINY.items() if not k.startswith("GRID")},
    "min_channels_8": {"HOURGLASS_MIN_CHANNELS": 8},
}


@pytest.mark.parametrize("name", sorted(ROOFLINE_CONFIGS))
def test_roofline_matches_jax(name):
    kw = ROOFLINE_CONFIGS[name]
    cfg, jcfg = Configuration(**kw), JConfiguration(**kw)
    for fn in ("generator_fwd_work", "discriminator_fwd_work", "step_work_per_cell"):
        got = dataclasses.asdict(getattr(roofline, fn)(cfg))
        assert got == dataclasses.asdict(getattr(jroofline, fn)(jcfg)), fn
    for peaks in (roofline.PUBLISHED_PEAKS_H100, jroofline.MEASURED_PEAKS_V5E):
        got = roofline.attainable(cfg, 107 * 1584, 128334, dict(peaks))
        assert got == jroofline.attainable(jcfg, 107 * 1584, 128334, dict(peaks))
    default = roofline.attainable(cfg, 107 * 1584, 128334)
    assert default["peaks"] is roofline.PUBLISHED_PEAKS_H100
    assert roofline.PUBLISHED_PEAKS_H100["trans_gops"] == pytest.approx(16 * 132 * 1.98)
