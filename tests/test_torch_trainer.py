"""The port's eval step, Trainer and CLI (CPU, tests/test_train.py::tiny_cfg widths).

- ``hist_quantile`` against JAX's over histograms and quantiles (exact).
- The eval step against the JAX pieces it ports (the flax generator run
  deterministic, the Gumbel straight-through labels, ``generator_loss``
  against the deterministic critic, ``compute_metrics``) on K = 1 and K = 3
  batches, with the same weights (through the converters), z and Gumbel
  noise.  Logits within 1e-4 (atol); ``g_loss`` and its terms rtol 1e-4 /
  atol 1e-5, as tests/test_torch_losses.py; the confusion matrix and the
  per-graph F1 histogram equal; the scores computed from those equal
  matrices within 1e-6 (f32 divisions in another order).
- A CPU ``Trainer``: 2 epochs, then a new Trainer on the same log dir
  resumes from the latest checkpoint and runs epoch 3 only; the reference's
  14 tags for every epoch in the JSON-lines log (tensorboardX hidden), the
  step count continued, and ``test()`` finite.
- The CLI's synth -> preprocess -> train -> test in process on the CPU, the
  same at ``--layout edges`` and at each other ``--conv-type``
  (``--mesh-data``: tests/test_torch_parallel.py).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_gan_tpu.data import grid as jgrid
from building_gan_tpu.models import GridVoxelGNNDiscriminator as JDiscriminator
from building_gan_tpu.models import GridVoxelGNNGenerator as JGenerator
from building_gan_tpu.train import losses as JL
from building_gan_tpu.train import metrics as JM

from building_gan_torch.checkpoint import ckpt
from building_gan_torch.checkpoint.torch_compat import (
    discriminator_params_to_state_dict, generator_params_to_state_dict,
)
from building_gan_torch.cli import main as cli
from building_gan_torch.config import Configuration
from building_gan_torch.data.pipeline import GraphDataLoaders
from building_gan_torch.data.preprocess import create_dataset
from building_gan_torch.data.synthetic import write_dataset
from building_gan_torch.models import fast_infer
from building_gan_torch.models.grid_models import GridVoxelGNNDiscriminator, GridVoxelGNNGenerator
from building_gan_torch.train import metrics as TM
from building_gan_torch.train import writer as W
from building_gan_torch.train.state import create_train_state
from building_gan_torch.train.step import make_eval_step
from building_gan_torch.train.trainer import Trainer, stream_generator

from test_torch_layers import multi_batch, perturb, port_batch, port_cfg, t
from test_torch_losses import _st_gumbel_jax
from test_train import tiny_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

LOGITS_ATOL, LOSS_RTOL, LOSS_ATOL, SCORE_RTOL = 1e-4, 1e-4, 1e-5, 1e-6
REFERENCE_TAGS = (
    "g_loss_train", "d_loss_train", "g_loss_validation", "f1_score_train", "f1_score_validation",
    "f1_score_min_train", "f1_score_min_validation", "f1_score_min_weightedsum",
    "precision_score_train", "precision_score_validation", "recall_score_train",
    "recall_score_validation", "accuracy_score_train", "accuracy_score_validation",
)
TINY = dict(GENERATOR_ENCODER_REPEAT=2, GENERATOR_HIDDEN_DIM=32, LOCAL_ENCODER_HIDDEN_DIM=32,
            Z_DIM=16, GENERATOR_MLP_ENCODER_REPEAT=1, LOCAL_GRAPH_ENCODER_REPEAT=1,
            DISCRIMINATOR_ENCODER_REPEAT=2, DISCRIMINATOR_HIDDEN_DIM=32, N_CRITIC=2,
            GRID_SHAPE=(10, 8, 8), GRID_BATCH=4, GRID_SLOT_GRAPHS=3, GRID_PACK_MODE="cell",
            GRID_LOCAL_NODES=128)


def _histograms():
    rng = np.random.default_rng(4)
    one = np.zeros(32)
    one[0] = 3
    last = np.zeros(32)
    last[-1] = 5
    spread = rng.integers(0, 6, 32).astype(np.float64)
    tail = np.zeros(32)
    tail[[5, 20, 31]] = [1, 2, 40]
    return {"empty": np.zeros(32), "first": one, "last": last, "spread": spread, "tail": tail}


@pytest.mark.parametrize("q", [0.0, 0.1, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("name", list(_histograms()))
def test_hist_quantile_matches_jax(name, q):
    hist = _histograms()[name]
    assert TM.hist_quantile(hist, q) == JM.hist_quantile(hist, q)


# ---------------------------------------------------------------------------
# the eval step against the JAX pieces
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[False, True], ids=["k1", "k3_gid"])
def eval_case(request, synthetic_samples, small_cfg):
    cfg = tiny_cfg(small_cfg, LAYOUT="grid", GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=64,
                   COMPUTE_DTYPE="float32")
    gb = multi_batch(synthetic_samples, cfg) if request.param else jgrid.pack_grid(
        synthetic_samples[:3], cfg, batch_slots=3)
    rng = np.random.default_rng(9)
    shape = tuple(gb.mask.shape)
    z = rng.normal(size=shape + (cfg.Z_DIM,)).astype(np.float32)
    noise = rng.gumbel(size=shape + (7,)).astype(np.float32)
    key = jax.random.key(5)
    disc = JDiscriminator(configuration=cfg, dtype=jnp.float32)
    gen = JGenerator(configuration=cfg, dtype=jnp.float32)
    K = gb.graphs_per_slot
    gid = None if gb.gid is None else jnp.asarray(gb.gid)

    def pieces(pg, pd, z, noise):
        logits, _, _ = gen.apply({"params": pg}, gb, z, deterministic=True, rngs={"gumbel": key})
        label_hard, _ = _st_gumbel_jax(logits, noise)
        g_loss, aux = JL.generator_loss(
            lambda lbl: disc.apply({"params": pd}, gb, lbl, deterministic=True),
            gb, logits, label_hard, cfg)
        m = JM.compute_metrics(jnp.asarray(gb.type), jnp.argmax(label_hard, -1),
                               jnp.asarray(gb.mask), None, jnp.asarray(gb.graph_mask), gid=gid,
                               num_graphs_per_slot=K)
        return {"logits": logits, "g_loss": g_loss, **aux, **m}

    with jax.default_matmul_precision("highest"):
        pd = perturb(jax.jit(lambda k: disc.init({"params": k}, gb, jax.nn.one_hot(
            jnp.asarray(gb.type), 7), deterministic=True))(key)["params"], 3, 0.05)
        pg = perturb(jax.jit(lambda k: gen.init({"params": k, "gumbel": k}, gb, jnp.array(z),
                                                deterministic=True))(key)["params"], 4, 0.05)
        out = jax.jit(pieces)(pg, pd, jnp.array(z), jnp.array(noise))
    want = jax.device_get(out)

    tcfg = port_cfg(cfg)
    tgen, tdisc = GridVoxelGNNGenerator(tcfg), GridVoxelGNNDiscriminator(tcfg)
    tgen.load_state_dict(generator_params_to_state_dict(pg, tcfg))
    tdisc.load_state_dict(discriminator_params_to_state_dict(pd, tcfg))
    state = create_train_state(tcfg, tgen, tdisc, device="cpu")
    return tcfg, state, port_batch(gb), t(z), t(noise), want


def test_eval_step_matches_jax_pieces(eval_case):
    tcfg, state, batch, z, noise, want = eval_case
    got = make_eval_step(tcfg, state)(batch, z=z, gumbel_noise=noise)
    with torch.no_grad():  # the eval step's own generator forward, for its logits
        logits, _, _ = fast_infer.infer(state.generator, fast_infer.prepare(state.generator, tcfg),
                                        batch, z, noise)
    np.testing.assert_allclose(logits.numpy(), want["logits"], rtol=0, atol=LOGITS_ATOL)
    for k in ("g_loss", "g_loss_adv", "g_loss_label", "g_loss_ratio", "g_loss_ratio_void",
              "g_loss_far"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                   err_msg=k)
    assert np.array_equal(got["confusion_matrix"].numpy(), want["confusion_matrix"])
    assert np.array_equal(got["per_graph_f1_hist"].numpy(), want["per_graph_f1_hist"])
    for k in ("f1", "f1_min", "precision", "recall", "accuracy"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=SCORE_RTOL, err_msg=k)
    np.testing.assert_allclose(got["per_graph_f1"].numpy(), want["per_graph_f1"], rtol=SCORE_RTOL)
    assert not any(v.requires_grad for v in got.values())


def test_eval_step_draws_from_the_generator_and_refreshes_its_weights(eval_case):
    tcfg, state, batch, _, _, _ = eval_case
    step = make_eval_step(tcfg, state)
    a = step(batch, torch.Generator().manual_seed(1))
    b = step(batch, torch.Generator().manual_seed(1))
    assert a["g_loss"].item() == b["g_loss"].item()
    with torch.no_grad():
        for p in state.generator.encoder.parameters():
            p.add_(0.5)
    try:
        assert step(batch, torch.Generator().manual_seed(1))["g_loss"].item() == a["g_loss"].item()
        state.step += 1  # the packed hourglass weights follow the step count
        assert step(batch, torch.Generator().manual_seed(1))["g_loss"].item() != a["g_loss"].item()
    finally:
        with torch.no_grad():
            for p in state.generator.encoder.parameters():
                p.sub_(0.5)
        state.step -= 1


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer_data")
    cfg = Configuration(DATA_PATH=str(root / "raw"), SAVE_DATA_PATH=str(root / "npz"))
    write_dataset(cfg.DATA_PATH, 16, seed=5)
    create_dataset(cfg, verbose=False)
    return cfg.DATA_PATH, cfg.SAVE_DATA_PATH


def _trainer(npz, log_dir, epochs, seed):
    cfg = Configuration(SAVE_DATA_PATH=npz, COMPUTE_DTYPE="float32", EPOCHS=epochs,
                        CKPT_LATEST_INTERVAL=1, **TINY)
    torch.manual_seed(seed)
    return Trainer(GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg), GraphDataLoaders(cfg),
                   cfg, log_dir=log_dir, device="cpu")


def test_trainer_trains_resumes_and_tests(processed, tmp_path, monkeypatch, capsys):
    _, npz = processed
    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # the JSON-lines log
    log_dir = str(tmp_path / "run")
    first = _trainer(npz, log_dir, epochs=2, seed=0)
    per_epoch = first.dataloaders.train_dataloader.num_packs_per_epoch()
    first.train()
    assert first.state.step == 2 * per_epoch
    latest = ckpt.read_meta(log_dir, ckpt.LATEST_STATE_FILE, ckpt.LATEST_META_FILE)
    assert latest["epoch_start"] == 3 and latest["is_latest"]
    best = ckpt.read_meta(log_dir)
    assert set(best) >= {"epoch_start", "epoch_end", "best_f1_score", "f1_score_min_weightedsum"}
    assert "Scalar log: building_gan_torch.train.writer.JsonlScalarWriter" in capsys.readouterr().out

    second = _trainer(npz, log_dir, epochs=3, seed=1)
    assert "Loaded latest states" in capsys.readouterr().out
    assert second.state.step == 2 * per_epoch and second.meta["epoch_start"] == 3
    for a, b in zip(first.generator.state_dict().values(), second.generator.state_dict().values()):
        assert torch.equal(a, b)
    second.train()
    out = capsys.readouterr().out
    assert "epoch 3:" in out and "epoch 1:" not in out and "epoch 2:" not in out
    assert second.state.step == 3 * per_epoch

    records = W.read_jsonl(log_dir)
    scalars = [(r["tag"], r["step"]) for r in records if r["kind"] == "scalar"]
    for tag in REFERENCE_TAGS:
        assert sorted(s for g, s in scalars if g == tag) == [1, 2, 3], tag
    assert all(np.isfinite(r["value"]) for r in records if r["kind"] == "scalar")
    assert {"f1_score_p10_train", "f1_score_median_validation", "recall_office_train"} <= {
        g for g, _ in scalars}
    assert any(r["kind"] == "histogram" and r["tag"] == "per_graph_f1_train" for r in records)
    assert any(r["kind"] == "text" and r["tag"] == "configuration/SEED" for r in records)

    result = second.test()
    assert set(result) == {"f1", "f1_min", "precision", "recall", "accuracy"}
    assert all(np.isfinite(v) for v in result.values())
    assert "f1_score_test:" in capsys.readouterr().out
    second.test(num_samples_to_viz=1)  # the scores, then one test building rendered
    out = capsys.readouterr().out
    assert "f1_score_test:" in out and "rendered 1 test samples: a (3, " in out


def test_best_checkpoint_when_latest_is_not_ahead(processed, tmp_path, capsys):
    _, npz = processed
    log_dir = str(tmp_path / "run")
    trainer = _trainer(npz, log_dir, epochs=1, seed=0)
    ckpt.save_states(log_dir, trainer.state, {"epoch_start": 4, "best_f1_score": 0.5})
    trainer.state.step = 99
    with torch.no_grad():
        for p in trainer.generator.parameters():
            p.add_(1.0)
    ckpt.save_latest(log_dir, trainer.state, {"epoch_start": 4, "is_latest": True})
    resumed = _trainer(npz, log_dir, epochs=1, seed=1)
    assert "Loaded best states" in capsys.readouterr().out
    assert resumed.state.step == 0 and resumed.meta["best_f1_score"] == 0.5
    ckpt.save_latest(log_dir, trainer.state, {"epoch_start": 5, "is_latest": True})
    resumed = _trainer(npz, log_dir, epochs=1, seed=1)
    assert "Loaded latest states" in capsys.readouterr().out
    assert resumed.state.step == 99
    for a, b in zip(trainer.generator.parameters(), resumed.generator.parameters()):
        assert torch.equal(a, b)


def test_writer_is_tensorboard_where_installed(tmp_path, monkeypatch):
    pytest.importorskip("tensorboardX")
    writer = W.make_writer(str(tmp_path))
    assert type(writer).__module__.startswith("tensorboardX")
    writer.close()
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    writer = W.make_writer(str(tmp_path))
    writer.add_scalar("a", 1.5, 2)
    writer.add_text("b", "x")
    writer.close()
    assert W.read_jsonl(str(tmp_path)) == [
        {"kind": "scalar", "tag": "a", "step": 2, "value": 1.5},
        {"kind": "text", "tag": "b", "step": None, "text": "x"},
    ]


def test_stream_generators_do_not_collide():
    first = {}
    for seed, epoch in [(777, e) for e in range(1, 6)] + [(777 + 999, e) for e in range(1, 6)] + [
            (777 + 31337, None), (778, 1), (777, 0)]:
        first[(seed, epoch)] = torch.randint(0, 2**62, (4,), generator=stream_generator(
            seed, epoch, "cpu")).tolist()
    assert len({tuple(v) for v in first.values()}) == len(first)
    assert first[(777, 3)] == torch.randint(0, 2**62, (4,), generator=stream_generator(
        777, 3, "cpu")).tolist()


def test_trainer_runs_on_the_card_unless_asked_for_the_cpu(processed):
    _, npz = processed
    cfg = Configuration(SAVE_DATA_PATH=npz, COMPUTE_DTYPE="float32", **TINY)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg),
                    GraphDataLoaders(cfg), cfg, log_dir="unused")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.fixture
def tiny_cli(monkeypatch):
    build = cli._build_config
    monkeypatch.setattr(cli, "_build_config", lambda args: build(args).replace(
        **{k: v for k, v in TINY.items() if k not in ("GRID_SLOT_GRAPHS", "GRID_LOCAL_NODES")}))
    return cli


def test_cli_synth_preprocess_train_test(tiny_cli, tmp_path, capsys):
    raw, npz, run = (str(tmp_path / d) for d in ("raw", "npz", "run"))
    tiny_cli.main(["synth", "--data-path", raw, "--num", "16", "--seed", "2"])
    tiny_cli.main(["preprocess", "--data-path", raw, "--save-data-path", npz])
    common = ["--save-data-path", npz, "--log-dir", run, "--device", "cpu",
              "--compute-dtype", "float32", "--slot-graphs", "3", "--grid-local-nodes", "128"]
    tiny_cli.main(["train", "--epochs", "2"] + common)
    out = capsys.readouterr().out
    assert "processed 16 buildings" in out and "epoch 1:" in out and "epoch 2:" in out
    assert ckpt.exists(run)
    tiny_cli.main(["test", "--num-samples-to-viz", "0"] + common)
    out = capsys.readouterr().out
    assert "Loaded best states" in out
    values = {ln.split(":")[0].strip(): float(ln.split(":")[1]) for ln in out.splitlines()
              if ln.strip().endswith(tuple("0123456789")) and "_test:" in ln}
    assert set(values) == {"f1_score_test", "f1_score_min_test", "precision_score_test",
                           "recall_score_test", "accuracy_score_test"}
    assert all(np.isfinite(v) for v in values.values())
    # the JAX package's defaults (COMPUTE_DTYPE bfloat16, GP_DTYPE compute) run too
    run16 = str(tmp_path / "run_bf16")
    default = ["--save-data-path", npz, "--log-dir", run16, "--device", "cpu", "--slot-graphs", "3",
               "--grid-local-nodes", "128"]
    tiny_cli.main(["train", "--epochs", "1"] + default)
    assert "epoch 1:" in capsys.readouterr().out and ckpt.exists(run16)
    tiny_cli.main(["test", "--num-samples-to-viz", "0"] + default)
    out = capsys.readouterr().out
    assert all(np.isfinite(float(ln.split(":")[1])) for ln in out.splitlines() if "_test:" in ln)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tiny_cli.main(["train", "--save-data-path", npz, "--log-dir", run,
                           "--compute-dtype", "float32"])
    tiny_cli.main(["test", "--num-samples-to-viz", "2"] + common)
    assert "rendered 2 test samples: a (3, " in capsys.readouterr().out


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    """16 synthetic buildings, processed."""
    root = tmp_path_factory.mktemp("cli_data")
    raw, npz = str(root / "raw"), str(root / "npz")
    cli.main(["synth", "--data-path", raw, "--num", "16", "--seed", "2"])
    cli.main(["preprocess", "--data-path", raw, "--save-data-path", npz])
    return npz


@pytest.mark.parametrize("flags", [
    ["--layout", "edges", "--pack-graphs", "4", "--pack-voxel-nodes", "2048",
     "--pack-voxel-edges", "16384", "--pack-local-nodes", "256", "--pack-local-edges", "2048"],
    ["--conv-type", "GCNCONV"],
    ["--conv-type", "GRAPHCONV"],
    ["--conv-type", "GATV2CONV"],
], ids=lambda v: v[1])
def test_cli_trains_and_tests_edges_and_other_convs(flags, cli_data, tiny_cli, tmp_path, capsys):
    """The packed edge-list layout and the other convs of the registry: one epoch, then test,
    on the CPU, at the default compute dtype (bf16)."""
    run = str(tmp_path / "run")
    common = ["--save-data-path", cli_data, "--log-dir", run, "--device", "cpu"] + flags
    tiny_cli.main(["train", "--epochs", "1"] + common)
    out = capsys.readouterr().out
    assert "epoch 1:" in out and ckpt.exists(run)
    tiny_cli.main(["test", "--num-samples-to-viz", "0"] + common)
    out = capsys.readouterr().out
    values = [float(ln.split(":")[1]) for ln in out.splitlines() if "_test:" in ln]
    assert len(values) == 5 and all(np.isfinite(v) for v in values)
