"""The port's checkpoints (CPU), and the JAX package's trained checkpoint run through the port.

- Round trip: the generator and critic weights, both Adam states (moments and
  step counts) and the step count come back bit for bit, onto the device
  asked for; the writes leave no temporary file.
- Quirk Q11: ``patch_epoch_start`` moves only the resume cursor; the weights
  file is untouched.
- The in-repo JAX checkpoint ``runs/ref10k-rbgfull-seed42`` (hidden 128,
  repeat 7, trained on synthetic buildings on a (10, 6, 6) grid,
  ``scripts/eval_checkpoint.py``'s settings), read through flax and converted
  with ``checkpoint/torch_compat.py``, loaded into a CPU ``Trainer``:
  ``Trainer.test`` on 190 default-scale synthetic buildings the checkpoint
  never saw (``write_dataset`` seed 7; it was trained on seed 0's) gives
  macro F1 >= 0.98 (TRAINING.md records 0.9936-0.9969 for the four ref10k
  seeds on their own test splits).  On one 16-slot test pack, the port's
  eval step against the JAX pieces with the same z and Gumbel noise, at this
  full width: logits within 1e-4 (atol), ``g_loss`` and its terms rtol 1e-4 /
  atol 1e-5, the confusion matrix equal, the scores within 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from building_gan_tpu.config import Configuration as JConfiguration
from building_gan_tpu.data.pipeline import GraphDataLoaders as JGraphDataLoaders
from building_gan_tpu.models import GridVoxelGNNDiscriminator as JDiscriminator
from building_gan_tpu.models import GridVoxelGNNGenerator as JGenerator
from building_gan_tpu.train import losses as JL
from building_gan_tpu.train import metrics as JM

from building_gan_torch.checkpoint import ckpt
from building_gan_torch.checkpoint.torch_compat import (
    discriminator_params_to_state_dict, generator_params_to_state_dict,
)
from building_gan_torch.config import Configuration
from building_gan_torch.data.pipeline import GraphDataLoaders
from building_gan_torch.data.preprocess import create_dataset
from building_gan_torch.data.synthetic import write_dataset
from building_gan_torch.models import fast_infer
from building_gan_torch.models.grid_models import GridVoxelGNNDiscriminator, GridVoxelGNNGenerator
from building_gan_torch.train.state import create_train_state
from building_gan_torch.train.step import make_eval_step
from building_gan_torch.train.trainer import Trainer

from test_torch_layers import port_batch, port_cfg
from test_torch_losses import _st_gumbel_jax
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF10K = os.path.join(ROOT, "runs", "ref10k-rbgfull-seed42", "states.msgpack")
TEST_F1_FLOOR = 0.98
LOGITS_ATOL, LOSS_RTOL, LOSS_ATOL, SCORE_RTOL = 1e-4, 1e-4, 1e-5, 1e-6
TINY = dict(GENERATOR_ENCODER_REPEAT=2, GENERATOR_HIDDEN_DIM=32, LOCAL_ENCODER_HIDDEN_DIM=32,
            Z_DIM=16, GENERATOR_MLP_ENCODER_REPEAT=1, LOCAL_GRAPH_ENCODER_REPEAT=1,
            DISCRIMINATOR_ENCODER_REPEAT=2, DISCRIMINATOR_HIDDEN_DIM=32, COMPUTE_DTYPE="float32")


def _state(seed, steps):
    """A tiny CPU TrainState whose Adam states have taken ``steps`` updates of seeded grads."""
    cfg = Configuration(**TINY)
    torch.manual_seed(seed)
    state = create_train_state(cfg, GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg),
                               device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        for module, opt in ((state.generator, state.opt_g), (state.discriminator, state.opt_d)):
            for p in module.parameters():
                p.grad = torch.randn(p.shape, generator=gen)
            opt.step()
    state.opt_g.param_groups[0]["lr"] = 1.25e-4  # as set_g_lr leaves it mid-run
    state.step = steps
    return state


def _assert_same(a, b):
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("latest", [False, True], ids=["best", "latest"])
def test_round_trip_is_bit_exact(latest, tmp_path):
    saved, fresh = _state(0, 3), _state(1, 1)
    meta = {"epoch_start": 4, "best_f1_score": 0.25}
    save, load = (ckpt.save_latest, ckpt.load_latest) if latest else (ckpt.save_states, ckpt.load_states)
    save(str(tmp_path), saved, meta)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    state, got_meta = load(str(tmp_path), fresh, map_location="cpu")
    assert state is fresh and got_meta == meta and fresh.step == 3
    for name in ("generator", "discriminator", "opt_g", "opt_d"):
        _assert_same(getattr(fresh, name).state_dict(), getattr(saved, name).state_dict())
    step_counts = [s["step"] for s in fresh.opt_g.state_dict()["state"].values()]
    assert all(t.device.type == "cpu" and t.item() == 3 for t in step_counts)
    assert ckpt.load_states(str(tmp_path / "empty"), fresh) is None


def test_patch_epoch_start_moves_only_the_cursor(tmp_path):
    log_dir = str(tmp_path)
    state = _state(0, 2)
    meta = {"epoch_start": 3, "epoch_end": 11, "best_f1_score": 0.5, "f1_score_train": 0.4}
    ckpt.save_states(log_dir, state, meta)
    with open(os.path.join(log_dir, ckpt.STATE_FILE), "rb") as f:
        weights = f.read()
    assert ckpt.exists(log_dir)
    ckpt.patch_epoch_start(log_dir, 7)
    with open(os.path.join(log_dir, ckpt.STATE_FILE), "rb") as f:
        assert f.read() == weights
    assert ckpt.read_meta(log_dir) == {**meta, "epoch_start": 7}
    fresh = _state(1, 1)
    _, got = ckpt.load_states(log_dir, fresh)
    assert got["epoch_start"] == 7 and fresh.step == 2
    _assert_same(fresh.generator.state_dict(), state.generator.state_dict())


# ---------------------------------------------------------------------------
# the JAX package's trained checkpoint, through the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref10k(tmp_path_factory):
    root = tmp_path_factory.mktemp("ref10k_split")
    jcfg = JConfiguration(DATA_PATH=str(root / "raw"), SAVE_DATA_PATH=str(root / "npz"),
                          GRID_SHAPE=(10, 6, 6), GRID_LOCAL_NODES=64, GRID_BATCH=16,
                          COMPUTE_DTYPE="float32", TRAIN_SPLIT_RATIO=0.05,
                          VALIDATION_SPLIT_RATIO=0.0)
    cfg = port_cfg(jcfg)
    write_dataset(cfg.DATA_PATH, 200, seed=7)
    create_dataset(cfg, verbose=False)
    with open(REF10K, "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    return jcfg, cfg, raw


def test_ref10k_checkpoint_tests_above_the_floor(ref10k, tmp_path):
    _, cfg, raw = ref10k
    gen, disc = GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg)
    gen.load_state_dict(generator_params_to_state_dict(raw["params_g"], cfg))
    disc.load_state_dict(discriminator_params_to_state_dict(raw["params_d"], cfg))
    assert tuple(gen.encoder.module_0.lin.weight.shape) == (64, 128)  # conv_0 lin/kernel (128, 64)
    loaders = GraphDataLoaders(cfg)
    assert len(loaders.test_indices) == 190
    trainer = Trainer(gen, disc, loaders, cfg, log_dir=str(tmp_path / "run"), device="cpu")
    out = trainer.test()
    assert out["f1"] >= TEST_F1_FLOOR, out
    assert all(np.isfinite(v) for v in out.values())


def test_ref10k_eval_step_matches_jax_pieces(ref10k):
    jcfg, cfg, raw = ref10k
    gb = next(iter(JGraphDataLoaders(jcfg).test_dataloader))
    rng = np.random.default_rng(3)
    shape = tuple(gb.mask.shape)
    z = rng.normal(size=shape + (jcfg.Z_DIM,)).astype(np.float32)
    noise = rng.gumbel(size=shape + (7,)).astype(np.float32)
    gen, disc = JGenerator(configuration=jcfg, dtype=jnp.float32), JDiscriminator(configuration=jcfg,
                                                                                    dtype=jnp.float32)
    key = jax.random.key(0)

    def pieces(pg, pd, z, noise):
        logits, _, _ = gen.apply({"params": pg}, gb, z, deterministic=True, rngs={"gumbel": key})
        label_hard, _ = _st_gumbel_jax(logits, noise)
        g_loss, aux = JL.generator_loss(
            lambda lbl: disc.apply({"params": pd}, gb, lbl, deterministic=True),
            gb, logits, label_hard, jcfg)
        m = JM.compute_metrics(jnp.asarray(gb.type), jnp.argmax(label_hard, -1),
                               jnp.asarray(gb.mask), None, jnp.asarray(gb.graph_mask))
        return {"logits": logits, "g_loss": g_loss, **aux, **m}

    with jax.default_matmul_precision("highest"):
        want = jax.device_get(jax.jit(pieces)(raw["params_g"], raw["params_d"], z, noise))

    tgen, tdisc = GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg)
    tgen.load_state_dict(generator_params_to_state_dict(raw["params_g"], cfg))
    tdisc.load_state_dict(discriminator_params_to_state_dict(raw["params_d"], cfg))
    state = create_train_state(cfg, tgen, tdisc, device="cpu")
    batch, tz, tnoise = port_batch(gb), torch.from_numpy(z), torch.from_numpy(noise)
    got = make_eval_step(cfg, state)(batch, z=tz, gumbel_noise=tnoise)
    with torch.no_grad():  # the eval step's own generator forward, for its logits
        logits, _, _ = fast_infer.infer(tgen, fast_infer.prepare(tgen, cfg), batch, tz, tnoise)
    np.testing.assert_allclose(logits.numpy(), want["logits"], rtol=0, atol=LOGITS_ATOL)
    for k in ("g_loss", "g_loss_adv", "g_loss_label", "g_loss_ratio", "g_loss_ratio_void",
              "g_loss_far"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                   err_msg=k)
    assert np.array_equal(got["confusion_matrix"].numpy(), want["confusion_matrix"])
    for k in ("f1", "f1_min", "precision", "recall", "accuracy"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=SCORE_RTOL, err_msg=k)
    assert got["f1"].item() >= TEST_F1_FLOOR
