"""The transformer generator (``GENERATOR_ARCH="transformer"``): the port against the JAX package (CPU).

Same seeded numpy inputs and the same weights on both sides (flax params
through ``transformer_params_to_state_dict``), tests/test_train.py::tiny_cfg
widths with 2 blocks of 4 heads:

- ``GridSelfAttention`` and ``TransformerBlock`` against flax (the block
  deterministic and with given dropout masks);
- the generator at K = 1, deterministic and with the port's Philox masks
  given to the flax side's dropout calls, at f32 and at the JAX default bf16;
- at K = 3 (buildings packed into shared slots) the port's logits against
  the JAX generator run on each building alone at K = 1, every cell's z
  carried to its packed position: the port keeps the buildings of a slot
  apart, where the JAX model lets them attend to and pool over each other
  (ROADMAP Queue C item 11), so JAX's own K = 3 run is not the reference;
- a train step and an eval step against the GATCONV critic's fused route
  (its plain version on the CPU), and the state-dict converter's keys;
- ``train --generator-arch transformer`` for one epoch and ``test`` on the CPU.

Tolerances: rtol 1e-4 / atol 1e-5 for the attention and the block (as
tests/test_torch_layers.py); rtol 1e-4 / atol 1e-4 for logits
(tests/test_torch_generator.py); bf16 by tests/test_torch_bf16_models.py's
rules (1)-(3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from building_gan_tpu.data import grid as jgrid
from building_gan_tpu.models import transformer as jtr
from building_gan_tpu.ops.dropout import FastDropout

from building_gan_torch.checkpoint.torch_compat import transformer_params_to_state_dict
from building_gan_torch.cli import main as cli
from building_gan_torch.checkpoint import ckpt
from building_gan_torch.data import grid as tgrid
from building_gan_torch.models import transformer as ttr
from building_gan_torch.models.fast_infer import fused_route
from building_gan_torch.models.grid_models import GridVoxelGNNDiscriminator
from building_gan_torch.ops import dropout as drop
from building_gan_torch.ops import gat_train as gt
from building_gan_torch.ops import hourglass as hg
from building_gan_torch.train.state import create_train_state
from building_gan_torch.train.step import make_eval_step, make_train_step

from test_torch_bf16_models import LOGIT_RTOL, assert_as_accurate, assert_not_f32, assert_rel
from test_torch_layers import perturb, port_batch, port_cfg, t
from test_train import tiny_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

RTOL, ATOL = 1e-4, 1e-5  # attention and block
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-4  # logits


def masks_in_dtype(masks, scale):
    """Flax interceptor: the i-th FastDropout call returns x * masks[i] * scale, the mask and
    the scale in x's dtype, as FastDropout scales (the port's masks given to flax)."""
    it = iter(masks)

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, FastDropout) and context.method_name == "__call__":
            x = args[0]
            return x * jnp.asarray(next(it), x.dtype) * jnp.asarray(scale, x.dtype)
        return next_fun(*args, **kwargs)

    return nn.intercept_methods(interceptor)


def site_masks(B, R, dim, keys, rate):
    """The port's keep masks of each dropout site, (B, R, dim) float numpy."""
    levels = drop.drop_levels(rate)
    return [drop.keep_mask((B, R, dim), k, levels).numpy().astype(np.float32) for k in keys]


@pytest.fixture(scope="module")
def tcfg_j(small_cfg):
    return tiny_cfg(small_cfg, LAYOUT="grid", GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=64,
                    GENERATOR_ARCH="transformer", TRANSFORMER_LAYERS=2, TRANSFORMER_HEADS=4,
                    COMPUTE_DTYPE="float32")


def _block_case(synthetic_samples, tcfg_j, seed):
    gb = jgrid.pack_grid(synthetic_samples[:3], tcfg_j, batch_slots=3)
    B = gb.mask.shape[0]
    mask = np.asarray(gb.mask).reshape(B, -1)
    x = np.random.default_rng(seed).normal(size=mask.shape + (32,)).astype(np.float32)
    return x, mask


def test_self_attention_matches_flax(synthetic_samples, tcfg_j, highest_precision):
    x, mask = _block_case(synthetic_samples, tcfg_j, 1)
    mask[2, :] = 0.0  # an empty slot: every key masked, the row stays finite
    attn = jtr.GridSelfAttention(dim=32, heads=4)
    params = perturb(attn.init(jax.random.key(1), jnp.asarray(x), jnp.asarray(mask))["params"], 2)
    want = attn.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    mine = ttr.GridSelfAttention(32, 4)
    sd = transformer_params_to_state_dict({"block_0": {"attn": params}}, None)
    mine.load_state_dict({k[len("block_0.attn."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = mine(t(x), t(mask))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("training", [False, True], ids=["deterministic", "dropout"])
def test_transformer_block_matches_flax(training, synthetic_samples, tcfg_j, highest_precision):
    x, mask = _block_case(synthetic_samples, tcfg_j, 3)
    block = jtr.TransformerBlock(dim=32, heads=4, dropout_rate=0.2)
    params = perturb(block.init(jax.random.key(2), jnp.asarray(x), jnp.asarray(mask), True)["params"],
                     4)
    keys = drop.draw_keys(2, torch.Generator().manual_seed(5))
    masks = site_masks(*mask.shape, 32, keys, 0.2)
    interceptor = masks_in_dtype(masks, 256.0 / 205.0) if training else nn.intercept_methods(
        lambda f, a, k, c: f(*a, **k))
    with interceptor:
        want = block.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask), not training,
                           rngs={"dropout": jax.random.key(0)})
    mine = ttr.TransformerBlock(32, 4, dropout_rate=0.2)
    sd = transformer_params_to_state_dict({"block_0": params}, None)
    mine.load_state_dict({k[len("block_0."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = mine(t(x), t(mask), torch.float32, keys=keys if training else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _flax_generator(cfg, gb, z, seed):
    gen = jtr.GridTransformerGenerator(configuration=cfg)
    key = jax.random.key(seed)
    params = jax.jit(lambda: gen.init({"params": key, "gumbel": key}, gb, jnp.asarray(z),
                                      deterministic=True))()["params"]
    return gen, perturb(params, seed + 1, scale=0.05)


def _port_generator(cfg, params):
    tcfg = port_cfg(cfg)
    model = ttr.GridTransformerGenerator(tcfg)
    model.load_state_dict(transformer_params_to_state_dict(params, tcfg))
    return tcfg, model


@pytest.fixture(scope="module")
def k1_case(synthetic_samples, tcfg_j):
    """The flax transformer (perturbed params) on a K = 1 batch and the port's, loaded."""
    gb = jgrid.pack_grid(synthetic_samples[:3], tcfg_j, batch_slots=3)
    z = np.random.default_rng(6).normal(size=tuple(gb.mask.shape) + (tcfg_j.Z_DIM,)).astype(
        np.float32)
    with jax.default_matmul_precision("highest"):
        gen, params = _flax_generator(tcfg_j, gb, z, 7)
    return gb, z, gen, params


def test_converter_round_trip(k1_case, tcfg_j):
    """Every flax leaf lands on a port parameter of its shape, and back."""
    _, _, _, params = k1_case
    tcfg, model = _port_generator(tcfg_j, params)
    sd = transformer_params_to_state_dict(params, tcfg)
    assert set(sd) == set(model.state_dict())
    assert {"block_1.attn.qkv.weight", "block_0.norm2.weight", "pos_proj.bias",
            "matched_enc_0.0.weight", "mlp_enc_1.1.bias", "dec_3.0.weight", "dec_out.weight"} <= set(sd)
    flat = {"/".join(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    back = {k: v.numpy() for k, v in model.state_dict().items()}
    assert len(flat) == len(back)
    for k, v in flat.items():
        parts = k.split("/")
        mods, leaf = parts[:-1], parts[-1]
        if mods[0].startswith(("matched_enc_", "mlp_enc_", "dec_")) and mods[0] != "dec_out":
            mods[1] = {"dense": "0", "norm": "1"}[mods[1]]
        name = ".".join(mods + ["weight" if leaf in ("kernel", "scale") else leaf])
        np.testing.assert_array_equal(back[name].T if leaf == "kernel" else back[name], v, err_msg=k)


@pytest.mark.parametrize("training", [False, True], ids=["deterministic", "dropout"])
def test_generator_at_k1_matches_flax(training, k1_case, tcfg_j):
    gb, z, gen, params = k1_case
    tcfg, model = _port_generator(tcfg_j, params)
    batch = port_batch(gb)
    B, R = batch.mask.shape[0], int(np.prod(batch.grid_shape))
    keys = drop.draw_keys(model.dropout_sites, torch.Generator().manual_seed(8))
    masks = site_masks(B, R, tcfg.GENERATOR_HIDDEN_DIM, keys, tcfg.ENCODER_DROPOUT_RATE)
    noise = np.random.default_rng(9).gumbel(size=tuple(gb.mask.shape) + (7,)).astype(np.float32)
    ctx = masks_in_dtype(masks, 256.0 / 205.0) if training else nn.intercept_methods(
        lambda f, a, k, c: f(*a, **k))
    with jax.default_matmul_precision("highest"), ctx:
        want, _, _ = gen.apply({"params": params}, gb, jnp.asarray(z), deterministic=not training,
                               rngs={"gumbel": jax.random.key(0), "dropout": jax.random.key(0)})
    with torch.no_grad():
        got, hard, _ = model(batch, t(z), gumbel_noise=t(noise), deterministic=not training,
                             keys=keys)
    assert got.dtype == torch.float32 and got.shape == tuple(np.shape(want))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MODEL_RTOL, atol=MODEL_ATOL)
    np.testing.assert_array_equal(hard.argmax(-1).numpy(), np.argmax(got.numpy() + noise, -1))


def test_generator_at_k1_bfloat16_matches_flax(k1_case, tcfg_j):
    """At the JAX default COMPUTE_DTYPE: the rules of tests/test_torch_bf16_models.py on
    the real cells (padded cells' logits are never read)."""
    gb, z, _, params = k1_case
    cfg = tcfg_j.replace(COMPUTE_DTYPE="bfloat16")
    gen = jtr.GridTransformerGenerator(configuration=cfg)

    def logits(g):
        return g.apply({"params": params}, gb, jnp.asarray(z), deterministic=True,
                       rngs={"gumbel": jax.random.key(0)})[0]

    want = np.asarray(jax.jit(lambda: logits(gen))())
    with jax.default_matmul_precision("highest"):
        want32 = np.asarray(jax.jit(lambda: logits(gen.clone(dtype=jnp.float32)))())
    batch = port_batch(gb)
    got = {}
    for dt in ("bfloat16", "float32"):
        tcfg, model = _port_generator(cfg.replace(COMPUTE_DTYPE=dt), params)
        assert model.compute_dtype == getattr(torch, dt)
        with torch.no_grad():
            got[dt] = model(batch, t(z), gumbel_noise=torch.zeros(want.shape))[0].numpy()
    real = np.asarray(gb.mask) > 0
    assert_rel(got["bfloat16"][real], want[real], LOGIT_RTOL, "logits")
    assert_as_accurate(got["bfloat16"][real], want[real], want32[real], "logits")
    assert_not_f32(got["bfloat16"][real], got["float32"][real], "logits")


def test_generator_at_k3_matches_flax_on_each_building_alone(synthetic_samples, tcfg_j):
    """Up to three buildings a slot (cell packing: they touch): each building's logits in the
    port equal the JAX generator's on that building alone in its own slot, its cells' z
    carried to where the packer placed them."""
    samples = synthetic_samples
    cfg3 = port_cfg(tcfg_j).replace(GRID_SLOT_GRAPHS=3, GRID_PACK_MODE="cell")
    slots = tgrid.plan_packing_slots(samples, cfg3)
    assert len(slots) < len(samples) and max(len(s.placed) for s in slots) == 3
    batch3 = tgrid.pack_grid_multi_from_slots(samples, slots, cfg3, batch_slots=len(slots))
    gb1 = jgrid.pack_grid(samples, tcfg_j, batch_slots=len(samples))
    rng = np.random.default_rng(10)
    z1 = rng.normal(size=tuple(gb1.mask.shape) + (tcfg_j.Z_DIM,)).astype(np.float32)
    z3 = np.zeros(tuple(batch3.mask.shape) + (tcfg_j.Z_DIM,), np.float32)
    cells = []
    for b, slot in enumerate(slots):
        for i, (f0, y0, x0) in slot.placed:
            f, y, x = samples[i][1].location.astype(int).T
            z3[b, f + f0, y + y0, x + x0] = z1[i, f, y, x]
            cells.append((b, i, (f + f0, y + y0, x + x0), (f, y, x)))
    with jax.default_matmul_precision("highest"):
        gen, params = _flax_generator(tcfg_j, gb1, z1, 11)
        want, _, _ = gen.apply({"params": params}, gb1, jnp.asarray(z1), deterministic=True,
                               rngs={"gumbel": jax.random.key(0)})
    _, model = _port_generator(tcfg_j, params)
    with torch.no_grad():
        got, _, _ = model(batch3, t(z3), gumbel_noise=torch.zeros(tuple(batch3.mask.shape) + (7,)))
    want = np.asarray(want)
    for b, i, p3, p1 in cells:
        np.testing.assert_allclose(got[b][p3].numpy(), want[i][p1], rtol=MODEL_RTOL,
                                   atol=MODEL_ATOL, err_msg=f"building {i} in slot {b}")


@pytest.fixture(scope="module")
def step_state(synthetic_samples, tcfg_j):
    cfg = port_cfg(tcfg_j).replace(GRID_SLOT_GRAPHS=3, GRID_PACK_MODE="cell")
    slots = tgrid.plan_packing_slots(synthetic_samples, cfg)
    batch = tgrid.pack_grid_multi_from_slots(synthetic_samples, slots, cfg, batch_slots=len(slots))
    torch.manual_seed(0)
    state = create_train_state(cfg, ttr.GridTransformerGenerator(cfg),
                               GridVoxelGNNDiscriminator(cfg), device="cpu")
    return cfg, batch, state


def test_train_and_eval_steps_run_the_transformer_plain_and_the_critic_fused(step_state):
    cfg, batch, state = step_state
    assert (fused_route(state.generator), fused_route(state.discriminator)) == (False, True)
    assert state.generator.dropout_sites == 2 * cfg.TRANSFORMER_LAYERS
    before = {k: v.clone() for k, v in state.generator.state_dict().items()}
    counts = (hg.launches.value, gt.fwd_launches.value, gt.bwd_launches.value,
              gt.bytes_launches.value)
    m = make_train_step(cfg, state)(batch, torch.Generator().manual_seed(1))
    e = make_eval_step(cfg, state)(batch, torch.Generator().manual_seed(2))
    assert (hg.launches.value, gt.fwd_launches.value, gt.bwd_launches.value,
            gt.bytes_launches.value) == counts  # CPU: every wrapper's plain version
    for k, v in {**m, **e}.items():
        assert torch.isfinite(v).all(), k
    assert float(m["confusion_matrix"].sum()) == float(batch.mask.sum())
    moved = {k for k, v in state.generator.state_dict().items() if not torch.equal(v, before[k])}
    assert moved == set(before)  # every generator parameter moves


def test_cli_trains_and_tests_the_transformer(tmp_path, monkeypatch, capsys):
    build = cli._build_config
    monkeypatch.setattr(cli, "_build_config", lambda args: build(args).replace(
        GENERATOR_HIDDEN_DIM=16, LOCAL_ENCODER_HIDDEN_DIM=16, Z_DIM=8, TRANSFORMER_LAYERS=1,
        GENERATOR_MLP_ENCODER_REPEAT=1, LOCAL_GRAPH_ENCODER_REPEAT=1, DISCRIMINATOR_HIDDEN_DIM=16,
        DISCRIMINATOR_ENCODER_REPEAT=2, N_CRITIC=1, GRID_SHAPE=(10, 8, 8), GRID_BATCH=8))
    raw, npz, run = (str(tmp_path / d) for d in ("raw", "npz", "run"))
    cli.main(["synth", "--data-path", raw, "--num", "12", "--seed", "3"])
    cli.main(["preprocess", "--data-path", raw, "--save-data-path", npz])
    common = ["--save-data-path", npz, "--log-dir", run, "--device", "cpu",
              "--generator-arch", "transformer"]
    cli.main(["train", "--epochs", "1"] + common)
    assert "epoch 1:" in capsys.readouterr().out and ckpt.exists(run)
    assert "block_0.attn.qkv.weight" in torch.load(f"{run}/{ckpt.STATE_FILE}",
                                                   weights_only=True)["generator"]
    cli.main(["test", "--num-samples-to-viz", "0"] + common)
    values = [float(ln.split(":")[1]) for ln in capsys.readouterr().out.splitlines() if "_test:" in ln]
    assert len(values) == 5 and all(np.isfinite(v) for v in values)
