"""The port's critic, and both models in training mode, vs flax (f32, CPU).

Weights cross through the port's converters (flax params -> reference torch
state_dict -> ``load_state_dict``).  In training mode the port draws its
hourglass dropout masks from Philox keys; the flax side gets the same masks
through ``flax.linen.intercept_methods`` on its ``FastDropout`` calls (the
package's own modules run unchanged; its threefry bits cannot be replayed
in torch).  The fused CPU path (``models/fast_train.py``, the plain stack
with the same keys) is held against the same flax outputs.

Tolerance rtol 1e-4 / atol 1e-4, as tests/test_torch_generator.py: MLP
blocks, a 4-layer hourglass narrowing to 8-channel GraphNorm layers and the
decoders, summed in other orders by XLA and torch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from building_gan_tpu.data import grid as jgrid
from building_gan_tpu.models import GridVoxelGNNDiscriminator as JDiscriminator
from building_gan_tpu.models import GridVoxelGNNGenerator as JGenerator
from building_gan_tpu.ops.dropout import FastDropout

from building_gan_torch.checkpoint.torch_compat import (
    discriminator_params_to_state_dict, generator_params_to_state_dict,
)
from building_gan_torch.models import fast_train as FT
from building_gan_torch.models.grid_models import GridVoxelGNNDiscriminator, GridVoxelGNNGenerator
from building_gan_torch.ops import dropout as drop

from test_torch_layers import multi_batch, perturb, port_batch, port_cfg, t
from test_train import tiny_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

RTOL, ATOL = 1e-4, 1e-4


def given_masks(masks, scale):
    """Flax interceptor: the i-th FastDropout call returns x * masks[i] * scale."""
    it = iter(masks)

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, FastDropout) and context.method_name == "__call__":
            return args[0] * jnp.asarray(next(it)) * scale
        return next_fun(*args, **kwargs)

    return nn.intercept_methods(interceptor)


def port_masks(encoder, B, R, keys, rate):
    """The port's keep masks of each hourglass layer (B, R, co_l) as float numpy."""
    levels = drop.drop_levels(rate)
    return [
        drop.keep_mask((B, R, co), keys[l], levels, width=encoder.hidden_dim).numpy().astype(np.float32)
        for l, co in enumerate(encoder.channels)
    ]


@pytest.fixture(scope="module")
def case(synthetic_samples, small_cfg):
    with jax.default_matmul_precision("highest"):
        cfg = tiny_cfg(small_cfg, LAYOUT="grid", GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=64,
                       COMPUTE_DTYPE="float32")
        out = {}
        for multi in (False, True):
            gb = multi_batch(synthetic_samples, cfg) if multi else jgrid.pack_grid(
                synthetic_samples[:3], cfg, batch_slots=3
            )
            rng = np.random.default_rng(3)
            label = np.eye(7, dtype=np.float32)[rng.integers(0, 7, tuple(gb.mask.shape))]
            z = rng.normal(size=tuple(gb.mask.shape) + (cfg.Z_DIM,)).astype(np.float32)
            key = jax.random.key(1)
            disc = JDiscriminator(configuration=cfg, dtype=jnp.float32)
            pd = disc.init({"params": key, "dropout": key}, gb, jnp.array(label), deterministic=True)
            gen = JGenerator(configuration=cfg, dtype=jnp.float32)
            pg = gen.init({"params": key, "gumbel": key}, gb, jnp.array(z), deterministic=True)
            out[multi] = (gb, label, z, disc, perturb(pd["params"], 5, scale=0.05), gen,
                          perturb(pg["params"], 6, scale=0.05))
        return cfg, out


def _port_models(cfg, pd, pg):
    tcfg = port_cfg(cfg)
    tdisc = GridVoxelGNNDiscriminator(tcfg)
    tdisc.load_state_dict(discriminator_params_to_state_dict(pd, tcfg))
    tgen = GridVoxelGNNGenerator(tcfg)
    tgen.load_state_dict(generator_params_to_state_dict(pg, tcfg))
    return tcfg, tdisc, tgen


def test_critic_converter_keys_fill_the_port_state_dict(case):
    cfg, out = case
    _, _, _, _, pd, _, pg = out[False]
    tcfg, tdisc, _ = _port_models(cfg, pd, pg)
    sd = discriminator_params_to_state_dict(pd, tcfg)
    assert set(sd) == set(tdisc.state_dict())
    assert {"mlp_encoder.0.weight", "mlp_encoder.2.bias", "decoder.6.weight",
            "encoder.module_1.mean_scale"} <= set(sd)


@pytest.mark.parametrize("training", [False, True], ids=["deterministic", "dropout"])
@pytest.mark.parametrize("multi", [False, True], ids=["k1", "k3_gid"])
def test_critic_matches_flax(case, multi, training):
    cfg, out = case
    gb, label, _, disc, pd, _, pg = out[multi]
    tcfg, tdisc, _ = _port_models(cfg, pd, pg)
    batch = port_batch(gb)
    B, R = batch.mask.shape[0], int(np.prod(batch.grid_shape))
    keys = drop.draw_keys(len(tdisc.encoder.channels), torch.Generator().manual_seed(2))
    with jax.default_matmul_precision("highest"):
        if training:
            masks = port_masks(tdisc.encoder, B, R, keys, cfg.ENCODER_DROPOUT_RATE)
            with given_masks(masks, 256.0 / 205.0):
                want = disc.apply({"params": pd}, gb, jnp.array(label), deterministic=False,
                                  rngs={"dropout": jax.random.key(0)})
        else:
            want = disc.apply({"params": pd}, gb, jnp.array(label), deterministic=True)
    with torch.no_grad():
        got = tdisc(batch, t(label), deterministic=not training, keys=keys)
        fused = FT.discriminator_apply_fused(tdisc, tcfg, batch, t(label), keys,
                                             deterministic=not training)
    assert got.shape == want.shape == tuple(gb.mask.shape) + (1,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(fused.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("multi", [False, True], ids=["k1", "k3_gid"])
def test_training_mode_generator_matches_flax(case, multi):
    cfg, out = case
    gb, _, z, _, pd, gen, pg = out[multi]
    tcfg, _, tgen = _port_models(cfg, pd, pg)
    batch = port_batch(gb)
    B, R = batch.mask.shape[0], int(np.prod(batch.grid_shape))
    keys = drop.draw_keys(len(tgen.encoder.channels), torch.Generator().manual_seed(4))
    masks = port_masks(tgen.encoder, B, R, keys, cfg.ENCODER_DROPOUT_RATE)
    with jax.default_matmul_precision("highest"), given_masks(masks, 256.0 / 205.0):
        want, _, _ = gen.apply({"params": pg}, gb, jnp.array(z), deterministic=False,
                               rngs={"gumbel": jax.random.key(0), "dropout": jax.random.key(0)})
    noise = np.zeros(np.shape(want), np.float32)
    with torch.no_grad():
        got, _, _ = tgen(batch, t(z), gumbel_noise=t(noise), deterministic=False, keys=keys)
        fused, _, _ = FT.generator_apply_fused(tgen, tcfg, batch, t(z), gumbel_noise=t(noise),
                                               keys=keys)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(fused.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
