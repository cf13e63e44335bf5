"""The port's generator and its fused-hourglass inference vs the flax generator.

Weights cross through the port's converter (flax params -> reference torch
state_dict -> ``load_state_dict``); z and the Gumbel noise are made with
numpy (or by jax.random for the Gumbel check) and given to both sides, since
torch cannot replay threefry.  f32 on the CPU, at tests/test_train.py::tiny_cfg
sizes.

Tolerance rtol 1e-4 / atol 1e-4 on logits of order 1: four MLP blocks, a
4-layer hourglass narrowing to 8-channel GraphNorm layers and five more MLP
blocks, summed in other orders by XLA and torch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_gan_tpu.data import grid as jgrid
from building_gan_tpu.models import GridVoxelGNNGenerator as JGenerator
from building_gan_tpu.ops.gumbel import gumbel_softmax_st as jgumbel

from building_gan_torch.checkpoint.torch_compat import generator_params_to_state_dict
from building_gan_torch.models import fast_infer
from building_gan_torch.models.grid_models import GridVoxelGNNGenerator
from building_gan_torch.ops.gumbel import gumbel_softmax_st

from test_torch_layers import multi_batch, perturb, port_batch, port_cfg, t
from test_train import tiny_cfg

RTOL, ATOL = 1e-4, 1e-4


def _setup(samples, small_cfg, multi):
    with jax.default_matmul_precision("highest"):
        return _build(samples, small_cfg, multi)


def _build(samples, small_cfg, multi):
    cfg = tiny_cfg(small_cfg, LAYOUT="grid", GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=64)
    gb = multi_batch(samples, cfg) if multi else jgrid.pack_grid(samples[:3], cfg, batch_slots=3)
    rng = np.random.default_rng(7)
    z = rng.normal(size=tuple(gb.mask.shape) + (cfg.Z_DIM,)).astype(np.float32)
    gen = JGenerator(configuration=cfg, dtype=jnp.float32)
    key = jax.random.key(0)
    params = gen.init({"params": key, "gumbel": key}, gb, jnp.array(z), deterministic=True)
    params = perturb(params["params"], 8, scale=0.05)
    want, _, _ = gen.apply(
        {"params": params}, gb, jnp.array(z), deterministic=True, rngs={"gumbel": key}
    )
    tcfg = port_cfg(cfg).replace(COMPUTE_DTYPE="float32")  # as the flax side's dtype
    model = GridVoxelGNNGenerator(tcfg)
    model.load_state_dict(generator_params_to_state_dict(params, tcfg))
    return tcfg, port_batch(gb), z, np.asarray(want), model, params


@pytest.fixture(scope="module")
def cases(synthetic_samples, small_cfg):
    """One flax init/apply per packing (the slow part), shared by the tests."""
    return {multi: _setup(synthetic_samples, small_cfg, multi) for multi in (False, True)}


def test_converter_keys_fill_the_port_state_dict(cases):
    tcfg, _, _, _, model, params = cases[False]
    sd = generator_params_to_state_dict(params, tcfg)
    assert set(sd) == set(model.state_dict())
    assert "encoder.module_0.lin.weight" in sd and "decoder.12.weight" in sd
    assert sd["encoder.module_0.att_src"].shape == (1, 1, tcfg.GENERATOR_HIDDEN_DIM // 2)


@pytest.mark.parametrize("multi", [False, True], ids=["k1", "k3_gid"])
def test_generator_logits_match_flax(multi, cases):
    tcfg, batch, z, want, model, _ = cases[multi]
    noise = np.random.default_rng(9).gumbel(size=want.shape).astype(np.float32)
    with torch.no_grad():
        logits, hard, soft = model(batch, t(z), gumbel_noise=t(noise))
    assert logits.shape == want.shape
    np.testing.assert_allclose(logits.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        hard.argmax(-1).numpy(), np.argmax(logits.numpy() + noise, axis=-1)
    )


@pytest.mark.parametrize("multi", [False, True], ids=["k1", "k3_gid"])
def test_fast_infer_on_cpu_matches_flax(multi, cases):
    tcfg, batch, z, want, model, _ = cases[multi]
    packed = fast_infer.prepare(model, tcfg)
    noise = np.zeros(want.shape, np.float32)
    logits, hard, _ = fast_infer.infer(model, packed, batch, t(z), gumbel_noise=t(noise))
    np.testing.assert_allclose(logits.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(hard.sum(-1).numpy(), 1.0, atol=1e-6)


def test_gumbel_st_matches_jax_with_the_same_noise():
    """jax's Gumbel draw for a key, given to the port: identical soft and hard samples."""
    key = jax.random.key(3)
    logits = np.random.default_rng(4).normal(size=(5, 11, 7)).astype(np.float32)
    g = np.asarray(jax.random.gumbel(key, logits.shape, dtype=jnp.float32))
    want_hard, want_soft = jgumbel(jnp.array(logits), key)
    hard, soft = gumbel_softmax_st(t(logits), noise=t(g))
    np.testing.assert_allclose(soft.numpy(), np.asarray(want_soft), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(hard.numpy(), np.asarray(want_hard))
