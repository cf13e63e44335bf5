"""Port layers vs their JAX counterparts, in float32 on the CPU.

Same numpy-seeded inputs and the same weights on both sides.  Tolerance
rtol 1e-4 / atol 1e-5 as in tests/test_pallas.py unless a test states
otherwise: both sides are f32, and the differences are the order of the sums
(XLA's reduction trees against torch's).

The helpers at the top are shared by the other tests/test_torch_*.py files.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_gan_tpu.data import grid as jgrid
from building_gan_tpu.models import grid_layers as jgl
from building_gan_tpu.models import layers as jlayers

from building_gan_torch.config import Configuration as TorchConfiguration
from building_gan_torch.data.grid import GridBatch
from building_gan_torch.models import grid_layers as tgl
from building_gan_torch.models.layers import MLPBlock

from test_train import tiny_cfg

RTOL, ATOL = 1e-4, 1e-5


def port_cfg(jcfg):
    """The port's Configuration with every field of a JAX Configuration."""
    return TorchConfiguration(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def port_batch(gb) -> GridBatch:
    """A JAX GridBatch (K=1 or K>1) as the port's GridBatch of CPU tensors."""
    return GridBatch.from_numpy(
        **{f.name: None if getattr(gb, f.name) is None else np.asarray(getattr(gb, f.name))
           for f in dataclasses.fields(GridBatch)}
    )


def perturb(params, seed, scale=0.2):
    """Params tree with every leaf moved by seeded noise (so ones/zeros inits matter)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + scale * rng.normal(size=np.shape(a)).astype(np.float32), params
    )


def multi_batch(samples, jcfg, K=3, slots=5):
    """A gap-free (cell mode) K>1 JAX batch: buildings touch and need the gid plane."""
    cfg = jcfg.replace(GRID_SLOT_GRAPHS=K, GRID_PACK_MODE="cell", GRID_LOCAL_NODES=64)
    return jgrid.pack_grid_multi(samples, cfg, batch_slots=slots, graphs_per_slot=K)


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture
def grid_cfg(small_cfg):
    return tiny_cfg(small_cfg, LAYOUT="grid", GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=64)


def _flat_case(samples, cfg, multi, c, seed):
    gb = multi_batch(samples, cfg) if multi else jgrid.pack_grid(samples[:3], cfg, batch_slots=3)
    B = gb.mask.shape[0]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, int(np.prod(gb.mask.shape[1:])), c)).astype(np.float32)
    mask = np.asarray(gb.mask).reshape(B, -1)
    gid = None if gb.gid is None else np.asarray(gb.gid).reshape(B, -1)
    return gb, x, mask, gid


def test_mlp_block_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 9, 20)).astype(np.float32) * 3.0 + 1.0
    blk = jlayers.MLPBlock(16)
    params = perturb(blk.init(jax.random.key(0), jnp.array(x))["params"], 1)
    want = np.asarray(blk.apply({"params": params}, jnp.array(x)))
    mine = MLPBlock(20, 16)
    with torch.no_grad():
        mine[0].weight.copy_(t(params["dense"]["kernel"].T))
        mine[0].bias.copy_(t(params["dense"]["bias"]))
        mine[1].weight.copy_(t(params["norm"]["scale"]))
        mine[1].bias.copy_(t(params["norm"]["bias"]))
        got = mine(t(x)).numpy()
    assert mine[1].eps == 1e-6  # flax LayerNorm epsilon, not torch's 1e-5
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("multi", [False, True], ids=["per_slot", "gid_keyed"])
def test_graph_norm_matches_flax(multi, synthetic_samples, grid_cfg):
    gb, x, mask, gid = _flat_case(synthetic_samples, grid_cfg, multi, 6, 2)
    K = gb.graph_mask.shape[1] if multi else 1
    norm = jgl.GridGraphNorm(features=6)
    params = perturb(norm.init(jax.random.key(0), jnp.array(x), jnp.array(mask))["params"], 3)
    want = norm.apply(
        {"params": params}, jnp.array(x), jnp.array(mask),
        gid=None if gid is None else jnp.array(gid), num_graphs=K,
    )
    mine = tgl.GridGraphNorm(6)
    with torch.no_grad():
        for k in ("weight", "bias", "mean_scale"):
            getattr(mine, k).copy_(t(params[k]))
        got = mine(t(x), t(mask), gid=None if gid is None else t(gid), num_graphs=K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("multi", [False, True], ids=["k1", "gid"])
def test_gat_conv_matches_flax(multi, synthetic_samples, grid_cfg, highest_precision):
    gb, x, mask, gid = _flat_case(synthetic_samples, grid_cfg, multi, 8, 4)
    grid_shape = tuple(gb.mask.shape[1:])
    conv = jgl.GridGATConv(features=5)
    jgid = None if gid is None else jnp.array(gid)
    params = perturb(
        conv.init(jax.random.key(1), jnp.array(x), jnp.array(mask), grid_shape, jgid)["params"], 5
    )
    want = conv.apply({"params": params}, jnp.array(x), jnp.array(mask), grid_shape, jgid)
    mine = tgl.GridGATConv(8, 5)
    with torch.no_grad():
        mine.lin.weight.copy_(t(params["lin"]["kernel"].T))
        mine.att_src.copy_(t(params["att_src"].T[None]))
        mine.att_dst.copy_(t(params["att_dst"].T[None]))
        mine.bias.copy_(t(params["bias"]))
        got = mine(t(x), t(mask), grid_shape, gid=None if gid is None else t(gid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("multi", [False, True], ids=["k1", "building_type_key"])
def test_matched_pooling_matches_jax(multi, synthetic_samples, grid_cfg):
    gb = multi_batch(synthetic_samples, grid_cfg) if multi else jgrid.pack_grid(
        synthetic_samples[:3], grid_cfg, batch_slots=3
    )
    K = gb.graph_mask.shape[1] if multi else 1
    want = jgl.grid_type_matched_pooling(
        jnp.array(gb.local_x), jnp.array(gb.local_type), jnp.array(gb.local_mask),
        jnp.array(gb.type), 7, local_gid=None if gb.local_gid is None else jnp.array(gb.local_gid),
        gid=None if gb.gid is None else jnp.array(gb.gid), num_graphs=K,
    )
    pb = port_batch(gb)
    got = tgl.grid_type_matched_pooling(
        pb.local_x, pb.local_type, pb.local_mask, pb.type, 7,
        local_gid=pb.local_gid, gid=pb.gid, num_graphs=K,
    )
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_hourglass_channels_match_jax():
    for hidden, repeat, mc in [(128, 7, 1), (128, 7, 8), (64, 3, 16), (32, 2, 1)]:
        assert tgl.hourglass_channels(hidden, repeat, mc) == jgl.hourglass_channels(hidden, repeat, mc)
    with pytest.raises(ValueError):
        tgl.hourglass_channels(16, 2, 17)
