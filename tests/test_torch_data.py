"""The port's config, data helpers, stencil and RNG vs the JAX package.

Exact equality where both sides do the same integer or copy work (config
fields, synthetic buildings, preprocessing, grid packing, validity planes);
rtol 1e-5 / atol 1e-6 for the f32 stencil (a different order of the softmax
and neighbour sums) and the Box-Muller transform (torch's and XLA's log,
cos and sin differ in the last ulp).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_gan_tpu.config import Configuration as JConfiguration
from building_gan_tpu.data import grid as jgrid
from building_gan_tpu.data import preprocess as jpre
from building_gan_tpu.data import synthetic as jsyn
from building_gan_tpu.ops import rng as jrng
from building_gan_tpu.ops import stencil as jst

from building_gan_torch.config import Configuration
from building_gan_torch.data import grid as tgrid
from building_gan_torch.data import preprocess as tpre
from building_gan_torch.data import synthetic as tsyn
from building_gan_torch.ops import rng as trng
from building_gan_torch.ops import stencil as tst

from test_torch_layers import multi_batch, port_batch, t
from test_train import tiny_cfg


def test_config_fields_and_defaults_match_jax():
    jc, tc = JConfiguration(), Configuration()
    assert [f.name for f in dataclasses.fields(jc)] == [f.name for f in dataclasses.fields(tc)]
    assert jc.to_dict() == tc.to_dict()
    sj, st = JConfiguration(sanity_checking=True), Configuration(sanity_checking=True)
    assert sj.to_dict() == st.to_dict()
    assert tc.compute_dtype == torch.bfloat16 and tc.param_dtype == torch.float32
    assert tc.replace(COMPUTE_DTYPE="float32").compute_dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 17, 1004])
def test_synthetic_buildings_match_jax(seed):
    assert tsyn.generate_building(seed) == jsyn.generate_building(seed)
    assert tsyn.generate_building_real_scale(seed) == jsyn.generate_building_real_scale(seed)


@pytest.mark.parametrize("seed", [3, 41])
def test_process_building_matches_jax(seed):
    g, l, v = jsyn.generate_building_real_scale(seed)
    jl, jv = jpre.process_building(g, l, v, JConfiguration(), "7")
    tl, tv = tpre.process_building(g, l, v, Configuration(), "7")
    for a, b in ((jl, tl), (jv, tv)):
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(getattr(b, f.name), getattr(a, f.name))


def test_pack_grid_matches_jax(synthetic_samples, small_cfg):
    cfg = tiny_cfg(small_cfg, GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=64)
    want = jgrid.pack_grid(synthetic_samples[:3], cfg, batch_slots=5)
    got = tgrid.pack_grid(synthetic_samples[:3], Configuration(**cfg.to_dict()), batch_slots=5)
    assert got.gid is None and got.graphs_per_slot == 1 and got.grid_shape == (10, 8, 8)
    for f in dataclasses.fields(want):
        w = getattr(want, f.name)
        if w is None:
            assert getattr(got, f.name) is None
        else:
            np.testing.assert_array_equal(getattr(got, f.name).numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="slots"):
        tgrid.pack_grid(synthetic_samples[:3], Configuration(**cfg.to_dict()), batch_slots=2)


@pytest.mark.parametrize("multi", [False, True], ids=["mask_only", "gid"])
def test_stencil_planes_and_gat_match_jax(multi, synthetic_samples, small_cfg):
    cfg = tiny_cfg(small_cfg, GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=64)
    gb = multi_batch(synthetic_samples, cfg) if multi else jgrid.pack_grid(
        synthetic_samples[:3], cfg, batch_slots=3
    )
    pb = port_batch(gb)
    shape = (10, 8, 8)
    B = pb.batch_size
    mask = np.asarray(gb.mask).reshape(B, -1)
    gid = None if gb.gid is None else np.asarray(gb.gid).reshape(B, -1)

    for (jo, jm), (to, tm) in zip(jst._flat_dirs(shape), tst._flat_dirs(shape)):
        assert jo == to
        assert (jm is None) == (tm is None)
        if jm is not None:
            np.testing.assert_array_equal(tm, jm)

    want_planes = jst._nbr_valid_flat(
        jnp.array(mask), shape, None if gid is None else jnp.array(gid)
    )
    got_planes = tst._nbr_valid_flat(t(mask), shape, None if gid is None else t(gid))
    np.testing.assert_array_equal(got_planes.numpy(), np.asarray(want_planes))

    rng = np.random.default_rng(11)
    R = mask.shape[1]
    h = rng.normal(size=(B, R, 6)).astype(np.float32)
    a_s, a_d = (rng.normal(size=(B, R)).astype(np.float32) for _ in range(2))
    want = jst.stencil_gat_flat(
        jnp.array(h), jnp.array(a_s), jnp.array(a_d), jnp.array(mask), shape,
        gid=None if gid is None else jnp.array(gid),
    )
    got = tst.stencil_gat_flat(
        t(h), t(a_s), t(a_d), t(mask), shape, gid=None if gid is None else t(gid)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(4, 6, 8), (3, 5)], ids=["even_minor", "odd_minor"])
def test_box_muller_transform_matches_jax(shape):
    """The same uniforms (jax's, for a key) through the port's transform give jax's z."""
    key = jax.random.key(5)
    want = np.asarray(jrng.normal_box_muller(key, shape))
    k1, k2 = jax.random.split(key)
    if shape[-1] % 2 == 0:
        half = shape[:-1] + (shape[-1] // 2,)
    else:
        half = ((int(np.prod(shape)) + 1) // 2,)
    u1 = 1.0 - np.asarray(jax.random.uniform(k1, half, dtype=jnp.float32))
    u2 = np.asarray(jax.random.uniform(k2, half, dtype=jnp.float32))
    got = trng.box_muller(t(u1), t(u2), shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_normal_box_muller_is_seeded_and_standard():
    a = trng.normal_box_muller((64, 128), torch.Generator().manual_seed(1))
    b = trng.normal_box_muller((64, 128), torch.Generator().manual_seed(1))
    c = trng.normal_box_muller((64, 128), torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # 8192 draws: mean within ~4.5 sigma (0.05), std within 0.05
    assert abs(a.mean().item()) < 0.05 and abs(a.std().item() - 1.0) < 0.05
