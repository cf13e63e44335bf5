"""The port's fused hourglass (plain version, wrapper, weight packing) vs JAX.

K=1: against ``hourglass_fwd`` in Pallas interpret mode, as tests/test_pallas.py
runs it.  K>1: against the flax ``GridHourglass``, which the TPU kernel (per-
slot statistics) does not match and the port's kernel does.

test_plain_matches_pallas_interpret_k1 builds its own inputs (its own
Configuration and synthetic buildings, a threefry key named outright, one
torch thread) rather than share the session fixtures and the process's
default PRNG implementation with the other test files of its xdist worker.

Tolerance rtol 1e-4 / atol 1e-5 (tests/test_pallas.py:73) for one call of
the stack; STACK_ATOL = 1e-4 where the flax stack is the reference.  The
stack narrows to 4 channels (hidden 32, repeat 3: 16, 8, 4, 8, 16, 32),
where GraphNorm divides by a small standard deviation and magnifies
rounding, and the keyed (K>1) statistics are one-hot matmuls in XLA against
per-row sums here: the order of the sums differs, nothing else.

The CUDA kernel itself is compared with the plain version on the card by
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_gan_tpu.config import Configuration
from building_gan_tpu.data import grid as jgrid
from building_gan_tpu.data import preprocess, synthetic
from building_gan_tpu.models.grid_layers import GridHourglass as JGridHourglass
from building_gan_tpu.ops.pallas import hourglass as jhg

from building_gan_torch.checkpoint.torch_compat import generator_params_to_state_dict
from building_gan_torch.models.grid_layers import GridHourglass
from building_gan_torch.ops import hourglass as hg

from test_torch_layers import ATOL, RTOL, multi_batch, perturb, t
from test_train import tiny_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

HIDDEN, REPEAT = 32, 3
STACK_ATOL = 1e-4


def _port_encoder(params, cfg, hidden=HIDDEN, repeat=REPEAT):
    """Flax GridHourglass params -> the port's GridHourglass through the converter."""
    sd = generator_params_to_state_dict({"encoder": params}, cfg)
    enc = GridHourglass(hidden, repeat)
    enc.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()})
    return enc


def _case(samples, small_cfg, multi, seed=0):
    cfg = tiny_cfg(small_cfg, GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=64)
    gb = multi_batch(samples, cfg) if multi else jgrid.pack_grid(samples[:4], cfg, batch_slots=4)
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=tuple(gb.mask.shape) + (HIDDEN,)).astype(np.float32)
    feats = feats * np.asarray(gb.mask)[..., None]
    hgj = JGridHourglass(conv_type="GATCONV", hidden_dim=HIDDEN, repeat=REPEAT)
    key = jax.random.key(seed, impl="threefry2x32")
    params = hgj.init({"params": key}, jnp.array(feats), jnp.array(gb.mask), True)
    params = perturb(params["params"], seed + 1, scale=0.1)
    return cfg, gb, feats, hgj, params


def test_channel_pairs_match_jax():
    for hidden, repeat, mc in [(128, 7, 1), (128, 7, 8), (64, 3, 16), (32, 3, 1)]:
        assert hg.hourglass_channel_pairs(hidden, repeat, mc) == jhg.hourglass_channel_pairs(
            hidden, repeat, mc
        )


def test_pack_gat_weights_matches_jax(synthetic_samples, small_cfg):
    cfg, _, _, _, params = _case(synthetic_samples, small_cfg, False)
    want = jhg.pack_gat_weights(params, HIDDEN, REPEAT)
    got = hg.pack_gat_weights(_port_encoder(params, cfg))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))


def _own_samples():
    """Fresh copies of conftest's small_cfg and first four synthetic_samples."""
    cfg = Configuration(
        LAYOUT="edges", PACK_GRAPHS=4, PACK_LOCAL_NODES=256, PACK_LOCAL_EDGES=2048,
        PACK_VOXEL_NODES=2048, PACK_VOXEL_EDGES=16384,
    )
    samples = []
    for i in range(4):
        g, l, v = synthetic.generate_building(seed=1000 + i)
        samples.append(preprocess.process_building(g, l, v, cfg, f"{i:06d}"))
    return samples, cfg


def test_plain_matches_pallas_interpret_k1(highest_precision):
    samples, small_cfg = _own_samples()
    cfg, gb, feats, _, params = _case(samples, small_cfg, False)
    Ws, atts, vecs = jhg.pack_gat_weights(params, HIDDEN, REPEAT)
    want = jhg.hourglass_fwd(
        jnp.array(feats), jnp.array(gb.mask), Ws, atts, vecs,
        hidden_dim=HIDDEN, repeat=REPEAT, tile=2, interpret=True,
    )
    chans = hg.hourglass_channel_pairs(HIDDEN, REPEAT)
    got = hg.hourglass_plain(t(feats), t(gb.mask), t(Ws), t(atts), t(vecs), chans)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("multi", [False, True], ids=["k1", "k3_gid"])
def test_plain_and_module_match_flax_stack(multi, synthetic_samples, small_cfg, highest_precision):
    cfg, gb, feats, hgj, params = _case(synthetic_samples, small_cfg, multi, seed=2)
    K = gb.graph_mask.shape[1] if multi else 1
    jgid = None if gb.gid is None else jnp.array(gb.gid)
    want = np.asarray(
        hgj.apply({"params": params}, jnp.array(feats), jnp.array(gb.mask), True, jgid, K)
    )
    enc = _port_encoder(params, cfg)
    with torch.no_grad():
        Ws, atts, vecs = hg.pack_gat_weights(enc)
    gid = None if gb.gid is None else t(gb.gid)
    got = hg.hourglass_plain(
        t(feats), t(gb.mask), Ws, atts, vecs, hg.hourglass_channel_pairs(HIDDEN, REPEAT), gid, K
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=STACK_ATOL)
    B = feats.shape[0]
    with torch.no_grad():
        mod = enc(
            t(feats).reshape(B, -1, HIDDEN), t(gb.mask).reshape(B, -1), tuple(gb.mask.shape[1:]),
            gid=None if gid is None else gid.reshape(B, -1), num_graphs=K,
        )
    np.testing.assert_allclose(mod.reshape(want.shape).numpy(), want, rtol=RTOL, atol=STACK_ATOL)


def test_wrapper_on_cpu_runs_plain_and_counts_nothing(synthetic_samples, small_cfg):
    cfg, gb, feats, _, params = _case(synthetic_samples, small_cfg, False)
    Ws, atts, vecs = hg.pack_gat_weights(_port_encoder(params, cfg))
    chans = hg.hourglass_channel_pairs(HIDDEN, REPEAT)
    before = hg.launches.value
    got = hg.hourglass_fwd(t(feats), t(gb.mask), Ws, atts, vecs, chans)
    want = hg.hourglass_plain(t(feats), t(gb.mask), Ws, atts, vecs, chans)
    assert torch.equal(got, want)
    assert hg.launches.value == before
    with pytest.raises(ValueError, match="CUDA"):
        hg.hourglass_cuda(t(feats), t(gb.mask), Ws, atts, vecs, chans)
