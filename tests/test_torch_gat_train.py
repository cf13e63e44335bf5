"""The training layer's plain version and its dropout vs the JAX package, f32 on the CPU.

- ``hourglass_train`` on CPU tensors (the plain ``layer_plain`` stack), dropout
  off: forward and the grads to x, Ws, atts, vecs against
  ``gat_train.hourglass_train`` in interpret mode at K = 1 and K = 2, the
  Pallas kernels' own closed-form backward.
- Dropout on: the plain stack with the port's Philox keep masks against a JAX
  composition of ``stencil_gat_flat`` + ``GridGraphNorm`` + ReLU + the same
  masks x 256/205 (the TPU kernel's in-kernel random bits cannot be replayed).
- The Philox generator against the Random123 known-answer vectors, the
  dropout rate, ``build_planes`` and ``flat_offsets`` against JAX.
- ``layer_plain``'s ``branches``: the layer's own signs give the same layer,
  bit for bit; other branches give another.

Tolerances as tests/test_gat_train.py, under matmul precision "highest":
forward atol 2e-5; each gradient within 5e-5 of its largest magnitude (f32
sums in other orders through the softmax and GraphNorm backward).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_gan_tpu.models.grid_layers import GridGraphNorm
from building_gan_tpu.ops import stencil as jst
from building_gan_tpu.ops.pallas import gat_train as GT

from building_gan_torch.ops import dropout as drop
from building_gan_torch.ops import gat_train as gt

from test_torch_layers import t
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

GS = (3, 4, 4)
R = int(np.prod(GS))
C = 8
L = 2
FWD_ATOL, GRAD_TOL = 2e-5, 5e-5


def _case(K, seed=0, B=3):
    """The inputs of tests/test_gat_train.py::_case, as numpy."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((B, R)) > 0.3).astype(np.float32)
    gid = rng.integers(0, K, (B, R)).astype(np.int32)
    x0 = (rng.normal(size=(B, R, C)) * mask[..., None]).astype(np.float32)
    Ws = rng.normal(size=(L, C, C)).astype(np.float32) * 0.3
    atts = rng.normal(size=(L, 2, C)).astype(np.float32) * 0.3
    vecs = rng.normal(size=(L, 4, C)).astype(np.float32) * 0.2
    vecs[:, 1] += 1.0
    vecs[:, 3] += 1.0
    return mask, gid, x0, Ws, atts, vecs


def _port_grads(mask, gid, K, x0, Ws, atts, vecs, cot, keys=None, rate=0.0):
    planes = gt.build_planes(t(mask), t(gid) if K > 1 else None, GS)
    leaves = [t(a).requires_grad_(True) for a in (x0, Ws, atts, vecs)]
    y = gt.hourglass_train(*leaves[:1], planes, *leaves[1:], keys, GS, K=K, dropout_rate=rate,
                           deterministic=rate == 0.0, chans=[(C, C)] * L)
    grads = torch.autograd.grad((y * t(cot)).sum(), leaves)
    return y.detach().numpy(), [g.numpy() for g in grads]


def _assert_grads(got, want):
    for name, a, b in zip(("gx", "gW", "gatt", "gvec"), got, want):
        scale = float(np.max(np.abs(b))) + 1e-6
        np.testing.assert_allclose(a / scale, np.asarray(b) / scale, atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("K", [1, 2])
def test_plain_stack_matches_the_pallas_kernels(K):
    mask, gid, x0, Ws, atts, vecs = _case(K)
    planes = GT.build_planes(jnp.array(mask), jnp.array(gid) if K > 1 else None, GS)
    seeds = jnp.zeros((L,), jnp.int32)

    def ker(x, W, a, v):
        return GT.hourglass_train(x, planes, W, a, v, seeds, GS, K=K, dropout_rate=0.0,
                                  deterministic=True, tile=1, interpret=True)

    cot = np.random.default_rng(9).normal(size=x0.shape).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        args = [jnp.array(a) for a in (x0, Ws, atts, vecs)]
        want = np.asarray(ker(*args))
        want_g = jax.grad(lambda *a: jnp.sum(ker(*a) * cot), argnums=(0, 1, 2, 3))(*args)
    got, got_g = _port_grads(mask, gid, K, x0, Ws, atts, vecs, cot)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)
    _assert_grads(got_g, want_g)


def _jax_composition(x, Ws, atts, vecs, mask, gid, K, keeps, scale):
    """stencil_gat_flat + GridGraphNorm + ReLU + given keep masks (the layer body of GridHourglass)."""
    for l in range(Ws.shape[0]):
        h = x @ Ws[l]
        a_s = (h * atts[l, 0]).sum(-1)
        a_d = (h * atts[l, 1]).sum(-1)
        conv = jst.stencil_gat_flat(h, a_s, a_d, mask, GS, gid=gid if K > 1 else None) + vecs[l, 0]
        z = GridGraphNorm(features=C).apply(
            {"params": {"weight": vecs[l, 1], "bias": vecs[l, 2], "mean_scale": vecs[l, 3]}},
            conv, mask, gid=gid if K > 1 else None, num_graphs=K,
        )
        x = jax.nn.relu(z) * keeps[l] * scale
    return x


@pytest.mark.parametrize("K", [1, 3])
def test_plain_stack_with_dropout_matches_a_jax_composition(K):
    mask, gid, x0, Ws, atts, vecs = _case(K, seed=4)
    keys = torch.tensor([[12345, 678], [0xFFFFFFFF, 42]], dtype=torch.int64)
    levels = drop.drop_levels(0.2)
    keeps = [drop.keep_mask((3, R, C), keys[l], levels).numpy().astype(np.float32) for l in range(L)]
    assert 0.5 < np.mean(keeps) < 0.95
    cot = np.random.default_rng(5).normal(size=x0.shape).astype(np.float32)

    def ref(*a):
        return _jax_composition(*a, jnp.array(mask), jnp.array(gid), K,
                                [jnp.array(k) for k in keeps], 256.0 / 205.0)

    with jax.default_matmul_precision("highest"):
        args = [jnp.array(a) for a in (x0, Ws, atts, vecs)]
        want = np.asarray(ref(*args))
        want_g = jax.grad(lambda *a: jnp.sum(ref(*a) * cot), argnums=(0, 1, 2, 3))(*args)
    got, got_g = _port_grads(mask, gid, K, x0, Ws, atts, vecs, cot, keys=keys, rate=0.2)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)
    _assert_grads(got_g, want_g)


def test_build_planes_and_offsets_match_jax():
    mask, gid, *_ = _case(3, seed=2)
    for g in (None, gid):
        want = GT.build_planes(jnp.array(mask), None if g is None else jnp.array(g), GS)
        got = gt.build_planes(t(mask), None if g is None else t(g), GS)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert gt.flat_offsets((11, 12, 12)) == GT.flat_offsets((11, 12, 12))


@pytest.mark.parametrize(
    "counter,key,want",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ],
    ids=["zeros", "ones", "pi"],
)
def test_philox_known_answers(counter, key, want):
    """Random123's known-answer vectors for Philox4x32-10 (kat_vectors)."""
    words = [torch.tensor([c], dtype=torch.int64) for c in counter]
    out = drop.philox4x32_10(*words, *(torch.tensor(k, dtype=torch.int64) for k in key))
    assert tuple(int(o) for o in out) == want


def test_dropout_rate_scale_and_keys():
    assert drop.drop_levels(0.2) == 51 and drop.keep_scale(51) == 256.0 / 205.0
    key = drop.draw_keys(1, torch.Generator().manual_seed(3))[0]
    b = drop.random_bytes(torch.arange(200_000), key)
    assert int(b.min()) >= 0 and int(b.max()) <= 255
    keep = (b >= 51).double().mean().item()
    assert abs(keep - 205 / 256) < 0.005  # ~5.6 sigma at 200k draws
    x = torch.ones(4, 50, 8)
    y = drop.dropout(x, key, 0.2)
    assert set(torch.unique(y).tolist()) <= {0.0, float(np.float32(256.0 / 205.0))}
    assert torch.equal(drop.dropout(x, key, 0.2), y)  # a key gives one mask
    other = drop.draw_keys(1, torch.Generator().manual_seed(4))[0]
    assert not torch.equal(drop.dropout(x, other, 0.2), y)
    # a narrow block at a padded width draws the padded block's bits
    wide = drop.keep_mask((4, 50, 16), key, 51)
    assert torch.equal(drop.keep_mask((4, 50, 8), key, 51, width=16), wide[..., :8])


def test_fused_path_refuses_cpu_tensors():
    mask, gid, x0, Ws, atts, vecs = _case(1)
    planes = gt.build_planes(t(mask), None, GS)
    with pytest.raises(ValueError, match="CUDA"):
        gt.fused_layer(t(x0), planes, t(Ws[0]), t(atts[0]), t(vecs[0]), None, GS, C, C)
    with pytest.raises(ValueError, match="keys"):
        gt.hourglass_train(t(x0), planes, t(Ws), t(atts), t(vecs), None, GS, dropout_rate=0.2,
                           chans=[(C, C)] * L)


def test_layer_plain_takes_the_given_branches():
    from building_gan_torch.ops.stencil import shift

    mask, gid, x0, Ws, atts, vecs = _case(2)
    planes = gt.build_planes(t(mask), t(gid), GS)
    cot = t(np.random.default_rng(1).normal(size=x0.shape).astype(np.float32))

    def run(branches):
        leaves = [t(a).requires_grad_(True) for a in (x0, Ws[0], atts[0], vecs[0])]
        y = gt.layer_plain(leaves[0], planes, *leaves[1:], None, GS, 2, branches=branches)
        return [y.detach()] + list(torch.autograd.grad((y * cot).sum(), leaves))

    plain = run(None)
    with torch.no_grad():
        h = t(x0) @ t(Ws[0])
        a_s, a_d = (h * t(atts[0])[0]).sum(-1), (h * t(atts[0])[1]).sum(-1)
        leaky = torch.stack([shift(a_s, 1, o) + a_d >= 0 for o in gt.flat_offsets(GS)]
                            + [a_s + a_d >= 0])
    own = run((plain[0] > 0, leaky))
    for a, b in zip(own, plain):
        assert torch.equal(a, b)
    other = run((plain[0] > 0, torch.ones_like(leaky)))  # slope 1 everywhere
    assert not torch.allclose(other[0], plain[0])
