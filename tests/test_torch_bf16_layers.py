"""The port's layers at COMPUTE_DTYPE bfloat16 vs the JAX package's, on the CPU.

The same numpy-seeded inputs, rounded to bf16, go through the flax modules at
``dtype=bfloat16`` and the port's modules fed bf16 (parameters f32 on both
sides, cast at use).  Covered: ``MLPBlock`` (Dense + LayerNorm, statistics in
f32), ``graph_norm`` (K = 1 and the gid-keyed K > 1 path, scale and shift
applied in bf16), the GAT conv with its stencil (score math in f32, the
normalised weights cast to bf16), matched pooling, the training layer's
plain bf16 mode (``layer_plain``: f32 math, x read as bf16, y and gx
rounded to bf16) against ``make_fused_layer`` in interpret mode fed bf16 x,
and the serving hourglass's plain bf16 twin against the flax bf16 stack.

Tolerances, in bf16 ulps of the reference value (one ulp = 2^(e - 7) for a
value in [2^e, 2^(e+1))) plus an absolute term, stated per comparison:
both sides round to bf16 at the same places, but XLA on the CPU may keep
excess precision inside a fusion where torch rounds each op, and sums run in
other orders, so an output may sit a rounding step or two away; a layer's
absolute term covers values near 0 that come from cancelling sums.  Each
bf16 output is also held against the port's own f32 output of the same
inputs: it must differ (a silent f32 path would not) and stay within a
stated relative bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_gan_tpu.data import grid as jgrid
from building_gan_tpu.models import grid_layers as jgl
from building_gan_tpu.models import layers as jlayers
from building_gan_tpu.ops import stencil as jst
from building_gan_tpu.ops.pallas import gat_train as GT

from building_gan_torch.models import grid_layers as tgl
from building_gan_torch.models.layers import MLPBlock
from building_gan_torch.ops import dropout as drop
from building_gan_torch.ops import gat_train as gt
from building_gan_torch.ops import hourglass as hg

from test_torch_gat_train import GS, C, L, _case as _layer_case
from test_torch_layers import _flat_case, multi_batch, perturb, t
from test_train import tiny_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

BF16 = torch.bfloat16
GRAD_TOL = 5e-5  # f32 weight grads of the bf16 stacks, of their largest magnitude (as f32)


def bf16_ulp(v):
    """One bf16 ulp of each value (of the smallest normal for 0)."""
    a = np.maximum(np.abs(np.asarray(v, np.float64)), 2.0**-126)
    return np.exp2(np.floor(np.log2(a)) - 7)


def assert_ulps(got, want, n_ulp, atol, name=""):
    """|got - want| <= n_ulp bf16 ulps of want + atol, elementwise."""
    got = np.asarray(torch.as_tensor(got).double() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want)
    bound = n_ulp * bf16_ulp(want) + atol
    worst = np.argmax(err - bound)
    assert (err <= bound).all(), (
        f"{name}: {int((err > bound).sum())} of {err.size} beyond {n_ulp} ulp + {atol}; worst "
        f"got {got.flat[worst]:.6g} want {want.flat[worst]:.6g}")


def assert_not_f32(b16, f32, rel, name=""):
    """The bf16 output is not the f32 one, and within ``rel`` of its largest magnitude."""
    d = (torch.as_tensor(b16).double() - torch.as_tensor(f32).double()).abs().max().item()
    scale = torch.as_tensor(f32).double().abs().max().item()
    assert 0 < d <= rel * scale, f"{name}: bf16 - f32 = {d:.3e}, scale {scale:.3e}"


def jbf(a):
    return jnp.asarray(np.asarray(a), jnp.bfloat16)


def tbf(a):
    return t(np.asarray(a, np.float32)).to(BF16)


@pytest.fixture
def grid_cfg(small_cfg):
    return tiny_cfg(small_cfg, LAYOUT="grid", GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=64)


def test_mlp_block_bf16_matches_flax():
    """Dense in bf16; LayerNorm statistics and affine in f32, rounded to bf16. 2 ulp + 1e-2."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 9, 20)) * 3.0 + 1.0).astype(np.float32)
    blk = jlayers.MLPBlock(16, dtype=jnp.bfloat16)
    params = perturb(blk.init(jax.random.key(0), jbf(x))["params"], 1)
    want = blk.apply({"params": params}, jbf(x))
    assert want.dtype == jnp.bfloat16
    mine = MLPBlock(20, 16)
    with torch.no_grad():
        mine[0].weight.copy_(t(params["dense"]["kernel"].T))
        mine[0].bias.copy_(t(params["dense"]["bias"]))
        mine[1].weight.copy_(t(params["norm"]["scale"]))
        mine[1].bias.copy_(t(params["norm"]["bias"]))
        got = mine(tbf(x))
        f32 = mine(tbf(x).float())
    assert got.dtype == BF16 and mine[0].weight.dtype == torch.float32
    assert_ulps(got, want, 2, 1e-2, "MLPBlock")
    assert_not_f32(got, f32, 2e-2, "MLPBlock")


@pytest.mark.parametrize("multi", [False, True], ids=["per_slot", "gid_keyed"])
def test_graph_norm_bf16_matches_flax(multi, synthetic_samples, grid_cfg):
    """Statistics in f32, scale and shift rounded to bf16 and applied in bf16. 1 ulp + 1e-3.

    The flax layer is jitted, as the JAX package's steps run it: XLA then keeps
    the K > 1 squares in f32 inside their one-hot einsum (run eagerly, they
    are rounded to bf16 first)."""
    gb, x, mask, gid = _flat_case(synthetic_samples, grid_cfg, multi, 6, 2)
    K = gb.graph_mask.shape[1] if multi else 1
    norm = jgl.GridGraphNorm(features=6, dtype=jnp.bfloat16)
    params = perturb(norm.init(jax.random.key(0), jbf(x), jnp.array(mask))["params"], 3)
    want = jax.jit(lambda p, x_: norm.apply(
        {"params": p}, x_, jnp.array(mask), gid=None if gid is None else jnp.array(gid),
        num_graphs=K))(params, jbf(x))
    assert want.dtype == jnp.bfloat16
    mine = tgl.GridGraphNorm(6)
    with torch.no_grad():
        for k in ("weight", "bias", "mean_scale"):
            getattr(mine, k).copy_(t(params[k]))
        g = None if gid is None else t(gid)
        got = mine(tbf(x), t(mask), gid=g, num_graphs=K)
        f32 = mine(tbf(x).float(), t(mask), gid=g, num_graphs=K)
    assert got.dtype == BF16
    assert_ulps(got, want, 1, 1e-3, "graph_norm")
    assert_not_f32(got, f32, 2e-2, "graph_norm")


@pytest.mark.parametrize("multi", [False, True], ids=["k1", "gid"])
def test_gat_conv_bf16_matches_flax(multi, synthetic_samples, grid_cfg):
    """The folded GEMM in bf16, the stencil's scores in f32 (-1e30 never meets bf16),
    its weights and sums in bf16. 1 ulp + 1e-3."""
    gb, x, mask, gid = _flat_case(synthetic_samples, grid_cfg, multi, 8, 4)
    grid_shape = tuple(gb.mask.shape[1:])
    conv = jgl.GridGATConv(features=5, dtype=jnp.bfloat16)
    jgid = None if gid is None else jnp.array(gid)
    params = perturb(
        conv.init(jax.random.key(1), jbf(x), jnp.array(mask), grid_shape, jgid)["params"], 5
    )
    want = conv.apply({"params": params}, jbf(x), jnp.array(mask), grid_shape, jgid)
    assert want.dtype == jnp.bfloat16
    mine = tgl.GridGATConv(8, 5)
    with torch.no_grad():
        mine.lin.weight.copy_(t(params["lin"]["kernel"].T))
        mine.att_src.copy_(t(params["att_src"].T[None]))
        mine.att_dst.copy_(t(params["att_dst"].T[None]))
        mine.bias.copy_(t(params["bias"]))
        g = None if gid is None else t(gid)
        got = mine(tbf(x), t(mask), grid_shape, gid=g)
        f32 = mine(tbf(x).float(), t(mask), grid_shape, gid=g)
    assert got.dtype == BF16 and torch.isfinite(got.float()).all()
    assert_ulps(got, want, 1, 1e-3, "GATConv")
    assert_not_f32(got, f32, 2e-2, "GATConv")


@pytest.mark.parametrize("multi", [False, True], ids=["k1", "building_type_key"])
def test_matched_pooling_bf16_matches_jax(multi, synthetic_samples, grid_cfg):
    """Sums in f32, the mean table rounded to bf16, read back exactly: equal."""
    gb = multi_batch(synthetic_samples, grid_cfg) if multi else jgrid.pack_grid(
        synthetic_samples[:3], grid_cfg, batch_slots=3
    )
    K = gb.graph_mask.shape[1] if multi else 1
    want = jgl.grid_type_matched_pooling(
        jbf(gb.local_x), jnp.array(gb.local_type), jnp.array(gb.local_mask), jnp.array(gb.type), 7,
        local_gid=None if gb.local_gid is None else jnp.array(gb.local_gid),
        gid=None if gb.gid is None else jnp.array(gb.gid), num_graphs=K,
    )
    got = tgl.grid_type_matched_pooling(
        tbf(gb.local_x), t(gb.local_type), t(gb.local_mask), t(gb.type), 7,
        local_gid=None if gb.local_gid is None else t(gb.local_gid),
        gid=None if gb.gid is None else t(gb.gid), num_graphs=K,
    )
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


# --- the training layer: the plain bf16 mode against the Pallas kernels ----------------------

def _port_stack(mask, gid, K, x0, Ws, atts, vecs, cot, keys=None, rate=0.0):
    """The port's plain stack on bf16 x: y, and the grads to x (bf16), Ws, atts, vecs (f32)."""
    planes = gt.build_planes(t(mask), t(gid) if K > 1 else None, GS)
    xb = t(x0).to(BF16).requires_grad_(True)
    leaves = [t(a).requires_grad_(True) for a in (Ws, atts, vecs)]
    y = gt.hourglass_train(xb, planes, *leaves, keys, GS, K=K, dropout_rate=rate,
                           deterministic=rate == 0.0, chans=[(C, C)] * L)
    assert y.dtype == BF16
    grads = torch.autograd.grad((y.float() * t(cot)).sum(), [xb] + leaves)
    assert grads[0].dtype == BF16 and all(g.dtype == torch.float32 for g in grads[1:])
    return y.detach(), grads


def _assert_stack(got, got_g, want, want_g, name):
    """y and gx (bf16): 2 ulp + 1e-3 of their scale (the layers' bf16 outputs land on
    the other side of a rounding step where the two f32 computations differ); the f32
    weight grads within GRAD_TOL of their largest magnitude."""
    scale = float(np.abs(np.asarray(jnp.asarray(want, jnp.float32))).max())
    assert_ulps(got, want, 2, 1e-3 * scale, f"{name} y")
    for nm, a, b in zip(("gx", "gW", "gatt", "gvec"), got_g, want_g):
        b = np.asarray(jnp.asarray(b, jnp.float32))
        s = float(np.abs(b).max()) + 1e-6
        if nm == "gx":
            assert_ulps(a, b, 2, 1e-3 * s, f"{name} gx")
        else:
            np.testing.assert_allclose(a.numpy() / s, b / s, atol=GRAD_TOL, err_msg=f"{name} {nm}")


@pytest.mark.parametrize("K", [1, 2])
def test_plain_bf16_stack_matches_the_pallas_kernels(K):
    """make_fused_layer in interpret mode fed bf16 x: f32 math, y and gx in bf16."""
    mask, gid, x0, Ws, atts, vecs = _layer_case(K)
    x0 = np.asarray(jbf(x0).astype(jnp.float32))
    planes = GT.build_planes(jnp.array(mask), jnp.array(gid) if K > 1 else None, GS)
    seeds = jnp.zeros((L,), jnp.int32)

    def ker(x, W, a, v):
        return GT.hourglass_train(x, planes, W, a, v, seeds, GS, K=K, dropout_rate=0.0,
                                  deterministic=True, tile=1, interpret=True)

    cot = np.random.default_rng(9).normal(size=x0.shape).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        args = [jbf(x0)] + [jnp.array(a) for a in (Ws, atts, vecs)]
        want = ker(*args)
        assert want.dtype == jnp.bfloat16
        want_g = jax.grad(lambda *a: jnp.sum(ker(*a).astype(jnp.float32) * cot),
                          argnums=(0, 1, 2, 3))(*args)
    assert want_g[0].dtype == jnp.bfloat16
    got, got_g = _port_stack(mask, gid, K, x0, Ws, atts, vecs, cot)
    _assert_stack(got, got_g, want, want_g, f"K={K}")
    with torch.no_grad():
        plain32 = gt.hourglass_train(t(x0), gt.build_planes(t(mask), t(gid) if K > 1 else None, GS),
                                     t(Ws), t(atts), t(vecs), None, GS, K=K, deterministic=True,
                                     chans=[(C, C)] * L)
    assert_not_f32(got, plain32, 2e-2, "stack")


@pytest.mark.parametrize("K", [1, 3])
def test_plain_bf16_stack_with_dropout_matches_a_jax_composition(K):
    """Dropout on, with the port's Philox masks given to a JAX composition in f32 that
    rounds each layer's output to bf16 (the fused layer's bf16 semantics)."""
    mask, gid, x0, Ws, atts, vecs = _layer_case(K, seed=4)
    x0 = np.asarray(jbf(x0).astype(jnp.float32))
    keys = torch.tensor([[12345, 678], [0xFFFFFFFF, 42]], dtype=torch.int64)
    levels = drop.drop_levels(0.2)
    keeps = [drop.keep_mask((3, GS[0] * GS[1] * GS[2], C), keys[l], levels).numpy()
             .astype(np.float32) for l in range(L)]
    cot = np.random.default_rng(5).normal(size=x0.shape).astype(np.float32)

    def ref(x, Ws_, atts_, vecs_):
        x = x.astype(jnp.float32)
        for l in range(L):
            h = x @ Ws_[l]
            a_s = (h * atts_[l, 0]).sum(-1)
            a_d = (h * atts_[l, 1]).sum(-1)
            conv = jst.stencil_gat_flat(h, a_s, a_d, jnp.array(mask), GS,
                                        gid=jnp.array(gid) if K > 1 else None) + vecs_[l, 0]
            z = jgl.GridGraphNorm(features=C).apply(
                {"params": {"weight": vecs_[l, 1], "bias": vecs_[l, 2], "mean_scale": vecs_[l, 3]}},
                conv, jnp.array(mask), gid=jnp.array(gid) if K > 1 else None, num_graphs=K,
            )
            x = (jax.nn.relu(z) * keeps[l] * (256.0 / 205.0)).astype(jnp.bfloat16).astype(jnp.float32)
        return x.astype(jnp.bfloat16)

    with jax.default_matmul_precision("highest"):
        args = [jbf(x0)] + [jnp.array(a) for a in (Ws, atts, vecs)]
        want = ref(*args)
        want_g = jax.grad(lambda *a: jnp.sum(ref(*a).astype(jnp.float32) * cot),
                          argnums=(0, 1, 2, 3))(*args)
    got, got_g = _port_stack(mask, gid, K, x0, Ws, atts, vecs, cot, keys=keys, rate=0.2)
    _assert_stack(got, got_g, want, want_g, f"K={K} dropout")


# --- the serving hourglass: the plain bf16 twin against the flax bf16 stack ------------------

def test_hourglass_plain_bf16_matches_the_flax_bf16_stack(synthetic_samples, grid_cfg):
    """hourglass_plain on bf16 x (f32 math, each layer's output rounded to bf16) against
    the JAX package's plain bf16 stack (GridHourglass at dtype bf16, deterministic), K = 1.
    The flax stack also rounds h, the softmax weights, the aggregate and the norm's
    output to bf16, the twin only each layer's output, so the two differ by the flax
    stack's own rounding: their largest difference is within 1.5x the flax bf16 stack's
    largest distance from the flax f32 stack, and the twin is within 2e-2 of the f32
    stack's scale (the flax bf16 stack within 8e-2)."""
    hidden, repeat = 16, 3
    gb = jgrid.pack_grid(synthetic_samples[:3], grid_cfg, batch_slots=3)
    rng = np.random.default_rng(21)
    feats = (rng.normal(size=tuple(gb.mask.shape) + (hidden,)) * np.asarray(gb.mask)[..., None])
    feats = np.asarray(jbf(feats).astype(jnp.float32))
    stack = jgl.GridHourglass(conv_type="GATCONV", hidden_dim=hidden, repeat=repeat,
                              dtype=jnp.bfloat16)
    key = jax.random.key(0, impl="threefry2x32")
    params = perturb(stack.init({"params": key}, jbf(feats), jnp.array(gb.mask), True)["params"],
                     22, scale=0.1)
    want = stack.apply({"params": params}, jbf(feats), jnp.array(gb.mask), True)
    assert want.dtype == jnp.bfloat16
    want32 = jgl.GridHourglass(conv_type="GATCONV", hidden_dim=hidden, repeat=repeat).apply(
        {"params": params}, jnp.array(feats), jnp.array(gb.mask), True)
    Ws, atts, vecs = (t(a) for a in jhg_pack(params, hidden, repeat))
    chans = hg.hourglass_channel_pairs(hidden, repeat)
    got = hg.hourglass_plain(tbf(feats), t(gb.mask), Ws, atts, vecs, chans)
    assert got.dtype == BF16
    want = np.asarray(want.astype(jnp.float32), np.float64)
    want32 = np.asarray(want32, np.float64)
    flax_err = np.abs(want - want32).max()
    diff = np.abs(got.double().numpy() - want).max()
    assert diff <= 1.5 * flax_err, (diff, flax_err)
    assert_not_f32(got, want32, 2e-2, "hourglass twin")
    assert_not_f32(want, want32, 8e-2, "flax bf16")


def jhg_pack(params, hidden, repeat):
    from building_gan_tpu.ops.pallas import hourglass as jhg

    return [np.asarray(a) for a in jhg.pack_gat_weights(params, hidden, repeat)]
