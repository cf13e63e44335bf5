"""Card-only tests of the training layer's CUDA kernels and the train step.

Marked ``cuda``; each skips where torch sees no GPU (decided in the fixture,
at run time).  No JAX import, so they run on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_train.py

f32 with TF32 off.  Kernel outputs and gradients are held against the plain
version run in float64 by two rules: max abs error at most 4x that of the
plain version run in float32, plus 1e-4 (the narrow GraphNorm layers magnify
f32 rounding, so no fixed tolerance fits both that and a fault); and the
norm-relative error ||kernel - f64|| / ||f64|| at most 4x the plain f32
version's, plus 1e-4, which a few cells where rounding flips a ReLU barely
move and a missing term fails.  Whole stacks and each layer alone.
"""

import math
import os

import pytest
import torch

from building_gan_torch.config import Configuration
from building_gan_torch.data import generate_building, pack_grid_multi, process_building
from building_gan_torch.models.grid_models import GridVoxelGNNDiscriminator, GridVoxelGNNGenerator
from building_gan_torch.ops import dropout as drop
from building_gan_torch.ops import gat_train as gt
from building_gan_torch.ops.hourglass import hourglass_channel_pairs
from building_gan_torch.ops.rng import normal_box_muller
from building_gan_torch.train.state import create_train_state
from building_gan_torch.train.step import make_train_step

ROUNDING_FACTOR, ROUNDING_ATOL, REL_ATOL = 4.0, 1e-4, 1e-4
GRID = (11, 12, 12)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _stack(hidden, repeat, B, K, seed, dev):
    """Zero-padded random weights at the hourglass's real widths, planes, x and keys."""
    gen = torch.Generator().manual_seed(seed)
    chans = hourglass_channel_pairs(hidden, repeat)
    L, R = len(chans), GRID[0] * GRID[1] * GRID[2]
    Ws, atts, vecs = torch.zeros(L, hidden, hidden), torch.zeros(L, 2, hidden), torch.zeros(L, 4, hidden)
    for l, (ci, co) in enumerate(chans):
        Ws[l, :ci, :co] = torch.randn(ci, co, generator=gen) / ci**0.5
        atts[l, :, :co] = torch.randn(2, co, generator=gen) * 0.5
        vecs[l, :, :co] = torch.rand(4, co, generator=gen) + torch.tensor([[-0.5], [0.5], [-0.5], [0.5]])
    mask = (torch.rand(B, R, generator=gen) < 0.7).float()
    gid = torch.randint(0, K, (B, R), generator=gen) if K > 1 else None
    planes = gt.build_planes(mask, gid, GRID)
    keys = torch.randint(0, 2**32, (L, 2), generator=gen, dtype=torch.int64)
    x = torch.randn(B, R, hidden, generator=gen)
    to = lambda a: a.to(dev)  # noqa: E731
    return to(x), to(planes), to(Ws), to(atts), to(vecs), to(keys), chans


def _grads(fn, leaves, gy):
    leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    y = fn(*leaves)
    return [y.detach()] + list(torch.autograd.grad(y, leaves, gy))


def _ulp(t, dtype=torch.bfloat16) -> float:
    """One ulp of the 16-bit dtype (bf16: 8 significant bits, f16: 11) at the largest
    |value| of t."""
    m = t.abs().max().item()
    nmant = round(-math.log2(torch.finfo(dtype).eps))  # stored significand bits: 7, 10
    return 2.0 ** (math.floor(math.log2(m)) - nmant) if m > 0 else 0.0


class _Store(torch.autograd.Function):
    """Identity that rounds to a 16-bit dtype and back, forward and backward: in an
    f64 reference, where a 16-bit kernel stores (a layer's output; its gx)."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.to(dtype).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None


def _stored(t, dtype=torch.bfloat16):
    return t if t.dtype == dtype else _Store.apply(t, dtype)


def _assert_f64_rules(got, want, want64):
    """Max abs and norm-relative rules; an output the twin stores in 16 bits also has one
    ulp of that dtype at its largest value (f32 rounding can move it across a rounding
    boundary)."""
    for name, a, b, c in zip(("y", "gx", "gW", "gatt", "gvec"), got, want, want64):
        assert torch.isfinite(a).all(), name
        err_k = (a.double() - c).abs().max().item()
        err_p = (b.double() - c).abs().max().item()
        ulp = _ulp(c, b.dtype) if b.dtype in (torch.bfloat16, torch.float16) else 0.0
        assert err_k <= ROUNDING_FACTOR * err_p + ROUNDING_ATOL + ulp, (name, err_k, err_p)
        rel_k = ((a.double() - c).norm() / c.norm()).item()
        rel_p = ((b.double() - c).norm() / c.norm()).item()
        assert rel_k <= ROUNDING_FACTOR * rel_p + REL_ATOL, (name, rel_k, rel_p)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,repeat,K", [(128, 7, 6), (64, 3, 1)], ids=["generator_k6", "critic_k1"])
def test_kernels_match_plain_forward_and_backward(hidden, repeat, K, cuda_device):
    x, planes, Ws, atts, vecs, keys, chans = _stack(hidden, repeat, 4, K, hidden + K, cuda_device)
    gy = torch.randn_like(x)
    levels = drop.drop_levels(0.2)

    def fused(*a):
        return gt.hourglass_train(a[0], planes, *a[1:], keys, GRID, K, 0.2, False, chans=chans)

    def plain(*a):
        return gt.hourglass_train_plain(a[0], planes, *a[1:], keys, GRID, K, levels)

    f0, b0 = gt.fwd_launches.value, gt.bwd_launches.value
    got = _grads(fused, (x, Ws, atts, vecs), gy)
    torch.cuda.synchronize()
    assert (gt.fwd_launches.value - f0, gt.bwd_launches.value - b0) == (len(chans), len(chans))
    want = _grads(plain, (x, Ws, atts, vecs), gy)
    want64 = _grads(plain, [a.double() for a in (x, Ws, atts, vecs)], gy.double())
    _assert_f64_rules(got, want, want64)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,repeat,K", [(128, 7, 6), (64, 3, 1)], ids=["generator_k6", "critic_k1"])
def test_each_layer_matches_plain_forward_and_backward(hidden, repeat, K, cuda_device):
    """Each layer alone on the kernel stack's own activations: no compounding, both rules tight."""
    x, planes, Ws, atts, vecs, keys, chans = _stack(hidden, repeat, 4, K, hidden + K + 1, cuda_device)
    gy = torch.randn_like(x)
    levels = drop.drop_levels(0.2)
    for l, (ci, co) in enumerate(chans):
        leaves = (x, Ws[l], atts[l], vecs[l])
        got = _grads(lambda *a: gt.fused_layer(a[0], planes, *a[1:], keys[l], GRID, ci, co, K, levels),
                     leaves, gy)
        plain = lambda *a: gt.layer_plain(a[0], planes, *a[1:], keys[l], GRID, K, levels)  # noqa: E731
        want = _grads(plain, leaves, gy)
        want64 = _grads(plain, [a.double() for a in leaves], gy.double())
        _assert_f64_rules(got, want, want64)
        x = got[0]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,repeat,K", [(128, 7, 6), (64, 3, 1), (32, 5, 3)],
                         ids=["generator_k6", "critic_k1", "odd_co1_k3"])
def test_bf16_kernels_match_plain_forward_and_backward(hidden, repeat, K, cuda_device):
    """bf16 storage: x, y, gy and gx bf16 (rows of 2 co bytes: odd widths give rows on
    no 4-byte boundary), weights and their grads f32.  Each layer alone on the
    kernels' own activations (its backward on gy), against the plain bf16 twins (the
    same roundings) by the f64 rules, the f64 reference taking the same bf16 inputs
    and rounding to bf16 where the kernels store (each layer's y, and gx); the stack's
    output and gradients equal bit for bit the chain of layer calls, each backward fed
    the kernel's gx of the layer above.  A whole bf16 stack is not held by the rules:
    its rounding flips compound through the narrow GraphNorm layers."""
    _hold_16bit_layers(hidden, repeat, K, cuda_device, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,repeat,K", [(128, 7, 6), (64, 3, 1), (32, 5, 3)],
                         ids=["generator_k6", "critic_k1", "odd_co1_k3"])
def test_f16_kernels_match_plain_forward_and_backward(hidden, repeat, K, cuda_device):
    """f16 storage, held as bf16 storage above, with one f16 ulp (11 significant bits)."""
    _hold_16bit_layers(hidden, repeat, K, cuda_device, torch.float16)


def _hold_16bit_layers(hidden, repeat, K, cuda_device, dtype):
    x, planes, Ws, atts, vecs, keys, chans = _stack(hidden, repeat, 4, K, hidden + K + 2, cuda_device)
    x = x.to(dtype)
    gy = torch.randn(x.shape, device=cuda_device).to(dtype)
    levels = drop.drop_levels(0.2)

    def fused(*a):
        return gt.hourglass_train(a[0], planes, *a[1:], keys, GRID, K, 0.2, False, chans=chans)

    f0, b0 = gt.fwd_launches.value, gt.bwd_launches.value
    got = _grads(fused, (x, Ws, atts, vecs), gy)
    torch.cuda.synchronize()
    assert (gt.fwd_launches.value - f0, gt.bwd_launches.value - b0) == (len(chans), len(chans))
    assert [t.dtype for t in got] == [dtype] * 2 + [torch.float32] * 3
    xs = [x]
    with torch.no_grad():
        for l, (ci, co) in enumerate(chans):
            xs.append(gt.fused_layer(xs[-1], planes, Ws[l], atts[l], vecs[l], keys[l], GRID, ci, co,
                                     K, levels))
    assert torch.equal(got[0], xs[-1])
    g = gy
    for l in reversed(range(len(chans))):
        ci, co = chans[l]
        leaves = (xs[l], Ws[l], atts[l], vecs[l])
        kernel = lambda *a: gt.fused_layer(a[0], planes, *a[1:], keys[l], GRID, ci, co, K, levels)  # noqa: E731
        one = lambda *a: _stored(gt.layer_plain(_stored(a[0], dtype), planes, *a[1:], keys[l],  # noqa: E731
                                                GRID, K, levels), dtype)
        want = _grads(one, leaves, gy)
        want64 = _grads(one, [a.double() for a in leaves], gy.double())
        _assert_f64_rules(_grads(kernel, leaves, gy), want, want64)
        chain = _grads(kernel, leaves, g)
        assert all(torch.equal(a, b[l]) for a, b in zip(chain[2:], got[2:])), l
        g = chain[1]
    assert torch.equal(got[1], g)


@pytest.mark.cuda
def test_param_grads_do_not_depend_on_slot_grouping(cuda_device):
    """gW of a batch == the sum over its slots run one at a time (f32 rounding apart)."""
    x, planes, Ws, atts, vecs, keys, chans = _stack(32, 2, 5, 3, 7, cuda_device)
    gy = torch.randn_like(x)
    ci, co = chans[0]
    args = lambda s: (x[s], planes[s], Ws[0], atts[0], vecs[0])  # noqa: E731

    def grads(s):
        leaves = [a.detach().clone().requires_grad_(True) for a in args(s)]
        # keys index elements by their flat position, so a slot alone needs its own
        # offset: with dropout off the layer is the same function on any grouping
        y = gt.fused_layer(leaves[0], leaves[1], *leaves[2:], None, GRID, ci, co, 3, 0)
        return torch.autograd.grad(y, [leaves[0], leaves[2], leaves[3], leaves[4]], gy[s])

    whole = grads(slice(None))
    parts = [grads(slice(b, b + 1)) for b in range(x.shape[0])]
    torch.cuda.synchronize()
    gx = torch.cat([p[0] for p in parts])
    assert torch.allclose(whole[0], gx, rtol=0, atol=0)  # row-local: identical
    for i, name in ((1, "gW"), (2, "gatt"), (3, "gvec")):
        total = sum(p[i] for p in parts)
        scale = whole[i].abs().max().item()
        assert (whole[i] - total).abs().max().item() <= 1e-5 * scale + 1e-6, name
    again = grads(slice(None))
    for a, b in zip(whole, again):
        assert torch.equal(a, b)  # no atomics: bit-reproducible


@pytest.mark.cuda
def test_wrapper_rejects_what_it_does_not_take(cuda_device):
    x, planes, Ws, atts, vecs, keys, chans = _stack(16, 2, 2, 1, 3, cuda_device)
    ci, co = chans[0]
    ok = (x, planes, Ws[0], atts[0], vecs[0], keys[0], GRID, ci, co, 1, 51)
    gt.fused_layer(*ok)
    gt.fused_layer(x.half(), *ok[1:])  # the three storage dtypes are taken
    bad = [
        ((x.double(),) + ok[1:], TypeError),  # dtype
        ((x.to(torch.int32),) + ok[1:], TypeError),
        ((x[:, :-1],) + ok[1:], ValueError),  # rows != grid
        ((x.cpu(),) + ok[1:], ValueError),  # device
        (ok[:2] + (Ws[0].cpu(),) + ok[3:], ValueError),
        (ok[:3] + (atts[0][:1],) + ok[4:], ValueError),  # shape
        ((x.transpose(0, 1).contiguous().transpose(0, 1),) + ok[1:], ValueError),  # layout
        (ok[:5] + (None,) + ok[6:], ValueError),  # dropout without a key
        (ok[:5] + (keys[0].int(),) + ok[6:], TypeError),
        (ok[:7] + (ci + 1,) + ok[8:], ValueError),  # width beyond cmax
        (ok[:9] + (17,) + ok[10:], ValueError),  # K beyond 16
    ]
    for args, exc in bad:
        with pytest.raises(exc):
            gt.fused_layer(*args)


@pytest.mark.cuda
def test_train_step_launches_both_kernels(cuda_device):
    cfg = Configuration(
        COMPUTE_DTYPE="float32", GRID_SHAPE=(10, 8, 8), GENERATOR_HIDDEN_DIM=32,
        GENERATOR_ENCODER_REPEAT=2, LOCAL_ENCODER_HIDDEN_DIM=32, Z_DIM=16,
        GENERATOR_MLP_ENCODER_REPEAT=1, LOCAL_GRAPH_ENCODER_REPEAT=1,
        DISCRIMINATOR_ENCODER_REPEAT=2, DISCRIMINATOR_HIDDEN_DIM=32, N_CRITIC=2,
        GRID_LOCAL_NODES=128, GRID_SLOT_GRAPHS=3, GRID_PACK_MODE="cell",
    )
    samples = [process_building(*generate_building(1000 + i), cfg, str(i)) for i in range(8)]
    samples = [s for s in samples if int(s[1].location[:, 0].max()) < 10]
    batch = pack_grid_multi(samples, cfg, batch_slots=6).to(cuda_device)
    torch.manual_seed(0)
    state = create_train_state(cfg, GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg))
    assert next(state.generator.parameters()).is_cuda  # the card is the default
    step = make_train_step(cfg, state)
    f0, b0, d0 = gt.fwd_launches.value, gt.bwd_launches.value, gt.bytes_launches.value
    metrics = step(batch, torch.Generator(device=cuda_device).manual_seed(0))
    torch.cuda.synchronize()
    Lg = Ld = 4
    assert gt.fwd_launches.value - f0 == cfg.N_CRITIC * (Lg + 2 * Ld) + Lg + Ld
    assert gt.bwd_launches.value - b0 == cfg.N_CRITIC * 2 * Ld + Ld + Lg
    # the plain GP critic pass draws its dropout bytes with the Philox kernel
    assert gt.bytes_launches.value - d0 == cfg.N_CRITIC * Ld
    for k, v in metrics.items():
        assert torch.isfinite(v).all(), k


@pytest.mark.cuda
@pytest.mark.parametrize("gp_dtype", ["compute", "float32"])
def test_bf16_train_step_launches_both_kernels(gp_dtype, cuda_device):
    """The train step at the JAX package's default COMPUTE_DTYPE (bf16), the GP pass at
    GP_DTYPE: the same kernel and dropout-byte launches as f32, finite losses, f32
    parameters."""
    cfg = Configuration(
        GP_DTYPE=gp_dtype, GRID_SHAPE=(10, 8, 8), GENERATOR_HIDDEN_DIM=32,
        GENERATOR_ENCODER_REPEAT=2, LOCAL_ENCODER_HIDDEN_DIM=32, Z_DIM=16,
        GENERATOR_MLP_ENCODER_REPEAT=1, LOCAL_GRAPH_ENCODER_REPEAT=1,
        DISCRIMINATOR_ENCODER_REPEAT=2, DISCRIMINATOR_HIDDEN_DIM=32, N_CRITIC=2,
        GRID_LOCAL_NODES=128, GRID_SLOT_GRAPHS=3, GRID_PACK_MODE="cell",
    )
    assert cfg.COMPUTE_DTYPE == "bfloat16"
    samples = [process_building(*generate_building(1000 + i), cfg, str(i)) for i in range(8)]
    samples = [s for s in samples if int(s[1].location[:, 0].max()) < 10]
    batch = pack_grid_multi(samples, cfg, batch_slots=6).to(cuda_device)
    torch.manual_seed(0)
    state = create_train_state(cfg, GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg))
    step = make_train_step(cfg, state)
    f0, b0, d0 = gt.fwd_launches.value, gt.bwd_launches.value, gt.bytes_launches.value
    metrics = step(batch, torch.Generator(device=cuda_device).manual_seed(0))
    torch.cuda.synchronize()
    Lg = Ld = 4
    assert gt.fwd_launches.value - f0 == cfg.N_CRITIC * (Lg + 2 * Ld) + Lg + Ld
    assert gt.bwd_launches.value - b0 == cfg.N_CRITIC * 2 * Ld + Ld + Lg
    assert gt.bytes_launches.value - d0 == cfg.N_CRITIC * Ld
    for k, v in metrics.items():
        assert torch.isfinite(v).all(), k
    for m in (state.generator, state.discriminator):
        assert {p.dtype for p in m.parameters()} == {torch.float32}


@pytest.mark.cuda
@pytest.mark.parametrize("C,width", [(64, 64), (16, 64), (1, 128)])
def test_gp_dropout_masks_from_the_kernel_match_keep_mask(C, width, cuda_device):
    B, R = 3, GRID[0] * GRID[1] * GRID[2]
    gen = torch.Generator(device=cuda_device).manual_seed(C)
    keys = drop.draw_keys(4, gen)
    levels = drop.drop_levels(0.2)
    x = torch.ones(B, R, C, device=cuda_device)
    for key in keys:
        before = gt.bytes_launches.value
        kept = drop.dropout(x, key, 0.2, width=width) != 0
        assert gt.bytes_launches.value == before + 1
        assert torch.equal(kept, drop.keep_mask((B, R, C), key, levels, width, cuda_device))
        assert torch.equal(drop.dropout(x.cpu(), key.cpu(), 0.2, width=width) != 0, kept.cpu())


def _tiny_cfg(**kw):
    return Configuration(
        GRID_SHAPE=(10, 8, 8), GENERATOR_HIDDEN_DIM=32, GENERATOR_ENCODER_REPEAT=2,
        LOCAL_ENCODER_HIDDEN_DIM=32, Z_DIM=16, GENERATOR_MLP_ENCODER_REPEAT=1,
        LOCAL_GRAPH_ENCODER_REPEAT=1, DISCRIMINATOR_ENCODER_REPEAT=2, DISCRIMINATOR_HIDDEN_DIM=32,
        N_CRITIC=2, GRID_LOCAL_NODES=128, GRID_SLOT_GRAPHS=3, GRID_PACK_MODE="cell",
        TRANSFORMER_LAYERS=2, **kw)


def _launches():
    from building_gan_torch.ops import hourglass as hg

    return (hg.launches.value, gt.fwd_launches.value, gt.bwd_launches.value,
            gt.bytes_launches.value)


def _one_step(cfg, batch, gen, disc, dev):
    """One train step on the card from fresh models; -> (metrics, launches it made:
    hourglass, training forward, training backward, dropout bytes)."""
    state = create_train_state(cfg, gen, disc)
    before = _launches()
    metrics = make_train_step(cfg, state)(batch, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    for k, v in metrics.items():
        assert torch.isfinite(v).all(), k
    return metrics, tuple(b - a for a, b in zip(before, _launches()))


def _grid_batch(cfg, dev):
    samples = [process_building(*generate_building(1000 + i), cfg, str(i)) for i in range(8)]
    samples = [s for s in samples if int(s[1].location[:, 0].max()) < 10]
    return pack_grid_multi(samples, cfg, batch_slots=6).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("conv", ["GATV2CONV", "GCNCONV", "GRAPHCONV"])
def test_plain_grid_conv_step_runs_on_the_card(conv, cuda_device):
    """A plain grid conv at the JAX default bf16: finite, no layer-kernel launch, every
    dropout mask's bytes from the Philox kernel (each critic update's generator, real,
    fake and GP passes, then the G update's generator and critic)."""
    cfg = _tiny_cfg(GENERATOR_CONV_TYPE=conv, DISCRIMINATOR_CONV_TYPE=conv)
    torch.manual_seed(0)
    _, got = _one_step(cfg, _grid_batch(cfg, cuda_device), GridVoxelGNNGenerator(cfg),
                       GridVoxelGNNDiscriminator(cfg), cuda_device)
    Lg = Ld = 4
    assert got == (0, 0, 0, cfg.N_CRITIC * (Lg + 3 * Ld) + Lg + Ld)


@pytest.mark.cuda
@pytest.mark.parametrize("conv", ["GATCONV", "GATV2CONV"])
def test_edge_pack_step_runs_on_the_card(conv, cuda_device):
    """A packed edge-list batch at the JAX default bf16: finite, no layer-kernel launch."""
    from building_gan_torch.data.batching import pack_graphs
    from building_gan_torch.models.discriminator import VoxelGNNDiscriminator
    from building_gan_torch.models.generator import VoxelGNNGenerator

    cfg = _tiny_cfg(LAYOUT="edges", GENERATOR_CONV_TYPE=conv, DISCRIMINATOR_CONV_TYPE=conv,
                    PACK_GRAPHS=4, PACK_LOCAL_NODES=256, PACK_LOCAL_EDGES=2048,
                    PACK_VOXEL_NODES=2048, PACK_VOXEL_EDGES=16384)
    samples = [process_building(*generate_building(1000 + i), cfg, str(i)) for i in range(4)]
    batch = pack_graphs(samples, cfg)[0].to(cuda_device)
    torch.manual_seed(0)
    _, got = _one_step(cfg, batch, VoxelGNNGenerator(cfg), VoxelGNNDiscriminator(cfg), cuda_device)
    Lg = Ld = 4
    assert got == (0, 0, 0, cfg.N_CRITIC * (Lg + 3 * Ld) + Lg + Ld)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bce", "batch_level_matching", "batch_level_graphnorm",
                                  "transformer"])
def test_mode_steps_launch_as_expected(mode, cuda_device):
    """The other training modes on the card at bf16: the BCE step fuses every critic pass
    (no penalty, so no plain pass and no dropout-byte launch); batch-level matching keeps
    both models fused; batch-level GraphNorm runs both plain; the transformer generator
    runs plain (two dropout sites a block) against the fused critic."""
    from building_gan_torch.models.transformer import GridTransformerGenerator

    cfg = _tiny_cfg(**{"bce": {"USE_WGANGP": False},
                       "batch_level_matching": {"BATCH_LEVEL_MATCHING": True},
                       "batch_level_graphnorm": {"BATCH_LEVEL_GRAPHNORM": True},
                       "transformer": {"GENERATOR_ARCH": "transformer"}}[mode])
    G = GridTransformerGenerator if mode == "transformer" else GridVoxelGNNGenerator
    torch.manual_seed(0)
    metrics, got = _one_step(cfg, _grid_batch(cfg, cuda_device), G(cfg),
                             GridVoxelGNNDiscriminator(cfg), cuda_device)
    n, Lg, Ld, T = cfg.N_CRITIC, 4, 4, 2 * cfg.TRANSFORMER_LAYERS
    want = {
        "bce": (0, n * (Lg + 2 * Ld) + Lg + Ld, n * 2 * Ld + Ld + Lg, 0),
        "batch_level_matching": (0, n * (Lg + 2 * Ld) + Lg + Ld, n * 2 * Ld + Ld + Lg, n * Ld),
        "batch_level_graphnorm": (0, 0, 0, n * (Lg + 3 * Ld) + Lg + Ld),
        "transformer": (0, n * 2 * Ld + Ld, n * 2 * Ld + Ld, (n + 1) * T + n * Ld),
    }[mode]
    assert got == want
    if mode == "bce":
        assert float(metrics["d_loss"]) > 0 and float(metrics["g_loss_adv"]) > 0


def _tiny_trainer(tmp_path, dev, **kw):
    from building_gan_torch.data import write_dataset
    from building_gan_torch.data.pipeline import GraphDataLoaders
    from building_gan_torch.data.preprocess import create_dataset
    from building_gan_torch.train.trainer import Trainer

    cfg = Configuration(
        COMPUTE_DTYPE="float32", GRID_SHAPE=(10, 8, 8), GRID_BATCH=4, GRID_SLOT_GRAPHS=3,
        GRID_PACK_MODE="cell", GRID_LOCAL_NODES=128, N_CRITIC=2, EPOCHS=1,
        DATA_PATH=str(tmp_path / "raw"), SAVE_DATA_PATH=str(tmp_path / "npz"), **kw,
    )
    if not os.path.exists(cfg.SAVE_DATA_PATH):
        write_dataset(cfg.DATA_PATH, 16, seed=5)
        create_dataset(cfg, verbose=False)
    torch.manual_seed(0)
    return Trainer(GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg), GraphDataLoaders(cfg),
                   cfg, log_dir=str(tmp_path / "run"), device=dev)


@pytest.mark.cuda
def test_eval_step_and_generate_launch_the_kernels(tmp_path, cuda_device):
    from building_gan_torch.ops import hourglass as hg

    trainer = _tiny_trainer(tmp_path, cuda_device)  # the config of record's widths
    batch = next(iter(trainer.dataloaders.validation_dataloader)).to(cuda_device)
    Ld = len(trainer.discriminator.encoder.channels)
    h0, f0 = hg.launches.value, gt.fwd_launches.value
    metrics = trainer.eval_step(batch, torch.Generator(device=cuda_device).manual_seed(1))
    torch.cuda.synchronize()
    assert (hg.launches.value - h0, gt.fwd_launches.value - f0) == (1, Ld)
    for k, v in metrics.items():
        assert torch.isfinite(v).all(), k
    h0, f0 = hg.launches.value, gt.fwd_launches.value
    logits, hard, _ = trainer.generate(batch, torch.Generator(device=cuda_device).manual_seed(2))
    torch.cuda.synchronize()
    assert (hg.launches.value - h0, gt.fwd_launches.value - f0) == (1, 0)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    z = normal_box_muller(tuple(batch.mask.shape) + (trainer.configuration.Z_DIM,), g)
    with torch.no_grad():
        plain, _, _ = trainer.generator(batch, z, generator=g)
    assert (logits - plain).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_checkpoint_written_on_the_card_loads_on_the_cpu(tmp_path, cuda_device):
    from building_gan_torch.checkpoint import ckpt

    trainer = _tiny_trainer(tmp_path, cuda_device, GENERATOR_HIDDEN_DIM=32, DISCRIMINATOR_HIDDEN_DIM=32,
                            LOCAL_ENCODER_HIDDEN_DIM=32, Z_DIM=16)
    batch = next(iter(trainer.dataloaders.train_dataloader)).to(cuda_device)
    trainer.train_step(batch, torch.Generator(device=cuda_device).manual_seed(0))
    ckpt.save_states(trainer.log_dir, trainer.state, {"epoch_start": 1})
    cpu = _tiny_trainer(tmp_path, "cpu", GENERATOR_HIDDEN_DIM=32, DISCRIMINATOR_HIDDEN_DIM=32,
                        LOCAL_ENCODER_HIDDEN_DIM=32, Z_DIM=16)
    assert cpu.state.step == 1
    for name in ("generator", "discriminator", "opt_g", "opt_d"):
        want, got = getattr(trainer.state, name).state_dict(), getattr(cpu.state, name).state_dict()
        pairs = list(zip(_tensors(want), _tensors(got)))
        assert pairs
        for a, b in pairs:
            assert b.device.type == "cpu" and torch.equal(a.cpu(), b), name


def _tensors(tree):
    """The tensors of a state_dict, in key order."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _tensors(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


@pytest.mark.cuda
def test_sanity_overfit_one_building(cuda_device):
    """The port of tests/test_train.py::test_sanity_overfit_one_building (the edge layout
    there) on the grid's fused route at the config of record's widths: one real-scale
    building in one slot (K=1), N_CRITIC=1, the supervised term on (LAMBDA_LABEL=10) and
    LEARNING_RATE_GENERATOR=1e-3, as there; 1,500 steps at the default bf16.  The F1
    after the last step must pass 0.5 and the F1 after the first 100 steps."""
    import time

    from building_gan_torch.data import generate_building_real_scale, pack_grid

    cfg = Configuration(sanity_checking=True, N_CRITIC=1, LAMBDA_LABEL=10.0,
                        LEARNING_RATE_GENERATOR=1e-3)
    sample = process_building(*generate_building_real_scale(77), cfg, "000077")
    cfg = cfg.replace(GRID_LOCAL_NODES=64 * math.ceil(sample[0].x.shape[0] / 64))
    batch = pack_grid([sample], cfg, batch_slots=1).to(cuda_device)
    torch.manual_seed(0)
    state = create_train_state(cfg, GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg))
    step = make_train_step(cfg, state)
    gen = torch.Generator(device=cuda_device).manual_seed(42)
    f1, f0 = [], gt.fwd_launches.value
    t = time.perf_counter()
    for _ in range(1500):
        f1.append(step(batch, gen)["f1"])
    f1 = torch.stack(f1).cpu()
    seconds = time.perf_counter() - t
    print(f"sanity overfit: {sample[1].x.shape[0]} voxels, F1 after steps 1 / 100 / 1500: "
          f"{f1[0]:.4f} / {f1[99]:.4f} / {f1[-1]:.4f}; {seconds:.1f} s for 1500 steps")
    assert gt.fwd_launches.value - f0 == 1500 * (2 * 14 + 3 * 6)  # every step fused
    assert torch.isfinite(f1).all()
    assert f1[-1] > 0.5 and f1[-1] > f1[99]
