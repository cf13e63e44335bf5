"""The packed edge-list layout (``LAYOUT="edges"``): the port against the JAX package (CPU).

Same seeded numpy inputs and the same weights on both sides (flax params
through the port's converters), tests/test_train.py::tiny_cfg widths on
small_cfg's packs:

- ``pack_graphs`` / ``stack_packs`` / ``null_like``: every array bit-equal to
  the JAX package's, and a building over a budget raises;
- the segment ops (an empty and a fully masked segment included),
  ``gat_aggregate`` and the type-matched pooling, per graph and over the
  whole pack (``batch_level``, quirk Q1);
- the four edge convs, ``GraphNorm`` and ``HourglassGNN``;
- both edge models for all four convs, deterministic and with dropout (the
  port's Philox masks given to the flax side);
- the edge models of all four convs at the JAX default COMPUTE_DTYPE
  bfloat16 (what ``--layout edges`` trains at), and their critic loss with its
  penalty at GP_DTYPE "compute" and "float32";
- ``generator_loss``, ``discriminator_loss`` with the gradient penalty (and
  the critic's parameter gradients through its double backward: the edge
  softmax's shift by the segment max carries no gradient in the port) and
  ``compute_metrics`` on a ``PackedBatch``;
- grid-vs-edge parity in the port for all four convs: one ``state_dict``
  loaded into the grid and the edge models, two buildings, logits and scores
  on real cells;
- a train step on a ``PackedBatch`` (runs, updates, launches no kernel), and
  the eval step;
- the in-repo ref10k seed-42 checkpoint (GATCONV), converted, through
  ``Trainer.test`` at ``LAYOUT="edges"`` on the 190 buildings that
  tests/test_torch_ckpt.py tests on the grid.

Tolerances: exact for packing and metrics' confusion matrices; rtol 1e-4 /
atol 1e-5 for ops and layers (tests/test_torch_layers.py); rtol 1e-4 / atol
1e-4 for the hourglass, logits and scores (tests/test_torch_generator.py)
plus twice the case's f32 rounding (tests/test_torch_convs.py::hold); losses
rtol 1e-4 / atol 1e-5 and critic gradients within 1e-4 of their largest
magnitude plus 1e-6 (tests/test_torch_losses.py); grid-vs-edge parity rtol
5e-3 / atol 1e-3, the JAX package's own (tests/test_grid.py); the ref10k
test F1 >= 0.98 and within 0.005 of the grid layout's on the same buildings.
bf16: logits and scores on real nodes by tests/test_torch_bf16_models.py's
rules (1)-(3) (a padded node's values are rounding noise: the JAX package's
bf16 GATCONV logits there are 0.79 from its f32 ones, on real nodes 0.088),
the critic loss by tests/test_torch_convs.py::hold_critic_loss_bf16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from building_gan_tpu.config import Configuration as JConfiguration
from building_gan_tpu.data import batching as jbatching
from building_gan_tpu.data import pipeline as jpipe
from building_gan_tpu.models import VoxelGNNDiscriminator as JEdgeDiscriminator
from building_gan_tpu.models import VoxelGNNGenerator as JEdgeGenerator
from building_gan_tpu.models import layers as jlayers
from building_gan_tpu.ops import message_passing as jmp
from building_gan_tpu.ops import pooling as jpool
from building_gan_tpu.ops import segment as jseg
from building_gan_tpu.ops.rng import bulk_key
from building_gan_tpu.train import losses as JL
from building_gan_tpu.train import metrics as JM

from building_gan_torch.checkpoint.torch_compat import (
    discriminator_params_to_state_dict, generator_params_to_state_dict,
)
from building_gan_torch.data import batching as tbatching
from building_gan_torch.data import pipeline as tpipe
from building_gan_torch.data.grid import pack_grid
from building_gan_torch.data.pipeline import GraphDataLoaders
from building_gan_torch.data.preprocess import create_dataset
from building_gan_torch.data.synthetic import write_dataset
from building_gan_torch.models import layers as tlayers
from building_gan_torch.models.discriminator import VoxelGNNDiscriminator
from building_gan_torch.models.generator import VoxelGNNGenerator
from building_gan_torch.models.grid_models import GridVoxelGNNDiscriminator, GridVoxelGNNGenerator
from building_gan_torch.ops import dropout as drop
from building_gan_torch.ops import gat_train as gt
from building_gan_torch.ops import message_passing as tmp
from building_gan_torch.ops import pooling as tpool
from building_gan_torch.ops import segment as tseg
from building_gan_torch.train import losses as TL
from building_gan_torch.train import metrics as TM
from building_gan_torch.train.state import create_train_state
from building_gan_torch.train.step import make_eval_step, make_train_step
from building_gan_torch.train.trainer import Trainer

from test_torch_bf16_models import LOGIT_RTOL, assert_as_accurate, assert_not_f32, assert_rel
from test_torch_convs import (
    _conv_state_dict, as_f64, bf16_loss_refs, hold, hold_critic_loss_bf16, masks_if,
)
from test_torch_layers import perturb, port_cfg, t
from test_torch_losses import _st_gumbel_jax
from test_train import tiny_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

RTOL, ATOL = 1e-4, 1e-5  # ops and layers
LOSS_RTOL, LOSS_ATOL, GRAD_TOL = 1e-4, 1e-5, 1e-4
PARITY_RTOL, PARITY_ATOL = 5e-3, 1e-3  # grid vs edge, as tests/test_grid.py
TEST_F1_FLOOR, LAYOUT_F1_GAP = 0.98, 0.005
CONVS = ("GATCONV", "GATV2CONV", "GCNCONV", "GRAPHCONV")
REF10K = "runs/ref10k-rbgfull-seed42/states.msgpack"


def port_pack(jpack) -> tbatching.PackedBatch:
    """A JAX PackedBatch as the port's (integer arrays as int64 tensors)."""
    return tbatching.PackedBatch.from_numpy(
        **{f.name: np.asarray(getattr(jpack, f.name)) for f in dataclasses.fields(tbatching.PackedBatch)})


def assert_packs_equal(jpack, tpack, where=""):
    for f in dataclasses.fields(tbatching.PackedBatch):
        j, tt = np.asarray(getattr(jpack, f.name)), getattr(tpack, f.name)
        assert j.shape == tuple(tt.shape), f"{where} {f.name}"
        assert np.issubdtype(j.dtype, np.integer) == (tt.dtype == torch.int64), f"{where} {f.name}"
        assert np.array_equal(j, tt.numpy()), f"{where} {f.name}"


@pytest.fixture(scope="module")
def edge_cfg(small_cfg):
    return tiny_cfg(small_cfg, COMPUTE_DTYPE="float32")


@pytest.fixture(scope="module")
def packs(synthetic_samples, edge_cfg):
    """(JAX packs, the port's packs) of the eight synthetic buildings."""
    return (jbatching.pack_graphs(synthetic_samples, edge_cfg),
            tbatching.pack_graphs(synthetic_samples, port_cfg(edge_cfg)))


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------


def test_packed_batches_are_bit_equal_to_jax(packs, synthetic_samples, edge_cfg):
    jp, tp = packs
    assert len(jp) == len(tp) == 2
    for i, (a, b) in enumerate(zip(jp, tp)):
        assert_packs_equal(a, b, f"pack {i}")
        assert b.num_graph_slots == edge_cfg.PACK_GRAPHS
        assert int(b.voxel_graph_id.max()) == edge_cfg.PACK_GRAPHS  # the padding's segment
        dst = b.voxel_dst[b.voxel_edge_mask > 0]
        assert bool((dst[1:] >= dst[:-1]).all())  # sorted by destination
    assert_packs_equal(jbatching.stack_packs(jp), tbatching.stack_packs(tp), "stacked")
    assert_packs_equal(jpipe.null_like(jp[0]), tpipe.null_like(tp[0]), "null")
    tight = port_cfg(edge_cfg).replace(PACK_VOXEL_NODES=8)
    for pack_fn, cfg in ((jbatching.pack_graphs, edge_cfg.replace(PACK_VOXEL_NODES=8)),
                         (tbatching.pack_graphs, tight)):
        with pytest.raises(ValueError, match="exceeds pack budgets"):
            pack_fn(synthetic_samples[:2], cfg)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_segment_ops_match_jax(op):
    rng = np.random.default_rng(21)
    n, segments = 40, 7
    ids = rng.choice([0, 1, 2, 3, 5], size=n)  # segment 4 and 6 empty
    ids[:3] = 5
    mask = (rng.random(n) < 0.7).astype(np.float32)
    mask[ids == 5] = 0.0  # segment 5 fully masked
    values = rng.normal(size=(n, 3)).astype(np.float32)
    jids, tids = jnp.asarray(ids), torch.as_tensor(ids)
    if op == "sum":
        want = jseg.segment_sum(jnp.asarray(values), jids, segments)
        got = tseg.segment_sum(t(values), tids, segments)
    elif op == "mean":
        want = jseg.segment_mean(jnp.asarray(values), jids, segments, weights=jnp.asarray(mask))
        got = tseg.segment_mean(t(values), tids, segments, weights=t(mask))
        assert float(got[4].abs().max()) == 0.0  # empty: 0, not NaN
    else:
        want = jseg.segment_max(jnp.asarray(values), jids, segments, mask=jnp.asarray(mask))
        got = tseg.segment_max(t(values), tids, segments, mask=t(mask))
        assert float(got[5].max()) == float(got[4].max()) == float(np.float32(tseg.NEG_INF))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_gat_aggregate_matches_jax(packs):
    p = packs[0][0]
    rng = np.random.default_rng(22)
    nv = p.voxel_x.shape[0]
    h = rng.normal(size=(nv, 5)).astype(np.float32)
    a_src, a_dst = (rng.normal(size=nv).astype(np.float32) * 2 for _ in range(2))
    edges = (p.voxel_src, p.voxel_dst, p.voxel_edge_mask)
    want = jmp.gat_aggregate_xla(jnp.asarray(h), jnp.asarray(a_src), jnp.asarray(a_dst),
                                 *(jnp.asarray(e) for e in edges))
    got = tmp.gat_aggregate(t(h), t(a_src), t(a_dst), *(torch.as_tensor(np.asarray(e)).long()
                                                        if e.dtype != np.float32 else t(e)
                                                        for e in edges))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_type_matched_pooling_matches_jax(packs):
    jp, tp = packs[0][1], packs[1][1]
    rng = np.random.default_rng(23)
    lx = rng.normal(size=jp.local_x.shape).astype(np.float32)
    args = ("local_type", "local_graph_id", "local_mask", "voxel_type", "voxel_graph_id")
    G = jp.graph_mask.shape[0]
    want = jpool.type_matched_pooling(jnp.asarray(lx), *(jnp.asarray(getattr(jp, a)) for a in args), G)
    got = tpool.type_matched_pooling(t(lx), *(getattr(tp, a) for a in args), G)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    want = jpool.type_matched_pooling(jnp.asarray(lx), *(jnp.asarray(getattr(jp, a)) for a in args), G,
                                      batch_level=True)
    got = tpool.type_matched_pooling(t(lx), *(getattr(tp, a) for a in args), G, batch_level=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _voxel_graph(packs, seed, c):
    jp, tp = packs[0][0], packs[1][0]
    x = np.random.default_rng(seed).normal(size=(jp.voxel_x.shape[0], c)).astype(np.float32)
    jedges = (jnp.asarray(jp.voxel_src), jnp.asarray(jp.voxel_dst), jnp.asarray(jp.voxel_edge_mask))
    tedges = (tp.voxel_src, tp.voxel_dst, tp.voxel_edge_mask)
    return jp, tp, x, jedges, tedges


@pytest.mark.parametrize("conv", CONVS)
def test_edge_convs_match_flax(conv, packs, highest_precision):
    _, _, x, jedges, tedges = _voxel_graph(packs, 24, 8)
    jconv = jlayers.CONV_REGISTRY[conv](features=5)
    params = perturb(jconv.init(jax.random.key(6), jnp.asarray(x), *jedges)["params"], 25)
    want = jconv.apply({"params": params}, jnp.asarray(x), *jedges)
    mine = tlayers.CONV_REGISTRY[conv](8, 5)
    mine.load_state_dict(_conv_state_dict(params, None))
    with torch.no_grad():
        got = mine(t(x), *tedges)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_graph_norm_matches_flax(packs):
    jp, tp, x, _, _ = _voxel_graph(packs, 26, 6)
    G1 = jp.graph_mask.shape[0] + 1
    norm = jlayers.GraphNorm(features=6)
    args = (jnp.asarray(jp.voxel_graph_id), G1, jnp.asarray(jp.voxel_mask))
    params = perturb(norm.init(jax.random.key(7), jnp.asarray(x), *args)["params"], 27)
    want = norm.apply({"params": params}, jnp.asarray(x), *args)
    mine = tlayers.GraphNorm(6)
    mine.load_state_dict({k: t(v) for k, v in params.items()})
    with torch.no_grad():
        got = mine(t(x), tp.voxel_graph_id, G1, tp.voxel_mask)
    real = jp.voxel_mask > 0
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("conv", CONVS)
def test_hourglass_matches_flax(conv, packs, highest_precision):
    jp, tp, x, jedges, tedges = _voxel_graph(packs, 28, 16)
    G1 = jp.graph_mask.shape[0] + 1
    hg = jlayers.HourglassGNN(conv_type=conv, hidden_dim=16, repeat=2)
    rest = (jnp.asarray(jp.voxel_graph_id), G1, jnp.asarray(jp.voxel_mask), True)
    params = perturb(hg.init(jax.random.key(8), jnp.asarray(x), *jedges, *rest)["params"], 29, 0.05)
    want = hg.apply({"params": params}, jnp.asarray(x), *jedges, *rest)
    mine = tlayers.HourglassGNN(16, 2, conv_type=conv)
    sd = generator_params_to_state_dict({"encoder": params}, None)
    mine.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()})
    args = (*tedges, tp.voxel_graph_id, G1, tp.voxel_mask)
    with torch.no_grad():
        got = mine(t(x), *args)
        ref64 = mine.double()(t(x).double(), *args[:2], args[2].double(), *args[3:5],
                              args[5].double())
    hold(got, want, ref64)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=CONVS)
def edge_models(request, packs, edge_cfg):
    """One conv's flax edge generator and critic (perturbed params) on the first pack, and
    the port's edge models loaded through the converters."""
    conv = request.param
    cfg = edge_cfg.replace(GENERATOR_CONV_TYPE=conv, DISCRIMINATOR_CONV_TYPE=conv)
    jp = packs[0][0]
    nv = jp.voxel_x.shape[0]
    rng = np.random.default_rng(30)
    z = rng.normal(size=(nv, cfg.Z_DIM)).astype(np.float32)
    noise = rng.gumbel(size=(nv, 7)).astype(np.float32)
    label = np.eye(7, dtype=np.float32)[rng.integers(0, 7, nv)]
    key = jax.random.key(9)
    with jax.default_matmul_precision("highest"):
        gen = JEdgeGenerator(configuration=cfg, dtype=jnp.float32)
        disc = JEdgeDiscriminator(configuration=cfg, dtype=jnp.float32)
        pg = perturb(jax.jit(lambda: gen.init({"params": key, "gumbel": key}, jp, jnp.asarray(z),
                                              deterministic=True))()["params"], 31, 0.05)
        pd = perturb(jax.jit(lambda: disc.init({"params": key}, jp, jnp.asarray(label),
                                               deterministic=True))()["params"], 32, 0.05)
    tcfg = port_cfg(cfg)
    tgen, tdisc = VoxelGNNGenerator(tcfg), VoxelGNNDiscriminator(tcfg)
    tgen.load_state_dict(generator_params_to_state_dict(pg, tcfg))
    tdisc.load_state_dict(discriminator_params_to_state_dict(pd, tcfg))
    return cfg, tcfg, jp, packs[1][0], z, noise, label, key, gen, disc, pg, pd, tgen, tdisc


def _edge_masks(encoder, nv, keys, rate):
    """The port's keep masks of each hourglass layer (NV, co) as float numpy."""
    levels = drop.drop_levels(rate)
    return [drop.keep_mask((1, nv, co), keys[i], levels, width=encoder.hidden_dim)[0]
            .numpy().astype(np.float32) for i, co in enumerate(encoder.channels)]


@pytest.mark.parametrize("training", [False, True], ids=["deterministic", "dropout"])
def test_edge_generator_matches_flax(edge_models, training):
    cfg, _, jp, tp, z, noise, _, key, gen, _, pg, _, tgen, _ = edge_models
    nv = jp.voxel_x.shape[0]
    keys = drop.draw_keys(len(tgen.encoder.channels), torch.Generator().manual_seed(7))
    masks = _edge_masks(tgen.encoder, nv, keys, cfg.ENCODER_DROPOUT_RATE)
    with jax.default_matmul_precision("highest"), masks_if(training, masks):
        want, _, _ = gen.apply({"params": pg}, jp, jnp.asarray(z), deterministic=not training,
                               rngs={"gumbel": key, "dropout": key})
    gen64, tp64 = as_f64(tgen, tp)
    with torch.no_grad():
        got, hard, _ = tgen(tp, t(z), gumbel_noise=t(noise), deterministic=not training, keys=keys)
        ref64, _, _ = gen64(tp64, t(z).double(), gumbel_noise=t(noise).double(),
                            deterministic=not training, keys=keys)
    assert got.shape == (nv, 7) and hard.shape == (nv, 7)
    hold(got, want, ref64)


@pytest.mark.parametrize("training", [False, True], ids=["deterministic", "dropout"])
def test_edge_critic_matches_flax(edge_models, training):
    cfg, _, jp, tp, _, _, label, key, _, disc, _, pd, _, tdisc = edge_models
    nv = jp.voxel_x.shape[0]
    keys = drop.draw_keys(len(tdisc.encoder.channels), torch.Generator().manual_seed(8))
    masks = _edge_masks(tdisc.encoder, nv, keys, cfg.ENCODER_DROPOUT_RATE)
    with jax.default_matmul_precision("highest"), masks_if(training, masks):
        want = disc.apply({"params": pd}, jp, jnp.asarray(label), deterministic=not training,
                          rngs={"dropout": key})
    disc64, tp64 = as_f64(tdisc, tp)
    with torch.no_grad():
        got = tdisc(tp, t(label), deterministic=not training, keys=keys)
        ref64 = disc64(tp64, t(label).double(), deterministic=not training, keys=keys)
    assert got.shape == (nv, 1)
    hold(got, want, ref64)


def critic_grads(disc, batch, types_onehot, label_hard, label_soft, eps, cfg):
    """(critic loss, {name: gradient}) of ``disc`` on ``batch``, at the batch's float dtype."""
    dt = batch.voxel_x.dtype
    disc.zero_grad()
    loss = TL.discriminator_loss(lambda lbl: disc(batch, lbl), *(t(a).to(dt) for a in (
        types_onehot, label_hard, label_soft)), batch.voxel_mask, cfg, eps=t(eps).to(dt))
    loss.backward()
    return loss, {k: p.grad.clone() for k, p in disc.named_parameters()}


@pytest.mark.parametrize("edge_models", ["GATCONV", "GATV2CONV"], indirect=True)
def test_losses_and_metrics_on_a_packed_batch_match_jax(edge_models):
    """The critic loss with its penalty (and its parameter gradients), the generator loss
    and its terms, and the metrics: the JAX functions on the same inputs.  The two
    attention convs, whose softmax shift (the segment max) the port keeps out of the
    double backward.  Each gradient within GRAD_TOL of its largest magnitude, plus
    twice its f32 rounding (its distance from the port's f64 gradient): the
    encoder's GraphNorm layers amplify rounding, and both packages' decoder
    gradients are ~3e-4 of scale from the f64 ones."""
    cfg, tcfg, jp, tp, z, noise, _, key, gen, disc, pg, pd, tgen, tdisc = edge_models
    mask = jnp.asarray(jp.voxel_mask)
    types_onehot = jax.nn.one_hot(jnp.asarray(jp.voxel_type), 7) * mask[:, None]
    with jax.default_matmul_precision("highest"):
        logits, _, _ = gen.apply({"params": pg}, jp, jnp.asarray(z), deterministic=True,
                                 rngs={"gumbel": key})
        label_hard, label_soft = jax.lax.stop_gradient(_st_gumbel_jax(logits, jnp.asarray(noise)))
        eps = jax.random.uniform(bulk_key(key), mask.shape + (1,), dtype=types_onehot.dtype)

        def d_loss(p):
            return JL.discriminator_loss(
                lambda lbl: disc.apply({"params": p}, jp, lbl, deterministic=True),
                types_onehot, label_hard, label_soft, mask, key, cfg)

        want_d, want_grads = jax.jit(jax.value_and_grad(d_loss))(pd)
        want_gp = JL.gradient_penalty(
            lambda lbl: disc.apply({"params": pd}, jp, lbl, deterministic=True),
            types_onehot, label_soft, mask, key, cfg.LAMBDA_GP)
        want_g, want_aux = JL.generator_loss(
            lambda lbl: disc.apply({"params": pd}, jp, lbl, deterministic=True), jp, logits,
            label_hard, cfg)
        want_m = JM.compute_metrics(jnp.asarray(jp.voxel_type), jnp.argmax(label_hard, -1), mask,
                                    jnp.asarray(jp.voxel_graph_id), jnp.asarray(jp.graph_mask))
    got_d, grads = critic_grads(tdisc, tp, types_onehot, label_hard, label_soft, eps, tcfg)
    _, grads64 = critic_grads(*as_f64(tdisc, tp), types_onehot, label_hard, label_soft, eps, tcfg)
    got_gp = TL.gradient_penalty(lambda lbl: tdisc(tp, lbl), t(types_onehot), t(label_soft),
                                 tp.voxel_mask, tcfg.LAMBDA_GP, eps=t(eps))
    assert float(want_gp) > 1.0  # the penalty is exercised
    np.testing.assert_allclose(got_gp.item(), float(want_gp), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    np.testing.assert_allclose(got_d.item(), float(want_d), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    want_grads = discriminator_params_to_state_dict(want_grads, tcfg)
    assert set(grads) == set(want_grads)
    for k, w in want_grads.items():
        rounding = float((grads[k].double() - grads64[k]).abs().max())
        np.testing.assert_allclose(grads[k].numpy(), w.numpy(), rtol=0, err_msg=k,
                                   atol=GRAD_TOL * float(w.abs().max()) + 1e-6 + 2 * rounding)
    with torch.no_grad():
        got_g, got_aux = TL.generator_loss(lambda lbl: tdisc(tp, lbl), tp, t(logits),
                                           t(label_hard), tcfg)
    np.testing.assert_allclose(got_g.item(), float(want_g), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    for k, v in want_aux.items():
        np.testing.assert_allclose(got_aux[k].item(), float(v), rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                   err_msg=k)
    assert float(want_aux["g_loss_far"]) > 0
    np.testing.assert_allclose(TL.generated_far(tp, t(label_hard)).numpy(),
                               np.asarray(JL.generated_far(jp, label_hard)), rtol=1e-6)
    got_m = TM.compute_metrics(tp.voxel_type, t(label_hard).argmax(-1), tp.voxel_mask,
                               tp.graph_mask, graph_id=tp.voxel_graph_id)
    np.testing.assert_array_equal(got_m["confusion_matrix"].numpy(), np.asarray(want_m["confusion_matrix"]))
    np.testing.assert_array_equal(got_m["per_graph_f1_hist"].numpy(),
                                  np.asarray(want_m["per_graph_f1_hist"]))
    for k in ("f1", "f1_min", "precision", "recall", "accuracy"):
        np.testing.assert_allclose(got_m[k].item(), float(want_m[k]), rtol=1e-6, err_msg=k)


@pytest.fixture(scope="module", params=CONVS)
def edge_bf16(request, packs, edge_cfg):
    """One conv's edge models at the JAX default bf16 on the first pack: the JAX results
    (bf16, and the f32 clones on the same params) and the port's models at bf16 and f32."""
    conv = request.param
    cfg = edge_cfg.replace(COMPUTE_DTYPE="bfloat16", GENERATOR_CONV_TYPE=conv,
                           DISCRIMINATOR_CONV_TYPE=conv)
    jp = packs[0][0]
    nv = jp.voxel_x.shape[0]
    rng = np.random.default_rng(40)
    z = rng.normal(size=(nv, cfg.Z_DIM)).astype(np.float32)
    noise = rng.gumbel(size=(nv, 7)).astype(np.float32)
    label = np.eye(7, dtype=np.float32)[rng.integers(0, 7, nv)]
    key = jax.random.key(12)
    gen, disc = JEdgeGenerator(configuration=cfg), JEdgeDiscriminator(configuration=cfg)
    pg = perturb(jax.jit(lambda: gen.init({"params": key, "gumbel": key}, jp, jnp.asarray(z),
                                          deterministic=True))()["params"], 41, 0.05)
    pd = perturb(jax.jit(lambda: disc.init({"params": key}, jp, jnp.asarray(label),
                                           deterministic=True))()["params"], 42, 0.05)
    ref = bf16_loss_refs(cfg, jp, jp.voxel_mask, jp.voxel_type, z, noise, key, gen, disc, pg, pd)

    def logits(g):
        return g.apply({"params": pg}, jp, jnp.asarray(z), deterministic=True,
                       rngs={"gumbel": key})[0]

    def scores(d):
        return d.apply({"params": pd}, jp, jnp.asarray(label), deterministic=True)

    ref["logits"] = np.asarray(jax.jit(lambda: logits(gen))())
    ref["scores"] = np.asarray(jax.jit(lambda: scores(disc))())
    with jax.default_matmul_precision("highest"):
        ref["logits32"] = np.asarray(jax.jit(lambda: logits(gen.clone(dtype=jnp.float32)))())
        ref["scores32"] = np.asarray(jax.jit(lambda: scores(disc.clone(dtype=jnp.float32)))())
    tcfg = port_cfg(cfg)
    models = {}
    for dt in ("bfloat16", "float32"):
        c = tcfg.replace(COMPUTE_DTYPE=dt)
        models[dt] = (VoxelGNNGenerator(c), VoxelGNNDiscriminator(c))
        models[dt][0].load_state_dict(generator_params_to_state_dict(pg, c))
        models[dt][1].load_state_dict(discriminator_params_to_state_dict(pd, c))
    return tcfg, packs[1][0], z, noise, label, ref, models


def test_edge_models_at_bfloat16_match_flax(edge_bf16):
    _, tp, z, noise, label, ref, models = edge_bf16
    with torch.no_grad():
        got = {dt: (g(tp, t(z), gumbel_noise=t(noise))[0], d(tp, t(label)))
               for dt, (g, d) in models.items()}
    assert models["bfloat16"][0].compute_dtype == torch.bfloat16
    real = tp.voxel_mask.numpy() > 0  # padded nodes carry rounding noise no loss reads
    for i, name in enumerate(("logits", "scores")):
        assert got["bfloat16"][i].dtype == torch.float32  # logits and scores come out f32
        b16, f32 = got["bfloat16"][i].numpy()[real], got["float32"][i].numpy()[real]
        want, want32 = ref[name][real], ref[name + "32"][real]
        assert_rel(b16, want, LOGIT_RTOL, name)
        assert_as_accurate(b16, want, want32, name)
        assert_not_f32(b16, f32, name)


@pytest.mark.parametrize("gp_dtype", ["compute", "float32"])
def test_edge_critic_loss_at_bfloat16_matches_jax(edge_bf16, gp_dtype):
    tcfg, tp, _, _, _, ref, models = edge_bf16
    hold_critic_loss_bf16(models["bfloat16"][1], tp, tcfg, ref, gp_dtype)


# ---------------------------------------------------------------------------
# grid vs edge in the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("conv", CONVS)
def test_grid_and_edge_layouts_agree(conv, synthetic_samples, edge_cfg):
    """One state_dict, two buildings, both layouts: logits and scores on real cells."""
    cfg = port_cfg(edge_cfg).replace(GENERATOR_CONV_TYPE=conv, DISCRIMINATOR_CONV_TYPE=conv,
                                     GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=64)
    samples = synthetic_samples[:2]
    pack = tbatching.pack_graphs(samples, cfg)[0]
    gb = pack_grid(samples, cfg)
    torch.manual_seed(33)
    grid_gen, grid_disc = GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg)
    for m in (grid_gen, grid_disc):  # GraphNorm and biases off their inits
        with torch.no_grad():
            for p in m.parameters():
                p.add_(0.05 * torch.randn_like(p))
    edge_gen, edge_disc = VoxelGNNGenerator(cfg), VoxelGNNDiscriminator(cfg)
    edge_gen.load_state_dict(grid_gen.state_dict())
    edge_disc.load_state_dict(grid_disc.state_dict())
    nv = pack.voxel_x.shape[0]
    label_e = torch.nn.functional.one_hot(pack.voxel_type, 7).float() * pack.voxel_mask[:, None]
    label_g = torch.nn.functional.one_hot(gb.type, 7).float() * gb.mask[..., None]
    with torch.no_grad():
        logits_e, _, _ = edge_gen(pack, torch.zeros(nv, cfg.Z_DIM), gumbel_noise=torch.zeros(nv, 7))
        logits_g, _, _ = grid_gen(gb, torch.zeros(tuple(gb.mask.shape) + (cfg.Z_DIM,)),
                                  gumbel_noise=torch.zeros(tuple(gb.mask.shape) + (7,)))
        score_e, score_g = edge_disc(pack, label_e), grid_disc(gb, label_g)
    offset = 0
    for b, (_, voxel) in enumerate(samples):
        n = voxel.x.shape[0]
        f, y, x = voxel.location.astype(int).T
        np.testing.assert_allclose(logits_g[b, f, y, x].numpy(), logits_e[offset: offset + n].numpy(),
                                   rtol=PARITY_RTOL, atol=PARITY_ATOL)
        np.testing.assert_allclose(score_g[b, f, y, x].numpy(), score_e[offset: offset + n].numpy(),
                                   rtol=PARITY_RTOL, atol=PARITY_ATOL)
        offset += n


# ---------------------------------------------------------------------------
# the step and the trainer on edges
# ---------------------------------------------------------------------------


def test_train_and_eval_steps_on_a_packed_batch(packs, edge_cfg):
    tcfg = port_cfg(edge_cfg.replace(GENERATOR_CONV_TYPE="GATV2CONV"))
    batch = packs[1][0]
    torch.manual_seed(0)
    state = create_train_state(tcfg, VoxelGNNGenerator(tcfg), VoxelGNNDiscriminator(tcfg),
                               device="cpu")
    before = [{k: v.clone() for k, v in m.state_dict().items()}
              for m in (state.generator, state.discriminator)]
    counts = (gt.fwd_launches.value, gt.bwd_launches.value, gt.bytes_launches.value)
    metrics = make_train_step(tcfg, state)(batch, torch.Generator().manual_seed(1))
    assert state.step == 1
    assert (gt.fwd_launches.value, gt.bwd_launches.value, gt.bytes_launches.value) == counts
    for k, v in metrics.items():
        assert torch.isfinite(v).all(), k
    assert float(metrics["confusion_matrix"].sum()) == float(batch.voxel_mask.sum())
    # as on the grid, every parameter moves but the critic's score bias, whose gradient
    # cancels between mean(D(fake)) and mean(D(real)) and which the penalty does not see
    for m, old, fixed in zip((state.generator, state.discriminator), before,
                             (set(), {"decoder.6.bias"})):
        unchanged = {k for k, v in m.state_dict().items() if torch.equal(v, old[k])}
        assert unchanged == fixed
    ev = make_eval_step(tcfg, state)(batch, torch.Generator().manual_seed(2))
    assert ev["per_graph_f1"].shape == (tcfg.PACK_GRAPHS,)
    for k, v in ev.items():
        assert torch.isfinite(v).all(), k


@pytest.fixture(scope="module")
def ref10k_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("ref10k_edges")
    jcfg = JConfiguration(DATA_PATH=str(root / "raw"), SAVE_DATA_PATH=str(root / "npz"),
                          GRID_SHAPE=(10, 6, 6), GRID_LOCAL_NODES=64, GRID_BATCH=16,
                          COMPUTE_DTYPE="float32", TRAIN_SPLIT_RATIO=0.05,
                          VALIDATION_SPLIT_RATIO=0.0)
    cfg = port_cfg(jcfg)
    write_dataset(cfg.DATA_PATH, 200, seed=7)
    create_dataset(cfg, verbose=False)
    with open(REF10K, "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    return cfg, raw


def test_ref10k_checkpoint_tests_the_same_on_edges(ref10k_data, tmp_path):
    """The JAX package's GATCONV checkpoint through Trainer.test on both layouts: the same
    weights, so the same quality; only the layout (and the noise's shape) changes."""
    cfg, raw = ref10k_data
    out = {}
    for layout, (G, D) in (("grid", (GridVoxelGNNGenerator, GridVoxelGNNDiscriminator)),
                           ("edges", (VoxelGNNGenerator, VoxelGNNDiscriminator))):
        c = cfg.replace(LAYOUT=layout)
        gen, disc = G(c), D(c)
        gen.load_state_dict(generator_params_to_state_dict(raw["params_g"], c))
        disc.load_state_dict(discriminator_params_to_state_dict(raw["params_d"], c))
        loaders = GraphDataLoaders(c)
        assert len(loaders.test_indices) == 190
        batch = next(iter(loaders.test_dataloader))
        assert isinstance(batch, tbatching.PackedBatch) == (layout == "edges")
        trainer = Trainer(gen, disc, loaders, c, log_dir=str(tmp_path / layout), device="cpu")
        out[layout] = trainer.test()
    assert out["edges"]["f1"] >= TEST_F1_FLOOR, out
    assert abs(out["edges"]["f1"] - out["grid"]["f1"]) <= LAYOUT_F1_GAP, out
    assert all(np.isfinite(v) for v in out["edges"].values())
