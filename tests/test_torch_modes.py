"""The reference's other training modes in the port against the JAX package (CPU).

Same seeded numpy inputs and the same weights on both sides (flax params
through the port's converters), tests/test_train.py::tiny_cfg widths:

- the batch-level quirks: type-matched pooling over the whole batch (Q1,
  ``BATCH_LEVEL_MATCHING``) on the grid (K = 1 and K = 3, whose gid planes it
  does not read) and on a packed edge-list batch; GraphNorm statistics over
  the whole batch (Q5, ``BATCH_LEVEL_GRAPHNORM``) on the grid, f32 and bf16
  (the squares in f32, as the jitted JAX layer keeps them), and on edges,
  each on a batch with an empty slot or graph (a null pack's cells take no
  part in the statistics);
- the grid and edge generator and critic with each flag, against flax;
- the BCE losses of ``USE_WGANGP=False``: the critic loss and its parameter
  gradients, the generator loss and its terms, and the critic's sigmoid
  scores, plain and on the fused route (its plain version on the CPU);
- a BCE train step (no plain critic pass: no penalty) and batch-level train
  steps: finite, every parameter moving;
- the routes: ``fused_route`` is False under ``BATCH_LEVEL_GRAPHNORM`` and
  stays True under ``BATCH_LEVEL_MATCHING``; the server refuses both modes.

Tolerances: rtol 1e-4 / atol 1e-5 for pooling and norms and the losses
(tests/test_torch_layers.py, tests/test_torch_losses.py); bf16 norms 1 bf16
ulp + 1e-3 (tests/test_torch_bf16_layers.py); logits and scores rtol 1e-4 /
atol 1e-4 plus twice the case's f32 rounding (tests/test_torch_convs.py::hold);
critic gradients within 1e-4 of their largest magnitude plus 1e-6 plus twice
their f32 rounding (their distance from the port's f64 gradients, as
tests/test_torch_edges.py holds them: a K = 3 one-pass GraphNorm amplifies
rounding in the mean_scale gradients of both packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_gan_tpu.data import batching as jbatching
from building_gan_tpu.data import grid as jgrid
from building_gan_tpu.models import GridVoxelGNNDiscriminator as JDiscriminator
from building_gan_tpu.models import GridVoxelGNNGenerator as JGenerator
from building_gan_tpu.models import VoxelGNNDiscriminator as JEdgeDiscriminator
from building_gan_tpu.models import VoxelGNNGenerator as JEdgeGenerator
from building_gan_tpu.models import grid_layers as jgl
from building_gan_tpu.models import layers as jlayers
from building_gan_tpu.ops import pooling as jpool
from building_gan_tpu.train import losses as JL

from building_gan_torch.checkpoint.torch_compat import (
    discriminator_params_to_state_dict, generator_params_to_state_dict,
)
from building_gan_torch.models import fast_train as FT
from building_gan_torch.models import grid_layers as tgl
from building_gan_torch.models import layers as tlayers
from building_gan_torch.models.discriminator import VoxelGNNDiscriminator
from building_gan_torch.models.fast_infer import fused_route
from building_gan_torch.models.generator import VoxelGNNGenerator
from building_gan_torch.models.grid_models import GridVoxelGNNDiscriminator, GridVoxelGNNGenerator
from building_gan_torch.ops import gat_train as gt
from building_gan_torch.ops import pooling as tpool
from building_gan_torch.serving import InferenceServer
from building_gan_torch.train import losses as TL
from building_gan_torch.train.state import create_train_state
from building_gan_torch.train.step import make_eval_step, make_train_step

from test_torch_bf16_layers import assert_ulps, jbf, tbf
from test_torch_convs import as_f64, hold
from test_torch_edges import port_pack
from test_torch_layers import multi_batch, perturb, port_batch, port_cfg, t
from test_torch_losses import _st_gumbel_jax
from test_train import tiny_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

RTOL, ATOL = 1e-4, 1e-5  # pooling, norms, losses
GRAD_TOL = 1e-4
FLAGS = ("BATCH_LEVEL_MATCHING", "BATCH_LEVEL_GRAPHNORM")


@pytest.fixture(scope="module")
def jcfg(small_cfg):
    return tiny_cfg(small_cfg, LAYOUT="grid", GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=64,
                    COMPUTE_DTYPE="float32")


def grid_batch(samples, cfg, multi):
    """A JAX grid batch with an empty slot: K = 3 (cell packing) or K = 1."""
    if multi:
        gb = multi_batch(samples, cfg, slots=6)
    else:
        gb = jgrid.pack_grid(samples[:3], cfg, batch_slots=4)
    assert float(np.asarray(gb.mask)[-1].sum()) == 0.0  # the null slot
    return gb


@pytest.fixture(scope="module")
def edge_pack(synthetic_samples, jcfg):
    """A JAX edge pack of 3 buildings in 4 graph slots (an empty graph, padded nodes)."""
    cfg = jcfg.replace(LAYOUT="edges")
    jp = jbatching.pack_graphs(synthetic_samples[:3], cfg)[0]
    assert float(np.asarray(jp.graph_mask).sum()) == 3.0
    return cfg, jp, port_pack(jp)


# ---------------------------------------------------------------------------
# pooling and norms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi", [False, True], ids=["k1", "k3_gid"])
def test_batch_level_grid_pooling_matches_jax(multi, synthetic_samples, jcfg):
    gb = grid_batch(synthetic_samples, jcfg, multi)
    B = gb.mask.shape[0]
    lx = np.random.default_rng(1).normal(size=np.shape(gb.local_x)).astype(np.float32)
    K = gb.graph_mask.shape[1] if multi else 1
    gid = None if gb.gid is None else np.asarray(gb.gid).reshape(B, -1)
    args = (np.asarray(gb.local_type), np.asarray(gb.local_mask),
            np.asarray(gb.type).reshape(B, -1), 7)
    lgid = None if gb.local_gid is None else np.asarray(gb.local_gid)
    kw = dict(local_gid=lgid, gid=gid, num_graphs=K)
    tkw = {k: (t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    want = jgl.grid_type_matched_pooling(jnp.asarray(lx), *(jnp.asarray(a) for a in args[:3]), 7,
                                         batch_level=True, **kw)
    got = tgl.grid_type_matched_pooling(t(lx), *(t(a) for a in args[:3]), 7, batch_level=True,
                                        **tkw)
    per_graph = tgl.grid_type_matched_pooling(t(lx), *(t(a) for a in args[:3]), 7, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert not torch.allclose(got, per_graph)  # the whole batch's means, not each slot's


def test_batch_level_edge_pooling_matches_jax(edge_pack):
    _, jp, tp = edge_pack
    lx = np.random.default_rng(2).normal(size=np.shape(jp.local_x)).astype(np.float32)
    names = ("local_type", "local_graph_id", "local_mask", "voxel_type", "voxel_graph_id")
    G = jp.graph_mask.shape[0]
    want = jpool.type_matched_pooling(jnp.asarray(lx), *(jnp.asarray(getattr(jp, a)) for a in names),
                                      G, batch_level=True)
    got = tpool.type_matched_pooling(t(lx), *(getattr(tp, a) for a in names), G, batch_level=True)
    per_graph = tpool.type_matched_pooling(t(lx), *(getattr(tp, a) for a in names), G)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert not torch.allclose(got, per_graph)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("multi", [False, True], ids=["k1", "k3_gid"])
def test_batch_level_grid_graph_norm_matches_jax(multi, dtype, synthetic_samples, jcfg):
    """Statistics over every masked cell of the batch (the null slot's take no part); the
    flax layer jitted, as the JAX steps run it.  f32 within rtol 1e-4 / atol 1e-5, bf16
    within 1 ulp + 1e-3."""
    gb = grid_batch(synthetic_samples, jcfg, multi)
    B = gb.mask.shape[0]
    mask = np.asarray(gb.mask).reshape(B, -1)
    gid = None if gb.gid is None else np.asarray(gb.gid).reshape(B, -1)
    K = gb.graph_mask.shape[1] if multi else 1
    x = np.random.default_rng(3).normal(size=mask.shape + (6,)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    norm = jgl.GridGraphNorm(features=6, batch_level=True, dtype=jdt)
    params = perturb(norm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(mask))["params"], 4)
    jx = jnp.asarray(x) if dtype == "float32" else jbf(x)
    want = np.asarray(jax.jit(lambda p, x_: norm.apply(
        {"params": p}, x_, jnp.asarray(mask), gid=None if gid is None else jnp.asarray(gid),
        num_graphs=K))(params, jx).astype(jnp.float32))
    mine = tgl.GridGraphNorm(6)
    mine.load_state_dict({k: t(v) for k, v in params.items()})
    tx = t(x) if dtype == "float32" else tbf(x)
    with torch.no_grad():
        got = mine(tx, t(mask), gid=None if gid is None else t(gid), num_graphs=K, batch_level=True)
        per_slot = mine(tx, t(mask), gid=None if gid is None else t(gid), num_graphs=K)
    assert got.dtype == tx.dtype
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    else:
        assert_ulps(got, want, 1, 1e-3, "batch-level graph_norm")
    assert float(got[-1].abs().max()) == 0.0  # the null slot stays 0
    assert not torch.allclose(got.float(), per_slot.float())


def test_batch_level_edge_graph_norm_matches_jax(edge_pack):
    """GraphNorm without segment ids: statistics over the pack's real nodes."""
    _, jp, tp = edge_pack
    x = np.random.default_rng(5).normal(size=(jp.voxel_x.shape[0], 6)).astype(np.float32)
    norm = jlayers.GraphNorm(features=6)
    mask = jnp.asarray(jp.voxel_mask)
    params = perturb(norm.init(jax.random.key(1), jnp.asarray(x), None, None, mask)["params"], 6)
    want = norm.apply({"params": params}, jnp.asarray(x), None, None, mask)
    mine = tlayers.GraphNorm(6)
    mine.load_state_dict({k: t(v) for k, v in params.items()})
    with torch.no_grad():
        got = mine(t(x), None, None, tp.voxel_mask)
    real = np.asarray(jp.voxel_mask) > 0
    assert (~real).any()  # padded nodes, and an empty graph slot, in the pack
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real], rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the models with each flag
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[(lay, f) for lay in ("grid", "edges") for f in FLAGS],
                ids=lambda p: f"{p[0]}-{p[1].lower()}")
def flag_models(request, synthetic_samples, jcfg, edge_pack):
    """The flax generator and critic (perturbed params) with one flag on, on a K = 3 grid
    batch with an empty slot or the edge pack, and the port's models loaded."""
    layout, flag = request.param
    if layout == "grid":
        cfg = jcfg.replace(**{flag: True})
        jb = grid_batch(synthetic_samples, cfg, True)
        G, D, tG, tD = JGenerator, JDiscriminator, GridVoxelGNNGenerator, GridVoxelGNNDiscriminator
        cells = tuple(jb.mask.shape)
        tb = port_batch(jb)
    else:
        cfg = edge_pack[0].replace(**{flag: True})
        jb, tb = edge_pack[1], edge_pack[2]
        G, D, tG, tD = JEdgeGenerator, JEdgeDiscriminator, VoxelGNNGenerator, VoxelGNNDiscriminator
        cells = (jb.voxel_x.shape[0],)
    rng = np.random.default_rng(7)
    z = rng.normal(size=cells + (cfg.Z_DIM,)).astype(np.float32)
    label = np.eye(7, dtype=np.float32)[rng.integers(0, 7, cells)]
    key = jax.random.key(3)
    with jax.default_matmul_precision("highest"):
        gen, disc = G(configuration=cfg, dtype=jnp.float32), D(configuration=cfg, dtype=jnp.float32)
        pg = perturb(jax.jit(lambda: gen.init({"params": key, "gumbel": key}, jb, jnp.asarray(z),
                                              deterministic=True))()["params"], 8, 0.05)
        pd = perturb(jax.jit(lambda: disc.init({"params": key}, jb, jnp.asarray(label),
                                               deterministic=True))()["params"], 9, 0.05)
        want_logits = jax.jit(lambda: gen.apply({"params": pg}, jb, jnp.asarray(z),
                                                deterministic=True, rngs={"gumbel": key})[0])()
        want_scores = jax.jit(lambda: disc.apply({"params": pd}, jb, jnp.asarray(label),
                                                 deterministic=True))()
    tcfg = port_cfg(cfg)
    tgen, tdisc = tG(tcfg), tD(tcfg)
    tgen.load_state_dict(generator_params_to_state_dict(pg, tcfg))
    tdisc.load_state_dict(discriminator_params_to_state_dict(pd, tcfg))
    return (layout, flag, tcfg, tb, z, label, np.asarray(want_logits), np.asarray(want_scores),
            tgen, tdisc)


def test_generator_with_the_flag_matches_flax(flag_models):
    layout, flag, tcfg, batch, z, _, want, _, tgen, _ = flag_models
    noise = torch.zeros(want.shape)
    gen64, batch64 = as_f64(tgen, batch)
    with torch.no_grad():
        got = tgen(batch, t(z), gumbel_noise=noise)[0]
        ref64 = gen64(batch64, t(z).double(), gumbel_noise=noise.double())[0]
        if layout == "grid" and flag == "BATCH_LEVEL_MATCHING":  # the fused route stays
            assert fused_route(tgen)
            fused = FT.generator_apply_fused(tgen, tcfg, batch, t(z), gumbel_noise=noise,
                                             deterministic=True)[0]
            hold(fused, want, ref64)
    hold(got, want, ref64)


def test_critic_with_the_flag_matches_flax(flag_models):
    layout, flag, tcfg, batch, _, label, _, want, _, tdisc = flag_models
    disc64, batch64 = as_f64(tdisc, batch)
    with torch.no_grad():
        got = tdisc(batch, t(label))
        ref64 = disc64(batch64, t(label).double())
    hold(got, want, ref64)
    assert fused_route(tdisc) == (layout == "grid" and flag == "BATCH_LEVEL_MATCHING")


# ---------------------------------------------------------------------------
# the BCE losses (USE_WGANGP=False)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bce_case(synthetic_samples, jcfg):
    cfg = jcfg.replace(USE_WGANGP=False)
    gb = multi_batch(synthetic_samples, cfg)
    rng = np.random.default_rng(10)
    shape = tuple(gb.mask.shape)
    z = rng.normal(size=shape + (cfg.Z_DIM,)).astype(np.float32)
    noise = rng.gumbel(size=shape + (7,)).astype(np.float32)
    key = jax.random.key(4)
    with jax.default_matmul_precision("highest"):
        disc = JDiscriminator(configuration=cfg, dtype=jnp.float32)
        gen = JGenerator(configuration=cfg, dtype=jnp.float32)
        label0 = jax.nn.one_hot(jnp.asarray(gb.type), 7)
        pd = perturb(jax.jit(lambda: disc.init({"params": key}, gb, label0,
                                               deterministic=True))()["params"], 11, 0.05)
        pg = perturb(jax.jit(lambda: gen.init({"params": key, "gumbel": key}, gb, jnp.asarray(z),
                                              deterministic=True))()["params"], 12, 0.05)
    tcfg = port_cfg(cfg)
    tdisc, tgen = GridVoxelGNNDiscriminator(tcfg), GridVoxelGNNGenerator(tcfg)
    tdisc.load_state_dict(discriminator_params_to_state_dict(pd, tcfg))
    tgen.load_state_dict(generator_params_to_state_dict(pg, tcfg))
    return cfg, tcfg, gb, port_batch(gb), z, noise, key, disc, gen, pd, pg, tdisc, tgen


def test_bce_critic_scores_are_the_sigmoid_on_both_routes(bce_case):
    cfg, tcfg, gb, batch, *_, disc, _, pd, _, tdisc, _ = bce_case
    label = np.eye(7, dtype=np.float32)[np.asarray(gb.type)]
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda: disc.apply({"params": pd}, gb, jnp.asarray(label),
                                                     deterministic=True))())
    with torch.no_grad():
        plain = tdisc(batch, t(label))
        fused = FT.discriminator_apply_fused(tdisc, tcfg, batch, t(label), deterministic=True)
        wgan = GridVoxelGNNDiscriminator(tcfg.replace(USE_WGANGP=True))
        wgan.load_state_dict(tdisc.state_dict())
        raw = wgan(batch, t(label))
    assert fused_route(tdisc) and plain.dtype == torch.float32
    assert float(plain.min()) > 0 and float(plain.max()) < 1
    np.testing.assert_allclose(plain.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(fused.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(plain.numpy(), torch.sigmoid(raw).numpy(), rtol=1e-6, atol=1e-7)


def test_bce_losses_and_critic_grads_match_jax(bce_case):
    cfg, tcfg, gb, batch, z, noise, key, disc, gen, pd, pg, tdisc, _ = bce_case
    mask = jnp.asarray(gb.mask)
    types_onehot = jax.nn.one_hot(jnp.asarray(gb.type), 7) * mask[..., None]
    with jax.default_matmul_precision("highest"):
        logits = jax.jit(lambda: gen.apply({"params": pg}, gb, jnp.asarray(z), deterministic=True,
                                           rngs={"gumbel": key})[0])()
        label_hard, label_soft = jax.lax.stop_gradient(_st_gumbel_jax(logits, jnp.asarray(noise)))

        def d_loss(p):
            return JL.discriminator_loss(
                lambda lbl: disc.apply({"params": p}, gb, lbl, deterministic=True),
                types_onehot, label_hard, label_soft, mask, key, cfg)

        want_d, want_grads = jax.jit(jax.value_and_grad(d_loss))(pd)
        want_g, want_aux = jax.jit(lambda: JL.generator_loss(
            lambda lbl: disc.apply({"params": pd}, gb, lbl, deterministic=True), gb, logits,
            label_hard, cfg))()
    calls = []

    def critic_loss(model, b):
        model.zero_grad()
        dt = b.mask.dtype
        loss = TL.discriminator_loss(
            lambda lbl: model(b, lbl), *(t(a).to(dt) for a in (types_onehot, label_hard, label_soft)),
            b.mask, tcfg, d_apply_gp=lambda lbl: calls.append(lbl))
        loss.backward()
        return loss, {k: p.grad.clone() for k, p in model.named_parameters()}

    got_d, grads = critic_loss(tdisc, batch)
    _, grads64 = critic_loss(*as_f64(tdisc, batch))
    assert not calls  # no penalty: the critic inside it is never called
    np.testing.assert_allclose(got_d.item(), float(want_d), rtol=RTOL, atol=ATOL)
    want_grads = discriminator_params_to_state_dict(want_grads, tcfg)
    for k, g in grads.items():  # plus twice the f32 rounding, as tests/test_torch_edges.py
        w = want_grads[k].numpy()
        rounding = float((g.double() - grads64[k]).abs().max())
        np.testing.assert_allclose(g.numpy(), w, rtol=0, err_msg=k,
                                   atol=GRAD_TOL * float(np.abs(w).max()) + 1e-6 + 2 * rounding)
    with torch.no_grad():
        got_g, got_aux = TL.generator_loss(lambda lbl: tdisc(batch, lbl), batch, t(logits),
                                           t(label_hard), tcfg)
    np.testing.assert_allclose(got_g.item(), float(want_g), rtol=RTOL, atol=ATOL)
    for k, v in want_aux.items():
        np.testing.assert_allclose(got_aux[k].item(), float(v), rtol=RTOL, atol=ATOL, err_msg=k)
    assert float(want_aux["g_loss_adv"]) > 0  # -log of a sigmoid


# ---------------------------------------------------------------------------
# train steps and routes
# ---------------------------------------------------------------------------


def _step_runs(tcfg, batch):
    """One train step and one eval step of fresh models on the CPU; -> (metrics, plain
    critic calls in the step, parameters that did not move)."""
    torch.manual_seed(0)
    state = create_train_state(tcfg, GridVoxelGNNGenerator(tcfg), GridVoxelGNNDiscriminator(tcfg),
                               device="cpu")
    before = [{k: v.clone() for k, v in m.state_dict().items()}
              for m in (state.generator, state.discriminator)]
    calls = []
    hook = state.discriminator.register_forward_pre_hook(lambda *a: calls.append(1))
    counts = (gt.fwd_launches.value, gt.bwd_launches.value, gt.bytes_launches.value)
    try:
        m = make_train_step(tcfg, state)(batch, torch.Generator().manual_seed(1))
    finally:
        hook.remove()
    e = make_eval_step(tcfg, state)(batch, torch.Generator().manual_seed(2))
    assert (gt.fwd_launches.value, gt.bwd_launches.value, gt.bytes_launches.value) == counts
    for k, v in {**m, **e}.items():
        assert torch.isfinite(v).all(), k
    still = [{k for k, v in mod.state_dict().items() if torch.equal(v, old[k])}
             for mod, old in zip((state.generator, state.discriminator), before)]
    return state, m, len(calls), still


def test_bce_train_step_runs_without_a_plain_critic_pass(bce_case):
    """Both models fused on the CPU (their plain versions); no penalty, so the plain critic
    module is never called, where the WGAN-GP step calls it once a critic update."""
    tcfg, batch = bce_case[1], bce_case[3]
    _, m, plain_calls, still = _step_runs(tcfg, batch)
    assert plain_calls == 0
    assert still == [set(), set()]  # BCE reaches the score bias too
    assert float(m["d_loss"]) > 0 and float(m["g_loss_adv"]) > 0
    _, _, wgan_calls, _ = _step_runs(tcfg.replace(USE_WGANGP=True), batch)
    assert wgan_calls == tcfg.N_CRITIC


@pytest.mark.parametrize("flags", [FLAGS[:1], FLAGS], ids=["matching", "both"])
def test_batch_level_train_step_runs(flags, synthetic_samples, jcfg):
    tcfg = port_cfg(jcfg).replace(**{f: True for f in flags})
    batch = port_batch(grid_batch(synthetic_samples, jcfg, True))
    state, _, plain_calls, still = _step_runs(tcfg, batch)
    fused = "BATCH_LEVEL_GRAPHNORM" not in flags
    assert (fused_route(state.generator), fused_route(state.discriminator)) == (fused, fused)
    # the plain critic runs in each critic update's penalty, and every pass when not fused
    assert plain_calls == (tcfg.N_CRITIC if fused else 3 * tcfg.N_CRITIC + 1)
    assert still == [set(), {"decoder.6.bias"}]


def test_routes_and_server_refuse_as_jax(jcfg):
    tcfg = port_cfg(jcfg)
    for flags, fused in (({}, True), ({"BATCH_LEVEL_MATCHING": True}, True),
                         ({"BATCH_LEVEL_GRAPHNORM": True}, False)):
        c = tcfg.replace(**flags)
        assert fused_route(GridVoxelGNNGenerator(c)) == fused
        assert fused_route(GridVoxelGNNDiscriminator(c)) == fused
    sd = GridVoxelGNNGenerator(tcfg).state_dict()
    for flag in FLAGS:
        with pytest.raises(ValueError, match="batch-level quirk modes"):
            InferenceServer(tcfg.replace(**{flag: True}), sd, device="cpu")
