"""The conv registry on the grid layout: the port's GATv2, GCN and GraphConv vs the JAX package's.

Same seeded numpy inputs and the same weights on both sides (flax params
through the port's converter), CPU:

- the three stencils (``stencil_gatv2_flat``, ``stencil_gcn_flat``,
  ``stencil_sum_flat``) at K = 1 and at K = 3 with the gid plane (cells of
  different buildings touch, so a wrong gate moves the boundary cells);
- the three grid convs (``GridGATv2Conv``, ``GridGCNConv``, ``GridGraphConv``);
- the grid generator's logits and the critic's scores for each of them, on a
  K = 3 batch, deterministic and with dropout (the port's Philox masks given
  to the flax side, as tests/test_torch_critic.py does);
- the GCN models at the JAX default bf16, at the tolerances of
  tests/test_torch_bf16_models.py, and the critic loss with its gradient
  penalty at bf16 for each new conv on a K = 3 batch (GP_DTYPE "compute"
  and "float32"), against the JAX ``discriminator_loss``'s parts on the same
  inputs;
- the route each model takes (``models/fast_infer.py::fused_route``): a GATCONV grid
  model fused, every other conv plain, per model; a train step with a GATCONV
  generator and a GRAPHCONV critic, and a server at GATV2CONV, on the CPU.

Tolerances, f32: rtol 1e-4 / atol 1e-5 for the stencils and convs (as
tests/test_torch_layers.py): both sides f32, the sums in other orders.
Logits and scores, rtol 1e-4 / atol 1e-4 (as tests/test_torch_generator.py),
plus twice the f32 rounding of the case, measured as the port's f32 result's
largest distance from the port run in f64 on the same weights, masks and
inputs (itself held under 1e-3).  A semantic fault moves the f64 run with
the f32 one and leaves that allowance at its rounding size.  The allowance is
needed where the one-pass GraphNorm of a K = 3 slot amplifies f32 rounding
(a building whose channel barely varies): with GATV2CONV in training mode
the first norm alone is 2.1e-4 from f64 on both sides, its outputs bit-equal
between the packages, and the final logits of the two f32 runs differ by
3.2e-4 on 2 of 22400 elements, the port 2.6e-4 and the JAX package 9.2e-5
from the f64 run.

bf16 (tests/test_torch_bf16_models.py's rules): at K = 1 all three, (1) the
JAX bf16 result within LOGIT_RTOL of its scale, (2) as accurate as the JAX
bf16 result against the JAX f32 one, (3) not the port's f32 result.  At
K = 3 rules (2) and (3): there the JAX bf16 critic is itself 67% of its
scale from the JAX f32 critic, the port's 9%.  The critic loss: less its
penalty, by rule (2) plus one bf16 rounding of the scores' scale; the
penalty at "float32" within that file's loss tolerances of the JAX f32
critic's, plus twice its f32 rounding (as ``hold``).  The penalty at "compute"
(input gradients through ~20 bf16 layers and five K = 3 one-pass norms) is
rounding-dominated in both packages, so it is held to the f32 critic's
within BF16_GP_RTOL, not by rule (2): on these cases the JAX package's bf16
penalty is 0.2% (GRAPHCONV), 18% (GCNCONV) and 130% (GATV2CONV) from its
f32 one, the port's 12%, 19% and 2.5%.
"""

import contextlib
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_gan_tpu.data import grid as jgrid
from building_gan_tpu.models import GridVoxelGNNDiscriminator as JDiscriminator
from building_gan_tpu.models import GridVoxelGNNGenerator as JGenerator
from building_gan_tpu.models import grid_layers as jgl
from building_gan_tpu.ops import stencil as jst
from building_gan_tpu.ops.rng import bulk_key
from building_gan_tpu.train import losses as JL

from building_gan_torch.checkpoint.torch_compat import (
    discriminator_params_to_state_dict, generator_params_to_state_dict,
)
from building_gan_torch.models import grid_layers as tgl
from building_gan_torch.models.fast_infer import fused_route
from building_gan_torch.models.grid_models import GridVoxelGNNDiscriminator, GridVoxelGNNGenerator
from building_gan_torch.ops import dropout as drop
from building_gan_torch.ops import gat_train as gt
from building_gan_torch.ops import stencil as tst
from building_gan_torch.serving import InferenceServer
from building_gan_torch.train import losses as TL
from building_gan_torch.train.state import create_train_state
from building_gan_torch.train.step import make_eval_step, make_train_step

from test_torch_bf16_models import (
    ACC_FACTOR, LOGIT_RTOL, LOSS_ATOL as BF16_LOSS_ATOL, LOSS_RTOL as BF16_LOSS_RTOL, assert_as_accurate,
    assert_not_f32, assert_rel,
)
from test_torch_critic import given_masks, port_masks
from test_torch_layers import _flat_case, multi_batch, perturb, port_batch, port_cfg, t
from test_torch_losses import _st_gumbel_jax
from test_train import tiny_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

RTOL, ATOL = 1e-4, 1e-5  # stencils and convs
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-4  # logits and scores
BF16_GP_RTOL = 0.25  # the penalty through the bf16 critic against the f32 critic's (K = 3)
NEW_CONVS = ("GATV2CONV", "GCNCONV", "GRAPHCONV")
JAX_CONVS = {"GATV2CONV": jgl.GridGATv2Conv, "GCNCONV": jgl.GridGCNConv,
             "GRAPHCONV": jgl.GridGraphConv}


@pytest.fixture(scope="module")
def grid_cfg(small_cfg):
    return tiny_cfg(small_cfg, LAYOUT="grid", GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=64,
                    COMPUTE_DTYPE="float32")


@pytest.mark.parametrize("multi", [False, True], ids=["k1", "k3_gid"])
@pytest.mark.parametrize("name", ["gatv2", "gcn", "sum"])
def test_stencils_match_jax(name, multi, synthetic_samples, grid_cfg, highest_precision):
    gb, h, mask, gid = _flat_case(synthetic_samples, grid_cfg, multi, 6, 11)
    grid_shape = tuple(gb.mask.shape[1:])
    rng = np.random.default_rng(12)
    h_r = rng.normal(size=h.shape).astype(np.float32)
    att = rng.normal(size=(6,)).astype(np.float32)
    jfn, tfn = {"gatv2": (jst.stencil_gatv2_flat, tst.stencil_gatv2_flat),
                "gcn": (jst.stencil_gcn_flat, tst.stencil_gcn_flat),
                "sum": (jst.stencil_sum_flat, tst.stencil_sum_flat)}[name]
    extra = (h_r, att) if name == "gatv2" else ()
    j_in = [jnp.array(a) for a in (h,) + extra]
    t_in = [t(a) for a in (h,) + extra]
    want = jfn(*j_in, jnp.array(mask), grid_shape, gid=None if gid is None else jnp.array(gid))
    got = tfn(*t_in, t(mask), grid_shape, gid=None if gid is None else t(gid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    if multi:  # buildings touch: without the gid gate their boundary cells would mix
        assert not torch.allclose(tfn(*t_in, t(mask), grid_shape), got, rtol=RTOL, atol=ATOL)


def masks_if(training, masks):
    """The port's keep masks given to the flax model's dropout calls, in training mode."""
    return given_masks(masks, 256.0 / 205.0) if training else contextlib.nullcontext()


def _conv_state_dict(params, tcfg):
    """A flax conv's params -> the port conv's state_dict, through the model converter."""
    sd = generator_params_to_state_dict({"encoder": {"conv_0": params}}, tcfg)
    return {k[len("encoder.module_0."):]: v for k, v in sd.items()}


@pytest.mark.parametrize("multi", [False, True], ids=["k1", "k3_gid"])
@pytest.mark.parametrize("conv", NEW_CONVS)
def test_grid_convs_match_flax(conv, multi, synthetic_samples, grid_cfg, highest_precision):
    gb, x, mask, gid = _flat_case(synthetic_samples, grid_cfg, multi, 8, 13)
    grid_shape = tuple(gb.mask.shape[1:])
    jgid = None if gid is None else jnp.array(gid)
    jconv = JAX_CONVS[conv](features=5)
    params = perturb(jconv.init(jax.random.key(3), jnp.array(x), jnp.array(mask), grid_shape,
                                jgid)["params"], 14)
    want = jconv.apply({"params": params}, jnp.array(x), jnp.array(mask), grid_shape, jgid)
    mine = tgl.GRID_CONV_REGISTRY[conv](8, 5)
    mine.load_state_dict(_conv_state_dict(params, port_cfg(grid_cfg)))
    with torch.no_grad():
        got = mine(t(x), t(mask), grid_shape, gid=None if gid is None else t(gid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module", params=NEW_CONVS)
def model_case(request, synthetic_samples, grid_cfg):
    """One conv's flax generator and critic (perturbed params) on a K = 3 batch, and the
    port's models loaded through the converters."""
    conv = request.param
    cfg = grid_cfg.replace(GENERATOR_CONV_TYPE=conv, DISCRIMINATOR_CONV_TYPE=conv)
    gb = multi_batch(synthetic_samples, cfg)
    rng = np.random.default_rng(15)
    shape = tuple(gb.mask.shape)
    z = rng.normal(size=shape + (cfg.Z_DIM,)).astype(np.float32)
    label = np.eye(7, dtype=np.float32)[rng.integers(0, 7, shape)]
    key = jax.random.key(4)
    with jax.default_matmul_precision("highest"):
        gen = JGenerator(configuration=cfg, dtype=jnp.float32)
        disc = JDiscriminator(configuration=cfg, dtype=jnp.float32)
        pg = perturb(gen.init({"params": key, "gumbel": key}, gb, jnp.array(z),
                              deterministic=True)["params"], 16, scale=0.05)
        pd = perturb(disc.init({"params": key}, gb, jnp.array(label),
                               deterministic=True)["params"], 17, scale=0.05)
    tcfg = port_cfg(cfg)
    tgen, tdisc = GridVoxelGNNGenerator(tcfg), GridVoxelGNNDiscriminator(tcfg)
    tgen.load_state_dict(generator_params_to_state_dict(pg, tcfg))
    tdisc.load_state_dict(discriminator_params_to_state_dict(pd, tcfg))
    return cfg, gb, z, label, gen, disc, pg, pd, tgen, tdisc


def as_f64(model, batch):
    """A copy of ``model`` computing in f64, and ``batch`` with its float fields in f64."""
    m = copy.deepcopy(model).double()
    m.compute_dtype = torch.float64
    fields = {k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
              for k, v in vars(batch).items()}
    return m, dataclasses.replace(batch, **fields)


def hold(got, want, ref64):
    """The port's f32 ``got`` within rtol / atol of the JAX f32 ``want``, plus twice the case's
    f32 rounding (``got``'s distance from the port's f64 run ``ref64``, below 1e-3)."""
    got, want, ref64 = (np.asarray(a, np.float64) for a in (got, want, ref64))
    assert got.shape == want.shape == ref64.shape
    rounding = np.abs(got - ref64).max()
    assert rounding < 1e-3, f"the port's f32 run is {rounding:.3e} from its f64 run"
    np.testing.assert_allclose(got, want, rtol=MODEL_RTOL, atol=MODEL_ATOL + 2.0 * rounding)


@pytest.mark.parametrize("training", [False, True], ids=["deterministic", "dropout"])
def test_grid_generator_matches_flax(model_case, training):
    cfg, gb, z, _, gen, _, pg, _, tgen, _ = model_case
    batch = port_batch(gb)
    B, R = batch.mask.shape[0], int(np.prod(batch.grid_shape))
    keys = drop.draw_keys(len(tgen.encoder.channels), torch.Generator().manual_seed(5))
    masks = port_masks(tgen.encoder, B, R, keys, cfg.ENCODER_DROPOUT_RATE)
    rngs = {"gumbel": jax.random.key(0), "dropout": jax.random.key(0)}
    with jax.default_matmul_precision("highest"), masks_if(training, masks):
        want, _, _ = gen.apply({"params": pg}, gb, jnp.array(z), deterministic=not training,
                               rngs=rngs)
    noise = torch.zeros(tuple(np.shape(want)))
    gen64, batch64 = as_f64(tgen, batch)
    with torch.no_grad():
        got, _, _ = tgen(batch, t(z), gumbel_noise=noise, deterministic=not training, keys=keys)
        ref64, _, _ = gen64(batch64, t(z).double(), gumbel_noise=noise.double(),
                            deterministic=not training, keys=keys)
    hold(got, want, ref64)


@pytest.mark.parametrize("training", [False, True], ids=["deterministic", "dropout"])
def test_grid_critic_matches_flax(model_case, training):
    cfg, gb, _, label, _, disc, _, pd, _, tdisc = model_case
    batch = port_batch(gb)
    B, R = batch.mask.shape[0], int(np.prod(batch.grid_shape))
    keys = drop.draw_keys(len(tdisc.encoder.channels), torch.Generator().manual_seed(6))
    masks = port_masks(tdisc.encoder, B, R, keys, cfg.ENCODER_DROPOUT_RATE)
    with jax.default_matmul_precision("highest"), masks_if(training, masks):
        want = disc.apply({"params": pd}, gb, jnp.array(label), deterministic=not training,
                          rngs={"dropout": jax.random.key(0)})
    disc64, batch64 = as_f64(tdisc, batch)
    with torch.no_grad():
        got = tdisc(batch, t(label), deterministic=not training, keys=keys)
        ref64 = disc64(batch64, t(label).double(), deterministic=not training, keys=keys)
    assert got.shape == tuple(gb.mask.shape) + (1,)
    hold(got, want, ref64)


@pytest.fixture(scope="module", params=[False, True], ids=["k1", "k3_gid"])
def bf16_case(request, synthetic_samples, small_cfg):
    """GCNCONV models at the JAX default COMPUTE_DTYPE bfloat16."""
    multi = request.param
    cfg = tiny_cfg(small_cfg, LAYOUT="grid", GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=64,
                   GENERATOR_CONV_TYPE="GCNCONV", DISCRIMINATOR_CONV_TYPE="GCNCONV")
    assert cfg.COMPUTE_DTYPE == "bfloat16"
    gb = multi_batch(synthetic_samples, cfg) if multi else jgrid.pack_grid(
        synthetic_samples[:3], cfg, batch_slots=3)
    rng = np.random.default_rng(18)
    shape = tuple(gb.mask.shape)
    z = rng.normal(size=shape + (cfg.Z_DIM,)).astype(np.float32)
    label = np.eye(7, dtype=np.float32)[rng.integers(0, 7, shape)]
    key = jax.random.key(5)
    gen, disc = JGenerator(configuration=cfg), JDiscriminator(configuration=cfg)
    pg = perturb(jax.jit(lambda: gen.init({"params": key, "gumbel": key}, gb, jnp.array(z),
                                          deterministic=True))()["params"], 19, 0.05)
    pd = perturb(jax.jit(lambda: disc.init({"params": key}, gb, jnp.array(label),
                                           deterministic=True))()["params"], 20, 0.05)

    def logits(g):
        return g.apply({"params": pg}, gb, jnp.array(z), deterministic=True,
                       rngs={"gumbel": key})[0]

    def scores(d):
        return d.apply({"params": pd}, gb, jnp.array(label), deterministic=True)

    want = {"logits": np.asarray(jax.jit(lambda: logits(gen))()),
            "scores": np.asarray(jax.jit(lambda: scores(disc))())}
    with jax.default_matmul_precision("highest"):
        want["logits32"] = np.asarray(jax.jit(lambda: logits(gen.clone(dtype=jnp.float32)))())
        want["scores32"] = np.asarray(jax.jit(lambda: scores(disc.clone(dtype=jnp.float32)))())
    tcfg = port_cfg(cfg)
    models = {}
    for dt in ("bfloat16", "float32"):
        c = tcfg.replace(COMPUTE_DTYPE=dt)
        models[dt] = (GridVoxelGNNGenerator(c), GridVoxelGNNDiscriminator(c))
        models[dt][0].load_state_dict(generator_params_to_state_dict(pg, c))
        models[dt][1].load_state_dict(discriminator_params_to_state_dict(pd, c))
    return multi, port_batch(gb), z, label, want, models


def test_gcn_models_at_bfloat16_match_flax(bf16_case):
    multi, batch, z, label, want, models = bf16_case
    noise = torch.zeros(tuple(batch.mask.shape) + (7,))
    with torch.no_grad():
        got = {dt: (g(batch, t(z), gumbel_noise=noise)[0], d(batch, t(label)))
               for dt, (g, d) in models.items()}
    for i, name in enumerate(("logits", "scores")):
        b16, f32 = got["bfloat16"][i].numpy(), got["float32"][i].numpy()
        assert b16.dtype == np.float32  # logits and scores come out f32
        if not multi:
            assert_rel(b16, want[name], LOGIT_RTOL, name)
        assert_as_accurate(b16, want[name], want[name + "32"], name)
        assert_not_f32(b16, f32, name)


def test_each_model_takes_its_own_route(grid_cfg):
    tcfg = port_cfg(grid_cfg.replace(GENERATOR_CONV_TYPE="GATCONV", DISCRIMINATOR_CONV_TYPE="GCNCONV"))
    gen, disc = GridVoxelGNNGenerator(tcfg), GridVoxelGNNDiscriminator(tcfg)
    assert (fused_route(gen), fused_route(disc)) == (True, False)
    for conv in NEW_CONVS:
        c = tcfg.replace(GENERATOR_CONV_TYPE=conv, DISCRIMINATOR_CONV_TYPE="GATCONV")
        assert (fused_route(GridVoxelGNNGenerator(c)), fused_route(GridVoxelGNNDiscriminator(c))) == (
            False, True)
    with pytest.raises(ValueError, match="Invalid conv_type"):
        GridVoxelGNNGenerator(tcfg.replace(GENERATOR_CONV_TYPE="SAGECONV"))


def test_mixed_conv_train_and_eval_steps_run(synthetic_samples, grid_cfg):
    """A GATCONV generator with a GRAPHCONV critic: each on its own route, on the CPU
    (where the fused route runs its plain version and launches nothing)."""
    tcfg = port_cfg(grid_cfg.replace(DISCRIMINATOR_CONV_TYPE="GRAPHCONV"))
    batch = port_batch(multi_batch(synthetic_samples, grid_cfg))
    torch.manual_seed(1)
    state = create_train_state(tcfg, GridVoxelGNNGenerator(tcfg), GridVoxelGNNDiscriminator(tcfg),
                               device="cpu")
    before = {k: v.clone() for k, v in state.discriminator.state_dict().items()}
    counts = (gt.fwd_launches.value, gt.bwd_launches.value)
    m = make_train_step(tcfg, state)(batch, torch.Generator().manual_seed(2))
    e = make_eval_step(tcfg, state)(batch, torch.Generator().manual_seed(3))
    assert (gt.fwd_launches.value, gt.bwd_launches.value) == counts
    for k, v in {**m, **e}.items():
        assert torch.isfinite(v).all(), k
    moved = {k for k, v in state.discriminator.state_dict().items() if not torch.equal(v, before[k])}
    assert "encoder.module_0.lin_rel.weight" in moved and "encoder.module_0.lin_root.weight" in moved


def test_server_at_another_conv_serves_the_plain_generator(synthetic_samples, grid_cfg):
    tcfg = port_cfg(grid_cfg.replace(GENERATOR_CONV_TYPE="GATV2CONV"))
    torch.manual_seed(2)
    model = GridVoxelGNNGenerator(tcfg)
    server = InferenceServer(tcfg, model.state_dict(), max_batch=2, max_delay_ms=5.0,
                             device="cpu").start()
    try:
        assert server._weights[1] is None  # no packed hourglass: the plain route
        served = [server.infer(*synthetic_samples[i], seed=i) for i in range(2)]
    finally:
        server.stop()
    z, noise = server._noise([0, 1])
    batch = port_batch(jgrid.pack_grid(synthetic_samples[:2], grid_cfg, batch_slots=2))
    with torch.no_grad():
        logits, _, _ = model(batch, z, gumbel_noise=noise)
    for i, r in enumerate(served):
        pos = synthetic_samples[i][1].location.astype(int)
        want = logits[i, pos[:, 0], pos[:, 1], pos[:, 2]].numpy()
        np.testing.assert_allclose(r["logits"], want, rtol=0, atol=1e-6)


def bf16_loss_refs(cfg, jbatch, mask, types, z, noise, key, gen, disc, pg, pd):
    """The JAX critic loss's inputs and parts at bf16, as tests/test_torch_bf16_models.py
    takes them: the bf16 generator's labels (given Gumbel noise), the GP's eps (the JAX
    package's own draw), the penalty and the real-fake term through the bf16 critic and
    through its f32 clone, and the scores' scale; ``jbatch`` a GridBatch or a PackedBatch."""
    mask = jnp.asarray(mask)
    types_onehot = jax.nn.one_hot(jnp.asarray(types), 7) * mask[..., None]

    def scores_of(d, lbl):
        return d.apply({"params": pd}, jbatch, lbl, deterministic=True)

    def refs():
        logits = gen.apply({"params": pg}, jbatch, jnp.asarray(z), deterministic=True,
                           rngs={"gumbel": key})[0]
        label_hard, label_soft = _st_gumbel_jax(logits, jnp.asarray(noise))
        eps = jax.random.uniform(bulk_key(key), mask.shape + (1,), dtype=types_onehot.dtype)

        def gp(d):
            return JL.gradient_penalty(lambda lbl: scores_of(d, lbl), types_onehot, label_soft,
                                       mask, key, cfg.LAMBDA_GP)

        def adv(d):
            return (JL.masked_mean(scores_of(d, label_hard), mask)
                    - JL.masked_mean(scores_of(d, types_onehot), mask))

        disc32 = disc.clone(dtype=jnp.float32)
        return {"types_onehot": types_onehot, "label_hard": label_hard, "label_soft": label_soft,
                "eps": eps, "gp": gp(disc), "gp32": gp(disc32), "adv": adv(disc),
                "adv32": adv(disc32), "score_scale": jnp.abs(scores_of(disc, types_onehot)).max()}

    return jax.tree.map(np.asarray, jax.jit(refs)())


def hold_critic_loss_bf16(tdisc, batch, tcfg, ref, gp_dtype):
    """The port's bf16 critic loss (its penalty at ``gp_dtype``, differentiated twice) against
    the JAX parts of ``bf16_loss_refs``: the loss less its penalty (a difference of means of
    bf16 scores) by rule (2), as close to the JAX f32 critic's as ACC_FACTOR times the JAX
    bf16 critic's, plus one bf16 rounding (2^-8) of the scores' largest magnitude; the
    penalty at "float32" within the f32 loss tolerances of the JAX f32 critic's plus twice
    its f32 rounding (its distance from the port's f64 penalty); at "compute" not that value (a silent f32 pass would be), and within BF16_GP_RTOL of it."""
    dt = torch.float32 if gp_dtype == "float32" else None
    tdisc.zero_grad()
    got = TL.discriminator_loss(
        lambda lbl: tdisc(batch, lbl), t(ref["types_onehot"]), t(ref["label_hard"]),
        t(ref["label_soft"]), batch.cell_mask, tcfg.replace(GP_DTYPE=gp_dtype),
        eps=t(ref["eps"]), d_apply_gp=lambda lbl: tdisc(batch, lbl, dtype=dt),
    )
    got.backward()
    got_gp = TL.gradient_penalty(lambda lbl: tdisc(batch, lbl, dtype=dt), t(ref["types_onehot"]),
                                 t(ref["label_soft"]), batch.cell_mask, tcfg.LAMBDA_GP,
                                 eps=t(ref["eps"])).item()
    gp32 = float(ref["gp32"])
    assert got.dtype == torch.float32 and gp32 > 0.1
    adv32 = float(ref["adv32"])
    assert abs(got.item() - got_gp - adv32) <= (ACC_FACTOR * abs(float(ref["adv"]) - adv32)
                                                + 2.0**-8 * float(ref["score_scale"]))
    if gp_dtype == "float32":  # plus twice the f32 rounding, as ``hold``
        disc64, batch64 = as_f64(tdisc, batch)
        gp64 = TL.gradient_penalty(lambda lbl: disc64(batch64, lbl), t(ref["types_onehot"]).double(),
                                   t(ref["label_soft"]).double(), batch64.cell_mask,
                                   tcfg.LAMBDA_GP, eps=t(ref["eps"]).double()).item()
        np.testing.assert_allclose(got_gp, gp32, rtol=BF16_LOSS_RTOL,
                                   atol=BF16_LOSS_ATOL + 2.0 * abs(got_gp - gp64))
    else:
        assert got_gp != gp32  # through the bf16 critic
        assert abs(got_gp - gp32) <= BF16_GP_RTOL * gp32, (
            f"penalty at bf16 {got_gp:.5g}, at f32 {gp32:.5g}; the JAX package's at bf16 "
            f"{float(ref['gp']):.5g}")
    for k, p in tdisc.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, k
        assert torch.isfinite(p.grad).all(), k


@pytest.fixture(scope="module", params=NEW_CONVS)
def critic_bf16(request, synthetic_samples, small_cfg):
    """One conv's models at bf16 on a K = 3 batch: the JAX loss parts and the port's critic."""
    cfg = tiny_cfg(small_cfg, LAYOUT="grid", GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=64,
                   GENERATOR_CONV_TYPE=request.param, DISCRIMINATOR_CONV_TYPE=request.param)
    assert cfg.COMPUTE_DTYPE == "bfloat16"
    gb = multi_batch(synthetic_samples, cfg)
    rng = np.random.default_rng(22)
    shape = tuple(gb.mask.shape)
    z = rng.normal(size=shape + (cfg.Z_DIM,)).astype(np.float32)
    noise = rng.gumbel(size=shape + (7,)).astype(np.float32)
    label = np.eye(7, dtype=np.float32)[rng.integers(0, 7, shape)]
    key = jax.random.key(6)
    gen, disc = JGenerator(configuration=cfg), JDiscriminator(configuration=cfg)
    pg = perturb(jax.jit(lambda: gen.init({"params": key, "gumbel": key}, gb, jnp.array(z),
                                          deterministic=True))()["params"], 23, 0.05)
    pd = perturb(jax.jit(lambda: disc.init({"params": key}, gb, jnp.array(label),
                                           deterministic=True))()["params"], 24, 0.05)
    ref = bf16_loss_refs(cfg, gb, gb.mask, gb.type, z, noise, key, gen, disc, pg, pd)
    tcfg = port_cfg(cfg)
    tdisc = GridVoxelGNNDiscriminator(tcfg)
    tdisc.load_state_dict(discriminator_params_to_state_dict(pd, tcfg))
    return tcfg, port_batch(gb), ref, tdisc


@pytest.mark.parametrize("gp_dtype", ["compute", "float32"])
def test_critic_loss_at_bfloat16_matches_jax(critic_bf16, gp_dtype):
    tcfg, batch, ref, tdisc = critic_bf16
    assert batch.graphs_per_slot == 3
    hold_critic_loss_bf16(tdisc, batch, tcfg, ref, gp_dtype)
