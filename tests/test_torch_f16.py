"""The port at COMPUTE_DTYPE float16 vs the JAX package's (CPU).

The JAX package computes at any ``COMPUTE_DTYPE`` its modules cast to
(``Configuration.compute_dtype``); float16 reaches it through its
``Configuration`` and ``scripts/demo_train.py --compute-dtype``.  The same
numpy-seeded inputs go through both packages at f16, with f32 parameters
(cast at use) and the same casts as at bf16 (tests/test_torch_bf16_*.py):

- GraphNorm at f16 against the jitted flax layer (K = 1 and gid-keyed K > 1:
  the jitted JAX layer keeps the K > 1 squares in f32 at f16 as at bf16, and
  so does the port), 1 f16 ulp + 1e-3;
- the training layer's plain f16 mode (``layer_plain``: f32 math, x read as
  f16, y and gx rounded to f16), a two-layer stack, against the JAX package's
  ``make_fused_layer`` with the Pallas kernels in interpret mode fed f16, K = 1
  and K = 3;
- the serving hourglass's plain f16 twin (f32 math, each layer's output
  rounded to f16) against the flax f16 stack, K = 1 and K = 3.  The JAX
  package's Pallas hourglass takes no 16-bit x (its layer loop's carry turns
  f32), so the flax stack is what its server and eval step run at f16;
- the grid GATCONV generator's logits and critic's scores (plain modules, the
  fused paths and the served path, K = 3), and the edge-layout GATCONV generator and
  critic, against the jitted flax models at f16;
- the critic loss with its gradient penalty at GP_DTYPE "compute" and
  "float32", and the generator loss;
- one whole f16 train step, and the ``InferenceServer`` at f16 against the flax
  f16 generator on the server's own noise.

Tolerances.  f16 has 11 significant bits (an ulp is 2^(e - 10) for a value in
[2^e, 2^(e+1))), 8x finer than bf16, and the same rounding places as bf16:
- the layer stack: y and gx within 2 f16 ulps + 1e-3 of their scale, the f32
  weight grads within GRAD_TOL of their largest magnitude;
- the hourglass twin: within 1.5x the flax f16 stack's own largest distance
  from the flax f32 stack (the flax stack also rounds h, the softmax weights
  and the norm's output), and the twin within 5e-3 of the f32 stack's scale;
- models: (1) within LOGIT_RTOL of the JAX f16 result's largest magnitude;
  (2) within ACC_FACTOR times the JAX f16 result's own distance from the JAX
  f32 result, plus 1e-3 of scale (as accurate as the reference at f16); (3)
  different from the port's own f32 result (a silent f32 path would not be),
  by at most F32_RTOL of its scale.  Measured at these sizes: the port's f16
  logits 0.3-1.5% of scale from the JAX f16 ones;
- losses: the penalty at GP_DTYPE "float32" and the generator loss's label,
  ratio and FAR terms within LOSS_RTOL + LOSS_ATOL, as in f32
  (tests/test_torch_losses.py: the f32 penalty, a double backward through the
  critic, moves by ~1e-5 between sum orders); the critic's real-fake term
  and the generator's adversarial term within one f16 rounding (2^-11) of the
  scores' largest magnitude; the penalty at GP_DTYPE "compute" by rule (2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_gan_tpu.data import grid as jgrid
from building_gan_tpu.models import GridVoxelGNNDiscriminator as JDiscriminator
from building_gan_tpu.models import GridVoxelGNNGenerator as JGenerator
from building_gan_tpu.models import VoxelGNNDiscriminator as JEdgeDiscriminator
from building_gan_tpu.models import VoxelGNNGenerator as JEdgeGenerator
from building_gan_tpu.models import grid_layers as jgl
from building_gan_tpu.ops.pallas import gat_train as GT

from building_gan_torch.checkpoint.torch_compat import (
    discriminator_params_to_state_dict, generator_params_to_state_dict,
)
from building_gan_torch.data import batching as tbatching
from building_gan_torch.models import fast_infer
from building_gan_torch.models import fast_train as FT
from building_gan_torch.models.discriminator import VoxelGNNDiscriminator
from building_gan_torch.models.generator import VoxelGNNGenerator
from building_gan_torch.models import grid_layers as tgl
from building_gan_torch.models.grid_models import GridVoxelGNNDiscriminator, GridVoxelGNNGenerator
from building_gan_torch.ops import gat_train as gt
from building_gan_torch.ops import hourglass as hg
from building_gan_torch.serving import InferenceServer
from building_gan_torch.train import losses as TL

from test_torch_bf16_layers import jhg_pack
from test_torch_bf16_models import _jax_refs, assert_types_where_decided
from test_torch_gat_train import GS, C, L, _case as _layer_case
from test_torch_layers import _flat_case, multi_batch, perturb, port_batch, port_cfg, t
from test_train import tiny_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

F16 = torch.float16
GRAD_TOL = 5e-5
LOGIT_RTOL = 0.05
ACC_FACTOR = 3.0
F32_RTOL = 0.05
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5  # as the f32 loss tests (tests/test_torch_losses.py)
ULP16 = 2.0**-11  # one f16 rounding of a value's magnitude


def f16_ulp(v):
    """One f16 ulp of each value (of the smallest normal, 2^-14, below it)."""
    a = np.maximum(np.abs(np.asarray(v, np.float64)), 2.0**-14)
    return np.exp2(np.floor(np.log2(a)) - 10)


def as64(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


def assert_ulps(got, want, n_ulp, atol, name):
    got, want = as64(got), as64(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want)
    bound = n_ulp * f16_ulp(want) + atol
    assert (err <= bound).all(), f"{name}: {int((err > bound).sum())} of {err.size} beyond bound"


def assert_rel(got, want, rtol, name):
    got, want = as64(got), as64(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, f"{name}: max err {err:.3e} > {rtol} x {scale:.3e}"


def assert_not_f32(f16, f32, rtol, name):
    """The f16 result is not the f32 one, and within ``rtol`` of its largest magnitude."""
    d = np.abs(as64(f16) - as64(f32)).max()
    scale = np.abs(as64(f32)).max()
    assert 0 < d <= rtol * scale, f"{name}: f16 - f32 = {d:.3e}, scale {scale:.3e}"


def assert_as_accurate(got, want_f16, want_f32, name):
    got, wh, wf = as64(got), as64(want_f16), as64(want_f32)
    ref_err, err = np.abs(wh - wf).max(), np.abs(got - wf).max()
    assert err <= ACC_FACTOR * ref_err + 1e-3 * np.abs(wf).max(), (
        f"{name}: {err:.3e} from f32, the JAX f16 result {ref_err:.3e}")


def jh(a):
    return jnp.asarray(np.asarray(a), jnp.float16)


def th(a):
    return t(np.asarray(a, np.float32)).to(F16)


# --- GraphNorm, the training layer and the serving hourglass ---------------------------------

@pytest.mark.parametrize("multi", [False, True], ids=["per_slot", "gid_keyed"])
def test_graph_norm_f16_matches_flax(multi, synthetic_samples, small_cfg):
    """Statistics in f32, scale and shift rounded to f16 and applied in f16."""
    cfg = tiny_cfg(small_cfg, LAYOUT="grid", GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=64)
    gb, x, mask, gid = _flat_case(synthetic_samples, cfg, multi, 6, 2)
    K = gb.graph_mask.shape[1] if multi else 1
    norm = jgl.GridGraphNorm(features=6, dtype=jnp.float16)
    params = perturb(norm.init(jax.random.key(0), jh(x), jnp.array(mask))["params"], 3)
    want = jax.jit(lambda p, x_: norm.apply(
        {"params": p}, x_, jnp.array(mask), gid=None if gid is None else jnp.array(gid),
        num_graphs=K))(params, jh(x))
    assert want.dtype == jnp.float16
    mine = tgl.GridGraphNorm(6)
    with torch.no_grad():
        for k in ("weight", "bias", "mean_scale"):
            getattr(mine, k).copy_(t(params[k]))
        g = None if gid is None else t(gid)
        got = mine(th(x), t(mask), gid=g, num_graphs=K)
        f32 = mine(th(x).float(), t(mask), gid=g, num_graphs=K)
    assert got.dtype == F16
    assert_ulps(got, want, 1, 1e-3, "graph_norm")
    assert_not_f32(got, f32, 5e-3, "graph_norm")


@pytest.mark.parametrize("K", [1, 3])
def test_plain_f16_stack_matches_the_pallas_kernels(K):
    """make_fused_layer in interpret mode fed f16 x against the port's plain f16 stack:
    f32 math, y and gx in f16, the weight grads f32."""
    mask, gid, x0, Ws, atts, vecs = _layer_case(K, seed=K)
    x0 = np.asarray(jh(x0).astype(jnp.float32))
    planes = GT.build_planes(jnp.array(mask), jnp.array(gid) if K > 1 else None, GS)
    seeds = jnp.zeros((L,), jnp.int32)

    def ker(x, W, a, v):
        return GT.hourglass_train(x, planes, W, a, v, seeds, GS, K=K, dropout_rate=0.0,
                                  deterministic=True, tile=1, interpret=True)

    cot = np.random.default_rng(9).normal(size=x0.shape).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        args = [jh(x0)] + [jnp.array(a) for a in (Ws, atts, vecs)]
        want = ker(*args)
        want_g = jax.grad(lambda *a: jnp.sum(ker(*a).astype(jnp.float32) * cot),
                          argnums=(0, 1, 2, 3))(*args)
    assert want.dtype == want_g[0].dtype == jnp.float16
    tplanes = gt.build_planes(t(mask), t(gid) if K > 1 else None, GS)
    xh = th(x0).requires_grad_(True)
    leaves = [t(a).requires_grad_(True) for a in (Ws, atts, vecs)]
    got = gt.hourglass_train(xh, tplanes, *leaves, None, GS, K=K, deterministic=True,
                             chans=[(C, C)] * L)
    got_g = torch.autograd.grad((got.float() * t(cot)).sum(), [xh] + leaves)
    assert got.dtype == got_g[0].dtype == F16
    assert all(g.dtype == torch.float32 for g in got_g[1:])
    scale = np.abs(as64(want)).max()
    assert_ulps(got, want, 2, 1e-3 * scale, f"K={K} y")
    for nm, a, b in zip(("gx", "gW", "gatt", "gvec"), got_g, want_g):
        s = np.abs(as64(b)).max() + 1e-6
        if nm == "gx":
            assert_ulps(a, b, 2, 1e-3 * s, f"K={K} gx")
        else:
            np.testing.assert_allclose(as64(a) / s, as64(b) / s, atol=GRAD_TOL, err_msg=f"K={K} {nm}")
    with torch.no_grad():
        plain32 = gt.hourglass_train(t(x0), tplanes, t(Ws), t(atts), t(vecs), None, GS, K=K,
                                     deterministic=True, chans=[(C, C)] * L)
    assert_not_f32(got, plain32, 5e-3, "stack")


@pytest.mark.parametrize("multi", [False, True], ids=["k1", "k3_gid"])
def test_hourglass_plain_f16_matches_the_flax_f16_stack(multi, synthetic_samples, small_cfg):
    """hourglass_plain on f16 x against GridHourglass at dtype f16 (deterministic)."""
    cfg = tiny_cfg(small_cfg, LAYOUT="grid", GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=64)
    hidden, repeat = 16, 2
    gb = multi_batch(synthetic_samples, cfg) if multi else jgrid.pack_grid(
        synthetic_samples[:3], cfg, batch_slots=3)
    K = gb.graph_mask.shape[1] if multi else 1
    gid = None if K == 1 else np.asarray(gb.gid)
    rng = np.random.default_rng(21 + K)
    feats = rng.normal(size=tuple(gb.mask.shape) + (hidden,)) * np.asarray(gb.mask)[..., None]
    feats = np.asarray(jh(feats).astype(jnp.float32))
    mk = dict(conv_type="GATCONV", hidden_dim=hidden, repeat=repeat)
    stack = jgl.GridHourglass(**mk, dtype=jnp.float16)
    jargs = (jnp.array(gb.mask), True, None if gid is None else jnp.array(gid), K)
    params = perturb(jax.jit(lambda: stack.init({"params": jax.random.key(0, impl="threefry2x32")},
                                                jh(feats), *jargs))()["params"], 22, scale=0.1)
    want = jax.jit(lambda p, x_: stack.apply({"params": p}, x_, *jargs))(params, jh(feats))
    assert want.dtype == jnp.float16
    with jax.default_matmul_precision("highest"):
        want32 = jax.jit(lambda p, x_: jgl.GridHourglass(**mk).apply({"params": p}, x_, *jargs))(
            params, jnp.array(feats))
    Ws, atts, vecs = (t(a) for a in jhg_pack(params, hidden, repeat))
    chans = hg.hourglass_channel_pairs(hidden, repeat)
    got = hg.hourglass_plain(th(feats), t(gb.mask), Ws, atts, vecs, chans,
                             None if gid is None else t(gid), K)
    assert got.dtype == F16 and torch.isfinite(got).all()
    flax_err = np.abs(as64(want) - as64(want32)).max()
    diff = np.abs(as64(got) - as64(want)).max()
    assert diff <= 1.5 * flax_err, (diff, flax_err)
    assert_not_f32(got, want32, 5e-3, "hourglass twin")


# --- the grid models, their losses and the served path --------------------------------------

@pytest.fixture(scope="module")
def case(synthetic_samples, small_cfg):
    """A K = 3 batch (tests/test_torch_bf16_models.py holds both K = 1 and K = 3 at bf16:
    the dtype changes nothing the batch's layout reaches)."""
    cfg = tiny_cfg(small_cfg, LAYOUT="grid", GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=64,
                   COMPUTE_DTYPE="float16")
    gb = multi_batch(synthetic_samples, cfg)
    rng = np.random.default_rng(18)
    shape = tuple(gb.mask.shape)
    z = rng.normal(size=shape + (cfg.Z_DIM,)).astype(np.float32)
    noise = rng.gumbel(size=shape + (7,)).astype(np.float32)
    label = np.eye(7, dtype=np.float32)[rng.integers(0, 7, shape)]
    key = jax.random.key(5)
    disc, gen = JDiscriminator(configuration=cfg), JGenerator(configuration=cfg)  # f16
    pd = perturb(jax.jit(lambda: disc.init({"params": key}, gb, jnp.array(label),
                                           deterministic=True))()["params"], 1, 0.05)
    pg = perturb(jax.jit(lambda: gen.init({"params": key, "gumbel": key}, gb, jnp.array(z),
                                          deterministic=True))()["params"], 2, 0.05)
    ref = _jax_refs(cfg, gb, z, noise, label, key, disc, gen, pd, pg)
    tcfg = port_cfg(cfg)
    tdisc = GridVoxelGNNDiscriminator(tcfg)
    tdisc.load_state_dict(discriminator_params_to_state_dict(pd, tcfg))
    tgen = GridVoxelGNNGenerator(tcfg)
    tgen.load_state_dict(generator_params_to_state_dict(pg, tcfg))
    assert tgen.compute_dtype == tdisc.compute_dtype == F16
    cfg32 = tcfg.replace(COMPUTE_DTYPE="float32")
    f32 = {"gen": GridVoxelGNNGenerator(cfg32), "disc": GridVoxelGNNDiscriminator(cfg32)}
    f32["gen"].load_state_dict(tgen.state_dict())
    f32["disc"].load_state_dict(tdisc.state_dict())
    return tcfg, port_batch(gb), z, noise, label, ref, tdisc, tgen, f32


def test_generator_f16_matches_flax(case):
    tcfg, batch, z, noise, _, ref, _, tgen, f32 = case
    with torch.no_grad():
        got, _, _ = tgen(batch, t(z), gumbel_noise=t(noise))
        fused, _, _ = FT.generator_apply_fused(tgen, tcfg, batch, t(z), gumbel_noise=t(noise),
                                               deterministic=True)
        served, _, _ = fast_infer.infer(tgen, fast_infer.prepare(tgen, tcfg), batch, t(z),
                                        gumbel_noise=t(noise))
        ref32, _, _ = f32["gen"](batch, t(z), gumbel_noise=t(noise))
    assert got.dtype == fused.dtype == served.dtype == torch.float32
    for name, a, want in (("plain", got, ref["logits"]), ("fused", fused, ref["fused_logits"]),
                          ("served", served, ref["logits"])):
        assert torch.isfinite(a).all(), name
        assert_rel(a, want, LOGIT_RTOL, f"{name} generator")
        assert_as_accurate(a, want, ref["logits32"], f"{name} generator")
        assert_not_f32(a, ref32, F32_RTOL, f"{name} generator")
    assert_types_where_decided(got.numpy(), ref["logits"], noise, "plain generator types")


def test_critic_f16_matches_flax(case):
    tcfg, batch, _, _, label, ref, tdisc, _, f32 = case
    with torch.no_grad():
        got = tdisc(batch, t(label))
        fused = FT.discriminator_apply_fused(tdisc, tcfg, batch, t(label), deterministic=True)
        at32 = tdisc(batch, t(label), dtype=torch.float32)  # the GP_DTYPE "float32" critic
        ref32 = f32["disc"](batch, t(label))
    assert got.dtype == fused.dtype == torch.float32
    for name, a, want in (("plain", got, ref["scores"]), ("fused", fused, ref["fused_scores"])):
        assert_rel(a, want, LOGIT_RTOL, f"{name} critic")
        assert_as_accurate(a, want, ref["scores32"], f"{name} critic")
        assert_not_f32(a, ref32, F32_RTOL, f"{name} critic")
    assert torch.equal(at32, ref32)


@pytest.mark.parametrize("gp_dtype", ["compute", "float32"])
def test_critic_loss_f16_matches_jax(case, gp_dtype):
    """The critic update's loss: the plain f16 critic, its penalty at GP_DTYPE,
    differentiated twice; every parameter grad finite and f32."""
    tcfg, batch, _, _, _, ref, tdisc, _, _ = case
    dt = torch.float32 if gp_dtype == "float32" else None
    tdisc.zero_grad()
    got = TL.discriminator_loss(
        lambda lbl: tdisc(batch, lbl), t(ref["types_onehot"]), t(ref["label_hard"]),
        t(ref["label_soft"]), batch.mask, tcfg.replace(GP_DTYPE=gp_dtype), eps=t(ref["eps"]),
        d_apply_gp=lambda lbl: tdisc(batch, lbl, dtype=dt),
    )
    got.backward()
    got_gp = TL.gradient_penalty(lambda lbl: tdisc(batch, lbl, dtype=dt), t(ref["types_onehot"]),
                                 t(ref["label_soft"]), batch.mask, tcfg.LAMBDA_GP,
                                 eps=t(ref["eps"])).item()
    assert got.dtype == torch.float32 and ref["gp32"] > 0.1 and np.isfinite(ref["gp"])
    assert abs(got.item() - got_gp - float(ref["adv"])) <= ULP16 * float(ref["score_scale"])
    if gp_dtype == "float32":
        np.testing.assert_allclose(got_gp, float(ref["gp32"]), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    else:
        assert got_gp != float(ref["gp32"])  # through the f16 critic
        assert_as_accurate(got_gp, ref["gp"], ref["gp32"], "penalty at f16")
    for k, p in tdisc.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, k
        assert torch.isfinite(p.grad).all(), k


def test_generator_loss_f16_matches_jax(case):
    tcfg, batch, z, noise, _, ref, tdisc, tgen, _ = case
    tgen.zero_grad()
    got_logits, _, _ = tgen(batch, t(z), gumbel_noise=t(noise))
    got, got_aux = TL.generator_loss(lambda lbl: tdisc(batch, lbl), batch, got_logits,
                                     t(ref["label_hard"]), tcfg)
    adv_tol = ULP16 * float(ref["score_scale"])
    np.testing.assert_allclose(got.item(), float(ref["g_loss"]), rtol=0, atol=adv_tol)
    assert set(got_aux) == set(ref["g_aux"])
    for k, v in ref["g_aux"].items():
        adv = k == "g_loss_adv"
        np.testing.assert_allclose(got_aux[k].item(), float(v), rtol=0 if adv else LOSS_RTOL,
                                   atol=adv_tol if adv else LOSS_ATOL, err_msg=k)
    got.backward(inputs=list(tgen.parameters()))
    for k, p in tgen.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), k


# --- the edge layout ------------------------------------------------------------------------

def test_edge_models_at_float16_match_flax(synthetic_samples, small_cfg):
    """The edge-layout GATCONV generator and critic at f16 on one pack, on real nodes
    (padded nodes carry rounding noise no loss reads)."""
    from building_gan_tpu.data import batching as jbatching

    cfg = tiny_cfg(small_cfg, COMPUTE_DTYPE="float16")
    jp = jbatching.pack_graphs(synthetic_samples, cfg)[0]
    tp = tbatching.pack_graphs(synthetic_samples, port_cfg(cfg))[0]
    nv = jp.voxel_x.shape[0]
    rng = np.random.default_rng(44)
    z = rng.normal(size=(nv, cfg.Z_DIM)).astype(np.float32)
    noise = rng.gumbel(size=(nv, 7)).astype(np.float32)
    label = np.eye(7, dtype=np.float32)[rng.integers(0, 7, nv)]
    key = jax.random.key(13)
    gen, disc = JEdgeGenerator(configuration=cfg), JEdgeDiscriminator(configuration=cfg)
    pg = perturb(jax.jit(lambda: gen.init({"params": key, "gumbel": key}, jp, jnp.asarray(z),
                                          deterministic=True))()["params"], 45, 0.05)
    pd = perturb(jax.jit(lambda: disc.init({"params": key}, jp, jnp.asarray(label),
                                           deterministic=True))()["params"], 46, 0.05)

    def run(g, d):
        return (g.apply({"params": pg}, jp, jnp.asarray(z), deterministic=True,
                        rngs={"gumbel": key})[0],
                d.apply({"params": pd}, jp, jnp.asarray(label), deterministic=True))

    want = jax.jit(lambda: run(gen, disc))()
    with jax.default_matmul_precision("highest"):
        want32 = jax.jit(lambda: run(gen.clone(dtype=jnp.float32), disc.clone(dtype=jnp.float32)))()
    got = {}
    for dt in ("float16", "float32"):
        c = port_cfg(cfg).replace(COMPUTE_DTYPE=dt)
        g, d = VoxelGNNGenerator(c), VoxelGNNDiscriminator(c)
        g.load_state_dict(generator_params_to_state_dict(pg, c))
        d.load_state_dict(discriminator_params_to_state_dict(pd, c))
        with torch.no_grad():
            got[dt] = (g(tp, t(z), gumbel_noise=t(noise))[0], d(tp, t(label)))
    real = tp.voxel_mask.numpy() > 0
    for i, name in enumerate(("logits", "scores")):
        h16, f32 = got["float16"][i], got["float32"][i]
        assert h16.dtype == torch.float32 and torch.isfinite(h16).all(), name
        a, w, w32 = as64(h16)[real], as64(want[i])[real], as64(want32[i])[real]
        assert_rel(a, w, LOGIT_RTOL, name)
        assert_as_accurate(a, w, w32, name)
        assert_not_f32(a, as64(f32)[real], F32_RTOL, name)


# --- the train step and the server ----------------------------------------------------------

@pytest.mark.parametrize("gp_dtype", ["compute", "float32"])
def test_train_step_at_float16(synthetic_samples, small_cfg, gp_dtype):
    """One whole WGAN-GP step at COMPUTE_DTYPE float16 on a K = 3 batch (the plain paths
    on the CPU): finite losses and metrics, every parameter but the critic's score bias
    moves, parameters and Adam moments stay f32."""
    from building_gan_torch.train import state as TS
    from building_gan_torch.train.step import make_eval_step, make_train_step

    jcfg = tiny_cfg(small_cfg, LAYOUT="grid", GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=64,
                    GP_DTYPE=gp_dtype, COMPUTE_DTYPE="float16")
    cfg = port_cfg(jcfg)
    batch = port_batch(multi_batch(synthetic_samples, jcfg))
    torch.manual_seed(0)
    state = TS.create_train_state(cfg, GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg),
                                  device="cpu")
    assert state.generator.compute_dtype == F16
    before = [{k: v.clone() for k, v in m.state_dict().items()}
              for m in (state.generator, state.discriminator)]
    metrics = make_train_step(cfg, state)(batch, torch.Generator().manual_seed(1))
    for k, v in metrics.items():
        assert torch.isfinite(v).all(), k
    assert metrics["g_loss"].dtype == metrics["d_loss"].dtype == torch.float32
    for m, old, fixed in zip((state.generator, state.discriminator), before, (set(), {"decoder.6.bias"})):
        assert {k for k, v in m.state_dict().items() if torch.equal(v, old[k])} == fixed
        assert {p.dtype for p in m.parameters()} == {torch.float32}
    for opt in (state.opt_g, state.opt_d):
        for st in opt.state.values():
            assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
    ev = make_eval_step(cfg, state)(batch, torch.Generator().manual_seed(2))
    for k, v in ev.items():
        assert torch.isfinite(torch.as_tensor(v)).all(), k


def test_server_at_float16_matches_the_flax_generator(synthetic_samples, small_cfg):
    """InferenceServer at COMPUTE_DTYPE float16: what it serves, against the flax f16
    generator on the server's own z (drawn in f32, cast on entry), K = 1."""
    cfg = tiny_cfg(small_cfg, LAYOUT="grid", GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=64,
                   COMPUTE_DTYPE="float16")
    tcfg = port_cfg(cfg)
    key = jax.random.key(3)
    local, voxel = synthetic_samples[2]
    gb = jgrid.pack_grid([(local, voxel)], cfg, batch_slots=2)
    gen = JGenerator(configuration=cfg)
    z0 = np.zeros(tuple(gb.mask.shape) + (cfg.Z_DIM,), np.float32)
    pg = perturb(jax.jit(lambda: gen.init({"params": key, "gumbel": key}, gb, jnp.array(z0),
                                          deterministic=True))()["params"], 4, 0.05)
    sd = generator_params_to_state_dict(pg, tcfg)
    out = {}
    for dt in ("float16", "float32"):
        srv = InferenceServer(tcfg.replace(COMPUTE_DTYPE=dt), sd, max_batch=2, max_delay_ms=5.0,
                              device="cpu").start()
        try:
            out[dt] = srv.infer(local, voxel, seed=11, timeout_s=120.0)
        finally:
            srv.stop()
        assert srv._weights[0].compute_dtype == getattr(torch, dt)
    z, _ = srv._noise([11])
    pos = np.asarray(voxel.location).astype(int)

    def want_of(g):
        o = jax.jit(lambda: g.apply({"params": pg}, gb, jnp.array(z.numpy()), deterministic=True,
                                    rngs={"gumbel": key})[0])()
        return np.asarray(o)[0, pos[:, 0], pos[:, 1], pos[:, 2]]

    want = want_of(gen)
    with jax.default_matmul_precision("highest"):
        want32 = want_of(gen.clone(dtype=jnp.float32))
    served = out["float16"]["logits"]
    assert served.dtype == np.float32 and np.isfinite(served).all()
    assert_rel(served, want, LOGIT_RTOL, "served logits")
    assert_as_accurate(served, want, want32, "served logits")
    assert_not_f32(served, out["float32"]["logits"], F32_RTOL, "served")
