"""The port's models, losses and server at COMPUTE_DTYPE bfloat16 vs the JAX package's (CPU).

Weights cross through the converters; z, the Gumbel noise and the GP eps are
numpy or the JAX package's own draws, given to both sides.  tiny_cfg sizes,
the config's own dtypes (COMPUTE_DTYPE bfloat16, GP_DTYPE "compute", or
"float32" where stated), deterministic models.

- the generator's logits and the critic's scores, the plain modules against
  the flax models at bf16, and the fused paths (``fast_train`` on the CPU:
  the plain bf16 training layer) against the JAX package's fused functions
  with the Pallas kernels in interpret mode fed bf16, K = 1 and K = 3;
- the served path (``fast_infer``: the serving hourglass's plain bf16 twin)
  against the flax bf16 generator, which is what the JAX server runs;
- the critic loss with its gradient penalty at GP_DTYPE "compute" and
  "float32", and the generator loss with its terms (the losses of a train
  step's critic and generator updates);
- the ``InferenceServer`` at the default config: what it serves against the
  flax bf16 generator on the server's own noise.

Tolerances (bf16 has 8 significant bits: an ulp is 2^-7 of a value in
[1, 2)).  The layers agree with the JAX package's bit for bit or within two
ulps (tests/test_torch_bf16_layers.py), but a rounding step taken
differently (XLA keeps excess precision inside some fusions, torch rounds
every op) moves a hidden value by an ulp, and ~20 bf16 layers carry it on:
at these sizes each side's bf16 logits are 4-11% of their largest magnitude
from the f32 model's, and from each other.  So each bf16 result is held
(1) to the JAX package's bf16 result within LOGIT_RTOL of its largest
magnitude, elementwise; (2) to the JAX package's f32 result (the quantity
both approximate) within ACC_FACTOR times the JAX bf16 result's own largest
distance from it, plus 1e-3 of scale: the port is about as accurate as the
reference at bf16 (each is one draw of rounding error: the ratio measured
0.07-2.1 over these cases); and (3) to the port's own f32 result on the same weights
and inputs: it must differ (a silent f32 path would not), by at most
F32_RTOL of its largest magnitude (measured up to 0.12).  Hard types are
compared where the reference's top-2 margin (logits + Gumbel noise) exceeds
twice the largest logit difference: Gumbel argmax flips within rounding.
The penalty at GP_DTYPE "float32" and the generator loss's label, ratio
and FAR terms within LOSS_RTOL (relative) + LOSS_ATOL, as in f32; the
critic's real-fake term and the generator's adversarial term (means of bf16
scores) within one bf16 rounding (2^-8) of the scores' largest magnitude;
the penalty at GP_DTYPE "compute" (input gradients through bf16 activations:
1-12% between the packages) by (2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_gan_tpu.data import grid as jgrid
from building_gan_tpu.models import GridVoxelGNNDiscriminator as JDiscriminator
from building_gan_tpu.models import GridVoxelGNNGenerator as JGenerator
from building_gan_tpu.models import fast_train as JFT
from building_gan_tpu.ops.rng import bulk_key
from building_gan_tpu.train import losses as JL

from building_gan_torch.checkpoint.torch_compat import (
    discriminator_params_to_state_dict, generator_params_to_state_dict,
)
from building_gan_torch.models import fast_infer
from building_gan_torch.models import fast_train as FT
from building_gan_torch.models.grid_models import GridVoxelGNNDiscriminator, GridVoxelGNNGenerator
from building_gan_torch.serving import InferenceServer
from building_gan_torch.train import losses as TL

from test_torch_layers import multi_batch, perturb, port_batch, port_cfg, t
from test_torch_losses import _st_gumbel_jax
from test_train import tiny_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

LOGIT_RTOL = 0.15
ACC_FACTOR = 3.0
F32_RTOL = 0.2
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6


def assert_rel(got, want, rtol, name):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rtol * scale, f"{name}: max err {err:.3e} > {rtol} x {scale:.3e}"


def assert_not_f32(b16, f32, name):
    """bf16 differs from f32 (a silent f32 path would not), within F32_RTOL of its scale."""
    d = np.abs(np.asarray(b16, np.float64) - np.asarray(f32, np.float64)).max()
    scale = np.abs(np.asarray(f32, np.float64)).max()
    assert 0 < d <= F32_RTOL * scale, f"{name}: bf16 - f32 = {d:.3e}, scale {scale:.3e}"


def assert_as_accurate(got, want_bf16, want_f32, name):
    """got within ACC_FACTOR x (the JAX bf16 result's distance from the JAX f32 one)."""
    got, wb, wf = (np.asarray(a, np.float64) for a in (got, want_bf16, want_f32))
    ref_err = np.abs(wb - wf).max()
    err = np.abs(got - wf).max()
    assert err <= ACC_FACTOR * ref_err + 1e-3 * np.abs(wf).max(), (
        f"{name}: {err:.3e} from f32, the JAX bf16 result {ref_err:.3e}")


def assert_types_where_decided(got_logits, want_logits, noise, name):
    """Argmax of logits + noise agrees wherever the reference's top-2 margin exceeds twice
    the largest logit difference."""
    want = np.asarray(want_logits, np.float64) + noise
    got = np.asarray(got_logits, np.float64) + noise
    top2 = np.sort(want, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 2 * np.abs(got - want).max()
    assert sure.mean() > 0.2, f"{name}: too few decided cells ({sure.mean():.2f})"
    np.testing.assert_array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure], err_msg=name)


def _jax_refs(cfg, gb, z, noise, label, key, disc, gen, pd, pg):
    """Every JAX result the tests compare with, jitted (eager bf16 on the CPU is slow)."""
    mask = jnp.asarray(gb.mask)
    types_onehot = jax.nn.one_hot(jnp.asarray(gb.type), 7) * mask[..., None]
    disc32, gen32 = disc.clone(dtype=jnp.float32), gen.clone(dtype=jnp.float32)

    def logits_of(g):
        return g.apply({"params": pg}, gb, jnp.array(z), deterministic=True, rngs={"gumbel": key})[0]

    def scores_of(d, lbl):
        return d.apply({"params": pd}, gb, lbl, deterministic=True)

    def refs():
        logits = logits_of(gen)
        label_hard, label_soft = _st_gumbel_jax(logits, jnp.array(noise))
        eps = jax.random.uniform(bulk_key(key), mask.shape + (1,), dtype=types_onehot.dtype)

        def gp(d):
            return JL.gradient_penalty(lambda lbl: scores_of(d, lbl), types_onehot, label_soft,
                                       mask, key, cfg.LAMBDA_GP)

        g_loss, g_aux = JL.generator_loss(lambda lbl: scores_of(disc, lbl), gb, logits,
                                          label_hard, cfg)
        return {
            "logits": logits,
            "fused_logits": JFT.generator_apply_fused(pg, cfg, gb, jnp.array(z), key, None,
                                                      deterministic=True, tile=1, interpret=True)[0],
            "scores": scores_of(disc, jnp.array(label)),
            "fused_scores": JFT.discriminator_apply_fused(pd, cfg, gb, jnp.array(label), None,
                                                          deterministic=True, tile=1,
                                                          interpret=True),
            "types_onehot": types_onehot, "label_hard": label_hard, "label_soft": label_soft,
            "eps": eps, "gp": gp(disc), "gp32": gp(disc32),
            "adv": (JL.masked_mean(scores_of(disc, label_hard), mask)
                    - JL.masked_mean(scores_of(disc, types_onehot), mask)),
            "score_scale": jnp.abs(scores_of(disc, types_onehot)).max(),
            "g_loss": g_loss, "g_aux": g_aux,
        }

    out = jax.tree.map(np.asarray, jax.jit(refs)())
    with jax.default_matmul_precision("highest"):  # the JAX package's f32 results
        out["logits32"] = np.asarray(jax.jit(lambda: logits_of(gen32))())
        out["scores32"] = np.asarray(jax.jit(lambda: scores_of(disc32, jnp.array(label)))())
    return out


@pytest.fixture(scope="module", params=[False, True], ids=["k1", "k3_gid"])
def case(request, synthetic_samples, small_cfg):
    multi = request.param
    cfg = tiny_cfg(small_cfg, LAYOUT="grid", GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=64)
    assert cfg.COMPUTE_DTYPE == "bfloat16" and cfg.GP_DTYPE == "compute"
    gb = multi_batch(synthetic_samples, cfg) if multi else jgrid.pack_grid(
        synthetic_samples[:3], cfg, batch_slots=3
    )
    rng = np.random.default_rng(8)
    shape = tuple(gb.mask.shape)
    z = rng.normal(size=shape + (cfg.Z_DIM,)).astype(np.float32)
    noise = rng.gumbel(size=shape + (7,)).astype(np.float32)
    label = np.eye(7, dtype=np.float32)[rng.integers(0, 7, shape)]
    key = jax.random.key(2)
    disc, gen = JDiscriminator(configuration=cfg), JGenerator(configuration=cfg)  # bf16
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
    assert tgen.compute_dtype == tdisc.compute_dtype == torch.bfloat16
    cfg32 = tcfg.replace(COMPUTE_DTYPE="float32")
    f32 = {"gen": GridVoxelGNNGenerator(cfg32), "disc": GridVoxelGNNDiscriminator(cfg32)}
    f32["gen"].load_state_dict(tgen.state_dict())
    f32["disc"].load_state_dict(tdisc.state_dict())
    return tcfg, port_batch(gb), z, noise, label, ref, tdisc, tgen, f32


def test_generator_bf16_matches_flax(case):
    tcfg, batch, z, noise, _, ref, _, tgen, f32 = case
    assert ref["logits"].dtype == np.float32  # the head's logits in f32
    with torch.no_grad():
        got, _, _ = tgen(batch, t(z), gumbel_noise=t(noise))
        fused, _, _ = FT.generator_apply_fused(tgen, tcfg, batch, t(z), gumbel_noise=t(noise),
                                               deterministic=True)
        ref32, _, _ = f32["gen"](batch, t(z), gumbel_noise=t(noise))
    assert got.dtype == fused.dtype == torch.float32
    assert_rel(got.numpy(), ref["logits"], LOGIT_RTOL, "plain generator")
    assert_rel(fused.numpy(), ref["fused_logits"], LOGIT_RTOL, "fused generator")
    assert_as_accurate(got.numpy(), ref["logits"], ref["logits32"], "plain generator")
    assert_as_accurate(fused.numpy(), ref["fused_logits"], ref["logits32"], "fused generator")
    assert_types_where_decided(got.numpy(), ref["logits"], noise, "plain generator types")
    assert_not_f32(got.numpy(), ref32.numpy(), "plain generator")
    assert_not_f32(fused.numpy(), ref32.numpy(), "fused generator")


def test_critic_bf16_matches_flax(case):
    tcfg, batch, _, _, label, ref, tdisc, _, f32 = case
    assert ref["scores"].dtype == np.float32
    with torch.no_grad():
        got = tdisc(batch, t(label))
        fused = FT.discriminator_apply_fused(tdisc, tcfg, batch, t(label), deterministic=True)
        at32 = tdisc(batch, t(label), dtype=torch.float32)  # the GP_DTYPE "float32" critic
        ref32 = f32["disc"](batch, t(label))
    assert got.dtype == fused.dtype == torch.float32
    assert_rel(got.numpy(), ref["scores"], LOGIT_RTOL, "plain critic")
    assert_rel(fused.numpy(), ref["fused_scores"], LOGIT_RTOL, "fused critic")
    assert_as_accurate(got.numpy(), ref["scores"], ref["scores32"], "plain critic")
    assert_as_accurate(fused.numpy(), ref["fused_scores"], ref["scores32"], "fused critic")
    assert torch.equal(at32, ref32)
    assert_not_f32(got.numpy(), ref32.numpy(), "plain critic")
    assert_not_f32(fused.numpy(), ref32.numpy(), "fused critic")


def test_served_path_bf16_matches_the_flax_generator(case):
    """fast_infer at bf16 (the serving hourglass's plain twin) against the flax bf16
    generator, the JAX server's and eval step's path."""
    tcfg, batch, z, noise, _, ref, _, tgen, f32 = case
    got, _, _ = fast_infer.infer(tgen, fast_infer.prepare(tgen, tcfg), batch, t(z),
                                 gumbel_noise=t(noise))
    ref32, _, _ = fast_infer.infer(f32["gen"], fast_infer.prepare(f32["gen"], tcfg), batch, t(z),
                                   gumbel_noise=t(noise))
    assert got.dtype == torch.float32
    assert_rel(got.numpy(), ref["logits"], LOGIT_RTOL, "served generator")
    assert_as_accurate(got.numpy(), ref["logits"], ref["logits32"], "served generator")
    assert_not_f32(got.numpy(), ref32.numpy(), "served generator")


@pytest.mark.parametrize("gp_dtype", ["compute", "float32"])
def test_critic_loss_bf16_matches_jax(case, gp_dtype):
    """The critic update's loss: the plain critic at bf16, its penalty at GP_DTYPE,
    differentiated twice."""
    tcfg, batch, _, _, _, ref, tdisc, _, _ = case
    dt = torch.float32 if gp_dtype == "float32" else None
    tdisc.zero_grad()
    got = TL.discriminator_loss(
        lambda lbl: tdisc(batch, lbl), t(ref["types_onehot"]), t(ref["label_hard"]),
        t(ref["label_soft"]), batch.mask, tcfg.replace(GP_DTYPE=gp_dtype), eps=t(ref["eps"]),
        d_apply_gp=lambda lbl: tdisc(batch, lbl, dtype=dt),
    )
    got.backward()  # the penalty differentiated twice, through the bf16 critic under "compute"
    got_gp = TL.gradient_penalty(lambda lbl: tdisc(batch, lbl, dtype=dt), t(ref["types_onehot"]),
                                 t(ref["label_soft"]), batch.mask, tcfg.LAMBDA_GP,
                                 eps=t(ref["eps"])).item()
    assert got.dtype == torch.float32 and ref["gp32"] > 0.1
    # the critic loss less the penalty, a difference of two means of bf16 scores: within
    # one bf16 rounding (2^-8) of the scores' largest magnitude
    assert abs(got.item() - got_gp - float(ref["adv"])) <= 2.0**-8 * float(ref["score_scale"])
    if gp_dtype == "float32":
        np.testing.assert_allclose(got_gp, float(ref["gp32"]), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    else:
        assert got_gp != float(ref["gp32"])  # through the bf16 critic
        assert_as_accurate(got_gp, ref["gp"], ref["gp32"], "penalty at bf16")
    for k, p in tdisc.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, k
        assert torch.isfinite(p.grad).all(), k


def test_generator_loss_bf16_matches_jax(case):
    tcfg, batch, z, noise, _, ref, tdisc, tgen, _ = case
    tgen.zero_grad()
    # the port's own logits, with the JAX generator's hard labels: an argmax of the
    # port's logits would flip within rounding
    got_logits, _, _ = tgen(batch, t(z), gumbel_noise=t(noise))
    got, got_aux = TL.generator_loss(lambda lbl: tdisc(batch, lbl), batch, got_logits,
                                     t(ref["label_hard"]), tcfg)
    # the adversarial term, a mean of bf16 scores: within one bf16 rounding (2^-8) of
    # the scores' largest magnitude; the others (from the hard labels) as in f32
    adv_tol = 2.0**-8 * float(ref["score_scale"])
    np.testing.assert_allclose(got.item(), float(ref["g_loss"]), rtol=0, atol=adv_tol)
    assert set(got_aux) == set(ref["g_aux"])
    for k, v in ref["g_aux"].items():
        np.testing.assert_allclose(got_aux[k].item(), float(v), rtol=0 if k == "g_loss_adv" else
                                   LOSS_RTOL, atol=adv_tol if k == "g_loss_adv" else LOSS_ATOL,
                                   err_msg=k)
    got.backward(inputs=list(tgen.parameters()))
    for k, p in tgen.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), k


def test_server_at_the_default_dtype_matches_the_flax_generator(synthetic_samples, small_cfg):
    """InferenceServer at COMPUTE_DTYPE bfloat16: what it serves, against the flax bf16
    generator on the server's own z (drawn in f32, cast on entry) and K = 1 batch."""
    from building_gan_torch.data import grid as tgrid

    cfg = tiny_cfg(small_cfg, LAYOUT="grid", GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=64)
    tcfg = port_cfg(cfg)
    key = jax.random.key(3)
    local, voxel = synthetic_samples[2]
    gb = jgrid.pack_grid([(local, voxel)], cfg, batch_slots=2)
    gen = JGenerator(configuration=cfg)
    z0 = np.zeros(tuple(gb.mask.shape) + (cfg.Z_DIM,), np.float32)
    pg = perturb(jax.jit(lambda: gen.init({"params": key, "gumbel": key}, gb, jnp.array(z0),
                                          deterministic=True))()["params"], 4, 0.05)
    sd = generator_params_to_state_dict(pg, tcfg)
    srv = InferenceServer(tcfg, sd, max_batch=2, max_delay_ms=5.0, device="cpu").start()
    try:
        served = srv.infer(local, voxel, seed=11, timeout_s=120.0)
    finally:
        srv.stop()
    z, _ = srv._noise([11])
    assert z.dtype == torch.float32
    pos = np.asarray(voxel.location).astype(int)

    def want_of(g):
        out = jax.jit(lambda: g.apply({"params": pg}, gb, jnp.array(z.numpy()), deterministic=True,
                                      rngs={"gumbel": key})[0])()
        return np.asarray(out)[0, pos[:, 0], pos[:, 1], pos[:, 2]]

    want = want_of(gen)
    with jax.default_matmul_precision("highest"):
        want32 = want_of(gen.clone(dtype=jnp.float32))
    assert served["logits"].dtype == np.float32 and np.isfinite(served["logits"]).all()
    assert_rel(served["logits"], want, LOGIT_RTOL, "served logits")
    assert_as_accurate(served["logits"], want, want32, "served logits")
    f32 = InferenceServer(tcfg.replace(COMPUTE_DTYPE="float32"), sd, max_batch=2, device="cpu")
    b32 = tgrid.pack_grid([(local, voxel)], f32.configuration, batch_slots=2)
    ref32, _, _ = fast_infer.infer(*f32._weights, b32, z, gumbel_noise=torch.zeros(z.shape[:-1] + (7,)))
    assert_not_f32(served["logits"], ref32.numpy()[0, pos[:, 0], pos[:, 1], pos[:, 2]], "served")


@pytest.mark.parametrize("gp_dtype", ["compute", "float32"])
def test_train_step_at_bfloat16(synthetic_samples, small_cfg, gp_dtype):
    """One whole WGAN-GP step at COMPUTE_DTYPE bfloat16 on a K = 3 batch (the plain
    paths on the CPU): finite losses and metrics, every parameter but the critic's
    score bias moves, parameters and Adam moments stay f32."""
    from building_gan_torch.ops import gat_train as gt
    from building_gan_torch.train import state as TS
    from building_gan_torch.train.step import make_train_step

    jcfg = tiny_cfg(small_cfg, LAYOUT="grid", GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=64,
                    GP_DTYPE=gp_dtype)
    cfg = port_cfg(jcfg)
    batch = port_batch(multi_batch(synthetic_samples, jcfg))
    torch.manual_seed(0)
    state = TS.create_train_state(cfg, GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg),
                                  device="cpu")
    before = [{k: v.clone() for k, v in m.state_dict().items()}
              for m in (state.generator, state.discriminator)]
    counts = (gt.fwd_launches.value, gt.bwd_launches.value)
    metrics = make_train_step(cfg, state)(batch, torch.Generator().manual_seed(1))
    assert (gt.fwd_launches.value, gt.bwd_launches.value) == counts  # CPU: the plain path
    for k, v in metrics.items():
        assert torch.isfinite(v).all(), k
    assert metrics["g_loss"].dtype == metrics["d_loss"].dtype == torch.float32
    for m, old, fixed in zip((state.generator, state.discriminator), before, (set(), {"decoder.6.bias"})):
        assert {k for k, v in m.state_dict().items() if torch.equal(v, old[k])} == fixed
        assert {p.dtype for p in m.parameters()} == {torch.float32}
    for opt in (state.opt_g, state.opt_d):
        for st in opt.state.values():
            assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
