"""The port's WGAN-GP losses and their gradients vs the JAX package (f32, CPU).

Critic loss (with the gradient penalty, differentiated twice) and generator
loss (with its terms: adversarial, label CE, the ``[-2:]`` ratio split, the
detached FAR term) on K = 1 and K = 3 batches, and the gradient of each with
respect to every critic or generator parameter.  Both sides get the same
weights (through the converters), z, Gumbel noise and GP eps; the eps is the
JAX package's own draw, ``jax.random.uniform(bulk_key(key), ...)``.  JAX's
gradients are carried to the torch layout by the same converters as the
weights.  The models run deterministic (dropout is covered in
tests/test_torch_critic.py).

Tolerance: losses rtol 1e-4 / atol 1e-5; each critic parameter gradient
within 1e-4 of its largest magnitude plus 1e-6 (f32 sums in other orders
through the double backward of the penalty and the hourglass).  Generator
gradients: within 3e-3 of the largest magnitude.  The K = 3 case has a ReLU
pre-activation within f32 rounding of zero (|z| = 4.4e-6 in the last
hourglass layer; the port's f32 value lands on the other side of 0 from
both JAX's f32 and the port run in f64), so one term of each downstream sum
switches and the hourglass grads move by up to 2.1e-3 of their largest
magnitude, while every forward quantity agrees to ~1e-5 and the decoder
grads to ~1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_gan_tpu.data import grid as jgrid
from building_gan_tpu.models import GridVoxelGNNDiscriminator as JDiscriminator
from building_gan_tpu.models import GridVoxelGNNGenerator as JGenerator
from building_gan_tpu.ops.rng import bulk_key
from building_gan_tpu.train import losses as JL

from building_gan_torch.checkpoint.torch_compat import (
    discriminator_params_to_state_dict, generator_params_to_state_dict,
)
from building_gan_torch.models.grid_models import GridVoxelGNNDiscriminator, GridVoxelGNNGenerator
from building_gan_torch.train import losses as TL

from test_torch_layers import multi_batch, perturb, port_batch, port_cfg, t
from test_train import tiny_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

LOSS_RTOL, LOSS_ATOL, GRAD_TOL, GEN_GRAD_TOL = 1e-4, 1e-5, 1e-4, 3e-3


def _st_gumbel_jax(logits, noise):
    """gumbel_softmax_st with given noise (the JAX package draws it from a key inside)."""
    soft = jax.nn.softmax(logits + noise, axis=-1)
    hard = jax.nn.one_hot(jnp.argmax(soft, axis=-1), 7, dtype=logits.dtype)
    return hard - jax.lax.stop_gradient(soft) + soft, soft


def _assert_grads(got: dict, want: dict, tol: float):
    assert set(got) == set(want)
    for k, w in want.items():
        w = w.numpy()
        g = got[k]
        assert g is not None, k
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, atol=tol * scale + 1e-6, rtol=0, err_msg=k)


@pytest.fixture(scope="module", params=[False, True], ids=["k1", "k3_gid"])
def case(request, synthetic_samples, small_cfg):
    multi = request.param
    cfg = tiny_cfg(small_cfg, LAYOUT="grid", GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=64,
                   COMPUTE_DTYPE="float32")
    gb = multi_batch(synthetic_samples, cfg) if multi else jgrid.pack_grid(
        synthetic_samples[:3], cfg, batch_slots=3
    )
    rng = np.random.default_rng(8)
    shape = tuple(gb.mask.shape)
    z = rng.normal(size=shape + (cfg.Z_DIM,)).astype(np.float32)
    noise = rng.gumbel(size=shape + (7,)).astype(np.float32)
    key = jax.random.key(2)
    with jax.default_matmul_precision("highest"):
        disc = JDiscriminator(configuration=cfg, dtype=jnp.float32)
        gen = JGenerator(configuration=cfg, dtype=jnp.float32)
        label0 = jax.nn.one_hot(jnp.asarray(gb.type), 7)
        pd = perturb(disc.init({"params": key}, gb, label0, deterministic=True)["params"], 1, 0.05)
        pg = perturb(gen.init({"params": key, "gumbel": key}, gb, jnp.array(z),
                              deterministic=True)["params"], 2, 0.05)
    tcfg = port_cfg(cfg)
    tdisc = GridVoxelGNNDiscriminator(tcfg)
    tdisc.load_state_dict(discriminator_params_to_state_dict(pd, tcfg))
    tgen = GridVoxelGNNGenerator(tcfg)
    tgen.load_state_dict(generator_params_to_state_dict(pg, tcfg))
    return cfg, tcfg, gb, port_batch(gb), z, noise, key, disc, gen, pd, pg, tdisc, tgen


def test_discriminator_loss_and_grads_match_jax(case):
    cfg, tcfg, gb, batch, z, noise, key, disc, gen, pd, pg, tdisc, _ = case
    mask = jnp.asarray(gb.mask)
    types_onehot = jax.nn.one_hot(jnp.asarray(gb.type), 7) * mask[..., None]
    with jax.default_matmul_precision("highest"):
        logits, _, _ = gen.apply({"params": pg}, gb, jnp.array(z), deterministic=True,
                                 rngs={"gumbel": key})
        label_hard, label_soft = _st_gumbel_jax(logits, jnp.array(noise))
        label_hard, label_soft = jax.lax.stop_gradient(label_hard), jax.lax.stop_gradient(label_soft)
        eps = jax.random.uniform(bulk_key(key), mask.shape + (1,), dtype=types_onehot.dtype)

        def loss_fn(p):
            return JL.discriminator_loss(
                lambda lbl: disc.apply({"params": p}, gb, lbl, deterministic=True),
                types_onehot, label_hard, label_soft, mask, key, cfg,
            )

        want, want_g = jax.jit(jax.value_and_grad(loss_fn))(pd)
        gp = jax.jit(lambda p: JL.gradient_penalty(
            lambda lbl: disc.apply({"params": p}, gb, lbl, deterministic=True),
            types_onehot, label_soft, mask, key, cfg.LAMBDA_GP,
        ))(pd)
    tdisc.zero_grad()
    got = TL.discriminator_loss(
        lambda lbl: tdisc(batch, lbl), t(types_onehot), t(label_hard), t(label_soft), batch.mask,
        tcfg, eps=t(eps),
    )
    got.backward()
    got_gp = TL.gradient_penalty(lambda lbl: tdisc(batch, lbl), t(types_onehot), t(label_soft),
                                 batch.mask, tcfg.LAMBDA_GP, eps=t(eps))
    np.testing.assert_allclose(got_gp.item(), float(gp), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert float(gp) > 0.1  # the penalty term is exercised, not vanishing
    _assert_grads({k: p.grad for k, p in tdisc.named_parameters()},
                  discriminator_params_to_state_dict(want_g, tcfg), GRAD_TOL)


def test_generator_loss_terms_and_grads_match_jax(case):
    cfg, tcfg, gb, batch, z, noise, key, disc, gen, pd, pg, tdisc, tgen = case

    def loss_fn(p):
        logits, _, _ = gen.apply({"params": p}, gb, jnp.array(z), deterministic=True,
                                 rngs={"gumbel": key})
        label_hard, _ = _st_gumbel_jax(logits, jnp.array(noise))
        return JL.generator_loss(
            lambda lbl: disc.apply({"params": pd}, gb, lbl, deterministic=True),
            gb, logits, label_hard, cfg,
        )

    with jax.default_matmul_precision("highest"):
        (want, want_aux), want_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(pg)
    tgen.zero_grad()
    logits, label_hard, _ = tgen(batch, t(z), gumbel_noise=t(noise))
    got, got_aux = TL.generator_loss(lambda lbl: tdisc(batch, lbl), batch, logits, label_hard, tcfg)
    got.backward(inputs=list(tgen.parameters()))
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert set(got_aux) == set(want_aux)
    for k, v in want_aux.items():
        np.testing.assert_allclose(got_aux[k].item(), float(v), rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                   err_msg=k)
    assert float(want_aux["g_loss_far"]) > 0 and not got_aux["g_loss_far"].requires_grad
    _assert_grads({k: p.grad for k, p in tgen.named_parameters()},
                  generator_params_to_state_dict(want_g, tcfg), GEN_GRAD_TOL)


def test_masked_mean_and_generated_far_match_jax(case):
    cfg, _, gb, batch, _, noise, *_ = case
    lh = np.eye(7, dtype=np.float32)[np.argmax(noise, -1)]
    np.testing.assert_allclose(TL.generated_far(batch, t(lh)).numpy(),
                               np.asarray(JL.generated_far(gb, jnp.array(lh))), rtol=1e-6)
    vals = noise[..., :2]
    np.testing.assert_allclose(TL.masked_mean(t(vals), batch.mask).item(),
                               float(JL.masked_mean(jnp.array(vals), jnp.asarray(gb.mask))), rtol=1e-6)
