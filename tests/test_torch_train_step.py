"""The port's optimizer state, learning-rate schedule and train step (CPU).

- One and two Adam updates from given gradients against ``optax.adam`` with
  the configured betas and eps (rtol 1e-5 / atol 1e-7: the same f32 update
  formula, the bias corrections computed in another order).
- ``cosine_lr`` against the JAX function, and ``set_g_lr``.
- ``create_train_state`` puts the modules on the card unless asked for
  another device, and the step refuses a batch on another device than the
  modules' (checked with modules on the ``meta`` device, batch on the CPU).
- The whole WGAN-GP step at tests/test_train.py::tiny_cfg sizes on a K = 3
  batch: finite losses and metrics, both modules move, the step count
  advances, and on CPU tensors no kernel launches.  The composed step is not
  compared with JAX's: docs/PERF.md section 8 shows it is chaotic in f32.
"""

import dataclasses
import inspect

import numpy as np
import optax
import pytest
import torch

from building_gan_tpu.train import state as JS

from building_gan_torch.config import Configuration
from building_gan_torch.models.grid_models import GridVoxelGNNDiscriminator, GridVoxelGNNGenerator
from building_gan_torch.ops import gat_train as gt
from building_gan_torch.train import state as TS
from building_gan_torch.train.step import make_eval_step, make_train_step

from test_torch_layers import multi_batch, port_batch, port_cfg
from test_train import tiny_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)


def test_adam_matches_optax(small_cfg):
    cfg = port_cfg(small_cfg)
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=w0.shape).astype(np.float32) for _ in range(2)]
    gen, disc = torch.nn.Linear(3, 5, bias=False), torch.nn.Linear(3, 5, bias=False)
    with torch.no_grad():
        gen.weight.copy_(torch.from_numpy(w0))
    opt_g, _ = TS.make_optimizers(cfg, gen, disc)
    tx = optax.adam(learning_rate=cfg.LEARNING_RATE_GENERATOR, b1=cfg.BETAS[0], b2=cfg.BETAS[1])
    params = w0
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update(g, opt_state, params)
        params = np.asarray(optax.apply_updates(params, updates))
        gen.weight.grad = torch.from_numpy(g.copy())
        opt_g.step()
        np.testing.assert_allclose(gen.weight.detach().numpy(), params, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("epoch", [0, 1, 2, 17, 2500, 4999, 5000, 6000])
def test_cosine_lr_matches_jax(small_cfg, epoch):
    cfg = port_cfg(small_cfg)
    assert TS.cosine_lr(cfg, epoch) == pytest.approx(JS.cosine_lr(small_cfg, epoch), rel=1e-12)


@pytest.fixture(scope="module")
def step_case(synthetic_samples, small_cfg):
    jcfg = tiny_cfg(small_cfg, LAYOUT="grid", GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=64,
                    COMPUTE_DTYPE="float32")
    cfg = port_cfg(jcfg)
    batch = port_batch(multi_batch(synthetic_samples, jcfg))
    torch.manual_seed(0)
    state = TS.create_train_state(cfg, GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg),
                                  device="cpu")
    return cfg, batch, state


def test_set_g_lr(step_case):
    cfg, _, state = step_case
    TS.set_g_lr(state, 1.5e-4)
    assert [g["lr"] for g in state.opt_g.param_groups] == [1.5e-4]
    assert [g["lr"] for g in state.opt_d.param_groups] == [cfg.LEARNING_RATE_DISCRIMINATOR]
    TS.set_g_lr(state, cfg.LEARNING_RATE_GENERATOR)


def test_train_step_runs_and_updates(step_case):
    cfg, batch, state = step_case
    step = make_train_step(cfg, state)
    before = [{k: v.clone() for k, v in m.state_dict().items()}
              for m in (state.generator, state.discriminator)]
    counts = (gt.fwd_launches.value, gt.bwd_launches.value)
    metrics = step(batch, torch.Generator().manual_seed(1))
    assert state.step == 1
    assert (gt.fwd_launches.value, gt.bwd_launches.value) == counts  # CPU: the plain path
    for k, v in metrics.items():
        assert torch.isfinite(v).all(), k
    assert set(metrics) >= {"g_loss", "d_loss", "g_loss_adv", "g_loss_ratio", "g_loss_ratio_void",
                            "g_loss_far", "g_loss_label", "f1", "f1_min", "precision", "recall",
                            "accuracy", "per_graph_f1_hist", "confusion_matrix"}
    assert float(metrics["confusion_matrix"].sum()) == float(batch.mask.sum())
    # every parameter moves but the critic's score bias: mean(D(fake)) - mean(D(real))
    # cancels it and the penalty does not see it, so its gradient is exactly 0
    for m, old, fixed in zip((state.generator, state.discriminator), before, (set(), {"decoder.6.bias"})):
        unchanged = {k for k, v in m.state_dict().items() if torch.equal(v, old[k])}
        assert unchanged == fixed
    # the same generator seed gives the same draws: a second state replays the step exactly
    torch.manual_seed(0)
    twin = TS.create_train_state(cfg, GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg),
                                 device="cpu")
    for m, old in zip((twin.generator, twin.discriminator), before):
        m.load_state_dict(old)
    again = make_train_step(cfg, twin)(batch, torch.Generator().manual_seed(1))
    assert torch.equal(again["g_loss"], metrics["g_loss"]) and torch.equal(again["d_loss"], metrics["d_loss"])


def test_train_state_defaults_to_the_card_and_step_refuses_another_device(step_case):
    cfg, batch, _ = step_case
    assert inspect.signature(TS.create_train_state).parameters["device"].default == "cuda"
    state = TS.create_train_state(cfg, GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg),
                                  device="meta")
    for m in (state.generator, state.discriminator):
        assert {p.device.type for p in m.parameters()} == {"meta"}
    with pytest.raises(ValueError, match="the batch is on cpu, the modules on meta"):
        make_train_step(cfg, state)(batch, torch.Generator().manual_seed(1))


@pytest.mark.parametrize("dtype,raises", [("bfloat16", False), ("float16", False), ("float32", False),
                                          ("float64", True)])
def test_train_entry_points_take_float32_and_bfloat16(step_case, dtype, raises):
    """create_train_state, make_train_step and make_eval_step take f32, bf16 and f16;
    a name the port does not compute in is refused, naming the field and the entry point."""
    cfg, _, state = step_case
    other = cfg.replace(COMPUTE_DTYPE=dtype)
    if raises:
        modules = (GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg))
        for make, args in ((TS.create_train_state, modules), (make_train_step, (state,)),
                           (make_eval_step, (state,))):
            with pytest.raises(ValueError, match=f"{make.__name__}: COMPUTE_DTYPE='{dtype}'"):
                make(other, *args, **({"device": "cpu"} if make is TS.create_train_state else {}))
    else:
        modules = (GridVoxelGNNGenerator(other), GridVoxelGNNDiscriminator(other))
        made = TS.create_train_state(other, *modules, device="cpu")
        for m in (made.generator, made.discriminator):
            assert m.compute_dtype == getattr(torch, dtype)
            assert {p.dtype for p in m.parameters()} == {torch.float32}
        make_train_step(other, made)
        make_eval_step(other, made)


def test_train_entry_points_take_the_default_config(step_case):
    cfg = Configuration()
    assert (cfg.COMPUTE_DTYPE, cfg.GP_DTYPE) == ("bfloat16", "compute")
    state = TS.create_train_state(cfg, GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg),
                                  device="cpu")
    make_train_step(cfg, state)
    make_eval_step(cfg, state)
