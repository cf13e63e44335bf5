"""The WGAN-GP train step and the eval step, on one device.

Port of ``building_gan_tpu/train/step.py`` with ``USE_PALLAS_TRAIN`` (no
``axis_name``): N_CRITIC critic updates, then one generator update, then the
confusion-matrix metrics.  The generator and the real / fake critic passes
run with the hourglass fused (``models/fast_train.py``: the CUDA kernels on a
CUDA batch); the gradient-penalty critic pass runs the plain
``GridVoxelGNNDiscriminator``, because the penalty is differentiated twice.
It gets the same Philox dropout keys as that iteration's fused passes.

Every random draw (z, the Gumbel noise, the GP's eps, the per-layer dropout
keys) comes from the ``torch.Generator`` given to the step, on the batch's
device.  z is drawn in f32 and cast to the compute dtype on the models'
entry (the JAX step draws it in the compute dtype: the same values).

Dtypes are the JAX step's: f32 parameters and Adam state, activations in
``COMPUTE_DTYPE`` (bf16 by default, or f32), losses and metrics in f32, and
the gradient-penalty critic pass at ``GP_DTYPE`` ("compute", or "float32":
the same critic's parameters run with f32 activations).

The eval step (``make_eval_step``) is the JAX package's validation step: a
deterministic generator forward with its hourglass fused
(``models/fast_infer.py``: the serving kernel on a CUDA batch), the G loss
against the deterministic critic (``models/fast_train.py``: the training
layer's forward kernel), and the metrics; no update and no autograd graph.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from ..config import NUM_CLASSES, Configuration
from ..models import fast_infer
from ..models import fast_train as FT
from ..ops.dropout import draw_keys
from ..ops.gat_train import build_planes
from ..ops.rng import normal_box_muller
from . import losses as L
from . import metrics as M
from .state import TrainState

METRIC_KEYS = ("f1", "f1_min", "precision", "recall", "accuracy", "per_graph_f1_hist",
               "confusion_matrix")


def _check_device(batch, model_device) -> None:
    if batch.mask.device != model_device:
        raise ValueError(f"the batch is on {batch.mask.device}, the modules on {model_device}: "
                         "move the batch (batch.to(device)) first")


def make_train_step(cfg: Configuration, state: TrainState) -> Callable:
    """Build ``train_step(batch, generator) -> metrics`` over ``state``.

    PyTorch idiom, unlike the pure JAX step: ``train_step`` updates
    ``state.generator``, ``state.discriminator``, ``state.opt_g`` and
    ``state.opt_d`` in place and counts ``state.step``; it returns only the
    metrics, as detached tensors on the batch's device.  The batch must be on
    the modules' device (``create_train_state`` puts them on the card unless
    asked for the CPU); another raises.  So does a ``cfg.COMPUTE_DTYPE`` the port
    does not compute in (float16).
    """
    cfg.require_ported_dtype("make_train_step")
    gen, disc = state.generator, state.discriminator
    model_device = next(gen.parameters()).device
    n_gen_layers = len(gen.encoder.channels)
    n_disc_layers = len(disc.encoder.channels)
    # the GP critic: the same critic, with f32 activations under GP_DTYPE "float32"
    # (building_gan_tpu/train/step.py clones it at f32), else at its own dtype
    gp_dtype = torch.float32 if cfg.GP_DTYPE == "float32" else None

    def generator_forward(batch, planes, generator):
        z = normal_box_muller(tuple(batch.mask.shape) + (cfg.Z_DIM,), generator)
        return FT.generator_apply_fused(
            gen, cfg, batch, z, generator=generator, keys=draw_keys(n_gen_layers, generator),
            planes=planes,
        )

    def critic_fused(batch, planes, keys):
        return lambda label: FT.discriminator_apply_fused(disc, cfg, batch, label, keys, planes=planes)

    def critic_update(batch, planes, types_onehot, generator):
        with torch.no_grad():  # the generator's stop-gradient: nothing is saved
            _, label_hard, label_soft = generator_forward(batch, planes, generator)
        keys = draw_keys(n_disc_layers, generator)
        eps = torch.rand(tuple(batch.mask.shape) + (1,), generator=generator,
                         device=batch.mask.device)
        state.opt_d.zero_grad(set_to_none=True)
        d_loss = L.discriminator_loss(
            critic_fused(batch, planes, keys), types_onehot, label_hard, label_soft,
            batch.mask, cfg, eps=eps,
            d_apply_gp=lambda label: disc(batch, label, deterministic=False, keys=keys,
                                          dtype=gp_dtype),
        )
        d_loss.backward()
        state.opt_d.step()
        return d_loss.detach()

    def train_step(batch, generator: torch.Generator) -> dict:
        _check_device(batch, model_device)
        mask = batch.mask
        types_onehot = F.one_hot(batch.type.long(), NUM_CLASSES).float() * mask[..., None]
        planes = build_planes(mask, batch.gid, batch.grid_shape)

        d_loss_sum = torch.zeros((), device=mask.device)
        for _ in range(cfg.N_CRITIC):
            d_loss_sum = d_loss_sum + critic_update(batch, planes, types_onehot, generator)

        state.opt_g.zero_grad(set_to_none=True)
        logits, label_hard, _ = generator_forward(batch, planes, generator)
        keys_d = draw_keys(n_disc_layers, generator)
        g_loss, aux = L.generator_loss(critic_fused(batch, planes, keys_d), batch, logits,
                                       label_hard, cfg)
        g_loss.backward(inputs=list(gen.parameters()))
        state.opt_g.step()
        state.step += 1

        y_pred = label_hard.detach().argmax(-1)
        m = M.compute_metrics(batch.type, y_pred, mask, batch.graph_mask, gid=batch.gid,
                              num_graphs_per_slot=batch.graphs_per_slot)
        return {
            "g_loss": g_loss.detach(),
            "d_loss": d_loss_sum / max(cfg.N_CRITIC, 1),
            **{k: v.detach() for k, v in aux.items()},
            **{k: m[k] for k in METRIC_KEYS},
        }

    return train_step


def make_eval_step(cfg: Configuration, state: TrainState) -> Callable:
    """Build ``eval_step(batch, generator) -> metrics`` over ``state``: no update.

    z and the Gumbel noise are drawn from ``generator`` (z first), unless given
    as ``z`` (B, F, Y, X, Z_DIM) and ``gumbel_noise`` (B, F, Y, X, 7).  The
    generator's packed hourglass weights are cached until ``state.step``
    moves.  Returns the G loss and its terms, the batch scores, the per-graph
    F1 and its histogram and the confusion matrix, as tensors on the batch's
    device.
    """
    cfg.require_ported_dtype("make_eval_step")
    gen, disc = state.generator, state.discriminator
    model_device = next(gen.parameters()).device
    packed = {"step": None}

    def weights():
        if packed["step"] != state.step:
            packed["weights"] = fast_infer.prepare(gen, cfg)
            packed["step"] = state.step
        return packed["weights"]

    @torch.no_grad()
    def eval_step(batch, generator: torch.Generator | None = None, *, z=None,
                  gumbel_noise=None) -> dict:
        _check_device(batch, model_device)
        mask = batch.mask
        if z is None:
            z = normal_box_muller(tuple(mask.shape) + (cfg.Z_DIM,), generator)
        logits, label_hard, _ = fast_infer.infer(gen, weights(), batch, z, gumbel_noise, generator)
        g_loss, aux = L.generator_loss(
            lambda label: FT.discriminator_apply_fused(disc, cfg, batch, label, deterministic=True),
            batch, logits, label_hard, cfg,
        )
        m = M.compute_metrics(batch.type, label_hard.argmax(-1), mask, batch.graph_mask,
                              gid=batch.gid, num_graphs_per_slot=batch.graphs_per_slot)
        return {"g_loss": g_loss, **aux, **{k: m[k] for k in METRIC_KEYS},
                "per_graph_f1": m["per_graph_f1"]}

    return eval_step
