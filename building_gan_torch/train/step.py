"""The WGAN-GP train step and the eval step, on one device.

Port of ``building_gan_tpu/train/step.py`` (no ``axis_name``): N_CRITIC
critic updates, then one generator update, then the confusion-matrix
metrics, on a ``GridBatch`` or a ``PackedBatch``.

Each model's route is read from its configuration, per model
(``models/fast_infer.py::fused_route``): a grid model whose conv is GATCONV
runs its hourglass fused (``models/fast_train.py``: the CUDA kernels on a
CUDA batch), as the JAX package does with ``USE_PALLAS_TRAIN``; a model with
any other conv, the edge-list models, the transformer generator and
``BATCH_LEVEL_GRAPHNORM`` run their plain modules, as the JAX package does
without it.  The gradient-penalty critic pass always runs the plain critic,
because the penalty is differentiated twice; it gets the same Philox
dropout keys as that iteration's real / fake passes.  Under the BCE losses
(``USE_WGANGP=False``) there is no penalty, so no plain critic pass and no eps
draw (``GP_DTYPE`` is not read, as in the JAX package).

Every random draw (z, the Gumbel noise, the GP's eps, the per-layer dropout
keys) comes from the ``torch.Generator`` given to the step, on the batch's
device.  z is drawn in f32 and cast to the compute dtype on the models'
entry (the JAX step draws it in the compute dtype: the same values); it is
shaped like the batch's cells, (B, F, Y, X, Z_DIM) or (NV, Z_DIM).

Dtypes are the JAX step's: f32 parameters and Adam state, activations in
``COMPUTE_DTYPE`` (bf16 by default, or f32), losses and metrics in f32, and
the gradient-penalty critic pass at ``GP_DTYPE`` ("compute", or "float32":
the same critic's parameters run with f32 activations).

The eval step (``make_eval_step``) is the JAX package's validation step: a
deterministic generator forward (fused on its route: the serving kernel,
``models/fast_infer.py``), the G loss against the deterministic critic (fused
on its route: the training layer's forward kernel), and the metrics; no
update and no autograd graph.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from ..config import NUM_CLASSES, Configuration
from ..models import fast_infer
from ..models import fast_train as FT
from ..models.fast_infer import fused_route
from ..ops.dropout import draw_keys
from ..ops.gat_train import build_planes
from ..ops.rng import normal_box_muller
from . import losses as L
from . import metrics as M
from .state import TrainState

METRIC_KEYS = ("f1", "f1_min", "precision", "recall", "accuracy", "per_graph_f1_hist",
               "confusion_matrix")


def _check_device(batch, model_device) -> None:
    mask = batch.cell_mask
    if mask.device != model_device:
        raise ValueError(f"the batch is on {mask.device}, the modules on {model_device}: "
                         "move the batch (batch.to(device)) first")


def _metrics(batch, y_pred) -> dict:
    return M.compute_metrics(batch.cell_type, y_pred, batch.cell_mask, batch.graph_mask,
                             **batch.metric_graphs)


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
    n_gen_layers, n_disc_layers = gen.dropout_sites, disc.dropout_sites
    gen_fused, disc_fused = fused_route(gen), fused_route(disc)
    # the GP critic: the same critic, with f32 activations under GP_DTYPE "float32"
    # (building_gan_tpu/train/step.py clones it at f32), else at its own dtype
    gp_dtype = torch.float32 if cfg.GP_DTYPE == "float32" else None

    def generator_forward(batch, mask, planes, generator):
        z = normal_box_muller(tuple(mask.shape) + (cfg.Z_DIM,), generator)
        keys = draw_keys(n_gen_layers, generator)
        if gen_fused:
            return FT.generator_apply_fused(gen, cfg, batch, z, generator=generator, keys=keys,
                                            planes=planes)
        return gen(batch, z, generator=generator, deterministic=False, keys=keys)

    def critic(batch, planes, keys):
        if disc_fused:
            return lambda label: FT.discriminator_apply_fused(disc, cfg, batch, label, keys,
                                                              planes=planes)
        return lambda label: disc(batch, label, deterministic=False, keys=keys)

    def critic_update(batch, mask, planes, types_onehot, generator):
        with torch.no_grad():  # the generator's stop-gradient: nothing is saved
            _, label_hard, label_soft = generator_forward(batch, mask, planes, generator)
        keys = draw_keys(n_disc_layers, generator)
        eps = torch.rand(tuple(mask.shape) + (1,), generator=generator,
                         device=mask.device) if cfg.USE_WGANGP else None
        state.opt_d.zero_grad(set_to_none=True)
        d_loss = L.discriminator_loss(
            critic(batch, planes, keys), types_onehot, label_hard, label_soft, mask, cfg, eps=eps,
            d_apply_gp=lambda label: disc(batch, label, deterministic=False, keys=keys,
                                          dtype=gp_dtype),
        )
        d_loss.backward()
        state.opt_d.step()
        return d_loss.detach()

    def train_step(batch, generator: torch.Generator) -> dict:
        _check_device(batch, model_device)
        mask = batch.cell_mask
        types_onehot = F.one_hot(batch.cell_type.long(), NUM_CLASSES).float() * mask[..., None]
        planes = build_planes(mask, batch.gid, batch.grid_shape) if gen_fused or disc_fused else None

        d_loss_sum = torch.zeros((), device=mask.device)
        for _ in range(cfg.N_CRITIC):
            d_loss_sum = d_loss_sum + critic_update(batch, mask, planes, types_onehot, generator)

        state.opt_g.zero_grad(set_to_none=True)
        logits, label_hard, _ = generator_forward(batch, mask, planes, generator)
        keys_d = draw_keys(n_disc_layers, generator)
        g_loss, aux = L.generator_loss(critic(batch, planes, keys_d), batch, logits, label_hard, cfg)
        g_loss.backward(inputs=list(gen.parameters()))
        state.opt_g.step()
        state.step += 1

        m = _metrics(batch, label_hard.detach().argmax(-1))
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
    as ``z`` (the batch's cells by Z_DIM) and ``gumbel_noise`` (cells by 7).  On
    the fused route the generator's packed hourglass weights are cached until
    ``state.step`` moves.  Returns the G loss and its terms, the batch scores,
    the per-graph F1 and its histogram and the confusion matrix, as tensors on
    the batch's device.
    """
    cfg.require_ported_dtype("make_eval_step")
    gen, disc = state.generator, state.discriminator
    model_device = next(gen.parameters()).device
    gen_fused, disc_fused = fused_route(gen), fused_route(disc)
    packed = {"step": None}

    def weights():
        if packed["step"] != state.step:
            packed["weights"] = fast_infer.prepare(gen, cfg)
            packed["step"] = state.step
        return packed["weights"]

    def critic(batch):
        if disc_fused:
            return lambda label: FT.discriminator_apply_fused(disc, cfg, batch, label,
                                                              deterministic=True)
        return lambda label: disc(batch, label, deterministic=True)

    @torch.no_grad()
    def eval_step(batch, generator: torch.Generator | None = None, *, z=None,
                  gumbel_noise=None) -> dict:
        _check_device(batch, model_device)
        mask = batch.cell_mask
        if z is None:
            z = normal_box_muller(tuple(mask.shape) + (cfg.Z_DIM,), generator)
        if gen_fused:
            logits, label_hard, _ = fast_infer.infer(gen, weights(), batch, z, gumbel_noise,
                                                     generator)
        else:
            logits, label_hard, _ = gen(batch, z, gumbel_noise=gumbel_noise, generator=generator)
        g_loss, aux = L.generator_loss(critic(batch), batch, logits, label_hard, cfg)
        m = _metrics(batch, label_hard.argmax(-1))
        return {"g_loss": g_loss, **aux, **{k: m[k] for k in METRIC_KEYS},
                "per_graph_f1": m["per_graph_f1"]}

    return eval_step
