"""The WGAN-GP train step and the eval step, on one device or one rank of a group.

Port of ``building_gan_tpu/train/step.py``: N_CRITIC critic updates, then
one generator update, then the confusion-matrix metrics, on a ``GridBatch``
or a ``PackedBatch``.

With a data-parallel ``group`` (the counterpart of ``axis_name``; built by
``parallel/dp.py``) each rank's gradients become the mean over the ranks
weighted by each rank's real-cell count w, ``sum_r w_r g_r / max(sum_r
w_r, 1)``, before each Adam update (one all-reduce of one flat f64 buffer an
update: the gradients and the update's losses times w, then w), so every
rank takes the same update and the replicas stay bit-identical; a null
fill pack (w = 0) adds nothing.  The losses are weighted alike, the
confusion matrices and F1 histograms summed, the scores recomputed from
the summed matrix and ``f1_min`` taken over the ranks with w > 0
(``reduce_metrics``).  Without a group the step makes no collective.

With a floor shard ``sp`` (``parallel/sp.py::make_sp_train_step``) the batch
is this rank's floors of every slot: both models run their plain modules with
halo stencils and summed statistics, the noise is the whole slots' draw at
this rank's floors, each rank backprops 1/n of the replicated loss, every
parameter gradient is summed over the ranks before each Adam update, and the
per-building confusion matrices are summed before any score.

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
``COMPUTE_DTYPE`` (bf16 by default, f32 or f16), losses and metrics in f32, and
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
import torch.distributed as dist
import torch.nn.functional as F

from ..config import NUM_CLASSES, Configuration
from ..models import fast_infer
from ..models import fast_train as FT
from ..models.fast_infer import fused_route
from ..ops.dropout import draw_keys
from ..ops.gat_train import build_planes
from ..ops.rng import normal_box_muller
from ..parallel.sp import sum_gradients_
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


def _metrics(batch, y_pred, sp=None) -> dict:
    return M.compute_metrics(batch.cell_type, y_pred, batch.cell_mask, batch.graph_mask,
                             **batch.metric_graphs, sp=sp)


def real_cells(batch) -> torch.Tensor:
    """w: the batch's real-cell count (f32 scalar on its device), 0 for a null pack."""
    return batch.cell_mask.float().sum()


def weighted_mean_(params, scalars, w: torch.Tensor, group) -> list:
    """Over the ranks of ``group``: each parameter's gradient becomes, in place,
    ``sum_r w_r g_r / max(sum_r w_r, 1)``, and so does each scalar, returned (f32).

    One all-reduce of one flat f64 buffer (the gradients and the scalars times
    w, then w).  In f64 each product w g of an f32 g and an integer w below
    2**24 is exact, and so is a sum of a few alike ones, so ranks holding the
    same pack, or null packs beside one real pack, give back the one-device
    gradients bit for bit (in f32 a rounding there would set the chaotic
    WGAN-GP step on another course).  The gradients become views of the f32
    result.  Parameters without a gradient are left out, the same ones on every
    rank.
    """
    grads = [p for p in params if p.grad is not None]
    sizes = [p.numel() for p in grads] + [1] * len(scalars)
    n = sum(sizes)
    buf = torch.cat([p.grad.reshape(-1).float() for p in grads]
                    + [s.detach().float().reshape(1) for s in scalars]
                    + [w.float().reshape(1)]).double()
    buf[:n].mul_(buf[n:])
    dist.all_reduce(buf, group=group)
    out = (buf[:n] / buf[n:].clamp(min=1.0)).float()
    parts = out.split(sizes)
    for p, g in zip(grads, parts):
        p.grad = g.view_as(p).to(p.grad.dtype)
    return [v.reshape(()) for v in parts[len(grads):]]


def reduce_metrics(m: dict, w: torch.Tensor, group, losses=()) -> tuple:
    """One rank's ``compute_metrics`` -> the group's, as ``building_gan_tpu/train/step.py``:
    the confusion matrices and per-graph F1 histograms summed, the scores
    recomputed from the summed matrix, ``f1_min`` the least over the ranks with
    w > 0 (0 when every rank is null).  ``losses`` (scalars) come back weighted
    by w as ``weighted_mean_``'s, in the same f64 all-reduce; a MIN all-reduce
    takes ``f1_min``.  -> (metrics, weighted losses)."""
    cm, hist = m["confusion_matrix"], m["per_graph_f1_hist"]
    k, wd = len(losses), w.double()
    parts = [torch.stack([v.double().reshape(()) for v in losses]) * wd] if k else []
    buf = torch.cat(parts + [wd.reshape(1), cm.double().reshape(-1), hist.double()])
    dist.all_reduce(buf, group=group)
    losses = list((buf[:k] / buf[k:k + 1].clamp(min=1.0)).float())
    sums = buf[k + 1:].float()
    cm, hist = sums[:cm.numel()].reshape(cm.shape), sums[cm.numel():]
    f1_min = torch.where(w > 0, m["f1_min"].float(), torch.full_like(w, float("inf"))).reshape(1)
    dist.all_reduce(f1_min, op=dist.ReduceOp.MIN, group=group)
    f1_min = f1_min.reshape(())
    f1_min = torch.where(torch.isfinite(f1_min), f1_min, torch.zeros_like(f1_min))
    return ({**M.scores_from_cm(cm), "f1_min": f1_min, "per_graph_f1_hist": hist,
             "confusion_matrix": cm}, losses)


def one_hot_types(batch) -> torch.Tensor:
    """The real cells' one-hot program types (the critic's real labels), 0 on padding."""
    return F.one_hot(batch.cell_type.long(), NUM_CLASSES).float() * batch.cell_mask[..., None]


def make_update_losses(cfg: Configuration, state: TrainState, sp=None, fused: bool = True):
    """The train step's two losses over ``state``: ``(critic_loss, generator_loss)``.

    ``critic_loss(batch, planes, generator[, types_onehot])`` draws one critic update's noise
    (the generator forward under no_grad, the critic's dropout keys, the GP's
    eps) from ``generator`` and returns the critic loss, differentiable in the
    critic's parameters.  ``generator_loss(batch, planes, generator)`` draws the
    generator update's and returns ``(g_loss, aux, label_hard)``, ``g_loss``
    differentiable in both modules' parameters.  ``planes`` is ``build_planes``
    of the batch where a model is fused, else None (``needs_planes``).  With a
    floor shard ``sp`` both models run plain on this rank's floors, and each draw
    shaped like the cells is the whole slots' draw at them.  ``fused=False`` runs
    both models' plain modules whatever their route (a floor shard's route).
    """
    gen, disc = state.generator, state.discriminator
    n_gen_layers, n_disc_layers = gen.dropout_sites, disc.dropout_sites
    fused = fused and sp is None
    gen_fused, disc_fused = fused_route(gen) and fused, fused_route(disc) and fused
    shard = {} if sp is None else {"sp": sp}
    # the GP critic: the same critic, with f32 activations under GP_DTYPE "float32"
    # (building_gan_tpu/train/step.py clones it at f32), else at its own dtype
    gp_dtype = torch.float32 if cfg.GP_DTYPE == "float32" else None

    def cells_draw(draw, mask, *tail):
        shape = tuple(mask.shape) + tail
        return draw(shape) if sp is None else sp.local(draw(sp.global_shape(shape)))

    def generator_forward(batch, mask, planes, generator):
        z = cells_draw(lambda s: normal_box_muller(s, generator), mask, cfg.Z_DIM)
        keys = draw_keys(n_gen_layers, generator)
        if gen_fused:
            return FT.generator_apply_fused(gen, cfg, batch, z, generator=generator, keys=keys,
                                            planes=planes)
        return gen(batch, z, generator=generator, deterministic=False, keys=keys, **shard)

    def critic(batch, planes, keys):
        if disc_fused:
            return lambda label: FT.discriminator_apply_fused(disc, cfg, batch, label, keys,
                                                              planes=planes)
        return lambda label: disc(batch, label, deterministic=False, keys=keys, **shard)

    def critic_loss(batch, planes, generator, types_onehot=None):
        mask = batch.cell_mask
        if types_onehot is None:
            types_onehot = one_hot_types(batch)
        with torch.no_grad():  # the generator's stop-gradient: nothing is saved
            _, label_hard, label_soft = generator_forward(batch, mask, planes, generator)
        keys = draw_keys(n_disc_layers, generator)
        eps = cells_draw(lambda s: torch.rand(s, generator=generator, device=mask.device), mask,
                         1) if cfg.USE_WGANGP else None
        return L.discriminator_loss(
            critic(batch, planes, keys), types_onehot, label_hard, label_soft, mask, cfg, eps=eps,
            d_apply_gp=lambda label: disc(batch, label, deterministic=False, keys=keys,
                                          dtype=gp_dtype, **shard),
            sp=sp,
        )

    def generator_loss(batch, planes, generator):
        logits, label_hard, _ = generator_forward(batch, batch.cell_mask, planes, generator)
        keys_d = draw_keys(n_disc_layers, generator)
        g_loss, aux = L.generator_loss(critic(batch, planes, keys_d), batch, logits, label_hard, cfg,
                                       sp=sp)
        return g_loss, aux, label_hard

    return critic_loss, generator_loss


def needs_planes(state: TrainState) -> bool:
    """Whether a model of ``state`` runs fused, so the step builds the batch's planes."""
    return fused_route(state.generator) or fused_route(state.discriminator)


def make_train_step(cfg: Configuration, state: TrainState, group=None, sp=None,
                    fused: bool = True) -> Callable:
    """Build ``train_step(batch, generator) -> metrics`` over ``state``.

    PyTorch idiom, unlike the pure JAX step: ``train_step`` updates
    ``state.generator``, ``state.discriminator``, ``state.opt_g`` and
    ``state.opt_d`` in place and counts ``state.step``; it returns only the
    metrics, as detached tensors on the batch's device.  The batch must be on
    the modules' device (``create_train_state`` puts them on the card unless
    asked for the CPU); another raises.  So does a ``cfg.COMPUTE_DTYPE`` the port
    does not compute in (one not in ``PORTED_DTYPES``).  With ``group`` the gradients, losses and
    metrics are aggregated over its ranks (module docstring); every rank must
    call the step together, on batches of one shape.  With a floor shard ``sp``
    the batch is this rank's floors (``parallel/sp.py::make_sp_train_step``
    shards it); every rank calls the step together, from identically seeded
    generators.  ``fused=False`` runs both models' plain modules whatever their
    route (the floor-sharded step's route, on one device).
    """
    cfg.require_ported_dtype("make_train_step")
    if group is not None and sp is not None:
        raise ValueError("the step takes a data-parallel group or a floor shard, not both")
    gen, disc = state.generator, state.discriminator
    model_device = next(gen.parameters()).device
    fused = fused and sp is None
    critic_loss, generator_loss = make_update_losses(cfg, state, sp, fused)
    with_planes = needs_planes(state) and fused

    def backward(loss, **kw):
        # on a floor shard each rank seeds 1/n: the n ranks' seeds add up to the loss once
        (loss if sp is None else loss / sp.n).backward(**kw)

    def train_step(batch, generator: torch.Generator) -> dict:
        # the backward passes on this thread: nodes of the penalty's double backward are
        # then numbered with the rest, so the gradients sum in one order whatever ran
        # before (on the device's worker thread they sum in an order that depends on
        # the process's history, and the f32 step did not repeat itself on the card)
        with torch.autograd.set_multithreading_enabled(False):
            return step(batch, generator)

    def step(batch, generator):
        _check_device(batch, model_device)
        mask = batch.cell_mask
        planes = build_planes(mask, batch.gid, batch.grid_shape) if with_planes else None
        types_onehot = one_hot_types(batch)
        w = real_cells(batch) if group is not None else None

        d_loss_sum = torch.zeros((), device=mask.device)
        for _ in range(cfg.N_CRITIC):
            state.opt_d.zero_grad(set_to_none=True)
            d_loss = critic_loss(batch, planes, generator, types_onehot)
            backward(d_loss)
            d_loss = d_loss.detach()
            if group is not None:
                (d_loss,) = weighted_mean_(disc.parameters(), [d_loss], w, group)
            if sp is not None:
                sum_gradients_(disc.parameters(), sp)
            state.opt_d.step()
            d_loss_sum = d_loss_sum + d_loss

        state.opt_g.zero_grad(set_to_none=True)
        g_loss, aux, label_hard = generator_loss(batch, planes, generator)
        backward(g_loss, inputs=list(gen.parameters()))
        g_loss, aux = g_loss.detach(), {k: v.detach() for k, v in aux.items()}
        if group is not None:
            g_loss, *terms = weighted_mean_(gen.parameters(), [g_loss, *aux.values()], w, group)
            aux = dict(zip(aux, terms))
        if sp is not None:
            sum_gradients_(gen.parameters(), sp)
        state.opt_g.step()
        state.step += 1

        m = _metrics(batch, label_hard.detach().argmax(-1), sp)
        if group is not None:
            m, _ = reduce_metrics(m, w, group)
        return {
            "g_loss": g_loss,
            "d_loss": d_loss_sum / max(cfg.N_CRITIC, 1),
            **aux,
            **{k: m[k] for k in METRIC_KEYS},
        }

    return train_step


def make_eval_step(cfg: Configuration, state: TrainState, group=None) -> Callable:
    """Build ``eval_step(batch, generator) -> metrics`` over ``state``: no update.

    z and the Gumbel noise are drawn from ``generator`` (z first), unless given
    as ``z`` (the batch's cells by Z_DIM) and ``gumbel_noise`` (cells by 7).  On
    the fused route the generator's packed hourglass weights are cached until
    ``state.step`` moves.  Returns the G loss and its terms, the batch scores,
    the per-graph F1 and its histogram and the confusion matrix, as tensors on
    the batch's device.  With ``group``: the losses weighted by each rank's
    real cells and the metrics aggregated over its ranks, as the train step's
    (``reduce_metrics``: one all-reduce of the losses, matrices and histograms,
    one MIN); no per-graph F1, which stays a rank's own.
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
        if group is None:
            return {"g_loss": g_loss, **aux, **{k: m[k] for k in METRIC_KEYS},
                    "per_graph_f1": m["per_graph_f1"]}
        m, (g_loss, *terms) = reduce_metrics(m, real_cells(batch), group, [g_loss, *aux.values()])
        return {"g_loss": g_loss, **dict(zip(aux, terms)), **{k: m[k] for k in METRIC_KEYS}}

    return eval_step
