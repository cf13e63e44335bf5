"""WGAN-GP and auxiliary losses, on either layout (grid or packed edge list).

Port of ``building_gan_tpu/train/losses.py``:

- critic loss ``mean(D(fake)) - mean(D(real)) + GP`` with means over real
  cells only;
- gradient penalty: per-cell ``eps ~ U[0, 1)`` interpolation on the one-hot
  label simplex, the gradient of the summed critic output with respect to
  the interpolated labels (``torch.autograd.grad(..., create_graph=True)``,
  so the caller's backward differentiates it a second time),
  ``mean((||grad||_2 - 1)^2) * lambda_gp``;
- generator loss ``lambda_adv * (-mean(D(fake))) + lambda_label * CE +
  lambda_ratio * MSE(ratio[:-2]) + lambda_ratio_void * MSE(ratio[-2:]) +
  lambda_far * MSE(FAR_gen, FAR)``, ratios over the merged batch, the
  ``[-2:]`` split (quirk Q4) and the FAR term detached (quirk Q3).

With ``USE_WGANGP=False`` both are the BCE losses of the reference instead
(its non-WGAN branch): the critic's sigmoid scores clipped to [1e-7, 1 - 1e-7],
``mean(-log D(real)) + mean(-log(1 - D(fake)))`` for the critic (no penalty)
and ``lambda_adv * mean(-log D(fake))`` for the generator's adversarial term,
masked means in f32.

Noise (the GP's eps) is passed in, or drawn from an explicit ``torch.Generator``.

With a floor shard ``sp`` (``parallel/sp.py``; grid batches) the cells are this
rank's floors: every mean over cells is the ranks' summed partial sums over the
summed count, every sum per building the ranks' sum (one all-reduce through the
differentiable ``AllReduceSum`` each), so each loss is the same on every rank.

A batch of either layout gives its cells' types, mask and floor areas and
sums per building (``per_graph_sum``): a ``GridBatch`` by dense axis sums
(per slot, or per (slot, gid) building), a ``PackedBatch`` by segment sums
keyed on its voxel graph ids.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from ..config import NUM_CLASSES, VOID, Configuration
from ..parallel.sp import all_reduce_sum


BCE_EPS = 1e-7  # the BCE losses' clip of the sigmoid scores


def _bce(scores: torch.Tensor, target_real: bool) -> torch.Tensor:
    """``-log(D)`` (real) or ``-log(1 - D)`` (fake) of sigmoid scores, clipped as the JAX losses clip."""
    d = scores.float().clamp(BCE_EPS, 1.0 - BCE_EPS)
    return -torch.log(d if target_real else 1.0 - d)


def _summed(sp, *parts) -> tuple:
    """``parts`` summed over the floor shard's ranks (as they are without one)."""
    return parts if sp is None else all_reduce_sum(sp, *parts)


def masked_mean(values: torch.Tensor, mask: torch.Tensor, sp=None) -> torch.Tensor:
    """Mean over entries where mask > 0, in float32; a trailing feature axis beyond mask is summed."""
    values = values.float()
    if values.dim() == mask.dim() + 1:
        values = values.sum(-1)
    values = torch.where(mask > 0, values, torch.zeros_like(values))
    total, count = _summed(sp, values.sum(), mask.sum().float())
    return total / count.clamp(min=1.0)


def gradient_penalty(
    d_apply: Callable[[torch.Tensor], torch.Tensor],
    types_onehot: torch.Tensor,  # (..., 7) real labels
    label_soft: torch.Tensor,  # (..., 7) generated soft labels
    voxel_mask: torch.Tensor,  # (...)
    lambda_gp: float,
    eps: torch.Tensor | None = None,  # (..., 1) in [0, 1)
    generator: torch.Generator | None = None,
    sp=None,
) -> torch.Tensor:
    """WGAN-GP on the label simplex; ``eps`` given, or drawn from ``generator``.

    With a floor shard each rank differentiates its own cells' scores: the critic's
    collectives' backwards carry the other ranks' terms, so every rank gets the
    gradient of the whole slots' sum at its cells."""
    if eps is None:  # with a floor shard: the whole slots' draw at this rank's floors
        shape = tuple(voxel_mask.shape) + (1,)
        eps = torch.rand(shape if sp is None else sp.global_shape(shape), generator=generator,
                         device=voxel_mask.device, dtype=types_onehot.dtype)
        eps = eps if sp is None else sp.local(eps)
    interpolated = eps * types_onehot + (1.0 - eps) * label_soft
    if not interpolated.requires_grad:
        interpolated.requires_grad_(True)
    scores = d_apply(interpolated)  # (..., 1) per-cell critic scores
    total = (scores[..., 0] * voxel_mask).sum()
    (grads,) = torch.autograd.grad(total, interpolated, create_graph=True)
    norms = torch.sqrt((grads * grads).sum(-1) + 1e-12)
    return masked_mean((norms - 1.0) ** 2, voxel_mask, sp) * lambda_gp


def discriminator_loss(
    d_apply: Callable[[torch.Tensor], torch.Tensor],
    types_onehot: torch.Tensor,
    label_hard: torch.Tensor,
    label_soft: torch.Tensor,
    voxel_mask: torch.Tensor,
    cfg: Configuration,
    eps: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    d_apply_gp: Callable[[torch.Tensor], torch.Tensor] | None = None,
    sp=None,
) -> torch.Tensor:
    """Critic loss.  ``d_apply_gp`` (default ``d_apply``) is the critic inside the
    penalty, which is differentiated twice: the fused critic is first-order, so
    the train step passes the plain critic there.  Under the BCE losses there is
    no penalty: ``eps``, ``generator`` and ``d_apply_gp`` are not used."""
    if not cfg.USE_WGANGP:
        return (masked_mean(_bce(d_apply(label_hard), False), voxel_mask, sp)
                + masked_mean(_bce(d_apply(types_onehot), True), voxel_mask, sp))
    loss = (masked_mean(d_apply(label_hard), voxel_mask, sp)
            - masked_mean(d_apply(types_onehot), voxel_mask, sp))
    return loss + gradient_penalty(
        d_apply_gp or d_apply, types_onehot, label_soft, voxel_mask, cfg.LAMBDA_GP,
        eps=eps, generator=generator, sp=sp,
    )


def generator_loss(
    d_apply: Callable[[torch.Tensor], torch.Tensor],
    batch,
    logits: torch.Tensor,
    label_hard: torch.Tensor,
    cfg: Configuration,
    sp=None,
) -> tuple[torch.Tensor, dict]:
    """Generator loss and its terms (``g_loss_adv``, ``_label``, ``_ratio``, ``_ratio_void``, ``_far``)."""
    voxel_mask = batch.cell_mask
    types_onehot = F.one_hot(batch.cell_type.long(), NUM_CLASSES).to(logits.dtype) * voxel_mask[..., None]

    d_fake = d_apply(label_hard)
    if cfg.USE_WGANGP:
        g_loss_adv = -masked_mean(d_fake, voxel_mask, sp) * cfg.LAMBDA_ADV
    else:
        g_loss_adv = masked_mean(_bce(d_fake, True), voxel_mask, sp) * cfg.LAMBDA_ADV

    ce = -(types_onehot * torch.log_softmax(logits, dim=-1)).sum(-1)
    g_loss_label = masked_mean(ce, voxel_mask, sp) * cfg.LAMBDA_LABEL

    sum_dims = tuple(range(label_hard.dim() - 1))
    n_real, gen_sums, true_sums = _summed(
        sp, voxel_mask.sum().to(label_hard.dtype), (label_hard * voxel_mask[..., None]).sum(sum_dims),
        types_onehot.sum(sum_dims))
    n_real = n_real.clamp(min=1.0)
    ratio_gen = gen_sums / n_real
    ratio_true = true_sums / n_real
    g_loss_ratio = ((ratio_gen[:-2] - ratio_true[:-2]) ** 2).mean() * cfg.LAMBDA_RATIO
    g_loss_ratio_void = ((ratio_gen[-2:] - ratio_true[-2:]) ** 2).mean() * cfg.LAMBDA_RATIO_VOID

    far_err = (generated_far(batch, label_hard, sp) - batch.far) ** 2
    g_mask = batch.graph_mask
    g_loss_far = (far_err * g_mask).sum() / g_mask.sum().clamp(min=1.0)
    g_loss_far = g_loss_far.detach() * cfg.LAMBDA_FAR

    g_loss = g_loss_adv + g_loss_ratio + g_loss_label + g_loss_ratio_void + g_loss_far
    aux = {
        "g_loss_adv": g_loss_adv,
        "g_loss_label": g_loss_label,
        "g_loss_ratio": g_loss_ratio,
        "g_loss_ratio_void": g_loss_ratio_void,
        "g_loss_far": g_loss_far,
    }
    return g_loss, aux


def generated_far(batch, label_hard: torch.Tensor, sp=None) -> torch.Tensor:
    """Per-graph floor-area ratio of the generated labels: (B,) or (B, K) on the grid, (G,) packed.

    GFA = sum of (dim_y * dim_x) over generated non-void cells; FAR = GFA / site_area.
    """
    gen_type = label_hard.argmax(-1)
    nonvoid = (gen_type != VOID).to(label_hard.dtype) * batch.cell_mask
    (gfa,) = _summed(sp, batch.per_graph_sum(batch.cell_area * nonvoid))
    return gfa / batch.site_area.clamp(min=1e-6)
