"""Train state: the two modules, their Adam optimizers and the step count.

Port of ``building_gan_tpu/train/state.py``.  The optimizers are
``torch.optim.Adam(betas=BETAS, eps=1e-8)`` (optax's adam); the generator's
learning rate follows the per-epoch cosine schedule of the reference
(``CosineAnnealingLR(T_max=EPOCHS)`` stepped once an epoch) through
``cosine_lr`` and ``set_g_lr``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..config import Configuration

ADAM_EPS = 1e-8


@dataclasses.dataclass
class TrainState:
    generator: nn.Module
    discriminator: nn.Module
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    step: int = 0  # generator updates taken


def make_optimizers(cfg: Configuration, generator: nn.Module, discriminator: nn.Module):
    """(opt_g, opt_d): Adam with the configured rates and betas."""
    betas = tuple(cfg.BETAS)
    opt_g = torch.optim.Adam(generator.parameters(), lr=cfg.LEARNING_RATE_GENERATOR,
                             betas=betas, eps=ADAM_EPS)
    opt_d = torch.optim.Adam(discriminator.parameters(), lr=cfg.LEARNING_RATE_DISCRIMINATOR,
                             betas=betas, eps=ADAM_EPS)
    return opt_g, opt_d


def create_train_state(cfg: Configuration, generator: nn.Module, discriminator: nn.Module,
                       device: torch.device | str = "cuda") -> TrainState:
    """Move both modules to ``device`` (the card unless the caller asks for the CPU),
    then give each its Adam optimizer.  Parameters and Adam moments stay f32
    (``PARAM_DTYPE``) at any compute dtype.  Raises on a ``cfg.COMPUTE_DTYPE``
    the port does not compute in (one not in ``PORTED_DTYPES``)."""
    cfg.require_ported_dtype("create_train_state")
    generator, discriminator = generator.to(device), discriminator.to(device)
    opt_g, opt_d = make_optimizers(cfg, generator, discriminator)
    return TrainState(generator, discriminator, opt_g, opt_d)


def cosine_lr(cfg: Configuration, epoch: int) -> float:
    """The generator's learning rate entering ``epoch`` (1-based): epoch 1 runs at the
    initial rate, the last approaches 0 (eta_min = 0)."""
    t = min(max(epoch - 1, 0), cfg.EPOCHS)
    return cfg.LEARNING_RATE_GENERATOR * 0.5 * (1.0 + math.cos(math.pi * t / cfg.EPOCHS))


def set_g_lr(state: TrainState, lr: float) -> TrainState:
    """Set the generator optimizer's learning rate, in place; returns ``state``."""
    for group in state.opt_g.param_groups:
        group["lr"] = lr
    return state
