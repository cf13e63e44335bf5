"""Data-parallel train and eval steps: one replica a rank, the step's group hook.

Port of ``building_gan_tpu/parallel/dp.py``.  The JAX package shard-maps its
step over a device mesh and ``psum``s inside it; here each rank is a process
(or a thread, for checks) holding one replica on its own device, and the
port's own step (``train/step.py``) runs with the group: every gradient the
node-weighted mean over the ranks before each of the N_CRITIC + 1 Adam
updates, the losses weighted alike, the metrics summed (confusion matrices,
F1 histograms) or taken over the ranks with real cells (``f1_min``).  Each
rank calls the step on its own pack (``data/pipeline.py`` with ``rank``); the
packs of one call have one shape, null fill packs where the epoch runs out.

Noise: by default each rank draws from its own ``torch.Generator``, derived
from the one the caller passes and the rank (the JAX ``fold_in`` of the
device index), so ranks draw independent z, Gumbel noise, dropout keys and
GP eps; ``fold_device_rng=False`` draws every rank alike, for equivalence
checks against one device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..config import Configuration
from ..train.state import TrainState
from ..train.step import make_eval_step, make_train_step


def rank_generator(generator: torch.Generator, rank: int) -> torch.Generator:
    """A generator on ``generator``'s device seeded with 64 bits of
    ``np.random.SeedSequence((generator.initial_seed(), rank))``: the trainer's
    epoch stream seeded from (SEED, epoch) gives each rank one from (SEED, epoch, rank)."""
    hi, lo = np.random.SeedSequence((generator.initial_seed(), rank)).generate_state(
        2, dtype=np.uint32)
    return torch.Generator(device=generator.device).manual_seed((int(hi) << 32) | int(lo))


def _folder(rank: int) -> Callable:
    """generator -> its rank generator, derived once for each (generator, seed) and then
    drawn from call after call, as the caller's own would be."""
    cache = {"src": None, "seed": None, "gen": None}

    def fold(generator: torch.Generator) -> torch.Generator:
        if cache["src"] is not generator or cache["seed"] != generator.initial_seed():
            cache.update(src=generator, seed=generator.initial_seed(),
                         gen=rank_generator(generator, rank))
        return cache["gen"]

    return fold


def make_parallel_train_step(cfg: Configuration, state: TrainState, group,
                             fold_device_rng: bool = True) -> Callable:
    """``train_step(batch, generator) -> metrics`` for this rank of ``group``: the port's
    train step with the group's weighted gradient mean, losses and metrics.

    Args:
      fold_device_rng: draw from a generator derived from ``generator`` and the
        rank (independent noise a rank: the semantics of a larger batch).
        False draws every rank from ``generator`` itself, for checks against one
        device.
    """
    core = make_train_step(cfg, state, group=group)
    if not fold_device_rng:
        return core
    fold = _folder(group.rank())

    def train_step(batch, generator: torch.Generator) -> dict:
        return core(batch, fold(generator))

    return train_step


def make_parallel_eval_step(cfg: Configuration, state: TrainState, group) -> Callable:
    """``eval_step(batch, generator=None, *, z=None, gumbel_noise=None) -> metrics`` for this
    rank of ``group``: every rank evaluates its own pack at once, the losses
    node-weighted and the scores from the summed confusion matrices, equal to
    the sequential pass over the packs.  The rank's noise comes from a generator
    derived from ``generator`` and the rank, or is given."""
    core = make_eval_step(cfg, state, group=group)
    fold = _folder(group.rank())

    def eval_step(batch, generator: torch.Generator | None = None, *, z=None,
                  gumbel_noise=None) -> dict:
        return core(batch, None if generator is None else fold(generator), z=z,
                    gumbel_noise=gumbel_noise)

    return eval_step
