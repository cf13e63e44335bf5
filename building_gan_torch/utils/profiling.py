"""Profiling and seeding utilities.

Port of ``building_gan_tpu/utils/profiling.py``:

- ``runtime_calculator``: the reference's wall-clock decorator
  (``building_gan/src/trainer.py:31-50``); the trainer's epochs and ``test``
  carry it;
- ``trace``: a context manager around ``torch.profiler.profile`` (CPU, and
  CUDA where a card is present) that writes a Chrome trace under ``log_dir``;
- ``set_seed``: the reference ``config.py:137-157``: seeds the host RNGs
  (numpy, random) and torch's default generator, which the CLI uses for the
  models' initial weights.  The port's draws (z, Gumbel noise, GP eps,
  dropout keys) come from explicit ``torch.Generator`` streams seeded from
  ``Configuration.SEED`` (``train/trainer.py::stream_generator``).
"""

from __future__ import annotations

import contextlib
import os
import random
import time
from functools import wraps
from typing import Callable, Iterator

import numpy as np
import torch

TRACE_FILE = "trace.json"


def runtime_calculator(func: Callable) -> Callable:
    """Wall-clock decorator (reference trainer.py:31-50)."""

    @wraps(func)
    def wrapper(*args, **kwargs):
        start = time.time()
        result = func(*args, **kwargs)
        print(f"The function {func.__name__} took {time.time() - start} seconds to run.")
        return result

    return wrapper


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """Profile the enclosed block with ``torch.profiler`` (CPU activity, and CUDA
    where a card is present) and write its Chrome trace to ``log_dir/trace.json``
    (open it in chrome://tracing or Perfetto).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def set_seed(seed: int) -> None:
    """Seed numpy, random and torch's default generator, and report, mirroring
    reference config.py:137-157."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    print("Seeds status:")
    print(f"  Seeds set for numpy        : {seed}")
    print(f"  Seeds set for random       : {seed}")
    print(f"  Device RNG: explicit torch.Generator streams derived from SEED={seed}")
