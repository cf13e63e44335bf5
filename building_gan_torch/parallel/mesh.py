"""The data-parallel group: N ranks, each one process (or thread) with one replica.

Port of ``building_gan_tpu/parallel/mesh.py``.  The JAX package builds a 1-D
device mesh named ``"data"`` inside one process and shards a stacked batch
over it; the port runs one rank a card, rank r on ``cuda:r``, joined by an
explicit ``torch.distributed`` process group: NCCL on the card, gloo on the
CPU.  Every function that communicates takes that group, so a check can pass
a gloo group whose ranks share one card or the CPU (``thread_ranks``).
"""

from __future__ import annotations

import datetime
import inspect
import threading
from typing import Callable, List

import torch
import torch.distributed as dist

DATA_AXIS = "data"
GLOO_TIMEOUT_S = 300.0  # a collective waits this long for the slowest rank


def check_ranks(n: int, device_type: str = "cuda") -> None:
    """Raise unless ``n`` ranks can run: at least one, and on CUDA one visible card each
    (the JAX package's ``make_mesh`` refuses more devices than it has, as here)."""
    if n < 1:
        raise ValueError(f"requested {n} data-parallel ranks; need at least 1")
    if device_type == "cuda":
        have = torch.cuda.device_count()
        if n > have:
            raise ValueError(f"requested {n} data-parallel ranks, have {have} visible CUDA "
                             "devices (one card a rank)")


def rank_device(rank: int, device_type: str) -> torch.device:
    """The device rank ``rank`` owns: ``cuda:rank``, or the CPU."""
    return torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")


def init_data_group(rank: int, world_size: int, store_path: str, device_type: str):
    """Join the data group as ``rank`` of ``world_size`` and return it.

    On CUDA the rank first makes ``cuda:rank`` its current device, then joins
    over NCCL; on the CPU over gloo.  The ranks meet through a file store at
    ``store_path`` (no network); ``destroy_data_group`` leaves.
    """
    check_ranks(world_size, device_type)
    kwargs = {}
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        if "device_id" in inspect.signature(dist.init_process_group).parameters:
            kwargs["device_id"] = rank_device(rank, device_type)  # binds NCCL to the card
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo", store=store, rank=rank,
                            world_size=world_size, **kwargs)
    return dist.group.WORLD


def destroy_data_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def barrier(group, device) -> None:
    """Return once every rank of ``group`` has called it: one all-reduce of a scalar on
    ``device`` (any backend), read back on the host."""
    t = torch.zeros(1, device=device)
    dist.all_reduce(t, group=group)
    t.item()


def thread_ranks(n: int, fn: Callable, timeout_s: float = GLOO_TIMEOUT_S) -> List:
    """Run ``fn(rank, group)`` for ranks 0..n-1 on n threads of this process, each with
    its own gloo group of size n over one in-memory store; -> their results by rank.

    For checks whose ranks share one card or the CPU (gloo takes CPU and CUDA
    tensors).  The first exception a rank raises re-raises here, after every
    thread ended (the other ranks fail their next collective when it times out).
    """
    store = dist.HashStore()
    results: list = [None] * n
    errors: list = []  # in the order they happened: the first is the cause
    threads_each = torch.get_num_threads()

    def run(rank):
        try:
            # a new thread starts at the host's default intra-op width: take the caller's,
            # so the ranks' CPU reductions split (and round) as the caller's do
            torch.set_num_threads(threads_each)
            group = dist.ProcessGroupGloo(dist.PrefixStore(DATA_AXIS, store), rank, n,
                                          datetime.timedelta(seconds=timeout_s))
            results[rank] = fn(rank, group)
        except Exception as e:  # noqa: BLE001 - re-raised below, in the caller
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,), name=f"rank{r}") for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results
