"""Dataset and loaders: NPZ pairs -> shuffled grid batches, epoch after epoch.

Port of ``building_gan_tpu/data/pipeline.py`` for the grid layout:
``GraphDataset`` loads every ``*_local.npz`` / ``*_voxel.npz`` pair, sorted
by building number (``DATA_SLICER``, and one datum in sanity mode);
``GraphDataLoaders`` makes the seeded 65/25/10 split and three shuffled
``PackedLoader``s.  The split and every epoch's shuffle draw from
``np.random.default_rng`` exactly as the JAX package does, so both packages
give the same indices and the same batches in the same order.

Batches follow ``LAYOUT``: ``"grid"`` gives ``GridBatch``es, ``"edges"`` the
packed edge-list layout's ``PackedBatch``es (``data/batching.py``, at the
``PACK_*`` budgets), the layout for buildings that do not fit ``GRID_SHAPE``.
Either holds CPU tensors; the consumer moves them to its device (``.to``).
``prefetch`` packs on a host thread and makes no CUDA call there.

With ``GRID_BUCKETS`` each building goes to the smallest bucket shape
that holds its extent, and each bucket's group is packed into slots of its
own shape (composing with ``GRID_SLOT_GRAPHS`` > 1), so an epoch's grid
batches come in several shapes, smallest bucket first, as in the JAX
package.  ``DEVICE_RESIDENT_DATA`` only schedules TPU transfers in the JAX
package and is accepted and ignored.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Configuration
from . import batching
from . import grid as gridlib
from .preprocess import LocalGraph, VoxelGraph, load_local, load_voxel


class GraphDataset:
    """Eagerly loads all processed building pairs (reference data.py:80-163)."""

    def __init__(self, configuration: Configuration):
        cfg = configuration
        self.configuration = cfg

        def files(suffix):
            names = (d for d in os.listdir(cfg.SAVE_DATA_PATH) if d.endswith(suffix))
            return sorted((os.path.join(cfg.SAVE_DATA_PATH, d) for d in names),
                          key=lambda x: int(os.path.basename(x).split("_")[0]))

        local_files = files(cfg.LOCAL_DATA_SUFFIX)[: cfg.DATA_SLICER]
        voxel_files = files(cfg.VOXEL_DATA_SUFFIX)[: cfg.DATA_SLICER]
        if cfg.SANITY_CHECKING:
            # single-datum selection (reference data.py:105-107)
            idx = min(cfg.DATA_POINT, len(local_files) - 1)
            local_files = [local_files[idx]]
            voxel_files = [voxel_files[idx]]
        if len(local_files) != len(voxel_files):
            raise ValueError(f"{len(local_files)} local and {len(voxel_files)} voxel files in "
                             f"{cfg.SAVE_DATA_PATH}")

        self.samples: List[Tuple[LocalGraph, VoxelGraph]] = []
        for lf, vf in zip(local_files, voxel_files):
            local, voxel = load_local(lf), load_voxel(vf)
            if local.data_number != voxel.data_number:
                raise ValueError(f"unpaired files {lf} and {vf}")
            self.samples.append((local, voxel))

    def __getitem__(self, i: int) -> Tuple[LocalGraph, VoxelGraph]:
        return self.samples[i]

    def __len__(self) -> int:
        return len(self.samples)


def null_like(pack):
    """An all-masked-out pack of the same shape (a ``GridBatch`` or ``PackedBatch``), to
    complete a device group.

    Every mask is zero, so a weighted cross-device aggregation gives it zero
    gradient and metric weight; ``site_area`` stays 1 to keep FAR division benign.
    """
    fields = {name: None if v is None else torch.zeros_like(v) for name, v in vars(pack).items()}
    fields["site_area"] = torch.ones_like(pack.site_area)
    return dataclasses.replace(pack, **fields)


def _same_shapes(a, b) -> bool:
    """Whether two packs of one kind have the same shape in every field."""
    return all((x is None) == (y is None) and (x is None or x.shape == y.shape)
               for x, y in zip(vars(a).values(), vars(b).values()))


def _pack_group(samples, cfg: Configuration) -> list:
    """``GridBatch``es of ``GRID_BATCH`` slots at ``cfg.GRID_SHAPE``: one building a slot,
    or several by the 3D first-fit packer with ``GRID_SLOT_GRAPHS`` > 1."""
    B = cfg.GRID_BATCH
    if cfg.GRID_SLOT_GRAPHS > 1:
        slots = gridlib.plan_packing_slots(samples, cfg)
        return [gridlib.pack_grid_multi_from_slots(samples, slots[i: i + B], cfg, batch_slots=B)
                for i in range(0, len(slots), B)]
    return [gridlib.pack_grid(samples[i: i + B], cfg) for i in range(0, len(samples), B)]


def prefetch(iterable, size: int = 2):
    """Run ``iterable`` on a background thread, ``size`` items ahead: host packing
    overlaps the device's work (the reference used ``DataLoader(num_workers=3)``).

    An exception in the producer is raised in the consumer, after the items
    produced before it.
    """
    q: "queue.Queue" = queue.Queue(maxsize=size)
    done = object()
    failure: list = []

    def producer():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 - handed to the consumer
            failure.append(e)
        finally:
            q.put(done)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is done:
            break
        yield item
    t.join()
    if failure:
        raise failure[0]


class PackedLoader:
    """Shuffled epoch iterator over ``GridBatch``es of ``GRID_BATCH`` slots, or
    (``LAYOUT="edges"``) over ``PackedBatch``es at the ``PACK_*`` budgets.

    Each ``__iter__`` re-shuffles (a torch DataLoader with ``shuffle=True``).
    With ``GRID_SLOT_GRAPHS`` > 1 the 3D first-fit packer places several
    buildings a grid slot.  With ``GRID_BUCKETS`` the buildings are routed to
    their smallest fitting bucket and each bucket packs at its own grid shape.
    With ``n_device_batches`` set, consecutive packs of one shape are grouped,
    completed with ``null_like`` packs, and stacked on a leading device axis;
    with ``rank`` set too, member ``rank`` of each group comes unstacked, so the
    data-parallel ranks, each building the same epoch, take one pack of each
    group between them (rank r takes member r).
    """

    def __init__(
        self,
        samples: Sequence[Tuple[LocalGraph, VoxelGraph]],
        cfg: Configuration,
        shuffle: bool = True,
        seed: int = 0,
        n_device_batches: Optional[int] = None,
        rank: Optional[int] = None,
    ):
        if rank is not None and not (n_device_batches and 0 <= rank < n_device_batches):
            raise ValueError(f"rank {rank} needs n_device_batches above it, got {n_device_batches}")
        self.samples = list(samples)
        self.cfg = cfg
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.n_device_batches = n_device_batches
        self.rank = rank
        if cfg.LAYOUT == "grid":
            max_shape = cfg.GRID_SHAPE
            if cfg.GRID_BUCKETS:
                max_shape = max(cfg.GRID_BUCKETS, key=lambda s: s[0] * s[1] * s[2])
            bad = [v.data_number for _, v in self.samples
                   if not gridlib.grid_compatible(v, max_shape)]
            if bad:
                raise ValueError(
                    f"{len(bad)} buildings are not grid-compatible (e.g. {bad[:3]}); "
                    "use LAYOUT='edges' or a larger GRID_SHAPE"
                )

    def _make_batches(self, samples) -> list:
        cfg = self.cfg
        if cfg.LAYOUT != "grid":
            return batching.pack_graphs(samples, cfg)
        if not cfg.GRID_BUCKETS:
            return _pack_group(samples, cfg)
        ordered = sorted(dict.fromkeys(tuple(b) for b in cfg.GRID_BUCKETS),
                         key=lambda s: s[0] * s[1] * s[2])
        groups = {shape: [] for shape in ordered}
        for s in samples:
            extent = s[1].location.max(axis=0) + 1
            shape = next((b for b in ordered if all(int(e) <= d for e, d in zip(extent, b))), None)
            if shape is None:
                raise ValueError(f"building {s[1].data_number} (extent {extent}) fits no "
                                 f"bucket in {cfg.GRID_BUCKETS}")
            groups[shape].append(s)
        return [pack for shape in ordered if groups[shape]
                for pack in _pack_group(groups[shape], cfg.replace(GRID_SHAPE=shape))]

    def __iter__(self):
        order = np.arange(len(self.samples))
        if self.shuffle:
            self.rng.shuffle(order)
        packs = self._make_batches([self.samples[i] for i in order])
        if self.n_device_batches is None:
            yield from packs
            return
        # a group takes consecutive packs of one shape (buckets mix grid shapes)
        d = self.n_device_batches
        stack = gridlib.stack_grid_batches if self.cfg.LAYOUT == "grid" else batching.stack_packs
        i = 0
        while i < len(packs):
            group = [packs[i]]
            i += 1
            while len(group) < d and i < len(packs) and _same_shapes(packs[i], group[0]):
                group.append(packs[i])
                i += 1
            group += [null_like(group[0]) for _ in range(d - len(group))]
            yield stack(group) if self.rank is None else group[self.rank]

    def num_packs_per_epoch(self) -> int:
        return len(self._make_batches(self.samples))


class GraphDataLoaders:
    """Seeded 65/25/10 split + three shuffled loaders (reference data.py:166-212); with
    ``n_device_batches`` and ``rank``, each loader gives rank ``rank``'s packs."""

    def __init__(self, configuration: Configuration, n_device_batches: Optional[int] = None,
                 rank: Optional[int] = None):
        cfg = configuration
        self.configuration = cfg
        self.sanity_checking = cfg.SANITY_CHECKING
        self.dataset = GraphDataset(cfg)

        n = len(self.dataset)
        rng = np.random.default_rng(cfg.SEED)
        perm = rng.permutation(n)
        n_train = int(round(n * cfg.TRAIN_SPLIT_RATIO))
        n_val = int(round(n * cfg.VALIDATION_SPLIT_RATIO))
        self.train_indices = perm[:n_train]
        self.validation_indices = perm[n_train: n_train + n_val]
        self.test_indices = perm[n_train + n_val:]

        def loader(indices, seed):
            return PackedLoader([self.dataset[i] for i in indices], cfg, shuffle=True, seed=seed,
                                n_device_batches=n_device_batches, rank=rank)

        def held_out(indices, seed):
            return loader(indices, seed) if not self.sanity_checking and len(indices) else None

        self.train_dataloader = loader(self.train_indices, cfg.SEED)
        self.validation_dataloader = held_out(self.validation_indices, cfg.SEED + 1)
        self.test_dataloader = held_out(self.test_indices, cfg.SEED + 2)
