"""Floor sharding: each slot's (F, Y, X) cell block split along the floor axis over ranks.

Port of ``building_gan_tpu/parallel/sp.py``.  Every graph op of the grid
layout is pointwise, a per-(slot, building) reduction, or a 6-point stencil
whose only cross-shard dependency is one ghost plane along the floor axis.
So rank r of n holds floors ``[r Fs, (r + 1) Fs)``, ``Fs = F / n``, of the
floor-sharded fields (``x``, ``type``, ``mask``, ``dimension``, ``gid``); the
parameters, the local program graph and the per-building scalars are
replicated.

The JAX package gets the communication from GSPMD (XLA inserts the ghost-plane
``collective-permute``s and the gradient all-reduces); PyTorch has no
partitioner, so here it is written out:

- ``HaloPad`` pads a slab of flat rows ``(B, Fs Y X, ...)`` with one ghost
  plane a side, the neighbouring ranks' boundary planes (zeros at the global
  bottom and top, the stencil's zero-fill boundary, as ``ppermute`` fills
  them).  Its backward is ``HaloTranspose``: the ghost planes' gradients go
  back to the ranks that own them and add onto their boundary planes.  Each
  one's backward applies the other, so the gradient penalty's double backward
  sees the cross-shard terms of the second order too.
- ``AllReduceSum`` sums partial sums over the ranks; its backward is itself.
  GraphNorm's statistics and every sum that feeds a loss or a metric go
  through it.

The exchange is one all-gather of each rank's two boundary planes (2 B Y X C
elements a rank), staged through the host for a gloo group on CUDA tensors
(gloo gathers host memory only); NCCL gathers on the card.  Every rank issues
the same collectives in the same order, in the forward and in both
backwards, whatever its floors hold: nothing branches on the data.

The four stencils (``stencil_{gat,gcn,sum,gatv2}_sp``) run the port's flat
stencils (``ops/stencil.py``) on the halo-padded slab ``(B, (Fs + 2) Y X,
C)`` of grid ``(Fs + 2, Y, X)`` and crop: a floor is Y X contiguous rows, so
the flat stencil's ±1 and ±X row masks stay right on it.  The ``gid`` plane is
exchanged too, so buildings packed face to face stay apart across a shard
boundary.

The train step (``make_sp_train_step``) is the port's ``train/step.py`` with
``sp``: the plain modules on every rank (the JAX floor-sharded step is its
``make_train_step`` at ``USE_PALLAS_TRAIN=False``), the replicated loss
backpropagated at 1/n on every rank so the n ranks' seeds add up to it once,
and every parameter gradient then summed over the ranks before each Adam
update.  Noise is drawn at the global shape from each rank's identically
seeded generator and sliced to the rank's floors, so a rank draws what one
device draws.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from ..ops import stencil

SP_AXIS = "sp"
# GridBatch fields laid out (B, F, Y, X, ...): floor-sharded; every other field is replicated
FLOOR_SHARDED_FIELDS = ("x", "type", "mask", "dimension", "gid")


def _backend(group) -> str:
    try:
        return dist.get_backend(group)
    except (ValueError, RuntimeError):  # a group built outside the default group's map
        return group.name()


@dataclasses.dataclass
class FloorShard:
    """Rank ``rank`` of the ``n`` ranks of ``group`` holds floors ``[f0, f0 + fs)`` of ``floors``.

    ``stats`` counts each kind of collective (``"halo"``, ``"sum"``, ``"grads"``):
    calls and bytes sent, and with ``timed`` the milliseconds spent in them (each
    bracketed by a device synchronisation: for measuring, not for training).
    """

    group: Any
    rank: int
    n: int
    floors: int
    timed: bool = False
    stats: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    _planes: Any = dataclasses.field(default=None, repr=False)

    @property
    def fs(self) -> int:
        return self.floors // self.n

    @property
    def f0(self) -> int:
        return self.rank * self.fs

    @functools.cached_property
    def backend(self) -> str:
        return _backend(self.group)

    def local(self, t: torch.Tensor, dim: int = 1, plane: int = 1) -> torch.Tensor:
        """This rank's part of a tensor that spans every floor along ``dim`` (each floor
        ``plane`` entries there: Y X for flat rows)."""
        return t.narrow(dim, self.f0 * plane, self.fs * plane)

    def global_shape(self, shape, dim: int = 1, plane: int = 1) -> Tuple[int, ...]:
        """``shape`` of this rank's part, with ``dim`` grown to every floor."""
        shape = list(shape)
        if shape[dim] != self.fs * plane:
            raise ValueError(f"dim {dim} of {tuple(shape)} is not {self.fs} floors of {plane}")
        shape[dim] = self.floors * plane
        return tuple(shape)

    def rows(self, plane: int) -> Tuple[int, int]:
        """(first row, rows of the whole slot) of this rank's flat rows, ``plane`` rows a floor."""
        return self.f0 * plane, self.floors * plane

    def reset_stats(self) -> None:
        self.stats = {}

    def _run(self, kind: str, nbytes: int, device, fn):
        s = self.stats.setdefault(kind, {"calls": 0, "bytes": 0, "ms": 0.0})
        s["calls"] += 1
        s["bytes"] += nbytes
        if not self.timed:
            return fn()
        _sync(device)
        t = time.perf_counter()
        out = fn()
        _sync(device)
        s["ms"] += (time.perf_counter() - t) * 1e3
        return out

    def with_planes(self, mask: torch.Tensor, gid: torch.Tensor | None) -> "FloorShard":
        """This shard holding ``mask`` and ``gid`` (B, R) halo-padded, exchanged once here for
        every stencil of a forward (the stencils pad them themselves otherwise)."""
        return dataclasses.replace(self, _planes=(mask, gid) + halo_planes(mask, gid, self))

    def _held_planes(self, mask, gid):
        p = self._planes
        if p is not None and p[0] is mask and p[1] is gid:
            return p[2], p[3]
        return halo_planes(mask, gid, self)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def make_floor_shard(group, floors: int, timed: bool = False) -> FloorShard:
    """The floor shard of this rank of ``group`` (``parallel/mesh.py::init_data_group`` or
    ``thread_ranks``), over a grid of ``floors`` floors: the counterpart of ``make_sp_mesh``.
    ``floors`` must divide by the group's size."""
    n = group.size()
    if floors % n:
        raise ValueError(f"the floor axis F={floors} does not divide over n={n} ranks")
    return FloorShard(group, group.rank(), n, floors, timed)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _neighbour_planes(lo: torch.Tensor, hi: torch.Tensor, sp: FloorShard):
    """(the rank below's ``hi``, the rank above's ``lo``); zeros past the global ends.

    One all-gather of every rank's two planes; staged through the host for a gloo
    group on CUDA tensors."""
    buf = torch.stack([lo, hi])
    stage = buf.is_cuda and sp.backend == "gloo"

    def gather():
        src = buf.cpu() if stage else buf.contiguous()
        out = [torch.empty_like(src) for _ in range(sp.n)]
        dist.all_gather(out, src, group=sp.group)
        return out

    out = sp._run("halo", buf.numel() * buf.element_size(), buf.device, gather)
    below = out[sp.rank - 1][1].to(buf.device) if sp.rank > 0 else torch.zeros_like(hi)
    above = out[sp.rank + 1][0].to(buf.device) if sp.rank < sp.n - 1 else torch.zeros_like(lo)
    return below, above


def _halo_pad(x: torch.Tensor, plane: int, sp: FloorShard) -> torch.Tensor:
    below, above = _neighbour_planes(x[:, :plane], x[:, -plane:], sp)
    return torch.cat([below, x, above], dim=1)


def _halo_transpose(g: torch.Tensor, plane: int, sp: FloorShard) -> torch.Tensor:
    # my lower ghost's gradient belongs to the rank below's top plane, my upper ghost's to
    # the rank above's bottom plane
    from_below, from_above = _neighbour_planes(g[:, :plane], g[:, -plane:], sp)
    gx = g[:, plane:-plane].clone()
    gx[:, :plane] += from_below
    gx[:, -plane:] += from_above
    return gx


class HaloPad(torch.autograd.Function):
    """(B, Fs P, ...) -> (B, (Fs + 2) P, ...): one ghost plane of P rows a side."""

    @staticmethod
    def forward(ctx, x, plane, sp):
        ctx.plane, ctx.sp = plane, sp
        return _halo_pad(x, plane, sp)

    @staticmethod
    def backward(ctx, g):
        return HaloTranspose.apply(g, ctx.plane, ctx.sp), None, None


class HaloTranspose(torch.autograd.Function):
    """``HaloPad``'s transpose: (B, (Fs + 2) P, ...) -> (B, Fs P, ...), each ghost plane
    added onto the owning rank's boundary plane."""

    @staticmethod
    def forward(ctx, g, plane, sp):
        ctx.plane, ctx.sp = plane, sp
        return _halo_transpose(g, plane, sp)

    @staticmethod
    def backward(ctx, gg):
        return HaloPad.apply(gg, ctx.plane, ctx.sp), None, None


class AllReduceSum(torch.autograd.Function):
    """The sum over the ranks; its backward is itself (each rank's uses of the sum are
    its own part of the loss)."""

    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp = sp
        y = x.clone(memory_format=torch.contiguous_format)
        sp._run("sum", y.numel() * y.element_size(), y.device,
                lambda: dist.all_reduce(y, group=sp.group))
        return y

    @staticmethod
    def backward(ctx, g):
        return AllReduceSum.apply(g, ctx.sp), None


def halo_pad(x: torch.Tensor, plane: int, sp: FloorShard) -> torch.Tensor:
    """``x`` (B, Fs P, ...) with a ghost plane a side, differentiable twice over."""
    return HaloPad.apply(x, plane, sp)


def crop(x: torch.Tensor, plane: int) -> torch.Tensor:
    return x[:, plane:-plane]


def all_reduce_sum(sp: FloorShard, *parts: torch.Tensor) -> tuple:
    """Each of ``parts`` summed over the ranks, in one all-reduce of their dtype (the first
    part's); differentiable."""
    dt = parts[0].dtype
    flat = AllReduceSum.apply(torch.cat([p.reshape(-1).to(dt) for p in parts]), sp)
    return tuple(o.view_as(p) for o, p in zip(flat.split([p.numel() for p in parts]), parts))


def sum_gradients_(params, sp: FloorShard) -> None:
    """Each parameter's gradient summed over the ranks, in place: one all-reduce of one
    flat f64 buffer (the sum of a few f32 terms, rounded to f32 once, is the same on
    every rank).  Parameters without a gradient are left out, the same ones on every rank."""
    grads = [p for p in params if p.grad is not None]
    buf = torch.cat([p.grad.reshape(-1).double() for p in grads])
    sp._run("grads", buf.numel() * buf.element_size(), buf.device,
            lambda: dist.all_reduce(buf, group=sp.group))
    for p, g in zip(grads, buf.split([p.numel() for p in grads])):
        p.grad = g.view_as(p).to(p.grad.dtype)


def halo_planes(mask: torch.Tensor, gid: torch.Tensor | None, sp: FloorShard):
    """``mask`` and ``gid`` (B, Fs P) halo-padded in one exchange (no gradient)."""
    if mask.shape[1] % sp.fs:
        raise ValueError(f"{mask.shape[1]} rows are not {sp.fs} floors")
    plane = mask.shape[1] // sp.fs
    if gid is None:
        return _halo_pad(mask, plane, sp), None
    both = _halo_pad(torch.stack([mask.to(torch.int64), gid.to(torch.int64)], -1), plane, sp)
    return both[..., 0].to(mask.dtype), both[..., 1].to(gid.dtype)


def gather_floors(t: torch.Tensor, sp: FloorShard, dim: int = 1) -> torch.Tensor:
    """Every rank's part of ``t`` (floors along ``dim``) joined in floor order: the whole
    tensor on every rank (no gradient)."""
    src = t.cpu() if t.is_cuda and sp.backend == "gloo" else t.contiguous()
    out = [torch.empty_like(src) for _ in range(sp.n)]
    dist.all_gather(out, src, group=sp.group)
    return torch.cat(out, dim=dim).to(t.device)


# ---------------------------------------------------------------------------
# the four halo stencils (``ops/stencil.py`` on the halo-padded slab)
# ---------------------------------------------------------------------------


def _padded(grid_shape, sp: FloorShard):
    F, Y, X = grid_shape
    if F != sp.fs:
        raise ValueError(f"a floor shard holds {sp.fs} floors, the stencil got grid {grid_shape}")
    return (F + 2, Y, X), Y * X


def _zero_halo(x: torch.Tensor, plane: int) -> torch.Tensor:
    """Ghost planes of zeros: for a target-side input, read at the interior cells only."""
    z = x.new_zeros((x.shape[0], plane) + tuple(x.shape[2:]))
    return torch.cat([z, x, z], dim=1)


def stencil_gat_sp(h, a_src, a_dst, mask, grid_shape, sp: FloorShard,
                   negative_slope: float = 0.2, gid=None):
    """``ops.stencil.stencil_gat_flat`` on this rank's floors (h (B, Fs Y X, C))."""
    padded, plane = _padded(grid_shape, sp)
    C = h.shape[-1]
    hp = halo_pad(torch.cat([h, a_src[..., None].to(h.dtype)], -1), plane, sp)
    mp, gp = sp._held_planes(mask, gid)
    out = stencil.stencil_gat_flat(hp[..., :C], hp[..., C], _zero_halo(a_dst, plane), mp, padded,
                                   negative_slope=negative_slope, gid=gp)
    return crop(out, plane)


def stencil_gatv2_sp(h_l, h_r, att, mask, grid_shape, sp: FloorShard,
                     negative_slope: float = 0.2, gid=None):
    """``ops.stencil.stencil_gatv2_flat`` on this rank's floors."""
    padded, plane = _padded(grid_shape, sp)
    mp, gp = sp._held_planes(mask, gid)
    out = stencil.stencil_gatv2_flat(halo_pad(h_l, plane, sp), _zero_halo(h_r, plane), att, mp,
                                     padded, negative_slope=negative_slope, gid=gp)
    return crop(out, plane)


def stencil_sum_sp(h, mask, grid_shape, sp: FloorShard, gid=None):
    """``ops.stencil.stencil_sum_flat`` on this rank's floors."""
    padded, plane = _padded(grid_shape, sp)
    mp, gp = sp._held_planes(mask, gid)
    return crop(stencil.stencil_sum_flat(halo_pad(h, plane, sp), mp, padded, gid=gp), plane)


def stencil_gcn_sp(h, mask, grid_shape, sp: FloorShard, gid=None):
    """``ops.stencil.stencil_gcn_flat`` on this rank's floors.

    GCN has a two-hop dependency: a neighbour's term is scaled by its own degree,
    and a ghost cell's degree needs the ghost's neighbours.  So the degree comes
    from the mask halo (right for every local cell), the features are scaled
    locally, and the already-scaled features are exchanged and aggregated."""
    padded, plane = _padded(grid_shape, sp)
    dt = torch.promote_types(h.dtype, torch.float32)
    maskf = mask.to(dt)
    mp, gp = sp._held_planes(mask, gid)
    nbr_valid = stencil._nbr_valid_flat(mp.to(dt), padded, gp)  # (6, B, (Fs + 2) P)
    dinv = torch.rsqrt(crop(nbr_valid.sum(dim=0) + 1.0, plane))

    scaled = h * (dinv * maskf)[..., None].to(h.dtype)
    ps = halo_pad(scaled, plane, sp)
    agg = ps
    for d, ((off, _), bm) in enumerate(zip(stencil._flat_dirs(padded),
                                           stencil._boundary_masks(padded, h.device))):
        t = stencil.shift(ps, 1, off)
        if gid is not None:
            t = t * nbr_valid[d][..., None].to(h.dtype)
        elif bm is not None:
            t = t * bm.to(h.dtype)[None, :, None]
        agg = agg + t
    out = crop(agg, plane) * dinv[..., None].to(h.dtype)
    return out * mask[..., None].to(h.dtype)


# ---------------------------------------------------------------------------
# the batch, the step, the generator forward
# ---------------------------------------------------------------------------


def grid_batch_spec(batch) -> dict:
    """Field name -> ``(None, SP_AXIS)`` (floor axis sharded), ``()`` (replicated) or None
    (absent), as the JAX function's PartitionSpecs ``P(None, "sp")`` and ``P()``."""
    specs = {}
    for f in dataclasses.fields(batch):
        if getattr(batch, f.name) is None:
            specs[f.name] = None
        elif f.name in FLOOR_SHARDED_FIELDS:
            specs[f.name] = (None, SP_AXIS)
        else:
            specs[f.name] = ()
    return specs


def shard_grid_batch(batch, sp: FloorShard):
    """This rank's part of a ``GridBatch``: floors ``[f0, f0 + fs)`` of the floor-sharded
    fields, every other field as it is.  Raises unless the batch's F divides over the
    ranks and is the shard's."""
    F = batch.grid_shape[0]
    if F % sp.n:
        raise ValueError(f"the floor axis F={F} does not divide over n={sp.n} ranks")
    if F != sp.floors:
        raise ValueError(f"the batch has F={F} floors, the floor shard {sp.floors}")
    kwargs = {}
    for name, spec in grid_batch_spec(batch).items():
        v = getattr(batch, name)
        kwargs[name] = sp.local(v).contiguous() if spec == (None, SP_AXIS) else v
    return type(batch)(**kwargs)


def check_floor_shardable(model) -> None:
    """Raise unless every parameter of ``model`` acts on per-cell tensors, whose floors the
    ranks split: a grid model over ``GridHourglass`` (the convs, GraphNorm, the per-cell
    MLPs and decoder).  The transformer generator's attention reads a whole slot's
    cells at once, and the edge-list models have no floor axis."""
    from ..models.grid_layers import GridHourglass
    from ..models.grid_models import GridVoxelGNNDiscriminator, GridVoxelGNNGenerator

    if type(model) not in (GridVoxelGNNGenerator, GridVoxelGNNDiscriminator) or not isinstance(
            getattr(model, "encoder", None), GridHourglass):
        raise ValueError(f"{type(model).__name__} cannot be floor-sharded: only the grid "
                         "models' parameters all act on per-cell tensors")


def make_sp_train_step(cfg, state, sp: FloorShard):
    """``train_step(batch, generator) -> metrics`` for this rank of a floor shard: the
    WGAN-GP step (N_CRITIC critic updates with their gradient penalties' double
    backward, the generator update, the metrics) on the rank's floors of ``batch``
    (the whole batch: each rank takes its floors itself), every rank drawing from an
    identically seeded ``generator``.

    The route is the plain modules on every rank, whatever the conv (a GATCONV
    configuration included): the JAX floor-sharded step is its ``make_train_step``
    at ``USE_PALLAS_TRAIN=False``, and the fused kernels take a whole slot's F Y X
    rows, their GraphNorm statistics inside the launch.  The dropout masks' bytes
    still come from the Philox kernel on a CUDA batch.  Gradients: each rank
    backprops 1/n of the replicated loss, then every parameter gradient is summed
    over the ranks (one f64 all-reduce an update), so every rank takes the same
    Adam update; the losses and the metrics (the summed confusion matrices) are the
    same on every rank.
    """
    from ..train.step import make_train_step

    check_floor_shardable(state.generator)
    check_floor_shardable(state.discriminator)
    core = make_train_step(cfg, state, sp=sp)

    def train_step(batch, generator: torch.Generator) -> dict:
        return core(shard_grid_batch(batch, sp), generator)

    return train_step


def sp_generator_apply(gen, sp: FloorShard):
    """``apply(batch, z, gumbel_noise=None, generator=None) -> (logits, label_hard,
    label_soft)``: the deterministic generator forward on this rank's floors of
    ``batch`` (the whole batch), ``z`` (B, F, Y, X, Z_DIM) and the Gumbel noise (B, F,
    Y, X, 7; given, or drawn at the whole shape from ``generator``) taken at the rank's
    floors, the parameters replicated.  Returns the rank's floors of the outputs
    (``gather_floors`` joins them)."""
    check_floor_shardable(gen)

    @torch.no_grad()
    def apply(batch, z, gumbel_noise=None, generator=None):
        local = shard_grid_batch(batch, sp)
        noise = None if gumbel_noise is None else sp.local(gumbel_noise)
        return gen(local, sp.local(z), gumbel_noise=noise, generator=generator, sp=sp)

    return apply
