"""6-neighbour stencil message passing on the flattened-row layout.

A building's (F, Y, X) grid is flattened to R = F*Y*X rows, so the six
face-adjacent neighbours are row shifts by {±Y·X, ±X, ±1}.  A ±1 or ±X shift
wraps into the adjacent row of the grid, where a valid cell is structurally
not a neighbour: static per-direction boundary masks gate those.  Floor
shifts never wrap.  Direction order: (floor+, floor-, y+, y-, x+, x-).

``gid`` (multi-building slots) tags each cell with its building: a neighbour
is valid only when it is occupied AND carries the same gid, so buildings
packed face to face exchange no messages.

Masked logits are -1e30, not -inf: under -inf a row with no valid neighbour
would give NaN.

The four convs of the reference's registry each have a stencil here, after
``building_gan_tpu/ops/stencil.py``: ``stencil_gat_flat`` (GATConv),
``stencil_gatv2_flat`` (GATv2Conv), ``stencil_gcn_flat`` (GCNConv) and
``stencil_sum_flat`` (GraphConv's neighbour sum).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

NEG_INF = -1e30


def shift(x: torch.Tensor, dim: int, d: int) -> torch.Tensor:
    """Zero-filled (not circular) shift: ``out[..., i, ...] = x[..., i - d, ...]``."""
    if d == 0:
        return x
    n = x.shape[dim]
    out = torch.zeros_like(x)
    if abs(d) >= n:
        return out
    if d > 0:
        out.narrow(dim, d, n - d).copy_(x.narrow(dim, 0, n - d))
    else:
        out.narrow(dim, 0, n + d).copy_(x.narrow(dim, -d, n + d))
    return out


@lru_cache(maxsize=None)
def _flat_dirs(grid_shape: Tuple[int, int, int]):
    """[(row offset, boundary mask (R,) f32 numpy or None)] for the 6 directions."""
    F, Y, X = grid_shape
    R = F * Y * X
    iy = (np.arange(R) // X) % Y
    ix = np.arange(R) % X
    dirs = []
    for stride, s, bm in (
        (Y * X, 1, None),
        (Y * X, -1, None),
        (X, 1, iy >= 1),
        (X, -1, iy <= Y - 2),
        (1, 1, ix >= 1),
        (1, -1, ix <= X - 2),
    ):
        mask = None if bm is None else np.asarray(bm, np.float32)
        dirs.append((s * stride, mask))
    return tuple(dirs)


@lru_cache(maxsize=None)
def _boundary_masks(grid_shape: Tuple[int, int, int], device: torch.device):
    """``_flat_dirs``'s boundary masks as tensors on ``device``, copied there once: a
    copy from host memory each call would make the host wait for the device."""
    return tuple(None if bm is None else torch.as_tensor(bm, device=device)
                 for _, bm in _flat_dirs(grid_shape))


def _nbr_valid_flat(
    maskf: torch.Tensor, grid_shape, gid: torch.Tensor | None = None
) -> torch.Tensor:
    """(6, B, R) neighbour-exists planes, including the row-boundary masks.

    ``gid`` (B, R) additionally requires the neighbour to be of the same building.
    """
    planes = []
    grid_shape = tuple(grid_shape)
    for (off, _), bm in zip(_flat_dirs(grid_shape), _boundary_masks(grid_shape, maskf.device)):
        p = shift(maskf, 1, off)
        if bm is not None:
            p = p * bm[None, :]
        if gid is not None:
            p = p * (shift(gid, 1, off) == gid).to(p.dtype)
        planes.append(p)
    return torch.stack(planes, dim=0)


def stencil_gat_flat(
    h: torch.Tensor,  # (B, R, C) transformed features (W x)
    a_src: torch.Tensor,  # (B, R)
    a_dst: torch.Tensor,  # (B, R)
    mask: torch.Tensor,  # (B, R)
    grid_shape: Tuple[int, int, int],
    negative_slope: float = 0.2,
    gid: torch.Tensor | None = None,  # (B, R)
) -> torch.Tensor:
    """Single-head GAT aggregation over the 6-neighbourhood plus the self loop.

    Softmax over {self, valid neighbours} of LeakyReLU(a_src[nbr] + a_dst[cell]);
    returns ``mask * (alpha_self * h + sum_d alpha_d * h[nbr_d])``.
    """
    dt = torch.promote_types(h.dtype, torch.float32)  # score math in f32 or wider
    a_src = a_src.to(dt)
    a_dst = a_dst.to(dt)
    maskf = mask.to(dt)
    dirs = _flat_dirs(tuple(grid_shape))
    nbr_a_src = torch.stack([shift(a_src, 1, off) for off, _ in dirs], dim=0)
    nbr_valid = _nbr_valid_flat(maskf, grid_shape, gid)

    e = nbr_a_src + a_dst[None]
    e = torch.where(e >= 0, e, negative_slope * e)
    e = torch.where(nbr_valid > 0, e, torch.full_like(e, NEG_INF))

    e_self = a_src + a_dst
    e_self = torch.where(e_self >= 0, e_self, negative_slope * e_self)

    m = torch.maximum(e.max(dim=0).values, e_self)
    exp_e = torch.exp(e - m[None]) * nbr_valid
    exp_self = torch.exp(e_self - m)

    denom = torch.clamp(exp_e.sum(dim=0) + exp_self, min=1e-16)
    alpha = (exp_e / denom[None]).to(h.dtype)
    alpha_self = (exp_self / denom).to(h.dtype)
    hm = h * mask[..., None].to(h.dtype)
    num = alpha_self[..., None] * h
    for d, (off, _) in enumerate(dirs):
        # wrapped-in rows carry alpha == 0 (boundary-masked above)
        num = num + alpha[d][..., None] * shift(hm, 1, off)
    return num * mask[..., None].to(h.dtype)


def leaky_relu(x: torch.Tensor, negative_slope: float) -> torch.Tensor:
    """``jax.nn.leaky_relu``: its gradient at 0 is 1 (``F.leaky_relu``'s is the negative slope)."""
    return torch.where(x >= 0, x, negative_slope * x)


def stencil_gatv2_flat(
    h_l: torch.Tensor,  # (B, R, C) source transform (W_l x + b_l)
    h_r: torch.Tensor,  # (B, R, C) target transform (W_r x + b_r)
    att: torch.Tensor,  # (C,)
    mask: torch.Tensor,  # (B, R)
    grid_shape: Tuple[int, int, int],
    negative_slope: float = 0.2,
    gid: torch.Tensor | None = None,  # (B, R)
) -> torch.Tensor:
    """Single-head GATv2 aggregation over the 6-neighbourhood plus the self loop.

    ``e = att . LeakyReLU(h_l[nbr] + h_r[cell])``, softmax over {self, valid
    neighbours}, returns ``mask * (alpha_self * h_l + sum_d alpha_d * h_l[nbr_d])``.
    ``att`` is rounded to the activations' dtype and the scores summed in f32
    (JAX's ``preferred_element_type``); alpha is cast back to that dtype.
    """
    dt = torch.promote_types(h_l.dtype, torch.float32)
    hl_m = h_l * mask[..., None].to(h_l.dtype)
    maskf = mask.to(dt)
    dirs = _flat_dirs(tuple(grid_shape))
    nbr_valid = _nbr_valid_flat(maskf, grid_shape, gid)

    att = att.to(h_l.dtype).to(dt)
    es = []
    for off, _ in dirs:
        z = leaky_relu(shift(hl_m, 1, off) + h_r, negative_slope)
        es.append(z.to(dt) @ att)
    e = torch.stack(es, dim=0)
    e = torch.where(nbr_valid > 0, e, torch.full_like(e, NEG_INF))

    e_self = leaky_relu(h_l + h_r, negative_slope).to(dt) @ att

    m = torch.maximum(e.max(dim=0).values, e_self)
    exp_e = torch.exp(e - m[None]) * nbr_valid
    exp_self = torch.exp(e_self - m)

    denom = torch.clamp(exp_e.sum(dim=0) + exp_self, min=1e-16)
    alpha = (exp_e / denom[None]).to(h_l.dtype)
    alpha_self = (exp_self / denom).to(h_l.dtype)
    num = alpha_self[..., None] * h_l
    for d, (off, _) in enumerate(dirs):
        num = num + alpha[d][..., None] * shift(hl_m, 1, off)
    return num * mask[..., None].to(h_l.dtype)


def stencil_gcn_flat(
    h: torch.Tensor,  # (B, R, C) transformed features (W x)
    mask: torch.Tensor,  # (B, R)
    grid_shape: Tuple[int, int, int],
    gid: torch.Tensor | None = None,  # (B, R)
) -> torch.Tensor:
    """GCN aggregation over A + I: ``dinv_i * (dinv_i h_i + sum_j dinv_j h_j)``.

    The degree counts the valid neighbours (of the same building, with
    ``gid``) plus the self loop, in f32.  With ``gid`` each neighbour's term is
    gated by its ``nbr_valid`` plane; without it by the static boundary masks
    (a wrapped-in row is a valid cell of the adjacent grid row).
    """
    dt = torch.promote_types(h.dtype, torch.float32)
    maskf = mask.to(dt)
    grid_shape = tuple(grid_shape)
    dirs = _flat_dirs(grid_shape)
    nbr_valid = _nbr_valid_flat(maskf, grid_shape, gid)
    dinv = torch.rsqrt(nbr_valid.sum(dim=0) + 1.0)

    scaled = h * (dinv * maskf)[..., None].to(h.dtype)
    agg = scaled
    for d, ((off, _), bm) in enumerate(zip(dirs, _boundary_masks(grid_shape, h.device))):
        t = shift(scaled, 1, off)
        if gid is not None:
            t = t * nbr_valid[d][..., None].to(h.dtype)
        elif bm is not None:
            t = t * bm.to(h.dtype)[None, :, None]
        agg = agg + t
    out = agg * dinv[..., None].to(h.dtype)
    return out * mask[..., None].to(h.dtype)


def stencil_sum_flat(
    h: torch.Tensor,  # (B, R, C)
    mask: torch.Tensor,  # (B, R)
    grid_shape: Tuple[int, int, int],
    gid: torch.Tensor | None = None,  # (B, R)
) -> torch.Tensor:
    """Sum of the valid neighbours' ``h`` (GraphConv's ``aggr='add'``, no self loop)."""
    hm = h * mask[..., None].to(h.dtype)
    grid_shape = tuple(grid_shape)
    nbr_valid = (None if gid is None
                 else _nbr_valid_flat(mask.to(torch.promote_types(h.dtype, torch.float32)),
                                      grid_shape, gid))
    out = torch.zeros_like(h)
    for d, ((off, _), bm) in enumerate(zip(_flat_dirs(grid_shape),
                                           _boundary_masks(grid_shape, h.device))):
        t = shift(hm, 1, off)
        if nbr_valid is not None:
            t = t * nbr_valid[d][..., None].to(h.dtype)
        elif bm is not None:
            t = t * bm.to(h.dtype)[None, :, None]
        out = out + t
    return out * mask[..., None].to(h.dtype)
