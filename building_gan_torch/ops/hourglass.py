"""Fused deterministic hourglass forward: the CUDA kernel and its plain version.

Port of ``building_gan_tpu/ops/pallas/hourglass.py``.  The whole GATCONV +
GraphNorm + ReLU stack of the generator runs in one call.  Weights are packed
once into three zero-padded arrays:

    Ws   (L, Cmax, Cmax)  conv kernels, (in, out)
    atts (L, 2, Cmax)     att_src, att_dst
    vecs (L, 4, Cmax)     conv bias, GraphNorm weight, bias, mean_scale

``hourglass_fwd`` is the wrapper: on CPU tensors it runs ``hourglass_plain``;
on CUDA tensors it launches ``csrc/hourglass.cu`` or raises.  GraphNorm
statistics are per (slot, gid key), so unlike the TPU kernel (per slot) it
also matches the flax stack on multi-building (K>1) batches.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import stencil

TILE_ROWS = 64  # rows per block in csrc/hourglass.cu
MAX_CHANNELS = 128
MAX_KEYS = 16


class LaunchCounter:
    """Thread-safe count of a wrapper's kernel launches."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n


launches = LaunchCounter()


def hourglass_channel_pairs(
    hidden_dim: int, repeat: int, min_channels: int = 1
) -> List[Tuple[int, int]]:
    """(C_in, C_out) per layer, from the shared schedule ``hourglass_channels``."""
    from ..models.grid_layers import hourglass_channels

    ch = hourglass_channels(hidden_dim, repeat, min_channels)
    return list(zip([hidden_dim] + ch[:-1], ch))


def pack_gat_weights(encoder) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A ``GridHourglass`` module -> (Ws, atts, vecs), zero-padded to its width, on its device.

    Built by ``F.pad`` + ``torch.stack`` of the module's own parameters, so
    autograd carries gradients of the packed arrays back to each layer (the
    training path); call it under ``torch.no_grad()`` for a plain copy.
    """
    cmax = encoder.hidden_dim
    Ws, atts, vecs = [], [], []
    for conv, norm in encoder.layers():
        co, ci = conv.lin.weight.shape
        Ws.append(F.pad(conv.lin.weight.t(), (0, cmax - co, 0, cmax - ci)))
        pad = lambda p: F.pad(p.reshape(co), (0, cmax - co))  # noqa: E731
        atts.append(torch.stack([pad(conv.att_src), pad(conv.att_dst)]))
        vecs.append(torch.stack([pad(conv.bias), pad(norm.weight), pad(norm.bias),
                                 pad(norm.mean_scale)]))
    return torch.stack(Ws), torch.stack(atts), torch.stack(vecs)


def hourglass_plain(
    x: torch.Tensor,  # (B, F, Y, X, Cmax)
    mask: torch.Tensor,  # (B, F, Y, X)
    Ws: torch.Tensor,
    atts: torch.Tensor,
    vecs: torch.Tensor,
    chans: Sequence[Tuple[int, int]],
    gid: torch.Tensor | None = None,  # (B, F, Y, X)
    num_graphs: int = 1,
    negative_slope: float = 0.2,
    eps: float = 1e-5,
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: (B, F, Y, X, Cmax) -> same shape.

    Runs in x's dtype: float32 as the kernel does, or float64 as a reference
    for how far float32 rounding alone moves the result.
    """
    from ..models.grid_layers import graph_norm

    B, F, Y, X, cmax = x.shape
    grid_shape = (F, Y, X)
    xf = x.reshape(B, -1, cmax)
    m = mask.reshape(B, -1).to(x.dtype)
    g = None if gid is None else gid.reshape(B, -1)
    for l, (ci, co) in enumerate(chans):
        h = xf[..., :ci] @ Ws[l, :ci, :co]
        a_s = (h * atts[l, 0, :co]).sum(-1)
        a_d = (h * atts[l, 1, :co]).sum(-1)
        v = stencil.stencil_gat_flat(h, a_s, a_d, m, grid_shape, negative_slope, gid=g)
        v = v + vecs[l, 0, :co]
        xf = torch.relu(
            graph_norm(v, m, vecs[l, 1, :co], vecs[l, 2, :co], vecs[l, 3, :co], eps, g, num_graphs)
        )
    return xf.reshape(B, F, Y, X, -1)


def _bind(lib):
    """Declare the C signatures of ``csrc/hourglass.cu`` on a loaded library."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hg_forward.argtypes = [
        p, p, p, i,  # x, mask, gid, K
        p, p, p,  # Ws, atts, vecs
        ctypes.POINTER(ctypes.c_int), i,  # chans, L
        i, i, i, i, i,  # B, F, Y, X, cmax
        f, f,  # slope, eps
        p, p, p, p, p, p,  # out, h, v, scores, part, cnt
        p,  # stream
    ]
    lib.hg_forward.restype = ctypes.c_int
    lib.hg_error_string.argtypes = [ctypes.c_int]
    lib.hg_error_string.restype = ctypes.c_char_p
    return lib


def _load():
    """Build (first use) and load the kernel library; returns it bound."""
    from . import _build

    return _bind(_build.load("hourglass"))


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def hourglass_cuda(x, mask, Ws, atts, vecs, chans, gid=None, num_graphs=1,
                   negative_slope=0.2, eps=1e-5) -> torch.Tensor:
    """Launch ``csrc/hourglass.cu`` on the current stream; raises on what it does not take."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"hourglass_cuda needs CUDA tensors, got {dev}")
    B, F, Y, X, cmax = x.shape
    L = len(chans)
    if not 1 <= cmax <= MAX_CHANNELS:
        raise ValueError(f"channel width {cmax} outside [1, {MAX_CHANNELS}]")
    if not 1 <= num_graphs <= MAX_KEYS:
        raise ValueError(f"num_graphs {num_graphs} outside [1, {MAX_KEYS}]")
    for ci, co in chans:
        if not (1 <= ci <= cmax and 1 <= co <= cmax):
            raise ValueError(f"layer widths ({ci}, {co}) outside [1, {cmax}]")
    if chans[0][0] != cmax or chans[-1][1] != cmax:
        raise ValueError("first input and last output width must equal the padded width")
    _check(x, "x", torch.float32, (B, F, Y, X, cmax), dev)
    _check(mask, "mask", torch.float32, (B, F, Y, X), dev)
    _check(Ws, "Ws", torch.float32, (L, cmax, cmax), dev)
    _check(atts, "atts", torch.float32, (L, 2, cmax), dev)
    _check(vecs, "vecs", torch.float32, (L, 4, cmax), dev)
    if gid is not None:
        if gid.device != dev or gid.shape != mask.shape or gid.dtype not in (torch.int32, torch.int64):
            raise ValueError("gid must be an int32/int64 tensor shaped like mask on x's device")
        gid = gid.to(torch.int32).contiguous()
    elif num_graphs > 1:
        raise ValueError("num_graphs > 1 needs a gid plane")

    R = F * Y * X
    T = math.ceil(R / TILE_ROWS)
    K = num_graphs
    out = torch.empty_like(x)
    h = torch.empty_like(x)
    v = torch.empty_like(x)
    scores = torch.empty(2, B, R, device=dev)
    part = torch.empty(B, T, K, 2, cmax, device=dev)
    cnt = torch.empty(B, T, K, device=dev)
    chans_c = (ctypes.c_int * (2 * L))(*[c for pair in chans for c in pair])

    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hg_forward(
            x.data_ptr(), mask.data_ptr(), None if gid is None else gid.data_ptr(), K,
            Ws.data_ptr(), atts.data_ptr(), vecs.data_ptr(), chans_c, L,
            B, F, Y, X, cmax, negative_slope, eps,
            out.data_ptr(), h.data_ptr(), v.data_ptr(), scores.data_ptr(),
            part.data_ptr(), cnt.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"hourglass kernel launch failed: {lib.hg_error_string(rc).decode()}")
    launches.add()
    return out


def hourglass_fwd(x, mask, Ws, atts, vecs, chans, gid=None, num_graphs=1,
                  negative_slope=0.2, eps=1e-5) -> torch.Tensor:
    """Deterministic hourglass forward: the kernel on CUDA, the plain version on CPU.

    ``x`` (B, F, Y, X, Cmax) f32 -> (B, F, Y, X, Cmax).
    """
    if x.device.type == "cpu":
        return hourglass_plain(x, mask, Ws, atts, vecs, chans, gid, num_graphs, negative_slope, eps)
    return hourglass_cuda(x, mask, Ws, atts, vecs, chans, gid, num_graphs, negative_slope, eps)
