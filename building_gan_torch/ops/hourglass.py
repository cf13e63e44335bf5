"""Fused deterministic hourglass forward: the CUDA kernel and its plain version.

Port of ``building_gan_tpu/ops/pallas/hourglass.py``.  The whole GATCONV +
GraphNorm + ReLU stack of the generator runs in one call.  Weights are packed
once into three zero-padded arrays:

    Ws   (L, Cmax, Cmax)  conv kernels, (in, out)
    atts (L, 2, Cmax)     att_src, att_dst
    vecs (L, 4, Cmax)     conv bias, GraphNorm weight, bias, mean_scale

``hourglass_fwd`` is the wrapper: on CPU tensors it runs ``hourglass_plain``;
on CUDA tensors it launches ``csrc/hourglass.cu`` or raises.  x and the output
are float32, bfloat16 or float16 (the compute dtype); the math is f32 either
way, and at a 16-bit dtype each layer's output is rounded to it before the
next layer reads it.  GraphNorm
statistics are per (slot, gid key), so unlike the TPU kernel (per slot) it
also matches the flax stack on multi-building (K>1) batches.

The kernel runs the whole stack in one launch, a thread block cluster a slot
(``hg_cluster_size`` in the source picks its size from R, Cmax and K).
``hourglass_cuda`` allocates the output alone: h, v, the scores and the
statistics live in the cluster's shared memory.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..config import _TORCH_DTYPES, PORTED_DTYPES
from . import stencil

MAX_CHANNELS = 128
MAX_KEYS = 16
MAX_LAYERS = 64
MAX_SLOTS = 65535  # the launch grid's y extent
# The activation dtypes the kernels take, in the order of their storage codes
# (0: f32, 1: bf16, 2: f16), which csrc/hourglass.cu and csrc/gat_train.cu dispatch on.
STORAGE_DTYPES = tuple(_TORCH_DTYPES[d] for d in PORTED_DTYPES)


def storage_code(x: torch.Tensor) -> int:
    """The kernels' storage code for x's dtype: its index in ``STORAGE_DTYPES``."""
    return STORAGE_DTYPES.index(x.dtype)


class LaunchCounter:
    """Thread-safe count of a wrapper's kernel launches, in all and by the calling thread
    (``in_this_thread``: a data-parallel rank run as a thread counts its own)."""

    def __init__(self):
        self._n = 0
        self._by_thread: dict = {}
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1
            me = threading.get_ident()
            self._by_thread[me] = self._by_thread.get(me, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0
            self._by_thread.clear()

    @property
    def value(self) -> int:
        return self._n

    @property
    def in_this_thread(self) -> int:
        return self._by_thread.get(threading.get_ident(), 0)


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
    """The kernel's arithmetic in plain PyTorch: (B, F, Y, X, Cmax) -> same shape, x's dtype.

    Math in float32 as the kernel's (or in float64 for an f64 x, a reference
    for how far float32 rounding alone moves the result).  A bf16 or f16 x is
    the kernel's 16-bit storage mode: each layer's output is rounded to x's dtype.
    """
    from ..models.grid_layers import graph_norm

    B, F, Y, X, cmax = x.shape
    grid_shape = (F, Y, X)
    dt = torch.promote_types(x.dtype, torch.float32)
    xf = x.reshape(B, -1, cmax).to(dt)
    m = mask.reshape(B, -1).to(dt)
    g = None if gid is None else gid.reshape(B, -1)
    for l, (ci, co) in enumerate(chans):
        h = xf[..., :ci] @ Ws[l, :ci, :co]
        a_s = (h * atts[l, 0, :co]).sum(-1)
        a_d = (h * atts[l, 1, :co]).sum(-1)
        v = stencil.stencil_gat_flat(h, a_s, a_d, m, grid_shape, negative_slope, gid=g)
        v = v + vecs[l, 0, :co]
        xf = torch.relu(
            graph_norm(v, m, vecs[l, 1, :co], vecs[l, 2, :co], vecs[l, 3, :co], eps, g, num_graphs)
        ).to(x.dtype).to(dt)
    return xf.to(x.dtype).reshape(B, F, Y, X, -1)


def _bind(lib):
    """Declare the C signatures of ``csrc/hourglass.cu`` on a loaded library."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hg_forward.argtypes = [
        p, p, p, i,  # x, mask, gid, K
        p, p, p,  # Ws, atts, vecs
        ctypes.POINTER(ctypes.c_int), i,  # chans, L
        i, i, i, i, i,  # B, F, Y, X, cmax
        f, f,  # slope, eps
        p, p, i,  # out, vlast (16-bit storage: the last layer's f32 v; else null), storage code
        i, p,  # cluster (0: the kernel's choice), trace (null)
        p,  # stream
    ]
    lib.hg_forward.restype = ctypes.c_int
    ints = ctypes.POINTER(ctypes.c_int)
    lib.hg_cluster_size.argtypes = [i, i, i, i, ints, i]  # B, R, cmax, K, chans, L
    lib.hg_smem_bytes.argtypes = [i, i, i, ints, i, i]  # R, cmax, K, chans, L, C
    lib.hg_max_active_clusters.argtypes = [i, i, i, ints, i, i]
    for name in ("hg_cluster_size", "hg_smem_bytes", "hg_max_active_clusters"):
        getattr(lib, name).restype = ctypes.c_int
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


def c_chans(chans):
    """L (ci, co) pairs as the C array the library takes."""
    return (ctypes.c_int * (2 * len(chans)))(*[c for pair in chans for c in pair])


def cluster_size(B: int, R: int, cmax: int, K: int, chans) -> int:
    """CTAs of the cluster that holds one slot, as the kernel chooses for B slots
    of R rows on the current device (0: no cluster of at most 16 holds one)."""
    return _load().hg_cluster_size(B, R, cmax, K, c_chans(chans), len(chans))


def hourglass_cuda(x, mask, Ws, atts, vecs, chans, gid=None, num_graphs=1,
                   negative_slope=0.2, eps=1e-5, cluster=0) -> torch.Tensor:
    """Launch ``csrc/hourglass.cu`` on the current stream; raises on what it does not take.

    One launch: a cluster of ``cluster`` CTAs a slot (0: the kernel's choice,
    ``cluster_size``, from the device's occupancy).  It takes up to 65535
    slots, widths up to 128, up to 16 keys, and a slot whose rows fit a
    cluster of at most 16 CTAs: at the config of record's widths (128 -> 1
    -> 128) and K = 1, up to 4,448 rows (278 a CTA).  A refused
    configuration or launch raises; there is no fallback.  The result is
    bit-reproducible, and a slot's does not depend on the other slots, for
    one cluster size (which depends on B and on the card).
    """
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"hourglass_cuda needs CUDA tensors, got {dev}")
    B, F, Y, X, cmax = x.shape
    L = len(chans)
    if not 1 <= cmax <= MAX_CHANNELS:
        raise ValueError(f"channel width {cmax} outside [1, {MAX_CHANNELS}]")
    if not 1 <= num_graphs <= MAX_KEYS:
        raise ValueError(f"num_graphs {num_graphs} outside [1, {MAX_KEYS}]")
    if not 1 <= L <= MAX_LAYERS:
        raise ValueError(f"{L} layers outside [1, {MAX_LAYERS}]")
    if not 1 <= B <= MAX_SLOTS:
        raise ValueError(f"{B} slots outside [1, {MAX_SLOTS}]")
    for l, (ci, co) in enumerate(chans):
        if not (1 <= ci <= cmax and 1 <= co <= cmax):
            raise ValueError(f"layer widths ({ci}, {co}) outside [1, {cmax}]")
        if l > 0 and ci != chans[l - 1][1]:
            raise ValueError(f"layer {l} takes {ci} channels, the previous layer gives {chans[l - 1][1]}")
    if chans[0][0] != cmax or chans[-1][1] != cmax:
        raise ValueError("first input and last output width must equal the padded width")
    if x.dtype not in STORAGE_DTYPES:
        raise TypeError(f"x must be one of {STORAGE_DTYPES}, got {x.dtype}")
    _check(x, "x", x.dtype, (B, F, Y, X, cmax), dev)
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
    K = num_graphs
    lib = _load()
    chans_c = c_chans(chans)
    out = torch.empty_like(x)
    storage = storage_code(x)
    vlast = torch.empty(x.shape, device=dev, dtype=torch.float32) if storage else None
    # x's card is the runtime's current device for the occupancy query and the
    # launch, which read it (cudaGetDevice), and its stream is the one launched on
    with torch.cuda.device(dev):
        if cluster == 0 and lib.hg_cluster_size(B, R, cmax, K, chans_c, L) == 0:
            raise ValueError(f"no cluster of at most 16 CTAs holds a slot of {R} rows at width "
                             f"{cmax} with {K} keys")
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hg_forward(
            x.data_ptr(), mask.data_ptr(), None if gid is None else gid.data_ptr(), K,
            Ws.data_ptr(), atts.data_ptr(), vecs.data_ptr(), chans_c, L,
            B, F, Y, X, cmax, negative_slope, eps, out.data_ptr(),
            None if vlast is None else vlast.data_ptr(), storage, cluster, None, stream,
        )
    if rc != 0:
        raise RuntimeError(f"hourglass kernel launch failed: {lib.hg_error_string(rc).decode()}")
    launches.add()
    return out


def hourglass_fwd(x, mask, Ws, atts, vecs, chans, gid=None, num_graphs=1,
                  negative_slope=0.2, eps=1e-5) -> torch.Tensor:
    """Deterministic hourglass forward: the kernel on CUDA, the plain version on CPU.

    ``x`` (B, F, Y, X, Cmax) f32, bf16 or f16 -> (B, F, Y, X, Cmax) in x's dtype.
    """
    if x.device.type == "cpu":
        return hourglass_plain(x, mask, Ws, atts, vecs, chans, gid, num_graphs, negative_slope, eps)
    return hourglass_cuda(x, mask, Ws, atts, vecs, chans, gid, num_graphs, negative_slope, eps)
