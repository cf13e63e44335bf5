"""The training hourglass layer: its CUDA forward and backward kernels and its plain version.

Port of ``building_gan_tpu/ops/pallas/gat_train.py``.  One layer is

    h   = x @ W;  a_s = h . att_src;  a_d = h . att_dst
    e_d = LeakyReLU(a_s[nbr_d] + a_d) where neighbour d is valid, else -1e30;
          softmax over {self, the 6 row shifts +-1, +-X, +-Y*X}
    v   = mask * sum_d alpha_d (h * mask)[nbr_d] + bias
    z   = GraphNorm(v), statistics per (slot, gid key), one-pass moments with
          mean_scale;  y = ReLU(z) * keep * 256 / (256 - d)

with the byte-threshold dropout mask of ``ops/dropout.py`` (Philox, keyed per
layer).  Weights are zero-padded to the stack's widest layer, Cmax:

    W (Cmax, Cmax) as (in, out);  att (2, Cmax);  vec (4, Cmax) holding conv
    bias, GraphNorm weight, GraphNorm bias, mean_scale

``planes`` (B, R, 8) are the 6 gid-aware neighbour-valid planes, the cell
mask and the gid (as float), from ``build_planes``.

``hourglass_train`` is the entry point.  On CPU tensors it runs
``layer_plain``, differentiated by autograd (and twice differentiable).  On
CUDA tensors each layer is ``_FusedLayer``: the forward kernel
``csrc/gat_train.cu::gt_forward`` and, as its backward, the kernel
``gt_backward``, with gradients to x, W, att and vec.  Anything else raises;
there is no fallback from the kernel to the plain version.

Activations (x, y and their grads) are float32, bfloat16 or float16, as the
TPU kernel takes ``x.dtype``: the math inside stays f32, the weights and their
grads f32, and a 16-bit layer rounds only what it writes (y, gx).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence, Tuple

import torch

from . import dropout as drop
from .hourglass import STORAGE_DTYPES, LaunchCounter, _check, storage_code
from .stencil import NEG_INF, _nbr_valid_flat, shift

MAX_CHANNELS = 128
MAX_KEYS = 16

fwd_launches = LaunchCounter()  # layer forwards launched on the card
bwd_launches = LaunchCounter()  # layer backwards launched on the card
bytes_launches = LaunchCounter()  # Philox dropout-byte draws launched on the card


def flat_offsets(grid_shape) -> Tuple[int, ...]:
    """Row offset of each direction (floor+, floor-, y+, y-, x+, x-): neighbour d of row r is r - off_d."""
    _, y, x = grid_shape
    return (y * x, -y * x, x, -x, 1, -1)


def build_planes(mask: torch.Tensor, gid, grid_shape) -> torch.Tensor:
    """(B, R, 8) float planes: 6 gid-aware neighbour-valid planes, the cell mask, the gid."""
    b = mask.shape[0]
    maskf = mask.reshape(b, -1).to(torch.float32)
    gidr = None if gid is None else gid.reshape(b, -1)
    nbr = _nbr_valid_flat(maskf, tuple(grid_shape), gidr)  # (6, B, R)
    gidp = torch.zeros_like(maskf) if gidr is None else gidr.to(torch.float32)
    return torch.cat([nbr.movedim(0, -1), maskf[..., None], gidp[..., None]], dim=-1).contiguous()


def _key_masks(planes: torch.Tensor, K: int, dtype) -> torch.Tensor:
    """(B, R, K) statistics membership: masked rows of gid k (every masked row when K == 1)."""
    mask = planes[..., 6].to(dtype)
    if K == 1:
        return mask[..., None]
    ks = torch.arange(K, device=planes.device, dtype=planes.dtype)
    return mask[..., None] * (planes[..., 7:8] == ks).to(dtype)


def layer_plain(
    x: torch.Tensor,  # (B, R, C)
    planes: torch.Tensor,  # (B, R, 8)
    w: torch.Tensor,  # (C, C)
    att: torch.Tensor,  # (2, C)
    vec: torch.Tensor,  # (4, C)
    key: torch.Tensor | None,  # (2,) int64 Philox key, or None for no dropout
    grid_shape: Tuple[int, int, int],
    K: int = 1,
    levels: int = 0,
    negative_slope: float = 0.2,
    eps: float = 1e-5,
    branches: Tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """One training layer in plain PyTorch: math in f32, or in f64 for an f64 x (a reference).

    A bf16 or f16 x is the kernels' 16-bit storage mode: read as f32, the
    layer in f32, y rounded to x's dtype (and by autograd gx rounded to it,
    the weight grads f32).  The arithmetic of ``gat_train.py::_fwd_kernel``; autograd gives the
    gradients of ``_bwd_kernel``.  The softmax shift is detached and the
    variance clamp passes its gradient straight through, as the closed-form
    backward does.  LeakyReLU is ``where(v >= 0, v, slope * v)``, whose
    gradient at exactly 0 is 1 as in the kernels.

    ``branches`` = (relu_on (B, R, C) bool, leaky_on (7, B, R) bool: the 6
    directions, then self) makes the ReLU pass and each LeakyReLU take slope
    1 where given, in place of the signs of their arguments: a reference in
    f64 then takes the branches another computation took where f32 rounding
    decided a sign near 0.
    """
    out_dtype = x.dtype
    dt = torch.promote_types(x.dtype, torch.float32)
    x = x.to(dt)
    planes = planes.to(dt)
    mask = planes[..., 6]
    m3 = mask[..., None]
    h = x @ w
    hm = h * m3
    a_s = (h * att[0]).sum(-1)
    a_d = (h * att[1]).sum(-1)

    def lrelu(v, d):
        return torch.where(v >= 0 if branches is None else branches[1][d], v, negative_slope * v)

    offsets = flat_offsets(grid_shape)
    e_self = lrelu(a_s + a_d, 6)
    es = []
    for d, off in enumerate(offsets):
        e_d = lrelu(shift(a_s, 1, off) + a_d, d)
        es.append(torch.where(planes[..., d] > 0, e_d, torch.full_like(e_d, NEG_INF)))
    m = torch.stack([e_self] + es).amax(0).detach()
    p_self = torch.exp(e_self - m)
    ps = [torch.exp(e - m) * planes[..., d] for d, e in enumerate(es)]
    den = torch.clamp(p_self + sum(ps), min=1e-16)
    u = (p_self / den)[..., None] * h
    for d, off in enumerate(offsets):
        u = u + (ps[d] / den)[..., None] * shift(hm, 1, off)
    v = u * m3 + vec[0]

    mk = _key_masks(planes, K, dt)  # (B, R, K)
    n = mk.sum(1).clamp(min=1.0)[..., None]  # (B, K, 1)
    mu = torch.einsum("brk,brc->bkc", mk, v) / n
    ex2 = torch.einsum("brk,brc->bkc", mk, v * v) / n
    s = mu * vec[3]
    var = ex2 - 2.0 * s * mu + s * s
    var = var + (var.clamp(min=0.0) - var).detach()  # clamp at 0, gradient straight through
    rstd = torch.rsqrt(var + eps)
    z = torch.zeros_like(v)
    for k in range(K):
        z = z + mk[..., k : k + 1] * ((v - s[:, k : k + 1]) * rstd[:, k : k + 1])
    t = (z * vec[1] + vec[2]) * m3
    y = torch.relu(t) if branches is None else t * branches[0].to(dt)
    if levels > 0:
        keep = drop.keep_mask(tuple(y.shape), key, levels, device=y.device)
        y = y * keep.to(dt) * drop.keep_scale(levels)
    return y.to(out_dtype)


def hourglass_train_plain(x, planes, Ws, atts, vecs, keys, grid_shape, K=1, levels=0,
                          negative_slope=0.2, eps=1e-5) -> torch.Tensor:
    """The plain version of the stack: ``layer_plain`` over depth, every layer at Cmax."""
    for l in range(Ws.shape[0]):
        x = layer_plain(x, planes, Ws[l], atts[l], vecs[l], keys[l] if levels > 0 else None,
                        grid_shape, K, levels, negative_slope, eps)
    return x


# --------------------------------------------------------------------------
# the CUDA kernels
# --------------------------------------------------------------------------


def _bind(lib):
    """Declare the C signatures of ``csrc/gat_train.cu`` on a loaded library."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dims = [i, i, i, i, i, i, i, i, i, i]  # levels, B, F, Y, X, cmax, ci, co, K, storage code
    lib.gt_forward.argtypes = (
        [p, p, p, p, p, p] + dims + [f, f]  # x, planes, w, att, vec, key; slope, eps
        + [p] * 10  # y, h, v, scores, alphas, bits, stats, nk, part, cnt
        + [p]  # stream
    )
    lib.gt_backward.argtypes = (
        [p, p, p, p, p, p] + dims + [f]  # ...; slope
        + [p] * 8  # h, v, scores, alphas, bits, stats, nk, gy
        + [p] * 4  # gx, gw, gatt, gvec
        + [p] * 7  # gu, de, part, pbias, pgn, patt, pw
        + [p]  # stream
    )
    lib.gt_dropout_bytes.argtypes = [p, ctypes.c_longlong, p, p]
    for fn in (lib.gt_forward, lib.gt_backward, lib.gt_dropout_bytes):
        fn.restype = ctypes.c_int
    lib.gt_error_string.argtypes = [ctypes.c_int]
    lib.gt_error_string.restype = ctypes.c_char_p
    lib.gt_failed_step.argtypes = []
    lib.gt_failed_step.restype = ctypes.c_char_p
    for fn in (lib.gt_row_chunks, lib.gt_lane_width):
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_int
    return lib


_lib = None


def _load():
    """Build (first use) and load the kernel library; returns it bound, once per process."""
    global _lib
    if _lib is None:
        from . import _build

        _lib = _bind(_build.load("gat_train"))
    return _lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"gat_train {what} launch failed: {lib.gt_error_string(rc).decode()} "
                           f"(at {lib.gt_failed_step().decode()})")


@functools.lru_cache(maxsize=512)
def _layout(shapes):
    """(offsets, total) in f32 units of the given shapes in one buffer, each 256-byte aligned."""
    offsets, total = [], 0
    for sh in shapes:
        offsets.append(total)
        total += -(-math.prod(sh) // 64) * 64
    return tuple(offsets), total


def _saved_shapes(lib, B, R, co, K):
    """f32-unit shapes of what the forward saves: h, v, scores, alphas, bits (a word
    for each of a lane's channels, ``gt_lane_width``), stats (f64), nk."""
    return ((B, R, co), (B, R, co), (2, B, R), (B, R, 8), (B, R, lib.gt_lane_width(co)),
            (B, K, 3, 2 * co), (B, K))


def saved_views(lib, saved, x_shape, meta) -> dict:
    """The tensors inside the buffer a forward saved, by name (for checks and diagnostics)."""
    ci, co, K = meta[:3]
    B, R, _ = x_shape
    shapes = _saved_shapes(lib, B, R, co, K)
    offsets, _ = _layout(shapes)
    names = ("h", "v", "scores", "alphas", "bits", "stats", "nk")
    out = {n: saved[o:o + math.prod(sh)].view(sh) for n, o, sh in zip(names, offsets, shapes)}
    out["bits"] = out["bits"].view(torch.int32)
    out["stats"] = out["stats"].view(torch.float64)
    return out


def _ptrs(buf, offsets):
    base = buf.data_ptr()
    return [base + 4 * o for o in offsets]


def launch_forward(lib, stream, x, planes, w, att, vec, key, meta):
    """Allocate outputs and scratch and call ``gt_forward``: -> (y, saved).

    ``saved`` is one f32 buffer holding, at the layer's real width co: h and
    v (B, R, co), the scores (2, B, R), the softmax weights (B, R, 8), one bit
    an element (keyed, ReLU on, kept) as (B, R, gt_lane_width(co)) int32 words,
    the statistics (B, K, 3, co) in f64 and the row counts (B, K)
    (``saved_views`` names them).  Tensors are handed to the kernels as
    pointers into one allocation: the allocator's and the view calls are host
    time that a narrow layer's launch would otherwise wait on.  Checks
    nothing: ``_FusedLayer`` checks the tensors of a call on the card.
    """
    ci, co, K, levels, (F, Y, X), slope, eps = meta
    B, R, cmax = x.shape
    P = lib.gt_row_chunks(R)
    y = torch.empty(B, R, cmax, device=x.device, dtype=x.dtype)
    offsets, total = _layout(_saved_shapes(lib, B, R, co, K))
    saved = torch.empty(total, device=x.device, dtype=torch.float32)
    s_off, s_total = _layout(((B, P, K, 2, 2 * co), (B, P, K)))
    scratch = torch.empty(s_total, device=x.device, dtype=torch.float32)
    rc = lib.gt_forward(
        _ptr(x), _ptr(planes), _ptr(w), _ptr(att), _ptr(vec), _ptr(key),
        levels, B, F, Y, X, cmax, ci, co, K, storage_code(x), slope, eps,
        _ptr(y), *_ptrs(saved, offsets), *_ptrs(scratch, s_off), stream,
    )
    _raise_on(lib, rc, "forward")
    return y, saved


def launch_backward(lib, stream, gy, x, planes, w, att, vec, key, saved, meta):
    """Allocate gradients and scratch and call ``gt_backward``: -> (gx, gw, gatt, gvec)."""
    ci, co, K, levels, (F, Y, X), slope, _ = meta
    B, R, cmax = x.shape
    P = lib.gt_row_chunks(R)
    offsets, _ = _layout(_saved_shapes(lib, B, R, co, K))
    gx = torch.empty(B, R, cmax, device=x.device, dtype=x.dtype)
    grads = torch.empty(6 * cmax + cmax * cmax, device=x.device, dtype=torch.float32)
    gw = grads[:cmax * cmax].view(cmax, cmax)
    gatt = grads[cmax * cmax:cmax * cmax + 2 * cmax].view(2, cmax)
    gvec = grads[cmax * cmax + 2 * cmax:].view(4, cmax)
    s_off, s_total = _layout(((B, R, co), (B, R, 8), (B, P, K, 2, 2 * co), (B, P, co),
                              (B, 3, 2 * co), (B, P, 2, co), (B, P, ci, co)))
    scratch = torch.empty(s_total, device=x.device, dtype=torch.float32)
    rc = lib.gt_backward(
        _ptr(x), _ptr(planes), _ptr(w), _ptr(att), _ptr(vec), _ptr(key),
        levels, B, F, Y, X, cmax, ci, co, K, storage_code(x), slope,
        *_ptrs(saved, offsets), _ptr(gy),
        _ptr(gx), _ptr(gw), _ptr(gatt), _ptr(gvec),
        *_ptrs(scratch, s_off), stream,
    )
    _raise_on(lib, rc, "backward")
    return gx, gw, gatt, gvec


def _check_call(x, planes, w, att, vec, key, meta) -> None:
    ci, co, K, levels, grid_shape, _, _ = meta
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the gat_train kernels need CUDA tensors, got {dev}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, R, Cmax), got shape {tuple(x.shape)}")
    B, R, cmax = x.shape
    if R != math.prod(grid_shape):
        raise ValueError(f"x has {R} rows, grid {tuple(grid_shape)} has {math.prod(grid_shape)}")
    if not 1 <= cmax <= MAX_CHANNELS:
        raise ValueError(f"channel width {cmax} outside [1, {MAX_CHANNELS}]")
    if not (1 <= ci <= cmax and 1 <= co <= cmax):
        raise ValueError(f"layer widths ({ci}, {co}) outside [1, {cmax}]")
    if not 1 <= K <= MAX_KEYS:
        raise ValueError(f"K {K} outside [1, {MAX_KEYS}]")
    if not 0 <= levels < 256:
        raise ValueError(f"dropout levels {levels} outside [0, 256)")
    if x.dtype not in STORAGE_DTYPES:
        raise TypeError(f"x must be one of {STORAGE_DTYPES}, got {x.dtype}")
    _check(x, "x", x.dtype, (B, R, cmax), dev)
    _check(planes, "planes", torch.float32, (B, R, 8), dev)
    _check(w, "w", torch.float32, (cmax, cmax), dev)
    _check(att, "att", torch.float32, (2, cmax), dev)
    _check(vec, "vec", torch.float32, (4, cmax), dev)
    if levels > 0:
        if key is None:
            raise ValueError("dropout needs a Philox key")
        _check(key, "key", torch.int64, (2,), dev)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


class _FusedLayer(torch.autograd.Function):
    """One layer on the card: forward kernel, and the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, x, w, att, vec, planes, key, meta):
        _check_call(x, planes, w, att, vec, key, meta)
        lib = _load()
        with torch.cuda.device(x.device):
            y, saved = launch_forward(lib, _stream(x.device), x, planes, w, att, vec, key, meta)
        fwd_launches.add()
        ctx.meta = meta
        ctx.save_for_backward(x, w, att, vec, planes, key, saved)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w, att, vec, planes, key, saved = ctx.saved_tensors
        gy = gy.contiguous()
        _check(gy, "gy", x.dtype, tuple(x.shape), x.device)
        lib = _load()
        with torch.cuda.device(x.device):
            gx, gw, gatt, gvec = launch_backward(
                lib, _stream(x.device), gy, x, planes, w, att, vec, key, saved, ctx.meta
            )
        bwd_launches.add()
        return gx, gw, gatt, gvec, None, None, None


def fused_layer(x, planes, w, att, vec, key, grid_shape, ci, co, K=1, levels=0,
                negative_slope=0.2, eps=1e-5) -> torch.Tensor:
    """One layer through the CUDA kernels (differentiable); raises on what they do not take."""
    meta = (ci, co, K, levels, tuple(grid_shape), negative_slope, eps)
    key = key if levels > 0 else None
    return _FusedLayer.apply(x, w, att, vec, planes, key, meta)


def dropout_bytes_cuda(n: int, key: torch.Tensor) -> torch.Tensor:
    """The Philox dropout bytes of flat elements 0..n-1 under ``key``, drawn on the card."""
    if key.device.type != "cuda":
        raise ValueError(f"the dropout-byte kernel needs a CUDA key, got {key.device}")
    _check(key, "key", torch.int64, (2,), key.device)
    out = torch.empty(n, dtype=torch.uint8, device=key.device)
    lib = _load()
    with torch.cuda.device(key.device):
        _raise_on(lib, lib.gt_dropout_bytes(_ptr(out), n, _ptr(key), _stream(key.device)), "bytes")
    bytes_launches.add()
    return out


def hourglass_train(
    x: torch.Tensor,  # (B, R, Cmax)
    planes: torch.Tensor,  # (B, R, 8)
    Ws: torch.Tensor,  # (L, Cmax, Cmax)
    atts: torch.Tensor,  # (L, 2, Cmax)
    vecs: torch.Tensor,  # (L, 4, Cmax)
    keys: torch.Tensor | None,  # (L, 2) int64 Philox keys
    grid_shape: Tuple[int, int, int],
    K: int = 1,
    dropout_rate: float = 0.0,
    deterministic: bool = False,
    *,
    chans: Sequence[Tuple[int, int]],  # (ci, co) of each layer, as hourglass_channel_pairs
    negative_slope: float = 0.2,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Differentiable training hourglass, a Python loop over depth.

    Gradients flow to x, Ws, atts and vecs (not to planes or keys).  On CPU
    tensors: the plain version, at Cmax (the padding is zero).  On CUDA
    tensors: the kernels, computing only the real ``chans`` widths.
    """
    levels = 0 if deterministic else drop.drop_levels(dropout_rate)
    if levels > 0 and keys is None:
        raise ValueError("dropout needs per-layer Philox keys")
    if len(chans) != Ws.shape[0]:
        raise ValueError(f"{len(chans)} layer widths for {Ws.shape[0]} layers")
    if x.device.type == "cpu":
        return hourglass_train_plain(x, planes, Ws, atts, vecs, keys, grid_shape, K, levels,
                                     negative_slope, eps)
    # unbind, not Ws[l]: one autograd node a parameter stack, whose backward
    # stacks the layers' grads once, in place of a zero-filled copy a layer
    for l, (w, att, vec) in enumerate(zip(Ws.unbind(0), atts.unbind(0), vecs.unbind(0))):
        ci, co = chans[l]
        x = fused_layer(x, planes, w, att, vec, keys[l] if levels > 0 else None,
                        grid_shape, ci, co, K, levels, negative_slope, eps)
    return x
