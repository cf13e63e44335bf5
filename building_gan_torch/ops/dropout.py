"""Byte-threshold dropout driven by a counter-based generator (Philox4x32-10).

Port of ``building_gan_tpu/ops/dropout.py::FastDropout``: one random byte an
element, ``keep = byte >= d`` with ``d = round(rate * 256)`` drop levels (51
for rate 0.2, so the drop rate is 51/256), and the kept values scaled by the
exact inverse keep rate ``256 / (256 - d)``.

The bytes come from Philox4x32-10 (Salmon et al., SC'11), a full-entropy
counter-based generator: the key is 64 bits, one for each (layer, pass),
drawn from the step's ``torch.Generator``; the counter is the element's flat
index ``(slot * R + row) * width + channel`` over the padded width of the
stack, and the byte is the low byte of the first output word.  So a mask
depends only on (key, element) and the plain stack, the fused CUDA kernel
(``csrc/philox.cuh``, the same rounds in C++) and the backward all draw the
same bits.  The JAX package's structured keys collapsed WGAN-GP training
(``docs/PERF.md`` section 11-12), hence a full-entropy key here.

This module computes Philox in int64 tensor arithmetic: each 32 x 32 -> 64
bit product is built from 16-bit halves, so no int64 product overflows.
That is the plain version: ``dropout`` on a CPU tensor draws its mask so.  On
a CUDA tensor it draws the bytes with the port's Philox kernel
(``ops/gat_train.py::dropout_bytes_cuda``, the rounds of ``csrc/philox.cuh``),
bit-equal to ``keep_mask``, which stays as the kernel's oracle.
"""

from __future__ import annotations

import functools

import torch

PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def drop_levels(rate: float) -> int:
    """Drop levels out of 256 for ``rate`` (0.2 -> 51)."""
    return int(round(rate * 256.0))


def keep_scale(levels: int) -> float:
    return 256.0 / (256.0 - levels)


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of ``a * m`` for int64 ``a`` in [0, 2^32) and a 32-bit constant."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    mid = a_lo * m_hi + a_hi * m_lo  # < 2^33
    lo_full = a_lo * m_lo + ((mid & 0xFFFF) << 16)  # < 2^33
    hi = a_hi * m_hi + (mid >> 16) + (lo_full >> 32)
    return hi & _MASK32, lo_full & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32 with 10 rounds on int64 tensors holding 32-bit words.

    ``c*`` are the counter words, ``k0``/``k1`` the key words (tensors that
    broadcast against the counters, or ints).  Returns the four output words.
    """
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W0) & _MASK32
            k1 = (k1 + PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def random_bytes(index: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """The dropout byte (int64 in [0, 256)) of each flat element ``index`` under ``key``.

    ``key`` is an int64 tensor of two 32-bit words (k0, k1).
    """
    index = index.to(torch.int64)
    key = key.to(device=index.device, dtype=torch.int64)
    zero = torch.zeros_like(index)
    out0, _, _, _ = philox4x32_10(index & _MASK32, index >> 32, zero, zero, key[0], key[1])
    return out0 & 0xFF


def flat_index(shape, width: int, device, rows=None) -> torch.Tensor:
    """Counters of a (B, R, C) block laid out at a padded channel width ``width``.

    ``rows`` (first row, rows a slot): the block is rows ``[first, first + R)`` of
    slots that hold more rows (a floor shard's), counted as the whole slots' are.
    """
    B, R, C = shape
    first, total = (0, R) if rows is None else rows
    r = (torch.arange(B, device=device, dtype=torch.int64)[:, None] * total
         + first + torch.arange(R, device=device, dtype=torch.int64))
    return r[..., None] * width + torch.arange(C, device=device, dtype=torch.int64)


def keep_mask(shape, key: torch.Tensor, levels: int, width: int | None = None,
              device=None, rows=None) -> torch.Tensor:
    """Boolean keep mask of a (B, R, C) block: ``byte >= levels`` (``rows``: ``flat_index``)."""
    width = shape[-1] if width is None else width
    dev = key.device if device is None else device
    return random_bytes(flat_index(shape, width, dev, rows), key) >= levels


def dropout(x: torch.Tensor, key: torch.Tensor, rate: float, width: int | None = None,
            rows=None) -> torch.Tensor:
    """``x`` (B, R, C) with the Philox byte-threshold mask of ``key`` applied.

    ``width`` is the padded channel width whose flat index is the counter
    (the hourglass's widest layer), so a narrow layer draws the same bits as
    the fused kernel, which lays every layer out at that width.  ``rows``
    (first row, rows a slot): x is those rows of larger slots (a floor shard's),
    masked as they are in the whole slots.
    """
    levels = drop_levels(rate)
    if levels <= 0:
        return x
    if levels >= 256:
        return torch.zeros_like(x)
    width = x.shape[-1] if width is None else width
    if width < x.shape[-1]:
        raise ValueError(f"padded width {width} is below the block's {x.shape[-1]} channels")
    keep = _keep(tuple(x.shape), key, levels, width, x.device, rows)
    return x * keep.to(x.dtype) * _keep_scale_in(levels, x.dtype)


@functools.lru_cache(maxsize=None)
def _keep_scale_in(levels: int, dtype: torch.dtype) -> float:
    """The inverse keep rate rounded to ``dtype``, as FastDropout casts it (1.25 in bf16)."""
    return torch.tensor(keep_scale(levels), dtype=dtype).item()


def _keep(shape, key: torch.Tensor, levels: int, width: int, device, rows=None) -> torch.Tensor:
    """``keep_mask``'s bits: on the card the bytes of the B * R * width counters come
    from the Philox kernel, viewed as (B, R, width), the first C channels kept.  With
    ``rows`` the kernel draws the whole slots' bytes and this block's rows are kept."""
    if device.type != "cuda":
        return keep_mask(shape, key, levels, width, device, rows)
    from .gat_train import dropout_bytes_cuda  # gat_train imports this module

    B, R, C = shape
    first, total = (0, R) if rows is None else rows
    drawn = dropout_bytes_cuda(B * total * width, key).view(B, total, width)
    return drawn[:, first:first + R, :C] >= levels


def draw_keys(n: int, generator: torch.Generator) -> torch.Tensor:
    """(n, 2) int64 Philox keys (two 32-bit words each) from ``generator``, on its device."""
    return torch.randint(0, 2**32, (n, 2), generator=generator, device=generator.device,
                         dtype=torch.int64)
