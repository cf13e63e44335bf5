"""The training layer's CUDA kernels (csrc/gat_train.cu), run on the CPU under emulation.

The same emulation as tests/test_torch_kernel_emulated.py: the kernel source
is compiled with the host C++ compiler against a stand-in ``cuda_runtime.h``
(a ``std::thread`` for each CUDA thread, ``__syncthreads`` a barrier, blocks
one after another) and driven through the port's own ctypes binding and
launch code (``ops.gat_train.launch_forward`` / ``launch_backward``).  The
design uses no atomics (per-block partials reduced in a fixed order), which
is what lets the emulation run the backward too.

Each layer of a stack is held against ``layer_plain``: the forward output,
and the backward's gx, gW, gatt and gvec against autograd through it, with
dropout on and off, K = 1 to 4, and every lane mapping of the kernels: co
of 1, 2 and 3 (that many channels a lane, 32 rows a warp), 4 to 64 (4 a lane,
float4 rows, and scalar rows when co is not a multiple of 4: co = 6, 12) and
96 and 128 (8 a lane); a slot of two row-pass chunks whose +-Y*X halo (42
rows) is wider than the gather pass's 32-row tile.  A layer's backward run twice gives the same bits (no atomics), and
the Philox header's bytes equal the torch Philox bit for bit.  The source is
built with ``-fsanitize=alignment``: a float4 or double access at an address
the card would fault on (``misaligned address``) aborts the run.

Tolerance: the forward and each gradient within 1e-4 of the largest
magnitude of the reference (f32 sums in other orders, and FMA contraction
by the host compiler, through narrow GraphNorm layers).  The reference is
``layer_plain`` run in float64 on the same f32 inputs: through a 1-channel
GraphNorm layer the plain version run in f32 is itself ~1.2e-4 of scale from
f64 (a gvec of the co = 1 case), 7x further than the kernel.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from building_gan_torch.ops import _build
from building_gan_torch.ops import dropout as drop
from building_gan_torch.ops import gat_train as gt
from building_gan_torch.ops.hourglass import hourglass_channel_pairs

from test_torch_kernel_emulated import EMU_BF16_HEADER, EMU_FP16_HEADER, EMU_HEADER, emulated_source
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

TOL = 1e-4


@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++) for the CPU emulation")
    d = tmp_path_factory.mktemp("cuda_emu_gt")
    (d / "cuda_runtime.h").write_text(EMU_HEADER)
    (d / "cuda_bf16.h").write_text(EMU_BF16_HEADER)
    (d / "cuda_fp16.h").write_text(EMU_FP16_HEADER)
    with open(f"{_build.CSRC}/gat_train.cu") as f:
        src, n = emulated_source(f.read())
    # launch sites: forward 3, backward 4, bytes 1 (each pass launches one
    # kernel a layer, its template instance picked by the layer's widths)
    assert n == 8
    (d / "gat_train_emu.cpp").write_text(src)
    so = d / "libgat_train_emu.so"
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas",
         "-fsanitize=alignment", "-fno-sanitize-recover=all",
         f"-I{d}", f"-I{_build.CSRC}", "-o", str(so), str(d / "gat_train_emu.cpp")],
        check=True, capture_output=True, timeout=300,
    )
    return gt._bind(ctypes.CDLL(str(so)))


def _stack(rng, hidden, repeat):
    """Zero-padded per-layer weights at the hourglass's real widths."""
    chans = hourglass_channel_pairs(hidden, repeat)
    L = len(chans)
    Ws, atts, vecs = np.zeros((L, hidden, hidden)), np.zeros((L, 2, hidden)), np.zeros((L, 4, hidden))
    for l, (ci, co) in enumerate(chans):
        Ws[l, :ci, :co] = rng.normal(size=(ci, co)) / np.sqrt(ci)
        atts[l, :, :co] = rng.normal(size=(2, co)) * 0.5
        vecs[l, 0, :co] = rng.uniform(-0.3, 0.3, co)
        vecs[l, 1, :co] = rng.uniform(0.5, 1.5, co)
        vecs[l, 2, :co] = rng.uniform(-0.3, 0.3, co)
        vecs[l, 3, :co] = rng.uniform(0.5, 1.5, co)
    f = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    return f(Ws), f(atts), f(vecs), chans


def _close(got, want, name):
    scale = want.abs().max().item() + 1e-6
    err = (got.double() - want).abs().max().item()
    assert err <= TOL * scale, f"{name}: max abs err {err:.3e} > {TOL} x {scale:.3e}"


def _case(rng, B, F, Y, X, hidden, repeat, K, rate):
    grid = (F, Y, X)
    R = F * Y * X
    Ws, atts, vecs, chans = _stack(rng, hidden, repeat)
    mask = torch.from_numpy((rng.random((B, R)) < 0.7).astype(np.float32))
    gid = torch.from_numpy(rng.integers(0, K, (B, R))) if K > 1 else None
    planes = gt.build_planes(mask, gid, grid)
    keys = torch.from_numpy(rng.integers(0, 2**32, (len(chans), 2), dtype=np.int64))
    levels = drop.drop_levels(rate)
    x = torch.from_numpy(rng.normal(size=(B, R, hidden)).astype(np.float32))
    return grid, Ws, atts, vecs, chans, planes, keys, levels, x


@pytest.mark.parametrize(
    "B,F,Y,X,hidden,repeat,K,rate",
    [(2, 3, 5, 6, 16, 2, 1, 0.2), (2, 4, 5, 7, 16, 1, 3, 0.2), (3, 2, 9, 9, 8, 2, 1, 0.0),
     (2, 8, 6, 7, 4, 2, 2, 0.2), (2, 2, 5, 6, 128, 1, 1, 0.2), (2, 2, 5, 7, 96, 1, 4, 0.2),
     (2, 3, 4, 5, 12, 2, 2, 0.2), (2, 3, 4, 5, 4, 2, 3, 0.2)],
    ids=["k1_dropout_two_tiles", "k3_dropout_three_tiles", "k1_no_dropout_odd_grid",
         "k2_co1_co2_two_chunks_wide_halo", "k1_co64_co128_vector_lanes", "k4_co48_co96_unequal_blocks",
         "k2_co3_co6_unaligned_rows", "k3_co1_odd_shared_planes"],
)
def test_emulated_layer_matches_plain(emulated_lib, B, F, Y, X, hidden, repeat, K, rate):
    rng = np.random.default_rng(hidden + 7 * K)
    _hold_layers(emulated_lib, rng, K, *_case(rng, B, F, Y, X, hidden, repeat, K, rate))


@pytest.mark.parametrize("K", [1, 3])
def test_emulated_all_masked_slot_matches_plain(emulated_lib, K):
    """A slot with no real row, as a data-parallel null fill pack's: its GraphNorm row
    counts are 0, which the kernels clamp to 1 as layer_plain does, so every output and
    gradient is finite (0 x a NaN would poison the ranks' gradient all-reduce); held
    to layer_plain as above, the other slot real."""
    rng = np.random.default_rng(40 + K)
    grid, Ws, atts, vecs, chans, _, keys, levels, x = _case(rng, 2, 2, 4, 5, 8, 1, K, 0.2)
    mask = torch.from_numpy((rng.random((2, 2 * 4 * 5)) < 0.7).astype(np.float32))
    mask[1] = 0.0
    gid = torch.from_numpy(rng.integers(0, K, mask.shape)) * mask.long() if K > 1 else None
    planes = gt.build_planes(mask, gid, grid)
    _hold_layers(emulated_lib, rng, K, grid, Ws, atts, vecs, chans, planes, keys, levels, x)


def _hold_layers(emulated_lib, rng, K, grid, Ws, atts, vecs, chans, planes, keys, levels, x):
    """Each layer of the stack, forward and backward, against layer_plain in f64."""
    B = x.shape[0]
    hidden = x.shape[-1]
    for l, (ci, co) in enumerate(chans):
        key = keys[l] if levels else None
        meta = (ci, co, K, levels, grid, 0.2, 1e-5)
        xl = x.double().requires_grad_(True)
        w, att, vec = (a[l].double().requires_grad_(True) for a in (Ws, atts, vecs))
        want = gt.layer_plain(xl, planes, w, att, vec, key, grid, K, levels)
        got, saved = gt.launch_forward(emulated_lib, None, x, planes, Ws[l], atts[l], vecs[l], key, meta)
        assert torch.isfinite(got).all()
        _close(got, want.detach(), f"layer {l} forward")
        assert (got[..., co:] == 0).all()

        gy = torch.from_numpy(rng.normal(size=(B, x.shape[1], hidden)).astype(np.float32))
        want_g = torch.autograd.grad((want * gy.double()).sum(), (xl, w, att, vec))
        got_g = gt.launch_backward(emulated_lib, None, gy, x, planes, Ws[l], atts[l], vecs[l],
                                   key, saved, meta)
        for name, a, b in zip(("gx", "gW", "gatt", "gvec"), got_g, want_g):
            assert torch.isfinite(a).all(), name
            _close(a, b, f"layer {l} {name}")
        x = want.detach().float()


def _close_16bit(got, want, name, dtype=torch.bfloat16):
    """A 16-bit result: within one ulp of the f64 value (half the dtype's epsilon of
    it: 2^-8 at bf16, 2^-11 at f16; the rounding of the store is half of that) plus
    TOL of the largest magnitude."""
    assert got.dtype == dtype, name
    scale = want.abs().max().item() + 1e-6
    err = (got.double() - want).abs()
    bound = want.abs() * (torch.finfo(dtype).eps / 2) + TOL * scale
    assert (err <= bound).all(), f"{name}: max excess {(err - bound).max().item():.3e} (scale {scale:.3e})"


@pytest.mark.parametrize(
    "B,F,Y,X,hidden,repeat,K,rate",
    [(2, 3, 4, 5, 4, 2, 3, 0.2), (2, 3, 4, 5, 12, 2, 2, 0.2), (2, 2, 5, 6, 128, 1, 1, 0.2)],
    ids=["k3_co1_odd_rows", "k2_co3_co6_unaligned_rows", "k1_co64_co128"],
)
def test_emulated_bf16_layer_matches_plain(emulated_lib, B, F, Y, X, hidden, repeat, K, rate):
    """bf16 storage (x, y, gy, gx): every row is 2 co bytes, so odd widths give rows
    no 4- or 8-byte boundary holds; the reference is layer_plain in f64 on the same
    bf16 values, each bf16 output within one ulp of it, the f32 weight grads as above."""
    _hold_16bit_layers(emulated_lib, torch.bfloat16, B, F, Y, X, hidden, repeat, K, rate)


@pytest.mark.parametrize(
    "B,F,Y,X,hidden,repeat,K,rate",
    [(2, 3, 4, 5, 4, 2, 3, 0.2), (2, 3, 4, 5, 12, 2, 2, 0.2)],
    ids=["k3_co1_odd_rows", "k2_co3_co6_unaligned_rows"],
)
def test_emulated_f16_layer_matches_plain(emulated_lib, B, F, Y, X, hidden, repeat, K, rate):
    """f16 storage, as bf16 storage above: each f16 output within one f16 ulp of the
    f64 reference on the same f16 values.  The 2-byte rows of odd widths; the wide
    lanes' 16-bit rows (co 64, 128) are the bf16 case's, which differs only in the
    conversions (~40 s under the emulation)."""
    _hold_16bit_layers(emulated_lib, torch.float16, B, F, Y, X, hidden, repeat, K, rate)


def _hold_16bit_layers(emulated_lib, dtype, B, F, Y, X, hidden, repeat, K, rate):
    rng = np.random.default_rng(hidden + 11 * K)
    grid, Ws, atts, vecs, chans, planes, keys, levels, x = _case(rng, B, F, Y, X, hidden, repeat,
                                                                 K, rate)
    x = x.to(dtype)
    for l, (ci, co) in enumerate(chans):
        key = keys[l] if levels else None
        meta = (ci, co, K, levels, grid, 0.2, 1e-5)
        xl = x.double().requires_grad_(True)
        w, att, vec = (a[l].double().requires_grad_(True) for a in (Ws, atts, vecs))
        want = gt.layer_plain(xl, planes, w, att, vec, key, grid, K, levels)
        got, saved = gt.launch_forward(emulated_lib, None, x, planes, Ws[l], atts[l], vecs[l], key, meta)
        assert torch.isfinite(got).all()
        _close_16bit(got, want.detach(), f"layer {l} forward", dtype)
        assert (got[..., co:] == 0).all()

        gy = torch.from_numpy(rng.normal(size=(B, x.shape[1], hidden)).astype(np.float32))
        gy = gy.to(dtype)
        want_g = torch.autograd.grad((want * gy.double()).sum(), (xl, w, att, vec))
        got_g = gt.launch_backward(emulated_lib, None, gy, x, planes, Ws[l], atts[l], vecs[l],
                                   key, saved, meta)
        assert [a.dtype for a in got_g] == [dtype] + [torch.float32] * 3
        _close_16bit(got_g[0], want_g[0], f"layer {l} gx", dtype)
        for name, a, b in zip(("gW", "gatt", "gvec"), got_g[1:], want_g[1:]):
            assert torch.isfinite(a).all(), name
            _close(a, b, f"layer {l} {name}")
        x = got


def test_emulated_backward_is_bit_reproducible(emulated_lib):
    rng = np.random.default_rng(5)
    grid, Ws, atts, vecs, chans, planes, keys, levels, x = _case(rng, 2, 8, 6, 7, 16, 1, 3, 0.2)
    ci, co = chans[0]
    meta = (ci, co, 3, levels, grid, 0.2, 1e-5)
    gy = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    args = (x, planes, Ws[0], atts[0], vecs[0], keys[0])
    _, saved = gt.launch_forward(emulated_lib, None, *args, meta)
    first = gt.launch_backward(emulated_lib, None, gy, *args, saved, meta)
    again = gt.launch_backward(emulated_lib, None, gy, *args, saved, meta)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_emulated_philox_bytes_equal_torch(emulated_lib):
    key = torch.tensor([0x243F6A88, 0x85A308D3], dtype=torch.int64)
    n = 3000
    out = torch.empty(n, dtype=torch.uint8)
    assert emulated_lib.gt_dropout_bytes(out.data_ptr(), n, key.data_ptr(), None) == 0
    want = drop.random_bytes(torch.arange(n), key)
    assert torch.equal(out.to(torch.int64), want)
