"""Card-only tests of the port's CUDA kernel and its served path.

Marked ``cuda``; each skips where torch sees no GPU (decided in the fixture,
at run time).  This file imports no JAX, so it also runs on a machine that
has only the port's dependencies:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py imports JAX).  f32 with TF32
off.  The kernel runs the stack in one launch, a thread block cluster a
slot; it raises on a slot no cluster of 16 CTAs holds, and on a cluster
size the slot does not fit.  It is held against the plain version run in
float64: its max abs error must be at most 4x that of the plain version run
in float32, plus 1e-4.  The 1-channel GraphNorm layers of the 128 -> 1 ->
128 stack magnify f32 rounding to ~1e-2 on a few outputs, so no fixed
tolerance fits both that and a fault, which moves outputs by their own size.
"""

import numpy as np
import pytest
import torch

from building_gan_torch.config import Configuration
from building_gan_torch.data import generate_building, process_building
from building_gan_torch.models.grid_layers import GridHourglass
from building_gan_torch.models.grid_models import GridVoxelGNNGenerator
from building_gan_torch.ops import hourglass as hg
from building_gan_torch.serving import InferenceServer

ROUNDING_FACTOR, ROUNDING_ATOL = 4.0, 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 4])
def test_kernel_matches_plain_at_full_width(K, cuda_device):
    gen = torch.Generator().manual_seed(K)
    B, F, Y, X = 4, 11, 12, 12
    torch.manual_seed(K)
    with torch.no_grad():
        Ws, atts, vecs = (a.to(cuda_device) for a in hg.pack_gat_weights(GridHourglass(128, 7)))
    chans = hg.hourglass_channel_pairs(128, 7)
    mask = (torch.rand(B, F, Y, X, generator=gen) < 0.6).float()
    ix = torch.arange(X).expand(B, F, Y, X)
    iy = torch.arange(Y)[:, None].expand(B, F, Y, X)
    gid = ((ix >= X // 2).long() + 2 * (iy >= Y // 2).long()) if K > 1 else None
    args = (
        torch.randn(B, F, Y, X, 128, generator=gen).to(cuda_device), mask.to(cuda_device),
        Ws, atts, vecs, chans, None if gid is None else gid.to(cuda_device), K,
    )
    want = hg.hourglass_plain(*args)
    want64 = hg.hourglass_plain(
        *(a.double() if torch.is_tensor(a) and a.is_floating_point() else a for a in args)
    )
    before = hg.launches.value
    got = hg.hourglass_fwd(*args)
    torch.cuda.synchronize()
    assert hg.launches.value == before + 1
    assert torch.isfinite(got).all()
    err_kernel = (got.double() - want64).abs().max().item()
    err_plain = (want.double() - want64).abs().max().item()
    assert err_kernel <= ROUNDING_FACTOR * err_plain + ROUNDING_ATOL, (err_kernel, err_plain)


def _ulp(t, dtype=torch.bfloat16) -> float:
    """One ulp of the 16-bit dtype (bf16: 8 significant bits, f16: 11) at the largest
    |value| of t."""
    m = t.abs().max().item()
    nmant = round(-np.log2(torch.finfo(dtype).eps))  # stored significand bits: 7, 10
    return 2.0 ** (np.floor(np.log2(m)) - nmant) if m > 0 else 0.0


def _stored64(x, mask, Ws, atts, vecs, chans, gid, K):
    """The plain stack in f64 on 16-bit x, a layer at a time, each layer's output
    rounded to x's dtype as the 16-bit kernel stores it."""
    y = x.double()
    for l in range(len(chans)):
        y = hg.hourglass_plain(y, mask, Ws[l:l + 1].double(), atts[l:l + 1].double(),
                               vecs[l:l + 1].double(), chans[l:l + 1], gid, K).to(x.dtype).double()
    return y


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 4])
def test_kernel_bf16_matches_plain_at_full_width(K, cuda_device):
    """bf16 storage (x and out bf16, each layer's output rounded to bf16, f32 math):
    held against the plain version run in f64 on the same bf16 x and rounded to bf16
    where the kernel stores, so the plain bf16 twin's distance from it is f32
    rounding alone.  Max abs within 4x the twin's own plus 1e-4 and one bf16 ulp of
    the largest value (f32 rounding can move a stored value across a rounding
    boundary); norm-relative within 4x the twin's plus 1e-4."""
    _hold_16bit_kernel(K, cuda_device, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 4])
def test_kernel_f16_matches_plain_at_full_width(K, cuda_device):
    """f16 storage, by the bf16 rules with one f16 ulp (11 significant bits)."""
    _hold_16bit_kernel(K, cuda_device, torch.float16)


def _hold_16bit_kernel(K, cuda_device, dtype):
    gen = torch.Generator().manual_seed(10 + K)
    B, F, Y, X = 4, 11, 12, 12
    torch.manual_seed(10 + K)
    with torch.no_grad():
        Ws, atts, vecs = (a.to(cuda_device) for a in hg.pack_gat_weights(GridHourglass(128, 7)))
    chans = hg.hourglass_channel_pairs(128, 7)
    mask = (torch.rand(B, F, Y, X, generator=gen) < 0.6).float()
    ix = torch.arange(X).expand(B, F, Y, X)
    iy = torch.arange(Y)[:, None].expand(B, F, Y, X)
    gid = ((ix >= X // 2).long() + 2 * (iy >= Y // 2).long()) if K > 1 else None
    x = torch.randn(B, F, Y, X, 128, generator=gen).to(cuda_device, dtype)
    args = (x, mask.to(cuda_device), Ws, atts, vecs, chans,
            None if gid is None else gid.to(cuda_device), K)
    twin = hg.hourglass_plain(*args)
    unrounded64 = hg.hourglass_plain(
        *(a.double() if torch.is_tensor(a) and a.is_floating_point() else a for a in args)
    )
    want64 = _stored64(*args)
    before = hg.launches.value
    got = hg.hourglass_fwd(*args)
    torch.cuda.synchronize()
    assert hg.launches.value == before + 1
    assert got.dtype == twin.dtype == dtype and torch.isfinite(got).all()
    assert (twin.double() - unrounded64).abs().max().item() > 0  # the twin rounds
    err_kernel = (got.double() - want64).abs().max().item()
    err_twin = (twin.double() - want64).abs().max().item()
    limit = ROUNDING_FACTOR * err_twin + ROUNDING_ATOL + _ulp(want64, dtype)
    assert err_kernel <= limit, (err_kernel, err_twin, limit)
    rel_kernel = ((got.double() - want64).norm() / want64.norm()).item()
    rel_twin = ((twin.double() - want64).norm() / want64.norm()).item()
    assert rel_kernel <= ROUNDING_FACTOR * rel_twin + ROUNDING_ATOL, (rel_kernel, rel_twin)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    with torch.no_grad():
        Ws, atts, vecs = (a.to(cuda_device) for a in hg.pack_gat_weights(GridHourglass(16, 2)))
    chans = hg.hourglass_channel_pairs(16, 2)
    x = torch.zeros(2, 3, 4, 5, 16, device=cuda_device)
    mask = torch.ones(2, 3, 4, 5, device=cuda_device)
    with pytest.raises(TypeError):
        hg.hourglass_fwd(x.double(), mask, Ws, atts, vecs, chans)
    with pytest.raises(TypeError):
        hg.hourglass_fwd(x.to(torch.int32), mask, Ws, atts, vecs, chans)
    hg.hourglass_fwd(x.half(), mask, Ws, atts, vecs, chans)  # the three storage dtypes are taken
    with pytest.raises(ValueError):
        hg.hourglass_fwd(x, mask, Ws, atts, vecs, chans, num_graphs=2)  # no gid plane
    with pytest.raises(ValueError):
        hg.hourglass_fwd(x.transpose(1, 2), mask, Ws, atts, vecs, chans)
    # the largest slot a 16-CTA cluster holds at the config of record's widths
    # and K = 1 is 4,448 rows; one of 4,800 rows raises before any launch
    with torch.no_grad():
        Ws, atts, vecs = (a.to(cuda_device) for a in hg.pack_gat_weights(GridHourglass(128, 7)))
    chans = hg.hourglass_channel_pairs(128, 7)
    big = torch.zeros(1, 3, 40, 40, 128, device=cuda_device)
    big_mask = torch.ones(1, 3, 40, 40, device=cuda_device)
    assert hg.cluster_size(1, 4800, 128, 1, chans) == 0 < hg.cluster_size(1, 4448, 128, 1, chans)
    before = hg.launches.value
    with pytest.raises(ValueError, match="cluster"):
        hg.hourglass_fwd(big, big_mask, Ws, atts, vecs, chans)
    # a cluster too small for the slot is a refused configuration: it raises, no fallback
    x = torch.zeros(1, 11, 12, 12, 128, device=cuda_device)
    with pytest.raises(RuntimeError, match="launch failed"):
        hg.hourglass_cuda(x, torch.ones(1, 11, 12, 12, device=cuda_device), Ws, atts, vecs, chans,
                          cluster=5)
    assert hg.launches.value == before


@pytest.mark.cuda
def test_kernel_is_deterministic_and_slot_independent(cuda_device):
    """Two calls on the same inputs give the same bits, and a slot's output does not
    depend on its batchmates (at one batch size, so one cluster size: the server
    always runs max_batch slots): the server batches requests and relies on both."""
    gen = torch.Generator().manual_seed(3)
    B, F, Y, X = 4, 11, 12, 12
    torch.manual_seed(3)
    with torch.no_grad():
        Ws, atts, vecs = (a.to(cuda_device) for a in hg.pack_gat_weights(GridHourglass(128, 7)))
    chans = hg.hourglass_channel_pairs(128, 7)
    x = torch.randn(B, F, Y, X, 128, generator=gen).to(cuda_device)
    mask = (torch.rand(B, F, Y, X, generator=gen) < 0.6).float().to(cuda_device)
    first = hg.hourglass_fwd(x, mask, Ws, atts, vecs, chans)
    again = hg.hourglass_fwd(x, mask, Ws, atts, vecs, chans)
    x2, mask2 = x.clone(), mask.clone()
    x2[1:] = torch.randn(B - 1, F, Y, X, 128, generator=gen).to(cuda_device)
    mask2[1:] = (torch.rand(B - 1, F, Y, X, generator=gen) < 0.3).float().to(cuda_device)
    other = hg.hourglass_fwd(x2, mask2, Ws, atts, vecs, chans)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert torch.equal(first[0], other[0])
    assert not torch.equal(first[1], other[1])


@pytest.mark.cuda
def test_served_path_launches_the_kernel(cuda_device):
    cfg = Configuration(
        COMPUTE_DTYPE="float32", GRID_SHAPE=(10, 8, 8), GENERATOR_HIDDEN_DIM=32,
        GENERATOR_ENCODER_REPEAT=3, LOCAL_ENCODER_HIDDEN_DIM=32, Z_DIM=16,
    )
    samples = [process_building(*generate_building(1000 + i), cfg, str(i)) for i in range(4)]
    torch.manual_seed(0)
    srv = InferenceServer(
        cfg, GridVoxelGNNGenerator(cfg).state_dict(), max_batch=4, max_delay_ms=20.0,
        device=cuda_device,
    ).start()
    try:
        before = hg.launches.value
        first = [srv.infer(*s, seed=i, timeout_s=120.0) for i, s in enumerate(samples)]
        again = srv.infer(*samples[2], seed=2, timeout_s=120.0)
    finally:
        srv.stop()
    assert hg.launches.value >= before + 5
    np.testing.assert_array_equal(again["types"], first[2]["types"])
    for r, (_, v) in zip(first, samples):
        assert r["logits"].shape == (v.x.shape[0], 7) and np.isfinite(r["logits"]).all()


@pytest.mark.cuda
def test_served_path_at_bf16_launches_the_kernel(cuda_device):
    """The server at the JAX package's default COMPUTE_DTYPE (bf16): the kernel's bf16
    storage on the served path, one launch a batch, finite f32 logits, alone == batched."""
    cfg = Configuration(GRID_SHAPE=(10, 8, 8), GENERATOR_HIDDEN_DIM=32, GENERATOR_ENCODER_REPEAT=3,
                        LOCAL_ENCODER_HIDDEN_DIM=32, Z_DIM=16)
    assert cfg.COMPUTE_DTYPE == "bfloat16"
    samples = [process_building(*generate_building(1000 + i), cfg, str(i)) for i in range(4)]
    torch.manual_seed(0)
    srv = InferenceServer(cfg, GridVoxelGNNGenerator(cfg).state_dict(), max_batch=4,
                          max_delay_ms=20.0, device=cuda_device).start()
    try:
        before = hg.launches.value
        first = [srv.infer(*s, seed=i, timeout_s=120.0) for i, s in enumerate(samples)]
        again = srv.infer(*samples[2], seed=2, timeout_s=120.0)
    finally:
        srv.stop()
    assert hg.launches.value >= before + 5
    assert srv._weights[0].compute_dtype == torch.bfloat16
    np.testing.assert_array_equal(again["types"], first[2]["types"])
    np.testing.assert_array_equal(again["logits"], first[2]["logits"])
    for r, (_, v) in zip(first, samples):
        assert r["logits"].dtype == np.float32 and r["logits"].shape == (v.x.shape[0], 7)
        assert np.isfinite(r["logits"]).all()
