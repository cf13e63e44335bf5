"""The CUDA hourglass kernel's own code, run on the CPU under an emulation.

There is no nvcc here, so ``csrc/hourglass.cu`` is compiled with the host
C++ compiler against a small stand-in for ``cuda_runtime.h`` and
``cooperative_groups.h``: every CUDA thread is a ``std::thread``,
``__syncthreads`` a ``std::barrier`` of its block.  Warps are 32
consecutive threads with a barrier and an exchange buffer of their own, so
``__shfl_*_sync``, ``__ballot_sync`` and ``__syncwarp`` work.  A
``cudaLaunchKernelEx`` with a cluster dimension runs the blocks of each
cluster at once (their threads together), each with its own dynamic shared
memory, which starts as NaNs; ``this_cluster()`` gives ``sync()`` (a barrier
over the cluster's threads), ``block_rank()``, ``num_blocks()`` and
``map_shared_rank()`` (the same offset in another block's shared memory).
The occupancy queries answer as a card that holds every cluster at once, a
block an SM.  ``kernel<<<grid, threads, smem, s>>>(`` launches (the training
kernels') run their blocks one after another (``emulated_source``).  The
library is driven through the same ctypes binding as on the card.

The cases check the kernel's indexing, masks, cluster layout and
statistics: halos that cross into the next CTA and two or three CTAs away,
R not divisible by the cluster size (and ranks that own no row), widths 1
to 128 (and widths that are no multiple of 4, and a padded width that is
none), K = 1 and K > 1 with a gid plane, two GEMM passes over a CTA's rows,
and the largest cluster (16 CTAs) at a tiny shape; not its speed or its
behaviour under real scheduling (tests/test_torch_cuda.py runs it on the
card).  The reference is ``hourglass_plain`` run in float64 on the same
float32 inputs, within rtol 1e-4 / atol 1e-4: the kernel sums in float32
in other orders (and the host compiler contracts to FMA), and the narrow
GraphNorm layers (down to 1 channel) magnify that rounding.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from building_gan_torch.models.grid_layers import GridHourglass
from building_gan_torch.ops import _build
from building_gan_torch.ops import hourglass as hg

EMU_HEADER = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
using std::min;
using std::max;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return float4{a, b, c, d}; }
inline float2 make_float2(float a, float b) { return float2{a, b}; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline double rsqrt(double v) { return 1.0 / std::sqrt(v); }
// One block: its barrier, its warps' barriers and exchange buffer, its own
// dynamic shared memory.  A cluster: its blocks and a barrier over all their
// threads.  Every CUDA thread is a std::thread that knows its block.
constexpr size_t kEmuSmem = 256 * 1024;
struct EmuBlock {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
  uint64_t xchg[1024];
  alignas(16) unsigned char smem[kEmuSmem];
};
struct EmuCluster {
  std::vector<EmuBlock*> blocks;
  std::unique_ptr<std::barrier<>> bar;
};
inline thread_local dim3 threadIdx, blockIdx;
inline thread_local EmuBlock* emu_block = nullptr;
inline thread_local EmuCluster* emu_cluster = nullptr;
inline thread_local unsigned emu_rank = 0;
inline dim3 blockDim, gridDim;
inline void __syncthreads() { emu_block->bar->arrive_and_wait(); }
// Warps: 32 consecutive threads share a barrier and an exchange buffer, so a
// shuffle or a ballot is a write, a warp barrier, a read and a second barrier.
// Every lane of the warp must take part, as __shfl_*_sync with a full mask asks.
inline void __syncwarp(unsigned = 0xffffffffu) { emu_block->warp_bar[threadIdx.x / 32]->arrive_and_wait(); }
template <class T>
inline T emu_exchange(T v, int src_lane) {
  static_assert(sizeof(T) <= 8, "emulated shuffle of a wider type");
  const int lane = threadIdx.x % 32, base = threadIdx.x - lane;
  uint64_t bits = 0;
  __builtin_memcpy(&bits, &v, sizeof(T));
  emu_block->xchg[threadIdx.x] = bits;
  __syncwarp();
  bits = emu_block->xchg[base + (src_lane & 31)];
  __syncwarp();
  T out;
  __builtin_memcpy(&out, &bits, sizeof(T));
  return out;
}
template <class T> inline T __shfl_xor_sync(unsigned, T v, int m) { return emu_exchange(v, (int)(threadIdx.x % 32) ^ m); }
template <class T> inline T __shfl_sync(unsigned, T v, int src) { return emu_exchange(v, src); }
template <class T> inline T __shfl_down_sync(unsigned, T v, int d) {
  const int lane = threadIdx.x % 32;
  T o = emu_exchange(v, lane + d < 32 ? lane + d : lane);
  return o;
}
inline unsigned __ballot_sync(unsigned, int pred) {
  const int lane = threadIdx.x % 32, base = threadIdx.x - lane;
  emu_block->xchg[threadIdx.x] = pred ? 1 : 0;
  __syncwarp();
  unsigned out = 0;
  for (int l = 0; l < 32; ++l) out |= (unsigned)emu_block->xchg[base + l] << l;
  __syncwarp();
  return out;
}
// Dynamic shared memory: `extern __shared__ T name[];` becomes a pointer to the block's own.
inline unsigned char* emu_dyn_smem() { return emu_block->smem; }
typedef void* cudaStream_t;
enum cudaError_t {
  cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9,
  cudaErrorInvalidDevice = 101, cudaErrorMisalignedAddress = 716,
};
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 132; return cudaSuccess; }
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8, cudaFuncAttributeNonPortableClusterSizeAllowed = 12,
};
template <class K> inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute a, int v) {
  return a != cudaFuncAttributeMaxDynamicSharedMemorySize || v <= (int)kEmuSmem ? cudaSuccess
                                                                                : cudaErrorInvalidValue;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct { struct { unsigned x, y, z; } clusterDim; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
// Occupancy: every cluster at once, a CTA an SM.
template <class K>
inline cudaError_t cudaOccupancyMaxActiveClusters(int* n, K, const cudaLaunchConfig_t*) { *n = 1 << 20; return cudaSuccess; }
template <class K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) { *n = 1; return cudaSuccess; }
// Runs the blocks of a cluster at once: nblocks * threads std::threads.  Each
// block's shared memory starts as `fill` bytes (0xff: every float a NaN).
template <class K, class... A>
void emu_run_cluster(dim3 first, unsigned nblocks, int threads, unsigned char fill, K kernel, A... args) {
  const int warps = (threads + 31) / 32;
  EmuCluster cl;
  std::vector<std::unique_ptr<EmuBlock>> own;
  for (unsigned b = 0; b < nblocks; ++b) {
    own.emplace_back(new EmuBlock());
    EmuBlock* blk = own.back().get();
    std::memset(blk->smem, fill, kEmuSmem);
    blk->bar.reset(new std::barrier<>(threads));
    for (int w = 0; w < warps; ++w) blk->warp_bar.emplace_back(new std::barrier<>(min(32, threads - 32 * w)));
    cl.blocks.push_back(blk);
  }
  cl.bar.reset(new std::barrier<>(threads * (int)nblocks));
  std::vector<std::thread> ts;
  for (unsigned b = 0; b < nblocks; ++b)
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([=, &cl] {
        threadIdx = dim3(t);
        blockIdx = dim3(first.x + b, first.y, first.z);
        emu_block = cl.blocks[b];
        emu_cluster = &cl;
        emu_rank = b;
        kernel(args...);
      });
  for (auto& th : ts) th.join();
}
// kernel<<<grid, threads, smem, s>>>(...): blocks one after another.
template <class K, class... A>
void emu_launch(dim3 grid, int threads, K kernel, A... args) {
  gridDim = grid;
  blockDim = dim3(threads);
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) emu_run_cluster(dim3(bx, by), 1, threads, 0, kernel, args...);
}
// cudaLaunchKernelEx with a cluster dimension: the clusters one after another,
// the blocks of each at once, each with its own dynamic shared memory, which
// starts as NaNs so that a read of what the kernel never wrote shows.
template <class... P, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(P...), A&&... args) {
  unsigned cx = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) cx = cfg->attrs[i].val.clusterDim.x;
  if (cx < 1 || cfg->gridDim.x % cx != 0 || cfg->dynamicSmemBytes > kEmuSmem) return cudaErrorInvalidConfiguration;
  gridDim = cfg->gridDim;
  blockDim = cfg->blockDim;
  for (unsigned by = 0; by < cfg->gridDim.y; ++by)
    for (unsigned bx = 0; bx < cfg->gridDim.x; bx += cx)
      emu_run_cluster(dim3(bx, by), cx, (int)cfg->blockDim.x, 0xff, kernel, P(args)...);
  return cudaSuccess;
}
"""

# cuda_bf16.h's storage type and its two conversions (round to nearest even).
EMU_BF16_HEADER = r"""
#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { std::uint16_t bits; };
inline float __bfloat162float(__nv_bfloat16 b) {
  const std::uint32_t u = (std::uint32_t)b.bits << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  std::uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(std::uint16_t)((u >> 16) | 0x40u)};  // NaN
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(std::uint16_t)(u >> 16)};
}
"""

# cuda_fp16.h's storage type and its two conversions, through the host compiler's
# _Float16 (IEEE binary16, round to nearest even, subnormals, overflow to inf).
EMU_FP16_HEADER = r"""
#pragma once
#include <cstdint>
#include <cstring>
struct __half { std::uint16_t bits; };
inline float __half2float(__half h) {
  _Float16 f;
  std::memcpy(&f, &h.bits, 2);
  return (float)f;
}
inline __half __float2half_rn(float f) {
  const _Float16 h = (_Float16)f;
  __half out;
  std::memcpy(&out.bits, &h, 2);
  return out;
}
"""

# cooperative_groups' cluster API over the emulated cluster.
EMU_CG_HEADER = r"""
#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct cluster_group {
  void sync() const { emu_cluster->bar->arrive_and_wait(); }
  unsigned block_rank() const { return emu_rank; }
  unsigned num_blocks() const { return (unsigned)emu_cluster->blocks.size(); }
  template <class T> T* map_shared_rank(T* p, unsigned rank) const {
    const std::ptrdiff_t off = reinterpret_cast<unsigned char*>(p) - emu_block->smem;
    return reinterpret_cast<T*>(emu_cluster->blocks[rank]->smem + off);
  }
};
inline cluster_group this_cluster() { return cluster_group{}; }
}  // namespace cooperative_groups
"""

# `name<<<grid, threads, smem, s>>>(` -> `emu_launch(grid, threads, name, ` (templates too),
# and `extern __shared__ T name[];` -> a pointer into the emulated dynamic shared memory.
LAUNCH_RE = r"([\w:]+(?:<[^<>]*>)?)<<<([^,]+), ([^,]+), ([^,]+), s>>>\("
DYN_SMEM_RE = r"extern __shared__ (?:__align__\(\d+\) )?(\w+) (\w+)\[\];"


def emulated_source(src: str):
    """(source with CUDA launches and dynamic shared memory rewritten, number of launches)."""
    src = re.sub(DYN_SMEM_RE, r"\1* const \2 = reinterpret_cast<\1*>(emu_dyn_smem());", src)
    return re.subn(LAUNCH_RE, r"emu_launch(\2, \3, \1, ", src)


@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++) for the CPU emulation")
    d = tmp_path_factory.mktemp("cuda_emu")
    (d / "cuda_runtime.h").write_text(EMU_HEADER)
    (d / "cuda_bf16.h").write_text(EMU_BF16_HEADER)
    (d / "cuda_fp16.h").write_text(EMU_FP16_HEADER)
    (d / "cooperative_groups.h").write_text(EMU_CG_HEADER)
    with open(f"{_build.CSRC}/hourglass.cu") as f:
        raw = f.read()
    # The blocks of a cluster run at once here, each with its own dynamic shared
    # memory; a static __shared__ array would be one array for all of them.
    assert not re.search(r"^\s*(?:static )?__shared__", raw, re.M)
    src, n = emulated_source(raw)
    assert n == 0 and raw.count("cudaLaunchKernelEx(") == 1  # one launch a call, with clusters
    (d / "hourglass_emu.cpp").write_text(src)
    so = d / "libhourglass_emu.so"
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas",
         f"-I{d}", "-o", str(so), str(d / "hourglass_emu.cpp")],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(so))
    hg._bind(lib)
    return lib


def _run(lib, x, mask, Ws, atts, vecs, chans, gid, K, cluster):
    B, F, Y, X, cmax = x.shape
    L = len(chans)
    out = torch.full_like(x, float("nan"))  # every element must be written
    storage = hg.storage_code(x)
    vlast = torch.full(x.shape, float("nan")) if storage else None
    g = None if gid is None else gid.to(torch.int32).contiguous()
    chans_c = (ctypes.c_int * (2 * L))(*[c for pair in chans for c in pair])
    rc = lib.hg_forward(
        x.data_ptr(), mask.data_ptr(), None if g is None else g.data_ptr(), K,
        Ws.data_ptr(), atts.data_ptr(), vecs.data_ptr(), chans_c, L,
        B, F, Y, X, cmax, 0.2, 1e-5, out.data_ptr(), None if vlast is None else vlast.data_ptr(),
        storage, cluster, None, None,
    )
    assert rc == 0
    return out


# (B, F, Y, X, hidden, repeat, K, cluster); cluster 0 is the kernel's own choice.
CASES = {
    "k1_two_tiles": (3, 3, 5, 6, 16, 2, 1, 0),
    "k3_three_tiles": (2, 4, 5, 7, 32, 3, 3, 0),
    "k1_odd_grid": (2, 2, 9, 9, 8, 1, 1, 0),
    # R = 80 over 4 CTAs of 20 rows: the +-Y*X (20) halo lies in the next CTA
    "k1_halo_next_cta": (2, 4, 4, 5, 32, 3, 1, 4),
    # R = 90 over 7 CTAs of 13 rows (the last 12): the +-Y*X (30) halo lies two
    # and three CTAs away; two buildings a slot
    "k2_halo_two_ctas_uneven": (2, 3, 5, 6, 16, 2, 2, 7),
    # every width of the config of record's schedule, 128 -> 1 -> 128, over 3 CTAs
    "k1_widths_1_to_128": (2, 2, 3, 4, 128, 7, 1, 3),
    # widths that are no multiple of 4 (12 -> 6 -> 3 -> 6 -> 12), K = 3
    "k3_widths_not_multiple_of_4": (2, 3, 4, 4, 12, 2, 3, 5),
    # a padded width that is no multiple of 4 (x and out read and written by element)
    "k1_cmax_6": (2, 2, 4, 5, 6, 1, 1, 2),
    # one CTA of 300 rows: the 32-wide layers' GEMM takes two passes of 256 rows
    "k1_two_row_passes": (1, 3, 10, 10, 32, 2, 1, 1),
    # the largest cluster, 16 CTAs of 3 rows for R = 40: the last two own no row
    "k4_gid_cluster_16": (2, 2, 4, 5, 16, 2, 4, 16),
}


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_kernel_matches_plain(emulated_lib, case):
    x, mask, Ws, atts, vecs, chans, gid, K, cluster = _emulated_case(case)
    want = hg.hourglass_plain(x.double(), mask, Ws.double(), atts.double(), vecs.double(), chans,
                              gid, K).float()
    got = _run(emulated_lib, x, mask, Ws, atts, vecs, chans, gid, K, cluster)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _emulated_case(case):
    """(x, mask, Ws, atts, vecs, chans, gid, K, cluster) of a CASES entry."""
    B, F, Y, X, hidden, repeat, K, cluster = CASES[case]
    rng = np.random.default_rng(hidden + K)
    torch.manual_seed(hidden + K)
    enc = GridHourglass(hidden, repeat)
    with torch.no_grad():
        for conv, norm in enc.layers():
            conv.bias.uniform_(-0.3, 0.3)
            norm.weight.uniform_(0.5, 1.5)
            norm.bias.uniform_(-0.3, 0.3)
            norm.mean_scale.uniform_(0.5, 1.5)
        Ws, atts, vecs = hg.pack_gat_weights(enc)
    chans = hg.hourglass_channel_pairs(hidden, repeat)
    mask = torch.from_numpy((rng.random((B, F, Y, X)) < 0.7).astype(np.float32))
    gid = torch.from_numpy(rng.integers(0, K, (B, F, Y, X))) if K > 1 else None
    x = torch.from_numpy(rng.normal(size=(B, F, Y, X, hidden)).astype(np.float32))
    return x, mask, Ws, atts, vecs, chans, gid, K, cluster


@pytest.mark.parametrize("case", ["k3_widths_not_multiple_of_4", "k1_cmax_6", "k2_halo_two_ctas_uneven"])
def test_emulated_bf16_kernel_matches_plain(emulated_lib, case):
    """bf16 storage: x read as bf16, each layer's output rounded to bf16, out written
    in bf16 (the last layer's v in the f32 buffer).  Held against hourglass_plain in
    f64 without rounding: the kernel's error within twice the plain bf16 twin's own
    (its rounding is the error) plus 1e-4."""
    _hold_16bit(emulated_lib, case, torch.bfloat16)


@pytest.mark.parametrize("case", ["k3_widths_not_multiple_of_4", "k1_cmax_6", "k2_halo_two_ctas_uneven"])
def test_emulated_f16_kernel_matches_plain(emulated_lib, case):
    """f16 storage, as bf16 storage above: the kernel's error from the unrounded f64
    stack within twice the plain f16 twin's own plus 1e-4."""
    _hold_16bit(emulated_lib, case, torch.float16)


def _hold_16bit(emulated_lib, case, dtype):
    x, mask, Ws, atts, vecs, chans, gid, K, cluster = _emulated_case(case)
    x = x.to(dtype)
    exact = hg.hourglass_plain(x.double(), mask, Ws.double(), atts.double(), vecs.double(), chans,
                               gid, K)
    twin = hg.hourglass_plain(x, mask, Ws, atts, vecs, chans, gid, K)
    got = _run(emulated_lib, x, mask, Ws, atts, vecs, chans, gid, K, cluster)
    assert got.dtype == twin.dtype == dtype and torch.isfinite(got.float()).all()
    err = (got.double() - exact).abs().max().item()
    twin_err = (twin.double() - exact).abs().max().item()
    assert twin_err > 0  # the rounding is there
    assert err <= 2.0 * twin_err + 1e-4, (err, twin_err)


def test_emulated_cluster_choice(emulated_lib):
    """The kernel's cluster choice, under the emulation's occupancy (every cluster at
    once, a CTA an SM, 132 SMs): the fewest rows a CTA, down to 64; and its limits."""
    lib = emulated_lib
    chans = hg.hourglass_channel_pairs(128, 7)
    cc, L = hg.c_chans(chans), len(chans)
    R = 11 * 12 * 12
    # the config of record's widths need 196 floats a row: 6 CTAs of 264 rows at the least
    assert lib.hg_smem_bytes(R, 128, 1, cc, L, 6) <= 232448 < lib.hg_smem_bytes(R, 128, 1, cc, L, 5)
    assert lib.hg_cluster_size(16, R, 128, 1, cc, L) == 16
    assert lib.hg_cluster_size(16, 4448, 128, 1, cc, L) == 16
    assert lib.hg_cluster_size(16, 4449, 128, 1, cc, L) == 0
    small = hg.hourglass_channel_pairs(16, 2)
    assert lib.hg_cluster_size(3, 90, 16, 1, hg.c_chans(small), len(small)) == 2
