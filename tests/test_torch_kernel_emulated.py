"""The CUDA hourglass kernel's own code, run on the CPU under an emulation.

There is no nvcc here, so ``csrc/hourglass.cu`` is compiled with the host
C++ compiler against a small stand-in for ``cuda_runtime.h``: every CUDA
thread of a block is a ``std::thread``, ``__syncthreads`` is a
``std::barrier``, ``__shared__`` arrays are shared by the block's threads,
and blocks run one after another.  Warps are 32 consecutive threads with a
barrier and an exchange buffer of their own, so ``__shfl_*_sync``,
``__ballot_sync`` and ``__syncwarp`` work; ``extern __shared__`` (dynamic
shared memory) points into one static buffer; ``cudaFuncSetAttribute``
accepts sizes up to that buffer's.  Each ``kernel<<<grid, threads, smem,
s>>>(`` launch (templates too) becomes ``emu_launch(grid, threads, kernel,
...)`` (``emulated_source``).  The library is then driven through the same
ctypes binding as on the card and compared with the plain PyTorch version.

This checks the kernel's indexing, masks, tiling, partial statistics and
layer loop (multi-tile rows, K=1 and K>1), not its speed or its behaviour
under real warp scheduling; tests/test_torch_cuda.py runs it on the card.
Tolerance rtol 1e-4 / atol 1e-4: f32 sums in other orders (and FMA
contraction by the host compiler) through narrow GraphNorm layers.
"""

import ctypes
import math
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
inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim, gridDim;
inline std::barrier<>* emu_bar = nullptr;
inline void __syncthreads() { emu_bar->arrive_and_wait(); }
// Warps: 32 consecutive threads share a barrier and an exchange buffer, so a
// shuffle or a ballot is a write, a warp barrier, a read and a second barrier.
// Every lane of the warp must take part, as __shfl_*_sync with a full mask asks.
inline std::vector<std::barrier<>*> emu_warp_bar;
inline uint64_t emu_xchg[1024];
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp_bar[threadIdx.x / 32]->arrive_and_wait(); }
template <class T>
inline T emu_exchange(T v, int src_lane) {
  static_assert(sizeof(T) <= 8, "emulated shuffle of a wider type");
  const int lane = threadIdx.x % 32, base = threadIdx.x - lane;
  uint64_t bits = 0;
  __builtin_memcpy(&bits, &v, sizeof(T));
  emu_xchg[threadIdx.x] = bits;
  __syncwarp();
  bits = emu_xchg[base + (src_lane & 31)];
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
  emu_xchg[threadIdx.x] = pred ? 1 : 0;
  __syncwarp();
  unsigned out = 0;
  for (int l = 0; l < 32; ++l) out |= (unsigned)emu_xchg[base + l] << l;
  __syncwarp();
  return out;
}
// Dynamic shared memory: `extern __shared__ T name[];` becomes a pointer into this buffer.
alignas(16) inline unsigned char emu_dyn_smem[256 * 1024];
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class K> inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int v) {
  return v <= (int)sizeof(emu_dyn_smem) ? cudaSuccess : cudaErrorInvalidValue;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
template <class K, class... A>
void emu_launch(dim3 grid, int threads, K kernel, A... args) {
  gridDim = grid;
  blockDim = dim3(threads);
  const int warps = (threads + 31) / 32;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = dim3(bx, by);
      std::barrier<> bar(threads);
      emu_bar = &bar;
      std::vector<std::barrier<>*> wb;
      for (int w = 0; w < warps; ++w) wb.push_back(new std::barrier<>(min(32, threads - 32 * w)));
      emu_warp_bar = wb;
      std::vector<std::thread> ts;
      for (int t = 0; t < threads; ++t)
        ts.emplace_back([=] { threadIdx = dim3(t); kernel(args...); });
      for (auto& th : ts) th.join();
      for (auto* b : wb) delete b;
    }
}
"""

# `name<<<grid, threads, smem, s>>>(` -> `emu_launch(grid, threads, name, ` (templates too),
# and `extern __shared__ T name[];` -> a pointer into the emulated dynamic shared memory.
LAUNCH_RE = r"([\w:]+(?:<[^<>]*>)?)<<<([^,]+), ([^,]+), ([^,]+), s>>>\("
DYN_SMEM_RE = r"extern __shared__ (?:__align__\(\d+\) )?(\w+) (\w+)\[\];"


def emulated_source(src: str):
    """(source with CUDA launches and dynamic shared memory rewritten, number of launches)."""
    src = re.sub(DYN_SMEM_RE, r"static \1* const \2 = reinterpret_cast<\1*>(emu_dyn_smem);", src)
    return re.subn(LAUNCH_RE, r"emu_launch(\2, \3, \1, ", src)


@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++) for the CPU emulation")
    d = tmp_path_factory.mktemp("cuda_emu")
    (d / "cuda_runtime.h").write_text(EMU_HEADER)
    with open(f"{_build.CSRC}/hourglass.cu") as f:
        src, n = emulated_source(f.read())
    assert n == 3
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


def _run(lib, x, mask, Ws, atts, vecs, chans, gid, K):
    B, F, Y, X, cmax = x.shape
    R, L = F * Y * X, len(chans)
    T = math.ceil(R / hg.TILE_ROWS)
    out, h, v = (torch.full_like(x, float("nan")) for _ in range(3))  # stale scratch
    scores, part, cnt = torch.empty(2, B, R), torch.empty(B, T, K, 2, cmax), torch.empty(B, T, K)
    g = None if gid is None else gid.to(torch.int32).contiguous()
    chans_c = (ctypes.c_int * (2 * L))(*[c for pair in chans for c in pair])
    rc = lib.hg_forward(
        x.data_ptr(), mask.data_ptr(), None if g is None else g.data_ptr(), K,
        Ws.data_ptr(), atts.data_ptr(), vecs.data_ptr(), chans_c, L,
        B, F, Y, X, cmax, 0.2, 1e-5,
        out.data_ptr(), h.data_ptr(), v.data_ptr(), scores.data_ptr(),
        part.data_ptr(), cnt.data_ptr(), None,
    )
    assert rc == 0
    return out


@pytest.mark.parametrize(
    "B,F,Y,X,hidden,repeat,K",
    [(3, 3, 5, 6, 16, 2, 1), (2, 4, 5, 7, 32, 3, 3), (2, 2, 9, 9, 8, 1, 1)],
    ids=["k1_two_tiles", "k3_three_tiles", "k1_odd_grid"],
)
def test_emulated_kernel_matches_plain(emulated_lib, B, F, Y, X, hidden, repeat, K):
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
    want = hg.hourglass_plain(x, mask, Ws, atts, vecs, chans, gid, K)
    got = _run(emulated_lib, x, mask, Ws, atts, vecs, chans, gid, K)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
