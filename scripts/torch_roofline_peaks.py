"""Measure one NVIDIA GPU's attainable peaks for the port's roofline model.

The counterpart of ``scripts/roofline_peaks.py``, for
``building_gan_torch/utils/roofline.py`` (whose defaults are the H100's
published peaks).  Each rate is timed with CUDA events around a chain of
launches after a warm-up, and keyed as the roofline model's peaks dict:

- hbm_gbps: a stream, ``torch.mul(x, 2 or 0.5, out=y)`` over 512 MiB of bf16
  back and forth; bytes = 2 x the array a launch (one read, one write);
- vpu_gops: an f32 FMA chain, ``y = y * y + 0.25`` (fixed point 0.5, not
  foldable), 8 independent chains a thread so the pipes stay full; an FMA
  counts as two ops, as the model counts work;
- trans_gops: an ``exp`` chain, ``y = __expf(-y)`` (fixed point ~0.567),
  one transcendental an iteration;
- mxu_tflops: a chain of bf16 8192^3 matmuls (``torch.matmul``, f32
  accumulation); 2 m^3 flops each.

The FMA and exp chains are a small CUDA source compiled here with nvcc
(``building_gan_torch/ops/_build.py``'s flags) into a temporary directory and
loaded with ctypes.  Also printed: the card's name and power limit and its
maximum SM clock (``nvidia-smi``), and the transcendental rate the CUDA C++
Programming Guide implies for compute capability 9.0 at that clock (16
results a clock an SM).

    python scripts/torch_roofline_peaks.py   # one JSON line
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>
#define CHAINS 8

__global__ void fma_chain(float* x, long n, int k) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i * CHAINS >= n) return;
    float y[CHAINS];
    #pragma unroll
    for (int c = 0; c < CHAINS; ++c) y[c] = x[i * CHAINS + c];
    for (int it = 0; it < k; ++it) {
        #pragma unroll
        for (int c = 0; c < CHAINS; ++c) y[c] = fmaf(y[c], y[c], 0.25f);
    }
    #pragma unroll
    for (int c = 0; c < CHAINS; ++c) x[i * CHAINS + c] = y[c];
}

__global__ void exp_chain(float* x, long n, int k) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i * CHAINS >= n) return;
    float y[CHAINS];
    #pragma unroll
    for (int c = 0; c < CHAINS; ++c) y[c] = x[i * CHAINS + c];
    for (int it = 0; it < k; ++it) {
        #pragma unroll
        for (int c = 0; c < CHAINS; ++c) y[c] = __expf(-y[c]);
    }
    #pragma unroll
    for (int c = 0; c < CHAINS; ++c) x[i * CHAINS + c] = y[c];
}

extern "C" int launch_chain(int which, float* x, long n, int k, void* stream) {
    int threads = 256;
    long blocks = (n / CHAINS + threads - 1) / threads;
    if (which == 0)
        fma_chain<<<blocks, threads, 0, (cudaStream_t)stream>>>(x, n, k);
    else
        exp_chain<<<blocks, threads, 0, (cudaStream_t)stream>>>(x, n, k);
    return (int)cudaGetLastError();
}
"""


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def events_ms(fn, reps: int) -> float:
    """Device ms of ``reps`` calls of fn, CUDA events around them, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def load_chains(workdir: str):
    from building_gan_torch.ops._build import NVCC_FLAGS, find_nvcc

    src, lib = os.path.join(workdir, "peaks.cu"), os.path.join(workdir, "libpeaks.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", lib, src], check=True, capture_output=True,
                   timeout=300)
    chains = ctypes.CDLL(lib)
    chains.launch_chain.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
                                    ctypes.c_void_p]
    chains.launch_chain.restype = ctypes.c_int
    return chains


def chain_rate(chains, which: int, n: int, k: int, reps: int, ops_per_iter: float) -> float:
    """G ops/s of the FMA (0) or exp (1) chain over n f32 values, k iterations a launch."""
    x = torch.full((n,), 0.5, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = chains.launch_chain(which, x.data_ptr(), n, k, stream)
        if err:
            raise RuntimeError(f"chain launch failed: CUDA error {err}")

    ms = events_ms(launch, reps)
    if not torch.isfinite(x).all().item():
        raise AssertionError("the chain diverged")
    return ops_per_iter * k * n * reps / (ms / 1e3) / 1e9


def hbm_stream(n_bytes: int = 512 * 2**20, reps: int = 64) -> float:
    n = n_bytes // 2
    a = torch.full((n,), 0.5, device="cuda", dtype=torch.bfloat16)
    b = torch.empty_like(a)

    def there_and_back():
        torch.mul(a, 2.0, out=b)
        torch.mul(b, 0.5, out=a)

    ms = events_ms(there_and_back, reps // 2)
    return 2.0 * n * 2 * reps / (ms / 1e3) / 1e9


def matmul_rate(m: int = 8192, reps: int = 20) -> float:
    a = torch.randn(m, m, device="cuda", dtype=torch.bfloat16)
    b = torch.randn(m, m, device="cuda", dtype=torch.bfloat16)
    c = torch.empty(m, m, device="cuda", dtype=torch.bfloat16)
    ms = events_ms(lambda: torch.matmul(a, b, out=c), reps)
    return 2.0 * m**3 * reps / (ms / 1e3) / 1e12


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_roofline_peaks: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory() as work:
        chains = load_chains(work)
        n = 132 * 2048 * 8 * 8  # many resident threads a SM, 8 chains each
        out = {
            "hbm_gbps": hbm_stream(),
            "vpu_gops": chain_rate(chains, 0, n, 4096, 5, 2.0),
            "trans_gops": chain_rate(chains, 1, n, 1024, 5, 1.0),
            "mxu_tflops": matmul_rate(),
        }
    out.update({
        "card": card, "sms": sms, "clocks_max_sm_mhz": clock_mhz,
        "trans_gops_guide": 16 * sms * clock_mhz / 1e3,
    })
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
