"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file has a plain C interface (``extern "C"``) and is
compiled on first use into ``building_gan_torch/_build/lib<name>-<hash>.so``
(the hash is of the source and the flags, so an edited source rebuilds).  No
PyTorch headers and no ninja are involved: a build takes seconds.  The
directory is listed in ``.gitignore``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict = {}
build_log: dict = {}  # name -> (seconds, ptxas summary lines)


def find_nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set NVCC or CUDA_HOME, or put nvcc on PATH")


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source exists."""
    out = _lib_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log[-4000:]}")
    os.replace(tmp, out)
    build_log[name] = (seconds, [ln.strip() for ln in log.splitlines() if "registers" in ln])
    return out


def load(name: str) -> ctypes.CDLL:
    """Build if needed, then load ``lib<name>`` once per process."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(build(name))
        return _libs[name]
