"""Build the port's native sources and load them with ``ctypes``.

Each ``csrc/*.cu`` file (``hourglass``, ``gat_train``) has a plain C
interface (``extern "C"``) and is compiled with ``nvcc`` on first use into
``building_gan_torch/_build/lib<name>-<hash>.so`` (the hash is of the source,
the shared ``csrc/*.cuh`` headers and the flags, so an edited source
rebuilds).  ``build_all`` starts one nvcc for each source, all at once.  No
PyTorch headers and no ninja are involved: a build takes seconds.

The host runtime's ``native/*.cc`` files (``buildingjson``, the JSON parser
of ``data/preprocess.py``; ``batcher``, the server's micro-batcher) are
compiled the same way with the host C++ compiler (``$CXX``, ``g++`` or
``c++``; ``build_host`` / ``load_host``), into the same directory, which is
listed in ``.gitignore``.  A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
NATIVE = os.path.join(_PKG, "native")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

HOST_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")
HOST_EXTRA_FLAGS = {"buildingjson": (), "batcher": ("-pthread",)}  # the host libraries

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


def find_cxx() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++`` or ``c++`` on PATH."""
    for cand in (os.environ.get("CXX"), shutil.which("g++"), shutil.which("c++")):
        if cand and (os.path.exists(cand) or shutil.which(cand)):
            return cand
    raise RuntimeError("no host C++ compiler: set CXX, or put g++ or c++ on PATH")


def _hashed_path(name: str, flags, sources) -> str:
    """``_build/lib<name>-<hash>.so``, the hash of the flags and the sources' bytes."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sources:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _lib_path(name: str) -> str:
    """Build path keyed by the source, the shared ``csrc/*.cuh`` headers and the flags."""
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    return _hashed_path(name, NVCC_FLAGS, [os.path.join(CSRC, f) for f in [f"{name}.cu"] + headers])


def _compile(cmd, tmp: str, out: str, name: str, log_name: str, what: str) -> str:
    """Run a compiler writing ``tmp``, keep its log, move ``tmp`` to ``out``; -> the log."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    log = proc.stdout + proc.stderr
    with open(os.path.join(BUILD_DIR, log_name), "w") as f:
        f.write(" ".join(cmd) + "\n" + log)
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed on {name} (exit {proc.returncode}):\n{log[-4000:]}")
    os.replace(tmp, out)
    return log


def _kernel_name(mangled: str) -> str:
    """Readable name of a mangled ``__global__`` function, in a namespace or not,
    with its template arguments: integers, bools and the storage type
    (``name<4, 2, float>``, ``name<true>``, ``name<__half>`` as ``name<f16>``)."""
    name, rest = mangled, ""
    m = re.match(r"_ZN(\d+)", mangled)  # _ZN <len><namespace> <len><name> E ...
    if m:
        pos = m.end() + int(m.group(1))
        m = re.match(r"\d+", mangled[pos:])
        if m:
            end = pos + m.end() + int(m.group(0))
            name, rest = mangled[pos + m.end(): end], mangled[end:]
    else:
        m = re.match(r"_Z(\d+)", mangled)
        if m:
            end = m.end() + int(m.group(1))
            name, rest = mangled[m.end(): end], mangled[end:]
    arg = r"Li(-?\d+)E|Lb([01])E|(f)|13(__nv_bfloat16)|6(__half)"
    t = re.match(rf"I((?:{arg})+)E", rest)  # template arguments
    if not t:
        return name
    args = []
    for i, b, f, bf, _ in re.findall(arg, t.group(1)):
        args.append(i if i else ("true" if b == "1" else "false") if b else "float" if f
                    else "bf16" if bf else "f16")
    return f"{name}<{', '.join(args)}>"


def ptxas_usage(log: str) -> list:
    """["kernel: Used N registers, M bytes smem, ..."] from ``nvcc -Xptxas -v`` output."""
    out, current, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            current, spill = _kernel_name(m.group(1)), ""
        elif "spill stores" in ln and current is not None:
            m = re.search(r"(\d+) bytes spill stores", ln)
            spill = f", {m.group(1)} bytes spilled" if m and m.group(1) != "0" else ""
        elif "registers" in ln and current is not None:
            out.append(f"{current}: {ln.split(':', 1)[-1].strip()}{spill}")
            current = None
    return out


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source exists."""
    out = _lib_path(name)
    if os.path.exists(out):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    t0 = time.perf_counter()
    log = _compile(cmd, tmp, out, f"{name}.cu", f"{name}.log", "nvcc")
    build_log[name] = (time.perf_counter() - t0, ptxas_usage(log))
    return out


def build_host(name: str) -> str:
    """Compile ``native/<name>.cc`` with the host compiler unless a build of this exact
    source and these flags exists: ``-O2 -std=c++17 -fPIC -shared`` (and ``-pthread``
    for the batcher)."""
    flags = HOST_FLAGS + HOST_EXTRA_FLAGS[name]
    src = os.path.join(NATIVE, f"{name}.cc")
    out = _hashed_path(name, flags, [src])
    if os.path.exists(out):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_cxx(), *flags, "-o", tmp, src]
    t0 = time.perf_counter()
    _compile(cmd, tmp, out, f"{name}.cc", f"{name}.host.log", "the host C++ compiler")
    build_log[name] = (time.perf_counter() - t0, [])
    return out


def build_all(names=("hourglass", "gat_train")) -> None:
    """Build several sources in parallel, one nvcc process each; raises on the first failure."""
    errors = []

    def one(name):
        try:
            build(name)
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def load(name: str) -> ctypes.CDLL:
    """Build if needed, then load ``lib<name>`` once per process."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(build(name))
        return _libs[name]


def load_host(name: str) -> ctypes.CDLL:
    """Build ``native/<name>.cc`` if needed, then load it once per process."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(build_host(name))
        return _libs[name]
