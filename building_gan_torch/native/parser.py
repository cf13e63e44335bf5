"""ctypes binding to the native C++ building-JSON parser (``buildingjson.cc``).

The reference spends its preprocessing time in Python ``json.load`` and
per-node Python loops.  The port's ``create_dataset`` parses each building's
three JSON files with this small C++ library instead (``use_native=True``, the
default, as in the JAX package): it validates a file and re-emits it as
compact JSON, numbers copied as written, which ``json.loads`` reads back to
the same values.  The library is compiled at first use by
``ops/_build.py::build_host``; a failed build or a failed parse raises.
"""

from __future__ import annotations

import ctypes
import json

_lib = None


def load():
    """Build (first use) and load the parser library; returns it bound, once per process."""
    global _lib
    if _lib is None:
        from ..ops import _build

        lib = _build.load_host("buildingjson")
        lib.bj_parse_file.restype = ctypes.c_char_p
        lib.bj_parse_file.argtypes = [ctypes.c_char_p]
        _lib = lib
    return _lib


def parse_file(path: str):
    """One JSON file through the native parser, as ``json.load`` would give it."""
    raw = load().bj_parse_file(path.encode())
    if not raw:
        raise RuntimeError(f"native JSON parse failed for {path}")
    return json.loads(raw)


def parse_triplet(global_path: str, local_path: str, voxel_path: str):
    """The three JSON files of one building: (global, local, voxel) data."""
    return tuple(parse_file(p) for p in (global_path, local_path, voxel_path))
