"""Dynamic micro-batcher: size-or-deadline batch formation.

Port of ``building_gan_tpu/serving/batcher.py``.  Threads ``submit``
request ids and block in ``wait``; one executor thread drains
``next_batch``, which closes a batch when it holds ``max_batch`` ids or when
its oldest request has waited ``max_delay_us``; ``complete`` wakes the
waiters.  ``shutdown`` makes every blocked call return or raise; ``close``
also frees what the batcher holds.

``NativeBatcher`` is the C++ batcher (``native/batcher.cc``, compiled at
first use by ``ops/_build.py::build_host``), which the server runs on;
``PyBatcher`` is its plain twin with the same semantics, which the tests
hold it against.  ``make_batcher`` builds the native one, and raises when it
cannot: there is no fallback to the Python one.
"""

from __future__ import annotations

import ctypes
import threading
import time
from collections import deque
from typing import List

_lib = None


def _load():
    """Build (first use) and load ``libbatcher``; returns it bound, once per process."""
    global _lib
    if _lib is None:
        from ..ops import _build

        lib = _build.load_host("batcher")
        i32, i64, p = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
        ids = ctypes.POINTER(ctypes.c_int64)
        lib.sb_create.restype = p
        lib.sb_create.argtypes = [i32, i64]
        lib.sb_destroy.argtypes = [p]
        lib.sb_shutdown.argtypes = [p]
        lib.sb_submit.restype = i32
        lib.sb_submit.argtypes = [p, i64]
        lib.sb_next_batch.restype = i32
        lib.sb_next_batch.argtypes = [p, ids, i32, i64]
        lib.sb_complete.argtypes = [p, ids, i32]
        lib.sb_wait.restype = i32
        lib.sb_wait.argtypes = [p, i64, i64]
        lib.sb_pending.restype = i32
        lib.sb_pending.argtypes = [p]
        _lib = lib
    return _lib


class NativeBatcher:
    """The C++ batcher behind a handle; ``close`` frees it (``sb_destroy`` first wakes
    and drains every thread blocked in it)."""

    def __init__(self, max_batch: int, max_delay_us: int):
        self._h = None
        self._lib = _load()
        self.max_batch = max_batch
        self._h = self._lib.sb_create(max_batch, max_delay_us)
        self._buf = (ctypes.c_int64 * max_batch)()  # next_batch's ids (one executor thread)

    def submit(self, request_id: int) -> None:
        if self._lib.sb_submit(self._handle(), request_id) != 0:
            raise RuntimeError("batcher is shut down")

    def next_batch(self, poll_timeout_us: int = 100_000) -> List[int]:
        """Up to ``max_batch`` ids; [] after an idle poll; StopIteration once shut down and drained."""
        n = self._lib.sb_next_batch(self._handle(), self._buf, self.max_batch, poll_timeout_us)
        if n < 0:
            raise StopIteration
        return list(self._buf[:n])

    def complete(self, ids: List[int]) -> None:
        self._lib.sb_complete(self._handle(), (ctypes.c_int64 * len(ids))(*ids), len(ids))

    def wait(self, request_id: int, timeout_us: int) -> None:
        rc = self._lib.sb_wait(self._handle(), request_id, timeout_us)
        if rc == -2:
            raise TimeoutError(f"request {request_id} timed out")
        if rc == -1:
            raise RuntimeError("batcher is shut down")

    def pending(self) -> int:
        return self._lib.sb_pending(self._handle())

    def shutdown(self) -> None:
        if self._h:
            self._lib.sb_shutdown(self._h)

    def close(self) -> None:
        """Shut down and free the native handle (drains blocked waiters first)."""
        h, self._h = self._h, None
        if h:
            self._lib.sb_destroy(h)

    def _handle(self):
        if not self._h:
            raise RuntimeError("batcher is closed")
        return self._h

    def __del__(self):  # last resort; close() is the API
        self.close()


class PyBatcher:
    """Thread-safe request queue with size-or-deadline batching, in Python: the plain twin
    of ``NativeBatcher``."""

    def __init__(self, max_batch: int, max_delay_us: int):
        self.max_batch = max_batch
        self.max_delay = max_delay_us / 1e6
        self._lock = threading.Condition()
        self._queue: deque = deque()  # (id, arrival time)
        self._done = set()
        self._shutdown = False

    def submit(self, request_id: int) -> None:
        with self._lock:
            if self._shutdown:
                raise RuntimeError("batcher is shut down")
            self._queue.append((request_id, time.monotonic()))
            self._lock.notify_all()

    def next_batch(self, poll_timeout_us: int = 100_000) -> List[int]:
        """Up to ``max_batch`` ids; [] after an idle poll; StopIteration once shut down and drained."""
        with self._lock:
            deadline = time.monotonic() + poll_timeout_us / 1e6
            while not self._queue and not self._shutdown:
                if not self._lock.wait(timeout=deadline - time.monotonic()):
                    if not self._queue:
                        if self._shutdown:
                            raise StopIteration
                        return []
            if self._shutdown and not self._queue:
                raise StopIteration
            close_at = self._queue[0][1] + self.max_delay
            while len(self._queue) < self.max_batch and not self._shutdown:
                remaining = close_at - time.monotonic()
                if remaining <= 0 or not self._lock.wait(timeout=remaining):
                    break
            out = []
            while self._queue and len(out) < self.max_batch:
                out.append(self._queue.popleft()[0])
            return out

    def complete(self, ids: List[int]) -> None:
        with self._lock:
            self._done.update(ids)
            self._lock.notify_all()

    def wait(self, request_id: int, timeout_us: int) -> None:
        with self._lock:
            deadline = time.monotonic() + timeout_us / 1e6
            while request_id not in self._done:
                if self._shutdown:
                    raise RuntimeError("batcher is shut down")
                if not self._lock.wait(timeout=deadline - time.monotonic()):
                    if request_id in self._done:
                        break
                    raise TimeoutError(f"request {request_id} timed out")
            self._done.discard(request_id)

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            self._lock.notify_all()

    def close(self) -> None:
        self.shutdown()


def make_batcher(max_batch: int, max_delay_us: int) -> NativeBatcher:
    """The server's batcher: ``NativeBatcher`` (built at first use; raises if it cannot be)."""
    return NativeBatcher(max_batch, max_delay_us)
