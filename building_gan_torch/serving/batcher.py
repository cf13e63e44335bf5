"""Dynamic micro-batcher: size-or-deadline batch formation (pure Python).

The same semantics as ``building_gan_tpu/serving/batcher.py::PyBatcher``:
threads ``submit`` request ids and block in ``wait``; one executor thread
drains ``next_batch``, which closes a batch when it holds ``max_batch`` ids
or when its oldest request has waited ``max_delay_us``; ``complete`` wakes
the waiters.  ``shutdown`` makes every blocked call return or raise.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List


class PyBatcher:
    """Thread-safe request queue with size-or-deadline batching."""

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
