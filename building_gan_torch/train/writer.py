"""The trainer's scalar log: TensorBoard when tensorboardX is installed, JSON lines otherwise.

``make_writer(log_dir)`` gives ``tensorboardX.SummaryWriter`` where the
package imports, else a ``JsonlScalarWriter``: the same calls
(``add_text``, ``add_scalar``, ``add_histogram_raw``, ``close``), each
appended as one JSON object a line to ``log_dir/scalars.jsonl``, so a run on
a machine without tensorboardX still records its curves.  A resumed run
appends to the same file.
"""

from __future__ import annotations

import json
import os

JSONL_FILE = "scalars.jsonl"


class JsonlScalarWriter:
    """Appends ``{"kind", "tag", "step", ...}`` lines to ``log_dir/scalars.jsonl``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, JSONL_FILE)
        self._f = open(self.path, "a")

    def _put(self, record: dict) -> None:
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def add_text(self, tag: str, text_string: str, global_step=None) -> None:
        self._put({"kind": "text", "tag": tag, "step": global_step, "text": text_string})

    def add_scalar(self, tag: str, scalar_value, global_step=None) -> None:
        self._put({"kind": "scalar", "tag": tag, "step": global_step,
                   "value": float(scalar_value)})

    def add_histogram_raw(self, tag: str, min, max, num, sum, sum_squares, bucket_limits,  # noqa: A002
                          bucket_counts, global_step=None) -> None:
        self._put({"kind": "histogram", "tag": tag, "step": global_step, "min": float(min),
                   "max": float(max), "num": int(num), "sum": float(sum),
                   "sum_squares": float(sum_squares), "bucket_limits": list(bucket_limits),
                   "bucket_counts": list(bucket_counts)})

    def close(self) -> None:
        self._f.close()


def make_writer(log_dir: str):
    """``tensorboardX.SummaryWriter(log_dir)`` if tensorboardX imports, else a
    ``JsonlScalarWriter(log_dir)``."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return JsonlScalarWriter(log_dir)
    return SummaryWriter(log_dir=log_dir)


def read_jsonl(log_dir: str) -> list:
    """The records a ``JsonlScalarWriter`` wrote under ``log_dir``, in order."""
    with open(os.path.join(log_dir, JSONL_FILE)) as f:
        return [json.loads(line) for line in f if line.strip()]
