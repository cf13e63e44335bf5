"""The trainer's scalar log: TensorBoard when tensorboardX is installed, JSON lines otherwise.

``make_writer(log_dir)`` gives ``tensorboardX.SummaryWriter`` where the
package imports, else a ``JsonlScalarWriter``: the same calls
(``add_text``, ``add_scalar``, ``add_histogram_raw``, ``add_image``,
``close``), each appended as one JSON object a line to
``log_dir/scalars.jsonl``, so a run on a machine without tensorboardX still
records its curves.  An image (CHW uint8, the trainer's best-epoch render)
is saved as ``log_dir/images/{tag}_{step}.npy`` beside its record, which
keeps Pillow out of the writer.  A resumed run appends to the same file.
``NullWriter`` takes the same calls and writes nothing: a data-parallel
rank other than 0 logs through it.
"""

from __future__ import annotations

import json
import os

import numpy as np

JSONL_FILE = "scalars.jsonl"
IMAGE_DIR = "images"


class JsonlScalarWriter:
    """Appends ``{"kind", "tag", "step", ...}`` lines to ``log_dir/scalars.jsonl``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
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

    def add_image(self, tag: str, img_tensor, global_step=None) -> None:
        """Save a CHW uint8 image as ``images/{tag}_{step}.npy`` (the record's ``file``,
        relative to the log dir)."""
        img = np.asarray(img_tensor)
        name = os.path.join(IMAGE_DIR, f"{tag}_{global_step}.npy")
        os.makedirs(os.path.join(self.log_dir, IMAGE_DIR), exist_ok=True)
        np.save(os.path.join(self.log_dir, name), img)
        self._put({"kind": "image", "tag": tag, "step": global_step, "file": name,
                   "shape": list(img.shape)})

    def close(self) -> None:
        self._f.close()


class NullWriter:
    """The writer's calls, each doing nothing."""

    def _none(self, *args, **kwargs) -> None:
        return None

    add_text = add_scalar = add_histogram_raw = add_image = close = _none


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
