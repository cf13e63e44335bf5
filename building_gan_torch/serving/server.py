"""Batched inference server: dynamic micro-batching over the generator.

Port of ``building_gan_tpu/serving/server.py``:

- requests (one building each: LocalGraph + VoxelGraph + seed) arrive from
  any thread via :meth:`InferenceServer.infer`;
- the batcher forms micro-batches under a size-or-deadline policy: the C++
  ``NativeBatcher`` (``native/batcher.cc``, built at first use);
- one executor thread packs each micro-batch into a fixed-slot ``GridBatch``
  (always ``max_batch`` slots, so every batch has one shape) and runs the
  generator: a GATCONV generator with its hourglass fused
  (``models/fast_infer.py``: the CUDA kernel when the server's device is a
  GPU), a generator of any other conv as its plain module (the route read
  from ``GENERATOR_CONV_TYPE``, as the train step reads it);
- z and the Gumbel noise of a request come from a ``torch.Generator`` seeded
  by the request's seed, so a building's output does not depend on its
  batchmates (the fused kernel keeps slots apart and uses no atomics);
- the generator runs at ``COMPUTE_DTYPE`` (bf16 by default, or f32 or f16):
  the noise is drawn in f32 and cast on entry, the logits come back f32.

Results are per-voxel arrays in the request's own node order, with the
version of the weights that served them (``params_version``: 0, then one
more at each ``swap_params``).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ..config import NUM_CLASSES, Configuration
from ..data import grid as gridlib
from ..models import fast_infer
from ..models.fast_infer import fused_route
from ..models.grid_models import GridVoxelGNNGenerator
from ..ops.gumbel import gumbel_noise
from ..ops.rng import normal_box_muller
from .batcher import make_batcher


class InferenceServer:
    """Load weights once, serve concurrent single-building requests batched."""

    def __init__(
        self,
        configuration: Configuration,
        state_dict,
        max_batch: int = 16,
        max_delay_ms: float = 2.0,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        cfg = configuration
        cfg.require_ported_dtype("InferenceServer")
        if cfg.LAYOUT != "grid":
            raise ValueError("serving uses the grid layout")
        if cfg.BATCH_LEVEL_MATCHING or cfg.BATCH_LEVEL_GRAPHNORM:
            raise ValueError(
                "batch-level quirk modes make outputs depend on batchmates; "
                "serve with the per-graph defaults"
            )
        self.configuration = cfg
        self.device = torch.device(device)
        self.seed = seed
        self.max_batch = max_batch
        self.params_version = 0
        self._weights = self._load(state_dict)
        self._batcher = make_batcher(max_batch, int(max_delay_ms * 1000))
        self._lock = threading.Lock()
        self._next_id = 0
        self._staged: dict = {}
        self._results: dict = {}
        self._thread: Optional[threading.Thread] = None
        self.batch_sizes: list = []  # diagnostics: sizes of executed batches

    def _load(self, state_dict):
        """(model, packed hourglass weights on the fused route, else None)."""
        model = GridVoxelGNNGenerator(self.configuration)
        model.load_state_dict(state_dict)
        model = model.to(self.device).eval()
        return model, fast_infer.prepare(model, self.configuration) if fused_route(model) else None

    # ------------------------------------------------------------------
    def start(self) -> "InferenceServer":
        self._thread = threading.Thread(target=self._run, name="inference-executor", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 60.0) -> None:
        """Shut the batcher down, join the executor and free the batcher (the native
        handle: ``sb_destroy`` wakes and drains any client still blocked in ``wait``);
        raises if the executor does not exit, and then leaves the batcher allocated."""
        self._batcher.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            if self._thread.is_alive():
                raise RuntimeError("inference executor did not stop")
        self._batcher.close()

    def swap_params(self, state_dict) -> int:
        """Replace the served weights; batches already running finish on the old ones."""
        new = self._load(state_dict)
        with self._lock:
            self._weights = new
            self.params_version += 1
            return self.params_version

    # ------------------------------------------------------------------
    def _noise(self, seeds):
        """Per-request (z, gumbel) stacks of ``max_batch`` slots; empty slots get zeros."""
        cfg = self.configuration
        F, Y, X = cfg.GRID_SHAPE
        z = torch.zeros(self.max_batch, F, Y, X, cfg.Z_DIM, device=self.device)
        g = torch.zeros(self.max_batch, F, Y, X, NUM_CLASSES, device=self.device)
        for slot, s in enumerate(seeds):
            gen = torch.Generator(device=self.device)
            gen.manual_seed((self.seed * 2**32 + int(s)) % 2**63)
            z[slot] = normal_box_muller((F, Y, X, cfg.Z_DIM), gen)
            g[slot] = gumbel_noise((F, Y, X, NUM_CLASSES), gen)
        return z, g

    def _serve(self, samples, seeds):
        """-> (logits, hard, soft) as numpy, and the weights' version that computed them."""
        with self._lock:
            (model, packed), version = self._weights, self.params_version
        batch = gridlib.pack_grid(samples, self.configuration, batch_slots=self.max_batch)
        batch = batch.to(self.device)
        z, g = self._noise(seeds)
        if packed is None:
            with torch.no_grad():
                logits, hard, soft = model(batch, z, gumbel_noise=g)
        else:
            logits, hard, soft = fast_infer.infer(model, packed, batch, z, gumbel_noise=g)
        return (logits.cpu().numpy(), hard.cpu().numpy(), soft.cpu().numpy()), version

    def _run(self) -> None:
        while True:
            try:
                ids = self._batcher.next_batch()
            except StopIteration:
                return
            if not ids:
                continue
            with self._lock:
                # a timed-out request may have withdrawn its staged entry
                pairs = [(i, self._staged.pop(i)) for i in ids if i in self._staged]
            if not pairs:
                self._batcher.complete(ids)
                continue
            ids = [i for i, _ in pairs]
            reqs = [r for _, r in pairs]
            try:
                samples = [(r[0], r[1]) for r in reqs]
                (logits, hard, soft), version = self._serve(samples, [r[2] for r in reqs])
                with self._lock:
                    for slot, (i, (_, voxel)) in enumerate(zip(ids, samples)):
                        pos = np.asarray(voxel.location).astype(int)
                        f_, y_, x_ = pos[:, 0], pos[:, 1], pos[:, 2]
                        self._results[i] = {
                            "logits": logits[slot, f_, y_, x_],
                            "label_hard": hard[slot, f_, y_, x_],
                            "label_soft": soft[slot, f_, y_, x_],
                            "types": np.argmax(hard[slot, f_, y_, x_], axis=-1),
                            "params_version": version,
                        }
                self.batch_sizes.append(len(ids))
            except Exception as exc:  # noqa: BLE001 - isolate the poison batch
                # a failing batch fails ITS requests; the executor survives
                with self._lock:
                    for i in ids:
                        self._results[i] = {"error": exc}
            finally:
                self._batcher.complete(ids)

    # ------------------------------------------------------------------
    def infer(self, local, voxel, seed: int = 0, timeout_s: float = 120.0) -> dict:
        """Blocking single-building inference (thread-safe).

        Returns per-voxel arrays in the request's node order:
        ``{"logits": (n,7), "label_hard": (n,7), "label_soft": (n,7), "types": (n,)}``,
        and ``params_version``, the version of the weights that served it.
        Raises ``ValueError`` at submit time for a building that cannot fit the
        server's static shapes, ``TimeoutError`` after ``timeout_s``, and
        ``RuntimeError`` when this request's batch failed.
        """
        cfg = self.configuration
        F, Y, X = cfg.GRID_SHAPE
        loc = np.asarray(voxel.location)
        if loc.shape[0] == 0:
            raise ValueError("building has no voxels")
        extent = loc.max(axis=0) + 1
        if (loc.min() < 0) or (extent > np.array([F, Y, X])).any():
            raise ValueError(
                f"building extent {tuple(int(e) for e in extent)} exceeds the "
                f"server grid {cfg.GRID_SHAPE}; resize or use a larger-grid server"
            )
        n_local = np.asarray(local.x).shape[0]
        if n_local > cfg.GRID_LOCAL_NODES:
            raise ValueError(
                f"program graph has {n_local} nodes > GRID_LOCAL_NODES={cfg.GRID_LOCAL_NODES}"
            )

        with self._lock:
            rid = self._next_id
            self._next_id += 1
            self._staged[rid] = (local, voxel, seed)
        self._batcher.submit(rid)
        try:
            self._batcher.wait(rid, int(timeout_s * 1e6))
        except Exception:
            # withdraw so a late batch skips us, and drop a result that raced in
            with self._lock:
                self._staged.pop(rid, None)
                self._results.pop(rid, None)
            raise
        with self._lock:
            result = self._results.pop(rid)
        if "error" in result:
            raise RuntimeError(f"inference batch failed: {result['error']}") from result["error"]
        return result
