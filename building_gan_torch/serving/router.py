"""Routing over several batched inference servers.

Port of ``building_gan_tpu/serving/router.py``.  One (configuration,
weights) pair is one ``InferenceServer`` with its own batcher and executor
thread, so a slow or failing model does not hold up another:

- **named routing**: ``add_model("prod", cfg, state_dict)`` and
  ``infer(..., model="prod")``;
- **routing by size**: ``infer`` without a name goes to the smallest
  registered grid that holds the building's extent (the serving side of
  ``GRID_BUCKETS``), and to the default model when none does;
- **weight swap**: ``swap_params(name, state_dict)`` goes through
  ``InferenceServer.swap_params``: batches already running finish on the old
  weights, the next batch serves the new ones, no request is dropped.
"""

from __future__ import annotations

import threading

import numpy as np

from ..config import Configuration
from .server import InferenceServer


class RoutingServer:
    """Route single-building requests across named ``InferenceServer``s."""

    def __init__(self):
        self._lock = threading.Lock()
        self._models: dict[str, InferenceServer] = {}
        self._default: str | None = None

    def add_model(self, name: str, configuration: Configuration, state_dict,
                  default: bool = False, **server_kwargs) -> InferenceServer:
        """Register and start a server for ``name``; returns it.  The first model
        registered is the default route until ``default=True`` moves it."""
        with self._lock:
            if name in self._models:
                raise ValueError(f"model {name!r} already registered")
            srv = InferenceServer(configuration, state_dict, **server_kwargs).start()
            self._models[name] = srv
            if default or self._default is None:
                self._default = name
            return srv

    def remove_model(self, name: str) -> None:
        """Stop and unregister ``name``."""
        with self._lock:
            srv = self._models.pop(name)
            if self._default == name:
                self._default = next(iter(self._models), None)
        srv.stop()

    def swap_params(self, name: str, state_dict) -> int:
        """Swap ``name``'s weights; returns its new version number."""
        return self._model(name).swap_params(state_dict)

    def models(self) -> dict[str, dict]:
        """Name -> {grid_shape, params_version, batches_served, default}."""
        with self._lock:
            return {
                n: {"grid_shape": tuple(s.configuration.GRID_SHAPE),
                    "params_version": s.params_version,
                    "batches_served": len(s.batch_sizes),
                    "default": n == self._default}
                for n, s in self._models.items()
            }

    def _model(self, name: str) -> InferenceServer:
        with self._lock:
            try:
                return self._models[name]
            except KeyError:
                raise KeyError(f"no model {name!r}; registered: {sorted(self._models)}") from None

    def route(self, voxel) -> InferenceServer:
        """The smallest registered grid that holds ``voxel``'s extent, else the default."""
        loc = np.asarray(voxel.location)
        extent = loc.max(axis=0) + 1 if loc.shape[0] else np.zeros(3, int)
        with self._lock:
            fitting = [s for s in self._models.values()
                       if (extent <= np.array(s.configuration.GRID_SHAPE)).all()]
            if not fitting:
                if self._default is None:
                    raise RuntimeError("no models registered")
                return self._models[self._default]
        return min(fitting, key=lambda s: int(np.prod(s.configuration.GRID_SHAPE)))

    def infer(self, local, voxel, model: str | None = None, seed: int = 0,
              timeout_s: float = 120.0) -> dict:
        """Blocking inference on ``model``, or on the server ``route`` picks."""
        srv = self._model(model) if model is not None else self.route(voxel)
        return srv.infer(local, voxel, seed=seed, timeout_s=timeout_s)

    def stop(self) -> None:
        """Stop every server and join its executor."""
        with self._lock:
            servers = list(self._models.values())
            self._models.clear()
            self._default = None
        for s in servers:
            s.stop()
