"""Best-gated and latest checkpoints of a ``TrainState``, with JSON meta.

Port of ``building_gan_tpu/checkpoint/ckpt.py`` with the reference's
semantics (``trainer.py:628-636``, ``:714-745``):

- ``states.pt`` holds the generator and critic ``state_dict``s, both Adam
  ``state_dict``s and the step count; ``states.meta.json`` the epoch bounds
  and the F1 family.  Written only when the weighted min-F1 criterion
  improves;
- on a non-improving epoch only ``epoch_start`` is patched into the meta, so
  a resume restores the best weights at the current epoch (quirk Q11);
- ``states_latest.pt`` / ``states_latest.meta.json``, every
  ``CKPT_LATEST_INTERVAL`` epochs, so a crash loses at most that many epochs;
- every write goes to a temporary file first, then ``os.replace``.

Files load with ``torch.load(weights_only=True)`` onto the given device, so a
checkpoint written on the card loads into a CPU trainer and the other way
round.  Adam keeps its step counts on the host (not capturable), so they are
put back there whatever the device.

Not ported: the JAX package's ``_migrate_opt_g``, which upgrades that
package's own first-round optax layout; the port writes no such files.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import torch

STATE_FILE = "states.pt"
META_FILE = "states.meta.json"
LATEST_STATE_FILE = "states_latest.pt"
LATEST_META_FILE = "states_latest.meta.json"


def _replace_atomically(path: str, write) -> None:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def _write_meta(path: str, meta: dict) -> None:
    def write(tmp):
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2)

    _replace_atomically(path, write)


def _write(log_dir: str, state, meta: dict, state_file: str, meta_file: str) -> None:
    os.makedirs(log_dir, exist_ok=True)
    payload = {
        "generator": state.generator.state_dict(),
        "discriminator": state.discriminator.state_dict(),
        "opt_g": state.opt_g.state_dict(),
        "opt_d": state.opt_d.state_dict(),
        "step": int(state.step),
    }
    _replace_atomically(os.path.join(log_dir, state_file), lambda tmp: torch.save(payload, tmp))
    _write_meta(os.path.join(log_dir, meta_file), meta)


def save_states(log_dir: str, state, meta: dict) -> None:
    """Write the best-gated checkpoint (state + JSON meta) atomically."""
    _write(log_dir, state, meta, STATE_FILE, META_FILE)


def save_latest(log_dir: str, state, meta: dict) -> None:
    """Write the periodic crash-recovery checkpoint atomically."""
    _write(log_dir, state, meta, LATEST_STATE_FILE, LATEST_META_FILE)


def _adam_steps_on_host(opt_state: dict) -> dict:
    for st in opt_state["state"].values():
        if torch.is_tensor(st.get("step")):
            st["step"] = st["step"].cpu()
    return opt_state


def read_meta(log_dir: str, state_file: str = STATE_FILE,
              meta_file: str = META_FILE) -> Optional[dict]:
    """A checkpoint's meta without loading it: None if there is no checkpoint, {}
    if it has no meta file."""
    if not os.path.exists(os.path.join(log_dir, state_file)):
        return None
    meta_path = os.path.join(log_dir, meta_file)
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def load_states(
    log_dir: str,
    state,
    state_file: str = STATE_FILE,
    meta_file: str = META_FILE,
    map_location=None,
) -> Optional[Tuple[object, dict]]:
    """Restore ``state`` in place from ``log_dir``: -> (state, meta), or None if no file.

    ``map_location`` is the device the tensors are loaded onto (the trainer's).
    """
    meta = read_meta(log_dir, state_file, meta_file)
    if meta is None:
        return None
    payload = torch.load(os.path.join(log_dir, state_file), weights_only=True,
                         map_location=map_location)
    state.generator.load_state_dict(payload["generator"])
    state.discriminator.load_state_dict(payload["discriminator"])
    state.opt_g.load_state_dict(_adam_steps_on_host(payload["opt_g"]))
    state.opt_d.load_state_dict(_adam_steps_on_host(payload["opt_d"]))
    state.step = int(payload["step"])
    return state, meta


def load_latest(log_dir: str, state, map_location=None) -> Optional[Tuple[object, dict]]:
    """Restore the periodic crash-recovery checkpoint, or None."""
    return load_states(log_dir, state, LATEST_STATE_FILE, LATEST_META_FILE, map_location)


def exists(log_dir: str) -> bool:
    return os.path.exists(os.path.join(log_dir, STATE_FILE))


def patch_epoch_start(log_dir: str, epoch: int) -> None:
    """Advance only the resume cursor, keeping the best weights (quirk Q11)."""
    meta_path = os.path.join(log_dir, META_FILE)
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    meta["epoch_start"] = epoch
    _write_meta(meta_path, meta)
