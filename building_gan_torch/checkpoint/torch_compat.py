"""Weight carry-over: flax generator params -> the port's ``state_dict``.

Port of ``building_gan_tpu/checkpoint/torch_compat.py::generator_params_to_torch``.
The input is the flax parameter tree as a nested dict of numpy arrays (so this
module needs no JAX); the output keys follow the reference torch layout, which
is how the port's ``GridVoxelGNNGenerator`` names its submodules:

    reference torch key                      flax path
    ---------------------------------------  ---------------------------------
    matched_features_encoder.{3i}.weight     matched_enc_i/dense/kernel (T)
    matched_features_encoder.{3i+1}.*        matched_enc_i/norm/{scale,bias}
    mlp_encoder.{3i}.*                       mlp_enc_i/dense/*
    encoder.module_{4i}.lin.weight           encoder/conv_i/lin/kernel (T)
    encoder.module_{4i}.att_src              encoder/conv_i/att_src
    encoder.module_{4i}.bias                 encoder/conv_i/bias
    encoder.module_{4i+1}.weight             encoder/norm_i/weight
    encoder.module_{4i+1}.mean_scale         encoder/norm_i/mean_scale
    decoder.{3i}.weight                      dec_i/dense/kernel (T)
    decoder.12.weight                        dec_out/kernel (T)

(T): torch Linear stores (out, in), flax Dense (in, out).  GATCONV only.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _flatten(tree, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
    else:
        out[prefix] = np.asarray(tree)
    return out


def _dense_or_norm(out, path, v, base_prefix, i):
    """MLPBlock leaf: dense at index 3i, LayerNorm (scale -> weight) at 3i+1."""
    if path[1] == "dense":
        key = f"{base_prefix}.{3 * i}." + ("weight" if path[2] == "kernel" else "bias")
        out[key] = v.T if path[2] == "kernel" else v
    else:
        key = f"{base_prefix}.{3 * i + 1}." + ("weight" if path[2] == "scale" else "bias")
        out[key] = v


def generator_params_to_state_dict(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """Flax generator params (nested dict of arrays) -> the port's state_dict."""
    if cfg.GENERATOR_CONV_TYPE != "GATCONV":
        raise NotImplementedError("conversion implemented for GATCONV only")
    out: Dict[str, np.ndarray] = {}
    for path, v in _flatten(params).items():
        name = path[0]
        if name.startswith("matched_enc_"):
            _dense_or_norm(out, path, v, "matched_features_encoder", int(name.split("_")[-1]))
        elif name.startswith("mlp_enc_"):
            _dense_or_norm(out, path, v, "mlp_encoder", int(name.split("_")[-1]))
        elif name == "encoder":
            kind, i = path[1].rsplit("_", 1)
            i = int(i)
            if kind == "conv":
                base = f"encoder.module_{4 * i}"
                if path[2] == "lin":
                    out[f"{base}.lin.weight"] = v.T
                elif path[2] in ("att_src", "att_dst"):
                    out[f"{base}.{path[2]}"] = v.T[None]  # torch: (1, heads=1, C)
                elif path[2] == "bias":
                    out[f"{base}.bias"] = v
                else:
                    raise KeyError(f"unmapped generator param {path}")
            else:
                out[f"encoder.module_{4 * i + 1}.{path[2]}"] = v
        elif name == "dec_out":
            out["decoder.12." + ("weight" if path[1] == "kernel" else "bias")] = (
                v.T if path[1] == "kernel" else v
            )
        elif name.startswith("dec_"):
            _dense_or_norm(out, path, v, "decoder", int(name.split("_")[-1]))
        else:
            raise KeyError(f"unmapped generator param {path}")
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)) for k, v in out.items()}
