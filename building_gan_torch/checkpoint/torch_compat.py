"""Weight carry-over: flax generator and critic params -> the port's ``state_dict``.

Port of ``building_gan_tpu/checkpoint/torch_compat.py::generator_params_to_torch``
and ``discriminator_params_to_torch``; ``transformer_params_to_state_dict``
carries the transformer generator's params over to the port's own names.
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

The critic (``discriminator_params_to_state_dict``): ``mlp_i`` ->
``mlp_encoder.{2i}``, ``encoder`` as above, ``dec_i`` -> ``decoder.{2i}``,
``dec_out`` -> ``decoder.6``.

The other convs' leaves (``encoder/conv_i/...``) take PyG's names, the
reference's library (the JAX package's own converter maps GATCONV only):

    GATv2Conv    lin_l.{weight,bias}, lin_r.{weight,bias}  <- lin_l/*, lin_r/*
                 att (1, 1, C)                               <- att (C, 1)
    GCNConv      lin.weight                                  <- lin/kernel (T)
    GraphConv    lin_rel.weight                              <- lin_nbr/kernel (T)
                 lin_root.weight                             <- lin_self/kernel (T)
                 lin_rel.bias                                <- lin_self/bias

PyG keeps GraphConv's one bias on ``lin_rel``; the JAX layer adds it with
its self term.  Either way the layer's output is the same sum.  The flax
edge-list and grid models share one parameter tree, and so do the port's:
the output loads into both layouts.

(T): torch Linear stores (out, in), flax Dense (in, out).
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


def _dense(out, base, path, v):
    """A bare Dense leaf (kernel or bias) at torch ``base``."""
    out[f"{base}." + ("weight" if path[1] == "kernel" else "bias")] = v.T if path[1] == "kernel" else v


# flax Dense leaves of the convs -> the reference (PyG) torch names: (module, param)
_CONV_DENSE = {
    ("lin", "kernel"): ("lin", "weight"),  # GATConv, GCNConv
    ("lin_l", "kernel"): ("lin_l", "weight"),  # GATv2Conv
    ("lin_l", "bias"): ("lin_l", "bias"),
    ("lin_r", "kernel"): ("lin_r", "weight"),
    ("lin_r", "bias"): ("lin_r", "bias"),
    ("lin_nbr", "kernel"): ("lin_rel", "weight"),  # GraphConv: PyG's lin_rel ...
    ("lin_self", "kernel"): ("lin_root", "weight"),  # ... and lin_root,
    ("lin_self", "bias"): ("lin_rel", "bias"),  # which keeps the one bias on lin_rel
}


def _encoder_leaf(out, path, v, what):
    """A hourglass leaf: conv_i -> module_{4i}, norm_i -> module_{4i+1}."""
    kind, i = path[1].rsplit("_", 1)
    i = int(i)
    if kind == "conv":
        base = f"encoder.module_{4 * i}"
        if path[2:] in _CONV_DENSE:
            module, name = _CONV_DENSE[path[2:]]
            out[f"{base}.{module}.{name}"] = v.T if name == "weight" else v
        elif path[2] in ("att_src", "att_dst", "att"):
            out[f"{base}.{path[2]}"] = v.T[None]  # torch: (1, heads=1, C)
        elif path[2] == "bias":
            out[f"{base}.bias"] = v
        else:
            raise KeyError(f"unmapped {what} param {path}")
    else:
        out[f"encoder.module_{4 * i + 1}.{path[2]}"] = v


def _tensors(out: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}


def generator_params_to_state_dict(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """Flax generator params (nested dict of arrays) -> the port's state_dict (either layout)."""
    out: Dict[str, np.ndarray] = {}
    for path, v in _flatten(params).items():
        name = path[0]
        if name.startswith("matched_enc_"):
            _dense_or_norm(out, path, v, "matched_features_encoder", int(name.split("_")[-1]))
        elif name.startswith("mlp_enc_"):
            _dense_or_norm(out, path, v, "mlp_encoder", int(name.split("_")[-1]))
        elif name == "encoder":
            _encoder_leaf(out, path, v, "generator")
        elif name == "dec_out":
            out["decoder.12." + ("weight" if path[1] == "kernel" else "bias")] = (
                v.T if path[1] == "kernel" else v
            )
        elif name.startswith("dec_"):
            _dense_or_norm(out, path, v, "decoder", int(name.split("_")[-1]))
        else:
            raise KeyError(f"unmapped generator param {path}")
    return _tensors(out)


def discriminator_params_to_state_dict(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """Flax critic params (nested dict of arrays) -> the port's critic state_dict (either layout)."""
    out: Dict[str, np.ndarray] = {}
    for path, v in _flatten(params).items():
        name = path[0]
        if name.startswith("mlp_"):
            _dense(out, f"mlp_encoder.{2 * int(name.split('_')[-1])}", path, v)
        elif name == "encoder":
            _encoder_leaf(out, path, v, "discriminator")
        elif name == "dec_out":
            _dense(out, "decoder.6", path, v)
        elif name.startswith("dec_"):
            _dense(out, f"decoder.{2 * int(name.split('_')[-1])}", path, v)
        else:
            raise KeyError(f"unmapped discriminator param {path}")
    return _tensors(out)


_MLP_BLOCK_PARTS = {"dense": "0", "norm": "1"}  # the port's MLPBlock: Linear at 0, LayerNorm at 1


def transformer_params_to_state_dict(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """Flax ``GridTransformerGenerator`` params -> the port's ``GridTransformerGenerator``
    state_dict.

    The reference has no transformer, so the keys are the port's own module
    names, which follow the flax paths: ``block_i/attn/qkv/kernel`` ->
    ``block_i.attn.qkv.weight`` (T), LayerNorm ``scale`` -> ``weight``, and an
    MLP block's ``dense`` / ``norm`` (``matched_enc_i``, ``mlp_enc_i``,
    ``dec_i``) -> its ``0`` / ``1``.
    """
    out: Dict[str, np.ndarray] = {}
    for path, v in _flatten(params).items():
        mods, leaf = list(path[:-1]), path[-1]
        if mods[0].startswith(("matched_enc_", "mlp_enc_", "dec_")) and mods[0] != "dec_out":
            mods[1] = _MLP_BLOCK_PARTS[mods[1]]
        name = "weight" if leaf in ("kernel", "scale") else leaf
        out[".".join(mods + [name])] = v.T if leaf == "kernel" else v
    return _tensors(out)
