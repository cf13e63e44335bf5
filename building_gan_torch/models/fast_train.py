"""Training forwards with the hourglass fused: generator and critic.

Port of ``building_gan_tpu/models/fast_train.py``.  ``generator_apply_fused``
and ``discriminator_apply_fused`` compute what ``GridVoxelGNNGenerator`` and
``GridVoxelGNNDiscriminator`` compute, from the same modules, with the GAT
hourglass run by ``ops.gat_train.hourglass_train``: the CUDA forward and
backward kernels on a CUDA batch, the plain version on a CPU batch.  The
hourglass weights are packed by ``ops.hourglass.pack_gat_weights`` on every
call, with a graph, so autograd carries the kernels' weight grads back to
each layer's parameters.  The MLP
encoders and decoders and the pooling stay plain PyTorch, as they stay XLA
in the JAX package.  Everything runs at the model's compute dtype, with the
JAX package's casts: the hourglass takes and returns activations in it (the
kernels' bf16 storage at bf16), the logits and scores come out f32.

The fused path is first-order differentiable (the backward is a kernel), so
the gradient-penalty critic pass, differentiated twice, runs the plain
``GridVoxelGNNDiscriminator`` (``train/step.py``).  Given the same Philox
keys, both draw the same dropout masks.
"""

from __future__ import annotations

import torch

from ..ops.gat_train import build_planes, hourglass_train
from ..ops.hourglass import pack_gat_weights


def fused_hourglass(encoder, x, planes, grid_shape, K, keys, deterministic):
    """The hourglass of ``encoder`` on (B, R, Cmax) ``x`` through ``hourglass_train``."""
    Ws, atts, vecs = pack_gat_weights(encoder)
    return hourglass_train(
        x.contiguous(), planes, Ws, atts, vecs, keys, grid_shape, K=K,
        dropout_rate=encoder.dropout_rate, deterministic=deterministic,
        chans=encoder.channel_pairs,
    )


def _planes(batch, planes):
    return build_planes(batch.mask, batch.gid, batch.grid_shape) if planes is None else planes


def generator_apply_fused(model, cfg, batch, z, gumbel_noise=None, generator=None, keys=None,
                          deterministic: bool = False, planes=None):
    """``GridVoxelGNNGenerator.forward`` with the hourglass fused: (logits, label_hard, label_soft).

    ``keys`` (L, 2) are the hourglass's Philox dropout keys; ``planes`` may be
    given to skip rebuilding them from the batch.
    """
    if cfg.GENERATOR_CONV_TYPE != "GATCONV":
        raise NotImplementedError("the fused train path supports GATCONV only")
    x, encoded_matched, voxel_x, zf, _, _ = model.encode(batch, z)
    encoded = fused_hourglass(
        model.encoder, x, _planes(batch, planes), batch.grid_shape, batch.graphs_per_slot,
        keys, deterministic,
    )
    return model.decode(batch, encoded, x, encoded_matched, voxel_x, zf, gumbel_noise, generator)


def discriminator_apply_fused(model, cfg, batch, label, keys=None, deterministic: bool = False,
                              planes=None) -> torch.Tensor:
    """``GridVoxelGNNDiscriminator.forward`` with the hourglass fused: scores (B, F, Y, X, 1).

    First-order differentiable only: the gradient penalty uses the plain critic.
    """
    if cfg.DISCRIMINATOR_CONV_TYPE != "GATCONV":
        raise NotImplementedError("the fused train path supports GATCONV only")
    x, _, _ = model.encode(batch, label)
    encoded = fused_hourglass(
        model.encoder, x, _planes(batch, planes), batch.grid_shape, batch.graphs_per_slot,
        keys, deterministic,
    )
    return model.decode(batch, encoded)
