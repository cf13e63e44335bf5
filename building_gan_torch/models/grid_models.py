"""Grid-layout generator: the port of ``GridVoxelGNNGenerator``.

Same computation as ``building_gan_tpu/models/grid_models.py`` (the
deterministic forward, in float32), with submodules named after the
reference ``state_dict``: ``matched_features_encoder``, ``mlp_encoder``,
``encoder`` (the GAT hourglass) and ``decoder`` (four MLP blocks, then the
7-way head at ``decoder.12``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import NUM_CLASSES, Configuration
from ..ops.gumbel import gumbel_softmax_st
from .grid_layers import GridHourglass, grid_type_matched_pooling
from .layers import mlp_stack

LOCAL_FEATURES = 17
VOXEL_FEATURES = 12


class GridVoxelGNNGenerator(nn.Module):
    """Generator over a ``GridBatch``: -> (logits, label_hard, label_soft), grid-shaped."""

    def __init__(self, configuration: Configuration):
        super().__init__()
        cfg = configuration
        if cfg.BATCH_LEVEL_GRAPHNORM or cfg.BATCH_LEVEL_MATCHING:
            raise NotImplementedError("the batch-level quirk modes are not ported")
        self.configuration = cfg
        lh, gh, z = cfg.LOCAL_ENCODER_HIDDEN_DIM, cfg.GENERATOR_HIDDEN_DIM, cfg.Z_DIM
        self.matched_features_encoder = mlp_stack(
            LOCAL_FEATURES, [lh] * (1 + cfg.LOCAL_GRAPH_ENCODER_REPEAT)
        )
        self.mlp_encoder = mlp_stack(
            lh + VOXEL_FEATURES + z, [gh] * (1 + cfg.GENERATOR_MLP_ENCODER_REPEAT)
        )
        self.encoder = GridHourglass(
            gh, cfg.GENERATOR_ENCODER_REPEAT, cfg.HOURGLASS_MIN_CHANNELS,
            conv_type=cfg.GENERATOR_CONV_TYPE,
        )
        self.decoder = mlp_stack(
            2 * gh + lh + VOXEL_FEATURES + z, [gh, gh // 2, gh // 4, gh // 8]
        )
        self.decoder.append(nn.Linear(gh // 8, NUM_CLASSES))

    def encode(self, batch, z: torch.Tensor):
        """Everything before the hourglass: -> (x, encoded_matched, voxel_x, z, mask, gid), flat."""
        B = batch.x.shape[0]
        voxel_x = batch.x.reshape(B, -1, batch.x.shape[-1]).float()
        mask = batch.mask.reshape(B, -1)
        vtype = batch.type.reshape(B, -1)
        gid = None if batch.gid is None else batch.gid.reshape(B, -1)
        matched_x = grid_type_matched_pooling(
            batch.local_x.float(), batch.local_type, batch.local_mask, vtype, NUM_CLASSES,
            local_gid=batch.local_gid, gid=gid, num_graphs=batch.graphs_per_slot,
        )
        encoded_matched = self.matched_features_encoder(matched_x)
        z = z.reshape(B, -1, z.shape[-1]).float()
        x = self.mlp_encoder(torch.cat([encoded_matched, voxel_x, z], dim=-1))
        return x, encoded_matched, voxel_x, z, mask, gid

    def decode(self, batch, encoded, x, encoded_matched, voxel_x, z, gumbel_noise=None,
               generator: torch.Generator | None = None):
        final = torch.cat([encoded, x, encoded_matched, voxel_x, z], dim=-1)
        logits = self.decoder(final).float()
        if gumbel_noise is not None:
            gumbel_noise = gumbel_noise.reshape(logits.shape)
        label_hard, label_soft = gumbel_softmax_st(logits, gumbel_noise, generator)
        shape5 = tuple(batch.x.shape[:4]) + (NUM_CLASSES,)
        return logits.reshape(shape5), label_hard.reshape(shape5), label_soft.reshape(shape5)

    def forward(self, batch, z, gumbel_noise=None, generator=None):
        """``z`` (B, F, Y, X, Z_DIM); Gumbel noise given, or drawn from ``generator``."""
        x, encoded_matched, voxel_x, z, mask, gid = self.encode(batch, z)
        encoded = self.encoder(
            x, mask, batch.grid_shape, gid=gid, num_graphs=batch.graphs_per_slot
        )
        return self.decode(batch, encoded, x, encoded_matched, voxel_x, z, gumbel_noise, generator)
