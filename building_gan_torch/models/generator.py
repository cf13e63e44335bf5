"""The generator on the packed edge-list layout.

Port of ``building_gan_tpu/models/generator.py::VoxelGNNGenerator``: the
same computation as the grid generator (``models/grid_models.py``) over a
``PackedBatch``: per-graph type-matched pooling by segment ops, the two MLP
encoders, the hourglass over the voxel graph's edge list
(``models/layers.py::HourglassGNN``, its conv by ``GENERATOR_CONV_TYPE``),
the skip-concat decoder and the straight-through Gumbel head.  Submodules
and parameters carry the grid generator's names, so one ``state_dict``
drives both layouts.

Dtypes are the JAX model's: the pooled features, voxel features and z are
cast to ``COMPUTE_DTYPE`` on entry; the hourglass returns f32 (its
aggregations promote) and the decoder takes it rounded to the compute dtype,
as flax ``Dense`` casts its input; the logits come out f32.
"""

from __future__ import annotations

import torch

from ..ops.gumbel import gumbel_softmax_st
from ..ops.pooling import type_matched_pooling
from .grid_models import GridVoxelGNNGenerator
from .layers import HourglassGNN


class VoxelGNNGenerator(GridVoxelGNNGenerator):
    """Generator over a ``PackedBatch``: (batch, z (NV, Z_DIM)) -> (logits, label_hard,
    label_soft), each (NV, 7)."""

    hourglass_cls = HourglassGNN

    def forward(self, batch, z, gumbel_noise=None, generator=None,
                deterministic: bool = True, keys: torch.Tensor | None = None):
        """Gumbel noise (NV, 7) given, or drawn from ``generator``; ``keys`` (L, 2): the
        hourglass's dropout keys when not ``deterministic``."""
        dt = self.compute_dtype
        num_graphs = batch.graph_mask.shape[0]
        matched_x = type_matched_pooling(
            batch.local_x, batch.local_type, batch.local_graph_id, batch.local_mask,
            batch.voxel_type, batch.voxel_graph_id, num_graphs,
            batch_level=self.configuration.BATCH_LEVEL_MATCHING,
        )
        encoded_matched = self.matched_features_encoder(matched_x.to(dt))
        voxel_x, z = batch.voxel_x.to(dt), z.to(dt)
        x = self.mlp_encoder(torch.cat([encoded_matched, voxel_x, z], dim=-1))
        encoded = self.encoder(
            x, batch.voxel_src, batch.voxel_dst, batch.voxel_edge_mask, batch.voxel_graph_id,
            num_graphs + 1, batch.voxel_mask, deterministic=deterministic, keys=keys,
        )
        final = torch.cat([encoded.to(dt), x, encoded_matched, voxel_x, z], dim=-1)
        logits = self.decoder(final).float()
        label_hard, label_soft = gumbel_softmax_st(logits, gumbel_noise, generator)
        return logits, label_hard, label_soft
