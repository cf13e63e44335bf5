"""The WGAN critic on the packed edge-list layout.

Port of ``building_gan_tpu/models/discriminator.py::VoxelGNNDiscriminator``:
the grid critic's computation (``models/grid_models.py``) over a
``PackedBatch``: type-matched pooling, the [matched, voxel features, label]
input through the ReLU MLP, the hourglass over the voxel graph's edge list
(its conv by ``DISCRIMINATOR_CONV_TYPE``), and per-node scores (no graph
readout, quirk Q10), through a sigmoid with ``USE_WGANGP=False``.
Submodules carry the grid critic's names.
"""

from __future__ import annotations

import torch

from ..ops.pooling import type_matched_pooling
from .grid_models import GridVoxelGNNDiscriminator
from .layers import HourglassGNN


class VoxelGNNDiscriminator(GridVoxelGNNDiscriminator):
    """Critic over a ``PackedBatch``: (batch, label (NV, 7)) -> per-node scores (NV, 1) in f32.

    ``dtype`` replaces the compute dtype for one call (the GP pass at
    ``GP_DTYPE="float32"``), as on the grid.
    """

    hourglass_cls = HourglassGNN

    def forward(self, batch, label, deterministic: bool = True,
                keys: torch.Tensor | None = None, dtype: torch.dtype | None = None) -> torch.Tensor:
        dt = self.compute_dtype if dtype is None else dtype
        num_graphs = batch.graph_mask.shape[0]
        matched_x = type_matched_pooling(
            batch.local_x, batch.local_type, batch.local_graph_id, batch.local_mask,
            batch.voxel_type, batch.voxel_graph_id, num_graphs,
            batch_level=self.configuration.BATCH_LEVEL_MATCHING,
        )
        x = self.mlp_encoder(torch.cat([matched_x.to(dt), batch.voxel_x.to(dt), label.to(dt)],
                                       dim=-1))
        encoded = self.encoder(
            x, batch.voxel_src, batch.voxel_dst, batch.voxel_edge_mask, batch.voxel_graph_id,
            num_graphs + 1, batch.voxel_mask, deterministic=deterministic, keys=keys,
        )
        return self.score(encoded.to(dt))
