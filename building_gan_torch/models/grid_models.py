"""Grid-layout generator and critic: the port of ``GridVoxelGNNGenerator``
and ``GridVoxelGNNDiscriminator``.

Same computation as ``building_gan_tpu/models/grid_models.py``, at its
dtypes: parameters float32, activations in ``COMPUTE_DTYPE`` (the models'
``compute_dtype``), cast on entry as the JAX models cast them (voxel and
local features, z, the label); the generator's logits and the critic's
scores come out in float32.  Submodules are named after the
reference ``state_dict``.  Generator:
``matched_features_encoder``, ``mlp_encoder``, ``encoder`` (the
hourglass, its conv by ``GENERATOR_CONV_TYPE``) and ``decoder`` (four MLP blocks, then the 7-way head at
``decoder.12``).  Critic: ``mlp_encoder.{0,2}`` (Linear, ReLU), ``encoder``
and ``decoder.{0,2,4,6}`` (Linear, ReLU, ..., the score head).  The edge-list
models (``models/generator.py``, ``models/discriminator.py``) subclass these
with the edge-list hourglass (``hourglass_cls``), so one ``state_dict`` loads
into either layout.

Both run deterministic by default; ``deterministic=False`` with per-layer
Philox ``keys`` turns the hourglass dropout on (training mode).  The
reference's merged-batch quirks are flags of the configuration, as in the JAX
models: ``BATCH_LEVEL_MATCHING`` (Q1: type-matched pooling over the whole
batch) and ``BATCH_LEVEL_GRAPHNORM`` (Q5: every GraphNorm's statistics over
the whole batch).  With ``USE_WGANGP=False`` the critic's scores pass through
a sigmoid, for the BCE losses.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import NUM_CLASSES, Configuration
from ..ops.gumbel import gumbel_noise as draw_gumbel
from ..ops.gumbel import gumbel_softmax_st
from .grid_layers import GridHourglass, grid_type_matched_pooling
from .layers import Dense, mlp_stack

LOCAL_FEATURES = 17
VOXEL_FEATURES = 12


class GridVoxelGNNGenerator(nn.Module):
    """Generator over a ``GridBatch``: -> (logits, label_hard, label_soft), grid-shaped."""

    hourglass_cls = GridHourglass

    def __init__(self, configuration: Configuration):
        super().__init__()
        cfg = configuration
        self.configuration = cfg
        self.compute_dtype = cfg.compute_dtype
        lh, gh, z = cfg.LOCAL_ENCODER_HIDDEN_DIM, cfg.GENERATOR_HIDDEN_DIM, cfg.Z_DIM
        self.matched_features_encoder = mlp_stack(
            LOCAL_FEATURES, [lh] * (1 + cfg.LOCAL_GRAPH_ENCODER_REPEAT)
        )
        self.mlp_encoder = mlp_stack(
            lh + VOXEL_FEATURES + z, [gh] * (1 + cfg.GENERATOR_MLP_ENCODER_REPEAT)
        )
        self.encoder = self.hourglass_cls(
            gh, cfg.GENERATOR_ENCODER_REPEAT, cfg.HOURGLASS_MIN_CHANNELS,
            conv_type=cfg.GENERATOR_CONV_TYPE, dropout_rate=cfg.ENCODER_DROPOUT_RATE,
            batch_level_graphnorm=cfg.BATCH_LEVEL_GRAPHNORM,
        )
        self.decoder = mlp_stack(
            2 * gh + lh + VOXEL_FEATURES + z, [gh, gh // 2, gh // 4, gh // 8]
        )
        self.decoder.append(Dense(gh // 8, NUM_CLASSES))

    @property
    def dropout_sites(self) -> int:
        """Philox keys a training forward draws: one an hourglass layer."""
        return len(self.encoder.channels)

    def encode(self, batch, z: torch.Tensor):
        """Everything before the hourglass: -> (x, encoded_matched, voxel_x, z, mask, gid), flat,
        in the compute dtype."""
        dt = self.compute_dtype
        B = batch.x.shape[0]
        voxel_x = batch.x.reshape(B, -1, batch.x.shape[-1]).to(dt)
        mask = batch.mask.reshape(B, -1)
        vtype = batch.type.reshape(B, -1)
        gid = None if batch.gid is None else batch.gid.reshape(B, -1)
        matched_x = grid_type_matched_pooling(
            batch.local_x.to(dt), batch.local_type, batch.local_mask, vtype, NUM_CLASSES,
            local_gid=batch.local_gid, gid=gid, num_graphs=batch.graphs_per_slot,
            batch_level=self.configuration.BATCH_LEVEL_MATCHING,
        )
        encoded_matched = self.matched_features_encoder(matched_x)
        z = z.reshape(B, -1, z.shape[-1]).to(dt)
        x = self.mlp_encoder(torch.cat([encoded_matched, voxel_x, z], dim=-1))
        return x, encoded_matched, voxel_x, z, mask, gid

    def decode(self, batch, encoded, x, encoded_matched, voxel_x, z, gumbel_noise=None,
               generator: torch.Generator | None = None, sp=None):
        final = torch.cat([encoded, x, encoded_matched, voxel_x, z], dim=-1)
        logits = self.decoder(final).float()  # the head in the compute dtype, logits in f32
        if gumbel_noise is not None:
            gumbel_noise = gumbel_noise.reshape(logits.shape)
        elif sp is not None:  # the whole slots' draw, at this rank's rows
            if generator is None:
                raise ValueError("gumbel_softmax_st needs the noise or a generator")
            plane = batch.x.shape[2] * batch.x.shape[3]
            gumbel_noise = sp.local(draw_gumbel(sp.global_shape(logits.shape, 1, plane), generator,
                                                device=logits.device), 1, plane)
        label_hard, label_soft = gumbel_softmax_st(logits, gumbel_noise, generator)
        shape5 = tuple(batch.x.shape[:4]) + (NUM_CLASSES,)
        return logits.reshape(shape5), label_hard.reshape(shape5), label_soft.reshape(shape5)

    def forward(self, batch, z, gumbel_noise=None, generator=None,
                deterministic: bool = True, keys: torch.Tensor | None = None, sp=None):
        """``z`` (B, F, Y, X, Z_DIM); Gumbel noise given, or drawn from ``generator``.

        ``keys`` (L, 2): the hourglass's dropout keys when not ``deterministic``.
        ``sp``: a floor shard (``parallel/sp.py``); batch, z and the noise are then this
        rank's floors, and noise drawn here is the whole slots' draw at them.
        """
        x, encoded_matched, voxel_x, z, mask, gid = self.encode(batch, z)
        encoded = self.encoder(
            x, mask, batch.grid_shape, gid=gid, num_graphs=batch.graphs_per_slot,
            deterministic=deterministic, keys=keys, sp=sp,
        )
        return self.decode(batch, encoded, x, encoded_matched, voxel_x, z, gumbel_noise, generator,
                           sp)


class GridVoxelGNNDiscriminator(nn.Module):
    """Critic over a ``GridBatch``: (batch, label) -> per-cell scores (B, F, Y, X, 1) in f32.

    ``forward`` and ``encode`` take a per-call ``dtype`` in place of the
    compute dtype, the way the JAX train step clones its critic at f32 for
    the gradient penalty (``GP_DTYPE="float32"``).
    """

    hourglass_cls = GridHourglass

    def __init__(self, configuration: Configuration):
        super().__init__()
        cfg = configuration
        self.configuration = cfg
        self.compute_dtype = cfg.compute_dtype
        d = cfg.DISCRIMINATOR_HIDDEN_DIM
        self.mlp_encoder = nn.Sequential(
            Dense(LOCAL_FEATURES + VOXEL_FEATURES + NUM_CLASSES, d), nn.ReLU(),
            Dense(d, d), nn.ReLU(),
        )
        self.encoder = self.hourglass_cls(
            d, cfg.DISCRIMINATOR_ENCODER_REPEAT, cfg.HOURGLASS_MIN_CHANNELS,
            conv_type=cfg.DISCRIMINATOR_CONV_TYPE, dropout_rate=cfg.ENCODER_DROPOUT_RATE,
            batch_level_graphnorm=cfg.BATCH_LEVEL_GRAPHNORM,
        )
        self.decoder = nn.Sequential(
            Dense(d, d // 2), nn.ReLU(),
            Dense(d // 2, d // 4), nn.ReLU(),
            Dense(d // 4, d // 8), nn.ReLU(),
            Dense(d // 8, 1),
        )

    @property
    def dropout_sites(self) -> int:
        """Philox keys a training forward draws: one an hourglass layer."""
        return len(self.encoder.channels)

    def encode(self, batch, label: torch.Tensor, dtype: torch.dtype | None = None):
        """Everything before the hourglass: -> (x (B, R, d), mask, gid), flat, in ``dtype``
        (default: the model's compute dtype)."""
        dt = self.compute_dtype if dtype is None else dtype
        B = batch.x.shape[0]
        voxel_x = batch.x.reshape(B, -1, batch.x.shape[-1]).to(dt)
        vtype = batch.type.reshape(B, -1)
        gid = None if batch.gid is None else batch.gid.reshape(B, -1)
        label = label.reshape(B, -1, label.shape[-1]).to(dt)
        matched_x = grid_type_matched_pooling(
            batch.local_x.to(dt), batch.local_type, batch.local_mask, vtype, NUM_CLASSES,
            local_gid=batch.local_gid, gid=gid, num_graphs=batch.graphs_per_slot,
            batch_level=self.configuration.BATCH_LEVEL_MATCHING,
        )
        x = self.mlp_encoder(torch.cat([matched_x, voxel_x, label], dim=-1))
        return x, batch.mask.reshape(B, -1), gid

    def score(self, encoded: torch.Tensor) -> torch.Tensor:
        """The decoder's per-cell scores in f32: the WGAN critic's, or their sigmoid for
        the BCE losses (``USE_WGANGP=False``)."""
        s = self.decoder(encoded).float()
        return s if self.configuration.USE_WGANGP else torch.sigmoid(s)

    def decode(self, batch, encoded: torch.Tensor) -> torch.Tensor:
        """Per-cell critic scores in f32, grid-shaped (``score``)."""
        return self.score(encoded).reshape(tuple(batch.x.shape[:4]) + (1,))

    def forward(self, batch, label, deterministic: bool = True,
                keys: torch.Tensor | None = None, dtype: torch.dtype | None = None,
                sp=None) -> torch.Tensor:
        """``sp``: a floor shard (``parallel/sp.py``); batch and label are this rank's floors."""
        x, mask, gid = self.encode(batch, label, dtype)
        encoded = self.encoder(
            x, mask, batch.grid_shape, gid=gid, num_graphs=batch.graphs_per_slot,
            deterministic=deterministic, keys=keys, sp=sp,
        )
        return self.decode(batch, encoded)
