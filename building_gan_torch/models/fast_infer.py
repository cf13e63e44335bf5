"""Fast generator inference: the generator's forward with its hourglass fused.

Port of ``building_gan_tpu/models/fast_infer.py``.  ``prepare`` packs the
hourglass weights once; ``infer`` runs the generator's MLPs and pooling as
plain PyTorch and the hourglass through ``ops.hourglass.hourglass_fwd``: the
CUDA kernel on a CUDA batch, its plain version on a CPU batch.  At the
model's compute dtype: under bf16 the kernel reads and writes bf16 (f32
inside), and the logits come out f32.
"""

from __future__ import annotations

import torch

from ..ops.hourglass import hourglass_fwd, pack_gat_weights
from .grid_layers import GridHourglass


def fused_route(model) -> bool:
    """Whether ``model`` runs its hourglass fused: a grid model whose hourglass (from the
    configuration that built it) is GATCONV, the one conv with kernels, with statistics
    per building.  A model without a ``GridHourglass`` (the edge models, the transformer
    generator) runs plain; so does ``BATCH_LEVEL_GRAPHNORM``, whose statistics span the
    batch while the kernels keep them per slot or per gid key (the JAX fused train path
    has no branch for the flag; the port follows the flax modules, which honour it)."""
    enc = getattr(model, "encoder", None)
    return (isinstance(enc, GridHourglass) and enc.conv_type == "GATCONV"
            and not enc.batch_level_graphnorm)


def prepare(model, cfg) -> dict:
    """Pack the hourglass weights of a ``GridVoxelGNNGenerator`` for ``infer``."""
    if cfg.GENERATOR_CONV_TYPE != "GATCONV":
        raise NotImplementedError("the fused hourglass supports GATCONV only")
    with torch.no_grad():
        Ws, atts, vecs = pack_gat_weights(model.encoder)
    return {"Ws": Ws, "atts": atts, "vecs": vecs, "chans": model.encoder.channel_pairs}


@torch.no_grad()
def infer(model, packed: dict, batch, z: torch.Tensor, gumbel_noise=None, generator=None):
    """(logits, label_hard, label_soft), grid-shaped, with the fused hourglass."""
    x, encoded_matched, voxel_x, zf, mask, gid = model.encode(batch, z)
    B, F, Y, X = batch.mask.shape
    encoded = hourglass_fwd(
        x.reshape(B, F, Y, X, -1).contiguous(),
        batch.mask.float().contiguous(),
        packed["Ws"], packed["atts"], packed["vecs"], packed["chans"],
        gid=batch.gid, num_graphs=batch.graphs_per_slot,
    ).reshape(B, F * Y * X, -1)
    return model.decode(batch, encoded, x, encoded_matched, voxel_x, zf, gumbel_noise, generator)
