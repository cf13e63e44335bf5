"""The grid transformer generator: masked multi-head self-attention over each building's cells.

Port of ``building_gan_tpu/models/transformer.py`` (the generator of
``GENERATOR_ARCH="transformer"``): the grid generator's matched-pooling
conditioning, MLP encoders, skip-concat decoder and straight-through Gumbel
head, with pre-LN transformer blocks in place of the hourglass, and a learned
positional projection of the voxel features.  Submodules carry the flax
names: ``matched_enc_i``, ``mlp_enc_i``, ``pos_proj``, ``block_i.{norm1,
attn.qkv, attn.proj, norm2, mlp_in, mlp_out}``, ``dec_i``, ``dec_out``.

The arithmetic is the JAX model's, not PyTorch's defaults: LayerNorm eps
1e-6 with f32 statistics, the tanh GELU (flax ``nn.gelu``), the attention
scores in f32 masked with -1e30 (not -inf: a query with no valid key stays
finite) and softmaxed in f32, then cast to v's dtype for the second product.
The attention is two ``torch.matmul``s around that softmax, on the CPU and
the card alike (``scaled_dot_product_attention`` rounds otherwise).  The
attention's output and each block's output are multiplied by the cell mask
(f32), which, as in the JAX model, promotes the residual stream to f32 after
the first attention; each LayerNorm and Dense computes at the compute dtype.
Dropout is the port's Philox byte dropout (``ops/dropout.py``) at
``ENCODER_DROPOUT_RATE``, after the attention and after the MLP of each block,
one key a site (``dropout_sites`` keys a forward).

Buildings that share a grid slot (K > 1) are kept apart: a cell attends only
to the cells of its own building (same gid) and pools over its own
building's program nodes.  The JAX model masks by the cell mask alone and
pools without the gid, so there the buildings of a slot attend to and pool
over each other (ROADMAP Queue C item 11); at K = 1 the two are the same.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..config import NUM_CLASSES, Configuration
from ..ops import dropout
from ..ops.gumbel import gumbel_softmax_st
from .grid_layers import grid_type_matched_pooling
from .grid_models import LOCAL_FEATURES, VOXEL_FEATURES
from .layers import LAYER_NORM_EPS, Dense, LayerNorm, MLPBlock

NEG_INF = -1e30


class GridSelfAttention(nn.Module):
    """Masked multi-head attention over the flattened cells (B, R, C) of each slot."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, gid: torch.Tensor | None = None):
        """``x`` (B, R, dim) at the compute dtype, ``mask`` (B, R) f32, ``gid`` (B, R) or None
        -> (B, R, dim): the projection's output times the mask (so f32 for an f32 mask)."""
        b, r, _ = x.shape
        hd = self.dim // self.heads
        q, k, v = (t.reshape(b, r, self.heads, hd).transpose(1, 2)
                   for t in self.qkv(x).split(self.dim, dim=-1))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
        keep = (mask > 0)[:, None, None, :]
        if gid is not None:
            keep = keep & (gid[:, None, :, None] == gid[:, None, None, :])
        scores = scores.masked_fill(~keep, NEG_INF)
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, r, self.dim)
        return self.proj(out) * mask[..., None]


class TransformerBlock(nn.Module):
    """Pre-LN block: x + drop(attn(LN(x))), then (x + drop(MLP(LN(x)))) * mask."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4, dropout_rate: float = 0.0):
        super().__init__()
        self.dim, self.dropout_rate = dim, dropout_rate
        self.norm1 = LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.attn = GridSelfAttention(dim, heads)
        self.norm2 = LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.mlp_in = Dense(dim, dim * mlp_ratio)
        self.mlp_out = Dense(dim * mlp_ratio, dim)

    def _drop(self, h, key):
        return h if key is None else dropout.dropout(h, key, self.dropout_rate, width=self.dim)

    def forward(self, x, mask, dtype: torch.dtype, gid=None, keys=None):
        """``keys`` (2, 2): the two dropout sites' Philox keys, or None (deterministic)."""
        k1, k2 = (None, None) if keys is None else keys
        h = self.attn(self.norm1(x).to(dtype), mask, gid)
        x = x + self._drop(h, k1)
        h = self.mlp_out(F.gelu(self.mlp_in(self.norm2(x).to(dtype)), approximate="tanh"))
        return (x + self._drop(h, k2)) * mask[..., None]


class GridTransformerGenerator(nn.Module):
    """Generator with attention over each building's cells: (batch, z) -> (logits,
    label_hard, label_soft), grid-shaped, the logits f32."""

    def __init__(self, configuration: Configuration):
        super().__init__()
        cfg = configuration
        self.configuration = cfg
        self.compute_dtype = cfg.compute_dtype
        lh, gh, zd = cfg.LOCAL_ENCODER_HIDDEN_DIM, cfg.GENERATOR_HIDDEN_DIM, cfg.Z_DIM
        for i in range(1 + cfg.LOCAL_GRAPH_ENCODER_REPEAT):
            self.add_module(f"matched_enc_{i}", MLPBlock(LOCAL_FEATURES if i == 0 else lh, lh))
        for i in range(1 + cfg.GENERATOR_MLP_ENCODER_REPEAT):
            self.add_module(f"mlp_enc_{i}", MLPBlock(lh + VOXEL_FEATURES + zd if i == 0 else gh, gh))
        self.pos_proj = Dense(VOXEL_FEATURES, gh)
        for i in range(cfg.TRANSFORMER_LAYERS):
            self.add_module(f"block_{i}", TransformerBlock(
                gh, cfg.TRANSFORMER_HEADS, dropout_rate=cfg.ENCODER_DROPOUT_RATE))
        widths = [gh, gh // 2, gh // 4, gh // 8]
        cin = 2 * gh + lh + VOXEL_FEATURES + zd
        for i, w in enumerate(widths):
            self.add_module(f"dec_{i}", MLPBlock(cin, w))
            cin = w
        self.dec_out = Dense(cin, NUM_CLASSES)
        self._blocks = {"matched_enc": 1 + cfg.LOCAL_GRAPH_ENCODER_REPEAT,
                        "mlp_enc": 1 + cfg.GENERATOR_MLP_ENCODER_REPEAT, "dec": len(widths)}

    @property
    def dropout_sites(self) -> int:
        """Philox keys a training forward draws: two a block."""
        return 2 * self.configuration.TRANSFORMER_LAYERS

    def _run(self, prefix: str, x):
        """x through the MLP blocks ``{prefix}_0``, ``{prefix}_1``, ... in order."""
        for i in range(self._blocks[prefix]):
            x = getattr(self, f"{prefix}_{i}")(x)
        return x

    def forward(self, batch, z, gumbel_noise=None, generator=None,
                deterministic: bool = True, keys: torch.Tensor | None = None):
        """``z`` (B, F, Y, X, Z_DIM); Gumbel noise given, or drawn from ``generator``;
        ``keys`` (``dropout_sites``, 2): the dropout keys when not ``deterministic``."""
        cfg, dt = self.configuration, self.compute_dtype
        drop_on = not deterministic and dropout.drop_levels(cfg.ENCODER_DROPOUT_RATE) > 0
        if drop_on and keys is None:
            raise ValueError("training-mode dropout needs per-site Philox keys")
        B = batch.x.shape[0]
        mask = batch.mask.reshape(B, -1).float()
        gid = None if batch.gid is None else batch.gid.reshape(B, -1)
        matched_x = grid_type_matched_pooling(
            batch.local_x.to(dt), batch.local_type, batch.local_mask, batch.type.reshape(B, -1),
            NUM_CLASSES, local_gid=batch.local_gid, gid=gid, num_graphs=batch.graphs_per_slot,
            batch_level=cfg.BATCH_LEVEL_MATCHING,
        )
        encoded_matched = self._run("matched_enc", matched_x)
        voxel_x = batch.x.reshape(B, -1, batch.x.shape[-1]).to(dt)
        zc = z.reshape(B, -1, z.shape[-1]).to(dt)
        tokens = self._run("mlp_enc", torch.cat([encoded_matched, voxel_x, zc], dim=-1))
        tok = tokens + self.pos_proj(voxel_x)
        attend_gid = gid if batch.graphs_per_slot > 1 else None
        for i in range(cfg.TRANSFORMER_LAYERS):
            tok = getattr(self, f"block_{i}")(tok, mask, dt, attend_gid,
                                               keys[2 * i: 2 * i + 2] if drop_on else None)
        final = torch.cat([tok.to(dt), tokens, encoded_matched, voxel_x, zc], dim=-1)
        logits = self.dec_out(self._run("dec", final)).float()
        if gumbel_noise is not None:
            gumbel_noise = gumbel_noise.reshape(logits.shape)
        label_hard, label_soft = gumbel_softmax_st(logits, gumbel_noise, generator)
        shape5 = tuple(batch.x.shape[:4]) + (NUM_CLASSES,)
        return logits.reshape(shape5), label_hard.reshape(shape5), label_soft.reshape(shape5)
