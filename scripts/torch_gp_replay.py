"""Replay a slot that ``scripts/torch_gp_probe.py`` saved through the JAX and the port critics.

The probe saves the slot whose building took most of a spiking gradient
penalty, with the critic's weights, the interpolation's inputs (real labels,
generated soft labels, eps) and the slot's dropout masks as the full batch
drew them.  This script rebuilds the JAX critic's params from the port's
state_dict (through the port's converter, by tracing where each flax entry
lands), gives both packages those masks, and prints for each package at bf16 and at f32 the
slot's penalty and the saved building's largest per-cell gradient norm.
CPU, with the JAX package and the tests' helpers; the port runs on the CPU too.

    python scripts/torch_gp_replay.py gp_probe_out/gp_slot_bfloat16.pt
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "tests"), ROOT]

import conftest  # noqa: E402,F401  (the JAX package on the CPU)
from building_gan_tpu.config import Configuration as JConfiguration  # noqa: E402
from building_gan_tpu.data.grid import GridBatch as JGridBatch  # noqa: E402
from building_gan_tpu.models import GridVoxelGNNDiscriminator as JDiscriminator  # noqa: E402
from test_torch_critic import given_masks  # noqa: E402

from building_gan_torch.checkpoint.torch_compat import (  # noqa: E402
    discriminator_params_to_state_dict,
)
from building_gan_torch.config import Configuration  # noqa: E402
from building_gan_torch.data.grid import GridBatch  # noqa: E402
from building_gan_torch.models.grid_models import GridVoxelGNNDiscriminator  # noqa: E402
from building_gan_torch.ops import dropout as drop  # noqa: E402


def flax_params(jdisc, jbatch, label, state_dict, cfg):
    """The flax params whose conversion is ``state_dict``: each flax entry gets a distinct id,
    the converter shows where each id lands, and the port's values go back there."""
    params = jax.jit(lambda: jdisc.init({"params": jax.random.key(0)}, jbatch, label,
                                        deterministic=True))()["params"]
    leaves, tree = jax.tree_util.tree_flatten(params)
    ids, n = [], 0
    for leaf in leaves:
        ids.append(np.arange(n + 1, n + 1 + leaf.size).reshape(leaf.shape))
        n += leaf.size
    assert n < 2**24  # ids exact in f32
    traced = discriminator_params_to_state_dict(
        jax.tree_util.tree_unflatten(tree, [jnp.asarray(i, jnp.float32) for i in ids]), cfg)
    flat = np.full(n + 1, np.nan, np.float32)
    for k, where in traced.items():
        flat[where.numpy().astype(np.int64).ravel()] = state_dict[k].float().numpy().ravel()
    assert not np.isnan(flat[1:]).any(), "a flax entry has no counterpart"
    return jax.tree_util.tree_unflatten(tree, [jnp.asarray(flat[i]) for i in ids])


def main(path):
    torch.set_num_threads(4)
    saved = torch.load(path, weights_only=False)
    fields = {k: None if v is None else v.numpy() for k, v in saved["batch"].items()}
    cfg_fields = {k: tuple(v) if isinstance(v, list) else v for k, v in saved["cfg"].items()}
    cfg = Configuration(**cfg_fields)
    jcfg = JConfiguration(**{k: v for k, v in cfg_fields.items()
                             if k in JConfiguration.__dataclass_fields__})
    jbatch = JGridBatch(**{k: None if v is None else jnp.asarray(v) for k, v in fields.items()})
    batch = GridBatch.from_numpy(**fields)
    types, soft, eps = (saved[k].float().numpy() for k in ("types_onehot", "label_soft", "eps"))
    interp = eps * types + (1.0 - eps) * soft
    mask = batch.mask.numpy() > 0
    building = ((batch.gid == saved["gid"]).numpy()) & mask

    disc = GridVoxelGNNDiscriminator(cfg)
    disc.load_state_dict(saved["critic"])
    jdisc = JDiscriminator(configuration=jcfg)
    pj = flax_params(jdisc, jbatch, jnp.asarray(types), saved["critic"], cfg)
    keys, masks = saved["keys"], saved["masks"]

    def report(name, grads):
        norms = np.sqrt((np.asarray(grads, np.float64) ** 2).sum(-1) + 1e-12)
        gp = ((norms - 1.0) ** 2)[mask].mean() * cfg.LAMBDA_GP
        print(f"{name}: the slot's penalty {gp:.6g}; building {saved['gid']}'s largest cell "
              f"gradient norm {norms[building].max():.6g}", flush=True)

    for name in ("bfloat16", "float32"):
        jd = jdisc.clone(dtype=jnp.dtype(name))

        def total(x):
            with given_masks([m.float().numpy() for m in masks], 256.0 / 205.0):
                s = jd.apply({"params": pj}, jbatch, x, deterministic=False,
                             rngs={"dropout": jax.random.key(0)})
            return jnp.sum(s[..., 0] * jbatch.mask)

        report(f"JAX {name}", jax.jit(jax.grad(total))(jnp.asarray(interp)))
        x = torch.as_tensor(interp).requires_grad_(True)
        given, keep = iter(masks), drop._keep
        drop._keep = lambda *a: next(given)
        try:
            scores = disc(batch, x, deterministic=False, keys=keys, dtype=getattr(torch, name))
        finally:
            drop._keep = keep
        (grads,) = torch.autograd.grad((scores[..., 0] * batch.mask).sum(), x)
        report(f"port {name}", grads.numpy())


if __name__ == "__main__":
    main(sys.argv[1])
