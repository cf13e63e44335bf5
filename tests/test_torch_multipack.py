"""The port's multi-building grid packers vs the JAX package's (exact equality).

``pack_grid_multi`` and ``plan_packing_slots`` + ``pack_grid_multi_from_slots``
in both placement modes ("cell": gap-free, "bbox_gap": a 1-cell margin) give
array-equal batches, gid and local_gid planes included: both sides do the
same integer and copy work.
"""

import dataclasses

import numpy as np
import pytest

from building_gan_tpu.data import grid as jgrid

from building_gan_torch.config import Configuration
from building_gan_torch.data import grid as tgrid

from test_train import tiny_cfg


def _cfgs(small_cfg, mode, K):
    cfg = tiny_cfg(small_cfg, LAYOUT="grid", GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=128,
                   GRID_SLOT_GRAPHS=K, GRID_PACK_MODE=mode)
    return cfg, Configuration(**cfg.to_dict())


def _assert_equal_batches(got, want):
    assert got.graphs_per_slot == want.graphs_per_slot
    for f in dataclasses.fields(want):
        w = getattr(want, f.name)
        if w is None:
            assert getattr(got, f.name) is None, f.name
        else:
            np.testing.assert_array_equal(getattr(got, f.name).numpy(), np.asarray(w), err_msg=f.name)


@pytest.mark.parametrize("mode", ["cell", "bbox_gap"])
@pytest.mark.parametrize("K", [2, 3])
def test_pack_grid_multi_matches_jax(synthetic_samples, small_cfg, mode, K):
    jcfg, tcfg = _cfgs(small_cfg, mode, K)
    want = jgrid.pack_grid_multi(synthetic_samples, jcfg, batch_slots=6, graphs_per_slot=K)
    got = tgrid.pack_grid_multi(synthetic_samples, tcfg, batch_slots=6, graphs_per_slot=K)
    _assert_equal_batches(got, want)
    assert got.gid is not None and int(got.graph_mask.sum()) == len(synthetic_samples)


@pytest.mark.parametrize("mode", ["cell", "bbox_gap"])
def test_plan_and_fill_from_slots_match_jax(synthetic_samples, small_cfg, mode):
    jcfg, tcfg = _cfgs(small_cfg, mode, 3)
    jslots = jgrid.plan_packing_slots(synthetic_samples, jcfg)
    tslots = tgrid.plan_packing_slots(synthetic_samples, tcfg)
    assert [s.placed for s in tslots] == [s.placed for s in jslots]
    assert tgrid.plan_packing(synthetic_samples, tcfg) == jgrid.plan_packing(synthetic_samples, jcfg)
    n = len(tslots) + 1  # one all-null slot at the end
    want = jgrid.pack_grid_multi_from_slots(synthetic_samples, jslots, jcfg, batch_slots=n)
    got = tgrid.pack_grid_multi_from_slots(synthetic_samples, tslots, tcfg, batch_slots=n)
    _assert_equal_batches(got, want)
    assert float(got.mask[-1].sum()) == 0.0


def test_pack_grid_multi_raises_when_it_does_not_fit(synthetic_samples, small_cfg):
    _, tcfg = _cfgs(small_cfg, "cell", 1)
    with pytest.raises(ValueError, match="do not fit"):
        tgrid.pack_grid_multi(synthetic_samples, tcfg, batch_slots=2, graphs_per_slot=1)
