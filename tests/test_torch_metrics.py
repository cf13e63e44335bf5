"""The port's confusion-matrix metrics vs the JAX package's (CPU).

``compute_metrics`` on given labels at K = 1 (per-slot graphs) and K = 6
(per-building graphs keyed on gid): every output equal to JAX's within 1e-6 (counts are exact;
the scores are f32 divisions done in the same order).  Labels draw from a
subset of classes so that sklearn's "classes present" macro mean and its
zero-division rule both matter.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_gan_tpu.train import metrics as JM

from building_gan_torch.train import metrics as TM

from test_torch_layers import t
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

KEYS = ("f1", "f1_min", "precision", "recall", "accuracy", "confusion_matrix", "per_graph_f1",
        "per_graph_f1_hist")


def _compare(got, want):
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("K", [1, 6])
def test_grid_metrics_match_jax(K):
    rng = np.random.default_rng(K)
    shape = (4, 3, 5, 5)
    y_true = rng.choice([0, 1, 4, 6], size=shape)
    y_pred = np.where(rng.random(shape) < 0.6, y_true, rng.choice([0, 2, 4, 6], size=shape))
    mask = (rng.random(shape) < 0.8).astype(np.float32)
    gid = rng.integers(0, K, shape) if K > 1 else None
    graph_mask = np.ones((4, K) if K > 1 else (4,), np.float32)
    graph_mask[-1] = 0.0  # a null slot takes no part in f1_min
    want = JM.compute_metrics(jnp.array(y_true), jnp.array(y_pred), jnp.array(mask), None,
                              jnp.array(graph_mask), gid=None if gid is None else jnp.array(gid),
                              num_graphs_per_slot=K)
    got = TM.compute_metrics(t(y_true), t(y_pred), t(mask), t(graph_mask),
                             gid=None if gid is None else t(gid), num_graphs_per_slot=K)
    _compare(got, want)
    assert float(got["confusion_matrix"].sum()) == mask.sum()


def test_scores_zero_division():
    cm = torch.zeros(7, 7)
    cm[0, 0], cm[0, 3] = 5.0, 2.0  # class 3 predicted, never true: precision 0
    got = TM.scores_from_cm(cm)
    want = JM._scores_from_cm(jnp.array(cm.numpy()))
    for k in ("precision", "recall", "f1", "accuracy"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6)
