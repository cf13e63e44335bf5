"""Classification metrics from masked confusion matrices, on either layout.

Port of ``building_gan_tpu/train/metrics.py``: the 7 x 7
confusion matrix (rows true, columns predicted) and sklearn's
``average='macro', zero_division=0`` semantics: per-class precision / recall
/ F1 with 0 where a denominator is 0, the macro mean over the classes
present in y_true or y_pred.  Per-graph scores come from per-graph
matrices: per slot, or per (slot, building) on a K > 1 grid batch, or per
graph id of a packed batch (one scatter-add, the padding's dummy graph dropped).
``hist_quantile`` reads the trainer's epoch-summed per-graph F1 histogram on
the host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import NUM_CLASSES
from ..parallel.sp import all_reduce_sum
from ..ops.segment import segment_sum

F1_HIST_BINS = 32


def scores_from_cm(cm: torch.Tensor) -> dict:
    """Macro precision / recall / F1 and accuracy of one or a stack of (7, 7) matrices."""
    tp = torch.diagonal(cm, dim1=-2, dim2=-1)
    support_true = cm.sum(-1)
    support_pred = cm.sum(-2)
    present = ((support_true + support_pred) > 0).to(cm.dtype)
    n_present = present.sum(-1).clamp(min=1.0)
    zero = torch.zeros_like(tp)
    precision = torch.where(support_pred > 0, tp / support_pred.clamp(min=1.0), zero)
    recall = torch.where(support_true > 0, tp / support_true.clamp(min=1.0), zero)
    pr = precision + recall
    f1 = torch.where(pr > 0, 2.0 * precision * recall / pr.clamp(min=1e-12), zero)
    total = cm.sum((-2, -1)).clamp(min=1.0)
    return {
        "precision": (precision * present).sum(-1) / n_present,
        "recall": (recall * present).sum(-1) / n_present,
        "f1": (f1 * present).sum(-1) / n_present,
        "accuracy": tp.sum(-1) / total,
    }


def confusion_matrix(y_true, y_pred, mask) -> torch.Tensor:
    """(7, 7) matrix of 1-D labels, rows true, columns predicted; masked entries excluded."""
    idx = y_true.long() * NUM_CLASSES + y_pred.long()
    return segment_sum(mask.float(), idx, NUM_CLASSES * NUM_CLASSES).reshape(NUM_CLASSES, NUM_CLASSES)


def per_graph_confusion_matrices(y_true, y_pred, mask, graph_id, num_graphs: int) -> torch.Tensor:
    """(G, 7, 7) per-graph matrices of a packed batch; graph id G (the padding) is dropped."""
    idx = (graph_id.long() * NUM_CLASSES + y_true.long()) * NUM_CLASSES + y_pred.long()
    flat = segment_sum(mask.float(), idx, (num_graphs + 1) * NUM_CLASSES * NUM_CLASSES)
    return flat.reshape(num_graphs + 1, NUM_CLASSES, NUM_CLASSES)[:num_graphs]


def grid_confusion_matrices(y_true, y_pred, mask, gid=None, num_graphs: int = 1) -> torch.Tensor:
    """(B, 7, 7) per-slot matrices, or (B, K, 7, 7) per building when ``gid`` keys K > 1."""
    oh_p = F.one_hot(y_pred.long(), NUM_CLASSES).float()
    if gid is not None and num_graphs > 1:
        oh_kt = F.one_hot(gid.long() * NUM_CLASSES + y_true.long(), num_graphs * NUM_CLASSES).float()
        oh_kt = oh_kt * mask.float()[..., None]
        cms = torch.einsum("bfyxt,bfyxp->btp", oh_kt, oh_p)
        return cms.reshape(mask.shape[0], num_graphs, NUM_CLASSES, NUM_CLASSES)
    oh_t = F.one_hot(y_true.long(), NUM_CLASSES).float() * mask.float()[..., None]
    return torch.einsum("bfyxt,bfyxp->btp", oh_t, oh_p)


def per_graph_f1_hist(per_graph_f1, graph_mask, bins: int = F1_HIST_BINS) -> torch.Tensor:
    """(bins,) count histogram of per-graph F1 over real graphs; F1 == 1 lands in the last bin."""
    idx = (per_graph_f1 * bins).to(torch.int32).clamp(0, bins - 1)
    oh = F.one_hot(idx.long(), bins).float()
    w = (graph_mask > 0).float()
    return (oh * w[..., None]).reshape(-1, bins).sum(0)


def hist_quantile(hist, q: float) -> float:
    """Quantile ``q`` of a per-graph F1 count histogram, as a bin center (host side).

    The smallest bin whose cumulative count reaches ``q`` of the total; q = 0
    gives the first non-empty bin.  An empty histogram gives 0.
    """
    hist = np.asarray(hist, dtype=np.float64)
    total = hist.sum()
    if total <= 0:
        return 0.0
    bins = hist.shape[0]
    i = int(np.searchsorted(np.cumsum(hist), max(q * total, 1e-12), side="left"))
    return (min(i, bins - 1) + 0.5) / bins


def _min_over_real(per_graph_f1, graph_mask) -> torch.Tensor:
    inf = torch.full_like(per_graph_f1, float("inf"))
    f1_min = torch.where(graph_mask > 0, per_graph_f1, inf).min()
    return torch.where(torch.isfinite(f1_min), f1_min, torch.zeros_like(f1_min))


def compute_metrics(y_true, y_pred, mask, graph_mask, gid=None,
                    num_graphs_per_slot: int = 1, graph_id=None, sp=None) -> dict:
    """Batch macro scores and the min per-graph F1 over real graphs.

    Grid: ``(B, F, Y, X)`` labels; graphs are slots, or (slot, gid) with K > 1.
    Packed: 1-D labels with their ``graph_id`` (padding at G = ``graph_mask``'s length).
    With a floor shard ``sp`` (``parallel/sp.py``) the labels are this rank's floors:
    the per-building matrices are summed over the ranks before any score, so every
    rank scores the whole buildings (a building split across floors has one F1).
    """
    if graph_id is not None:
        cm = confusion_matrix(y_true, y_pred, mask)
        cms = per_graph_confusion_matrices(y_true, y_pred, mask, graph_id, graph_mask.shape[0])
    else:
        cms = grid_confusion_matrices(y_true, y_pred, mask, gid, num_graphs_per_slot)
        if sp is not None:
            (cms,) = all_reduce_sum(sp, cms)
        cm = cms.reshape(-1, NUM_CLASSES, NUM_CLASSES).sum(0)
    batch_scores = scores_from_cm(cm)
    per_graph = scores_from_cm(cms)
    return {
        **batch_scores,
        "f1_min": _min_over_real(per_graph["f1"], graph_mask),
        "confusion_matrix": cm,
        "per_graph_f1": per_graph["f1"],
        "per_graph_f1_hist": per_graph_f1_hist(per_graph["f1"], graph_mask),
    }
