"""Trainer: the epoch loop with its scalar log, best-gated checkpoints and resume.

Port of ``building_gan_tpu/train/trainer.py`` (one device), which mirrors
the reference training runtime (``building_gan/src/trainer.py:580-806``):

- per epoch: the per-epoch cosine G learning rate, every train batch through
  the train step (5 critic updates and one G update each), then a no-update
  validation pass through the eval step;
- checkpoint criterion ``0.05 * min_train_f1 + 1.0 * min_val_f1``;
- the reference's 14 scalar tags an epoch, the configuration as text, the
  per-class recall tags and the per-graph F1 p10 / median / histogram;
- resume from ``log_dir`` on construction: the latest checkpoint when it is
  ahead of the best-gated one, with the quirk-Q11 ``epoch_start`` patch on
  non-improving epochs;
- the best epoch's qualitative image (``viz/render.py``) in the scalar log;
- ``test()`` prints the test split's scores, then renders test samples.

Per-batch metrics stay on the device until the epoch ends, then come to the
host in one fetch; with ``GRID_BUCKETS`` an epoch's batches come in several
grid shapes and pass through the same steps (each builds its planes per
batch), their metrics summed over the shapes.  Each epoch's draws come from one ``torch.Generator`` on
the trainer's device, seeded from ``(SEED, epoch)`` (validation from
``(SEED + 999, epoch)``, the test from ``SEED + 31337``), so a resumed run
draws from an epoch on what an uninterrupted run draws there.  Torch cannot
replay JAX's threefry, so the streams differ from the JAX package's.

With a data-parallel ``group`` (the JAX package's mesh branches) the
trainer is one rank of it: it trains its own replica on its own device
through ``parallel/dp.py``'s steps on the rank's packs (the loaders built
with ``n_device_batches`` and ``rank``), its noise from a generator derived
from the epoch's and the rank.  Every rank computes the same aggregated
scores; rank 0 alone writes the checkpoints, the scalar log, the printed
scores and the renders, and a barrier follows each checkpoint write.  Every
rank resumes from the same files.  The scalar log is TensorBoard's when
tensorboardX is installed, JSON lines otherwise (``train/writer.py``).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..checkpoint import ckpt
from ..config import PROGRAM_NAMES, Configuration
from ..data.pipeline import GraphDataLoaders, prefetch
from ..models import fast_infer
from ..ops.rng import normal_box_muller
from ..parallel import dp
from ..parallel.mesh import barrier
from ..utils.profiling import runtime_calculator
from . import metrics as M
from .state import cosine_lr, create_train_state, set_g_lr
from .step import make_eval_step, make_train_step
from .writer import NullWriter, make_writer

TRAIN_KEYS = ("g_loss", "d_loss", "f1", "precision", "recall", "accuracy")
EVAL_KEYS = ("g_loss", "f1", "precision", "recall", "accuracy")
VALIDATION_SEED_OFFSET, TEST_SEED_OFFSET = 999, 31337


def stream_generator(seed: int, epoch: Optional[int], device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with 64 bits of
    ``np.random.SeedSequence((seed, epoch))`` (or ``(seed,)``): distinct
    (seed, epoch) pairs give unrelated streams."""
    entropy = (seed,) if epoch is None else (seed, epoch)
    hi, lo = np.random.SeedSequence(entropy).generate_state(2, dtype=np.uint32)
    return torch.Generator(device=device).manual_seed((int(hi) << 32) | int(lo))


def _row(metrics: dict, keys) -> torch.Tensor:
    """One batch's scalars (``keys``, then f1_min), F1 histogram and confusion
    matrix as one f32 vector on the batch's device."""
    scalars = torch.stack([metrics[k].float() for k in keys + ("f1_min",)])
    return torch.cat([scalars, metrics["per_graph_f1_hist"].float(),
                      metrics["confusion_matrix"].float().reshape(-1)])


def _epoch_summary(rows: list, keys) -> dict:
    """Means of ``keys``, the min of f1_min and the summed histogram and matrix:
    one host fetch for the whole epoch."""
    if not rows:
        return {**{k: 0.0 for k in keys}, "f1_min": 0.0, "f1_hist": 0.0, "cm": 0.0}
    table = torch.stack(rows).cpu().numpy().astype(np.float64)  # the epoch's one sync
    n, bins = len(keys), M.F1_HIST_BINS
    out = {k: float(v) for k, v in zip(keys, table[:, :n].mean(0))}
    f1_min = float(table[:, n].min())
    out["f1_min"] = f1_min if np.isfinite(f1_min) else 0.0
    out["f1_hist"] = table[:, n + 1: n + 1 + bins].sum(0)  # epoch-summed per-graph F1 histogram
    out["cm"] = table[:, n + 1 + bins:].sum(0).reshape(7, 7)  # epoch-summed confusion matrix
    return out


class Trainer:
    """Adversarial trainer with checkpoint / resume and a scalar log.

    ``generator`` and ``discriminator`` are the port's models of the loaders'
    layout (grid, or the packed edge list), their weights initialised by the
    caller (alike on every rank); the optimizers come from the configuration
    (``train/state.py``).  Everything runs on ``device``, the card unless the
    caller asks for the CPU.  With ``group`` the trainer is one data-parallel
    rank (module docstring); its loaders must give this rank's packs.
    """

    def __init__(
        self,
        generator,
        discriminator,
        dataloaders: GraphDataLoaders,
        configuration: Configuration,
        log_dir: Optional[str] = None,
        device="cuda",
        group=None,
    ):
        self.device = torch.device(device)
        self.group = group
        self.is_writer = group is None or group.rank() == 0
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device is available; pass device='cpu' "
                               "(the CLI's --device cpu) to train on the CPU")
        self.dataloaders = dataloaders
        self.configuration = cfg = configuration
        self.sanity_checking = cfg.SANITY_CHECKING
        if log_dir is None:
            log_dir = os.path.join(cfg.LOG_DIR, time.strftime("%m-%d-%Y__%H-%M-%S"))
        self.log_dir = log_dir

        # as the JAX trainer, take one train pack at construction: a packing
        # budget that is too small raises here, and both packages' loaders then
        # stand at the same shuffle
        next(iter(self.dataloaders.train_dataloader))

        self.state = create_train_state(cfg, generator, discriminator, device=self.device)
        self.generator, self.discriminator = self.state.generator, self.state.discriminator
        if group is None:
            self.train_step = make_train_step(cfg, self.state)
            self.eval_step = make_eval_step(cfg, self.state)
        else:
            self.train_step = dp.make_parallel_train_step(cfg, self.state, group)
            self.eval_step = dp.make_parallel_eval_step(cfg, self.state, group)
        self._fast_infer_step, self._fast_infer_packed = None, None

        # auto-resume (reference trainer.py:628-636); a "latest" checkpoint
        # (CKPT_LATEST_INTERVAL) AHEAD of the best-gated one is preferred:
        # resuming best weights at a later cursor loses every epoch since the
        # last best update
        self.meta = {"epoch_start": 1, "best_f1_score": 0.0}
        best = ckpt.read_meta(self.log_dir)
        latest = ckpt.read_meta(self.log_dir, ckpt.LATEST_STATE_FILE, ckpt.LATEST_META_FILE)
        if latest is not None and (
            best is None or int(latest.get("epoch_start", 0)) > int(best.get("epoch_start", 0))
        ):
            restored, which = ckpt.load_latest(self.log_dir, self.state, self.device), "latest"
        elif best is not None:
            restored, which = ckpt.load_states(self.log_dir, self.state,
                                               map_location=self.device), "best"
        else:
            restored = None
        if restored is not None:
            self.meta.update(restored[1])
            self._say(f"Loaded {which} states from {self.log_dir}")

    def _say(self, text: str) -> None:
        if self.is_writer:
            print(text, flush=True)

    def _written(self, write, *args) -> None:
        """``write(*args)`` on rank 0, then (with a group) every rank waits for it."""
        if self.is_writer:
            write(*args)
        if self.group is not None:
            barrier(self.group, self.device)

    # ------------------------------------------------------------------
    @runtime_calculator
    def _train_each_epoch(self, epoch: int) -> dict:
        gen = stream_generator(self.configuration.SEED, epoch, self.device)
        rows = []
        for batch in prefetch(self.dataloaders.train_dataloader):
            metrics = self.train_step(batch.to(self.device, non_blocking=True), gen)
            rows.append(_row(metrics, TRAIN_KEYS))
        return _epoch_summary(rows, TRAIN_KEYS)

    def _evaluate(self, loader, gen) -> dict:
        rows = [_row(self.eval_step(batch.to(self.device, non_blocking=True), gen), EVAL_KEYS)
                for batch in loader]
        return _epoch_summary(rows, EVAL_KEYS)

    @runtime_calculator
    def _validate_each_epoch(self, epoch: int) -> dict:
        if self.sanity_checking or self.dataloaders.validation_dataloader is None:
            return {k: 0.0 for k in EVAL_KEYS + ("f1_min",)}
        gen = stream_generator(self.configuration.SEED + VALIDATION_SEED_OFFSET, epoch, self.device)
        return self._evaluate(self.dataloaders.validation_dataloader, gen)

    # ------------------------------------------------------------------
    def train(self):
        cfg = self.configuration
        writer = make_writer(self.log_dir) if self.is_writer else NullWriter()
        self._say(f"Scalar log: {type(writer).__module__}.{type(writer).__name__} in {self.log_dir}")
        for key, value in cfg.to_dict().items():
            writer.add_text(f"configuration/{key}", str(value))

        epoch_start = int(self.meta.get("epoch_start", 1))
        epoch_end = cfg.EPOCHS + 1
        best_f1_score = float(self.meta.get("best_f1_score", 0.0))

        for epoch in range(epoch_start, epoch_end):
            # per-epoch cosine G LR: the reference CosineAnnealingLR trajectory
            set_g_lr(self.state, cosine_lr(cfg, epoch))
            tr = self._train_each_epoch(epoch)
            va = self._validate_each_epoch(epoch)

            current_f1_score = (
                tr["f1_min"] * cfg.F1_SCORE_TRAIN_WEIGHT
                + va["f1_min"] * cfg.F1_SCORE_VALIDATION_WEIGHT
            )
            self._say(
                f"epoch {epoch}: g_loss={tr['g_loss']:.4f} d_loss={tr['d_loss']:.4f} "
                f"f1={tr['f1']:.4f}/{va['f1']:.4f} f1_min={tr['f1_min']:.4f}/{va['f1_min']:.4f} "
                f"acc={tr['accuracy']:.4f}/{va['accuracy']:.4f}"
            )

            # the reference's scalar tags (trainer.py:680-693)
            for tag, value in (
                ("g_loss_train", tr["g_loss"]),
                ("d_loss_train", tr["d_loss"]),
                ("g_loss_validation", va["g_loss"]),
                ("f1_score_train", tr["f1"]),
                ("f1_score_validation", va["f1"]),
                ("f1_score_min_train", tr["f1_min"]),
                ("f1_score_min_validation", va["f1_min"]),
                ("f1_score_min_weightedsum", current_f1_score),
                ("precision_score_train", tr["precision"]),
                ("precision_score_validation", va["precision"]),
                ("recall_score_train", tr["recall"]),
                ("recall_score_validation", va["recall"]),
                ("accuracy_score_train", tr["accuracy"]),
                ("accuracy_score_validation", va["accuracy"]),
            ):
                writer.add_scalar(tag, value, epoch)

            # per-class recall from the epoch-summed confusion matrix: the
            # test-split min-F1 is driven by rare-class single-voxel instances
            for tag, d in (("train", tr), ("validation", va)):
                cm = np.asarray(d.get("cm", 0.0))
                if cm.ndim != 2:
                    continue
                support = cm.sum(axis=1)
                for c, name in PROGRAM_NAMES.items():
                    if support[c] > 0:
                        writer.add_scalar(f"recall_{name.lower()}_{tag}",
                                          float(cm[c, c] / support[c]), epoch)

            # per-graph F1 distribution: p10 / median from the epoch histogram,
            # its min the exact epoch f1_min
            for tag, d in (("train", tr), ("validation", va)):
                hist = np.asarray(d.get("f1_hist", 0.0))
                if hist.ndim != 1 or hist.sum() <= 0:
                    continue
                writer.add_scalar(f"f1_score_p10_{tag}", M.hist_quantile(hist, 0.10), epoch)
                writer.add_scalar(f"f1_score_median_{tag}", M.hist_quantile(hist, 0.50), epoch)
                bins = hist.shape[0]
                centers = (np.arange(bins) + 0.5) / bins
                writer.add_histogram_raw(
                    f"per_graph_f1_{tag}",
                    min=float(d["f1_min"]),
                    max=float(M.hist_quantile(hist, 1.0)),
                    num=int(hist.sum()),
                    sum=float((hist * centers).sum()),
                    sum_squares=float((hist * centers**2).sum()),
                    bucket_limits=((np.arange(bins) + 1.0) / bins).tolist(),
                    bucket_counts=hist.tolist(),
                    global_step=epoch,
                )

            if best_f1_score < current_f1_score:
                self._say(f"Best f1 score updated: {best_f1_score} -> {current_f1_score}")
                best_f1_score = current_f1_score
                if not self.sanity_checking:
                    self._written(ckpt.save_states, self.log_dir, self.state, {
                        "epoch_start": epoch,
                        "epoch_end": epoch_end,
                        "best_f1_score": best_f1_score,
                        "f1_score_train": tr["f1"],
                        "f1_score_validation": va["f1"],
                        "f1_score_min_train": tr["f1_min"],
                        "f1_score_min_validation": va["f1_min"],
                        "f1_score_min_weightedsum": current_f1_score,
                        "recall_score_train": tr["recall"],
                        "recall_score_validation": va["recall"],
                        "accuracy_score_train": tr["accuracy"],
                        "accuracy_score_validation": va["accuracy"],
                    })
                fig = self._render_sample(epoch) if self.is_writer else None
                if fig is not None:
                    writer.add_image(f"epoch_{epoch}", fig, epoch)
            elif not self.sanity_checking and ckpt.exists(self.log_dir):
                self._written(ckpt.patch_epoch_start, self.log_dir, epoch)  # quirk Q11

            interval = int(getattr(cfg, "CKPT_LATEST_INTERVAL", 0) or 0)
            if interval and not self.sanity_checking and epoch % interval == 0:
                self._written(ckpt.save_latest, self.log_dir, self.state, {
                    "epoch_start": epoch + 1,
                    "epoch_end": epoch_end,
                    "best_f1_score": best_f1_score,
                    "is_latest": True,
                })

        writer.close()

    # ------------------------------------------------------------------
    def _render_sample(self, epoch: int):
        """The best epoch's qualitative image (CHW uint8) for the scalar log, or None."""
        try:
            from ..viz.render import evaluate_qualitatively

            return evaluate_qualitatively(self, epoch=epoch, num_samples_to_viz=1, to_tensor=True)
        except Exception as e:  # rendering must never kill training
            print(f"render skipped: {e}")
            return None

    @torch.no_grad()
    def generate(self, batch, generator: torch.Generator):
        """One generator forward at eval time -> (logits, label_hard, label_soft).

        On the fused route (a GATCONV grid generator) the hourglass runs fused
        (``models/fast_infer.py``: the serving kernel on the card); any other
        generator runs its plain module.  z and then the Gumbel noise are drawn
        from ``generator``.
        """
        z = normal_box_muller(tuple(batch.cell_mask.shape) + (self.configuration.Z_DIM,), generator)
        if not fast_infer.fused_route(self.generator):
            return self.generator(batch, z, generator=generator)
        if self._fast_infer_step != self.state.step:
            self._fast_infer_packed = fast_infer.prepare(self.generator, self.configuration)
            self._fast_infer_step = self.state.step
        return fast_infer.infer(self.generator, self._fast_infer_packed, batch, z,
                                generator=generator)

    @runtime_calculator
    def test(self, num_samples_to_viz: int = 0, show: bool = False) -> dict:
        """Test-split scores (reference trainer.py:749-806): printed, and returned; then
        ``num_samples_to_viz`` test buildings rendered (``viz/render.py``, best-of-1).
        With a group every rank evaluates its packs; rank 0 prints and renders."""
        loader = self.dataloaders.test_dataloader
        if loader is None:
            raise ValueError("no test split (sanity mode, or too few buildings)")
        gen = stream_generator(self.configuration.SEED + TEST_SEED_OFFSET, None, self.device)
        out = self._evaluate(loader, gen)
        out = {k: out[k] for k in ("f1", "precision", "recall", "accuracy", "f1_min")}
        self._say(
            f"""
            f1_score_test: {out['f1']}
            f1_score_min_test: {out['f1_min']}
            precision_score_test: {out['precision']}
            recall_score_test: {out['recall']}
            accuracy_score_test: {out['accuracy']}
            """
        )
        if num_samples_to_viz > 0 and self.is_writer:
            from ..viz.render import evaluate_qualitatively

            strip = evaluate_qualitatively(self, epoch=None, num_samples_to_viz=num_samples_to_viz,
                                           to_tensor=True, use_test_dataset=True, show=show)
            print(f"rendered {num_samples_to_viz} test samples: a {tuple(strip.shape)} CHW uint8 strip")
        return out
