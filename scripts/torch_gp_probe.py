"""Probe the gradient penalty of the port's grid critic on the card, one critic update at a time.

Trains fresh plain models (weights from ``torch.manual_seed(cfg.SEED)``, step
draws from ``torch.Generator(device).manual_seed(0)``, as ``chip_smoke.py``'s
``plain_steps`` does) on ``chip_smoke.py``'s training batch (512 real-scale
buildings, K=6, 105 slots, the config of record's widths) at the conv and the
compute dtypes asked for, and prints each critic update's GP term.  The
first update whose GP exceeds
``--threshold`` is taken apart:

- its GP per building (slot, gid), the largest first, with the building's
  largest per-cell gradient norm;
- the same GP (same weights, labels, eps and dropout keys) with the critic's
  activations at f32 and at f64;
- for the worst building, each GraphNorm layer's variance as the layer
  computes it (one pass, the squares in x's dtype) against the exact
  two-pass variance of the same inputs in f64, on the channel where they
  differ the most;

and the worst building's slot is run alone (its dropout masks given, as the
full batch drew them), then saved with the critic's weights, its inputs and
masks (``<out>/gp_slot_<dtype>.pt``) for ``scripts/torch_gp_replay.py``,
which runs it through the JAX critic and the port's on the CPU.

Run on the card:  python3 scripts/torch_gp_probe.py --conv GRAPHCONV
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the training batch)
from building_gan_torch.models import grid_layers as GL  # noqa: E402
from building_gan_torch.models.grid_models import (  # noqa: E402
    GridVoxelGNNDiscriminator, GridVoxelGNNGenerator,
)
from building_gan_torch.ops import dropout as drop  # noqa: E402
from building_gan_torch.train import losses as L  # noqa: E402
from building_gan_torch.train import step as S  # noqa: E402
from building_gan_torch.train.state import create_train_state  # noqa: E402


def per_building(values, batch):
    """Sum per-cell ``values`` (B, F, Y, X) per (slot, gid): (B, K)."""
    return batch.per_graph_sum(values * batch.mask)


def gp_parts(d_apply, types_onehot, label_soft, mask, eps):
    interp = (eps * types_onehot + (1.0 - eps) * label_soft).detach().requires_grad_(True)
    scores = d_apply(interp)
    (grads,) = torch.autograd.grad((scores[..., 0] * mask).sum(), interp)
    norms = torch.sqrt((grads.double() ** 2).sum(-1) + 1e-12)
    return norms, ((norms - 1.0) ** 2)


def norm_stats(x, mask, gid, K, b, k):
    """(computed var, exact var) of building (b, k) per channel, as graph_norm takes them."""
    sel = ((gid[b] == k) & (mask[b] > 0))
    xs = x[b][sel]  # (n, C) in x's dtype
    n = xs.shape[0]
    sq = (xs * xs).float() if K > 1 else xs.float() * xs.float()
    mean, ex2 = xs.float().sum(0) / n, sq.sum(0) / n
    return ex2, mean, xs.double().var(0, unbiased=False), xs.double().mean(0)


def probe(cfg, batch, slots, dev, steps, threshold, out, dt_name):
    c = cfg.replace(COMPUTE_DTYPE=dt_name)
    torch.manual_seed(c.SEED)
    state = create_train_state(c, GridVoxelGNNGenerator(c), GridVoxelGNNDiscriminator(c),
                               device=dev)
    disc = state.discriminator
    step = S.make_train_step(c, state)
    gen = torch.Generator(device=dev).manual_seed(0)
    last_keys = {}
    draw = S.draw_keys

    def draw_keys(n, g):
        last_keys["k"] = draw(n, g)
        return last_keys["k"]

    seen = {"done": False, "i": 0}
    orig_gp = L.gradient_penalty

    def gradient_penalty(d_apply, types_onehot, label_soft, mask, lam, eps=None, generator=None):
        v = orig_gp(d_apply, types_onehot, label_soft, mask, lam, eps=eps, generator=generator)
        seen["i"] += 1
        print(f"  [{dt_name}] critic update {seen['i']}: GP {v.item():.6f}", flush=True)
        if v.item() > threshold and not seen["done"]:
            seen["done"] = True
            analyse(d_apply, types_onehot, label_soft, mask, eps, lam)
        return v

    def analyse(d_apply, types_onehot, label_soft, mask, eps, lam):
        keys = last_keys["k"]
        norms, pen = gp_parts(d_apply, types_onehot, label_soft, mask, eps)
        per_b = per_building(pen, batch) * lam / mask.sum()
        top = torch.argsort(per_b.flatten(), descending=True)[:5].tolist()
        K = batch.graphs_per_slot
        for f in top:
            b, k = divmod(f, K)
            sel = (batch.gid[b] == k) & (batch.mask[b] > 0)
            print(f"  [{dt_name}]   building slot {b} gid {k} (sample {slots[b].placed[k][0]}, "
                  f"{int(sel.sum())} cells): GP share {per_b[b, k].item():.6g}, largest cell "
                  f"gradient norm {norms[b][sel].max().item():.6g}", flush=True)
        for other in (torch.float32, torch.float64):
            dd = disc.double() if other == torch.float64 else disc
            try:
                _, p = gp_parts(lambda lab: dd(batch, lab, deterministic=False, keys=keys,
                                               dtype=other), types_onehot.to(other),
                                label_soft.to(other), mask.to(other), eps.to(other))
                print(f"  [{dt_name}]   the same GP with {other} activations: "
                      f"{(p * mask).sum().item() / mask.sum().item() * lam:.6g}", flush=True)
            finally:
                disc.float()
        b, k = divmod(top[0], K)
        caught = []
        hooks = [m.register_forward_hook(lambda mod, a, kw, out_: caught.append((a, kw)),
                                         with_kwargs=True)
                 for m in disc.encoder.modules() if isinstance(m, GL.GridGraphNorm)]
        try:
            with torch.no_grad():
                d_apply((eps * types_onehot + (1.0 - eps) * label_soft))
        finally:
            for h in hooks:
                h.remove()
        for li, (a, kw) in enumerate(caught):
            x, m_, g_ = a[0], a[1], kw.get("gid", a[2] if len(a) > 2 else None)
            ex2, mean, var64, mean64 = norm_stats(x, m_, g_, K, b, k)
            mod = [m for m in disc.encoder.modules() if isinstance(m, GL.GridGraphNorm)][li]
            ms = mod.mean_scale.detach().float()
            s = mean * ms
            var = torch.clamp(ex2 - 2.0 * s * mean + s * s, min=0.0)
            s64 = mean64 * ms.double()
            vexact = var64 + (mean64 - s64) ** 2  # E[(x - s)^2], what the one-pass form estimates
            ratio = torch.sqrt((vexact + mod.eps) / (var.double() + mod.eps))
            ch = int(torch.argmax(ratio))
            print(f"  [{dt_name}]   norm {li}: worst channel {ch}: computed var "
                  f"{var[ch].item():.6g}, exact {vexact[ch].item():.6g} (E[x] {mean64[ch].item():.6g},"
                  f" Var x {var64[ch].item():.6g}); scale off by x{ratio[ch].item():.4g}; channels "
                  f"with computed var 0: {int((var == 0).sum())} of {var.numel()}", flush=True)
        # the worst building's slot alone, with the full batch's dropout masks of that slot
        R = batch.mask[0].numel()
        masks = [drop.keep_mask((batch.mask.shape[0], R, co), keys[i], drop.drop_levels(
            c.ENCODER_DROPOUT_RATE), width=disc.encoder.hidden_dim)[b:b + 1]
            for i, co in enumerate(disc.encoder.channels)]
        sl = {f.name: (None if getattr(batch, f.name) is None else getattr(batch, f.name)[b:b + 1])
              for f in dataclasses.fields(batch)}
        alone = type(batch)(**sl)
        given = iter(masks)
        keep = drop._keep
        drop._keep = lambda *a: next(given)
        try:
            norms1, _ = gp_parts(lambda lab: disc(alone, lab, deterministic=False, keys=keys),
                                 types_onehot[b:b + 1], label_soft[b:b + 1], alone.mask,
                                 eps[b:b + 1])
        finally:
            drop._keep = keep
        sel = (alone.gid[0] == k) & (alone.mask[0] > 0)
        print(f"  [{dt_name}]   slot {b} alone, its masks given: building {k}'s largest cell "
              f"gradient norm {norms1[0][sel].max().item():.6g}", flush=True)
        os.makedirs(out, exist_ok=True)
        torch.save({"batch": {n: None if v is None else v.cpu() for n, v in sl.items()},
                    "types_onehot": types_onehot[b:b + 1].cpu(),
                    "label_soft": label_soft[b:b + 1].cpu(), "eps": eps[b:b + 1].cpu(),
                    "keys": keys.cpu(), "masks": [m.cpu() for m in masks], "gid": k,
                    "critic": {n: v.cpu() for n, v in disc.state_dict().items()},
                    "cfg": dataclasses.asdict(c)}, os.path.join(out, f"gp_slot_{dt_name}.pt"))

    S.draw_keys, L.gradient_penalty = draw_keys, gradient_penalty
    try:
        for i in range(steps):
            m = step(batch, gen)
            print(f"[{dt_name}] step {i + 1}: g_loss {m['g_loss'].item():.6f} d_loss "
                  f"{m['d_loss'].item():.6f}", flush=True)
    finally:
        S.draw_keys, L.gradient_penalty = draw, orig_gp


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--conv", default="GRAPHCONV")
    ap.add_argument("--dtypes", default="bfloat16,float32")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--buildings", type=int, default=chip_smoke.TRAIN_BUILDINGS)
    ap.add_argument("--threshold", type=float, default=100.0)
    ap.add_argument("--out", default="gp_probe_out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    chip_smoke.TRAIN_BUILDINGS = args.buildings
    if args.device == "cuda":
        print(chip_smoke.card_line(), flush=True)  # nvidia-smi's name and power limit
    cfg, batch = chip_smoke.train_batch()
    from building_gan_torch.data import plan_packing_slots

    slots = plan_packing_slots(list(chip_smoke.train_samples()), cfg)
    cfg = cfg.replace(GENERATOR_CONV_TYPE=args.conv, DISCRIMINATOR_CONV_TYPE=args.conv)
    batch = batch.to(args.device)
    print(f"{args.conv}: {batch.mask.shape[0]} slots, K={batch.graphs_per_slot}, N_CRITIC "
          f"{cfg.N_CRITIC}, GP_DTYPE {cfg.GP_DTYPE}", flush=True)
    for dt in args.dtypes.split(","):
        probe(cfg, batch, slots, args.device, args.steps, args.threshold, args.out, dt)


if __name__ == "__main__":
    main()
