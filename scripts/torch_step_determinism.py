"""Is the port's WGAN-GP train step bit-reproducible on the card?

The data-parallel checks of ``chip_smoke.py`` (phase 13) hold a rank's step
against the one-device step at rtol 1e-4 / atol 1e-6 in the parameters.  A
bias in front of a GraphNorm has a gradient of rounding noise only, and Adam
turns the sign of that noise into a +-lr step, so two runs of one step agree
there only if every sum in the step adds in the same order both times.  This
script runs the one-device step (the config of record, f32 with TF32 off, the
first 54 slots of ``chip_smoke.py``'s train batch, K = 6) twice from the same
weights and draws, then twice more with ``torch.use_deterministic_algorithms``
(``warn_only``), and prints for each pair the parameters that differ, the
largest difference, and the operations that warned they have no deterministic
implementation on CUDA.  Then, at f32, it runs each piece of the step twice
on the same inputs (the fused and the plain critic, forward and parameter
gradients; the gradient penalty through the plain critic and its double
backward; the fused and the plain generator) and prints which pieces differ
between their two runs; then two whole steps with every Adam update's
gradients recorded (the first record that differs); then the step and the
pieces again after the allocator's free memory was filled with NaN, and with
7: a result that changes reads memory nothing wrote.

    python scripts/torch_step_determinism.py
    python scripts/torch_step_determinism.py --first  # the pieces twice, then a recorded pair
    python scripts/torch_step_determinism.py --pairs [--cublas]  # two recorded pairs first
        # (--cublas: matmuls through cuBLAS instead of cuBLASLt)
"""

from __future__ import annotations

import os
import sys
import warnings
from collections import Counter

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # before any cuBLAS handle
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def step_params(cfg, pack, dev):
    from building_gan_torch.train.step import make_train_step

    state = cs.dp_state(cfg, dev)
    make_train_step(cfg, state)(pack, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize(dev)
    return cs.dp_params(state)


def compare(label, a, b):
    differ = {k: (a[k] - b[k]).abs().max().item() for k in a if not torch.equal(a[k], b[k])}
    worst = max(differ.values(), default=0.0)
    print(f"{label}: {len(differ)} of {len(a)} parameters differ, max abs {worst:.3e}; "
          f"largest: {sorted(differ.items(), key=lambda kv: -kv[1])[:4]}", flush=True)


def twice(label, fn, params):
    """fn() -> output, run twice; prints whether the outputs and the gradients of
    sum(output * a fixed cotangent) w.r.t. ``params`` are equal bit for bit."""
    runs = []
    for _ in range(2):
        for p in params:
            p.grad = None
        out = fn()
        cot = torch.linspace(-1.0, 1.0, out.numel(), device=out.device).reshape(out.shape)
        (out.float() * cot).sum().backward()
        torch.cuda.synchronize()
        runs.append((out.detach().clone(), [None if p.grad is None else p.grad.clone() for p in params]))
    (o1, g1), (o2, g2) = runs
    differ = sum(not (a is None and b is None or a is not None and b is not None and torch.equal(a, b))
                 for a, b in zip(g1, g2))
    worst = max(((a - b).abs().max().item() for a, b in zip(g1, g2)
                 if a is not None and b is not None), default=0.0)
    print(f"{label}: output equal {torch.equal(o1, o2)} (max abs {(o1 - o2).abs().max().item():.3e}); "
          f"{differ} of {len(params)} parameter gradients differ (max abs {worst:.3e})", flush=True)


def pieces(cfg, pack, dev):
    """Each piece of the f32 step twice on the same inputs."""
    import torch.nn.functional as F

    from building_gan_torch.models import fast_train as FT
    from building_gan_torch.ops.dropout import draw_keys
    from building_gan_torch.ops.gat_train import build_planes
    from building_gan_torch.train import losses as L

    state = cs.dp_state(cfg, dev)
    gen, disc = state.generator, state.discriminator
    g = torch.Generator(device=dev).manual_seed(3)
    mask = pack.cell_mask
    planes = build_planes(mask, pack.gid, pack.grid_shape)
    types = F.one_hot(pack.cell_type.long(), 7).float() * mask[..., None]
    soft = torch.softmax(torch.randn(tuple(mask.shape) + (7,), generator=g, device=dev), -1)
    eps = torch.rand(tuple(mask.shape) + (1,), generator=g, device=dev)
    z = torch.randn(tuple(mask.shape) + (cfg.Z_DIM,), generator=g, device=dev)
    noise = -torch.log(-torch.log(torch.rand(tuple(mask.shape) + (7,), generator=g, device=dev)
                                  .clamp(1e-6, 1 - 1e-6)))
    dk, gk = draw_keys(disc.dropout_sites, g), draw_keys(gen.dropout_sites, g)
    dp_, gp_ = list(disc.parameters()), list(gen.parameters())
    twice("fused critic", lambda: FT.discriminator_apply_fused(disc, cfg, pack, soft, dk,
                                                               planes=planes), dp_)
    twice("plain critic", lambda: disc(pack, soft, deterministic=False, keys=dk), dp_)
    twice("gradient penalty (plain critic, double backward)", lambda: L.gradient_penalty(
        lambda lbl: disc(pack, lbl, deterministic=False, keys=dk), types, soft, mask,
        cfg.LAMBDA_GP, eps=eps).reshape(1), dp_)
    twice("fused generator", lambda: FT.generator_apply_fused(
        gen, cfg, pack, z, gumbel_noise=noise, keys=gk, planes=planes)[0], gp_)
    twice("plain generator", lambda: gen(pack, z, gumbel_noise=noise, deterministic=False,
                                         keys=gk)[0], gp_)


def first_difference(cfg, pack, dev):
    """Two f32 steps from the same weights and draws, every Adam update's gradients and
    every fused generator and critic call's output recorded: the first that differs."""
    from building_gan_torch.models import fast_train as FT
    from building_gan_torch.train.step import make_train_step

    runs = []
    fg, fd = FT.generator_apply_fused, FT.discriminator_apply_fused
    for _ in range(2):
        log = []

        def rec(name, fn):
            def wrapped(*a, **k):
                out = fn(*a, **k)
                first = out[0] if isinstance(out, tuple) else out
                log.append((name, first.detach().clone()))
                return out
            return wrapped

        FT.generator_apply_fused = rec("fused generator output", fg)
        FT.discriminator_apply_fused = rec("fused critic output", fd)
        state = cs.dp_state(cfg, dev)
        for name, opt, mod in (("critic", state.opt_d, state.discriminator),
                               ("generator", state.opt_g, state.generator)):
            def step(*a, _o=opt.step, _n=name, _m=mod, **k):
                for pn, p in _m.named_parameters():
                    if p.grad is not None:
                        log.append((f"{_n} update gradient {pn}", p.grad.clone()))
                return _o(*a, **k)
            opt.step = step
        try:
            make_train_step(cfg, state)(pack, torch.Generator(device=dev).manual_seed(0))
        finally:
            FT.generator_apply_fused, FT.discriminator_apply_fused = fg, fd
        torch.cuda.synchronize(dev)
        runs.append(log)
    a, b = runs
    print(f"first difference: {len(a)} / {len(b)} records", flush=True)
    for i, ((na, ta), (nb, tb)) in enumerate(zip(a, b)):
        if na != nb or not torch.equal(ta, tb):
            print(f"first difference at record {i}: {na} (max abs "
                  f"{(ta.float() - tb.float()).abs().max().item():.3e}, of max "
                  f"{ta.float().abs().max().item():.3e})", flush=True)
            return
    print("no difference in any record", flush=True)


def poison(dev, value: float, gib: float = 24.0) -> None:
    """Fill ~gib GiB of the caching allocator's free blocks with ``value``: tensors of many
    sizes allocated, filled and freed, so the next allocations start as ``value``."""
    held, left, size = [], int(gib * 2**30), 2**16
    while left > 0:
        n = min(size, left) // 4
        held.append(torch.full((n,), value, device=dev))
        left -= 4 * n
        size = size * 2 if size < 2**29 else 2**16
    del held
    torch.cuda.synchronize(dev)


def poisoned(label, fn, dev):
    """fn() (-> a list of tensors) after the free memory was filled with NaN, then with 7:
    whether the results are finite and equal (they depend on memory nothing wrote)."""
    out = []
    for value in (float("nan"), 7.0):
        poison(dev, value)
        out.append([t.detach().float().clone() for t in fn()])
    finite = all(torch.isfinite(t).all().item() for t in out[0])
    same = all(torch.equal(a, b) for a, b in zip(*out))
    worst = max((a - b).abs().nan_to_num(float("inf")).max().item() for a, b in zip(*out))
    print(f"poisoned free memory, {label}: finite after NaN {finite}, NaN-poisoned == 7-poisoned "
          f"{same} (max abs {worst:.3e})", flush=True)


def poisoned_pieces(cfg, pack, dev):
    import torch.nn.functional as F

    from building_gan_torch.models import fast_train as FT
    from building_gan_torch.ops.dropout import draw_keys
    from building_gan_torch.ops.gat_train import build_planes

    poisoned("f32 step (parameters)", lambda: list(step_params(cfg, pack, dev).values()), dev)
    state = cs.dp_state(cfg, dev)
    gen, disc = state.generator, state.discriminator
    g = torch.Generator(device=dev).manual_seed(3)
    mask = pack.cell_mask
    soft = torch.softmax(torch.randn(tuple(mask.shape) + (7,), generator=g, device=dev), -1)
    z = torch.randn(tuple(mask.shape) + (cfg.Z_DIM,), generator=g, device=dev)
    dk, gk = draw_keys(disc.dropout_sites, g), draw_keys(gen.dropout_sites, g)

    def grads(fn, module):
        module.zero_grad(set_to_none=True)
        planes = build_planes(mask, pack.gid, pack.grid_shape)
        out = fn(planes)
        cot = torch.linspace(-1.0, 1.0, out.numel(), device=dev).reshape(out.shape)
        (out.float() * cot).sum().backward()
        return [out] + [p.grad for p in module.parameters() if p.grad is not None]

    poisoned("fused critic (output, parameter gradients)", lambda: grads(
        lambda pl: FT.discriminator_apply_fused(disc, cfg, pack, soft, dk, planes=pl), disc), dev)
    poisoned("fused generator (logits, parameter gradients)", lambda: grads(
        lambda pl: FT.generator_apply_fused(gen, cfg, pack, z, gumbel_noise=F.one_hot(
            pack.cell_type.long(), 7).float(), keys=gk, planes=pl)[0], gen), dev)
    poisoned("plain critic (output, parameter gradients)", lambda: grads(
        lambda pl: disc(pack, soft, deterministic=False, keys=dk), disc), dev)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from building_gan_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(cs.card_line(), f"torch {torch.__version__}", flush=True)
    _build.build_all(("hourglass", "gat_train"))
    cfg, packs = cs.dp_packs(cs.train_cfg())
    pack = packs[0].to(dev)
    if "--cublas" in sys.argv:  # matmuls through cuBLAS, not cuBLASLt
        torch.backends.cuda.preferred_blas_library("cublas")
    if "--pairs" in sys.argv:  # two recorded pairs of steps as the first work of the process
        first_difference(cfg, pack, dev)
        first_difference(cfg, pack, dev)
        return 0
    if "--first" in sys.argv:  # the pieces as the first work of the process, then steps
        pieces(cfg, pack, dev)
        pieces(cfg, pack, dev)
        first_difference(cfg, pack, dev)
        return 0
    for tag, c in (("float32", cfg), ("bfloat16", cfg.replace(COMPUTE_DTYPE="bfloat16"))):
        compare(f"{tag}, default algorithms, run 1 vs run 2", step_params(c, pack, dev),
                step_params(c, pack, dev))
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                a, b = step_params(c, pack, dev), step_params(c, pack, dev)
        finally:
            torch.use_deterministic_algorithms(False)
        compare(f"{tag}, deterministic algorithms, run 1 vs run 2", a, b)
        ops = Counter(str(w.message).split(" does not have")[0] for w in caught
                      if "deterministic" in str(w.message))
        print(f"{tag}: operations without a deterministic CUDA implementation: {dict(ops)}",
              flush=True)
    pieces(cfg, pack, dev)
    first_difference(cfg, pack, dev)
    poisoned_pieces(cfg, pack, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
