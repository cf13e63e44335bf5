"""Data parallelism of the port (parallel/mesh.py, parallel/dp.py) on the CPU.

Ranks are threads of this process (``mesh.thread_ranks``), each with its own
replica and its own gloo group over one in-memory store; the CLI's ranks are
spawned processes.  Every case runs on the grid layout (K = 3 slots of
(10, 8, 8)) and the packed edge-list layout, at tests/test_train.py::tiny_cfg
widths and f32, on three synthetic buildings: a pack of two (buildings 3 and
4), a pack of one (building 7) and ``null_like`` fill packs.

(a) The same pack on 4 ranks, every rank drawing alike
    (``fold_device_rng=False``), equals the one-device step: losses and
    metrics within rtol 1e-4 / atol 1e-5, parameters within rtol 1e-4 / atol
    1e-6 (tests/test_parallel.py's tolerances).
(b) One real pack and three null packs equal the real pack alone, the same.
(c) Packs of 2, 1, 0 and 0 buildings equal a sequential oracle that weights
    each pack's gradients and losses by its real-cell count before each of
    the N_CRITIC + 1 Adam updates (the step's own loss functions,
    ``make_update_losses``, the generator's state replayed for each pack),
    the same tolerances; the equal-weighted mean is not within them.
(d) After 2 steps every rank's parameters and Adam state are equal bit for bit.
(e) The parallel eval step on 3 packs and a null pack, with given z and Gumbel
    noise, against the JAX package's pieces run on each pack (as
    tests/test_torch_trainer.py::eval_case) aggregated with its
    ``metrics._scores_from_cm`` on the summed confusion matrices: matrices and
    histograms equal, scores and ``f1_min`` within rtol 1e-6, losses within
    rtol 1e-4 / atol 1e-5 (that file's tolerances).
(f) The node-weighted combination of 4 shard means, reduced over the group,
    equals JAX's ``masked_mean`` on the merged batch (rtol 1e-6).
(g) A null pack's losses and gradients are finite on the plain route (the
    fused kernels' all-masked slot: tests/test_torch_gat_train_emulated.py,
    which holds the compiled emulation).
(h) The CLI: train --mesh-data 2 then test --mesh-data 2 on the CPU, two
    spawned gloo ranks: one checkpoint, one scalar log, one set of finite
    test scores printed (rank 0's).
(i) More ranks than visible cards raises, naming both counts.
Also: a rank's loader gives member r of each of the JAX loader's groups.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_gan_tpu.data import batching as jbatching
from building_gan_tpu.data import grid as jgrid
from building_gan_tpu.data import pipeline as jpipe
from building_gan_tpu.models import GridVoxelGNNDiscriminator as JGridDiscriminator
from building_gan_tpu.models import GridVoxelGNNGenerator as JGridGenerator
from building_gan_tpu.models import VoxelGNNDiscriminator as JEdgeDiscriminator
from building_gan_tpu.models import VoxelGNNGenerator as JEdgeGenerator
from building_gan_tpu.train import losses as JL
from building_gan_tpu.train import metrics as JM

from building_gan_torch.checkpoint import ckpt
from building_gan_torch.checkpoint.torch_compat import (
    discriminator_params_to_state_dict, generator_params_to_state_dict,
)
from building_gan_torch.cli import main as cli
from building_gan_torch.data import pipeline as tpipe
from building_gan_torch.data.batching import PackedBatch
from building_gan_torch.data.grid import GridBatch
from building_gan_torch.models.discriminator import VoxelGNNDiscriminator
from building_gan_torch.models.generator import VoxelGNNGenerator
from building_gan_torch.models.grid_models import GridVoxelGNNDiscriminator, GridVoxelGNNGenerator
from building_gan_torch.ops.gat_train import build_planes
from building_gan_torch.parallel import dp, mesh
from building_gan_torch.train import losses as TL
from building_gan_torch.train import metrics as TM
from building_gan_torch.train.state import create_train_state
from building_gan_torch.train.step import (
    make_train_step, make_update_losses, needs_planes, real_cells, weighted_mean_,
)

from test_torch_edges import port_pack
from test_torch_layers import port_batch, port_cfg, t
from test_torch_losses import _st_gumbel_jax
from test_torch_trainer import LOSS_ATOL, LOSS_RTOL, SCORE_RTOL, tiny_cli  # noqa: F401 (fixture)
from test_train import tiny_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

RTOL, ATOL, PARAM_ATOL = 1e-4, 1e-5, 1e-6  # tests/test_parallel.py
RANKS, SEED = 4, 7
# f32; one critic update a step (two weighted Adam updates, one of each module) and no
# dropout (the int64 Philox masks are ~40% of a CPU step) keep the 4-rank steps' time down;
# the card's phase 13 of chip_smoke.py runs N_CRITIC 5 with dropout
STEP = dict(COMPUTE_DTYPE="float32", N_CRITIC=1, ENCODER_DROPOUT_RATE=0.0)
TWO, ONE, THIRD = (3, 4), (7,), (6,)  # the packs' buildings of synthetic_samples
SCALARS = ("g_loss", "d_loss", "g_loss_adv", "g_loss_ratio", "g_loss_ratio_void", "g_loss_far",
           "g_loss_label", "f1", "f1_min", "precision", "recall", "accuracy")
EDGE_BUDGETS = dict(PACK_GRAPHS=2, PACK_LOCAL_NODES=64, PACK_LOCAL_EDGES=256, PACK_VOXEL_NODES=160,
                    PACK_VOXEL_EDGES=640)


def jax_packs(samples, jcfg, groups):
    """One JAX pack of each group of buildings: a K = 3 grid slot, or an edge pack."""
    out = []
    for g in groups:
        chosen = [samples[i] for i in g]
        if jcfg.LAYOUT == "grid":
            out.append(jgrid.pack_grid_multi(chosen, jcfg, batch_slots=1, graphs_per_slot=3))
        else:
            (pack,) = jbatching.pack_graphs(chosen, jcfg)
            out.append(pack)
    return out


def to_port(jpack):
    return port_batch(jpack) if isinstance(jpack, jgrid.GridBatch) else port_pack(jpack)


def models(cfg):
    if cfg.LAYOUT == "grid":
        return GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg)
    return VoxelGNNGenerator(cfg), VoxelGNNDiscriminator(cfg)


@dataclasses.dataclass
class Case:
    jcfg: object
    cfg: object
    jpacks: list  # JAX packs of TWO, ONE, THIRD
    packs: list  # the port's
    weights: tuple  # the initial generator and critic state_dicts

    def state(self):
        gen, disc = models(self.cfg)
        gen.load_state_dict(self.weights[0])
        disc.load_state_dict(self.weights[1])
        return create_train_state(self.cfg, gen, disc, device="cpu")

    @property
    def null(self):
        return tpipe.null_like(self.packs[0])


@pytest.fixture(scope="module", params=["grid", "edges"])
def case(request, synthetic_samples, small_cfg):
    if request.param == "grid":
        jcfg = tiny_cfg(small_cfg, LAYOUT="grid", GRID_SHAPE=(10, 8, 8), GRID_LOCAL_NODES=64,
                        GRID_SLOT_GRAPHS=3, GRID_PACK_MODE="cell", **STEP)
    else:
        jcfg = tiny_cfg(small_cfg, **EDGE_BUDGETS, **STEP)
    jpacks = jax_packs(synthetic_samples, jcfg, (TWO, ONE, THIRD))
    cfg = port_cfg(jcfg)
    torch.manual_seed(0)
    gen, disc = models(cfg)
    return Case(jcfg, cfg, jpacks, [to_port(p) for p in jpacks],
                (gen.state_dict(), disc.state_dict()))


def params(state) -> dict:
    """A copy of both modules' parameters, by "generator.<name>" / "discriminator.<name>"."""
    return {f"{m}.{k}": v.detach().clone() for m in ("generator", "discriminator")
            for k, v in getattr(state, m).named_parameters()}


def dp_steps(case, packs, steps=1):
    """Each rank's (metrics of each step, parameters after each step, state) after ``steps``
    parallel steps, rank r on packs[r], every rank drawing from a generator seeded SEED."""
    def rank(r, group):
        state = case.state()
        step = dp.make_parallel_train_step(case.cfg, state, group, fold_device_rng=False)
        gen = torch.Generator().manual_seed(SEED)
        ms, ps = [], []
        for _ in range(steps):
            ms.append(step(packs[r], gen))
            ps.append(params(state))
        return ms, ps, state

    return mesh.thread_ranks(len(packs), rank)


def assert_step_close(got_metrics, got_params, want_metrics, want_params, keys=SCALARS):
    for k in keys:
        np.testing.assert_allclose(float(got_metrics[k]), float(want_metrics[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    assert set(got_params) == set(want_params)
    for k, v in want_params.items():
        np.testing.assert_allclose(got_params[k].numpy(), v.numpy(), rtol=RTOL, atol=PARAM_ATOL,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# (a), (b): one device against 4 ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def single(case):
    """The one-device step on the pack of two buildings: (metrics, parameters)."""
    state = case.state()
    m = make_train_step(case.cfg, state)(case.packs[0], torch.Generator().manual_seed(SEED))
    return m, params(state)


def test_same_pack_on_every_rank_equals_one_device(case, single):
    for ms, ps, _ in dp_steps(case, [case.packs[0]] * RANKS):
        assert_step_close(ms[0], ps[0], *single)
        for k in ("confusion_matrix", "per_graph_f1_hist"):
            assert torch.equal(ms[0][k], RANKS * single[0][k]), k


def test_null_fill_equals_the_real_pack_alone(case, single):
    for ms, ps, _ in dp_steps(case, [case.packs[0]] + [case.null] * (RANKS - 1)):
        assert_step_close(ms[0], ps[0], *single)
        for k in ("confusion_matrix", "per_graph_f1_hist"):
            assert torch.equal(ms[0][k], single[0][k]), k


# ---------------------------------------------------------------------------
# (c), (d): uneven packs against the sequential oracle; replicas
# ---------------------------------------------------------------------------


def oracle_step(case, packs):
    """One step over ``packs`` in sequence: each update's gradients and loss the packs'
    node-weighted mean, each pack drawing from the generator's state at the update's
    start (as every rank does with alike seeds); -> (metrics, state, equal-weighted d_loss)."""
    state = case.state()
    critic_loss, generator_loss = make_update_losses(case.cfg, state)
    gen = torch.Generator().manual_seed(SEED)
    w = [float(p.cell_mask.sum()) for p in packs]
    planes = [build_planes(p.cell_mask, p.gid, p.grid_shape) if needs_planes(state) else None
              for p in packs]

    def update(loss_fn, module, opt):
        leaves = list(module.parameters())
        start, grads, outs = gen.get_state(), [], []
        for pack, pl in zip(packs, planes):
            gen.set_state(start)
            for p in leaves:
                p.grad = None
            with torch.autograd.set_multithreading_enabled(False):  # as the step
                out = loss_fn(pack, pl, gen)
                (out[0] if isinstance(out, tuple) else out).backward(inputs=leaves)
            grads.append([p.grad.clone() for p in leaves])
            outs.append(out)
        for i, p in enumerate(leaves):  # in f64, as the step's all-reduce
            p.grad = (sum(wp * g[i].double() for wp, g in zip(w, grads)) / sum(w)).float()
        opt.step()
        return outs

    d_losses, d_equal = [], []
    for _ in range(case.cfg.N_CRITIC):
        losses = [o.item() for o in update(critic_loss, state.discriminator, state.opt_d)]
        d_losses.append(sum(wp * v for wp, v in zip(w, losses)) / sum(w))
        d_equal.append(np.mean(losses))
    outs = update(generator_loss, state.generator, state.opt_g)
    g_loss = sum(wp * o[0].item() for wp, o in zip(w, outs)) / sum(w)
    ms = [TM.compute_metrics(p.cell_type, o[2].detach().argmax(-1), p.cell_mask, p.graph_mask,
                             **p.metric_graphs) for p, o in zip(packs, outs)]
    cm = sum(m["confusion_matrix"] for m in ms)
    metrics = {"d_loss": np.mean(d_losses), "g_loss": g_loss, **TM.scores_from_cm(cm),
               "confusion_matrix": cm, "f1_min": min(m["f1_min"] for m in ms)}
    return metrics, params(state), float(np.mean(d_equal))


@pytest.fixture(scope="module")
def uneven(case):
    packs = [case.packs[0], case.packs[1], case.null, case.null]
    assert real_cells(packs[0]) != real_cells(packs[1])
    return dp_steps(case, packs, steps=2), oracle_step(case, packs[:2])


def test_uneven_packs_equal_the_node_weighted_oracle(uneven):
    ranks, (want, want_params, d_equal) = uneven
    keys = ("g_loss", "d_loss", "f1", "f1_min", "precision", "recall", "accuracy")
    for ms, ps, _ in ranks:
        assert_step_close(ms[0], ps[0], want, want_params, keys)
        assert torch.equal(ms[0]["confusion_matrix"], want["confusion_matrix"])
        # a mean weighting each pack alike is not within the tolerance
        assert not np.isclose(ms[0]["d_loss"].item(), d_equal, rtol=RTOL, atol=ATOL)


def test_replicas_stay_bit_identical(uneven):
    ranks, _ = uneven
    _, _, s0 = ranks[0]
    for _, _, s in ranks[1:]:
        for name in ("generator", "discriminator"):
            for a, b in zip(getattr(s, name).parameters(), getattr(s0, name).parameters()):
                assert torch.equal(a, b), name
        for opt, opt0 in ((s.opt_g, s0.opt_g), (s.opt_d, s0.opt_d)):
            for st, st0 in zip(opt.state.values(), opt0.state.values()):
                for k in st0:
                    assert torch.equal(torch.as_tensor(st[k]), torch.as_tensor(st0[k])), k
        assert s.step == s0.step == 2


# ---------------------------------------------------------------------------
# (e): the parallel eval step against the JAX package's pieces
# ---------------------------------------------------------------------------


def seeded_params(shapes, seed):
    """A flax params tree of ``shapes`` filled from a seed as init then ``perturb`` would:
    kernels N(0, 1 / fan_in), attention vectors N(0, 0.3^2), biases N(0, 0.05^2),
    norm scales and weights 1 + N(0, 0.05^2).  No init is compiled."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        noise = rng.normal(size=s.shape).astype(np.float32)
        if name == "kernel":
            return noise / np.float32(np.sqrt(s.shape[0]))
        if name.startswith("att_"):
            return 0.3 * noise
        return (name != "bias") + 0.05 * noise

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_models(case):
    """The flax generator and critic of the case's layout, with seeded params."""
    jcfg, jp = case.jcfg, case.jpacks[0]
    grid = jcfg.LAYOUT == "grid"
    gen = (JGridGenerator if grid else JEdgeGenerator)(configuration=jcfg, dtype=jnp.float32)
    disc = (JGridDiscriminator if grid else JEdgeDiscriminator)(configuration=jcfg,
                                                                 dtype=jnp.float32)
    types = jnp.asarray(jp.type if grid else jp.voxel_type)
    key = jax.random.key(5)
    z = jnp.zeros(types.shape + (jcfg.Z_DIM,), jnp.float32)
    pg = jax.eval_shape(lambda: gen.init({"params": key, "gumbel": key}, jp, z, deterministic=True))
    pd = jax.eval_shape(lambda: disc.init({"params": key}, jp, jax.nn.one_hot(types, 7),
                                          deterministic=True))
    return gen, disc, seeded_params(pg["params"], 4), seeded_params(pd["params"], 3)


def jax_eval_pieces(case, gen, disc, pg, pd, jp, z, noise):
    """The JAX eval step's pieces on one pack: deterministic generator, straight-through
    labels from the given noise, the G loss against the deterministic critic, the metrics."""
    cfg, grid = case.jcfg, case.jcfg.LAYOUT == "grid"
    logits, _, _ = gen.apply({"params": pg}, jp, z, deterministic=True,
                             rngs={"gumbel": jax.random.key(0)})
    label_hard, _ = _st_gumbel_jax(logits, noise)
    g_loss, aux = JL.generator_loss(
        lambda lbl: disc.apply({"params": pd}, jp, lbl, deterministic=True), jp, logits,
        label_hard, cfg)
    y_pred = jnp.argmax(label_hard, -1)
    if grid:
        m = JM.compute_metrics(jnp.asarray(jp.type), y_pred, jnp.asarray(jp.mask), None,
                               jnp.asarray(jp.graph_mask), gid=jnp.asarray(jp.gid),
                               num_graphs_per_slot=jp.graphs_per_slot)
    else:
        m = JM.compute_metrics(jnp.asarray(jp.voxel_type), y_pred, jnp.asarray(jp.voxel_mask),
                               jnp.asarray(jp.voxel_graph_id), jnp.asarray(jp.graph_mask))
    return {"g_loss": g_loss, **aux, **m}


def test_parallel_eval_matches_the_jax_pieces(case):
    gen, disc, pg, pd = jax_models(case)
    rng = np.random.default_rng(9)
    cells = [tuple(p.cell_mask.shape) for p in case.packs]
    zs = [rng.normal(size=c + (case.cfg.Z_DIM,)).astype(np.float32) for c in cells]
    noises = [rng.gumbel(size=c + (7,)).astype(np.float32) for c in cells]
    with jax.default_matmul_precision("highest"):
        pieces = jax.jit(lambda jp, z, noise: jax_eval_pieces(case, gen, disc, pg, pd, jp, z, noise))
        per_pack = jax.device_get([pieces(jp, z, n) for jp, z, n in zip(case.jpacks, zs, noises)])
    w = [float(np.sum(jp.mask if case.jcfg.LAYOUT == "grid" else jp.voxel_mask))
         for jp in case.jpacks]
    cm = sum(m["confusion_matrix"] for m in per_pack)
    want = {k: float(v) for k, v in JM._scores_from_cm(jnp.asarray(cm)).items()}
    want["f1_min"] = min(float(m["f1_min"]) for m in per_pack)
    for k in ("g_loss", "g_loss_adv", "g_loss_label", "g_loss_ratio", "g_loss_ratio_void",
              "g_loss_far"):
        want[k] = sum(wp * float(m[k]) for wp, m in zip(w, per_pack)) / sum(w)

    weights = (generator_params_to_state_dict(pg, case.cfg),
               discriminator_params_to_state_dict(pd, case.cfg))
    inputs = [(p, t(z), t(n)) for p, z, n in zip(case.packs, zs, noises)]
    inputs.append((case.null, torch.zeros_like(inputs[0][1]), torch.zeros_like(inputs[0][2])))

    def rank(r, group):
        state = dataclasses.replace(case, weights=weights).state()
        pack, z, noise = inputs[r]
        return dp.make_parallel_eval_step(case.cfg, state, group)(pack, z=z, gumbel_noise=noise)

    for got in mesh.thread_ranks(len(inputs), rank):
        np.testing.assert_array_equal(got["confusion_matrix"].numpy(), cm)
        np.testing.assert_array_equal(got["per_graph_f1_hist"].numpy(),
                                      sum(m["per_graph_f1_hist"] for m in per_pack))
        for k in ("f1", "f1_min", "precision", "recall", "accuracy"):
            np.testing.assert_allclose(got[k].item(), want[k], rtol=SCORE_RTOL, err_msg=k)
        for k in ("g_loss", "g_loss_adv", "g_loss_label", "g_loss_ratio", "g_loss_ratio_void",
                  "g_loss_far"):
            np.testing.assert_allclose(got[k].item(), want[k], rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# (f), (g): the lemma; null packs are finite
# ---------------------------------------------------------------------------


def test_node_weighted_shard_means_equal_the_merged_mean():
    """sum_r n_r mean_r / sum_r n_r, reduced over 4 ranks, is the merged batch's masked
    mean (the lemma behind the weighting; shards of 3, 11, 0 and 16 real entries)."""
    rng = np.random.default_rng(0)
    vals = [rng.normal(size=16).astype(np.float32) for _ in range(4)]
    masks = [(np.arange(16) < n).astype(np.float32) for n in (3, 11, 0, 16)]

    def rank(r, group):
        v, mk = torch.from_numpy(vals[r]), torch.from_numpy(masks[r])
        (combined,) = weighted_mean_([], [TL.masked_mean(v, mk)], mk.sum(), group)
        return combined.item()

    merged = float(JL.masked_mean(jnp.asarray(np.concatenate(vals)),
                                  jnp.asarray(np.concatenate(masks))))
    for got in mesh.thread_ranks(4, rank):
        np.testing.assert_allclose(got, merged, rtol=1e-6)


def test_null_pack_losses_and_gradients_are_finite(case):
    """A null pack (w = 0) gives finite losses and gradients, so 0 x them adds nothing."""
    state = case.state()
    critic_loss, generator_loss = make_update_losses(case.cfg, state)
    null, gen = case.null, torch.Generator().manual_seed(SEED)
    assert real_cells(null).item() == 0
    planes = build_planes(null.cell_mask, null.gid, null.grid_shape) if needs_planes(state) else None
    d_loss = critic_loss(null, planes, gen)
    d_loss.backward()
    g_loss, aux, _ = generator_loss(null, planes, gen)
    g_loss.backward(inputs=list(state.generator.parameters()))
    assert torch.isfinite(d_loss) and torch.isfinite(g_loss)
    assert all(torch.isfinite(v) for v in aux.values())
    for name in ("generator", "discriminator"):
        for k, p in getattr(state, name).named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), f"{name}.{k}"


# ---------------------------------------------------------------------------
# the loaders: rank r takes member r of each group
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["grid", "edges"])
def test_a_ranks_loader_gives_member_r_of_each_group(layout, synthetic_samples, small_cfg):
    if layout == "grid":  # 3 packs an epoch, in groups of 2
        jcfg = small_cfg.replace(LAYOUT="grid", GRID_SHAPE=(10, 8, 8), GRID_BATCH=1,
                                 GRID_SLOT_GRAPHS=3, GRID_PACK_MODE="cell", GRID_LOCAL_NODES=192)
        n = 2
    else:  # 4 packs an epoch, in groups of 3
        jcfg, n = small_cfg.replace(PACK_GRAPHS=2), 3
    jl = jpipe.PackedLoader(synthetic_samples, jcfg, seed=11, n_device_batches=n)
    tls = [tpipe.PackedLoader(synthetic_samples, port_cfg(jcfg), seed=11, n_device_batches=n,
                              rank=r) for r in range(n)]
    kind = GridBatch if layout == "grid" else PackedBatch
    nulls = 0
    for _ in range(2):  # two epochs: each reshuffles alike
        groups, per_rank = list(jl), [list(tl) for tl in tls]
        assert all(len(p) == len(groups) > 0 for p in per_rank)
        for i, g in enumerate(groups):
            for r in range(n):
                pack = per_rank[r][i]
                assert isinstance(pack, kind)
                for f in dataclasses.fields(kind):
                    j, tt = getattr(g, f.name), getattr(pack, f.name)
                    assert (j is None) == (tt is None), f.name
                    if j is not None:
                        assert np.array_equal(np.asarray(j)[r], tt.numpy()), (i, r, f.name)
                nulls += int(real_cells(pack).item() == 0)
    assert nulls > 0  # an epoch's tail group was completed with null packs
    with pytest.raises(ValueError, match=f"rank {n} needs n_device_batches above it"):
        tpipe.PackedLoader(synthetic_samples, port_cfg(jcfg), n_device_batches=n, rank=n)


# ---------------------------------------------------------------------------
# (h), (i): the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_npz(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_cli")
    raw, npz = str(root / "raw"), str(root / "npz")
    cli.main(["synth", "--data-path", raw, "--num", "8", "--seed", "2"])
    cli.main(["preprocess", "--data-path", raw, "--save-data-path", npz])
    return npz


def test_cli_trains_and_tests_on_two_ranks(cli_npz, tiny_cli, tmp_path, capfd):
    """train then test with --mesh-data 2 --device cpu: two spawned gloo ranks; rank 0
    alone writes the checkpoint and the scalar log and prints."""
    run = str(tmp_path / "run")
    common = ["--save-data-path", cli_npz, "--log-dir", run, "--device", "cpu", "--mesh-data", "2",
              "--compute-dtype", "float32", "--slot-graphs", "3", "--grid-local-nodes", "128"]
    tiny_cli.main(["train", "--epochs", "1"] + common)
    out = capfd.readouterr().out
    assert out.count("epoch 1:") == 1 and out.count("Scalar log:") == 1
    assert ckpt.exists(run)
    logs = [f for f in os.listdir(run) if f.startswith("events.out.tfevents") or f == "scalars.jsonl"]
    assert len(logs) == 1, logs
    tiny_cli.main(["test", "--num-samples-to-viz", "0"] + common)
    out = capfd.readouterr().out
    assert out.count("Loaded best states") == 1
    values = [float(ln.split(":")[1]) for ln in out.splitlines() if "_test:" in ln]
    assert len(values) == 5 and all(np.isfinite(v) for v in values)


@pytest.mark.parametrize("where", ["cli", "init_data_group"])
def test_more_ranks_than_cards_raises(where, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    match = "requested 2 data-parallel ranks, have 1 visible CUDA devices"
    with pytest.raises(ValueError, match=match):
        if where == "cli":
            cli.main(["train", "--save-data-path", str(tmp_path), "--mesh-data", "2",
                      "--compute-dtype", "float32"])
        else:
            mesh.init_data_group(0, 2, str(tmp_path / "store"), "cuda")
