"""Floor sharding of the port (parallel/sp.py) on the CPU.

Ranks are threads of this process (``mesh.thread_ranks``), each with its own
gloo group; rank r holds floors [r F / n, (r + 1) F / n) of every slot.
Grids are (8, 8, 8), as tests/test_sp.py's, at tests/test_train.py::tiny_cfg
widths, f32, on synthetic buildings of at most 8 floors: K = 1 (one building
a slot) and K = 2 (two buildings a slot, cell packing, keyed by the gid plane).

- The four halo stencils (GAT, GCN, GraphConv's sum, GATv2), with and without
  gid, on 2 and 4 ranks, against the port's unsharded flat stencil: the
  forward bit for bit, and the first- and second-order input gradients (the
  collectives' backwards, twice) within 1e-6 of their scale; and against
  JAX's ``stencil_*_sp`` under ``jax.shard_map`` on 4 virtual CPU devices
  within rtol 1e-5 / atol 1e-6 (tests/test_sp.py's tolerances).
- ``graph_norm`` with a floor shard equals it without (rtol 1e-5 / atol 1e-6:
  the summed statistics reassociate).
- ``sp_generator_apply`` on 2 and 4 ranks against the JAX package's
  unsharded forward and its ``sp.sp_generator_apply`` on the same converted
  weights: logits within rtol 1e-4 / atol 1e-5 (tests/test_sp.py's) plus
  twice the case's f32 rounding (``hold``, as tests/test_torch_convs.py).
- ``make_sp_train_step`` on 2 and 4 ranks against the port's one-device plain
  step on the same batch, weights and generator seed, with SGD, with
  tests/test_sp.py's rationale and limits: metrics within rtol 5e-3; the
  critic's update within rel 3e-3 plus twice the one-device f32 step's own
  distance from its f64 run (rel 5.9e-3 here: the GP-shaped curvature
  amplifies rounding) / cos 0.9999; the generator's update after the critic
  updates within rel 0.5 / cos 0.95 (its gradient is the critic's input
  gradient, which amplifies the critic's reassociation noise); the pure
  generator update (N_CRITIC = 0) within rel 3e-3 / cos 0.9999.  Both steps
  computing in f64 agree to rel 1e-9 (critic) and 1e-5 (generator; the
  losses' reductions stay f32): a dropped halo plane, a double-counted shard
  or a wrong gradient reduction moves them at O(1).  Dropout is on: a rank's
  masks are the whole slots' at its rows.
- After 2 steps every rank's parameters are equal bit for bit.
- A rank whose floors are all empty stays finite and keeps the collectives'
  order (the others would wait for it otherwise).
- F % n != 0 raises, naming both; a model without a floor axis to shard
  raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from building_gan_tpu.data import grid as jgrid
from building_gan_tpu.models import GridVoxelGNNGenerator as JGridGenerator
from building_gan_tpu.parallel import sp as jsp

from building_gan_torch.checkpoint.torch_compat import generator_params_to_state_dict
from building_gan_torch.models.grid_layers import graph_norm
from building_gan_torch.models.grid_models import GridVoxelGNNDiscriminator, GridVoxelGNNGenerator
from building_gan_torch.models.transformer import GridTransformerGenerator
from building_gan_torch.ops import dropout, stencil
from building_gan_torch.parallel import mesh
from building_gan_torch.parallel import sp
from building_gan_torch.train.state import TrainState
from building_gan_torch.train.step import make_train_step

from test_torch_convs import as_f64
from test_torch_layers import port_batch, port_cfg, t
from test_torch_parallel import seeded_params
from test_train import tiny_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

GRID = (8, 8, 8)
SEED = 7
B, C = 2, 5  # the stencil slabs: slots, channels


def low_samples(samples):
    """The synthetic buildings that fit the (8, 8, 8) grid's floors."""
    return [s for s in samples if int(s[1].location[:, 0].max()) < GRID[0]]


def jax_cfg(small_cfg, **kw):
    return tiny_cfg(small_cfg, LAYOUT="grid", GRID_SHAPE=GRID, GRID_BATCH=2, GRID_LOCAL_NODES=64,
                    PACK_GRAPHS=2, COMPUTE_DTYPE="float32", **kw)


def jax_pack(samples, jcfg, K):
    """Two slots: one building each (K = 1) or two each, cell packing (K = 2)."""
    low = low_samples(samples)
    if K == 1:
        return jgrid.pack_grid(low[:2], jcfg)
    cfg = jcfg.replace(GRID_SLOT_GRAPHS=2, GRID_PACK_MODE="cell", GRID_LOCAL_NODES=128)
    return jgrid.pack_grid_multi(low[:4], cfg, batch_slots=2, graphs_per_slot=2)


# ---------------------------------------------------------------------------
# the halo stencils
# ---------------------------------------------------------------------------


def slab(seed=0):
    """(B, F Y X) mask and gid planes and the stencils' inputs, from a seed."""
    rng = np.random.default_rng(seed)
    R = int(np.prod(GRID))
    mask = (rng.random((B, R)) > 0.3).astype(np.float32)
    ins = {
        "h": rng.normal(size=(B, R, C)).astype(np.float32) * mask[..., None],
        "h2": rng.normal(size=(B, R, C)).astype(np.float32) * mask[..., None],
        "a_src": rng.normal(size=(B, R)).astype(np.float32),
        "a_dst": rng.normal(size=(B, R)).astype(np.float32),
        "att": rng.normal(size=(C,)).astype(np.float32),
        "gy": rng.normal(size=(B, R, C)).astype(np.float32),
    }
    return mask, rng.integers(0, 3, size=(B, R)), ins


STENCIL_INPUTS = {"gat": ("h", "a_src", "a_dst"), "gcn": ("h",), "sum": ("h",),
                  "gatv2": ("h", "h2")}


def flat_stencil(op, xs, mask, grid, gid, att, shard=None):
    """The port's unsharded stencil, or with ``shard`` its halo stencil."""
    if shard is None:
        fns = {"gat": stencil.stencil_gat_flat, "gcn": stencil.stencil_gcn_flat,
               "sum": stencil.stencil_sum_flat, "gatv2": stencil.stencil_gatv2_flat}
        kw = {}
    else:
        fns = {"gat": sp.stencil_gat_sp, "gcn": sp.stencil_gcn_sp, "sum": sp.stencil_sum_sp,
               "gatv2": sp.stencil_gatv2_sp}
        kw = {"sp": shard}
    if op == "gatv2":
        return fns[op](xs[0], xs[1], att, mask, grid, gid=gid, **kw)
    return fns[op](*xs, mask, grid, gid=gid, **kw)


def with_two_orders(fn, xs, gy):
    """(y, first-order input gradients of sum(y^2 gy) with create_graph, second-order
    gradients of the first-order ones' squared sum)."""
    xs = [x.clone().requires_grad_(True) for x in xs]
    y = fn(xs)
    g1 = torch.autograd.grad((y * y * gy).sum(), xs, create_graph=True)
    g2 = torch.autograd.grad(sum((g * g).sum() for g in g1), xs)
    return [y.detach()] + [g.detach() for g in g1] + list(g2)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("with_gid", [False, True], ids=["no_gid", "gid"])
@pytest.mark.parametrize("op", list(STENCIL_INPUTS))
def test_halo_stencils_match_unsharded(op, with_gid, n):
    mask_np, gid_np, ins = slab()
    mask, gid = t(mask_np), t(gid_np) if with_gid else None
    xs, att, gy = [t(ins[k]) for k in STENCIL_INPUTS[op]], t(ins["att"]), t(ins["gy"])
    want = with_two_orders(lambda v: flat_stencil(op, v, mask, GRID, gid, att), xs, gy)
    plane = GRID[1] * GRID[2]

    def rank(r, group):
        shard = sp.make_floor_shard(group, GRID[0])
        loc = [shard.local(x, 1, plane) for x in xs]
        m = shard.local(mask, 1, plane)
        g = None if gid is None else shard.local(gid, 1, plane)
        got = with_two_orders(
            lambda v: flat_stencil(op, v, m, (shard.fs,) + GRID[1:], g, att, shard), loc,
            shard.local(gy, 1, plane))
        return [sp.gather_floors(v, shard) for v in got]

    for got in mesh.thread_ranks(n, rank):
        assert torch.equal(got[0], want[0]), "the sharded forward is not the unsharded one"
        for i, (a, b) in enumerate(zip(got[1:], want[1:])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-6 * float(b.abs().max()), err_msg=str(i))


@pytest.fixture(scope="module")
def sp_mesh():
    return jsp.make_sp_mesh(4)


@pytest.mark.parametrize("with_gid", [False, True], ids=["no_gid", "gid"])
@pytest.mark.parametrize("op", list(STENCIL_INPUTS))
def test_halo_stencils_match_jax_shard_map(op, with_gid, sp_mesh):
    mask_np, gid_np, ins = slab(1)
    F, Y, X = GRID
    grid5 = lambda a: jnp.asarray(a.reshape((B, F, Y, X) + a.shape[2:]))  # noqa: E731
    jmask, jgid = grid5(mask_np), grid5(gid_np.astype(np.int32)) if with_gid else None
    jatt = jnp.asarray(ins["att"])
    jx = [grid5(ins[k]) for k in STENCIL_INPUTS[op]]

    def fn(*a):
        *xs, m = a[:-1] if with_gid else a
        g = a[-1] if with_gid else None
        if op == "gat":
            return jsp.stencil_gat_sp(*xs, m, gid=g)
        if op == "gcn":
            return jsp.stencil_gcn_sp(*xs, m, gid=g)
        if op == "sum":
            return jsp.stencil_sum_sp(*xs, m, gid=g)
        return jsp.stencil_gatv2_sp(xs[0], xs[1], jatt, m, gid=g)

    args = jx + [jmask] + ([jgid] if with_gid else [])
    specs = (P(None, jsp.SP_AXIS),) * len(args)
    want = jax.jit(jax.shard_map(fn, mesh=sp_mesh, in_specs=specs,
                                 out_specs=P(None, jsp.SP_AXIS)))(*args)

    def rank(r, group):
        shard = sp.make_floor_shard(group, F)
        plane = Y * X
        loc = [shard.local(t(ins[k]), 1, plane) for k in STENCIL_INPUTS[op]]
        g = None if not with_gid else shard.local(t(gid_np), 1, plane)
        y = flat_stencil(op, loc, shard.local(t(mask_np), 1, plane), (shard.fs, Y, X), g,
                         t(ins["att"]), shard)
        return sp.gather_floors(y, shard)

    got = mesh.thread_ranks(4, rank)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(got.shape), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("mode", ["per_slot", "gid_keyed", "batch_level"])
def test_graph_norm_with_a_floor_shard_equals_it_without(mode):
    rng = np.random.default_rng(3)
    R, c = int(np.prod(GRID)), 6
    x = t(rng.normal(size=(B, R, c)).astype(np.float32) * 2.0 + 0.5)
    mask = t((rng.random((B, R)) > 0.4).astype(np.float32))
    gid = t(rng.integers(0, 3, size=(B, R))) if mode == "gid_keyed" else None
    w, b, ms = (t(rng.normal(size=(c,)).astype(np.float32)) for _ in range(3))
    kw = dict(gid=gid, num_graphs=3 if gid is not None else 1, batch_level=mode == "batch_level")
    want = graph_norm(x, mask, w, b, ms, **kw)
    plane = GRID[1] * GRID[2]

    def rank(r, group):
        shard = sp.make_floor_shard(group, GRID[0])
        loc = {k: None if v is None else shard.local(v, 1, plane) for k, v in
               (("x", x), ("mask", mask), ("gid", gid))}
        y = graph_norm(loc["x"], loc["mask"], w, b, ms, **{**kw, "gid": loc["gid"]}, sp=shard)
        return sp.gather_floors(y, shard)

    for got in mesh.thread_ranks(2, rank):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_dropout_rows_draw_the_whole_slots_masks():
    key = torch.tensor([123456789, 987654321])
    whole = dropout.keep_mask((3, 40, 6), key, 51, width=8)
    part = dropout.keep_mask((3, 10, 6), key, 51, width=8, rows=(20, 40))
    assert torch.equal(part, whole[:, 20:30])


# ---------------------------------------------------------------------------
# the generator forward against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [1, 2])
def test_sp_generator_apply_matches_jax(K, synthetic_samples, small_cfg, sp_mesh):
    jcfg = jax_cfg(small_cfg)
    gb = jax_pack(synthetic_samples, jcfg, K)
    jcfg = jcfg.replace(GRID_LOCAL_NODES=gb.local_x.shape[1])
    gen = JGridGenerator(configuration=jcfg, dtype=jnp.float32)
    key = jax.random.key(0)
    z = np.random.default_rng(5).normal(size=gb.mask.shape + (jcfg.Z_DIM,)).astype(np.float32)
    shapes = jax.eval_shape(lambda: gen.init({"params": key, "gumbel": key}, gb, jnp.asarray(z),
                                             deterministic=True))
    params = seeded_params(shapes["params"], 8)
    with jax.default_matmul_precision("highest"):
        want, _, _ = jax.jit(lambda p: gen.apply({"params": p}, gb, jnp.asarray(z),
                                                 deterministic=True, rngs={"gumbel": key}))(params)
        want_sp, _, _ = jsp.sp_generator_apply(gen, sp_mesh)(params, gb, jnp.asarray(z), key)
    cfg = port_cfg(jcfg)
    model = GridVoxelGNNGenerator(cfg)
    model.load_state_dict(generator_params_to_state_dict(params, cfg))
    batch = port_batch(gb)
    noise = torch.zeros(tuple(gb.mask.shape) + (7,))
    gen64, batch64 = as_f64(model, batch)
    with torch.no_grad():
        ref64, _, _ = gen64(batch64, t(z).double(), gumbel_noise=noise.double())

    for n in (2, 4):
        def rank(r, group):
            shard = sp.make_floor_shard(group, GRID[0])
            logits, _, _ = sp.sp_generator_apply(model, shard)(batch, t(z), gumbel_noise=noise)
            return sp.gather_floors(logits, shard)

        for got in mesh.thread_ranks(n, rank):
            hold(got, want, ref64)
            hold(got, want_sp, ref64)


def hold(got, want, ref64):
    """rtol 1e-4 / atol 1e-5 (tests/test_sp.py's), plus twice the case's f32 rounding: the
    sharded f32 logits' largest distance from the port's unsharded f64 run (below 1e-3),
    as tests/test_torch_convs.py holds the models.  The 1-channel GraphNorm layers of
    a K = 2 slot amplify a reassociated statistic's rounding to ~4e-5 in the logits."""
    got, want, ref64 = (np.asarray(a, np.float64) for a in (got, want, ref64))
    rounding = np.abs(got - ref64).max()
    assert rounding < 1e-3, f"the sharded f32 run is {rounding:.3e} from the f64 run"
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 + 2.0 * rounding)


# ---------------------------------------------------------------------------
# the train step against the port's one-device step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StepCase:
    cfg: object
    batch: object
    weights: tuple  # the initial generator and critic state_dicts
    f64: bool = False

    def state(self, cfg=None):
        """Fresh modules from the weights (computing in f64 for an f64 case), each with
        SGD(1e-2) (tests/test_sp.py's reason: Adam turns rounding-level sign flips of
        near-zero gradients into +-lr steps)."""
        cfg = cfg or self.cfg
        gen, disc = GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg)
        gen.load_state_dict(self.weights[0])
        disc.load_state_dict(self.weights[1])
        if self.f64:
            for m in (gen, disc):
                m.double()
                m.compute_dtype = torch.float64
        return TrainState(gen, disc, torch.optim.SGD(gen.parameters(), lr=1e-2),
                          torch.optim.SGD(disc.parameters(), lr=1e-2))

    def in_f64(self):
        fields = {k: v.double() for k, v in vars(self.batch).items()
                  if torch.is_tensor(v) and v.is_floating_point()}
        return dataclasses.replace(self, batch=dataclasses.replace(self.batch, **fields), f64=True)


@pytest.fixture(scope="module")
def step_case(synthetic_samples, small_cfg):
    jcfg = jax_cfg(small_cfg)
    gb = jax_pack(synthetic_samples, jcfg, 2)
    cfg = port_cfg(jcfg).replace(GRID_SLOT_GRAPHS=2, GRID_LOCAL_NODES=gb.local_x.shape[1])
    torch.manual_seed(0)
    gen, disc = GridVoxelGNNGenerator(cfg), GridVoxelGNNDiscriminator(cfg)
    return StepCase(cfg, port_batch(gb), (gen.state_dict(), disc.state_dict()))


def params_of(module) -> list:
    return [p.detach().clone() for p in module.parameters()]


def update_distance(p0, pa, pb):
    """(relative Frobenius distance, cosine) of two updates from p0, as one vector each."""
    ua = torch.cat([(a - o).reshape(-1).double() for o, a in zip(p0, pa)])
    ub = torch.cat([(b.double() - o.double()).reshape(-1) for o, b in zip(p0, pb)])
    rel = float((ua - ub).norm() / ua.norm().clamp(min=1e-12))
    cos = float(ua @ ub / (ua.norm() * ub.norm()).clamp(min=1e-12))
    return rel, cos


def one_device(case, cfg=None):
    """The port's one-device plain step (``fused=False``, the floor-sharded step's route):
    (metrics, initial (generator, critic) parameters, after)."""
    state = case.state(cfg)
    p0 = (params_of(state.generator), params_of(state.discriminator))
    step = make_train_step(cfg or case.cfg, state, fused=False)
    m = step(case.batch, torch.Generator().manual_seed(SEED))
    return m, p0, (params_of(state.generator), params_of(state.discriminator))


def sharded(case, n, cfg=None, steps=1, batch=None):
    """Each rank's (metrics of each step, (generator, critic) parameters after each step)."""
    cfg = cfg or case.cfg

    def rank(r, group):
        state = case.state(cfg)
        step = sp.make_sp_train_step(cfg, state, sp.make_floor_shard(group, GRID[0]))
        gen = torch.Generator().manual_seed(SEED)
        out = []
        for _ in range(steps):
            m = step(case.batch if batch is None else batch, gen)
            out.append((m, (params_of(state.generator), params_of(state.discriminator))))
        return out

    return mesh.thread_ranks(n, rank)


@pytest.fixture(scope="module")
def reference(step_case):
    """The one-device step at f32, and the same step computing in f64 (its parameters'
    distance from the f32 one is the f32 step's own rounding)."""
    return one_device(step_case), one_device(step_case.in_f64())


@pytest.mark.parametrize("n", [2, 4])
def test_sp_train_step_matches_one_device(step_case, reference, n):
    """tests/test_sp.py's limits, the critic's rel plus twice the one-device f32 step's own
    distance from its f64 run (the GP-shaped curvature amplifies rounding: a K = 2 slot's
    critic update moved by rel 5.8e-3 on 4 ranks, while the f64 runs agree to 1e-12,
    ``test_sp_train_step_in_f64_equals_one_device``)."""
    (m1, (g0, d0), (g1, d1)), (_, _, (_, d64)) = reference
    rounding_d = update_distance(d0, d64, d1)[0]
    ranks = sharded(step_case, n, steps=2 if n == 2 else 1)
    for r, out in enumerate(ranks):
        m2, (g2, d2) = out[0]
        for k in ("g_loss", "d_loss", "f1", "accuracy", "g_loss_label", "g_loss_ratio"):
            assert np.isclose(float(m1[k]), float(m2[k]), rtol=5e-3, atol=5e-3), k
        assert torch.equal(m1["confusion_matrix"], m2["confusion_matrix"])
        rel_d, cos_d = update_distance(d0, d1, d2)
        rel_g, cos_g = update_distance(g0, g1, g2)
        if r == 0:
            print(f"n={n}: critic rel {rel_d:.3e} cos {cos_d:.7f} (f32 rounding {rounding_d:.3e}); "
                  f"generator rel {rel_g:.3e} cos {cos_g:.7f}")
        assert rel_d < 3e-3 + 2.0 * rounding_d and cos_d > 0.9999, ("params_d", rel_d, cos_d)
        assert rel_g < 0.5 and cos_g > 0.95, ("params_g", rel_g, cos_g)
    if n == 2:  # replicas after 2 steps: bit for bit
        (_, last0), (_, last1) = ranks[0][-1], ranks[1][-1]
        for a, b in zip(last0[0] + last0[1], last1[0] + last1[1]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n", [2, 4])
def test_sp_train_step_in_f64_equals_one_device(step_case, reference, n):
    """Both steps computing in f64 (the losses' reductions stay f32): a dropped halo plane,
    a double-counted shard or a wrong gradient reduction moves the update at O(1); the
    rounding that reassociation leaves is ~1e-13 in the critic and ~1e-7 in the generator."""
    _, (_, (g0, d0), (g1, d1)) = reference
    (m2, (g2, d2)), = sharded(step_case.in_f64(), n)[0]
    rel_d, _ = update_distance(d0, d1, d2)
    rel_g, _ = update_distance(g0, g1, g2)
    print(f"f64, n={n}: critic rel {rel_d:.3e}, generator rel {rel_g:.3e}")
    assert rel_d < 1e-9 and rel_g < 1e-5, (rel_d, rel_g)


@pytest.mark.parametrize("n", [2, 4])
def test_sp_pure_generator_update_matches_one_device(step_case, n):
    cfg0 = step_case.cfg.replace(N_CRITIC=0)
    _, (g0, _), (g1, _) = one_device(step_case, cfg0)
    for r, out in enumerate(sharded(step_case, n, cfg0)):
        _, (g2, _) = out[0]
        rel, cos = update_distance(g0, g1, g2)
        if r == 0:
            print(f"pure G, n={n}: rel {rel:.3e} cos {cos:.7f}")
        assert rel < 3e-3 and cos > 0.9999, ("params_g_pure", rel, cos)


def test_a_rank_of_empty_floors_stays_finite(step_case):
    """4 ranks on a batch whose cells all lie on floors 0-3: ranks 2 and 3 hold none."""
    batch = dataclasses.replace(step_case.batch)
    keep = torch.zeros(GRID[0])
    keep[:4] = 1.0
    for f in ("mask", "x", "dimension"):
        v = getattr(batch, f)
        setattr(batch, f, v * keep.view((1, -1) + (1,) * (v.dim() - 2)))
    assert batch.mask[:, 4:].sum() == 0 and batch.mask.sum() > 0
    cfg1 = step_case.cfg.replace(N_CRITIC=1)
    ranks = sharded(step_case, 4, cfg1, batch=batch)
    for out in ranks:
        m, (g, d) = out[0]
        assert all(torch.isfinite(v).all() for v in m.values())
        assert all(torch.isfinite(p).all() for p in g + d)
    for out in ranks[1:]:  # every rank took the same update
        for a, b in zip(out[0][1][0] + out[0][1][1], ranks[0][0][1][0] + ranks[0][0][1][1]):
            assert torch.equal(a, b)


def test_the_floor_axis_must_divide_over_the_ranks(step_case):
    def rank(r, group):
        with pytest.raises(ValueError, match="F=8 does not divide over n=3"):
            sp.make_floor_shard(group, GRID[0])
        shard = sp.FloorShard(group, r, 3, 9)
        with pytest.raises(ValueError, match="F=8 does not divide over n=3"):
            sp.shard_grid_batch(step_case.batch, shard)
        return True

    assert all(mesh.thread_ranks(3, rank))


def test_models_without_a_floor_axis_are_refused(step_case):
    cfg = step_case.cfg.replace(GENERATOR_ARCH="transformer")
    with pytest.raises(ValueError, match="cannot be floor-sharded"):
        sp.check_floor_shardable(GridTransformerGenerator(cfg))
    sp.check_floor_shardable(GridVoxelGNNGenerator(step_case.cfg))
    assert sp.grid_batch_spec(step_case.batch)["mask"] == (None, sp.SP_AXIS)
    assert sp.grid_batch_spec(step_case.batch)["local_x"] == ()
