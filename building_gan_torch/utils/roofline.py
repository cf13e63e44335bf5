"""Analytic roofline floor of the WGAN-GP train step, against an H100's peaks.

Port of ``building_gan_tpu/utils/roofline.py``: the same work model, number
for number, so that the same configuration gives the same ``Work`` in both
packages; only the default peaks differ.  From the configuration's layer
schedule alone it derives the least work one train step must do per grid
cell (matrix MACs, elementwise ops, transcendentals, memory bytes) and
divides by the card's peaks: the step's floor time and the nodes/s it
bounds.  A measured step time over ``floor_ms`` is the step's roofline
share.

Floor rules (each chosen to undercount work, so the floor is optimistic):

- GEMMs: exactly cin*cout MACs per cell (+2 columns for the folded GAT
  attention scores); backward = 3x fwd MACs (dgrad + wgrad).
- Memory: each layer reads its input once and writes its output once at a
  2-byte compute dtype; perfect producer/consumer fusion assumed (stencil
  neighbour reads, the norm's second pass, weights and optimizer traffic
  free).  Backward = 2x fwd bytes (grad stream + activation re-read).
- Elementwise: only irreducible math per element: the 7-tap stencil
  accumulate (mul+add per tap), GraphNorm stats and apply, activation,
  dropout mask+scale; attention-plane glue counted per cell.  Backward = 2x.
- Transcendentals (exp/log/cos): GAT softmax exps, Box-Muller z, Gumbel
  noise, softmaxes.

Traversal multipliers per step (reference semantics, trainer.py:459-502,
N_CRITIC=5), in fwd/bwd-equivalents of one network traversal:

    G: 6 fwd + 1 bwd                  (5 stop-grad fwds + update fwd/bwd)
    D: 16 fwd + 21 bwd-equivalents    (3 fwd/iter + inner input-grad +
                                       fake/real reverse + ~2x for the
                                       GP branch's reverse-over-reverse,
                                       + fwd/bwd in the G update)

The key names of a peaks dict are the JAX package's (``mxu_tflops`` for the
matrix units, ``vpu_gops`` for the elementwise units, ``trans_gops``,
``hbm_gbps``), so one dict can be passed to both packages.  On the H100,
``mxu`` is the tensor cores, ``vpu`` the f32 CUDA cores and ``trans`` the
special-function units.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..models.layers import hourglass_channels

# Published peaks of one H100 SXM at its 700 W power limit (NVIDIA's data sheet;
# dense rates, no sparsity).  A card set below 700 W runs slower under load.
# The data sheet gives no transcendental rate: the CUDA C++ Programming Guide
# gives 16 results a clock an SM for compute capability 9.0's special-function
# ops (exp2, log2, sin, cos, rsqrt, rcp), so
#   16 x 132 SMs x 1.98e9 Hz (the H100 SXM's maximum SM clock,
#   nvidia-smi --query-gpu=clocks.max.sm) = 4,181.76 Gop/s.
# scripts/torch_roofline_peaks.py measures the attainable rates on a card.
PUBLISHED_PEAKS_H100 = {
    "hbm_gbps": 3350.0,  # HBM3
    "vpu_gops": 67000.0,  # f32 outside the tensor cores, an FMA counted as two
    "trans_gops": 4181.76,  # SFU results, 16 x 132 x 1.98 (above)
    "mxu_tflops": 989.0,  # bf16 tensor cores, dense
}


@dataclass
class Work:
    """Per-cell work totals (one grid cell through the whole step).

    ``hbm_bytes`` is the optimistic accounting (one read + one write per
    layer, everything else fused free: the floor).  ``hbm_bytes_hi`` is the
    realistic accounting: it also counts the stencil's activation re-reads,
    the GraphNorm stats + apply passes (the apply needs all rows' stats, so
    it cannot fuse into the producing GEMM), and the z-noise write.  The
    attainable step time lies between the two floors.
    """

    mxu_macs: float = 0.0
    vpu_ops: float = 0.0
    trans_ops: float = 0.0
    hbm_bytes: float = 0.0
    hbm_bytes_hi: float = 0.0
    # the part of hbm_bytes_hi that streams through GEMMs (activation read +
    # write of every dense layer): in the serial model a GEMM's floor is
    # max(its matrix-unit time, its own streaming time)
    hbm_bytes_gemm: float = 0.0

    def __iadd__(self, other):
        self.mxu_macs += other.mxu_macs
        self.vpu_ops += other.vpu_ops
        self.trans_ops += other.trans_ops
        self.hbm_bytes += other.hbm_bytes
        self.hbm_bytes_hi += other.hbm_bytes_hi
        self.hbm_bytes_gemm += other.hbm_bytes_gemm
        return self

    def scaled(self, f: float) -> "Work":
        return Work(
            self.mxu_macs * f,
            self.vpu_ops * f,
            self.trans_ops * f,
            self.hbm_bytes * f,
            self.hbm_bytes_hi * f,
            self.hbm_bytes_gemm * f,
        )


ITEMSIZE = 2.0  # bytes of the bf16 compute dtype


def _dense(cin: int, cout: int, norm_act: bool = True) -> Work:
    """Dense (+LayerNorm+LeakyReLU for MLPBlock) per cell, forward."""
    # realistic == optimistic for MLP blocks: LayerNorm stats are per row
    # (channel axis), so they fuse into the GEMM epilogue in registers
    w = Work(
        mxu_macs=cin * cout,
        hbm_bytes=ITEMSIZE * (cin + cout),
        hbm_bytes_hi=ITEMSIZE * (cin + cout),
        hbm_bytes_gemm=ITEMSIZE * (cin + cout),
    )
    if norm_act:
        # LayerNorm: 2 stat MACs + 2 apply ops; LeakyReLU: 2 (cmp+select*mul)
        w.vpu_ops += 6 * cout
    return w


def _gat_layer(cin: int, cout: int, K: int, dropout: bool = True) -> Work:
    """One hourglass GAT conv + GraphNorm + ReLU + Dropout per cell, fwd."""
    w = Work()
    # GEMM with 2 folded attention columns
    w.mxu_macs += cin * (cout + 2)
    w.hbm_bytes += ITEMSIZE * (cin + cout)
    # realistic memory (hbm_bytes_hi): the GEMM's read/write as above, plus
    #   +2*cout  stencil re-reads of h (attention-weight pass + aggregate)
    #   +3*cout  GraphNorm: stats read + apply read/write (the apply needs the
    #            per-graph stats over all rows: a second pass)
    #   +16      attention planes a_src/a_dst + neighbour-validity masks
    w.hbm_bytes_hi += ITEMSIZE * (cin + cout + 2 * cout + 3 * cout) + 16
    w.hbm_bytes_gemm += ITEMSIZE * (cin + cout)  # the conv GEMM's stream
    # stencil softmax-weighted accumulate: 7 taps x (mul+add) per channel
    w.vpu_ops += 14 * cout
    # attention plane per cell: LeakyReLU + masking + softmax glue on 7
    # scalars (~8 ops each) + 7 softmax exps
    w.vpu_ops += 56
    w.trans_ops += 7
    # GraphNorm: 3 stat MACs/elem (x*m, x*x*m accumulate) + 2 apply ops; the
    # keyed apply as a matrix product (K buildings x 2C table)
    w.vpu_ops += 5 * cout
    w.mxu_macs += K * 2 * cout
    # ReLU + dropout (compare + select*scale)
    w.vpu_ops += (1 + 3) * cout if dropout else cout
    return w


def _hourglass_channels(hidden: int, repeat: int, min_channels: int = 1) -> list:
    # one source with the models (HOURGLASS_MIN_CHANNELS included)
    return hourglass_channels(hidden, repeat, min_channels)


def generator_fwd_work(cfg) -> Work:
    """One generator forward, per cell (models/grid_models.py schedule)."""
    K = 6  # graphs per slot (the bench's multipack); callers may rescale
    w = Work()
    # type-matched pooling readback: (B,R,KT)x(B,KT,C) product
    kt = K * 7
    local_f = 17
    w.mxu_macs += kt * local_f
    w.hbm_bytes += ITEMSIZE * local_f
    w.hbm_bytes_hi += ITEMSIZE * local_f
    # realistic: the z draw is written once and read by both concats (the
    # reads are inside the GEMM cin counts; the write is not)
    w.hbm_bytes_hi += ITEMSIZE * cfg.Z_DIM
    # matched encoder MLP stack: 17 -> 128 x (1+LOCAL_GRAPH_ENCODER_REPEAT)
    h = cfg.LOCAL_ENCODER_HIDDEN_DIM
    w += _dense(local_f, h)
    for _ in range(cfg.LOCAL_GRAPH_ENCODER_REPEAT):
        w += _dense(h, h)
    # input concat [matched 128, voxel_x 12, z 128] -> MLP encoder stack
    cin = h + 12 + cfg.Z_DIM
    g = cfg.GENERATOR_HIDDEN_DIM
    w += _dense(cin, g)
    for _ in range(cfg.GENERATOR_MLP_ENCODER_REPEAT):
        w += _dense(g, g)
    # hourglass
    c = g
    for ch in _hourglass_channels(g, cfg.GENERATOR_ENCODER_REPEAT, getattr(cfg, "HOURGLASS_MIN_CHANNELS", 1)):
        w += _gat_layer(c, ch, K)
        c = ch
    # decoder: concat 524 -> 128,64,32,16 -> 7
    cin = c + g + h + 12 + cfg.Z_DIM
    for feat in (g, g // 2, g // 4, g // 8):
        w += _dense(cin, feat)
        cin = feat
    w += _dense(cin, 7, norm_act=False)
    # ST-Gumbel head: gumbel noise (log(-log u): 2 trans) + softmax (1 exp)
    # + argmax/one-hot glue (~4 ops), all per class channel
    w.trans_ops += 3 * 7
    w.vpu_ops += 4 * 7
    # z draw amortized per G traversal: 128 normals via paired Box-Muller
    # (1 cos/sin + 0.5 log + 0.5 sqrt per normal ~= 2 trans) + glue
    w.trans_ops += 2 * cfg.Z_DIM
    w.vpu_ops += 2 * cfg.Z_DIM
    return w


def discriminator_fwd_work(cfg) -> Work:
    """One critic forward, per cell."""
    K = 6
    w = Work()
    kt = K * 7
    local_f = 17
    w.mxu_macs += kt * local_f
    w.hbm_bytes += ITEMSIZE * (local_f + 12 + 7)
    w.hbm_bytes_hi += ITEMSIZE * (local_f + 12 + 7)
    d = cfg.DISCRIMINATOR_HIDDEN_DIM
    cin = local_f + 12 + 7
    w += _dense(cin, d, norm_act=False)
    w.vpu_ops += d  # relu
    w += _dense(d, d, norm_act=False)
    w.vpu_ops += d
    c = d
    for ch in _hourglass_channels(d, cfg.DISCRIMINATOR_ENCODER_REPEAT, getattr(cfg, "HOURGLASS_MIN_CHANNELS", 1)):
        w += _gat_layer(c, ch, K)
        c = ch
    for feat in (d // 2, d // 4, d // 8):
        w += _dense(c, feat, norm_act=False)
        w.vpu_ops += feat
        c = feat
    w += _dense(c, 1, norm_act=False)
    return w


# traversal multipliers (module docstring): fwd-equivalents of one traversal
G_FWD, G_BWD = 6.0, 1.0
D_FWD, D_BWD = 16.0, 21.0
# backward cost of one traversal, relative to its forward, per resource
BWD_MXU, BWD_VPU, BWD_HBM, BWD_TRANS = 3.0, 2.0, 2.0, 0.0


def step_work_per_cell(cfg) -> Work:
    """Total per-cell work for ONE full WGAN-GP train step (N_CRITIC inside)."""
    gf = generator_fwd_work(cfg)
    df = discriminator_fwd_work(cfg)
    total = Work()
    for fwd, n_fwd, n_bwd in ((gf, G_FWD, G_BWD), (df, D_FWD, D_BWD)):
        total += fwd.scaled(n_fwd)
        total += Work(
            fwd.mxu_macs * BWD_MXU,
            fwd.vpu_ops * BWD_VPU,
            fwd.trans_ops * BWD_TRANS,
            fwd.hbm_bytes * BWD_HBM,
            fwd.hbm_bytes_hi * BWD_HBM,
            fwd.hbm_bytes_gemm * BWD_HBM,
        ).scaled(n_bwd)
    # GP interpolation + grad-norm reduce on the 7-channel label plane x5
    total.vpu_ops += 5 * (3 * 7 + 10)
    return total


def attainable(cfg, cells_per_step: int, real_nodes: int, peaks: dict = None) -> dict:
    """Floor times per resource + attainable-max nodes/sec for this config.

    cells_per_step: slots x cells-per-slot (padding included: the dense
    layout moves padded cells too).
    real_nodes: non-padding voxel nodes per step (the metric's numerator).
    peaks: the JAX package's keys; ``PUBLISHED_PEAKS_H100`` by default.
    """
    peaks = peaks or PUBLISHED_PEAKS_H100
    w = step_work_per_cell(cfg).scaled(float(cells_per_step))
    t_mxu_ms = w.mxu_macs * 2.0 / (peaks["mxu_tflops"] * 1e12) * 1e3
    t_vpu_ms = w.vpu_ops / (peaks["vpu_gops"] * 1e9) * 1e3
    t_trans_ms = w.trans_ops / (peaks["trans_gops"] * 1e9) * 1e3
    t_hbm_ms = w.hbm_bytes / (peaks["hbm_gbps"] * 1e9) * 1e3
    t_hbm_hi_ms = w.hbm_bytes_hi / (peaks["hbm_gbps"] * 1e9) * 1e3
    # perfect-overlap roofline: the step can't be faster than its slowest
    # resource; elementwise ops and transcendentals are added, as in the JAX
    # package (on the H100 the SFUs issue beside the FMA pipes, so the sum
    # overstates this bar: a longer floor, a smaller share)
    floor_ms = max(t_mxu_ms, t_vpu_ms + t_trans_ms, t_hbm_ms)
    # the realistic floor (a) swaps the one-read-per-layer memory rule for the
    # mandatory-traffic accounting (Work docstring), and (b) models serial
    # execution, one op at a time: elementwise ops are bounded by their own
    # bar, GEMMs by max(matrix-unit bar, their own activation stream), and the
    # ops' times add.  The attainable nodes/s lies in [attainable_realistic,
    # attainable].
    t_gemm_ms = max(t_mxu_ms, w.hbm_bytes_gemm / (peaks["hbm_gbps"] * 1e9) * 1e3)
    floor_realistic_ms = max(t_gemm_ms + t_vpu_ms + t_trans_ms, t_hbm_hi_ms)
    return {
        "floor_ms": round(floor_ms, 2),
        "floor_realistic_ms": round(floor_realistic_ms, 2),
        "t_mxu_ms": round(t_mxu_ms, 2),
        "t_vpu_ms": round(t_vpu_ms, 2),
        "t_trans_ms": round(t_trans_ms, 2),
        "t_hbm_ms": round(t_hbm_ms, 2),
        "t_hbm_realistic_ms": round(t_hbm_hi_ms, 2),
        "t_gemm_serial_ms": round(t_gemm_ms, 2),
        "binding_resource": (
            "vpu+trans"
            if t_vpu_ms + t_trans_ms >= max(t_mxu_ms, t_hbm_ms)
            else ("hbm" if t_hbm_ms >= t_mxu_ms else "mxu")
        ),
        "binding_resource_realistic": (
            "vpu+trans"
            if t_vpu_ms + t_trans_ms >= max(t_mxu_ms, t_hbm_hi_ms)
            else ("hbm" if t_hbm_hi_ms >= t_mxu_ms else "mxu")
        ),
        "attainable_nodes_per_sec": round(real_nodes / (floor_ms / 1e3), 0),
        "attainable_realistic_nodes_per_sec": round(
            real_nodes / (floor_realistic_ms / 1e3), 0
        ),
        "work_per_cell": {
            "mxu_macs": round(step_work_per_cell(cfg).mxu_macs),
            "vpu_ops": round(step_work_per_cell(cfg).vpu_ops),
            "trans_ops": round(step_work_per_cell(cfg).trans_ops),
            "hbm_bytes": round(step_work_per_cell(cfg).hbm_bytes),
            "hbm_bytes_realistic": round(step_work_per_cell(cfg).hbm_bytes_hi),
        },
        "peaks": peaks,
    }
