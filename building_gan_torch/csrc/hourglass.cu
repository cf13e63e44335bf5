// Deterministic GAT hourglass forward for Hopper (sm_90a), f32 math, with x
// and out stored as f32, as bf16 (the JAX package's default COMPUTE_DTYPE) or
// as f16.
//
// Replaces building_gan_tpu/ops/pallas/hourglass.py::_kernel (reached through
// hourglass_fwd): the whole GATCONV + GraphNorm + ReLU stack of the generator,
// L layers of
//     h   = x[:, :ci] @ W[:ci, :co]                  (f32 FMA, no TF32)
//     a_s = h . att_src,  a_d = h . att_dst
//     e_d = LeakyReLU(a_s[nbr_d] + a_d), masked to -1e30 where nbr_d is not a
//           neighbour; softmax over {self, 6 row shifts +-1, +-X, +-Y*X}
//     v   = mask * sum_d alpha_d h[nbr_d] + bias
//     y   = ReLU(GraphNorm(v)), statistics per (slot, gid key), 0 off the mask
// x and out are (B, R, cmax) with R = F*Y*X rows a slot.  With bf16 or f16
// storage x is read as the floats it holds, each layer's output is rounded to
// the storage type (to nearest even) before the next layer reads it (as the
// plain twin and the training kernels, csrc/gat_train.cu, round theirs), and
// out is written in it; the last layer's v, which the f32 kernel keeps in
// out, goes to an f32 buffer (vlast) instead.
//
// What bounds it.  At the config of record (hidden 128, repeat 7, grid
// (11, 12, 12), 16 slots, K = 1) the stack does 1.34 GFLOP of f32 (the GEMMs
// at the real ci x co widths dominate) and must move 27 MB (x in, out back,
// the mask, the weights, once each): bound by operations, 0.0200 ms on an
// H100 SXM at 67 TFLOP/s f32 without tensor cores against 0.008 ms at
// 3.35 TB/s (chip_smoke.py::bound_of).  The first version of this file ran 3
// launches a layer over (64-row tile, slot) blocks, 42 a call, with h, v, the
// scores and the statistics going through device memory between them, one
// thread a channel walking a tile's rows serially (1-8 of 128 threads busy
// in the narrow layers), and took 1.11 ms: ~26 us a launch whatever the
// layer's width, a latency-bound 1.8% of the bound.
//
// Design: one launch a stack call, a thread block cluster a slot.
//  * The TPU kernel keeps a tile of slots resident in VMEM across all L
//    layers.  A slot in f32 (811 KB at the config of record) exceeds one
//    block's 227 KB of shared memory, but not a cluster's: C CTAs of one
//    cluster each own ceil(R / C) consecutive rows of the slot for all L
//    layers, and read each other's shared memory (distributed shared memory,
//    DSMEM).  x is read from device memory once and out written once; h, v,
//    the scores and the statistics stay in shared memory (the last layer's
//    v goes to out, which it becomes).  A row keeps x / v / y at columns
//    [0, ci) and h beside them (Chans::hoff): 192 floats at the config of
//    record's widths, so 6 CTAs hold a slot at the least.
//  * The cluster size is chosen at launch from the card's occupancy
//    (choose_cluster): the fewest rows an SM has to run, waves counted, and
//    within 5% of that more CTAs an SM.  On an H100 at the config of record
//    that is 12 CTAs of 132 rows (115,440 B each, two an SM): 192 CTAs for
//    16 slots, all at once (16 such clusters fit; 8-CTA clusters of 198 rows
//    fit 15 at once, so 16 slots took two waves).  Up to 16 CTAs
//    (non-portable cluster size) for larger slots.
//  * Per layer, in one CTA: (1) the GEMM from shared memory at the real
//    ci x co width, W staged in (column block, k chunk) stages of 8 KB (the
//    next stage's loads, and the next layer's first, in flight in registers
//    while this one computes); a thread holds up to 8 rows x 4 columns; the
//    scores a_s, a_d summed in its epilogue; cluster.sync(); (2) a thread a
//    row: the masked 7-way softmax, neighbour scores in another CTA's rows
//    read through map_shared_rank, every load issued before any is used;
//    (3) lanes over (row, 4 channels): the aggregate, a row's 7 h rows
//    loaded before any is used; (4) GraphNorm statistics per (key, channel):
//    this CTA's count, mean and sum of squares about the mean, from one pass
//    of f64 sums of d = v - v0 and d^2 with v0 a sample (the key's first row
//    here: the error of the sums' cancellation is ~1e-16 (1 + (mean - v0)^2 /
//    var) of the result); cluster.sync(); every CTA merges the C partials in
//    rank order, exactly (Chan's parallel form: sum (v - s)^2 = sum_j [M2_j +
//    n_j (m_j - s)^2] for the centre s = mean * mean_scale), into scale and
//    shift; (5) norm and ReLU in place.  2 cluster barriers a layer and one
//    at the end: 2 L + 1 = 29 a call.  The row metadata (key, 6 neighbour
//    bits, mask bit), the keys' counts and their first rows do not depend on
//    the layer: computed once, before the layer loop.
//  * Lanes by the layer's width, as in gat_train.cu: a lane holds 4
//    channels, the power of 2 >= ceil(co / 4) lanes a row, so a warp step
//    covers 32 / that many rows and the narrow layers keep every lane busy.
//    Rows are 4 mod 32 floats apart, so a warp's float4 loads of different
//    rows do not conflict.
//  * No atomics: every sum has a fixed order (the rows of a lane, a shuffle
//    tree, the warps, the ranks), so results are bit-reproducible and a
//    slot's output does not depend on its batchmates.  All shared memory is
//    the one dynamic allocation (hg_smem_bytes).
//  * What binds it now (PERF.md §6): ~8-9 us a layer of barriers and
//    dependent loads whatever the width (14 layers), and the two widest
//    layers' GEMMs (128 -> 64, 64 -> 128) at ~40% of the f32 peak; two CTAs an SM run the kernel
//    at 128 registers a thread, and a version that spilled ran 5-50% slower.
// Prediction (PERF.md §6), made for 8 CTAs of 198 rows: per CTA 198 rows
// x 43.7 kFLOP = 8.7 MFLOP, ~17 us at one SM's share of the f32 peak and
// ~35-60 us at a realistic share; the aggregate and statistics a few us a
// layer; 29 cluster barriers at ~0.5-1 us: 0.08-0.15 ms a call.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxC = 128;         // widest layer
constexpr int kMaxKeys = 16;       // buildings a slot (gid keys)
constexpr int kMaxLayers = 64;
constexpr int kMaxCluster = 16;    // CTAs a cluster, non-portable above 8
constexpr int kPortableCluster = 8;
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may take on sm_90
constexpr int kStage = 2048;        // GEMM: floats of one W stage (rows x columns)
constexpr int kMinRows = 64;        // cluster choice: rows a CTA below which more CTAs gain nothing
constexpr int kTracePoints = 8;     // a layer's trace points (mark())
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// The layers' widths and where each keeps h in a row of shared memory: x at
// columns [0, ci), v and y over it at [0, co) (the last layer's v and y go to
// out), h at [hoff, hoff + co), so that h, which neighbours read while v is
// written, never overlaps them.  width: the floats of a row all layers need.
struct Chans {
  int L, width;
  unsigned char ci[kMaxLayers], co[kMaxLayers], hoff[kMaxLayers];
};

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// One CTA's shared memory, offsets in floats (each a multiple of 4):
//   rows [rows][stride]  x, then v and y over it, and h at hoff (Chans)
//   stat [K][2][cmax]    f64: this CTA's mean and sum of squares about it
//   over                 a W stage (GEMM), the softmax weights (8 a row),
//                        the warps' f64 partials, then scale and shift (K x 2 x cmax)
//   score [2][rows]      a_s, a_d
//   meta [rows]          bits 0-5 neighbour valid, bit 6 mask, bits 8+ key + 1
//   cnt [K], frow [K]    this CTA's rows of each key, and the first of them (-1: none)
//   wcnt [C][K], ninv [K] f64: every rank's cnt and 1 / (the keys' rows), once
struct Layout {
  int rows, stride, stat, over, score, meta, cnt, wcnt, total;
};

__host__ __device__ __forceinline__ Layout layout_for(int R, int width, int cmax, int K, int C) {
  Layout s;
  s.rows = (R + C - 1) / C;
  s.stride = (round4(width) + 27) / 32 * 32 + 4;  // >= width rounded to 4, 4 mod 32
  s.stat = s.rows * s.stride;
  s.over = s.stat + round4(4 * K * cmax);
  int over = kStage;
  over = max(over, 8 * s.rows);
  over = max(over, 2 * kWarps * round4(cmax));
  over = max(over, 2 * K * cmax);
  over = max(over, 2 * kMaxKeys * kMaxKeys);  // the key-count and first-row cells, once
  s.score = s.over + round4(over);
  s.meta = s.score + round4(2 * s.rows);
  s.cnt = s.meta + round4(s.rows);
  s.wcnt = s.cnt + round4(2 * K);
  s.total = s.wcnt + round4(2 * (C * K + K));
  return s;
}

__host__ __device__ __forceinline__ int lanes_per_row(int co) {
  const int need = (co + 3) / 4;
  int L = 1;
  while (L < need) L <<= 1;
  return L;
}

__device__ __forceinline__ float lrelu(float v, float slope) { return v >= 0.f ? v : slope * v; }

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// One W stage: rows [k0, k0 + kStage / cw) x columns [cb, cb + cw) of a
// layer's W (null W: none), at most 512 float4s, 2 a thread; loaded into
// registers (the next stage's loads in flight while this one computes),
// then stored to shared memory.
struct WStage {
  const float* W;
  int ci, co, cb, cw, k0;
};

__device__ __forceinline__ int stage_floats4(const WStage& s) {
  return min(kStage / s.cw, round4(s.ci) - s.k0) * (s.cw / 4);
}

__device__ __forceinline__ void load_stage(const WStage& s, int cmax, float4 (&reg)[2]) {
  const int per = s.cw / 4, units = stage_floats4(s);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int u = threadIdx.x + q * kThreads;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (u < units) {
      const int k = s.k0 + u / per, c = s.cb + 4 * (u % per);
      if (k < s.ci) {
        const float* src = s.W + (size_t)k * cmax + c;
        if (cmax % 4 == 0 && c + 4 <= s.co) {
          v = ld4(src);
        } else {
          v.x = c < s.co ? src[0] : 0.f;
          v.y = c + 1 < s.co ? src[1] : 0.f;
          v.z = c + 2 < s.co ? src[2] : 0.f;
          v.w = c + 3 < s.co ? src[3] : 0.f;
        }
      }
    }
    reg[q] = v;
  }
}

__device__ __forceinline__ void store_stage(float* ws, const WStage& s, const float4 (&reg)[2]) {
  const int per = s.cw / 4, units = stage_floats4(s);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int u = threadIdx.x + q * kThreads;
    if (u < units) st4(ws + (u / per) * s.cw + 4 * (u % per), reg[q]);
  }
}

// GEMM column block width of a layer: 4, 8, 16 or 32.
__device__ __forceinline__ int block_cols(int co) {
  const int c4 = round4(co);
  return c4 <= 4 ? 4 : c4 <= 8 ? 8 : c4 <= 16 ? 16 : 32;
}

// Trace point i of this CTA: the device clock in ns (%globaltimer), written
// by thread 0 when a trace buffer is given (chip_smoke.py's time by layer).
__device__ __forceinline__ void mark(unsigned long long* trace, size_t i) {
  if (trace == nullptr || threadIdx.x != 0) return;
#ifdef __CUDA_ARCH__
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  trace[i] = ns;
#else
  trace[i] = i;
#endif
}

__device__ __forceinline__ double sum_subrows(double v, int L) {
  for (int o = L; o < 32; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// One layer's GEMM as one thread sees it.
struct GemmArgs {
  const float* xs;
  float *ws, *hs, *a_s, *a_d;
  int S, nrows, RT, tc, CT, ci4, co4, cmax;
};

// One GEMM pass of a thread: rows r0 + RT * i (i < TM) of h's columns
// [c, c + 4) = x[:, :ci4] @ W's column block `cur`, the W stages (k chunks)
// staged in turn, the one `after` them loaded ahead; h stored at hs, each
// row's score partials summed over its CT column lanes and added into a_s,
// a_d by the first.  Every thread of the block calls it (barriers, shuffles).
template <int TM>
__device__ __forceinline__ void gemm_pass(const GemmArgs& g, WStage cur, const WStage& after,
                                          int r0, int c, const float (&as)[4],
                                          const float (&ad)[4], float4 (&wpre)[2]) {
  int rows[TM];
  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    rows[i] = min(r0 + g.RT * i, g.nrows - 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  const int kc = kStage / cur.cw, cw = cur.cw, tc4 = 4 * g.tc;
  for (int k0 = 0; k0 < g.ci4; k0 += kc) {
    cur.k0 = k0;
    store_stage(g.ws, cur, wpre);
    __syncthreads();
    if (k0 + kc < g.ci4) {
      WStage nx = cur;
      nx.k0 = k0 + kc;
      load_stage(nx, g.cmax, wpre);
    } else if (after.W != nullptr) {
      load_stage(after, g.cmax, wpre);
    }
    const int kend = min(g.ci4, k0 + kc);
    for (int k = k0; k < kend; k += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = ld4(g.xs + rows[i] * g.S + k);
      const float* wk = g.ws + (k - k0) * cw + tc4;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b = ld4(wk + kk * cw);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
          acc[i][0] = fmaf(av, b.x, acc[i][0]);
          acc[i][1] = fmaf(av, b.y, acc[i][1]);
          acc[i][2] = fmaf(av, b.z, acc[i][2]);
          acc[i][3] = fmaf(av, b.w, acc[i][3]);
        }
      }
    }
    __syncthreads();  // the stage's readers are done
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float ps = 0.f, pd = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ps = fmaf(acc[i][j], as[j], ps);
      pd = fmaf(acc[i][j], ad[j], pd);
    }
    for (int o = 1; o < g.CT; o <<= 1) {  // the CT column lanes of the row
      ps += __shfl_xor_sync(kFull, ps, o);
      pd += __shfl_xor_sync(kFull, pd, o);
    }
    const int r = r0 + g.RT * i;
    if (r < g.nrows) {
      if (c < g.co4) st4(g.hs + r * g.S + c, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      if (g.tc == 0) {
        g.a_s[r] += ps;
        g.a_d[r] += pd;
      }
    }
  }
}

// Channels c .. c + 3 of a row that lies in device memory (n floats a row):
// one float4 when rows are 16-byte aligned (vec), else element by element.
__device__ __forceinline__ float4 load_row4(const float* row, int c, int n, bool vec) {
  if (vec) return ld4(row + c);
  return make_float4(row[c], c + 1 < n ? row[c + 1] : 0.f, c + 2 < n ? row[c + 2] : 0.f,
                     c + 3 < n ? row[c + 3] : 0.f);
}

// A 16-bit storage value as the float it is, and a float rounded once to it.
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <class T>
__device__ __forceinline__ T from_float(float v) {
  if constexpr (std::is_same<T, __half>::value)
    return __float2half_rn(v);
  else
    return __float2bfloat16_rn(v);
}

template <class T>
__device__ __forceinline__ float round_to(float v) { return to_float(from_float<T>(v)); }

// The same from a 16-bit row (element by element), and to one, each value rounded once.
template <class T>
__device__ __forceinline__ float4 load_row4_16(const T* row, int c, int n) {
  return make_float4(to_float(row[c]), c + 1 < n ? to_float(row[c + 1]) : 0.f,
                     c + 2 < n ? to_float(row[c + 2]) : 0.f, c + 3 < n ? to_float(row[c + 3]) : 0.f);
}

template <class T>
__device__ __forceinline__ void store_row4_16(T* row, int c, int n, float4 v) {
  row[c] = from_float<T>(v.x);
  if (c + 1 < n) row[c + 1] = from_float<T>(v.y);
  if (c + 2 < n) row[c + 2] = from_float<T>(v.z);
  if (c + 3 < n) row[c + 3] = from_float<T>(v.w);
}

__device__ __forceinline__ void store_row4(float* row, int c, int n, bool vec, float4 v) {
  if (vec) {
    st4(row + c, v);
    return;
  }
  row[c] = v.x;
  if (c + 1 < n) row[c + 1] = v.y;
  if (c + 2 < n) row[c + 2] = v.z;
  if (c + 3 < n) row[c + 3] = v.w;
}

// T: the storage type of x and out, float (vlast == out) or a 16-bit type,
// __nv_bfloat16 or __half (vlast holds the last layer's v).  An instance a
// storage type: a runtime flag's extra code made the f32 kernel spill at 128
// registers and run ~20% slower.
template <class T>
__global__ void __launch_bounds__(kThreads, 2)
hg_cluster_kernel(const void* __restrict__ x, const float* __restrict__ mask,
                  const int* __restrict__ gid, const float* __restrict__ Ws,
                  const float* __restrict__ atts, const float* __restrict__ vecs,
                  void* __restrict__ out, float* __restrict__ vlast, const Chans ch, int R, int Y,
                  int X, int cmax, int K, float slope, float eps,
                  unsigned long long* __restrict__ trace) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int L = ch.L;
  // trace: 1 + kTracePoints L points a CTA: entry, then for each layer its
  // start, after the GEMM barrier, after the softmax, after the aggregate,
  // after the statistics, after the statistics barrier, after the merge, end
  const size_t tr0 = ((size_t)blockIdx.y * C + rank) * (1 + kTracePoints * L);
  mark(trace, tr0);
  const Layout lay = layout_for(R, ch.width, cmax, K, C);
  const int Rc = lay.rows, S = lay.stride, cm4 = round4(cmax);
  const int r0 = rank * Rc;
  const int nrows = max(0, min(Rc, R - r0));
  const int t = threadIdx.x, w = t / 32, lane = t & 31;
  const size_t slot = (size_t)blockIdx.y * R;
  float* xs = smem;
  double* stat = reinterpret_cast<double*>(smem + lay.stat);
  float* over = smem + lay.over;
  float* a_s = smem + lay.score;
  float* a_d = a_s + Rc;
  int* meta = reinterpret_cast<int*>(smem + lay.meta);
  int* cnt = reinterpret_cast<int*>(smem + lay.cnt);
  int* frow = cnt + K;
  double* wcnt = reinterpret_cast<double*>(smem + lay.wcnt);
  double* ninv = wcnt + C * K;
  const int off[6] = {Y * X, -Y * X, X, -X, 1, -1};  // neighbour d of row r is r - off[d]
  const bool vec = cmax % 4 == 0;                      // x / out rows load as float4
  // neighbour d of this CTA's row rr: row rr + nrb[d] (less Rc, one rank on, when
  // >= Rc) of rank rank + nqb[d]; no division in the row loops
  int nqb[6], nrb[6];
#pragma unroll
  for (int d = 0; d < 6; ++d) {
    const int o = -off[d];
    nqb[d] = o >= 0 ? o / Rc : -((-o + Rc - 1) / Rc);
    nrb[d] = o - nqb[d] * Rc;
  }

  // layer 0's first W stage in flight while x loads
  float4 wpre[2];
  load_stage(WStage{Ws, ch.ci[0], ch.co[0], 0, block_cols(ch.co[0]), 0}, cmax, wpre);

  // Own rows of x (zeros from cmax to cmax rounded to 4), metadata, key counts.
  const int q4 = cm4 / 4;
  for (int i = t; i < nrows * q4; i += kThreads) {
    const int rr = i / q4, c = 4 * (i % q4);
    const size_t row = (slot + r0 + rr) * cmax;
    if constexpr (std::is_same<T, float>::value)
      st4(xs + rr * S + c, load_row4(static_cast<const float*>(x) + row, c, cmax, vec));
    else
      st4(xs + rr * S + c, load_row4_16(static_cast<const T*>(x) + row, c, cmax));
  }
  for (int rr = t; rr < nrows; rr += kThreads) {
    const int r = r0 + rr;
    const bool live = mask[slot + r] > 0.f;
    const int g = gid ? gid[slot + r] : 0;
    const int key = !live ? -1 : K == 1 ? 0 : (g >= 0 && g < K ? g : -1);
    const int iy = (r / X) % Y, ix = r % X;
    const bool inside[6] = {true, true, iy >= 1, iy <= Y - 2, ix >= 1, ix <= X - 2};
    int bits = 0;
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      const int n = r - off[d];
      const bool ok = inside[d] && n >= 0 && n < R && mask[slot + n] > 0.f &&
                      (!gid || gid[slot + n] == g);
      bits |= ok ? 1 << d : 0;
    }
    meta[rr] = bits | (live ? 64 : 0) | ((key + 1) << 8);
  }
  __syncthreads();
  {
    // [16 row groups][16 keys]: rows of the key, and the first of them, in each group
    int* cells = reinterpret_cast<int*>(over);
    int* first = cells + kMaxKeys * kMaxKeys;
    const int k = t % kMaxKeys, grp = t / kMaxKeys;
    int n = 0, f = -1;
    for (int rr = grp; rr < nrows; rr += kThreads / kMaxKeys) {
      if ((meta[rr] >> 8) - 1 == k) {
        f = n == 0 ? rr : f;
        ++n;
      }
    }
    cells[grp * kMaxKeys + k] = n;
    first[grp * kMaxKeys + k] = f;
    __syncthreads();
    if (t < K) {
      int total = 0, f0 = -1;
      for (int j = 0; j < kThreads / kMaxKeys; ++j) {
        total += cells[j * kMaxKeys + t];
        const int fj = first[j * kMaxKeys + t];
        if (fj >= 0 && (f0 < 0 || fj < f0)) f0 = fj;
      }
      cnt[t] = total;
      frow[t] = f0;
    }
    __syncthreads();
  }

  for (int l = 0; l < L; ++l) {
    const size_t trl = tr0 + 1 + kTracePoints * l;
    mark(trace, trl);
    const int ci = ch.ci[l], co = ch.co[l], co4 = round4(co), ho = ch.hoff[l];
    const bool last = l + 1 == L;
    const float* att = atts + (size_t)l * 2 * cmax;
    const float* vb = vecs + (size_t)l * 4 * cmax;
    float* hs = xs + ho;  // h of row rr at hs + rr * S

    // (1) h = x[:, :ci] @ W[:ci, :co] and the scores, by column blocks of W,
    // each staged in k chunks; each pass covers a thread's rows tr, tr + RT, ...
    // (at most 8)
    {
      const float* W = Ws + (size_t)l * cmax * cmax;
      const int cw = block_cols(co), CT = cw / 4, RT = kThreads / CT;
      const int tc = t % CT, tr = t / CT;
      const GemmArgs g{xs, over, hs, a_s, a_d, S, nrows, RT, tc, CT, round4(ci), co4, cmax};
      const int tm = min(8, (nrows + RT - 1) / RT);
      for (int rr = t; rr < nrows; rr += kThreads) a_s[rr] = a_d[rr] = 0.f;
      for (int cb = 0; cb < co4; cb += cw) {
        const int c = cb + 4 * tc;
        float as[4], ad[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          as[j] = c + j < co ? att[c + j] : 0.f;
          ad[j] = c + j < co ? att[cmax + c + j] : 0.f;
        }
        for (int rb = 0; rb < nrows; rb += RT * tm) {
          const WStage cur{W, ci, co, cb, cw, 0};
          WStage after{nullptr, 0, 0, 0, 4, 0};
          if (rb + RT * tm < nrows) {
            after = cur;
          } else if (cb + cw < co4) {
            after = WStage{W, ci, co, cb + cw, cw, 0};
          } else if (!last) {
            after = WStage{W + (size_t)cmax * cmax, ch.ci[l + 1], ch.co[l + 1], 0,
                           block_cols(ch.co[l + 1]), 0};
          }
          const int r1 = rb + tr;
          switch (tm) {
            case 1: gemm_pass<1>(g, cur, after, r1, c, as, ad, wpre); break;
            case 2: gemm_pass<2>(g, cur, after, r1, c, as, ad, wpre); break;
            case 3: gemm_pass<3>(g, cur, after, r1, c, as, ad, wpre); break;
            case 4: gemm_pass<4>(g, cur, after, r1, c, as, ad, wpre); break;
            case 5: gemm_pass<5>(g, cur, after, r1, c, as, ad, wpre); break;
            case 6: gemm_pass<6>(g, cur, after, r1, c, as, ad, wpre); break;
            case 7: gemm_pass<7>(g, cur, after, r1, c, as, ad, wpre); break;
            default: gemm_pass<8>(g, cur, after, r1, c, as, ad, wpre); break;
          }
        }
      }
    }
    cluster.sync();  // every CTA's h and scores are complete
    mark(trace, trl + 1);
    if (l == 0) {  // every rank's key counts, once: they do not depend on the layer
      for (int i = t; i < C * K; i += kThreads) wcnt[i] = cluster.map_shared_rank(cnt, i / K)[i % K];
      for (int k = t; k < K; k += kThreads) {
        int n = 0;
        for (int j = 0; j < C; ++j) n += cluster.map_shared_rank(cnt, j)[k];
        ninv[k] = n > 0 ? 1.0 / n : 0.0;
      }
    }

    // (2) a thread a row: the masked softmax over self and the 6 neighbours
    for (int rr = t; rr < nrows; rr += kThreads) {
      const int m = meta[rr];
      float asn[6];
#pragma unroll
      for (int d = 0; d < 6; ++d) {  // every load first; an invalid neighbour reads the row itself
        const float* src = a_s + rr;
        if (m >> d & 1) {
          int lr = rr + nrb[d], q = rank + nqb[d];
          if (lr >= Rc) lr -= Rc, ++q;
          src = (q == rank ? a_s : cluster.map_shared_rank(a_s, q)) + lr;
        }
        asn[d] = *src;
      }
      const float ad = a_d[rr];
      const float e_self = lrelu(a_s[rr] + ad, slope);
      float e[6], mx = e_self;
#pragma unroll
      for (int d = 0; d < 6; ++d) {
        e[d] = (m >> d & 1) ? lrelu(asn[d] + ad, slope) : kNegInf;
        mx = fmaxf(mx, e[d]);
      }
      float ex[6], sum = 0.f;
#pragma unroll
      for (int d = 0; d < 6; ++d) {
        ex[d] = (m >> d & 1) ? expf(e[d] - mx) : 0.f;
        sum += ex[d];
      }
      const float ex_self = expf(e_self - mx);
      const float inv = 1.f / fmaxf(sum + ex_self, 1e-16f);
      float* al = over + rr * 8;
      st4(al, make_float4(ex[0] * inv, ex[1] * inv, ex[2] * inv, ex[3] * inv));
      st4(al + 4, make_float4(ex[4] * inv, ex[5] * inv, ex_self * inv, 0.f));
    }
    __syncthreads();
    mark(trace, trl + 2);

    // (3) lanes over (row, 4 channels): v = mask * sum alpha h[nbr] + bias, over x
    // (at the last layer into out); a row's 7 h rows, local or in another CTA,
    // are all loaded before any is used
    const int Lr = lanes_per_row(co), rpw = 32 / Lr, sub = lane / Lr, c = 4 * (lane % Lr);
    const bool act = c < co;
    float* vrow0 = last ? vlast + (slot + r0) * cmax : xs;  // row rr of v at vrow0 + rr * vstride
    const int vstride = last ? cmax : S;
    const bool vvec = last ? vec : true;
    {
      float bias[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bias[j] = act && c + j < co ? vb[c + j] : 0.f;
      for (int base = w * rpw; base < nrows; base += kWarps * rpw) {
        const int rr = base + sub;
        if (rr >= nrows || !act) continue;
        const int m = meta[rr];
        const float* src[6];
#pragma unroll
        for (int d = 0; d < 6; ++d) {
          src[d] = hs + rr * S + c;
          if (m >> d & 1) {
            int lr = rr + nrb[d], q = rank + nqb[d];
            if (lr >= Rc) lr -= Rc, ++q;
            src[d] = (q == rank ? hs : cluster.map_shared_rank(hs, q)) + lr * S + c;
          }
        }
        const float4 a0 = ld4(over + rr * 8), a1 = ld4(over + rr * 8 + 4);
        const float4 hself = ld4(hs + rr * S + c);
        float4 hn[6];
#pragma unroll
        for (int d = 0; d < 6; ++d) hn[d] = ld4(src[d]);
        const float al[6] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y};
        float4 u = make_float4(a1.z * hself.x, a1.z * hself.y, a1.z * hself.z, a1.z * hself.w);
#pragma unroll
        for (int d = 0; d < 6; ++d) {
          u.x = fmaf(al[d], hn[d].x, u.x);
          u.y = fmaf(al[d], hn[d].y, u.y);
          u.z = fmaf(al[d], hn[d].z, u.z);
          u.w = fmaf(al[d], hn[d].w, u.w);
        }
        if (!(m & 64)) u = make_float4(0.f, 0.f, 0.f, 0.f);
        store_row4(vrow0 + (size_t)rr * vstride, c, co, vvec,
                   make_float4(u.x + bias[0], u.y + bias[1], u.z + bias[2], u.w + bias[3]));
      }
    }
    __syncthreads();
    mark(trace, trl + 3);

    // (4) this CTA's moments a key, into stat: its mean and its sum of squares
    // about that mean, from f64 sums of d = v - v0 and d^2, where v0 is the
    // key's first row here (one pass over the rows: a shift by a sample of the
    // data keeps the f64 sums' cancellation at ~1e-16 (1 + (mean - v0)^2 / var)
    // of the result, as good as a second pass about the mean).  Layers up to 8
    // wide: one warp, a lane's rows lane, lane + 32, ..., then a shuffle tree
    // (no barrier; the cluster barrier follows).  Wider: the lanes of step (3),
    // then the warps' cells, the two sums together when they fit.
    if (co <= 8) {
      if (w == 0) {
        for (int k = 0; k < K; ++k) {
          const int fr = frow[k];
          const double rn = cnt[k] > 0 ? 1.0 / cnt[k] : 0.0;
          for (int g4 = 0; g4 < co; g4 += 4) {
            double v0[4] = {0.0, 0.0, 0.0, 0.0}, a1[4] = {0.0, 0.0, 0.0, 0.0}, a2[4] = {0.0, 0.0, 0.0, 0.0};
            if (fr >= 0) {
              const float4 f = load_row4(vrow0 + (size_t)fr * vstride, g4, co, vvec);
              v0[0] = f.x, v0[1] = f.y, v0[2] = f.z, v0[3] = f.w;
            }
            for (int rr = lane; rr < nrows; rr += 32) {
              if ((meta[rr] >> 8) - 1 != k) continue;
              const float4 v = load_row4(vrow0 + (size_t)rr * vstride, g4, co, vvec);
              const double d[4] = {v.x - v0[0], v.y - v0[1], v.z - v0[2], v.w - v0[3]};
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                a1[j] += d[j];
                a2[j] = fma(d[j], d[j], a2[j]);
              }
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (g4 + j < co) {
                a1[j] = sum_subrows(a1[j], 1);
                a2[j] = sum_subrows(a2[j], 1);
              }
            }
            if (lane == 0) {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                if (g4 + j < co) {
                  double* st = stat + (size_t)(2 * k) * cmax + g4 + j;  // st[0] mean, st[cmax] M2
                  st[0] = fr >= 0 ? v0[j] + a1[j] * rn : 0.0;
                  st[cmax] = fmax(a2[j] - a1[j] * a1[j] * rn, 0.0);
                }
              }
            }
          }
        }
      }
    } else {
      double* red = reinterpret_cast<double*>(over);  // [quantity][warp][co4]
      const int nq = 2 * kWarps * co4 <= kStage / 2 ? 2 : 1;
      for (int k = 0; k < K; ++k) {
        const int fr = frow[k];
        const double rn = cnt[k] > 0 ? 1.0 / cnt[k] : 0.0;
        double v0[4] = {0.0, 0.0, 0.0, 0.0}, a1[4] = {0.0, 0.0, 0.0, 0.0}, a2[4] = {0.0, 0.0, 0.0, 0.0};
        if (fr >= 0 && act) {
          const float4 f = load_row4(vrow0 + (size_t)fr * vstride, c, co, vvec);
          v0[0] = f.x, v0[1] = f.y, v0[2] = f.z, v0[3] = f.w;
        }
        for (int base = w * rpw; base < nrows; base += kWarps * rpw) {
          const int rr = base + sub;
          if (rr >= nrows || !act || (meta[rr] >> 8) - 1 != k) continue;
          const float4 v = load_row4(vrow0 + (size_t)rr * vstride, c, co, vvec);
          const double d[4] = {v.x - v0[0], v.y - v0[1], v.z - v0[2], v.w - v0[3]};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            a1[j] += d[j];
            a2[j] = fma(d[j], d[j], a2[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a1[j] = sum_subrows(a1[j], Lr);
          a2[j] = sum_subrows(a2[j], Lr);
        }
        for (int q0 = 0; q0 < 2; q0 += nq) {
          if (sub == 0 && act) {
            for (int q = q0; q < q0 + nq; ++q)
#pragma unroll
              for (int j = 0; j < 4; ++j) red[((q - q0) * kWarps + w) * co4 + c + j] = q == 0 ? a1[j] : a2[j];
          }
          __syncthreads();
          for (int e = t; e < co; e += kThreads) {
            double sum[2] = {0.0, 0.0};
            for (int q = q0; q < q0 + nq; ++q)
              for (int ww = 0; ww < kWarps; ++ww) sum[q] += red[((q - q0) * kWarps + ww) * co4 + e];
            double* st = stat + (size_t)(2 * k) * cmax + e;  // st[0] mean, st[cmax] M2
            if (q0 == 0) st[0] = sum[0];                     // the sum of d until the end
            if (q0 + nq == 2) {
              const double s1 = st[0], s2 = sum[1];
              const double f0 = fr >= 0 ? (double)vrow0[(size_t)fr * vstride + e] : 0.0;
              st[0] = fr >= 0 ? f0 + s1 * rn : 0.0;
              st[cmax] = fmax(s2 - s1 * s1 * rn, 0.0);
            }
          }
          __syncthreads();
        }
      }
    }
    mark(trace, trl + 4);
    cluster.sync();  // every CTA's statistics are complete
    mark(trace, trl + 5);

    // merge the C partials into scale and shift, ss[k][0 / 1][cmax]: n = sum n_j,
    // mean = sum n_j m_j / n, s = mean * mean_scale, sum (v - s)^2 = sum_j [M2_j
    // + n_j (m_j - s)^2], each sum in rank order; every rank's partials in flight
    // at once
    {
      float* ss = over;
      for (int e = t; e < K * co; e += kThreads) {
        const int k = e / co, cc = e % co;
        const size_t im = (size_t)(2 * k) * cmax + cc, iq = im + cmax;
        const double gn_w = vb[cmax + cc], gn_b = vb[2 * cmax + cc], gn_ms = vb[3 * cmax + cc];
        double mj[kMaxCluster], qj[kMaxCluster];
#pragma unroll
        for (int j = 0; j < kMaxCluster; ++j) {
          const double* st = cluster.map_shared_rank(stat, min(j, C - 1));
          mj[j] = st[im];
          qj[j] = st[iq];
        }
        double scale = 0.0, shift = 0.0;
        if (ninv[k] > 0.0) {
          double s1 = 0.0, q = 0.0;
#pragma unroll
          for (int j = 0; j < kMaxCluster; ++j) {
            if (j < C) {
              s1 += wcnt[j * K + k] * mj[j];
              q += qj[j];
            }
          }
          const double s = s1 * ninv[k] * gn_ms;
#pragma unroll
          for (int j = 0; j < kMaxCluster; ++j) {
            if (j < C) {
              const double dm = mj[j] - s;
              q += wcnt[j * K + k] * dm * dm;
            }
          }
          scale = gn_w * rsqrt(q * ninv[k] + (double)eps);
          shift = gn_b - s * scale;
        }
        ss[(2 * k) * cmax + cc] = (float)scale;
        ss[(2 * k + 1) * cmax + cc] = (float)shift;
      }
    }
    if (last) {
      cluster.sync();  // no CTA leaves while another still reads its statistics
    } else {
      __syncthreads();
    }
    mark(trace, trl + 6);

    // (5) y = ReLU(v * scale + shift) on the mask, 0 off it, in place over v
    // (16-bit storage: rounded to it, and the last layer's to out)
    {
      const float* ss = over;
      for (int base = w * rpw; base < nrows; base += kWarps * rpw) {
        const int rr = base + sub;
        if (rr >= nrows || !act) continue;
        const int key = (meta[rr] >> 8) - 1;
        float* vr = vrow0 + (size_t)rr * vstride;
        const float4 v = load_row4(vr, c, co, vvec);
        const float vv[4] = {v.x, v.y, v.z, v.w};
        float y[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          y[j] = 0.f;
          if (key >= 0 && c + j < co)
            y[j] = fmaxf(fmaf(vv[j], ss[(2 * key) * cmax + c + j], ss[(2 * key + 1) * cmax + c + j]), 0.f);
        }
        const float4 y4 = make_float4(y[0], y[1], y[2], y[3]);
        if constexpr (std::is_same<T, float>::value) {
          store_row4(vr, c, co, vvec, y4);
        } else if (last) {
          store_row4_16(static_cast<T*>(out) + (slot + r0 + rr) * cmax, c, co, y4);
        } else {
          store_row4(vr, c, co, vvec,
                     make_float4(round_to<T>(y4.x), round_to<T>(y4.y), round_to<T>(y4.z),
                                 round_to<T>(y4.w)));
        }
      }
      __syncthreads();  // y complete before the next GEMM reads it and restages W
    }
    mark(trace, trl + 7);
  }
}

// The kernel instance of a storage code (0: float, 1: __nv_bfloat16, 2: __half).
constexpr int kStorages = 3;
using Kernel = decltype(&hg_cluster_kernel<float>);
Kernel kernel_for(int storage) {
  return storage == 1 ? hg_cluster_kernel<__nv_bfloat16>
         : storage == 2 ? hg_cluster_kernel<__half>
                        : hg_cluster_kernel<float>;
}

// Dynamic shared memory beyond 48 KB, and cluster sizes above 8, have to be
// allowed per kernel instance and device first.  cudaFuncSetAttribute costs
// host time on every call, so each grant is raised to the largest size asked
// so far and left there.  The occupancy queries of the cluster choice are
// kept per (device, cluster size, bytes) for the same reason; they ask the
// f32 instance, which answers for all three: each is held to 128 registers by
// its launch bounds and takes the same shared memory.
std::mutex g_mutex;
int g_smem_granted[kStorages][64];
bool g_nonportable[kStorages][64];
int g_sms[64];

struct Occupancy {
  int device, C, bytes, clusters, per_sm;
};
Occupancy g_occ[256];
int g_occ_n = 0;

cudaError_t allow_locked(int device, int bytes, int C, int storage) {
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (bytes > g_smem_granted[storage][device]) {
    const cudaError_t e = cudaFuncSetAttribute(kernel_for(storage),
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    g_smem_granted[storage][device] = bytes;
  }
  if (C > kPortableCluster && !g_nonportable[storage][device]) {
    const cudaError_t e = cudaFuncSetAttribute(kernel_for(storage),
                                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    g_nonportable[storage][device] = true;
  }
  return cudaSuccess;
}

cudaError_t allow(int device, int bytes, int C, int storage) {
  std::lock_guard<std::mutex> lock(g_mutex);
  return allow_locked(device, bytes, C, storage);
}

void launch_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int B, int C, int bytes,
                   cudaStream_t stream) {
  cfg->gridDim = dim3(C, B, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = bytes;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// Clusters of C CTAs the device holds at once, and CTAs an SM, at `bytes` a CTA.
cudaError_t occupancy(int device, int C, int bytes, Occupancy* o) {
  std::lock_guard<std::mutex> lock(g_mutex);
  for (int i = 0; i < g_occ_n; ++i)
    if (g_occ[i].device == device && g_occ[i].C == C && g_occ[i].bytes == bytes) {
      *o = g_occ[i];
      return cudaSuccess;
    }
  cudaError_t e = allow_locked(device, bytes, C, 0);
  if (e != cudaSuccess) return e;
  *o = Occupancy{device, C, bytes, 0, 0};
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  launch_config(&cfg, attr, C, C, bytes, nullptr);
  e = cudaOccupancyMaxActiveClusters(&o->clusters, kernel_for(0), &cfg);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o->per_sm, kernel_for(0), kThreads, bytes);
  if (e == cudaSuccess && g_sms[device] == 0)
    e = cudaDeviceGetAttribute(&g_sms[device], cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  if (g_occ_n < 256) g_occ[g_occ_n++] = *o;
  return cudaSuccess;
}

// The layers' widths and h offsets (Chans) from L (ci, co) pairs; false on
// widths the kernel does not take: each in [1, cmax], each layer's ci the
// previous co, the last co equal to cmax.
bool make_chans(const int* chans, int L, int cmax, Chans* ch) {
  if (L < 1 || L > kMaxLayers || cmax < 1 || cmax > kMaxC) return false;
  ch->L = L;
  ch->width = round4(cmax);
  for (int l = 0; l < L; ++l) {
    const int ci = chans[2 * l], co = chans[2 * l + 1];
    if (ci < 1 || co < 1 || ci > cmax || co > cmax || (l > 0 && ci != chans[2 * l - 1])) return false;
    const int ho = round4(max(ci, l + 1 < L ? co : 0));
    ch->ci[l] = (unsigned char)ci;
    ch->co[l] = (unsigned char)co;
    ch->hoff[l] = (unsigned char)ho;
    ch->width = max(ch->width, ho + round4(co));
  }
  return chans[2 * L - 1] == cmax;
}

int smem_bytes(int R, const Chans& ch, int cmax, int K, int C) {
  return 4 * layout_for(R, ch.width, cmax, K, C).total;
}

// The cluster size for B slots of R rows: of the sizes whose CTAs' shares of
// a slot fit their shared memory, the one with the fewest rows an SM has to
// run, waves counted: waves (B over the clusters the device holds at once)
// x rows a CTA (at least kMinRows) x CTAs sharing an SM.  Within 5% of that,
// the one with more CTAs an SM: the kernel is bound by latency (barriers,
// dependent loads), which a second CTA on the SM hides.  0 if none fits.
int choose_cluster(int B, int R, const Chans& ch, int cmax, int K, int device) {
  int best = 0;
  double best_cost = 0.0;
  long long best_share = 0;
  for (int C = 1; C <= kMaxCluster; ++C) {
    const int bytes = smem_bytes(R, ch, cmax, K, C);
    Occupancy o;
    if (bytes > kSmemLimit || occupancy(device, C, bytes, &o) != cudaSuccess || o.clusters < 1)
      continue;
    const long long rows = (R + C - 1) / C;
    const long long waves = (B + o.clusters - 1) / o.clusters;
    const long long ctas = (long long)min(B, o.clusters) * C;
    const int sms = max(1, g_sms[device]);
    const long long share = max(1LL, min((long long)o.per_sm, (ctas + sms - 1) / sms));
    const double cost = (double)(waves * max(rows, (long long)kMinRows) * share);
    if (best == 0 || cost < 0.95 * best_cost || (cost <= 1.05 * best_cost && share > best_share)) {
      best = C;
      best_cost = cost;
      best_share = share;
    }
  }
  return best;
}

}  // namespace

extern "C" {

// Runs the whole stack in one launch: a cluster of `cluster` CTAs a slot (0:
// hg_cluster_size's choice).  Device pointers: x, out (B, R, cmax) in the
// storage `storage` names (0: f32, 1: bf16, 2: f16); vlast (B, R, cmax) f32
// for the last layer's v with 16-bit storage (null with f32: out holds it); mask
// (B, R), gid (B, R) int32 or null (K == 1), Ws (L, cmax, cmax), atts (L, 2,
// cmax), vecs (L, 4, cmax) holding conv bias, GraphNorm weight, bias,
// mean_scale; x and out 16-byte aligned when cmax is a multiple of 4.  chans
// is a host array of L (ci, co) pairs, each layer's ci the previous co and
// the last co equal to cmax.  Takes B <= 65535 slots of R = F*Y*X rows when
// a cluster of at most 16 CTAs holds a slot (hg_cluster_size > 0).  out also
// holds the last layer's v.  trace: null, or B * C * (1 + 8 L) u64 for each
// CTA's clock at its trace points (mark()).  Launches on `stream`, does not
// synchronise; returns the CUDA error of a refused configuration or launch
// (0 on success).
int hg_forward(const void* x, const float* mask, const int* gid, int K, const float* Ws,
               const float* atts, const float* vecs, const int* chans, int L, int B, int F,
               int Y, int X, int cmax, float slope, float eps, void* out, float* vlast, int storage,
               int cluster, unsigned long long* trace, void* stream) {
  const int R = F * Y * X;
  Chans ch;
  if (!make_chans(chans, L, cmax, &ch) || K < 1 || K > kMaxKeys || (K > 1 && gid == nullptr) ||
      B < 1 || B > 65535 || F < 1 || Y < 1 || X < 1)
    return (int)cudaErrorInvalidValue;
  if (storage < 0 || storage >= kStorages || (storage ? vlast == nullptr : vlast != nullptr))
    return (int)cudaErrorInvalidValue;
  if (!storage) vlast = static_cast<float*>(out);
  if (cmax % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
        reinterpret_cast<uintptr_t>(vlast)) & 15))
    return (int)cudaErrorMisalignedAddress;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  const int C = cluster > 0 ? cluster : choose_cluster(B, R, ch, cmax, K, device);
  if (C < 1 || C > kMaxCluster) return (int)cudaErrorInvalidConfiguration;
  const int bytes = smem_bytes(R, ch, cmax, K, C);
  if (bytes > kSmemLimit) return (int)cudaErrorInvalidConfiguration;
  e = allow(device, bytes, C, storage);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  launch_config(&cfg, attr, B, C, bytes, (cudaStream_t)stream);
  e = cudaLaunchKernelEx(&cfg, kernel_for(storage), x, mask, gid, Ws, atts, vecs, out, vlast, ch, R, Y,
                         X, cmax, K, slope, eps, trace);
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}

// The cluster size hg_forward chooses for B slots of R rows on the current
// device (0: no cluster of at most 16 CTAs holds a slot, or bad widths).
int hg_cluster_size(int B, int R, int cmax, int K, const int* chans, int L) {
  Chans ch;
  int device = 0;
  if (!make_chans(chans, L, cmax, &ch) || B < 1 || R < 1 || K < 1 || K > kMaxKeys ||
      cudaGetDevice(&device) != cudaSuccess)
    return 0;
  return choose_cluster(B, R, ch, cmax, K, device);
}

// Dynamic shared memory of one CTA at cluster size C (0 on bad widths).
int hg_smem_bytes(int R, int cmax, int K, const int* chans, int L, int C) {
  Chans ch;
  if (!make_chans(chans, L, cmax, &ch) || C < 1 || K < 1) return 0;
  return smem_bytes(R, ch, cmax, K, C);
}

// Clusters of size C the current device holds at once
// (cudaOccupancyMaxActiveClusters), or -(CUDA error).
int hg_max_active_clusters(int R, int cmax, int K, const int* chans, int L, int C) {
  Chans ch;
  if (!make_chans(chans, L, cmax, &ch) || C < 1 || C > kMaxCluster || K < 1)
    return -(int)cudaErrorInvalidValue;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  Occupancy o;
  if (e == cudaSuccess) e = occupancy(device, C, smem_bytes(R, ch, cmax, K, C), &o);
  return e == cudaSuccess ? o.clusters : -(int)e;
}

const char* hg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
