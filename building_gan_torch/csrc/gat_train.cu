// Training GAT hourglass layer for Hopper (sm_90a), f32 on the CUDA cores
// (no TF32): forward and backward kernels, with the activations x, y, gy and
// gx stored as f32, as bf16 (the JAX package's default COMPUTE_DTYPE) or as
// f16 (the TPU kernel reads x.dtype and writes y and gx in it, its math and
// weight grads f32).  Everything between the loads and the stores is the same
// in all three: the saved residuals, the weights and their grads stay f32.
//
// Replaces building_gan_tpu/ops/pallas/gat_train.py::_fwd_kernel (one layer
// forward, reached through make_fused_layer and hourglass_train) and
// ::_bwd_kernel (its recompute backward, the custom VJP layer_bwd).  A layer:
//     h   = x[:, :ci] @ W[:ci, :co]
//     a_s = h . att_src,  a_d = h . att_dst
//     e_d = LeakyReLU(a_s[nbr_d] + a_d) where planes[d] says neighbour d is
//           valid, else -1e30; softmax over {self, 6 row shifts}, den >= 1e-16
//     v   = mask * sum_d alpha_d h[nbr_d] + bias          (nbr_d = r - off_d)
//     z   = GraphNorm(v): per (slot, gid key) one-pass moments with mean_scale
//     y   = ReLU(z), then dropout: keep = philox_byte(i) >= levels, y * 256/(256-levels)
// and the backward: dropout and ReLU' (0 at z = 0), the closed-form GraphNorm
// backward with the gn_w / gn_b / mean_scale grads, the softmax Jacobian x
// LeakyReLU' with the score grads sent back through reverse shifts, then
// gx = gh @ W^T and gW = x^T @ gh.  x, y, gy and gx are (B, R, cmax), R =
// F*Y*X rows a slot; y and gx are written at cmax, zeros beyond co / ci.
//
// What bounds it.  At the train step's shapes (105 slots of 1584 rows, cmax
// 128 or 64) a layer must move ~4 (ci + cmax + 8) bytes a row forward and
// ~4 (co + cmax + ci + 8) backward, and does 2 ci co (forward) or 4 ci co
// (backward) flops a row: bytes bound every pass on an H100 (3.35 TB/s
// against 67 TFLOP/s f32).  Two costs sit on top of the bytes: the Philox
// dropout (~100 integer operations an element of the forward; the integer
// pipes run at half the f32 rate) and the latency of the dependent loads of
// a row (its planes, scores and 6 neighbours).  The first version of this
// file took ~0.3 ms forward and ~0.9 ms backward for EVERY layer, the
// 1-channel ones included: one thread a channel walked its rows serially (a
// narrow layer ran 1-16 live threads a block), the score dot products were
// serial per row, parameter-grad partials were summed by single threads over
// 2,625 terms, and scratch went to memory at cmax.
//
// Design.
//  * Lanes over (row, channel) by the layer's width: a lane holds V =
//    min(co, 4) channels (a float4 when co >= 4), L = the power of 2 >=
//    ceil(co / V) lanes a row, so a warp step covers 32 / L rows: every lane
//    works for any co from 1 to 128.  Dot products over a row's channels are
//    shuffle (xor) trees across its L lanes.
//  * Two phases in the row passes: a thread a row first does the row's
//    scalar work (softmax, LeakyReLU slopes, reverse-shift scalars) into
//    shared memory; then the lanes do the channel work, every load of a row
//    issued before any is used (out-of-range neighbours read the row itself
//    and are masked), so a row costs one memory round trip.
//  * Residuals at the layer's real width: h, v and the backward's gu are
//    (B, R, co); the forward also saves the softmax weights (B, R, 8), the
//    scores (2, B*R), the statistics (B, K, 3, co) in f64, and one bit an
//    element, keyed & ReLU on & kept, as V words a row, so the backward draws
//    no Philox.  For co <= 32 the apply pass stages its outputs in shared
//    memory and writes whole y rows (co values, then zeros to cmax) as float4.
//  * Row passes run over (chunk of <= 320 rows, slot) blocks of 8 warps.
//    Per-key sums (GraphNorm moments, G1 / G2) go to per-(warp, key,
//    channel) shared-memory cells, the rows of a warp step adding in turn,
//    then a fixed-order sum over the warps: a per-block partial, kept in f64.
//    The next pass reduces its own slot's partials in chunk order in its
//    prologue, so no per-slot launch is needed.
//  * Sums that decide branches or cancel are taken past f32: the GEMM sums 16
//    products in f32 and those partial sums in f64 (the ReLU and LeakyReLU
//    branches hang on h and the scores), the scores, statistics, GraphNorm
//    coefficients and cross-block partials are f64, each rounded once.  No
//    TF32 anywhere.
//  * The gather pass keeps its gh tile (32 rows; more when co <= 8, so every
//    warp has rows) in shared memory and computes gx = gh W^T (W^T staged once
//    a block) and its gW partial x^T gh in registers over all its rows, so gh
//    never goes to memory.
//  * One finalize pass sums the parameter-grad partials: 8 outputs a block,
//    32 thread groups over interleaved partials in f64, then the 32 in order.
//  forward  (3 launches): GEMM + scores; attend (softmax, v, moment
//           partials); apply (statistics in the prologue, norm, ReLU,
//           dropout, the backward's bits).
//  backward (4 launches): G1 / G2 partials; rows (GraphNorm coefficients and
//           parameter grads in the prologue, gu, the 7 score dot products,
//           de); gather (reverse shifts, gh, gx, gW and gatt partials);
//           finalize.
// No floating-point atomics: every sum has a fixed order, so results are
// bit-reproducible, and a slot's contribution does not depend on which slots
// share the launch (only the summation order of the parameter grads across
// slots does).  Out-of-range neighbours of the reverse shifts read as zero: a
// wrapped row carries alpha = 0 in the TPU kernel's circular roll.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <type_traits>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;  // every pass
constexpr int kWarps = kThreads / 32;
constexpr int kChunkRows = 320;     // most rows of one slot in a row-pass block
constexpr int kGemmTile = 64;       // GEMM tile rows
constexpr int kGemmBlockRows = 128; // rows of one GEMM block
constexpr int kTileRows = 32;       // gather-pass tile rows (4 a warp in the gx product)
constexpr int kMaxC = 128;
constexpr int kMaxKeys = 16;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float lrelu(float v, float slope) { return v >= 0.f ? v : slope * v; }
__device__ __forceinline__ float lrelu_grad(float v, float slope) { return v >= 0.f ? 1.f : slope; }

// Row offsets of the 6 directions: neighbour d of row r is r - off[d].
__device__ __forceinline__ void dir_offsets(int Y, int X, int off[6]) {
  off[0] = Y * X;
  off[1] = -Y * X;
  off[2] = X;
  off[3] = -X;
  off[4] = 1;
  off[5] = -1;
}

__device__ __forceinline__ void load8(const float* src, float (&p)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  p[0] = a.x; p[1] = a.y; p[2] = a.z; p[3] = a.w;
  p[4] = b.x; p[5] = b.y; p[6] = b.z; p[7] = b.w;
}

__device__ __forceinline__ void store8(float* dst, const float (&p)[8]) {
  *reinterpret_cast<float4*>(dst) = make_float4(p[0], p[1], p[2], p[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(p[4], p[5], p[6], p[7]);
}

// Activation storage (x, y, gy, gx): float, __nv_bfloat16 or __half (T).  A
// 16-bit value is read as the float it is and a result rounded once to the
// nearest even value of T when written; every sum inside stays f32 or f64.
// Row vector loads and stores (float2 / float4) are the f32 storage's only:
// 16-bit rows go element by element.
template <class T>
constexpr bool kF32 = std::is_same<T, float>::value;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <class T>
__device__ __forceinline__ T from_float(float v) {
  if constexpr (kF32<T>)
    return v;
  else if constexpr (std::is_same<T, __half>::value)
    return __float2half_rn(v);
  else
    return __float2bfloat16_rn(v);
}

// Statistics key of a row from its planes: its gid (0 when K == 1), -1 off the mask.
__device__ __forceinline__ int key_of(const float (&p)[8], int K) {
  if (!(p[6] > 0.f)) return -1;
  if (K == 1) return 0;
  const int g = (int)p[7];
  return ((float)g == p[7] && g >= 0 && g < K) ? g : -1;
}

// A warp's lanes over (row, channel): lane = s * L + c0 holds channels
// c0 * V .. c0 * V + V - 1 of the row of sub-row s; L = the power of 2 >=
// ceil(co / V) lanes a row, rpw = 32 / L rows a warp step.
struct Lanes {
  int L, rpw, s, c0;
};

__host__ __device__ __forceinline__ int lanes_per_row(int co, int V) {
  const int need = (co + V - 1) / V;
  int L = 1;
  while (L < need) L <<= 1;
  return L;
}

template <int V>
__device__ __forceinline__ Lanes lanes_for(int co) {
  const int L = lanes_per_row(co, V);
  const int lane = threadIdx.x & 31;
  return Lanes{L, 32 / L, lane / L, lane % L};
}

// Channels c0*V .. c0*V+V-1 of a row (n of them valid; zeros beyond).  `vec`:
// the row start is aligned to V floats (V = 2 or 4), so a whole piece of an
// f32 row loads as one float2 / float4.
template <int V, class T>
__device__ __forceinline__ void load_ch(const T* row, int c0, int n, bool vec, float (&o)[V]) {
  const int c = c0 * V;
  if constexpr (V == 4 && kF32<T>) {
    if (vec && c + 4 <= n) {
      const float4 t = *reinterpret_cast<const float4*>(row + c);
      o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
      return;
    }
  }
  if constexpr (V == 2 && kF32<T>) {
    if (vec && c + 2 <= n) {
      const float2 t = *reinterpret_cast<const float2*>(row + c);
      o[0] = t.x; o[1] = t.y;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) o[j] = c + j < n ? to_float(row[c + j]) : 0.f;
}

template <int V, class T>
__device__ __forceinline__ void store_ch(T* row, int c0, int n, bool vec, const float (&o)[V]) {
  const int c = c0 * V;
  if constexpr (V == 4 && kF32<T>) {
    if (vec && c + 4 <= n) {
      *reinterpret_cast<float4*>(row + c) = make_float4(o[0], o[1], o[2], o[3]);
      return;
    }
  }
  if constexpr (V == 2 && kF32<T>) {
    if (vec && c + 2 <= n) {
      *reinterpret_cast<float2*>(row + c) = make_float2(o[0], o[1]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (c + j < n) row[c + j] = from_float<T>(o[j]);
}

// A row's vector flag: its start is aligned for load_ch / store_ch.
template <int V>
__device__ __forceinline__ bool vec_rows(int stride) {
  return V == 2 ? stride % 2 == 0 : stride % 4 == 0;
}

// Sum over the L lanes of each row (an xor tree: every lane of the row gets
// the same bits).  Every lane of the warp must call it.
__device__ __forceinline__ float row_sum(float x, int L) {
  for (int o = 1; o < L; o <<= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Sum over the rows of a warp step (lanes with the same c0).
__device__ __forceinline__ float subrow_sum(float x, int L) {
  for (int o = L; o < 32; o <<= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Per-key partial sums of NQ quantities in shared memory, one cell for each
// (quantity q, warp w, key k, component j, lane):
// acc[(((q * kWarps + w) * K + k) * V + j) * 32 + lane], written only by its
// lane, in row order.
template <int V, int NQ>
__device__ __forceinline__ void keyed_add(float* acc, int K, int co, const Lanes& m, int k,
                                          const float (&val)[NQ][V]) {
  if (k < 0) return;
  const int w = threadIdx.x / 32, lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (m.c0 * V + j < co) acc[(((q * kWarps + w) * K + k) * V + j) * 32 + lane] += val[q][j];
}

// The cells of keyed_add summed over the block in a fixed order (the rows of
// a warp step by a shuffle tree, then the warps in order) into
// out[(k * NQ + q) * co + c].  Every thread of the block must call it.
template <int V, int NQ>
__device__ void keyed_reduce(float* acc, int K, int co, const Lanes& m, double* __restrict__ out) {
  const int t = threadIdx.x, w = t / 32, lane = t & 31;
  for (int q = 0; q < NQ; ++q)
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float* cell = acc + (((q * kWarps + w) * K + k) * V + j) * 32 + lane;
        const float x = subrow_sum(*cell, m.L);
        if (m.s == 0) *cell = x;  // lane == c0: channel c0 * V + j
      }
  __syncthreads();
  for (int e = t; e < NQ * K * co; e += kThreads) {
    const int c = e % co, k = (e / co) % K, q = e / (co * K);
    const int j = c % V, c0 = c / V;
    double sum = 0.0;
    for (int ww = 0; ww < kWarps; ++ww) sum += acc[(((q * kWarps + ww) * K + k) * V + j) * 32 + c0];
    out[(k * NQ + q) * co + c] = sum;
  }
}

// Doubles before bwd_rows_kernel's row staging: its 7 K x co planes, rounded up
// to an even count so the float4 rows after them start 16-byte aligned (7 K co
// is odd when K and co are, e.g. a 1-channel layer at K = 1).
__host__ __device__ __forceinline__ int rows_planes_doubles(int K, int co) {
  return (7 * K * co + 1) & ~1;
}

// Floats of keyed_add cells for NQ quantities.
__host__ __device__ __forceinline__ int keyed_cells(int NQ, int K, int V) {
  return NQ * kWarps * K * V * 32;
}

// Per-channel sums of NQ quantities held in each lane's registers, summed over
// the block in a fixed order into out[q * co + c].  red: kWarps * NQ * kMaxC
// floats of shared memory.  Every thread of the block must call it.
template <int V, int NQ>
__device__ void lane_reduce(const float (&a)[NQ][V], float* red, int co, const Lanes& m,
                            float* __restrict__ out) {
  const int t = threadIdx.x, w = t / 32;
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float x = subrow_sum(a[q][j], m.L);
      const int c = m.c0 * V + j;
      if (m.s == 0 && c < co) red[(w * NQ + q) * kMaxC + c] = x;
    }
  __syncthreads();
  for (int e = t; e < NQ * co; e += kThreads) {
    const int q = e / co, c = e % co;
    double sum = 0.0;
    for (int ww = 0; ww < kWarps; ++ww) sum += red[(ww * NQ + q) * kMaxC + c];
    out[e] = (float)sum;
  }
}

// Rows [rbeg, rend) of the slot that row-pass block p of P covers.
__device__ __forceinline__ void chunk_rows(int R, int p, int P, int* rbeg, int* rend) {
  const int chunk = (R + P - 1) / P;
  *rbeg = min(R, p * chunk);
  *rend = min(R, *rbeg + chunk);
}

// Forward 1: h = x[:, :ci] @ W[:ci, :co] (x row stride cmax, h row stride co)
// and the scores a_s = h . att[0], a_d = h . att[1].  The ReLU and LeakyReLU
// branches of the layer hang on h and the scores, so they are summed more
// closely than one f32 chain: f32 over 16 k at a time, those partial sums in
// double, the scores in double, each rounded once.  A block stages W once
// and walks kGemmBlockRows rows in 64-row tiles; a thread holds 4 rows x NJ
// consecutive columns (tc * NJ ..) of each 16 NJ-column block of co, read
// from W as one float4 (NJ = 4) or float2; the x tile is read as float4.
// Dynamic shared memory: W (ci8 x cw) and the x tile (64 x ci8, f32 whatever
// x's storage T); ci8 = ci rounded up to 8, cw = co rounded up to 16 NJ, zero
// padded.
template <int NJ, class T>
__global__ void __launch_bounds__(kThreads)
fwd_gemm_kernel(const T* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ att, float* __restrict__ h, float* __restrict__ a_s,
                float* __restrict__ a_d, int rows, int ci, int co, int cmax) {
  extern __shared__ __align__(16) float smem[];
  constexpr int WC = 16 * NJ;
  const int ci8 = (ci + 7) & ~7, cw = (co + WC - 1) / WC * WC;
  float* ws = smem;             // [ci8][cw]
  float* xs = smem + ci8 * cw;  // [64][ci8]
  const int t = threadIdx.x, tr = t / 16, tc = t % 16;
  for (int i = t; i < ci8 * cw; i += kThreads) {
    const int k = i / cw, c = i % cw;
    ws[i] = k < ci && c < co ? w[(size_t)k * cmax + c] : 0.f;
  }
  const bool x4 = kF32<T> && ci % 4 == 0 && cmax % 4 == 0;  // x rows load as float4
  const int q8 = ci8 / 4;
  const bool h_vec = NJ > 1 && co % NJ == 0;
  const int rb = blockIdx.x * kGemmBlockRows;
  const int re = min(rows, rb + kGemmBlockRows);
  for (int r0 = rb; r0 < re; r0 += kGemmTile) {
    __syncthreads();  // W staged; the last tile's reads of xs done
    for (int i = t; i < kGemmTile * q8; i += kThreads) {
      const int rr = i / q8, k = 4 * (i % q8), r = r0 + rr;
      float4 v4 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < re) {
        const T* xr = x + (size_t)r * cmax + k;
        if (x4) {
          if (k < ci) v4 = *reinterpret_cast<const float4*>(xr);
        } else {
          v4 = make_float4(k < ci ? to_float(xr[0]) : 0.f, k + 1 < ci ? to_float(xr[1]) : 0.f,
                           k + 2 < ci ? to_float(xr[2]) : 0.f, k + 3 < ci ? to_float(xr[3]) : 0.f);
        }
      }
      *reinterpret_cast<float4*>(xs + rr * ci8 + k) = v4;
    }
    __syncthreads();
    double ps[4] = {0.0, 0.0, 0.0, 0.0}, pd[4] = {0.0, 0.0, 0.0, 0.0};
    for (int cb = 0; cb < co; cb += WC) {
      const int c0 = cb + tc * NJ;
      double acc[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0;
      for (int k16 = 0; k16 < ci8; k16 += 16) {
        float part[4][NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) part[i][j] = 0.f;
        for (int k0 = k16; k0 < min(ci8, k16 + 16); k0 += 8) {
          float a[4][8];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 u0 = *reinterpret_cast<const float4*>(xs + (tr * 4 + i) * ci8 + k0);
            const float4 u1 = *reinterpret_cast<const float4*>(xs + (tr * 4 + i) * ci8 + k0 + 4);
            a[i][0] = u0.x; a[i][1] = u0.y; a[i][2] = u0.z; a[i][3] = u0.w;
            a[i][4] = u1.x; a[i][5] = u1.y; a[i][6] = u1.z; a[i][7] = u1.w;
          }
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            float b[NJ];
            const float* wk = ws + (k0 + kk) * cw + c0;
            if constexpr (NJ == 4) {
              const float4 t4 = *reinterpret_cast<const float4*>(wk);
              b[0] = t4.x; b[1] = t4.y; b[2] = t4.z; b[3] = t4.w;
            } else if constexpr (NJ == 2) {
              const float2 t2 = *reinterpret_cast<const float2*>(wk);
              b[0] = t2.x; b[1] = t2.y;
            } else {
              b[0] = wk[0];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < NJ; ++j) part[i][j] = fmaf(a[i][kk], b[j], part[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] += (double)part[i][j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + tr * 4 + i;
        float hv[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          hv[j] = (float)acc[i][j];
          if (c0 + j < co) {
            ps[i] = fma(acc[i][j], (double)att[c0 + j], ps[i]);
            pd[i] = fma(acc[i][j], (double)att[cmax + c0 + j], pd[i]);
          }
        }
        if (r >= re || c0 >= co) continue;
        float* hr = h + (size_t)r * co + c0;
        if constexpr (NJ == 4) {
          if (h_vec) {
            *reinterpret_cast<float4*>(hr) = make_float4(hv[0], hv[1], hv[2], hv[3]);
            continue;
          }
        }
        if constexpr (NJ == 2) {
          if (h_vec) {
            *reinterpret_cast<float2*>(hr) = make_float2(hv[0], hv[1]);
            continue;
          }
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          if (c0 + j < co) hr[j] = hv[j];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) {  // the 16 column lanes of this row: a half-warp
        ps[i] += __shfl_xor_sync(kFull, ps[i], o);
        pd[i] += __shfl_xor_sync(kFull, pd[i], o);
      }
    }
    if (tc == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + tr * 4 + i;
        if (r < re) {
          a_s[r] = (float)ps[i];
          a_d[r] = (float)pd[i];
        }
      }
    }
  }
}

// Forward 2, in two phases.  Rows: a thread a row computes its masked
// softmax (alphas saved, and kept in shared memory with the row's key and
// mask).  Channels: lanes over (row, channel) aggregate v = mask * sum alpha
// h[nbr] + bias (saved at co) and add the block's per-key moment partials
// S1 = sum v, S2 = sum v^2 and row counts (ballots in the row phase).  Grid
// (P, B).  Dynamic shared memory: keyed_add cells for 2 quantities, kWarps x
// K counts, then 8 floats (7 alphas, the mask) and a key for each row.
template <int V>
__global__ void __launch_bounds__(kThreads, 4)
fwd_attend_kernel(const float* __restrict__ h, const float* __restrict__ a_s,
                  const float* __restrict__ a_d, const float* __restrict__ planes,
                  const float* __restrict__ vec, float* __restrict__ v, float* __restrict__ alphas,
                  double* __restrict__ part, float* __restrict__ cnt, int R, int Y, int X, int co,
                  int K, float slope) {
  extern __shared__ __align__(16) float smem[];
  const int ncells = keyed_cells(2, K, V);
  float* acc = smem;                                // keyed_add cells, 2 quantities
  int* ncnt = reinterpret_cast<int*>(acc + ncells);  // [kWarps][K] row counts
  float* sal = acc + ncells + ((kWarps * K + 3) & ~3);  // [rows][8]: alphas 0..6, mask
  const int t = threadIdx.x, w = t / 32;
  const int p = blockIdx.x, P = gridDim.x, b = blockIdx.y;
  int rbeg, rend;
  chunk_rows(R, p, P, &rbeg, &rend);
  const int nrows = rend - rbeg;
  int* skey = reinterpret_cast<int*>(sal + 8 * nrows);  // [rows]
  const Lanes m = lanes_for<V>(co);
  const size_t slot = (size_t)b * R;
  for (int i = t; i < ncells; i += kThreads) acc[i] = 0.f;
  for (int i = t; i < kWarps * K; i += kThreads) ncnt[i] = 0;
  __syncthreads();
  int off[6];
  dir_offsets(Y, X, off);

  for (int base = 0; base < nrows; base += kThreads) {  // rows: the softmax and the counts
    const int rr = base + t;
    const bool live = rr < nrows;
    const int r = rbeg + (live ? rr : 0);
    const size_t row = slot + r;
    float pl[8], asn[6];
    load8(planes + row * 8, pl);
    const float ad = a_d[row], asr = a_s[row];
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      const int n = r - off[d];
      asn[d] = a_s[slot + (n >= 0 && n < R ? n : r)];
    }
    const float e_self = lrelu(asr + ad, slope);
    float e[6];
    bool ok[6];
    float mx = e_self;
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      const int n = r - off[d];
      ok[d] = pl[d] > 0.f && n >= 0 && n < R;
      e[d] = ok[d] ? lrelu(asn[d] + ad, slope) : kNegInf;
      mx = fmaxf(mx, e[d]);
    }
    const float ex_self = expf(e_self - mx);
    float ex[6], den = ex_self;
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      ex[d] = ok[d] ? expf(e[d] - mx) : 0.f;
      den += ex[d];
    }
    den = fmaxf(den, 1e-16f);
    float al[8];
#pragma unroll
    for (int d = 0; d < 6; ++d) al[d] = ex[d] / den;
    al[6] = ex_self / den;
    al[7] = 0.f;
    const int key = live ? key_of(pl, K) : -1;
    for (int k = 0; k < K; ++k) {  // rows of key k in this warp's 32: a ballot
      const unsigned bal = __ballot_sync(kFull, key == k);
      if ((t & 31) == 0) ncnt[w * K + k] += __popc(bal);
    }
    if (!live) continue;
    store8(alphas + row * 8, al);
    al[7] = pl[6] > 0.f ? 1.f : 0.f;
    store8(sal + rr * 8, al);
    skey[rr] = key;
  }
  __syncthreads();

  float bias[V];
#pragma unroll
  for (int j = 0; j < V; ++j) bias[j] = m.c0 * V + j < co ? vec[m.c0 * V + j] : 0.f;
  const bool vec_ok = vec_rows<V>(co);
  const int groups = (nrows + m.rpw - 1) / m.rpw;
  const int steps = (groups + kWarps - 1) / kWarps;
  for (int it = 0; it < steps; ++it) {  // uniform across the block: keyed sums below
    const int g = it * kWarps + w;
    const int rr0 = g * m.rpw + m.s;
    const bool live = g < groups && rr0 < nrows;
    const int rr = live ? rr0 : 0;  // a dead lane reads a real row and writes nothing
    const int r = rbeg + rr;
    const size_t row = slot + r;
    float al[8], hv[7][V];
    load8(sal + rr * 8, al);
    load_ch<V>(h + row * co, m.c0, co, vec_ok, hv[6]);
#pragma unroll
    for (int d = 0; d < 6; ++d) {  // an out-of-range neighbour has alpha 0: read the row itself
      const int n = r - off[d];
      load_ch<V>(h + (slot + (n >= 0 && n < R ? n : r)) * co, m.c0, co, vec_ok, hv[d]);
    }
    const int k = live ? skey[rr] : -1;
    float u[V];
#pragma unroll
    for (int j = 0; j < V; ++j) u[j] = al[6] * hv[6][j];
#pragma unroll
    for (int d = 0; d < 6; ++d)
#pragma unroll
      for (int j = 0; j < V; ++j) u[j] += al[d] != 0.f ? al[d] * hv[d][j] : 0.f;
    float val[2][V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      val[0][j] = u[j] * al[7] + bias[j];
      val[1][j] = val[0][j] * val[0][j];
    }
    if (live) store_ch<V>(v + row * co, m.c0, co, vec_ok, val[0]);
    keyed_add<V, 2>(acc, K, co, m, k, val);
  }
  // moments: part[((b * P + p) * K + k) * 2 + q][c]
  keyed_reduce<V, 2>(acc, K, co, m, part + (size_t)(b * P + p) * K * 2 * co);
  if (t < K) {
    int n = 0;
    for (int ww = 0; ww < kWarps; ++ww) n += ncnt[ww * K + t];
    cnt[(size_t)(b * P + p) * K + t] = (float)n;
  }
}

// Forward 3: the slot's statistics from its P moment partials (chunk order;
// block 0 saves them), then z = GraphNorm(v), y = ReLU(z), dropout, y at cmax
// with zeros beyond co, and the backward's bits: keyed & z > 0 & kept, word j
// bit c0 for channel c0 * V + j.  For co <= 32 the outputs are staged and y
// written a whole row at a time.  Grid (P, B).  Dynamic shared memory: s and
// rstd, K x co doubles each; for co <= 32 then the chunk's outputs, rows x co.
// y in the storage T, each value rounded once; the ReLU bit is the f32 value's.
template <int V, class T>
__global__ void __launch_bounds__(kThreads, 4)
fwd_apply_kernel(const float* __restrict__ v, const double* __restrict__ part,
             const float* __restrict__ cnt, const float* __restrict__ planes,
             const float* __restrict__ vec, const long long* __restrict__ key, int levels,
             T* __restrict__ y, unsigned* __restrict__ bits, double* __restrict__ stats,
             float* __restrict__ nk, int R, int co, int cmax, int K, float eps) {
  extern __shared__ __align__(16) double dsmem[];
  double* sh_s = dsmem;           // [K][co]
  double* sh_r = dsmem + K * co;  // [K][co]
  // co <= 32: the chunk's outputs [rows][co], then written as whole y rows
  float* ystage = reinterpret_cast<float*>(dsmem + 2 * K * co);
  const int t = threadIdx.x, w = t / 32, lane = t & 31;
  const int p = blockIdx.x, P = gridDim.x, b = blockIdx.y;
  int rbeg, rend;
  chunk_rows(R, p, P, &rbeg, &rend);
  const size_t slot = (size_t)b * R;
  for (int e = t; e < K * co; e += kThreads) {
    const int k = e / co, c = e % co;
    double S1 = 0.0, S2 = 0.0;
    float n = 0.f;  // a count: exact in f32
    for (int q = 0; q < P; ++q) {
      const size_t base = (size_t)(b * P + q) * K + k;
      S1 += part[(base * 2) * co + c];
      S2 += part[(base * 2 + 1) * co + c];
      n += cnt[base];
    }
    const double nc = fmax((double)n, 1.0);
    const double mean = S1 / nc, ex2 = S2 / nc;
    const double s = mean * vec[3 * cmax + c];
    const double var = fmax(ex2 - 2.0 * s * mean + s * s, 0.0);
    const double rstd = 1.0 / sqrt(var + eps);
    sh_s[e] = s;
    sh_r[e] = rstd;
    if (p == 0) {
      double* st = stats + ((size_t)(b * K + k) * 3) * co + c;
      st[0] = mean;
      st[co] = s;
      st[2 * co] = rstd;
      if (c == 0) nk[b * K + k] = n;
    }
  }
  __syncthreads();

  const Lanes m = lanes_for<V>(co);
  float gw[V], gb[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = m.c0 * V + j;
    gw[j] = c < co ? vec[cmax + c] : 0.f;
    gb[j] = c < co ? vec[2 * cmax + c] : 0.f;
  }
  const uint32_t k0 = levels > 0 ? (uint32_t)key[0] : 0u;
  const uint32_t k1 = levels > 0 ? (uint32_t)key[1] : 0u;
  const float scale = 256.f / (256.f - (float)levels);
  const bool vec_v = vec_rows<V>(co), vec_y = vec_rows<V>(cmax);
  const int groups = (rend - rbeg + m.rpw - 1) / m.rpw;
  for (int g = w; g < groups; g += kWarps) {  // uniform across the warp: ballots below
    const int r = rbeg + g * m.rpw + m.s;
    const bool live = r < rend;
    const size_t row = slot + r;
    float out[V];
    bool on[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      out[j] = 0.f;
      on[j] = false;
    }
    if (live) {
      float pl[8];
      load8(planes + row * 8, pl);
      const int k = key_of(pl, K);
      float vv[V];
      load_ch<V>(v + row * co, m.c0, co, vec_v, vv);
      if (pl[6] > 0.f) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int c = m.c0 * V + j;
          if (c >= co) continue;
          // the normalised value in double, rounded once: the ReLU branch hangs on it
          const int e = k * co + c;
          const float zn = k >= 0 ? (float)(((double)vv[j] - sh_s[e]) * sh_r[e]) : 0.f;
          const float tt = fmaf(zn, gw[j], gb[j]);
          float o = fmaxf(tt, 0.f);
          bool kept = true;
          if (levels > 0) {
            kept = philox_byte(row * cmax + c, k0, k1) >= levels;
            o = kept ? o * scale : 0.f;
          }
          out[j] = o;
          on[j] = k >= 0 && tt > 0.f && kept;
        }
      }
      if (co > 32) {
        store_ch<V>(y + row * cmax, m.c0, co, vec_y, out);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (m.c0 * V + j < co) ystage[(r - rbeg) * co + m.c0 * V + j] = out[j];
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {  // word j of the row: bit c0 for channel c0 * V + j
      const unsigned bal = __ballot_sync(kFull, on[j]);
      const unsigned word = m.L == 32 ? bal : (bal >> (m.s * m.L)) & ((1u << m.L) - 1u);
      if (live && m.c0 == 0) bits[row * V + j] = word;
    }
  }
  // y rows by a warp a row, as float4 where cmax allows (f32 storage): for
  // co > 32 the padding co .. cmax (zeros), for co <= 32 the whole row, from
  // the stage and zeros, so that no 32-byte sector of y is written in pieces
  const int cz = co > 32 ? co : 0;
  if (co <= 32) __syncthreads();
  for (int rr = w; rr < rend - rbeg; rr += kWarps) {
    T* yr = y + (slot + rbeg + rr) * cmax;
    const float* ys = ystage + rr * co;
    if constexpr (!kF32<T>) {
      for (int c = cz + lane; c < cmax; c += 32) yr[c] = from_float<T>(c < co ? ys[c] : 0.f);
    } else if (cmax % 4 == 0) {
      const int c4 = min(cmax, (cz + 3) & ~3);
      if (lane < c4 - cz) yr[cz + lane] = 0.f;
      for (int q = c4 / 4 + lane; q < cmax / 4; q += 32) {
        const int c = 4 * q;
        float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c < co) {
          o.x = ys[c];
          o.y = c + 1 < co ? ys[c + 1] : 0.f;
          o.z = c + 2 < co ? ys[c + 2] : 0.f;
          o.w = c + 3 < co ? ys[c + 3] : 0.f;
        }
        reinterpret_cast<float4*>(yr)[q] = o;
      }
    } else {
      for (int c = cz + lane; c < cmax; c += 32) yr[c] = c < co ? ys[c] : 0.f;
    }
  }
}

// The gradient of z at the lane's channels: the saved bit (keyed, ReLU on,
// kept) times gy, scaled by the dropout's inverse keep rate.
template <int V, class T>
__device__ __forceinline__ void grad_z(const unsigned* __restrict__ bits,
                                       const T* __restrict__ gy,
                                       size_t row, const Lanes& m, int co, int cmax, float scale,
                                       float (&gz)[V]) {
  load_ch<V>(gy + row * cmax, m.c0, co, vec_rows<V>(cmax), gz);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const unsigned word = bits[row * V + j];
    gz[j] = (word >> m.c0) & 1u ? gz[j] * scale : 0.f;
  }
}

// Backward 1: per-key partials G1 = sum gz, G2 = sum gz (v - s) of the block.
// Grid (P, B).  Dynamic shared memory: keyed_add cells for 2 quantities, then
// s (K x co doubles).
template <int V, class T>
__global__ void __launch_bounds__(kThreads, 4)
bwd_norm_kernel(const float* __restrict__ v, const double* __restrict__ stats,
                     const unsigned* __restrict__ bits, const T* __restrict__ gy,
                     const float* __restrict__ planes, int levels, double* __restrict__ part,
                     int R, int co, int cmax, int K) {
  extern __shared__ __align__(16) float smem[];
  float* acc = smem;  // keyed_add cells, 2 quantities
  double* sh_s = reinterpret_cast<double*>(smem + keyed_cells(2, K, V));  // [K][co]
  const int t = threadIdx.x, w = t / 32;
  const int p = blockIdx.x, P = gridDim.x, b = blockIdx.y;
  int rbeg, rend;
  chunk_rows(R, p, P, &rbeg, &rend);
  const size_t slot = (size_t)b * R;
  for (int e = t; e < K * co; e += kThreads)
    sh_s[e] = stats[((size_t)(b * K + e / co) * 3 + 1) * co + e % co];
  for (int i = t; i < keyed_cells(2, K, V); i += kThreads) acc[i] = 0.f;
  __syncthreads();
  const Lanes m = lanes_for<V>(co);
  const float scale = levels > 0 ? 256.f / (256.f - (float)levels) : 1.f;
  const bool vec_v = vec_rows<V>(co);
  const int groups = (rend - rbeg + m.rpw - 1) / m.rpw;
  const int steps = (groups + kWarps - 1) / kWarps;
  for (int it = 0; it < steps; ++it) {  // uniform across the block: keyed sums below
    const int g = it * kWarps + w;
    const int r0 = rbeg + g * m.rpw + m.s;
    const bool live = g < groups && r0 < rend;
    const size_t row = slot + (live ? r0 : rbeg);
    float pl[8], gz[V], vv[V];
    load8(planes + row * 8, pl);
    grad_z<V>(bits, gy, row, m, co, cmax, scale, gz);
    load_ch<V>(v + row * co, m.c0, co, vec_v, vv);
    const int k = live ? key_of(pl, K) : -1;
    float val[2][V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = m.c0 * V + j;
      val[0][j] = gz[j];
      val[1][j] = k >= 0 && c < co ? (float)(gz[j] * ((double)vv[j] - sh_s[k * co + c])) : 0.f;
    }
    keyed_add<V, 2>(acc, K, co, m, k, val);
  }
  keyed_reduce<V, 2>(acc, K, co, m, part + (size_t)(b * P + p) * K * 2 * co);
}

// Backward 2: prologue, the slot's G1 and G2 summed over its P partials in
// chunk order into the coefficients of gv = gz*A - Bc - Cc*(v + D) per (key,
// channel), and (block 0) the slot's GraphNorm parameter grads.  Rows: gu
// (= gv on keyed rows, else 0; saved at co) and its bias-grad partial; the 7
// score dot products gu . h[r], gu . h[nbr_d] as shuffle trees; then
// de[r] = (de_0..de_5, de_self, da_d).  A thread a row first puts each row's
// alphas, LeakyReLU slopes and key in shared memory.  Grid (P, B).  Dynamic
// shared memory: 4 coefficient and 3 parameter-grad planes, K x co doubles
// each; then 16 floats (7 alphas, the mask, 7 slopes, 0) and a key for each row.
template <int V, class T>
__global__ void __launch_bounds__(kThreads)
bwd_rows_kernel(const double* __restrict__ part, const double* __restrict__ stats,
            const float* __restrict__ nk, const float* __restrict__ vec,
            const unsigned* __restrict__ bits, const T* __restrict__ gy,
            const float* __restrict__ v, const float* __restrict__ h,
            const float* __restrict__ a_s, const float* __restrict__ a_d,
            const float* __restrict__ alphas, const float* __restrict__ planes, int levels,
            float* __restrict__ gu, float* __restrict__ de, float* __restrict__ pbias,
            double* __restrict__ pgn, int R, int Y, int X, int co, int cmax, int K, float slope) {
  extern __shared__ __align__(16) double dsm[];
  double* coef = dsm;               // [4][K][co]
  double* pg = dsm + 4 * K * co;    // [3][K][co]
  __shared__ float red[kWarps * kMaxC];
  const int t = threadIdx.x, w = t / 32;
  const int p = blockIdx.x, P = gridDim.x, b = blockIdx.y;
  int rbeg, rend;
  chunk_rows(R, p, P, &rbeg, &rend);
  const size_t slot = (size_t)b * R;
  const int KC = K * co;
  for (int e = t; e < KC; e += kThreads) {
    const int k = e / co, c = e % co;
    double G1 = 0.0, G2 = 0.0;
    for (int q = 0; q < P; ++q) {
      const size_t base = (size_t)(b * P + q) * K + k;
      G1 += part[(base * 2) * co + c];
      G2 += part[(base * 2 + 1) * co + c];
    }
    const double* st = stats + ((size_t)(b * K + k) * 3) * co + c;
    const double mu = st[0], s = st[co], rstd = st[2 * co];
    const double gn_w = vec[cmax + c], ms = vec[3 * cmax + c];
    const double n = fmax((double)nk[b * K + k], 1.0);
    const double inv = rstd * gn_w;
    coef[e] = inv;
    coef[KC + e] = (ms / n) * inv * G1;
    coef[2 * KC + e] = (inv * rstd * rstd / n) * G2;
    coef[3 * KC + e] = -2.0 * s + s * ms;
    pg[e] = G2 * rstd;
    pg[KC + e] = G1;
    pg[2 * KC + e] = -mu * inv * G1 - inv * rstd * rstd * mu * (s - mu) * G2;
  }
  __syncthreads();
  if (p == 0) {
    for (int e = t; e < 3 * co; e += kThreads) {
      const int which = e / co, c = e % co;
      double sum = 0.0;
      for (int k = 0; k < K; ++k) sum += pg[which * KC + k * co + c];
      pgn[((size_t)b * 3 + which) * co + c] = sum;
    }
  }

  const int nrows = rend - rbeg;
  float* srow = reinterpret_cast<float*>(dsm + rows_planes_doubles(K, co));  // [rows][16]
  int* skey = reinterpret_cast<int*>(srow + 16 * nrows);  // [rows]
  int off[6];
  dir_offsets(Y, X, off);
  for (int rr = t; rr < nrows; rr += kThreads) {  // rows: alphas, slopes, key
    const int r = rbeg + rr;
    const size_t row = slot + r;
    float pl[8], al[8], gl[8];
    load8(planes + row * 8, pl);
    load8(alphas + row * 8, al);
    const float ad = a_d[row];
    gl[6] = lrelu_grad(a_s[row] + ad, slope);
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      const int n = r - off[d];
      const bool ok = pl[d] > 0.f && n >= 0 && n < R;
      gl[d] = ok ? lrelu_grad(a_s[slot + n] + ad, slope) : 0.f;
      if (!ok) al[d] = 0.f;
    }
    gl[7] = 0.f;
    al[7] = pl[6] > 0.f ? 1.f : 0.f;
    store8(srow + rr * 16, al);
    store8(srow + rr * 16 + 8, gl);
    skey[rr] = key_of(pl, K);
  }
  __syncthreads();

  const Lanes m = lanes_for<V>(co);
  const float scale = levels > 0 ? 256.f / (256.f - (float)levels) : 1.f;
  const bool vec_c = vec_rows<V>(co);
  float gbias[1][V];
#pragma unroll
  for (int j = 0; j < V; ++j) gbias[0][j] = 0.f;
  const int groups = (nrows + m.rpw - 1) / m.rpw;
  const int steps = (groups + kWarps - 1) / kWarps;
  for (int it = 0; it < steps; ++it) {  // uniform across the block: shuffles below
    const int g = it * kWarps + w;
    const int rr0 = g * m.rpw + m.s;
    const bool live = g < groups && rr0 < nrows;
    const int rr = live ? rr0 : 0;  // a dead lane reads a real row and writes nothing
    const int r = rbeg + rr;
    const size_t row = slot + r;
    float al[8], gz[V], vv[V], hv[7][V];
    load8(srow + rr * 16, al);
    grad_z<V>(bits, gy, row, m, co, cmax, scale, gz);
    load_ch<V>(v + row * co, m.c0, co, vec_c, vv);
    load_ch<V>(h + row * co, m.c0, co, vec_c, hv[6]);
#pragma unroll
    for (int d = 0; d < 6; ++d) {  // an invalid neighbour has alpha 0: read the row itself
      const int n = r - off[d];
      load_ch<V>(h + (slot + (n >= 0 && n < R ? n : r)) * co, m.c0, co, vec_c, hv[d]);
    }
    const int k = live ? skey[rr] : -1;
    float g_u[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = m.c0 * V + j;
      g_u[j] = 0.f;
      if (k >= 0 && c < co) {
        const int e = k * co + c;
        // in double: coef[KC + e] and coef[2 KC + e] are the same for all the key's
        // rows, so their f32 rounding would not average out over the rows
        g_u[j] = (float)(gz[j] * coef[e] - coef[KC + e] -
                         coef[2 * KC + e] * (vv[j] + coef[3 * KC + e]));
        gbias[0][j] += g_u[j];
      }
    }
    if (live) store_ch<V>(gu + row * co, m.c0, co, vec_c, g_u);
    // dot products of gu with h at the row and its neighbours (0 where alpha is)
    float dot[7];
#pragma unroll
    for (int d = 0; d < 7; ++d) {
      float x = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) x += g_u[j] * hv[d][j];
      dot[d] = row_sum(d == 6 || al[d] != 0.f ? x : 0.f, m.L);
    }
    if (live && m.c0 == 0) {
      float gl[8];
      load8(srow + rr * 16 + 8, gl);
      float S = al[6] * dot[6];
#pragma unroll
      for (int d = 0; d < 6; ++d) S += al[d] * dot[d];
      float out[8];
      out[6] = al[6] * (dot[6] - S) * gl[6];
      float da_d = out[6];
#pragma unroll
      for (int d = 0; d < 6; ++d) {
        out[d] = al[d] * (dot[d] - S) * gl[d];
        da_d += out[d];
      }
      out[7] = da_d;
      store8(de + row * 8, out);
    }
  }
  lane_reduce<V, 1>(gbias, red, co, m, pbias + (size_t)(b * P + p) * co);
}

// Rows of a gather-pass tile: 32, or 8 warp steps when a warp step covers
// more than 4 rows (co <= 8), so every warp has rows to gather.
__host__ __device__ __forceinline__ int gather_tile_rows(int co) {
  int L = 1;
  while (L < co && L < 32) L <<= 1;
  const int rows = kWarps * (32 / L);
  return rows > kTileRows ? rows : kTileRows;
}

__host__ __device__ __forceinline__ int round8(int c) { return (c + 7) & ~7; }

// N (2, 4 or 8) consecutive floats from shared memory aligned to 8 (N = 2) or 16 bytes.
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&o)[N]) {
  if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    o[0] = t.x; o[1] = t.y;
  } else {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 t = *reinterpret_cast<const float4*>(p + 4 * q);
      o[4 * q] = t.x; o[4 * q + 1] = t.y; o[4 * q + 2] = t.z; o[4 * q + 3] = t.w;
    }
  }
}

// Backward 3: gh = alpha_self gu + mask * sum_d alpha_d[r+off] gu[r+off]
//                  + da_s att_src + da_d att_dst,
// with da_s[r] = de_self[r] + sum_d de_d[r + off_d], over tiles of TR rows
// (gather_tile_rows) kept in shared memory, with the block's gatt partials
// sum da_s h, sum da_d h.  Per tile then gx = gh W^T: a warp holds 8 rows x
// up to 2 x 32 columns (the 8 warps as 4 row groups x 2 column halves), gh
// read four k at a time as float4; and the gW partial x^T gh in registers over
// all the block's rows: a thread holds MI x MJ outputs (rows ti*MI.., columns
// tj*MJ..; MI, MJ = 2, 4, 8 as ci, co reach 32, 64, 128), read as float2 /
// float4.
// A thread a row first puts the tile's per-row scalars (reverse-shift alphas,
// alpha_self, mask, da_s, da_d) in shared memory.  Grid (P, B).  Dynamic
// shared memory, widths rounded up to 8 and zero padded: W^T (co8 x cmax,
// zeros beyond ci), gh tile (TR x co8), x tile (TR x ci8), then 12 floats a row.
template <int V, int MI, int MJ, class T>
__global__ void __launch_bounds__(kThreads)
bwd_gather_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ att, const float* __restrict__ gu,
                  const float* __restrict__ de, const float* __restrict__ alphas,
                  const float* __restrict__ h, const float* __restrict__ planes,
                  T* __restrict__ gx, float* __restrict__ pw, float* __restrict__ patt,
                  int R, int Y, int X, int ci, int co, int cmax) {
  extern __shared__ __align__(16) float smem[];
  const int cs = round8(co), ci8 = round8(ci), TR = gather_tile_rows(co);
  float* wt = smem;              // [cs][cmax]
  float* ghs = wt + cs * cmax;   // [TR][cs]
  float* xs = ghs + TR * cs;     // [TR][ci8]
  float* srow = xs + TR * ci8;   // [TR][12]: alphas of the 6 reverse shifts, alpha_self,
                                 // mask, da_s, da_d
  __shared__ float red[kWarps * 2 * kMaxC];
  const int t = threadIdx.x, w_ = t / 32, lane = t & 31;
  const int p = blockIdx.x, P = gridDim.x, b = blockIdx.y;
  int rbeg, rend;
  chunk_rows(R, p, P, &rbeg, &rend);
  const size_t slot = (size_t)b * R;
  for (int e = t; e < cs * cmax; e += kThreads) {
    const int k = e / cmax, n = e % cmax;
    wt[e] = n < ci && k < co ? w[(size_t)n * cmax + k] : 0.f;
  }
  for (int e = t; e < TR * cs; e += kThreads) ghs[e] = 0.f;  // the padding stays 0
  const Lanes m = lanes_for<V>(co);
  int off[6];
  dir_offsets(Y, X, off);
  const bool vec_c = vec_rows<V>(co);
  float att_s[V], att_d[V], ga[2][V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = m.c0 * V + j;
    att_s[j] = c < co ? att[c] : 0.f;
    att_d[j] = c < co ? att[cmax + c] : 0.f;
    ga[0][j] = ga[1][j] = 0.f;
  }
  const int ti = t / 16, tj = t % 16;
  const bool gw_live = ti * MI < ci8 && tj * MJ < cs;
  float acc[MI][MJ];
#pragma unroll
  for (int u = 0; u < MI; ++u)
#pragma unroll
    for (int c = 0; c < MJ; ++c) acc[u][c] = 0.f;
  const int wr = w_ & 3, half = w_ >> 2;

  for (int r0 = rbeg; r0 < rend; r0 += TR) {
    __syncthreads();  // W^T and the zeros staged; the last tile's products done
    for (int e = t; e < TR * ci8; e += kThreads) {
      const int r = r0 + e / ci8, i = e % ci8;
      xs[e] = r < rend && i < ci ? to_float(x[(slot + r) * cmax + i]) : 0.f;
    }
    for (int rr = t; rr < TR; rr += kThreads) {  // rows: the scalars of the gather
      const int r = r0 + rr;
      float sr[12] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (r < rend) {
        const size_t row = slot + r;
        float dr[8];
        load8(de + row * 8, dr);
        float das = dr[6];
#pragma unroll
        for (int d = 0; d < 6; ++d) {
          const int jn = r + off[d];
          if (jn < 0 || jn >= R) continue;
          const size_t jr = slot + jn;
          das += de[jr * 8 + d];
          sr[d] = alphas[jr * 8 + d];
        }
        sr[6] = alphas[row * 8 + 6];
        sr[7] = planes[row * 8 + 6] > 0.f ? 1.f : 0.f;
        sr[8] = das;
        sr[9] = dr[7];
      }
#pragma unroll
      for (int q = 0; q < 3; ++q)
        *reinterpret_cast<float4*>(srow + rr * 12 + 4 * q) =
            make_float4(sr[4 * q], sr[4 * q + 1], sr[4 * q + 2], sr[4 * q + 3]);
    }
    __syncthreads();
    for (int g = w_; g < TR / m.rpw; g += kWarps) {  // channels: gh
      const int rr = g * m.rpw + m.s, r = r0 + rr;
      if (r >= rend) continue;  // its gh row stays 0
      const size_t row = slot + r;
      float sr[12], g_r[V], hh[V], gn[6][V];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float4 f4 = *reinterpret_cast<const float4*>(srow + rr * 12 + 4 * q);
        sr[4 * q] = f4.x; sr[4 * q + 1] = f4.y; sr[4 * q + 2] = f4.z; sr[4 * q + 3] = f4.w;
      }
      load_ch<V>(gu + row * co, m.c0, co, vec_c, g_r);
      load_ch<V>(h + row * co, m.c0, co, vec_c, hh);
#pragma unroll
      for (int d = 0; d < 6; ++d) {  // alpha 0 off the slot: read the row itself
        const int jn = r + off[d];
        load_ch<V>(gu + (slot + (jn >= 0 && jn < R ? jn : r)) * co, m.c0, co, vec_c, gn[d]);
      }
      float ghm[V];
#pragma unroll
      for (int j = 0; j < V; ++j) ghm[j] = 0.f;
#pragma unroll
      for (int d = 0; d < 6; ++d)
#pragma unroll
        for (int j = 0; j < V; ++j) ghm[j] += sr[d] != 0.f ? sr[d] * gn[d][j] : 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c = m.c0 * V + j;
        if (c >= co) continue;
        ghs[rr * cs + c] = sr[6] * g_r[j] + ghm[j] * sr[7] + sr[8] * att_s[j] + sr[9] * att_d[j];
        ga[0][j] += sr[8] * hh[j];
        ga[1][j] += sr[9] * hh[j];
      }
    }
    __syncthreads();

    // gx: rows r0 + 32 z + 8 wr + i, columns (2 half + q) * 32 + lane
    for (int z = 0; z < TR / 32; ++z) {
      const int rb = 32 * z + 8 * wr;
      float gxa[8][2];
#pragma unroll
      for (int i = 0; i < 8; ++i) gxa[i][0] = gxa[i][1] = 0.f;
      for (int k0 = 0; k0 < cs; k0 += 4) {
        float a[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i) lds<4>(ghs + (rb + i) * cs + k0, a[i]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float bq[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int n = (2 * half + q) * 32 + lane;
            bq[q] = n < cmax ? wt[(k0 + kk) * cmax + n] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int q = 0; q < 2; ++q) gxa[i][q] = fmaf(a[i][kk], bq[q], gxa[i][q]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = r0 + rb + i;
        if (r >= rend) continue;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = (2 * half + q) * 32 + lane;
          if (n < cmax) gx[(slot + r) * cmax + n] = from_float<T>(gxa[i][q]);
        }
      }
    }

    // gW partial: rows beyond rend are zero in both tiles
    if (gw_live) {
#pragma unroll 2
      for (int rr = 0; rr < TR; ++rr) {
        float a[MI], bb[MJ];
        lds<MI>(xs + rr * ci8 + ti * MI, a);
        lds<MJ>(ghs + rr * cs + tj * MJ, bb);
#pragma unroll
        for (int u = 0; u < MI; ++u)
#pragma unroll
          for (int c = 0; c < MJ; ++c) acc[u][c] = fmaf(a[u], bb[c], acc[u][c]);
      }
    }
  }
  float* pwb = pw + (size_t)(b * P + p) * ci * co;
#pragma unroll
  for (int u = 0; u < MI; ++u)
#pragma unroll
    for (int c = 0; c < MJ; ++c) {
      const int i = ti * MI + u, j = tj * MJ + c;
      if (i < ci && j < co) pwb[i * co + j] = acc[u][c];
    }
  __syncthreads();  // every warp is past the tile loop before red is written
  lane_reduce<V, 2>(ga, red, co, m, patt + (size_t)(b * P + p) * 2 * co);
}

// Backward 4: every parameter grad from its partials: gW over the B*P gather
// blocks, gatt and the bias grad over the B*P row blocks, the GraphNorm grads
// over the B slots.  A block sums 8 consecutive real outputs (ci x co of gW,
// then 6 x co), 32 groups of threads over interleaved partials (a 32-byte
// sector of 8 outputs a partial), in double, then the 32 group sums in order.
// The blocks also write the zeros outside ci x co, grid-stride.
constexpr int kFinOut = 8;
constexpr int kFinGroups = kThreads / kFinOut;

__global__ void __launch_bounds__(kThreads)
bwd_finalize_kernel(const float* __restrict__ pw, const float* __restrict__ patt,
                    const float* __restrict__ pbias, const double* __restrict__ pgn,
                    float* __restrict__ gw, float* __restrict__ gatt, float* __restrict__ gvec,
                    int Q, int B, int ci, int co, int cmax) {
  __shared__ double red[kFinGroups][kFinOut];
  const int t = threadIdx.x, g = t / kFinOut, o = t % kFinOut;
  const int nw = ci * co, ne = nw + 6 * co;
  const int e = blockIdx.x * kFinOut + o;
  double s = 0.0;
  if (e < nw) {
#pragma unroll 4
    for (int q = g; q < Q; q += kFinGroups) s += pw[(size_t)q * nw + e];
  } else if (e < ne) {
    // which: 0 att_src, 1 att_dst, 2 conv bias, 3 gn weight, 4 gn bias, 5 mean_scale
    const int f = e - nw, which = f / co, c = f % co;
    if (which < 2) {
#pragma unroll 4
      for (int q = g; q < Q; q += kFinGroups) s += patt[((size_t)q * 2 + which) * co + c];
    } else if (which == 2) {
#pragma unroll 4
      for (int q = g; q < Q; q += kFinGroups) s += pbias[(size_t)q * co + c];
    } else {
      for (int bb = g; bb < B; bb += kFinGroups) s += pgn[((size_t)bb * 3 + which - 3) * co + c];
    }
  }
  red[g][o] = s;
  __syncthreads();
  if (g == 0 && e < ne) {
    double sum = 0.0;
    for (int gg = 0; gg < kFinGroups; ++gg) sum += red[gg][o];
    if (e < nw) {
      gw[(e / co) * cmax + e % co] = (float)sum;
    } else {
      const int f = e - nw, which = f / co, c = f % co;
      if (which < 2)
        gatt[which * cmax + c] = (float)sum;
      else
        gvec[(which - 2) * cmax + c] = (float)sum;
    }
  }
  // zeros: gw outside ci x co, gatt and gvec beyond co
  for (int z = blockIdx.x * kThreads + t; z < cmax * cmax + 6 * cmax; z += gridDim.x * kThreads) {
    if (z < cmax * cmax) {
      if (z / cmax >= ci || z % cmax >= co) gw[z] = 0.f;
    } else {
      const int f = z - cmax * cmax, c = f % cmax;
      if (c >= co) (f < 2 * cmax ? gatt[f] : gvec[f - 2 * cmax]) = 0.f;
    }
  }
}

__global__ void bytes_kernel(unsigned char* __restrict__ out, long long n,
                             const long long* __restrict__ key) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) out[i] = (unsigned char)philox_byte((uint64_t)i, (uint32_t)key[0], (uint32_t)key[1]);
}

bool bad_dims(int levels, int B, int F, int Y, int X, int cmax, int ci, int co, int K) {
  return B < 1 || F < 1 || Y < 1 || X < 1 || cmax < 1 || cmax > kMaxC || ci < 1 || co < 1 ||
         ci > cmax || co > cmax || K < 1 || K > kMaxKeys || levels < 0 || levels > 255;
}

// Channels a lane of the row passes holds (V): co itself below 4, else 4 (a float4).
int lane_width(int co) { return co < 4 ? co : 4; }

// Row-pass blocks a slot: chunks of at most kChunkRows rows.
int chunks_for(int R) { return (R + kChunkRows - 1) / kChunkRows; }

// Dynamic shared memory beyond 48 KB (the static arrays counted in) has to be
// allowed per kernel and device first.  cudaFuncSetAttribute costs host time
// on every call, so each (kernel, device) is raised to the largest size asked
// so far and left there.
struct SmemGrant {
  const void* fn;
  int device;
  size_t bytes;
};
std::mutex g_smem_mutex;
SmemGrant g_smem[64];
int g_smem_n = 0;

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(g_smem_mutex);
  int i = 0;
  while (i < g_smem_n && !(g_smem[i].fn == fn && g_smem[i].device == device)) ++i;
  if (i < g_smem_n && g_smem[i].bytes >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  if (i < g_smem_n)
    g_smem[i].bytes = bytes;
  else if (g_smem_n < 64)
    g_smem[g_smem_n++] = SmemGrant{fn, device, bytes};
  return cudaSuccess;
}

// The step of the last call that failed, for the wrapper's error message.
const char* g_failed = "";

#define GT_TRY(expr)                   \
  do {                                 \
    const cudaError_t e_ = (expr);     \
    if (e_ != cudaSuccess) {           \
      g_failed = #expr;                \
      return (int)e_;                  \
    }                                  \
  } while (0)

// After a launch: a refused launch (too many threads, too much shared memory) is reported here.
#define GT_LAUNCHED(name)                     \
  do {                                        \
    const cudaError_t e_ = cudaGetLastError(); \
    if (e_ != cudaSuccess) {                  \
      g_failed = name;                        \
      return (int)e_;                         \
    }                                         \
  } while (0)

template <int V, class T>
int forward_v(const T* x, const float* planes, const float* w, const float* att,
              const float* vec, const long long* key, int levels, int B, int R, int Y, int X,
              int cmax, int ci, int co, int K, float slope, float eps, T* y, float* h,
              float* v, float* scores, float* alphas, unsigned* bits, double* stats, float* nk,
              double* part, float* cnt, cudaStream_t s) {
  const int rows = B * R;
  const dim3 grid(chunks_for(R), B);
  const unsigned gemm_blocks = (unsigned)((rows + kGemmBlockRows - 1) / kGemmBlockRows);
  const int nj = co <= 16 ? 1 : co <= 32 ? 2 : 4;
  auto gemm = nj == 1   ? fwd_gemm_kernel<1, T>
              : nj == 2 ? fwd_gemm_kernel<2, T>
                        : fwd_gemm_kernel<4, T>;
  const int ci8 = (ci + 7) & ~7, cw = (co + 16 * nj - 1) / (16 * nj) * (16 * nj);
  const size_t gemm_smem = sizeof(float) * (size_t)ci8 * (cw + kGemmTile);
  GT_TRY(allow_smem(gemm, gemm_smem));
  gemm<<<gemm_blocks, kThreads, gemm_smem, s>>>(x, w, att, h, scores, scores + rows, rows, ci, co,
                                                cmax);
  GT_LAUNCHED("fwd_gemm_kernel");
  const int chunk = (R + grid.x - 1) / grid.x;
  const size_t attend_smem =
      sizeof(float) * (size_t)(keyed_cells(2, K, V) + ((kWarps * K + 3) & ~3) + 9 * chunk);
  GT_TRY(allow_smem(fwd_attend_kernel<V>, attend_smem));
  fwd_attend_kernel<V><<<grid, kThreads, attend_smem, s>>>(h, scores, scores + rows, planes, vec, v,
                                                       alphas, part, cnt, R, Y, X, co, K, slope);
  GT_LAUNCHED("fwd_attend_kernel");
  const size_t apply_smem =
      sizeof(double) * 2 * (size_t)K * co + (co <= 32 ? sizeof(float) * (size_t)chunk * co : 0);
  GT_TRY(allow_smem(fwd_apply_kernel<V, T>, apply_smem));
  fwd_apply_kernel<V, T><<<grid, kThreads, apply_smem, s>>>(v, part, cnt, planes, vec, key, levels, y,
                                                     bits, stats, nk, R, co, cmax, K, eps);
  GT_LAUNCHED("fwd_apply_kernel");
  return 0;
}

// The gather pass's instance for a layer: its gW micro-tile MI x MJ covers ci x co.
template <int V, class T>
auto gather_kernel_for(int ci, int co) {
  const int mi = ci <= 32 ? 2 : ci <= 64 ? 4 : 8;
  if constexpr (V < 4) {  // co < 4
    return mi == 2 ? bwd_gather_kernel<V, 2, 2, T>
           : mi == 4 ? bwd_gather_kernel<V, 4, 2, T>
                     : bwd_gather_kernel<V, 8, 2, T>;
  } else {
#define GT_GATHER(MJ)                                                 \
  (mi == 2   ? bwd_gather_kernel<V, 2, MJ, T>                            \
   : mi == 4 ? bwd_gather_kernel<V, 4, MJ, T>                            \
             : bwd_gather_kernel<V, 8, MJ, T>)
    return co <= 32 ? GT_GATHER(2) : co <= 64 ? GT_GATHER(4) : GT_GATHER(8);
#undef GT_GATHER
  }
}

template <int V, class T>
int backward_v(const T* x, const float* planes, const float* w, const float* att,
               const float* vec, int levels, int B, int R, int Y, int X, int cmax, int ci, int co,
               int K, float slope, const float* h, const float* v, const float* scores,
               const float* alphas, const unsigned* bits, const double* stats, const float* nk,
               const T* gy, T* gx, float* gw, float* gatt, float* gvec, float* gu,
               float* de, double* part, float* pbias, double* pgn, float* patt, float* pw,
               cudaStream_t s) {
  const int rows = B * R;
  const int P = chunks_for(R);
  const dim3 grid(P, B);
  const size_t norm_smem =
      sizeof(float) * (size_t)keyed_cells(2, K, V) + sizeof(double) * (size_t)K * co;
  GT_TRY(allow_smem(bwd_norm_kernel<V, T>, norm_smem));
  bwd_norm_kernel<V, T><<<grid, kThreads, norm_smem, s>>>(v, stats, bits, gy, planes, levels,
                                                            part, R, co, cmax, K);
  GT_LAUNCHED("bwd_norm_kernel");
  const int chunk = (R + P - 1) / P;
  const size_t rows_smem =
      sizeof(double) * (size_t)rows_planes_doubles(K, co) + sizeof(float) * 17 * (size_t)chunk;
  GT_TRY(allow_smem(bwd_rows_kernel<V, T>, rows_smem));
  bwd_rows_kernel<V, T><<<grid, kThreads, rows_smem, s>>>(part, stats, nk, vec, bits, gy, v, h, scores,
                                                   scores + rows, alphas, planes, levels, gu, de,
                                                   pbias, pgn, R, Y, X, co, cmax, K, slope);
  GT_LAUNCHED("bwd_rows_kernel");
  const auto gather = gather_kernel_for<V, T>(ci, co);
  const int cs = round8(co), TR = gather_tile_rows(co);
  const size_t gather_smem =
      sizeof(float) * ((size_t)cs * cmax + (size_t)TR * (cs + round8(ci) + 12));
  GT_TRY(allow_smem(gather, gather_smem));
  gather<<<grid, kThreads, gather_smem, s>>>(x, w, att, gu, de, alphas, h, planes, gx, pw, patt,
                                             R, Y, X, ci, co, cmax);
  GT_LAUNCHED("bwd_gather_kernel");
  const unsigned fin_blocks = (unsigned)((ci * co + 6 * co + kFinOut - 1) / kFinOut);
  bwd_finalize_kernel<<<fin_blocks, kThreads, 0, s>>>(pw, patt, pbias, pgn, gw, gatt, gvec, B * P,
                                                      B, ci, co, cmax);
  GT_LAUNCHED("bwd_finalize_kernel");
  return 0;
}

}  // namespace

extern "C" {

// One layer forward (3 launches).  Device pointers: x (B, R, cmax) and y in
// the activation storage `storage` names (0: float, 1: __nv_bfloat16, 2:
// __half), planes
// (B, R, 8), w (cmax, cmax) as (in, out), att (2, cmax), vec (4, cmax) = conv
// bias, gn weight, gn bias, mean_scale; key (2,) int64 Philox words (read only
// when levels > 0).  Outputs: y (B, R, cmax) and, saved for the backward, h
// and v (B, R, co), scores (2, B*R), alphas (B, R, 8), bits (B, R, V) with V =
// gt_lane_width(co), stats (B, K, 3, co) f64, nk (B, K); scratch part (B, P, K,
// 2, co) f64 and cnt (B, P, K) with P = gt_row_chunks(R).  16-byte
// aligned pointers.  Launches on `stream`, does not synchronise; returns the
// first CUDA error (0 on success; gt_failed_step names the step).
int gt_forward(const void* x, const float* planes, const float* w, const float* att,
               const float* vec, const long long* key, int levels, int B, int F, int Y, int X,
               int cmax, int ci, int co, int K, int storage, float slope, float eps, void* y, float* h,
               float* v, float* scores, float* alphas, unsigned* bits, double* stats, float* nk,
               double* part, float* cnt, void* stream) {
  if (bad_dims(levels, B, F, Y, X, cmax, ci, co, K) || (levels > 0 && key == nullptr) ||
      storage < 0 || storage > 2) {
    g_failed = "the argument checks";
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int R = F * Y * X;
#define GT_FORWARD_T(V, T)                                                                   \
  forward_v<V>(static_cast<const T*>(x), planes, w, att, vec, key, levels, B, R, Y, X, cmax, ci, \
               co, K, slope, eps, static_cast<T*>(y), h, v, scores, alphas, bits, stats, nk,    \
               part, cnt, s)
#define GT_FORWARD(V)                                             \
  (storage == 1   ? GT_FORWARD_T(V, __nv_bfloat16)                \
   : storage == 2 ? GT_FORWARD_T(V, __half)                       \
                  : GT_FORWARD_T(V, float))
  switch (lane_width(co)) {
    case 1: return GT_FORWARD(1);
    case 2: return GT_FORWARD(2);
    case 3: return GT_FORWARD(3);
    default: return GT_FORWARD(4);
  }
#undef GT_FORWARD
#undef GT_FORWARD_T
}

// One layer backward (4 launches).  Inputs as gt_forward, what it saved (h, v,
// scores, alphas, bits, stats, nk), and gy (B, R, cmax).  Outputs gx (B, R,
// cmax), gw (cmax, cmax), gatt (2, cmax), gvec (4, cmax); x, gy and gx in the
// storage `storage` names, the rest f32.  Scratch: gu (B, R, co), de (B, R, 8),
// part (B, P, K, 2, co) f64, pbias (B, P, co), pgn (B, 3, co) f64, patt (B, P,
// 2, co), pw (B, P, ci, co).
int gt_backward(const void* x, const float* planes, const float* w, const float* att,
                const float* vec, const long long* key, int levels, int B, int F, int Y, int X,
                int cmax, int ci, int co, int K, int storage, float slope, const float* h,
                const float* v, const float* scores, const float* alphas, const unsigned* bits,
                const double* stats, const float* nk, const void* gy, void* gx, float* gw,
                float* gatt, float* gvec, float* gu, float* de, double* part, float* pbias,
                double* pgn, float* patt, float* pw, void* stream) {
  if (bad_dims(levels, B, F, Y, X, cmax, ci, co, K) || (levels > 0 && key == nullptr) ||
      storage < 0 || storage > 2) {
    g_failed = "the argument checks";
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int R = F * Y * X;
#define GT_BACKWARD_T(V, T)                                                                  \
  backward_v<V>(static_cast<const T*>(x), planes, w, att, vec, levels, B, R, Y, X, cmax, ci, co, \
                K, slope, h, v, scores, alphas, bits, stats, nk, static_cast<const T*>(gy),      \
                static_cast<T*>(gx), gw, gatt, gvec, gu, de, part, pbias, pgn, patt, pw, s)
#define GT_BACKWARD(V)                                              \
  (storage == 1   ? GT_BACKWARD_T(V, __nv_bfloat16)                 \
   : storage == 2 ? GT_BACKWARD_T(V, __half)                        \
                  : GT_BACKWARD_T(V, float))
  switch (lane_width(co)) {
    case 1: return GT_BACKWARD(1);
    case 2: return GT_BACKWARD(2);
    case 3: return GT_BACKWARD(3);
    default: return GT_BACKWARD(4);
  }
#undef GT_BACKWARD
#undef GT_BACKWARD_T
}

// The dropout bytes of flat elements 0..n-1 under key (a check of csrc/philox.cuh).
int gt_dropout_bytes(unsigned char* out, long long n, const long long* key, void* stream) {
  if (n < 0 || key == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks == 0) return 0;
  bytes_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(out, n, key);
  return (int)cudaGetLastError();
}

// The layout decisions the caller allocates by: row-pass blocks a slot of R
// rows (P), and channels a lane of a layer of co channels (V, the bit words a row).
int gt_row_chunks(int R) { return chunks_for(R); }
int gt_lane_width(int co) { return lane_width(co); }

const char* gt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// What the last failed gt_forward / gt_backward call was doing.
const char* gt_failed_step() { return g_failed; }

}  // extern "C"
