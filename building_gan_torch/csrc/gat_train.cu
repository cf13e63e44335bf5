// Training GAT hourglass layer for Hopper (sm_90a), f32 throughout: forward and
// backward kernels.
//
// Replaces building_gan_tpu/ops/pallas/gat_train.py::_fwd_kernel (one layer
// forward, reached through make_fused_layer and hourglass_train) and
// ::_bwd_kernel (its recompute backward, the custom VJP layer_bwd).  A layer:
//     h   = x[:, :ci] @ W[:ci, :co]                      (f32 FMA, no TF32)
//     a_s = h . att_src,  a_d = h . att_dst
//     e_d = LeakyReLU(a_s[nbr_d] + a_d) where planes[d] says neighbour d is
//           valid, else -1e30; softmax over {self, 6 row shifts}, den >= 1e-16
//     v   = mask * sum_d alpha_d h[nbr_d] + bias          (nbr_d = r - off_d)
//     z   = GraphNorm(v): per (slot, gid key) one-pass moments with mean_scale
//     y   = ReLU(z), then dropout: keep = philox_byte(i) >= levels, y * 256/(256-levels)
// and the backward: dropout and ReLU' (0 at z = 0), the closed-form GraphNorm
// backward with the gn_w / gn_b / mean_scale grads, the softmax Jacobian x
// LeakyReLU' with the score grads sent back through reverse shifts, then
// gx = gh @ W^T and gW = x^T @ gh.
//
// Layout: x, y, h, v (B, R, cmax) with R = F*Y*X rows per slot; only the
// first ci (input) or co (output) channels of a layer are computed, so the
// 128 -> 1 -> 128 hourglass costs narrow work in its narrow layers.  y and gx
// are written at the full padded width (zeros beyond co / ci).
//
// Design.  A slot in f32 is R*cmax*4 = 811 KB, more than the 227 KB of
// shared memory of a block, so nothing stays resident across launches: every
// pass is a grid of (64-row tile, slot) blocks (or a row-blocked GEMM) and
// quantities that span blocks go through device memory.
//   forward  (4 launches): GEMM + scores epilogue; attend (alphas, v and
//            per-block partial GraphNorm sums per key); per-slot statistics
//            (the partials summed in tile order); apply (norm, ReLU, dropout).
//   backward (7 launches): GraphNorm partials G1 = sum m gz, G2 = sum m gz (v - s);
//            per-slot reduction into per-(key, channel) coefficients and the
//            GraphNorm parameter grads; per-row gv/gu and the 7 score dot
//            products (de_d, S, da_d written per row); the gather of the
//            reverse shifts (alphas and de of rows r + off read with their
//            halos, out-of-range rows as zero: a wrapped row carries alpha = 0
//            in the TPU kernel's circular roll, so zero fill is the same
//            function); gx GEMM; gW partial GEMMs over row chunks; one
//            finalize pass summing every parameter-grad partial in a fixed order.
// No atomics anywhere: the result is reproducible, and a slot's gradient
// contribution does not depend on which slots share the launch (only the
// f32 summation order of the parameter grads does).
//
// Save, not recompute.  The TPU kernel recomputes h, the alphas, v and the
// statistics in its backward because VMEM is scarce.  The card has 80 GB,
// so the forward saves h and v (B, R, cmax), the alphas (B, R, 8), the scores
// (2, B, R) and the per-key statistics; the backward reads them instead of
// running the GEMM and the softmax again.  At the train smoke's ~105 slots
// that is ~2.4 GB for the generator's 14 layers.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 without tensor cores).
// Per layer the GEMMs cost 2*ci*co (forward) and 4*ci*co (backward) flops a
// row, the Philox dropout ~100 integer operations an element, the rest ~40
// operations an element; the bytes are x, y (and gy, gx), the planes, the
// weights and the saved residuals.  chip_smoke.py computes the bound of a
// stack from those counts at the step's shapes and times the kernels against
// it.  This first version re-reads h, gu and the alphas through L2 between
// its launches and runs 11 launches a layer; speed is later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kTileRows = 64;     // rows of one slot per block
constexpr int kMaxC = 128;        // widest layer a block covers
constexpr int kChunk = 32;        // GEMM depth per shared-memory stage
constexpr int kMaxKeys = 16;      // buildings per slot (gid keys)
constexpr int kGemmThreads = 256;
constexpr int kRowThreads = 128;  // one thread per channel in the row passes
constexpr int kWg = 32;           // weight-gradient output tile (kWg x kWg)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float lrelu(float v, float slope) { return v >= 0.f ? v : slope * v; }
__device__ __forceinline__ float lrelu_grad(float v, float slope) { return v >= 0.f ? 1.f : slope; }

// Statistics key of a row: its gid (0 when K == 1), -1 off the mask.
__device__ __forceinline__ int row_key(const float* planes, size_t row, int K) {
  const float* p = planes + row * 8;
  if (!(p[6] > 0.f)) return -1;
  if (K == 1) return 0;
  const int g = (int)p[7];
  return ((float)g == p[7] && g >= 0 && g < K) ? g : -1;
}

// Row offsets of the 6 directions: neighbour d of row r is r - off[d].
__device__ __forceinline__ void dir_offsets(int Y, int X, int off[6]) {
  off[0] = Y * X;
  off[1] = -Y * X;
  off[2] = X;
  off[3] = -X;
  off[4] = 1;
  off[5] = -1;
}

// C[r, n] = sum_{k < kd} A[r, k] * B(k, n) for the `rows` rows of A (row
// stride cmax), n < nn, with B(k, n) = Bm[k * bk + n * bn]; writes C[r, n] for
// n < nw (0 where n >= nn), row stride cmax.  With att: also the scores
// a_s[r] = C[r, :] . att[0, :], a_d[r] = C[r, :] . att[1, :].
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const float* __restrict__ A, const float* __restrict__ Bm, int bk, int bn,
            float* __restrict__ C, int rows, int kd, int nn, int nw, int cmax,
            const float* __restrict__ att, float* __restrict__ a_s, float* __restrict__ a_d) {
  __shared__ float as[kTileRows][kChunk + 1];
  __shared__ float bs[kChunk][kMaxC];
  __shared__ float red_s[kTileRows][17];
  __shared__ float red_d[kTileRows][17];

  const int t = threadIdx.x;
  const int tr = t / 16;  // rows tr*4 .. tr*4+3 of the tile
  const int tc = t % 16;  // columns tc + 16*j
  const int r0 = blockIdx.x * kTileRows;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kd; k0 += kChunk) {
    for (int i = t; i < kTileRows * kChunk; i += kGemmThreads) {
      const int row = i / kChunk, kk = i % kChunk;
      const int r = r0 + row, k = k0 + kk;
      as[row][kk] = (r < rows && k < kd) ? A[(size_t)r * cmax + k] : 0.f;
    }
    for (int i = t; i < kChunk * kMaxC; i += kGemmThreads) {
      const int kk = i / kMaxC, c = i % kMaxC;
      const int k = k0 + kk;
      bs[kk][c] = (k < kd && c < nn) ? Bm[(size_t)k * bk + (size_t)c * bn] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kChunk; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[tr * 4 + i][kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = bs[kk][tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + tr * 4 + i;
    if (r < rows) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tc + 16 * j;
        if (c < nw) C[(size_t)r * cmax + c] = acc[i][j];
      }
    }
  }
  if (att == nullptr) return;  // uniform across the block
  float ps[4] = {0.f, 0.f, 0.f, 0.f};
  float pd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = tc + 16 * j;
    if (c < nn) {
      const float s = att[c], d = att[cmax + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ps[i] = fmaf(acc[i][j], s, ps[i]);
        pd[i] = fmaf(acc[i][j], d, pd[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    red_s[tr * 4 + i][tc] = ps[i];
    red_d[tr * 4 + i][tc] = pd[i];
  }
  __syncthreads();
  if (t < kTileRows && r0 + t < rows) {
    float s = 0.f, d = 0.f;
    for (int q = 0; q < 16; ++q) {
      s += red_s[t][q];
      d += red_d[t][q];
    }
    a_s[r0 + t] = s;
    a_d[r0 + t] = d;
  }
}

// Forward 2: per-row masked softmax (alphas saved), v = mask * aggregate + bias,
// and per-block partial GraphNorm sums per key.  Grid (T, B).
__global__ void __launch_bounds__(kRowThreads)
attend_kernel(const float* __restrict__ h, const float* __restrict__ a_s,
              const float* __restrict__ a_d, const float* __restrict__ planes,
              const float* __restrict__ vec, float* __restrict__ v, float* __restrict__ alphas,
              float* __restrict__ part, float* __restrict__ cnt,
              int R, int Y, int X, int co, int cmax, int K, float slope) {
  __shared__ float alpha[kTileRows][7];  // 0..5 neighbours, 6 self
  __shared__ int nbr[kTileRows][6];      // neighbour row, or -1
  __shared__ int key[kTileRows];
  __shared__ float mrow[kTileRows];
  __shared__ float s1[kMaxKeys][kMaxC];
  __shared__ float s2[kMaxKeys][kMaxC];
  __shared__ float nk[kMaxKeys];

  const int t = threadIdx.x;
  const int tile = blockIdx.x, T = gridDim.x;
  const int b = blockIdx.y;
  const int r0 = tile * kTileRows;
  const int nrows = min(kTileRows, R - r0);
  const size_t slot = (size_t)b * R;

  if (t < nrows) {
    const int r = r0 + t;
    const size_t row = slot + r;
    const float* p = planes + row * 8;
    int off[6];
    dir_offsets(Y, X, off);
    const float ad = a_d[row];
    const float e_self = lrelu(a_s[row] + ad, slope);
    float e[6];
    int q[6];
    float m = e_self;
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      const int n = r - off[d];
      const bool ok = p[d] > 0.f && n >= 0 && n < R;
      q[d] = ok ? n : -1;
      e[d] = ok ? lrelu(a_s[slot + n] + ad, slope) : kNegInf;
      m = fmaxf(m, e[d]);
    }
    const float ex_self = expf(e_self - m);
    float ex[6], den = ex_self;
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      ex[d] = q[d] >= 0 ? expf(e[d] - m) : 0.f;
      den += ex[d];
    }
    den = fmaxf(den, 1e-16f);
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      alpha[t][d] = ex[d] / den;
      nbr[t][d] = q[d];
      alphas[row * 8 + d] = alpha[t][d];
    }
    alpha[t][6] = ex_self / den;
    alphas[row * 8 + 6] = alpha[t][6];
    alphas[row * 8 + 7] = 0.f;
    key[t] = row_key(planes, row, K);
    mrow[t] = p[6] > 0.f ? 1.f : 0.f;
  }
  for (int i = t; i < K * kMaxC; i += kRowThreads) {
    s1[i / kMaxC][i % kMaxC] = 0.f;
    s2[i / kMaxC][i % kMaxC] = 0.f;
  }
  if (t < K) nk[t] = 0.f;
  __syncthreads();

  const int c = t;
  if (c < co) {
    const float bc = vec[c];
    for (int i = 0; i < nrows; ++i) {
      const size_t row = slot + r0 + i;
      float u = alpha[i][6] * h[row * cmax + c];
#pragma unroll
      for (int d = 0; d < 6; ++d) {
        const int n = nbr[i][d];
        if (n >= 0) u += alpha[i][d] * h[(slot + n) * cmax + c];
      }
      const float val = u * mrow[i] + bc;
      v[row * cmax + c] = val;
      const int k = key[i];
      if (k >= 0) {
        s1[k][c] += val;
        s2[k][c] += val * val;
      }
    }
  }
  if (t == 0) {
    for (int i = 0; i < nrows; ++i)
      if (key[i] >= 0) nk[key[i]] += 1.f;
  }
  __syncthreads();

  // part[((b*T + tile)*K + k)*2 + {0,1}][c], cnt[(b*T + tile)*K + k]
  const size_t base = ((size_t)b * T + tile) * K;
  if (c < co) {
    for (int k = 0; k < K; ++k) {
      part[((base + k) * 2) * cmax + c] = s1[k][c];
      part[((base + k) * 2 + 1) * cmax + c] = s2[k][c];
    }
  }
  if (t < K) cnt[base + t] = nk[t];
}

// Forward 3: per slot, the partials summed in tile order into the statistics
// stats[b, k] = (mean, s = mean * mean_scale, rstd) and the row count nk[b, k].
// Grid (B).
__global__ void __launch_bounds__(kRowThreads)
stats_kernel(const float* __restrict__ part, const float* __restrict__ cnt,
             const float* __restrict__ vec, float* __restrict__ stats, float* __restrict__ nk,
             int T, int co, int cmax, int K, float eps) {
  const int c = threadIdx.x;
  const int b = blockIdx.x;
  if (c >= co) return;
  const float ms = vec[3 * cmax + c];
  for (int k = 0; k < K; ++k) {
    float S1 = 0.f, S2 = 0.f, n = 0.f;
    for (int q = 0; q < T; ++q) {
      const size_t base = ((size_t)b * T + q) * K + k;
      S1 += part[(base * 2) * cmax + c];
      S2 += part[(base * 2 + 1) * cmax + c];
      n += cnt[base];
    }
    const float nc = fmaxf(n, 1.f);
    const float mean = S1 / nc, ex2 = S2 / nc;
    const float s = mean * ms;
    const float var = fmaxf(ex2 - 2.f * s * mean + s * s, 0.f);
    float* st = stats + (((size_t)b * K + k) * 3) * cmax + c;
    st[0] = mean;
    st[cmax] = s;
    st[2 * cmax] = 1.f / sqrtf(var + eps);
    if (c == 0) nk[b * K + k] = n;
  }
}

// Forward 4: z = GraphNorm(v), y = ReLU(z), dropout; zeros beyond co.  Grid (T, B).
__global__ void __launch_bounds__(kRowThreads)
apply_kernel(const float* __restrict__ v, const float* __restrict__ stats,
             const float* __restrict__ planes, const float* __restrict__ vec,
             const long long* __restrict__ key, int levels, float* __restrict__ y,
             int R, int co, int cmax, int K) {
  __shared__ int rkey[kTileRows];
  __shared__ float mrow[kTileRows];
  __shared__ float sh_s[kMaxKeys][kMaxC];
  __shared__ float sh_r[kMaxKeys][kMaxC];

  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kTileRows;
  const int nrows = min(kTileRows, R - r0);
  const size_t slot = (size_t)b * R;

  if (t < nrows) {
    rkey[t] = row_key(planes, slot + r0 + t, K);
    mrow[t] = planes[(slot + r0 + t) * 8 + 6] > 0.f ? 1.f : 0.f;
  }
  for (int i = t; i < K * kMaxC; i += kRowThreads) {
    const int k = i / kMaxC, c = i % kMaxC;
    const bool in = c < co;
    sh_s[k][c] = in ? stats[(((size_t)b * K + k) * 3 + 1) * cmax + c] : 0.f;
    sh_r[k][c] = in ? stats[(((size_t)b * K + k) * 3 + 2) * cmax + c] : 0.f;
  }
  __syncthreads();

  const int c = t;
  if (c >= cmax) return;
  if (c >= co) {
    for (int i = 0; i < nrows; ++i) y[(slot + r0 + i) * cmax + c] = 0.f;
    return;
  }
  const float gn_w = vec[cmax + c], gn_b = vec[2 * cmax + c];
  const uint32_t k0 = levels > 0 ? (uint32_t)key[0] : 0u;
  const uint32_t k1 = levels > 0 ? (uint32_t)key[1] : 0u;
  const float scale = 256.f / (256.f - (float)levels);
  for (int i = 0; i < nrows; ++i) {
    const size_t row = slot + r0 + i;
    const int k = rkey[i];
    float out = 0.f;
    if (mrow[i] > 0.f) {
      const float zn = k >= 0 ? (v[row * cmax + c] - sh_s[k][c]) * sh_r[k][c] : 0.f;
      out = fmaxf(zn * gn_w + gn_b, 0.f);
      if (levels > 0) {
        const size_t idx = row * cmax + c;
        out = philox_byte(idx, k0, k1) >= levels ? out * scale : 0.f;
      }
    }
    y[row * cmax + c] = out;
  }
}

// Backward 1: gz = ReLU'(z) * dropout(gy) on keyed rows (saved to gz), and
// per-block partials G1 = sum gz, G2 = sum gz (v - s) per key.  Grid (T, B).
__global__ void __launch_bounds__(kRowThreads)
norm_partials_kernel(const float* __restrict__ v, const float* __restrict__ stats,
                     const float* __restrict__ planes, const float* __restrict__ vec,
                     const long long* __restrict__ key, int levels,
                     const float* __restrict__ gy, float* __restrict__ gz,
                     float* __restrict__ part, int R, int co, int cmax, int K) {
  __shared__ int rkey[kTileRows];
  __shared__ float sh_s[kMaxKeys][kMaxC];
  __shared__ float sh_r[kMaxKeys][kMaxC];
  __shared__ float g1[kMaxKeys][kMaxC];
  __shared__ float g2[kMaxKeys][kMaxC];

  const int t = threadIdx.x;
  const int tile = blockIdx.x, T = gridDim.x;
  const int b = blockIdx.y;
  const int r0 = tile * kTileRows;
  const int nrows = min(kTileRows, R - r0);
  const size_t slot = (size_t)b * R;

  if (t < nrows) rkey[t] = row_key(planes, slot + r0 + t, K);
  for (int i = t; i < K * kMaxC; i += kRowThreads) {
    const int k = i / kMaxC, c = i % kMaxC;
    const bool in = c < co;
    sh_s[k][c] = in ? stats[(((size_t)b * K + k) * 3 + 1) * cmax + c] : 0.f;
    sh_r[k][c] = in ? stats[(((size_t)b * K + k) * 3 + 2) * cmax + c] : 0.f;
    g1[k][c] = 0.f;
    g2[k][c] = 0.f;
  }
  __syncthreads();

  const int c = t;
  if (c >= co) return;
  const float gn_w = vec[cmax + c], gn_b = vec[2 * cmax + c];
  const uint32_t k0 = levels > 0 ? (uint32_t)key[0] : 0u;
  const uint32_t k1 = levels > 0 ? (uint32_t)key[1] : 0u;
  const float scale = 256.f / (256.f - (float)levels);
  for (int i = 0; i < nrows; ++i) {
    const size_t row = slot + r0 + i;
    const int k = rkey[i];
    float g = 0.f;
    if (k >= 0) {
      const float d = v[row * cmax + c] - sh_s[k][c];
      const float z = d * sh_r[k][c] * gn_w + gn_b;
      float gin = gy[row * cmax + c];
      if (levels > 0) gin = philox_byte(row * cmax + c, k0, k1) >= levels ? gin * scale : 0.f;
      g = z > 0.f ? gin : 0.f;
      g1[k][c] += g;
      g2[k][c] += g * d;
    }
    gz[row * cmax + c] = g;
  }
  const size_t base = ((size_t)b * T + tile) * K;
  for (int k = 0; k < K; ++k) {
    part[((base + k) * 2) * cmax + c] = g1[k][c];
    part[((base + k) * 2 + 1) * cmax + c] = g2[k][c];
  }
}

// Backward 2: per slot, G1 and G2 summed in tile order; per (key, channel)
// coefficients of gv = gz*A - Bc - Cc*(v + D), and the slot's GraphNorm
// parameter grads (gn_w, gn_b, mean_scale).  Grid (B).
__global__ void __launch_bounds__(kRowThreads)
norm_reduce_kernel(const float* __restrict__ part, const float* __restrict__ stats,
                   const float* __restrict__ nk, const float* __restrict__ vec,
                   float* __restrict__ coef, float* __restrict__ pgn,
                   int T, int co, int cmax, int K) {
  const int c = threadIdx.x;
  const int b = blockIdx.x;
  if (c >= co) return;
  const float gn_w = vec[cmax + c], ms = vec[3 * cmax + c];
  float acc_w = 0.f, acc_b = 0.f, acc_ms = 0.f;
  for (int k = 0; k < K; ++k) {
    float G1 = 0.f, G2 = 0.f;
    for (int q = 0; q < T; ++q) {
      const size_t base = ((size_t)b * T + q) * K + k;
      G1 += part[(base * 2) * cmax + c];
      G2 += part[(base * 2 + 1) * cmax + c];
    }
    const float* st = stats + (((size_t)b * K + k) * 3) * cmax + c;
    const float mu = st[0], s = st[cmax], rstd = st[2 * cmax];
    const float n = fmaxf(nk[b * K + k], 1.f);
    const float inv = rstd * gn_w;
    float* cf = coef + (((size_t)b * K + k) * 4) * cmax + c;
    cf[0] = inv;
    cf[cmax] = (ms / n) * inv * G1;
    cf[2 * cmax] = (inv * rstd * rstd / n) * G2;
    cf[3 * cmax] = -2.f * s + s * ms;
    acc_w += G2 * rstd;
    acc_b += G1;
    acc_ms += -mu * inv * G1 - inv * rstd * rstd * mu * (s - mu) * G2;
  }
  pgn[((size_t)b * 3 + 0) * cmax + c] = acc_w;
  pgn[((size_t)b * 3 + 1) * cmax + c] = acc_b;
  pgn[((size_t)b * 3 + 2) * cmax + c] = acc_ms;
}

// Backward 3: gv (= gu, zero off the keyed rows) per row and channel, its
// per-block bias partial, then per row the score dot products and
// de[r] = (de_0..de_5, de_self, da_d).  Grid (T, B).
__global__ void __launch_bounds__(kRowThreads)
attn_rows_kernel(const float* __restrict__ gz, const float* __restrict__ v,
                 const float* __restrict__ coef, const float* __restrict__ h,
                 const float* __restrict__ a_s, const float* __restrict__ a_d,
                 const float* __restrict__ alphas, const float* __restrict__ planes,
                 float* __restrict__ gu, float* __restrict__ de, float* __restrict__ patt,
                 int R, int Y, int X, int co, int cmax, int K, float slope) {
  __shared__ float gus[kTileRows][kMaxC + 1];
  __shared__ int rkey[kTileRows];

  const int t = threadIdx.x;
  const int tile = blockIdx.x, T = gridDim.x;
  const int b = blockIdx.y;
  const int r0 = tile * kTileRows;
  const int nrows = min(kTileRows, R - r0);
  const size_t slot = (size_t)b * R;

  if (t < nrows) rkey[t] = row_key(planes, slot + r0 + t, K);
  __syncthreads();

  const int c = t;
  if (c < co) {
    float gb = 0.f;
    for (int i = 0; i < nrows; ++i) {
      const size_t row = slot + r0 + i;
      const int k = rkey[i];
      float g = 0.f;
      if (k >= 0) {
        const float* cf = coef + (((size_t)b * K + k) * 4) * cmax + c;
        g = gz[row * cmax + c] * cf[0] - cf[cmax] - cf[2 * cmax] * (v[row * cmax + c] + cf[3 * cmax]);
      }
      gus[i][c] = g;
      gu[row * cmax + c] = g;
      gb += g;
    }
    patt[(((size_t)b * T + tile) * 3 + 2) * cmax + c] = gb;
  }
  __syncthreads();

  if (t < nrows) {
    const int r = r0 + t;
    const size_t row = slot + r;
    const float* p = planes + row * 8;
    const float* a = alphas + row * 8;
    int off[6];
    dir_offsets(Y, X, off);
    float dself = 0.f;
    for (int cc = 0; cc < co; ++cc) dself += gus[t][cc] * h[row * cmax + cc];
    float dd[6];
    int q[6];
    float S = a[6] * dself;
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      const int n = r - off[d];
      q[d] = (p[d] > 0.f && n >= 0 && n < R) ? n : -1;
      dd[d] = 0.f;
      if (q[d] >= 0) {
        const float* hn = h + (slot + n) * cmax;
        for (int cc = 0; cc < co; ++cc) dd[d] += gus[t][cc] * hn[cc];
      }
      S += a[d] * dd[d];
    }
    const float ad = a_d[row];
    const float de_self = a[6] * (dself - S) * lrelu_grad(a_s[row] + ad, slope);
    float da_d = de_self;
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      const float de_d =
          q[d] >= 0 ? a[d] * (dd[d] - S) * lrelu_grad(a_s[slot + q[d]] + ad, slope) : 0.f;
      de[row * 8 + d] = de_d;
      da_d += de_d;
    }
    de[row * 8 + 6] = de_self;
    de[row * 8 + 7] = da_d;
  }
}

// Backward 4: gh = alpha_self gu + mask * sum_d alpha_d[r+off] gu[r+off]
//                  + da_s att_src + da_d att_dst,
// with da_s[r] = de_self[r] + sum_d de_d[r + off_d]; per-block partials of
// gatt_src = sum da_s h and gatt_dst = sum da_d h.  Grid (T, B).
__global__ void __launch_bounds__(kRowThreads)
attn_gather_kernel(const float* __restrict__ gu, const float* __restrict__ de,
                   const float* __restrict__ alphas, const float* __restrict__ h,
                   const float* __restrict__ planes, const float* __restrict__ att,
                   float* __restrict__ gh, float* __restrict__ patt,
                   int R, int Y, int X, int co, int cmax) {
  __shared__ float das[kTileRows], dad[kTileRows], aself[kTileRows], mrow[kTileRows];
  __shared__ float an[kTileRows][6];
  __shared__ int jn[kTileRows][6];

  const int t = threadIdx.x;
  const int tile = blockIdx.x, T = gridDim.x;
  const int b = blockIdx.y;
  const int r0 = tile * kTileRows;
  const int nrows = min(kTileRows, R - r0);
  const size_t slot = (size_t)b * R;

  if (t < nrows) {
    const int r = r0 + t;
    const size_t row = slot + r;
    int off[6];
    dir_offsets(Y, X, off);
    float s = de[row * 8 + 6];
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      const int j = r + off[d];
      const bool in = j >= 0 && j < R;
      jn[t][d] = in ? j : -1;
      an[t][d] = in ? alphas[(slot + j) * 8 + d] : 0.f;
      if (in) s += de[(slot + j) * 8 + d];
    }
    das[t] = s;
    dad[t] = de[row * 8 + 7];
    aself[t] = alphas[row * 8 + 6];
    mrow[t] = planes[row * 8 + 6] > 0.f ? 1.f : 0.f;
  }
  __syncthreads();

  const int c = t;
  if (c >= co) return;
  const float att_s = att[c], att_d = att[cmax + c];
  float acc_s = 0.f, acc_d = 0.f;
  for (int i = 0; i < nrows; ++i) {
    const size_t row = slot + r0 + i;
    float ghm = 0.f;
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      const int j = jn[i][d];
      if (j >= 0 && an[i][d] != 0.f) ghm += an[i][d] * gu[(slot + j) * cmax + c];
    }
    const float g = aself[i] * gu[row * cmax + c] + ghm * mrow[i] + das[i] * att_s + dad[i] * att_d;
    gh[row * cmax + c] = g;
    const float hv = h[row * cmax + c];
    acc_s += das[i] * hv;
    acc_d += dad[i] * hv;
  }
  patt[(((size_t)b * T + tile) * 3 + 0) * cmax + c] = acc_s;
  patt[(((size_t)b * T + tile) * 3 + 1) * cmax + c] = acc_d;
}

// Backward 6: partial gW[i, j] = sum_{rows of chunk p} x[r, i] gh[r, j] for
// i < ci, j < co.  Grid (tiles of kWg x kWg outputs, chunks P).
__global__ void __launch_bounds__(kGemmThreads)
wgrad_kernel(const float* __restrict__ x, const float* __restrict__ gh, float* __restrict__ pw,
             int rows, int ci, int co, int cmax, int chunk) {
  __shared__ float xs[kWg][kWg + 1];
  __shared__ float gs[kWg][kWg + 1];
  const int t = threadIdx.x;
  const int tiles_j = (co + kWg - 1) / kWg;
  const int i0 = (blockIdx.x / tiles_j) * kWg;
  const int j0 = (blockIdx.x % tiles_j) * kWg;
  const int p = blockIdx.y;
  const int rbeg = p * chunk;
  const int rend = min(rows, rbeg + chunk);
  const int ti = t / 8;        // output row i0 + ti
  const int tj = (t % 8) * 4;  // output columns j0 + tj .. +3
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int rb = rbeg; rb < rend; rb += kWg) {
    for (int e = t; e < kWg * kWg; e += kGemmThreads) {
      const int rr = e / kWg, cc = e % kWg;
      const int r = rb + rr;
      xs[rr][cc] = (r < rend && i0 + cc < ci) ? x[(size_t)r * cmax + i0 + cc] : 0.f;
      gs[rr][cc] = (r < rend && j0 + cc < co) ? gh[(size_t)r * cmax + j0 + cc] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < kWg; ++rr) {
      const float a = xs[rr][ti];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = fmaf(a, gs[rr][tj + q], acc[q]);
    }
    __syncthreads();
  }
  const int i = i0 + ti;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = j0 + tj + q;
    if (i < ci && j < co) pw[((size_t)p * cmax + i) * cmax + j] = acc[q];
  }
}

// Backward 7: every parameter grad from its partials, summed in a fixed
// order: gW over the P row chunks, gatt and the bias grad over the (slot,
// tile) blocks, the GraphNorm grads over the slots.  Zeros outside ci x co.
__global__ void __launch_bounds__(kGemmThreads)
finalize_kernel(const float* __restrict__ pw, const float* __restrict__ patt,
                const float* __restrict__ pgn, float* __restrict__ gw, float* __restrict__ gatt,
                float* __restrict__ gvec, int P, int BT, int B, int ci, int co, int cmax) {
  const int e = blockIdx.x * kGemmThreads + threadIdx.x;
  const int nw = cmax * cmax;
  if (e < nw) {
    const int i = e / cmax, j = e % cmax;
    float s = 0.f;
    if (i < ci && j < co)
      for (int p = 0; p < P; ++p) s += pw[((size_t)p * cmax + i) * cmax + j];
    gw[e] = s;
    return;
  }
  const int f = e - nw;
  if (f >= 6 * cmax) return;
  const int which = f / cmax, c = f % cmax;
  float s = 0.f;
  if (c < co) {
    if (which < 3) {
      for (int q = 0; q < BT; ++q) s += patt[((size_t)q * 3 + which) * cmax + c];
    } else {
      for (int b = 0; b < B; ++b) s += pgn[((size_t)b * 3 + which - 3) * cmax + c];
    }
  }
  // which: 0 att_src, 1 att_dst, 2 conv bias, 3 gn weight, 4 gn bias, 5 mean_scale
  if (which < 2)
    gatt[which * cmax + c] = s;
  else
    gvec[(which - 2) * cmax + c] = s;
}

__global__ void bytes_kernel(unsigned char* __restrict__ out, long long n,
                             const long long* __restrict__ key) {
  const long long i = (long long)blockIdx.x * kGemmThreads + threadIdx.x;
  if (i < n) out[i] = (unsigned char)philox_byte((uint64_t)i, (uint32_t)key[0], (uint32_t)key[1]);
}

bool bad_dims(int levels, int B, int F, int Y, int X, int cmax, int ci, int co, int K) {
  return B < 1 || F < 1 || Y < 1 || X < 1 || cmax < 1 || cmax > kMaxC || ci < 1 || co < 1 ||
         ci > cmax || co > cmax || K < 1 || K > kMaxKeys || levels < 0 || levels > 255;
}

}  // namespace

extern "C" {

// One layer forward.  Device pointers: x (B, R, cmax), planes (B, R, 8),
// w (cmax, cmax) as (in, out), att (2, cmax), vec (4, cmax) = conv bias, gn
// weight, gn bias, mean_scale; key (2,) int64 Philox words (read only when
// levels > 0).  Outputs: y (B, R, cmax) and, saved for the backward, h, v
// (B, R, cmax), scores (2, B*R), alphas (B, R, 8), stats (B, K, 3, cmax),
// nk (B, K); scratch part (B, T, K, 2, cmax), cnt (B, T, K), T = ceil(R/64).
// Launches on `stream`, does not synchronise; returns the first
// cudaGetLastError() that is not cudaSuccess (0 on success).
int gt_forward(const float* x, const float* planes, const float* w, const float* att,
               const float* vec, const long long* key, int levels, int B, int F, int Y, int X,
               int cmax, int ci, int co, int K, float slope, float eps, float* y, float* h,
               float* v, float* scores, float* alphas, float* part, float* cnt, float* stats,
               float* nk, void* stream) {
  if (bad_dims(levels, B, F, Y, X, cmax, ci, co, K) || (levels > 0 && key == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int R = F * Y * X;
  const int T = (R + kTileRows - 1) / kTileRows;
  const int rows = B * R;
  const int gemm_blocks = (rows + kTileRows - 1) / kTileRows;
  const dim3 tiles(T, B);
  gemm_kernel<<<gemm_blocks, kGemmThreads, 0, s>>>(x, w, cmax, 1, h, rows, ci, co, co, cmax, att,
                                                   scores, scores + rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attend_kernel<<<tiles, kRowThreads, 0, s>>>(h, scores, scores + rows, planes, vec, v, alphas,
                                              part, cnt, R, Y, X, co, cmax, K, slope);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_kernel<<<B, kRowThreads, 0, s>>>(part, cnt, vec, stats, nk, T, co, cmax, K, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  apply_kernel<<<tiles, kRowThreads, 0, s>>>(v, stats, planes, vec, key, levels, y, R, co, cmax, K);
  return (int)cudaGetLastError();
}

// One layer backward.  Inputs as gt_forward, the saved h, v, scores, alphas,
// stats, nk, and gy (B, R, cmax).  Outputs gx (B, R, cmax), gw (cmax, cmax),
// gatt (2, cmax), gvec (4, cmax).  Scratch: gz, gu, gh (B, R, cmax),
// de (B, R, 8), part (B, T, K, 2, cmax), coef (B, K, 4, cmax), pgn (B, 3, cmax),
// patt (B, T, 3, cmax), pw (P, cmax, cmax) with P = chunks row chunks.
int gt_backward(const float* x, const float* planes, const float* w, const float* att,
                const float* vec, const long long* key, int levels, int B, int F, int Y, int X,
                int cmax, int ci, int co, int K, float slope, int chunks, const float* h,
                const float* v, const float* scores, const float* alphas, const float* stats,
                const float* nk, const float* gy, float* gx, float* gw, float* gatt, float* gvec,
                float* gz, float* gu, float* gh, float* de, float* part, float* coef, float* pgn,
                float* patt, float* pw, void* stream) {
  if (bad_dims(levels, B, F, Y, X, cmax, ci, co, K) || (levels > 0 && key == nullptr) ||
      chunks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int R = F * Y * X;
  const int T = (R + kTileRows - 1) / kTileRows;
  const int rows = B * R;
  const int gemm_blocks = (rows + kTileRows - 1) / kTileRows;
  const dim3 tiles(T, B);
  const float* a_s = scores;
  const float* a_d = scores + rows;

  norm_partials_kernel<<<tiles, kRowThreads, 0, s>>>(v, stats, planes, vec, key, levels, gy, gz,
                                                     part, R, co, cmax, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  norm_reduce_kernel<<<B, kRowThreads, 0, s>>>(part, stats, nk, vec, coef, pgn, T, co, cmax, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_rows_kernel<<<tiles, kRowThreads, 0, s>>>(gz, v, coef, h, a_s, a_d, alphas, planes, gu, de,
                                                 patt, R, Y, X, co, cmax, K, slope);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_gather_kernel<<<tiles, kRowThreads, 0, s>>>(gu, de, alphas, h, planes, att, gh, patt, R, Y,
                                                   X, co, cmax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // gx[r, n] = sum_{k < co} gh[r, k] W[n, k], n < ci; zeros up to cmax
  gemm_kernel<<<gemm_blocks, kGemmThreads, 0, s>>>(gh, w, 1, cmax, gx, rows, co, ci, cmax, cmax,
                                                   nullptr, nullptr, nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int chunk = (rows + chunks - 1) / chunks;
  const dim3 wg_grid(((ci + kWg - 1) / kWg) * ((co + kWg - 1) / kWg), chunks);
  wgrad_kernel<<<wg_grid, kGemmThreads, 0, s>>>(x, gh, pw, rows, ci, co, cmax, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int fin_blocks = (cmax * cmax + 6 * cmax + kGemmThreads - 1) / kGemmThreads;
  finalize_kernel<<<fin_blocks, kGemmThreads, 0, s>>>(pw, patt, pgn, gw, gatt, gvec, chunks,
                                                      B * T, B, ci, co, cmax);
  return (int)cudaGetLastError();
}

// The dropout bytes of flat elements 0..n-1 under key (a check of csrc/philox.cuh).
int gt_dropout_bytes(unsigned char* out, long long n, const long long* key, void* stream) {
  if (n < 0 || key == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long blocks = (n + kGemmThreads - 1) / kGemmThreads;
  if (blocks == 0) return 0;
  bytes_kernel<<<(unsigned)blocks, kGemmThreads, 0, s>>>(out, n, key);
  return (int)cudaGetLastError();
}

const char* gt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
