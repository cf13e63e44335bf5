// Deterministic GAT hourglass forward for Hopper (sm_90a), f32 throughout.
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
//
// Layout: x, h, v, out are (B, R, cmax) with R = F*Y*X rows per slot; only the
// first co channels of a layer are computed and read, so narrow layers cost
// narrow work.  The neighbour validity (grid boundaries, occupancy, same gid)
// is computed here from mask and gid.
//
// Design.  A slot in f32 is R*cmax*4 = 811 KB, more than the 227 KB of shared
// memory of one block, so the TPU kernel's "whole slot resident across all
// layers" layout does not carry over.  Each layer is three launches over a
// (row tiles of 64, slots) grid; a block never spans two slots:
//   1. gemm_scores_kernel: tiled f32 GEMM in shared memory; its epilogue
//      reduces each row against att_src / att_dst.
//   2. attend_kernel: per-row masked 7-way softmax, the aggregate plus bias,
//      and per-block partial sums (count, sum v, sum v^2) per (slot, key).
//   3. norm_apply_kernel: the partials summed in a fixed order (tile 0..T-1),
//      one-pass variance, scale and shift, mask, ReLU.
// No atomics: results are reproducible and a slot's output does not depend on
// the other slots of the batch.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 without tensor cores): at the
// config of record (hidden 128, repeat 7, grid (11,12,12), 16 slots) the work
// is 1.34 GFLOP of f32 (the GEMMs at the real ci x co widths dominate) against
// 27 MB moved once (x in, out back, mask, weights), so it is bound by
// operations at 20 us.  This first version re-reads h and v from memory
// between its launches and runs 3 launches a layer; chip_smoke.py measures
// how far it is from that bound.

#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 64;   // rows of one slot per block
constexpr int kMaxC = 128;      // widest layer a block covers
constexpr int kChunk = 32;      // GEMM depth per shared-memory stage
constexpr int kMaxKeys = 16;    // buildings per slot (gid keys)
constexpr int kGemmThreads = 256;
constexpr int kRowThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

// Key of row r for the statistics: -1 when the row takes no part.
__device__ __forceinline__ int row_key(const float* mask, const int* gid, size_t i, int K) {
  if (!(mask[i] > 0.f)) return -1;
  if (K == 1) return 0;
  const int g = gid[i];
  return (g >= 0 && g < K) ? g : -1;
}

__global__ void __launch_bounds__(kGemmThreads)
gemm_scores_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ att, float* __restrict__ h,
                   float* __restrict__ a_s, float* __restrict__ a_d,
                   int R, int ci, int co, int cmax) {
  __shared__ float xs[kTileRows][kChunk + 1];
  __shared__ float ws[kChunk][kMaxC];
  __shared__ float red_s[kTileRows][17];
  __shared__ float red_d[kTileRows][17];

  const int t = threadIdx.x;
  const int tr = t / 16;  // rows tr*4 .. tr*4+3 of the tile
  const int tc = t % 16;  // columns tc + 16*j
  const int r0 = blockIdx.x * kTileRows;
  const size_t slot = (size_t)blockIdx.y * R;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < ci; k0 += kChunk) {
    for (int i = t; i < kTileRows * kChunk; i += kGemmThreads) {
      const int row = i / kChunk, kk = i % kChunk;
      const int r = r0 + row, k = k0 + kk;
      xs[row][kk] = (r < R && k < ci) ? x[(slot + r) * cmax + k] : 0.f;
    }
    for (int i = t; i < kChunk * kMaxC; i += kGemmThreads) {
      const int kk = i / kMaxC, c = i % kMaxC;
      const int k = k0 + kk;
      ws[kk][c] = (k < ci && c < co) ? w[(size_t)k * cmax + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kChunk; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[tr * 4 + i][kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = ws[kk][tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float ps[4] = {0.f, 0.f, 0.f, 0.f};
  float pd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = tc + 16 * j;
    if (c < co) {
      const float as = att[c], ad = att[cmax + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ps[i] = fmaf(acc[i][j], as, ps[i]);
        pd[i] = fmaf(acc[i][j], ad, pd[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + tr * 4 + i;
    if (r < R) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tc + 16 * j;
        if (c < co) h[(slot + r) * cmax + c] = acc[i][j];
      }
    }
    red_s[tr * 4 + i][tc] = ps[i];
    red_d[tr * 4 + i][tc] = pd[i];
  }
  __syncthreads();
  if (t < kTileRows && r0 + t < R) {
    float s = 0.f, d = 0.f;
    for (int q = 0; q < 16; ++q) {
      s += red_s[t][q];
      d += red_d[t][q];
    }
    a_s[slot + r0 + t] = s;
    a_d[slot + r0 + t] = d;
  }
}

__global__ void __launch_bounds__(kRowThreads)
attend_kernel(const float* __restrict__ h, const float* __restrict__ a_s,
              const float* __restrict__ a_d, const float* __restrict__ mask,
              const int* __restrict__ gid, const float* __restrict__ bias,
              float* __restrict__ v, float* __restrict__ part, float* __restrict__ cnt,
              int R, int Y, int X, int co, int cmax, int K, float slope) {
  __shared__ float alpha[kTileRows][7];  // 0..5 neighbours, 6 self
  __shared__ int nbr[kTileRows][6];      // neighbour row, or -1
  __shared__ int key[kTileRows];
  __shared__ float valid_row[kTileRows];
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
    const int YX = Y * X;
    const int iy = (r / X) % Y, ix = r % X;
    const int offs[6] = {YX, -YX, X, -X, 1, -1};
    const bool inside[6] = {true, true, iy >= 1, iy <= Y - 2, ix >= 1, ix <= X - 2};
    const int g = gid ? gid[slot + r] : 0;
    const float ad = a_d[slot + r];
    const float e_self = lrelu(a_s[slot + r] + ad, slope);
    float e[6];
    int q[6];
    float m = e_self;
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      const int n = r - offs[d];
      bool ok = inside[d] && n >= 0 && n < R;
      ok = ok && mask[slot + n] > 0.f && (!gid || gid[slot + n] == g);
      q[d] = ok ? n : -1;
      e[d] = ok ? lrelu(a_s[slot + n] + ad, slope) : kNegInf;
      m = fmaxf(m, e[d]);
    }
    float ex[6], sum = 0.f;
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      ex[d] = q[d] >= 0 ? expf(e[d] - m) : 0.f;
      sum += ex[d];
    }
    const float ex_self = expf(e_self - m);
    const float den = fmaxf(sum + ex_self, 1e-16f);
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      alpha[t][d] = ex[d] / den;
      nbr[t][d] = q[d];
    }
    alpha[t][6] = ex_self / den;
    key[t] = row_key(mask, gid, slot + r, K);
    valid_row[t] = mask[slot + r] > 0.f ? 1.f : 0.f;
  }
  for (int i = t; i < K * kMaxC; i += kRowThreads) {
    s1[i / kMaxC][i % kMaxC] = 0.f;
    s2[i / kMaxC][i % kMaxC] = 0.f;
  }
  if (t < K) nk[t] = 0.f;
  __syncthreads();

  const int c = t;
  if (c < co) {
    const float bc = bias[c];
    for (int i = 0; i < nrows; ++i) {
      const size_t row = slot + r0 + i;
      float u = alpha[i][6] * h[row * cmax + c];
#pragma unroll
      for (int d = 0; d < 6; ++d) {
        const int n = nbr[i][d];
        if (n >= 0) u += alpha[i][d] * h[(slot + n) * cmax + c];
      }
      const float val = valid_row[i] > 0.f ? u + bc : bc;
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

  // partials: part[((b*T + tile)*K + k)*2 + {0,1}][c], cnt[(b*T + tile)*K + k]
  const size_t base = ((size_t)b * T + tile) * K;
  if (c < co) {
    for (int k = 0; k < K; ++k) {
      part[((base + k) * 2) * cmax + c] = s1[k][c];
      part[((base + k) * 2 + 1) * cmax + c] = s2[k][c];
    }
  }
  if (t < K) cnt[base + t] = nk[t];
}

__global__ void __launch_bounds__(kRowThreads)
norm_apply_kernel(const float* __restrict__ v, const float* __restrict__ part,
                  const float* __restrict__ cnt, const float* __restrict__ mask,
                  const int* __restrict__ gid, const float* __restrict__ vec,
                  float* __restrict__ out, int R, int co, int cmax, int K, float eps) {
  __shared__ float scale[kMaxKeys][kMaxC];
  __shared__ float shift[kMaxKeys][kMaxC];
  __shared__ int key[kTileRows];
  __shared__ int used[kMaxKeys];

  const int t = threadIdx.x;
  const int T = gridDim.x;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kTileRows;
  const int nrows = min(kTileRows, R - r0);
  const size_t slot = (size_t)b * R;

  if (t < K) used[t] = 0;
  __syncthreads();
  if (t < nrows) {
    const int k = row_key(mask, gid, slot + r0 + t, K);
    key[t] = k;
    if (k >= 0) used[k] = 1;  // benign race: every writer stores 1
  }
  __syncthreads();

  const int c = t;
  if (c < co) {
    const float gn_w = vec[cmax + c], gn_b = vec[2 * cmax + c], gn_ms = vec[3 * cmax + c];
    for (int k = 0; k < K; ++k) {
      if (!used[k]) continue;
      float S1 = 0.f, S2 = 0.f, n = 0.f;
      for (int q = 0; q < T; ++q) {
        const size_t base = ((size_t)b * T + q) * K + k;
        S1 += part[(base * 2) * cmax + c];
        S2 += part[(base * 2 + 1) * cmax + c];
        n += cnt[base];
      }
      const float nc = fmaxf(n, 1.f);
      const float mean = S1 / nc, ex2 = S2 / nc;
      const float s = mean * gn_ms;
      const float var = fmaxf(ex2 - 2.f * s * mean + s * s, 0.f);
      const float inv = gn_w * (1.f / sqrtf(var + eps));
      scale[k][c] = inv;
      shift[k][c] = gn_b - s * inv;
    }
    for (int i = 0; i < nrows; ++i) {
      const size_t row = slot + r0 + i;
      const int k = key[i];
      out[row * cmax + c] = k >= 0 ? fmaxf(v[row * cmax + c] * scale[k][c] + shift[k][c], 0.f) : 0.f;
    }
  }
}

}  // namespace

extern "C" {

// Runs the whole stack.  Device pointers: x, mask, gid (may be null: one
// building per slot), Ws (L, cmax, cmax), atts (L, 2, cmax), vecs (L, 4, cmax)
// holding conv bias, GraphNorm weight, bias, mean_scale; out (B, R, cmax);
// scratch h, v (B, R, cmax), scores (2, B, R), part (B, T, K, 2, cmax),
// cnt (B, T, K) with T = ceil(R / 64).  chans is a host array of L (ci, co)
// pairs.  Launches on `stream`, does not synchronise, returns the first
// cudaGetLastError() that is not cudaSuccess (0 on success).
int hg_forward(const float* x, const float* mask, const int* gid, int K,
               const float* Ws, const float* atts, const float* vecs,
               const int* chans, int L, int B, int F, int Y, int X, int cmax,
               float slope, float eps, float* out, float* h, float* v,
               float* scores, float* part, float* cnt, void* stream) {
  if (cmax > kMaxC || K < 1 || K > kMaxKeys || (K > 1 && gid == nullptr))
    return (int)cudaErrorInvalidValue;
  const int R = F * Y * X;
  const int T = (R + kTileRows - 1) / kTileRows;
  const dim3 grid(T, B);
  cudaStream_t s = (cudaStream_t)stream;
  float* a_s = scores;
  float* a_d = scores + (size_t)B * R;
  const float* in = x;
  for (int l = 0; l < L; ++l) {
    const int ci = chans[2 * l], co = chans[2 * l + 1];
    if (ci < 1 || co < 1 || ci > cmax || co > cmax) return (int)cudaErrorInvalidValue;
    gemm_scores_kernel<<<grid, kGemmThreads, 0, s>>>(
        in, Ws + (size_t)l * cmax * cmax, atts + (size_t)l * 2 * cmax, h, a_s, a_d,
        R, ci, co, cmax);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    attend_kernel<<<grid, kRowThreads, 0, s>>>(
        h, a_s, a_d, mask, gid, vecs + (size_t)l * 4 * cmax, v, part, cnt,
        R, Y, X, co, cmax, K, slope);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    norm_apply_kernel<<<grid, kRowThreads, 0, s>>>(
        v, part, cnt, mask, gid, vecs + (size_t)l * 4 * cmax, out, R, co, cmax, K, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    in = out;
  }
  return 0;
}

const char* hg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
