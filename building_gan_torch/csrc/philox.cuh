// Philox4x32-10 (Salmon, Moraes, Dror, Shaw, "Parallel random numbers: as
// easy as 1, 2, 3", SC'11), written out for the dropout of the training
// kernels.  The same rounds in int64 tensor arithmetic are
// building_gan_torch/ops/dropout.py::philox4x32_10; both give the
// Random123 known-answer vectors, so a kernel and the plain version draw
// bit-identical masks.
//
// Dropout byte of a flat element index i under a 64-bit key (k0, k1): the low
// byte of the first output word for the counter (lo32(i), hi32(i), 0, 0).
#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t philox_mulhilo(uint32_t a, uint32_t b, uint32_t* hi) {
  const uint64_t p = (uint64_t)a * (uint64_t)b;
  *hi = (uint32_t)(p >> 32);
  return (uint32_t)p;
}

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    uint32_t hi0, hi1;
    const uint32_t lo0 = philox_mulhilo(0xD2511F53u, c[0], &hi0);
    const uint32_t lo1 = philox_mulhilo(0xCD9E8D57u, c[2], &hi1);
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

__device__ __forceinline__ int philox_byte(uint64_t index, uint32_t k0, uint32_t k1) {
  uint32_t c[4] = {(uint32_t)index, (uint32_t)(index >> 32), 0u, 0u};
  philox4x32_10(c, k0, k1);
  return (int)(c[0] & 255u);
}
