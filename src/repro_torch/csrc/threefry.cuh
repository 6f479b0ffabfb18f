// Counter-based random bits shared by the fleet kernels.
//
// threefry2x32 with 20 rounds, exactly as JAX defines it: a row's
// 64-bit key (k0, k1) and a 64-bit counter (c0, c1) give two 32-bit
// words, and JAX's partitionable scheme hands out bits = x0 ^ x1 for
// the element at flat index (c0 = hi, c1 = lo). The plain versions in
// repro_torch/kernels/fleet.py compute the same words with int64
// tensor arithmetic, so a kernel and its plain version see identical
// bits for identical keys.
#pragma once
#include <stdint.h>

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
    return __funnelshift_l(x, x, r);
}

#define REPRO_TF_ROUND(r) \
    x0 += x1;             \
    x1 = rotl32(x1, r);   \
    x1 ^= x0;

__device__ __forceinline__ uint32_t threefry2x32_xor(uint32_t k0, uint32_t k1,
                                                     uint32_t c0, uint32_t c1) {
    const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
    uint32_t x0 = c0 + k0;
    uint32_t x1 = c1 + k1;
    REPRO_TF_ROUND(13) REPRO_TF_ROUND(15) REPRO_TF_ROUND(26) REPRO_TF_ROUND(6)
    x0 += k1; x1 += k2 + 1u;
    REPRO_TF_ROUND(17) REPRO_TF_ROUND(29) REPRO_TF_ROUND(16) REPRO_TF_ROUND(24)
    x0 += k2; x1 += k0 + 2u;
    REPRO_TF_ROUND(13) REPRO_TF_ROUND(15) REPRO_TF_ROUND(26) REPRO_TF_ROUND(6)
    x0 += k0; x1 += k1 + 3u;
    REPRO_TF_ROUND(17) REPRO_TF_ROUND(29) REPRO_TF_ROUND(16) REPRO_TF_ROUND(24)
    x0 += k1; x1 += k2 + 4u;
    REPRO_TF_ROUND(13) REPRO_TF_ROUND(15) REPRO_TF_ROUND(26) REPRO_TF_ROUND(6)
    x0 += k2; x1 += k0 + 5u;
    return x0 ^ x1;
}

#undef REPRO_TF_ROUND

// A uniform double in (0, 1) from 32 bits: the bits' centre cell.
__device__ __forceinline__ double uniform_open01(uint32_t bits) {
    return ((double)bits + 0.5) * 0x1p-32;
}
