// K2 row_draw: per row (node, tenant) and column, a standard normal from
// the row's threefry key, the latency scale·exp(sigma·z), the SLO
// violation flag and the row's masked latency sum and violation count.
//
// Replaces the jit-fused bodies _dense_impl, _fused_impl and
// _jitter_impl of src/repro/sim/engines/jax_backend.py. The uniform
// follows jax.random.normal bit for bit: bits = threefry2x32(key,
// (0, col)) as x0 ^ x1, u = max(lo, ((bits >> 9 | 1.0f) - 1)·(1 - lo)
// + lo) with lo = nextafter(-1, 0), z = sqrt(2)·erfinv(u).
//
// Modes: dense (mask = active[row, col]), fused (mask = col <
// totals[row]) and jitter (writes exp(sigma·z) only; no mask, no
// reductions). One block per row walks the row's columns, so the row
// reductions stay in registers and one block reduction; nothing is
// carried between blocks.
//
// Bound: integer ALU. About 74 32-bit integer operations a cell for the
// 20 threefry rounds against about 6 bytes of traffic, so the int32
// pipe and not device memory limits it.
//
// Built with -fmad=false so that every float product and sum rounds
// where the plain torch version rounds it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

enum { MODE_DENSE = 0, MODE_FUSED = 1, MODE_JITTER = 2 };

__device__ __forceinline__ float normal_from_bits(uint32_t bits, float lo,
                                                  float span) {
    const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    const float u = fmaxf(lo, f * span + lo);
    return 0x1.6a09e6p+0f * erfinvf(u);  // float32(sqrt(2))
}

template <int MODE>
__global__ void row_draw_kernel(const uint32_t* __restrict__ k0,
                                const uint32_t* __restrict__ k1,
                                uint32_t chunk_word,
                                const uint8_t* __restrict__ active,
                                const int32_t* __restrict__ totals,
                                const float* __restrict__ scale,
                                const float* __restrict__ sigma,
                                const float* __restrict__ slo,
                                float* __restrict__ lat,
                                uint8_t* __restrict__ viol,
                                float* __restrict__ lat_sum,
                                int32_t* __restrict__ viol_count,
                                long long cols, float lo, float span) {
    const long long row = blockIdx.x;
    const uint32_t key0 = k0[row];
    const uint32_t key1 = k1[row] ^ chunk_word;
    const float sg = sigma[row];
    const long long base = row * cols;
    float sc = 0.0f, sl = 0.0f;
    long long tot = 0;
    if (MODE != MODE_JITTER) {
        sc = scale[row];
        sl = slo[row];
    }
    if (MODE == MODE_FUSED) tot = totals[row];
    float acc = 0.0f;
    int cnt = 0;
    for (long long c = threadIdx.x; c < cols; c += blockDim.x) {
        const float z = normal_from_bits(
            threefry2x32_xor(key0, key1, 0u, (uint32_t)c), lo, span);
        const float e = expf(z * sg);
        if (MODE == MODE_JITTER) {
            lat[base + c] = e;
            continue;
        }
        const float l = sc * e;
        const bool m = (MODE == MODE_DENSE) ? active[base + c] != 0 : c < tot;
        const bool v = m && (l > sl);
        lat[base + c] = l;
        viol[base + c] = v ? 1 : 0;
        if (m) acc += l;
        cnt += v ? 1 : 0;
    }
    if (MODE == MODE_JITTER) return;

    // block reduction: warp shuffles, then one warp over the warp sums
    __shared__ float s_acc[32];
    __shared__ int s_cnt[32];
    for (int o = 16; o > 0; o >>= 1) {
        acc += __shfl_down_sync(0xffffffffu, acc, o);
        cnt += __shfl_down_sync(0xffffffffu, cnt, o);
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
        s_acc[warp] = acc;
        s_cnt[warp] = cnt;
    }
    __syncthreads();
    if (warp == 0) {
        const int nw = (blockDim.x + 31) >> 5;
        acc = lane < nw ? s_acc[lane] : 0.0f;
        cnt = lane < nw ? s_cnt[lane] : 0;
        for (int o = 16; o > 0; o >>= 1) {
            acc += __shfl_down_sync(0xffffffffu, acc, o);
            cnt += __shfl_down_sync(0xffffffffu, cnt, o);
        }
        if (lane == 0) {
            lat_sum[row] = acc;
            viol_count[row] = cnt;
        }
    }
}

extern "C" int row_draw_f32(int mode, const void* k0, const void* k1,
                            unsigned int chunk_word, const void* active,
                            const void* totals, const void* scale,
                            const void* sigma, const void* slo, void* lat,
                            void* viol, void* lat_sum, void* viol_count,
                            long long rows, long long cols, float lo,
                            float span, void* stream) {
    if (rows == 0 || cols == 0) return 0;
    const int threads = cols <= 128 ? 128 : 256;
    const dim3 grid((unsigned)rows);
    cudaStream_t s = (cudaStream_t)stream;
#define REPRO_ROW_DRAW_ARGS                                               \
    (const uint32_t*)k0, (const uint32_t*)k1, (uint32_t)chunk_word,      \
        (const uint8_t*)active, (const int32_t*)totals,                  \
        (const float*)scale, (const float*)sigma, (const float*)slo,     \
        (float*)lat, (uint8_t*)viol, (float*)lat_sum,                    \
        (int32_t*)viol_count, cols, lo, span
    switch (mode) {
        case MODE_DENSE:
            row_draw_kernel<MODE_DENSE><<<grid, threads, 0, s>>>(
                REPRO_ROW_DRAW_ARGS);
            break;
        case MODE_FUSED:
            row_draw_kernel<MODE_FUSED><<<grid, threads, 0, s>>>(
                REPRO_ROW_DRAW_ARGS);
            break;
        case MODE_JITTER:
            row_draw_kernel<MODE_JITTER><<<grid, threads, 0, s>>>(
                REPRO_ROW_DRAW_ARGS);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef REPRO_ROW_DRAW_ARGS
    return (int)cudaGetLastError();
}
