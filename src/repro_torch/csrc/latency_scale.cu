// K1 latency_scale: base_pf · max(1, demand / capacity)^alpha per
// (tenant, second) cell, float32 in and out.
//
// Replaces the Pallas kernel _scale_kernel / _pallas_latency_scale of
// src/repro/sim/engines/jax_backend.py. The TPU version walks 256-row
// blocks in order; here every cell is independent, so one thread takes
// one cell (grid-stride) and the per-tenant columns are read through
// the cache. Bound: bytes — one f32 read and one f32 write per cell.
// pow runs only where rho > 1; elsewhere the factor is exactly 1, which
// is what pow(1, alpha) returns.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void latency_scale_kernel(const float* __restrict__ base_pf,
                                     const float* __restrict__ alpha,
                                     const float* __restrict__ demand,
                                     const float* __restrict__ capacity,
                                     float* __restrict__ out,
                                     long long rows, long long cols) {
    const long long n = rows * cols;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        const long long r = i / cols;
        const float m = fmaxf(1.0f, demand[i] / capacity[r]);
        const float p = m > 1.0f ? powf(m, alpha[r]) : 1.0f;
        out[i] = base_pf[r] * p;
    }
}

extern "C" int latency_scale_f32(const void* base_pf, const void* alpha,
                                 const void* demand, const void* capacity,
                                 void* out, long long rows, long long cols,
                                 void* stream) {
    const long long n = rows * cols;
    if (n == 0) return 0;
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 16) blocks = 132 * 16;
    latency_scale_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
        (const float*)base_pf, (const float*)alpha, (const float*)demand,
        (const float*)capacity, (float*)out, rows, cols);
    return (int)cudaGetLastError();
}
