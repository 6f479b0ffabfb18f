// K1 latency_scale: base_pf · max(1, demand / capacity)^alpha per
// (tenant, second) cell, float32 in and out.
//
// Replaces the Pallas kernel _scale_kernel / _pallas_latency_scale of
// src/repro/sim/engines/jax_backend.py. The TPU version walks 256-row
// blocks in order; here a warp takes a row (rows grid-stride), reads the
// row's capacity, alpha and base_pf once into registers, and its lanes
// take four consecutive columns each: one float4 load of demand and one
// float4 store of out where cols % 4 == 0 and both pointers are 16-byte
// aligned, scalar accesses otherwise. Rows and columns are indexed as
// such, so no cell pays for a 64-bit division.
//
// Bound: bytes — one f32 read and one f32 write per cell; the
// operations (the IEEE division, max, compare, the product, and powf
// where rho > 1) come second at the game fleet's chunk. pow runs only
// where rho > 1; elsewhere the factor is exactly 1, which is what
// pow(1, alpha) returns. Built with -fmad=false: the cell's expression
// rounds where the plain torch version rounds it, bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kWarps = 8;

__device__ __forceinline__ float scale_cell(float d, float c, float a,
                                            float b) {
    const float m = fmaxf(1.0f, d / c);
    const float p = m > 1.0f ? powf(m, a) : 1.0f;
    return b * p;
}

template <int VEC>
__global__ void __launch_bounds__(kWarps * 32)
    latency_scale_kernel(const float* __restrict__ base_pf,
                         const float* __restrict__ alpha,
                         const float* __restrict__ demand,
                         const float* __restrict__ capacity,
                         float* __restrict__ out, long long rows,
                         long long cols) {
    const int lane = threadIdx.x & 31;
    const long long stride = (long long)gridDim.x * kWarps;
    for (long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
         r < rows; r += stride) {
        const float c = capacity[r], a = alpha[r], b = base_pf[r];
        const float* d = demand + r * cols;
        float* o = out + r * cols;
        for (long long c0 = 4LL * lane; c0 < cols; c0 += 128) {
            if (VEC) {
                const float4 x = *reinterpret_cast<const float4*>(d + c0);
                *reinterpret_cast<float4*>(o + c0) = make_float4(
                    scale_cell(x.x, c, a, b), scale_cell(x.y, c, a, b),
                    scale_cell(x.z, c, a, b), scale_cell(x.w, c, a, b));
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (c0 + j < cols) o[c0 + j] = scale_cell(d[c0 + j], c, a, b);
            }
        }
    }
}

extern "C" int latency_scale_f32(const void* base_pf, const void* alpha,
                                 const void* demand, const void* capacity,
                                 void* out, long long rows, long long cols,
                                 void* stream) {
    if (rows == 0 || cols == 0) return 0;
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    // a warp per row; at most the CTAs that stay resident (2,048 threads
    // an SM), the rest grid-stride
    long long blocks = (rows + kWarps - 1) / kWarps;
    const long long fill = (long long)sms * (2048 / (kWarps * 32));
    if (blocks > fill) blocks = fill;
    const bool vec = cols % 4 == 0 && (uintptr_t)demand % 16 == 0 &&
                     (uintptr_t)out % 16 == 0;
    const auto kernel = vec ? latency_scale_kernel<1> : latency_scale_kernel<0>;
    kernel<<<(unsigned)blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
            (const float*)base_pf, (const float*)alpha, (const float*)demand,
            (const float*)capacity, (float*)out, rows, cols);
    return (int)cudaGetLastError();
}
