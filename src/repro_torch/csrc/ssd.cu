// K7 ssd: the Mamba-2 SSD chunk scan. Per (b, h), with the (P, N) f32
// state S, a = -exp(a_log[h]), x̃_t = dt_t·x_t and cum the running sum
// of dt·a inside a chunk:
//   intra  y_i  = Σ_{j≤i} exp(cum_i − cum_j)·(C_i·B_j)·x̃_j
//   inter  y_i += exp(cum_i)·C_i·S_prevᵀ
//   state  S    ← exp(cum_end)·S + Σ_j exp(cum_end − cum_j)·x̃_j B_jᵀ.
//
// Replaces the Pallas kernel ssd._kernel / ssd_forward of
// src/repro/kernels/ssd.py, which walks the chunks of one (b, h) in
// order with the state in VMEM scratch and the three products on the
// MXU. Here one CTA of 256 threads owns a (b, h) and walks its chunks of
// L = 64 steps in order, with the state and the chunk in shared memory
// (x̃ (L, P), Bᵀ and Cᵀ (N, L), the masked decay matrix (L, L) and the
// state transposed (N, P); 81 KiB at P = N = 64). Each product is a
// loop over 4×4 register tiles, one tile per thread, fed by 16-byte
// shared-memory loads along the tile's two output axes (the layouts are
// chosen so that those loads hit distinct banks or broadcast). The
// chunk's cumulative decay is a sequential sum in one thread, as the
// reference's cumsum is. A ragged last chunk is masked (dt = 0 and
// x̃ = B = C = 0 past the end, which decays nothing and adds nothing), so
// any T works; the chunk is the kernel's own and does not change the
// function. Inputs are read through element strides, so the model's
// (B, T, H, P) activations and the B/C columns of its conv output pass
// without a copy.
//
// Bound on an H100: bytes. x read and y written once (plus B, C, dt and
// the state) take 6.8 µs at zamba2-2.7b's prefill shape (1, 80, 1024,
// 64), N = 64; the chunked form's 2·L·(N + P) + 4·N·P FLOPs a step would
// take 4 µs on the bf16 tensor cores. This kernel does them as f32 FMAs
// on the CUDA cores (67 TFLOP/s, ~60 µs); wgmma is later work.
#include "elem.cuh"

namespace {

constexpr int L = 64;     // steps per chunk
constexpr int NT = 256;   // threads per CTA: one 4×4 tile each of (L, L)

size_t smem_floats(int P, int N) {
    return (size_t)L * P + 2 * (size_t)N * L + (size_t)L * L
           + (size_t)N * P + 4 * L;
}

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

template <typename TX, typename TB>
__global__ void __launch_bounds__(NT)
ssd_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a_log, const TB* __restrict__ Bm,
           const TB* __restrict__ Cm, const float* __restrict__ s0,
           TX* __restrict__ y, float* __restrict__ s_out, int H, int steps,
           int P, int N, long long xsb, long long xsh, long long xst,
           long long dsb, long long dsh, long long dst, long long bsb,
           long long bst, long long csb, long long cst, long long ysb,
           long long ysh, long long yst) {
    extern __shared__ float4 smem4[];
    float* xs = reinterpret_cast<float*>(smem4);   // [L][P]  x̃
    float* bt = xs + L * P;                        // [N][L]  Bᵀ
    float* ct = bt + N * L;                        // [N][L]  Cᵀ
    float* mt = ct + N * L;                        // [L][L]  M[i][j] at [j][i]
    float* st = mt + L * L;                        // [N][P]  Sᵀ
    float* dts = st + N * P;                       // [L]
    float* cum = dts + L;                          // [L]
    float* ecum = cum + L;                         // [L] exp(cum)
    float* dend = ecum + L;                        // [L] exp(cum_end - cum)

    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const TX* xp = x + b * xsb + h * xsh;
    const float* dp = dt + b * dsb + h * dsh;
    const TB* bp = Bm + b * bsb;
    const TB* cp = Cm + b * csb;
    TX* yp = y + b * ysb + h * ysh;
    const long long sbase = ((long long)b * H + h) * P * N;
    const float a = -expf(a_log[h]);

    for (int i = tid; i < N * P; i += NT) {
        const int p = i / N, n = i % N;
        st[n * P + p] = s0 ? s0[sbase + i] : 0.0f;
    }
    const int P4 = P / 4, N4 = N / 4;
    for (int t0 = 0; t0 < steps; t0 += L) {
        const int nv = min(L, steps - t0);
        __syncthreads();   // the previous chunk is consumed
        // every global load of the chunk at once: dt, Bᵀ, Cᵀ and raw x
        for (int i = tid; i < L; i += NT)
            dts[i] = i < nv ? dp[(t0 + i) * dst] : 0.0f;
        for (int i = tid; i < L * N; i += NT) {
            // j fastest across lanes: the transposed stores hit distinct
            // banks (the rows' global loads are strided, from L2)
            const int j = i % L, n = i / L;
            const bool in = j < nv;
            bt[n * L + j] = in ? elem::to_f32(bp[(t0 + j) * bst + n]) : 0.0f;
            ct[n * L + j] = in ? elem::to_f32(cp[(t0 + j) * cst + n]) : 0.0f;
        }
        for (int i = tid; i < L * P; i += NT) {
            const int j = i / P, p = i % P;
            xs[i] = j < nv ? elem::to_f32(xp[(t0 + j) * xst + p]) : 0.0f;
        }
        __syncthreads();
        if (tid == 0) {
            // sequential, as the reference's cumsum: neighbouring steps
            // share their prefix to the bit, so the differences
            // cum_i − cum_j that weight the nearest steps most keep
            // their precision (a tree scan rounds each cum apart)
            float c = 0.0f;
#pragma unroll
            for (int i = 0; i < L; ++i) {
                c += dts[i] * a;
                cum[i] = c;
            }
        }
        for (int i = tid; i < L * P; i += NT) xs[i] *= dts[i / P];
        __syncthreads();
        for (int i = tid; i < L; i += NT) {
            ecum[i] = expf(cum[i]);
            dend[i] = expf(cum[L - 1] - cum[i]);
        }

        // M = (C·Bᵀ) ⊙ exp(cum_i − cum_j), causal; thread tile rows
        // i0..i0+3 (ti fastest across lanes), cols j0..j0+3
        {
            const int i0 = 4 * (tid % (L / 4)), j0 = 4 * (tid / (L / 4));
            float acc[4][4] = {};
            if (j0 <= i0 + 3) {
#pragma unroll 4
                for (int n = 0; n < N; ++n) {
                    const float4 ci = ld4(ct + n * L + i0);
                    const float4 bj = ld4(bt + n * L + j0);
                    const float cv[4] = {ci.x, ci.y, ci.z, ci.w};
                    const float bv[4] = {bj.x, bj.y, bj.z, bj.w};
#pragma unroll
                    for (int r = 0; r < 4; ++r)
#pragma unroll
                        for (int c = 0; c < 4; ++c)
                            acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
                }
            }
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int j = j0 + c;
                float m[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const int i = i0 + r;
                    m[r] = j <= i ? acc[r][c] * expf(cum[i] - cum[j]) : 0.0f;
                }
                *reinterpret_cast<float4*>(mt + j * L + i0) =
                    make_float4(m[0], m[1], m[2], m[3]);
            }
        }
        __syncthreads();

        // y = M·x̃ + exp(cum)·(C·Sᵀ): tiles (i0.., p0..), p fastest
        for (int tile = tid; tile < (L / 4) * P4; tile += NT) {
            const int i0 = 4 * (tile / P4), p0 = 4 * (tile % P4);
            if (i0 >= nv) continue;
            float in_[4][4] = {}, ex[4][4] = {};
#pragma unroll 4
            for (int j = 0; j < min(i0 + 4, nv); ++j) {
                const float4 mj = ld4(mt + j * L + i0);
                const float4 xj = ld4(xs + j * P + p0);
                const float mv[4] = {mj.x, mj.y, mj.z, mj.w};
                const float xv[4] = {xj.x, xj.y, xj.z, xj.w};
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        in_[r][c] = fmaf(mv[r], xv[c], in_[r][c]);
            }
#pragma unroll 4
            for (int n = 0; n < N; ++n) {
                const float4 cn = ld4(ct + n * L + i0);
                const float4 sn = ld4(st + n * P + p0);
                const float cv[4] = {cn.x, cn.y, cn.z, cn.w};
                const float sv[4] = {sn.x, sn.y, sn.z, sn.w};
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        ex[r][c] = fmaf(cv[r], sv[c], ex[r][c]);
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int i = i0 + r;
                if (i >= nv) break;
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    elem::store(in_[r][c] + ecum[i] * ex[r][c],
                                yp + (t0 + i) * yst + p0 + c);
            }
        }
        __syncthreads();

        // Sᵀ ← exp(cum_end)·Sᵀ + Bᵀ·(dend ⊙ x̃): tiles (n0.., p0..)
        const float gamma = expf(cum[L - 1]);
        for (int tile = tid; tile < N4 * P4; tile += NT) {
            const int n0 = 4 * (tile / P4), p0 = 4 * (tile % P4);
            float acc[4][4] = {};
#pragma unroll 4
            for (int j = 0; j < nv; ++j) {
                const float4 xj = ld4(xs + j * P + p0);
                const float d = dend[j];
                const float xv[4] = {xj.x * d, xj.y * d, xj.z * d, xj.w * d};
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const float bv = bt[(n0 + r) * L + j];
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        acc[r][c] = fmaf(bv, xv[c], acc[r][c]);
                }
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                float* row = st + (n0 + r) * P + p0;
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    row[c] = fmaf(gamma, row[c], acc[r][c]);
            }
        }
    }
    __syncthreads();
    for (int i = tid; i < N * P; i += NT) {
        const int p = i / N, n = i % N;
        s_out[sbase + i] = st[n * P + p];
    }
}

template <typename TX, typename TB>
int launch(const void* x, const void* dt, const void* a_log, const void* Bm,
           const void* Cm, const void* s0, void* y, void* s_out, int B,
           int H, int steps, int P, int N, const long long* st,
           cudaStream_t stream) {
    const size_t bytes = smem_floats(P, N) * 4;
    if (bytes > 232448) return (int)cudaErrorInvalidValue;
    auto kern = ssd_kernel<TX, TB>;
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(H, B);
    kern<<<grid, NT, bytes, stream>>>(
        (const TX*)x, (const float*)dt, (const float*)a_log, (const TB*)Bm,
        (const TB*)Cm, (const float*)s0, (TX*)y, (float*)s_out, H, steps, P,
        N, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
        st[9], st[10], st[11], st[12]);
    return (int)cudaGetLastError();
}

}  // namespace

// dtypes: 0 f32 x and B/C, 1 bf16 x and B/C, 2 bf16 x with f32 B/C (y
// in x's dtype; dt, a_log and the states are f32). P and N are
// multiples of 4. strides: 13 element strides — (batch, head, time) of
// x and of dt, (batch, time) of B and of C, (batch, head, time) of y;
// the last dimension of x, B, C and y is contiguous. a_log is (H,);
// s0 (nullable) and s_out are contiguous (B, H, P, N).
extern "C" int ssd_fwd(int dtypes, const void* x, const void* dt,
                       const void* a_log, const void* Bm, const void* Cm,
                       const void* s0, void* y, void* s_out, int B, int H,
                       int steps, int P, int N, const void* strides,
                       void* stream) {
    if (B == 0 || H == 0) return 0;
    if (P % 4 || N % 4 || P <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
    const long long* st = (const long long*)strides;
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtypes) {
        case 0: return launch<float, float>(x, dt, a_log, Bm, Cm, s0, y, s_out,
                                            B, H, steps, P, N, st, s);
        case 1: return launch<__nv_bfloat16, __nv_bfloat16>(
            x, dt, a_log, Bm, Cm, s0, y, s_out, B, H, steps, P, N, st, s);
        case 2: return launch<__nv_bfloat16, float>(
            x, dt, a_log, Bm, Cm, s0, y, s_out, B, H, steps, P, N, st, s);
    }
    return (int)cudaErrorInvalidValue;
}
