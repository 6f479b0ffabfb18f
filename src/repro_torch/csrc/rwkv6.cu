// K6 rwkv6: the RWKV-6 recurrence with data-dependent per-channel decay.
// Per (b, h), with the (K, V = K) state S:
//   o_t = r_t·(S + diag(u)·k_t v_tᵀ),    S ← diag(w_t)·S + k_t v_tᵀ.
//
// Replaces the Pallas kernel rwkv6._kernel / rwkv6_forward of
// src/repro/kernels/rwkv6.py. The TPU version walks the time chunks of
// one (b, h) in order and keeps the whole (K, K) f32 state in VMEM
// scratch, one (K,)·(K, K) matvec a step. Here the state is split
// across threads instead: column v of S evolves independently of every
// other column, and
//   o_t[v] = Σ_k r_t[k]·S[k, v] + (Σ_k r_t[k]·u[k]·k_t[k])·v_t[v].
// A CTA owns VB = 16 columns of one (b, h) (grid (K / 16, H, B), so a
// 40-head layer at K = 64 is 160 CTAs on the 132 SMs); its 128 threads
// each hold a (K / 16, 2) block of the state in registers, 16 lanes to
// a column pair. The only serial dependency is one multiply-add per
// state element per step: a thread writes its partial sums of o_t to
// shared memory and the partials are summed once per 32-step chunk, off
// the recurrence, and the step loop is unrolled so that the next steps'
// operands load while this one computes. The chunk's r, k, w and v rows are copied to shared
// memory with cp.async, one chunk ahead, so the loads overlap the
// previous chunk's steps. The decay update rounds as the reference
// does (w·S and k·v each rounded, then added: the build passes
// -fmad=false), so the final state matches the plain version to the
// bit; o is summed in another order.
//
// Bound on an H100: operations, 5·K² f32 operations per (step, head)
// against 67 TFLOP/s (12.5 µs at rwkv6-3b's prefill shape (1, 40, 1024,
// 64), above the 9.4 µs its bytes take). What holds this kernel back is
// that the steps are serial: each CTA does its 16 columns' state
// updates step after step, at one SM's rate.
#include "elem.cuh"

namespace {

constexpr int SPLIT = 16;            // row blocks: lanes that share columns
constexpr int CV = 2;                // state columns per thread
constexpr int VB = 16;               // state columns per CTA
constexpr int NT = VB / CV * SPLIT;  // threads per CTA
constexpr int C = 32;                // time steps per staged chunk

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// N consecutive elements of shared memory widened to f32, through the
// widest aligned vector loads (the callers' offsets keep N·sizeof(T)
// aligned to its own size, up to 16 bytes).
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float* out) {
    constexpr int BYTES = N * int(sizeof(T));
    constexpr int VEC = BYTES % 16 == 0 ? 16
                        : BYTES % 8 == 0 ? 8 : BYTES % 4 == 0 ? 4 : 2;
    constexpr int PER = VEC / int(sizeof(T));
#pragma unroll
    for (int i = 0; i < BYTES / VEC; ++i) {
        alignas(VEC) T tmp[PER];
        if constexpr (VEC == 16)
            *reinterpret_cast<uint4*>(tmp) =
                reinterpret_cast<const uint4*>(p)[i];
        else if constexpr (VEC == 8)
            *reinterpret_cast<uint2*>(tmp) =
                reinterpret_cast<const uint2*>(p)[i];
        else if constexpr (VEC == 4)
            *reinterpret_cast<unsigned*>(tmp) =
                reinterpret_cast<const unsigned*>(p)[i];
        else
            *reinterpret_cast<unsigned short*>(tmp) =
                reinterpret_cast<const unsigned short*>(p)[i];
#pragma unroll
        for (int j = 0; j < PER; ++j) out[i * PER + j] = elem::to_f32(tmp[j]);
    }
}

template <typename T, int K>
__host__ __device__ constexpr int stage_bytes() {
    return C * K * int(sizeof(T)) * 2 + C * K * 4 + C * VB * int(sizeof(T));
}

template <typename T, int K>
__host__ __device__ constexpr int smem_bytes() {
    return 2 * stage_bytes<T, K>() + (C * SPLIT * VB + C * SPLIT) * 4;
}

template <typename T, int K>
__global__ void __launch_bounds__(NT)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ s0,
             T* __restrict__ o, float* __restrict__ s_out, int H,
             int steps, long long rsb, long long rsh, long long rst,
             long long ksb, long long ksh, long long kst, long long vsb,
             long long vsh, long long vst, long long wsb, long long wsh,
             long long wst, long long osb, long long osh, long long ost) {
    constexpr int KB = K / SPLIT;   // state rows per thread
    constexpr int EL = 16 / int(sizeof(T));   // elements per 16 bytes
    extern __shared__ float4 smem4[];
    char* base = reinterpret_cast<char*>(smem4);
    float* op_s = reinterpret_cast<float*>(base + 2 * stage_bytes<T, K>());
    float* bon_s = op_s + C * SPLIT * VB;   // [C][SPLIT]: Σ r·u·k partials

    const int v0 = blockIdx.x * VB;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int tid = threadIdx.x;
    const int part = tid % SPLIT;
    const int cg = tid / SPLIT;
    const int kr = part * KB;          // this thread's first state row
    const int vc = cg * CV;            // its first column in the CTA block
    const T* rp = r + b * rsb + h * rsh;
    const T* kp = k + b * ksb + h * ksh;
    const T* vp = v + b * vsb + h * vsh + v0;
    const float* wp = w + b * wsb + h * wsh;
    T* opp = o + b * osb + h * osh + v0;
    const long long sbase = ((long long)b * H + h) * K * K;

    float S[KB][CV], uu[KB];
#pragma unroll
    for (int i = 0; i < KB; ++i) {
        uu[i] = u[h * K + kr + i];
#pragma unroll
        for (int c = 0; c < CV; ++c)
            S[i][c] = s0 ? s0[sbase + (kr + i) * K + v0 + vc + c] : 0.0f;
    }

    // copy chunk ch's rows into stage st (rows past the end are skipped:
    // the step loop never reads them)
    auto stage_chunk = [&](int ch, int st) {
        const int t0 = ch * C;
        const int n = min(C, steps - t0);
        T* rs = reinterpret_cast<T*>(base + st * stage_bytes<T, K>());
        T* ks = rs + C * K;
        float* ws = reinterpret_cast<float*>(ks + C * K);
        T* vs = reinterpret_cast<T*>(ws + C * K);
        constexpr int RP = K / EL, WP = K / 4, VP = VB / EL;
        for (int i = tid; i < n * RP; i += NT) {
            const int t = i / RP, q = (i % RP) * EL;
            cp_async16(rs + t * K + q, rp + (t0 + t) * rst + q);
            cp_async16(ks + t * K + q, kp + (t0 + t) * kst + q);
        }
        for (int i = tid; i < n * WP; i += NT) {
            const int t = i / WP, q = (i % WP) * 4;
            cp_async16(ws + t * K + q, wp + (t0 + t) * wst + q);
        }
        for (int i = tid; i < n * VP; i += NT) {
            const int t = i / VP, q = (i % VP) * EL;
            cp_async16(vs + t * VB + q, vp + (t0 + t) * vst + q);
        }
        cp_async_commit();
    };

    const int nc = (steps + C - 1) / C;
    if (nc > 0) stage_chunk(0, 0);
    for (int ch = 0; ch < nc; ++ch) {
        if (ch + 1 < nc) {
            stage_chunk(ch + 1, (ch + 1) & 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const T* rs =
            reinterpret_cast<const T*>(base + (ch & 1) * stage_bytes<T, K>());
        const T* ks = rs + C * K;
        const float* ws = reinterpret_cast<const float*>(ks + C * K);
        const T* vs = reinterpret_cast<const T*>(ws + C * K);
        const int t0 = ch * C;
        const int n = min(C, steps - t0);
#pragma unroll 4
        for (int t = 0; t < n; ++t) {
            float rr[KB], kk[KB], ww[KB], vv[CV];
            load_f32<T, KB>(rs + t * K + kr, rr);
            load_f32<T, KB>(ks + t * K + kr, kk);
            load_f32<float, KB>(ws + t * K + kr, ww);
            load_f32<T, CV>(vs + t * VB + vc, vv);
            float bonus = 0.0f, acc[CV];
#pragma unroll
            for (int c = 0; c < CV; ++c) acc[c] = 0.0f;
#pragma unroll
            for (int i = 0; i < KB; ++i) {
                bonus = fmaf(rr[i] * uu[i], kk[i], bonus);
#pragma unroll
                for (int c = 0; c < CV; ++c) {
                    acc[c] = fmaf(rr[i], S[i][c], acc[c]);
                    S[i][c] = ww[i] * S[i][c] + kk[i] * vv[c];
                }
            }
            float* dst = op_s + (t * SPLIT + part) * VB + vc;
#pragma unroll
            for (int c = 0; c < CV; ++c) dst[c] = acc[c];
            if (cg == 0) bon_s[t * SPLIT + part] = bonus;
        }
        __syncthreads();
        for (int i = tid; i < n * VB; i += NT) {
            const int t = i / VB, j = i % VB;
            float a = 0.0f, bsum = 0.0f;
#pragma unroll
            for (int p = 0; p < SPLIT; ++p) {
                a += op_s[(t * SPLIT + p) * VB + j];
                bsum += bon_s[t * SPLIT + p];
            }
            elem::store(fmaf(bsum, elem::to_f32(vs[t * VB + j]), a),
                        opp + (t0 + t) * ost + j);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < KB; ++i)
#pragma unroll
        for (int c = 0; c < CV; ++c)
            s_out[sbase + (kr + i) * K + v0 + vc + c] = S[i][c];
}

template <typename T, int K>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* o, void* s_out, int B,
           int H, int steps, const long long* st, cudaStream_t stream) {
    constexpr int bytes = smem_bytes<T, K>();
    static_assert(bytes <= 232448, "above the H100's opt-in shared memory");
    auto kern = rwkv6_kernel<T, K>;
    if (bytes > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid(K / VB, H, B);
    kern<<<grid, NT, bytes, stream>>>(
        (const T*)r, (const T*)k, (const T*)v, (const float*)w,
        (const float*)u, (const float*)s0, (T*)o, (float*)s_out, H, steps,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
        st[10], st[11], st[12], st[13], st[14]);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int K, const void* r, const void* k, const void* v,
             const void* w, const void* u, const void* s0, void* o,
             void* s_out, int B, int H, int steps, const long long* st,
             cudaStream_t stream) {
    switch (K) {
        case 16: return launch<T, 16>(r, k, v, w, u, s0, o, s_out, B, H,
                                      steps, st, stream);
        case 32: return launch<T, 32>(r, k, v, w, u, s0, o, s_out, B, H,
                                      steps, st, stream);
        case 64: return launch<T, 64>(r, k, v, w, u, s0, o, s_out, B, H,
                                      steps, st, stream);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype 0: float32, 1: bfloat16 (r, k, v and o alike; w, u, the states
// are float32). strides: 15 element strides, (batch, head, time) for r,
// k, v, w and o in that order; the last dimension is contiguous and
// every row 16-byte aligned. u is contiguous (H, K); s0 (nullable) and
// s_out are contiguous (B, H, K, K).
extern "C" int rwkv6_fwd(int dtype, int K, const void* r, const void* k,
                         const void* v, const void* w, const void* u,
                         const void* s0, void* o, void* s_out, int B, int H,
                         int steps, const void* strides, void* stream) {
    if (B == 0 || H == 0) return 0;
    const long long* st = (const long long*)strides;
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return dispatch<float>(K, r, k, v, w, u, s0, o, s_out, B, H, steps,
                               st, s);
    if (dtype == 1)
        return dispatch<__nv_bfloat16>(K, r, k, v, w, u, s0, o, s_out, B, H,
                                       steps, st, s);
    return (int)cudaErrorInvalidValue;
}
