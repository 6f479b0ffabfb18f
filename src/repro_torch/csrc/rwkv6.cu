// K6 rwkv6: the RWKV-6 recurrence with data-dependent per-channel decay.
// Per (b, h), with the (K, V = K) state S:
//   o_t = r_t·(S + diag(u)·k_t v_tᵀ),    S ← diag(w_t)·S + k_t v_tᵀ.
//
// Replaces the Pallas kernel rwkv6._kernel / rwkv6_forward of
// src/repro/kernels/rwkv6.py, which walks the time chunks of one (b, h)
// in order (a TPU grid runs in order on one core) with the (K, K) f32
// state in VMEM scratch. Here the sequence is cut into chunks of L = 64
// steps and only the hand-off of the state between chunks is sequential.
// A chunk's state update from a zero start is one product,
//   ΔS_c = Σ_s diag(E_s)·k_s v_sᵀ = (k ⊙ E)ᵀ·v,  E_s = Π_{τ>s} w_τ,
// and S_{c+1} = diag(P_end)·S_c + ΔS_c with P_end = Π w over the chunk.
// E and P_end are products of decays, so they only shrink toward 0 (the
// right limit of a strong decay): no decay is ever divided by. One call
// is three launches:
//   1. summary, a CTA per (chunk, head, batch): E by a running product
//      per channel from the chunk's end, then ΔS_c on the tensor cores for
//      bf16 inputs (mma.sync m16n8k16; k ⊙ E, computed, split into two
//      bf16 parts; v exact) or as f32 FMAs for f32 inputs; ΔS_c and P_end
//      into the caller's f32 scratch;
//   2. the state pass (chunked.cuh): S_{c+1} = P_end ⊙ S_c + ΔS_c from
//      the initial state, each chunk's start state over its ΔS_c, the
//      last to s_out;
//   3. scan, a CTA per (chunk, head, batch): the recurrence over the
//      chunk from its start state S_c, every chunk at once. The state is
//      split across threads — column v evolves on its own and
//        o_t[v] = Σ_k r_t[k]·S[k, v] + (Σ_k r_t[k]·u[k]·k_t[k])·v_t[v];
//      each thread holds a (K / 8, 4) block of it in registers, 8 lanes
//      to a group of 4 columns, and the 8 lanes' partials of o_t are
//      summed by shuffles; the bonus sums are taken for all steps first, a
//      warp a step. The chunk's r, k, v and w rows are copied to shared
//      memory with cp.async first.
//
// Bound on an H100: bytes, r, k, v and w read and o written once (9.4 µs
// at rwkv6-3b's prefill shape (1, 40, 1024, 64)); the chunked form's
// products would take about 1.4 µs on the bf16 tensor cores. Phase 3's
// recurrence is 5·K² f32 operations a (step, head) (12.5 µs at the f32
// rate) and is what remains serial: L steps in each CTA, with 640 CTAs
// of 4 warps at that shape.
#include "chunked.cuh"

namespace {

constexpr int L = 64;     // steps per chunk
constexpr int SPLIT = 8;  // phase 1: lanes that share state columns
constexpr int CV = 4;     // phase 1: state columns per thread
constexpr unsigned FULL = 0xffffffffu;
using bf16 = __nv_bfloat16;

// N consecutive elements of shared memory widened to f32, through the
// widest aligned vector loads (N·sizeof(T) is 4 bytes or more, and the
// callers' offsets keep it aligned to its own size, up to 16 bytes).
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float* out) {
    constexpr int BYTES = N * int(sizeof(T));
    constexpr int VEC = BYTES % 16 == 0 ? 16 : BYTES % 8 == 0 ? 8 : 4;
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
        else
            *reinterpret_cast<unsigned*>(tmp) =
                reinterpret_cast<const unsigned*>(p)[i];
#pragma unroll
        for (int j = 0; j < PER; ++j) out[i * PER + j] = elem::to_f32(tmp[j]);
    }
}

struct Args {
    const void *r, *k, *v; const float *w, *u; void* o;
    float *ds, *dec;               // scratch: ΔS_c (then S_c), P_end
    int H, steps, nc;
    long long rsb, rsh, rst, ksb, ksh, kst, vsb, vsh, vst, wsb, wsh, wst,
        osb, osh, ost;
};

// Rows [0, n) of a chunk's (L, K) slice of one (b, h) into shared memory
// (row stride ld) with 16-byte cp.async copies; with `zero`, rows [n, L)
// are zero-filled.
template <typename T, int K, int NT>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src,
                                      long long rs, int n, bool zero) {
    constexpr int EL = 16 / int(sizeof(T)), RP = K / EL;
    const int rows = zero ? L : n;
    for (int i = threadIdx.x; i < rows * RP; i += NT) {
        const int t = i / RP, q = (i % RP) * EL;
        wg::cp_async16(wg::smem_addr(dst + t * ld + q),
                       t < n ? src + t * rs + q : src, t < n);
    }
}

// ---- phase 1: ΔS_c = (k ⊙ E)ᵀ·v with E_s = Π_{τ>s} w_τ, and P_end
constexpr int NT1 = 128;

template <typename T, int K>
__host__ __device__ constexpr int summary_bytes() {
    return sizeof(T) == 2 ? L * K * 2 + L * (K + 8) * 2 + L * K * 4
                                + 2 * L * (K + 8) * 2
                          : 2 * L * K * 4 + L * K * 4 + L * (K + 4) * 4;
}

template <typename T, int K>
__global__ void __launch_bounds__(NT1) rwkv6_summary_kernel(Args A) {
    constexpr bool TCK = sizeof(T) == 2;   // bf16: on the tensor cores
    constexpr int VS = TCK ? K + 8 : K;    // row strides of v and of k̃
    constexpr int KS = TCK ? K + 8 : K + 4;
    extern __shared__ float4 smem4[];
    T* ks = reinterpret_cast<T*>(smem4);               // [L][K]
    T* vs = ks + L * K;                                // [L][VS]
    float* ws = reinterpret_cast<float*>(vs + L * VS); // [L][K]
    // k̃ = k ⊙ E: [L][KS] as bf16 high and low parts, or in f32
    bf16* kh = reinterpret_cast<bf16*>(ws + L * K);
    bf16* kl = kh + L * KS;
    float* kf = ws + L * K;

    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x;
    const int t0 = c * L, n = min(L, A.steps - t0);
    const long long bhc = ((long long)b * A.H + h) * A.nc + c;
    stage<T, K, NT1>(ks, K, (const T*)A.k + b * A.ksb + h * A.ksh
                                + t0 * A.kst, A.kst, n, true);
    stage<T, K, NT1>(vs, VS, (const T*)A.v + b * A.vsb + h * A.vsh
                                 + t0 * A.vst, A.vst, n, true);
    stage<float, K, NT1>(ws, K, A.w + b * A.wsb + h * A.wsh + t0 * A.wst,
                         A.wst, n, false);
    wg::cp_async_commit();
    wg::cp_async_wait<0>();
    __syncthreads();
    // a channel a thread, from the chunk's end back: k̃_s = k_s·E_s, and
    // E_{s−1} = w_s·E_s (loads 16 steps ahead); at the start E = P_end
    for (int kk = tid; kk < K; kk += NT1) {
        float e = 1.0f;
        for (int s0 = L - 16; s0 >= 0; s0 -= 16) {
            float kv[16], wv[16];
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                kv[j] = elem::to_f32(ks[(s0 + j) * K + kk]);
                wv[j] = s0 + j < n ? ws[(s0 + j) * K + kk] : 1.0f;
            }
#pragma unroll
            for (int j = 15; j >= 0; --j) {
                const float kt = kv[j] * e;
                const int s = s0 + j;
                if constexpr (TCK) {
                    const bf16 hv = __float2bfloat16(kt);
                    kh[s * KS + kk] = hv;
                    kl[s * KS + kk] =
                        __float2bfloat16(kt - __bfloat162float(hv));
                } else {
                    kf[s * KS + kk] = kt;
                }
                e *= wv[j];
            }
        }
        A.dec[bhc * K + kk] = e;
    }
    __syncthreads();

    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, q = lane & 3;
    float* out = A.ds + bhc * K * K;
    auto store = [&](const float (&acc)[4], int m0, int col) {
#pragma unroll
        for (int half = 0; half < 2; ++half)
            *reinterpret_cast<float2*>(out + (m0 + g + 8 * half) * K + col) =
                make_float2(acc[2 * half], acc[2 * half + 1]);
    };
    for (int m0 = 16 * warp; m0 < K; m0 += 16 * (NT1 / 32)) {
        if constexpr (TCK) {
            // every column block at once: K / 8 accumulators side by side
            float acc[K / 8][4] = {};
#pragma unroll
            for (int s0 = 0; s0 < L; s0 += 16) {
                uint32_t ah[4], al[4];
                chunked::load_a<true>(ah, kh, KS, m0, s0);
                chunked::load_a<true>(al, kl, KS, m0, s0);
#pragma unroll
                for (int n0 = 0; n0 < K; n0 += 16) {
                    uint32_t bv[4];
                    chunked::load_b2<true>(bv, vs, VS, n0, s0);
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        float (&d)[4] = acc[n0 / 8 + j];
                        chunked::mma_bf16(d, ah, bv[2 * j], bv[2 * j + 1]);
                        chunked::mma_bf16(d, al, bv[2 * j], bv[2 * j + 1]);
                    }
                }
            }
#pragma unroll
            for (int nb = 0; nb < K / 8; ++nb)
                store(acc[nb], m0, 8 * nb + 2 * q);
        } else {
            float acc[K / 8][4] = {};
            chunked::warp_fma(
                acc, K / 8, 0, L,
                [&](int r, int s) { return kf[s * KS + m0 + r]; },
                [&](int s, int j) { return elem::to_f32(vs[s * VS + j]); });
#pragma unroll
            for (int nb = 0; nb < K / 8; ++nb)
                store(acc[nb], m0, 8 * nb + 2 * q);
        }
    }
}

// ---- phase 3: the recurrence over one chunk from its start state S_c
template <typename T, int K>
__host__ __device__ constexpr int scan_bytes() {
    return 3 * L * K * int(sizeof(T)) + L * K * 4 + L * 4;
}

template <typename T, int K>
__global__ void __launch_bounds__(K / CV * SPLIT) rwkv6_scan_kernel(Args A) {
    constexpr int NT = K / CV * SPLIT;
    constexpr int KB = K / SPLIT;   // state rows per thread
    extern __shared__ float4 smem4[];
    T* rs = reinterpret_cast<T*>(smem4);               // [L][K]
    T* ks = rs + L * K;                                // [L][K]
    T* vs = ks + L * K;                                // [L][K]
    float* ws = reinterpret_cast<float*>(vs + L * K);  // [L][K]
    float* bon = ws + L * K;                           // [L] Σ r·u·k

    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x;
    const int part = tid % SPLIT;      // lanes part, part^1, .. share columns
    const int kr = part * KB;          // this thread's first state row
    const int vc = tid / SPLIT * CV;   // its first state column
    const int t0 = c * L;
    const int n = min(L, A.steps - t0);
    const long long bhc = ((long long)b * A.H + h) * A.nc + c;
    stage<T, K, NT>(rs, K, (const T*)A.r + b * A.rsb + h * A.rsh
                               + t0 * A.rst, A.rst, n, false);
    stage<T, K, NT>(ks, K, (const T*)A.k + b * A.ksb + h * A.ksh
                               + t0 * A.kst, A.kst, n, false);
    stage<T, K, NT>(vs, K, (const T*)A.v + b * A.vsb + h * A.vsh
                               + t0 * A.vst, A.vst, n, false);
    stage<float, K, NT>(ws, K, A.w + b * A.wsb + h * A.wsh + t0 * A.wst,
                        A.wst, n, false);
    wg::cp_async_commit();
    float S[KB][CV], uu[KB];
    const float* sc = A.ds + bhc * K * K;
#pragma unroll
    for (int i = 0; i < KB; ++i) {
        uu[i] = A.u[h * K + kr + i];
        const float4 v = *reinterpret_cast<const float4*>(
            sc + (kr + i) * K + vc);
        S[i][0] = v.x; S[i][1] = v.y; S[i][2] = v.z; S[i][3] = v.w;
    }
    wg::cp_async_wait<0>();
    __syncthreads();
    {   // the bonus Σ_k r·u·k of each step: a warp a step
        const int lane = tid % 32;
        for (int t = tid / 32; t < n; t += NT / 32) {
            float x = 0.0f;
            for (int kk = lane; kk < K; kk += 32)
                x = fmaf(elem::to_f32(rs[t * K + kk]) * A.u[h * K + kk],
                         elem::to_f32(ks[t * K + kk]), x);
#pragma unroll
            for (int o = 16; o > 0; o /= 2) x += __shfl_xor_sync(FULL, x, o);
            if (lane == 0) bon[t] = x;
        }
    }
    __syncthreads();

    // after the reduction a lane holds column vc + sel of o_t
    const bool up4 = part & 4, up2 = part & 2;
    const int sel = (up4 ? 2 : 0) + (up2 ? 1 : 0);
    T* op = (T*)A.o + b * A.osb + h * A.osh + t0 * A.ost + vc + sel;
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
        float rr[KB], kk[KB], ww[KB], vv[CV], acc[CV];
        load_f32<T, KB>(rs + t * K + kr, rr);
        load_f32<T, KB>(ks + t * K + kr, kk);
        load_f32<float, KB>(ws + t * K + kr, ww);
        load_f32<T, CV>(vs + t * K + vc, vv);
#pragma unroll
        for (int cc = 0; cc < CV; ++cc) acc[cc] = 0.0f;
#pragma unroll
        for (int i = 0; i < KB; ++i) {
#pragma unroll
            for (int cc = 0; cc < CV; ++cc) {
                acc[cc] = fmaf(rr[i], S[i][cc], acc[cc]);
                S[i][cc] = fmaf(ww[i], S[i][cc], kk[i] * vv[cc]);
            }
        }
        // sum over the 8 lanes of the column group, each lane left with
        // one column (lanes part and part^1 alike)
        float k0 = up4 ? acc[2] : acc[0], k1 = up4 ? acc[3] : acc[1];
        k0 += __shfl_xor_sync(FULL, up4 ? acc[0] : acc[2], 4);
        k1 += __shfl_xor_sync(FULL, up4 ? acc[1] : acc[3], 4);
        float x = up2 ? k1 : k0;
        x += __shfl_xor_sync(FULL, up2 ? k0 : k1, 2);
        x += __shfl_xor_sync(FULL, x, 1);
        if (!(part & 1))
            elem::store(fmaf(bon[t], up4 ? (up2 ? vv[3] : vv[2])
                                         : (up2 ? vv[1] : vv[0]), x),
                        op + t * A.ost);
    }
}

template <typename Kern>
int set_smem(Kern kern, int bytes) {
    if (bytes <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int K>
int launch(const Args& A, const float* s0, float* s_out, int B,
           cudaStream_t stream) {
    constexpr int b1 = summary_bytes<T, K>(), b3 = scan_bytes<T, K>();
    static_assert(b1 <= 232448 && b3 <= 232448,
                  "above the H100's opt-in shared memory");
    const dim3 grid(A.nc, A.H, B);
    int e;
    if (A.nc > 0) {
        if ((e = set_smem(rwkv6_summary_kernel<T, K>, b1))) return e;
        rwkv6_summary_kernel<T, K><<<grid, NT1, b1, stream>>>(A);
        if ((e = (int)cudaGetLastError())) return e;
    }
    e = chunked::launch_state_pass(A.ds, A.dec, s0, s_out, B * A.H, A.nc,
                                   K * K, K, K, 1, stream);
    if (e || A.nc == 0) return e;
    if ((e = set_smem(rwkv6_scan_kernel<T, K>, b3))) return e;
    rwkv6_scan_kernel<T, K><<<grid, K / CV * SPLIT, b3, stream>>>(A);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int K, const Args& A, const float* s0, float* s_out, int B,
             cudaStream_t stream) {
    switch (K) {
        case 16: return launch<T, 16>(A, s0, s_out, B, stream);
        case 32: return launch<T, 32>(A, s0, s_out, B, stream);
        case 64: return launch<T, 64>(A, s0, s_out, B, stream);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype 0: float32 (the chunk summaries as f32 FMAs), 1: bfloat16 (on
// the tensor cores); r, k, v and o alike; w, u and the states are
// float32. strides: 15 element strides, (batch, head, time) for r, k,
// v, w and o in that order; the last dimension is contiguous and every
// row 16-byte aligned. u is contiguous (H, K); s0 (nullable) and s_out
// are contiguous (B, H, K, K). scratch: f32, B·H·nc·(K² + K) elements
// with nc = ceil(steps / 64).
extern "C" int rwkv6_fwd(int dtype, int K, const void* r, const void* k,
                         const void* v, const void* w, const void* u,
                         const void* s0, void* o, void* s_out, int B, int H,
                         int steps, void* scratch, const void* strides,
                         void* stream) {
    if (B == 0 || H == 0) return 0;
    const long long* st = (const long long*)strides;
    const int nc = (steps + L - 1) / L;
    float* ds = (float*)scratch;
    float* dec = ds + (long long)B * H * nc * K * K;
    const Args A{r, k, v, (const float*)w, (const float*)u, o, ds, dec, H,
                 steps, nc, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
                 st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14]};
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return dispatch<float>(K, A, (const float*)s0, (float*)s_out, B, s);
    if (dtype == 1)
        return dispatch<bf16>(K, A, (const float*)s0, (float*)s_out, B, s);
    return (int)cudaErrorInvalidValue;
}
