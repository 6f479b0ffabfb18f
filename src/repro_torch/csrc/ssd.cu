// K7 ssd: the Mamba-2 SSD chunk scan. Per (b, h), with the (P, N) f32
// state S, a = -exp(a_log[h]), x̃_t = dt_t·x_t and cum the running sum
// of dt·a inside a chunk of L = 64 steps:
//   intra  y_i  = Σ_{j≤i} exp(cum_i − cum_j)·(C_i·B_j)·x̃_j
//   inter  y_i += exp(cum_i)·C_i·S_prevᵀ
//   state  S    ← exp(cum_end)·S + Σ_j exp(cum_end − cum_j)·x̃_j B_jᵀ.
//
// Replaces the Pallas kernel ssd._kernel / ssd_forward of
// src/repro/kernels/ssd.py, which walks the chunks of one (b, h) in
// order (a TPU grid runs in order on one core) with the state in VMEM
// scratch. Only the state hand-off between chunks is sequential, so here
// one call is three launches (arXiv:2405.21060 §6):
//   1. summary, a CTA per (chunk, head, batch): the chunk's state update
//      from zero, S_c = (x̃ ⊙ exp(cum_end − cum))ᵀ·B (P × N), and its
//      decay γ_c = exp(cum_end), into the caller's f32 scratch;
//   2. the state pass (chunked.cuh), a thread per 4 state elements:
//      S_prev(c+1) = γ_c·S_prev(c) + S_c from the initial state, each
//      chunk's start state written over its S_c, the last one to s_out;
//   3. output, a CTA per (chunk, head, batch): M = (C·Bᵀ) ⊙ exp(cum_i −
//      cum_j) (causal), y = exp(cum)·(C·S_prevᵀ) + M·x̃, stored in x's
//      dtype.
// A CTA's four warps own 16 rows each. Its chunk of x, B and C is
// copied to shared memory with cp.async as it is (zero past the end and
// in the padding to 16 columns); dt and the decays are applied where the
// products read their operands. With bf16 x and B/C (the model's path)
// the products run on the tensor cores (mma.sync m16n8k16, operands
// through ldmatrix, f32 accumulators): C·Bᵀ takes the bf16 inputs as they
// are and stays in registers, where the mask, dt and the decays turn it
// into the A operand of its product with x; the computed operands (that
// one, dt·decay·B in the summary, S_prev) are split into two bf16 parts
// (16 significant bits; one bf16 part missed the 2e-2 check), so each
// such product is two. With f32 x or f32 B/C the products are f32 FMAs
// on the CUDA cores. The cumulative decay is a sequential sum in one
// thread, as the reference's cumsum is: neighbours share their prefix to
// the bit, so the differences cum_i − cum_j keep their precision (a tree
// scan doubled the error). A ragged last chunk
// is masked (dt = 0 and x = B = C = 0 past the end: it decays nothing
// and adds nothing), so any T works; the chunk is the kernel's own.
// Inputs are read through element strides, so the model's (B, T, H, P)
// activations and the B/C columns of its conv output pass as views.
//
// Bound on an H100: bytes. x read and y written once (plus B, C, dt and
// the state) take 6.8 µs at zamba2-2.7b's prefill shape (1, 80, 1024,
// 64), N = 64; the products' 2·L·(N + P) + 4·N·P FLOPs a step take
// about 4 µs on the bf16 tensor cores (twice that with the split
// operands). What bounds this design is the f32 scratch between its
// phases (16 KB a chunk at P = N = 64): written, read, written again and
// read, 84 MB a call at that shape, 3.7 times its inputs and outputs.
#include "chunked.cuh"

namespace {

constexpr int L = 64;     // steps per chunk
constexpr int NT = 128;   // four warps of 16 rows
using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }

struct Geometry {         // shared-memory row strides (elements)
    int PP, NP;           // P and N padded to 16
    int xs, bs, ms, ss;   // x and B/C rows, M rows, f32 S_prev rows
    __host__ __device__ Geometry(int P, int N)
        : PP(pad16(P)), NP(pad16(N)), xs(PP + 8), bs(NP + 8), ms(L + 4),
          ss(NP + 4) {}
};

// Consecutive 16-byte aligned regions of shared memory.
struct Carve {
    char* base;
    size_t off = 0;
    template <typename T>
    __host__ __device__ T* take(size_t n) {
        T* p = reinterpret_cast<T*>(base + off);
        off += chunked::align16(n * sizeof(T));
        return p;
    }
};

// Shared memory of both kernels. TCK (the tensor-core kernels, bf16 x and
// B/C): the summary splits dt·decay·B into bf16 parts (hi, lo), the
// output S_prev, and the output's y rows pass through yt on their way to
// 16-byte stores; else (f32 FMAs) the output keeps M and S_prev in f32
// (mt, sp).
template <typename TX, typename TB, bool TCK, bool OUT>
struct Smem {
    TX* xr;
    TB *br, *cr;
    bf16 *hi, *lo, *yt;                 // yt: the output's y rows
    float *mt, *sp, *dts, *cum, *aux;   // aux: w1 (summary), ecum (output)
    size_t bytes;
    __host__ __device__ Smem(char* base, const Geometry& G) {
        Carve c{base};
        xr = c.take<TX>(L * G.xs);
        br = c.take<TB>(L * G.bs);
        cr = OUT ? c.take<TB>(L * G.bs) : nullptr;
        const int hrows = OUT ? G.PP : L;
        hi = TCK ? c.take<bf16>(hrows * G.bs) : nullptr;
        lo = TCK ? c.take<bf16>(hrows * G.bs) : nullptr;
        yt = TCK && OUT ? c.take<bf16>(L * G.xs) : nullptr;
        mt = !TCK && OUT ? c.take<float>(L * G.ms) : nullptr;
        sp = !TCK && OUT ? c.take<float>(G.PP * G.ss) : nullptr;
        dts = c.take<float>(L);
        cum = c.take<float>(L);
        aux = c.take<float>(L);
        bytes = c.off;
    }
};

struct Args {
    const void* x; const float* dt; const float* a_log; const void* Bm;
    const void* Cm; void* y; float* buf; float* dec;
    int H, steps, P, N, nc;
    long long xsb, xsh, xst, dsb, dsh, dst, bsb, bst, csb, cst, ysb, ysh,
        yst;
    int vecx, vecb, vecc, vecy;
};

// The chunk's dt (zero past the end) and, in one thread, its cumulative
// decay, summed in registers; returns after a barrier.
__device__ __forceinline__ void chunk_decay(const Args& A, float* dts,
                                            float* cum, int b, int h,
                                            int t0, int nv) {
    const float* dp = A.dt + b * A.dsb + h * A.dsh;
    for (int i = threadIdx.x; i < L; i += NT)
        dts[i] = i < nv ? dp[(t0 + i) * A.dst] : 0.0f;
    __syncthreads();
    if (threadIdx.x == 0) {
        const float a = -expf(A.a_log[h]);
        float v[L];
#pragma unroll
        for (int i = 0; i < L; i += 4)
            *reinterpret_cast<float4*>(v + i) =
                *reinterpret_cast<const float4*>(dts + i);
        float c = 0.0f;
#pragma unroll
        for (int i = 0; i < L; ++i) {
            c += v[i] * a;
            v[i] = c;
        }
#pragma unroll
        for (int i = 0; i < L; i += 4)
            *reinterpret_cast<float4*>(cum + i) =
                *reinterpret_cast<const float4*>(v + i);
    }
    __syncthreads();
}

// ---- phase 1: S_c = Σ_j x_j ⊗ (dt_j·exp(cum_end − cum_j)·B_j), γ_c
template <typename TX, typename TB, bool TCK>
__global__ void __launch_bounds__(NT) ssd_summary_kernel(Args A) {
    extern __shared__ float4 smem4[];
    const Geometry G(A.P, A.N);
    const Smem<TX, TB, TCK, false> S(reinterpret_cast<char*>(smem4), G);
    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int t0 = c * L, nv = min(L, A.steps - t0);
    chunked::stage_rows<TX, NT>(
        S.xr, G.xs, (const TX*)A.x + b * A.xsb + h * A.xsh + t0 * A.xst,
        A.xst, L, nv, A.P, G.PP, A.vecx);
    chunked::stage_rows<TB, NT>(S.br, G.bs,
                                (const TB*)A.Bm + b * A.bsb + t0 * A.bst,
                                A.bst, L, nv, A.N, G.NP, A.vecb);
    wg::cp_async_commit();
    chunk_decay(A, S.dts, S.cum, b, h, t0, nv);
    const long long bhc = ((long long)b * A.H + h) * A.nc + c;
    float* w1 = S.aux;
    for (int i = threadIdx.x; i < L; i += NT)
        w1[i] = S.dts[i] * expf(S.cum[L - 1] - S.cum[i]);
    if (threadIdx.x == 0) A.dec[bhc] = expf(S.cum[L - 1]);
    wg::cp_async_wait<0>();
    __syncthreads();

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, q = lane & 3;
    float* out = A.buf + bhc * A.P * A.N;
    // the (P × N) tile: rows p, a warp per 16 of them; column pairs n, n + 1
    auto store = [&](const float (&acc)[4], int m0, int n) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int p = m0 + g + 8 * half;
            if (p < A.P && n < A.N)
                *reinterpret_cast<float2*>(out + p * A.N + n) =
                    make_float2(acc[2 * half], acc[2 * half + 1]);
        }
    };
    if constexpr (TCK) {
        // dt·decay·B as two bf16 parts: the B operand
        const int np = G.NP / 2;
        for (int i = threadIdx.x; i < L * np; i += NT) {
            const int j = i / np, n = 2 * (i % np);
            uint32_t hv, lv;
            chunked::split(elem::to_f32(S.br[j * G.bs + n]) * w1[j],
                           elem::to_f32(S.br[j * G.bs + n + 1]) * w1[j], hv,
                           lv);
            *reinterpret_cast<uint32_t*>(S.hi + j * G.bs + n) = hv;
            *reinterpret_cast<uint32_t*>(S.lo + j * G.bs + n) = lv;
        }
        __syncthreads();
        for (int m0 = 16 * warp; m0 < G.PP; m0 += 16 * (NT / 32)) {
            for (int n0 = 0; n0 < G.NP; n0 += 64) {
                const int npn = min(4, (G.NP - n0) / 16);   // column pairs
                float acc[8][4] = {};
#pragma unroll
                for (int k0 = 0; k0 < L; k0 += 16) {
                    uint32_t a[4];
                    chunked::load_a<true>(a, S.xr, G.xs, m0, k0);
#pragma unroll
                    for (int np = 0; np < 4; ++np) {
                        if (np >= npn) break;
                        uint32_t bh[4], bl[4];
                        chunked::load_b2<true>(bh, S.hi, G.bs, n0 + 16 * np,
                                               k0);
                        chunked::load_b2<true>(bl, S.lo, G.bs, n0 + 16 * np,
                                               k0);
                        chunked::mma_bf16(acc[2 * np], a, bh[0], bh[1]);
                        chunked::mma_bf16(acc[2 * np + 1], a, bh[2], bh[3]);
                        chunked::mma_bf16(acc[2 * np], a, bl[0], bl[1]);
                        chunked::mma_bf16(acc[2 * np + 1], a, bl[2], bl[3]);
                    }
                }
#pragma unroll
                for (int nb = 0; nb < 8; ++nb)
                    if (nb < 2 * npn) store(acc[nb], m0, n0 + 8 * nb + 2 * q);
            }
        }
    } else {
        for (int m0 = 16 * warp; m0 < G.PP; m0 += 16 * (NT / 32)) {
            for (int n0 = 0; n0 < G.NP; n0 += 64) {
                const int nbn = min(8, (G.NP - n0) / 8);
                float acc[8][4] = {};
                chunked::warp_fma(
                    acc, nbn, 0, L,
                    [&](int r, int k) {
                        return elem::to_f32(S.xr[k * G.xs + m0 + r]) * w1[k];
                    },
                    [&](int k, int j) {
                        return elem::to_f32(S.br[k * G.bs + n0 + j]);
                    });
#pragma unroll
                for (int nb = 0; nb < 8; ++nb)
                    if (nb < nbn) store(acc[nb], m0, n0 + 8 * nb + 2 * q);
            }
        }
    }
}

// ---- phase 3: y = exp(cum)·(C·S_prevᵀ) + (M·diag(dt))·x, M causal
template <typename TX, typename TB, bool TCK>
__global__ void __launch_bounds__(NT) ssd_output_kernel(Args A) {
    extern __shared__ float4 smem4[];
    const Geometry G(A.P, A.N);
    const Smem<TX, TB, TCK, true> S(reinterpret_cast<char*>(smem4), G);
    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int t0 = c * L, nv = min(L, A.steps - t0);
    const long long bhc = ((long long)b * A.H + h) * A.nc + c;
    const float* sprev = A.buf + bhc * A.P * A.N;
    chunked::stage_rows<TX, NT>(
        S.xr, G.xs, (const TX*)A.x + b * A.xsb + h * A.xsh + t0 * A.xst,
        A.xst, L, nv, A.P, G.PP, A.vecx);
    chunked::stage_rows<TB, NT>(S.br, G.bs,
                                (const TB*)A.Bm + b * A.bsb + t0 * A.bst,
                                A.bst, L, nv, A.N, G.NP, A.vecb);
    chunked::stage_rows<TB, NT>(S.cr, G.bs,
                                (const TB*)A.Cm + b * A.csb + t0 * A.cst,
                                A.cst, L, nv, A.N, G.NP, A.vecc);
    if constexpr (TCK) {
        // S_prev (P × N, f32) as two bf16 parts, zero in the padding
        // (its loads issued in batches of 8, ahead of the batch's stores)
        constexpr int AHEAD = 8;
        const int np = G.NP / 2;
        for (int i0 = threadIdx.x; i0 < G.PP * np; i0 += AHEAD * NT) {
            float2 v[AHEAD];
#pragma unroll
            for (int u = 0; u < AHEAD; ++u) {
                const int i = i0 + u * NT, p = i / np, n = 2 * (i % np);
                v[u] = p < A.P && n < A.N
                           ? *reinterpret_cast<const float2*>(sprev + p * A.N
                                                              + n)
                           : make_float2(0.f, 0.f);
            }
#pragma unroll
            for (int u = 0; u < AHEAD; ++u) {
                const int i = i0 + u * NT, p = i / np, n = 2 * (i % np);
                if (p >= G.PP) break;
                uint32_t hv, lv;
                chunked::split(v[u].x, v[u].y, hv, lv);
                *reinterpret_cast<uint32_t*>(S.hi + p * G.bs + n) = hv;
                *reinterpret_cast<uint32_t*>(S.lo + p * G.bs + n) = lv;
            }
        }
    } else {
        chunked::stage_rows<float, NT>(S.sp, G.ss, sprev, A.N, G.PP, A.P,
                                       A.N, G.NP, true);
    }
    wg::cp_async_commit();
    chunk_decay(A, S.dts, S.cum, b, h, t0, nv);
    float* ecum = S.aux;
    for (int i = threadIdx.x; i < L; i += NT) ecum[i] = expf(S.cum[i]);
    wg::cp_async_wait<0>();
    __syncthreads();

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, q = lane & 3;
    const int m0 = 16 * warp;
    const float* dts = S.dts;
    const float* cum = S.cum;
    // M·diag(dt) at row i, column j of the causal chunk
    auto mval = [&](float cb, int i, int j) {
        return j <= i ? cb * dts[j] * expf(cum[i] - cum[j]) : 0.0f;
    };
    TX* yp = (TX*)A.y + b * A.ysb + h * A.ysh;
    auto store = [&](const float (&acc)[4], int p) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int i = m0 + g + 8 * (e / 2);
            if (i < nv && p + e % 2 < A.P)
                elem::store(acc[e], yp + (t0 + i) * A.yst + p + e % 2);
        }
    };
    const float e_lo = ecum[m0 + g], e_hi = ecum[m0 + g + 8];
    if constexpr (TCK) {
        // C·Bᵀ over the warp's rows and columns 0 .. m0 + 15, in registers
        float cb[8][4] = {};
        for (int k0 = 0; k0 < G.NP; k0 += 16) {
            uint32_t a[4];
            chunked::load_a<false>(a, S.cr, G.bs, m0, k0);
#pragma unroll
            for (int np = 0; np < 4; ++np) {
                if (np > warp) break;
                uint32_t bb[4];
                chunked::load_b2<false>(bb, S.br, G.bs, 16 * np, k0);
                chunked::mma_bf16(cb[2 * np], a, bb[0], bb[1]);
                chunked::mma_bf16(cb[2 * np + 1], a, bb[2], bb[3]);
            }
        }
        // M·diag(dt) as the A operand of its product with x, in two parts
        uint32_t mh[4][4], ml[4][4];
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) {
            if (kb > warp) break;
#pragma unroll
            for (int f = 0; f < 4; ++f) {   // a0..a3: (row half, col half)
                const int blk = 2 * kb + f / 2, rh = f % 2;
                const int i = m0 + g + 8 * rh, j = 8 * blk + 2 * q;
                chunked::split(mval(cb[blk][2 * rh], i, j),
                               mval(cb[blk][2 * rh + 1], i, j + 1), mh[kb][f],
                               ml[kb][f]);
            }
        }
        // 64 columns of y at a time: eight accumulators side by side, so
        // that the products of one k step do not wait on each other
        for (int p0 = 0; p0 < G.PP; p0 += 64) {
            const int npn = min(4, (G.PP - p0) / 16);   // column pairs
            float acc[8][4] = {};
            for (int k0 = 0; k0 < G.NP; k0 += 16) {
                uint32_t a[4];
                chunked::load_a<false>(a, S.cr, G.bs, m0, k0);
#pragma unroll
                for (int np = 0; np < 4; ++np) {
                    if (np >= npn) break;
                    uint32_t sh[4], sl[4];
                    chunked::load_b2<false>(sh, S.hi, G.bs, p0 + 16 * np, k0);
                    chunked::load_b2<false>(sl, S.lo, G.bs, p0 + 16 * np, k0);
                    chunked::mma_bf16(acc[2 * np], a, sh[0], sh[1]);
                    chunked::mma_bf16(acc[2 * np + 1], a, sh[2], sh[3]);
                    chunked::mma_bf16(acc[2 * np], a, sl[0], sl[1]);
                    chunked::mma_bf16(acc[2 * np + 1], a, sl[2], sl[3]);
                }
            }
#pragma unroll
            for (int nb = 0; nb < 8; ++nb) {
                acc[nb][0] *= e_lo; acc[nb][1] *= e_lo;
                acc[nb][2] *= e_hi; acc[nb][3] *= e_hi;
            }
#pragma unroll
            for (int kb = 0; kb < 4; ++kb) {
                if (kb > warp) break;
#pragma unroll
                for (int np = 0; np < 4; ++np) {
                    if (np >= npn) break;
                    uint32_t xb[4];
                    chunked::load_b2<true>(xb, S.xr, G.xs, p0 + 16 * np,
                                           16 * kb);
                    chunked::mma_bf16(acc[2 * np], mh[kb], xb[0], xb[1]);
                    chunked::mma_bf16(acc[2 * np + 1], mh[kb], xb[2], xb[3]);
                    chunked::mma_bf16(acc[2 * np], ml[kb], xb[0], xb[1]);
                    chunked::mma_bf16(acc[2 * np + 1], ml[kb], xb[2], xb[3]);
                }
            }
            // the warp's 16 rows × 64 columns, through shared memory, as
            // 16-byte stores of whole row pieces
            bf16* yw = S.yt + m0 * G.xs;
#pragma unroll
            for (int nb = 0; nb < 8; ++nb) {
                if (nb >= 2 * npn) break;
#pragma unroll
                for (int half = 0; half < 2; ++half)
                    *reinterpret_cast<__nv_bfloat162*>(
                        yw + (g + 8 * half) * G.xs + 8 * nb + 2 * q) =
                        __floats2bfloat162_rn(acc[nb][2 * half],
                                              acc[nb][2 * half + 1]);
            }
            __syncwarp();
            for (int u = lane; u < 16 * 2 * npn; u += 32) {
                const int row = u / (2 * npn), c8 = 8 * (u % (2 * npn));
                const int i = m0 + row, p = p0 + c8;
                if (i >= nv || p >= A.P) continue;
                TX* dst = yp + (t0 + i) * A.yst + p;
                const bf16* src = yw + row * G.xs + c8;
                if (A.vecy && p + 8 <= A.P)
                    *reinterpret_cast<uint4*>(dst) =
                        *reinterpret_cast<const uint4*>(src);
                else
                    for (int e = 0; e < 8 && p + e < A.P; ++e) dst[e] = src[e];
            }
            __syncwarp();
        }
    } else {
        auto crow = [&](int r, int k) {
            return elem::to_f32(S.cr[(m0 + r) * G.bs + k]);
        };
        {   // M·diag(dt), causal: the warp's rows, columns 0 .. m0 + 15
            const int nbn = 2 * warp + 2;
            float acc[8][4] = {};
            chunked::warp_fma(acc, nbn, 0, G.NP, crow, [&](int k, int j) {
                return elem::to_f32(S.br[j * G.bs + k]);
            });
#pragma unroll
            for (int nb = 0; nb < 8; ++nb) {
                if (nb >= nbn) continue;
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int i = m0 + g + 8 * (e / 2);
                    const int j = 8 * nb + 2 * q + (e % 2);
                    S.mt[i * G.ms + j] = mval(acc[nb][e], i, j);
                }
            }
        }
        __syncwarp();   // a warp reads only its own rows of M
        for (int p0 = 0; p0 < G.PP; p0 += 64) {
            const int nbn = min(8, (G.PP - p0) / 8);
            float acc[8][4] = {};
            chunked::warp_fma(acc, nbn, 0, G.NP, crow, [&](int k, int j) {
                return S.sp[(p0 + j) * G.ss + k];
            });
#pragma unroll
            for (int nb = 0; nb < 8; ++nb) {
                acc[nb][0] *= e_lo; acc[nb][1] *= e_lo;
                acc[nb][2] *= e_hi; acc[nb][3] *= e_hi;
            }
            chunked::warp_fma(
                acc, nbn, 0, m0 + 16,
                [&](int r, int k) { return S.mt[(m0 + r) * G.ms + k]; },
                [&](int k, int j) {
                    return elem::to_f32(S.xr[k * G.xs + p0 + j]);
                });
#pragma unroll
            for (int nb = 0; nb < 8; ++nb)
                if (nb < nbn) store(acc[nb], p0 + 8 * nb + 2 * q);
        }
    }
}

template <typename Kern>
int set_smem(Kern kern, size_t bytes) {
    if (bytes > 232448) return (int)cudaErrorInvalidValue;
    return (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename TX, typename TB, bool TCK>
int launch(Args A, const float* s0, float* s_out, int B,
           cudaStream_t stream) {
    const Geometry G(A.P, A.N);
    A.vecx = chunked::rows16(A.x, sizeof(TX), A.P, {A.xsb, A.xsh, A.xst});
    A.vecb = chunked::rows16(A.Bm, sizeof(TB), A.N, {A.bsb, A.bst});
    A.vecc = chunked::rows16(A.Cm, sizeof(TB), A.N, {A.csb, A.cst});
    A.vecy = chunked::rows16(A.y, sizeof(TX), 8, {A.ysb, A.ysh, A.yst});
    const dim3 grid(A.nc, A.H, B);
    int e;
    if (A.nc > 0) {
        const size_t bytes = Smem<TX, TB, TCK, false>(nullptr, G).bytes;
        if ((e = set_smem(ssd_summary_kernel<TX, TB, TCK>, bytes))) return e;
        ssd_summary_kernel<TX, TB, TCK><<<grid, NT, bytes, stream>>>(A);
        if ((e = (int)cudaGetLastError())) return e;
    }
    e = chunked::launch_state_pass(A.buf, A.dec, s0, s_out, B * A.H, A.nc,
                                   A.P * A.N, A.N, 1, 0, stream);
    if (e || A.nc == 0) return e;
    const size_t bytes = Smem<TX, TB, TCK, true>(nullptr, G).bytes;
    if ((e = set_smem(ssd_output_kernel<TX, TB, TCK>, bytes))) return e;
    ssd_output_kernel<TX, TB, TCK><<<grid, NT, bytes, stream>>>(A);
    return (int)cudaGetLastError();
}

}  // namespace

// dtypes: 0 f32 x and B/C, 2 bf16 x with f32 B/C (products as f32 FMAs
// on the CUDA cores), 1 bf16 x and B/C (products on the tensor cores); y
// in x's dtype; dt, a_log and the states are f32. P and N are multiples
// of 4 up to 128. strides: 13 element strides — (batch, head, time) of x
// and of dt, (batch, time) of B and of C, (batch, head, time) of y; the
// last dimension of x, B, C and y is contiguous. a_log is (H,); s0
// (nullable) and s_out are contiguous (B, H, P, N). scratch: f32,
// B·H·nc·(P·N + 1) elements with nc = ceil(steps / 64).
extern "C" int ssd_fwd(int dtypes, const void* x, const void* dt,
                       const void* a_log, const void* Bm, const void* Cm,
                       const void* s0, void* y, void* s_out, int B, int H,
                       int steps, int P, int N, void* scratch,
                       const void* strides, void* stream) {
    if (B == 0 || H == 0) return 0;
    if (P % 4 || N % 4 || P <= 0 || N <= 0 || P > 128 || N > 128)
        return (int)cudaErrorInvalidValue;
    const long long* st = (const long long*)strides;
    const int nc = (steps + L - 1) / L;
    float* buf = (float*)scratch;
    Args A{x, (const float*)dt, (const float*)a_log, Bm, Cm, y, buf,
           buf + (long long)B * H * nc * P * N, H, steps, P, N, nc,
           st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
           st[9], st[10], st[11], st[12], 0, 0, 0, 0};
    cudaStream_t s = (cudaStream_t)stream;
    const float* s0f = (const float*)s0;
    float* so = (float*)s_out;
    switch (dtypes) {
        case 0: return launch<float, float, false>(A, s0f, so, B, s);
        case 1: return launch<bf16, bf16, true>(A, s0f, so, B, s);
        case 2: return launch<bf16, float, false>(A, s0f, so, B, s);
    }
    return (int)cudaErrorInvalidValue;
}
