// Building blocks of the chunk-parallel recurrent kernels (K6 rwkv6.cu,
// K7 ssd.cu): warp-level products on the tensor cores (mma.sync with bf16
// operands, a computed f32 operand split into two bf16 parts, and f32
// accumulators) or, on the f32 route, as f32 FMAs on the CUDA cores with
// the same fragment layout; row staging into shared memory; and the state
// pass that carries each chunk's start state across the chunks of one
// (batch, head).
#pragma once
#include <cstdint>
#include <initializer_list>

#include "elem.cuh"
#include "wgmma.cuh"

namespace chunked {

// ---- tensor-core products (mma.sync m16n8k16, bf16 operands, f32
// accumulators). Fragments of lane l (g = l / 4, q = l % 4): A (16 × 16,
// row-major) a0 = (g, 2q..2q+1), a1 = (g + 8, 2q..), a2 = (g, 2q + 8..),
// a3 = (g + 8, 2q + 8..); B (16 × 8) b0 = (k 2q..2q+1, n g), b1 = (k
// 2q + 8.., n g); C/D c0, c1 = (g, 2q..2q+1), c2, c3 = (g + 8, 2q..).
// Operands come from shared memory through ldmatrix (rows of 16 bytes,
// 16-byte aligned), or from registers: a C fragment of 16 columns is the
// A fragment of the next product's 16 k.

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    if constexpr (TRANS)
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0, %1, %2, %3}, [%4];\n"
            : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
            : "r"(wg::smem_addr(p)) : "memory");
    else
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
            "{%0, %1, %2, %3}, [%4];\n"
            : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
            : "r"(wg::smem_addr(p)) : "memory");
}

// The A fragment of rows [r0, r0 + 16) and k [k0, k0 + 16) of a bf16
// tile stored row-major ([row][k], KT false) or k-major ([k][row], KT
// true), row stride ld elements.
template <bool KT>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* t,
                                       int ld, int r0, int k0) {
    const int l = threadIdx.x & 31;
    const int i = l % 8, hi = (l / 8) % 2, kh = l / 16;
    ldsm_x4<KT>(a, KT ? t + (k0 + i + 8 * kh) * ld + r0 + 8 * hi
                      : t + (r0 + i + 8 * hi) * ld + k0 + 8 * kh);
}

// The B fragments of two column blocks [n0, n0 + 8) (b[0], b[1]) and
// [n0 + 8, n0 + 16) (b[2], b[3]) over k [k0, k0 + 16) of a bf16 tile
// stored [n][k] (KT false) or [k][n] (KT true), row stride ld.
template <bool KT>
__device__ __forceinline__ void load_b2(uint32_t (&b)[4], const __nv_bfloat16* t,
                                        int ld, int n0, int k0) {
    const int l = threadIdx.x & 31;
    const int i = l % 8, kh = (l / 8) % 2, nh = l / 16;
    ldsm_x4<KT>(b, KT ? t + (k0 + i + 8 * kh) * ld + n0 + 8 * nh
                      : t + (n0 + i + 8 * nh) * ld + k0 + 8 * kh);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
    return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) ≈ hi + lo, each a bf16 pair (x0 in the low half): 16
// significant bits where one bf16 holds 8 (a computed f32 operand as a
// single bf16 missed 2e-2 on 64-term sums)
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    hi = bits(h);
    lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// ---- the f32 route: acc += A·B as f32 FMAs in the order of k, for one
// warp's 16 × 8·NB tile with the C fragment layout above; k in [k0, k1)
// (a multiple of 8 apart), only the first nbn column blocks (nbn
// warp-uniform). A(r, k): row r (0..15) of the tile; B(k, j): column j.
template <int NB, typename FA, typename FB>
__device__ __forceinline__ void warp_fma(float (&acc)[NB][4], int nbn,
                                         int k0, int k1, FA A, FB B) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    for (int k = k0; k < k1; k += 8) {
#pragma unroll
        for (int kk = k; kk < k + 8; ++kk) {
            const float a0 = A(g, kk), a1 = A(g + 8, kk);
#pragma unroll
            for (int nb = 0; nb < NB; ++nb) {
                if (nb >= nbn) continue;
                const float b0 = B(kk, 8 * nb + 2 * q);
                const float b1 = B(kk, 8 * nb + 2 * q + 1);
                acc[nb][0] = fmaf(a0, b0, acc[nb][0]);
                acc[nb][1] = fmaf(a0, b1, acc[nb][1]);
                acc[nb][2] = fmaf(a1, b0, acc[nb][2]);
                acc[nb][3] = fmaf(a1, b1, acc[nb][3]);
            }
        }
    }
}

template <typename T>
__device__ __forceinline__ T zero() {
    T z;
    elem::store(0.0f, &z);
    return z;
}

// Rows [0, rows) of a (rows, cols_pad) shared-memory tile with row stride
// dstride, from src (row stride sstride, contiguous rows): rows at or
// past `valid` and columns at or past `cols` are zero. vec: 16-byte
// cp.async copies (every source row 16-byte aligned, cols a multiple of
// 16 bytes; the caller commits and waits); else element by element.
template <typename T, int NT>
__device__ __forceinline__ void stage_rows(T* dst, int dstride, const T* src,
                                           long long sstride, int rows,
                                           int valid, int cols, int cols_pad,
                                           bool vec) {
    const int tid = threadIdx.x;
    if (vec) {
        constexpr int EL = 16 / int(sizeof(T));
        const int per = cols_pad / EL;
        for (int i = tid; i < rows * per; i += NT) {
            const int r = i / per, c = (i % per) * EL;
            T* d = dst + r * dstride + c;
            if (c < cols) {
                const bool in = r < valid;
                wg::cp_async16(wg::smem_addr(d), in ? src + r * sstride + c
                                                    : src, in);
            } else {
                *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
            }
        }
    } else {
        for (int i = tid; i < rows * cols_pad; i += NT) {
            const int r = i / cols_pad, c = i % cols_pad;
            dst[r * dstride + c] =
                r < valid && c < cols ? src[r * sstride + c] : zero<T>();
        }
    }
}

// The state pass over the chunks of one (batch, head) = blockIdx.y:
// buf (BH, nc, E) holds each chunk's increment D_c (its state update from
// a zero start) and receives in its place the chunk's start state, as
//   S_0 = s0 (or 0),  S_{c+1} = decay_c ⊙ S_c + D_c,  s_out = S_nc.
// The decay of element e of chunk c is dec[(bh·nc + c)·drow + (e /
// ncol)·dcol] (one scalar a chunk: drow 1, dcol 0; one a state row:
// drow = rows, dcol 1). Four elements a thread; E and ncol multiples
// of 4.
constexpr int PASS_NT = 256;

__global__ void __launch_bounds__(PASS_NT)
state_pass_kernel(float* __restrict__ buf, const float* __restrict__ dec,
                  const float* __restrict__ s0, float* __restrict__ s_out,
                  int nc, int E, int ncol, int drow, int dcol) {
    constexpr int AHEAD = 8;   // chunks whose increments load together
    const int e = 4 * (blockIdx.x * PASS_NT + threadIdx.x);
    if (e >= E) return;
    const long long bh = blockIdx.y;
    float4 s = s0 ? *reinterpret_cast<const float4*>(s0 + bh * E + e)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    float4* p = reinterpret_cast<float4*>(buf + bh * nc * E + e);
    const float* d = dec + bh * nc * drow + (e / ncol) * dcol;
    const long long step = E / 4;
    for (int c0 = 0; c0 < nc; c0 += AHEAD) {
        float4 inc[AHEAD];
        float g[AHEAD];
#pragma unroll
        for (int i = 0; i < AHEAD; ++i) {
            if (c0 + i < nc) {
                inc[i] = p[(c0 + i) * step];
                g[i] = d[(long long)(c0 + i) * drow];
            }
        }
#pragma unroll
        for (int i = 0; i < AHEAD; ++i) {
            if (c0 + i >= nc) break;
            p[(c0 + i) * step] = s;
            s = make_float4(fmaf(g[i], s.x, inc[i].x),
                            fmaf(g[i], s.y, inc[i].y),
                            fmaf(g[i], s.z, inc[i].z),
                            fmaf(g[i], s.w, inc[i].w));
        }
    }
    *reinterpret_cast<float4*>(s_out + bh * E + e) = s;
}

inline int launch_state_pass(float* buf, const float* dec, const float* s0,
                             float* s_out, int BH, int nc, int E, int ncol,
                             int drow, int dcol, cudaStream_t stream) {
    const dim3 grid((E / 4 + PASS_NT - 1) / PASS_NT, BH);
    state_pass_kernel<<<grid, PASS_NT, 0, stream>>>(buf, dec, s0, s_out, nc,
                                                     E, ncol, drow, dcol);
    return (int)cudaGetLastError();
}

__host__ __device__ constexpr size_t align16(size_t bytes) {
    return (bytes + 15) / 16 * 16;
}

inline bool rows16(const void* p, int elem, int cols,
                   std::initializer_list<long long> strides) {
    if (reinterpret_cast<uintptr_t>(p) % 16 || (cols * elem) % 16)
        return false;
    for (long long s : strides)
        if ((s * elem) % 16) return false;
    return true;
}

}  // namespace chunked
