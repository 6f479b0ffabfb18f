// The CUDA-core online-softmax pieces of the attention kernels: the f32
// route of flash_attention.cu runs one warp's update of up to ROWS query
// rows against one tile of TILE keys staged in shared memory (below);
// paged_attention.cu takes NEG_INF, the warp reductions and the element
// conversions.
//
// Score pass: lane j owns key j of the tile and computes its dot
// product with every row (the K row is read once from shared memory
// and reused for all ROWS rows; the q rows are broadcast reads). The
// row max and row sum are warp reductions. Value pass: lane l owns the
// accumulator columns d = l + 32c, the tile's probabilities go through
// a warp-private [TILE][ROWS] scratch, and every V element read is used
// for all ROWS rows. Masked scores are NEG_INF = -1e30 (not -inf) so
// that exp(m_prev - m_new) stays finite on a row whose keys so far were
// all masked; such a row's partial sums are wiped by corr = 0 as soon
// as it meets its first valid key, exactly as in the Pallas kernels.
#pragma once
#include "elem.cuh"

namespace attn {

constexpr float NEG_INF = -1e30f;
constexpr int TILE = 32;   // keys per tile: one per lane in the score pass
constexpr int ROWS = 8;    // query rows one warp carries

using elem::store;
using elem::to_f32;

// 16-byte loads of N consecutive elements, widened to f32.
template <typename T>
struct VecLoad;

template <>
struct VecLoad<float> {
    static constexpr int N = 4;
    __device__ static __forceinline__ void load(const float* p, float* o) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p));
        o[0] = v.x;
        o[1] = v.y;
        o[2] = v.z;
        o[3] = v.w;
    }
};

template <>
struct VecLoad<__nv_bfloat16> {
    static constexpr int N = 8;
    __device__ static __forceinline__ void load(const __nv_bfloat16* p,
                                                float* o) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(h[i]);
            o[2 * i] = f.x;
            o[2 * i + 1] = f.y;
        }
    }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

// Online-softmax state of ROWS rows, replicated m and l in every lane,
// accumulator columns d = lane + 32c.
template <int D>
struct RowState {
    static constexpr int NC = (D + 31) / 32;
    float m[ROWS], l[ROWS], acc[ROWS][NC];

    __device__ __forceinline__ void init() {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            m[r] = NEG_INF;
            l[r] = 0.0f;
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[r][c] = 0.0f;
        }
    }
};

// True when some row r has a valid key in [k0, k0 + TILE): key k is
// valid for row r iff lo[r] <= k < hi[r]. A tile no row can see is
// skipped; that is exact (p = 0 and corr = 1 for rows already holding a
// valid key, and wiped partial sums for the others).
__device__ __forceinline__ bool tile_needed(const int* lo, const int* hi,
                                            int k0) {
    bool any = false;
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
        any |= max(lo[r], k0) < min(hi[r], k0 + TILE);
    return any;
}

// Stage the TILE rows of a K or V tile into shared memory as f32, 16
// bytes a load, threads t, t + nt, ... of the block: row(j) is the first
// element of row j, or nullptr for a row past the end (zeros). Rows of
// dst are dst_stride floats apart. Every row pointer is 16-byte
// aligned (the wrappers check base pointers and strides).
template <typename T, int D, typename RowFn>
__device__ __forceinline__ void stage_tile(float* dst, int dst_stride,
                                           RowFn row, int t, int nt) {
    constexpr int N = VecLoad<T>::N;
    constexpr int PER_ROW = D / N;
#pragma unroll 4
    for (int i = t; i < TILE * PER_ROW; i += nt) {
        const int j = i / PER_ROW, c = (i % PER_ROW) * N;
        const T* src = row(j);
        float v[N];
        if (src != nullptr) {
            VecLoad<T>::load(src + c, v);
        } else {
#pragma unroll
            for (int n = 0; n < N; ++n) v[n] = 0.0f;
        }
        float* d = dst + j * dst_stride + c;
#pragma unroll
        for (int n = 0; n < N; n += 4)
            *reinterpret_cast<float4*>(d + n) =
                make_float4(v[n], v[n + 1], v[n + 2], v[n + 3]);
    }
}

// q_s [ROWS][D]: the rows, f32, already scaled by D^-0.5.
// k_s [TILE][D + 4] and v_s [TILE][D]: the tile, f32 (K rows padded so
// that lane j's float4 reads of row j hit distinct banks).
// p_s [TILE][ROWS]: warp-private scratch.
template <int D>
__device__ __forceinline__ void tile_update(RowState<D>& st,
                                            const float* q_s,
                                            const float* k_s,
                                            const float* v_s, float* p_s,
                                            int k0, const int* lo,
                                            const int* hi, int lane) {
    constexpr int NC = RowState<D>::NC;
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.0f;
    const float* kr = k_s + lane * (D + 4);
#pragma unroll
    for (int d = 0; d < D; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            const float4 qv =
                *reinterpret_cast<const float4*>(q_s + r * D + d);
            s[r] = fmaf(qv.x, kv.x, s[r]);
            s[r] = fmaf(qv.y, kv.y, s[r]);
            s[r] = fmaf(qv.z, kv.z, s[r]);
            s[r] = fmaf(qv.w, kv.w, s[r]);
        }
    }
    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const float sr = (key >= lo[r] && key < hi[r]) ? s[r] : NEG_INF;
        const float m_new = fmaxf(st.m[r], warp_max(sr));
        const float corr = expf(st.m[r] - m_new);
        const float p = expf(sr - m_new);
        st.l[r] = st.l[r] * corr + warp_sum(p);
        st.m[r] = m_new;
#pragma unroll
        for (int c = 0; c < NC; ++c) st.acc[r][c] *= corr;
        p_s[lane * ROWS + r] = p;
    }
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < TILE; ++j) {
        const float4 pa = *reinterpret_cast<const float4*>(p_s + j * ROWS);
        const float4 pb =
            *reinterpret_cast<const float4*>(p_s + j * ROWS + 4);
        const float pr[ROWS] = {pa.x, pa.y, pa.z, pa.w,
                                pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            const int d = lane + 32 * c;
            if (D % 32 == 0 || d < D) {
                const float vv = v_s[j * D + d];
#pragma unroll
                for (int r = 0; r < ROWS; ++r)
                    st.acc[r][c] = fmaf(pr[r], vv, st.acc[r][c]);
            }
        }
    }
    __syncwarp();
}

}  // namespace attn
