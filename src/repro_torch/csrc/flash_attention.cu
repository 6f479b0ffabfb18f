// K4 flash_attention: blockwise online-softmax prefill attention with
// GQA, causal masking, an optional sliding window and ragged lengths.
//
// Replaces the Pallas kernel flash_attention._kernel / flash_attention
// of src/repro/kernels/flash_attention.py. The TPU version walks the K
// blocks of one (b, h, q block) in order and carries m, l and the
// (bq, D) accumulator in VMEM scratch. Here one CTA of 8 warps owns a
// (b, h, 64-row q block); each warp carries 8 of those rows in
// registers (attention_tile.cuh) and the CTA stages each 32-key K/V
// tile of kv head h / G in shared memory as f32 once for all warps.
// K tiles that no row of the block can see (above the causal diagonal,
// left of the window) are never loaded: the same block pruning as the
// Pallas kernel, from the tile bounds. Ragged Sq and Sk are bounds
// checks, not padding. Inputs are f32 or bf16; the math is f32; the
// output is written in q's dtype through explicit strides, so the
// model's (B, S, H, D) activations pass without a copy.
//
// Bound on an H100: operations. 4·D FLOPs per visible (q, k) pair; the
// tensor-core rate for bf16 is out of reach of this CUDA-core kernel,
// which does the products as f32 FMAs (a wgmma version is later work).
#include "attention_tile.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int BQ = WARPS * attn::ROWS;   // query rows per CTA

template <int D>
constexpr int smem_floats() {
    return BQ * D + attn::TILE * (D + 4) + attn::TILE * D
           + WARPS * attn::TILE * attn::ROWS;
}

template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int KH, int Sq, int Sk, long long qsb, long long qsh,
                       long long qss, long long ksb, long long ksh,
                       long long kss, long long vsb, long long vsh,
                       long long vss, long long osb, long long osh,
                       long long oss, int causal, int window, float scale) {
    extern __shared__ float4 smem4[];
    float* q_s = reinterpret_cast<float*>(smem4);        // [BQ][D]
    float* k_s = q_s + BQ * D;                           // [TILE][D+4]
    float* v_s = k_s + attn::TILE * (D + 4);             // [TILE][D]
    float* p_s = v_s + attn::TILE * D;                   // [WARPS][TILE][ROWS]

    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int kh = h / (H / KH);
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const T* qp = q + b * qsb + h * qsh;
    const T* kp = k + b * ksb + kh * ksh;
    const T* vp = v + b * vsb + kh * vsh;

    for (int i = tid; i < BQ * D; i += WARPS * 32) {
        const int r = i / D, d = i % D, qi = q0 + r;
        q_s[i] = qi < Sq ? attn::to_f32(qp[qi * qss + d]) * scale : 0.0f;
    }
    // visible keys of this warp's rows: lo <= key < hi
    int lo[attn::ROWS], hi[attn::ROWS];
#pragma unroll
    for (int r = 0; r < attn::ROWS; ++r) {
        const int qi = q0 + warp * attn::ROWS + r;
        const bool row = qi < Sq;
        hi[r] = row ? (causal ? min(Sk, qi + 1) : Sk) : 0;
        lo[r] = (row && window > 0) ? max(0, qi - window + 1) : 0;
    }
    // keys visible to any row of the block
    const int q_last = min(Sq, q0 + BQ) - 1;
    const int k_end = causal ? min(Sk, q_last + 1) : Sk;
    int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
    k_begin -= k_begin % attn::TILE;

    attn::RowState<D> st;
    st.init();
    for (int k0 = k_begin; k0 < k_end; k0 += attn::TILE) {
        __syncthreads();   // q staged / previous tile consumed
        attn::stage_tile<T, D>(k_s, D + 4, [&](int j) -> const T* {
            return k0 + j < Sk ? kp + (k0 + j) * kss : nullptr;
        }, tid, WARPS * 32);
        attn::stage_tile<T, D>(v_s, D, [&](int j) -> const T* {
            return k0 + j < Sk ? vp + (k0 + j) * vss : nullptr;
        }, tid, WARPS * 32);
        __syncthreads();
        if (attn::tile_needed(lo, hi, k0))
            attn::tile_update<D>(st, q_s + warp * attn::ROWS * D, k_s, v_s,
                                 p_s + warp * attn::TILE * attn::ROWS, k0,
                                 lo, hi, lane);
    }
    T* op = o + b * osb + h * osh;
#pragma unroll
    for (int r = 0; r < attn::ROWS; ++r) {
        const int qi = q0 + warp * attn::ROWS + r;
        if (qi >= Sq) continue;
        const float l = fmaxf(st.l[r], 1e-30f);
#pragma unroll
        for (int c = 0; c < attn::RowState<D>::NC; ++c) {
            const int d = lane + 32 * c;
            if (d < D) attn::store(st.acc[r][c] / l, op + qi * oss + d);
        }
    }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KH, int Sq, int Sk, const long long* st, int causal,
           int window, float scale, cudaStream_t stream) {
    constexpr int bytes = smem_floats<D>() * 4;
    auto kern = flash_attention_kernel<T, D>;
    if (bytes > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid((Sq + BQ - 1) / BQ, H, B);
    kern<<<grid, WARPS * 32, bytes, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, H, KH, Sq, Sk, st[0],
        st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
        st[10], st[11], causal, window, scale);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* o,
             int B, int H, int KH, int Sq, int Sk, const long long* st,
             int causal, int window, float scale, cudaStream_t stream) {
    switch (D) {
        case 16: return launch<T, 16>(q, k, v, o, B, H, KH, Sq, Sk, st,
                                      causal, window, scale, stream);
        case 32: return launch<T, 32>(q, k, v, o, B, H, KH, Sq, Sk, st,
                                      causal, window, scale, stream);
        case 64: return launch<T, 64>(q, k, v, o, B, H, KH, Sq, Sk, st,
                                      causal, window, scale, stream);
        case 80: return launch<T, 80>(q, k, v, o, B, H, KH, Sq, Sk, st,
                                      causal, window, scale, stream);
        case 128: return launch<T, 128>(q, k, v, o, B, H, KH, Sq, Sk, st,
                                        causal, window, scale, stream);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype 0: float32, 1: bfloat16 (q, k, v and o alike). strides: 12
// element strides, (batch, head, seq) for q, k, v and o in that order;
// the last dimension is contiguous.
extern "C" int flash_attention_fwd(int dtype, int D, const void* q,
                                   const void* k, const void* v, void* o,
                                   int B, int H, int KH, int Sq, int Sk,
                                   const void* strides, int causal,
                                   int window, float scale, void* stream) {
    if (B == 0 || Sq == 0) return 0;
    const long long* st = (const long long*)strides;
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return dispatch<float>(D, q, k, v, o, B, H, KH, Sq, Sk, st, causal,
                               window, scale, s);
    if (dtype == 1)
        return dispatch<__nv_bfloat16>(D, q, k, v, o, B, H, KH, Sq, Sk, st,
                                       causal, window, scale, s);
    return (int)cudaErrorInvalidValue;
}
