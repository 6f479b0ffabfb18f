// K5 paged_attention: single-token GQA decode attention that reads K/V
// through a page table, with an online softmax over the sequence.
//
// Replaces the Pallas kernel paged_attention._kernel / paged_attention
// of src/repro/kernels/paged_attention.py. The TPU version walks one
// sequence's pages in order (grid (B, KH, max_pages)) and skips pages
// at or past ceil(len / page). Here one CTA of W warps (8 for D < 128,
// 4 at D = 128) owns a (sequence, kv head) and the G = H / KH query rows
// that share it (up to 8 per CTA; more rows take more CTAs along grid
// z). The tokens [0, len) are cut into 32-token tiles; warp w takes
// tiles w, w + W, ... and gathers each tile's rows from their pages
// itself (page table[b, tok / page], row tok % page), 16 bytes a load,
// so pages past ceil(len / page) are never read and a page may be any
// size. Each warp keeps its own online-softmax state
// (attention_tile.cuh); the W states are merged at the end through
// shared memory, as flash decoding merges its splits.
//
// The pools are addressed through explicit element strides for (kv
// head, page, row); the last dimension is contiguous. A dense per-slot
// cache (B, Smax, KH, D) therefore passes without a copy as the view
// (KH, B·Smax/page, page, D) with the identity page table.
//
// Bound on an H100: bytes — every valid token's K and V row is read
// once. One CTA per (sequence, kv head) is B·KH CTAs against 132 SMs;
// a split over the sequence across CTAs is later work.
#include "attention_tile.cuh"

namespace {

// warps per CTA: 8 while the per-warp tiles fit the 227 KiB of opt-in
// shared memory (D = 80: 195 KiB), else 4 (D = 128: 154 KiB)
template <int D>
__host__ __device__ constexpr int warps() { return D < 128 ? 8 : 4; }

template <int D>
constexpr int smem_floats() {
    return attn::ROWS * D
           + warps<D>() * (attn::TILE * (D + 4) + attn::TILE * D
                           + attn::TILE * attn::ROWS)
           + warps<D>() * attn::ROWS * (D + 2);
}
static_assert(smem_floats<80>() * 4 <= 232448 &&
              smem_floats<128>() * 4 <= 232448,
              "per-CTA shared memory above the H100's opt-in limit");

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(256)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                       const TKV* __restrict__ vp,
                       const int* __restrict__ table,
                       const int* __restrict__ lengths, TQ* __restrict__ o,
                       int H, int KH, int mp, int page, long long ksh,
                       long long ksp, long long kst, long long vsh,
                       long long vsp, long long vst, float scale) {
    constexpr int WARPS = warps<D>();
    constexpr int KT = attn::TILE * (D + 4) + attn::TILE * D
                       + attn::TILE * attn::ROWS;
    extern __shared__ float4 smem4[];
    float* q_s = reinterpret_cast<float*>(smem4);          // [ROWS][D]
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    float* k_s = q_s + attn::ROWS * D + warp * KT;         // [TILE][D+4]
    float* v_s = k_s + attn::TILE * (D + 4);               // [TILE][D]
    float* p_s = v_s + attn::TILE * D;                     // [TILE][ROWS]
    float* merge = q_s + attn::ROWS * D + WARPS * KT;      // [WARPS][ROWS][D+2]

    const int b = blockIdx.x;
    const int kh = blockIdx.y;
    const int G = H / KH;
    const int g0 = blockIdx.z * attn::ROWS;
    const int nrows = min(attn::ROWS, G - g0);
    const int len = min(lengths[b], mp * page);
    const TQ* qb = q + ((long long)b * H + kh * G + g0) * D;

    for (int i = tid; i < attn::ROWS * D; i += WARPS * 32)
        q_s[i] = i / D < nrows ? attn::to_f32(qb[i]) * scale : 0.0f;
    int lo[attn::ROWS], hi[attn::ROWS];
#pragma unroll
    for (int r = 0; r < attn::ROWS; ++r) {
        lo[r] = 0;
        hi[r] = r < nrows ? len : 0;
    }
    __syncthreads();

    attn::RowState<D> st;
    st.init();
    const int* pt = table + (long long)b * mp;
    const TKV* kbase = kp + kh * ksh;
    const TKV* vbase = vp + kh * vsh;
    for (int t0 = warp * attn::TILE; t0 < len; t0 += WARPS * attn::TILE) {
        attn::stage_tile<TKV, D>(k_s, D + 4, [&](int j) -> const TKV* {
            const int tok = t0 + j;
            return tok < len ? kbase + pt[tok / page] * ksp
                                   + (tok % page) * kst
                             : nullptr;
        }, lane, 32);
        attn::stage_tile<TKV, D>(v_s, D, [&](int j) -> const TKV* {
            const int tok = t0 + j;
            return tok < len ? vbase + pt[tok / page] * vsp
                                   + (tok % page) * vst
                             : nullptr;
        }, lane, 32);
        __syncwarp();
        attn::tile_update<D>(st, q_s, k_s, v_s, p_s, t0, lo, hi, lane);
    }

    // merge the warps' partial softmax states
    float* mw = merge + warp * attn::ROWS * (D + 2);
#pragma unroll
    for (int r = 0; r < attn::ROWS; ++r) {
        float* row = mw + r * (D + 2);
        if (lane == 0) {
            row[D] = st.m[r];
            row[D + 1] = st.l[r];
        }
#pragma unroll
        for (int c = 0; c < attn::RowState<D>::NC; ++c) {
            const int d = lane + 32 * c;
            if (d < D) row[d] = st.acc[r][c];
        }
    }
    __syncthreads();
    TQ* ob = o + ((long long)b * H + kh * G + g0) * D;
    for (int i = tid; i < nrows * D; i += WARPS * 32) {
        const int r = i / D, d = i % D;
        float m = attn::NEG_INF;
        for (int w = 0; w < WARPS; ++w)
            m = fmaxf(m, merge[(w * attn::ROWS + r) * (D + 2) + D]);
        float l = 0.0f, a = 0.0f;
        for (int w = 0; w < WARPS; ++w) {
            const float* row = merge + (w * attn::ROWS + r) * (D + 2);
            const float f = expf(row[D] - m);
            l += row[D + 1] * f;
            a += row[d] * f;
        }
        attn::store(a / fmaxf(l, 1e-30f), ob + i);
    }
}

template <typename TQ, typename TKV, int D>
int launch(const void* q, const void* kp, const void* vp, const void* table,
           const void* lengths, void* o, int B, int H, int KH, int mp,
           int page, const long long* st, float scale, cudaStream_t stream) {
    constexpr int bytes = smem_floats<D>() * 4;
    auto kern = paged_attention_kernel<TQ, TKV, D>;
    if (bytes > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (e != cudaSuccess) return (int)e;
    }
    const int G = H / KH;
    const dim3 grid(B, KH, (G + attn::ROWS - 1) / attn::ROWS);
    kern<<<grid, warps<D>() * 32, bytes, stream>>>(
        (const TQ*)q, (const TKV*)kp, (const TKV*)vp, (const int*)table,
        (const int*)lengths, (TQ*)o, H, KH, mp, page, st[0], st[1], st[2],
        st[3], st[4], st[5], scale);
    return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int dispatch(int D, const void* q, const void* kp, const void* vp,
             const void* table, const void* lengths, void* o, int B, int H,
             int KH, int mp, int page, const long long* st, float scale,
             cudaStream_t stream) {
    switch (D) {
        case 16: return launch<TQ, TKV, 16>(q, kp, vp, table, lengths, o, B,
                                            H, KH, mp, page, st, scale,
                                            stream);
        case 32: return launch<TQ, TKV, 32>(q, kp, vp, table, lengths, o, B,
                                            H, KH, mp, page, st, scale,
                                            stream);
        case 64: return launch<TQ, TKV, 64>(q, kp, vp, table, lengths, o, B,
                                            H, KH, mp, page, st, scale,
                                            stream);
        case 80: return launch<TQ, TKV, 80>(q, kp, vp, table, lengths, o, B,
                                            H, KH, mp, page, st, scale,
                                            stream);
        case 128: return launch<TQ, TKV, 128>(q, kp, vp, table, lengths, o,
                                              B, H, KH, mp, page, st, scale,
                                              stream);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtypes: 0 f32 q and pools, 1 bf16 q and pools, 2 f32 q with bf16
// pools. strides: 6 element strides, (kv head, page, row) of the K pool
// then of the V pool. q and o are contiguous (B, H, D); table is int32
// (B, mp), lengths int32 (B,).
extern "C" int paged_attention_fwd(int dtypes, int D, const void* q,
                                   const void* k_pool, const void* v_pool,
                                   const void* table, const void* lengths,
                                   void* o, int B, int H, int KH, int mp,
                                   int page, const void* strides, float scale,
                                   void* stream) {
    if (B == 0) return 0;
    const long long* st = (const long long*)strides;
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtypes) {
        case 0: return dispatch<float, float>(D, q, k_pool, v_pool, table,
                                              lengths, o, B, H, KH, mp, page,
                                              st, scale, s);
        case 1: return dispatch<__nv_bfloat16, __nv_bfloat16>(
            D, q, k_pool, v_pool, table, lengths, o, B, H, KH, mp, page, st,
            scale, s);
        case 2: return dispatch<float, __nv_bfloat16>(
            D, q, k_pool, v_pool, table, lengths, o, B, H, KH, mp, page, st,
            scale, s);
    }
    return (int)cudaErrorInvalidValue;
}
