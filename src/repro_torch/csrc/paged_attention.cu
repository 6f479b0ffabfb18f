// K5 paged_attention: single-token GQA decode attention that reads K/V
// through a page table, with an online softmax over the sequence, split
// over the sequence across CTAs (flash decoding).
//
// Replaces the Pallas kernel paged_attention._kernel / paged_attention
// of src/repro/kernels/paged_attention.py. The TPU version walks one
// sequence's pages in order (grid (B, KH, max_pages)) and skips pages
// at or past ceil(len / page).
//
// Bound on an H100: bytes — every valid token's K and V row is read
// once, and there are at most a few tens of MFLOP a call. So the design
// is about keeping enough bytes in flight on all 132 SMs:
//
// * The grid is (B · KH · row groups, splits). A CTA of W warps owns
//   one (sequence, kv head) and carries exactly the query rows of its
//   group, R of the G = H / KH rows that share the kv head (R = G for G
//   of 1, 2, 4 or 8; more rows take more groups). The wrapper picks the
//   number of splits from B, KH and the table's capacity so that there
//   is about one CTA an SM (paged_splits in kernels/attention.py);
//   each CTA computes its own split of [0, len) from the sequence's
//   length: whole 128-token rounds, so a split past ceil(len / split)
//   is empty. The length is clipped to the table: min(len, mp · page).
// * Warp w of a CTA takes the 32-token tiles w, w + W, ... of its
//   split. Each warp keeps a private 2-stage ring of K and V tiles in
//   their own dtype, filled with 16-byte cp.async copies: the next tile
//   loads while this one computes. A tile's page ids are read once, one
//   per lane, and the row addresses shuffled to the lanes that copy.
//   Rows are padded by 16 bytes, so lane j's 16-byte reads of row j hit
//   distinct banks.
// * The math is f32 on the CUDA cores: lane j scores token j against
//   the R rows (q pre-scaled by D^-0.5 in f32 in shared memory), the
//   warp keeps an online-softmax state per row, and the value pass
//   gives lane l the column pairs 2l + 64c of the accumulator.
// * The W warp states merge through shared memory. With one split the
//   CTA writes the output; otherwise it writes its partial state (m, l,
//   acc[D]) per row in f32 to scratch, and the last CTA of the (sequence,
//   kv head, row group) to finish — found by an atomic counter, which it
//   resets — merges the splits: m = max m_s, o = Σ acc_s e^(m_s − m) /
//   Σ l_s e^(m_s − m). An empty split writes (NEG_INF, 0, 0) and adds
//   nothing. One launch a call: a second merge kernel cost more than
//   the merge itself at decode sizes.
//
// The pools are addressed through explicit element strides for (kv
// head, page, row); the last dimension is contiguous. A dense per-slot
// cache (B, Smax, KH, D) therefore passes without a copy as the view
// (KH, B·Smax/page, page, D) with the identity page table.
#include "attention_tile.cuh"
#include "wgmma.cuh"

namespace {

constexpr int TILE = 32;    // tokens a warp tile: one a lane
constexpr int ROUND = 128;  // a split is whole rounds of this many tokens

// 16-byte shared-memory rows of one token, padded to an odd number of
// 16-byte units
template <typename TKV, int D>
__host__ __device__ constexpr int row_bytes() {
    return D * (int)sizeof(TKV) + 16;
}
template <typename TKV, int D>
__host__ __device__ constexpr int warp_tile_bytes() {
    return 2 * 2 * TILE * row_bytes<TKV, D>();   // 2 stages of K and V
}
template <typename TKV, int D, int R>
__host__ __device__ constexpr int smem_bytes(int warps) {
    return R * D * 4 + warps * (warp_tile_bytes<TKV, D>() + TILE * R * 4);
}
// warps per CTA: 4 while their tiles fit the 227 KiB of opt-in shared
// memory, else fewer (f32 pools at D = 128)
template <typename TKV, int D, int R>
__host__ __device__ constexpr int warps() {
    return smem_bytes<TKV, D, R>(4) <= 232448 ? 4
           : smem_bytes<TKV, D, R>(3) <= 232448 ? 3 : 2;
}
static_assert(smem_bytes<float, 128, 8>(warps<float, 128, 8>()) <= 232448,
              "per-CTA shared memory above the H100's opt-in limit");

// 16 bytes of K or V as f32
__device__ __forceinline__ void widen(const uint4& u, float* f) {
    const float* x = reinterpret_cast<const float*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = x[i];
}
__device__ __forceinline__ void widen_bf16(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 v = __bfloat1622float2(h[i]);
        f[2 * i] = v.x;
        f[2 * i + 1] = v.y;
    }
}

__device__ __forceinline__ float2 pair(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename TQ, typename TKV, int D, int R>
__global__ void __launch_bounds__(warps<TKV, D, R>() * 32)
paged_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                   const TKV* __restrict__ vp, const int* __restrict__ table,
                   const int* __restrict__ lengths, TQ* __restrict__ o,
                   float* __restrict__ part, int* __restrict__ counters,
                   int H, int KH, int mp, int page,
                   long long ksh, long long ksp, long long kst,
                   long long vsh, long long vsp, long long vst, float scale) {
    constexpr int W = warps<TKV, D, R>();
    constexpr int VE = 16 / (int)sizeof(TKV);     // elements a chunk
    constexpr int C = D / VE;                     // chunks a row
    constexpr int RB = row_bytes<TKV, D>();
    constexpr int NP = (D + 63) / 64;             // column pairs a lane
    extern __shared__ __align__(16) unsigned char smem[];
    float* q_s = reinterpret_cast<float*>(smem);                  // [R][D]
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    unsigned char* wbase =
        smem + R * D * 4 + warp * warp_tile_bytes<TKV, D>();
    float* p_s = reinterpret_cast<float*>(
        smem + R * D * 4 + W * warp_tile_bytes<TKV, D>()) + warp * TILE * R;

    const int G = H / KH;
    const int groups = (G + R - 1) / R;
    const int grp = blockIdx.x % groups;
    const int kh = (blockIdx.x / groups) % KH;
    const int b = blockIdx.x / groups / KH;
    const int g0 = grp * R;
    const int nrows = min(R, G - g0);
    const int nsplit = gridDim.y;
    const int len = max(0, min(lengths[b], mp * page));
    const int per = (len + nsplit - 1) / nsplit;
    const int split = max(ROUND, (per + ROUND - 1) / ROUND * ROUND);
    const int t_begin = blockIdx.y * split;
    const int t_end = min(len, t_begin + split);
    const long long h0 = (long long)b * H + kh * G + g0;
    const long long BHS = (long long)gridDim.x / groups * G * nsplit;

    const int* pt = table + (long long)b * mp;
    const TKV* kbase = kp + kh * ksh;
    const TKV* vbase = vp + kh * vsh;
    // copy the 32 rows of the tile at t0 into stage `st` of this warp
    auto load = [&](int t0, int st) {
        const int tok = t0 + lane;
        long long ko = 0, vo = 0;
        if (tok < t_end) {
            const int pg = pt[tok / page], r = tok % page;
            ko = pg * ksp + r * kst;
            vo = pg * vsp + r * vst;
        }
        const uint32_t ks = wg::smem_addr(wbase) + st * 2 * TILE * RB;
        const uint32_t vs = ks + TILE * RB;
#pragma unroll
        for (int n = 0; n < C; ++n) {
            const int i = lane + 32 * n;          // chunk i of the tile
            const int j = i / C, c = i % C;       // row j, chunk c
            const long long kj = __shfl_sync(0xffffffffu, ko, j);
            const long long vj = __shfl_sync(0xffffffffu, vo, j);
            const bool ok = t0 + j < t_end;
            wg::cp_async16(ks + j * RB + 16 * c, kbase + kj + c * VE, ok);
            wg::cp_async16(vs + j * RB + 16 * c, vbase + vj + c * VE, ok);
        }
        wg::cp_async_commit();
    };

    // this warp's first two tiles are on their way before q is staged
    constexpr int STEP = W * TILE;
    int t0 = t_begin + warp * TILE;
    if (t0 < t_end) load(t0, 0);
    if (t0 + STEP < t_end) load(t0 + STEP, 1);

    for (int i = tid; i < R * D; i += W * 32)
        q_s[i] = i / D < nrows ? attn::to_f32(q[h0 * D + i]) * scale : 0.0f;
    float m[R], l[R], acc[R][NP][2];
#pragma unroll
    for (int g = 0; g < R; ++g) {
        m[g] = attn::NEG_INF;
        l[g] = 0.0f;   // this lane's part of the row sum
#pragma unroll
        for (int c = 0; c < NP; ++c) acc[g][c][0] = acc[g][c][1] = 0.0f;
    }
    __syncthreads();   // q_s

    for (int it = 0; t0 < t_end; t0 += STEP, ++it) {
        if (t0 + STEP < t_end) wg::cp_async_wait<1>();
        else wg::cp_async_wait<0>();
        __syncwarp();
        const unsigned char* ks = wbase + (it & 1) * 2 * TILE * RB;
        const unsigned char* vs = ks + TILE * RB;

        // score pass: lane j against token t0 + j
        float s[R];
#pragma unroll
        for (int g = 0; g < R; ++g) s[g] = 0.0f;
        const unsigned char* kr = ks + lane * RB;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const uint4 u = *reinterpret_cast<const uint4*>(kr + 16 * c);
            float kf[VE];
            if constexpr (VE == 4) widen(u, kf); else widen_bf16(u, kf);
#pragma unroll
            for (int g = 0; g < R; ++g)
#pragma unroll
                for (int e = 0; e < VE; e += 4) {
                    const float4 qv = *reinterpret_cast<const float4*>(
                        q_s + g * D + c * VE + e);
                    s[g] = fmaf(qv.x, kf[e], s[g]);
                    s[g] = fmaf(qv.y, kf[e + 1], s[g]);
                    s[g] = fmaf(qv.z, kf[e + 2], s[g]);
                    s[g] = fmaf(qv.w, kf[e + 3], s[g]);
                }
        }
        const bool valid = t0 + lane < t_end;
#pragma unroll
        for (int g = 0; g < R; ++g) {
            const float sg = valid ? s[g] : attn::NEG_INF;
            const float m_new = fmaxf(m[g], attn::warp_max(sg));
            const float corr = expf(m[g] - m_new);
            const float p = expf(sg - m_new);
            l[g] = l[g] * corr + p;
            m[g] = m_new;
#pragma unroll
            for (int c = 0; c < NP; ++c) {
                acc[g][c][0] *= corr;
                acc[g][c][1] *= corr;
            }
            p_s[lane * R + g] = p;
        }
        __syncwarp();
        // value pass: lane l owns the column pairs 2l + 64c
        const int nj = min(TILE, t_end - t0);
        for (int j = 0; j < nj; ++j) {
            float pj[R];
            if constexpr (R % 4 == 0) {
#pragma unroll
                for (int g = 0; g < R; g += 4) {
                    const float4 p4 =
                        *reinterpret_cast<const float4*>(p_s + j * R + g);
                    pj[g] = p4.x;
                    pj[g + 1] = p4.y;
                    pj[g + 2] = p4.z;
                    pj[g + 3] = p4.w;
                }
            } else {
#pragma unroll
                for (int g = 0; g < R; ++g) pj[g] = p_s[j * R + g];
            }
            const TKV* vr = reinterpret_cast<const TKV*>(vs + j * RB);
#pragma unroll
            for (int c = 0; c < NP; ++c) {
                const int d = 2 * lane + 64 * c;
                if (D % 64 == 0 || d < D) {
                    const float2 vv = pair(vr + d);
#pragma unroll
                    for (int g = 0; g < R; ++g) {
                        acc[g][c][0] = fmaf(pj[g], vv.x, acc[g][c][0]);
                        acc[g][c][1] = fmaf(pj[g], vv.y, acc[g][c][1]);
                    }
                }
            }
        }
        __syncwarp();   // the stage and p_s are free again
        if (t0 + 2 * STEP < t_end) load(t0 + 2 * STEP, it & 1);
    }

    // merge the warps' states: [W][R][D + 2] over the (idle) tiles
    __syncthreads();
    float* merge = reinterpret_cast<float*>(smem + R * D * 4);
    float* mw = merge + warp * R * (D + 2);
#pragma unroll
    for (int g = 0; g < R; ++g) {
        float* row = mw + g * (D + 2);
        const float lsum = attn::warp_sum(l[g]);
        if (lane == 0) {
            row[D] = m[g];
            row[D + 1] = lsum;
        }
#pragma unroll
        for (int c = 0; c < NP; ++c) {
            const int d = 2 * lane + 64 * c;
            if (D % 64 == 0 || d < D) {
                row[d] = acc[g][c][0];
                row[d + 1] = acc[g][c][1];
            }
        }
    }
    __syncthreads();
    for (int i = tid; i < nrows * D; i += W * 32) {
        const int g = i / D, d = i % D;
        float mx = attn::NEG_INF;
        for (int w = 0; w < W; ++w)
            mx = fmaxf(mx, merge[(w * R + g) * (D + 2) + D]);
        float ls = 0.0f, a = 0.0f;
        for (int w = 0; w < W; ++w) {
            const float* row = merge + (w * R + g) * (D + 2);
            const float f = expf(row[D] - mx);
            ls += row[D + 1] * f;
            a += row[d] * f;
        }
        if (nsplit == 1) {
            attn::store(a / fmaxf(ls, 1e-30f), o + h0 * D + i);
        } else {
            // part: acc [B·H][nsplit][D], then m and l [B·H][nsplit]
            const long long hs = (h0 + g) * nsplit + blockIdx.y;
            part[hs * D + d] = a;
            if (d == 0) {
                part[BHS * D + hs] = mx;
                part[BHS * (D + 1) + hs] = ls;
            }
        }
    }
    if (nsplit == 1) return;

    // the last of the nsplit CTAs of this (sequence, kv head, row group)
    // to finish merges their states and resets the counter for the next
    // call: m = max m_s, o = Σ acc_s e^(m_s − m) / Σ l_s e^(m_s − m)
    int& last = *reinterpret_cast<int*>(smem);   // q_s is spent
    __syncthreads();
    if (tid == 0) {
        __threadfence();
        last = atomicAdd(counters + blockIdx.x, 1) == nsplit - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    // the partial states come from other CTAs: read them from L2, four
    // columns a thread and 8 splits' loads in flight at a time
    constexpr int U = 8;
    const float* pm = part + BHS * D;
    const float* pl = pm + BHS;
    for (int i = tid; i < nrows * D / 4; i += W * 32) {
        const int g = i / (D / 4), d = 4 * (i % (D / 4));
        const long long hs = (h0 + g) * nsplit;
        float mx = attn::NEG_INF;
        for (int s0 = 0; s0 < nsplit; s0 += U) {
#pragma unroll
            for (int u = 0; u < U; ++u)
                if (s0 + u < nsplit) mx = fmaxf(mx, __ldcg(pm + hs + s0 + u));
        }
        float ls = 0.0f;
        float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int s0 = 0; s0 < nsplit; s0 += U) {
            float mv[U], lv[U];
            float4 av[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const bool ok = s0 + u < nsplit;
                const long long hu = hs + s0 + u;
                mv[u] = ok ? __ldcg(pm + hu) : attn::NEG_INF;
                lv[u] = ok ? __ldcg(pl + hu) : 0.0f;
                av[u] = ok ? __ldcg(reinterpret_cast<const float4*>(
                                 part + hu * D + d))
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const float f = expf(mv[u] - mx);
                ls += lv[u] * f;
                a.x += av[u].x * f;
                a.y += av[u].y * f;
                a.z += av[u].z * f;
                a.w += av[u].w * f;
            }
        }
        const float inv = 1.0f / fmaxf(ls, 1e-30f);
        TQ* out = o + h0 * D + (long long)g * D + d;
        attn::store(a.x * inv, out);
        attn::store(a.y * inv, out + 1);
        attn::store(a.z * inv, out + 2);
        attn::store(a.w * inv, out + 3);
    }
    if (tid == 0) counters[blockIdx.x] = 0;
}

// The pointers and sizes every launch passes on.
struct Args {
    const void *q, *kp, *vp, *table, *lengths;
    void *o, *part, *counters;
    int B, H, KH, mp, page, nsplit;
    const long long* st;
    float scale;
    cudaStream_t stream;
};

template <typename TQ, typename TKV, int D, int R>
int launch(const Args& a) {
    constexpr int W = warps<TKV, D, R>();
    constexpr int bytes = smem_bytes<TKV, D, R>(W);
    auto kern = paged_split_kernel<TQ, TKV, D, R>;
    if (bytes > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (e != cudaSuccess) return (int)e;
    }
    const int G = a.H / a.KH;
    const dim3 grid(a.B * a.KH * ((G + R - 1) / R), a.nsplit);
    kern<<<grid, W * 32, bytes, a.stream>>>(
        (const TQ*)a.q, (const TKV*)a.kp, (const TKV*)a.vp,
        (const int*)a.table, (const int*)a.lengths, (TQ*)a.o,
        (float*)a.part, (int*)a.counters, a.H, a.KH, a.mp, a.page, a.st[0],
        a.st[1], a.st[2], a.st[3], a.st[4], a.st[5], a.scale);
    return (int)cudaGetLastError();
}

// rows a CTA carries: G itself for G of 1, 2, 4 or 8, else the next of
// those (groups of 8 beyond)
template <typename TQ, typename TKV, int D>
int launch_rows(const Args& a) {
    const int G = a.H / a.KH;
    if (G <= 1) return launch<TQ, TKV, D, 1>(a);
    if (G <= 2) return launch<TQ, TKV, D, 2>(a);
    if (G <= 4) return launch<TQ, TKV, D, 4>(a);
    return launch<TQ, TKV, D, 8>(a);
}

template <typename TQ, typename TKV>
int dispatch(int D, const Args& a) {
    switch (D) {
        case 16: return launch_rows<TQ, TKV, 16>(a);
        case 32: return launch_rows<TQ, TKV, 32>(a);
        case 64: return launch_rows<TQ, TKV, 64>(a);
        case 80: return launch_rows<TQ, TKV, 80>(a);
        case 128: return launch_rows<TQ, TKV, 128>(a);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtypes: 0 f32 q and pools, 1 bf16 q and pools, 2 f32 q with bf16
// pools. strides: 6 element strides, (kv head, page, row) of the K pool
// then of the V pool. q and o are contiguous (B, H, D); table is int32
// (B, mp), lengths int32 (B,). nsplit >= 1 splits of each sequence;
// with nsplit > 1, part is f32 scratch of B·H·nsplit·(D + 2) floats and
// counters B·KH·ceil(G / R) int32 zeros, which the kernel leaves zero.
extern "C" int paged_attention_fwd(int dtypes, int D, const void* q,
                                   const void* k_pool, const void* v_pool,
                                   const void* table, const void* lengths,
                                   void* o, int B, int H, int KH, int mp,
                                   int page, const void* strides, float scale,
                                   int nsplit, void* part, void* counters,
                                   void* stream) {
    if (B == 0) return 0;
    if (nsplit < 1 || (nsplit > 1 && (!part || !counters)))
        return (int)cudaErrorInvalidValue;
    const Args a{q, k_pool, v_pool, table, lengths, o, part, counters, B, H,
                 KH, mp, page, nsplit, (const long long*)strides, scale,
                 (cudaStream_t)stream};
    switch (dtypes) {
        case 0: return dispatch<float, float>(D, a);
        case 1: return dispatch<__nv_bfloat16, __nv_bfloat16>(D, a);
        case 2: return dispatch<float, __nv_bfloat16>(D, a);
    }
    return (int)cudaErrorInvalidValue;
}
