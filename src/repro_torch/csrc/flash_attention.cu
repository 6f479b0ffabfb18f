// K4 flash_attention: blockwise online-softmax prefill attention with
// GQA, causal masking, an optional sliding window and ragged lengths.
//
// Replaces the Pallas kernel flash_attention._kernel / flash_attention
// of src/repro/kernels/flash_attention.py. The TPU version walks the K
// blocks of one (b, h, q block) in order and carries m, l and the
// (bq, D) accumulator in VMEM scratch. Here a CTA owns one (b, h, q
// block) and walks the key tiles the block can see; key tiles that no
// row of the block can see (above the causal diagonal, left of the
// window) are never loaded: the Pallas kernel's block pruning, from the
// tile bounds. Ragged Sq and Sk are bounds checks and zero-filled
// copies, not padding. Every tensor is read and written through
// explicit strides, so the model's (B, S, H, D) activations pass
// without a copy.
//
// Bound on an H100: operations, 4·D FLOPs per visible (q, k) pair,
// which only the tensor cores reach. So the two dtypes take two routes:
//
// * bf16 (flash_tc_kernel), on the tensor cores. A CTA is two consumer
//   warpgroups of 64 query rows each and one producer warp. For GQA the
//   two warpgroups take two heads of one kv group at the same rows, so
//   each K/V tile is loaded once for both; a group of one head (zamba2)
//   gives them 128 consecutive rows instead. The grid runs the q blocks
//   with the most keys first (blockIdx.y counts down the diagonal), so
//   the second wave is the short blocks.
//   - S = Q·Kᵀ is wgmma m64n64k16 over D/16 steps, Q and a 64-key K
//     tile both read from shared memory. S is scaled by D^-0.5 in f32
//     after the product: scaling bf16 Q first would add a rounding at
//     D = 80, whose scale is no power of two.
//   - The masks go on the accumulator fragment, only on tiles that
//     cross a mask boundary; the row max and sum take two shuffles over
//     the 4 lanes that share a row; the exponentials are MUFU ex2.
//   - P is rounded to bf16 in registers and is the register A operand
//     of O += P·V, with V read MN-major through the transpose bit. That
//     is the one rounding the f32 Pallas kernel does not have.
//   - S(t) is issued together with P(t-1)·V(t-1), so the tensor cores
//     run one tile's second product while the warpgroup computes the
//     next tile's softmax. No product is issued under a condition the
//     compiler cannot prove warp-uniform (ptxas would serialize them).
//   - The producer warp fills a 3-stage K/V ring with the tensor memory
//     accelerator (TMA), behind mbarriers: full when a stage's bytes
//     have landed, empty when both warpgroups have read it. The tiles
//     stay bf16. With cp.async instead (a producer warpgroup of 16-byte
//     copies into an unswizzled layout) the kernel was bound by its
//     loads; TMA moves whole 128-byte rows from one thread. Its tensor
//     maps are encoded on the host at each call (the views change),
//     three to six of them, a small cost beside the wrapper's own.
//   - Layout (Tile<D>): the first 64·(D/64) columns of a tile in the
//     128-byte swizzle, the rest (D = 80's last 16, all of D = 16 and
//     32) as unswizzled 16-byte column blocks. 80's 160-byte rows do not
//     tile the 128-byte atom; both layouts are wgmma-readable in both
//     operand orders, and a k16 step or a 64/16-column slice of P·V
//     never spans both.
// * f32 (flash_attention_kernel): the tensor cores would compute in
//   TF32, beyond the f32 tolerance, so f32 stays on the CUDA cores: 8
//   warps × 8 rows a CTA, each warp carrying its rows in registers
//   (attention_tile.cuh), the CTA staging each 32-key tile in shared
//   memory as f32.
#include <cuda.h>
#include <cudaTypedefs.h>

#include <type_traits>

#include "attention_tile.cuh"
#include "wgmma.cuh"

namespace {

// ------------------------------------------------- bf16: tensor cores
namespace tc {

constexpr int WGS = 2;                 // consumer warpgroups a CTA
constexpr int CONSUMERS = 128 * WGS;
constexpr int THREADS = CONSUMERS + 32;   // and a producer warp
constexpr int BQ = 64;                 // query rows a warpgroup
constexpr int BK = 64;                 // keys a tile
constexpr int STAGES = 3;              // K/V ring
constexpr int BARS = 1024;             // mbarriers; tiles 1 KiB aligned
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int tile_bytes() { return BK * D * 2; }
template <int D>
__host__ __device__ constexpr int smem_bytes() {   // + alignment slack
    return 1024 + BARS + WGS * BQ * D * 2 + STAGES * 2 * tile_bytes<D>();
}
static_assert(smem_bytes<128>() <= 232448,
              "per-CTA shared memory above the H100's opt-in limit");
static_assert((2 * STAGES + 1) * 8 <= BARS, "mbarrier space");

// A tile of 64 rows × D bf16 in shared memory is D/64 parts of 64
// columns, part p at byte 8192·p, each 64 rows of 128 bytes with the
// 128-byte swizzle (one TMA box of full 128-byte rows: whole sectors from
// L2), then the (D % 64)/8 remaining 16-byte column blocks (80's last 16
// columns, all of 16 and 32), block c at 8192·(D/64) + 1024·c, each 64
// rows × 16 bytes unswizzled (a TMA box each). Both read K-major for S =
// Q·Kᵀ and MN-major for O += P·V.
template <int D>
struct Tile {
    static constexpr int NA = D / 64;           // swizzled 64-column parts
    static constexpr int NT = (D % 64) / 8;     // 16-byte column blocks
    static constexpr int TAIL_AT = 8192 * NA;   // their offset

    // the K-major operand of k16 step kk (columns 16kk..16kk+15)
    __device__ static uint64_t k_major(uint32_t base, int kk) {
        if (kk < 4 * NA)   // 32 bytes a step inside the swizzled rows
            return wg::desc_sw128(base + 8192 * (kk / 4) + 32 * (kk % 4),
                                  16, 1024);
        return wg::desc(base + TAIL_AT + 2048 * (kk - 4 * NA), 1024, 128);
    }
};

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int row, int head, int b,
                                         uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        :: "r"(dst), "l"(map), "r"(col), "r"(row), "r"(head), "r"(b),
           "r"(bar) : "memory");
}

// One 64-row tile: its swizzled parts from map `sw`, its 16-byte blocks
// from map `tl`.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* sw,
                                         const CUtensorMap* tl, int row,
                                         int head, int b, uint32_t bar) {
#pragma unroll
    for (int p = 0; p < Tile<D>::NA; ++p)
        tma_load(dst + 8192 * p, sw, 64 * p, row, head, b, bar);
#pragma unroll
    for (int c = 0; c < Tile<D>::NT; ++c)
        tma_load(dst + Tile<D>::TAIL_AT + 1024 * c, tl,
                 64 * Tile<D>::NA + 8 * c, row, head, b, bar);
}

// O[:, 64p, 64p + 64) += P·V for swizzled part p (p < 2)
template <int N, int NO>
__device__ __forceinline__ void rs_part(int p, float (&acc)[NO],
                                        const uint32_t (&a)[4], uint64_t b) {
    if (p == 0) wg::rs_mn<N, 0>(acc, a, b);
    if constexpr (NO >= 64) {
        if (p == 1) wg::rs_mn<N, 32>(acc, a, b);
    }
}

// One consumer warpgroup (wgi) of flash_tc_kernel: rows q0 + 16·warp +
// lane/4 (+8) of head h, over the CTA's ntiles key tiles. Tile t's
// S(t) = Q·K(t)ᵀ is issued together with O += P(t-1)·V(t-1), so the
// tensor cores run the previous tile's product while this warpgroup
// computes the softmax of S(t). No product is issued under a condition
// the compiler cannot prove uniform, which would serialize them.
template <int D>
__device__ __forceinline__ void consume(
        int wgi, int lane, int warp, int h_cta, int q_cta, int pair, int b,
        int Sq, int Sk, int causal, int window, float scale_log2,
        int k_begin, int ntiles, uint32_t bars, uint32_t q_s, uint32_t kv_s,
        __nv_bfloat16* __restrict__ o, long long osb, long long osh,
        long long oss) {
    constexpr int NO = D / 2;            // O accumulator floats a thread
    constexpr int QB = BQ * D * 2;
    constexpr int TB = tile_bytes<D>();
    auto full = [&](int st) { return bars + 8 * st; };
    auto empty = [&](int st) { return bars + 8 * (STAGES + st); };
    const int h = h_cta + (pair ? wgi : 0);
    const int q0 = q_cta + (pair ? 0 : wgi * BQ);
    // a tile within [full_lo, full_hi) is visible to each of its rows
    const int full_lo = window > 0
        ? max(0, min(Sq, q0 + BQ) - 1 - window + 1) : 0;
    const int full_hi = causal ? min(Sk, q0 + 1) : Sk;
    int lo[2], hi[2];   // visible keys of row i: lo[i] <= key < hi[i]
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int qi = q0 + 16 * warp + (lane >> 2) + 8 * i;
        hi[i] = causal ? min(Sk, qi + 1) : Sk;
        lo[i] = window > 0 ? max(0, qi - window + 1) : 0;
    }
    float acc[NO], m[2], l[2];
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        m[i] = attn::NEG_INF;
        l[i] = 0.0f;   // this thread's part of the row sum
    }
    const uint32_t q_w = q_s + wgi * QB;
    uint32_t pa[4][4];   // P(t-1): the A fragments of its four k16 steps
    float s[32];

    auto wait_tile = [&](int t) {
        wg::mbar_wait(full(t % STAGES), (t / STAGES) & 1);
    };
    auto issue_s = [&](int t) {
        const uint32_t k_s = kv_s + (t % STAGES) * 2 * TB;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            wg::ss_m64n64(s, Tile<D>::k_major(q_w, kk),
                          Tile<D>::k_major(k_s, kk), kk > 0);
        wg::commit();
    };
    auto issue_pv = [&](int t) {
        const uint32_t v_s = kv_s + (t % STAGES) * 2 * TB + TB;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {   // keys 16kk..16kk+15
            if constexpr (Tile<D>::NA > 0) {
#pragma unroll
                for (int p = 0; p < Tile<D>::NA; ++p)
                    rs_part<64>(p, acc, pa[kk],
                                wg::desc_sw128(v_s + 8192 * p + 2048 * kk,
                                               8192, 1024));
            }
            if constexpr (Tile<D>::NT > 0)
                wg::rs_mn<8 * Tile<D>::NT, 32 * Tile<D>::NA>(
                    acc, pa[kk],
                    wg::desc(v_s + Tile<D>::TAIL_AT + 256 * kk, 128, 1024));
        }
        wg::commit();
    };
    auto release = [&](int t) {
        __syncwarp();
        if (lane == 0) wg::mbar_arrive(empty(t % STAGES));
    };
    // scale and mask S(t), fold it into the running max and sum, and
    // leave P(t) in s; returns nothing, writes corr
    float corr[2];
    auto softmax = [&](int t) {
        // s[4j + 2i + e]: row i, key k0 + 8j + 2·(lane % 4) + e
        const int k0 = k_begin + t * BK;
        if (k0 < full_lo || k0 + BK > full_hi) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int i = e >> 1;
                    const int key = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
                    s[4 * j + e] = (key >= lo[i] && key < hi[i])
                                       ? s[4 * j + e] * scale_log2
                                       : attn::NEG_INF;
                }
        } else {
#pragma unroll
            for (int j = 0; j < 32; ++j) s[j] *= scale_log2;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            float mx = attn::NEG_INF;
#pragma unroll
            for (int j = 0; j < 8; ++j)
                mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m[i], mx);
            corr[i] = wg::exp2_approx(m[i] - m_new);
            m[i] = m_new;
            float sum = 0.0f;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float p =
                        wg::exp2_approx(s[4 * j + 2 * i + e] - m_new);
                    s[4 * j + 2 * i + e] = p;
                    sum += p;
                }
            l[i] = l[i] * corr[i] + sum;
        }
    };
    // O *= corr, and P(t) becomes the A operand of the next P·V: the S
    // fragment of keys 16kk..16kk+15 is the A fragment of k16 step kk
    auto rescale_and_pack = [&]() {
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                acc[4 * j + 2 * i] *= corr[i];
                acc[4 * j + 2 * i + 1] *= corr[i];
            }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r)
                pa[kk][r] = wg::pack_bf16(s[8 * kk + 2 * r],
                                          s[8 * kk + 2 * r + 1]);
    };

    wg::mbar_wait(bars + 8 * 2 * STAGES, 0);   // Q has landed
    if (ntiles > 0) {
        wait_tile(0);
        wg::fence();
        issue_s(0);
        wg::wait<0>();
        wg::fence_operand(s);
        softmax(0);
        rescale_and_pack();
        for (int t = 1; t < ntiles; ++t) {
            wait_tile(t);
            wg::fence_operand(acc);
            wg::fence();
            issue_s(t);
            issue_pv(t - 1);
            wg::wait<1>();
            wg::fence_operand(s);
            softmax(t);
            wg::wait<0>();
            wg::fence_operand(acc);
            release(t - 1);
            rescale_and_pack();
        }
        wg::fence_operand(acc);
        wg::fence();
        issue_pv(ntiles - 1);
        wg::wait<0>();
        wg::fence_operand(acc);
        release(ntiles - 1);
    }

    __nv_bfloat16* op = o + b * osb + h * osh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        float sum = l[i];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float inv = 1.0f / fmaxf(sum, 1e-30f);
        const int qi = q0 + 16 * warp + (lane >> 2) + 8 * i;
        if (qi >= Sq) continue;
        __nv_bfloat16* row = op + (long long)qi * oss + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
                __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv,
                                      acc[4 * j + 2 * i + 1] * inv);
    }
}

// A CTA's two warpgroups take either two heads of one kv group at the
// same 64 rows (pair: they read the same K/V tiles), or 128 consecutive
// rows of one head when the group is a single head or odd; both walk
// every key tile either of them sees (a tile one of them cannot see is
// fully masked for it, which is exact).
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_tc_kernel(const __grid_constant__ CUtensorMap qsw,
                const __grid_constant__ CUtensorMap qtl,
                const __grid_constant__ CUtensorMap ksw,
                const __grid_constant__ CUtensorMap ktl,
                const __grid_constant__ CUtensorMap vsw,
                const __grid_constant__ CUtensorMap vtl,
                __nv_bfloat16* __restrict__ o, int H, int KH, int Sq, int Sk,
                long long osb, long long osh, long long oss, int causal,
                int window, float scale_log2, int pair) {
    constexpr int QB = BQ * D * 2;       // bytes of a warpgroup's Q
    constexpr int TB = tile_bytes<D>();
    extern __shared__ unsigned char smem[];
    const uint32_t bars = (wg::smem_addr(smem) + 1023) & ~1023u;
    const uint32_t q_s = bars + BARS;                  // [WGS][BQ][D]
    const uint32_t kv_s = q_s + WGS * QB;              // stage s: K, V
    auto full = [&](int st) { return bars + 8 * st; };
    auto empty = [&](int st) { return bars + 8 * (STAGES + st); };
    const uint32_t q_full = bars + 8 * 2 * STAGES;

    const int tid = threadIdx.x;
    // the longest q blocks first: blockIdx.y counts down the diagonal
    const int yq = gridDim.y - 1 - blockIdx.y;
    const int hs = pair ? H / 2 : H;
    const int b = blockIdx.x / hs;
    const int h_cta = (blockIdx.x % hs) * (pair ? 2 : 1);
    const int q_cta = yq * (pair ? BQ : WGS * BQ);
    const int kh = h_cta / (H / KH);

    // key tiles either warpgroup sees: [k_begin, k_begin + ntiles·BK)
    const int q_last = min(Sq, q_cta + (pair ? BQ : WGS * BQ)) - 1;
    const int k_end = causal ? min(Sk, q_last + 1) : Sk;
    int k_begin = window > 0 ? max(0, q_cta - window + 1) : 0;
    k_begin -= k_begin % BK;
    const int ntiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

    if (tid == 0) {
        for (int st = 0; st < STAGES; ++st) {
            wg::mbar_init(full(st), 1);
            wg::mbar_init(empty(st), CONSUMERS / 32);
        }
        wg::mbar_init(q_full, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // the role, provably uniform across each warp (shuffled from lane 0)
    // so that the compiler keeps the warpgroup products asynchronous
    const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
    const int lane = tid & 31;
    if (role == WGS) {
        // producer warp, one thread: Q of both warpgroups, then the K/V
        // tiles into the ring, each stage once both have released it;
        // the tensor memory accelerator zero-fills rows past Sq and Sk
        if (lane == 0) {
            wg::mbar_expect_tx(q_full, WGS * QB);
#pragma unroll
            for (int w = 0; w < WGS; ++w)
                tma_tile<D>(q_s + w * QB, &qsw, &qtl,
                            q_cta + (pair ? 0 : w * BQ),
                            h_cta + (pair ? w : 0), b, q_full);
            for (int t = 0; t < ntiles; ++t) {
                const int st = t % STAGES;
                if (t >= STAGES)
                    wg::mbar_wait(empty(st), ((t / STAGES) & 1) ^ 1);
                const uint32_t dst = kv_s + st * 2 * TB;
                const int k1 = k_begin + t * BK;
                wg::mbar_expect_tx(full(st), 2 * TB);
                tma_tile<D>(dst, &ksw, &ktl, k1, kh, b, full(st));
                tma_tile<D>(dst + TB, &vsw, &vtl, k1, kh, b, full(st));
            }
        }
    } else {
        consume<D>(role, lane, (tid >> 5) & 3, h_cta, q_cta, pair, b, Sq, Sk,
                   causal, window, scale_log2, k_begin, ntiles, bars, q_s,
                   kv_s, o, osb, osh, oss);
    }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda)
PFN_cuTensorMapEncodeTiled_v12000 encoder() {
    static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult res;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                    cudaEnableDefault, &res) == cudaSuccess
            && res == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    }
    return fn;
}

// A (B, heads, S, D) bf16 view with element strides (sb, sh, ss) as a 4-D
// tensor map of boxes of 64 rows × `cols` columns: 64 with the 128-byte
// swizzle, or 8 without.
bool tensor_map(CUtensorMap* map, const void* base, int B, int heads, int S,
                int D, long long sb, long long sh, long long ss, int cols) {
    auto enc = encoder();
    if (!enc) return false;
    // a stride of a dimension of size 1 is never used; TMA wants it valid.
    // Sk = 0 leaves no tile to load, but a map needs a row.
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)(S > 1 ? S : 1),
                                (cuuint64_t)heads, (cuuint64_t)B};
    const cuuint64_t strides[3] = {
        (cuuint64_t)(S > 1 ? ss : D) * 2, (cuuint64_t)(heads > 1 ? sh : D) * 2,
        (cuuint64_t)(B > 1 ? sb : D) * 2};
    const cuuint32_t box[4] = {(cuuint32_t)cols, BQ, 1, 1};
    const cuuint32_t estr[4] = {1, 1, 1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
               const_cast<void*>(base), dims, strides, box, estr,
               CU_TENSOR_MAP_INTERLEAVE_NONE,
               cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KH, int Sq, int Sk, const long long* st, int causal,
           int window, float scale, cudaStream_t stream) {
    constexpr int bytes = smem_bytes<D>();
    auto kern = flash_tc_kernel<D>;
    if (bytes > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (e != cudaSuccess) return (int)e;
    }
    // per tensor a map for the swizzled parts and one for the 16-byte
    // blocks, where the head dim has them (an unused map stays zero)
    CUtensorMap m[6] = {};
    const void* base[3] = {q, k, v};
    const int heads[3] = {H, KH, KH}, len[3] = {Sq, Sk, Sk};
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 2; ++j) {
            if ((j == 0 ? Tile<D>::NA : Tile<D>::NT) == 0) continue;
            if (!tensor_map(&m[2 * i + j], base[i], B, heads[i], len[i], D,
                            st[3 * i], st[3 * i + 1], st[3 * i + 2],
                            j == 0 ? 64 : 8))
                return (int)cudaErrorInvalidValue;
        }
    const int pair = (H / KH) % 2 == 0;
    const int rows = pair ? BQ : WGS * BQ;
    const dim3 grid(B * (pair ? H / 2 : H), (Sq + rows - 1) / rows);
    kern<<<grid, THREADS, bytes, stream>>>(
        m[0], m[1], m[2], m[3], m[4], m[5], (__nv_bfloat16*)o, H, KH, Sq, Sk,
        st[9], st[10], st[11],
        causal, window, scale * LOG2E, pair);
    return (int)cudaGetLastError();
}

}  // namespace tc

// --------------------------------------------------- f32: CUDA cores
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

// bf16 on the tensor cores, f32 on the CUDA cores
template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KH, int Sq, int Sk, const long long* st, int causal,
           int window, float scale, cudaStream_t stream) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        return tc::launch<D>(q, k, v, o, B, H, KH, Sq, Sk, st, causal,
                             window, scale, stream);
    } else {
        constexpr int bytes = smem_floats<D>() * 4;
        auto kern = flash_attention_kernel<T, D>;
        if (bytes > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
            if (e != cudaSuccess) return (int)e;
        }
        const dim3 grid((Sq + BQ - 1) / BQ, H, B);
        kern<<<grid, WARPS * 32, bytes, stream>>>(
            (const T*)q, (const T*)k, (const T*)v, (T*)o, H, KH, Sq, Sk,
            st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
            st[9], st[10], st[11], causal, window, scale);
        return (int)cudaGetLastError();
    }
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
