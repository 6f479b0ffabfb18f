// K2 row_draw: per row (node, tenant) and column, a standard normal from
// the row's threefry key, the latency scale·exp(sigma·z), the SLO
// violation flag and the row's masked latency sum and violation count.
//
// Replaces the jit-fused bodies _fused_impl, _dense_impl and
// _jitter_impl of src/repro/sim/engines/jax_backend.py:109-142. The
// uniform follows jax.random.normal bit for bit: bits =
// threefry2x32(key, (0, col)) as x0 ^ x1, u = max(lo, ((bits >> 9 |
// 1.0f) - 1)·(1 - lo) + lo) with lo = nextafter(-1, 0), z =
// sqrt(2)·erfinv(u).
//
// Modes: dense (mask = active[row, col]), fused (mask = col <
// totals[row]) and jitter (writes exp(sigma·z) only; no mask, no
// reductions).
//
// Bound: operations. About 74 32-bit integer operations a cell for the
// 20 threefry rounds and 31 float ones (erfinvf and expf at their
// inlined length) against about 6 bytes of traffic, so the issue rate
// and not device memory limits it. The layout spends as few
// instructions as it can outside the cells' own arithmetic:
//
// * Short rows (cols <= short_max, the stream fleets' 120 seconds):
//   one warp per row, several rows a CTA, a persistent grid that walks
//   the rows grid-stride. No block of threads idles on a row shorter
//   than itself, and the next row's key, sigma, scale, SLO and total
//   are loaded before the current row's draws, so their latency hides
//   behind the arithmetic.
// * Every lane takes V consecutive columns: V independent threefry
//   chains a thread, which the scheduler overlaps, and one V-wide
//   access of active, lat and viol (a 32-bit load, a float4 store and
//   a 32-bit store for V = 4) where cols % V == 0 and the pointers are
//   aligned; the same layout with scalar accesses otherwise (an odd
//   last chunk, a row slice of active that starts off a word).
// * A short row's sums are the lanes' own partial sums and five warp
//   shuffles (the count one integer reduction): no shared memory, no
//   __syncthreads. Wide rows (the game
//   fleets' L = 6,848) keep a CTA per row and the warp-then-block
//   reduction, amortised over thousands of cells.
//
// The sweep in chip_smoke.py's kernels phase chose the layout that
// fleet.ROW_DRAW_LAYOUT passes in.
//
// Built with -fmad=false so that every float product and sum rounds
// where the plain torch version rounds it: lat and viol equal it bit
// for bit; the row sums are taken in another order (lane partials,
// then the shuffle tree).
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

enum { MODE_DENSE = 0, MODE_FUSED = 1, MODE_JITTER = 2 };
// the most warps a CTA may have: keeps the register cap at 128 a thread
constexpr int kMaxWarps = 16;

struct RowDrawArgs {
    const uint32_t* k0;
    const uint32_t* k1;
    const uint8_t* active;
    const int32_t* totals;
    const float* scale;
    const float* sigma;
    const float* slo;
    float* lat;
    uint8_t* viol;
    float* lat_sum;
    int32_t* viol_count;
    long long rows, cols;
    uint32_t chunk_word;
    float lo, span;
};

// what one row needs besides its cells
struct RowKey {
    uint32_t k0, k1;
    float sigma, scale, slo;
    long long total;
};

template <int MODE>
__device__ __forceinline__ RowKey load_row(const RowDrawArgs& a,
                                           long long row) {
    RowKey p;
    p.k0 = a.k0[row];
    p.k1 = a.k1[row] ^ a.chunk_word;
    p.sigma = a.sigma[row];
    p.scale = 0.0f;
    p.slo = 0.0f;
    p.total = 0;
    if (MODE != MODE_JITTER) {
        p.scale = a.scale[row];
        p.slo = a.slo[row];
    }
    if (MODE == MODE_FUSED) p.total = a.totals[row];
    return p;
}

// V floats and V flag bytes as one access
template <int V>
struct Pack;
template <>
struct Pack<2> {
    using Word = uint16_t;
    static __device__ __forceinline__ void store(float* p, const float* l) {
        *reinterpret_cast<float2*>(p) = make_float2(l[0], l[1]);
    }
};
template <>
struct Pack<4> {
    using Word = uint32_t;
    static __device__ __forceinline__ void store(float* p, const float* l) {
        *reinterpret_cast<float4*>(p) = make_float4(l[0], l[1], l[2], l[3]);
    }
};

__device__ __forceinline__ float normal_from_bits(uint32_t bits, float lo,
                                                  float span) {
    const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    const float u = fmaxf(lo, f * span + lo);
    return 0x1.6a09e6p+0f * erfinvf(u);  // float32(sqrt(2))
}

// Columns c0 .. c0 + V - 1 of one row (act, lat, viol point at the
// row's first cell). VEC: all V columns are inside the row and the
// V-wide accesses are aligned. The masked latencies are added to acc in
// column order.
template <int MODE, int V, int VEC>
__device__ __forceinline__ void draw_cells(const RowKey& p, long long c0,
                                           long long cols,
                                           const uint8_t* __restrict__ act,
                                           float* __restrict__ lat,
                                           uint8_t* __restrict__ viol,
                                           float lo, float span, float& acc,
                                           int& cnt) {
    using Word = typename Pack<V>::Word;
    bool m[V];
    if (MODE == MODE_DENSE) {
        if (VEC) {
            const Word w = *reinterpret_cast<const Word*>(act + c0);
#pragma unroll
            for (int j = 0; j < V; ++j) m[j] = ((w >> (8 * j)) & 0xFFu) != 0;
        } else {
#pragma unroll
            for (int j = 0; j < V; ++j)
                m[j] = c0 + j < cols && act[c0 + j] != 0;
        }
    } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
            m[j] = (VEC || c0 + j < cols) && c0 + j < p.total;
    }
    uint32_t bits[V];
#pragma unroll
    for (int j = 0; j < V; ++j)
        bits[j] = threefry2x32_xor(p.k0, p.k1, 0u, (uint32_t)(c0 + j));
    float l[V];
    uint8_t v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
        const float e = expf(normal_from_bits(bits[j], lo, span) * p.sigma);
        l[j] = MODE == MODE_JITTER ? e : p.scale * e;
        v[j] = (MODE != MODE_JITTER && m[j] && l[j] > p.slo) ? 1 : 0;
        if (MODE != MODE_JITTER) {
            if (m[j]) acc += l[j];
            cnt += v[j];
        }
    }
    if (VEC) {
        Pack<V>::store(lat + c0, l);
        if (MODE != MODE_JITTER) {
            Word w = 0;
#pragma unroll
            for (int j = 0; j < V; ++j) w |= (Word)(v[j] << (8 * j));
            *reinterpret_cast<Word*>(viol + c0) = w;
        }
    } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
            if (c0 + j < cols) {
                lat[c0 + j] = l[j];
                if (MODE != MODE_JITTER) viol[c0 + j] = v[j];
            }
        }
    }
}

// the f32 sum in lane 0 after five shuffles; the count in every lane
// after one integer reduction (exact in any order)
__device__ __forceinline__ void warp_sum(float& acc, int& cnt) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, o);
    cnt = (int)__reduce_add_sync(0xffffffffu, (unsigned)cnt);
}

// a warp per row, rows grid-stride, the next row's key loaded ahead
template <int MODE, int V, int VEC>
__device__ __forceinline__ void short_rows(const RowDrawArgs& a) {
    const int lane = threadIdx.x & 31;
    const long long per_cta = blockDim.x >> 5;
    const long long stride = (long long)gridDim.x * per_cta;
    long long row = (long long)blockIdx.x * per_cta + (threadIdx.x >> 5);
    if (row >= a.rows) return;
    RowKey p = load_row<MODE>(a, row);
    while (true) {
        const long long next = row + stride;
        RowKey q = p;
        if (next < a.rows) q = load_row<MODE>(a, next);
        const long long base = row * a.cols;
        float acc = 0.0f;
        int cnt = 0;
        for (long long c0 = (long long)lane * V; c0 < a.cols; c0 += 32 * V)
            draw_cells<MODE, V, VEC>(
                p, c0, a.cols, MODE == MODE_DENSE ? a.active + base : nullptr,
                a.lat + base, MODE == MODE_JITTER ? nullptr : a.viol + base,
                a.lo, a.span, acc, cnt);
        if (MODE != MODE_JITTER) {
            warp_sum(acc, cnt);
            if (lane == 0) {
                a.lat_sum[row] = acc;
                a.viol_count[row] = cnt;
            }
        }
        if (next >= a.rows) break;
        row = next;
        p = q;
    }
}

// a CTA per row; lane partials, warp shuffles, then one warp over the
// warps' sums
template <int MODE, int V, int VEC>
__device__ __forceinline__ void wide_row(const RowDrawArgs& a) {
    const long long row = blockIdx.x;
    const RowKey p = load_row<MODE>(a, row);
    const long long base = row * a.cols;
    float acc = 0.0f;
    int cnt = 0;
    for (long long c0 = (long long)threadIdx.x * V; c0 < a.cols;
         c0 += (long long)blockDim.x * V)
        draw_cells<MODE, V, VEC>(
            p, c0, a.cols, MODE == MODE_DENSE ? a.active + base : nullptr,
            a.lat + base, MODE == MODE_JITTER ? nullptr : a.viol + base,
            a.lo, a.span, acc, cnt);
    if (MODE == MODE_JITTER) return;
    __shared__ float s_acc[kMaxWarps];
    __shared__ int s_cnt[kMaxWarps];
    warp_sum(acc, cnt);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
        s_acc[warp] = acc;
        s_cnt[warp] = cnt;
    }
    __syncthreads();
    if (warp == 0) {
        const int nw = blockDim.x >> 5;
        acc = lane < nw ? s_acc[lane] : 0.0f;
        cnt = lane < nw ? s_cnt[lane] : 0;
        warp_sum(acc, cnt);
        if (lane == 0) {
            a.lat_sum[row] = acc;
            a.viol_count[row] = cnt;
        }
    }
}

// MODE, V, VEC (V-wide accesses) and WIDE (a CTA per row) as ints, so
// that the assembler's report names them as numbers
template <int MODE, int V, int VEC, int WIDE>
__global__ void __launch_bounds__(kMaxWarps * 32)
    row_draw_kernel(const RowDrawArgs a) {
    if (WIDE)
        wide_row<MODE, V, VEC>(a);
    else
        short_rows<MODE, V, VEC>(a);
}

template <int MODE, int V, int VEC, int WIDE>
static int launch(const RowDrawArgs& a, int warps, cudaStream_t s) {
    const auto kernel = row_draw_kernel<MODE, V, VEC, WIDE>;
    const int threads = warps * 32;
    long long grid = a.rows;
    if (!WIDE) {
        // persistent: as many CTAs as stay resident, rows grid-stride
        // (the count is kept per instantiation, CTA size and device)
        static int fill_dev[kMaxWarps + 1];
        static long long fill[kMaxWarps + 1];
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return (int)err;
        if (fill[warps] == 0 || fill_dev[warps] != dev) {
            int sms = 0, per_sm = 0;
            err = cudaDeviceGetAttribute(&sms,
                                         cudaDevAttrMultiProcessorCount, dev);
            if (err == cudaSuccess)
                err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, kernel, threads, 0);
            if (err != cudaSuccess) return (int)err;
            fill[warps] = (long long)sms * (per_sm > 0 ? per_sm : 1);
            fill_dev[warps] = dev;
        }
        grid = (a.rows + warps - 1) / warps;
        if (grid > fill[warps]) grid = fill[warps];
    }
    kernel<<<(unsigned)grid, threads, 0, s>>>(a);
    return (int)cudaGetLastError();
}

template <int MODE, int V>
static int launch_v(const RowDrawArgs& a, bool vec, bool wide, int warps,
                    cudaStream_t s) {
    if (wide)
        return vec ? launch<MODE, V, 1, 1>(a, warps, s)
                   : launch<MODE, V, 0, 1>(a, warps, s);
    return vec ? launch<MODE, V, 1, 0>(a, warps, s)
               : launch<MODE, V, 0, 0>(a, warps, s);
}

template <int MODE>
static int launch_mode(const RowDrawArgs& a, int v, bool vec, bool wide,
                       int warps, cudaStream_t s) {
    if (v == 2) return launch_v<MODE, 2>(a, vec, wide, warps, s);
    return launch_v<MODE, 4>(a, vec, wide, warps, s);
}

static bool aligned(const void* p, int bytes) {
    return p == nullptr || (uintptr_t)p % (uintptr_t)bytes == 0;
}

// The layout: rows of at most short_max columns take a warp each,
// short_warps rows a CTA, short_v columns a lane; longer rows a CTA of
// wide_warps warps each, wide_v columns a thread. V is 2 or 4.
extern "C" int row_draw_f32(int mode, const void* k0, const void* k1,
                            unsigned int chunk_word, const void* active,
                            const void* totals, const void* scale,
                            const void* sigma, const void* slo, void* lat,
                            void* viol, void* lat_sum, void* viol_count,
                            long long rows, long long cols, float lo,
                            float span, int short_v, int short_warps,
                            long long short_max, int wide_v, int wide_warps,
                            void* stream) {
    const bool wide = cols > short_max;
    const int v = wide ? wide_v : short_v;
    const int warps = wide ? wide_warps : short_warps;
    if ((v != 2 && v != 4) || warps < 1 || warps > kMaxWarps || mode < 0 ||
        mode > MODE_JITTER)
        return (int)cudaErrorInvalidValue;
    if (rows == 0 || cols == 0) return 0;
    const RowDrawArgs a{(const uint32_t*)k0, (const uint32_t*)k1,
                        (const uint8_t*)active, (const int32_t*)totals,
                        (const float*)scale, (const float*)sigma,
                        (const float*)slo, (float*)lat, (uint8_t*)viol,
                        (float*)lat_sum, (int32_t*)viol_count, rows, cols,
                        (uint32_t)chunk_word, lo, span};
    // the V-wide path needs every row to start on a V-cell boundary
    const bool vec = cols % v == 0 && aligned(lat, 4 * v) &&
                     (mode == MODE_JITTER || aligned(viol, v)) &&
                     (mode != MODE_DENSE || aligned(active, v));
    cudaStream_t s = (cudaStream_t)stream;
    switch (mode) {
        case MODE_DENSE:
            return launch_mode<MODE_DENSE>(a, v, vec, wide, warps, s);
        case MODE_FUSED:
            return launch_mode<MODE_FUSED>(a, v, vec, wide, warps, s);
        default:
            return launch_mode<MODE_JITTER>(a, v, vec, wide, warps, s);
    }
}
