// K3 and K9b: the packed layer 0's backward, dA[g] = decode(bytes[g])[:, :n] dz[g].
//
// K3 replaces rs_bann_tpu/ops/packed_matmul.py::_bwd_fused_kernel (called
// through _pallas_bwd_fused, the VJP of packed_linear): dz = g * h'(out) is
// formed from the saved output of the fused forward (K2), and d_off[g] =
// sum_i dz[g, i] comes out beside dA. K9b replaces ::_bwd_kernel
// (_pallas_bwd, the VJP of packed_matmul): dz = g, no d_off; the port
// reaches it only for silu, since K3 takes any m (the TPU kernel needs one
// marker tile and falls back to K9b otherwise). One template, FUSED on or
// off.
//
// What bounds it on the H100: the bytes. The contraction runs over n
// individuals into a small [m, k] output. At the GD warm start's block (G
// = 10, m = 104, B = 25,088, n = 100,000, k = 16) it reads 26 MB of
// genotypes and 64 MB of g, plus 64 MB of the saved output where h' needs
// it: 0.027 ms at 3.35 TB/s (0.046 ms with the saved output), against
// 0.010 ms of tensor-core work (three bf16 products per f32 one at 989
// TFLOP/s) and 0.050 ms of f32 FMAs at 67 TFLOP/s. So the products go to
// the tensor cores, and the design streams g with the MMAs under the
// copies. Measured (PERF.md, scripts/ablate_k3_torch.py): the copies alone
// run at 81% of the bytes bound, but the MMA pass alone, three mma.sync
// per f32 product with the decode and the f32 adds, takes ~4x the tensor
// bound and sets the pace.
//
// Exact products (packed_mma.cuh): the genotype (0, 1, 2) is the exact bf16
// A operand; each f32 dz is split into hi + mid + lo bf16 parts, bit for
// bit. Every fragment goes through mma_split3_add: hi's MMA from a zero
// accumulator, lo's then mid's into another, joined to the f32 sum by
// round-to-nearest adds. No run of MMAs is chained through one accumulator:
// the tensor cores' f32 accumulation cuts toward zero, and the sums here
// run over up to n individuals.
//
// Design. Work items are (branch g, marker slab, column slab, tile), a tile
// being 64 byte columns of one strided group (four parts q of 64
// consecutive individuals). One wave of CTAs of 4 warps; each CTA owns an
// equal run of the items in order.
//  * Staging: the tile's bytes [slab markers x 64] and, per part q, its 64
//    rows of g (contiguous: g is [G, n, k] row-major; the slab's KC columns
//    of each) come by cp.async into one of two buffers, while the previous
//    tile is computed. Rows past n and columns past k are zero-filled
//    through the copy's source size, never read. The saved output comes the
//    same way only where h' reads it: at identity h' = 1 and the kernel
//    multiplies by nothing, which is exactly _bwd_fused_kernel's g * 1.
//  * dz pass: one pass over the landed tile forms dz = g * h'(out) in f32
//    (h' a runtime switch, out of the MMA loop), adds it to the thread's
//    d_off sum (one column per thread: the tile's 32 values in f32, the
//    tiles in f64), splits it into three bf16 planes in K4's gradient
//    order (packed_mma.cuh store_split3x4, two parts per conversion).
//  * MMA pass: warp w takes byte columns 16w..16w+15 of the tile (4
//    k-steps of 16 individuals) for every marker tile of the slab (up to 8
//    of 16 markers), all KC columns (NT = 1 or 2 tiles of 8), with K4's A
//    fragments (two parts of one byte per register, one 32-bit shared load
//    of a marker row for four k-steps) and B fragments read from the
//    planes without bank conflicts. The accumulators stay in registers
//    across the CTA's run of tiles.
//  * Flush, at the end of the run or of an item group: the four warps'
//    accumulators are added in warp order (through shared memory) into the
//    CTA's partial row in global memory, d_off in f64 likewise.
//  * Reduce: a second kernel adds each (branch, slab) group's partial rows
//    in CTA order and writes dA and d_off (rounded once from f64). Each
//    element of a partial row has one owner thread and no float atomics
//    are used, so repeats give the same bits. A call is exactly these two
//    launches.
// Shapes: any m (slabs of up to 128 markers over the grid), any k (slabs
// of 16 columns over the grid, NT = 1 for k <= 8), B a multiple of 128, n
// <= 4 * B; the bytes 16-byte aligned. g and out go by 16-byte copies where
// k is a multiple of 4 and they are 16-byte aligned, else by 4-byte ones.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "packed_decode.cuh"
#include "packed_mma.cuh"

namespace {

using namespace rsbann;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileCols = 64;                 // byte columns per tile: 16 per warp
constexpr int kTileStride = 80;               // shared bytes per marker row of a byte tile
constexpr int kDzStride = 2 * kTileCols + 2;  // 32-bit words per dz plane row (one column)
constexpr int kMt = 8;                        // marker tiles of 16 per slab
constexpr int kMaxSmem = 232448;              // dynamic shared memory a block may use

struct Args {
    const uint8_t* bytes;
    const float* g;
    const float* out;
    float* partial;
    int m, B, k, n, act;
    int read_out;     // stage the saved output: fused and h' not constant
    int vec;          // g and out by 16-byte copies
    int tiles;        // tiles of 64 byte columns per branch that hold an individual below n
    int ms;           // markers per slab, a multiple of 16
    int mslabs, cslabs;
    long long items;  // G * mslabs * cslabs * tiles
    int row;          // floats per partial row: [ms][KC] dA, then KC doubles of d_off
    int stage;        // bytes per tile buffer: g [4][64][KC], out (read_out), bytes [ms][80]
};

// h'(z) rebuilt from a = h(z) for the fused activations, with the
// subgradient 0 at a = 0, rounded as ops/activations.py prime_from_out
// rounds it (no contraction of tanh's 1 - a * a).
__device__ __forceinline__ float act_prime_from_out(int act, float a) {
    switch (act) {
        case 1:
            return a > 0.f ? 1.f : 0.f;
        case 2:
            return a > 0.f ? 1.f : (a < 0.f ? 0.01f : 0.f);
        case 3:
            return __fsub_rn(1.f, __fmul_rn(a, a));
        default:
            return 1.f;
    }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
                 "r"(src_bytes));
}

// The first tile of item group v is item v * tiles; the CTA that owns item
// i of ``items`` over ``ctas``: the c with items * c / ctas <= i.
__host__ __device__ __forceinline__ int cta_of(long long i, long long items, int ctas) {
    return static_cast<int>(((i + 1) * ctas - 1) / items);
}

template <bool FUSED, int NT>
__global__ void __launch_bounds__(kThreads) packed_bwd_tc(const Args p) {
    constexpr int KC = 8 * NT;                         // columns per column slab
    constexpr int kPart = kTileCols * KC;              // floats of one part's staged rows
    extern __shared__ uint4 smem_u4[];
    uint8_t* smem = reinterpret_cast<uint8_t*>(smem_u4);
    uint32_t* dz_s = reinterpret_cast<uint32_t*>(smem + 2 * p.stage);  // [3][KC][kDzStride]
    double* red_s = reinterpret_cast<double*>(dz_s + 3 * KC * kDzStride);  // [kThreads]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int r = lane >> 2, tig = lane & 3;
    const long long i_begin = p.items * blockIdx.x / gridDim.x;
    const long long i_end = p.items * (blockIdx.x + 1) / gridDim.x;
    const int per_branch = p.mslabs * p.cslabs;

    // item i's bytes, g and (read_out) out into buffer ``buf``
    auto load = [&](long long i, int buf) {
        const int v = static_cast<int>(i / p.tiles), t = static_cast<int>(i % p.tiles);
        const int gb = v / per_branch, slab = v % per_branch;
        const int m0 = (slab / p.cslabs) * p.ms, c0 = (slab % p.cslabs) * KC;
        float* g_s = reinterpret_cast<float*>(smem + buf * p.stage);
        float* o_s = g_s + 4 * kPart;
        uint8_t* b_s = reinterpret_cast<uint8_t*>(g_s + (p.read_out ? 8 : 4) * kPart);
        // part q, row j: individual i0 + 128 q + j
        const int i0 = (t >> 1) * kGroup + (t & 1) * kTileCols;
        const size_t rows = static_cast<size_t>(gb) * p.n;
        if (p.vec) {
            for (int idx = tid; idx < 4 * kPart / 4; idx += kThreads) {
                const int u = idx % (KC / 4), j = (idx / (KC / 4)) % kTileCols;
                const int q = idx / (kPart / 4);
                const int ind = i0 + q * kGBytes + j, col = c0 + 4 * u;
                const bool ok = ind < p.n && col < p.k;
                const size_t off = ok ? (rows + ind) * p.k + col : 0;
                const int at = q * kPart + j * KC + 4 * u;
                cp_async16(g_s + at, p.g + off, ok ? 16 : 0);
                if (FUSED && p.read_out) cp_async16(o_s + at, p.out + off, ok ? 16 : 0);
            }
        } else {
            for (int idx = tid; idx < 4 * kPart; idx += kThreads) {
                const int u = idx % KC, j = (idx / KC) % kTileCols, q = idx / kPart;
                const int ind = i0 + q * kGBytes + j, col = c0 + u;
                const bool ok = ind < p.n && col < p.k;
                const size_t off = ok ? (rows + ind) * p.k + col : 0;
                cp_async4(g_s + idx, p.g + off, ok ? 4 : 0);
                if (FUSED && p.read_out) cp_async4(o_s + idx, p.out + off, ok ? 4 : 0);
            }
        }
        // the slab's marker rows; rows past m are zero bytes (genotype 2
        // against dz, their dA rows are never read)
        const uint8_t* src = p.bytes + static_cast<size_t>(gb) * p.m * p.B +
                             static_cast<size_t>(t) * kTileCols;
        for (int idx = tid; idx < p.ms * 4; idx += kThreads) {
            const int row = idx >> 2, c16 = idx & 3, mk = m0 + row;
            const bool real = mk < p.m;
            cp_async16(b_s + row * kTileStride + c16 * 16,
                       src + (real ? static_cast<size_t>(mk) * p.B + c16 * 16 : 0), real ? 16 : 0);
        }
        cp_async_commit();
    };

    float acc[kMt][NT][4];
#pragma unroll
    for (int i = 0; i < kMt; ++i)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;
    double dsum = 0.0;  // d_off of column tid % KC

    load(i_begin, 0);
    int buf = 0;
    for (long long i = i_begin; i < i_end; ++i) {
        cp_async_wait<0>();
        __syncthreads();  // item i landed; the other buffer and the planes are free
        if (i + 1 < i_end) load(i + 1, buf ^ 1);
        const int v = static_cast<int>(i / p.tiles);
        const int m0 = ((v % per_branch) / p.cslabs) * p.ms;
        const int mtiles = min(p.ms, ((p.m + 15) & ~15) - m0) / 16;
        const float* g_s = reinterpret_cast<const float*>(smem + buf * p.stage);
        const uint8_t* b_s = reinterpret_cast<const uint8_t*>(g_s + (p.read_out ? 8 : 4) * kPart);

        // dz pass: thread (column col, byte column c) forms the four parts'
        // dz, adds them to its f32 sum of the tile (then to d_off in f64) and
        // stores their three planes
        {
            const int col = tid % KC;
            float tsum = 0.f;
#pragma unroll 2
            for (int c = tid / KC; c < kTileCols; c += kThreads / KC) {
                float dz[4];
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int at = q * kPart + c * KC + col;
                    float x = g_s[at];
                    if (FUSED && p.read_out)
                        x = __fmul_rn(x, act_prime_from_out(p.act, g_s[4 * kPart + at]));
                    dz[q] = x;
                    tsum += x;
                }
                store_split3x4(dz_s + col * kDzStride + 2 * c, KC * kDzStride, dz);
            }
            if (FUSED) dsum += static_cast<double>(tsum);
        }
        __syncthreads();  // the planes are staged

        // MMA pass: warp w's four k-steps, every marker tile of the slab
        {
            uint32_t wr[kMt], wr8[kMt];
#pragma unroll
            for (int mt = 0; mt < kMt; ++mt) {
                const uint8_t* b = b_s + (mt * 16 + r) * kTileStride + 16 * warp + 4 * tig;
                wr[mt] = mt < mtiles ? *reinterpret_cast<const uint32_t*>(b) : 0u;
                wr8[mt] =
                    mt < mtiles ? *reinterpret_cast<const uint32_t*>(b + 8 * kTileStride) : 0u;
            }
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                uint2 bf[NT][3];
                grad_b_frags<NT>(dz_s + r * kDzStride + 2 * (16 * warp + 4 * tig + b), kDzStride,
                                 bf);
#pragma unroll
                for (int mt = 0; mt < kMt; ++mt) {
                    if (mt >= mtiles) continue;  // uniform over the CTA
                    uint32_t af[4];
                    grad_a_frag(wr[mt], wr8[mt], b, af);
#pragma unroll
                    for (int nt = 0; nt < NT; ++nt) mma_split3_add(acc[mt][nt], af, bf[nt]);
                }
            }
        }

        if (i + 1 < i_end && (i + 1) / p.tiles == v) {
            buf ^= 1;
            continue;
        }
        // flush the item group: warps 1-3 hand their accumulators to warp 0
        // through the planes, which add them in warp order
        __syncthreads();  // every warp's MMAs are done: the planes are free
        float* ex = reinterpret_cast<float*>(dz_s);  // [3 warps][kMt][NT * 4][32 lanes]
        if (warp > 0) {
#pragma unroll
            for (int mt = 0; mt < kMt; ++mt) {
                if (mt >= mtiles) continue;
#pragma unroll
                for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        ex[(((warp - 1) * kMt + mt) * NT * 4 + nt * 4 + e) * 32 + lane] =
                            acc[mt][nt][e];
            }
        }
        if (FUSED) red_s[tid] = dsum;
        __syncthreads();
        float* slot = p.partial + static_cast<size_t>(blockIdx.x + v) * p.row;
        if (warp == 0) {
#pragma unroll
            for (int mt = 0; mt < kMt; ++mt) {
                if (mt >= mtiles) continue;
#pragma unroll
                for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        float s0 = acc[mt][nt][2 * h], s1 = acc[mt][nt][2 * h + 1];
#pragma unroll
                        for (int w = 0; w < kWarps - 1; ++w) {
                            const float* x = ex + ((w * kMt + mt) * NT * 4 + nt * 4 + 2 * h) * 32;
                            s0 += x[lane];
                            s1 += x[32 + lane];
                        }
                        *reinterpret_cast<float2*>(slot + (mt * 16 + r + 8 * h) * KC + nt * 8 +
                                                   2 * tig) = make_float2(s0, s1);
                    }
            }
        }
        if (FUSED && tid < KC) {
            double s = 0.0;
#pragma unroll
            for (int u = 0; u < kThreads / KC; ++u) s += red_s[u * KC + tid];
            reinterpret_cast<double*>(slot + p.ms * KC)[tid] = s;
        }
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
        dsum = 0.0;
        buf ^= 1;
    }
}

// dA[g, mm, kk] = sum over the CTAs that worked on (g, mm's slab, kk's
// slab), in CTA order, of their partial rows; then d_off[g, kk] from the
// f64 sums of marker slab 0, rounded once (when doff is given).
__global__ void packed_bwd_reduce(const float* __restrict__ partial, float* __restrict__ da,
                                  float* __restrict__ doff, int G, int m, int k, int kc, int ms,
                                  int mslabs, int cslabs, int tiles, long long items, int ctas,
                                  int row) {
    const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    const size_t nda = static_cast<size_t>(G) * m * k;
    if (idx < nda) {
        const int g = static_cast<int>(idx / (static_cast<size_t>(m) * k));
        const int rem = static_cast<int>(idx % (static_cast<size_t>(m) * k));
        const int mm = rem / k, kk = rem % k;
        const int v = (g * mslabs + mm / ms) * cslabs + kk / kc;
        const long long first = static_cast<long long>(v) * tiles;
        const int c_lo = cta_of(first, items, ctas), c_hi = cta_of(first + tiles - 1, items, ctas);
        const float* src = partial + (mm % ms) * kc + kk % kc;
        float s = 0.f;
        for (int c = c_lo; c <= c_hi; ++c) s += src[static_cast<size_t>(c + v) * row];
        da[idx] = s;
    } else if (doff != nullptr && idx < nda + static_cast<size_t>(G) * k) {
        const int j = static_cast<int>(idx - nda);
        const int g = j / k, kk = j % k;
        const int v = g * mslabs * cslabs + kk / kc;
        const long long first = static_cast<long long>(v) * tiles;
        const int c_lo = cta_of(first, items, ctas), c_hi = cta_of(first + tiles - 1, items, ctas);
        double s = 0.0;
        for (int c = c_lo; c <= c_hi; ++c)
            s += reinterpret_cast<const double*>(partial + static_cast<size_t>(c + v) * row +
                                                 ms * kc)[kk % kc];
        doff[j] = static_cast<float>(s);
    }
}

struct Plan {
    int nt, ms, mslabs, cslabs, tiles, per_sm, ctas, row, stage, read_out;
    long long items, slots, smem;
};

template <bool FUSED>
const void* kernel_for(int nt) {
    return nt == 1 ? reinterpret_cast<const void*>(&packed_bwd_tc<FUSED, 1>)
                   : reinterpret_cast<const void*>(&packed_bwd_tc<FUSED, 2>);
}

// The shared memory attribute and the occupancy of each instantiation, kept
// per device and shared size: the GD loop's calls pay no query.
struct Occupancy {
    int dev = -1, sms = 0, per_sm = 0;
    long long smem = -1;
};
Occupancy g_occ[2][2];  // [fused][nt - 1]

int plan(int fused, int act, int G, int m, int B, int k, int n, Plan* pl) {
    if (G <= 0 || m <= 0 || k <= 0 || n <= 0 || B % kGBytes || n > 4 * B)
        return static_cast<int>(cudaErrorInvalidValue);
    pl->nt = k <= 8 ? 1 : 2;
    const int kc = 8 * pl->nt;
    pl->cslabs = (k + kc - 1) / kc;
    const int m16 = (m + 15) & ~15;
    pl->mslabs = (m16 + 16 * kMt - 1) / (16 * kMt);
    pl->ms = ((m16 + pl->mslabs - 1) / pl->mslabs + 15) & ~15;  // even slabs
    pl->read_out = fused && act != 0;
    pl->stage = 4 * kTileCols * kc * 4 * (pl->read_out ? 2 : 1) + pl->ms * kTileStride;
    pl->smem = 2LL * pl->stage + 12LL * kc * kDzStride + 8LL * kThreads;
    pl->row = pl->ms * kc + 2 * kc;
    // tiles holding an individual below n: half h of group q starts at 512 q + 64 h
    const int full = n / kGroup, rem = n % kGroup;
    pl->tiles = 2 * full + (rem > kTileCols ? 2 : (rem > 0 ? 1 : 0));
    pl->items = static_cast<long long>(G) * pl->mslabs * pl->cslabs * pl->tiles;
    if (pl->smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    Occupancy& occ = g_occ[fused ? 1 : 0][pl->nt - 1];
    if (occ.dev != dev || occ.smem != pl->smem) {
        const void* fn = fused ? kernel_for<true>(pl->nt) : kernel_for<false>(pl->nt);
        if ((e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      static_cast<int>(pl->smem))) != cudaSuccess ||
            (e = cudaDeviceGetAttribute(&occ.sms, cudaDevAttrMultiProcessorCount, dev)) !=
                cudaSuccess ||
            (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ.per_sm, fn, kThreads,
                                                               pl->smem)) != cudaSuccess) {
            occ.dev = -1;
            return static_cast<int>(e);
        }
        occ.dev = dev;
        occ.smem = pl->smem;
    }
    pl->per_sm = occ.per_sm;
    if (pl->per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    // one wave of resident CTAs, each with an equal run of the items
    const long long wave = static_cast<long long>(pl->per_sm) * occ.sms;
    pl->ctas = static_cast<int>(wave < pl->items ? wave : pl->items);
    // a CTA's partial row per item group it touches: row c + v is unique
    pl->slots = pl->ctas + static_cast<long long>(G) * pl->mslabs * pl->cslabs - 1;
    return 0;
}

}  // namespace

// What a launch of K3 (fused = 1, with activation code act) or K9b on this
// shape uses, on the current device: out[0..10] = column tiles of 8 (NT),
// markers per slab, marker slabs, column slabs, tiles per branch, CTAs (the
// grid), resident CTAs per SM, floats per partial row, partial rows, bytes
// per tile buffer, shared bytes per CTA.
extern "C" int packed_bwd_plan(int fused, int act, int G, int m, int B, int k, int n,
                               long long* out) {
    Plan pl;
    const int status = plan(fused, act, G, m, B, k, n, &pl);
    if (status != 0) return status;
    const long long v[11] = {pl.nt, pl.ms, pl.mslabs, pl.cslabs, pl.tiles, pl.ctas,
                             pl.per_sm, pl.row, pl.slots, pl.stage, pl.smem};
    for (int i = 0; i < 11; ++i) out[i] = v[i];
    return 0;
}

// bytes u8 [G, m, B] (group-strided, B a multiple of 128, 16-byte aligned);
// g f32 [G, n, k]; out f32 [G, n, k] (the forward's output; read only when
// fused and act is not identity); partial f32 scratch of partial_floats, at
// least slots * row of packed_bwd_plan (16-byte aligned); outputs da f32
// [G, m, k] and doff f32 [G, k] (doff only when fused). All contiguous.
// Exactly two launches: the pass and its reduce.
extern "C" int packed_bwd_f32(const void* bytes, const void* g, const void* out, void* partial,
                              long long partial_floats, void* da, void* doff, int G, int m, int B,
                              int k, int n, int act, int fused, void* stream) {
    if ((reinterpret_cast<uintptr_t>(bytes) | reinterpret_cast<uintptr_t>(partial)) & 15 ||
        (reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(out)) & 3)
        return static_cast<int>(cudaErrorMisalignedAddress);
    Plan pl;
    const int status = plan(fused, act, G, m, B, k, n, &pl);
    if (status != 0) return status;
    if (pl.slots * pl.row > partial_floats) return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = (k & 3) == 0 &&
                     ((reinterpret_cast<uintptr_t>(g) |
                       (pl.read_out ? reinterpret_cast<uintptr_t>(out) : 0)) & 15) == 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    Args args{static_cast<const uint8_t*>(bytes), static_cast<const float*>(g),
              static_cast<const float*>(out), static_cast<float*>(partial), m, B, k, n, act,
              pl.read_out, vec ? 1 : 0, pl.tiles, pl.ms, pl.mslabs, pl.cslabs, pl.items, pl.row,
              pl.stage};
    void* params[] = {&args};
    const void* fn = fused ? kernel_for<true>(pl.nt) : kernel_for<false>(pl.nt);
    cudaError_t e = cudaLaunchKernel(fn, dim3(pl.ctas), dim3(kThreads), params, pl.smem, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t total =
        static_cast<size_t>(G) * m * k + (fused ? static_cast<size_t>(G) * k : 0);
    const int threads = 256;
    packed_bwd_reduce<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0, s>>>(
        static_cast<const float*>(partial), static_cast<float*>(da),
        fused ? static_cast<float*>(doff) : nullptr, G, m, k, 8 * pl.nt, pl.ms, pl.mslabs,
        pl.cslabs, pl.tiles, pl.items, pl.ctas, pl.row);
    return static_cast<int>(cudaGetLastError());
}
