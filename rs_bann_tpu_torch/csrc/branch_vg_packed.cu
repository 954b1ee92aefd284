// K4: fused packed value-and-gradient of one leapfrog step's data term.
//
// Replaces rs_bann_tpu/ops/branch_mlp.py::_blocked_packed_kernel (called
// through _data_vg_packed_blocked, _vg_packed_for and data_vg_packed).
// In one pass over the packed genotype bytes it computes, for one branch,
//
//     y_pred[i]            = f(x_i; W, b)          for every individual i < n
//     d(rss/2)/d(W_l, b_l)  summed over i < n       for every layer l
//
// with rss = sum_i (y_pred[i] - target[i])^2, at any depth (W0 [m, k0], the
// hidden layers, w_out [s]), all five activations. Two kernels per call: the
// pass, which leaves one row of partial sums per CTA, and a reduce that adds
// the rows in a fixed order. No float atomics: the same inputs give the same
// bits on every run, and the MCMC chain with them. err is masked to i < n
// (individuals past n decode to 0 but still pass the bias through the net).
//
// Depth 0 at padded widths up to 32 (vg_packed0_kernel; the main path's
// branch is m = 104, k0 = 16, n = 100,000) runs both products on bf16 tensor
// cores, as K2 does:
//  * What bounds it on the H100: 2 x 2 x m x n x k0 FLOPs (the forward
//    Z = X^T W0' and the gradient dW0' = X dz0; 0.67 GFLOP at the main
//    path's shape, 10 us on the f32 cores at 67 TFLOP/s, 2.0 us as three
//    bf16 products each at 989 TFLOP/s) against 3.4 MB of bytes, target
//    and y_pred (1.0 us at 3.35 TB/s).
//  * Exact f32 products (packed_mma.cuh): the genotype is the exact bf16
//    operand of both products and the other factor is split into three
//    bf16 parts, three mma.sync.m16n8k16 per fragment, whose results join
//    the f32 sums by round-to-nearest adds (mma_split3_add): the tensor
//    cores' own f32 accumulation cuts toward zero, and chained through the
//    forward's marker chunks its drift, summed over n individuals, reached
//    1.6e-4 of d_off where the residuals cancel.
//  * Work: one wave of CTAs of 4 warps, each with an equal run of the tiles
//    of 64 byte columns (4 parts of 64 consecutive individuals); the bytes
//    come by cp.async, double buffered where shared memory allows.
//  * Forward: K2's loop. Warp w takes byte columns 16w..16w+15; per chunk of
//    16 markers one A fragment per part q (prmt decode, K2's marker and
//    byte-column permutations), all columns in n8 tiles (NT = 1, 2, 4 for
//    k0 <= 8, 16, 32: a width of 10 stored at 16 costs nothing extra).
//  * Epilogue in registers, from the D fragment: z + off, act, pred as the
//    quad's sum over the columns (shuffles in a fixed order), err masked to
//    i < n, y_pred in whole 8-byte stores (lane (r, tig) holds part tig of
//    two adjacent individuals), dz0 = w_out * err * act'(z), and the CTA's
//    sums of dz0 (d_off), a0 * err (dW_out) and err^2 (rss).
//  * Gradient: dW0'[marker, k] = sum over individuals of x * dz0 as an MMA
//    with markers as rows and the tile's 256 individuals as the reduction.
//    An A register pairs two parts q of one byte: K index 2 tig + {0, 1} is
//    parts 0 and 1 of byte column c_tig, 2 tig + 8 + {0, 1} parts 2 and 3,
//    so one 32-bit shared load of a marker row feeds four k-steps. dz0 is
//    staged as three bf16 planes in that same order. Warp w takes the
//    marker tiles w, w + 4, ... in rounds of kMtw and adds each round's
//    accumulators to its CTA's partial row in global memory (each element
//    has one owner thread: a fixed order).
//  * Standardization and rss inside the two launches: the pass forms W0' =
//    w_scale * W0 and off = b0 - shift . W0' (summed in f64 and rounded
//    once, nearer the exact value than an f32 sum) while it stages the
//    weights; the reduce forms dW0 = w_scale * dW0' - (shift * w_scale) *
//    d_off and rss from the CTAs' err^2 sums. A call is exactly two
//    launches and no other device op.
//  * Any m that the admission rule (branch_vg_packed_smem) takes: a single
//    byte buffer where two do not fit in 227 KB.
//
// Every other shape (depth >= 1, or depth 0 at a padded width of 33-64:
// vg_deep_kernel + reduce_deep_kernel, entry branch_vg_packed_deep_f32) runs
// the device code K5 shares, csrc/packed_deep.cuh, which says what bounds it
// and how it is built: one wave of CTAs of 8 warps, each with an equal run
// of the tiles of 16 byte columns (64 individuals), the bytes by cp.async
// double buffered, one chain's weights staged once with the fold inside
// (W0' = w_scale * W0, off = b0 - shift . W0' in f64), the CTA's sums and
// err^2 in one partial row; the reduce adds the rows in order and unfolds
// dW0. A call is its two launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "packed_decode.cuh"
#include "packed_deep.cuh"
#include "packed_mma.cuh"

namespace {

using namespace rsbann;

constexpr int kThreads = kGBytes;  // one thread per byte column of a group
constexpr int kRow = kGBytes + 4;  // shared-memory row stride of the byte tile
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use

// The depth-0 admission rule at widths up to 32 (that of the first f32
// design's layout, kept: the tensor-core kernel needs less for every m it
// admits).
size_t smem_bytes0(int m, int km) {
    const size_t floats = static_cast<size_t>(m) * km + km + km + 4 * km +
                          static_cast<size_t>(kGroup) * (km + 4);
    return floats * sizeof(float) + static_cast<size_t>(m) * kRow;
}

// ------------------------------------------------------------------ depth 0

constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 64;                 // byte columns per tile: 16 per warp
constexpr int kTileStride = 80;               // shared bytes per marker row of a byte tile
constexpr int kDzStride = 2 * kTileCols + 2;  // 32-bit words per dz0 plane row (one column)
constexpr int kMtw = 2;                       // marker tiles a warp holds per gradient round
constexpr int kRedCols = 32, kRedSlices = 16;  // the reduce: columns x row slices per block
constexpr int kBatch = 8;                     // global loads in flight per thread while staging

struct Args0 {
    const uint8_t* bytes;
    const float* target;
    const float* w0;
    const float* b0;
    const float* wout;
    const float* scale;
    const float* shift;
    float* y_pred;
    float* partial;
    int m, B, n, k0, act;
    int tiles;    // tiles of 64 byte columns that hold an individual below n
    int m16;      // m rounded up to 16
    int wstride;  // bf16 per weight plane row (one column)
    int row;      // floats per partial row
    int nbuf;     // byte tile buffers: 2 (double buffered) or 1
};

// bf16 per weight plane row: an odd number of 32-byte units, so the 8-byte
// fragment loads of 4 rows hit 4 distinct bank groups (as K2).
int weight_stride(int m16) { return ((m16 / 16) & 1) ? m16 : m16 + 16; }

// floats after the byte tiles: off, w_out, the fold's slices (f64), the block sums
int small_floats(int km) { return 2 * km + 2 * kThreads + kWarps * (2 * km + 1); }

long long smem0(int km, int m16, int wstride, int nbuf) {
    return 6LL * km * wstride + 12LL * km * kDzStride + static_cast<long long>(nbuf) * m16 * kTileStride +
           4LL * small_floats(km);
}

// The CTA's partial row: dW0' [m16][KM], then d_off [KM], dW_out [KM], err^2.
__host__ __device__ constexpr int off_dsum(int m16, int km) { return m16 * km; }

// Stage W0' = w_scale * W0 as three bf16 planes [column][marker position]
// (K2's layout), off = b0 - shift . W0' (summed in f64, rounded once), and
// w_out; the same order in every CTA. The global loads go in batches of
// kBatch per thread, all in flight at once.
template <int NT>
__device__ void stage0(const Args0& p, __nv_bfloat16* w_s, float* off_s, float* wo_s,
                       double* fold_s) {
    constexpr int KM = 8 * NT;
    constexpr int S = kThreads / KM;  // marker slices per column of the fold
    const int tid = threadIdx.x;
    const int plane = KM * p.wstride;
    const int total = p.m16 * KM;
    for (int base = 0; base < total; base += kThreads * kBatch) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int idx = base + u * kThreads + tid;
            const int mk = idx / KM, c = idx - mk * KM;
            v[u] = (mk < p.m && c < p.k0) ? p.scale[mk] * p.w0[mk * p.k0 + c] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int idx = base + u * kThreads + tid;
            if (idx >= total) break;
            const int mk = idx / KM, c = idx - mk * KM;
            __nv_bfloat16 hi, mid, lo;
            split3(v[u], hi, mid, lo);
            const int at = c * p.wstride + (mk & ~15) + k_position(mk & 15);
            w_s[at] = hi;
            w_s[plane + at] = mid;
            w_s[2 * plane + at] = lo;
        }
    }
    {
        // thread (c, sl) sums markers sl, sl + S, ... of column c in order,
        // in f64: off enters every individual's z, so an error in its
        // rounding moves all n residuals one way
        const int c = tid % KM, sl = tid / KM;
        double s = 0.0;
        if (c < p.k0) {
            for (int m0 = sl; m0 < p.m; m0 += S * kBatch) {
                float a[kBatch], b[kBatch];
#pragma unroll
                for (int u = 0; u < kBatch; ++u) {
                    const int mk = m0 + u * S;
                    a[u] = mk < p.m ? p.shift[mk] : 0.f;
                    b[u] = mk < p.m ? p.scale[mk] * p.w0[mk * p.k0 + c] : 0.f;
                }
#pragma unroll
                for (int u = 0; u < kBatch; ++u) {
                    if (m0 + u * S < p.m) s = fma(static_cast<double>(a[u]), static_cast<double>(b[u]), s);
                }
            }
        }
        fold_s[tid] = s;
    }
    if (tid < KM) wo_s[tid] = tid < p.k0 ? p.wout[tid] : 0.f;
    __syncthreads();
    if (tid < KM) {
        double s = 0.0;
#pragma unroll
        for (int sl = 0; sl < S; ++sl) s += fold_s[sl * KM + tid];
        off_s[tid] = tid < p.k0 ? static_cast<float>(static_cast<double>(p.b0[tid]) - s) : 0.f;
    }
}

// Z = X^T W0' for the warp's 4 parts x 16 rows of the tile, all KM columns:
// K2's loop.
template <int NT>
__device__ __forceinline__ void forward0(const Args0& p, const uint8_t* tile,
                                         const __nv_bfloat16* w_s, float (&acc)[4][NT][4]) {
    constexpr int KM = 8 * NT;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int r = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[q][nt][e] = 0.f;
    // this thread's markers tig + 4i of each chunk, byte columns 2r, 2r + 1
    const uint8_t* bp = tile + tig * kTileStride + warp * 16 + 2 * r;
    const __nv_bfloat16* wp = w_s + r * p.wstride + 4 * tig;
    const int plane = KM * p.wstride;
#pragma unroll 1
    for (int c = 0; c < p.m16 / 16; ++c) {
        const uint8_t* b = bp + c * 16 * kTileStride;
        const uint32_t u0 = *reinterpret_cast<const uint16_t*>(b);
        const uint32_t u1 = *reinterpret_cast<const uint16_t*>(b + 4 * kTileStride);
        const uint32_t u2 = *reinterpret_cast<const uint16_t*>(b + 8 * kTileStride);
        const uint32_t u3 = *reinterpret_cast<const uint16_t*>(b + 12 * kTileStride);
        const uint32_t p01 = prmt(u0, u1, 0x5140u);
        const uint32_t p23 = prmt(u2, u3, 0x5140u);
        uint32_t af[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const uint32_t s01 = selectors(p01, q), s23 = selectors(p23, q);
            af[q][0] = decode_pair(s01);        // row r, K 2tig, 2tig + 1
            af[q][1] = decode_pair(s01 >> 16);  // row r + 8
            af[q][2] = decode_pair(s23);        // row r, K 2tig + 8, 2tig + 9
            af[q][3] = decode_pair(s23 >> 16);  // row r + 8
        }
        const __nv_bfloat16* wc = wp + c * 16;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            uint2 bw[3];  // hi, mid, lo
#pragma unroll
            for (int part = 0; part < 3; ++part)
                bw[part] = *reinterpret_cast<const uint2*>(wc + part * plane + nt * 8 * p.wstride);
#pragma unroll
            for (int q = 0; q < 4; ++q) mma_split3_add(acc[q][nt], af[q], bw);
        }
    }
}

// From the D fragments of tile t and the targets of its rows (tgt[h][q]):
// y_pred, dz0 into dz_s, and the thread's sums of dz0 (db), a0 * err (dwo)
// and err^2 (e2). Row r of part q is byte
// column 16 w + 2 r of the tile, row r + 8 byte column 16 w + 2 r + 1 (K2's
// permutation): lane (r, tig) holds columns nt * 8 + 2 tig + {0, 1} of both.
template <int NT, int ACT>
__device__ __forceinline__ void epilogue0(const Args0& p, int t, const float (&acc)[4][NT][4],
                                          const float (&tgt)[2][4], const float* off_s,
                                          const float* wo_s, uint32_t* dz_s,
                                          float (&db)[NT][2], float (&dwo)[NT][2], float& e2) {
    constexpr int KM = 8 * NT;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int r = lane >> 2, tig = lane & 3;
    // individual of part 0, row r
    const int base = (t >> 1) * kGroup + (t & 1) * kTileCols + warp * 16 + 2 * r;
    float o[NT][2], w[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            o[nt][c] = off_s[nt * 8 + 2 * tig + c];
            w[nt][c] = wo_s[nt * 8 + 2 * tig + c];
        }
    float mine[2];  // pred of part tig, rows r and r + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float dz[4][NT][2];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int i = base + q * kGBytes + h;
            float z[NT][2], a[NT][2];
            float pp = 0.f;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    z[nt][c] = acc[q][nt][2 * h + c] + o[nt][c];
                    a[nt][c] = act_apply(ACT, z[nt][c]);
                    pp = fmaf(w[nt][c], a[nt][c], pp);
                }
            // the quad's columns in a fixed order: every lane gets the same bits
            pp += __shfl_xor_sync(0xffffffffu, pp, 1);
            pp += __shfl_xor_sync(0xffffffffu, pp, 2);
            const float err = i < p.n ? pp - tgt[h][q] : 0.f;
            if (q == tig) {
                mine[h] = pp;
                e2 = fmaf(err, err, e2);
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    dz[q][nt][c] = w[nt][c] * err * act_prime(ACT, z[nt][c], a[nt][c]);
                    db[nt][c] += dz[q][nt][c];
                    dwo[nt][c] = fmaf(a[nt][c], err, dwo[nt][c]);
                }
        }
        // dz0 of byte column 16 w + 2 r + h, its four parts in one 8-byte
        // unit per plane: parts (0, 1) then (2, 3), as the gradient's B
        // fragment reads them
        const int cc = warp * 16 + 2 * r + h;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const float v[4] = {dz[0][nt][c], dz[1][nt][c], dz[2][nt][c], dz[3][nt][c]};
                store_split3x4(dz_s + (nt * 8 + 2 * tig + c) * kDzStride + 2 * cc,
                               KM * kDzStride, v);
            }
    }
    // rows r and r + 8 of part tig are adjacent individuals
    const int i0 = base + tig * kGBytes;
    if (i0 + 1 < p.n) {
        *reinterpret_cast<float2*>(p.y_pred + i0) = make_float2(mine[0], mine[1]);
    } else if (i0 < p.n) {
        p.y_pred[i0] = mine[0];
    }
}

// dW0'[marker, k] += sum over the tile's 256 individuals of x * dz0, for the
// warp's marker tiles, into the CTA's partial row (stored on its first tile).
// k-step (J, b) takes byte columns 16 J + 4 tig + b, tig = 0..3: A register
// 0 holds parts 0, 1 of marker r, register 2 parts 2, 3 (registers 1, 3:
// marker r + 8); dz_s holds the same order.
template <int NT>
__device__ __forceinline__ void gradient0(const Args0& p, const uint8_t* tile,
                                          const uint32_t* dz_s, float* part, bool first) {
    constexpr int KM = 8 * NT;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int r = lane >> 2, tig = lane & 3;
    const int mtiles = p.m16 / 16;
    const int mine = warp < mtiles ? (mtiles - warp + kWarps - 1) / kWarps : 0;
#pragma unroll 1
    for (int round = 0; round * kMtw < mine; ++round) {
        int mt[kMtw];
        bool on[kMtw];
        float g[kMtw][NT][4];
#pragma unroll
        for (int i = 0; i < kMtw; ++i) {
            mt[i] = warp + kWarps * (round * kMtw + i);
            on[i] = mt[i] < mtiles;  // warp-uniform
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) g[i][nt][e] = 0.f;
        }
#pragma unroll 1
        for (int J = 0; J < kTileCols / 16; ++J) {
            uint32_t wr[kMtw], wr8[kMtw];
#pragma unroll
            for (int i = 0; i < kMtw; ++i) {
                const uint8_t* b = tile + (mt[i] * 16 + r) * kTileStride + 16 * J + 4 * tig;
                wr[i] = on[i] ? *reinterpret_cast<const uint32_t*>(b) : 0u;
                wr8[i] = on[i] ? *reinterpret_cast<const uint32_t*>(b + 8 * kTileStride) : 0u;
            }
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                uint2 bf[NT][3];
                grad_b_frags<NT>(dz_s + r * kDzStride + 2 * (16 * J + 4 * tig + b), kDzStride, bf);
#pragma unroll
                for (int i = 0; i < kMtw; ++i) {
                    if (!on[i]) continue;
                    uint32_t af[4];
                    grad_a_frag(wr[i], wr8[i], b, af);
#pragma unroll
                    for (int nt = 0; nt < NT; ++nt) mma_split3_add(g[i][nt], af, bf[nt]);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < kMtw; ++i) {
            if (!on[i]) continue;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    float2* dst = reinterpret_cast<float2*>(
                        part + (mt[i] * 16 + r + 8 * h) * KM + nt * 8 + 2 * tig);
                    float2 v = make_float2(g[i][nt][2 * h], g[i][nt][2 * h + 1]);
                    if (!first) {
                        const float2 old = *dst;
                        v = make_float2(old.x + v.x, old.y + v.y);
                    }
                    *dst = v;
                }
        }
    }
}

template <int NT>
__global__ void __launch_bounds__(kThreads, NT >= 4 ? 2 : 3) vg_packed0_kernel(const Args0 p) {
    constexpr int KM = 8 * NT;
    extern __shared__ uint4 smem_u4[];
    __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem_u4);     // [3][KM][wstride]
    uint32_t* dz_s = reinterpret_cast<uint32_t*>(w_s + 3 * KM * p.wstride);  // [3][KM][kDzStride]
    uint8_t* tile_s = reinterpret_cast<uint8_t*>(dz_s + 3 * KM * kDzStride);  // [nbuf][m16][80]
    float* off_s = reinterpret_cast<float*>(tile_s + p.nbuf * p.m16 * kTileStride);
    float* wo_s = off_s + KM;
    double* fold_s = reinterpret_cast<double*>(wo_s + KM);         // [kThreads]
    float* red_s = reinterpret_cast<float*>(fold_s + kThreads);   // [kWarps][2 KM + 1]

    // the CTA's share of the tiles, in order
    const int t_begin = static_cast<int>(static_cast<long long>(p.tiles) * blockIdx.x / gridDim.x);
    const int t_end = static_cast<int>(static_cast<long long>(p.tiles) * (blockIdx.x + 1) / gridDim.x);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    float* part = p.partial + static_cast<size_t>(blockIdx.x) * p.row;

    // bytes of tile t into buffer ``buf``; rows past m are zero (genotype 2
    // against a zero weight; their dW0' rows are never read)
    auto load = [&](int t, int buf) {
        const uint8_t* src = p.bytes + static_cast<size_t>(t) * kTileCols;
        uint8_t* dst = tile_s + buf * p.m16 * kTileStride;
        for (int idx = tid; idx < p.m16 * 4; idx += kThreads) {
            const int row = idx >> 2, c16 = idx & 3;
            const bool real = row < p.m;
            cp_async16(dst + row * kTileStride + c16 * 16,
                       src + (real ? static_cast<size_t>(row) * p.B + c16 * 16 : 0), real ? 16 : 0);
        }
        cp_async_commit();
    };

    load(t_begin, 0);
    stage0<NT>(p, w_s, off_s, wo_s, fold_s);
    float db[NT][2], dwo[NT][2], e2 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) db[nt][0] = db[nt][1] = dwo[nt][0] = dwo[nt][1] = 0.f;
    int buf = 0;
    for (int t = t_begin; t < t_end; ++t) {
        const bool next = t + 1 < t_end;
        if (next && p.nbuf == 2) {
            load(t + 1, buf ^ 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const uint8_t* tile = tile_s + buf * p.m16 * kTileStride;
        // the targets of the thread's rows, loaded while the forward runs
        float tgt[2][4];
        {
            const int i0 = (t >> 1) * kGroup + (t & 1) * kTileCols + warp * 16 + 2 * (lane >> 2);
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int i = i0 + q * kGBytes + h;
                    tgt[h][q] = i < p.n ? p.target[i] : 0.f;
                }
        }
        float acc[4][NT][4];
        forward0<NT>(p, tile, w_s, acc);
        switch (p.act) {
            case 1: epilogue0<NT, 1>(p, t, acc, tgt, off_s, wo_s, dz_s, db, dwo, e2); break;
            case 2: epilogue0<NT, 2>(p, t, acc, tgt, off_s, wo_s, dz_s, db, dwo, e2); break;
            case 3: epilogue0<NT, 3>(p, t, acc, tgt, off_s, wo_s, dz_s, db, dwo, e2); break;
            case 4: epilogue0<NT, 4>(p, t, acc, tgt, off_s, wo_s, dz_s, db, dwo, e2); break;
            default: epilogue0<NT, 0>(p, t, acc, tgt, off_s, wo_s, dz_s, db, dwo, e2); break;
        }
        __syncthreads();  // the four warps' dz0 staged
        gradient0<NT>(p, tile, dz_s, part, t == t_begin);
        __syncthreads();  // the tile and dz_s are free again
        if (next && p.nbuf == 1) load(t + 1, 0);
        if (p.nbuf == 2) buf ^= 1;
    }

    // the CTA's sums of d_off, dW_out and err^2: over the 8 rows r of each
    // column, then the four warps in order
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) {
                db[nt][c] += __shfl_xor_sync(0xffffffffu, db[nt][c], o);
                dwo[nt][c] += __shfl_xor_sync(0xffffffffu, dwo[nt][c], o);
            }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) e2 += __shfl_xor_sync(0xffffffffu, e2, o);
    float* red = red_s + warp * (2 * KM + 1);
    if (lane < 4) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                red[nt * 8 + 2 * lane + c] = db[nt][c];
                red[KM + nt * 8 + 2 * lane + c] = dwo[nt][c];
            }
    }
    if (lane == 0) red[2 * KM] = e2;
    __syncthreads();
    if (tid < 2 * KM + 1) {
        const int w = 2 * KM + 1;
        part[off_dsum(p.m16, KM) + tid] =
            ((red_s[tid] + red_s[w + tid]) + red_s[2 * w + tid]) + red_s[3 * w + tid];
    }
}

// grads = [dW0 [m, k0], db0 [k0], dW_out [k0], rss]: column sums over the
// CTAs' partial rows, each in the same fixed order (rows b = slice, slice +
// 16, ... per slice, then the 16 slices in order), and the unfold of dW0.
__global__ void __launch_bounds__(kRedCols * kRedSlices)
reduce0_kernel(const float* __restrict__ partial, int rows, int row, const float* __restrict__ scale,
               const float* __restrict__ shift, float* __restrict__ grads, int m, int k0, int km,
               int m16) {
    __shared__ float red[kRedSlices][2][kRedCols];
    const int lane = threadIdx.x & 31, sl = threadIdx.x >> 5;
    const int p = blockIdx.x * kRedCols + lane;
    const int mk0 = m * k0, dsum = off_dsum(m16, km);
    int col = -1, dcol = -1, mm = 0;
    if (p < mk0) {
        mm = p / k0;
        const int k = p - mm * k0;
        col = mm * km + k;
        dcol = dsum + k;
    } else if (p < mk0 + k0) {
        col = dsum + (p - mk0);
    } else if (p < mk0 + 2 * k0) {
        col = dsum + km + (p - mk0 - k0);
    } else if (p == mk0 + 2 * k0) {
        col = dsum + 2 * km;
    }
    float s = 0.f, d = 0.f;
    if (col >= 0) {
#pragma unroll 8
        for (int b = sl; b < rows; b += kRedSlices) {
            s += partial[static_cast<size_t>(b) * row + col];
            if (dcol >= 0) d += partial[static_cast<size_t>(b) * row + dcol];
        }
    }
    red[sl][0][lane] = s;
    red[sl][1][lane] = d;
    __syncthreads();
    if (sl == 0 && col >= 0) {
#pragma unroll
        for (int j = 1; j < kRedSlices; ++j) {
            s += red[j][0][lane];
            d += red[j][1][lane];
        }
        // dW0 = w_scale * dW0' - (shift * w_scale) * d_off, rounded as the
        // plain version rounds it
        grads[p] = dcol >= 0
                       ? __fsub_rn(__fmul_rn(scale[mm], s),
                                   __fmul_rn(__fmul_rn(shift[mm], scale[mm]), d))
                       : s;
    }
}

struct Plan0 {
    int nt, tiles, m16, wstride, row, nbuf, per_sm, ctas;
    long long smem;
};

const void* kernel0_for(int nt) {
    switch (nt) {
        case 1: return reinterpret_cast<const void*>(&vg_packed0_kernel<1>);
        case 2: return reinterpret_cast<const void*>(&vg_packed0_kernel<2>);
        default: return reinterpret_cast<const void*>(&vg_packed0_kernel<4>);
    }
}

// The shared memory attribute and the occupancy of each instantiation, kept
// per device and shared size: the wrapper's call on the sequential path
// pays no query.
struct Occupancy {
    int dev = -1, sms = 0, per_sm = 0;
    long long smem = -1;
};
Occupancy g_occ[3];

int plan0(int m, int B, int n, int k0, Plan0* pl) {
    const int km = pick_km(k0, k0);
    if (km < 0 || m <= 0 || n <= 0 || B % kGBytes || n > 4 * B)
        return static_cast<int>(cudaErrorInvalidValue);
    pl->nt = km / 8;
    pl->m16 = (m + 15) & ~15;
    pl->wstride = weight_stride(pl->m16);
    pl->row = (off_dsum(pl->m16, km) + 2 * km + 1 + 3) & ~3;
    pl->nbuf = 2;
    pl->smem = smem0(km, pl->m16, pl->wstride, 2);
    if (pl->smem > kMaxSmem) {
        pl->nbuf = 1;
        pl->smem = smem0(km, pl->m16, pl->wstride, 1);
        if (pl->smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    }
    // tiles holding an individual below n: half h of group g starts at 512 g + 64 h
    const int full = n / kGroup, rem = n % kGroup;
    pl->tiles = 2 * full + (rem > kTileCols ? 2 : (rem > 0 ? 1 : 0));
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    Occupancy& occ = g_occ[pl->nt == 1 ? 0 : (pl->nt == 2 ? 1 : 2)];
    if (occ.dev != dev || occ.smem != pl->smem) {
        const void* fn = kernel0_for(pl->nt);
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
    // one wave of resident CTAs, each with an equal run of the tiles
    const long long wave = static_cast<long long>(pl->per_sm) * occ.sms;
    pl->ctas = static_cast<int>(wave < pl->tiles ? wave : pl->tiles);
    return 0;
}

// -------------------------------- depth >= 1, or depth 0 at widths 33-64

struct ArgsDeep {
    const uint8_t* bytes;
    const float* target;
    const float* q;  // the flat weights W0, b0, (W_l, b_l)..., w_out, unfolded
    const float* scale;
    const float* shift;
    float* y_pred;
    float* partial;
    int row;  // floats per partial row: the flat layout's P, then err^2
    deep::Shape sh;
};

template <int KM>
__global__ void __launch_bounds__(deep::kThreads) vg_deep_kernel(const ArgsDeep p) {
    extern __shared__ uint4 smem_u4[];
    const deep::Smem sm = deep::carve(smem_u4, p.sh, KM, 1);
    const int t_begin = static_cast<int>(static_cast<long long>(p.sh.tiles) * blockIdx.x / gridDim.x);
    const int t_end = static_cast<int>(static_cast<long long>(p.sh.tiles) * (blockIdx.x + 1) / gridDim.x);
    const int tile_bytes = p.sh.m16 * deep::kTileStride;
    float* part = p.partial + static_cast<size_t>(blockIdx.x) * p.row;
    deep::load_tile(p.sh, p.bytes, t_begin, sm.tiles);
    deep::stage_chain<KM>(p.sh, p.q, p.scale, p.shift, sm.w0, sm.wf, sm.fold);
    float e2 = 0.f;
    int buf = 0;
    for (int t = t_begin; t < t_end; ++t) {
        if (t + 1 < t_end) {
            deep::load_tile(p.sh, p.bytes, t + 1, sm.tiles + (buf ^ 1) * tile_bytes);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        deep::tile_chain<KM>(p.sh, sm.tiles + buf * tile_bytes, sm.w0, sm.wf, sm, t, p.target,
                             p.y_pred, part, t == t_begin, e2);
        buf ^= 1;
    }
    const float e2_sum = deep::cta_sum(e2, sm.small + 5 * deep::kTile);
    if (threadIdx.x == 0) part[p.sh.P] = e2_sum;
}

// grads = [the flat layout with dW0 unfolded, rss]: column sums over the
// CTAs' partial rows, each in the same fixed order as reduce0_kernel's, then
// dW0 = w_scale * dW0' - (shift * w_scale) * d_off.
__global__ void __launch_bounds__(kRedCols * kRedSlices)
reduce_deep_kernel(const float* __restrict__ partial, int rows, int row,
                   const float* __restrict__ scale, const float* __restrict__ shift,
                   float* __restrict__ grads, int m, int k0, int P) {
    __shared__ float red[kRedSlices][2][kRedCols];
    const int lane = threadIdx.x & 31, sl = threadIdx.x >> 5;
    const int p = blockIdx.x * kRedCols + lane;
    const int mk0 = m * k0;
    const int col = p <= P ? p : -1;  // p == P: the err^2 sums, rss
    const int mm = p < mk0 ? p / k0 : 0;
    const int dcol = p < mk0 ? mk0 + (p - mm * k0) : -1;
    float s = 0.f, d = 0.f;
    if (col >= 0) {
#pragma unroll 8
        for (int b = sl; b < rows; b += kRedSlices) {
            s += partial[static_cast<size_t>(b) * row + col];
            if (dcol >= 0) d += partial[static_cast<size_t>(b) * row + dcol];
        }
    }
    red[sl][0][lane] = s;
    red[sl][1][lane] = d;
    __syncthreads();
    if (sl == 0 && col >= 0) {
#pragma unroll
        for (int j = 1; j < kRedSlices; ++j) {
            s += red[j][0][lane];
            d += red[j][1][lane];
        }
        grads[p] = dcol >= 0
                       ? __fsub_rn(__fmul_rn(scale[mm], s), __fmul_rn(__fmul_rn(shift[mm], scale[mm]), d))
                       : s;
    }
}

struct PlanDeep {
    int km, ctas, per_sm, row;
    long long smem;
};

const void* kernel_deep_for(int km) {
    switch (km) {
        case 8: return reinterpret_cast<const void*>(&vg_deep_kernel<8>);
        case 16: return reinterpret_cast<const void*>(&vg_deep_kernel<16>);
        case 32: return reinterpret_cast<const void*>(&vg_deep_kernel<32>);
        default: return reinterpret_cast<const void*>(&vg_deep_kernel<64>);
    }
}

Occupancy g_occ_deep[4];

int plan_deep(int m, int B, int n, int k0, int s, int depth, PlanDeep* pl) {
    pl->km = deep::pick_km64(k0, s);
    pl->smem = deep::smem(m, k0, s, depth, 1);
    if (pl->km < 0 || pl->smem < 0 || n <= 0 || B % kGBytes || n > 4 * B || (depth == 0 && k0 != s))
        return static_cast<int>(cudaErrorInvalidValue);
    pl->row = (deep::flat_size(m, k0, s, depth) + 1 + 3) & ~3;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    Occupancy& occ = g_occ_deep[pl->km == 8 ? 0 : (pl->km == 16 ? 1 : (pl->km == 32 ? 2 : 3))];
    if (occ.dev != dev || occ.smem != pl->smem) {
        const void* fn = kernel_deep_for(pl->km);
        if ((e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      static_cast<int>(pl->smem))) != cudaSuccess ||
            (e = cudaDeviceGetAttribute(&occ.sms, cudaDevAttrMultiProcessorCount, dev)) !=
                cudaSuccess ||
            (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ.per_sm, fn, deep::kThreads,
                                                               pl->smem)) != cudaSuccess) {
            occ.dev = -1;
            return static_cast<int>(e);
        }
        occ.dev = dev;
        occ.smem = pl->smem;
    }
    pl->per_sm = occ.per_sm;
    if (pl->per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    // one wave of resident CTAs, each with an equal run of the tiles
    const long long wave = static_cast<long long>(pl->per_sm) * occ.sms;
    const int tiles = deep::tiles_of(n);
    pl->ctas = static_cast<int>(wave < tiles ? wave : tiles);
    return 0;
}

}  // namespace

// Shared memory (bytes) K4 needs for one branch of m_pad markers and padded
// widths k0, s at this depth, or -1 if it cannot run them: at depth 0 and
// widths up to 32 the rule of the depth-0 kernel (the first f32 layout, which its
// tensor-core kernel never exceeds); at any other depth or at widths 33-64
// that of csrc/packed_deep.cuh (one chain); -1 above width 64 or past 227 KB.
extern "C" long long branch_vg_packed_smem(int m, int k0, int s, int depth) {
    if (depth == 0 && pick_km(k0, s) > 0) {
        const size_t smem = smem_bytes0(m, pick_km(k0, s));
        return smem > static_cast<size_t>(kMaxSmem) ? -1 : static_cast<long long>(smem);
    }
    return deep::smem(m, k0, s, depth, 1);
}

// What the deep kernel uses on this shape, on the current device: out[0..5]
// = CTAs (the grid, one partial row each), floats per partial row, the
// width class KM, resident CTAs per SM, tiles of 16 byte columns, shared
// bytes per CTA.
extern "C" int branch_vg_packed_deep_plan(int m, int B, int n, int k0, int s, int depth,
                                          long long* out) {
    PlanDeep pl;
    const int status = plan_deep(m, B, n, k0, s, depth, &pl);
    if (status != 0) return status;
    const long long v[6] = {pl.ctas, pl.row, pl.km, pl.per_sm, deep::tiles_of(n), pl.smem};
    for (int i = 0; i < 6; ++i) out[i] = v[i];
    return 0;
}

// Any depth, or depth 0 at widths 33-64, one branch, the standardization
// folded inside: bytes u8 [m, B] (group-strided, 16-byte aligned); target
// f32 [n]; q f32 [P], the flat layout W0 [m, k0], b0 [k0], per hidden layer
// W_l [k0, out_l] and b_l [out_l], w_out [s] (depth 0: k0 == s); scale,
// shift f32 [m]; y_pred f32 [n]; partial f32 scratch of partial_floats, at
// least ctas * row of branch_vg_packed_deep_plan; grads f32 [P + 1] = the
// flat layout's gradients, dW0 unfolded, then rss. Exactly two launches:
// the pass and its reduce.
extern "C" int branch_vg_packed_deep_f32(const void* bytes, const void* target, const void* q,
                                         const void* scale, const void* shift, void* y_pred,
                                         void* partial, long long partial_floats, void* grads,
                                         int m, int B, int n, int k0, int s, int depth, int act,
                                         void* stream) {
    if (reinterpret_cast<uintptr_t>(bytes) & 15) return static_cast<int>(cudaErrorMisalignedAddress);
    PlanDeep pl;
    const int status = plan_deep(m, B, n, k0, s, depth, &pl);
    if (status != 0) return status;
    if (static_cast<long long>(pl.ctas) * pl.row > partial_floats)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int P = deep::flat_size(m, k0, s, depth);
    ArgsDeep args{static_cast<const uint8_t*>(bytes), static_cast<const float*>(target),
                  static_cast<const float*>(q),       static_cast<const float*>(scale),
                  static_cast<const float*>(shift),   static_cast<float*>(y_pred),
                  static_cast<float*>(partial),       pl.row,
                  deep::make_shape(m, k0, s, depth, n, B, act)};
    void* params[] = {&args};
    cudaError_t e = cudaLaunchKernel(kernel_deep_for(pl.km), dim3(pl.ctas), dim3(deep::kThreads),
                                     params, pl.smem, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    reduce_deep_kernel<<<(P + 1 + kRedCols - 1) / kRedCols, kRedCols * kRedSlices, 0, st>>>(
        static_cast<const float*>(partial), pl.ctas, pl.row, static_cast<const float*>(scale),
        static_cast<const float*>(shift), static_cast<float*>(grads), m, k0, P);
    return static_cast<int>(cudaGetLastError());
}

// What the depth-0 kernel uses on this shape, on the current device: out[0..7]
// = CTAs (the grid, one partial row each), floats per partial row, column
// tiles of 8 (NT), byte tile buffers, resident CTAs per SM, tiles of 64 byte
// columns, shared bytes per CTA, bf16 per weight plane row.
extern "C" int branch_vg_packed0_plan(int m, int B, int n, int k0, long long* out) {
    Plan0 pl;
    const int status = plan0(m, B, n, k0, &pl);
    if (status != 0) return status;
    const long long v[8] = {pl.ctas, pl.row, pl.nt, pl.nbuf, pl.per_sm, pl.tiles, pl.smem,
                            pl.wstride};
    for (int i = 0; i < 8; ++i) out[i] = v[i];
    return 0;
}

// Depth 0, one branch, the standardization folded inside: bytes u8 [m, B]
// (group-strided, 16-byte aligned); target f32 [n]; w0 f32 [m, k0]; b0 f32
// [k0]; wout f32 [k0]; scale, shift f32 [m]; y_pred f32 [n] (8-byte
// aligned); partial f32 scratch of partial_floats, at least ctas * row of
// branch_vg_packed0_plan (16-byte aligned); grads f32
// [m * k0 + 2 * k0 + 1] = dW0 [m, k0], db0 [k0], dW_out [k0], rss, in the
// unfolded coordinates. Exactly two launches: the pass and its reduce.
extern "C" int branch_vg_packed0_f32(const void* bytes, const void* target, const void* w0,
                                     const void* b0, const void* wout, const void* scale,
                                     const void* shift, void* y_pred, void* partial,
                                     long long partial_floats, void* grads, int m, int B, int n,
                                     int k0, int act, void* stream) {
    if ((reinterpret_cast<uintptr_t>(bytes) | reinterpret_cast<uintptr_t>(partial)) & 15 ||
        reinterpret_cast<uintptr_t>(y_pred) & 7)
        return static_cast<int>(cudaErrorMisalignedAddress);
    Plan0 pl;
    const int status = plan0(m, B, n, k0, &pl);
    if (status != 0) return status;
    if (static_cast<long long>(pl.ctas) * pl.row > partial_floats)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    Args0 args{static_cast<const uint8_t*>(bytes), static_cast<const float*>(target),
               static_cast<const float*>(w0), static_cast<const float*>(b0),
               static_cast<const float*>(wout), static_cast<const float*>(scale),
               static_cast<const float*>(shift), static_cast<float*>(y_pred),
               static_cast<float*>(partial), m, B, n, k0, act, pl.tiles, pl.m16, pl.wstride,
               pl.row, pl.nbuf};
    void* params[] = {&args};
    cudaError_t e = cudaLaunchKernel(kernel0_for(pl.nt), dim3(pl.ctas), dim3(kThreads), params,
                                     pl.smem, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int total = m * k0 + 2 * k0 + 1;
    reduce0_kernel<<<(total + kRedCols - 1) / kRedCols, kRedCols * kRedSlices, 0, st>>>(
        static_cast<const float*>(partial), pl.ctas, pl.row, static_cast<const float*>(scale),
        static_cast<const float*>(shift), static_cast<float*>(grads), m, k0, 8 * pl.nt, pl.m16);
    return static_cast<int>(cudaGetLastError());
}
