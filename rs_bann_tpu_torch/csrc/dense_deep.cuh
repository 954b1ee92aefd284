// The dense branch MLP at any depth and at padded widths up to 64: the
// device code K6 (traj_dense.cu), K7 (vg_chains.cuh) and K8a/K8b
// (branch_vg_dense.cu) share for every feature-major shape their first
// design (dense_vg_mma.cuh: depth 0 or 1, widths up to 32) does not take:
// depth 2 or more, or a padded width of 33-64.
//
// Replaces, for those shapes, the bodies of rs_bann_tpu/ops/branch_mlp.py
// ``_kernel``, ``_blocked_kernel`` and ``_chain_kernel`` and of
// rs_bann_tpu/ops/leapfrog.py ``_traj_kernel`` (their loops over the
// hidden layers, unrolled at trace time for any depth).
//
// For one chain of one instance, per tile of 64 individuals of
// feature-major X [m, n], with D = depth hidden layers:
//
//     z0 = X^T W0 + b0
//     z_l = act(z_{l-1}) W_l + b_l   l = 1 .. D   (W_D is h x s, the others h x h)
//     pred = act(z_D) . w_out,  err = pred - target (0 past n)
//     dz_D = w_out * err * act'(z_D),  dz_{l-1} = (W_l dz_l) * act'(z_{l-1})
//
// and adds the tile's share of d(rss/2)/d(W_l, b_l, w_out) and of dW0 = X
// dz0, db0 = sum dz0 to the chain's partial row in global memory.
//
// Design, a simple kernel that is right first:
//  * Layer 0 on tf32 tensor cores in 3xTF32 (mma.sync.m16n8k8, every
//    operand split into tf32 hi and lo by split2_int, hi*hi, lo*hi and
//    hi*lo each from a zero accumulator, joined by round-to-nearest f32
//    adds: mma3_add of dense_vg_mma.cuh), so the value passes stay exact at
//    f32 level. The forward: warp w takes the tile's individuals 16 (w % 4)
//    .. + 15 (the MMA's M) and the column tiles of parity w / 4, K the
//    markers, A read from the staged X tile and B from W0 staged in f32.
//    dW0 = X dz0: the warps take (marker tile, pair of column tiles) units
//    in turn, K the tile's individuals, B from the dz0 rows.
//  * The X tile [m16][64] is staged by cp.async (two buffers where shared
//    memory allows) with a row stride of 72 floats and 4-column chunks
//    swapped on rows with bit 2 set, so both products' loads of it miss
//    bank conflicts.
//  * The hidden layers, the output and their gradients are the packed deep
//    design's code (packed_deep.cuh ``hidden_pass``, shared, not copied):
//    f32 cores, 4 threads an individual each holding its row, z_l rows in
//    shared memory overwritten by dz_l on the way back, dW_l by owner
//    threads over the tile in order.
//  * Sums: no float atomics. Every output of a partial row has one owner
//    thread, which stores it on the segment's first tile and adds each
//    later tile in tile order; the segments' rows are summed in a fixed
//    order afterwards, so the same inputs give the same bits.
//  * A CTA of 8 warps runs one chain at a time: work items (instance,
//    tile) split evenly over the CTAs, each a contiguous run whose
//    instance's weights are staged once per segment (one partial row per
//    (CTA, instance): row b + j, as dense_vg_mma.cuh's K8).
//  * Depth is a run-time loop; the width class KM (8, 16, 32, 64) is the
//    only template parameter besides X's storage, the activation a run-time
//    code.
//  * X stored in bf16 (--x-bf16, the XB instantiations): the tile is staged
//    in bf16, [m16][kXS] unswizzled (144-byte rows: both products' loads
//    fall on distinct banks), half the HBM stream and half the tile's
//    shared memory. A bf16 value is exact in tf32 (lo = 0), so layer 0's
//    products leave X's zero low part out (mma3_add_aexact): the f32
//    design's bits on the upcast values.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "dense_vg_mma.cuh"
#include "packed_deep.cuh"

namespace rsbann {
namespace ddeep {

using deep::kThreads;
using deep::kTile;
using deep::kWarps;

constexpr int kXS = kTile + 8;     // row stride of the X tile (8 mod 32)
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use

// Row stride of the staged W0 [m16][KM]: 8 or 24 mod 32, so a quad's rows
// fall on distinct banks.
__host__ __device__ constexpr int w0_stride(int km) { return km % 32 == 8 ? km + 16 : km + 8; }

// float index of (row r, column c) in the swizzled X tile
__device__ __forceinline__ int xswz(int r, int c) { return r * kXS + (c ^ (r & 4)); }

// Whether a shape runs this design: depth 2 or more, or a padded width
// above 32 (dense_vg_mma.cuh takes depth 0 and 1 at widths up to 32).
inline bool takes(int k0, int s, int depth) { return depth >= 2 || pick_km(k0, s) < 0; }

// Byte offsets of a CTA's shared memory with ``nbuf`` X tile buffers.
struct Layout {
    long long x, w0, wf, buf, small, total;
};

__host__ __device__ inline Layout layout(int m, int km, int depth, int nbuf, bool xb = false) {
    const long long m16 = (m + 15) & ~15;
    Layout L;
    L.x = 0;
    L.w0 = L.x + (xb ? 2LL : 4LL) * nbuf * m16 * kXS;                // f32 or bf16 [nbuf][m16][72]
    L.wf = L.w0 + 4LL * m16 * w0_stride(km);                         // f32 W0 [m16][ws]
    L.buf = L.wf + 4LL * deep::chain_floats(km, depth);              // b0, w_out, W_l^T, b_l
    L.small = L.buf + 4LL * (depth + 2) * kTile * deep::row_stride(km);  // [depth + 2][64][rs]
    L.total = L.small + 4LL * (5 * kTile + kWarps);                  // pred parts, err, warp sums
    return L;
}

// Shared memory of one CTA with ``nbuf`` X buffers (bf16 with xb), or -1
// above width 64 or past 227 KB.
inline long long smem(int m, int k0, int s, int depth, int nbuf, bool xb = false) {
    const int km = deep::pick_km64(k0, s);
    if (km < 0 || m <= 0 || depth < 0 || nbuf < 1) return -1;
    const long long t = layout(m, km, depth, nbuf, xb).total;
    return t <= kMaxSmem ? t : -1;
}

// X tile buffers: two where they fit, else one.
inline int buffers(int m, int k0, int s, int depth, bool xb) {
    return smem(m, k0, s, depth, 2, xb) > 0 ? 2 : 1;
}

inline deep::Shape make_shape(int m, int k0, int s, int depth, int n, int act) {
    deep::Shape sh{};
    sh.m = m;
    sh.m16 = (m + 15) & ~15;
    sh.k0 = k0;
    sh.s = s;
    sh.depth = depth;
    sh.P = deep::flat_size(m, k0, s, depth);
    sh.n = n;
    sh.tiles = (n + kTile - 1) / kTile;
    sh.act = act;
    return sh;
}

// Pointers into a CTA's shared memory (the X buffers as bytes).
struct Carve {
    char* xs;
    float *w0, *wf;
    deep::Smem sm;  // buf and small (the shared hidden pass's)
};

__device__ inline Carve carve(void* base, const deep::Shape& sh, int km, int nbuf, bool xb) {
    const Layout L = layout(sh.m, km, sh.depth, nbuf, xb);
    char* p = static_cast<char*>(base);
    Carve c;
    c.xs = p + L.x;
    c.w0 = reinterpret_cast<float*>(p + L.w0);
    c.wf = reinterpret_cast<float*>(p + L.wf);
    c.sm = deep::Smem{};
    c.sm.buf = reinterpret_cast<float*>(p + L.buf);
    c.sm.small = reinterpret_cast<float*>(p + L.small);
    return c;
}

// Tile t (individuals 64 t ..) of one branch xg [m, n] into ``xs``, by every
// thread of the CTA: rows past m and individuals past n are zero. vec16:
// n % 4 == 0 and X on 16 bytes, so 16-byte copies.
__device__ inline void load_x(const float* xg, const deep::Shape& sh, int vec16, int t, float* xs) {
    const int i0 = t * kTile;
    if (vec16) {
        for (int idx = threadIdx.x; idx < sh.m16 * (kTile / 4); idx += kThreads) {
            const int row = idx >> 4, c4 = idx & 15, i = i0 + 4 * c4;
            const bool ok = row < sh.m && i < sh.n;
            cp_async16(xs + xswz(row, 4 * c4), ok ? xg + static_cast<size_t>(row) * sh.n + i : xg,
                       ok ? 16 : 0);
        }
    } else {
        for (int idx = threadIdx.x; idx < sh.m16 * kTile; idx += kThreads) {
            const int row = idx >> 6, c = idx & (kTile - 1), i = i0 + c;
            const bool ok = row < sh.m && i < sh.n;
            vg::cp_async4(xs + xswz(row, c), ok ? xg + static_cast<size_t>(row) * sh.n + i : xg,
                          ok ? 4 : 0);
        }
    }
    cp_async_commit();
}

// The same for X stored in bf16 (``xs`` [m16][kXS], unswizzled): vec16: n %
// 8 == 0 and X on 16 bytes, so 16-byte copies of 8 values; else plain loads
// and stores, visible after the barrier that makes the tile visible.
__device__ inline void load_x(const uint16_t* xg, const deep::Shape& sh, int vec16, int t,
                              uint16_t* xs) {
    const int i0 = t * kTile;
    if (vec16) {
        for (int idx = threadIdx.x; idx < sh.m16 * (kTile / 8); idx += kThreads) {
            const int row = idx >> 3, c8 = idx & 7, i = i0 + 8 * c8;
            const bool ok = row < sh.m && i < sh.n;
            cp_async16(xs + row * kXS + 8 * c8, ok ? xg + static_cast<size_t>(row) * sh.n + i : xg,
                       ok ? 16 : 0);
        }
    } else {
        for (int idx = threadIdx.x; idx < sh.m16 * kTile; idx += kThreads) {
            const int row = idx >> 6, c = idx & (kTile - 1), i = i0 + c;
            xs[row * kXS + c] =
                row < sh.m && i < sh.n ? __ldg(xg + static_cast<size_t>(row) * sh.n + i) : 0;
        }
    }
    cp_async_commit();
}

// The tf32 parts of X element (row r, individual c) of the staged tile: f32
// split by split2_int (swizzled rows), or a bf16 value and a zero low part
template <bool XB>
__device__ __forceinline__ void x_split(const vg::XElem<XB>* xt, int r, int c, uint32_t& hi,
                                        uint32_t& lo) {
    if constexpr (XB) {
        hi = static_cast<uint32_t>(xt[r * kXS + c]) << 16;
        lo = 0;
    } else {
        vg::split2_int(xt[xswz(r, c)], hi, lo);
    }
}

// acc += A B for a fragment whose A is from X: mma3_add, or with XB (A exact
// in tf32) mma3_add_aexact
template <bool XB>
__device__ __forceinline__ void mma_x(float (&acc)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                      uint32_t bl0, uint32_t bl1) {
    if constexpr (XB) {
        vg::mma3_add_aexact(acc, ah, bh0, bh1, bl0, bl1);
    } else {
        vg::mma3_add(acc, ah, al, bh0, bh1, bl0, bl1);
    }
}

// Stage one chain's weights from its flat vector q (read through L2: K6
// rewrites it between evaluations): W0 in f32 [m16][ws] (zero past m and
// k0), b0 in the first KM floats of wf_s, then w_out and the hidden layers
// as the packed design stages them. Ends with a barrier.
template <int KM>
__device__ void stage_chain(const deep::Shape& sh, const float* q, float* w0_s, float* wf_s) {
    constexpr int WS = w0_stride(KM);
    const int tid = threadIdx.x;
    for (int idx = tid; idx < sh.m16 * KM; idx += kThreads) {
        const int r = idx / KM, c = idx - r * KM;
        w0_s[r * WS + c] = (r < sh.m && c < sh.k0) ? __ldcg(q + r * sh.k0 + c) : 0.f;
    }
    for (int j = tid; j < KM; j += kThreads) wf_s[j] = j < sh.k0 ? __ldcg(q + sh.m * sh.k0 + j) : 0.f;
    deep::stage_layers<KM>(sh, q, wf_s);
    __syncthreads();
}

// One chain on the staged X tile ``xt`` of tile t (the chain's weights in
// w0_s / wf_s): the forward and, with GRAD, the backward and the tile's
// gradient sums added to the chain's partial row ``part`` (flat layout;
// stored on the segment's first tile). With y_pred the predictions of the
// tile's individuals below n are written (with GRAD, err^2 added to e2).
// Starts after a barrier that made the tile visible; ends with a barrier.
// xt: the X tile, bf16 with XB.
template <int KM, bool GRAD, bool XB>
__device__ void tile_chain(const deep::Shape& sh, const vg::XElem<XB>* xt, const float* w0_s,
                           const float* wf_s, const deep::Smem& sm, int t, const float* target,
                           float* y_pred, float* part, bool first, float& e2) {
    constexpr int NT = KM / 8, RS = deep::row_stride(KM), WS = w0_stride(KM);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, tq = lane & 3;
    float* Z0 = sm.buf;

    // ---- 1. z0 = X^T W0 + b0 in 3xTF32: warp w the individuals 16 (w % 4)
    // + g (+ 8) as the MMA's rows, its column tiles of parity w / 4; the
    // rows past m are zero in both operands
    {
        const int r0 = 16 * (warp & 3) + g, par = warp >> 2;
        float acc[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll 1
        for (int kc = 0; kc < sh.m16 / 8; ++kc) {
            const int k = 8 * kc + tq;
            uint32_t ah[4], al[4];
            x_split<XB>(xt, k, r0, ah[0], al[0]);
            x_split<XB>(xt, k, r0 + 8, ah[1], al[1]);
            x_split<XB>(xt, k + 4, r0, ah[2], al[2]);
            x_split<XB>(xt, k + 4, r0 + 8, ah[3], al[3]);
            const float* wk = w0_s + k * WS + g;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                if ((nt & 1) != par) continue;
                uint32_t bh0, bl0, bh1, bl1;
                vg::split2_int(wk[8 * nt], bh0, bl0);
                vg::split2_int(wk[4 * WS + 8 * nt], bh1, bl1);
                mma_x<XB>(acc[nt], ah, al, bh0, bh1, bl0, bl1);
            }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            if ((nt & 1) != par) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int col = nt * 8 + 2 * tq;
                *reinterpret_cast<float2*>(Z0 + (r0 + 8 * h) * RS + col) =
                    make_float2(acc[nt][2 * h] + wf_s[col], acc[nt][2 * h + 1] + wf_s[col + 1]);
            }
        }
    }
    __syncthreads();

    // ---- 2-4. the hidden layers, the output and (GRAD) their gradients
    const int il = tid & (kTile - 1), i = t * kTile + il;
    deep::hidden_pass<KM, GRAD>(sh, wf_s, sm, i, i < sh.n, target, y_pred, part, first, e2);
    if constexpr (GRAD) {
        // ---- 5. layer 0's gradient: db0 = sum dz0 (dz0 in Z0), then dW0 =
        // X dz0 in 3xTF32, the warps taking (marker tile, NTU column tiles)
        // units in turn, K the tile's individuals
        if (tid < sh.k0) {
            float sum = 0.f;
            for (int ii = 0; ii < kTile; ++ii) sum += Z0[ii * RS + tid];
            deep::accum(part + sh.m * sh.k0 + tid, sum, first);
        }
        constexpr int NTU = NT >= 2 ? 2 : 1, NU = NT / NTU;
        const int units = (sh.m16 / 16) * NU;
#pragma unroll 1
        for (int u = warp; u < units; u += kWarps) {
            const int mt = u / NU, nt0 = (u - mt * NU) * NTU, r0 = 16 * mt + g;
            float acc[NTU][4];
#pragma unroll
            for (int v = 0; v < NTU; ++v)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[v][e] = 0.f;
#pragma unroll 2
            for (int ks = 0; ks < kTile / 8; ++ks) {
                const int c = 8 * ks + tq;
                uint32_t ah[4], al[4];
                x_split<XB>(xt, r0, c, ah[0], al[0]);
                x_split<XB>(xt, r0 + 8, c, ah[1], al[1]);
                x_split<XB>(xt, r0, c + 4, ah[2], al[2]);
                x_split<XB>(xt, r0 + 8, c + 4, ah[3], al[3]);
#pragma unroll
                for (int v = 0; v < NTU; ++v) {
                    const float* dz = Z0 + c * RS + 8 * (nt0 + v) + g;
                    uint32_t bh0, bl0, bh1, bl1;
                    vg::split2_int(dz[0], bh0, bl0);
                    vg::split2_int(dz[4 * RS], bh1, bl1);
                    mma_x<XB>(acc[v], ah, al, bh0, bh1, bl0, bl1);
                }
            }
            // element e of tile v: marker r0 + 8 (e / 2), column 8 (nt0 + v)
            // + 2 tq + e % 2; the earlier sums all loaded before any store
            auto at = [&](int v, int e) -> float* {
                const int mk = r0 + 8 * (e >> 1), col = 8 * (nt0 + v) + 2 * tq + (e & 1);
                return mk < sh.m && col < sh.k0 ? part + mk * sh.k0 + col : nullptr;
            };
            if (!first) {
#pragma unroll
                for (int v = 0; v < NTU; ++v)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        if (float* p = at(v, e)) acc[v][e] += __ldcg(p);
            }
#pragma unroll
            for (int v = 0; v < NTU; ++v)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (float* p = at(v, e)) __stcg(p, acc[v][e]);
        }
        __syncthreads();
    }
}

// K7's and K8's run over NB instances (``run_kernel``): instance j reads X
// branch xix[j] (null: j / C) and its target at (j / C, j % C).
struct RunArgs {
    const void* x;     // [G, m, n], f32 or (XB) bf16
    const int* xix;    // [NB] or null
    vg::Inst target;   // [.., C, n] (gradient)
    const float* q;    // [NB, P] flat weights
    float* y_pred;     // [NB, n]
    float* partial;    // [ctas + NB, P]: segment (CTA b, instance j) in row b + j (gradient)
    double* e2;        // [ctas + NB]: each segment's err^2 (gradient)
    deep::Shape sh;
    int C, NB, nbuf, vec16;
};

// The items (instance, tile) split evenly over the CTAs, each CTA a
// contiguous run: per item the tile chain, with GRAD each segment's err^2
// summed over the CTA in a fixed order at its end. Instantiated by
// csrc/branch_vg_chains.cu (GRAD) and csrc/branch_fwd_chains.cu (forward
// only; the XB twins in their *_xbf16.cu sources); K8's entry launches
// them too.
template <int KM, bool GRAD, bool XB>
__global__ void __launch_bounds__(kThreads) run_kernel(const __grid_constant__ RunArgs a) {
    using XT = vg::XElem<XB>;
    extern __shared__ float4 smem4[];
    const deep::Shape& sh = a.sh;
    const Carve cv = ddeep::carve(smem4, sh, KM, a.nbuf, XB);
    XT* const xs = reinterpret_cast<XT*>(cv.xs);
    const int tile_elems = sh.m16 * kXS;
    const long long items = static_cast<long long>(a.NB) * sh.tiles;
    const long long it_begin = blockIdx.x * items / gridDim.x;
    const long long it_end = (blockIdx.x + 1) * items / gridDim.x;
    auto x_of = [&](int j) {
        return static_cast<const XT*>(a.x) +
               static_cast<size_t>(a.xix != nullptr ? a.xix[j] : j / a.C) * sh.m * sh.n;
    };
    auto flush = [&](int j, float& e2) {
        const float sum = deep::cta_sum(e2, cv.sm.small + 5 * kTile);
        if (threadIdx.x == 0) a.e2[blockIdx.x + j] = static_cast<double>(sum);
        e2 = 0.f;
    };
    int jj = static_cast<int>(it_begin / sh.tiles), tl = static_cast<int>(it_begin % sh.tiles);
    int j = -1, buf = 0;
    float e2 = 0.f;
    if (it_begin < it_end) ddeep::load_x(x_of(jj), sh, a.vec16, tl, xs);
    for (long long it = it_begin; it < it_end; ++it) {
        const bool first = jj != j;  // the segment's first tile
        if (first) {
            if (GRAD && j >= 0) flush(j, e2);
            j = jj;
            ddeep::stage_chain<KM>(sh, a.q + static_cast<size_t>(j) * sh.P, cv.w0, cv.wf);
        }
        const int t = tl;
        if (++tl == sh.tiles) tl = 0, ++jj;
        const bool next = it + 1 < it_end;
        if (next && a.nbuf == 2) {
            ddeep::load_x(x_of(jj), sh, a.vec16, tl, xs + (buf ^ 1) * tile_elems);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();  // the X tile is visible
        const float* tg = GRAD ? vg::at(a.target, j / a.C, j - (j / a.C) * a.C) : nullptr;
        ddeep::tile_chain<KM, GRAD, XB>(sh, xs + buf * tile_elems, cv.w0, cv.wf, cv.sm, t, tg,
                             a.y_pred + static_cast<size_t>(j) * sh.n,
                             GRAD ? a.partial + (static_cast<size_t>(blockIdx.x) + j) * sh.P : nullptr,
                             first, e2);
        if (next && a.nbuf == 1) ddeep::load_x(x_of(jj), sh, a.vec16, tl, xs);
        if (a.nbuf == 2) buf ^= 1;
    }
    if (GRAD && j >= 0) flush(j, e2);
}

// The instantiation of run_kernel for width class km (csrc/branch_vg_chains.cu
// with the gradient, csrc/branch_fwd_chains.cu forward only; the bf16-X
// twins in csrc/branch_vg_chains_xbf16.cu and csrc/branch_fwd_chains_xbf16.cu).
const void* run_grad_kernel(int km);
const void* run_fwd_kernel(int km);
const void* run_grad_kernel_xbf16(int km);
const void* run_fwd_kernel_xbf16(int km);

template <bool GRAD, bool XB>
const void* run_kernel_for(int km) {
    switch (km) {
        case 8: return reinterpret_cast<const void*>(&run_kernel<8, GRAD, XB>);
        case 16: return reinterpret_cast<const void*>(&run_kernel<16, GRAD, XB>);
        case 32: return reinterpret_cast<const void*>(&run_kernel<32, GRAD, XB>);
        default: return reinterpret_cast<const void*>(&run_kernel<64, GRAD, XB>);
    }
}

// The getter of run_kernel's instantiation for the pass and X's storage
inline auto run_kernel_getter(bool grad, bool xb) -> const void* (*)(int) {
    if (xb) return grad ? run_grad_kernel_xbf16 : run_fwd_kernel_xbf16;
    return grad ? run_grad_kernel : run_fwd_kernel;
}

// The shared memory attribute and the occupancy of one instantiation at one
// shared size, kept per device.
struct Occupancy {
    int dev = -1, sms = 0, per_sm = 0;
    long long smem = -1;
};

inline cudaError_t occupancy(const void* fn, long long smem_bytes, Occupancy& occ) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (occ.dev == dev && occ.smem == smem_bytes) return cudaSuccess;
    if ((e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem_bytes))) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&occ.sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ.per_sm, fn, kThreads,
                                                           static_cast<size_t>(smem_bytes))) !=
            cudaSuccess) {
        occ.dev = -1;
        return e;
    }
    occ.dev = dev;
    occ.smem = smem_bytes;
    return cudaSuccess;
}

inline int km_slot(int km) { return km == 8 ? 0 : km == 16 ? 1 : km == 32 ? 2 : 3; }

// What a launch of this design over NB instances uses: the width class,
// X buffers, shared bytes, resident CTAs per SM, CTAs (one wave, at most
// one per item: K6's cooperative grid is resident), tiles per instance and
// partial-row slots (ctas + NB).
struct Plan {
    int km, nbuf, per_sm, ctas, tiles;
    long long smem, slots;
};

inline cudaError_t plan(const void* (*kernel_of)(int), Occupancy* occs, int NB, int m, int n,
                        int k0, int s, int depth, bool xb, Plan* pl) {
    if (NB <= 0 || n <= 0 || smem(m, k0, s, depth, 1, xb) < 0) return cudaErrorInvalidValue;
    pl->km = deep::pick_km64(k0, s);
    pl->nbuf = buffers(m, k0, s, depth, xb);
    pl->smem = smem(m, k0, s, depth, pl->nbuf, xb);
    Occupancy& occ = occs[km_slot(pl->km)];
    const cudaError_t e = occupancy(kernel_of(pl->km), pl->smem, occ);
    if (e != cudaSuccess) return e;
    pl->per_sm = occ.per_sm;
    if (pl->per_sm < 1) return cudaErrorInvalidConfiguration;
    pl->tiles = (n + kTile - 1) / kTile;
    const long long items = static_cast<long long>(NB) * pl->tiles;
    const long long wave = static_cast<long long>(pl->per_sm) * occ.sms;
    pl->ctas = static_cast<int>(wave < items ? wave : items);
    pl->slots = static_cast<long long>(pl->ctas) + NB;
    return cudaSuccess;
}

}  // namespace ddeep
}  // namespace rsbann
