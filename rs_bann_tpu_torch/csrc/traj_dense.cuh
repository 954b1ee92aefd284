// K6's kernels (csrc/traj_dense.cu holds the plans, the entry points and
// the design's notes), templated on X's storage: f32, or (XB) bf16 under
// --x-bf16, the X tile staged in bf16 (csrc/dense_vg_mma.cuh,
// csrc/dense_deep.cuh). csrc/traj_dense.cu instantiates the f32 kernels,
// csrc/traj_dense_xbf16.cu the bf16 ones, so the two compile in parallel.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dense_deep.cuh"
#include "dense_vg_mma.cuh"

namespace rsbann {
namespace traj {

namespace cg = cooperative_groups;
using namespace rsbann::vg;

constexpr int kMaxCC = 2;  // chains (groups of 4 warps) per CTA

// Element (r, k) of instance (g, c), at any strides.
__device__ __forceinline__ float ld_any(const Inst& v, int g, int c, int r, int k) {
    return __ldg(at(v, g, c) + r * v.sr + k * v.sk);
}

struct TrajArgs {
    const void* x;   // [G, m, n], f32 or (XB) bf16
    Inst target;     // [G, C, n]
    Inst err;        // [G, C]
    // per layer: the start (w, pw), the step sizes, the prior precision
    // factors, and the end of the trajectory (qo, po), written by the launch
    Inst w[kLayers], pw[kLayers], eps[kLayers], lam[kLayers], qo[kLayers], po[kLayers];
    float* partial;  // [(ctas + NB) * CC, P]: segment (CTA b, instance j), chain i in row (b + j) CC + i
    int G, C, m, n, k0, s, P, steps, l1;
    int chunks, NB, tiles, ctas, rper;  // rper: CTAs per instance (0: one wave over several)
    int m16, m8, nbuf, vec16;
    int lsize[kLayers], loff[kLayers];  // elements of each layer per (branch, chain), offset in P
    int lcols[kLayers];                 // columns of each layer
};

// The update phase for layer LY of CC-chain instances: one thread per
// (branch, chain, element), the per-coordinate arithmetic of the leapfrog
// (l: the evaluation).
template <int LY, int CC>
__device__ __forceinline__ void update_layer(const TrajArgs& a, int l) {
    const int size = a.lsize[LY], total = a.G * a.C * size;
    const int stride = gridDim.x * blockDim.x;
    const long long items = static_cast<long long>(a.NB) * a.tiles;
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride) {
        const int bc = e / size, i = e - bc * size;
        const int g = bc / a.C, c = bc - g * a.C;
        const int r = i / a.lcols[LY], k = i - r * a.lcols[LY];
        const int j = g * a.chunks + c / CC, ci = c % CC;
        int first, nseg;
        if (a.rper) {
            first = j * a.rper;
            nseg = a.rper;
        } else {
            first = cta_of(static_cast<long long>(j) * a.tiles, a.ctas, items);
            nseg = cta_of(static_cast<long long>(j + 1) * a.tiles - 1, a.ctas, items) - first + 1;
        }
        const float* src = a.partial + (static_cast<size_t>(first + j) * CC + ci) * a.P + a.loff[LY] + i;
        float sum = 0.f;
        for (int r = 0; r < nseg; ++r) sum += __ldcg(src + static_cast<size_t>(r) * CC * a.P);
        float q = __ldcg((l == 0 ? at(a.w[LY], g, c) : at(a.qo[LY], g, c)) + i);
        float p = __ldcg((l == 0 ? at(a.pw[LY], g, c) : at(a.po[LY], g, c)) + i);
        const float ep = ld_any(a.eps[LY], g, c, r, k);
        const float prior = a.l1 ? (q > 0.f ? 1.f : (q < 0.f ? -1.f : 0.f)) : q;
        const float gr = -ld_any(a.lam[LY], g, c, r, k) * prior - __ldg(at(a.err, g, c)) * sum;
        if (l > 0) p += 0.5f * ep * gr;  // closes step l
        if (l < a.steps) {                // opens step l + 1
            p += 0.5f * ep * gr;
            q += ep * p;
        }
        __stcg(const_cast<float*>(at(a.qo[LY], g, c)) + i, q);
        __stcg(const_cast<float*>(at(a.po[LY], g, c)) + i, p);
    }
}

// The chain's weights: the caller's at evaluation 0, then the launch's own.
__device__ __forceinline__ Inst pick(bool start, Inst in, Inst out) { return start ? in : out; }

template <int KM, bool DEEP, int ACT, int CC, bool XB>
__global__ void __launch_bounds__(kThreads * CC, CC == 1 ? 3 : 1)
    traj_dense_kernel(const __grid_constant__ TrajArgs a) {
    constexpr int K16 = km16(KM), MT = K16 / 16;
    using XT = XElem<XB>;
    extern __shared__ float4 smem4[];
    cg::grid_group grid = cg::this_grid();
    const int grp = threadIdx.x / kThreads;  // this warp group's chain of the chunk
    const int tid = threadIdx.x - grp * kThreads, w = tid >> 5, t = tid & 3;
    // [nbuf][m16][kS] (bf16: [kSB]), shared by the groups
    XT* xs = reinterpret_cast<XT*>(smem4);
    const int xtile = a.m16 * (XB ? kSB : kS);  // elements of one X buffer
    const Group<KM, DEEP, true> gs(
        reinterpret_cast<float*>(smem4) + a.nbuf * x_tile_floats(a.m16, XB) +
            grp * static_cast<int>(group_floats(KM, DEEP, true, false, a.m16, a.m8)),
        a.m16, a.m8);
    const int m = a.m, n = a.n, k0 = a.k0, s = a.s, P = a.P;
    const long long items = static_cast<long long>(a.NB) * a.tiles;
    const long long it_begin = blockIdx.x * items / a.ctas;
    const long long it_end = (blockIdx.x + 1) * items / a.ctas;
    // X tile tl of branch xb into dst, by every thread of the CTA
    auto x_tile = [&](int xb, int tl, XT* dst) {
        load_x(static_cast<const XT*>(a.x) + static_cast<size_t>(xb) * m * n, m, n, a.m16, a.vec16,
               tl, dst);
    };
    Sums<MT> sm;
    sm.zero();

    // the first item of the CTA's run, the same in every evaluation
    const int j0 = static_cast<int>(it_begin / a.tiles), tl0 = static_cast<int>(it_begin % a.tiles);
    int buf = 0;
    x_tile(j0 / a.chunks, tl0, xs);
    zero_frags<KM, DEEP, true>(gs, a.m8, tid);
    __syncthreads();

    // evaluation 0 only gives the initial gradient; 1..L integrate
    for (int l = 0; l <= a.steps; ++l) {
        int jj = j0, tl = tl0, j = -1, gb = 0, c = 0;
        bool live = false;  // this group's chain exists (a ragged last chunk has fewer)
        auto flush_j = [&]() {
            flush<KM, DEEP, false>(gs, sm, a.partial + (static_cast<size_t>(blockIdx.x + j) * CC + grp) * P,
                                   nullptr, m, k0, s, grp);
        };
        for (long long it = it_begin; it < it_end; ++it) {
            const int i0 = tl * kT;
            const bool first = jj != j;  // the segment's first tile
            if (first) {
                if (live) flush_j();
                j = jj;
                gb = j / a.chunks;
                c = (j - gb * a.chunks) * CC + grp;
                live = c < a.C;
                if (live) {
                    const bool st = l == 0;
                    stage_weights_from<MT, K16, DEEP, true>(
                        at(pick(st, a.w[0], a.qo[0]), gb, c), at(pick(st, a.w[1], a.qo[1]), gb, c),
                        DEEP ? at(pick(st, a.w[2], a.qo[2]), gb, c) : nullptr,
                        DEEP ? at(pick(st, a.w[3], a.qo[3]), gb, c) : nullptr,
                        at(pick(st, a.w[4], a.qo[4]), gb, c), m, k0, s, tid, gs.w0f, gs.w1a, gs.w1b,
                        gs.b0s);
                }
            }
            if (++tl == a.tiles) tl = 0, ++jj;
            const bool next = it + 1 < it_end;
            cp_async_wait<0>();  // this tile's copies (the only ones in flight)
            // the targets of this thread's two individuals
            float tg_a = 0.f, tg_b = 0.f;
            if (live) {
                const float* tg = at(a.target, gb, c);
                const int i_a = i0 + 8 * w + 2 * t;
                if (i_a < n) tg_a = __ldg(tg + i_a);
                if (i_a + 1 < n) tg_b = __ldg(tg + i_a + 1);
            }
            // the X tile and the staged weights are visible, and every group is
            // done with the last tile: its buffer, planes and accumulators
            __syncthreads();
            if (next && a.nbuf == 2) x_tile(jj / a.chunks, tl, xs + (buf ^ 1) * xtile);
            const XT* xt = xs + buf * xtile;
            if (live)
                tile<KM, DEEP, true, ACT, false, XB>(gs, sm, xt, a.m8, a.m16, n, i0, tg_a, tg_b,
                                                     first, grp, nullptr);
            if (a.nbuf == 1) {
                __syncthreads();  // the one X buffer is free again
                if (next) x_tile(jj / a.chunks, tl, xs);
            } else {
                buf ^= 1;
            }
        }
        if (live) flush_j();
        // X never changes: the next evaluation's first tile comes in across
        // the grid syncs, into the buffer every group was done with before
        // the last tile
        if (l < a.steps) x_tile(j0 / a.chunks, tl0, xs + buf * xtile);
        grid.sync();

        update_layer<0, CC>(a, l);
        update_layer<1, CC>(a, l);
        if (DEEP) {
            update_layer<2, CC>(a, l);
            update_layer<3, CC>(a, l);
        }
        update_layer<4, CC>(a, l);
        grid.sync();
    }
}

template <int KM, bool DEEP, int CC, bool XB>
const void* kernel_act(int act) {
    switch (act) {
        case 1: return reinterpret_cast<const void*>(&traj_dense_kernel<KM, DEEP, 1, CC, XB>);
        case 2: return reinterpret_cast<const void*>(&traj_dense_kernel<KM, DEEP, 2, CC, XB>);
        case 3: return reinterpret_cast<const void*>(&traj_dense_kernel<KM, DEEP, 3, CC, XB>);
        case 4: return reinterpret_cast<const void*>(&traj_dense_kernel<KM, DEEP, 4, CC, XB>);
        default: return reinterpret_cast<const void*>(&traj_dense_kernel<KM, DEEP, 0, CC, XB>);
    }
}

template <int KM, bool XB>
const void* kernel_km(bool deep, int act, int cc) {
    if (deep) return cc == 2 ? kernel_act<KM, true, 2, XB>(act) : kernel_act<KM, true, 1, XB>(act);
    return cc == 2 ? kernel_act<KM, false, 2, XB>(act) : kernel_act<KM, false, 1, XB>(act);
}

// The instantiation for the shape: the activation is a template parameter,
// so each one holds one activation's code (read at run time it made the
// flagship's launch 47% slower, PERF.md section 6; the 60 instantiations
// compile in parallel with branch_vg_packed.cu, which takes longer).
template <bool XB>
const void* kernel_for(int km, bool deep, int act, int cc) {
    if (km == 8) return kernel_km<8, XB>(deep, act, cc);
    if (km == 16) return kernel_km<16, XB>(deep, act, cc);
    return kernel_km<32, XB>(deep, act, cc);
}

// The deep design (csrc/dense_deep.cuh): instance j = (branch j / C,
// chain j % C), items (instance, tile of 64 individuals) split evenly over
// the cooperative grid, each CTA a contiguous run, one chain at a time; one
// partial row per (CTA, instance) per evaluation (row b + j). The weights
// and momenta are flat [G, C, P] copies the launch integrates in place;
// the update phase adds a coordinate's rows in CTA order, as above.
struct TrajDeepArgs {
    const void* x;   // [G, m, n], f32 or (XB) bf16
    Inst target;     // [G, C, n]
    Inst err;        // [G, C]
    float* w;        // [G, C, P]: the start, then the trajectory's end
    float* pw;       // [G, C, P]
    const float* eps;  // [G, C, P]
    const float* lam;  // [G, C, P]
    float* partial;    // [ctas + NB, P]
    deep::Shape sh;
    int C, NB, steps, l1, nbuf, vec16;
};

template <int KM, bool XB>
__global__ void __launch_bounds__(ddeep::kThreads)
    traj_dense_deep_kernel(const __grid_constant__ TrajDeepArgs a) {
    using XT = XElem<XB>;
    extern __shared__ float4 smem4[];
    cg::grid_group grid = cg::this_grid();
    const deep::Shape& sh = a.sh;
    const ddeep::Carve cv = ddeep::carve(smem4, sh, KM, a.nbuf, XB);
    XT* const xs = reinterpret_cast<XT*>(cv.xs);
    const int tile_elems = sh.m16 * ddeep::kXS, P = sh.P;
    const long long items = static_cast<long long>(a.NB) * sh.tiles;
    const long long it_begin = blockIdx.x * items / gridDim.x;
    const long long it_end = (blockIdx.x + 1) * items / gridDim.x;
    const long long total = static_cast<long long>(a.NB) * P;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    auto x_of = [&](int j) { return static_cast<const XT*>(a.x) + static_cast<size_t>(j / a.C) * sh.m * sh.n; };
    float e2 = 0.f;  // K7's and K8's rss term, not read here

    // evaluation 0 only gives the initial gradient; 1..L integrate
    for (int l = 0; l <= a.steps; ++l) {
        int jj = static_cast<int>(it_begin / sh.tiles), tl = static_cast<int>(it_begin % sh.tiles);
        int j = -1, buf = 0;
        if (it_begin < it_end) ddeep::load_x(x_of(jj), sh, a.vec16, tl, xs);
        for (long long it = it_begin; it < it_end; ++it) {
            const bool first = jj != j;  // the segment's first tile
            if (first) {
                j = jj;
                ddeep::stage_chain<KM>(sh, a.w + static_cast<size_t>(j) * P, cv.w0, cv.wf);
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
            const int g = j / a.C;
            ddeep::tile_chain<KM, true, XB>(sh, xs + buf * tile_elems, cv.w0, cv.wf, cv.sm, t,
                                        at(a.target, g, j - g * a.C), nullptr,
                                        a.partial + (static_cast<size_t>(blockIdx.x) + j) * P,
                                        first, e2);
            if (next && a.nbuf == 1) ddeep::load_x(x_of(jj), sh, a.vec16, tl, xs);
            if (a.nbuf == 2) buf ^= 1;
        }
        grid.sync();

        // one thread per (instance, coordinate): the segments' rows in CTA
        // order, the prior gradient and err, the leapfrog's arithmetic
        for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
             e += stride) {
            const int jc = static_cast<int>(e / P), p = static_cast<int>(e - static_cast<long long>(jc) * P);
            const int g = jc / a.C, c = jc - g * a.C;
            const int first = cta_of(static_cast<long long>(jc) * sh.tiles, gridDim.x, items);
            const int nseg =
                cta_of(static_cast<long long>(jc + 1) * sh.tiles - 1, gridDim.x, items) - first + 1;
            const float* src = a.partial + (static_cast<size_t>(first) + jc) * P + p;
            float sum = 0.f;
            for (int r = 0; r < nseg; ++r) sum += __ldcg(src + static_cast<size_t>(r) * P);
            float q = __ldcg(a.w + e);
            float pm = __ldcg(a.pw + e);
            const float ep = __ldg(a.eps + e);
            const float prior = a.l1 ? (q > 0.f ? 1.f : (q < 0.f ? -1.f : 0.f)) : q;
            const float gr = -__ldg(a.lam + e) * prior - __ldg(at(a.err, g, c)) * sum;
            if (l > 0) pm += 0.5f * ep * gr;  // closes step l
            if (l < a.steps) {                 // opens step l + 1
                pm += 0.5f * ep * gr;
                q += ep * pm;
            }
            __stcg(a.w + e, q);
            __stcg(a.pw + e, pm);
        }
        grid.sync();
    }
}

template <bool XB>
const void* deep_kernel_for(int km) {
    switch (km) {
        case 8: return reinterpret_cast<const void*>(&traj_dense_deep_kernel<8, XB>);
        case 16: return reinterpret_cast<const void*>(&traj_dense_deep_kernel<16, XB>);
        case 32: return reinterpret_cast<const void*>(&traj_dense_deep_kernel<32, XB>);
        default: return reinterpret_cast<const void*>(&traj_dense_deep_kernel<64, XB>);
    }
}

// The instantiations: the first design's for (width, depth 1, activation,
// CC) and the deep design's for its width class, f32 X in csrc/traj_dense.cu
// and bf16 X in csrc/traj_dense_xbf16.cu.
const void* kernel_f32(int km, bool deep, int act, int cc);
const void* kernel_xbf16(int km, bool deep, int act, int cc);
const void* deep_kernel_f32(int km);
const void* deep_kernel_xbf16(int km);

inline const void* kernel_x(int km, bool deep, int act, int cc, bool xb) {
    return xb ? kernel_xbf16(km, deep, act, cc) : kernel_f32(km, deep, act, cc);
}

}  // namespace traj
}  // namespace rsbann
