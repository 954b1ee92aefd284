// K6: chain-folded whole-trajectory leapfrog on dense feature-major X, its
// gradients on tf32 tensor cores.
//
// Replaces rs_bann_tpu/ops/leapfrog.py::_traj_kernel (pallas_call in
// _traj_chains_impl, reached through integrate_chains). For every (branch
// g, chain c) it integrates L leapfrog steps
//
//     p += eps/2 * g;   q += eps * p;   g = grad ld(q);   p += eps/2 * g
//
// of ld(q) = -lam * q^2 / 2 (or -lam * |q|, l1, gradient 0 at 0)
// - err[g, c] * rss(q) / 2 on xT [G, m, n]. Padded coordinates carry zero
// momentum and zero step size, so they never move. Any depth and padded
// widths up to 64, every activation: at depth 0 and 1 and widths up to 32
// the design below; at every other shape the deep one
// (traj_dense_deep_kernel at the end of this file, on csrc/dense_deep.cuh),
// entry traj_dense_deep_f32.
//
// What bounds it on the H100: each of the L + 1 gradient evaluations is the
// value and gradient of G x C branch MLPs over n individuals, 2 m k0 + 3 k0 s
// multiply-adds per (branch, chain, individual) in the five products (1.5e10
// FLOP at the dense flagship: G = 64, C = 4, m = 64, k0 = s = 32, depth 1,
// n = 4,096). They run in 3xTF32, three tf32 tensor-core products per f32
// one: 0.091 ms per evaluation at 494.7 TFLOP/s, 5.98 ms at L = 64 (14.7 ms
// as f32 FMAs outside the tensor cores). X (67 MB f32) exceeds the 50 MB L2
// and is streamed once per evaluation (20 us at 3.35 TB/s). Measured:
// PERF.md section 6.
//
// Design:
//  * One cooperative launch per trajectory, its grid sized from the
//    occupancy API, so an oversize grid is refused at launch instead of
//    hanging at a grid sync.
//  * The gradient phase runs the dense device code of K7 and K8
//    (csrc/dense_vg_mma.cuh: its tile and its flush), its operands but the
//    staged weights split into tf32 hi and lo by integer operations on the
//    bits (split2_int: fewer issue slots than cvt.rna). An instance is
//    (branch g, chunk of CC chains). A CTA is CC groups of 4 warps, group
//    i running chain i of the chunk, all on the one X tile of
//    32 individuals the CTA stages by cp.async (double buffered where shared
//    memory allows): each tile is read once for the chunk's chains, and each
//    SM sub-partition holds a warp of every group, so the groups'
//    independent MMAs issue back to back. CC is the largest instantiated
//    (2, 1) that is at most C and fits shared memory; CC = 1 fits every
//    shape traj_dense_smem admits. The chunks of one branch run on CTAs
//    that walk its tiles in step, so their second read of a tile can find
//    it in L2.
//  * A fixed work split for the whole launch: the G x chunks x ceil(n / 32)
//    items are split evenly over the CTAs. Where the card holds a CTA per
//    instance, the grid is R CTAs per instance, each a contiguous run of one
//    branch's tiles; else one wave, whose CTAs take several instances in
//    turn. A group keeps its chain's gradient sums in shared memory over its
//    run and writes one partial row per (segment, chain) per evaluation.
//  * grid.sync(), then the update phase, one thread per (branch, chain,
//    coordinate): the segments' rows are added in a fixed order (no float
//    atomics, so the same inputs give the same bits), the prior gradient and
//    err applied, and the momentum and position updated; then grid.sync()
//    again. Weights, momenta, step sizes and prior factors are read layer by
//    layer from the caller's tensors (strided over branches and chains; the
//    step sizes and prior factors at any strides, so a broadcast one is read
//    in place) and the trajectory's end written layer by layer, so a call
//    copies nothing.
//    State written inside the launch (the outputs, the partial rows) is read
//    through L2 only (__ldcg); X, which never changes, is read ahead across
//    the grid syncs for the next evaluation's first tile.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dense_deep.cuh"
#include "dense_vg_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace rsbann;
using namespace rsbann::vg;

constexpr int kMaxCC = 2;  // chains (groups of 4 warps) per CTA

// Element (r, k) of instance (g, c), at any strides.
__device__ __forceinline__ float ld_any(const Inst& v, int g, int c, int r, int k) {
    return __ldg(at(v, g, c) + r * v.sr + k * v.sk);
}

struct TrajArgs {
    const float* x;  // [G, m, n]
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

template <int KM, bool DEEP, int ACT, int CC>
__global__ void __launch_bounds__(kThreads * CC, CC == 1 ? 3 : 1)
    traj_dense_kernel(const __grid_constant__ TrajArgs a) {
    constexpr int K16 = km16(KM), MT = K16 / 16;
    extern __shared__ float4 smem4[];
    cg::grid_group grid = cg::this_grid();
    const int grp = threadIdx.x / kThreads;  // this warp group's chain of the chunk
    const int tid = threadIdx.x - grp * kThreads, w = tid >> 5, t = tid & 3;
    float* xs = reinterpret_cast<float*>(smem4);  // [nbuf][m16][kS], shared by the groups
    const Group<KM, DEEP, true> gs(
        xs + a.nbuf * a.m16 * kS +
            grp * static_cast<int>(group_floats(KM, DEEP, true, false, a.m16, a.m8)),
        a.m16, a.m8);
    const int m = a.m, n = a.n, k0 = a.k0, s = a.s, P = a.P;
    const long long items = static_cast<long long>(a.NB) * a.tiles;
    const long long it_begin = blockIdx.x * items / a.ctas;
    const long long it_end = (blockIdx.x + 1) * items / a.ctas;
    // X tile tl of branch xb into dst, by every thread of the CTA
    auto x_tile = [&](int xb, int tl, float* dst) {
        load_x(a.x + static_cast<size_t>(xb) * m * n, m, n, a.m16, a.vec16, tl, dst);
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
            if (next && a.nbuf == 2) x_tile(jj / a.chunks, tl, xs + (buf ^ 1) * a.m16 * kS);
            const float* xt = xs + buf * a.m16 * kS;
            if (live)
                tile<KM, DEEP, true, ACT, false>(gs, sm, xt, a.m8, a.m16, n, i0, tg_a, tg_b, first,
                                                 grp, nullptr);
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
        if (l < a.steps) x_tile(j0 / a.chunks, tl0, xs + buf * a.m16 * kS);
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

struct Plan {
    int km, cc, chunks, NB, tiles, m16, m8, nbuf, per_sm, ctas, rper;
    long long smem, scratch;  // bytes
};

template <int KM, bool DEEP, int CC>
const void* kernel_act(int act) {
    switch (act) {
        case 1: return reinterpret_cast<const void*>(&traj_dense_kernel<KM, DEEP, 1, CC>);
        case 2: return reinterpret_cast<const void*>(&traj_dense_kernel<KM, DEEP, 2, CC>);
        case 3: return reinterpret_cast<const void*>(&traj_dense_kernel<KM, DEEP, 3, CC>);
        case 4: return reinterpret_cast<const void*>(&traj_dense_kernel<KM, DEEP, 4, CC>);
        default: return reinterpret_cast<const void*>(&traj_dense_kernel<KM, DEEP, 0, CC>);
    }
}

template <int KM>
const void* kernel_km(bool deep, int act, int cc) {
    if (deep) return cc == 2 ? kernel_act<KM, true, 2>(act) : kernel_act<KM, true, 1>(act);
    return cc == 2 ? kernel_act<KM, false, 2>(act) : kernel_act<KM, false, 1>(act);
}

// The instantiation for the shape: the activation is a template parameter,
// so each one holds one activation's code (read at run time it made the
// flagship's launch 47% slower, PERF.md section 6; the 60 instantiations
// compile in parallel with branch_vg_packed.cu, which takes longer).
const void* kernel_for(int km, bool deep, int act, int cc) {
    if (km == 8) return kernel_km<8>(deep, act, cc);
    if (km == 16) return kernel_km<16>(deep, act, cc);
    return kernel_km<32>(deep, act, cc);
}

// The shared memory attribute and the occupancy of each instantiation, kept
// per device and shared size.
struct Occupancy {
    int dev = -1, sms = 0, per_sm = 0, nbuf = 0;
    long long smem1 = -1, smem2 = -1;  // shared bytes with one and two X buffers
};
Occupancy g_occ[3 * 2 * 5 * kMaxCC];

// The largest CC of (2, 1) that is at most C and fits, its X buffers and
// resident CTAs per SM, and the work split.
int plan(int G, int C, int m, int n, int k0, int s, int depth, int act, Plan* pl) {
    if (G <= 0 || C <= 0 || n <= 0 || act < 0 || act > 4 ||
        cta_smem(m, k0, s, depth, true, false, 1, 1) < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const bool deep = depth == 1;
    pl->km = pick_km(k0, s);
    pl->tiles = (n + kT - 1) / kT;
    pl->m16 = (m + 15) & ~15;
    pl->m8 = (m + 7) & ~7;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    pl->cc = 0;
    for (int cc = kMaxCC; cc >= 1 && pl->cc == 0; --cc) {
        if (cc > C && cc > 1) continue;
        // two X buffers (the next tile's copy under this one's work) unless
        // they cost a resident CTA per SM or do not fit
        const long long s1 = cta_smem(m, k0, s, depth, true, false, cc, 1);
        const long long s2 = cta_smem(m, k0, s, depth, true, false, cc, 2);
        if (s1 < 0) continue;
        const int slot = (((pl->km == 8 ? 0 : pl->km == 16 ? 1 : 2) * 2 + (deep ? 1 : 0)) * 5 + act) *
                             kMaxCC + cc - 1;
        Occupancy& occ = g_occ[slot];
        if (occ.dev != dev || occ.smem1 != s1 || occ.smem2 != s2) {
            const void* fn = kernel_for(pl->km, deep, act, cc);
            const bool two = s2 > 0;
            int p1 = 0, p2 = 0;
            if ((e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          static_cast<int>(two ? s2 : s1))) != cudaSuccess ||
                (e = cudaDeviceGetAttribute(&occ.sms, cudaDevAttrMultiProcessorCount, dev)) !=
                    cudaSuccess ||
                (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p1, fn, kThreads * cc, s1)) !=
                    cudaSuccess ||
                (two && (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p2, fn, kThreads * cc,
                                                                           s2)) != cudaSuccess)) {
                occ.dev = -1;
                return static_cast<int>(e);
            }
            occ.nbuf = two && p2 >= p1 ? 2 : 1;
            occ.per_sm = occ.nbuf == 2 ? p2 : p1;
            occ.dev = dev;
            occ.smem1 = s1;
            occ.smem2 = s2;
        }
        if (occ.per_sm < 1) continue;
        pl->cc = cc;
        pl->nbuf = occ.nbuf;
        pl->smem = occ.nbuf == 2 ? s2 : s1;
        pl->per_sm = occ.per_sm;
        const long long wave = static_cast<long long>(occ.per_sm) * occ.sms;
        pl->chunks = (C + cc - 1) / cc;
        pl->NB = G * pl->chunks;
        if (wave >= pl->NB) {  // R CTAs per instance, each a run of one branch's tiles
            pl->rper = static_cast<int>(wave / pl->NB < pl->tiles ? wave / pl->NB : pl->tiles);
            pl->ctas = pl->NB * pl->rper;
        } else {  // one wave, several instances per CTA
            pl->rper = 0;
            pl->ctas = static_cast<int>(wave);
        }
    }
    if (pl->cc == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int P = partial_size(m, k0, s, deep);
    pl->scratch = (static_cast<long long>(pl->ctas) + pl->NB) * pl->cc * P * 4;
    return 0;
}

// The deep design (csrc/dense_deep.cuh): instance j = (branch j / C,
// chain j % C), items (instance, tile of 64 individuals) split evenly over
// the cooperative grid, each CTA a contiguous run, one chain at a time; one
// partial row per (CTA, instance) per evaluation (row b + j). The weights
// and momenta are flat [G, C, P] copies the launch integrates in place;
// the update phase adds a coordinate's rows in CTA order, as above.
struct TrajDeepArgs {
    const float* x;  // [G, m, n]
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

template <int KM>
__global__ void __launch_bounds__(ddeep::kThreads)
    traj_dense_deep_kernel(const __grid_constant__ TrajDeepArgs a) {
    extern __shared__ float4 smem4[];
    cg::grid_group grid = cg::this_grid();
    const deep::Shape& sh = a.sh;
    const ddeep::Carve cv = ddeep::carve(smem4, sh, KM, a.nbuf);
    const int tile_floats = sh.m16 * ddeep::kXS, P = sh.P;
    const long long items = static_cast<long long>(a.NB) * sh.tiles;
    const long long it_begin = blockIdx.x * items / gridDim.x;
    const long long it_end = (blockIdx.x + 1) * items / gridDim.x;
    const long long total = static_cast<long long>(a.NB) * P;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    auto x_of = [&](int j) { return a.x + static_cast<size_t>(j / a.C) * sh.m * sh.n; };
    float e2 = 0.f;  // K7's and K8's rss term, not read here

    // evaluation 0 only gives the initial gradient; 1..L integrate
    for (int l = 0; l <= a.steps; ++l) {
        int jj = static_cast<int>(it_begin / sh.tiles), tl = static_cast<int>(it_begin % sh.tiles);
        int j = -1, buf = 0;
        if (it_begin < it_end) ddeep::load_x(x_of(jj), sh, a.vec16, tl, cv.xs);
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
                ddeep::load_x(x_of(jj), sh, a.vec16, tl, cv.xs + (buf ^ 1) * tile_floats);
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();  // the X tile is visible
            const int g = j / a.C;
            ddeep::tile_chain<KM, true>(sh, cv.xs + buf * tile_floats, cv.w0, cv.wf, cv.sm, t,
                                        at(a.target, g, j - g * a.C), nullptr,
                                        a.partial + (static_cast<size_t>(blockIdx.x) + j) * P,
                                        first, e2);
            if (next && a.nbuf == 1) ddeep::load_x(x_of(jj), sh, a.vec16, tl, cv.xs);
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

const void* traj_dense_deep_kernel_for(int km) {
    switch (km) {
        case 8: return reinterpret_cast<const void*>(&traj_dense_deep_kernel<8>);
        case 16: return reinterpret_cast<const void*>(&traj_dense_deep_kernel<16>);
        case 32: return reinterpret_cast<const void*>(&traj_dense_deep_kernel<32>);
        default: return reinterpret_cast<const void*>(&traj_dense_deep_kernel<64>);
    }
}

ddeep::Occupancy g_occ_deep[4];

// The deep design's cooperative grid for G x C instances, in K6's plan
// fields (CC 1, chunks C, R 0: the even split).
int plan_deep(int G, int C, int m, int n, int k0, int s, int depth, int act, Plan* pl,
              ddeep::Plan* dp) {
    if (G <= 0 || C <= 0 || act < 0 || act > 4) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e =
        ddeep::plan(traj_dense_deep_kernel_for, g_occ_deep, G * C, m, n, k0, s, depth, dp);
    if (e != cudaSuccess) return static_cast<int>(e);
    pl->km = dp->km, pl->cc = 1, pl->chunks = C, pl->NB = G * C, pl->tiles = dp->tiles;
    pl->m16 = (m + 15) & ~15, pl->m8 = (m + 7) & ~7, pl->nbuf = dp->nbuf;
    pl->per_sm = dp->per_sm, pl->ctas = dp->ctas, pl->rper = 0, pl->smem = dp->smem;
    pl->scratch = dp->slots * deep::flat_size(m, k0, s, depth) * 4;
    return 0;
}

}  // namespace

// Shared memory (bytes) K6 needs at these widths with one chain per CTA and
// one X buffer, or -1 if it cannot run them (a padded width above 64, or
// more than 227 KB): at depth 0 and 1 and widths up to 32 the first
// design's, at every other shape the deep design's (csrc/dense_deep.cuh).
// The CLI asks its mirror before a folded feature-major run on the card.
extern "C" long long traj_dense_smem(int m, int k0, int s, int depth) {
    if (ddeep::takes(k0, s, depth)) return ddeep::smem(m, k0, s, depth, 1);
    return cta_smem(m, k0, s, depth, true, false, 1, 1);
}

// What a K6 launch uses on this shape and activation on the current device:
// out[0..8] = CTAs, resident CTAs per SM, chains per CTA (CC), chunks of
// chains, tiles per branch (of 32 individuals; 64 in the deep design),
// shared bytes per CTA, X tile buffers, scratch bytes (the partial rows),
// register width KM (the deep design's width class 8-64).
extern "C" int traj_dense_plan(int G, int C, int m, int n, int k0, int s, int depth, int act,
                               long long* out) {
    Plan pl;
    ddeep::Plan dp;
    const int status = ddeep::takes(k0, s, depth)
                           ? plan_deep(G, C, m, n, k0, s, depth, act, &pl, &dp)
                           : plan(G, C, m, n, k0, s, depth, act, &pl);
    if (status != 0) return status;
    const long long v[9] = {pl.ctas, pl.per_sm, pl.cc, pl.chunks, pl.tiles, pl.smem, pl.nbuf,
                            pl.scratch, pl.km};
    for (int i = 0; i < 9; ++i) out[i] = v[i];
    return 0;
}

// x f32 [G, m, n] contiguous. ptrs[32] and strides[128] (four per pointer,
// in floats: over branches, chains, rows and columns, as Inst) describe
// [G, C, ...] f32 tensors: ptrs[0] targets [G, C, n], ptrs[1] err [G, C],
// then for each of the start w, the start momenta pw, the step sizes, the
// prior precision factors and the outputs (the end's positions, then its
// momenta) five layers W0 [m, k0], b0 [k0], W1 [k0, s], b1 [s], w_out
// [s, 1] (W1 and b1 null at depth 0). The step sizes and prior factors may
// have any strides (a broadcast one, stride 0, is read in place); the
// other tensors' trailing dims must be contiguous. The outputs must not
// overlap the inputs. scratch: the plan's bytes.
extern "C" int traj_dense_f32(const void* x, const void* const* ptrs, const long long* strides,
                              void* scratch, long long scratch_bytes, int G, int C, int m, int n,
                              int k0, int s, int depth, int steps, int act, int l1, void* stream) {
    Plan pl;
    int status = plan(G, C, m, n, k0, s, depth, act, &pl);
    if (status != 0) return status;
    const int P = partial_size(m, k0, s, depth == 1);
    if (steps < 0 || scratch_bytes < pl.scratch ||
        static_cast<long long>(G) * C * P > (1LL << 30))  // the update phase's int indices
        return static_cast<int>(cudaErrorInvalidValue);
    const bool deep = depth == 1;
    auto inst = [&](int k) {
        return Inst{static_cast<const float*>(ptrs[k]), strides[4 * k], strides[4 * k + 1],
                    strides[4 * k + 2], strides[4 * k + 3]};
    };
    TrajArgs a{};
    a.x = static_cast<const float*>(x);
    a.target = inst(0);
    a.err = inst(1);
    for (int ly = 0; ly < kLayers; ++ly) {
        a.w[ly] = inst(2 + ly);
        a.pw[ly] = inst(2 + kLayers + ly);
        a.eps[ly] = inst(2 + 2 * kLayers + ly);
        a.lam[ly] = inst(2 + 3 * kLayers + ly);
        a.qo[ly] = inst(2 + 4 * kLayers + ly);
        a.po[ly] = inst(2 + 5 * kLayers + ly);
    }
    a.partial = static_cast<float*>(scratch);
    a.G = G, a.C = C, a.m = m, a.n = n, a.k0 = k0, a.s = s;
    a.P = P;
    a.steps = steps, a.l1 = l1;
    a.chunks = pl.chunks, a.NB = pl.NB, a.tiles = pl.tiles, a.ctas = pl.ctas, a.rper = pl.rper;
    a.m16 = pl.m16, a.m8 = pl.m8, a.nbuf = pl.nbuf;
    a.vec16 = (n % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) ? 1 : 0;
    const int sizes[kLayers] = {m * k0, k0, deep ? k0 * s : 0, deep ? s : 0, s};
    const int cols[kLayers] = {k0, k0, s, s, 1};
    for (int ly = 0, off = 0; ly < kLayers; off += sizes[ly], ++ly) {
        a.lsize[ly] = sizes[ly];
        a.loff[ly] = off;
        a.lcols[ly] = cols[ly];
    }
    void* params[] = {&a};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        kernel_for(pl.km, deep, act, pl.cc), dim3(pl.ctas), dim3(kThreads * pl.cc), params,
        pl.smem, static_cast<cudaStream_t>(stream));
    return static_cast<int>(e);
}

// The deep design's K6 (csrc/dense_deep.cuh), at the shapes traj_dense_f32
// does not take (depth 2 or more, or a padded width of 33-64): x f32 [G,
// m, n] contiguous; ptrs[2] and strides[8] (four per pointer, as
// traj_dense_f32's) the targets [G, C, n] and err [G, C]; w, pw, eps, lam
// f32 [G, C, P] contiguous in the flat layout W0, b0, (W_l, b_l)..., w_out:
// w and pw the start on entry and the end of the trajectory on return;
// scratch: the plan's bytes. One cooperative launch.
extern "C" int traj_dense_deep_f32(const void* x, const void* const* ptrs, const long long* strides,
                                   void* w, void* pw, const void* eps, const void* lam,
                                   void* scratch, long long scratch_bytes, int G, int C, int m,
                                   int n, int k0, int s, int depth, int steps, int act, int l1,
                                   void* stream) {
    if (!ddeep::takes(k0, s, depth)) return static_cast<int>(cudaErrorInvalidValue);
    Plan pl;
    ddeep::Plan dp;
    const int status = plan_deep(G, C, m, n, k0, s, depth, act, &pl, &dp);
    if (status != 0) return status;
    const int P = deep::flat_size(m, k0, s, depth);
    if (steps < 0 || scratch_bytes < pl.scratch ||
        static_cast<long long>(G) * C * P > (1LL << 30))  // the update phase's int indices
        return static_cast<int>(cudaErrorInvalidValue);
    auto inst = [&](int k) {
        return Inst{static_cast<const float*>(ptrs[k]), strides[4 * k], strides[4 * k + 1],
                    strides[4 * k + 2], strides[4 * k + 3]};
    };
    TrajDeepArgs a{};
    a.x = static_cast<const float*>(x);
    a.target = inst(0);
    a.err = inst(1);
    a.w = static_cast<float*>(w);
    a.pw = static_cast<float*>(pw);
    a.eps = static_cast<const float*>(eps);
    a.lam = static_cast<const float*>(lam);
    a.partial = static_cast<float*>(scratch);
    a.sh = ddeep::make_shape(m, k0, s, depth, n, act);
    a.C = C, a.NB = G * C, a.steps = steps, a.l1 = l1, a.nbuf = dp.nbuf;
    a.vec16 = (n % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) ? 1 : 0;
    void* params[] = {&a};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        traj_dense_deep_kernel_for(dp.km), dim3(dp.ctas), dim3(ddeep::kThreads), params, dp.smem,
        static_cast<cudaStream_t>(stream)));
}
