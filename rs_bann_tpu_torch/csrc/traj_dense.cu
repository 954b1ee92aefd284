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
// momentum and zero step size, so they never move. Depth 0 and 1, widths up
// to 32, every activation.
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
//  * The gradient phase runs K8's device code (csrc/dense_vg_mma.cuh), its
//    operands but the staged weights split into tf32 hi and lo by integer
//    operations on the bits (split2_int: fewer issue slots than cvt.rna). An
//    instance is (branch g, chunk of CC chains). A CTA is CC groups of 4
//    warps, group i running chain i of the chunk, all on the one X tile of
//    32 individuals the CTA stages by cp.async (double buffered where shared
//    memory allows): each tile is read once for the chunk's chains, and each
//    SM sub-partition holds a warp of every group, so the groups'
//    independent MMAs issue back to back. CC is the largest instantiated
//    (2, 1) that is at most C and fits shared memory; CC = 1 fits every
//    shape dense_chains_smem admits. The chunks of one branch run on CTAs
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

#include "dense_vg_mma.cuh"

// K6's and K7's limits (csrc/branch_vg_chains.cu)
extern "C" long long dense_chains_smem(int m, int k0, int s, int depth);

namespace cg = cooperative_groups;

namespace {

using namespace rsbann;
using namespace rsbann::vg;

constexpr int kMaxCC = 2;   // chains (groups of 4 warps) per CTA
constexpr int kLayers = 5;  // W0, b0, W1, b1, w_out (W1 and b1 unused at depth 0)

// A [G, C, rows, cols] f32 tensor (a bias [G, C, cols] is one row, w_out
// [G, C, s, 1] one column): element (g, c, r, k) at p + g * sg + c * sc +
// r * sr + k * sk. Only the step sizes and prior factors are read through
// sr and sk; the other tensors' trailing dims are contiguous (element (g, c,
// i) at at(v, g, c) + i).
struct Inst {
    const float* p;
    long long sg, sc, sr, sk;
};

__device__ __forceinline__ const float* at(const Inst& v, int g, int c) {
    return v.p + g * v.sg + c * v.sc;
}

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

// Floats of shared memory of one group (one chain): the weight fragments,
// the planes, the accumulators, b0, b1, w_out and the warps' small sums.
__host__ __device__ inline long long group_floats(int km, bool deep, int m16, int m8) {
    const long long k16 = km16(km), mt = k16 / 16, plane = k16 * kS;
    long long f = (m8 / 8) * mt * 256;
    if (deep) f += 2 * (km / 8) * mt * 256 + plane;
    f += plane * (deep ? 2 : 1) + (m16 + (deep ? k16 : 0)) * acc_stride(km);
    return f + 3 * k16 + kWarps * 3 * k16;
}

long long smem_floats(int km, bool deep, int cc, int m16, int m8, int nbuf) {
    return static_cast<long long>(nbuf) * m16 * kS + cc * group_floats(km, deep, m16, m8);
}

// The 4 warps of group grp (named barrier grp + 1; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int grp) {
    asm volatile("bar.sync %0, %1;" ::"r"(grp + 1), "r"(kThreads) : "memory");
}

// The X tile tl of branch xb into ``xs``, by every thread of the CTA: rows
// past m and individuals past n are zero.
__device__ void load_x(const TrajArgs& a, int xb, int tl, float* xs) {
    const float* xg = a.x + static_cast<size_t>(xb) * a.m * a.n;
    const int i0 = tl * kT;
    if (a.vec16) {
        for (int idx = threadIdx.x; idx < a.m16 * (kT / 4); idx += blockDim.x) {
            const int row = idx >> 3, c4 = idx & 7, i = i0 + 4 * c4;
            const bool ok = row < a.m && i < a.n;
            cp_async16(xs + swz(row, 4 * c4), ok ? xg + static_cast<size_t>(row) * a.n + i : xg,
                       ok ? 16 : 0);
        }
    } else {
        for (int idx = threadIdx.x; idx < a.m16 * kT; idx += blockDim.x) {
            const int row = idx >> 5, c = idx & 31, i = i0 + c;
            const bool ok = row < a.m && i < a.n;
            cp_async4(xs + swz(row, c), ok ? xg + static_cast<size_t>(row) * a.n + i : xg,
                      ok ? 4 : 0);
        }
    }
    cp_async_commit();
}

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
    constexpr int K16 = km16(KM), MT = K16 / 16, NT = KM / 8, AS = acc_stride(KM);
    constexpr int PL = K16 * kS;  // floats per plane
    extern __shared__ float4 smem4[];
    cg::grid_group grid = cg::this_grid();
    const int grp = threadIdx.x / kThreads;  // this warp group's chain of the chunk
    const int tid = threadIdx.x - grp * kThreads, lane = tid & 31, w = tid >> 5, g = lane >> 2,
              t = lane & 3;
    float* xs = reinterpret_cast<float*>(smem4);  // [nbuf][m16][kS], shared by the groups
    float* w0f = xs + a.nbuf * a.m16 * kS +
                 grp * static_cast<int>(group_floats(KM, DEEP, a.m16, a.m8));  // Z0's A fragments
    float* w1a = w0f + (a.m8 / 8) * MT * 256;               // Z1's (depth 1)
    float* w1b = w1a + (DEEP ? NT * MT * 256 : 0);          // dA0's (depth 1)
    float* a0t = w1b + (DEEP ? NT * MT * 256 : 0);          // [K16][kS] (depth 1)
    float* dz1t = a0t + (DEEP ? PL : 0);                    // (depth 1)
    float* dz0t = dz1t + (DEEP ? PL : 0);
    float* acc0 = dz0t + PL;                                // dW0 [m16][AS]
    float* acc1 = acc0 + a.m16 * AS;                        // dW1 [K16][AS] (depth 1)
    float* b0s = acc1 + (DEEP ? K16 * AS : 0);              // [K16]
    float* b1s = b0s + K16;
    float* wos = b1s + K16;
    float* red = wos + K16;                                 // [kWarps][3][K16]

    const int m = a.m, n = a.n, k0 = a.k0, s = a.s, P = a.P;
    const long long items = static_cast<long long>(a.NB) * a.tiles;
    const long long it_begin = blockIdx.x * items / a.ctas;
    const long long it_end = (blockIdx.x + 1) * items / a.ctas;
    const int off_b0 = m * k0, off_w1 = off_b0 + k0, off_b1 = off_w1 + k0 * s;
    const int off_wo = DEEP ? off_b1 + s : off_w1;

    // the thread's sums over its individuals: db0, db1, dw_out per (tile mt,
    // row half h) of units 16 mt + g + 8 h
    float db0[MT][2], db1[MT][2], dwo[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) db0[mt][0] = db0[mt][1] = db1[mt][0] = db1[mt][1] = dwo[mt][0] = dwo[mt][1] = 0.f;

    // the group's gradient sums of instance j into its segment row; the
    // thread's sums restart at zero, the shared ones with the next first tile
    auto flush = [&](int j) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int o = 1; o < 4; o <<= 1) {
                    db0[mt][h] += __shfl_xor_sync(0xffffffffu, db0[mt][h], o);
                    db1[mt][h] += __shfl_xor_sync(0xffffffffu, db1[mt][h], o);
                    dwo[mt][h] += __shfl_xor_sync(0xffffffffu, dwo[mt][h], o);
                }
        if (t == 0) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int u = 16 * mt + g + 8 * h;
                    red[(w * 3 + 0) * K16 + u] = db0[mt][h];
                    red[(w * 3 + 1) * K16 + u] = db1[mt][h];
                    red[(w * 3 + 2) * K16 + u] = dwo[mt][h];
                }
        }
        group_sync(grp);
        auto warps = [&](int which, int u) {
            return ((red[which * K16 + u] + red[(3 + which) * K16 + u]) + red[(6 + which) * K16 + u]) +
                   red[(9 + which) * K16 + u];
        };
        // the row: dW0 and dW1 a row of units per warp, the sums over units
        float* part = a.partial + (static_cast<size_t>(blockIdx.x + j) * CC + grp) * P;
        if (lane < k0) {
            for (int mm = w; mm < m; mm += kWarps) part[mm * k0 + lane] = acc0[mm * AS + lane];
        }
        if (DEEP && lane < s) {
            for (int kk = w; kk < k0; kk += kWarps) part[off_w1 + kk * s + lane] = acc1[kk * AS + lane];
        }
        if (tid < k0) part[off_b0 + tid] = warps(0, tid);
        if (DEEP && tid < s) part[off_b1 + tid] = warps(1, tid);
        if (tid < s) part[off_wo + tid] = warps(2, tid);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) db0[mt][0] = db0[mt][1] = db1[mt][0] = db1[mt][1] = dwo[mt][0] = dwo[mt][1] = 0.f;
        group_sync(grp);
    };

    // the first item of the CTA's run, the same in every evaluation
    const int j0 = static_cast<int>(it_begin / a.tiles), tl0 = static_cast<int>(it_begin % a.tiles);
    int buf = 0;
    load_x(a, j0 / a.chunks, tl0, xs);
    // the weight fragments' padding (rows past m, k0 or s, columns past k0
    // or s) is zero for every chain; staging writes the rest
    {
        float4* f4 = reinterpret_cast<float4*>(w0f);
        const int n4 = ((a.m8 / 8) * MT + (DEEP ? 2 * NT * MT : 0)) * 64;
        for (int i = tid; i < n4; i += kThreads) f4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        __syncthreads();
    }

    // evaluation 0 only gives the initial gradient; 1..L integrate
    for (int l = 0; l <= a.steps; ++l) {
        int jj = j0, tl = tl0, j = -1, gb = 0, c = 0;
        bool live = false;  // this group's chain exists (a ragged last chunk has fewer)
        for (long long it = it_begin; it < it_end; ++it) {
            const int i0 = tl * kT;
            const bool first = jj != j;  // the segment's first tile
            if (first) {
                if (live) flush(j);
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
                        at(pick(st, a.w[4], a.qo[4]), gb, c), m, k0, s, tid, w0f, w1a, w1b, b0s);
                }
            }
            if (++tl == a.tiles) tl = 0, ++jj;
            const bool next = it + 1 < it_end;
            cp_async_wait<0>();  // this tile's copies (the only ones in flight)
            // the two individuals of this thread's column pair and their targets
            const int col = 8 * w + 2 * t;
            const int i_a = i0 + col, i_b = i_a + 1;
            float tg_a = 0.f, tg_b = 0.f;
            if (live) {
                const float* tg = at(a.target, gb, c);
                if (i_a < n) tg_a = __ldg(tg + i_a);
                if (i_b < n) tg_b = __ldg(tg + i_b);
            }
            // the X tile and the staged weights are visible, and every group is
            // done with the last tile: its buffer, planes and accumulators
            __syncthreads();
            if (next && a.nbuf == 2) load_x(a, jj / a.chunks, tl, xs + (buf ^ 1) * a.m16 * kS);
            const float* xt = xs + buf * a.m16 * kS;

            if (live) {
                // ---- phase A: the warp's 8 individuals through the whole MLP
                float z0[MT][4], a0[MT][4];
                product_a<MT, true>(w0f, xt, a.m8 / 8, 8 * w + g, z0);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        z0[mt][e] += b0s[16 * mt + g + 8 * (e >> 1)];
                        a0[mt][e] = act_apply(ACT, z0[mt][e]);
                    }
                float z1[MT][4], a1[MT][4];
                if (DEEP) {
                    store_plane<MT>(a0t, col, a0);
                    __syncwarp();
                    product_a<MT, true>(w1a, a0t, NT, 8 * w + g, z1);
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            z1[mt][e] += b1s[16 * mt + g + 8 * (e >> 1)];
                            a1[mt][e] = act_apply(ACT, z1[mt][e]);
                        }
                }
                float p_a = 0.f, p_b = 0.f;
                if constexpr (DEEP) {
                    pred_terms<MT>(a1, wos, p_a, p_b);
                } else {
                    pred_terms<MT>(a0, wos, p_a, p_b);
                }
                // over the units of the other lanes with this t: every lane gets the same bits
#pragma unroll
                for (int o = 4; o < 32; o <<= 1) {
                    p_a += __shfl_xor_sync(0xffffffffu, p_a, o);
                    p_b += __shfl_xor_sync(0xffffffffu, p_b, o);
                }
                const float err[2] = {i_a < n ? p_a - tg_a : 0.f, i_b < n ? p_b - tg_b : 0.f};
                float dz0[MT][4];
                if (DEEP) {
                    float dz1[MT][4];
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int h = e >> 1;
                            const float er = err[e & 1];
                            dz1[mt][e] = wos[16 * mt + g + 8 * h] * er * act_prime(ACT, z1[mt][e], a1[mt][e]);
                            dwo[mt][h] = fmaf(a1[mt][e], er, dwo[mt][h]);
                            db1[mt][h] += dz1[mt][e];
                        }
                    store_plane<MT>(dz1t, col, dz1);
                    __syncwarp();
                    float da[MT][4];
                    product_a<MT, true>(w1b, dz1t, NT, 8 * w + g, da);
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                        for (int e = 0; e < 4; ++e) dz0[mt][e] = da[mt][e] * act_prime(ACT, z0[mt][e], a0[mt][e]);
                } else {
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int h = e >> 1;
                            const float er = err[e & 1];
                            dz0[mt][e] = wos[16 * mt + g + 8 * h] * er * act_prime(ACT, z0[mt][e], a0[mt][e]);
                            dwo[mt][h] = fmaf(a0[mt][e], er, dwo[mt][h]);
                        }
                }
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) db0[mt][e >> 1] += dz0[mt][e];
                store_plane<MT>(dz0t, col, dz0);
                group_sync(grp);  // every warp's planes of this chain are written

                // ---- phase B: dW0 = X dz0 and dW1 = a0^T dz1 over the tile, in
                // units of a row tile and NTU column tiles that share its A
                constexpr int NTU = NT >= 2 ? 2 : 1, NU = NT / NTU;
                const int u0 = (a.m16 / 16) * NU, u1 = DEEP ? MT * NU : 0;
                for (int u = w; u < u0 + u1; u += kWarps) {
                    float acc[NTU][4];
                    if (u < u0) {
                        const int mt = u / NU, nt = (u - mt * NU) * NTU;
                        product_b<NTU, true>(xt, 16 * mt, dz0t, 8 * nt, acc);
                        add_tiles<NTU>(acc0, AS, 16 * mt, 8 * nt, first, acc);
                    } else {
                        const int kt = (u - u0) / NU, nt = (u - u0 - kt * NU) * NTU;
                        product_b<NTU, true>(a0t, 16 * kt, dz1t, 8 * nt, acc);
                        add_tiles<NTU>(acc1, AS, 16 * kt, 8 * nt, first, acc);
                    }
                }
            }
            if (a.nbuf == 1) {
                __syncthreads();  // the one X buffer is free again
                if (next) load_x(a, jj / a.chunks, tl, xs);
            } else {
                buf ^= 1;
            }
        }
        if (live) flush(j);
        // X never changes: the next evaluation's first tile comes in across
        // the grid syncs, into the buffer every group was done with before
        // the last tile
        if (l < a.steps) load_x(a, j0 / a.chunks, tl0, xs + buf * a.m16 * kS);
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
    if (G <= 0 || C <= 0 || n <= 0 || act < 0 || act > 4 || dense_chains_smem(m, k0, s, depth) < 0)
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
        const long long s1 = 4 * smem_floats(pl->km, deep, cc, pl->m16, pl->m8, 1);
        const long long s2 = 4 * smem_floats(pl->km, deep, cc, pl->m16, pl->m8, 2);
        if (s1 > kMaxSmem) continue;
        const int slot = (((pl->km == 8 ? 0 : pl->km == 16 ? 1 : 2) * 2 + (deep ? 1 : 0)) * 5 + act) *
                             kMaxCC + cc - 1;
        Occupancy& occ = g_occ[slot];
        if (occ.dev != dev || occ.smem1 != s1 || occ.smem2 != s2) {
            const void* fn = kernel_for(pl->km, deep, act, cc);
            const bool two = s2 <= kMaxSmem;
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

}  // namespace

// What a K6 launch uses on this shape and activation on the current device:
// out[0..8] = CTAs, resident CTAs per SM, chains per CTA (CC), chunks of
// chains, tiles of 32 individuals per branch, shared bytes per CTA, X tile
// buffers, scratch bytes (the partial rows), register width KM.
extern "C" int traj_dense_plan(int G, int C, int m, int n, int k0, int s, int depth, int act,
                               long long* out) {
    Plan pl;
    const int status = plan(G, C, m, n, k0, s, depth, act, &pl);
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
