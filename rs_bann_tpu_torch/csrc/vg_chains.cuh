// K7's kernel: the chain-folded dense value (and gradient) of the branch
// MLP's data term on the tensor-core device code of csrc/dense_vg_mma.cuh.
// csrc/branch_vg_chains.cu instantiates the value-and-gradient kernels and
// holds the entry points, csrc/branch_fwd_chains.cu the forward-only ones:
// the two compile in parallel.
//
// An instance is (branch g, chunk of CC chains). A CTA is CC groups of 4
// warps, group i running chain i of the chunk, all on the X tile of 32
// individuals the CTA stages by cp.async (two buffers where shared memory
// allows): each tile is read once for the chunk's chains, and the groups'
// independent MMAs interleave on each SM sub-partition. The G x chunks x
// ceil(n / 32) items are split evenly over one wave of CTAs (R CTAs per
// instance where the wave holds one per instance, each a contiguous run of
// one branch's tiles; else the wave's CTAs take several instances in turn).
// Weights, biases and targets are read where they lie, at their strides
// over branches and chains.
//
// The value-and-gradient kernel writes y_pred, one partial row of the
// gradients and one err^2 (f64) per (segment, chain), and a second launch
// adds each chain's segments in a fixed order into its gradients and rss:
// no float atomics, so the same inputs give the same bits. The forward-only
// kernel writes y_pred alone, in one launch.
//
// Every other shape (depth 2 or more, or a padded width of 33-64) runs the
// deep design, csrc/dense_deep.cuh ``run_kernel``: one chain a CTA of 8
// warps over tiles of 64 individuals, the same partial rows and reduce.
//
// X stored in bf16 (--x-bf16) runs the XB instantiations, the X tile staged
// in bf16 (dense_vg_mma.cuh): csrc/branch_vg_chains_xbf16.cu and
// csrc/branch_fwd_chains_xbf16.cu hold them, so the four sources compile in
// parallel.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "dense_deep.cuh"
#include "dense_vg_mma.cuh"

namespace rsbann {
namespace vg {

constexpr int kMaxCC = 2;  // chains (groups of 4 warps) per CTA

struct ChainArgs {
    const void* x;       // [G, m, n], f32 or (XB) bf16
    Inst target;         // [G, C, n] (gradient)
    Inst w[kLayers];     // W0 [m, k0], b0 [k0], W1 [k0, s], b1 [s], w_out [s, 1] of (g, c)
    float* y_pred;       // [G, C, n]
    float* grads;        // [G, C, P] (gradient)
    float* rss;          // [G, C] (gradient)
    float* partial;      // [(ctas + NB) * CC, P]: segment (CTA b, instance j), chain i in row (b + j) CC + i
    double* e2;          // [(ctas + NB) * CC]: each row's err^2
    int G, C, m, n, k0, s, P;
    int cc, chunks, NB, tiles;
    int m16, m8, nbuf, vec16;
};

template <int KM, bool DEEP, bool GRAD, int ACT, int CC, bool XB>
__global__ void __launch_bounds__(kThreads * CC, GRAD ? (CC == 1 ? 3 : 1) : (CC == 1 ? 4 : 2))
    vg_chains_kernel(const __grid_constant__ ChainArgs a) {
    constexpr int MT = km16(KM) / 16, K16 = km16(KM);
    using XT = XElem<XB>;
    extern __shared__ float4 smem4[];
    const int grp = threadIdx.x / kThreads;  // this warp group's chain of the chunk
    const int tid = threadIdx.x - grp * kThreads, w = tid >> 5, t = tid & 3;
    // [nbuf][m16][kS] (bf16: [kSB]), shared by the groups
    XT* xs = reinterpret_cast<XT*>(smem4);
    const int xtile = a.m16 * (XB ? kSB : kS);  // elements of one X buffer
    const XT* x = static_cast<const XT*>(a.x);
    const Group<KM, DEEP, GRAD> gs(
        reinterpret_cast<float*>(smem4) + a.nbuf * x_tile_floats(a.m16, XB) +
            grp * static_cast<int>(group_floats(KM, DEEP, GRAD, true, a.m16, a.m8)),
        a.m16, a.m8);
    const int m = a.m, n = a.n;
    const long long items = static_cast<long long>(a.NB) * a.tiles;
    const long long it_begin = blockIdx.x * items / gridDim.x;
    const long long it_end = (blockIdx.x + 1) * items / gridDim.x;
    Sums<MT> sm;
    sm.zero();

    int jj = static_cast<int>(it_begin / a.tiles), tl = static_cast<int>(it_begin % a.tiles);
    int j = -1, gb = 0, c = 0, buf = 0;
    bool live = false;  // this group's chain exists (a ragged last chunk has fewer)
    float* y = nullptr;
    load_x(x + static_cast<size_t>(jj / a.chunks) * m * n, m, n, a.m16, a.vec16, tl, xs);
    zero_frags<KM, DEEP, GRAD>(gs, a.m8, tid);
    __syncthreads();
    for (long long it = it_begin; it < it_end; ++it) {
        const int i0 = tl * kT;
        const bool first = jj != j;  // the segment's first tile
        if (first) {
            if (live) {  // the last segment's sums out; every warp is done with its weights
                if constexpr (GRAD) {
                    const size_t row = (static_cast<size_t>(blockIdx.x) + j) * CC + grp;
                    flush<KM, DEEP, true>(gs, sm, a.partial + row * a.P, a.e2 + row, m, a.k0,
                                          a.s, grp);
                } else {
                    group_sync(grp);
                }
            }
            j = jj;
            gb = j / a.chunks;
            c = (j - gb * a.chunks) * CC + grp;
            live = c < a.C;
            if (live) {
                stage_weights_from<MT, K16, DEEP, GRAD>(
                    at(a.w[0], gb, c), at(a.w[1], gb, c), DEEP ? at(a.w[2], gb, c) : nullptr,
                    DEEP ? at(a.w[3], gb, c) : nullptr, at(a.w[4], gb, c), m, a.k0, a.s, tid,
                    gs.w0f, gs.w1a, gs.w1b, gs.b0s);
                y = a.y_pred + (static_cast<size_t>(gb) * a.C + c) * n;
            }
        }
        if (++tl == a.tiles) tl = 0, ++jj;
        const bool next = it + 1 < it_end;
        cp_async_wait<0>();  // this tile's copies (the only ones in flight)
        // the targets of this thread's two individuals
        float tg_a = 0.f, tg_b = 0.f;
        if (GRAD && live) {
            const float* tg = at(a.target, gb, c);
            const int i_a = i0 + 8 * w + 2 * t;
            if (i_a < n) tg_a = __ldg(tg + i_a);
            if (i_a + 1 < n) tg_b = __ldg(tg + i_a + 1);
        }
        // the X tile and the staged weights are visible, and every group is
        // done with the last tile: its buffer, planes and accumulators
        __syncthreads();
        if (next && a.nbuf == 2)
            load_x(x + static_cast<size_t>(jj / a.chunks) * m * n, m, n, a.m16, a.vec16, tl,
                   xs + (buf ^ 1) * xtile);
        const XT* xt = xs + buf * xtile;
        if (live)
            tile<KM, DEEP, GRAD, ACT, true, XB>(gs, sm, xt, a.m8, a.m16, n, i0, tg_a, tg_b, first,
                                                grp, y);
        if (a.nbuf == 1) {
            __syncthreads();  // the one X buffer is free again
            if (next) load_x(x + static_cast<size_t>(jj / a.chunks) * m * n, m, n, a.m16,
                             a.vec16, tl, xs);
        } else {
            buf ^= 1;
        }
    }
    if constexpr (GRAD) {
        if (!live) return;
        const size_t row = (static_cast<size_t>(blockIdx.x) + j) * CC + grp;
        flush<KM, DEEP, true>(gs, sm, a.partial + row * a.P, a.e2 + row, m, a.k0, a.s, grp);
    }
}

template <int KM, bool DEEP, bool GRAD, int CC, bool XB>
const void* kernel_act(int act) {
    switch (act) {
        case 1: return reinterpret_cast<const void*>(&vg_chains_kernel<KM, DEEP, GRAD, 1, CC, XB>);
        case 2: return reinterpret_cast<const void*>(&vg_chains_kernel<KM, DEEP, GRAD, 2, CC, XB>);
        case 3: return reinterpret_cast<const void*>(&vg_chains_kernel<KM, DEEP, GRAD, 3, CC, XB>);
        case 4: return reinterpret_cast<const void*>(&vg_chains_kernel<KM, DEEP, GRAD, 4, CC, XB>);
        default: return reinterpret_cast<const void*>(&vg_chains_kernel<KM, DEEP, GRAD, 0, CC, XB>);
    }
}

template <int KM, bool GRAD, bool XB>
const void* kernel_km(bool deep, int act, int cc) {
    if (deep)
        return cc == 2 ? kernel_act<KM, true, GRAD, 2, XB>(act) : kernel_act<KM, true, GRAD, 1, XB>(act);
    return cc == 2 ? kernel_act<KM, false, GRAD, 2, XB>(act) : kernel_act<KM, false, GRAD, 1, XB>(act);
}

// The instantiation for the shape: the activation is a template parameter,
// so each one holds one activation's code (60 per translation unit).
template <bool GRAD, bool XB>
const void* chains_kernel(int km, bool deep, int act, int cc) {
    if (km == 8) return kernel_km<8, GRAD, XB>(deep, act, cc);
    if (km == 16) return kernel_km<16, GRAD, XB>(deep, act, cc);
    return kernel_km<32, GRAD, XB>(deep, act, cc);
}

// csrc/branch_fwd_chains.cu's (grad false) and csrc/branch_vg_chains.cu's,
// and their bf16-X twins in the *_xbf16.cu sources
const void* vg_chains_fwd_kernel(int km, bool deep, int act, int cc);
const void* vg_chains_grad_kernel(int km, bool deep, int act, int cc);
const void* vg_chains_fwd_kernel_xbf16(int km, bool deep, int act, int cc);
const void* vg_chains_grad_kernel_xbf16(int km, bool deep, int act, int cc);

inline const void* vg_chains_kernel_for(int km, bool deep, bool grad, int act, int cc, bool xb) {
    if (xb)
        return grad ? vg_chains_grad_kernel_xbf16(km, deep, act, cc)
                    : vg_chains_fwd_kernel_xbf16(km, deep, act, cc);
    return grad ? vg_chains_grad_kernel(km, deep, act, cc) : vg_chains_fwd_kernel(km, deep, act, cc);
}

}  // namespace vg
}  // namespace rsbann
