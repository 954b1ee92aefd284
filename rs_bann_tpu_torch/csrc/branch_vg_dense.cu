// K8a and K8b: the dense per-step value-and-gradient of the branch MLP's
// data term, one instance per (branch, chain), each reading its own X.
//
// Replaces rs_bann_tpu/ops/branch_mlp.py::_kernel (K8a: pallas_call in
// _data_vg_impl, one branch) and ::_blocked_kernel through ::_mlp_chunk
// (K8b: pallas_call in _data_vg_blocked, the branches of a vmap), both
// reached through data_vg. For NB instances j, on xT[ix[j]] of
// feature-major X [G, m, n] (on xT[j] when ix is null):
//
//     y_pred[j, i] = f(x_i; W[j])                                    (i < n)
//     rss[j]       = sum_i (y_pred[j, i] - t[j, i])^2
//     grads[j]     = d(rss_j / 2) / d(W0, b0, (W1, b1), w_out)[j]
//
// at depth 0 or 1, widths up to 32, every activation. NB = 1 is K8a (the
// sequential schedule's leapfrog step); NB = every (chain, branch) of a
// hybrid block is K8b, with ix pointing each chain's instances at its own
// block's branches, so no X is copied per step. The TPU kernel's
// block-diagonal packing of branches into one MXU tile is a TPU matter:
// here each instance's tiles are work items of their own.
//
// What bounds it on the H100: per instance and individual 2 m k0 + 2 k0 s +
// s (forward) and 2 m k0 + 4 k0 s + s (backward) FMAs; at the dense flagship
// (m = 64, k0 = s = 32, depth 1, n = 4,096) 5.9e7 FLOP per instance. The
// five products run on tf32 tensor cores in 3xTF32 (csrc/dense_vg_mma.cuh),
// three MMAs per f32 one: 0.36 us per instance at 494.7 TFLOP/s, against
// the 1 MB X branch (0.31 us at 3.35 TB/s). What the design does:
//  * One wave of CTAs of 4 warps over the NB x ceil(n / 32) items, split
//    evenly (128 CTAs for one instance at n = 4,096); each CTA keeps its
//    instance's gradient sums in shared memory over its run and writes one
//    partial row per instance it touched. X tiles come by cp.async, double
//    buffered where that costs no resident CTA (not at the flagship: 3 CTAs
//    of 74 KB fit an SM with one buffer, 2 with two).
//  * The weights are read through their own pointers and staged once per
//    instance and CTA as tf32 hi/lo fragments; err, rss and the partial rows
//    come out of the same launch.
//  * A second launch sums the segments in a fixed order, rss over them in
//    f64. (Summing them in the pass, by the last CTA of each instance found
//    with an integer ticket, took longer at NB = 1, 32 and 64: one CTA
//    reads all of an instance's rows; PERF.md section 6.) No float atomics,
//    so the same inputs give the same bits on every run.
//  * A forward-only instantiation (grad = 0) runs the same forward and
//    writes y_pred alone (the unfolded hybrid block's snapshot predictions).
// Measured times: PERF.md section 6.
#include <cuda_runtime.h>

#include <cstdint>

#include "dense_vg_mma.cuh"

// K6's and K7's limits, which K8 shares (csrc/branch_vg_chains.cu)
extern "C" long long dense_chains_smem(int m, int k0, int s, int depth);

namespace {

using namespace rsbann;
using namespace rsbann::vg;

// Floats of shared memory of one CTA (the carve in vg_dense_kernel).
long long smem_floats(int km, bool deep, bool grad, int m16, int m8, int nbuf) {
    const long long k16 = km16(km), mt = k16 / 16, plane = k16 * kS;
    long long f = static_cast<long long>(nbuf) * m16 * kS + (m8 / 8) * mt * 256;
    if (deep) f += (km / 8) * mt * 256 * (grad ? 2 : 1) + plane;
    if (grad) f += plane * (deep ? 2 : 1) + (m16 + (deep ? k16 : 0)) * acc_stride(km);
    f += 3 * k16 + kWarps * 3 * k16 + 2 * kWarps;  // b0, b1, w_out; red; e2red
    return f;
}

// The X tile tl of instance j into ``xs``: rows past m and individuals past
// n are zero.
__device__ void load_x(const Args& a, int j, int tl, float* xs) {
    const float* xg =
        a.x + static_cast<size_t>(a.xix != nullptr ? a.xix[j] : j) * a.m * a.n;
    const int i0 = tl * kT;
    if (a.vec16) {
        for (int idx = threadIdx.x; idx < a.m16 * (kT / 4); idx += kThreads) {
            const int row = idx >> 3, c4 = idx & 7, i = i0 + 4 * c4;
            const bool ok = row < a.m && i < a.n;
            cp_async16(xs + swz(row, 4 * c4), ok ? xg + static_cast<size_t>(row) * a.n + i : xg,
                       ok ? 16 : 0);
        }
    } else {
        for (int idx = threadIdx.x; idx < a.m16 * kT; idx += kThreads) {
            const int row = idx >> 5, c = idx & 31, i = i0 + c;
            const bool ok = row < a.m && i < a.n;
            cp_async4(xs + swz(row, c), ok ? xg + static_cast<size_t>(row) * a.n + i : xg,
                      ok ? 4 : 0);
        }
    }
    cp_async_commit();
}

// 3 CTAs (12 warps) per SM where shared memory allows: at the flagship's
// width the registers fit 168 a thread and one X buffer 74 KB a CTA
template <int KM, bool DEEP, bool GRAD, int ACT>
__global__ void __launch_bounds__(kThreads, 3) vg_dense_kernel(const Args a) {
    constexpr int K16 = km16(KM), MT = K16 / 16, NT = KM / 8, AS = acc_stride(KM);
    constexpr int PL = K16 * kS;  // floats per plane
    extern __shared__ float4 smem4[];
    float* xs = reinterpret_cast<float*>(smem4);            // [nbuf][m16][kS]
    float* w0f = xs + a.nbuf * a.m16 * kS;                   // Z0's A fragments
    float* w1a = w0f + (a.m8 / 8) * MT * 256;                // Z1's (depth 1)
    float* w1b = w1a + (DEEP ? NT * MT * 256 : 0);           // dA0's (depth 1, grad)
    float* a0t = w1b + (DEEP && GRAD ? NT * MT * 256 : 0);   // [K16][kS] (depth 1)
    float* dz1t = a0t + (DEEP ? PL : 0);                     // (depth 1, grad)
    float* dz0t = dz1t + (DEEP && GRAD ? PL : 0);            // (grad)
    float* acc0 = dz0t + (GRAD ? PL : 0);                    // dW0 [m16][AS] (grad)
    float* acc1 = acc0 + (GRAD ? a.m16 * AS : 0);            // dW1 [K16][AS] (depth 1, grad)
    float* b0s = acc1 + (GRAD && DEEP ? K16 * AS : 0);       // [K16]
    float* b1s = b0s + K16;
    float* wos = b1s + K16;
    float* red = wos + K16;                                  // [kWarps][3][K16]
    double* e2red = reinterpret_cast<double*>(red + kWarps * 3 * K16);  // [kWarps]

    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, g = lane >> 2, t = lane & 3;
    const int m = a.m, n = a.n, k0 = a.k0, s = a.s, P = a.P;
    const long long items = static_cast<long long>(a.NB) * a.tiles;
    const long long it_begin = blockIdx.x * items / gridDim.x;
    const long long it_end = (blockIdx.x + 1) * items / gridDim.x;
    const int off_b0 = m * k0, off_w1 = off_b0 + k0, off_b1 = off_w1 + k0 * s;
    const int off_wo = DEEP ? off_b1 + s : off_w1;

    // the thread's sums over its individuals: db0, db1, dw_out per (tile mt,
    // row half h) of units 16 mt + g + 8 h, and err^2
    float db0[MT][2], db1[MT][2], dwo[MT][2];
    double e2 = 0.0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) db0[mt][0] = db0[mt][1] = db1[mt][0] = db1[mt][1] = dwo[mt][0] = dwo[mt][1] = 0.f;

    // the CTA's gradient sums of instance j into its segment row; the
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
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) e2 += __shfl_xor_sync(0xffffffffu, e2, o);
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
        if (lane == 0) e2red[w] = e2;
        __syncthreads();
        auto warps = [&](int which, int u) {
            return ((red[which * K16 + u] + red[(3 + which) * K16 + u]) + red[(6 + which) * K16 + u]) +
                   red[(9 + which) * K16 + u];
        };
        // the row: dW0 and dW1 a row of units per warp, the sums over units
        float* part = a.partial + static_cast<size_t>(blockIdx.x + j) * P;
        if (lane < k0) {
            for (int mm = w; mm < m; mm += kWarps) part[mm * k0 + lane] = acc0[mm * AS + lane];
        }
        if (DEEP && lane < s) {
            for (int kk = w; kk < k0; kk += kWarps) part[off_w1 + kk * s + lane] = acc1[kk * AS + lane];
        }
        if (tid < k0) part[off_b0 + tid] = warps(0, tid);
        if (DEEP && tid < s) part[off_b1 + tid] = warps(1, tid);
        if (tid < s) part[off_wo + tid] = warps(2, tid);
        if (tid == 0) a.e2[blockIdx.x + j] = ((e2red[0] + e2red[1]) + e2red[2]) + e2red[3];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) db0[mt][0] = db0[mt][1] = db1[mt][0] = db1[mt][1] = dwo[mt][0] = dwo[mt][1] = 0.f;
        e2 = 0.0;
        __syncthreads();
    };

    // this item's instance and tile, and the next item's
    int jj = static_cast<int>(it_begin / a.tiles), tl = static_cast<int>(it_begin % a.tiles);
    int j = -1, buf = 0;
    load_x(a, jj, tl, xs);
    // the weight fragments' padding (rows past m, k0 or s, columns past k0
    // or s) is zero for every instance; staging writes the rest
    {
        float4* f4 = reinterpret_cast<float4*>(w0f);
        const int n4 = ((a.m8 / 8) * MT + (DEEP ? (GRAD ? 2 : 1) * NT * MT : 0)) * 64;
        for (int i = tid; i < n4; i += kThreads) f4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        __syncthreads();
    }
    for (long long it = it_begin; it < it_end; ++it) {
        const int i0 = tl * kT;
        const bool first = jj != j;  // the segment's first tile
        if (first) {
            if (GRAD && j >= 0) flush(j);
            j = jj;
            stage_weights<MT, K16, DEEP, GRAD>(a, j, w0f, w1a, w1b, b0s);
        }
        if (++tl == a.tiles) tl = 0, ++jj;
        const bool next = it + 1 < it_end;
        if (next && a.nbuf == 2) {
            load_x(a, jj, tl, xs + (buf ^ 1) * a.m16 * kS);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        // the two individuals of this thread's column pair and their targets
        const int col = 8 * w + 2 * t;
        const int i_a = i0 + col, i_b = i_a + 1;
        float tg_a = 0.f, tg_b = 0.f;
        if (GRAD) {
            if (i_a < n) tg_a = __ldg(a.target + static_cast<size_t>(j) * n + i_a);
            if (i_b < n) tg_b = __ldg(a.target + static_cast<size_t>(j) * n + i_b);
        }
        __syncthreads();  // the X tile and the staged weights are visible
        const float* xt = xs + buf * a.m16 * kS;

        // ---- phase A: the warp's 8 individuals through the whole MLP
        float z0[MT][4], a0[MT][4];
        product_a<MT>(w0f, xt, a.m8 / 8, 8 * w + g, z0);
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
            product_a<MT>(w1a, a0t, NT, 8 * w + g, z1);
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
        if (g == 0) {
            if (i_a < n) a.y_pred[static_cast<size_t>(j) * n + i_a] = p_a;
            if (i_b < n) a.y_pred[static_cast<size_t>(j) * n + i_b] = p_b;
        }
        if (GRAD) {
            const float err[2] = {i_a < n ? p_a - tg_a : 0.f, i_b < n ? p_b - tg_b : 0.f};
            if (g == 0) {
                e2 = fma(static_cast<double>(err[0]), static_cast<double>(err[0]), e2);
                e2 = fma(static_cast<double>(err[1]), static_cast<double>(err[1]), e2);
            }
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
                product_a<MT>(w1b, dz1t, NT, 8 * w + g, da);
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
            __syncthreads();  // every warp's planes are written

            // ---- phase B: dW0 = X dz0 and dW1 = a0^T dz1 over the tile, in
            // units of a row tile and NTU column tiles that share its A
            constexpr int NTU = NT >= 2 ? 2 : 1, NU = NT / NTU;
            const int u0 = (a.m16 / 16) * NU, u1 = DEEP ? MT * NU : 0;
            for (int u = w; u < u0 + u1; u += kWarps) {
                float acc[NTU][4];
                if (u < u0) {
                    const int mt = u / NU, nt = (u - mt * NU) * NTU;
                    product_b<NTU>(xt, 16 * mt, dz0t, 8 * nt, acc);
                    add_tiles<NTU>(acc0, AS, 16 * mt, 8 * nt, first, acc);
                } else {
                    const int kt = (u - u0) / NU, nt = (u - u0 - kt * NU) * NTU;
                    product_b<NTU>(a0t, 16 * kt, dz1t, 8 * nt, acc);
                    add_tiles<NTU>(acc1, AS, 16 * kt, 8 * nt, first, acc);
                }
            }
        }
        __syncthreads();  // the tile, the planes and the accumulators are free again
        if (next && a.nbuf == 1) load_x(a, jj, tl, xs);
        if (a.nbuf == 2) buf ^= 1;
    }
    if (GRAD && j >= 0) flush(j);
}

// grads[j] and rss[j] from instance j's segments (grid.y = j), CTAs first ..
// first + nseg - 1 of the pass (segment (c, j) in row c + j), 32 columns x
// kSlices row slices per block: slice sl adds segments sl, sl + kSlices, ...
// from zero, then the slices are added in order; column P is rss, in f64.
__global__ void __launch_bounds__(32 * kSlices) vg_dense_reduce(const Args a, int ctas) {
    __shared__ float s_f[kSlices][32];
    __shared__ double s_d[kSlices];
    const int j = blockIdx.y, c = threadIdx.x & 31, sl = threadIdx.x >> 5;
    const int p = blockIdx.x * 32 + c;
    int first, nseg;
    {
        const long long items = static_cast<long long>(a.NB) * a.tiles;
        first = cta_of(static_cast<long long>(j) * a.tiles, ctas, items);
        nseg = cta_of(static_cast<long long>(j + 1) * a.tiles - 1, ctas, items) - first + 1;
    }
    float sum = 0.f;
    double d = 0.0;
    if (p < a.P) {
        const float* part = a.partial + static_cast<size_t>(first + j) * a.P + p;
#pragma unroll 4
        for (int q = sl; q < nseg; q += kSlices) sum += __ldcg(part + static_cast<size_t>(q) * a.P);
    } else if (p == a.P) {
        for (int q = sl; q < nseg; q += kSlices) d += __ldcg(a.e2 + first + j + q);
        s_d[sl] = d;
    }
    s_f[sl][c] = sum;
    __syncthreads();
    if (sl == 0) {
        if (p < a.P) {
            float tot = s_f[0][c];
#pragma unroll
            for (int k = 1; k < kSlices; ++k) tot += s_f[k][c];
            a.grads[static_cast<size_t>(j) * a.P + p] = tot;
        } else if (p == a.P) {
            double tot = s_d[0];
#pragma unroll
            for (int k = 1; k < kSlices; ++k) tot += s_d[k];
            a.rss[j] = static_cast<float>(tot);
        }
    }
}

struct Plan {
    int km, tiles, m16, m8, nbuf, per_sm, ctas, slots;
    long long smem, scratch;  // bytes
};

template <int KM, bool DEEP, bool GRAD>
const void* kernel_act(int act) {
    switch (act) {
        case 1: return reinterpret_cast<const void*>(&vg_dense_kernel<KM, DEEP, GRAD, 1>);
        case 2: return reinterpret_cast<const void*>(&vg_dense_kernel<KM, DEEP, GRAD, 2>);
        case 3: return reinterpret_cast<const void*>(&vg_dense_kernel<KM, DEEP, GRAD, 3>);
        case 4: return reinterpret_cast<const void*>(&vg_dense_kernel<KM, DEEP, GRAD, 4>);
        default: return reinterpret_cast<const void*>(&vg_dense_kernel<KM, DEEP, GRAD, 0>);
    }
}

template <int KM>
const void* kernel_km(bool deep, bool grad, int act) {
    if (deep) return grad ? kernel_act<KM, true, true>(act) : kernel_act<KM, true, false>(act);
    return grad ? kernel_act<KM, false, true>(act) : kernel_act<KM, false, false>(act);
}

// The instantiation for the shape: the activation is a template parameter,
// so each one holds one activation's code.
const void* kernel_for(int km, bool deep, bool grad, int act) {
    if (km == 8) return kernel_km<8>(deep, grad, act);
    if (km == 16) return kernel_km<16>(deep, grad, act);
    return kernel_km<32>(deep, grad, act);
}

// The shared memory attribute and the occupancy of each instantiation, kept
// per device and shared size: a call on the sequential path pays no query.
struct Occupancy {
    int dev = -1, sms = 0, per_sm = 0, nbuf = 0;
    long long smem1 = -1, smem2 = -1;  // shared bytes with one and two X buffers
};
Occupancy g_occ[60];

int plan(int NB, int m, int n, int k0, int s, int depth, int grad, int act, Plan* pl) {
    if (NB <= 0 || n <= 0 || act < 0 || act > 4 || dense_chains_smem(m, k0, s, depth) < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const bool deep = depth == 1;
    pl->km = pick_km(k0, s);
    pl->tiles = (n + kT - 1) / kT;
    pl->m16 = (m + 15) & ~15;
    pl->m8 = (m + 7) & ~7;
    // two X buffers (the next tile's copy under this one's work) unless they
    // cost a resident CTA per SM or do not fit
    const long long s1 = 4 * smem_floats(pl->km, deep, grad, pl->m16, pl->m8, 1);
    const long long s2 = 4 * smem_floats(pl->km, deep, grad, pl->m16, pl->m8, 2);
    if (s1 > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int slot =
        ((pl->km == 8 ? 0 : pl->km == 16 ? 1 : 2) * 4 + (deep ? 2 : 0) + (grad ? 1 : 0)) * 5 + act;
    Occupancy& occ = g_occ[slot];
    if (occ.dev != dev || occ.smem1 != s1 || occ.smem2 != s2) {
        const void* fn = kernel_for(pl->km, deep, grad, act);
        const bool two = s2 <= kMaxSmem;
        int p1 = 0, p2 = 0;
        if ((e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      static_cast<int>(two ? s2 : s1))) != cudaSuccess ||
            (e = cudaDeviceGetAttribute(&occ.sms, cudaDevAttrMultiProcessorCount, dev)) !=
                cudaSuccess ||
            (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p1, fn, kThreads, s1)) !=
                cudaSuccess ||
            (two && (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p2, fn, kThreads, s2)) !=
                        cudaSuccess)) {
            occ.dev = -1;
            return static_cast<int>(e);
        }
        occ.nbuf = two && p2 >= p1 ? 2 : 1;
        occ.per_sm = occ.nbuf == 2 ? p2 : p1;
        occ.dev = dev;
        occ.smem1 = s1;
        occ.smem2 = s2;
    }
    pl->nbuf = occ.nbuf;
    pl->smem = occ.nbuf == 2 ? s2 : s1;
    pl->per_sm = occ.per_sm;
    if (pl->per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const long long items = static_cast<long long>(NB) * pl->tiles;
    const long long wave = static_cast<long long>(pl->per_sm) * occ.sms;
    pl->ctas = static_cast<int>(wave < items ? wave : items);
    pl->slots = pl->ctas + NB;
    const int P = partial_size(m, k0, s, deep);
    // partial rows (f32), then each segment's err^2 (f64)
    const long long part = (static_cast<long long>(pl->slots) * P * 4 + 7) & ~7LL;
    pl->scratch = grad ? part + 8LL * pl->slots : 0;
    return 0;
}

}  // namespace

// What a K8 launch uses on this shape and activation, on the current
// device: out[0..7] =
// CTAs, tiles of 32 individuals per instance, shared bytes per CTA,
// resident CTAs per SM, X tile buffers, partial-row slots, scratch bytes
// (zero for the forward-only pass), register width KM.
extern "C" int vg_dense_plan(int NB, int m, int n, int k0, int s, int depth, int grad, int act,
                             long long* out) {
    Plan pl;
    const int status = plan(NB, m, n, k0, s, depth, grad, act, &pl);
    if (status != 0) return status;
    const long long v[8] = {pl.ctas, pl.tiles, pl.smem, pl.per_sm, pl.nbuf, pl.slots,
                            pl.scratch, pl.km};
    for (int i = 0; i < 8; ++i) out[i] = v[i];
    return 0;
}

// x f32 [G, m, n]; ix int32 [NB] branch indices into x, or null (instance j
// reads branch j); target f32 [NB, n] (grad only); w0 [NB, m, k0], b0 [NB,
// k0], w1 [NB, k0, s] and b1 [NB, s] (depth 1), wout [NB, s] (s = k0 at
// depth 0), all f32 and contiguous; out f32: y_pred [NB, n], then with grad
// grads [NB, P] (P = partial_size) and rss [NB]; scratch of the plan's bytes
// (8-byte aligned). With grad, two launches: the pass and the fixed-order
// reduce. The caller keeps ix inside [0, G).
extern "C" int vg_dense_f32(const void* x, const void* ix, const void* target, const void* w0,
                            const void* b0, const void* w1, const void* b1, const void* wout,
                            void* out, void* scratch, long long scratch_bytes, int NB, int m,
                            int n, int k0, int s, int depth, int act, int grad, void* stream) {
    Plan pl;
    int status = plan(NB, m, n, k0, s, depth, grad, act, &pl);
    if (status != 0) return status;
    if (grad && (scratch_bytes < pl.scratch || reinterpret_cast<uintptr_t>(scratch) & 7))
        return static_cast<int>(cudaErrorInvalidValue);
    const bool deep = depth == 1;
    const int P = partial_size(m, k0, s, deep);
    float* o = static_cast<float*>(out);
    char* sc = static_cast<char*>(scratch);
    const long long part_bytes = (static_cast<long long>(pl.slots) * P * 4 + 7) & ~7LL;
    Args a{static_cast<const float*>(x),
           static_cast<const int*>(ix),
           static_cast<const float*>(target),
           static_cast<const float*>(w0),
           static_cast<const float*>(b0),
           static_cast<const float*>(w1),
           static_cast<const float*>(b1),
           static_cast<const float*>(wout),
           o,
           grad ? o + static_cast<size_t>(NB) * n : nullptr,
           grad ? o + static_cast<size_t>(NB) * (n + P) : nullptr,
           grad ? reinterpret_cast<float*>(sc) : nullptr,
           grad ? reinterpret_cast<double*>(sc + part_bytes) : nullptr,
           NB, m, n, k0, s, P, pl.tiles, pl.m16, pl.m8, pl.nbuf,
           (n % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) ? 1 : 0};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    void* params[] = {&a};
    cudaError_t e = cudaLaunchKernel(kernel_for(pl.km, deep, grad, act), dim3(pl.ctas), dim3(kThreads),
                                     params, pl.smem, st);
    if (e != cudaSuccess || !grad) return static_cast<int>(e);
    vg_dense_reduce<<<dim3((P + 1 + 31) / 32, NB), 32 * kSlices, 0, st>>>(a, pl.ctas);
    return static_cast<int>(cudaGetLastError());
}
