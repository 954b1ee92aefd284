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
// at any depth and padded widths up to 64, every activation. NB = 1 is K8a (the
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
//    instance and CTA as tf32 hi/lo fragments (cvt.rna), every other
//    operand split as it is loaded by integer operations on its bits
//    (split2_int, as K6 and K7); err, rss and the partial rows come out of
//    the same launch. The CTA is one group of the device code K6 and K7 run
//    (its tile, flush and segment sum).
//  * A second launch sums the segments in a fixed order, rss over them in
//    f64. (Summing them in the pass, by the last CTA of each instance found
//    with an integer ticket, took longer at NB = 1, 32 and 64: one CTA
//    reads all of an instance's rows; PERF.md section 6.) No float atomics,
//    so the same inputs give the same bits on every run.
//  * A forward-only instantiation (grad = 0) runs the same forward and
//    writes y_pred alone (the unfolded hybrid block's snapshot predictions).
//  * Depth 2 or more, or a padded width of 33-64: the deep design
//    (csrc/dense_deep.cuh), entry vg_dense_deep_f32, whose run over the
//    instances is K7's (its instantiations live in csrc/branch_vg_chains.cu
//    and csrc/branch_fwd_chains.cu), with this source's reduce.
//  * X stored in bf16 (--x-bf16): the entries' x_bf16 argument runs the
//    same designs on a bf16 X tile (half the bytes; the products as the
//    f32 kernel's on the upcast values).
// Measured times: PERF.md section 6.
#include <cuda_runtime.h>

#include <cstdint>

#include "dense_deep.cuh"
#include "dense_vg_mma.cuh"

namespace {

using namespace rsbann;
using namespace rsbann::vg;

struct Args {
    const void* x;        // [G, m, n], f32 or (XB) bf16
    const int* xix;       // [NB]: instance j reads X branch xix[j]; null: branch j
    const float* target;  // [NB, n]
    const float* w0;      // [NB, m, k0]
    const float* b0;      // [NB, k0]
    const float* w1;      // [NB, k0, s] (depth 1)
    const float* b1;      // [NB, s]
    const float* wout;    // [NB, s] (s = k0 at depth 0)
    float* y_pred;        // [NB, n]
    float* grads;         // [NB, P]: W0, b0, (W1, b1), w_out
    float* rss;           // [NB]
    float* partial;       // [ctas + NB, P]: segment (c, j) in row c + j
    double* e2;           // [ctas + NB]: each segment's err^2
    int NB, m, n, k0, s, P;
    int tiles;  // tiles of kT individuals per instance
    int m16, m8, nbuf, vec16;
};

// 3 CTAs (12 warps) per SM where shared memory allows: at the flagship's
// width the registers fit 168 a thread and one X buffer 74 KB a CTA. The CTA
// is one group of csrc/dense_vg_mma.cuh.
template <int KM, bool DEEP, bool GRAD, int ACT, bool XB>
__global__ void __launch_bounds__(kThreads, 3) vg_dense_kernel(const Args a) {
    constexpr int K16 = km16(KM), MT = K16 / 16;
    using XT = XElem<XB>;
    extern __shared__ float4 smem4[];
    XT* xs = reinterpret_cast<XT*>(smem4);  // [nbuf][m16][kS] (bf16: [kSB])
    const int xtile = a.m16 * (XB ? kSB : kS);  // elements of one X buffer
    const Group<KM, DEEP, GRAD> gs(reinterpret_cast<float*>(smem4) + a.nbuf * x_tile_floats(a.m16, XB),
                                   a.m16, a.m8);
    const int tid = threadIdx.x, w = tid >> 5, t = tid & 3;
    const int m = a.m, n = a.n, k0 = a.k0, s = a.s, P = a.P;
    const long long items = static_cast<long long>(a.NB) * a.tiles;
    const long long it_begin = blockIdx.x * items / gridDim.x;
    const long long it_end = (blockIdx.x + 1) * items / gridDim.x;
    // the X tile tl of instance j into dst: rows past m and individuals past n are zero
    auto x_tile = [&](int j, int tl, XT* dst) {
        load_x(static_cast<const XT*>(a.x) + static_cast<size_t>(a.xix != nullptr ? a.xix[j] : j) * m * n,
               m, n, a.m16, a.vec16, tl, dst);
    };
    Sums<MT> sm;
    sm.zero();

    // this item's instance and tile, and the next item's
    int jj = static_cast<int>(it_begin / a.tiles), tl = static_cast<int>(it_begin % a.tiles);
    int j = -1, buf = 0;
    x_tile(jj, tl, xs);
    zero_frags<KM, DEEP, GRAD>(gs, a.m8, tid);
    __syncthreads();
    for (long long it = it_begin; it < it_end; ++it) {
        const int i0 = tl * kT;
        const bool first = jj != j;  // the segment's first tile
        if (first) {
            if constexpr (GRAD) {
                if (j >= 0)
                    flush<KM, DEEP, true>(gs, sm, a.partial + static_cast<size_t>(blockIdx.x + j) * P,
                                          a.e2 + blockIdx.x + j, m, k0, s, 0);
            }
            j = jj;
            stage_weights_from<MT, K16, DEEP, GRAD>(
                a.w0 + static_cast<size_t>(j) * m * k0, a.b0 + static_cast<size_t>(j) * k0,
                DEEP ? a.w1 + static_cast<size_t>(j) * k0 * s : nullptr,
                DEEP ? a.b1 + static_cast<size_t>(j) * s : nullptr, a.wout + static_cast<size_t>(j) * s,
                m, k0, s, tid, gs.w0f, gs.w1a, gs.w1b, gs.b0s);
        }
        if (++tl == a.tiles) tl = 0, ++jj;
        const bool next = it + 1 < it_end;
        if (next && a.nbuf == 2) {
            x_tile(jj, tl, xs + (buf ^ 1) * xtile);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        // the targets of this thread's two individuals
        float tg_a = 0.f, tg_b = 0.f;
        if (GRAD) {
            const int i_a = i0 + 8 * w + 2 * t;
            if (i_a < n) tg_a = __ldg(a.target + static_cast<size_t>(j) * n + i_a);
            if (i_a + 1 < n) tg_b = __ldg(a.target + static_cast<size_t>(j) * n + i_a + 1);
        }
        __syncthreads();  // the X tile and the staged weights are visible
        tile<KM, DEEP, GRAD, ACT, true, XB>(gs, sm, xs + buf * xtile, a.m8, a.m16, n, i0, tg_a,
                                            tg_b, first, 0, a.y_pred + static_cast<size_t>(j) * n);
        __syncthreads();  // the tile, the planes and the accumulators are free again
        if (next && a.nbuf == 1) x_tile(jj, tl, xs);
        if (a.nbuf == 2) buf ^= 1;
    }
    if constexpr (GRAD) {
        if (j >= 0)
            flush<KM, DEEP, true>(gs, sm, a.partial + static_cast<size_t>(blockIdx.x + j) * P,
                                  a.e2 + blockIdx.x + j, m, k0, s, 0);
    }
}

// grads[j] and rss[j] from instance j's segments (grid.y = j), CTAs first ..
// first + nseg - 1 of the pass (segment (c, j) in row c + j).
__global__ void __launch_bounds__(32 * kSlices) vg_dense_reduce(const Args a, int ctas) {
    const int j = blockIdx.y;
    const long long items = static_cast<long long>(a.NB) * a.tiles;
    const int first = cta_of(static_cast<long long>(j) * a.tiles, ctas, items);
    const int nseg = cta_of(static_cast<long long>(j + 1) * a.tiles - 1, ctas, items) - first + 1;
    reduce_rows(a.partial, a.e2, a.P, static_cast<long long>(first) + j, 1, nseg,
                a.grads + static_cast<size_t>(j) * a.P, a.rss + j);
}

struct Plan {
    int km, tiles, m16, m8, nbuf, per_sm, ctas, slots;
    long long smem, scratch;  // bytes
};

template <int KM, bool DEEP, bool GRAD, bool XB>
const void* kernel_act(int act) {
    switch (act) {
        case 1: return reinterpret_cast<const void*>(&vg_dense_kernel<KM, DEEP, GRAD, 1, XB>);
        case 2: return reinterpret_cast<const void*>(&vg_dense_kernel<KM, DEEP, GRAD, 2, XB>);
        case 3: return reinterpret_cast<const void*>(&vg_dense_kernel<KM, DEEP, GRAD, 3, XB>);
        case 4: return reinterpret_cast<const void*>(&vg_dense_kernel<KM, DEEP, GRAD, 4, XB>);
        default: return reinterpret_cast<const void*>(&vg_dense_kernel<KM, DEEP, GRAD, 0, XB>);
    }
}

template <int KM, bool XB>
const void* kernel_km(bool deep, bool grad, int act) {
    if (deep) return grad ? kernel_act<KM, true, true, XB>(act) : kernel_act<KM, true, false, XB>(act);
    return grad ? kernel_act<KM, false, true, XB>(act) : kernel_act<KM, false, false, XB>(act);
}

template <bool XB>
const void* kernel_xb(int km, bool deep, bool grad, int act) {
    if (km == 8) return kernel_km<8, XB>(deep, grad, act);
    if (km == 16) return kernel_km<16, XB>(deep, grad, act);
    return kernel_km<32, XB>(deep, grad, act);
}

// The instantiation for the shape and X's storage: the activation is a
// template parameter, so each one holds one activation's code.
const void* kernel_for(int km, bool deep, bool grad, int act, bool xb) {
    return xb ? kernel_xb<true>(km, deep, grad, act) : kernel_xb<false>(km, deep, grad, act);
}

// The shared memory attribute and the occupancy of each instantiation, kept
// per device and shared size: a call on the sequential path pays no query.
struct Occupancy {
    int dev = -1, sms = 0, per_sm = 0, nbuf = 0;
    long long smem1 = -1, smem2 = -1;  // shared bytes with one and two X buffers
};
Occupancy g_occ[120];

int plan(int NB, int m, int n, int k0, int s, int depth, int grad, int act, bool xb, Plan* pl) {
    if (NB <= 0 || n <= 0 || act < 0 || act > 4 ||
        cta_smem(m, k0, s, depth, true, true, 1, 1, xb) < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const bool deep = depth == 1;
    pl->km = pick_km(k0, s);
    pl->tiles = (n + kT - 1) / kT;
    pl->m16 = (m + 15) & ~15;
    pl->m8 = (m + 7) & ~7;
    // two X buffers (the next tile's copy under this one's work) unless they
    // cost a resident CTA per SM or do not fit
    const long long s1 = cta_smem(m, k0, s, depth, grad, true, 1, 1, xb);
    const long long s2 = cta_smem(m, k0, s, depth, grad, true, 1, 2, xb);
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int slot = (((xb ? 3 : 0) + (pl->km == 8 ? 0 : pl->km == 16 ? 1 : 2)) * 4 + (deep ? 2 : 0) +
                      (grad ? 1 : 0)) * 5 + act;
    Occupancy& occ = g_occ[slot];
    if (occ.dev != dev || occ.smem1 != s1 || occ.smem2 != s2) {
        const void* fn = kernel_for(pl->km, deep, grad, act, xb);
        const bool two = s2 > 0;
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

ddeep::Occupancy g_occ_deep[2][2][4];  // [X bf16][grad][width class]

// The deep design's launch (csrc/dense_deep.cuh) for NB instances, in K8's
// plan fields.
int plan_deep(int NB, int m, int n, int k0, int s, int depth, int grad, int act, bool xb,
              Plan* pl, ddeep::Plan* dp) {
    if (act < 0 || act > 4) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e = ddeep::plan(ddeep::run_kernel_getter(grad, xb),
                                      g_occ_deep[xb ? 1 : 0][grad ? 1 : 0], NB, m, n, k0, s, depth,
                                      xb, dp);
    if (e != cudaSuccess) return static_cast<int>(e);
    pl->km = dp->km, pl->tiles = dp->tiles, pl->m16 = (m + 15) & ~15, pl->m8 = (m + 7) & ~7;
    pl->nbuf = dp->nbuf, pl->per_sm = dp->per_sm, pl->ctas = dp->ctas;
    pl->slots = static_cast<int>(dp->slots), pl->smem = dp->smem;
    const long long P = deep::flat_size(m, k0, s, depth);
    pl->scratch = grad ? ((dp->slots * P * 4 + 7) & ~7LL) + 8 * dp->slots : 0;
    return 0;
}


// Shared memory (bytes) K8 needs at these widths with one X buffer (the
// value-and-gradient kernel: the forward-only one needs less), or -1 if it
// cannot run them (a padded width above 64, or more than 227 KB): at depth
// 0 and 1 and widths up to 32 the first design's, at every other shape the
// deep design's (csrc/dense_deep.cuh); xb: X stored in bf16.
long long smem_rule(int m, int k0, int s, int depth, bool xb) {
    if (ddeep::takes(k0, s, depth)) return ddeep::smem(m, k0, s, depth, 1, xb);
    return cta_smem(m, k0, s, depth, true, true, 1, 1, xb);
}

int plan_entry(int NB, int m, int n, int k0, int s, int depth, int grad, int act, bool xb,
               long long* out) {
    Plan pl;
    ddeep::Plan dp;
    const int status = ddeep::takes(k0, s, depth)
                           ? plan_deep(NB, m, n, k0, s, depth, grad, act, xb, &pl, &dp)
                           : plan(NB, m, n, k0, s, depth, grad, act, xb, &pl);
    if (status != 0) return status;
    const long long v[8] = {pl.ctas, pl.tiles, pl.smem, pl.per_sm, pl.nbuf, pl.slots,
                            pl.scratch, pl.km};
    for (int i = 0; i < 8; ++i) out[i] = v[i];
    return 0;
}

int vec16_of(const void* x, int n, bool xb) {
    return (n % (xb ? 8 : 4) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) ? 1 : 0;
}

int run_entry(const void* x, const void* ix, const void* target, const void* w0, const void* b0,
              const void* w1, const void* b1, const void* wout, void* out, void* scratch,
              long long scratch_bytes, int NB, int m, int n, int k0, int s, int depth, int act,
              int grad, bool xb, void* stream) {
    Plan pl;
    int status = plan(NB, m, n, k0, s, depth, grad, act, xb, &pl);
    if (status != 0) return status;
    if (grad && (scratch_bytes < pl.scratch || reinterpret_cast<uintptr_t>(scratch) & 7))
        return static_cast<int>(cudaErrorInvalidValue);
    const bool deep = depth == 1;
    const int P = partial_size(m, k0, s, deep);
    float* o = static_cast<float*>(out);
    char* sc = static_cast<char*>(scratch);
    const long long part_bytes = (static_cast<long long>(pl.slots) * P * 4 + 7) & ~7LL;
    Args a{x,
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
           NB, m, n, k0, s, P, pl.tiles, pl.m16, pl.m8, pl.nbuf, vec16_of(x, n, xb)};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    void* params[] = {&a};
    cudaError_t e = cudaLaunchKernel(kernel_for(pl.km, deep, grad, act, xb), dim3(pl.ctas),
                                     dim3(kThreads), params, pl.smem, st);
    if (e != cudaSuccess || !grad) return static_cast<int>(e);
    vg_dense_reduce<<<dim3((P + 1 + 31) / 32, NB), 32 * kSlices, 0, st>>>(a, pl.ctas);
    return static_cast<int>(cudaGetLastError());
}

int deep_entry(const void* x, const void* ix, const void* target, const void* q, void* out,
               void* scratch, long long scratch_bytes, int NB, int m, int n, int k0, int s,
               int depth, int act, int grad, bool xb, void* stream) {
    if (!ddeep::takes(k0, s, depth)) return static_cast<int>(cudaErrorInvalidValue);
    Plan pl;
    ddeep::Plan dp;
    const int status = plan_deep(NB, m, n, k0, s, depth, grad, act, xb, &pl, &dp);
    if (status != 0) return status;
    if (grad && (scratch_bytes < pl.scratch || reinterpret_cast<uintptr_t>(scratch) & 7))
        return static_cast<int>(cudaErrorInvalidValue);
    const int P = deep::flat_size(m, k0, s, depth);
    float* o = static_cast<float*>(out);
    ddeep::RunArgs r{};
    r.x = x;
    r.xix = static_cast<const int*>(ix);
    r.target = Inst{static_cast<const float*>(target), n, 0, 0, 1};
    r.q = static_cast<const float*>(q);
    r.y_pred = o;
    if (grad) {
        r.partial = static_cast<float*>(scratch);
        r.e2 = reinterpret_cast<double*>(static_cast<char*>(scratch) + ((dp.slots * P * 4 + 7) & ~7LL));
    }
    r.sh = ddeep::make_shape(m, k0, s, depth, n, act);
    r.C = 1, r.NB = NB, r.nbuf = dp.nbuf;
    r.vec16 = vec16_of(x, n, xb);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    void* params[] = {&r};
    cudaError_t e = cudaLaunchKernel(ddeep::run_kernel_getter(grad, xb)(dp.km), dim3(dp.ctas),
                                     dim3(ddeep::kThreads), params, dp.smem, st);
    if (e != cudaSuccess || !grad) return static_cast<int>(e);
    Args a{};
    a.grads = o + static_cast<size_t>(NB) * n;
    a.rss = o + static_cast<size_t>(NB) * (n + P);
    a.partial = r.partial;
    a.e2 = r.e2;
    a.NB = NB, a.m = m, a.n = n, a.k0 = k0, a.s = s, a.P = P, a.tiles = dp.tiles;
    vg_dense_reduce<<<dim3((P + 1 + 31) / 32, NB), 32 * kSlices, 0, st>>>(a, dp.ctas);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K8's shared-memory rule (smem_rule) on f32 X, or with x_bf16 on X stored
// in bf16. The CLI asks its mirror before a sequential or unfolded
// feature-major run on the card.
extern "C" long long vg_dense_smem(int m, int k0, int s, int depth, int x_bf16) {
    return smem_rule(m, k0, s, depth, x_bf16 != 0);
}

// What a K8 launch uses on this shape and activation, on the current
// device, on f32 X or (x_bf16) on X stored in bf16: out[0..7] = CTAs,
// tiles per instance (of 32 individuals; 64 in the deep design), shared
// bytes per CTA, resident CTAs per SM, X tile buffers, partial-row slots,
// scratch bytes (zero for the forward-only pass), register width KM (the
// deep design's width class 8-64).
extern "C" int vg_dense_plan(int NB, int m, int n, int k0, int s, int depth, int grad, int act,
                             int x_bf16, long long* out) {
    return plan_entry(NB, m, n, k0, s, depth, grad, act, x_bf16 != 0, out);
}

// x [G, m, n], f32, or bf16 with x_bf16 (its plan taken with x_bf16 too);
// ix int32 [NB] branch indices into x, or null (instance j reads branch j);
// target f32 [NB, n] (grad only); w0 [NB, m, k0], b0 [NB, k0], w1 [NB, k0,
// s] and b1 [NB, s] (depth 1), wout [NB, s] (s = k0 at depth 0), all f32
// and contiguous; out f32: y_pred [NB, n], then with grad grads [NB, P] (P
// = partial_size) and rss [NB]; scratch of the plan's bytes (8-byte
// aligned). With grad, two launches: the pass and the fixed-order reduce.
// The caller keeps ix inside [0, G).
extern "C" int vg_dense_f32(const void* x, const void* ix, const void* target, const void* w0,
                            const void* b0, const void* w1, const void* b1, const void* wout,
                            void* out, void* scratch, long long scratch_bytes, int NB, int m,
                            int n, int k0, int s, int depth, int act, int grad, int x_bf16,
                            void* stream) {
    return run_entry(x, ix, target, w0, b0, w1, b1, wout, out, scratch, scratch_bytes, NB, m, n,
                     k0, s, depth, act, grad, x_bf16 != 0, stream);
}

// The deep design's K8 (csrc/dense_deep.cuh), at the shapes vg_dense_f32
// does not take (depth 2 or more, or a padded width of 33-64): x, ix,
// target, out, scratch and x_bf16 as vg_dense_f32's; q f32 [NB, P]
// contiguous, each instance's weights in the flat layout W0, b0, (W_l,
// b_l)..., w_out. With grad, two launches: the pass and the fixed-order
// reduce.
extern "C" int vg_dense_deep_f32(const void* x, const void* ix, const void* target, const void* q,
                                 void* out, void* scratch, long long scratch_bytes, int NB, int m,
                                 int n, int k0, int s, int depth, int act, int grad, int x_bf16,
                                 void* stream) {
    return deep_entry(x, ix, target, q, out, scratch, scratch_bytes, NB, m, n, k0, s, depth, act,
                      grad, x_bf16 != 0, stream);
}
