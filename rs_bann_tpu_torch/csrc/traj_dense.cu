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
//  * X stored in bf16 (--x-bf16): the entries' x_bf16 argument runs the
//    same designs on a bf16 X tile (half the bytes per evaluation; the
//    products as the f32 kernel's on the upcast values). The kernels live in csrc/traj_dense.cuh; this source
//    instantiates the f32 ones, csrc/traj_dense_xbf16.cu the bf16 ones.
#include <cuda_runtime.h>

#include <cstdint>

#include "traj_dense.cuh"

namespace {

using namespace rsbann;
using namespace rsbann::vg;
using namespace rsbann::traj;

struct Plan {
    int km, cc, chunks, NB, tiles, m16, m8, nbuf, per_sm, ctas, rper;
    long long smem, scratch;  // bytes
};

// The shared memory attribute and the occupancy of each instantiation, kept
// per device and shared size.
struct Occupancy {
    int dev = -1, sms = 0, per_sm = 0, nbuf = 0;
    long long smem1 = -1, smem2 = -1;  // shared bytes with one and two X buffers
};
Occupancy g_occ[2 * 3 * 2 * 5 * kMaxCC];

// The largest CC of (2, 1) that is at most C and fits, its X buffers and
// resident CTAs per SM, and the work split; xb: X in bf16.
int plan(int G, int C, int m, int n, int k0, int s, int depth, int act, bool xb, Plan* pl) {
    if (G <= 0 || C <= 0 || n <= 0 || act < 0 || act > 4 ||
        cta_smem(m, k0, s, depth, true, false, 1, 1, xb) < 0)
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
        const long long s1 = cta_smem(m, k0, s, depth, true, false, cc, 1, xb);
        const long long s2 = cta_smem(m, k0, s, depth, true, false, cc, 2, xb);
        if (s1 < 0) continue;
        const int slot = ((((xb ? 3 : 0) + (pl->km == 8 ? 0 : pl->km == 16 ? 1 : 2)) * 2 +
                           (deep ? 1 : 0)) * 5 + act) * kMaxCC + cc - 1;
        Occupancy& occ = g_occ[slot];
        if (occ.dev != dev || occ.smem1 != s1 || occ.smem2 != s2) {
            const void* fn = kernel_x(pl->km, deep, act, cc, xb);
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

ddeep::Occupancy g_occ_deep[2][4];  // [X bf16][width class]

// The deep design's cooperative grid for G x C instances, in K6's plan
// fields (CC 1, chunks C, R 0: the even split).
int plan_deep(int G, int C, int m, int n, int k0, int s, int depth, int act, bool xb, Plan* pl,
              ddeep::Plan* dp) {
    if (G <= 0 || C <= 0 || act < 0 || act > 4) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e = ddeep::plan(xb ? deep_kernel_xbf16 : deep_kernel_f32, g_occ_deep[xb ? 1 : 0],
                                      G * C, m, n, k0, s, depth, xb, dp);
    if (e != cudaSuccess) return static_cast<int>(e);
    pl->km = dp->km, pl->cc = 1, pl->chunks = C, pl->NB = G * C, pl->tiles = dp->tiles;
    pl->m16 = (m + 15) & ~15, pl->m8 = (m + 7) & ~7, pl->nbuf = dp->nbuf;
    pl->per_sm = dp->per_sm, pl->ctas = dp->ctas, pl->rper = 0, pl->smem = dp->smem;
    pl->scratch = dp->slots * deep::flat_size(m, k0, s, depth) * 4;
    return 0;
}

int vec16_of(const void* x, int n, bool xb) {
    return (n % (xb ? 8 : 4) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) ? 1 : 0;
}

// Shared memory (bytes) K6 needs at these widths with one chain per CTA and
// one X buffer, or -1 if it cannot run them (a padded width above 64, or
// more than 227 KB): at depth 0 and 1 and widths up to 32 the first
// design's, at every other shape the deep design's (csrc/dense_deep.cuh);
// xb: X stored in bf16.
long long smem_rule(int m, int k0, int s, int depth, bool xb) {
    if (ddeep::takes(k0, s, depth)) return ddeep::smem(m, k0, s, depth, 1, xb);
    return cta_smem(m, k0, s, depth, true, false, 1, 1, xb);
}

int plan_entry(int G, int C, int m, int n, int k0, int s, int depth, int act, bool xb,
               long long* out) {
    Plan pl;
    ddeep::Plan dp;
    const int status = ddeep::takes(k0, s, depth)
                           ? plan_deep(G, C, m, n, k0, s, depth, act, xb, &pl, &dp)
                           : plan(G, C, m, n, k0, s, depth, act, xb, &pl);
    if (status != 0) return status;
    const long long v[9] = {pl.ctas, pl.per_sm, pl.cc, pl.chunks, pl.tiles, pl.smem, pl.nbuf,
                            pl.scratch, pl.km};
    for (int i = 0; i < 9; ++i) out[i] = v[i];
    return 0;
}

int run_entry(const void* x, const void* const* ptrs, const long long* strides, void* scratch,
              long long scratch_bytes, int G, int C, int m, int n, int k0, int s, int depth,
              int steps, int act, int l1, bool xb, void* stream) {
    Plan pl;
    int status = plan(G, C, m, n, k0, s, depth, act, xb, &pl);
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
    a.x = x;
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
    a.vec16 = vec16_of(x, n, xb);
    const int sizes[kLayers] = {m * k0, k0, deep ? k0 * s : 0, deep ? s : 0, s};
    const int cols[kLayers] = {k0, k0, s, s, 1};
    for (int ly = 0, off = 0; ly < kLayers; off += sizes[ly], ++ly) {
        a.lsize[ly] = sizes[ly];
        a.loff[ly] = off;
        a.lcols[ly] = cols[ly];
    }
    void* params[] = {&a};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        kernel_x(pl.km, deep, act, pl.cc, xb), dim3(pl.ctas), dim3(kThreads * pl.cc), params,
        pl.smem, static_cast<cudaStream_t>(stream));
    return static_cast<int>(e);
}

int deep_entry(const void* x, const void* const* ptrs, const long long* strides, void* w,
               void* pw, const void* eps, const void* lam, void* scratch, long long scratch_bytes,
               int G, int C, int m, int n, int k0, int s, int depth, int steps, int act, int l1,
               bool xb, void* stream) {
    if (!ddeep::takes(k0, s, depth)) return static_cast<int>(cudaErrorInvalidValue);
    Plan pl;
    ddeep::Plan dp;
    const int status = plan_deep(G, C, m, n, k0, s, depth, act, xb, &pl, &dp);
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
    a.x = x;
    a.target = inst(0);
    a.err = inst(1);
    a.w = static_cast<float*>(w);
    a.pw = static_cast<float*>(pw);
    a.eps = static_cast<const float*>(eps);
    a.lam = static_cast<const float*>(lam);
    a.partial = static_cast<float*>(scratch);
    a.sh = ddeep::make_shape(m, k0, s, depth, n, act);
    a.C = C, a.NB = G * C, a.steps = steps, a.l1 = l1, a.nbuf = dp.nbuf;
    a.vec16 = vec16_of(x, n, xb);
    void* params[] = {&a};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        (xb ? deep_kernel_xbf16 : deep_kernel_f32)(dp.km), dim3(dp.ctas), dim3(ddeep::kThreads),
        params, dp.smem, static_cast<cudaStream_t>(stream)));
}

}  // namespace

namespace rsbann {
namespace traj {

const void* kernel_f32(int km, bool deep, int act, int cc) {
    return kernel_for<false>(km, deep, act, cc);
}

const void* deep_kernel_f32(int km) { return deep_kernel_for<false>(km); }

}  // namespace traj
}  // namespace rsbann

// K6's shared-memory rule (smem_rule) on f32 X, or with x_bf16 on X stored
// in bf16. The CLI asks its mirror before a folded feature-major run on the
// card.
extern "C" long long traj_dense_smem(int m, int k0, int s, int depth, int x_bf16) {
    return smem_rule(m, k0, s, depth, x_bf16 != 0);
}

// What a K6 launch uses on this shape and activation on the current device,
// on f32 X or (x_bf16) on X stored in bf16: out[0..8] = CTAs, resident CTAs
// per SM, chains per CTA (CC), chunks of chains, tiles per branch (of 32
// individuals; 64 in the deep design), shared bytes per CTA, X tile
// buffers, scratch bytes (the partial rows), register width KM (the deep
// design's width class 8-64).
extern "C" int traj_dense_plan(int G, int C, int m, int n, int k0, int s, int depth, int act,
                               int x_bf16, long long* out) {
    return plan_entry(G, C, m, n, k0, s, depth, act, x_bf16 != 0, out);
}

// x [G, m, n] contiguous, f32, or bf16 with x_bf16 (its plan taken with
// x_bf16 too). ptrs[32] and strides[128] (four per pointer, in floats: over
// branches, chains, rows and columns, as Inst) describe [G, C, ...] f32
// tensors: ptrs[0] targets [G, C, n], ptrs[1] err [G, C], then for each of
// the start w, the start momenta pw, the step sizes, the prior precision
// factors and the outputs (the end's positions, then its momenta) five
// layers W0 [m, k0], b0 [k0], W1 [k0, s], b1 [s], w_out [s, 1] (W1 and b1
// null at depth 0). The step sizes and prior factors may have any strides
// (a broadcast one, stride 0, is read in place); the other tensors'
// trailing dims must be contiguous. The outputs must not overlap the
// inputs. scratch: the plan's bytes.
extern "C" int traj_dense_f32(const void* x, const void* const* ptrs, const long long* strides,
                              void* scratch, long long scratch_bytes, int G, int C, int m, int n,
                              int k0, int s, int depth, int steps, int act, int l1, int x_bf16,
                              void* stream) {
    return run_entry(x, ptrs, strides, scratch, scratch_bytes, G, C, m, n, k0, s, depth, steps,
                     act, l1, x_bf16 != 0, stream);
}

// The deep design's K6 (csrc/dense_deep.cuh), at the shapes traj_dense_f32
// does not take (depth 2 or more, or a padded width of 33-64): x [G, m, n]
// contiguous, f32 or (x_bf16) bf16; ptrs[2] and strides[8] (four per
// pointer, as traj_dense_f32's) the targets [G, C, n] and err [G, C]; w,
// pw, eps, lam f32 [G, C, P] contiguous in the flat layout W0, b0, (W_l,
// b_l)..., w_out: w and pw the start on entry and the end of the
// trajectory on return; scratch: the plan's bytes. One cooperative launch.
extern "C" int traj_dense_deep_f32(const void* x, const void* const* ptrs, const long long* strides,
                                   void* w, void* pw, const void* eps, const void* lam,
                                   void* scratch, long long scratch_bytes, int G, int C, int m,
                                   int n, int k0, int s, int depth, int steps, int act, int l1,
                                   int x_bf16, void* stream) {
    return deep_entry(x, ptrs, strides, w, pw, eps, lam, scratch, scratch_bytes, G, C, m, n, k0, s,
                      depth, steps, act, l1, x_bf16 != 0, stream);
}
