// K7: chain-folded dense value-and-gradient of the branch MLP's data term.
//
// Replaces rs_bann_tpu/ops/branch_mlp.py::_chain_kernel (pallas_call in
// _data_vg_chains_impl, reached through data_vg_chains). For every (branch
// g, chain c) on feature-major X xT [G, m, n]:
//
//     y_pred[g, c, i] = f(x_i; W[g, c])                        (i < n)
//     rss[g, c]       = sum_i (y_pred - t)^2
//     grads[g, c]     = d(rss / 2) / d(W0, b0, (W1, b1), w_out)[g, c]
//
// at any depth and padded widths up to 64, every activation. At depth 0
// and 1 and widths up to 32 the kernel is csrc/vg_chains.cuh on the 3xTF32
// tensor-core device code of csrc/dense_vg_mma.cuh, which K6 and K8 run
// too; at every other shape it is csrc/dense_deep.cuh's run_kernel (entry
// vg_chains_deep_f32: the weights in their flat layout, one chain a CTA).
// This source holds the value-and-gradient instantiations, the fixed-order
// segment sum and the entry points, csrc/branch_fwd_chains.cu the
// forward-only ones (y_pred alone: the folded transition's value passes).
//
// What bounds it on the H100: per (branch, chain, individual) the five
// products are 2 m k0 + 3 k0 s multiply-adds (the forward's two m k0 + k0
// s); at the dense flagship (G = 64, C = 4, m = 64, k0 = s = 32, depth 1,
// n = 4,096) 1.5e10 FLOP (6.4e9 forward), three tf32 tensor-core products
// per f32 one: 0.091 ms at 494.7 TFLOP/s (forward 0.039), against X (67
// MB f32) read once, 0.020 ms at 3.35 TB/s. One partial row per (segment,
// chain): 3.24 MB at the flagship. Measured times: PERF.md section 6.
//
// X stored in bf16 (--x-bf16): the entries' x_bf16 argument runs the same
// designs on a bf16 X tile (half the bytes; the products as the f32
// kernel's on the upcast values), their instantiations in
// csrc/branch_vg_chains_xbf16.cu and csrc/branch_fwd_chains_xbf16.cu.
#include <cuda_runtime.h>

#include <cstdint>

#include "vg_chains.cuh"

namespace rsbann {
namespace vg {

const void* vg_chains_grad_kernel(int km, bool deep, int act, int cc) {
    return chains_kernel<true, false>(km, deep, act, cc);
}

}  // namespace vg

namespace ddeep {

const void* run_grad_kernel(int km) { return run_kernel_for<true, false>(km); }

}  // namespace ddeep
}  // namespace rsbann

namespace {

using namespace rsbann;
using namespace rsbann::vg;

// grads[g, c] and rss[g, c] (grid.y = g C + c) from the chain's segments:
// instance j = (g, chunk of c), chain i = c % cc in rows (first + j + q) cc
// + i for its CTAs first .. first + nseg - 1.
__global__ void __launch_bounds__(32 * kSlices) vg_chains_reduce(const ChainArgs a, int ctas) {
    const int gc = blockIdx.y, g = gc / a.C, c = gc - g * a.C;
    const int j = g * a.chunks + c / a.cc;
    const long long items = static_cast<long long>(a.NB) * a.tiles;
    const int first = cta_of(static_cast<long long>(j) * a.tiles, ctas, items);
    const int nseg = cta_of(static_cast<long long>(j + 1) * a.tiles - 1, ctas, items) - first + 1;
    reduce_rows(a.partial, a.e2, a.P, (static_cast<long long>(first) + j) * a.cc + c % a.cc, a.cc,
                nseg, a.grads + static_cast<size_t>(gc) * a.P, a.rss + gc);
}

struct Plan {
    int km, cc, chunks, NB, tiles, m16, m8, nbuf, per_sm, ctas;
    long long smem, scratch;  // bytes
};

// The shared memory attribute and the occupancy of each instantiation, kept
// per device and shared size.
struct Occupancy {
    int dev = -1, sms = 0, per_sm = 0, nbuf = 0;
    long long smem1 = -1, smem2 = -1;  // shared bytes with one and two X buffers
};
Occupancy g_occ[2 * 3 * 2 * 2 * 5 * kMaxCC];

// The largest CC of (2, 1) that is at most C and fits, its X buffers and
// resident CTAs per SM, and the work split over one wave; xb: X in bf16.
int plan(int G, int C, int m, int n, int k0, int s, int depth, int grad, int act, bool xb,
         Plan* pl) {
    if (G <= 0 || C <= 0 || n <= 0 || act < 0 || act > 4 ||
        cta_smem(m, k0, s, depth, true, true, 1, 1, xb) < 0)
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
        const long long s1 = cta_smem(m, k0, s, depth, grad, true, cc, 1, xb);
        const long long s2 = cta_smem(m, k0, s, depth, grad, true, cc, 2, xb);
        if (s1 < 0) continue;
        const int slot =
            (((((xb ? 1 : 0) * 3 + (pl->km == 8 ? 0 : pl->km == 16 ? 1 : 2)) * 2 + (deep ? 1 : 0)) * 2 +
              (grad ? 1 : 0)) * 5 + act) * kMaxCC + cc - 1;
        Occupancy& occ = g_occ[slot];
        if (occ.dev != dev || occ.smem1 != s1 || occ.smem2 != s2) {
            const void* fn = vg_chains_kernel_for(pl->km, deep, grad, act, cc, xb);
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
            const long long r = wave / pl->NB < pl->tiles ? wave / pl->NB : pl->tiles;
            pl->ctas = static_cast<int>(pl->NB * r);
        } else {  // one wave, several instances per CTA
            pl->ctas = static_cast<int>(wave);
        }
    }
    if (pl->cc == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    const long long rows = (static_cast<long long>(pl->ctas) + pl->NB) * pl->cc;
    // partial rows (f32), then each row's err^2 (f64)
    pl->scratch = grad ? ((rows * partial_size(m, k0, s, deep) * 4 + 7) & ~7LL) + 8 * rows : 0;
    return 0;
}

ddeep::Occupancy g_occ_deep[2][2][4];  // [X bf16][grad][width class]

// The deep design's launch (csrc/dense_deep.cuh) for G x C instances, one
// chain a CTA, in K7's plan fields (CC 1, chunks C).
int plan_deep(int G, int C, int m, int n, int k0, int s, int depth, int grad, int act, bool xb,
              Plan* pl, ddeep::Plan* dp) {
    if (G <= 0 || C <= 0 || act < 0 || act > 4) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e =
        ddeep::plan(ddeep::run_kernel_getter(grad, xb), g_occ_deep[xb ? 1 : 0][grad ? 1 : 0], G * C,
                    m, n, k0, s, depth, xb, dp);
    if (e != cudaSuccess) return static_cast<int>(e);
    pl->km = dp->km, pl->cc = 1, pl->chunks = C, pl->NB = G * C, pl->tiles = dp->tiles;
    pl->m16 = (m + 15) & ~15, pl->m8 = (m + 7) & ~7, pl->nbuf = dp->nbuf;
    pl->per_sm = dp->per_sm, pl->ctas = dp->ctas, pl->smem = dp->smem;
    const long long P = deep::flat_size(m, k0, s, depth);
    pl->scratch = grad ? ((dp->slots * P * 4 + 7) & ~7LL) + 8 * dp->slots : 0;
    return 0;
}

// Shared memory (bytes) K7 needs at these widths with one chain per CTA and
// one X buffer (the value-and-gradient kernel: the forward-only one needs
// less), or -1 if it cannot run them (a padded width above 64, or more than
// 227 KB): at depth 0 and 1 and widths up to 32 the first design's, at
// every other shape the deep design's (csrc/dense_deep.cuh).
long long smem_rule(int m, int k0, int s, int depth, bool xb) {
    if (ddeep::takes(k0, s, depth)) return ddeep::smem(m, k0, s, depth, 1, xb);
    return cta_smem(m, k0, s, depth, true, true, 1, 1, xb);
}

int plan_entry(int G, int C, int m, int n, int k0, int s, int depth, int grad, int act, bool xb,
               long long* out) {
    Plan pl;
    ddeep::Plan dp;
    const int status = ddeep::takes(k0, s, depth)
                           ? plan_deep(G, C, m, n, k0, s, depth, grad, act, xb, &pl, &dp)
                           : plan(G, C, m, n, k0, s, depth, grad, act, xb, &pl);
    if (status != 0) return status;
    const long long v[9] = {pl.ctas, pl.per_sm, pl.cc, pl.chunks, pl.tiles, pl.smem, pl.nbuf,
                            pl.scratch, pl.km};
    for (int i = 0; i < 9; ++i) out[i] = v[i];
    return 0;
}

// vec16: 16-byte copies of X's rows (4 f32 or 8 bf16 values)
int vec16_of(const void* x, int n, bool xb) {
    return (n % (xb ? 8 : 4) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) ? 1 : 0;
}

int run_entry(const void* x, const void* const* ptrs, const long long* strides, void* out,
              void* scratch, long long scratch_bytes, int G, int C, int m, int n, int k0, int s,
              int depth, int act, int grad, bool xb, void* stream) {
    Plan pl;
    int status = plan(G, C, m, n, k0, s, depth, grad, act, xb, &pl);
    if (status != 0) return status;
    if ((grad && (scratch_bytes < pl.scratch || reinterpret_cast<uintptr_t>(scratch) & 7)) ||
        static_cast<long long>(G) * C > 65535)  // the reduce's grid.y
        return static_cast<int>(cudaErrorInvalidValue);
    const bool deep = depth == 1;
    const int P = partial_size(m, k0, s, deep);
    auto inst = [&](int k) {
        return Inst{static_cast<const float*>(ptrs[k]), strides[4 * k], strides[4 * k + 1],
                    strides[4 * k + 2], strides[4 * k + 3]};
    };
    ChainArgs a{};
    a.x = x;
    a.target = inst(0);
    for (int ly = 0; ly < kLayers; ++ly) a.w[ly] = inst(1 + ly);
    const size_t pairs = static_cast<size_t>(G) * C;
    float* o = static_cast<float*>(out);
    a.y_pred = o;
    if (grad) {
        const long long rows = (static_cast<long long>(pl.ctas) + pl.NB) * pl.cc;
        a.grads = o + pairs * n;
        a.rss = a.grads + pairs * P;
        a.partial = static_cast<float*>(scratch);
        a.e2 = reinterpret_cast<double*>(static_cast<char*>(scratch) +
                                         ((rows * P * 4 + 7) & ~7LL));
    }
    a.G = G, a.C = C, a.m = m, a.n = n, a.k0 = k0, a.s = s, a.P = P;
    a.cc = pl.cc, a.chunks = pl.chunks, a.NB = pl.NB, a.tiles = pl.tiles;
    a.m16 = pl.m16, a.m8 = pl.m8, a.nbuf = pl.nbuf;
    a.vec16 = vec16_of(x, n, xb);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    void* params[] = {&a};
    cudaError_t e = cudaLaunchKernel(vg_chains_kernel_for(pl.km, deep, grad, act, pl.cc, xb),
                                     dim3(pl.ctas), dim3(kThreads * pl.cc), params, pl.smem, st);
    if (e != cudaSuccess || !grad) return static_cast<int>(e);
    int ctas = pl.ctas;
    void* rparams[] = {&a, &ctas};
    e = cudaLaunchKernel(reinterpret_cast<const void*>(&vg_chains_reduce),
                         dim3((P + 1 + 31) / 32, static_cast<unsigned>(pairs)), dim3(32 * kSlices),
                         rparams, 0, st);
    return static_cast<int>(e);
}

int deep_entry(const void* x, const void* target, long long tsg, long long tsc, const void* q,
               void* out, void* scratch, long long scratch_bytes, int G, int C, int m, int n,
               int k0, int s, int depth, int act, int grad, bool xb, void* stream) {
    if (!ddeep::takes(k0, s, depth)) return static_cast<int>(cudaErrorInvalidValue);
    Plan pl;
    ddeep::Plan dp;
    const int status = plan_deep(G, C, m, n, k0, s, depth, grad, act, xb, &pl, &dp);
    if (status != 0) return status;
    if ((grad && (scratch_bytes < pl.scratch || reinterpret_cast<uintptr_t>(scratch) & 7)) ||
        static_cast<long long>(G) * C > 65535)  // the reduce's grid.y
        return static_cast<int>(cudaErrorInvalidValue);
    const int P = deep::flat_size(m, k0, s, depth);
    const size_t pairs = static_cast<size_t>(G) * C;
    float* o = static_cast<float*>(out);
    ddeep::RunArgs r{};
    r.x = x;
    r.target = Inst{static_cast<const float*>(target), tsg, tsc, 0, 1};
    r.q = static_cast<const float*>(q);
    r.y_pred = o;
    if (grad) {
        r.partial = static_cast<float*>(scratch);
        r.e2 = reinterpret_cast<double*>(static_cast<char*>(scratch) + ((dp.slots * P * 4 + 7) & ~7LL));
    }
    r.sh = ddeep::make_shape(m, k0, s, depth, n, act);
    r.C = C, r.NB = G * C, r.nbuf = dp.nbuf;
    r.vec16 = vec16_of(x, n, xb);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    void* params[] = {&r};
    cudaError_t e = cudaLaunchKernel(ddeep::run_kernel_getter(grad, xb)(dp.km), dim3(dp.ctas),
                                     dim3(ddeep::kThreads), params, dp.smem, st);
    if (e != cudaSuccess || !grad) return static_cast<int>(e);
    ChainArgs a{};
    a.grads = o + pairs * n;
    a.rss = a.grads + pairs * P;
    a.partial = r.partial;
    a.e2 = r.e2;
    a.G = G, a.C = C, a.m = m, a.n = n, a.k0 = k0, a.s = s, a.P = P;
    a.cc = 1, a.chunks = C, a.NB = G * C, a.tiles = dp.tiles;
    int ctas = dp.ctas;
    void* rparams[] = {&a, &ctas};
    e = cudaLaunchKernel(reinterpret_cast<const void*>(&vg_chains_reduce),
                         dim3((P + 1 + 31) / 32, static_cast<unsigned>(pairs)), dim3(32 * kSlices),
                         rparams, 0, st);
    return static_cast<int>(e);
}

}  // namespace

// K7's shared-memory rule (smem_rule) on f32 X, or with x_bf16 on X stored
// in bf16, whose X tile takes half the bytes.
extern "C" long long vg_chains_smem(int m, int k0, int s, int depth, int x_bf16) {
    return smem_rule(m, k0, s, depth, x_bf16 != 0);
}

// What a K7 launch uses on this shape and activation on the current device,
// on f32 X or (x_bf16) on X stored in bf16: out[0..8] = CTAs, resident CTAs
// per SM, chains per CTA (CC), chunks of chains, tiles per branch (of 32
// individuals; 64 in the deep design), shared bytes per CTA, X tile
// buffers, scratch bytes (partial rows and err^2; zero for the forward-only
// pass), register width KM (the deep design's width class 8-64).
extern "C" int vg_chains_plan(int G, int C, int m, int n, int k0, int s, int depth, int grad,
                              int act, int x_bf16, long long* out) {
    return plan_entry(G, C, m, n, k0, s, depth, grad, act, x_bf16 != 0, out);
}

// x [G, m, n] contiguous, f32, or bf16 with x_bf16 (its plan taken with
// x_bf16 too). ptrs[6] and strides[24] (four per pointer, in floats: over
// branches, chains, rows and columns; only the first two are read)
// describe [G, C, ...] f32 tensors whose trailing dims are contiguous:
// ptrs[0] the targets [G, C, n] (grad only), then W0 [m, k0], b0 [k0], W1
// [k0, s], b1 [s], w_out [s, 1] (W1 and b1 null at depth 0). out f32:
// y_pred [G, C, n], then with grad grads [G, C, P] (P = partial_size) and
// rss [G, C]; scratch of the plan's bytes (8-byte aligned). With grad, two
// launches: the pass and the fixed-order reduce; else the forward-only
// pass alone.
extern "C" int vg_chains_f32(const void* x, const void* const* ptrs, const long long* strides,
                             void* out, void* scratch, long long scratch_bytes, int G, int C,
                             int m, int n, int k0, int s, int depth, int act, int grad, int x_bf16,
                             void* stream) {
    return run_entry(x, ptrs, strides, out, scratch, scratch_bytes, G, C, m, n, k0, s, depth, act,
                     grad, x_bf16 != 0, stream);
}

// The deep design's K7 (csrc/dense_deep.cuh run_kernel), at the shapes
// vg_chains_f32 does not take (depth 2 or more, or a padded width of
// 33-64): x [G, m, n] contiguous, f32 or (x_bf16) bf16; target f32 [G, C,
// n] (grad only), element (g, c, i) at target + g tsg + c tsc + i; q f32
// [G, C, P] contiguous, each instance's weights in the flat layout W0, b0,
// (W_l, b_l)..., w_out; out and scratch as vg_chains_f32's. With grad, two
// launches: the pass and the fixed-order reduce; else the forward-only
// pass alone.
extern "C" int vg_chains_deep_f32(const void* x, const void* target, long long tsg, long long tsc,
                                  const void* q, void* out, void* scratch, long long scratch_bytes,
                                  int G, int C, int m, int n, int k0, int s, int depth, int act,
                                  int grad, int x_bf16, void* stream) {
    return deep_entry(x, target, tsg, tsc, q, out, scratch, scratch_bytes, G, C, m, n, k0, s,
                      depth, act, grad, x_bf16 != 0, stream);
}
