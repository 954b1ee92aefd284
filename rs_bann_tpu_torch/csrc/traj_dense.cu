// K6: chain-folded whole-trajectory leapfrog on dense feature-major X.
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
// to 32, every activation, f32 throughout.
//
// What bounds it on the H100: each gradient evaluation is K7's pass (1.5e10
// FLOP at the dense flagship: G = 64, C = 4, m = 64, k0 = s = 32,
// n = 4,096), so a launch at L = 64 does 65 of them, 9.9e11 FLOP: 14.8 ms at
// the 67 TFLOP/s f32 FMA peak. X (67 MB f32) exceeds the 50 MB L2 and is
// streamed once per evaluation (20 us at 3.35 TB/s), for all C chains.
// f32 FMA issue bounds it, not device memory. Measured: PERF.md section 6.
//
// Design, as K5 (csrc/traj_packed.cu):
//  * One cooperative launch per transition (grid = resident blocks per SM x
//    SMs from the occupancy API, so an oversize grid is refused at launch
//    instead of hanging at a grid sync). Blocks walk a grid-stride loop.
//  * Each of the L + 1 gradient evaluations is a gradient phase, one work
//    item per (branch, 128-individual tile) running K7's device code
//    (csrc/dense_chain_mlp.cuh) for all C chains into the item's partial
//    sums, then grid.sync(), then an update phase, one thread per (branch,
//    chain, coordinate): the tiles' partials are added in a fixed order (no
//    float atomics, so the same inputs give the same bits), the prior
//    gradient and err applied, and the momentum and position updated in
//    place; then grid.sync() again. State written inside the launch is read
//    through L2 (__ldcg).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "dense_chain_mlp.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace rsbann;
using namespace rsbann::dense;

struct TrajArgs {
    ChainArgs chain;    // x, target, q = w (updated in place), partial
    const float* err;   // [G, C]
    const float* eps;   // [G, C, P]
    const float* lam;   // [G, C, P]
    float* w;           // [G, C, P] position
    float* pw;          // [G, C, P] momentum
    int G, steps, l1;
};

template <int KM, bool DEEP>
__global__ void __launch_bounds__(kThreads, 2) traj_dense_kernel(TrajArgs a) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    cg::grid_group grid = cg::this_grid();
    const int ntiles = a.chain.ntiles, P = a.chain.P;
    const long long items = static_cast<long long>(a.G) * ntiles;
    const long long total = static_cast<long long>(a.G) * a.chain.C * P;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;

    // evaluation 0 only gives the initial gradient; 1..L integrate
    for (int l = 0; l <= a.steps; ++l) {
        for (long long it = blockIdx.x; it < items; it += gridDim.x)
            chain_item<KM, DEEP, true>(a.chain, static_cast<int>(it / ntiles), static_cast<int>(it % ntiles),
                                       smem);
        grid.sync();

        for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
             e += stride) {
            const long long bc = e / P;
            const float* src = a.chain.partial + bc * ntiles * P + e % P;
            float sum = 0.f;
            for (int t = 0; t < ntiles; ++t) sum += __ldcg(src + static_cast<size_t>(t) * P);
            float q = __ldcg(a.w + e);
            float p = __ldcg(a.pw + e);
            const float ep = a.eps[e];
            const float prior = a.l1 ? (q > 0.f ? 1.f : (q < 0.f ? -1.f : 0.f)) : q;
            const float g = -a.lam[e] * prior - a.err[bc] * sum;
            if (l > 0) p += 0.5f * ep * g;  // closes step l
            if (l < a.steps) {               // opens step l + 1
                p += 0.5f * ep * g;
                q += ep * p;
            }
            __stcg(a.w + e, q);
            __stcg(a.pw + e, p);
        }
        grid.sync();
    }
}

template <int KM, bool DEEP>
int launch(TrajArgs a, cudaStream_t stream) {
    auto kern = traj_dense_kernel<KM, DEEP>;
    const size_t smem = smem_bytes(a.chain.m, KM);
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    int dev = 0, sms = 0, coop = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return static_cast<int>(e);
    if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
        return static_cast<int>(e);
    if (!coop) return static_cast<int>(cudaErrorNotSupported);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    void* params[] = {&a};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), dim3(per_sm * sms),
                                    dim3(kThreads), params, smem, stream);
    return static_cast<int>(e);
}

}  // namespace

// x f32 [G, m, n]; target f32 [G, C, n]; err f32 [G, C]; eps, lam f32
// [G, C, P]; w, pw f32 [G, C, P], the start on entry and the end of the
// trajectory on return; partial f32 [G, C, ceil(n / 128), P] scratch. The
// flat layout is W0 [m, k0], b0 [k0], (W1 [k0, s], b1 [s]), w_out [s].
extern "C" int traj_dense_f32(const void* x, const void* target, const void* err, const void* eps,
                              const void* lam, void* w, void* pw, void* partial, int G, int C,
                              int m, int n, int k0, int s, int P, int depth, int steps, int act,
                              int l1, void* stream) {
    const int km = pick_km(k0, s);
    const bool deep = depth == 1;
    if (km < 0 || depth < 0 || depth > 1 || P != partial_size(m, k0, s, deep) || steps < 0 ||
        n <= 0 || G <= 0 || C <= 0 || smem_bytes(m, km) > static_cast<size_t>(kMaxSmem))
        return static_cast<int>(cudaErrorInvalidValue);
    const int ntiles = (n + kTile - 1) / kTile;
    TrajArgs a{{static_cast<const float*>(x), static_cast<const float*>(target),
                static_cast<const float*>(w), nullptr, static_cast<float*>(partial), C, m, n, k0, s,
                P, act, ntiles},
               static_cast<const float*>(err), static_cast<const float*>(eps),
               static_cast<const float*>(lam), static_cast<float*>(w), static_cast<float*>(pw),
               G, steps, l1};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (deep) {
        if (km == 8) return launch<8, true>(a, st);
        if (km == 16) return launch<16, true>(a, st);
        return launch<32, true>(a, st);
    }
    if (km == 8) return launch<8, false>(a, st);
    if (km == 16) return launch<16, false>(a, st);
    return launch<32, false>(a, st);
}
