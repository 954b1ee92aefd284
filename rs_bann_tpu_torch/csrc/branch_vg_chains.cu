// K7: chain-folded dense value-and-gradient of the branch MLP's data term.
//
// Replaces rs_bann_tpu/ops/branch_mlp.py::_chain_kernel (pallas_call in
// _data_vg_chains_impl, reached through data_vg_chains). For every (branch
// g, chain c) on feature-major X xT [G, m, n]:
//
//     y_pred[g, c, i] = f(x_i; q[g, c])                       (i < n)
//     grads[g, c]     = d(rss / 2) / d(q[g, c]),  rss = sum_i (y_pred - t)^2
//
// in the flat layout W0 [m, k0], b0 [k0], (W1 [k0, s], b1 [s]), w_out [s].
// The device code is csrc/dense_chain_mlp.cuh, which K6 shares. One launch
// is one block per (tile of 128 individuals, branch), then a second kernel
// adds the tiles' partial sums in a fixed order: no float atomics, so the
// same inputs give the same bits. A forward-only instantiation (grad = 0)
// writes y_pred alone; the folded transition's value passes use it.
//
// What bounds it on the H100: per (branch, chain, individual) the pass does
// 2 m k0 + 2 k0 s + s (forward) and 2 m k0 + 4 k0 s (backward) FMAs; at the
// dense flagship (G = 64, C = 4, m = 64, k0 = s = 32, n = 4,096) that is
// 1.5e10 FLOP against 67 MB of X and 4 MB of targets, so the f32 FMA rate
// bounds it (0.23 ms at 67 TFLOP/s; the forward alone 0.10 ms), not device
// memory (0.02 ms at 3.35 TB/s). The partial sums add 104 MB written and
// read once per pass. Measured times: PERF.md section 6.
#include <cuda_runtime.h>

#include "dense_chain_mlp.cuh"

namespace {

using namespace rsbann;
using namespace rsbann::dense;

template <int KM, bool DEEP, bool GRAD>
__global__ void __launch_bounds__(kThreads, 2) vg_chains_kernel(ChainArgs a) {
    extern __shared__ float4 smem4[];
    chain_item<KM, DEEP, GRAD>(a, blockIdx.y, blockIdx.x, reinterpret_cast<float*>(smem4));
}

__global__ void reduce_tiles_kernel(const float* __restrict__ partial, float* __restrict__ grads,
                                    long long total, int ntiles, int P) {
    reduce_tiles(partial, grads, total, ntiles, P);
}

template <int KM, bool DEEP, bool GRAD>
int launch(const ChainArgs& a, int G, cudaStream_t stream) {
    auto kern = vg_chains_kernel<KM, DEEP, GRAD>;
    const size_t smem = smem_bytes(a.m, KM);
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<dim3(a.ntiles, G), kThreads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

template <bool DEEP, bool GRAD>
int launch_km(int km, const ChainArgs& a, int G, cudaStream_t stream) {
    if (km == 8) return launch<8, DEEP, GRAD>(a, G, stream);
    if (km == 16) return launch<16, DEEP, GRAD>(a, G, stream);
    return launch<32, DEEP, GRAD>(a, G, stream);
}

}  // namespace

// Shared memory K6 and K7 need at these widths, or -1 if they cannot run
// them (depth above 1, a width above 32, or more than 227 KB).
extern "C" long long dense_chains_smem(int m, int k0, int s, int depth) {
    const int km = pick_km(k0, s);
    if (km < 0 || depth < 0 || depth > 1 || m <= 0) return -1;
    const size_t smem = smem_bytes(m, km);
    return smem > static_cast<size_t>(kMaxSmem) ? -1 : static_cast<long long>(smem);
}

// x f32 [G, m, n]; target f32 [G, C, n] (grad only); q f32 [G, C, P] flat
// weights; y_pred f32 [G, C, n]; partial f32 [G, C, ceil(n / 128), P]
// scratch and grads f32 [G, C, P] (grad only).
extern "C" int vg_chains_f32(const void* x, const void* target, const void* q, void* y_pred,
                             void* partial, void* grads, int G, int C, int m, int n, int k0,
                             int s, int P, int depth, int act, int grad, void* stream) {
    const int km = pick_km(k0, s);
    const bool deep = depth == 1;
    if (dense_chains_smem(m, k0, s, depth) < 0 || P != partial_size(m, k0, s, deep) || n <= 0 ||
        G <= 0 || C <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int ntiles = (n + kTile - 1) / kTile;
    ChainArgs a{static_cast<const float*>(x), static_cast<const float*>(target),
                static_cast<const float*>(q),  static_cast<float*>(y_pred),
                static_cast<float*>(partial),  C, m, n, k0, s, P, act, ntiles};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    int status;
    if (!grad) return deep ? launch_km<true, false>(km, a, G, st) : launch_km<false, false>(km, a, G, st);
    status = deep ? launch_km<true, true>(km, a, G, st) : launch_km<false, true>(km, a, G, st);
    if (status != 0) return status;
    const long long total = static_cast<long long>(G) * C * P;
    const int threads = 256;
    reduce_tiles_kernel<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0, st>>>(
        static_cast<const float*>(partial), static_cast<float*>(grads), total, ntiles, P);
    return static_cast<int>(cudaGetLastError());
}
