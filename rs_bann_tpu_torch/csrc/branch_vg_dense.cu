// K8a and K8b: the dense per-step value-and-gradient of the branch MLP's
// data term, one instance per (branch, chain), each reading its own X.
//
// Replaces rs_bann_tpu/ops/branch_mlp.py::_kernel (K8a: pallas_call in
// _data_vg_impl, one branch) and ::_blocked_kernel through ::_mlp_chunk
// (K8b: pallas_call in _data_vg_blocked, the branches of a vmap), both
// reached through data_vg. For NB instances i, on xT[ix[i]] of feature-major
// X [G, m, n] (on xT[i] when ix is null):
//
//     y_pred[i, j] = f(x_j; q[i])                                   (j < n)
//     grads[i]     = d(rss_i / 2) / d(q[i]),  rss_i = sum_j (y_pred[i, j] - t[i, j])^2
//
// in K7's flat layout W0 [m, k0], b0 [k0], (W1 [k0, s], b1 [s]), w_out [s].
// NB = 1 is K8a (the sequential schedule's leapfrog step); NB = every
// (chain, branch) of a hybrid block is K8b, with ix pointing each chain's
// instances at its own block's branches, so no X is copied per step. The
// TPU kernel's block-diagonal packing of branches into one MXU tile is a
// TPU matter: here each instance is its own grid row.
//
// The device code is K7's chain_item (csrc/dense_chain_mlp.cuh) at C = 1:
// one block per (128-individual tile, instance) stages its X tile in shared
// memory, runs the forward and backward and writes the tile's gradient to
// its own partial slot; a second kernel adds the tiles in a fixed order. No
// float atomics, so the same inputs give the same bits. A forward-only
// instantiation (grad = 0) writes y_pred alone (the unfolded hybrid block's
// snapshot predictions).
//
// What bounds it on the H100: per instance and individual the pass does
// 2 m k0 + 2 k0 s + s (forward) and 2 m k0 + 4 k0 s + s (backward) FMAs; at
// the dense flagship (m = 64, k0 = s = 32, n = 4,096) 5.9e7 FLOP per
// instance, 0.88 us at the 67 TFLOP/s f32 peak, against 1 MB of X (0.31 us
// at 3.35 TB/s): operations bound it. At NB = 1 the grid is n / 128 = 32
// blocks on 132 SMs and the launches cost more than the arithmetic; the
// tile stays K7's 128 (a thread owns 4 individuals of a float4), because the
// sequential sweep that makes those calls is bound by the host's launches,
// not by the card. Measured times: PERF.md section 6.
#include <cuda_runtime.h>

#include "dense_chain_mlp.cuh"

// K6's and K7's limits, which K8 shares (csrc/branch_vg_chains.cu)
extern "C" long long dense_chains_smem(int m, int k0, int s, int depth);

namespace {

using namespace rsbann;
using namespace rsbann::dense;

template <int KM, bool DEEP, bool GRAD>
__global__ void __launch_bounds__(kThreads, 2) vg_dense_kernel(ChainArgs a) {
    extern __shared__ float4 smem4[];
    chain_item<KM, DEEP, GRAD>(a, blockIdx.y, blockIdx.x, reinterpret_cast<float*>(smem4));
}

__global__ void reduce_dense_kernel(const float* __restrict__ partial, float* __restrict__ grads,
                                    long long total, int ntiles, int P) {
    reduce_tiles(partial, grads, total, ntiles, P);
}

template <int KM, bool DEEP, bool GRAD>
int launch(const ChainArgs& a, int NB, cudaStream_t stream) {
    auto kern = vg_dense_kernel<KM, DEEP, GRAD>;
    const size_t smem = smem_bytes(a.m, KM);
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<dim3(a.ntiles, NB), kThreads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

template <bool DEEP, bool GRAD>
int launch_km(int km, const ChainArgs& a, int NB, cudaStream_t stream) {
    if (km == 8) return launch<8, DEEP, GRAD>(a, NB, stream);
    if (km == 16) return launch<16, DEEP, GRAD>(a, NB, stream);
    return launch<32, DEEP, GRAD>(a, NB, stream);
}

}  // namespace

// x f32 [G, m, n]; ix int32 [NB] branch indices into x, or null (instance i
// reads branch i); target f32 [NB, n] (grad only); q f32 [NB, P] flat
// weights; y_pred f32 [NB, n]; partial f32 [NB, ceil(n / 128), P] scratch
// and grads f32 [NB, P] (grad only). The caller keeps ix inside [0, G).
extern "C" int vg_dense_f32(const void* x, const void* ix, const void* target, const void* q,
                            void* y_pred, void* partial, void* grads, int NB, int m, int n,
                            int k0, int s, int P, int depth, int act, int grad, void* stream) {
    const int km = pick_km(k0, s);
    const bool deep = depth == 1;
    if (dense_chains_smem(m, k0, s, depth) < 0 || P != partial_size(m, k0, s, deep) || n <= 0 ||
        NB <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int ntiles = (n + kTile - 1) / kTile;
    ChainArgs a{static_cast<const float*>(x), static_cast<const float*>(target),
                static_cast<const float*>(q),  static_cast<float*>(y_pred),
                static_cast<float*>(partial),  1, m, n, k0, s, P, act, ntiles,
                static_cast<const int*>(ix)};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (!grad) return deep ? launch_km<true, false>(km, a, NB, st) : launch_km<false, false>(km, a, NB, st);
    const int status = deep ? launch_km<true, true>(km, a, NB, st) : launch_km<false, true>(km, a, NB, st);
    if (status != 0) return status;
    const long long total = static_cast<long long>(NB) * P;
    const int threads = 256;
    reduce_dense_kernel<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0, st>>>(
        static_cast<const float*>(partial), static_cast<float*>(grads), total, ntiles, P);
    return static_cast<int>(cudaGetLastError());
}
