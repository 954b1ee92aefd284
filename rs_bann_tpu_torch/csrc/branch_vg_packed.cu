// K4: fused packed value-and-gradient of one leapfrog step's data term.
//
// Replaces rs_bann_tpu/ops/branch_mlp.py::_blocked_packed_kernel (called
// through _data_vg_packed_blocked, _vg_packed_for and data_vg_packed).
// In one pass over the packed genotype bytes it computes, per branch g,
//
//     y_pred[i]            = f(x_i; W, b)          for every individual i < n
//     d(rss/2)/d(W_l, b_l)  summed over i < n       for every layer l
//
// with rss = sum_i (y_pred[i] - target[i])^2 (reduced outside from y_pred).
// Layer 0 arrives folded: W0' = w_scale * W0 and b0' = b0 - shift @ W0'; the
// wrapper unfolds the cotangents (ops/branch_mlp.py data_vg_packed).
// Depth 0 (layers W0 [m, k0], w_out [k0]) and depth 1 (W0 [m, k0],
// W1 [k0, s], w_out [s]), all five activations.
//
// What bounds it on the H100: per 512-individual block the forward and the
// dW0 reduction each cost m * k0 * 512 FMAs (0.67 GFLOP a call at the
// slice's shape: m = 104, k0 = 16, n = 100,352 padded) against 13 KB of
// bytes read once, so it is bound by f32 FMA issue and shared-memory
// traffic, not by device memory; at one branch per call its 196 blocks
// also leave part of the 132 SMs idle in the second wave.
//
// Design:
//  * Grid (n / 512 groups, G), 128 threads; thread j owns byte column j of
//    the group (four individuals, one per part q; K1 decodes them).
//  * The block's byte tile [m, 128] is staged once in shared memory (row
//    stride 132 bytes, so the per-marker-row reads of the dW0 pass hit
//    distinct banks) and read twice: forward and dW0 pass.
//  * Forward, error and backward for the thread's four individuals run in
//    registers; the per-individual layer-0 cotangents (and, at depth 1, the
//    layer-0 activations and layer-1 cotangents) go to shared memory with a
//    row stride of KM + 4 floats, which keeps float4 stores conflict-free.
//  * Gradients are sums over all n individuals. Hopper blocks run in no
//    order (on the TPU, the sequential grid carries the sum in VMEM), so
//    each block writes its partial sums to scratch [G, n_blocks, P] and a
//    second kernel adds them in a fixed order. No float atomics: the same
//    inputs give the same bits on every run, and the MCMC chain with them.
//  * err is masked to i < n (individuals past n decode to 0 but still pass
//    the bias through the net).
#include <cuda_runtime.h>

#include <cstdint>

#include "packed_decode.cuh"

namespace {

using namespace rsbann;

constexpr int kThreads = kGBytes;  // one thread per byte column of a group
constexpr int kRow = kGBytes + 4;  // shared-memory row stride of the byte tile
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use

__host__ __device__ constexpr int row_stride(int km) { return km + 4; }

size_t smem_bytes(int m, int km, bool deep) {
    const size_t floats = static_cast<size_t>(m) * km + km + (deep ? km * km + km : 0) + km +
                          4 * km + static_cast<size_t>(kGroup) * row_stride(km) * (deep ? 3 : 1);
    return floats * sizeof(float) + static_cast<size_t>(m) * kRow;
}

template <int KM, bool DEEP>
__global__ void __launch_bounds__(kThreads)
vg_packed_kernel(const uint8_t* __restrict__ bytes, const float* __restrict__ target,
                 const float* __restrict__ w0, const float* __restrict__ b0,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ wout, float* __restrict__ y_pred,
                 float* __restrict__ partial, int m, int B, int n, int k0, int s, int P,
                 int act) {
    constexpr int RS = row_stride(KM);
    extern __shared__ float4 smem4[];
    float* w0_s = reinterpret_cast<float*>(smem4);  // [m][KM]
    float* b0_s = w0_s + m * KM;                    // [KM]
    float* w1_s = b0_s + KM;                        // [KM][KM] (depth 1)
    float* b1_s = w1_s + (DEEP ? KM * KM : 0);      // [KM]     (depth 1)
    float* wo_s = b1_s + (DEEP ? KM : 0);           // [KM]
    float* red_s = wo_s + KM;                       // [4][KM]
    float* dz0_s = red_s + 4 * KM;                  // [512][RS]
    float* a0_s = dz0_s + kGroup * RS;              // [512][RS] (depth 1)
    float* dz1_s = a0_s + (DEEP ? kGroup * RS : 0); // [512][RS] (depth 1)
    uint8_t* by_s = reinterpret_cast<uint8_t*>(dz1_s + (DEEP ? kGroup * RS : 0));  // [m][kRow]

    const int grp = blockIdx.x;
    const int g = blockIdx.y;
    const int tid = threadIdx.x;

    // ---- stage weights (zero-padded to KM) and the byte tile
    const float* w0_g = w0 + static_cast<size_t>(g) * m * k0;
    for (int idx = tid; idx < m * KM; idx += kThreads) {
        const int mm = idx / KM, kk = idx % KM;
        w0_s[idx] = kk < k0 ? w0_g[mm * k0 + kk] : 0.f;
    }
    if (tid < KM) {
        b0_s[tid] = tid < k0 ? b0[g * k0 + tid] : 0.f;
        wo_s[tid] = tid < s ? wout[g * s + tid] : 0.f;
        if (DEEP) b1_s[tid] = tid < s ? b1[g * s + tid] : 0.f;
    }
    if (DEEP) {
        for (int idx = tid; idx < KM * KM; idx += kThreads) {
            const int kk = idx / KM, ss = idx % KM;
            w1_s[idx] = (kk < k0 && ss < s) ? w1[(static_cast<size_t>(g) * k0 + kk) * s + ss] : 0.f;
        }
    }
    const uint32_t* src = reinterpret_cast<const uint32_t*>(
        bytes + static_cast<size_t>(g) * m * B + static_cast<size_t>(grp) * kGBytes);
    for (int idx = tid; idx < m * (kGBytes / 4); idx += kThreads) {
        const int mm = idx / (kGBytes / 4), wd = idx % (kGBytes / 4);
        reinterpret_cast<uint32_t*>(by_s + mm * kRow)[wd] = src[static_cast<size_t>(mm) * (B / 4) + wd];
    }
    __syncthreads();

    // ---- layer 0 forward for the thread's four individuals
    float acc[4][KM];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int k = 0; k < KM; ++k) acc[q][k] = 0.f;
    for (int mm = 0; mm < m; ++mm) {
        const uint32_t byte = by_s[mm * kRow + tid];
        float x[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) x[q] = decode_part(byte, q);
        const float4* w4 = reinterpret_cast<const float4*>(w0_s + mm * KM);
#pragma unroll
        for (int v = 0; v < KM / 4; ++v) {
            const float4 w = w4[v];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                acc[q][4 * v + 0] = fmaf(x[q], w.x, acc[q][4 * v + 0]);
                acc[q][4 * v + 1] = fmaf(x[q], w.y, acc[q][4 * v + 1]);
                acc[q][4 * v + 2] = fmaf(x[q], w.z, acc[q][4 * v + 2]);
                acc[q][4 * v + 3] = fmaf(x[q], w.w, acc[q][4 * v + 3]);
            }
        }
    }

    // ---- rest of the forward, error and backward, one individual at a time
    float dwo[KM], db0p[KM], db1p[KM];
#pragma unroll
    for (int k = 0; k < KM; ++k) dwo[k] = db0p[k] = db1p[k] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int row = q * kGBytes + tid;
        const int i = grp * kGroup + row;
        const bool valid = i < n;
        float z0[KM], a0[KM], dz0[KM];
#pragma unroll
        for (int k = 0; k < KM; ++k) {
            z0[k] = acc[q][k] + b0_s[k];
            a0[k] = act_apply(act, z0[k]);
        }
        float pred = 0.f;
        if (DEEP) {
            float z1[KM], a1[KM], dz1[KM];
#pragma unroll
            for (int ss = 0; ss < KM; ++ss) {
                float z = b1_s[ss];
#pragma unroll
                for (int k = 0; k < KM; ++k) z = fmaf(a0[k], w1_s[k * KM + ss], z);
                z1[ss] = z;
                a1[ss] = act_apply(act, z);
                pred = fmaf(wo_s[ss], a1[ss], pred);
            }
            if (valid) y_pred[static_cast<size_t>(g) * n + i] = pred;
            const float err = valid ? pred - target[static_cast<size_t>(g) * n + i] : 0.f;
#pragma unroll
            for (int ss = 0; ss < KM; ++ss) {
                dwo[ss] = fmaf(a1[ss], err, dwo[ss]);
                dz1[ss] = wo_s[ss] * err * act_prime(act, z1[ss], a1[ss]);
                db1p[ss] += dz1[ss];
            }
#pragma unroll
            for (int k = 0; k < KM; ++k) {
                float da = 0.f;
#pragma unroll
                for (int ss = 0; ss < KM; ++ss) da = fmaf(w1_s[k * KM + ss], dz1[ss], da);
                dz0[k] = da * act_prime(act, z0[k], a0[k]);
                db0p[k] += dz0[k];
            }
            store_row<KM>(a0_s + row * RS, a0);
            store_row<KM>(dz1_s + row * RS, dz1);
        } else {
#pragma unroll
            for (int k = 0; k < KM; ++k) pred = fmaf(wo_s[k], a0[k], pred);
            if (valid) y_pred[static_cast<size_t>(g) * n + i] = pred;
            const float err = valid ? pred - target[static_cast<size_t>(g) * n + i] : 0.f;
#pragma unroll
            for (int k = 0; k < KM; ++k) {
                dwo[k] = fmaf(a0[k], err, dwo[k]);
                dz0[k] = wo_s[k] * err * act_prime(act, z0[k], a0[k]);
                db0p[k] += dz0[k];
            }
        }
        store_row<KM>(dz0_s + row * RS, dz0);
    }
    __syncthreads();

    float* part = partial + (static_cast<size_t>(g) * gridDim.x + grp) * P;
    const int off_db0 = m * k0;
    const int off_w1 = off_db0 + k0;
    const int off_b1 = off_w1 + k0 * s;
    const int off_wo = DEEP ? off_b1 + s : off_w1;

    // ---- small sums over the block
    block_sum<KM>(db0p, red_s, part + off_db0, k0);
    block_sum<KM>(dwo, red_s, part + off_wo, s);
    if (DEEP) block_sum<KM>(db1p, red_s, part + off_b1, s);

    // ---- dW0'[mm, :] = sum over the group's 512 individuals of x[mm, i] * dz0[i, :]
    for (int mm = tid; mm < m; mm += kThreads) {
        float acc2[KM];
#pragma unroll
        for (int k = 0; k < KM; ++k) acc2[k] = 0.f;
        const uint32_t* brow = reinterpret_cast<const uint32_t*>(by_s + mm * kRow);
        for (int c4 = 0; c4 < kGBytes / 4; ++c4) {
            const uint32_t word = brow[c4];
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                const uint32_t byte = (word >> (8 * b)) & 0xffu;
                const int c = 4 * c4 + b;
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const float x = decode_part(byte, q);
                    const float4* d4 = reinterpret_cast<const float4*>(dz0_s + (q * kGBytes + c) * RS);
#pragma unroll
                    for (int v = 0; v < KM / 4; ++v) {
                        const float4 d = d4[v];
                        acc2[4 * v + 0] = fmaf(x, d.x, acc2[4 * v + 0]);
                        acc2[4 * v + 1] = fmaf(x, d.y, acc2[4 * v + 1]);
                        acc2[4 * v + 2] = fmaf(x, d.z, acc2[4 * v + 2]);
                        acc2[4 * v + 3] = fmaf(x, d.w, acc2[4 * v + 3]);
                    }
                }
            }
        }
        for (int k = 0; k < k0; ++k) part[mm * k0 + k] = acc2[k];
    }

    // ---- dW1[k, ss] = sum over the group of a0[i, k] * dz1[i, ss] (depth 1)
    if (DEEP) {
        for (int idx = tid; idx < k0 * s; idx += kThreads) {
            const int k = idx / s, ss = idx % s;
            float sum = 0.f;
            for (int r = 0; r < kGroup; ++r) sum = fmaf(a0_s[r * RS + k], dz1_s[r * RS + ss], sum);
            part[off_w1 + idx] = sum;
        }
    }
}

// grads[g, p] = sum over blocks b, in order, of partial[g, b, p].
__global__ void reduce_partials_kernel(const float* __restrict__ partial, float* __restrict__ grads,
                                       int nblk, int P) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    const int g = blockIdx.y;
    if (p >= P) return;
    const float* src = partial + static_cast<size_t>(g) * nblk * P + p;
    float sum = 0.f;
    for (int b = 0; b < nblk; ++b) sum += src[static_cast<size_t>(b) * P];
    grads[static_cast<size_t>(g) * P + p] = sum;
}

template <int KM, bool DEEP>
int launch(const uint8_t* bytes, const float* target, const float* w0, const float* b0,
           const float* w1, const float* b1, const float* wout, float* y_pred, float* partial,
           int G, int m, int B, int n, int k0, int s, int P, int act, cudaStream_t stream) {
    const size_t smem = smem_bytes(m, KM, DEEP);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            vg_packed_kernel<KM, DEEP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const dim3 grid(B / kGBytes, G);
    vg_packed_kernel<KM, DEEP><<<grid, kThreads, smem, stream>>>(
        bytes, target, w0, b0, w1, b1, wout, y_pred, partial, m, B, n, k0, s, P, act);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory the kernel needs at these widths, or -1 if it cannot run them.
extern "C" long long branch_vg_packed_smem(int m, int k0, int s, int depth) {
    const int km = pick_km(k0, s);
    if (km < 0 || depth < 0 || depth > 1) return -1;
    const size_t smem = smem_bytes(m, km, depth == 1);
    return smem > static_cast<size_t>(kMaxSmem) ? -1 : static_cast<long long>(smem);
}

// bytes u8 [G, m, B]; target f32 [G, n]; w0 f32 [G, m, k0]; b0 f32 [G, k0];
// w1 f32 [G, k0, s] and b1 f32 [G, s] (depth 1, else unused); wout f32 [G, s];
// y_pred f32 [G, n]; partial f32 [G, B / 128, P] scratch; grads f32 [G, P]
// laid out as dW0' [m, k0], db0' [k0], (dW1 [k0, s], db1 [s]), dW_out [s].
extern "C" int branch_vg_packed_f32(const void* bytes, const void* target, const void* w0,
                                    const void* b0, const void* w1, const void* b1,
                                    const void* wout, void* y_pred, void* partial, void* grads,
                                    int G, int m, int B, int n, int k0, int s, int P, int depth,
                                    int act, void* stream) {
    const int km = pick_km(k0, s);
    const bool deep = depth == 1;
    if (km < 0 || depth < 0 || depth > 1 || P != partial_size(m, k0, s, deep) ||
        smem_bytes(m, km, deep) > static_cast<size_t>(kMaxSmem))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto* by = static_cast<const uint8_t*>(bytes);
    const auto* t = static_cast<const float*>(target);
    const auto* pw0 = static_cast<const float*>(w0);
    const auto* pb0 = static_cast<const float*>(b0);
    const auto* pw1 = static_cast<const float*>(w1);
    const auto* pb1 = static_cast<const float*>(b1);
    const auto* pwo = static_cast<const float*>(wout);
    auto* yp = static_cast<float*>(y_pred);
    auto* part = static_cast<float*>(partial);
    int e;
#define RSB_LAUNCH(KMV, DP)                                                                   \
    e = launch<KMV, DP>(by, t, pw0, pb0, pw1, pb1, pwo, yp, part, G, m, B, n, k0, s, P, act, st)
    if (deep) {
        if (km == 8) RSB_LAUNCH(8, true);
        else if (km == 16) RSB_LAUNCH(16, true);
        else RSB_LAUNCH(32, true);
    } else {
        if (km == 8) RSB_LAUNCH(8, false);
        else if (km == 16) RSB_LAUNCH(16, false);
        else RSB_LAUNCH(32, false);
    }
#undef RSB_LAUNCH
    if (e != 0) return e;
    const int nblk = B / kGBytes;
    const dim3 rgrid((P + 127) / 128, G);
    reduce_partials_kernel<<<rgrid, 128, 0, st>>>(part, static_cast<float*>(grads), nblk, P);
    return static_cast<int>(cudaGetLastError());
}
