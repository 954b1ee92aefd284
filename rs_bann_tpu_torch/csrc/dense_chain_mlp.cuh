// K7's device code: the chain-folded feature-major branch MLP, its error and
// its backward for one work item, shared by K7 (csrc/branch_vg_chains.cu),
// the gradient phase of K6 (csrc/traj_dense.cu) and K8 at C = 1
// (csrc/branch_vg_dense.cu), so they cannot drift apart.
//
// Replaces the body of rs_bann_tpu/ops/branch_mlp.py::_chain_kernel (and the
// data_grad of ::leapfrog.py::_traj_kernel, and ::_kernel / ::_blocked_kernel
// at one chain, which are the same computation).
//
// A work item is (branch g, tile of kTile = 128 individuals). The X tile
// xT[g, :, tile] ([m, 128] f32, 33 KB at m = 64) is staged once in shared
// memory and serves the C chains in turn; each chain's weights are staged
// over the previous chain's. Per chain, with 256 threads:
//
//   z0 [KM, 128] = W0^T x + b0     thread (warp w, lane l) owns units
//   a0 = act(z0)                    w*KT .. w*KT+KT-1 (KT = KM / 8) of
//   z1 [KM, 128] = W1^T a0 + b1     individuals 4l .. 4l+3: KT x 4 sums in
//   a1 = act(z1)                    registers, W rows broadcast over the warp
//   pred[i] = sum_s w_out[s] a1[s, i]                       (thread i < 128)
//   err[i]  = pred[i] - t[i] (0 for i >= n)
//   dz1 = w_out * err * act'(z1);  dz0 = (W1 dz1) * act'(z0)
//   dW0 [m, k0]  = x dz0^T,  dW1 [k0, s] = a0 dz1^T     (thread per column,
//   db0, db1, dw_out: one warp per row, butterfly sums   up to 8 rows each)
//
// Every output is one thread's sum in a fixed order, so the same inputs give
// the same bits. Activations, dz0 and dz1 live in shared memory as
// [KM][132]-strided rows: float4 loads over individuals, conflict-free
// column reads. The item's gradient lands in its own slot of the partial
// sums; the caller adds the tiles in a fixed order.
#pragma once

#include <cstddef>

#include "packed_decode.cuh"

namespace rsbann {
namespace dense {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;         // individuals per work item
constexpr int kRowT = kTile + 4;   // shared-memory row stride of [rows][tile] buffers
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use

// Shared memory of one item at padded width km (depth 0 leaves a1 and dz1
// unused; one size serves both depths and the forward-only pass).
inline size_t smem_bytes(int m, int km) {
    const size_t floats = static_cast<size_t>(m) * kRowT + 3ull * km * kRowT +
                          static_cast<size_t>(m) * km + 2ull * km * km + 4ull * km + kTile;
    return floats * sizeof(float);
}

struct ChainArgs {
    const float* x;       // xT [G, m, n]
    const float* target;  // [G, C, n] (gradient passes)
    const float* q;       // flat weights [G, C, P]: W0 [m, k0], b0 [k0], (W1 [k0, s], b1 [s]), w_out [s]
    float* y_pred;        // [G, C, n] or null
    float* partial;       // [G, C, ntiles, P] (gradient passes)
    int C, m, n, k0, s, P, act, ntiles;
    const int* xix = nullptr;  // [G]: work row g reads X branch xix[g] (K8); null: branch g
};

// grads[bc, p] = sum over tiles t in order of partial[bc, t, p], one thread
// per element of grads [total = rows * P]: the fixed-order tile sum that
// follows K7's and K8's gradient passes.
__device__ __forceinline__ void reduce_tiles(const float* __restrict__ partial,
                                             float* __restrict__ grads, long long total,
                                             int ntiles, int P) {
    const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (e >= total) return;
    const long long bc = e / P;
    const float* src = partial + bc * ntiles * P + e % P;
    float sum = 0.f;
    for (int t = 0; t < ntiles; ++t) sum += src[static_cast<size_t>(t) * P];
    grads[e] = sum;
}

template <int KT>
__device__ __forceinline__ void load_k(const float* p, float (&w)[KT]) {
    if constexpr (KT == 4) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else if constexpr (KT == 2) {
        const float2 v = *reinterpret_cast<const float2*>(p);
        w[0] = v.x, w[1] = v.y;
    } else {
        w[0] = p[0];
    }
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// acc[j][q] += w[j] * v.q over the KT x 4 register tile
template <int KT>
__device__ __forceinline__ void fma_tile(float (&acc)[KT][4], const float (&w)[KT], float4 v) {
#pragma unroll
    for (int j = 0; j < KT; ++j) {
        acc[j][0] = fmaf(w[j], v.x, acc[j][0]);
        acc[j][1] = fmaf(w[j], v.y, acc[j][1]);
        acc[j][2] = fmaf(w[j], v.z, acc[j][2]);
        acc[j][3] = fmaf(w[j], v.w, acc[j][3]);
    }
}

// dst[r] = sum_i a[r][i] (* b[i]) over the tile, for r < rows: one warp per
// row, four values a lane, then a butterfly; a fixed order.
__device__ __forceinline__ void row_sums(const float* a, const float* b, int rows, float* dst) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int r = warp; r < rows; r += kWarps) {
        const float4 v = ld4(a + r * kRowT + 4 * lane);
        float sum;
        if (b != nullptr) {
            const float4 e = ld4(b + 4 * lane);
            sum = fmaf(v.w, e.w, fmaf(v.z, e.z, fmaf(v.y, e.y, v.x * e.x)));
        } else {
            sum = ((v.x + v.y) + v.z) + v.w;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) dst[r] = sum;
    }
}

// dst[r * ld + col] = sum_i A[r][i] * B[col][i] over the tile, for r < rows
// and col < cols: thread (r0, col) = (tid / KM, tid % KM) owns rows
// r0, r0 + RG, ... (RG = 256 / KM), up to 8 at a time. With KM = 32 a warp
// shares its rows, so the A loads are broadcasts.
template <int KM>
__device__ __forceinline__ void contract(const float* A, const float* B, int rows, int cols,
                                         float* dst, int ld) {
    constexpr int RG = kThreads / KM;
    const int col = threadIdx.x % KM, r0 = threadIdx.x / KM;
    for (int rb = r0; rb < rows; rb += 8 * RG) {
        float acc[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = 0.f;
        for (int i4 = 0; i4 < kTile / 4; ++i4) {
            const float4 bv = ld4(B + col * kRowT + 4 * i4);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int r = rb + RG * j;
                if (r < rows) {
                    const float4 av = ld4(A + r * kRowT + 4 * i4);
                    acc[j] = fmaf(av.w, bv.w, fmaf(av.z, bv.z, fmaf(av.y, bv.y, fmaf(av.x, bv.x, acc[j]))));
                }
            }
        }
        if (col < cols) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int r = rb + RG * j;
                if (r < rows) dst[r * ld + col] = acc[j];
            }
        }
    }
}

// One work item: branch g, individuals tile * 128 .. + 127, every chain.
// GRAD = false is the forward-only pass (y_pred only).
template <int KM, bool DEEP, bool GRAD>
__device__ void chain_item(const ChainArgs& a, int g, int tile, float* smem) {
    constexpr int KT = KM / kWarps;
    const int tid = threadIdx.x;
    const int lane = tid & 31, kg = tid >> 5;
    const int m = a.m, n = a.n, k0 = a.k0, s = a.s, P = a.P;
    const int i0 = tile * kTile;

    float* xs = smem;                  // [m][kRowT]  X tile
    float* a0s = xs + m * kRowT;       // [KM][kRowT] a0
    float* a1s = a0s + KM * kRowT;     // [KM][kRowT] a1 (depth 1), then dz0
    float* dz1s = a1s + KM * kRowT;    // [KM][kRowT] dz1 (depth 1)
    float* w0s = dz1s + KM * kRowT;    // [m][KM]
    float* w1s = w0s + m * KM;         // [KM][KM] W1[k][s]
    float* w1ts = w1s + KM * KM;       // [KM][KM] W1[k][s] at [s][k]
    float* b0s = w1ts + KM * KM;       // [KM]
    float* b1s = b0s + KM;             // [KM]
    float* wos = b1s + KM;             // [KM]
    float* errs = wos + 2 * KM;        // [kTile]
    float* dz0s = a1s;
    const float* alast = DEEP ? a1s : a0s;

    const int off_b0 = m * k0;
    const int off_w1 = off_b0 + k0;
    const int off_b1 = off_w1 + k0 * s;
    const int off_wo = DEEP ? off_b1 + s : off_w1;

    // ---- the X tile, once for all chains (zero past n)
    __syncthreads();  // the previous item is done with shared memory
    const float* xg = a.x + static_cast<size_t>(a.xix != nullptr ? a.xix[g] : g) * m * n;
    if ((n & 3) == 0) {
        for (int idx = tid; idx < m * (kTile / 4); idx += kThreads) {
            const int mm = idx / (kTile / 4), v = idx % (kTile / 4);
            const int i = i0 + 4 * v;
            const float4 val = i < n ? __ldg(reinterpret_cast<const float4*>(xg + static_cast<size_t>(mm) * n + i))
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
            *reinterpret_cast<float4*>(xs + mm * kRowT + 4 * v) = val;
        }
    } else {
        for (int idx = tid; idx < m * kTile; idx += kThreads) {
            const int mm = idx / kTile, i = idx % kTile;
            xs[mm * kRowT + i] = i0 + i < n ? __ldg(xg + static_cast<size_t>(mm) * n + i0 + i) : 0.f;
        }
    }

    for (int c = 0; c < a.C; ++c) {
        const size_t bc = static_cast<size_t>(g) * a.C + c;
        const float* q = a.q + bc * P;

        // ---- chain c's weights, zero-padded to KM (read through L2: K6
        // rewrites them inside its launch)
        for (int idx = tid; idx < m * KM; idx += kThreads) {
            const int mm = idx / KM, k = idx % KM;
            w0s[idx] = k < k0 ? __ldcg(q + mm * k0 + k) : 0.f;
        }
        if (tid < KM) {
            b0s[tid] = tid < k0 ? __ldcg(q + off_b0 + tid) : 0.f;
            wos[tid] = tid < s ? __ldcg(q + off_wo + tid) : 0.f;
            if (DEEP) b1s[tid] = tid < s ? __ldcg(q + off_b1 + tid) : 0.f;
        }
        if (DEEP) {
            for (int idx = tid; idx < KM * KM; idx += kThreads) {
                const int k = idx / KM, ss = idx % KM;
                const float v = (k < k0 && ss < s) ? __ldcg(q + off_w1 + k * s + ss) : 0.f;
                w1s[idx] = v;
                w1ts[ss * KM + k] = v;
            }
        }
        __syncthreads();

        // ---- layer 0: z0[units kg*KT.., individuals 4*lane..]
        float z0[KT][4];
#pragma unroll
        for (int j = 0; j < KT; ++j)
#pragma unroll
            for (int u = 0; u < 4; ++u) z0[j][u] = 0.f;
        for (int mm = 0; mm < m; ++mm) {
            float w[KT];
            load_k<KT>(w0s + mm * KM + kg * KT, w);
            fma_tile<KT>(z0, w, ld4(xs + mm * kRowT + 4 * lane));
        }
#pragma unroll
        for (int j = 0; j < KT; ++j) {
            const float b = b0s[kg * KT + j];
            float act0[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                z0[j][u] += b;
                act0[u] = act_apply(a.act, z0[j][u]);
            }
            st4(a0s + (kg * KT + j) * kRowT + 4 * lane, act0);
        }
        __syncthreads();

        // ---- layer 1 (depth 1)
        float z1[KT][4], a1[KT][4];
        if (DEEP) {
#pragma unroll
            for (int j = 0; j < KT; ++j)
#pragma unroll
                for (int u = 0; u < 4; ++u) z1[j][u] = 0.f;
            for (int k = 0; k < KM; ++k) {
                float w[KT];
                load_k<KT>(w1s + k * KM + kg * KT, w);
                fma_tile<KT>(z1, w, ld4(a0s + k * kRowT + 4 * lane));
            }
#pragma unroll
            for (int j = 0; j < KT; ++j) {
                const float b = b1s[kg * KT + j];
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    z1[j][u] += b;
                    a1[j][u] = act_apply(a.act, z1[j][u]);
                }
                st4(a1s + (kg * KT + j) * kRowT + 4 * lane, a1[j]);
            }
            __syncthreads();
        }

        // ---- prediction and error, thread per individual
        if (tid < kTile) {
            float p = 0.f;
            for (int ss = 0; ss < KM; ++ss) p = fmaf(wos[ss], alast[ss * kRowT + tid], p);
            const int i = i0 + tid;
            if (a.y_pred != nullptr && i < n) a.y_pred[bc * n + i] = p;
            if (GRAD) errs[tid] = i < n ? p - a.target[bc * n + i] : 0.f;
        }
        if (!GRAD) {
            __syncthreads();  // chain c + 1 restages the weights
            continue;
        }
        __syncthreads();

        float* part = a.partial + (bc * a.ntiles + tile) * P;
        const float4 e4 = ld4(errs + 4 * lane);
        const float ev[4] = {e4.x, e4.y, e4.z, e4.w};
        if (DEEP) {
            // dz1 = w_out * err * act'(z1)
#pragma unroll
            for (int j = 0; j < KT; ++j) {
                const float wo = wos[kg * KT + j];
                float d[4];
#pragma unroll
                for (int u = 0; u < 4; ++u) d[u] = wo * ev[u] * act_prime(a.act, z1[j][u], a1[j][u]);
                st4(dz1s + (kg * KT + j) * kRowT + 4 * lane, d);
            }
            __syncthreads();
            row_sums(a1s, errs, s, part + off_wo);     // dw_out
            row_sums(dz1s, nullptr, s, part + off_b1);  // db1
            // da0 = W1 dz1, dz0 = da0 * act'(z0)
            float da[KT][4];
#pragma unroll
            for (int j = 0; j < KT; ++j)
#pragma unroll
                for (int u = 0; u < 4; ++u) da[j][u] = 0.f;
            for (int ss = 0; ss < KM; ++ss) {
                float w[KT];
                load_k<KT>(w1ts + ss * KM + kg * KT, w);
                fma_tile<KT>(da, w, ld4(dz1s + ss * kRowT + 4 * lane));
            }
            __syncthreads();  // every read of a1s is done: dz0 goes there
#pragma unroll
            for (int j = 0; j < KT; ++j) {
                const float4 av = ld4(a0s + (kg * KT + j) * kRowT + 4 * lane);
                const float a0v[4] = {av.x, av.y, av.z, av.w};
                float d[4];
#pragma unroll
                for (int u = 0; u < 4; ++u) d[u] = da[j][u] * act_prime(a.act, z0[j][u], a0v[u]);
                st4(dz0s + (kg * KT + j) * kRowT + 4 * lane, d);
            }
        } else {
            // dz0 = w_out * err * act'(z0)
#pragma unroll
            for (int j = 0; j < KT; ++j) {
                const float wo = wos[kg * KT + j];
                const float4 av = ld4(a0s + (kg * KT + j) * kRowT + 4 * lane);
                const float a0v[4] = {av.x, av.y, av.z, av.w};
                float d[4];
#pragma unroll
                for (int u = 0; u < 4; ++u) d[u] = wo * ev[u] * act_prime(a.act, z0[j][u], a0v[u]);
                st4(dz0s + (kg * KT + j) * kRowT + 4 * lane, d);
            }
            row_sums(a0s, errs, s, part + off_wo);  // dw_out
        }
        __syncthreads();

        row_sums(dz0s, nullptr, k0, part + off_b0);       // db0
        contract<KM>(xs, dz0s, m, k0, part, k0);          // dW0
        if (DEEP) contract<KM>(a0s, dz1s, k0, s, part + off_w1, s);  // dW1
        __syncthreads();  // chain c + 1 restages the weights and reuses the buffers
    }
}

}  // namespace dense
}  // namespace rsbann
