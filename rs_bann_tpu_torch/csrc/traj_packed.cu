// K5: chain-folded whole-trajectory leapfrog on packed genotypes.
//
// Replaces rs_bann_tpu/ops/leapfrog.py::_traj_kernel_packed (bytes resident,
// pallas_call in _traj_chains_packed_impl) and ::_traj_kernel_packed_stream
// (grid-streamed, _traj_chains_packed_stream_impl), both reached through
// integrate_chains_packed. On Hopper one kernel serves both shapes.
//
// For every (branch b of a block, chain c) it integrates L leapfrog steps
//
//     p += eps/2 * g;   q += eps * p;   g = grad ld(q);   p += eps/2 * g
//
// of ld(q) = -lam * q^2 / 2 (or -lam * |q|, l1) - err[b,c] * rss(q) / 2,
// rss = sum_{i<n} (f(x_i; q) - t[b,c,i])^2, with x_i decoded from the 2-bit
// bytes (K1) and standardized in the kernel as (g - mu) * scale. Padded
// markers have scale 0; padded coordinates carry zero momentum, so they
// never move. Depth 0 and 1, every activation, f32 throughout.
//
// What bounds it on the H100: per step and per 512-individual group the
// forward and the dW0 pass each cost m * KM * 512 FMAs per chain; at the
// hybrid slice's shape (B = 10 branches, C = 4 chains, m = 104, n = 100,352
// padded, width 10 stored at 16) that is ~2.7e10 FLOP a step at KM = 16
// against 26 MB of bytes read once a step for all four chains (and held in
// the 50 MB L2 across steps), so f32 FMA issue bounds it, not device memory.
// The partial sums (53 MB at that shape) are written and read once a step,
// ~35 us of traffic against ~1.2 ms of arithmetic. Measured there at L = 30
// on all 16 stored columns: 39.3 ms a launch, 32% of the f32 peak, 20% when
// only the live work is counted (H100 80GB HBM3, 700 W; PERF.md).
//
// The live columns. The JAX package pads every width to 8 sublanes, so a
// width of 10 is stored as 16 and 6 of every 16 FMAs of the forward, the
// backward and the dW0 pass go into columns whose weights and momenta are
// masked to zero (the TPU's matrix unit pads anyway; here they cost issue
// slots). Every activation has act(0) = 0, so such a column adds nothing
// to a prediction, its gradient is zero and the leapfrog leaves it as it
// is. At depth 0 the wrapper passes the block's live width k_live (1 + the
// last column with a nonzero weight or momentum, or a step size or prior
// precision that is not finite) beside the storage width k0, and the
// kernel computes KM columns, the smallest of {8, 12, 16, 24, 32} that
// holds k_live (12 for width 10: a quarter fewer FMAs than at 16). It
// stages, multiplies and writes partial sums for live coordinates only,
// and the update phase leaves the dead ones untouched (their partials are
// never written). A dead column would only add fmaf(0, act(0), pred) and
// zero partials, so the live coordinates get the bits they got at KM = 16.
// Depth 1 computes every stored column (k_live = k0).
//
// Design:
//  * One cooperative launch per block transition (cudaLaunchCooperativeKernel,
//    grid = resident blocks per SM x SMs, so a grid sync cannot hang: an
//    oversize grid is refused at launch). Blocks walk a grid-stride loop.
//  * Each leapfrog step has two phases separated by grid.sync():
//    1. gradient phase, one work item per (branch, 512-individual group):
//       the byte tile [m, 128] is staged once in shared memory and serves
//       the C chains in turn (forward, error, backward as in K4), each
//       chain's weights staged over the previous one's, so shared memory
//       (traj_packed_smem) does not grow with C; each (item, chain) writes
//       its partial sums of d(rss/2)/d(q) to scratch.
//    2. update phase, one thread per (branch, chain, coordinate): the
//       partials are added in a fixed order (no float atomics, so the same
//       inputs give the same bits), then the prior gradient, err and the
//       momentum and position updates are applied in place.
//  * The state q, p lives in device memory as one flat vector per
//    (branch, chain) in K4's gradient layout (partial_size); data written
//    inside the launch is read with __ldcg (L2, coherent across blocks).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "packed_decode.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace rsbann;

constexpr int kThreads = kGBytes;  // one thread per byte column of a group
constexpr int kRow = kGBytes + 4;  // shared-memory row stride of the byte tile
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use

// Row stride (floats) of the per-individual rows: an odd number of 16-byte
// units, so the float4 stores of neighbouring rows hit distinct banks
// (12, 20, 20, 28, 36 for KM = 8, 12, 16, 24, 32).
__host__ __device__ constexpr int row_stride(int km) { return (km / 4) % 2 ? km + 8 : km + 4; }

// K5's register width for a depth-0 block of live width k_live.
inline int live_km(int k_live) {
    if (k_live <= 8) return 8;
    if (k_live <= 12) return 12;
    if (k_live <= 16) return 16;
    if (k_live <= 24) return 24;
    return k_live <= 32 ? 32 : -1;
}

size_t smem_bytes(int m, int km, bool deep) {
    const size_t floats = static_cast<size_t>(kGroup) * row_stride(km) * (deep ? 3 : 1) +
                          static_cast<size_t>(m) * km + km + (deep ? km * km + km : 0) + km +
                          4 * km + 2 * static_cast<size_t>(m);
    return floats * sizeof(float) + static_cast<size_t>(m) * kRow;
}

struct Args {
    const uint8_t* bytes;  // [nb, m, B]
    const float* scale;    // [nb, m]
    const float* shift;    // [nb, m]
    const float* target;   // [nb, C, n]
    const float* err;      // [nb, C]
    const float* eps;      // [nb, C, P]
    const float* lam;      // [nb, C, P]
    float* w;              // [nb, C, P] position, updated in place
    float* pw;             // [nb, C, P] momentum, updated in place
    float* partial;        // [nb, C, B / 128, P] scratch
    int nb, C, m, B, n, k0, s, P, steps, act, l1;
    int k_live;            // layer-0 columns computed: [0, k_live) (k0 at depth 1)
};

// d(rss/2)/d(q) of one 512-individual group of branch b, for each chain in
// turn, written to the group's partial sums of the live coordinates.
template <int KM, bool DEEP>
__device__ void gradient_item(const Args& a, float* smem, int b, int grp) {
    constexpr int RS = row_stride(KM);
    const int m = a.m, k0 = a.k0, s = a.s, P = a.P;
    const int kl = a.k_live;           // live layer-0 columns
    const int sl = DEEP ? s : kl;      // live inputs of the output layer
    const int tid = threadIdx.x;
    const int ngrp = a.B / kGBytes;
    float* dz0_s = smem;                            // [512][RS]
    float* a0_s = dz0_s + kGroup * RS;              // [512][RS] (depth 1)
    float* dz1_s = a0_s + (DEEP ? kGroup * RS : 0); // [512][RS] (depth 1)
    float* w0_s = dz1_s + (DEEP ? kGroup * RS : 0); // [m][KM]
    float* b0_s = w0_s + m * KM;                    // [KM]
    float* w1_s = b0_s + KM;                        // [KM][KM] (depth 1)
    float* b1_s = w1_s + (DEEP ? KM * KM : 0);      // [KM]     (depth 1)
    float* wo_s = b1_s + (DEEP ? KM : 0);           // [KM]
    float* red_s = wo_s + KM;                       // [4][KM]
    float* sc_s = red_s + 4 * KM;                   // [m] scale
    float* of_s = sc_s + m;                         // [m] shift * scale
    uint8_t* by_s = reinterpret_cast<uint8_t*>(of_s + m);  // [m][kRow]

    const int off_db0 = m * k0;
    const int off_w1 = off_db0 + k0;
    const int off_b1 = off_w1 + k0 * s;
    const int off_wo = DEEP ? off_b1 + s : off_w1;

    // ---- the byte tile and the per-marker standardization, once for all chains
    __syncthreads();  // the previous item is done with shared memory
    const uint32_t* src = reinterpret_cast<const uint32_t*>(
        a.bytes + static_cast<size_t>(b) * m * a.B + static_cast<size_t>(grp) * kGBytes);
    for (int idx = tid; idx < m * (kGBytes / 4); idx += kThreads) {
        const int mm = idx / (kGBytes / 4), wd = idx % (kGBytes / 4);
        reinterpret_cast<uint32_t*>(by_s + mm * kRow)[wd] = src[static_cast<size_t>(mm) * (a.B / 4) + wd];
    }
    for (int mm = tid; mm < m; mm += kThreads) {
        const float sc = a.scale[b * m + mm];
        sc_s[mm] = sc;
        of_s[mm] = a.shift[b * m + mm] * sc;
    }

    for (int c = 0; c < a.C; ++c) {
        const size_t bc = static_cast<size_t>(b) * a.C + c;
        const float* q = a.w + bc * P;

        // ---- chain c's live weights, zero-padded to KM
        for (int idx = tid; idx < m * KM; idx += kThreads) {
            const int mm = idx / KM, kk = idx % KM;
            w0_s[idx] = kk < kl ? __ldcg(q + mm * k0 + kk) : 0.f;
        }
        if (tid < KM) {
            b0_s[tid] = tid < kl ? __ldcg(q + off_db0 + tid) : 0.f;
            wo_s[tid] = tid < sl ? __ldcg(q + off_wo + tid) : 0.f;
            if (DEEP) b1_s[tid] = tid < s ? __ldcg(q + off_b1 + tid) : 0.f;
        }
        if (DEEP) {
            for (int idx = tid; idx < KM * KM; idx += kThreads) {
                const int kk = idx / KM, ss = idx % KM;
                w1_s[idx] = (kk < k0 && ss < s) ? __ldcg(q + off_w1 + kk * s + ss) : 0.f;
            }
        }
        __syncthreads();

        // ---- layer 0 forward for the thread's four individuals
        float acc[4][KM];
#pragma unroll
        for (int qq = 0; qq < 4; ++qq)
#pragma unroll
            for (int k = 0; k < KM; ++k) acc[qq][k] = 0.f;
        for (int mm = 0; mm < m; ++mm) {
            const uint32_t byte = by_s[mm * kRow + tid];
            const float sc = sc_s[mm], of = of_s[mm];
            float x[4];
#pragma unroll
            for (int qq = 0; qq < 4; ++qq) x[qq] = fmaf(decode_part(byte, qq), sc, -of);
            const float4* w4 = reinterpret_cast<const float4*>(w0_s + mm * KM);
#pragma unroll
            for (int v = 0; v < KM / 4; ++v) {
                const float4 w = w4[v];
#pragma unroll
                for (int qq = 0; qq < 4; ++qq) {
                    acc[qq][4 * v + 0] = fmaf(x[qq], w.x, acc[qq][4 * v + 0]);
                    acc[qq][4 * v + 1] = fmaf(x[qq], w.y, acc[qq][4 * v + 1]);
                    acc[qq][4 * v + 2] = fmaf(x[qq], w.z, acc[qq][4 * v + 2]);
                    acc[qq][4 * v + 3] = fmaf(x[qq], w.w, acc[qq][4 * v + 3]);
                }
            }
        }

        // ---- rest of the forward, error and backward, one individual at a time
        const float* t_bc = a.target + bc * a.n;
        float dwo[KM], db0p[KM], db1p[KM];
#pragma unroll
        for (int k = 0; k < KM; ++k) dwo[k] = db0p[k] = db1p[k] = 0.f;
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
            const int row = qq * kGBytes + tid;
            const int i = grp * kGroup + row;
            const bool valid = i < a.n;
            float z0[KM], a0[KM], dz0[KM];
#pragma unroll
            for (int k = 0; k < KM; ++k) {
                z0[k] = acc[qq][k] + b0_s[k];
                a0[k] = act_apply(a.act, z0[k]);
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
                    a1[ss] = act_apply(a.act, z);
                    pred = fmaf(wo_s[ss], a1[ss], pred);
                }
                const float err = valid ? pred - t_bc[i] : 0.f;
#pragma unroll
                for (int ss = 0; ss < KM; ++ss) {
                    dwo[ss] = fmaf(a1[ss], err, dwo[ss]);
                    dz1[ss] = wo_s[ss] * err * act_prime(a.act, z1[ss], a1[ss]);
                    db1p[ss] += dz1[ss];
                }
#pragma unroll
                for (int k = 0; k < KM; ++k) {
                    float da = 0.f;
#pragma unroll
                    for (int ss = 0; ss < KM; ++ss) da = fmaf(w1_s[k * KM + ss], dz1[ss], da);
                    dz0[k] = da * act_prime(a.act, z0[k], a0[k]);
                    db0p[k] += dz0[k];
                }
                store_row<KM>(a0_s + row * RS, a0);
                store_row<KM>(dz1_s + row * RS, dz1);
            } else {
#pragma unroll
                for (int k = 0; k < KM; ++k) pred = fmaf(wo_s[k], a0[k], pred);
                const float err = valid ? pred - t_bc[i] : 0.f;
#pragma unroll
                for (int k = 0; k < KM; ++k) {
                    dwo[k] = fmaf(a0[k], err, dwo[k]);
                    dz0[k] = wo_s[k] * err * act_prime(a.act, z0[k], a0[k]);
                    db0p[k] += dz0[k];
                }
            }
            store_row<KM>(dz0_s + row * RS, dz0);
        }
        __syncthreads();

        float* part = a.partial + (bc * ngrp + grp) * P;

        // ---- small sums over the block
        block_sum<KM>(db0p, red_s, part + off_db0, kl);
        block_sum<KM>(dwo, red_s, part + off_wo, sl);
        if (DEEP) block_sum<KM>(db1p, red_s, part + off_b1, s);

        // ---- dW0[mm, :] = sum over the group's 512 individuals of x[mm, i] * dz0[i, :]
        for (int mm = tid; mm < m; mm += kThreads) {
            float acc2[KM];
#pragma unroll
            for (int k = 0; k < KM; ++k) acc2[k] = 0.f;
            const float sc = sc_s[mm], of = of_s[mm];
            const uint32_t* brow = reinterpret_cast<const uint32_t*>(by_s + mm * kRow);
            for (int c4 = 0; c4 < kGBytes / 4; ++c4) {
                const uint32_t word = brow[c4];
#pragma unroll
                for (int bb = 0; bb < 4; ++bb) {
                    const uint32_t byte = (word >> (8 * bb)) & 0xffu;
                    const int col = 4 * c4 + bb;
#pragma unroll
                    for (int qq = 0; qq < 4; ++qq) {
                        const float x = fmaf(decode_part(byte, qq), sc, -of);
                        const float4* d4 = reinterpret_cast<const float4*>(dz0_s + (qq * kGBytes + col) * RS);
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
#pragma unroll
            for (int k = 0; k < KM; ++k)
                if (k < kl) part[mm * k0 + k] = acc2[k];
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
        __syncthreads();  // chain c + 1 restages the weights and reuses dz0_s
    }
}

template <int KM, bool DEEP>
__global__ void __launch_bounds__(kThreads) traj_packed_kernel(Args a) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    cg::grid_group grid = cg::this_grid();
    const int ngrp = a.B / kGBytes;
    const long long items = static_cast<long long>(a.nb) * ngrp;
    const long long total = static_cast<long long>(a.nb) * a.C * a.P;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;

    // step 0 only evaluates the initial gradient; steps 1..L integrate
    for (int l = 0; l <= a.steps; ++l) {
        for (long long it = blockIdx.x; it < items; it += gridDim.x)
            gradient_item<KM, DEEP>(a, smem, static_cast<int>(it / ngrp), static_cast<int>(it % ngrp));
        grid.sync();

        for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
             e += stride) {
            // depth 0: W0 [m, k0], b0 [k0] and w_out [k0] are rows of k0 (P
            // a multiple of k0), so a coordinate's layer-0 column is its
            // index mod k0; a dead one has no partials and stays as it is
            if (!DEEP && static_cast<int>(e % a.k0) >= a.k_live) continue;
            const long long bc = e / a.P;
            const float* src = a.partial + bc * ngrp * a.P + e % a.P;
            float sum = 0.f;
            for (int gg = 0; gg < ngrp; ++gg) sum += __ldcg(src + static_cast<size_t>(gg) * a.P);
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
int launch(Args a, cudaStream_t stream) {
    auto kern = traj_packed_kernel<KM, DEEP>;
    const size_t smem = smem_bytes(a.m, KM, DEEP);
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

// Shared memory K5 needs at these (padded) widths, or -1 if it cannot run
// them. A block's live width never needs more.
extern "C" long long traj_packed_smem(int m, int k0, int s, int depth) {
    const int km = pick_km(k0, s);
    if (km < 0 || depth < 0 || depth > 1) return -1;
    const size_t smem = smem_bytes(m, km, depth == 1);
    return smem > static_cast<size_t>(kMaxSmem) ? -1 : static_cast<long long>(smem);
}

// The register width K5 computes with: at depth 0 the smallest of
// {8, 12, 16, 24, 32} holding k_live, at depth 1 pick_km(k0, s); -1 if
// it cannot run these widths.
extern "C" int traj_packed_km(int k0, int s, int k_live, int depth) {
    if (pick_km(k0, s) < 0 || depth < 0 || depth > 1) return -1;
    if (depth == 1) return k_live == k0 ? pick_km(k0, s) : -1;
    return s == k0 && k_live >= 0 && k_live <= k0 ? live_km(k_live) : -1;
}

// bytes u8 [nb, m, B]; scale, shift f32 [nb, m]; target f32 [nb, C, n];
// err f32 [nb, C]; eps, lam f32 [nb, C, P]; w, pw f32 [nb, C, P], the start
// on entry and the end of the trajectory on return; partial f32
// [nb, C, B / 128, P] scratch. The flat layout is W0 [m, k0], b0 [k0],
// (W1 [k0, s], b1 [s]), w_out [s]. k_live: the layer-0 columns [0, k_live)
// are integrated, the rest left as they are (depth 0; k0 at depth 1).
extern "C" int traj_packed_f32(const void* bytes, const void* scale, const void* shift,
                               const void* target, const void* err, const void* eps,
                               const void* lam, void* w, void* pw, void* partial, int nb, int C,
                               int m, int B, int n, int k0, int k_live, int s, int P, int depth,
                               int steps, int act, int l1, void* stream) {
    const int km = traj_packed_km(k0, s, k_live, depth);
    const bool deep = depth == 1;
    if (km < 0 || P != partial_size(m, k0, s, deep) || steps < 0 ||
        traj_packed_smem(m, k0, s, depth) < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    Args a{static_cast<const uint8_t*>(bytes), static_cast<const float*>(scale),
           static_cast<const float*>(shift),   static_cast<const float*>(target),
           static_cast<const float*>(err),     static_cast<const float*>(eps),
           static_cast<const float*>(lam),     static_cast<float*>(w),
           static_cast<float*>(pw),            static_cast<float*>(partial),
           nb, C, m, B, n, k0, s, P, steps, act, l1, k_live};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (deep) {
        if (km == 8) return launch<8, true>(a, st);
        if (km == 16) return launch<16, true>(a, st);
        return launch<32, true>(a, st);
    }
    if (km == 8) return launch<8, false>(a, st);
    if (km == 12) return launch<12, false>(a, st);
    if (km == 16) return launch<16, false>(a, st);
    if (km == 24) return launch<24, false>(a, st);
    return launch<32, false>(a, st);
}
