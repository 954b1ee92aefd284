// The packed branch MLP at any depth and at padded widths up to 64: the
// device code K4 (branch_vg_packed.cu, one branch's value and gradient)
// and K5 (traj_packed.cu, a block's whole trajectory) share for every
// packed shape their depth-0 designs do not take (depth >= 1, or depth 0
// at a padded width of 33-64).
//
// Replaces, for those shapes, the body of rs_bann_tpu/ops/branch_mlp.py
// ``_mlp_chunk`` (its loop over the hidden layers) inside K4's
// ``_blocked_packed_kernel`` and K5's ``_traj_kernel_packed``.
//
// For one chain of one branch, per tile of 64 individuals (16 byte
// columns of a group, all four parts), with D = depth hidden layers:
//
//     z0 = X^T W0' + off            (W0' = w_scale * W0, off = b0 - shift . W0')
//     z_l = act(z_{l-1}) W_l + b_l   l = 1 .. D   (W_D is h x s, the others h x h)
//     pred = act(z_D) . w_out,  err = pred - target (0 past n)
//     dz_D = w_out * err * act'(z_D),  dz_{l-1} = (W_l dz_l) * act'(z_{l-1})
//
// and adds the tile's share of d(rss/2)/d(W_l, b_l, w_out) and of dW0' = X
// dz0, d_off = sum dz0 to the chain's partial row in global memory.
//
// What bounds it on the H100: operations. At the slice's branch (m_pad 104,
// h = s = 56, D = 2) an individual costs 2 x 104 x 56 FMAs in layer 0
// (forward and dW0') and 3 x 56 x 56 per hidden layer (forward, dW_l and
// the backward product): about 6.1 GFLOP per chain and evaluation at n =
// 100,000, 91 us at the 67 TFLOP/s f32 peak, against 2.6 MB of bytes.
//
// Design, a simple kernel that is right first:
//  * Layer 0 on bf16 tensor cores with the genotype the exact operand and
//    W0' (forward) or dz0 (gradient) in K2's exact three-part split joined
//    by round-to-nearest f32 adds (packed_mma.cuh mma_split3_add), the
//    fragment code of K4's depth-0 kernel on a tile of 16 byte columns:
//    CTAs of 8 warps, warp w computing part w % 4's 16 pre-activations of
//    every other column tile of 8; the gradient's marker tiles go to the
//    warps in turn, 4 k-steps of 16 individuals.
//  * The hidden layers on f32 CUDA cores: thread (individual, part) holds
//    its individual's input row in registers and computes a quarter of the
//    layer's outputs (a half at KM = 8), four at a time, from the
//    transposed weights W_l^T read as broadcast float4s; the backward
//    product the same way from the same rows. The tile's z_l stay in shared
//    memory ([D + 1] rows of 64), each overwritten by dz_l on the way back,
//    with one more row for act(z), which each thread applies to its own
//    columns once (applied by every thread to the whole row, tanh had cost
//    more than the layer's FMAs: 881 against 615 ms a K5 call at the
//    slice's block, PERF.md).
//  * dW_l = act(z_{l-1})^T dz_l and the bias sums over the tile: each
//    thread owns a block of KB x KB outputs and sums the tile's 64
//    individuals in order.
//  * Sums: no float atomics. Every output of a partial row has one owner
//    thread, which stores it on the row's first tile and adds each later
//    tile in tile order (through L2, every earlier sum loaded before any
//    store, so the loads overlap), so a row holds the CTA's sums in a fixed
//    order and the same inputs give the same bits.
//  * Depth is a run-time loop; the width class KM (8, 16, 32, 64) is the
//    only template parameter, and the activation a run-time code (applied
//    KM times per individual and layer against KM x KM FMAs): 4
//    instantiations each of K4's pass and of K5.
//  * The hidden layers, the output and their gradients (``hidden_pass``)
//    and the staging of w_out and W_l (``stage_layers``) are shared with
//    the dense deep design (dense_deep.cuh), which puts its own layer 0
//    (3xTF32 on f32 X) around them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "packed_decode.cuh"
#include "packed_mma.cuh"

namespace rsbann {
namespace deep {

constexpr int kThreads = 256;               // 8 warps; warp w is part w % 4 in the forward
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 16;               // byte columns per tile
constexpr int kTile = 4 * kTileCols;        // individuals per tile
constexpr int kTileStride = kTileCols;      // bytes per marker row of a staged byte tile
constexpr int kDzs = 2 * kTileCols + 2;     // words per column of a dz0 plane
constexpr int kTilesPerGroup = kGBytes / kTileCols;
constexpr int kMaxSmem = 232448;            // dynamic shared memory a block may use

// The packed rules' width class: 8, 16, 32 or 64, -1 above 64.
__host__ __device__ inline int pick_km64(int k0, int s) {
    const int w = k0 > s ? k0 : s;
    if (w <= 8) return 8;
    if (w <= 16) return 16;
    if (w <= 32) return 32;
    return w <= 64 ? 64 : -1;
}

__host__ __device__ constexpr int row_stride(int km) { return km + 4; }

// bf16 per W0' plane row: an odd number of 32-byte units (as K2, K4).
__host__ __device__ inline int weight_stride(int m16) { return ((m16 / 16) & 1) ? m16 : m16 + 16; }

// Floats of one chain's staged f32 weights: off, w_out, then per hidden
// layer W_l^T [KM][KM] and b_l [KM].
__host__ __device__ inline int chain_floats(int km, int depth) {
    return 2 * km + depth * (km * km + km);
}

// Byte offsets of a CTA's shared memory for chunks of cc chains.
struct Layout {
    long long tiles, w0, wf, buf, dz, small, total;
};

__host__ __device__ inline Layout layout(int m, int km, int depth, int cc) {
    const long long m16 = (m + 15) & ~15;
    Layout L;
    L.tiles = 8LL * kThreads;                                   // after the fold's f64 slices
    L.w0 = L.tiles + 2 * m16 * kTileStride;                     // two byte tiles
    L.wf = L.w0 + 6LL * cc * km * weight_stride(static_cast<int>(m16));  // bf16 [cc][3][km][ws]
    L.buf = L.wf + 4LL * cc * chain_floats(km, depth);          // f32 [cc][chain_floats]
    L.dz = L.buf + 4LL * (depth + 2) * kTile * row_stride(km);  // f32 [depth + 2][64][rs]
    L.small = L.dz + 12LL * km * kDzs;                          // u32 [3][km][kDzs]
    L.total = L.small + 4LL * (5 * kTile + kWarps);             // pred parts, err, warp sums
    return L;
}

// Shared memory of one CTA, or -1 past 227 KB (or a width above 64).
inline long long smem(int m, int k0, int s, int depth, int cc) {
    const int km = pick_km64(k0, s);
    if (km < 0 || m <= 0 || depth < 0 || cc < 1) return -1;
    const long long t = layout(m, km, depth, cc).total;
    return t <= kMaxSmem ? t : -1;
}

// One branch's shape and its flat layout W0 [m, k0], b0 [k0], per hidden
// layer l = 1 .. D W_l [k0, out_l], b_l [out_l] (out_l = k0 for l < D, s
// for l = D), w_out [s]; at depth 0 k0 == s.
struct Shape {
    int m, m16, wstride, k0, s, depth, P, n, B, tiles, act;
};

__host__ __device__ inline int layer_out(const Shape& sh, int l) { return l < sh.depth ? sh.k0 : sh.s; }

// Offset of W_l (l >= 1) in the flat layout; b_l follows it.
__host__ __device__ inline int layer_off(const Shape& sh, int l) {
    return sh.m * sh.k0 + sh.k0 + (l - 1) * (sh.k0 * sh.k0 + sh.k0);
}

__host__ __device__ inline int flat_size(int m, int k0, int s, int depth) {
    return depth == 0 ? m * k0 + 2 * k0
                      : m * k0 + k0 + (depth - 1) * (k0 * k0 + k0) + k0 * s + s + s;
}

// Tiles of 16 byte columns that hold an individual below n.
__host__ __device__ inline int tiles_of(int n) {
    const int full = n / kGroup, rem = n % kGroup, last = rem < kGBytes ? rem : kGBytes;
    return kTilesPerGroup * full + (last + kTileCols - 1) / kTileCols;
}

inline Shape make_shape(int m, int k0, int s, int depth, int n, int B, int act) {
    Shape sh;
    sh.m = m;
    sh.m16 = (m + 15) & ~15;
    sh.wstride = weight_stride(sh.m16);
    sh.k0 = k0;
    sh.s = s;
    sh.depth = depth;
    sh.P = flat_size(m, k0, s, depth);
    sh.n = n;
    sh.B = B;
    sh.tiles = tiles_of(n);
    sh.act = act;
    return sh;
}

// Pointers into a CTA's shared memory.
struct Smem {
    double* fold;
    uint8_t* tiles;
    __nv_bfloat16* w0;
    float* wf;
    float* buf;
    uint32_t* dz;
    float* small;
};

__device__ inline Smem carve(void* base, const Shape& sh, int km, int cc) {
    const Layout L = layout(sh.m, km, sh.depth, cc);
    char* p = static_cast<char*>(base);
    return {reinterpret_cast<double*>(p), reinterpret_cast<uint8_t*>(p + L.tiles),
            reinterpret_cast<__nv_bfloat16*>(p + L.w0), reinterpret_cast<float*>(p + L.wf),
            reinterpret_cast<float*>(p + L.buf), reinterpret_cast<uint32_t*>(p + L.dz),
            reinterpret_cast<float*>(p + L.small)};
}

// The byte columns of tile t into a staged tile (rows past m zero): one
// 16-byte cp.async per marker row.
__device__ inline void load_tile(const Shape& sh, const uint8_t* bytes, int t, uint8_t* dst) {
    const uint8_t* src = bytes + static_cast<size_t>(t) * kTileCols;
    for (int row = threadIdx.x; row < sh.m16; row += kThreads) {
        const bool real = row < sh.m;
        cp_async16(dst + row * kTileStride, src + (real ? static_cast<size_t>(row) * sh.B : 0),
                   real ? 16 : 0);
    }
    cp_async_commit();
}

// *p = v on a row's first tile, else *p += v; through L2, since in K5 other
// CTAs read the rows after a grid barrier.
__device__ __forceinline__ void accum(float* p, float v, bool first) {
    __stcg(p, first ? v : __ldcg(p) + v);
}

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[N]) {
    if constexpr (N % 4 == 0) {
#pragma unroll
        for (int u = 0; u < N / 4; ++u) {
            const float4 f = reinterpret_cast<const float4*>(p)[u];
            v[4 * u] = f.x;
            v[4 * u + 1] = f.y;
            v[4 * u + 2] = f.z;
            v[4 * u + 3] = f.w;
        }
    } else if constexpr (N == 2) {
        const float2 f = *reinterpret_cast<const float2*>(p);
        v[0] = f.x;
        v[1] = f.y;
    } else {
#pragma unroll
        for (int u = 0; u < N; ++u) v[u] = p[u];
    }
}

// w_out and each hidden layer's W_l^T and b_l of one chain's flat vector q
// into wf_s (after its first KM floats), zero-padded to KM, read through
// L2. No barrier. Shared with the dense deep design (dense_deep.cuh).
template <int KM>
__device__ void stage_layers(const Shape& sh, const float* q, float* wf_s) {
    const int tid = threadIdx.x;
    float* wo_s = wf_s + KM;
    for (int j = tid; j < KM; j += kThreads)
        wo_s[j] = j < sh.s ? __ldcg(q + sh.P - sh.s + j) : 0.f;
    for (int l = 1; l <= sh.depth; ++l) {
        const int out = layer_out(sh, l), off = layer_off(sh, l);
        float* wt = wf_s + 2 * KM + (l - 1) * (KM * KM + KM);
        for (int idx = tid; idx < KM * KM; idx += kThreads) {
            const int k = idx / KM, j = idx - k * KM;  // W_l[k][j], read along j
            wt[j * KM + k] = (k < sh.k0 && j < out) ? __ldcg(q + off + k * out + j) : 0.f;
        }
        for (int j = tid; j < KM; j += kThreads)
            wt[KM * KM + j] = j < out ? __ldcg(q + off + sh.k0 * out + j) : 0.f;
    }
}

// Stage one chain's weights from its flat vector q (read through L2: K5
// rewrites it between steps): W0' = scale * W0 as three bf16 planes
// [column][marker position] (K2's layout), off = b0 - shift . W0' (summed
// in f64 in a fixed order, rounded once), w_out, and each hidden layer's
// W_l^T and b_l, zero-padded to KM. Ends with a barrier.
template <int KM>
__device__ void stage_chain(const Shape& sh, const float* q, const float* scale,
                            const float* shift, __nv_bfloat16* w_s, float* wf_s, double* fold_s) {
    constexpr int kBatch = 8;
    constexpr int S = kThreads / KM;  // marker slices of the fold
    const int tid = threadIdx.x;
    const int plane = KM * sh.wstride;
    const int total = sh.m16 * KM;
    for (int base = 0; base < total; base += kThreads * kBatch) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int idx = base + u * kThreads + tid;
            const int mk = idx / KM, c = idx - mk * KM;
            v[u] = (mk < sh.m && c < sh.k0) ? __ldg(scale + mk) * __ldcg(q + mk * sh.k0 + c) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int idx = base + u * kThreads + tid;
            if (idx >= total) break;
            const int mk = idx / KM, c = idx - mk * KM;
            __nv_bfloat16 hi, mid, lo;
            split3(v[u], hi, mid, lo);
            const int at = c * sh.wstride + (mk & ~15) + k_position(mk & 15);
            w_s[at] = hi;
            w_s[plane + at] = mid;
            w_s[2 * plane + at] = lo;
        }
    }
    {  // thread (c, sl) sums markers sl, sl + S, ... of column c in order, in f64
        const int c = tid % KM, sl = tid / KM;
        double acc = 0.0;
        if (c < sh.k0) {
            for (int mk = sl; mk < sh.m; mk += S) {
                const float b = __ldg(scale + mk) * __ldcg(q + mk * sh.k0 + c);
                acc = fma(static_cast<double>(__ldg(shift + mk)), static_cast<double>(b), acc);
            }
        }
        fold_s[tid] = acc;
    }
    stage_layers<KM>(sh, q, wf_s);
    __syncthreads();
    if (tid < KM) {
        double acc = 0.0;
#pragma unroll
        for (int sl = 0; sl < S; ++sl) acc += fold_s[sl * KM + tid];
        wf_s[tid] = tid < sh.k0
                        ? static_cast<float>(static_cast<double>(__ldcg(q + sh.m * sh.k0 + tid)) - acc)
                        : 0.f;
    }
    __syncthreads();
}

// dW_l[k][j] += sum over the tile of A[i][k] dz[i][j] (k < in, j < out), and
// db_l[j] += sum dz[i][j]: thread (kb, jb) owns KB x JB outputs and adds the
// 64 individuals in order. No barrier inside.
template <int KM>
__device__ void reduce_layer(const float* A, const float* DZ, float* pw, float* pb, int in,
                             int out, bool first) {
    constexpr int RS = row_stride(KM);
    constexpr int KB = KM >= 64 ? 4 : (KM >= 32 ? 2 : 1);
    constexpr int JB = KB;  // KM^2 / kThreads outputs a thread (64 threads at KM = 8)
    constexpr int NJ = KM / JB, NK = KM / KB;
    const int tid = threadIdx.x;
    if (tid >= NK * NJ) return;
    const int kb = (tid / NJ) * KB, jb = (tid % NJ) * JB;
    float acc[KB][JB], bsum[JB];
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) {
        bsum[jj] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) acc[kk][jj] = 0.f;
    }
#pragma unroll 4
    for (int ii = 0; ii < kTile; ++ii) {
        float a[KB], d[JB];
        load_vec<KB>(A + ii * RS + kb, a);
        load_vec<JB>(DZ + ii * RS + jb, d);
#pragma unroll
        for (int jj = 0; jj < JB; ++jj) {
            bsum[jj] += d[jj];
#pragma unroll
            for (int kk = 0; kk < KB; ++kk) acc[kk][jj] = fmaf(a[kk], d[jj], acc[kk][jj]);
        }
    }
    // the row's earlier sums all loaded before any store, so the loads
    // overlap (a store between them would order each after the last)
    if (!first) {
#pragma unroll
        for (int kk = 0; kk < KB; ++kk)
#pragma unroll
            for (int jj = 0; jj < JB; ++jj)
                if (kb + kk < in && jb + jj < out) acc[kk][jj] += __ldcg(pw + (kb + kk) * out + jb + jj);
#pragma unroll
        for (int jj = 0; jj < JB; ++jj)
            if (kb == 0 && jb + jj < out) bsum[jj] += __ldcg(pb + jb + jj);
    }
#pragma unroll
    for (int kk = 0; kk < KB; ++kk)
#pragma unroll
        for (int jj = 0; jj < JB; ++jj)
            if (kb + kk < in && jb + jj < out) __stcg(pw + (kb + kk) * out + jb + jj, acc[kk][jj]);
#pragma unroll
    for (int jj = 0; jj < JB; ++jj)
        if (kb == 0 && jb + jj < out) __stcg(pb + jb + jj, bsum[jj]);
}

// act on four values
__device__ __forceinline__ float4 act4(int act, float4 z) {
    return make_float4(act_apply(act, z.x), act_apply(act, z.y), act_apply(act, z.z),
                       act_apply(act, z.w));
}

// Layers 1 .. D and the output of one chain on a tile whose z0 rows (tile
// row il: the tile's individual il, its index i, ``valid`` if below n) are
// in sm.buf: the hidden layers' forward, pred and err; with GRAD the
// backward to dz0 (in place of z0), with the gradient sums of w_out and
// of every hidden layer added to ``part`` (stored on its first tile).
// With y_pred the predictions of the tile's valid individuals are written
// (and, with GRAD, err^2 added to e2 by the threads of the first part).
// Starts after a barrier that made z0 visible; ends with a barrier. The
// packed design's tile_chain and the dense one's (dense_deep.cuh) run it.
template <int KM, bool GRAD>
__device__ void hidden_pass(const Shape& sh, const float* wf_s, const Smem& sm, int i, bool valid,
                            const float* target, float* y_pred, float* part, bool first,
                            float& e2) {
    // the hidden layers' columns go to NH threads an individual, H each
    constexpr int NH = KM >= 16 ? kThreads / kTile : 2, H = KM / NH;
    constexpr int RS = row_stride(KM), BUF = kTile * RS;
    const int tid = threadIdx.x;
    const int D = sh.depth, act = sh.act;
    const float* wo_s = wf_s + KM;
    float* Z0 = sm.buf;
    float* AB = sm.buf + (D + 1) * BUF;
    float* pred_s = sm.small;              // [NH][64]
    float* err_s = sm.small + 4 * kTile;   // [64]
    // thread (individual il, part hf < NH): the thread's columns j0 .. j0 + H - 1
    const int il = tid & (kTile - 1), hf = tid / kTile, j0 = hf * H;
    const bool mine = hf < NH;

    // ---- 2. the hidden layers' forward: z_l = act(z_{l-1}) W_l + b_l, each
    // thread applying act to its own columns of the row (into AB) first
    for (int l = 1; l <= D; ++l) {
        if (mine) {
#pragma unroll
            for (int jj = 0; jj < H; jj += 4)
                *reinterpret_cast<float4*>(AB + il * RS + j0 + jj) = act4(
                    act, *reinterpret_cast<const float4*>(Z0 + (l - 1) * BUF + il * RS + j0 + jj));
        }
        __syncthreads();
        if (!mine) {
            __syncthreads();
            continue;
        }
        float a[KM];
#pragma unroll
        for (int v = 0; v < KM / 4; ++v) {
            const float4 a4 = reinterpret_cast<const float4*>(AB + il * RS)[v];
            a[4 * v] = a4.x;
            a[4 * v + 1] = a4.y;
            a[4 * v + 2] = a4.z;
            a[4 * v + 3] = a4.w;
        }
        const float* wt = wf_s + 2 * KM + (l - 1) * (KM * KM + KM);
        float* zout = Z0 + l * BUF + il * RS;
#pragma unroll 1
        for (int jj = j0; jj < j0 + H; jj += 4) {
            float z[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                z[u] = wt[KM * KM + jj + u];
                const float4* w4 = reinterpret_cast<const float4*>(wt + (jj + u) * KM);
#pragma unroll
                for (int v = 0; v < KM / 4; ++v) {
                    const float4 w = w4[v];
                    z[u] = fmaf(a[4 * v], w.x, z[u]);
                    z[u] = fmaf(a[4 * v + 1], w.y, z[u]);
                    z[u] = fmaf(a[4 * v + 2], w.z, z[u]);
                    z[u] = fmaf(a[4 * v + 3], w.w, z[u]);
                }
            }
            *reinterpret_cast<float4*>(zout + jj) = make_float4(z[0], z[1], z[2], z[3]);
        }
        __syncthreads();
    }

    // ---- 3. the output: pred, err, dz_D (in place of z_D), dW_out
    float* zd = Z0 + D * BUF + il * RS;
    if (mine) {
        float pp = 0.f;
#pragma unroll
        for (int jj = 0; jj < H; jj += 4) {
            const float4 a4 = act4(act, *reinterpret_cast<const float4*>(zd + j0 + jj));
            *reinterpret_cast<float4*>(AB + il * RS + j0 + jj) = a4;
            pp = fmaf(wo_s[j0 + jj], a4.x, pp);
            pp = fmaf(wo_s[j0 + jj + 1], a4.y, pp);
            pp = fmaf(wo_s[j0 + jj + 2], a4.z, pp);
            pp = fmaf(wo_s[j0 + jj + 3], a4.w, pp);
        }
        pred_s[hf * kTile + il] = pp;
    }
    __syncthreads();
    if constexpr (!GRAD) {
        if (mine && hf == 0 && valid && y_pred) {
            float pred = pred_s[il];
#pragma unroll
            for (int p = 1; p < NH; ++p) pred += pred_s[p * kTile + il];
            y_pred[i] = pred;
        }
        __syncthreads();
        return;
    }
    if (mine) {
        float pred = pred_s[il];
#pragma unroll
        for (int p = 1; p < NH; ++p) pred += pred_s[p * kTile + il];
        const float err = valid ? pred - target[i] : 0.f;
        if (hf == 0) {
            err_s[il] = err;
            if (valid && y_pred) {
                y_pred[i] = pred;
                e2 = fmaf(err, err, e2);
            }
        }
#pragma unroll
        for (int jj = 0; jj < H; ++jj) {
            const int j = j0 + jj;
            zd[j] = wo_s[j] * err * act_prime(act, zd[j], AB[il * RS + j]);
        }
    }
    __syncthreads();
    if (tid < sh.s) {
        float sum = 0.f;
        for (int ii = 0; ii < kTile; ++ii) sum = fmaf(AB[ii * RS + tid], err_s[ii], sum);
        accum(part + sh.P - sh.s + tid, sum, first);
    }
    __syncthreads();

    // ---- 4. the hidden layers' backward, l = D .. 1: dz_l in Z[l]; act(z_{l-1})
    // in AB; dW_l and db_l over the tile while each thread forms its part of
    // dz_{l-1} = (W_l dz_l) * act'(z_{l-1}) in place of z_{l-1}
    for (int l = D; l >= 1; --l) {
        float* zp = Z0 + (l - 1) * BUF;
        const float* dz = Z0 + l * BUF;
        if (mine) {
#pragma unroll
            for (int jj = 0; jj < H; jj += 4)
                *reinterpret_cast<float4*>(AB + il * RS + j0 + jj) =
                    act4(act, *reinterpret_cast<const float4*>(zp + il * RS + j0 + jj));
        }
        __syncthreads();
        const int off = layer_off(sh, l), out = layer_out(sh, l);
        reduce_layer<KM>(AB, dz, part + off, part + off + sh.k0 * out, sh.k0, out, first);
        if (!mine) {
            __syncthreads();
            continue;
        }
        const float* wt = wf_s + 2 * KM + (l - 1) * (KM * KM + KM);
        float da[H];
#pragma unroll
        for (int k = 0; k < H; ++k) da[k] = 0.f;
#pragma unroll 1
        for (int j = 0; j < KM; j += 4) {
            const float4 d4 = *reinterpret_cast<const float4*>(dz + il * RS + j);
            const float d[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const float4* w4 = reinterpret_cast<const float4*>(wt + (j + u) * KM + j0);
#pragma unroll
                for (int v = 0; v < H / 4; ++v) {
                    const float4 w = w4[v];
                    da[4 * v] = fmaf(d[u], w.x, da[4 * v]);
                    da[4 * v + 1] = fmaf(d[u], w.y, da[4 * v + 1]);
                    da[4 * v + 2] = fmaf(d[u], w.z, da[4 * v + 2]);
                    da[4 * v + 3] = fmaf(d[u], w.w, da[4 * v + 3]);
                }
            }
        }
#pragma unroll
        for (int k = 0; k < H; ++k) {
            float* zk = zp + il * RS + j0 + k;
            *zk = da[k] * act_prime(act, *zk, AB[il * RS + j0 + k]);
        }
        __syncthreads();
    }
}

// One chain on staged tile t (bytes in ``tile``, the chain's weights in
// w_s / wf_s): the forward, the backward and the tile's gradient sums added
// to the chain's partial row ``part`` (flat layout; stored on the row's
// first tile). With y_pred, the predictions of the tile's individuals below
// n are written and err^2 added to e2 (threads of the first part). Starts
// after a barrier that made the tile visible; ends with a barrier.
template <int KM>
__device__ void tile_chain(const Shape& sh, const uint8_t* tile, const __nv_bfloat16* w_s,
                           const float* wf_s, const Smem& sm, int t, const float* target,
                           float* y_pred, float* part, bool first, float& e2) {
    constexpr int NT = KM / 8, RS = row_stride(KM);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const float* off_s = wf_s;
    float* Z0 = sm.buf;

    // ---- 1. z0 = X^T W0' + off on the tensor cores: warp w is part w % 4,
    // column tiles of its parity w / 4; row r of the MMA is byte column 2 r,
    // row r + 8 byte column 2 r + 1
    {
        const int q = warp & 3, par = warp >> 2, r = lane >> 2, tig = lane & 3;
        float acc[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
        const uint8_t* bp = tile + tig * kTileStride + 2 * r;
        const __nv_bfloat16* wp = w_s + r * sh.wstride + 4 * tig;
        const int plane = KM * sh.wstride;
#pragma unroll 1
        for (int c = 0; c < sh.m16 / 16; ++c) {
            const uint8_t* b = bp + c * 16 * kTileStride;
            const uint32_t u0 = *reinterpret_cast<const uint16_t*>(b);
            const uint32_t u1 = *reinterpret_cast<const uint16_t*>(b + 4 * kTileStride);
            const uint32_t u2 = *reinterpret_cast<const uint16_t*>(b + 8 * kTileStride);
            const uint32_t u3 = *reinterpret_cast<const uint16_t*>(b + 12 * kTileStride);
            const uint32_t s01 = selectors(prmt(u0, u1, 0x5140u), q);
            const uint32_t s23 = selectors(prmt(u2, u3, 0x5140u), q);
            const uint32_t af[4] = {decode_pair(s01), decode_pair(s01 >> 16), decode_pair(s23),
                                    decode_pair(s23 >> 16)};
            const __nv_bfloat16* wc = wp + c * 16;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                if ((nt & 1) != par) continue;
                uint2 bw[3];
#pragma unroll
                for (int part3 = 0; part3 < 3; ++part3)
                    bw[part3] = *reinterpret_cast<const uint2*>(wc + part3 * plane + nt * 8 * sh.wstride);
                mma_split3_add(acc[nt], af, bw);
            }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            if ((nt & 1) != par) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int col = nt * 8 + 2 * tig;
                *reinterpret_cast<float2*>(Z0 + (q * kTileCols + 2 * r + h) * RS + col) =
                    make_float2(acc[nt][2 * h] + off_s[col], acc[nt][2 * h + 1] + off_s[col + 1]);
            }
        }
    }
    __syncthreads();

    // tile row il = q * 16 + c is part q of byte column c
    const int il = threadIdx.x & (kTile - 1);
    const int i = (t / kTilesPerGroup) * kGroup + (t % kTilesPerGroup) * kTileCols +
                  (il / kTileCols) * kGBytes + il % kTileCols;
    hidden_pass<KM, true>(sh, wf_s, sm, i, i < sh.n, target, y_pred, part, first, e2);

    // ---- 5. layer 0's gradient: dz0 (in Z0) to three bf16 planes in the
    // order of the MMA's B fragment, d_off, then dW0' = X dz0 on the tensor
    // cores: warp w takes marker tiles w, w + 8, ...
    for (int u = tid; u < KM * kTileCols; u += kThreads) {
        const int k = u % KM, c = u / KM;
        const float v[4] = {Z0[c * RS + k], Z0[(kTileCols + c) * RS + k],
                            Z0[(2 * kTileCols + c) * RS + k], Z0[(3 * kTileCols + c) * RS + k]};
        store_split3x4(sm.dz + k * kDzs + 2 * c, KM * kDzs, v);
    }
    if (tid < sh.k0) {
        float sum = 0.f;
        for (int ii = 0; ii < kTile; ++ii) sum += Z0[ii * RS + tid];
        accum(part + sh.m * sh.k0 + tid, sum, first);
    }
    __syncthreads();
    {
        const int r = lane >> 2, tig = lane & 3;
#pragma unroll 1
        for (int mt = warp; mt < sh.m16 / 16; mt += kWarps) {
            float g[NT][4];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) g[nt][e] = 0.f;
            const uint8_t* b = tile + (mt * 16 + r) * kTileStride + 4 * tig;
            const uint32_t wr = *reinterpret_cast<const uint32_t*>(b);
            const uint32_t wr8 = *reinterpret_cast<const uint32_t*>(b + 8 * kTileStride);
#pragma unroll
            for (int bb = 0; bb < 4; ++bb) {
                uint2 bf[NT][3];
                grad_b_frags<NT>(sm.dz + r * kDzs + 2 * (4 * tig + bb), kDzs, bf);
                uint32_t af[4];
                grad_a_frag(wr, wr8, bb, af);
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) mma_split3_add(g[nt], af, bf[nt]);
            }
            // element e of fragment nt: marker mt 16 + r + 8 (e / 2), column
            // nt 8 + 2 tig + e % 2; the earlier sums all loaded first
            auto at = [&](int nt, int e) -> float* {
                const int mk = mt * 16 + r + 8 * (e >> 1), col = nt * 8 + 2 * tig + (e & 1);
                return mk < sh.m && col < sh.k0 ? part + mk * sh.k0 + col : nullptr;
            };
            if (!first) {
#pragma unroll
                for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        if (float* p = at(nt, e)) g[nt][e] += __ldcg(p);
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (float* p = at(nt, e)) __stcg(p, g[nt][e]);
        }
    }
    __syncthreads();
}

// The sum of one float per thread over the CTA in a fixed order (warp
// butterflies, then the warps in order); every thread gets it. Uses
// red_s[kWarps].
__device__ inline float cta_sum(float v, float* red_s) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) red_s[threadIdx.x >> 5] = v;
    __syncthreads();
    float s = red_s[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red_s[w];
    __syncthreads();
    return s;
}

}  // namespace deep
}  // namespace rsbann
