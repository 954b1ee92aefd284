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
// rss = sum_{i<n} (f(x_i; q) - t[b,c,i])^2, with x_i = (g_i - mu) * scale the
// standardized genotype g_i in {0, 1, 2} decoded from the 2-bit bytes (K1).
// Padded markers have scale 0; padded coordinates carry zero momentum, so
// they never move. Every activation, any depth: depth 0 at padded widths up
// to 32 runs the design below, f32 throughout; every other shape (depth >=
// 1, or depth 0 at widths 33-64) the device code K4 shares,
// csrc/packed_deep.cuh (traj_deep_kernel, at the end of this file).
//
// What bounds it on the H100: per step and per 512-individual group the
// forward and the dW0 pass each cost m * KM * 512 FMAs per chain; at the
// hybrid slice's shape (B = 10 branches, C = 4 chains, m = 104, n = 100,352
// padded, width 10 stored at 16, KM = 12 live columns) that is ~2e10 FLOP a
// step against 26 MB of bytes read once a step for all four chains (held in
// the 50 MB L2 across steps), so f32 FMA issue bounds it, not device memory.
// Every instruction that is not an FMA (the decode, shared-memory loads,
// index arithmetic, barriers) takes a scheduler slot from the FMAs, and the
// register tiles that amortize them cost occupancy, so the depth-0 design
// below is about issuing FMAs from tiles that still leave 3 blocks (12
// warps) per SM. Measured there at L = 30 (scripts/bench_k5_torch.py, H100
// 80GB HBM3, 700 W power limit): 22.2 ms a launch, 35% of the f32 peak on
// the live work, against 34.0 ms for the one-chain-at-a-time design it
// replaces, in the same run (PERF.md section 6).
//
// The live columns. The JAX package pads every width to 8 sublanes, so a
// width of 10 is stored as 16. Every activation has act(0) = 0, so a
// column of zero weight and momentum adds nothing to a prediction, its
// gradient is zero and the leapfrog leaves it as it is. At depth 0 the
// wrapper passes the block's live width k_live (1 + the last column with a
// nonzero weight or momentum, or a step size or prior precision that is not
// finite) beside the storage width k0, and the kernel computes KM columns,
// the smallest of {8, 12, 16, 24, 32} that holds k_live (12 for width 10).
// It stages, multiplies and writes partial sums for live coordinates only,
// and the update phase leaves the dead ones untouched. The live columns'
// arithmetic does not depend on k0, so storing them at width k_live gives
// the same bits. The deep design computes every stored column (k_live = k0).
//
// Design:
//  * One cooperative launch per block transition (cudaLaunchCooperativeKernel,
//    grid = resident blocks per SM x SMs, so a grid sync cannot hang: an
//    oversize grid is refused at launch).
//  * Each leapfrog step has two phases separated by grid.sync():
//    1. gradient phase: each (item, chain) writes its partial sums of
//       d(rss/2)/d(q) to scratch;
//    2. update phase, one thread per (branch, chain, coordinate): the
//       partials are added in a fixed order (no float atomics, so the same
//       inputs give the same bits), then the prior gradient, err and the
//       momentum and position updates are applied in place.
//  * The state q, p lives in device memory as one flat vector per
//    (branch, chain) in K4's gradient layout (the flat layout); data written
//    inside the launch is read with __ldcg (L2, coherent across blocks).
//
// The depth-0 gradient phase (chunk_item). A work item is (branch, chunk
// of CC chains, group of 512 individuals); each block takes a contiguous
// run of items in that order, so it stages a chunk's weights once for many
// groups and each group's byte tile [m, 128] (cp.async) once per item. CC
// is a template parameter in {1, 2, 4}: the launch takes the largest one
// instantiated at KM that is at most C and whose shared memory fits (a
// chunk past C computes zeros and writes nothing), so C chains take
// ceil(C / CC) passes over a group's bytes, and one decoded genotype feeds
// the CC chains.
//  * Standardization folded out of the inner loops, as K2 and K4 do: the
//    chunk stages A_c = scale * W0_c for its CC chains side by side, [m][N]
//    with N = CC * KM, so that z0 = g^T A_c + (b0_c - shift^T A_c) on the raw
//    genotype g, and dW0_c = scale * (g dz0_c) - (shift * scale) (sum_i dz0_c),
//    whose last sum is the group's db0 partial. Padded markers have scale 0,
//    so their rows stay exactly 0; individuals past n have error 0, so their
//    dz0 is 0 whatever their bytes decode to.
//  * Decode without an int-to-float conversion (genotype): the 2-bit code
//    becomes a prmt selector that assembles the float's bits from two
//    constant tables; an and, a multiply-add and a permute.
//  * Forward: thread j owns byte column j (four individuals, one per part);
//    per marker it loads one byte, decodes each part once, and feeds each
//    decoded genotype to the N columns of the CC chains from broadcast
//    LDS.128s of A: a register tile of PH parts x N (PH = 4 up to N = 12,
//    else 2 in two halves, which leaves the rest of the item room under
//    the register cap below).
//  * Backward per individual and chain in registers, the activation
//    resolved once per item (a switch around the loops, not in them). Each
//    individual's targets wait at the end of its dz0 row (cp.async at the
//    item's start), so no register holds them through the forward. dz0 of
//    the CC chains side by side in shared memory, [4 parts][128][N], each
//    part shifted by 16 bytes so that the four parts' rows of a byte column
//    fall in distinct banks.
//  * The dW0 pass: lane (part q, slot) of warp w owns RM markers (4 up to
//    N = 24, else 2) of task r * 32 + w * 8 + slot and sums over
//    its part's 128 individuals: a register tile of RM x N, so each decoded
//    genotype feeds N FMAs and each LDS.128 of dz0 (one row, broadcast to
//    the eight lanes of a part) feeds 4 RM; the four parts' sums are added
//    by two xor shuffles in a fixed order.
//  * db0 and w_out sums: warp butterflies, then the four warps in order.
//  * The tiles are sized for 3 resident blocks per SM (168 registers, about
//    74 KB of shared memory at KM = 12, CC = 2): what an item derives from
//    threadIdx.x is computed in the item (thread_index), so that the
//    compiler does not keep it, hoisted, through the whole trajectory.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "packed_decode.cuh"
#include "packed_deep.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace rsbann;

constexpr int kThreads = kGBytes;  // one thread per byte column of a group
constexpr int kRow = kGBytes + 4;  // shared-memory row stride of the byte tile
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use

// Row stride (floats) of the shared-memory rule's per-individual rows
// (the first f32 layout): 12, 20, 20, 28, 36 for 8, 12, 16, 24, 32 columns.
__host__ __device__ constexpr int row_stride(int km) { return (km / 4) % 2 ? km + 8 : km + 4; }

// Floats from one part's dz0 rows (128 rows of N, unpadded) to the next's at
// depth 0: 16 bytes more than the rows, so that row j of the four parts
// lies in four distinct 16-byte bank groups.
__host__ __device__ constexpr int part_stride(int n) { return kGBytes * n + 4; }

// K5's register width for a depth-0 block of live width k_live.
inline int live_km(int k_live) {
    if (k_live <= 8) return 8;
    if (k_live <= 12) return 12;
    if (k_live <= 16) return 16;
    if (k_live <= 24) return 24;
    return k_live <= 32 ? 32 : -1;
}

// The rule traj_packed_smem reports at depth 0 and padded widths up to 32
// (the first f32 layout, kept): the depth-0 layout at one chain a chunk never
// needs more.
size_t smem_bytes0(int m, int km) {
    const size_t floats = static_cast<size_t>(kGroup) * row_stride(km) + static_cast<size_t>(m) * km +
                          km + km + 4 * km + 2 * static_cast<size_t>(m);
    return floats * sizeof(float) + static_cast<size_t>(m) * kRow;
}

// Shared memory of the depth-0 gradient phase at KM columns and chunks of
// CC chains (N = CC * KM): dz0 [4][128][N] with the parts 16 bytes apart,
// A [m][N], w_out, b0 and the group's db0 [N] each, the warp sums [4][2N],
// scale and shift [m], the byte tile [m][kRow]. At CC = 1 this is at most
// smem_bytes0(m, KM): the unpadded dz0 rows save at least 512 x 4
// floats, against 5 KM + 12 more elsewhere.
size_t smem_d0(int m, int km, int cc) {
    const int n = km * cc;
    const size_t floats = 4 * static_cast<size_t>(part_stride(n)) - 4 + static_cast<size_t>(m) * n +
                          11 * static_cast<size_t>(n) + 2 * static_cast<size_t>(m);
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
    float* partial;        // [nb, C, B / 128, P] scratch (the deep design's: its partial rows)
    int nb, C, m, B, n, k0, s, P, steps, act, l1;
    int k_live;            // layer-0 columns computed: [0, k_live) (k0 in the deep design)
};

// 4 bytes from global to shared memory without a register round trip, or 4
// zero bytes where !ok (src is then not read). Cached in L1: only for data
// that does not change during the launch.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok = true) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// threadIdx.x read afresh: what a depth-0 item derives from it is computed
// in the item, not hoisted out of the step loop and kept (and spilled) there.
__device__ __forceinline__ int thread_index() {
    int t;
    asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
    return t;
}

// The genotype of a 2-bit code c as a float, given sel = c * 0x1100 (the
// code at bits 8..9 and 12..13, from the caller's mask and multiply):
// selector sel + 0x0411's nibble 3 takes the float's top byte from
// 0x003f0040 (code 0 -> 0x40, 2 -> 0x3f, 1 and 3 -> 0), nibble 2 its next
// byte from 0x00800000 (code 2 -> 0x80), nibbles 1 and 0 a zero byte. Codes
// {00, 01, 10, 11} give {2, 0, 1, 0}, K1's value map, with no conversion.
__device__ __forceinline__ float genotype_sel(uint32_t sel) {
    // prmt itself: __byte_perm would add an and to clear each nibble's bit 3
    // (prmt's sign-replicate flag), which these selectors never set
    uint32_t bits;
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(bits) : "r"(0x003f0040u), "r"(0x00800000u), "r"(sel + 0x0411u));
    return __uint_as_float(bits);
}

// Part q (a compile-time constant once unrolled) of a byte: mask the code in
// place and scale it to c * 0x1100 (exact: 0x1100 is a multiple of 64).
__device__ __forceinline__ float genotype(uint32_t byte, int q) {
    return genotype_sel((byte & (3u << (2 * q))) * (0x1100u >> (2 * q)));
}

// Layer 0 forward of PH parts (h * PH ... h * PH + PH - 1) of the thread's
// byte column for a chunk's N = CC * KM columns: acc[p][t] = sum over the
// markers of g[mm, i_p] * A[mm, t].
template <int N, int PH>
__device__ __forceinline__ void forward_parts(const float* A_s, const uint8_t* by_s, int m, int h, int tid,
                                              float (&acc)[PH][N]) {
#pragma unroll
    for (int p = 0; p < PH; ++p)
#pragma unroll
        for (int t = 0; t < N; ++t) acc[p][t] = 0.f;
#pragma unroll 1
    for (int mm = 0; mm < m; ++mm) {
        const uint32_t byte = by_s[mm * kRow + tid];
        float g[PH];
#pragma unroll
        for (int p = 0; p < PH; ++p) g[p] = genotype(byte, h * PH + p);
        const float4* a4 = reinterpret_cast<const float4*>(A_s + mm * N);
#pragma unroll
        for (int v = 0; v < N / 4; ++v) {
            const float4 w = a4[v];
#pragma unroll
            for (int p = 0; p < PH; ++p) {
                acc[p][4 * v + 0] = fmaf(g[p], w.x, acc[p][4 * v + 0]);
                acc[p][4 * v + 1] = fmaf(g[p], w.y, acc[p][4 * v + 1]);
                acc[p][4 * v + 2] = fmaf(g[p], w.z, acc[p][4 * v + 2]);
                acc[p][4 * v + 3] = fmaf(g[p], w.w, acc[p][4 * v + 3]);
            }
        }
    }
}

// Error and backward of one individual for chain cc of the chunk (columns
// c0 = cc * KM ... c0 + KM - 1) at activation ACT (a compile-time code, so
// that no activation's branch is left in the loop): adds its terms to the
// thread's w_out and b0 sums and stores its dz0 into the individual's row,
// whose float N - CC + cc holds the chain's target until then (staged
// there, and stored over only by this call or a later chain's).
template <int ACT, int KM, int CC, int N>
__device__ __forceinline__ void backward_one(const float (&acc)[N], int cc, const float* b0_s,
                                             const float* wo_s, bool valid, float (&dwo)[KM],
                                             float (&db0p)[KM], float* row) {
    const int c0 = cc * KM;
    const float target = row[N - CC + cc];
    float* dz0_row = row + c0;
    float a0[KM];
    float pred = 0.f;
#pragma unroll
    for (int k = 0; k < KM; ++k) {
        a0[k] = act_apply(ACT, acc[c0 + k] + b0_s[c0 + k]);
        pred = fmaf(wo_s[c0 + k], a0[k], pred);
    }
    const float err = valid ? pred - target : 0.f;
#pragma unroll
    for (int u = 0; u < KM / 4; ++u) {  // dz0 stored four at a time
        float d[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
            const int k = 4 * u + v;
            dwo[k] = fmaf(a0[k], err, dwo[k]);
            d[v] = wo_s[c0 + k] * err * act_prime(ACT, acc[c0 + k] + b0_s[c0 + k], a0[k]);
            db0p[k] += d[v];
        }
        reinterpret_cast<float4*>(dz0_row)[u] = make_float4(d[0], d[1], d[2], d[3]);
    }
}

// Warp butterfly of a register vector; lane 0 writes the warp's sums to dst.
template <int K>
__device__ __forceinline__ void warp_sums(float (&v)[K], float* dst, int lane) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
    }
    if (lane == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) dst[k] = v[k];
    }
}

// The backward of parts h * PH ... h * PH + PH - 1 (the forward's pass h)
// for every chain, added to the thread's w_out and b0 sums. n_left: the
// group's individuals from the thread's first on that are < n.
template <int ACT, int KM, int CC, int PH>
__device__ __forceinline__ void backward_parts(const float (&acc)[PH][CC * KM], int h, const float* b0_s,
                                               const float* wo_s, int n_left, float* dz0_s,
                                               float (&dwo)[CC][KM], float (&db0p)[CC][KM], int tid) {
    constexpr int N = CC * KM, PS = part_stride(N);
#pragma unroll
    for (int p = 0; p < PH; ++p)
#pragma unroll
        for (int cc = 0; cc < CC; ++cc)
            backward_one<ACT, KM, CC, N>(acc[p], cc, b0_s, wo_s, (h * PH + p) * kGBytes < n_left, dwo[cc],
                                         db0p[cc], dz0_s + (h * PH + p) * PS + tid * N);
}

// d(rss/2)/d(q) at depth 0 of one 512-individual group of branch b for the
// chains ch * CC ... ch * CC + CC - 1 (those past C are masked), written
// to the group's partial sums of the live coordinates. The group's byte
// tile is staged every item; the chunk's weights (A, the folded bias,
// w_out), scale and shift only when stage_w (a new branch or chunk for
// this block), and otherwise stay from the block's previous item.
template <int KM, int CC>
__device__ void chunk_item(const Args& a, float* smem, int b, int grp, int ch, bool stage_w) {
    constexpr int N = CC * KM;
    constexpr int PS = part_stride(N);
    constexpr int PH = 4 * N <= 48 ? 4 : 2;  // parts per forward pass
    constexpr int S = kThreads / N < 8 ? kThreads / N : 8;  // marker slices of the staging pass
    const int m = a.m, k0 = a.k0, P = a.P, C = a.C;
    const int kl = a.k_live;
    const int tid = thread_index(), lane = tid & 31, warp = tid >> 5;
    const int ngrp = a.B / kGBytes;
    float* dz0_s = smem;                                  // [4][128][N], parts PS apart
    float* A_s = dz0_s + 4 * PS - 4;                      // [m][N]
    float* wo_s = A_s + m * N;                            // [N]
    float* b0_s = wo_s + N;                               // [N] folded bias
    float* db0_s = b0_s + N;                              // [N] the group's db0
    float* red_s = db0_s + N;                             // [4][2N] warp sums of db0, w_out
    float* sc_s = red_s + 8 * N;                          // [m] scale
    float* sh_s = sc_s + m;                               // [m] shift
    uint8_t* by_s = reinterpret_cast<uint8_t*>(sh_s + m); // [m][kRow]
    float* corr_s = red_s;  // [S][N] slices of shift^T A, until the backward

    const int off_db0 = m * k0;
    const int off_wo = off_db0 + k0;  // depth 0: W0 [m, k0], b0 [k0], w_out [k0]
    const size_t bc0 = static_cast<size_t>(b) * C + static_cast<size_t>(ch) * CC;

    __syncthreads();  // the previous item is done with shared memory
    {  // bytes, scale and shift are constant through the launch: cp.async, cached in L1
        const uint8_t* src = a.bytes + static_cast<size_t>(b) * m * a.B + static_cast<size_t>(grp) * kGBytes;
        for (int mm = warp; mm < m; mm += kThreads / 32)  // a row per warp, a word per lane
            cp_async4(by_s + mm * kRow + 4 * lane, src + static_cast<size_t>(mm) * a.B + 4 * lane);
        if (stage_w) {
            for (int mm = tid; mm < m; mm += kThreads) {
                cp_async4(sc_s + mm, a.scale + static_cast<size_t>(b) * m + mm);
                cp_async4(sh_s + mm, a.shift + static_cast<size_t>(b) * m + mm);
            }
        }
    }
    // the thread's four individuals' targets, each at the end of its dz0
    // row (float N - CC + cc for chain cc), zero past n and past C
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
        const int i = grp * kGroup + qq * kGBytes + tid;
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
            const bool ok = i < a.n && ch * CC + cc < C;
            cp_async4(dz0_s + qq * PS + tid * N + N - CC + cc, ok ? a.target + (bc0 + cc) * a.n + i : a.target,
                      ok);
        }
    }
    // ---- A = scale * W0 of the chunk's chains, their w_out and b0 (live
    // columns of chains < C; zero elsewhere), and shift^T A in S slices of
    // markers: thread (slice sl, column t)
    if (stage_w && tid < S * N) {
        const int sl = tid / N, t = tid % N, cc = t / KM, k = t % KM;
        const bool live = k < kl && ch * CC + cc < C;
        const float* q = a.w + (bc0 + cc) * P;
        const float* scale = a.scale + static_cast<size_t>(b) * m;
        const float* shift = a.shift + static_cast<size_t>(b) * m;
        if (sl == 0) {
            wo_s[t] = live ? __ldcg(q + off_wo + k) : 0.f;
            b0_s[t] = live ? __ldcg(q + off_db0 + k) : 0.f;
        }
        float corr = 0.f;
        for (int m0 = sl; m0 < m; m0 += 16 * S) {  // sixteen loads in flight
            float w[16];
#pragma unroll
            for (int u = 0; u < 16; ++u) {
                const int mm = m0 + u * S;
                w[u] = live && mm < m ? __ldcg(q + mm * k0 + k) : 0.f;
            }
#pragma unroll
            for (int u = 0; u < 16; ++u) {
                const int mm = m0 + u * S;
                if (mm < m) {
                    const float av = __ldg(scale + mm) * w[u];
                    A_s[mm * N + t] = av;
                    corr = fmaf(__ldg(shift + mm), av, corr);
                }
            }
        }
        corr_s[sl * N + t] = corr;
    }
    cp_async_wait_all();
    __syncthreads();

    // the folded bias b0 - shift^T A, the slices added in order
    if (stage_w && tid < N) {
        float corr = 0.f;
#pragma unroll 1
        for (int sl = 0; sl < S; ++sl) corr += corr_s[sl * N + tid];
        b0_s[tid] -= corr;
    }

    // ---- forward, error and backward for the thread's four individuals;
    // each chain's w_out and b0 sums over them go through warp butterflies
    // to red_s, added over the four warps in order below
    const int n_left = a.n - grp * kGroup - tid;
    {
        float dwo[CC][KM], db0p[CC][KM];
#pragma unroll
        for (int cc = 0; cc < CC; ++cc)
#pragma unroll
            for (int k = 0; k < KM; ++k) dwo[cc][k] = db0p[cc][k] = 0.f;
#pragma unroll
        for (int h = 0; h < 4 / PH; ++h) {
            float acc[PH][N];
            forward_parts<N, PH>(A_s, by_s, m, h, tid, acc);
            if (h == 0 && stage_w) __syncthreads();  // the folded bias is in place; corr_s is free
            switch (a.act) {
                case 1: backward_parts<1, KM, CC, PH>(acc, h, b0_s, wo_s, n_left, dz0_s, dwo, db0p, tid); break;
                case 2: backward_parts<2, KM, CC, PH>(acc, h, b0_s, wo_s, n_left, dz0_s, dwo, db0p, tid); break;
                case 3: backward_parts<3, KM, CC, PH>(acc, h, b0_s, wo_s, n_left, dz0_s, dwo, db0p, tid); break;
                case 4: backward_parts<4, KM, CC, PH>(acc, h, b0_s, wo_s, n_left, dz0_s, dwo, db0p, tid); break;
                default: backward_parts<0, KM, CC, PH>(acc, h, b0_s, wo_s, n_left, dz0_s, dwo, db0p, tid);
            }
        }
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
            warp_sums<KM>(db0p[cc], red_s + warp * 2 * N + cc * KM, lane);
            warp_sums<KM>(dwo[cc], red_s + warp * 2 * N + N + cc * KM, lane);
        }
    }
    __syncthreads();  // dz0 and the warp sums complete
    if (tid < 2 * N) {
        const float sum = ((red_s[tid] + red_s[2 * N + tid]) + red_s[4 * N + tid]) + red_s[6 * N + tid];
        const int t = tid < N ? tid : tid - N, cc = t / KM, k = t % KM;
        if (k < kl && ch * CC + cc < C)
            a.partial[((bc0 + cc) * ngrp + grp) * P + (tid < N ? off_db0 : off_wo) + k] = sum;
        if (tid < N) db0_s[t] = sum;  // the group's db0, for the dW0 pass
    }
    __syncthreads();

    // ---- dW0[mm, t] = scale * sum_i g[mm, i] dz0[i, t] - shift * scale * db0[t]:
    // lane (part q, slot) of warp w owns markers RM p ... RM p + RM - 1 of
    // task p = r * 32 + w * 8 + slot and its part's 128 individuals: a
    // register tile of RM markers x N columns (RM = 4 up to N = 24, else 2)
    constexpr int RM = 4 * N <= 96 ? 4 : 2;
    const int q = lane >> 3, slot = lane & 7;
    const int tasks = (m + RM - 1) / RM;
    const float* dzq = dz0_s + q * PS;
    for (int base = warp * 8; base < tasks; base += 32) {  // uniform in the warp
        const int p = base + slot;
        const int m0 = p < tasks ? RM * p : 0;  // lanes past the end read the first rows
        const uint32_t* rw[RM];
#pragma unroll
        for (int r = 0; r < RM; ++r)
            rw[r] = reinterpret_cast<const uint32_t*>(by_s + (m0 + r < m ? m0 + r : m0) * kRow);
        float sum[RM][N];
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
            for (int t = 0; t < N; ++t) sum[r][t] = 0.f;
        for (int c4 = 0; c4 < kGBytes / 4; ++c4) {
            uint32_t w[RM], u[RM];
#pragma unroll
            for (int r = 0; r < RM; ++r) {
                w[r] = rw[r][c4] >> (2 * q);
                u[r] = w[r] >> 16;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                float g[RM];
#pragma unroll
                for (int r = 0; r < RM; ++r) {
                    const uint32_t x = j < 2 ? w[r] : u[r];
                    g[r] = genotype_sel(j & 1 ? (x & 0x300u) * 0x11u : (x & 3u) * 0x1100u);
                }
                const float4* d4 = reinterpret_cast<const float4*>(dzq + (4 * c4 + j) * N);
#pragma unroll
                for (int v = 0; v < N / 4; ++v) {
                    const float4 d = d4[v];
#pragma unroll
                    for (int r = 0; r < RM; ++r) {
                        sum[r][4 * v + 0] = fmaf(g[r], d.x, sum[r][4 * v + 0]);
                        sum[r][4 * v + 1] = fmaf(g[r], d.y, sum[r][4 * v + 1]);
                        sum[r][4 * v + 2] = fmaf(g[r], d.z, sum[r][4 * v + 2]);
                        sum[r][4 * v + 3] = fmaf(g[r], d.w, sum[r][4 * v + 3]);
                    }
                }
            }
        }
        // the four parts' sums, in one fixed order for every lane
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
            for (int t = 0; t < N; ++t) {
                sum[r][t] += __shfl_xor_sync(0xffffffffu, sum[r][t], 8);
                sum[r][t] += __shfl_xor_sync(0xffffffffu, sum[r][t], 16);
            }
        if (p < tasks) {  // lane q writes the columns t = 4 j + q
#pragma unroll
            for (int r = 0; r < RM; ++r) {
                const int mm = m0 + r;
                if (mm >= m) continue;
                const float sc = sc_s[mm], of = sh_s[mm] * sc;
#pragma unroll
                for (int j = 0; j < N / 4; ++j) {
                    const int t = 4 * j + q, cc = t / KM, k = t - cc * KM;
                    const float v = q == 0 ? sum[r][4 * j] : q == 1 ? sum[r][4 * j + 1]
                                  : q == 2 ? sum[r][4 * j + 2] : sum[r][4 * j + 3];
                    if (k < kl && ch * CC + cc < C)
                        a.partial[((bc0 + cc) * ngrp + grp) * P + mm * k0 + k] = fmaf(sc, v, -of * db0_s[t]);
                }
            }
        }
    }
}

// The leapfrog at one coordinate e of (branch, chain) bc, given the sum of
// its data gradient's partials: the prior's gradient, err, and the momentum
// and position updates, in place. Step 0 only evaluates the initial
// gradient; steps 1..L integrate.
__device__ __forceinline__ void leapfrog_coord(const Args& a, long long e, long long bc, float sum,
                                               int l) {
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

// Resident blocks per SM the compiler is asked to allow (its register cap:
// 168 at 3): 3 up to N = CC * KM = 24 columns with KM <= 16, which fit it
// without spilling (ptxas -v in build.log), else 2.
template <int KM, int CC>
__global__ void __launch_bounds__(kThreads, KM * CC <= 24 && KM <= 16 ? 3 : 2)
    traj_packed_kernel(Args a) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    cg::grid_group grid = cg::this_grid();
    const int ngrp = a.B / kGBytes;
    const int nch = (a.C + CC - 1) / CC;
    const long long total = static_cast<long long>(a.nb) * a.C * a.P;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    const long long items = static_cast<long long>(a.nb) * ngrp * nch;

    // step 0 only evaluates the initial gradient; steps 1..L integrate
    for (int l = 0; l <= a.steps; ++l) {
        {  // a contiguous run of (branch, chunk, group) items per block
            const int lo = static_cast<int>(items * blockIdx.x / gridDim.x);
            const int hi = static_cast<int>(items * (blockIdx.x + 1) / gridDim.x);
            for (int it = lo; it < hi; ++it) {
                const int grp = it % ngrp, bch = it / ngrp;
                chunk_item<KM, CC>(a, smem, bch / nch, grp, bch % nch, it == lo || grp == 0);
            }
        }
        grid.sync();

        for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
             e += stride) {
            // W0 [m, k0], b0 [k0] and w_out [k0] are rows of k0 (P a
            // multiple of k0), so a coordinate's layer-0 column is its index
            // mod k0; a dead one has no partials and stays as it is
            if (static_cast<int>(e % a.k0) >= a.k_live) continue;
            const long long bc = e / a.P;
            const float* src = a.partial + bc * ngrp * a.P + e % a.P;
            float sum = 0.f;
            for (int gg = 0; gg < ngrp; ++gg) sum += __ldcg(src + static_cast<size_t>(gg) * a.P);
            leapfrog_coord(a, e, bc, sum, l);
        }
        grid.sync();
    }
}

// The deep design (csrc/packed_deep.cuh): work items (branch, chunk of cc
// chains, tile of 64 individuals) in that order, a contiguous run per CTA;
// a run's tile is staged once for the chunk's chains, whose weights stay
// staged through the run's tiles of one branch and chunk (a segment). Each
// (segment, chain) has one partial row per evaluation, at slot (CTA,
// segment of the CTA, chain); the update phase adds a coordinate's rows in
// CTA order and unfolds dW0 = scale * dW0' - (shift * scale) * d_off.
struct DeepArgs {
    Args a;
    deep::Shape sh;
    int cc;     // chains per chunk
    int slots;  // segments per CTA at most
};

template <int KM>
__global__ void __launch_bounds__(deep::kThreads) traj_deep_kernel(const DeepArgs d) {
    extern __shared__ uint4 smem_u4[];
    const Args& a = d.a;
    const deep::Shape& sh = d.sh;
    const deep::Smem sm = deep::carve(smem_u4, sh, KM, d.cc);
    cg::grid_group grid = cg::this_grid();
    const int tiles = sh.tiles, nch = a.C / d.cc;
    const int tile_bytes = sh.m16 * deep::kTileStride;
    const int F = deep::chain_floats(KM, sh.depth), planes = 3 * KM * sh.wstride;
    const long long items = static_cast<long long>(a.nb) * nch * tiles;
    const long long lo = items * blockIdx.x / gridDim.x, hi = items * (blockIdx.x + 1) / gridDim.x;
    const long long total = static_cast<long long>(a.nb) * a.C * a.P;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    const int mk0 = a.m * a.k0;
    float e2 = 0.f;  // K4's rss term, not read here

    for (int l = 0; l <= a.steps; ++l) {
        int slot = 0;
        for (long long it = lo; it < hi; ++slot) {
            const int bch = static_cast<int>(it / tiles);
            const long long seg_end = hi < static_cast<long long>(bch + 1) * tiles
                                          ? hi : static_cast<long long>(bch + 1) * tiles;
            const int b = bch / nch, c0 = (bch % nch) * d.cc;
            const int t0 = static_cast<int>(it - static_cast<long long>(bch) * tiles);
            const int t1 = static_cast<int>(seg_end - static_cast<long long>(bch) * tiles);
            const uint8_t* bytes = a.bytes + static_cast<size_t>(b) * a.m * a.B;
            deep::load_tile(sh, bytes, t0, sm.tiles);
            for (int cc = 0; cc < d.cc; ++cc)
                deep::stage_chain<KM>(sh, a.w + (static_cast<size_t>(b) * a.C + c0 + cc) * a.P,
                                      a.scale + static_cast<size_t>(b) * a.m,
                                      a.shift + static_cast<size_t>(b) * a.m, sm.w0 + cc * planes,
                                      sm.wf + cc * F, sm.fold);
            int buf = 0;
            for (int t = t0; t < t1; ++t) {
                if (t + 1 < t1) {
                    deep::load_tile(sh, bytes, t + 1, sm.tiles + (buf ^ 1) * tile_bytes);
                    cp_async_wait<1>();
                } else {
                    cp_async_wait<0>();
                }
                __syncthreads();
                for (int cc = 0; cc < d.cc; ++cc) {
                    const size_t bc = static_cast<size_t>(b) * a.C + c0 + cc;
                    float* part = a.partial +
                                  ((static_cast<size_t>(blockIdx.x) * d.slots + slot) * d.cc + cc) * a.P;
                    deep::tile_chain<KM>(sh, sm.tiles + buf * tile_bytes, sm.w0 + cc * planes,
                                         sm.wf + cc * F, sm, t, a.target + bc * a.n, nullptr, part,
                                         t == t0, e2);
                }
                buf ^= 1;
            }
            it = seg_end;
        }
        grid.sync();

        for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
             e += stride) {
            const long long bc = e / a.P;
            const int p = static_cast<int>(e - bc * a.P);
            const int b = static_cast<int>(bc / a.C), c = static_cast<int>(bc % a.C);
            const int bch = b * nch + c / d.cc, cw = c % d.cc;
            // the CTAs whose runs hold tiles of bch, in order: from the one
            // whose run holds its first tile
            const long long first = static_cast<long long>(bch) * tiles, last = first + tiles;
            int k = static_cast<int>(first * gridDim.x / items);
            while (k + 1 < static_cast<int>(gridDim.x) && items * (k + 1) / gridDim.x <= first) ++k;
            const bool w0c = p < mk0;
            const int dp = w0c ? mk0 + p % a.k0 : 0;
            float sum = 0.f, dsum = 0.f;
            for (; k < static_cast<int>(gridDim.x); ++k) {
                const long long klo = items * k / gridDim.x, khi = items * (k + 1) / gridDim.x;
                if (klo >= last) break;
                if (khi <= klo) continue;  // an empty run
                const int slot = static_cast<int>(bch - klo / tiles);
                const float* row = a.partial + ((static_cast<size_t>(k) * d.slots + slot) * d.cc + cw) * a.P;
                sum += __ldcg(row + p);
                if (w0c) dsum += __ldcg(row + dp);
            }
            if (w0c) {
                const int mm = p / a.k0;
                const float sc = a.scale[static_cast<size_t>(b) * a.m + mm];
                const float sf = a.shift[static_cast<size_t>(b) * a.m + mm];
                sum = __fsub_rn(__fmul_rn(sc, sum), __fmul_rn(__fmul_rn(sf, sc), dsum));
            }
            leapfrog_coord(a, e, bc, sum, l);
        }
        grid.sync();
    }
}

// One instantiation of the kernel with its shared memory, chunk width and
// threads per block.
struct Plan {
    const void* kern;
    size_t smem;
    int cc, threads;
};

template <int KM, int CC>
Plan make_plan(int m) {
    return {reinterpret_cast<const void*>(&traj_packed_kernel<KM, CC>), smem_d0(m, KM, CC), CC,
            kThreads};
}

// The instantiation K5 launches at depth 0 and register width km: the
// largest chunk of CC chains instantiated at km with CC at most C (one at
// least) whose shared memory fits. {nullptr} if none.
Plan pick_plan(int km, int m, int C) {
    Plan cand[3] = {};
    int n = 0;
    if (km == 8) {  // register tiles 4 x 32, 4 x 16, 4 x 8
        cand[n++] = make_plan<8, 4>(m);
        cand[n++] = make_plan<8, 2>(m);
        cand[n++] = make_plan<8, 1>(m);
    } else if (km == 12) {  // 4 x 24, 4 x 12
        cand[n++] = make_plan<12, 2>(m);
        cand[n++] = make_plan<12, 1>(m);
    } else if (km == 16) {  // 2 x 32 (two halves), 4 x 16
        cand[n++] = make_plan<16, 2>(m);
        cand[n++] = make_plan<16, 1>(m);
    } else if (km == 24) {
        cand[n++] = make_plan<24, 1>(m);
    } else if (km == 32) {
        cand[n++] = make_plan<32, 1>(m);
    }
    for (int i = 0; i < n; ++i)
        if ((cand[i].cc <= C || cand[i].cc == 1) && cand[i].smem <= static_cast<size_t>(kMaxSmem))
            return cand[i];
    return Plan{nullptr, 0, 0, 0};
}

// The deep design's instantiation: the width class of k0 and s, and the
// largest chunk of cc in {4, 2, 1} chains dividing C whose shared memory
// fits. {nullptr} if none.
Plan pick_deep(int m, int k0, int s, int depth, int C) {
    const int km = deep::pick_km64(k0, s);
    const void* kern = km == 8 ? reinterpret_cast<const void*>(&traj_deep_kernel<8>)
                     : km == 16 ? reinterpret_cast<const void*>(&traj_deep_kernel<16>)
                     : km == 32 ? reinterpret_cast<const void*>(&traj_deep_kernel<32>)
                     : reinterpret_cast<const void*>(&traj_deep_kernel<64>);
    for (int cc = 4; cc >= 1; cc /= 2) {
        const long long smem = deep::smem(m, k0, s, depth, cc);
        if (km > 0 && C % cc == 0 && smem > 0)
            return Plan{kern, static_cast<size_t>(smem), cc, deep::kThreads};
    }
    return Plan{nullptr, 0, 0, 0};
}

// Resident blocks per SM of a plan (the cooperative grid is that times the
// SMs), after allowing its shared memory.
cudaError_t blocks_per_sm(const Plan& pl, int* per_sm) {
    cudaError_t e = cudaFuncSetAttribute(pl.kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(pl.smem));
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, pl.kern, pl.threads, pl.smem);
}

// The cooperative grid of a plan: resident blocks per SM times the SMs.
cudaError_t grid_of(const Plan& pl, int* per_sm, int* grid) {
    int dev = 0, sms = 0, coop = 0;
    cudaError_t e;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) return e;
    if (!coop) return cudaErrorNotSupported;
    if ((e = blocks_per_sm(pl, per_sm)) != cudaSuccess) return e;
    if (*per_sm < 1) return cudaErrorInvalidConfiguration;
    *grid = *per_sm * sms;
    return cudaSuccess;
}

// Whether a shape runs the depth-0 design (depth 0, padded widths up to 32).
bool depth0_design(int k0, int s, int depth) { return depth == 0 && pick_km(k0, s) > 0; }

// Segments per CTA at most of the deep design: a run of up to
// ceil(items / grid) items crosses that many (branch, chunk) boundaries.
int deep_slots(long long items, int grid, int tiles, int chunks) {
    const long long len = (items + grid - 1) / grid;
    const long long s = (len + tiles - 2) / tiles + 1;
    return static_cast<int>(s < chunks ? s : chunks);
}

}  // namespace

// Shared memory K5 needs at these (padded) widths, or -1 if it cannot run
// them: at depth 0 and widths up to 32 the rule of the earlier layout (one
// chain at a time, padded rows; a depth-0 block's live width at one chain a
// chunk never needs more, so whatever passes it runs); at any other depth
// or at widths 33-64 the deep design's at one chain a chunk
// (csrc/packed_deep.cuh); -1 above width 64 or past 227 KB.
extern "C" long long traj_packed_smem(int m, int k0, int s, int depth) {
    if (depth0_design(k0, s, depth)) {
        const size_t smem = smem_bytes0(m, pick_km(k0, s));
        return smem > static_cast<size_t>(kMaxSmem) ? -1 : static_cast<long long>(smem);
    }
    return deep::smem(m, k0, s, depth, 1);
}

// The register width K5 computes with: at depth 0 and widths up to 32 the
// smallest of {8, 12, 16, 24, 32} holding k_live, else the deep design's
// width class of k0 and s (every stored column: k_live == k0); -1 if it
// cannot run these widths.
extern "C" int traj_packed_km(int k0, int s, int k_live, int depth) {
    if (depth < 0 || (depth == 0 && s != k0)) return -1;
    if (depth0_design(k0, s, depth)) return k_live >= 0 && k_live <= k0 ? live_km(k_live) : -1;
    return k_live == k0 ? deep::pick_km64(k0, s) : -1;
}

// What a launch of nb branches of m markers, B bytes per marker row, n
// individuals, these widths and C chains uses: out[0..6] = the register
// width KM, chains per chunk CC, resident blocks per SM, shared bytes per
// block, blocks in the cooperative grid, floats of partial scratch, and
// segments per block (the deep design's partial-row slots; 0 at depth 0).
// Returns a cudaError_t (cudaErrorInvalidValue if K5 cannot run them).
extern "C" int traj_packed_plan(int m, int k0, int s, int k_live, int depth, int nb, int C, int B,
                                int n, long long* out) {
    const int km = traj_packed_km(k0, s, k_live, depth);
    if (km < 0 || C < 1 || nb < 1 || n < 1 || B % kGBytes || traj_packed_smem(m, k0, s, depth) < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const bool d0 = depth0_design(k0, s, depth);
    const Plan pl = d0 ? pick_plan(km, m, C) : pick_deep(m, k0, s, depth, C);
    if (!pl.kern) return static_cast<int>(cudaErrorInvalidValue);
    int per_sm = 0, grid = 0;
    const cudaError_t e = grid_of(pl, &per_sm, &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long P = deep::flat_size(m, k0, s, depth);
    long long scratch, slots = 0;
    if (d0) {
        scratch = static_cast<long long>(nb) * C * (B / kGBytes) * P;
    } else {
        const int tiles = deep::tiles_of(n), chunks = nb * (C / pl.cc);
        slots = deep_slots(static_cast<long long>(chunks) * tiles, grid, tiles, chunks);
        scratch = static_cast<long long>(grid) * slots * pl.cc * P;
    }
    const long long v[7] = {km, pl.cc, per_sm, static_cast<long long>(pl.smem), grid, scratch, slots};
    for (int i = 0; i < 7; ++i) out[i] = v[i];
    return 0;
}

// bytes u8 [nb, m, B] (16-byte aligned); scale, shift f32 [nb, m]; target
// f32 [nb, C, n]; err f32 [nb, C]; eps, lam f32 [nb, C, P]; w, pw f32 [nb,
// C, P], the start on entry and the end of the trajectory on return;
// partial f32 scratch of partial_floats (traj_packed_plan's). The flat
// layout is W0 [m, k0], b0 [k0], per hidden layer W_l [k0, out_l] and b_l
// [out_l], w_out [s] (depth 0: k0 == s). k_live: the layer-0 columns
// [0, k_live) are integrated, the rest left as they are (the depth-0
// design; k0 in the deep one).
extern "C" int traj_packed_f32(const void* bytes, const void* scale, const void* shift,
                               const void* target, const void* err, const void* eps,
                               const void* lam, void* w, void* pw, void* partial,
                               long long partial_floats, int nb, int C, int m, int B, int n, int k0,
                               int k_live, int s, int P, int depth, int steps, int act, int l1,
                               void* stream) {
    long long plan[7];
    const int status = traj_packed_plan(m, k0, s, k_live, depth, nb, C, B, n, plan);
    if (status != 0) return status;
    if (P != deep::flat_size(m, k0, s, depth) || steps < 0 || plan[5] > partial_floats ||
        (reinterpret_cast<uintptr_t>(bytes) & 15))
        return static_cast<int>(cudaErrorInvalidValue);
    const bool d0 = depth0_design(k0, s, depth);
    const Plan pl = d0 ? pick_plan(static_cast<int>(plan[0]), m, C) : pick_deep(m, k0, s, depth, C);
    Args a{static_cast<const uint8_t*>(bytes), static_cast<const float*>(scale),
           static_cast<const float*>(shift),   static_cast<const float*>(target),
           static_cast<const float*>(err),     static_cast<const float*>(eps),
           static_cast<const float*>(lam),     static_cast<float*>(w),
           static_cast<float*>(pw),            static_cast<float*>(partial),
           nb, C, m, B, n, k0, s, P, steps, act, l1, k_live};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int grid = static_cast<int>(plan[4]);
    if (d0) {
        void* params[] = {&a};
        return static_cast<int>(
            cudaLaunchCooperativeKernel(pl.kern, dim3(grid), dim3(pl.threads), params, pl.smem, st));
    }
    DeepArgs da{a, deep::make_shape(m, k0, s, depth, n, B, act), pl.cc, static_cast<int>(plan[6])};
    void* params[] = {&da};
    return static_cast<int>(
        cudaLaunchCooperativeKernel(pl.kern, dim3(grid), dim3(pl.threads), params, pl.smem, st));
}
