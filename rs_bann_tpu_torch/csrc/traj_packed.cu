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
// they never move. Depth 0 and 1, every activation, f32 throughout.
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
// the same bits. Depth 1 computes every stored column (k_live = k0).
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
//    (branch, chain) in K4's gradient layout (partial_size); data written
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

namespace cg = cooperative_groups;

namespace {

using namespace rsbann;

constexpr int kThreads = kGBytes;  // one thread per byte column of a group
constexpr int kRow = kGBytes + 4;  // shared-memory row stride of the byte tile
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use

// Row stride (floats) of the depth-1 per-individual rows (and of the
// shared-memory rule): an odd number of 16-byte units, so the float4 stores
// of neighbouring rows hit distinct banks (12, 20, 20, 28, 36 for 8, 12,
// 16, 24, 32 columns).
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

// Shared memory of the depth-1 gradient phase, and the rule traj_packed_smem
// reports for both depths (at the padded width pick_km): the depth-0 layout
// at one chain a chunk never needs more.
size_t smem_bytes(int m, int km, bool deep) {
    const size_t floats = static_cast<size_t>(kGroup) * row_stride(km) * (deep ? 3 : 1) +
                          static_cast<size_t>(m) * km + km + (deep ? km * km + km : 0) + km +
                          4 * km + 2 * static_cast<size_t>(m);
    return floats * sizeof(float) + static_cast<size_t>(m) * kRow;
}

// Shared memory of the depth-0 gradient phase at KM columns and chunks of
// CC chains (N = CC * KM): dz0 [4][128][N] with the parts 16 bytes apart,
// A [m][N], w_out, b0 and the group's db0 [N] each, the warp sums [4][2N],
// scale and shift [m], the byte tile [m][kRow]. At CC = 1 this is at most
// smem_bytes(m, KM, false): the unpadded dz0 rows save at least 512 x 4
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
    float* partial;        // [nb, C, B / 128, P] scratch
    int nb, C, m, B, n, k0, s, P, steps, act, l1;
    int k_live;            // layer-0 columns computed: [0, k_live) (k0 at depth 1)
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

// d(rss/2)/d(q) of one 512-individual group of branch b at depth 1, for each
// chain in turn, written to the group's partial sums.
template <int KM>
__device__ void gradient_item_deep(const Args& a, float* smem, int b, int grp) {
    constexpr int RS = row_stride(KM);
    const int m = a.m, k0 = a.k0, s = a.s, P = a.P;
    const int tid = threadIdx.x;
    const int ngrp = a.B / kGBytes;
    float* dz0_s = smem;                 // [512][RS]
    float* a0_s = dz0_s + kGroup * RS;   // [512][RS]
    float* dz1_s = a0_s + kGroup * RS;   // [512][RS]
    float* w0_s = dz1_s + kGroup * RS;   // [m][KM]
    float* b0_s = w0_s + m * KM;         // [KM]
    float* w1_s = b0_s + KM;             // [KM][KM]
    float* b1_s = w1_s + KM * KM;        // [KM]
    float* wo_s = b1_s + KM;             // [KM]
    float* red_s = wo_s + KM;            // [4][KM]
    float* sc_s = red_s + 4 * KM;        // [m] scale
    float* of_s = sc_s + m;              // [m] shift * scale
    uint8_t* by_s = reinterpret_cast<uint8_t*>(of_s + m);  // [m][kRow]

    const int off_db0 = m * k0;
    const int off_w1 = off_db0 + k0;
    const int off_b1 = off_w1 + k0 * s;
    const int off_wo = off_b1 + s;

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

        // ---- chain c's weights, zero-padded to KM
        for (int idx = tid; idx < m * KM; idx += kThreads) {
            const int mm = idx / KM, kk = idx % KM;
            w0_s[idx] = kk < k0 ? __ldcg(q + mm * k0 + kk) : 0.f;
        }
        if (tid < KM) {
            b0_s[tid] = tid < k0 ? __ldcg(q + off_db0 + tid) : 0.f;
            wo_s[tid] = tid < s ? __ldcg(q + off_wo + tid) : 0.f;
            b1_s[tid] = tid < s ? __ldcg(q + off_b1 + tid) : 0.f;
        }
        for (int idx = tid; idx < KM * KM; idx += kThreads) {
            const int kk = idx / KM, ss = idx % KM;
            w1_s[idx] = (kk < k0 && ss < s) ? __ldcg(q + off_w1 + kk * s + ss) : 0.f;
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
            float z0[KM], a0[KM], dz0[KM], z1[KM], a1[KM], dz1[KM];
#pragma unroll
            for (int k = 0; k < KM; ++k) {
                z0[k] = acc[qq][k] + b0_s[k];
                a0[k] = act_apply(a.act, z0[k]);
            }
            float pred = 0.f;
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
            store_row<KM>(dz0_s + row * RS, dz0);
        }
        __syncthreads();

        float* part = a.partial + (bc * ngrp + grp) * P;

        // ---- small sums over the block
        block_sum<KM>(db0p, red_s, part + off_db0, k0);
        block_sum<KM>(dwo, red_s, part + off_wo, s);
        block_sum<KM>(db1p, red_s, part + off_b1, s);

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
                if (k < k0) part[mm * k0 + k] = acc2[k];
        }

        // ---- dW1[k, ss] = sum over the group of a0[i, k] * dz1[i, ss]
        for (int idx = tid; idx < k0 * s; idx += kThreads) {
            const int k = idx / s, ss = idx % s;
            float sum = 0.f;
            for (int r = 0; r < kGroup; ++r) sum = fmaf(a0_s[r * RS + k], dz1_s[r * RS + ss], sum);
            part[off_w1 + idx] = sum;
        }
        __syncthreads();  // chain c + 1 restages the weights and reuses dz0_s
    }
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

// Resident blocks per SM the compiler is asked to allow (its register cap:
// 168 at 3): 3 at depth 0 up to N = CC * KM = 24 columns with KM <= 16,
// which fit it without spilling (ptxas -v in build.log), else 2 (depth 0)
// or 1 (depth 1, unchanged).
template <int KM, int CC, bool DEEP>
__global__ void __launch_bounds__(kThreads, DEEP ? 1 : (KM * CC <= 24 && KM <= 16 ? 3 : 2))
    traj_packed_kernel(Args a) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    cg::grid_group grid = cg::this_grid();
    const int ngrp = a.B / kGBytes;
    const int nch = (a.C + CC - 1) / CC;
    const long long total = static_cast<long long>(a.nb) * a.C * a.P;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    const long long items = static_cast<long long>(a.nb) * ngrp * (DEEP ? 1 : nch);

    // step 0 only evaluates the initial gradient; steps 1..L integrate
    for (int l = 0; l <= a.steps; ++l) {
        if constexpr (DEEP) {
            for (long long it = blockIdx.x; it < items; it += gridDim.x)
                gradient_item_deep<KM>(a, smem, static_cast<int>(it / ngrp), static_cast<int>(it % ngrp));
        } else {  // a contiguous run of (branch, chunk, group) items per block
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

// One instantiation of the kernel with its shared memory and chunk width.
struct Plan {
    const void* kern;
    size_t smem;
    int cc;
};

template <int KM, int CC, bool DEEP>
Plan make_plan(int m) {
    return {reinterpret_cast<const void*>(&traj_packed_kernel<KM, CC, DEEP>),
            DEEP ? smem_bytes(m, KM, true) : smem_d0(m, KM, CC), CC};
}

// The instantiation K5 launches at register width km: at depth 1 the one of
// km; at depth 0 the largest chunk of CC chains instantiated at km with CC
// at most C (one at least) whose shared memory fits. {nullptr} if none.
Plan pick_plan(int km, int depth, int m, int C) {
    Plan cand[3] = {};
    int n = 0;
    if (depth == 1) {
        if (km == 8) cand[n++] = make_plan<8, 1, true>(m);
        if (km == 16) cand[n++] = make_plan<16, 1, true>(m);
        if (km == 32) cand[n++] = make_plan<32, 1, true>(m);
    } else if (km == 8) {  // register tiles 4 x 32, 4 x 16, 4 x 8
        cand[n++] = make_plan<8, 4, false>(m);
        cand[n++] = make_plan<8, 2, false>(m);
        cand[n++] = make_plan<8, 1, false>(m);
    } else if (km == 12) {  // 4 x 24, 4 x 12
        cand[n++] = make_plan<12, 2, false>(m);
        cand[n++] = make_plan<12, 1, false>(m);
    } else if (km == 16) {  // 2 x 32 (two halves), 4 x 16
        cand[n++] = make_plan<16, 2, false>(m);
        cand[n++] = make_plan<16, 1, false>(m);
    } else if (km == 24) {
        cand[n++] = make_plan<24, 1, false>(m);
    } else if (km == 32) {
        cand[n++] = make_plan<32, 1, false>(m);
    }
    for (int i = 0; i < n; ++i)
        if ((cand[i].cc <= C || cand[i].cc == 1) && cand[i].smem <= static_cast<size_t>(kMaxSmem))
            return cand[i];
    return Plan{nullptr, 0, 0};
}

// Resident blocks per SM of a plan (the cooperative grid is that times the
// SMs), after allowing its shared memory.
cudaError_t blocks_per_sm(const Plan& pl, int* per_sm) {
    cudaError_t e = cudaFuncSetAttribute(pl.kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(pl.smem));
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, pl.kern, kThreads, pl.smem);
}

cudaError_t launch(const Plan& pl, Args a, cudaStream_t stream) {
    int dev = 0, sms = 0, coop = 0, per_sm = 0;
    cudaError_t e;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) return e;
    if (!coop) return cudaErrorNotSupported;
    if ((e = blocks_per_sm(pl, &per_sm)) != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    void* params[] = {&a};
    return cudaLaunchCooperativeKernel(pl.kern, dim3(per_sm * sms), dim3(kThreads), params, pl.smem, stream);
}

}  // namespace

// Shared memory K5 needs at these (padded) widths, or -1 if it cannot run
// them: the rule of the depth-1 layout and of the earlier depth-0 one (one
// chain at a time, padded rows). A depth-0 block's live width at one chain
// a chunk never needs more, so whatever passes this rule runs.
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

// What a launch at these widths and C chains would use: *cc chains per
// chunk (1 at depth 1), *per_sm resident blocks per SM (the cooperative
// grid is that times the SMs) and *smem bytes of shared memory per block.
// Returns a cudaError_t (cudaErrorInvalidValue if K5 cannot run them).
extern "C" int traj_packed_occupancy(int m, int k0, int s, int k_live, int depth, int C, int* cc,
                                     int* per_sm, long long* smem) {
    const int km = traj_packed_km(k0, s, k_live, depth);
    if (km < 0 || C < 1 || traj_packed_smem(m, k0, s, depth) < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const Plan pl = pick_plan(km, depth, m, C);
    if (!pl.kern) return static_cast<int>(cudaErrorInvalidValue);
    *cc = pl.cc;
    *smem = static_cast<long long>(pl.smem);
    return static_cast<int>(blocks_per_sm(pl, per_sm));
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
    if (km < 0 || C < 1 || P != partial_size(m, k0, s, deep) || steps < 0 ||
        traj_packed_smem(m, k0, s, depth) < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const Plan pl = pick_plan(km, depth, m, C);
    if (!pl.kern) return static_cast<int>(cudaErrorInvalidValue);  // no chunk fits: raise
    Args a{static_cast<const uint8_t*>(bytes), static_cast<const float*>(scale),
           static_cast<const float*>(shift),   static_cast<const float*>(target),
           static_cast<const float*>(err),     static_cast<const float*>(eps),
           static_cast<const float*>(lam),     static_cast<float*>(w),
           static_cast<float*>(pw),            static_cast<float*>(partial),
           nb, C, m, B, n, k0, s, P, steps, act, l1, k_live};
    return static_cast<int>(launch(pl, a, static_cast<cudaStream_t>(stream)));
}
