// The dense branch MLP's value and gradient on tf32 tensor cores kept exact
// at f32 level: the device code of K8a/K8b (csrc/branch_vg_dense.cu) and of
// K6's gradient phase (csrc/traj_dense.cu). K7 keeps its own f32 device
// code, csrc/dense_chain_mlp.cuh.
//
// A work item is (instance j, tile of kT = 32 individuals) of feature-major
// X [m, n]. A group of 4 warps takes a contiguous run of items, one instance
// after another, and keeps that instance's gradient sums in shared memory
// over the run; it writes one partial row per instance it touched
// ("segment"), and the segments are summed in a fixed order afterwards. (K8
// is one group per CTA; K6's CTA holds CC groups, one chain each, on one X
// tile.)
//
// The five products run as mma.sync.m16n8k8 tf32 in 3xTF32: each f32
// operand v is split into hi = tf32(v) and lo = tf32(v - hi) (v - hi is
// exact), and a fragment is hi*hi + (lo*hi + hi*lo): 2^-21 of |a b| per
// product. The tensor cores' f32 accumulation cuts toward zero, so each of
// the three products runs from a zero accumulator and they join the f32 sum
// by round-to-nearest adds (as mma_split3_add in packed_mma.cuh does for
// its parts); no accumulator is chained across fragments.
//
// Phase A, warp w owns individuals 8w .. 8w + 7 of the tile (the MMA's N)
// and every unit (M, tiles of 16), so the chain stays in its registers:
//   Z0^T = W0^T X        A: W0 fragments staged once per instance,
//   a0   = act(Z0 + b0)     B: X[marker][individual] from the tile
//   Z1^T = W1^T a0^T      B: a0 through the warp's columns of a0t
//   pred = w_out . a1     the quad's units, then a butterfly over lanes
//   dz1  = w_out err act'(z1);  dA0^T = W1 dz1^T (B through dz1t)
//   dz0  = dA0 act'(z0)   (depth 0: w_out err act'(z0))
// a0, dz1 and dz0 go to shared planes [unit][individual] (f32).
// Phase B, the warps split the output tiles of dW0 = X dz0 and dW1 = a0^T
// dz1 (K = the tile's 32 individuals), every operand by ldmatrix, and add
// each tile's sums into the instance's shared accumulators.
//
// Shared [rows][kT] buffers (the X tile and the planes) have a row stride of
// kS = 40 floats and swap 4-column chunks on rows with bit 2 set, so the
// phase-A column loads, the 8-byte plane stores and the ldmatrix rows all
// miss bank conflicts.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "packed_decode.cuh"
#include "packed_mma.cuh"

namespace rsbann {
namespace vg {

constexpr int kT = 32;             // individuals per tile
constexpr int kWarps = 4;          // warps per CTA: kT / 8
constexpr int kThreads = 32 * kWarps;
constexpr int kS = kT + 8;         // row stride of [rows][kT] buffers (8 mod 32)
constexpr int kSlices = 8;         // row slices of the fixed-order segment sum
constexpr int kBatch = 16;         // weight loads in flight per thread while staging
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use

__host__ __device__ constexpr int km16(int km) { return km < 16 ? 16 : km; }
// row stride of the gradient accumulators: 8 mod 32 or 24, conflict-free float2
__host__ __device__ constexpr int acc_stride(int km) { return km == 32 ? 40 : 24; }

// float index of (row r, column c) in a swizzled [rows][kS] buffer
__device__ __forceinline__ int swz(int r, int c) { return r * kS + (c ^ (r & 4)); }

// The CTA of item x when ``items`` items are split evenly over ``ctas``
// CTAs (CTA c takes [c items / ctas, (c + 1) items / ctas)).
__host__ __device__ inline int cta_of(long long x, int ctas, long long items) {
    return static_cast<int>(((x + 1) * ctas - 1) / items);
}

struct Args {
    const float* x;       // [G, m, n]
    const int* xix;       // [NB]: instance j reads X branch xix[j]; null: branch j
    const float* target;  // [NB, n]
    const float* w0;      // [NB, m, k0]
    const float* b0;      // [NB, k0]
    const float* w1;      // [NB, k0, s] (depth 1)
    const float* b1;      // [NB, s]
    const float* wout;    // [NB, s] (s = k0 at depth 0)
    float* y_pred;        // [NB, n]
    float* grads;         // [NB, P]: W0, b0, (W1, b1), w_out
    float* rss;           // [NB]
    float* partial;       // [ctas + NB, P]: segment (c, j) in row c + j
    double* e2;           // [ctas + NB]: each segment's err^2
    int NB, m, n, k0, s, P;
    int tiles;  // tiles of kT individuals per instance
    int m16, m8, nbuf, vec16;
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

// x ~ hi + lo: hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split2(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32_rna(x);
    lo = tf32_rna(x - __uint_as_float(hi));
}

// x ~ hi + lo by integer operations on the bits, in fewer issue slots than
// cvt.rna (K6's products use it; K8's keep split2): hi = x with its low 13
// bits cleared (toward zero), lo = x - hi (exact) rounded to tf32, to
// nearest with ties away (half a tf32 ulp added to the magnitude, the low
// 13 bits cleared). hi + lo is x to 2^-21 of |x| (split2: 2^-22); a NaN or
// an infinite x stays so in hi.
__device__ __forceinline__ void split2_int(float x, uint32_t& hi, uint32_t& lo) {
    hi = __float_as_uint(x) & 0xffffe000u;
    lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// INT: split2_int (K6), else split2 (K8, whose outputs keep their bits;
// moving K8 onto split2_int and dropping this switch is ROADMAP Queue 2B's)
template <bool INT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    if (INT) {
        split2_int(x, hi, lo);
    } else {
        split2(x, hi, lo);
    }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// acc += A B for one fragment in 3xTF32, rounded to nearest: hi*hi, lo*hi
// and hi*lo each from a zero accumulator (no MMA waits on another), joined
// by f32 adds: acc + (hh + (lh + hl)).
__device__ __forceinline__ void mma3_add(float (&acc)[4], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                         uint32_t bl0, uint32_t bl1) {
    float hh[4], lh[4], hl[4];
    mma_tf32_zero(hh, ah, bh0, bh1);
    mma_tf32_zero(lh, al, bh0, bh1);
    mma_tf32_zero(hl, ah, bl0, bl1);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += hh[e] + (lh[e] + hl[e]);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a)
                 : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[4], const float* p) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(a)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
                 "r"(src_bytes));
}

// Element (K index r, M index c) of a fragment-ordered A operand, split
// into its hi and lo parts: fragment (kc, mt) = (r / 8, c / 16) is 256
// floats, hi [lane][4] then lo [lane][4], registers a0..a3 = (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4), kidx j <-> r = 8 kc + j.
template <int MT>
__device__ __forceinline__ void store_frag(float* frags, int r, int c, float v) {
    const int lane = 4 * (c & 7) + (r & 3), q = 2 * ((r >> 2) & 1) + ((c >> 3) & 1);
    uint32_t* d = reinterpret_cast<uint32_t*>(frags) + ((r >> 3) * MT + (c >> 4)) * 256 + 4 * lane + q;
    uint32_t hi, lo;
    split2(v, hi, lo);
    d[0] = hi;
    d[128] = lo;
}

// One instance's weights (W0 [m, k0], b0 [k0], (W1 [k0, s], b1 [s]), w_out
// [s], each from its own pointer), staged by the 4 warps of a group (``tid``
// its thread, 0 .. 127): W0 as Z0's A fragments (K = markers, M = units),
// W1 as Z1's (K = k0, M = s) and as dA0's (K = s, M = k0), b0, b1 and w_out
// as [K16] vectors. The entries past the real rows and columns stay as the
// group zeroed them. Warp w reads rows w, w + 4, ..., lane c column c
// (widths <= 32): coalesced, and every load of W1, the vectors and a batch
// of kBatch rows of W0 in flight at once (at the flagship all of them).
// Read through L2 only (__ldcg): K6 rewrites the weights inside its launch.
template <int MT, int K16, bool DEEP, bool GRAD>
__device__ void stage_weights_from(const float* w0, const float* b0, const float* w1,
                                   const float* b1, const float* wout, int m, int k0, int s,
                                   int tid, float* w0f, float* w1a, float* w1b, float* vecs) {
    const int lane = tid & 31, w = tid >> 5;
    constexpr int R1 = 32 / kWarps;  // rows of W1 per warp
    float v1[R1], vv = 0.f;
    if (DEEP) {
#pragma unroll
        for (int u = 0; u < R1; ++u) {
            const int k = w + kWarps * u;
            v1[u] = k < k0 && lane < s ? __ldcg(w1 + k * s + lane) : 0.f;
        }
    }
    if (tid < 3 * K16) {
        const int which = tid / K16, u = tid - which * K16;
        if (which == 0 && u < k0) vv = __ldcg(b0 + u);
        if (which == 1 && DEEP && u < s) vv = __ldcg(b1 + u);
        if (which == 2 && u < s) vv = __ldcg(wout + u);
    }
    for (int r0 = 0; r0 < m; r0 += kWarps * kBatch) {
        float v0[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int r = r0 + w + kWarps * u;
            v0[u] = r < m && lane < k0 ? __ldcg(w0 + r * k0 + lane) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int r = r0 + w + kWarps * u;
            if (r < m && lane < k0) store_frag<MT>(w0f, r, lane, v0[u]);
        }
    }
    if (DEEP) {
#pragma unroll
        for (int u = 0; u < R1; ++u) {
            const int k = w + kWarps * u;
            if (k < k0 && lane < s) {
                store_frag<MT>(w1a, k, lane, v1[u]);
                if (GRAD) store_frag<MT>(w1b, lane, k, v1[u]);
            }
        }
    }
    if (tid < 3 * K16) vecs[tid] = vv;
}

// Instance j's weights, once per instance and CTA (K8: one group per CTA).
template <int MT, int K16, bool DEEP, bool GRAD>
__device__ void stage_weights(const Args& a, int j, float* w0f, float* w1a, float* w1b,
                              float* vecs) {
    const int m = a.m, k0 = a.k0, s = a.s;
    stage_weights_from<MT, K16, DEEP, GRAD>(
        a.w0 + static_cast<size_t>(j) * m * k0, a.b0 + static_cast<size_t>(j) * k0,
        DEEP ? a.w1 + static_cast<size_t>(j) * k0 * s : nullptr,
        DEEP ? a.b1 + static_cast<size_t>(j) * s : nullptr, a.wout + static_cast<size_t>(j) * s,
        m, k0, s, threadIdx.x, w0f, w1a, w1b, vecs);
}

__device__ __forceinline__ void ld_frag(const float* f, int lane, uint32_t (&ah)[4],
                                        uint32_t (&al)[4]) {
    const uint4 h = *reinterpret_cast<const uint4*>(f + 4 * lane);
    const uint4 l = *reinterpret_cast<const uint4*>(f + 128 + 4 * lane);
    ah[0] = h.x, ah[1] = h.y, ah[2] = h.z, ah[3] = h.w;
    al[0] = l.x, al[1] = l.y, al[2] = l.z, al[3] = l.w;
}

// D[MT] = A B over ``ksteps``: A the staged fragments ``frags`` ((kc, mt)
// order), B rows 8 kc + t and 8 kc + t + 4, column ``col`` of the swizzled
// buffer ``bp`` (f32 values, split here; INT: by split2_int).
template <int MT, bool INT = false>
__device__ __forceinline__ void product_a(const float* frags, const float* bp, int ksteps, int col,
                                          float (&d)[MT][4]) {
    const int lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[mt][e] = 0.f;
#pragma unroll 4
    for (int kc = 0; kc < ksteps; ++kc) {
        uint32_t bh0, bh1, bl0, bl1;
        split<INT>(bp[swz(8 * kc + t, col)], bh0, bl0);
        split<INT>(bp[swz(8 * kc + t + 4, col)], bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            uint32_t ah[4], al[4];
            ld_frag(frags + (kc * MT + mt) * 256, lane, ah, al);
            mma3_add(d[mt], ah, al, bh0, bh1, bl0, bl1);
        }
    }
}

// The thread's share of pred for its two individuals: sum over its units
// 16 mt + g + 8 h of w_out * a, in order.
template <int MT>
__device__ __forceinline__ void pred_terms(const float (&v)[MT][4], const float* wos, float& p_a,
                                           float& p_b) {
    const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const float wo = wos[16 * mt + g + 8 * h];
            p_a = fmaf(wo, v[mt][2 * h], p_a);
            p_b = fmaf(wo, v[mt][2 * h + 1], p_b);
        }
}

// D[MT] (rows: units, columns 2t, 2t + 1 of the warp's 8) into the plane at
// column ``col`` (= 8 w + 2 t), 8-byte stores of f32 values (split where read).
template <int MT>
__device__ __forceinline__ void store_plane(float* plane, int col, const float (&v)[MT][4]) {
    const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(plane + swz(16 * mt + g + 8 * h, col)) =
                make_float2(v[mt][2 * h], v[mt][2 * h + 1]);
}

// acc[u] = A B over the tile's 32 individuals for the 16 x 8 output tiles
// u = 0 .. NTU - 1 of one row tile: A rows ``arow`` .. + 15 of ``ap``, loaded
// and split once per k-step for all NTU; B rows ``brow`` + 8 u .. + 7 of
// ``bp`` (one ldmatrix for both column tiles); individuals as columns, f32
// values split here (INT: by split2_int).
template <int NTU, bool INT = false>
__device__ __forceinline__ void product_b(const float* ap, int arow, const float* bp, int brow,
                                          float (&acc)[NTU][4]) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int u = 0; u < NTU; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kT / 8; ++ks) {
        uint32_t raw[4], ah[4], al[4], bh[4], bl[4];
        ldsm_x4(raw, ap + swz(arow + (lane & 15), 8 * ks + 4 * (lane >> 4)));
#pragma unroll
        for (int r = 0; r < 4; ++r) split<INT>(__uint_as_float(raw[r]), ah[r], al[r]);
        // matrices: (tile u, columns 8 ks .. + 3), (u, 8 ks + 4 .. + 7) per u
        const float* b = bp + swz(brow + 8 * (lane >> 4) + (lane & 7), 8 * ks + 4 * ((lane >> 3) & 1));
        if (NTU == 2) {
            ldsm_x4(raw, b);
        } else {
            ldsm_x2(raw, b);
        }
#pragma unroll
        for (int r = 0; r < 2 * NTU; ++r) split<INT>(__uint_as_float(raw[r]), bh[r], bl[r]);
#pragma unroll
        for (int u = 0; u < NTU; ++u)
            mma3_add(acc[u], ah, al, bh[2 * u], bh[2 * u + 1], bl[2 * u], bl[2 * u + 1]);
    }
}

// The 16 x 8 tiles at (row0, col0 + 8 u) of acc2 (stride ld) = acc[u] on a
// segment's first tile, else += acc[u], rounded to nearest
template <int NTU>
__device__ __forceinline__ void add_tiles(float* acc2, int ld, int row0, int col0, bool first,
                                          const float (&acc)[NTU][4]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int u = 0; u < NTU; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float2* d = reinterpret_cast<float2*>(acc2 + (row0 + g + 8 * h) * ld + col0 + 8 * u + 2 * t);
            float2 v = make_float2(acc[u][2 * h], acc[u][2 * h + 1]);
            if (!first) {
                const float2 old = *d;
                v = make_float2(old.x + v.x, old.y + v.y);
            }
            *d = v;
        }
}

}  // namespace vg
}  // namespace rsbann
