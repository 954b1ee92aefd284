// The dense branch MLP's value and gradient on tf32 tensor cores kept exact
// at f32 level: the device code of K6 (csrc/traj_dense.cu), K7
// (csrc/vg_chains.cuh) and K8a/K8b (csrc/branch_vg_dense.cu).
//
// A work item is (instance j, tile of kT = 32 individuals) of feature-major
// X [m, n]. A group of 4 warps runs one chain: it takes a contiguous run of
// items, one instance after another, and keeps that instance's gradient
// sums in shared memory over the run; it writes one partial row per
// instance it touched ("segment"), and the segments are summed in a fixed
// order afterwards. K8's CTA is one group; K6's and K7's hold CC groups,
// chain i of a chunk of CC chains in group i, all on one X tile.
//
// The five products run as mma.sync.m16n8k8 tf32 in 3xTF32: each f32
// operand v is split into tf32 parts hi and lo (v - hi is exact), and a
// fragment is hi*hi + (lo*hi + hi*lo). The staged weights are split once
// per instance by cvt.rna (hi + lo is v to 2^-22); every other operand as
// it is loaded by integer operations on its bits (split2_int: 2^-21, in
// fewer issue slots). The tensor cores' f32 accumulation cuts toward zero,
// so each of the three products runs from a zero accumulator and they join
// the f32 sum by round-to-nearest adds (as mma_split3_add in packed_mma.cuh
// does for its parts); no accumulator is chained across fragments.
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
//
// X stored in bf16 (--x-bf16; the XB instantiations): the tile is staged in
// bf16, [m16][kSB = 40] unswizzled (80-byte rows: a warp's column loads in
// phase A and its A-fragment loads in phase B fall on distinct banks), half
// the HBM stream and half the tile's shared memory. A bf16 value widens to
// f32 exactly (its bits shifted up by 16), so its tf32 split has hi = the
// value and lo = 0, the split of the same value upcast to f32: the product
// of X's zero low part is left out (mma3_add_aexact / _bexact), which
// changes no sum, so a bf16 tile gives the f32 kernel's bits on the
// upcast values.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "packed_decode.cuh"
#include "packed_mma.cuh"

namespace rsbann {
namespace vg {

constexpr int kT = 32;             // individuals per tile
constexpr int kWarps = 4;          // warps per group: kT / 8
constexpr int kThreads = 32 * kWarps;
constexpr int kS = kT + 8;         // row stride of [rows][kT] buffers (8 mod 32)
constexpr int kSB = kT + 8;        // row stride (bf16 values) of a bf16 X tile
constexpr int kSlices = 8;         // row slices of the fixed-order segment sum
constexpr int kBatch = 16;         // weight loads in flight per thread while staging
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use
constexpr int kLayers = 5;         // W0, b0, W1, b1, w_out (W1 and b1 unused at depth 0)

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

// Floats of shared memory of one group (one chain): the weight fragments,
// the planes, with ``grad`` the accumulators, b0, b1, w_out, the warps'
// small sums, and with ``grad`` and ``rss`` the warps' err^2 (f64). Every
// part is a multiple of 4 floats, so each group and each part starts on 16
// bytes.
__host__ __device__ inline long long group_floats(int km, bool deep, bool grad, bool rss, int m16,
                                                  int m8) {
    const long long k16 = km16(km), mt = k16 / 16, plane = k16 * kS;
    long long f = (m8 / 8) * mt * 256;
    if (deep) f += (km / 8) * mt * 256 * (grad ? 2 : 1) + plane;
    if (grad) f += plane * (deep ? 2 : 1) + (m16 + (deep ? k16 : 0)) * acc_stride(km);
    f += 3 * k16 + kWarps * 3 * k16;
    return f + (grad && rss ? 2 * kWarps : 0);
}

// Floats of one staged X tile of m16 rows: f32 [m16][kS], or (xb) bf16
// [m16][kSB], half as many bytes (a multiple of 16).
__host__ __device__ constexpr int x_tile_floats(int m16, bool xb) {
    return xb ? m16 * kSB / 2 : m16 * kS;
}

// Shared bytes a CTA of ``cc`` groups and ``nbuf`` X tile buffers (f32, or
// bf16 with xb) uses at padded width km, or -1 past depth 1, a width above
// 32 or 227 KB.
inline long long cta_smem(int m, int k0, int s, int depth, bool grad, bool rss, int cc,
                          int nbuf, bool xb = false) {
    const int km = pick_km(k0, s);
    if (km < 0 || depth < 0 || depth > 1 || m <= 0) return -1;
    const int m16 = (m + 15) & ~15, m8 = (m + 7) & ~7;
    const long long b = 4 * (static_cast<long long>(nbuf) * x_tile_floats(m16, xb) +
                             cc * group_floats(km, depth == 1, grad, rss, m16, m8));
    return b > kMaxSmem ? -1 : b;
}

// One group's shared buffers, carved from ``base`` in the order of
// group_floats.
template <int KM, bool DEEP, bool GRAD>
struct Group {
    float *w0f, *w1a, *w1b, *a0t, *dz1t, *dz0t, *acc0, *acc1, *b0s, *b1s, *wos, *red;
    double* e2red;
    __device__ __forceinline__ Group(float* base, int m16, int m8) {
        constexpr int K16 = km16(KM), MT = K16 / 16, NT = KM / 8, PL = K16 * kS;
        constexpr int AS = acc_stride(KM);
        w0f = base;                                        // Z0's A fragments
        w1a = w0f + (m8 / 8) * MT * 256;                   // Z1's (depth 1)
        w1b = w1a + (DEEP ? NT * MT * 256 : 0);            // dA0's (depth 1, grad)
        a0t = w1b + (DEEP && GRAD ? NT * MT * 256 : 0);    // [K16][kS] (depth 1)
        dz1t = a0t + (DEEP ? PL : 0);                      // (depth 1, grad)
        dz0t = dz1t + (DEEP && GRAD ? PL : 0);             // (grad)
        acc0 = dz0t + (GRAD ? PL : 0);                     // dW0 [m16][AS] (grad)
        acc1 = acc0 + (GRAD ? m16 * AS : 0);               // dW1 [K16][AS] (depth 1, grad)
        b0s = acc1 + (GRAD && DEEP ? K16 * AS : 0);        // [K16]
        b1s = b0s + K16;
        wos = b1s + K16;
        red = wos + K16;                                   // [kWarps][3][K16]
        e2red = reinterpret_cast<double*>(red + kWarps * 3 * K16);  // [kWarps] (grad, rss)
    }
};

// The 4 warps of group grp (named barrier grp + 1; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int grp) {
    asm volatile("bar.sync %0, %1;" ::"r"(grp + 1), "r"(kThreads) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
                 "r"(src_bytes));
}

// The X tile tl of one branch xg [m, n] into ``xs``, by every thread of the
// CTA: rows past m and individuals past n are zero. vec16: n % 4 == 0 and
// X on 16 bytes, so 16-byte copies.
__device__ __forceinline__ void load_x(const float* xg, int m, int n, int m16, int vec16, int tl,
                                       float* xs) {
    const int i0 = tl * kT;
    if (vec16) {
        for (int idx = threadIdx.x; idx < m16 * (kT / 4); idx += blockDim.x) {
            const int row = idx >> 3, c4 = idx & 7, i = i0 + 4 * c4;
            const bool ok = row < m && i < n;
            cp_async16(xs + swz(row, 4 * c4), ok ? xg + static_cast<size_t>(row) * n + i : xg,
                       ok ? 16 : 0);
        }
    } else {
        for (int idx = threadIdx.x; idx < m16 * kT; idx += blockDim.x) {
            const int row = idx >> 5, c = idx & 31, i = i0 + c;
            const bool ok = row < m && i < n;
            cp_async4(xs + swz(row, c), ok ? xg + static_cast<size_t>(row) * n + i : xg,
                      ok ? 4 : 0);
        }
    }
    cp_async_commit();
}

// The same for X stored in bf16 (``xs`` [m16][kSB]): vec16: n % 8 == 0 and
// X on 16 bytes, so 16-byte copies of 8 values; else plain loads and
// stores (cp.async copies 4 bytes at least), visible after the barrier
// that makes the tile visible.
__device__ __forceinline__ void load_x(const uint16_t* xg, int m, int n, int m16, int vec16, int tl,
                                       uint16_t* xs) {
    const int i0 = tl * kT;
    if (vec16) {
        for (int idx = threadIdx.x; idx < m16 * (kT / 8); idx += blockDim.x) {
            const int row = idx >> 2, c8 = idx & 3, i = i0 + 8 * c8;
            const bool ok = row < m && i < n;
            cp_async16(xs + row * kSB + 8 * c8, ok ? xg + static_cast<size_t>(row) * n + i : xg,
                       ok ? 16 : 0);
        }
    } else {
        for (int idx = threadIdx.x; idx < m16 * kT; idx += blockDim.x) {
            const int row = idx >> 5, c = idx & 31, i = i0 + c;
            xs[row * kSB + c] = row < m && i < n ? __ldg(xg + static_cast<size_t>(row) * n + i) : 0;
        }
    }
    cp_async_commit();
}

// The X tile element type of an instantiation: f32, or (XB) bf16 bits
template <bool XB>
using XElem = typename std::conditional<XB, uint16_t, float>::type;

// The tf32 parts of element (r, c) of a bf16 X tile: the value itself, and
// a zero low part
__device__ __forceinline__ uint32_t xb_bits(const uint16_t* xt, int r, int c) {
    return static_cast<uint32_t>(xt[r * kSB + c]) << 16;
}

// A [G, C, rows, cols] f32 tensor (a bias [G, C, cols] is one row, w_out
// [G, C, s, 1] one column): element (g, c, r, k) at p + g * sg + c * sc +
// r * sr + k * sk. K6 reads its step sizes and prior factors through sr and
// sk; every other tensor's trailing dims are contiguous (element (g, c, i)
// at at(v, g, c) + i).
struct Inst {
    const float* p;
    long long sg, sc, sr, sk;
};

__device__ __forceinline__ const float* at(const Inst& v, int g, int c) {
    return v.p + g * v.sg + c * v.sc;
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

// x ~ hi + lo: hi = tf32(x), lo = tf32(x - hi): the staged weights' split
__device__ __forceinline__ void split2(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32_rna(x);
    lo = tf32_rna(x - __uint_as_float(hi));
}

// x ~ hi + lo by integer operations on the bits, in fewer issue slots than
// cvt.rna (every operand but the staged weights): hi = x with its low 13
// bits cleared (toward zero), lo = x - hi (exact) rounded to tf32, to
// nearest with ties away (half a tf32 ulp added to the magnitude, the low
// 13 bits cleared). hi + lo is x to 2^-21 of |x| (split2: 2^-22); a NaN or
// an infinite x stays so in hi.
__device__ __forceinline__ void split2_int(float x, uint32_t& hi, uint32_t& lo) {
    hi = __float_as_uint(x) & 0xffffe000u;
    lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
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

// mma3_add where A is exact in tf32 (al = 0: a bf16 X value), so lh = 0:
// acc + (hh + hl), the bits of mma3_add on the same values
__device__ __forceinline__ void mma3_add_aexact(float (&acc)[4], const uint32_t (&ah)[4],
                                                uint32_t bh0, uint32_t bh1, uint32_t bl0,
                                                uint32_t bl1) {
    float hh[4], hl[4];
    mma_tf32_zero(hh, ah, bh0, bh1);
    mma_tf32_zero(hl, ah, bl0, bl1);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += hh[e] + hl[e];
}

// mma3_add where B is exact in tf32 (bl = 0), so hl = 0: acc + (hh + lh)
__device__ __forceinline__ void mma3_add_bexact(float (&acc)[4], const uint32_t (&ah)[4],
                                                const uint32_t (&al)[4], uint32_t bh0,
                                                uint32_t bh1) {
    float hh[4], lh[4];
    mma_tf32_zero(hh, ah, bh0, bh1);
    mma_tf32_zero(lh, al, bh0, bh1);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += hh[e] + lh[e];
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
// W1 as Z1's (K = k0, M = s) and with ``GRAD`` as dA0's (K = s, M = k0),
// b0, b1 and w_out as [K16] vectors. The entries past the real rows and
// columns stay as zero_frags left them. Warp w reads rows w, w + 4, ...,
// lane c column c (widths <= 32): coalesced, and every load of W1, the
// vectors and a batch of kBatch rows of W0 in flight at once (at the
// flagship all of them). Read through L2 only (__ldcg): K6 rewrites the
// weights inside its launch.
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

// The group's weight fragments zeroed (``tid`` its thread): their padding
// (rows past m, k0 or s, columns past k0 or s) is zero for every instance,
// and staging writes the rest. The caller syncs before staging.
template <int KM, bool DEEP, bool GRAD>
__device__ __forceinline__ void zero_frags(const Group<KM, DEEP, GRAD>& gs, int m8, int tid) {
    constexpr int MT = km16(KM) / 16, NT = KM / 8;
    float4* f4 = reinterpret_cast<float4*>(gs.w0f);
    const int n4 = ((m8 / 8) * MT + (DEEP ? (GRAD ? 2 : 1) * NT * MT : 0)) * 64;
    for (int i = tid; i < n4; i += kThreads) f4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
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
// buffer ``bp`` (f32 values, split here), or with XB of a bf16 X tile.
template <int MT, bool XB = false>
__device__ __forceinline__ void product_a(const float* frags, const XElem<XB>* bp, int ksteps,
                                          int col, float (&d)[MT][4]) {
    const int lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[mt][e] = 0.f;
#pragma unroll 4
    for (int kc = 0; kc < ksteps; ++kc) {
        uint32_t bh0, bh1, bl0, bl1;
        if constexpr (XB) {
            bh0 = xb_bits(bp, 8 * kc + t, col);
            bh1 = xb_bits(bp, 8 * kc + t + 4, col);
        } else {
            split2_int(bp[swz(8 * kc + t, col)], bh0, bl0);
            split2_int(bp[swz(8 * kc + t + 4, col)], bh1, bl1);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            uint32_t ah[4], al[4];
            ld_frag(frags + (kc * MT + mt) * 256, lane, ah, al);
            if constexpr (XB) {
                mma3_add_bexact(d[mt], ah, al, bh0, bh1);
            } else {
                mma3_add(d[mt], ah, al, bh0, bh1, bl0, bl1);
            }
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
// and split once per k-step for all NTU (with XB a bf16 X tile, read
// element by element: a0..a3 = (g, t), (g + 8, t), (g, t + 4), (g + 8,
// t + 4), exact in tf32); B rows ``brow`` + 8 u .. + 7 of ``bp`` (one
// ldmatrix for both column tiles); individuals as columns, f32 values split
// here.
template <int NTU, bool XB = false>
__device__ __forceinline__ void product_b(const XElem<XB>* ap, int arow, const float* bp, int brow,
                                          float (&acc)[NTU][4]) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int u = 0; u < NTU; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kT / 8; ++ks) {
        uint32_t raw[4], ah[4], al[4], bh[4], bl[4];
        if constexpr (XB) {
            const int g = lane >> 2, t = lane & 3;
#pragma unroll
            for (int r = 0; r < 4; ++r) ah[r] = xb_bits(ap, arow + g + 8 * (r & 1), 8 * ks + t + 4 * (r >> 1));
        } else {
            ldsm_x4(raw, ap + swz(arow + (lane & 15), 8 * ks + 4 * (lane >> 4)));
#pragma unroll
            for (int r = 0; r < 4; ++r) split2_int(__uint_as_float(raw[r]), ah[r], al[r]);
        }
        // matrices: (tile u, columns 8 ks .. + 3), (u, 8 ks + 4 .. + 7) per u
        const float* b = bp + swz(brow + 8 * (lane >> 4) + (lane & 7), 8 * ks + 4 * ((lane >> 3) & 1));
        if (NTU == 2) {
            ldsm_x4(raw, b);
        } else {
            ldsm_x2(raw, b);
        }
#pragma unroll
        for (int r = 0; r < 2 * NTU; ++r) split2_int(__uint_as_float(raw[r]), bh[r], bl[r]);
#pragma unroll
        for (int u = 0; u < NTU; ++u) {
            if constexpr (XB) {
                mma3_add_aexact(acc[u], ah, bh[2 * u], bh[2 * u + 1], bl[2 * u], bl[2 * u + 1]);
            } else {
                mma3_add(acc[u], ah, al, bh[2 * u], bh[2 * u + 1], bl[2 * u], bl[2 * u + 1]);
            }
        }
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

// The thread's sums over its individuals: db0, db1, dw_out per (tile mt,
// row half h) of units 16 mt + g + 8 h, and err^2
template <int MT>
struct Sums {
    float db0[MT][2], db1[MT][2], dwo[MT][2];
    double e2;
    __device__ __forceinline__ void zero() {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) db0[mt][h] = db1[mt][h] = dwo[mt][h] = 0.f;
        e2 = 0.0;
    }
};

// One tile of one chain by its group grp (4 warps): phase A (with OUT,
// y_pred of the tile's individuals below n into ``y``), then with GRAD err
// against the targets tg_a, tg_b of the thread's two individuals (with OUT
// its err^2 into the sums), the small sums, and phase B into the group's
// accumulators (``first``: the segment's first tile). xt: the X tile (bf16
// with XB).
template <int KM, bool DEEP, bool GRAD, int ACT, bool OUT, bool XB = false>
__device__ __forceinline__ void tile(const Group<KM, DEEP, GRAD>& gs, Sums<km16(KM) / 16>& sm,
                                     const XElem<XB>* xt, int m8, int m16, int n, int i0,
                                     float tg_a, float tg_b, bool first, int grp, float* y) {
    constexpr int K16 = km16(KM), MT = K16 / 16, NT = KM / 8, AS = acc_stride(KM);
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & (kWarps - 1), g = lane >> 2,
              t = lane & 3;
    const int col = 8 * w + 2 * t;
    const int i_a = i0 + col, i_b = i_a + 1;

    // ---- phase A: the warp's 8 individuals through the whole MLP
    float z0[MT][4], a0[MT][4];
    product_a<MT, XB>(gs.w0f, xt, m8 / 8, 8 * w + g, z0);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            z0[mt][e] += gs.b0s[16 * mt + g + 8 * (e >> 1)];
            a0[mt][e] = act_apply(ACT, z0[mt][e]);
        }
    float z1[MT][4], a1[MT][4];
    if (DEEP) {
        store_plane<MT>(gs.a0t, col, a0);
        __syncwarp();
        product_a<MT>(gs.w1a, gs.a0t, NT, 8 * w + g, z1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                z1[mt][e] += gs.b1s[16 * mt + g + 8 * (e >> 1)];
                a1[mt][e] = act_apply(ACT, z1[mt][e]);
            }
    }
    float p_a = 0.f, p_b = 0.f;
    if constexpr (DEEP) {
        pred_terms<MT>(a1, gs.wos, p_a, p_b);
    } else {
        pred_terms<MT>(a0, gs.wos, p_a, p_b);
    }
    // over the units of the other lanes with this t: every lane gets the same bits
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
        p_a += __shfl_xor_sync(0xffffffffu, p_a, o);
        p_b += __shfl_xor_sync(0xffffffffu, p_b, o);
    }
    if (OUT && g == 0) {
        if (i_a < n) y[i_a] = p_a;
        if (i_b < n) y[i_b] = p_b;
    }
    if constexpr (GRAD) {
        const float err[2] = {i_a < n ? p_a - tg_a : 0.f, i_b < n ? p_b - tg_b : 0.f};
        if (OUT && g == 0) {
            sm.e2 = fma(static_cast<double>(err[0]), static_cast<double>(err[0]), sm.e2);
            sm.e2 = fma(static_cast<double>(err[1]), static_cast<double>(err[1]), sm.e2);
        }
        float dz0[MT][4];
        if (DEEP) {
            float dz1[MT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int h = e >> 1;
                    const float er = err[e & 1];
                    dz1[mt][e] = gs.wos[16 * mt + g + 8 * h] * er * act_prime(ACT, z1[mt][e], a1[mt][e]);
                    sm.dwo[mt][h] = fmaf(a1[mt][e], er, sm.dwo[mt][h]);
                    sm.db1[mt][h] += dz1[mt][e];
                }
            store_plane<MT>(gs.dz1t, col, dz1);
            __syncwarp();
            float da[MT][4];
            product_a<MT>(gs.w1b, gs.dz1t, NT, 8 * w + g, da);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int e = 0; e < 4; ++e) dz0[mt][e] = da[mt][e] * act_prime(ACT, z0[mt][e], a0[mt][e]);
        } else {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int h = e >> 1;
                    const float er = err[e & 1];
                    dz0[mt][e] = gs.wos[16 * mt + g + 8 * h] * er * act_prime(ACT, z0[mt][e], a0[mt][e]);
                    sm.dwo[mt][h] = fmaf(a0[mt][e], er, sm.dwo[mt][h]);
                }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) sm.db0[mt][e >> 1] += dz0[mt][e];
        store_plane<MT>(gs.dz0t, col, dz0);
        group_sync(grp);  // every warp's planes of this chain are written

        // ---- phase B: dW0 = X dz0 and dW1 = a0^T dz1 over the tile, in
        // units of a row tile and NTU column tiles that share its A
        constexpr int NTU = NT >= 2 ? 2 : 1, NU = NT / NTU;
        const int u0 = (m16 / 16) * NU, u1 = DEEP ? MT * NU : 0;
        for (int u = w; u < u0 + u1; u += kWarps) {
            float acc[NTU][4];
            if (u < u0) {
                const int mt = u / NU, nt = (u - mt * NU) * NTU;
                product_b<NTU, XB>(xt, 16 * mt, gs.dz0t, 8 * nt, acc);
                add_tiles<NTU>(gs.acc0, AS, 16 * mt, 8 * nt, first, acc);
            } else {
                const int kt = (u - u0) / NU, nt = (u - u0 - kt * NU) * NTU;
                product_b<NTU>(gs.a0t, 16 * kt, gs.dz1t, 8 * nt, acc);
                add_tiles<NTU>(gs.acc1, AS, 16 * kt, 8 * nt, first, acc);
            }
        }
    }
}

// The group's gradient sums of one segment into its partial row ``part``
// (W0, b0, (W1, b1), w_out) and with OUT its err^2 into ``e2``: the small
// sums over the quad's lanes and the warps in order; the thread's sums
// restart at zero, the shared ones with the next first tile.
template <int KM, bool DEEP, bool OUT>
__device__ __forceinline__ void flush(const Group<KM, DEEP, true>& gs, Sums<km16(KM) / 16>& sm,
                                      float* part, double* e2, int m, int k0, int s, int grp) {
    constexpr int K16 = km16(KM), MT = K16 / 16, AS = acc_stride(KM);
    const int tid = threadIdx.x - grp * kThreads, lane = tid & 31, w = tid >> 5, g = lane >> 2,
              t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int o = 1; o < 4; o <<= 1) {
                sm.db0[mt][h] += __shfl_xor_sync(0xffffffffu, sm.db0[mt][h], o);
                sm.db1[mt][h] += __shfl_xor_sync(0xffffffffu, sm.db1[mt][h], o);
                sm.dwo[mt][h] += __shfl_xor_sync(0xffffffffu, sm.dwo[mt][h], o);
            }
    if (OUT) {
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) sm.e2 += __shfl_xor_sync(0xffffffffu, sm.e2, o);
    }
    if (t == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int u = 16 * mt + g + 8 * h;
                gs.red[(w * 3 + 0) * K16 + u] = sm.db0[mt][h];
                gs.red[(w * 3 + 1) * K16 + u] = sm.db1[mt][h];
                gs.red[(w * 3 + 2) * K16 + u] = sm.dwo[mt][h];
            }
    }
    if (OUT && lane == 0) gs.e2red[w] = sm.e2;
    group_sync(grp);
    const float* red = gs.red;
    auto warps = [&](int which, int u) {
        return ((red[which * K16 + u] + red[(3 + which) * K16 + u]) + red[(6 + which) * K16 + u]) +
               red[(9 + which) * K16 + u];
    };
    // the row: dW0 and dW1 a row of units per warp, the sums over units
    const int off_b0 = m * k0, off_w1 = off_b0 + k0, off_b1 = off_w1 + k0 * s;
    const int off_wo = DEEP ? off_b1 + s : off_w1;
    if (lane < k0) {
        for (int mm = w; mm < m; mm += kWarps) part[mm * k0 + lane] = gs.acc0[mm * AS + lane];
    }
    if (DEEP && lane < s) {
        for (int kk = w; kk < k0; kk += kWarps) part[off_w1 + kk * s + lane] = gs.acc1[kk * AS + lane];
    }
    if (tid < k0) part[off_b0 + tid] = warps(0, tid);
    if (DEEP && tid < s) part[off_b1 + tid] = warps(1, tid);
    if (tid < s) part[off_wo + tid] = warps(2, tid);
    if (OUT && tid == 0) *e2 = ((gs.e2red[0] + gs.e2red[1]) + gs.e2red[2]) + gs.e2red[3];
    sm.zero();
    group_sync(grp);
}

// One output's gradients and rss from its ``nseg`` segment rows (partial
// row0, row0 + stride, ...; their err^2 at the same indices of e2), 32
// columns x kSlices row slices per block of 32 kSlices threads (blockIdx.x:
// the block of columns): slice sl adds rows sl, sl + kSlices, ... from zero,
// then the slices are added in order; column P is rss, in f64.
__device__ __forceinline__ void reduce_rows(const float* partial, const double* e2, int P,
                                            long long row0, int stride, int nseg, float* grads,
                                            float* rss) {
    __shared__ float s_f[kSlices][32];
    __shared__ double s_d[kSlices];
    const int c = threadIdx.x & 31, sl = threadIdx.x >> 5;
    const int p = blockIdx.x * 32 + c;
    float sum = 0.f;
    double d = 0.0;
    if (p < P) {
        const float* part = partial + static_cast<size_t>(row0) * P + p;
#pragma unroll 4
        for (int q = sl; q < nseg; q += kSlices)
            sum += __ldcg(part + static_cast<size_t>(q) * stride * P);
    } else if (p == P) {
        for (int q = sl; q < nseg; q += kSlices) d += __ldcg(e2 + row0 + static_cast<long long>(q) * stride);
        s_d[sl] = d;
    }
    s_f[sl][c] = sum;
    __syncthreads();
    if (sl == 0) {
        if (p < P) {
            float tot = s_f[0][c];
#pragma unroll
            for (int k = 1; k < kSlices; ++k) tot += s_f[k][c];
            grads[p] = tot;
        } else if (p == P) {
            double tot = s_d[0];
#pragma unroll
            for (int k = 1; k < kSlices; ++k) tot += s_d[k];
            *rss = static_cast<float>(tot);
        }
    }
}

}  // namespace vg
}  // namespace rsbann
