// Tensor-core helpers shared by the packed kernels that run their f32
// products as exact bf16 MMAs: K2 and K9a (packed_linear.cu), K4's depth-0
// kernel (branch_vg_packed.cu), and K3 and K9b (packed_bwd.cu), whose
// product X dz is K4's gradient.
//
// A genotype (0, 1 or 2) is exact in bf16. Each f32 operand a is split into
// three bf16 parts, hi = bf16(a), mid = bf16(a - hi), lo = bf16(a - hi - mid),
// with hi + mid + lo == a exactly (finite a whose parts stay normal), so the
// three mma.sync.m16n8k16 of a fragment into one f32 accumulator give exact
// products and only the order of the f32 sums differs from a plain version.
//
// The decode goes from 2-bit codes straight to bf16 bits with prmt: a
// selector nibble pair (4 + c, c) for code c picks the low and the high byte
// of the genotype's bf16 bits from the two lookup words, so no I2F.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace rsbann {

// bf16 bits of genotype code c: byte c of kLutHi is the high byte, byte c of
// kLutLo the low byte (00 -> 2.0 = 0x4000, 10 -> 1.0 = 0x3F80, else 0).
constexpr uint32_t kLutHi = 0x003F0040u;
constexpr uint32_t kLutLo = 0x00800000u;

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
    uint32_t d;
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
    return d;
}

// Two genotypes as bf16x2, from the prmt selectors of their codes (the low
// 16 bits of ``sel``, built by ``selectors``).
__device__ __forceinline__ uint32_t decode_pair(uint32_t sel) {
    return prmt(kLutHi, kLutLo, sel);
}

// The prmt selectors of part q of the four bytes of ``pair``: per byte,
// nibbles (4 + c, c) for its code c, which pick the low and the high byte
// of the genotype's bf16 bits.
__device__ __forceinline__ uint32_t selectors(uint32_t pair, int q) {
    return ((pair >> (2 * q)) & 0x03030303u) * 0x11u + 0x04040404u;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = A B, from a zero accumulator.
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// acc += A (hi + mid + lo) for one fragment, rounded to nearest. The tensor
// cores' f32 accumulation cuts toward zero, so a run of MMAs into one
// accumulator, or even one MMA that adds the small parts to the large, drifts
// toward zero; summed over many individuals that drift shows wherever the
// sums cancel. Here the hi MMA runs alone from a zero accumulator (16
// products of at most 10 significant bits: exact), lo then mid into a
// second one (their cut is 2^-8 of hi's scale below f32's), and the two join
// the sum by round-to-nearest f32 adds.
__device__ __forceinline__ void mma_split3_add(float (&acc)[4], const uint32_t (&a)[4],
                                               const uint2 (&b)[3]) {
    float hi[4], ml[4];
    mma_bf16_zero(hi, a, b[0].x, b[0].y);
    mma_bf16_zero(ml, a, b[2].x, b[2].y);
    mma_bf16(ml, a, b[1].x, b[1].y);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += hi[e] + ml[e];
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
                 "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// Position of local marker u (0..15) of a chunk in the weight planes: the
// MMA's K index 2 * tig + {0, 1} holds markers tig and tig + 4, and
// 2 * tig + 8 + {0, 1} markers tig + 8 and tig + 12, at positions 4 * tig .. + 3.
__device__ __forceinline__ int k_position(int u) { return 4 * (u & 3) + (u >> 2); }

// The three bf16 parts of v, hi + mid + lo == v.
__device__ __forceinline__ void split3(float v, __nv_bfloat16& hi, __nv_bfloat16& mid,
                                       __nv_bfloat16& lo) {
    hi = __float2bfloat16_rn(v);
    const float r1 = v - __bfloat162float(hi);
    mid = __float2bfloat16_rn(r1);
    lo = __float2bfloat16_rn(r1 - __bfloat162float(mid));
}

// The gradient X dz (K4's dW0', K3's dA) as MMAs with markers as rows and
// individuals as the reduction. A k-step takes byte column c_tig of four
// adjacent ones (tig = 0..3): K index 2 tig + {0, 1} holds parts 0 and 1 of
// c_tig, 2 tig + 8 + {0, 1} parts 2 and 3, so one 32-bit shared load of a
// marker row feeds four k-steps, and dz is staged in three bf16 planes in
// the same order.
//
// The A fragment of k-step b from the 32-bit words wr (marker r) and wr8
// (marker r + 8) of byte columns 4 tig .. 4 tig + 3: byte b of each.
__device__ __forceinline__ void grad_a_frag(uint32_t wr, uint32_t wr8, int b, uint32_t (&af)[4]) {
    // bytes [x_r, x_r, x_r8, x_r8], then the codes of parts (0, 1) and (2, 3) of each
    const uint32_t pb = prmt(wr, wr8, b * 0x0011u + (4 + b) * 0x1100u);
    const uint32_t s01 = ((pb & 0x00030003u) | ((pb >> 2) & 0x03000300u)) * 0x11u + 0x04040404u;
    const uint32_t s23 =
        (((pb >> 4) & 0x00030003u) | ((pb >> 6) & 0x03000300u)) * 0x11u + 0x04040404u;
    af[0] = decode_pair(s01);        // marker r, parts 0, 1
    af[1] = decode_pair(s01 >> 16);  // marker r + 8
    af[2] = decode_pair(s23);        // marker r, parts 2, 3
    af[3] = decode_pair(s23 >> 16);  // marker r + 8
}

// dz of the four parts of one byte column, split into three bf16 planes:
// one 8-byte unit per plane, parts (0, 1) then (2, 3), as the B fragment
// reads them. ``dst`` is plane 0's unit; the planes lie ``plane`` words
// apart. split3 two parts at a time: one cvt.rn.bf16x2.f32 rounds both.
__device__ __forceinline__ void store_split3x4(uint32_t* dst, int plane, const float (&v)[4]) {
    uint32_t w[3][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2 * h], v[2 * h + 1]);
        const float2 hf = __bfloat1622float2(hi);
        const float r0 = v[2 * h] - hf.x, r1 = v[2 * h + 1] - hf.y;
        const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
        const float2 mf = __bfloat1622float2(mid);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
        w[0][h] = *reinterpret_cast<const uint32_t*>(&hi);
        w[1][h] = *reinterpret_cast<const uint32_t*>(&mid);
        w[2][h] = *reinterpret_cast<const uint32_t*>(&lo);
    }
#pragma unroll
    for (int pl = 0; pl < 3; ++pl)
        *reinterpret_cast<uint2*>(dst + pl * plane) = make_uint2(w[pl][0], w[pl][1]);
}

// The B fragments of one k-step, all NT column tiles, three planes: ``d``
// is the word of column r at the k-step's byte column, the columns
// ``stride`` words apart, each plane 8 NT columns.
template <int NT>
__device__ __forceinline__ void grad_b_frags(const uint32_t* d, int stride, uint2 (&bf)[NT][3]) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int pl = 0; pl < 3; ++pl)
            bf[nt][pl] = *reinterpret_cast<const uint2*>(d + (pl * 8 * NT + nt * 8) * stride);
}

}  // namespace rsbann
