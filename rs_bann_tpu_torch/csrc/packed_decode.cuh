// K1: 2-bit genotype decode, shared by every packed kernel.
//
// Replaces rs_bann_tpu/ops/packed_matmul.py::_kernel_decode_part.
//
// Layout (pack_strided): individuals come in groups of 512; byte column j
// of a group holds individuals j, j+128, j+256 and j+384 in bit pairs
// (0, 2, 4, 6). So thread j of a 128-thread block reads one byte per
// marker and gets its four individuals, one per "part" q, and the 128
// threads together cover the group in natural order.
//
// Value map {00->2, 01->0 (missing), 10->1, 11->0}, decoded by prmt from
// two lookup words (packed_mma.cuh, traj_packed.cu genotype_sel).
// Individuals past n carry code 01 and decode to 0.
//
// Also the activations, the width class and the depth-0/1 flat parameter
// layout that the value-and-gradient kernels share.
#pragma once

#include <cstdint>

namespace rsbann {

constexpr int kGroup = 512;   // individuals per strided group
constexpr int kGBytes = 128;  // bytes per marker per group

// Activation codes shared with the Python wrappers (ops/activations.py
// ACT_CODES): 0 identity, 1 relu, 2 leaky_relu, 3 tanh, 4 silu. Written as
// the JAX package writes them (z * (z > 0) etc.), so NaN propagates.
__device__ __forceinline__ float act_apply(int act, float z) {
    switch (act) {
        case 1:
            return z * (z > 0.f ? 1.f : 0.f);
        case 2:
            return z * (z > 0.f ? 1.f : 0.f) + 0.01f * z * (z < 0.f ? 1.f : 0.f);
        case 3:
            return tanhf(z);
        case 4:
            return z * (1.f / (1.f + expf(-z)));
        default:
            return z;
    }
}

// h'(z) given the pre-activation z and a = h(z).
__device__ __forceinline__ float act_prime(int act, float z, float a) {
    switch (act) {
        case 1:
            return z > 0.f ? 1.f : 0.f;
        case 2:
            return z > 0.f ? 1.f : (z < 0.f ? 0.01f : 0.f);
        case 3:
            return 1.f - a * a;
        case 4: {
            const float s = 1.f / (1.f + expf(-z));
            return s * (1.f + z * (1.f - s));
        }
        default:
            return 1.f;
    }
}

// Padded register width of layers of widths k0 and s, or -1 above 32.
inline int pick_km(int k0, int s) {
    const int w = k0 > s ? k0 : s;
    if (w <= 8) return 8;
    if (w <= 16) return 16;
    if (w <= 32) return 32;
    return -1;
}

// Length of one branch's flat parameter vector: W0 [m, k0], b0 [k0],
// (W1 [k0, s], b1 [s] at depth 1), w_out [s].
inline int partial_size(int m, int k0, int s, bool deep) {
    return m * k0 + k0 + (deep ? k0 * s + s : 0) + s;
}

}  // namespace rsbann
