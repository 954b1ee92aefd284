// K2: fused packed layer 0, out[g, i, :] = act(decode(bytes[g])[:, i]^T A[g] + off[g]),
// and K9a: the unfused product Z[g, i, :] = decode(bytes[g])[:, i]^T A[g].
//
// K2 replaces rs_bann_tpu/ops/packed_matmul.py::_fwd_fused_kernel (called
// through _pallas_fwd_fused and packed_linear). A = w_scale * W0 and
// off = b0 - shift @ A fold the standardization in, so the dense
// standardized genotype matrix and the layer-0 pre-activation never reach
// device memory. K9a replaces ::_fwd_kernel (_pallas_fwd, packed_matmul):
// the same kernel without the epilogue (EPI = false), for layer 0 under
// silu, whose derivative cannot be rebuilt from the output, so the caller
// keeps the pre-activation. Bounds at the silu hybrid value-pass shape
// (bytes [10, 104, 25088], k = C * 16 = 64): 1.3e10 FLOP, 0.20 ms (ops).
//
// What bounds it on the H100: per marker a thread reads one byte and does
// 4 * KC FMAs. A call at the slice's shape (G = 100, m = 104, k = 16,
// n = 100,352 padded) is 16.7 GFMA (0.50 ms at the 67 TFLOP/s f32 peak)
// against 0.26 GB of bytes read and 0.64 GB of f32 output written (0.27 ms
// at 3.35 TB/s), so f32 FMA issue on the CUDA cores bounds it; the tensor
// cores (bf16 or TF32 operands) are a later step.
//
// Design: grid (n / 512 groups, G, ceil(k / KC)); one 128-thread block per
// strided group of 512 individuals of one branch. Thread j reads byte
// column j of each marker row (coalesced 128-byte rows), decodes its four
// individuals with K1 and accumulates 4 x KC sums in registers. The block's
// slice of A sits in shared memory and is read as broadcast float4s.
// The TPU kernel's sequential m-tile accumulation becomes the loop over
// markers inside the block; no sum crosses blocks, so the result does not
// depend on scheduling. Rows past n are never written.
#include <cuda_runtime.h>

#include <cstdint>

#include "packed_decode.cuh"

namespace {

using namespace rsbann;

constexpr int KC = 16;  // output features per block (grid z covers wider k)

template <bool EPI>
__global__ void __launch_bounds__(kGBytes)
packed_linear_kernel(const uint8_t* __restrict__ bytes, const float* __restrict__ a,
                     const float* __restrict__ off, float* __restrict__ out, int m,
                     int B, int k, int n, int act) {
    extern __shared__ float4 a_s4[];  // [m][KC] floats
    float* a_s = reinterpret_cast<float*>(a_s4);
    const int grp = blockIdx.x;
    const int g = blockIdx.y;
    const int k0 = blockIdx.z * KC;
    const int j = threadIdx.x;

    const float* a_g = a + static_cast<size_t>(g) * m * k;
    for (int idx = j; idx < m * KC; idx += blockDim.x) {
        const int mm = idx / KC;
        const int kk = k0 + idx % KC;
        a_s[idx] = kk < k ? a_g[static_cast<size_t>(mm) * k + kk] : 0.f;
    }
    __syncthreads();

    float acc[4][KC];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) acc[q][kk] = 0.f;

    const uint8_t* col =
        bytes + static_cast<size_t>(g) * m * B + static_cast<size_t>(grp) * kGBytes + j;
    for (int mm = 0; mm < m; ++mm) {
        const uint32_t byte = col[static_cast<size_t>(mm) * B];
        float x[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) x[q] = decode_part(byte, q);
        const float4* w4 = a_s4 + mm * (KC / 4);
#pragma unroll
        for (int v = 0; v < KC / 4; ++v) {
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

    const float* off_g = EPI ? off + static_cast<size_t>(g) * k : nullptr;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int i = grp * kGroup + q * kGBytes + j;
        if (i >= n) continue;
        float* o = out + (static_cast<size_t>(g) * n + i) * k;
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
            if (k0 + kk < k) {
                o[k0 + kk] = EPI ? act_apply(act, acc[q][kk] + off_g[k0 + kk]) : acc[q][kk];
            }
        }
    }
}

template <bool EPI>
int launch(const void* bytes, const void* a, const void* off, void* out, int G, int m, int B,
           int k, int n, int act, void* stream) {
    const dim3 grid(B / kGBytes, G, (k + KC - 1) / KC);
    const size_t smem = static_cast<size_t>(m) * KC * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            packed_linear_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    packed_linear_kernel<EPI><<<grid, kGBytes, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(bytes), static_cast<const float*>(a),
        static_cast<const float*>(off), static_cast<float*>(out), m, B, k, n, act);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bytes u8 [G, m, B] (group-strided, B a multiple of 128); a f32 [G, m, k];
// off f32 [G, k]; out f32 [G, n, k]. All contiguous, on one device.
extern "C" int packed_linear_f32(const void* bytes, const void* a, const void* off,
                                 void* out, int G, int m, int B, int k, int n, int act,
                                 void* stream) {
    return launch<true>(bytes, a, off, out, G, m, B, k, n, act, stream);
}

// K9a: as packed_linear_f32 with no offset and no activation.
extern "C" int packed_matmul_f32(const void* bytes, const void* a, void* out, int G, int m,
                                 int B, int k, int n, void* stream) {
    return launch<false>(bytes, a, nullptr, out, G, m, B, k, n, 0, stream);
}
