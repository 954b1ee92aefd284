// K3 and K9b: the packed layer 0's backward, dA[g] = decode(bytes[g])[:, :n] dz[g].
//
// K3 replaces rs_bann_tpu/ops/packed_matmul.py::_bwd_fused_kernel (called
// through _pallas_bwd_fused, the VJP of packed_linear): dz = g * h'(out) is
// formed in registers from the saved output of the fused forward (K2), and
// d_off[g] = sum_i dz[g, i] comes out beside dA. K9b replaces ::_bwd_kernel
// (_pallas_bwd, the VJP of packed_matmul): dz = g, no d_off; the port
// reaches it only for silu, since K3 takes any m (the TPU kernel needs one
// marker tile and falls back to K9b otherwise). One template, FUSED on or
// off.
//
// What bounds it on the H100: the contraction runs over n individuals into
// a small [m, k] output. At G = 100, m = 104, n = 100,352 padded, k = 16 it
// is 16.7 GFMA, 0.50 ms at the 67 TFLOP/s f32 peak, against 1.55 GB of
// input for K3 (g and out 0.64 GB each, the bytes 0.26 GB; 0.46 ms at
// 3.35 TB/s) and 0.9 GB for K9b (0.27 ms): f32 FMA issue bounds both, with
// K3's bytes close behind.
//
// Design: the TPU kernel carries one accumulator across a sequential grid
// over n. Here a block owns (chunk of consecutive strided groups, branch,
// tile of 128 markers x 16 features) and writes a partial sum; a second
// kernel adds the chunks' partials in chunk order (no float atomics, so a
// repeat gives the same bits). Per group the block stages the group's 512
// rows of dz (16 features) in shared memory once for all its markers,
// masking rows past n to 0 (the caller's g and out have n rows, no
// padding); h'(out) and the d_off partial are taken while staging. Each of
// the 64 threads owns 2 markers and reads their bytes as 16-byte words
// straight from device memory; a byte is decoded once and its four
// individuals (parts q = 0..3, rows q * 128 + j of the group) each update
// 2 x 16 accumulators from one broadcast row of dz.
#include <cuda_runtime.h>

#include <cstdint>

#include "packed_decode.cuh"

namespace {

using namespace rsbann;

constexpr int KC = 16;        // features per block (grid z covers wider k)
constexpr int kThreads = 64;  // threads per block
constexpr int MPT = 2;        // markers per thread
constexpr int TM = kThreads * MPT;  // markers per block

// h'(z) rebuilt from a = h(z) for the fused activations, with the
// subgradient 0 at a = 0 (ops/activations.py prime_from_out).
__device__ __forceinline__ float act_prime_from_out(int act, float a) {
    switch (act) {
        case 1:
            return a > 0.f ? 1.f : 0.f;
        case 2:
            return a > 0.f ? 1.f : (a < 0.f ? 0.01f : 0.f);
        case 3:
            return 1.f - a * a;
        default:
            return 1.f;
    }
}

__device__ __forceinline__ uint32_t byte_of(const uint4& w, int b) {
    const uint32_t word = b < 4 ? w.x : (b < 8 ? w.y : (b < 12 ? w.z : w.w));
    return (word >> (8 * (b & 3))) & 0xffu;
}

template <bool FUSED>
__global__ void __launch_bounds__(kThreads)
packed_bwd_kernel(const uint8_t* __restrict__ bytes, const float* __restrict__ gz,
                  const float* __restrict__ res, float* __restrict__ part,
                  float* __restrict__ doff_part, int m, int B, int k, int n, int act, int gpc,
                  int chunks, int mtiles) {
    __shared__ float4 dz_s4[kGroup * KC / 4];  // [512 rows][KC]
    __shared__ float red_s[kThreads];
    float* dz_s = reinterpret_cast<float*>(dz_s4);
    const int chunk = blockIdx.x;
    const int g = blockIdx.y;
    const int mt = blockIdx.z % mtiles;
    const int k0 = (blockIdx.z / mtiles) * KC;
    const int t = threadIdx.x;
    const int c = t % KC;  // the feature this thread stages (kThreads % KC == 0)
    const int ngroups = B / kGBytes;
    const int grp0 = chunk * gpc;
    const int grp1 = min(grp0 + gpc, ngroups);

    float acc[MPT][KC];
#pragma unroll
    for (int p = 0; p < MPT; ++p)
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) acc[p][kk] = 0.f;
    float dacc = 0.f;

    const uint8_t* rows[MPT];
    bool valid[MPT];
#pragma unroll
    for (int p = 0; p < MPT; ++p) {
        const int mm = mt * TM + p * kThreads + t;
        valid[p] = mm < m;
        rows[p] = bytes + (static_cast<size_t>(g) * m + (valid[p] ? mm : 0)) * B;
    }
    const size_t gbase = static_cast<size_t>(g) * n * k;

    for (int grp = grp0; grp < grp1; ++grp) {
        __syncthreads();  // the previous group's rows are consumed
        for (int idx = t; idx < kGroup * KC; idx += kThreads) {
            const int i = grp * kGroup + idx / KC;
            float v = 0.f;
            if (i < n && k0 + c < k) {
                const size_t o = gbase + static_cast<size_t>(i) * k + k0 + c;
                v = gz[o];
                if (FUSED) v *= act_prime_from_out(act, res[o]);
            }
            dz_s[idx] = v;
            if (FUSED) dacc += v;
        }
        __syncthreads();

        for (int v = 0; v < kGBytes / 16; ++v) {
            uint4 w[MPT];
#pragma unroll
            for (int p = 0; p < MPT; ++p) {
                // invalid markers read code 01 (genotype 0); never written
                w[p] = valid[p] ? __ldg(reinterpret_cast<const uint4*>(
                                      rows[p] + static_cast<size_t>(grp) * kGBytes) + v)
                                : make_uint4(0x55555555u, 0x55555555u, 0x55555555u,
                                             0x55555555u);
            }
#pragma unroll
            for (int b = 0; b < 16; ++b) {
                const int j = 16 * v + b;
                uint32_t by[MPT];
#pragma unroll
                for (int p = 0; p < MPT; ++p) by[p] = byte_of(w[p], b);
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const float4* d4 = dz_s4 + (q * kGBytes + j) * (KC / 4);
                    float x[MPT];
#pragma unroll
                    for (int p = 0; p < MPT; ++p) x[p] = decode_part(by[p], q);
#pragma unroll
                    for (int u = 0; u < KC / 4; ++u) {
                        const float4 d = d4[u];
#pragma unroll
                        for (int p = 0; p < MPT; ++p) {
                            acc[p][4 * u + 0] = fmaf(x[p], d.x, acc[p][4 * u + 0]);
                            acc[p][4 * u + 1] = fmaf(x[p], d.y, acc[p][4 * u + 1]);
                            acc[p][4 * u + 2] = fmaf(x[p], d.z, acc[p][4 * u + 2]);
                            acc[p][4 * u + 3] = fmaf(x[p], d.w, acc[p][4 * u + 3]);
                        }
                    }
                }
            }
        }
    }

#pragma unroll
    for (int p = 0; p < MPT; ++p) {
        const int mm = mt * TM + p * kThreads + t;
        if (!valid[p]) continue;
        float* dst = part + ((static_cast<size_t>(g) * chunks + chunk) * m + mm) * k;
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
            if (k0 + kk < k) dst[k0 + kk] = acc[p][kk];
        }
    }
    if (FUSED && mt == 0) {
        red_s[t] = dacc;
        __syncthreads();
        if (t < KC && k0 + t < k) {
            float s = 0.f;
            for (int u = 0; u < kThreads / KC; ++u) s += red_s[u * KC + t];
            doff_part[(static_cast<size_t>(g) * chunks + chunk) * k + k0 + t] = s;
        }
    }
}

// da[g, mm, kk] = sum over chunks, in chunk order, of part[g, chunk, mm, kk];
// then d_off likewise from doff_part (when given).
__global__ void packed_bwd_reduce(const float* __restrict__ part,
                                  const float* __restrict__ doff_part, float* __restrict__ da,
                                  float* __restrict__ doff, int G, int m, int k, int chunks) {
    const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    const size_t nda = static_cast<size_t>(G) * m * k;
    if (idx < nda) {
        const size_t g = idx / (static_cast<size_t>(m) * k);
        const size_t r = idx % (static_cast<size_t>(m) * k);
        const float* src = part + g * chunks * m * k + r;
        float s = 0.f;
        for (int ch = 0; ch < chunks; ++ch) s += src[static_cast<size_t>(ch) * m * k];
        da[idx] = s;
    } else if (doff != nullptr && idx < nda + static_cast<size_t>(G) * k) {
        const size_t j = idx - nda;
        const size_t g = j / k;
        const size_t kk = j % k;
        const float* src = doff_part + g * chunks * k + kk;
        float s = 0.f;
        for (int ch = 0; ch < chunks; ++ch) s += src[static_cast<size_t>(ch) * k];
        doff[j] = s;
    }
}

}  // namespace

// Markers per block, so the wrapper can size the grid and the partials.
extern "C" int packed_bwd_tile_m() { return TM; }

// bytes u8 [G, m, B] (group-strided, B a multiple of 128); gz f32 [G, n, k];
// res f32 [G, n, k] (the forward's output; read only when fused); scratch
// part f32 [G, chunks, m, k] and doff_part f32 [G, chunks, k]; outputs
// da f32 [G, m, k] and doff f32 [G, k] (doff only when fused). ``gpc``
// strided groups per chunk, chunks = ceil(B / 128 / gpc). All contiguous.
extern "C" int packed_bwd_f32(const void* bytes, const void* gz, const void* res, void* part,
                              void* doff_part, void* da, void* doff, int G, int m, int B, int k,
                              int n, int act, int fused, int gpc, int chunks, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int mtiles = (m + TM - 1) / TM;
    const dim3 grid(chunks, G, mtiles * ((k + KC - 1) / KC));
    const auto* b8 = static_cast<const uint8_t*>(bytes);
    const auto* g32 = static_cast<const float*>(gz);
    const auto* r32 = static_cast<const float*>(res);
    if (fused) {
        packed_bwd_kernel<true><<<grid, kThreads, 0, s>>>(
            b8, g32, r32, static_cast<float*>(part), static_cast<float*>(doff_part), m, B, k, n,
            act, gpc, chunks, mtiles);
    } else {
        packed_bwd_kernel<false><<<grid, kThreads, 0, s>>>(
            b8, g32, nullptr, static_cast<float*>(part), nullptr, m, B, k, n, act, gpc, chunks,
            mtiles);
    }
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t total =
        static_cast<size_t>(G) * m * k + (fused ? static_cast<size_t>(G) * k : 0);
    const int threads = 256;
    packed_bwd_reduce<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0, s>>>(
        static_cast<const float*>(part), static_cast<const float*>(doff_part),
        static_cast<float*>(da), fused ? static_cast<float*>(doff) : nullptr, G, m, k, chunks);
    return static_cast<int>(cudaGetLastError());
}
