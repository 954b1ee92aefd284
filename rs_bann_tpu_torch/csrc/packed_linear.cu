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
// keeps the pre-activation.
//
// What bounds it on the H100: the bytes. At the folded value pass (bytes
// [10, 104, 25088], k = C * 10 live columns = 40) it reads 26 MB of
// genotypes and writes 160 MB of f32 output: 0.056 ms at 3.35 TB/s, against
// 0.025 ms of tensor-core work (3 bf16 products per f32 one at 989
// TFLOP/s); at the slice's shape (G = 100, k = 16) 902 MB, 0.269 ms,
// against 0.101 ms. The products on the f32 CUDA cores alone would take
// 0.12 and 0.50 ms (67 TFLOP/s), so the design moves them to the tensor
// cores and makes the output stores whole.
//
// Exact f32 products on bf16 tensor cores. The genotype (0, 1 or 2) is
// exact in bf16. Each weight is split into three bf16 parts, hi = bf16(a),
// mid = bf16(a - hi), lo = bf16(a - hi - mid), with hi + mid + lo == a
// exactly (finite a whose parts stay normal); each fragment takes three
// mma.sync.m16n8k16 into the same f32 accumulators, so every product is
// exact and only the order of the f32 sums differs from the plain version.
//
// Design. One wave of CTAs of 4 warps; each owns an equal run of the
// (branch g, tile) items in order, a tile being 64 byte columns of one
// strided group, i.e. 4 parts q of 64 consecutive individuals. The CTA
// stages A[g] as three bf16 planes [column][marker] in shared memory once
// per branch of its run (one or two), then for each tile:
//  * the [m x 64] byte tile comes by cp.async into one of two buffers while
//    the other one is computed;
//  * warp w takes byte columns 16w..16w+15: one m16n8k16 A fragment per
//    part q (16 individuals x 16 markers), so each byte read from shared
//    memory feeds 4 fragments, and all k columns (NT tiles of 8) at once, so
//    each byte is decoded once;
//  * decode straight to bf16 bits with prmt (codes 00, 10 -> 0x4000, 0x3F80,
//    01 and 11 -> 0): no I2F. The MMA's K order is a permutation of the 16
//    markers of a chunk, and its M order one of the 16 byte columns, chosen
//    so a thread's markers tig, tig+4, tig+8, tig+12 sit in its registers as
//    the fragment wants them, the byte loads hit no bank twice, and the
//    weight fragment is one 8-byte load per plane;
//  * epilogue: off and act in registers (K2), the 16 x k result of each part
//    staged in the warp's shared memory and written as 16-byte stores: the
//    16 rows are consecutive output rows, 16 * k * 4 contiguous bytes.
// Rows past n are never written. The order of every sum is fixed and no
// float atomics are used, so repeats are bit-identical.
//
// Shapes: any m, k, B a multiple of 128, n <= 4 * B. A branch's markers go
// in slabs that fit shared memory (one slab for m_pad up to 1,000-1,800 at
// the main path's widths); k above 64 goes in passes of 64 columns. With
// more than one slab or pass the CTA restages its weights per step. The
// launch picks NT, the slabs and the grid from the shape alone
// (packed_linear_plan).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "packed_decode.cuh"
#include "packed_mma.cuh"

namespace {

using namespace rsbann;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileBytes = 64;   // byte columns per tile: 16 per warp
constexpr int kRowStride = 80;   // shared bytes per marker row of a byte tile
constexpr int kSmemBudget = 232448 / 2 - 1024;  // two CTAs per SM

struct Args {
    const uint8_t* bytes;
    const float* a;
    const float* off;
    float* out;
    int m, B, k, n, act;
    int G;
    int tiles;        // tiles of a branch that hold an individual below n
    int ms;           // markers per slab (a multiple of 16)
    int nslabs;
    int npass;        // passes of 8 * NT columns
    int wstride;      // bf16 per weight row in shared memory
    int kp;           // floats per staged output row
    int stage;        // floats of one warp's output stage
};

template <int NT>
__device__ void stage_weights(const Args& p, int g, int pass, int slab, __nv_bfloat16* w_s) {
    constexpr int CT = 8 * NT;
    const int c0 = pass * CT, m0 = slab * p.ms;
    const float* a_g = p.a + static_cast<size_t>(g) * p.m * p.k;
    const int plane = CT * p.wstride;
    for (int idx = threadIdx.x; idx < p.ms * CT; idx += kThreads) {
        const int mk = idx / CT, c = idx - mk * CT;
        const int gm = m0 + mk, gc = c0 + c;
        const float v = (gm < p.m && gc < p.k) ? a_g[static_cast<size_t>(gm) * p.k + gc] : 0.f;
        const __nv_bfloat16 hi = __float2bfloat16_rn(v);
        const float r1 = v - __bfloat162float(hi);
        const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
        const __nv_bfloat16 lo = __float2bfloat16_rn(r1 - __bfloat162float(mid));
        const int at = c * p.wstride + (mk & ~15) + k_position(mk & 15);
        w_s[at] = hi;
        w_s[plane + at] = mid;
        w_s[2 * plane + at] = lo;
    }
}

// Copy ``rows`` x ``w`` floats from the stage (row stride kp) to global rows
// of stride k, consecutive lanes on consecutive addresses: 16-byte units
// when k is a multiple of 4, else 4-byte ones.
__device__ __forceinline__ void copy_out(const float* st, float* dst, int rows, int w, int kp,
                                         int k, bool vec, int lane) {
    const int U = vec ? w / 4 : w;  // units per row
    const int total = rows * U;
    int row = lane / U, col = lane - row * U;
    const int drow = 32 / U, dcol = 32 - drow * U;
    for (int e = lane; e < total; e += 32) {
        if (vec) {
            *reinterpret_cast<float4*>(dst + static_cast<size_t>(row) * k + 4 * col) =
                *reinterpret_cast<const float4*>(st + row * kp + 4 * col);
        } else {
            dst[static_cast<size_t>(row) * k + col] = st[row * kp + col];
        }
        col += dcol;
        row += drow;
        if (col >= U) {
            col -= U;
            ++row;
        }
    }
}

// The warp's 4 parts x 16 rows of one pass: epilogue in registers, staged
// per part, then written out.
template <bool EPI, int NT, int ACT>
__device__ __forceinline__ void epilogue(const Args& p, int g, int t, int pass,
                                         float (&acc)[4][NT][4], float* st) {
    constexpr int CT = 8 * NT;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int r = lane >> 2, tig = lane & 3;
    const int c0 = pass * CT;
    const int w = min(CT, p.k - c0);
    float o[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
        const int col = nt * 8 + 2 * tig;
        o[nt][0] = (EPI && col < w) ? p.off[static_cast<size_t>(g) * p.k + c0 + col] : 0.f;
        o[nt][1] = (EPI && col + 1 < w) ? p.off[static_cast<size_t>(g) * p.k + c0 + col + 1] : 0.f;
    }
    const bool vec = (p.k & 3) == 0;
    const int grp = t >> 1, half = t & 1;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int row0 = grp * kGroup + q * kGBytes + half * kTileBytes + warp * 16;
        const int rows = min(16, p.n - row0);
        if (rows <= 0) continue;  // warp-uniform
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            const int col = nt * 8 + 2 * tig;
            if (col >= w) continue;
            float v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                v[e] = EPI ? act_apply(ACT, acc[q][nt][e] + o[nt][e & 1]) : acc[q][nt][e];
            }
            // logical row r is byte column 2r, row r + 8 byte column 2r + 1
            float* s0 = st + (2 * r) * p.kp + col;
            float* s1 = s0 + p.kp;
            if (col + 1 < w) {
                *reinterpret_cast<float2*>(s0) = make_float2(v[0], v[1]);
                *reinterpret_cast<float2*>(s1) = make_float2(v[2], v[3]);
            } else {
                s0[0] = v[0];
                s1[0] = v[2];
            }
        }
        __syncwarp();
        copy_out(st, p.out + (static_cast<size_t>(g) * p.n + row0) * p.k + c0, rows, w, p.kp,
                 p.k, vec, lane);
        __syncwarp();
    }
}

template <bool EPI, int NT>
__global__ void __launch_bounds__(kThreads, NT >= 8 ? 2 : 3)
packed_linear_tc(const Args p) {
    constexpr int CT = 8 * NT;
    extern __shared__ uint4 smem_u4[];
    __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem_u4);
    uint8_t* tile_s = reinterpret_cast<uint8_t*>(w_s + 3 * CT * p.wstride);
    float* stage_s = reinterpret_cast<float*>(tile_s + 2 * p.ms * kRowStride);

    // the CTA's share of the G x tiles (branch, tile) items, in order
    const long long items = static_cast<long long>(p.G) * p.tiles;
    const long long i_begin = items * blockIdx.x / gridDim.x;
    const long long i_end = items * (blockIdx.x + 1) / gridDim.x;
    if (i_begin >= i_end) return;
    const int steps_per_tile = p.npass * p.nslabs;
    const int J = static_cast<int>(i_end - i_begin) * steps_per_tile;
    const bool restage = steps_per_tile > 1;  // else once per branch

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int r = lane >> 2, tig = lane & 3;
    float* st = stage_s + warp * p.stage;

    // bytes of step j (branch, tile, slab) into buffer ``buf``; rows past m
    // are zero (genotype 2 against a zero weight)
    auto load = [&](int j, int buf) {
        const long long item = i_begin + j / steps_per_tile;
        const int g = static_cast<int>(item / p.tiles), t = static_cast<int>(item % p.tiles);
        const int s = j % p.nslabs;
        const int m0 = s * p.ms;
        const int rows = min(p.ms, p.m - m0);
        const uint8_t* src = p.bytes + (static_cast<size_t>(g) * p.m + m0) * p.B + t * kTileBytes;
        uint8_t* dst = tile_s + buf * p.ms * kRowStride;
        for (int idx = tid; idx < p.ms * 4; idx += kThreads) {
            const int row = idx >> 2, c16 = idx & 3;
            const bool real = row < rows;
            cp_async16(dst + row * kRowStride + c16 * 16,
                       src + (real ? static_cast<size_t>(row) * p.B + c16 * 16 : 0),
                       real ? 16 : 0);
        }
        cp_async_commit();
    };
    auto loads = [&](int j) { return p.nslabs > 1 || (j / p.nslabs) % p.npass == 0; };

    load(0, 0);
    int buf = 0, staged = -1;  // the branch whose weights are staged
    float acc[4][NT][4];
    for (int j = 0; j < J; ++j) {
        const long long item = i_begin + j / steps_per_tile;
        const int g = static_cast<int>(item / p.tiles), t = static_cast<int>(item % p.tiles);
        const int pass = (j / p.nslabs) % p.npass, s = j % p.nslabs;
        const bool next = j + 1 < J && loads(j + 1);
        if (next) {
            load(j + 1, buf ^ 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        if (restage || g != staged) {
            stage_weights<NT>(p, g, pass, s, w_s);
            staged = g;
        }
        __syncthreads();

        if (s == 0) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[q][nt][e] = 0.f;
        }
        const int chunks = (min(p.ms, p.m - s * p.ms) + 15) >> 4;
        // this thread's markers tig + 4i of each chunk, byte columns 2r, 2r + 1
        const uint8_t* bp = tile_s + buf * p.ms * kRowStride + tig * kRowStride + warp * 16 + 2 * r;
        const __nv_bfloat16* wp = w_s + r * p.wstride + 4 * tig;
        const int plane = CT * p.wstride;
#pragma unroll 1
        for (int c = 0; c < chunks; ++c) {
            const uint8_t* b = bp + c * 16 * kRowStride;
            const uint32_t u0 = *reinterpret_cast<const uint16_t*>(b);
            const uint32_t u1 = *reinterpret_cast<const uint16_t*>(b + 4 * kRowStride);
            const uint32_t u2 = *reinterpret_cast<const uint16_t*>(b + 8 * kRowStride);
            const uint32_t u3 = *reinterpret_cast<const uint16_t*>(b + 12 * kRowStride);
            // per half: (marker tig, marker tig + 4) of byte column 2r, then 2r + 1
            const uint32_t p01 = prmt(u0, u1, 0x5140u);
            const uint32_t p23 = prmt(u2, u3, 0x5140u);
            uint32_t af[4][4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const uint32_t s01 = selectors(p01, q), s23 = selectors(p23, q);
                af[q][0] = decode_pair(s01);        // row r, K 2tig, 2tig + 1
                af[q][1] = decode_pair(s01 >> 16);  // row r + 8
                af[q][2] = decode_pair(s23);        // row r, K 2tig + 8, 2tig + 9
                af[q][3] = decode_pair(s23 >> 16);  // row r + 8
            }
            const __nv_bfloat16* wc = wp + c * 16;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
                for (int part = 0; part < 3; ++part) {  // hi, mid, lo
                    const uint2 bw = *reinterpret_cast<const uint2*>(
                        wc + part * plane + nt * 8 * p.wstride);
#pragma unroll
                    for (int q = 0; q < 4; ++q) mma_bf16(acc[q][nt], af[q], bw.x, bw.y);
                }
            }
        }

        if (s == p.nslabs - 1) {
            if (!EPI) {
                epilogue<false, NT, 0>(p, g, t, pass, acc, st);
            } else {
                switch (p.act) {
                    case 1: epilogue<true, NT, 1>(p, g, t, pass, acc, st); break;
                    case 2: epilogue<true, NT, 2>(p, g, t, pass, acc, st); break;
                    case 3: epilogue<true, NT, 3>(p, g, t, pass, acc, st); break;
                    case 4: epilogue<true, NT, 4>(p, g, t, pass, acc, st); break;
                    default: epilogue<true, NT, 0>(p, g, t, pass, acc, st); break;
                }
            }
        }
        __syncthreads();  // the buffer and the weights are free again
        if (next) buf ^= 1;
    }
}

// Column tiles of 8 per pass: an instantiated NT that covers k up to 64.
int pick_nt(int k) {
    if (k <= 8) return 1;
    if (k <= 16) return 2;
    if (k <= 32) return 4;
    if (k <= 40) return 5;
    return 8;
}

long long smem_bytes(int nt, int ms, int wstride, int stage) {
    return 3LL * 8 * nt * wstride * 2 + 2LL * ms * kRowStride + 4LL * kWarps * stage;
}

// bf16 per weight row: an odd number of 32-byte units, so the 8-byte
// fragment loads of 4 rows hit 4 distinct bank groups.
int weight_stride(int ms) { return ((ms / 16) & 1) ? ms : ms + 16; }

struct Plan {
    int nt, npass, ms, nslabs, tiles;
    int ctas;  // the whole grid
    int per_sm, kp, stage, wstride;
    long long smem;
};

template <bool EPI>
const void* kernel_for(int nt) {
    switch (nt) {
        case 1: return reinterpret_cast<const void*>(&packed_linear_tc<EPI, 1>);
        case 2: return reinterpret_cast<const void*>(&packed_linear_tc<EPI, 2>);
        case 4: return reinterpret_cast<const void*>(&packed_linear_tc<EPI, 4>);
        case 5: return reinterpret_cast<const void*>(&packed_linear_tc<EPI, 5>);
        default: return reinterpret_cast<const void*>(&packed_linear_tc<EPI, 8>);
    }
}

template <bool EPI>
int plan(int G, int m, int B, int k, int n, Plan* pl) {
    if (G <= 0 || m <= 0 || k <= 0 || n <= 0 || B % kGBytes || n > 4 * B)
        return static_cast<int>(cudaErrorInvalidValue);
    pl->nt = pick_nt(k);
    const int ct = 8 * pl->nt;
    pl->npass = (k + ct - 1) / ct;
    const int kw = k < ct ? k : ct;  // the widest pass
    pl->kp = (kw & 3) ? kw + (kw & 1) : ((kw & 7) ? kw : kw + 4);
    pl->stage = (16 * pl->kp + 3) & ~3;
    const int m16 = (m + 15) & ~15;
    int ms = m16;
    while (ms > 16 && smem_bytes(pl->nt, ms, weight_stride(ms), pl->stage) > kSmemBudget) ms -= 16;
    pl->ms = ms;
    pl->nslabs = (m16 + ms - 1) / ms;
    pl->wstride = weight_stride(ms);
    pl->smem = smem_bytes(pl->nt, ms, pl->wstride, pl->stage);
    // tiles holding an individual below n: half h of group q starts at 512 q + 64 h
    const int full = n / kGroup, rem = n % kGroup;
    pl->tiles = 2 * full + (rem > kTileBytes ? 2 : (rem > 0 ? 1 : 0));
    const void* fn = kernel_for<EPI>(pl->nt);
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(pl->smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    int dev = 0, sms = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return static_cast<int>(e);
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&pl->per_sm, fn, kThreads,
                                                           pl->smem)) != cudaSuccess)
        return static_cast<int>(e);
    if (pl->per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    // one wave of resident CTAs, each with an equal share of the (branch,
    // tile) items (a share may span two branches: the weights are restaged)
    const long long items = static_cast<long long>(G) * pl->tiles;
    const long long target = static_cast<long long>(pl->per_sm) * sms;
    pl->ctas = static_cast<int>(target < items ? target : items);
    return 0;
}

template <bool EPI>
int launch(const void* bytes, const void* a, const void* off, void* out, int G, int m, int B,
           int k, int n, int act, void* stream) {
    if ((reinterpret_cast<uintptr_t>(bytes) | reinterpret_cast<uintptr_t>(out)) & 15)
        return static_cast<int>(cudaErrorMisalignedAddress);
    Plan pl;
    const int status = plan<EPI>(G, m, B, k, n, &pl);
    if (status != 0) return status;
    Args args{static_cast<const uint8_t*>(bytes), static_cast<const float*>(a),
              static_cast<const float*>(off), static_cast<float*>(out), m, B, k, n, act,
              G, pl.tiles, pl.ms, pl.nslabs, pl.npass, pl.wstride, pl.kp, pl.stage};
    void* params[] = {&args};
    return static_cast<int>(cudaLaunchKernel(kernel_for<EPI>(pl.nt), dim3(pl.ctas),
                                             dim3(kThreads), params, pl.smem,
                                             static_cast<cudaStream_t>(stream)));
}

}  // namespace

// bytes u8 [G, m, B] (group-strided, B a multiple of 128, 16-byte aligned);
// a f32 [G, m, k]; off f32 [G, k]; out f32 [G, n, k]. All contiguous, on
// one device.
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

// What a launch of K2 (epi = 1) or K9a (epi = 0) on this shape uses, on the
// current device: out[0..9] = column tiles of 8 per pass (NT), passes,
// markers per slab, slabs, tiles per branch, CTAs (the grid), resident CTAs
// per SM, floats per staged output row, bf16 per weight row, shared bytes
// per CTA.
extern "C" int packed_linear_plan(int epi, int G, int m, int B, int k, int n, long long* out) {
    Plan pl;
    const int status = epi ? plan<true>(G, m, B, k, n, &pl) : plan<false>(G, m, B, k, n, &pl);
    if (status != 0) return status;
    const long long v[10] = {pl.nt, pl.npass, pl.ms, pl.nslabs, pl.tiles,
                             pl.ctas, pl.per_sm, pl.kp, pl.wstride, pl.smem};
    for (int i = 0; i < 10; ++i) out[i] = v[i];
    return 0;
}
