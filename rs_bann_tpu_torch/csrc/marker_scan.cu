// The per-marker spike-and-slab scan (cfg.ss_markers): one launch for every
// (chain, branch) instance of a block.
//
// It replaces no TPU kernel. The JAX package's _marker_ss_scan
// (rs_bann_tpu/models/net.py:218) is jnp inside lax.scan, which the TPU
// compiles into one program; written as eager torch ops the same loop
// costs about 50 small launches per marker, ~50,000 per sweep at the main
// path's shape (m_pad = 104, 10 blocks), five times what the rest of the
// sweep launches. So the loop over markers is this kernel, and its two
// ends stay outside it: u0 = X_b^T e (K9b on packed genotypes) and the
// branch Gram G = X_b X_b^T, formed once per run from the data.
//
// What it computes, per instance i (branch g = gix[i]) and per marker j in
// the instance's visiting order (a permutation of the m_pad markers), in
// coefficient space (u = X_g^T e, updated through the Gram, so the
// residual e is never touched):
//   beta_old = W0[j] . w,   u_mj = u[j] + G[j, j] beta_old
//   d = col_mask / eta[j],  dw = d what,  v_a = max(what . dw, 1e-30)
//   q_a = 1/v_a + lam_e G[j, j] |w|^2
//   log BF = log(lam_a / q_a) / 2 + (lam_e |w| u_mj)^2 / 2 / q_a
//   z = force ? 1 : (uz[j] < sigmoid(logit(pi) + log BF)), times row_mask[j]
//   a = lam_e |w| u_mj / q_a + na[j] / sqrt(q_a)
//   x = xi[j] sqrt(d),  x -= dw (x . what) / v_a
//   row = z > 0 ? (dw / v_a) a + x : 0          (where, not multiply)
//   u -= G[j, :] (row . w - beta_old)
// with w = w_out, what = w / max(|w|, 1e-15). G is the Gram, symmetric, so
// its row j is its column j; the plain version (ops/marker_scan.py
// marker_scan_ref) reads the same row. Padded columns have d = 0 and come
// out exactly 0; padded markers have z = 0 and a zero row. Every random
// draw comes in as a tensor.
//
// What bounds it on the H100: neither bytes nor operations. Each marker's
// move depends on the one before through u, so an instance is a chain of
// m_pad dependent steps of a few hundred cycles each (the dot products'
// shuffles, full-precision logf, expf, sqrtf and divisions, a shared-memory
// round trip). At the main path's block (I = 40 instances, m_pad = 104,
// s_pad = 16, ridge) it reads 1.1 MB (each of the block's 10 Grams once)
// and writes 0.3 MB: 0.0004 ms at 3.35 TB/s.
// The real floor is the chain: m_pad dependent steps.
//
// The slab precisions eta are read in place through their strides: ridge
// hands the row precisions broadcast over the columns (column stride 0),
// lasso a drawn [I, m_pad, s_pad] slab. The indices (gix, order) are
// torch's int64, read as they come.
//
// Design, simple first: a CTA of one warp per instance, so a step needs no
// __syncthreads, only shuffles and a __syncwarp. Lane k holds column k of
// the step's row, and column k + 32 too where s_pad > 32 (up to 64: the
// second instantiation, NC = 2; at s_pad <= 32 the one-column code). u lives in shared memory ([m_pad] floats);
// the Gram row of the step is read into registers at the top of the step
// (lane l holds entries l, l + 32, ...: m_pad <= 1024) and consumed at its
// end, so its latency runs under the step's scalar chain; the marker's own
// inputs (row, eta, xi, draws) are fetched one step ahead. All f32, with
// full-precision logf, log1pf, expf and sqrtf (no --use_fast_math) and the
// JAX package's 1e-30 floors: the only gap from the plain version is
// rounding (sums of s_pad terms in another order, contracted FMAs).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxRows = 32;  // Gram-row registers per lane: m_pad <= 32 * 32
constexpr int kMaxM = 32 * kMaxRows;
constexpr int kMaxS = 64;     // two columns a lane

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: every lane ends with the same bits (float add commutes)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The lane's share of a dot product over its NC columns: one product at NC
// = 1 (the expression of the one-column design), two added at NC = 2.
template <int NC>
__device__ __forceinline__ float lane_dot(const float (&x)[NC], const float (&y)[NC]) {
  float v = x[0] * y[0];
  if constexpr (NC == 2) v += x[1] * y[1];
  return v;
}

template <int NC>
struct Marker {  // one marker's inputs, lane k holding columns k (and k + 32)
  int j;
  float row[NC], eta[NC], xi[NC];
  float uz, na, rm;
};

template <int NC>
__device__ __forceinline__ Marker<NC> fetch(int t, int s, int lane, const long long* order,
                                            const float* W0, const float* eta, long long eta_sr,
                                            long long eta_sc, const float* xi, const float* uz,
                                            const float* na, const float* rm) {
  Marker<NC> k;
  k.j = (int)order[t];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int cl = lane + 32 * c;
    const bool col = cl < s;
    const long long r = (long long)k.j * s + cl;
    k.row[c] = col ? W0[r] : 0.f;
    k.eta[c] = col ? eta[k.j * eta_sr + cl * eta_sc] : 1.f;
    k.xi[c] = col ? xi[r] : 0.f;
  }
  k.uz = uz[k.j];
  k.na = na[k.j];
  k.rm = rm[k.j];
  return k;
}

// NC columns a lane: 1 for s_pad <= 32, 2 for s_pad <= 64.
template <int NC>
__global__ void __launch_bounds__(32) marker_scan_kernel(
    const float* __restrict__ gram, const long long* __restrict__ gix,
    const float* __restrict__ u0, const float* __restrict__ W0, const float* __restrict__ w_out,
    const float* __restrict__ eta, long long eta_si, long long eta_sr, long long eta_sc,
    const float* __restrict__ lam_e, const float* __restrict__ pi,
    const float* __restrict__ row_mask, const float* __restrict__ col_mask,
    const long long* __restrict__ order, const float* __restrict__ uz, const float* __restrict__ na,
    const float* __restrict__ xi, float* __restrict__ z_out, float* __restrict__ W_out, int m,
    int s, int force) {
  extern __shared__ float u_s[];  // [m]
  const int i = blockIdx.x;
  const int lane = threadIdx.x;
  const long long ms = (long long)m * s;
  const float* G = gram + (long long)gix[i] * m * m;
  W0 += i * ms;
  eta += i * eta_si;
  xi += i * ms;
  W_out += i * ms;
  order += (long long)i * m;
  uz += (long long)i * m;
  na += (long long)i * m;
  row_mask += (long long)i * m;
  z_out += (long long)i * m;
  for (int r = lane; r < m; r += 32) u_s[r] = u0[(long long)i * m + r];

  bool col[NC];
  float w[NC], cm[NC], what[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    col[c] = lane + 32 * c < s;
    w[c] = col[c] ? w_out[(long long)i * s + lane + 32 * c] : 0.f;
    cm[c] = col[c] ? col_mask[(long long)i * s + lane + 32 * c] : 0.f;
  }
  const float wn2 = warp_sum(lane_dot<NC>(w, w));
  const float wnorm = sqrtf(fmaxf(wn2, 1e-30f));
#pragma unroll
  for (int c = 0; c < NC; ++c) what[c] = w[c] / wnorm;
  const float le = lam_e[i];
  const float logit_pi = logf(pi[i]) - log1pf(-pi[i]);

  Marker<NC> cur = fetch<NC>(0, s, lane, order, W0, eta, eta_sr, eta_sc, xi, uz, na, row_mask);
  for (int t = 0; t < m; ++t) {
    const int j = cur.j;
    // this step's Gram row, consumed at the step's end
    float g[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      const int c = lane + 32 * r;
      g[r] = c < m ? G[(long long)j * m + c] : 0.f;
    }
    const float gjj = G[(long long)j * m + j];
    Marker<NC> nxt = cur;
    if (t + 1 < m)
      nxt = fetch<NC>(t + 1, s, lane, order, W0, eta, eta_sr, eta_sc, xi, uz, na, row_mask);

    const float beta_old = warp_sum(lane_dot<NC>(cur.row, w));
    float d[NC], dw[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      d[c] = col[c] ? cm[c] / cur.eta[c] : 0.f;
      dw[c] = d[c] * what[c];
    }
    const float v_a = fmaxf(warp_sum(lane_dot<NC>(what, dw)), 1e-30f);
    const float lam_a = 1.f / v_a;
    const float q_a = lam_a + le * gjj * wn2;
    __syncwarp();  // the previous step's u updates are visible
    const float u_mj = u_s[j] + gjj * beta_old;
    const float lu = le * wnorm * u_mj;
    const float log_bf = 0.5f * logf(lam_a / q_a) + 0.5f * (lu * lu) / q_a;
    const float p = 1.f / (1.f + expf(-(logit_pi + log_bf)));
    float zj = force ? 1.f : (cur.uz < p ? 1.f : 0.f);
    zj = zj * cur.rm;
    const float a = lu / q_a + cur.na / sqrtf(q_a);
    float x[NC], row[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) x[c] = cur.xi[c] * sqrtf(d[c]);
    const float xw = warp_sum(lane_dot<NC>(x, what)) / v_a;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      x[c] = x[c] - dw[c] * xw;
      row[c] = zj > 0.f ? (dw[c] / v_a) * a + x[c] : 0.f;
    }
    const float db = warp_sum(lane_dot<NC>(row, w)) - beta_old;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (col[c]) W_out[(long long)j * s + lane + 32 * c] = row[c];
    if (lane == 0) z_out[j] = zj;
    __syncwarp();  // every lane has read u_s[j]
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      const int c = lane + 32 * r;
      if (c < m) u_s[c] -= g[r] * db;
    }
    cur = nxt;
  }
}

}  // namespace

// gram [Gg, m, m] (symmetric), gix [I] int64, u0 [I, m], W0 [I, m, s],
// w_out [I, s], eta [I, m, s] at strides (eta_si, eta_sr, eta_sc) in
// floats, lam_e [I], pi [I], row_mask [I, m], col_mask [I, s], order [I, m]
// int64 (each row a permutation of 0..m-1), uz [I, m], na [I, m], xi [I,
// m, s]; out: z [I, m], W_out [I, m, s]. All contiguous f32 but the indices
// and eta. Returns cudaErrorInvalidValue beyond m <= kMaxM, s <= kMaxS
// (ops/marker_scan.py MAX_M, MAX_S, which the CLI refuses beyond).
extern "C" int marker_scan_f32(const void* gram, const void* gix, const void* u0,
                               const void* W0, const void* w_out, const void* eta,
                               long long eta_si, long long eta_sr, long long eta_sc,
                               const void* lam_e, const void* pi, const void* row_mask,
                               const void* col_mask, const void* order, const void* uz,
                               const void* na, const void* xi, void* z, void* W_out, int I,
                               int m, int s, int force, void* stream) {
  if (I < 1 || m < 1 || m > kMaxM || s < 1 || s > kMaxS) return (int)cudaErrorInvalidValue;
  auto* kern = s <= 32 ? &marker_scan_kernel<1> : &marker_scan_kernel<2>;
  kern<<<I, 32, m * sizeof(float), (cudaStream_t)stream>>>(
      (const float*)gram, (const long long*)gix, (const float*)u0, (const float*)W0,
      (const float*)w_out, (const float*)eta, eta_si, eta_sr, eta_sc, (const float*)lam_e,
      (const float*)pi, (const float*)row_mask, (const float*)col_mask,
      (const long long*)order, (const float*)uz,
      (const float*)na, (const float*)xi, (float*)z, (float*)W_out, m, s, force);
  return (int)cudaGetLastError();
}
