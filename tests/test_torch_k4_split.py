"""The arithmetic of K4's depth-0 kernel (rs_bann_tpu_torch/csrc/
branch_vg_packed.cu, ``vg_packed0_kernel`` and ``reduce0_kernel``) on the
CPU: the kernel runs only on the card, so this file holds an emulation of
one launch, written here and not in the package, to the port's plain
version (``data_vg_packed`` on a CPU tensor, its fold in f32), to the
same plain version with every step in f64, and to the JAX package's
``data_vg_packed`` (its Pallas kernel in interpret mode, as its own tests
run it), within REL_TOL of the largest entry of each output.

The emulation follows the kernel's data path: the in-kernel fold (W0' =
w_scale * W0 split into three bf16 planes, off = b0 - shift . W0' in marker
slices summed in f64); the forward's m16n8k16 A, B and D fragments (K2's marker and
byte-column permutations, the prmt decode); the epilogue lane by lane (z +
off, act, the quad-shuffle sum for pred, err masked to i < n, dz0 = w_out *
err * act'); dz0's three-part split staged as the kernel stages it (one
8-byte unit of four parts per byte column, column and plane, at the
kernel's word addresses); the gradient's fragments (markers as rows, the
tile's individuals as the reduction, two parts of one byte per A register)
read back from that staging; the CTA's partial row (stored on its first
tile, added to on the next); the block sums (warp butterflies, then the
warps in order); and the reduce's fixed-order column sums, unfold and rss.
Each fragment runs as ``mma_split3_add`` does: hi's MMA from a zero
accumulator, lo's then mid's from another, both added to the f32 sum by
round-to-nearest adds; each MMA is modelled as the tensor cores at their
worst: its exact products and accumulator aligned to the largest and cut
toward zero, the sum cut toward zero to f32. A chain of MMAs through one
accumulator drifts toward zero under that model, and did on the card, so
the kernel chains none across fragments.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_bann_tpu.models import density as JD
from rs_bann_tpu.ops import branch_mlp as JBM
from rs_bann_tpu_torch.models import density as TD
from rs_bann_tpu_torch.ops import branch_mlp as TBM
from rs_bann_tpu_torch.ops import packed_matmul as PM
from rs_bann_tpu_torch.ops.activations import apply as act_apply
from test_torch_k2_split import LUT_HI, LUT_LO, bf16_bits, bf16_value, prmt, selectors, split3

REL_TOL = 1e-4  # as chip_smoke.py: f32 sums over markers and over n in another order

F32 = np.float32
TILE, STRIDE, DZ_STRIDE, WARPS, SLICES = 64, 80, 130, 4, 16  # as branch_vg_packed.cu


def f32(x):
    return np.asarray(x, np.float64).astype(F32)


def fma(a, b, c):
    """fmaf: one rounding of a * b + c (the f32 product is exact in f64)."""
    return f32(np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64))


def act_np(act, z):
    return act_apply(act, torch.from_numpy(np.ascontiguousarray(z, F32))).numpy()


def act_prime_np(act, z, a):
    """h'(z) as packed_decode.cuh writes it."""
    if act == "relu":
        return (z > 0).astype(F32)
    if act == "leaky_relu":
        return np.where(z > 0, F32(1), np.where(z < 0, F32(0.01), F32(0))).astype(F32)
    if act == "tanh":
        return f32(F32(1) - f32(a * a))
    if act == "silu":
        s = f32(F32(1) / f32(F32(1) + f32(np.exp(-z.astype(np.float64)))))
        return f32(s * f32(F32(1) + f32(z * f32(F32(1) - s))))
    return np.ones_like(z, F32)


def trunc32(s):
    """f32 of f64 values, rounded toward zero."""
    _, e = np.frexp(s)
    u = np.ldexp(1.0, e - 24)
    return (np.trunc(s / u) * u).astype(F32)


def mma(acc, A, B):
    """acc [..., 16, 8] f32 + A [..., 16, 16] @ B [16, 8] (bf16 values) as the
    tensor cores are modelled here, no better than they are: the 16 exact
    products and the accumulator aligned to the largest of them, each cut
    toward zero to 24 bits, summed, and the sum cut toward zero to f32."""
    terms = np.concatenate([acc.astype(np.float64)[..., :, None, :],
                            A.astype(np.float64)[..., :, :, None] * B.astype(np.float64)],
                           axis=-2)  # [..., 16, 17, 8]
    _, e = np.frexp(np.abs(terms).max(axis=-2, keepdims=True))
    u = np.ldexp(1.0, e - 24)
    return trunc32((np.trunc(terms / u) * u).sum(axis=-2))


def split3_add(acc, A, Bs):
    """packed_mma.cuh mma_split3_add: hi's MMA from a zero accumulator, lo's
    then mid's from another, acc + (hi + ml) by f32 adds."""
    hi = mma(np.zeros_like(acc), A, Bs[0])
    ml = mma(mma(np.zeros_like(acc), A, Bs[2]), A, Bs[1])
    return f32(acc.astype(np.float64) + f32(hi.astype(np.float64) + ml))


def pair_bits(lo, hi):
    return (bf16_bits(lo).astype(np.uint32) | (bf16_bits(hi).astype(np.uint32) << 16))


def emulate(bytes_mb, target, w0, b0, wout, scale, shift, n, act, ctas):
    """One launch of the depth-0 pass and its reduce with ``ctas`` CTAs.
    Returns (y_pred [n], dW0 [m, k0], db0 [k0], dWout [k0], rss)."""
    m, B = bytes_mb.shape
    k0 = w0.shape[1]
    KM = 8 if k0 <= 8 else 16 if k0 <= 16 else 32
    NT = KM // 8
    m16 = -(-m // 16) * 16
    lane = np.arange(32)
    r, tig = lane >> 2, lane & 3

    # ---- staging: the fold, the weight planes, off
    wp = np.zeros((m16, KM), F32)
    wp[:m, :k0] = f32(scale[:, None] * w0)
    planes = split3(wp)  # hi, mid, lo [m16, KM]
    S = 128 // KM  # off: marker slices summed in f64, rounded once
    tot = np.zeros(KM)
    for sl in range(S):
        tot += sum(np.float64(shift[mk]) * wp[mk].astype(np.float64) for mk in range(sl, m, S))
    off = np.zeros(KM, F32)
    off[:k0] = f32(b0.astype(np.float64) - tot[:k0])
    wo = np.zeros(KM, F32)
    wo[:k0] = wout

    full, rem = divmod(n, 512)
    tiles = 2 * full + (2 if rem > 64 else 1 if rem > 0 else 0)
    row_len = (m16 * KM + 2 * KM + 1 + 3) & ~3
    partial = np.full((ctas, row_len), np.nan, F32)
    y_pred = np.full(n, np.nan, F32)

    for cta in range(ctas):
        t_begin, t_end = tiles * cta // ctas, tiles * (cta + 1) // ctas
        db = np.zeros((WARPS, 8, 4, NT, 2), F32)  # per lane [warp, r, tig]
        dwo = np.zeros((WARPS, 8, 4, NT, 2), F32)
        e2 = np.zeros((WARPS, 8, 4), F32)
        for t in range(t_begin, t_end):
            tile = np.zeros((m16, STRIDE), np.uint8)  # rows past m: zero bytes
            tile[:m, :TILE] = bytes_mb[:, t * TILE:(t + 1) * TILE]
            # ---- forward: acc [warp, q, 16 rows, KM]
            acc = np.zeros((WARPS, 4, 16, KM), F32)
            cols16 = np.arange(WARPS)[:, None] * 16 + 2 * r[None, :]  # [warp, lane]
            for c in range(m16 // 16):
                u = [tile[c * 16 + tig + 4 * i, cols16].astype(np.uint32)
                     | (tile[c * 16 + tig + 4 * i, cols16 + 1].astype(np.uint32) << 8)
                     for i in range(4)]
                p01, p23 = prmt(u[0], u[1], 0x5140), prmt(u[2], u[3], 0x5140)
                A = np.zeros((WARPS, 4, 16, 16), F32)
                for q in range(4):
                    s01, s23 = selectors(p01, q), selectors(p23, q)
                    for reg, (ro, co) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
                        bits = prmt(LUT_HI, LUT_LO, (s01, s01 >> 16, s23, s23 >> 16)[reg])
                        for h in range(2):
                            A[:, q, r + ro, 2 * tig + co + h] = bf16_value((bits >> (16 * h)) & 0xFFFF)
                for nt in range(NT):
                    Bs = []
                    for part in range(3):
                        Bm = np.zeros((16, 8), F32)
                        for j in range(2):  # K 2tig + j: marker tig + 4j, K + 8: tig + 8 + 4j
                            Bm[2 * tig + j, r] = planes[part][c * 16 + tig + 4 * j, nt * 8 + r]
                            Bm[2 * tig + 8 + j, r] = planes[part][c * 16 + tig + 8 + 4 * j,
                                                                  nt * 8 + r]
                        Bs.append(Bm)
                    acc[..., nt * 8:(nt + 1) * 8] = split3_add(acc[..., nt * 8:(nt + 1) * 8], A, Bs)
            # ---- epilogue, lane by lane: row rho = r + 8h of part q is byte
            # column 16w + 2r + h; lane (r, tig) holds columns nt*8 + 2tig + c
            dz_s = np.zeros(3 * KM * DZ_STRIDE, np.uint32)
            base = (t >> 1) * 512 + (t & 1) * TILE + np.arange(WARPS)[:, None] * 16 + 2 * r[None, :]
            colsl = np.array([[nt * 8 + 2 * tig + c for c in range(2)] for nt in range(NT)])

            def lanes(v, rows=None):  # lane (r, tig)'s columns of v: [..., 32, NT, 2]
                return np.stack([np.stack([v[:, rows, colsl[nt, c]] if rows is not None
                                           else v[colsl[nt, c]] for c in range(2)], -1)
                                 for nt in range(NT)], -2)

            w, o = lanes(wo)[None], lanes(off)[None]  # [1, 32, NT, 2]
            mine = np.zeros((WARPS, 32, 2), F32)
            for h in range(2):
                dz = np.zeros((4, WARPS, 32, NT, 2), F32)
                for q in range(4):
                    i = base + q * 128 + h  # [warp, lane]
                    z = f32(lanes(acc[:, q], r + 8 * h) + o)
                    a = act_np(act, z)
                    pp = np.zeros((WARPS, 32), F32)
                    for nt in range(NT):
                        for c in range(2):
                            pp = fma(w[..., nt, c], a[..., nt, c], pp)
                    pp = f32(pp + pp[:, lane ^ 1])
                    pp = f32(pp + pp[:, lane ^ 2])
                    valid = i < n
                    err = np.where(valid, f32(pp - target[np.minimum(i, n - 1)]), F32(0))
                    sel = (tig == q)[None, :]
                    mine[..., h] = np.where(sel, pp, mine[..., h])
                    e2 = np.where(sel.reshape(1, 8, 4), fma(err, err, e2.reshape(WARPS, 32))
                                  .reshape(WARPS, 8, 4), e2)
                    d = f32(f32(w * err[..., None, None]) * act_prime_np(act, z, a))
                    dz[q] = d
                    db = f32(db + d.reshape(WARPS, 8, 4, NT, 2))
                    dwo = fma(a.reshape(WARPS, 8, 4, NT, 2), err.reshape(WARPS, 8, 4)[..., None, None],
                              dwo)
                # the staging: one 8-byte unit per (column, byte column, plane)
                cc = np.arange(WARPS)[:, None] * 16 + 2 * r[None, :] + h  # [warp, lane]
                for nt in range(NT):
                    for c in range(2):
                        sp = split3(dz[..., nt, c])  # 3 x [4 q, warp, lane]
                        k = nt * 8 + 2 * tig + c
                        for pl in range(3):
                            at = (pl * KM + k)[None, :] * DZ_STRIDE + 2 * cc
                            dz_s[at] = pair_bits(sp[pl][0], sp[pl][1])
                            dz_s[at + 1] = pair_bits(sp[pl][2], sp[pl][3])
            i0 = base + tig[None, :] * 128
            for h in range(2):
                ok = i0 + h < n
                y_pred[(i0 + h)[ok]] = mine[..., h][ok]
            # ---- gradient: per marker tile, k-steps (J, b) in order
            for mt in range(m16 // 16):
                g = np.zeros((16, KM), F32)
                for J in range(TILE // 16):
                    rows = mt * 16 + r
                    word = lambda rr: sum(tile[rr, 16 * J + 4 * tig + k].astype(np.uint32) << (8 * k)
                                          for k in range(4))
                    wr, wr8 = word(rows), word(rows + 8)
                    for b in range(4):
                        pb = prmt(wr, wr8, b * 0x0011 + (4 + b) * 0x1100)
                        s01 = ((pb & 0x00030003) | ((pb >> 2) & 0x03000300)) * 0x11 + 0x04040404
                        s23 = (((pb >> 4) & 0x00030003) | ((pb >> 6) & 0x03000300)) * 0x11 \
                            + 0x04040404
                        s01, s23 = s01.astype(np.uint32), s23.astype(np.uint32)
                        A = np.zeros((16, 16), F32)
                        for reg, (ro, co) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
                            bits = prmt(LUT_HI, LUT_LO, (s01, s01 >> 16, s23, s23 >> 16)[reg])
                            for hh in range(2):
                                A[r + ro, 2 * tig + co + hh] = bf16_value((bits >> (16 * hh)) & 0xFFFF)
                        for nt in range(NT):
                            Bs = []
                            for pl in range(3):
                                at = (pl * KM + nt * 8 + r) * DZ_STRIDE + 2 * (16 * J + 4 * tig + b)
                                b0w, b1w = dz_s[at], dz_s[at + 1]
                                Bm = np.zeros((16, 8), F32)
                                for hh in range(2):
                                    Bm[2 * tig + hh, r] = bf16_value((b0w >> (16 * hh)) & 0xFFFF)
                                    Bm[2 * tig + 8 + hh, r] = bf16_value((b1w >> (16 * hh)) & 0xFFFF)
                                Bs.append(Bm)
                            g[:, nt * 8:(nt + 1) * 8] = split3_add(g[:, nt * 8:(nt + 1) * 8], A, Bs)
                dst = partial[cta, mt * 16 * KM:(mt + 1) * 16 * KM].reshape(16, KM)
                dst[:] = g if t == t_begin else f32(dst + g)
        # ---- the CTA's block sums: butterflies over r (and tig for e2), warps in order
        for v in (db, dwo):
            for o in (1, 2, 4):
                v[:] = f32(v + v[:, np.arange(8) ^ o])
        ee = e2.reshape(WARPS, 32)
        for o in (1, 2, 4, 8, 16):
            ee = f32(ee + ee[:, lane ^ o])
        red = np.zeros((WARPS, 2 * KM + 1), F32)
        for nt in range(NT):
            for c in range(2):
                red[:, nt * 8 + 2 * np.arange(4) + c] = db[:, 0, :, nt, c]
                red[:, KM + nt * 8 + 2 * np.arange(4) + c] = dwo[:, 0, :, nt, c]
        red[:, 2 * KM] = ee[:, 0]
        partial[cta, m16 * KM:m16 * KM + 2 * KM + 1] = f32(f32(f32(red[0] + red[1]) + red[2])
                                                           + red[3])

    # ---- the reduce: each column over row slices, the slices in order
    def colsum(col):
        s = np.zeros(SLICES, F32)
        for sl in range(SLICES):
            for b in range(sl, ctas, SLICES):
                s[sl] = f32(s[sl] + partial[b, col])
        tot = s[0]
        for sl in range(1, SLICES):
            tot = f32(tot + s[sl])
        return tot

    dsum = m16 * KM
    d_off = np.array([colsum(dsum + k) for k in range(k0)], F32)
    dwp = np.array([[colsum(mm * KM + k) for k in range(k0)] for mm in range(m)], F32)
    dW0 = f32(f32(scale[:, None] * dwp) - f32(f32(shift * scale)[:, None] * d_off[None, :]))
    dWout = np.array([colsum(dsum + KM + k) for k in range(k0)], F32)
    return y_pred, dW0, d_off, dWout, colsum(dsum + 2 * KM)


def _inputs(m, n, k0, live, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 3, size=(m, n)).astype(F32)
    vals[m - 3:] = 0  # padded marker rows
    by = PM.pack_strided(vals)
    scale = rng.uniform(0.5, 2.0, m).astype(F32)
    shift = rng.uniform(0.0, 2.0, m).astype(F32)
    scale[m - 3:] = shift[m - 3:] = 0
    w0 = (rng.standard_normal((m, k0)) * 0.3).astype(F32)
    b0 = (rng.standard_normal(k0) * 0.1).astype(F32)
    wout = (rng.standard_normal((k0, 1)) * 0.5).astype(F32)
    w0[:, live:] = b0[live:] = wout[live:] = 0  # a width stored wider than it is
    target = rng.standard_normal(n).astype(F32)
    return by, scale, shift, w0, b0, wout, target


def _plain_f64(by, target, w0, b0, wout, scale, shift, n, act):
    """The port's plain version with every step in f64, the fold too."""
    d = lambda v: torch.from_numpy(np.asarray(v, np.float64))  # noqa: E731
    s, sh, t = d(scale), d(shift), d(target)
    w0p = s[:, None] * d(w0)
    off = d(b0) - sh @ w0p
    y, dws, dbs = TBM.data_vg_packed_ref(act, torch.from_numpy(by), t, (w0p, d(wout)), (off,), n)
    dW0 = s[:, None] * dws[0] - (sh * s)[:, None] * dbs[0]
    return (y.numpy(), dW0.numpy(), dbs[0].numpy(), dws[1].numpy()[:, 0],
            float(torch.sum((y - t) ** 2)))


CASES = [  # (m, n, k0, live width, CTAs)
    (40, 1100, 16, 10, 4),  # width 10 stored at 16; 6 tiles over 4 CTAs
    (104, 1300, 16, 16, 3),  # the main path's m_pad; 4 marker tiles per warp pair
    (24, 700, 8, 8, 2),
    (40, 600, 32, 32, 1),  # n past one group, all tiles in one CTA
]


@pytest.mark.parametrize("act", TBM.SUPPORTED_ACTIVATIONS)
@pytest.mark.parametrize("case", CASES, ids=lambda c: "m{}_n{}_k{}_live{}_ctas{}".format(*c))
def test_depth0_emulation_matches_plain_and_jax(case, act):
    m, n, k0, live, ctas = case
    by, scale, shift, w0, b0, wout, target = _inputs(m, n, k0, live, seed=m + k0 + len(act))
    got = emulate(by, target, w0, b0, wout[:, 0], scale, shift, n, act, ctas)

    tx = TD.PackedX(torch.from_numpy(by), torch.from_numpy(scale), torch.from_numpy(shift), n)
    ty, trss, tdws, tdbs = TBM.data_vg_packed(
        act, tx, (torch.from_numpy(w0), torch.from_numpy(wout)), (torch.from_numpy(b0),),
        torch.from_numpy(target))
    plain = (ty.numpy(), tdws[0].numpy(), tdbs[0].numpy(), tdws[1].numpy()[:, 0], float(trss))
    JBM.FORCE = "interpret"
    try:
        jx = JD.PackedX(jnp.asarray(by), jnp.asarray(scale), jnp.asarray(shift), n)
        jy, jrss, jdws, jdbs = JBM.data_vg_packed(
            act, jx, (jnp.asarray(w0), jnp.asarray(wout)), (jnp.asarray(b0),), jnp.asarray(target))
    finally:
        JBM.FORCE = None
    jax_out = (np.asarray(jy), np.asarray(jdws[0]), np.asarray(jdbs[0]),
               np.asarray(jdws[1])[:, 0], float(jrss))
    names = ("y_pred", "dW0", "db0", "dW_out", "rss")
    for want in (plain, jax_out, _plain_f64(by, target, w0, b0, wout, scale, shift, n, act)):
        for name, g, w in zip(names, got, want):
            g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
            assert g.shape == w.shape, name
            assert np.all(np.isfinite(g)), name
            scale_ = max(1.0, np.abs(w).max())
            assert np.abs(g - w).max() <= REL_TOL * scale_, (name, np.abs(g - w).max(), scale_)
    # the padded marker rows get exactly zero gradient, the stored columns
    # past the live width exactly zero everywhere
    assert np.all(got[1][m - 3:] == 0)
    assert np.all(got[1][:, live:] == 0) and np.all(got[2][live:] == 0)
    assert np.all(got[3][live:] == 0)


def test_gradient_k_steps_cover_each_individual_once():
    """k-step (J, b) of a tile reads byte columns 16 J + 4 tig + b; with the
    parts (0, 1) and (2, 3) of each byte in its two A registers, the 16
    k-steps cover the tile's 64 byte columns x 4 parts once each, and the
    epilogue's staging writes each (byte column, part) once."""
    seen = []
    for J in range(4):
        for b in range(4):
            for tig in range(4):
                for part in range(4):
                    seen.append((16 * J + 4 * tig + b, part))
    assert sorted(seen) == [(c, p) for c in range(64) for p in range(4)]
    written = [(16 * w + 2 * r + h, q) for w in range(4) for r in range(8) for h in range(2)
               for q in range(4)]
    assert sorted(written) == sorted(seen)
