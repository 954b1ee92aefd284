"""The arithmetic of K3 and K9b (rs_bann_tpu_torch/csrc/packed_bwd.cu,
``packed_bwd_tc`` and ``packed_bwd_reduce``) on the CPU: the kernel runs
only on the card, so this file holds an emulation of one launch, written
here and not in the package, to the port's plain versions
(``packed_linear_vjp_ref``, ``packed_matmul_vjp_ref``), to the same in
f64, and to the JAX package's ``_pallas_bwd_fused`` and ``_pallas_bwd``
in interpret mode (as its own tests run them), within REL_TOL of the
largest entry of each output.

The emulation follows the kernel's data path: the items (branch, marker
slab, column slab, tile of 64 byte columns) split evenly over the CTAs;
per item the staged g (and, where h' reads it, the saved output) with rows
past n and columns past k zero; the dz pass thread by thread (dz = g *
h'(out) in f32, the thread's sum of its column over the tile in f32, then
into d_off in f64, dz's three bf16 planes at the kernel's word addresses); the MMA pass warp by warp
(warp w takes byte columns 16 w .. 16 w + 15, k-step b byte 4 tig + b of
each lane's 32-bit word of a marker row, the A registers holding parts
(0, 1) and (2, 3) of one byte, the B fragments read back from the planes);
each fragment through ``mma_split3_add``, with every MMA modelled as the
tensor cores at their worst (its exact products and accumulator aligned
to the largest and cut toward zero, the sum cut toward zero to f32); the
flush of an item group (warps added in order, d_off's 128 / KC thread sums
in order); and the reduce's sums in CTA order. ``chained=True`` runs each
fragment's three MMAs through the running accumulator instead: on a
cotangent whose sums cancel that drifts past the tolerance, which is why
the kernel does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_bann_tpu.ops import packed_matmul as JPM
from rs_bann_tpu_torch.ops import packed_matmul as PM
from rs_bann_tpu_torch.ops.activations import prime_from_out
from test_torch_k2_split import LUT_HI, LUT_LO, bf16_value, prmt, split3
from test_torch_k4_split import mma, pair_bits, split3_add

REL_TOL = 1e-4  # as chip_smoke.py: f32 sums over n individuals in another order

F32 = np.float32
TILE, DZ_STRIDE, WARPS, THREADS, MT = 64, 130, 4, 128, 8  # as packed_bwd.cu
LANE = np.arange(32)
R, TIG = LANE >> 2, LANE & 3


def plan(G, m, k, n):
    """packed_bwd.cu plan(): (KC, column slabs, marker slabs, markers per
    slab, tiles per branch, items)."""
    kc = 8 if k <= 8 else 16
    m16 = -(-m // 16) * 16
    mslabs = -(-m16 // (16 * MT))
    ms = -(-(-(-m16 // mslabs)) // 16) * 16
    full, rem = divmod(n, 512)
    tiles = 2 * full + (2 if rem > TILE else 1 if rem > 0 else 0)
    cslabs = -(-k // kc)
    return kc, cslabs, mslabs, ms, tiles, G * mslabs * cslabs * tiles


def cta_of(i, items, ctas):
    """The CTA that owns item i: the c with items * c // ctas <= i."""
    return ((i + 1) * ctas - 1) // items


def prime_np(act, a):
    """act_prime_from_out of packed_bwd.cu, rounded as the plain version."""
    if act == "relu":
        return (a > 0).astype(F32)
    if act == "leaky_relu":
        return np.where(a > 0, F32(1), np.where(a < 0, F32(0.01), F32(0))).astype(F32)
    if act == "tanh":
        return (F32(1) - (a * a).astype(F32)).astype(F32)
    return np.ones_like(a)


def a_fragment(wr, wr8, b):
    """packed_mma.cuh grad_a_frag: A [..., 16 markers, 16 K] of k-step b from
    each lane's words wr (marker r) and wr8 (marker r + 8) [..., 32]."""
    pb = prmt(wr, wr8, b * 0x0011 + (4 + b) * 0x1100)
    s01 = (((pb & 0x00030003) | ((pb >> 2) & 0x03000300)) * 0x11 + 0x04040404).astype(np.uint32)
    s23 = ((((pb >> 4) & 0x00030003) | ((pb >> 6) & 0x03000300)) * 0x11
           + 0x04040404).astype(np.uint32)
    A = np.zeros(wr.shape[:-1] + (16, 16), F32)
    for reg, (ro, co) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        bits = prmt(LUT_HI, LUT_LO, (s01, s01 >> 16, s23, s23 >> 16)[reg])
        for h in range(2):
            A[..., R + ro, 2 * TIG + co + h] = bf16_value((bits >> (16 * h)) & 0xFFFF)
    return A


def emulate(by, g, out, n, act, ctas, chained=False):
    """One launch of the pass and its reduce with ``ctas`` CTAs: K3 under
    ``act`` (returns dA [G, m, k], d_off [G, k]) or K9b (``act`` None:
    dA)."""
    G, m, B = by.shape
    k = g.shape[-1]
    fused = act is not None
    read_out = fused and act != "identity"
    kc, cslabs, mslabs, ms, tiles, items = plan(G, m, k, n)
    m16 = -(-m // 16) * 16
    rows = {}  # the partial rows: slot c + v -> (dA' [ms, kc] f32, d_off [kc] f64)
    tid = np.arange(THREADS)
    col = tid % kc
    for c in range(ctas):
        lo, hi = items * c // ctas, items * (c + 1) // ctas
        acc = None
        for i in range(lo, hi):
            v, t = divmod(i, tiles)
            gb, slab = divmod(v, mslabs * cslabs)
            m0, c0 = (slab // cslabs) * ms, (slab % cslabs) * kc
            mtiles = min(ms, m16 - m0) // 16
            if acc is None:
                acc = np.zeros((WARPS, mtiles, 16, kc), F32)
                dsum = np.zeros(THREADS)
            # ---- staging: part q, row j is individual i0 + 128 q + j
            i0 = (t >> 1) * 512 + (t & 1) * TILE
            ind = i0 + 128 * np.arange(4)[:, None] + np.arange(TILE)[None, :]  # [4, 64]
            cols = c0 + np.arange(kc)
            ok = (ind < n)[..., None] & (cols < k)[None, None, :]
            src = (gb, np.minimum(ind, n - 1)[..., None], np.minimum(cols, k - 1)[None, None, :])
            g_s = np.where(ok, g[src], F32(0))
            o_s = np.where(ok, out[src], F32(0)) if read_out else None
            tile = np.zeros((ms, TILE), np.uint8)  # marker rows past m: zero bytes
            real = min(ms, m - m0)
            if real > 0:
                tile[:real] = by[gb, m0:m0 + real, t * TILE:(t + 1) * TILE]
            # ---- dz pass, thread by thread: column col, byte columns c
            dz_s = np.zeros(3 * kc * DZ_STRIDE, np.uint32)
            step = THREADS // kc
            tsum = np.zeros(THREADS, F32)  # the tile's sum in f32, then into d_off in f64
            for u in range(TILE // step):
                cc = tid // kc + step * u
                dz = []
                for q in range(4):
                    x = g_s[q, cc, col]
                    if read_out:
                        x = (x * prime_np(act, o_s[q, cc, col])).astype(F32)
                    dz.append(x)
                    tsum = (tsum + x).astype(F32)
                for pl, part in enumerate(zip(*(split3(x) for x in dz))):  # hi, mid, lo
                    at = (pl * kc + col) * DZ_STRIDE + 2 * cc
                    dz_s[at] = pair_bits(part[0], part[1])
                    dz_s[at + 1] = pair_bits(part[2], part[3])
            dsum = dsum + tsum.astype(np.float64)
            # ---- MMA pass: warp w, k-steps b; lanes (r, tig)
            w = np.arange(WARPS)[:, None]
            word = lambda rr: sum(  # noqa: E731  [warp, mtile, lane]
                tile[rr, (16 * w + 4 * TIG + j)[:, None, :]].astype(np.uint32) << (8 * j)
                for j in range(4))
            rr = (np.arange(mtiles)[:, None] * 16 + R[None, :])[None]  # [1, mtile, lane]
            wr, wr8 = word(rr), word(rr + 8)
            for b in range(4):
                A = a_fragment(wr, wr8, b)  # [warp, mtile, 16, 16]
                Bs = []
                for pl in range(3):
                    Bm = np.zeros((WARPS, 16, kc), F32)
                    for nt in range(kc // 8):
                        at = (pl * kc + nt * 8 + R) * DZ_STRIDE + 2 * (16 * w + 4 * TIG + b)
                        for h in range(2):
                            Bm[:, 2 * TIG + h, nt * 8 + R] = bf16_value((dz_s[at] >> (16 * h))
                                                                        & 0xFFFF)
                            Bm[:, 2 * TIG + 8 + h, nt * 8 + R] = bf16_value(
                                (dz_s[at + 1] >> (16 * h)) & 0xFFFF)
                    Bs.append(Bm[:, None, None])
                if chained:
                    for Bm in Bs:
                        acc = mma(acc, A, Bm)
                else:
                    acc = split3_add(acc, A, Bs)
            if i + 1 < hi and (i + 1) // tiles == v:
                continue
            # ---- flush: warps in order, d_off's thread sums in order
            part = np.zeros((ms, kc), F32)
            s = acc[0]
            for ww in range(1, WARPS):
                s = (s + acc[ww]).astype(F32)
            part[:mtiles * 16] = s.reshape(mtiles * 16, kc)
            doff = np.zeros(kc)
            for cl in range(kc):
                for uu in range(THREADS // kc):
                    doff[cl] += dsum[uu * kc + cl]
            rows[c + v] = (part, doff)
            acc = None

    # ---- the reduce: each element over the CTAs of its group, in CTA order
    da = np.zeros((G, m, k), F32)
    d_off = np.zeros((G, k), F32)
    for gb in range(G):
        for mm in range(m):
            for kk in range(k):
                v = (gb * mslabs + mm // ms) * cslabs + kk // kc
                s = F32(0)
                for c in range(cta_of(v * tiles, items, ctas),
                               cta_of(v * tiles + tiles - 1, items, ctas) + 1):
                    s = F32(s + rows[c + v][0][mm % ms, kk % kc])
                da[gb, mm, kk] = s
        for kk in range(k):
            v = gb * mslabs * cslabs + kk // kc
            s = 0.0
            for c in range(cta_of(v * tiles, items, ctas),
                           cta_of(v * tiles + tiles - 1, items, ctas) + 1):
                s += rows[c + v][1][kk % kc]
            d_off[gb, kk] = F32(s)
    return (da, d_off) if fused else (da,)


def _inputs(G, m, n, k, act, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 3, size=(G, m, n))
    by = np.stack([PM.pack_strided(v) for v in vals])
    g = rng.standard_normal((G, n, k)).astype(F32)
    z = rng.standard_normal((G, n, k)).astype(F32)
    z[:, ::7] = 0.0  # exact zeros: h' = 0 there for relu and leaky_relu
    out = {"relu": np.maximum(z, 0), "leaky_relu": np.where(z > 0, z, F32(0.01) * z),
           "tanh": np.tanh(z)}.get(act, z).astype(F32)
    return by, g, out


def _references(by, g, out, n, act):
    """(plain f32, plain f64, JAX interpret) of K3 (or K9b, act None)."""
    tb, tg, to = (torch.from_numpy(np.ascontiguousarray(x)) for x in (by, g, out))
    if act is None:
        plain = (PM.packed_matmul_vjp_ref(tb, tg, n).numpy(),)
        f64 = (PM.unpack_strided(tb, n).double() @ tg.double(),)
    else:
        plain = tuple(x.numpy() for x in PM.packed_linear_vjp_ref(tb, tg, to, n, act))
        dz = tg.double() * prime_from_out(act, to).double()
        f64 = (PM.unpack_strided(tb, n).double() @ dz, dz.sum(dim=-2))
    f64 = tuple(x.numpy() for x in f64)
    G, m, B = by.shape
    jax_out = []
    for gb in range(G):
        pad = lambda x: np.concatenate([x, np.zeros((4 * B - n, x.shape[-1]), F32)])  # noqa: E731
        jb, jg = jnp.asarray(by[gb]), jnp.asarray(pad(g[gb]))
        if act is None:
            jax_out.append((np.asarray(JPM._pallas_bwd(jb, jg, n, interpret=True)),))
        elif JPM._tile_m(m) == m:
            da, d_off = JPM._pallas_bwd_fused(jb, jg, jnp.asarray(pad(out[gb])), n, act,
                                              interpret=True)
            jax_out.append((np.asarray(da), np.asarray(d_off)[0]))
        else:  # the JAX package's own fallback past one marker tile
            dz = jg * JPM._act_prime_from_out(act, jnp.asarray(pad(out[gb])))
            jax_out.append((np.asarray(JPM._pallas_bwd(jb, dz, n, interpret=True)),
                            np.asarray(jnp.sum(dz, axis=0))))
    jax_ref = tuple(np.stack(x) for x in zip(*jax_out))
    return plain, f64, jax_ref


def _worst(got, want):
    """The largest difference of each output over max(1, its largest entry)."""
    return [np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()
            / max(1.0, np.abs(np.asarray(b, np.float64)).max()) for a, b in zip(got, want)]


CASES = [  # (G, m, n, k, CTAs)
    (2, 24, 700, 5, 3),  # a partial marker tile, ragged n, k = 5 (4-byte copies), 2 branches
    (1, 40, 1100, 16, 4),  # NT = 2
    (1, 20, 600, 40, 2),  # three column slabs
    (1, 140, 300, 8, 2),  # two marker slabs (JAX: its fallback past one marker tile)
]


@pytest.mark.parametrize("act", PM.FUSED_ACTIVATIONS + (None,), ids=lambda a: a or "K9b")
@pytest.mark.parametrize("case", CASES, ids=lambda c: "G{}_m{}_n{}_k{}_ctas{}".format(*c))
def test_emulation_matches_plain_f64_and_jax(case, act):
    G, m, n, k, ctas = case
    by, g, out = _inputs(G, m, n, k, act, seed=m + k + len(act or ""))
    got = emulate(by, g, out, n, act, ctas)
    plain, f64, jax_ref = _references(by, g, out, n, act)
    for want in (plain, f64, jax_ref):
        assert all(x.shape == y.shape for x, y in zip(got, want))
        assert all(np.all(np.isfinite(x)) for x in got)
        errs = _worst(got, want)
        assert max(errs) <= REL_TOL, errs
    # no further from f64 than the plain version (d_off: summed in f64)
    for e, p in zip(_worst(got, f64), _worst(plain, f64)):
        assert e <= p + REL_TOL


def _cancelling(n, k, seed):
    """A cotangent [1, n, k] whose sums cancel: the first half of the
    individuals positive (~1.25), the second half zero but for every 9th
    (~ -12), and what is left of each column's sum spread over 500 of the
    zeros, so each column sums to ~0. Every other value sits just above a
    bf16 grid point (grid + delta, 0 < delta < half the grid's step), so its
    mid part has its sign: a chained MMA's cut toward zero then falls on the
    same side for the many positive products and does not cancel."""
    rng = np.random.default_rng(seed)
    g = np.zeros((n, k))
    half = n // 2
    g[:half] = (1 + rng.integers(0, 64, (half, k)) * 2.0 ** -7
                + 2.0 ** -9 * rng.uniform(0.1, 0.9, (half, k)))
    neg = np.arange(half, n, 9)
    g[neg] = -(8 + rng.integers(0, 128, (len(neg), k)) * 2.0 ** -4
               + 2.0 ** -6 * rng.uniform(0.1, 0.9, (len(neg), k)))
    fix = np.setdiff1d(np.arange(half, n), neg)[:500]
    g[fix] = -g.sum(axis=0) / len(fix)
    return g.astype(F32)[None]


def test_cancelling_cotangent_needs_split3_add():
    """n = 20,000, two CTAs: a warp's running sums reach ~3,000 while dA
    cancels to a few hundred and d_off to ~0. Chained through one
    accumulator, the MMAs' cut toward zero drifts dA by 7.6e-4 of its
    largest entry; through mma_split3_add (hi's product from zero, exact;
    the adds round to nearest) it stays 1e-5 from f64. dA is held to all
    three references. d_off is held to f64: the kernel sums each tile's
    values per thread in f32 and the tiles in f64, while the plain
    version's and JAX's f32 column sums of this cotangent miss f64 by
    8.8e-4 and 1.5e-3 of max(1, |d_off|), so the emulation must lie nearer
    f64 than they do. The plain version's dA is an f32 BLAS sum whose order
    depends on the CPU (up to 2.2e-4 from f64): dA is held to it by the
    nearer-reference rule, within REL_TOL of how far it lies from f64."""
    n, m, k = 20_000, 16, 8
    rng = np.random.default_rng(3)
    by = PM.pack_strided(rng.integers(0, 3, size=(m, n)))[None]
    g = _cancelling(n, k, seed=4)
    out = np.zeros_like(g)
    plain, f64, jax_ref = _references(by, g, out, n, "identity")
    got = emulate(by, g, out, n, "identity", ctas=2)
    for want in (f64, jax_ref):
        assert _worst(got[:1], want[:1])[0] <= REL_TOL
    # the f32 plain version's own dA lies up to ~2.2e-4 from f64, by the
    # CPU BLAS's order of summation: no further from it than it is from f64
    assert _worst(got[:1], plain[:1])[0] <= _worst(plain[:1], f64[:1])[0] + REL_TOL
    assert _worst(got, f64)[1] <= REL_TOL
    assert _worst(got, f64)[1] <= min(_worst(plain, f64)[1], _worst(jax_ref, f64)[1])
    drift = emulate(by, g, out, n, "identity", ctas=2, chained=True)
    assert _worst(drift, f64)[0] > 3 * REL_TOL  # dA: fails, with room
    assert _worst(got, f64)[0] < REL_TOL / 3


@pytest.mark.parametrize("G,m,k,n,ctas", [(3, 24, 5, 700, 5), (2, 300, 40, 2100, 7),
                                          (1, 104, 16, 100_000, 396), (10, 104, 16, 100_000, 396),
                                          (100, 104, 16, 100_000, 264), (4, 13, 8, 513, 9)])
def test_every_individual_is_counted_once(G, m, k, n, ctas):
    """The items split over the CTAs cover each (branch, marker slab, column
    slab) group's individuals below n exactly once (a tile's part q, row j is
    individual 512 (t // 2) + 64 (t % 2) + 128 q + j); each CTA's partial
    row c + v of a group v it touches is its own; and the reduce's CTA
    range of each group is exactly the CTAs that touched it. Within a tile,
    warp w's k-steps (b, tig, part) cover its 16 byte columns x 4 parts once,
    and the dz pass's threads each (byte column, column) once."""
    kc, cslabs, mslabs, ms, tiles, items = plan(G, m, k, n)
    ctas = min(ctas, items)
    seen = np.zeros((G * mslabs * cslabs, n), np.int64)
    touched, slots = {}, set()
    for c in range(ctas):
        for i in range(items * c // ctas, items * (c + 1) // ctas):
            v, t = divmod(i, tiles)
            ind = ((t >> 1) * 512 + (t & 1) * TILE + 128 * np.arange(4)[:, None]
                   + np.arange(TILE)[None, :]).ravel()
            np.add.at(seen[v], ind[ind < n], 1)
            touched.setdefault(v, set()).add(c)
            slots.add((c, v))
    assert np.all(seen == 1)
    assert len({c + v for c, v in slots}) == len(slots)
    assert max(c + v for c, v in slots) < ctas + G * mslabs * cslabs - 1
    for v, cs in touched.items():
        lo, hi = cta_of(v * tiles, items, ctas), cta_of(v * tiles + tiles - 1, items, ctas)
        assert cs == set(range(lo, hi + 1))
    steps = sorted((16 * w + 4 * tig + b, part) for w in range(WARPS) for b in range(4)
                   for tig in range(4) for part in range(4))
    assert steps == [(c, p) for c in range(TILE) for p in range(4)]
    tid = np.arange(THREADS)
    pairs = sorted((int(tt // kc + (THREADS // kc) * u), int(tt % kc)) for tt in tid
                   for u in range(TILE // (THREADS // kc)))
    assert pairs == [(c, cl) for c in range(TILE) for cl in range(kc)]
