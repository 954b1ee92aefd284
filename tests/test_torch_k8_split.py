"""The arithmetic of K8 (rs_bann_tpu_torch/csrc/branch_vg_dense.cu,
``vg_dense_kernel`` and its fixed-order reduce, on the device code of
csrc/dense_vg_mma.cuh) on the CPU: the kernel runs only on the card, so
this file holds an emulation of one launch, written here and not in the
package, and holds it to the port's plain version (``data_vg_blocked`` on a
CPU tensor, f32), to the same plain version in f64, and to the JAX
package's ``data_vg`` (its Pallas kernel in interpret mode, as its own tests
run it), within REL_TOL of the largest entry of each output.

The emulation follows the kernel's data path: the work split (items =
(instance, tile of 32 individuals), an even run per CTA, one partial row per
instance a CTA touches, in row c + j); each operand split into tf32 parts:
the staged weights by cvt.rna, hi = tf32(v) (round to nearest, ties away)
and lo = tf32(v - hi), every other operand as csrc/dense_vg_mma.cuh
split2_int splits it, hi = v truncated to tf32 and lo = tf32(v - hi); the five
products as m16n8k8 fragments over k-steps of 8 (markers or units for Z0,
Z1 and dA0; the tile's individuals for dW0 and dW1), each fragment's
hi*hi, lo*hi and hi*lo from zero accumulators, joined to the f32 sum by
round-to-nearest adds, acc + (hh + (lh + hl)); each MMA modelled as the
tensor cores at their worst (its exact products and accumulator aligned to
the largest, each cut toward zero to 24 bits, the sum cut toward zero to
f32); pred as
each thread's share of the units then a butterfly over the lanes; the small
sums (db0, db1, dw_out) per thread over its individuals, then over the
quad's lanes and the warps in order; each tile's dW0 and dW1 added to the
CTA's accumulators; err^2 in f64; and the reduce's slices.

Why 3xTF32 and not three bf16 parts each: v - hi is exact, so hi + lo is v
to 2^-22 (2^-21 truncated) and the dropped lo*lo term 2^-22 of |a b|: 2^-21
(2^-20) per product, at least 2^-6.7 below REL_TOL, in three MMAs per fragment at the tf32 rate (the
tensor time of six bf16 products, which would reach 2^-24) and two parts
per operand instead of three (``test_tf32_split_error``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_bann_tpu.ops import branch_mlp as JBM
from rs_bann_tpu_torch.ops import branch_mlp as TBM
from test_torch_k4_split import act_np, act_prime_np, f32, fma, trunc32

REL_TOL = 1e-4  # as chip_smoke.py: f32 sums over markers and over n in another order

F32 = np.float32
TILE, WARPS, SLICES = 32, 4, 8  # as dense_vg_mma.cuh: kT, kWarps, kSlices


def tf32(x):
    """cvt.rna.tf32.f32: 10 explicit mantissa bits, ties away from zero."""
    bits = np.ascontiguousarray(x, F32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def split2(x):
    """dense_vg_mma.cuh split2, the staged weights' split (cvt.rna twice)."""
    x = np.asarray(x, F32)
    hi = tf32(x)
    return hi, tf32(f32(x.astype(np.float64) - hi))


def split_int(x):
    """dense_vg_mma.cuh split2_int, the split of every operand but the
    staged weights: hi = x with its low 13 bits cleared, lo = tf32(x - hi)
    (round to nearest, ties away)."""
    x = np.asarray(x, F32)
    hi = (x.view(np.uint32) & np.uint32(0xFFFFE000)).view(F32)
    return hi, tf32(f32(x.astype(np.float64) - hi))


def mma(acc, A, B):
    """acc [..., M, N] + A [..., M, 8] @ B [..., 8, N] (tf32 values) as the
    tensor cores are modelled here, no better than they are: the 8 exact
    products and the accumulator aligned to the largest of them, each cut
    toward zero to 24 bits, summed, and the sum cut toward zero to f32."""
    terms = np.concatenate([acc.astype(np.float64)[..., :, None, :],
                            A.astype(np.float64)[..., :, :, None] * B.astype(np.float64)[..., None, :, :]],
                           axis=-2)  # [..., M, 9, N]
    _, e = np.frexp(np.abs(terms).max(axis=-2, keepdims=True))
    u = np.ldexp(1.0, e - 24)
    return trunc32((np.trunc(terms / u) * u).sum(axis=-2))


def mma3(acc, A, B, chained=False):
    """dense_vg_mma.cuh mma3_add for one k-step: A (hi, lo), B (hi, lo).
    ``chained``: the three MMAs straight into ``acc`` (what the kernel does
    not do)."""
    (ah, al), (bh, bl) = A, B
    if chained:
        return mma(mma(mma(acc, ah, bh), al, bh), ah, bl)
    zero = np.zeros_like(acc)
    hh, lh, hl = mma(zero, ah, bh), mma(zero, al, bh), mma(zero, ah, bl)
    small = f32(lh.astype(np.float64) + hl)
    return f32(acc.astype(np.float64) + f32(hh.astype(np.float64) + small))


def product(A, B, k):
    """D [M, N] = A [M, k] @ B [k, N] over k-steps of 8, each joined by mma3:
    A the staged weights (split2), B split by split_int."""
    d = np.zeros((A.shape[0], B.shape[1]), F32)
    sa, sb = split2(A), split_int(B)
    for kc in range(0, k, 8):
        d = mma3(d, tuple(p[:, kc:kc + 8] for p in sa), tuple(p[kc:kc + 8] for p in sb))
    return d


def pad(a, shape):
    out = np.zeros(shape, F32)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


def km_of(k0, s):
    return next(k for k in (8, 16, 32) if max(k0, s) <= k)


def cta_of(x, ctas, items):
    """dense_vg_mma.cuh cta_of: the CTA whose even run holds item x."""
    return ((x + 1) * ctas - 1) // items


def emulate(X, ix, weights, biases, targets, act, ctas, chained=False):
    """One launch and its reduce for NB instances (X [G, m, n], instance j
    on X[ix[j]]; weights[l] [NB, in, out]) with ``ctas`` CTAs. Returns
    (y_pred [NB, n], rss [NB], dws, dbs); ``chained`` runs phase B's MMAs
    into the CTA's accumulators without the f32 joins."""
    G, m, n = X.shape
    NB, depth = weights[0].shape[0], len(weights) - 2
    k0, s = weights[0].shape[-1], weights[-1].shape[-2]
    KM = km_of(k0, s)
    K16 = max(KM, 16)
    m8, m16 = -(-m // 8) * 8, -(-m // 16) * 16
    tiles = -(-n // TILE)
    items = NB * tiles
    P = m * k0 + k0 + (k0 * s + s if depth else 0) + s
    partial = np.full((ctas + NB, P), np.nan, F32)
    e2 = np.full(ctas + NB, np.nan)
    y_pred = np.full((NB, n), np.nan, F32)
    for c in range(ctas):
        j_cur = -1
        for it in range(items * c // ctas, items * (c + 1) // ctas):
            j, tl = divmod(it, tiles)
            if j != j_cur:
                if j_cur >= 0:
                    flush(partial, e2, c, j_cur, acc, m, k0, s, depth)
                j_cur = j
                W0T = pad(weights[0][j].T, (K16, m8))
                b0 = pad(biases[0][j], (K16,))
                wo = pad(weights[-1][j][:, 0], (K16,))
                if depth:
                    W1T, W1 = pad(weights[1][j].T, (K16, KM)), pad(weights[1][j], (K16, KM))
                    b1 = pad(biases[1][j], (K16,))
                acc = {"dW0": np.zeros((m16, KM), F32), "dW1": np.zeros((K16, KM), F32),
                       "small": np.zeros((3, WARPS, 4, K16), F32), "e2": np.zeros((WARPS, 4))}
            # the X tile, zero past m and n
            xt = np.zeros((m16, TILE), F32)
            cols = np.arange(tl * TILE, min(n, (tl + 1) * TILE))
            xt[:m, :len(cols)] = X[ix[j] if ix is not None else j][:, cols]
            valid = np.arange(tl * TILE, (tl + 1) * TILE) < n
            tg = np.zeros(TILE, F32)
            tg[:len(cols)] = targets[j][cols]
            # ---- phase A (units as rows, the tile's individuals as columns)
            z0 = f32(product(W0T, xt[:m8], m8) + b0[:, None])
            a0 = act_np(act, z0)
            last = a0
            if depth:
                z1 = f32(product(W1T, a0[:KM], KM) + b1[:, None])
                a1 = act_np(act, z1)
                last = a1
            # pred: thread (g, t) sums units 16 mt + g + 8 h in order, then a
            # butterfly over g (lanes xor 4, 8, 16)
            p = np.zeros((8, TILE), F32)
            for mt in range(K16 // 16):
                for h in range(2):
                    for g in range(8):
                        u = 16 * mt + g + 8 * h
                        p[g] = fma(wo[u], last[u], p[g])
            for o in (1, 2, 4):
                p = f32(p + p[np.arange(8) ^ o])
            pred = p[0]
            y_pred[j, cols] = pred[:len(cols)]
            err = np.where(valid, f32(pred - tg), F32(0))
            # per thread (warp w, t): individuals 8 w + 2 t, then + 1
            ew = err.reshape(WARPS, 4, 2).astype(np.float64)
            acc["e2"] = acc["e2"] + ew[..., 0] ** 2 + ew[..., 1] ** 2  # fma in f64: exact products
            lanes = lambda v: v.reshape(K16, WARPS, 4, 2).transpose(3, 1, 2, 0)  # noqa: E731
            small = acc["small"]
            if depth:
                dz1 = f32(f32(wo[:, None] * err) * act_prime_np(act, z1, a1))
                for c2, (dzc, ac) in enumerate(zip(lanes(dz1), lanes(a1))):
                    small[2] = fma(ac, lanes(np.broadcast_to(err, (K16, TILE)))[c2], small[2])
                    small[1] = f32(small[1] + dzc)
                da = product(W1, dz1[:KM], KM)
                dz0 = f32(da * act_prime_np(act, z0, a0))
            else:
                dz0 = f32(f32(wo[:, None] * err) * act_prime_np(act, z0, a0))
                for c2, ac in enumerate(lanes(a0)):
                    small[2] = fma(ac, lanes(np.broadcast_to(err, (K16, TILE)))[c2], small[2])
            for dzc in lanes(dz0):
                small[0] = f32(small[0] + dzc)
            # ---- phase B: dW0 = X dz0^T, dW1 = a0 dz1^T over the tile's k-steps
            pairs = [("dW0", xt, dz0[:KM])] + ([("dW1", a0, dz1[:KM])] if depth else [])
            for name, A, D in pairs:
                sa, sb = split_int(A), split_int(D.T)
                if chained:
                    for ks in range(0, TILE, 8):
                        acc[name] = mma3(acc[name], tuple(q[:, ks:ks + 8] for q in sa),
                                         tuple(q[ks:ks + 8] for q in sb), chained=True)
                else:
                    t_acc = np.zeros_like(acc[name])
                    for ks in range(0, TILE, 8):
                        t_acc = mma3(t_acc, tuple(q[:, ks:ks + 8] for q in sa),
                                     tuple(q[ks:ks + 8] for q in sb))
                    acc[name] = f32(acc[name] + t_acc)
        flush(partial, e2, c, j_cur, acc, m, k0, s, depth)

    # ---- the reduce: per column, slices of every kSlices-th segment, then the slices
    grads = np.zeros((NB, P), F32)
    rss = np.zeros(NB, F32)
    for j in range(NB):
        first = cta_of(j * tiles, ctas, items)
        nseg = cta_of((j + 1) * tiles - 1, ctas, items) - first + 1
        rows = partial[first + j:first + j + nseg]
        assert not np.isnan(rows).any()
        tot, dtot = None, None
        for sl in range(SLICES):
            sf, sd = np.zeros(P, F32), 0.0
            for q in range(sl, nseg, SLICES):
                sf = f32(sf + rows[q])
                sd += e2[first + j + q]
            tot = sf if tot is None else f32(tot + sf)
            dtot = sd if dtot is None else dtot + sd
        grads[j], rss[j] = tot, F32(dtot)
    sizes = [m * k0, k0] + ([k0 * s, s] if depth else []) + [s]
    parts = np.split(grads, np.cumsum(sizes)[:-1], axis=1)
    dws = [parts[0].reshape(NB, m, k0)] + ([parts[2].reshape(NB, k0, s)] if depth else []) \
        + [parts[-1].reshape(NB, s, 1)]
    dbs = [parts[1]] + ([parts[3]] if depth else [])
    return y_pred, rss, dws, dbs


def flush(partial, e2, c, j, acc, m, k0, s, depth):
    """The CTA's segment row of instance j: the small sums over the quad's
    lanes (xor 1, 2) and the warps in order, the accumulators as they are."""
    small = acc["small"]
    for o in (1, 2):
        small = f32(small + small[:, :, np.arange(4) ^ o])
    w = small[:, :, 0]
    tot = f32(f32(f32(w[:, 0] + w[:, 1]) + w[:, 2]) + w[:, 3])  # [3, K16]
    row = [acc["dW0"][:m, :k0].ravel(), tot[0, :k0]]
    if depth:
        row += [acc["dW1"][:k0, :s].ravel(), tot[1, :s]]
    row.append(tot[2, :s])
    partial[c + j] = np.concatenate(row)
    ee = acc["e2"]
    wsum = (ee[:, 0] + ee[:, 1]) + (ee[:, 2] + ee[:, 3])
    e2[c + j] = ((wsum[0] + wsum[1]) + wsum[2]) + wsum[3]


def _inputs(NB, G, m, n, k, depth, seed):
    rng = np.random.default_rng(seed)
    widths = [(m, k), (k, k), (k, 1)] if depth else [(m, k), (k, 1)]
    ws = [(rng.standard_normal((NB, i, o)) * 0.3).astype(F32) for i, o in widths]
    bs = [(rng.standard_normal((NB, o)) * 0.1).astype(F32) for _, o in widths[:-1]]
    X = rng.standard_normal((G, m, n)).astype(F32)
    X[:, m - 2:] = 0  # padded marker rows
    ix = rng.integers(0, G, NB).astype(np.int32)
    return X, ix, ws, bs, rng.standard_normal((NB, n)).astype(F32)


def _references(act, X, ix, ws, bs, targets):
    t = torch.from_numpy
    plain = TBM.data_vg_blocked(act, t(X), t(ix), tuple(map(t, ws)), tuple(map(t, bs)), t(targets))
    d = lambda v: torch.from_numpy(np.asarray(v, np.float64))  # noqa: E731
    f64 = TBM.data_vg_blocked_ref(act, d(X), t(ix), tuple(map(d, ws)), tuple(map(d, bs)),
                                  d(targets))
    JBM.FORCE = "interpret"
    try:
        outs = [JBM.data_vg(act, jnp.asarray(X[ix[j]]), tuple(jnp.asarray(w[j]) for w in ws),
                            tuple(jnp.asarray(b[j]) for b in bs), jnp.asarray(targets[j]))
                for j in range(len(ix))]
    finally:
        JBM.FORCE = None
    jax_out = (np.stack([np.asarray(o[0]) for o in outs]), np.array([float(o[1]) for o in outs]),
               [np.stack([np.asarray(o[2][l]) for o in outs]) for l in range(len(ws))],
               [np.stack([np.asarray(o[3][l]) for o in outs]) for l in range(len(bs))])
    numpy = lambda r: (r[0].numpy(), r[1].numpy(), [v.numpy() for v in r[2]],  # noqa: E731
                       [v.numpy() for v in r[3]])
    return numpy(plain), numpy(f64), jax_out


def _flat(r):
    return [r[0], r[1], *r[2], *r[3]]


def _worst(got, want):
    """Per output: the largest difference over max(1, its largest entry)."""
    return [np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64)).max()
            / max(1.0, np.abs(np.asarray(w, np.float64)).max())
            for g, w in zip(_flat(got), _flat(want))]


CASES = [  # (NB, G, m, n, k, depth, ctas)
    (1, 1, 24, 100, 8, 0, 3),    # K8a: ragged n, 4 tiles over 3 CTAs
    (1, 1, 40, 257, 16, 1, 5),   # depth 1, m not a multiple of 16
    (3, 2, 16, 70, 32, 1, 4),    # K8b: runs that cross instances, ix repeats a branch
    (5, 3, 24, 64, 12, 0, 7),    # a width stored wider than the MMA's 8-column tiles
]


@pytest.mark.parametrize("act", TBM.SUPPORTED_ACTIVATIONS)
@pytest.mark.parametrize("case", CASES, ids=lambda c: "nb{}_g{}_m{}_n{}_k{}_d{}_ctas{}".format(*c))
def test_emulation_matches_plain_f64_and_jax(case, act):
    NB, G, m, n, k, depth, ctas = case
    X, ix, ws, bs, targets = _inputs(NB, G, m, n, k, depth, seed=m + n + len(act))
    got = emulate(X, ix, ws, bs, targets, act, ctas)
    for want in _references(act, X, ix, ws, bs, targets):
        assert all(np.shape(a) == np.shape(b) for a, b in zip(_flat(got), _flat(want)))
        assert all(np.all(np.isfinite(a)) for a in _flat(got))
        errs = _worst(got, want)
        assert max(errs) <= REL_TOL, errs
    # the padded marker rows get exactly zero gradient
    assert np.all(got[2][0][:, m - 2:] == 0)


def test_tf32_split_error():
    """hi + lo is v to 2^-22 of |v| (v - hi is exact in f32, lo keeps 11
    bits of it), so hi*hi + hi*lo + lo*hi is a b to 2^-21 of |a b| over
    magnitudes from 2^-60 to 2^60."""
    rng = np.random.default_rng(0)
    a = (rng.uniform(0.5, 1, 100_000) * 2.0 ** rng.integers(-60, 60, 100_000)
         * rng.choice([-1, 1], 100_000)).astype(F32)
    b = rng.permutation(a)
    (ah, al), (bh, bl) = split2(a), split2(b)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    assert np.all(np.abs(ah.astype(np.float64) + al - a64) <= 2.0 ** -22 * np.abs(a64))
    assert np.all(np.abs(tf32(ah) - ah) == 0) and np.all(np.abs(tf32(al) - al) == 0)
    prod = ah.astype(np.float64) * bh + ah.astype(np.float64) * bl + al.astype(np.float64) * bh
    assert np.all(np.abs(prod - a64 * b64) <= 2.0 ** -21 * np.abs(a64 * b64))


def _cancelling(n, seed):
    """A residual [n] whose sums cancel: the first half ~1.25, the second
    half zero but for every 9th (~ -12) and what is left spread over 200 of
    the zeros. Each value is a point of a 2^-7 grid, so its tf32 hi part is
    the whole value and a hi*hi MMA of 8 such products is exact: the joins
    add nothing, while a chained accumulator of ~n/2 cuts its low bits
    toward zero at every MMA."""
    rng = np.random.default_rng(seed)
    e = np.zeros(n)
    half = n // 2
    e[:half] = 1 + rng.integers(0, 64, half) * 2.0 ** -7
    neg = np.arange(half, n, 9)
    e[neg] = -(8 + rng.integers(0, 128, len(neg)) * 2.0 ** -4)
    fix = np.setdiff1d(np.arange(half, n), neg)[:200]
    e[fix] = np.round(-e.sum() / len(fix) * 2.0 ** 7) * 2.0 ** -7
    return e


def test_cancelling_sums_need_the_joins():
    """Identity, depth 0, one instance, n = 2,048 over 2 CTAs (32 tiles
    each); X in [1, 1.03) on a 2^-7 grid and the targets made so that err is
    the cancelling residual above: dW0 sums to ~2 and db0 to ~0 while CTA
    0's running sums of dW0 reach ~640. Chained through its accumulator,
    phase B's MMAs cut dW0 by 1.1e-3 of max(1, |dW0|) from f64; with the
    joins it stays 4.5e-5 from f64 (JAX's kernel: 1.5e-5), what f32 running
    sums over 32 tiles lose, and every output within REL_TOL of f64 and JAX
    and, by the nearer-reference rule, of the f32 plain version (its BLAS
    order of summation depends on the CPU)."""
    n, m, k = 2048, 8, 8
    rng = np.random.default_rng(3)
    X = (1 + rng.integers(0, 4, (1, m, n)) * 2.0 ** -7).astype(F32)
    ws = [np.full((1, m, k), 2.0 ** -3, F32), np.full((1, k, 1), 0.5, F32)]
    bs = [np.zeros((1, k), F32)]
    ix = np.zeros(1, np.int32)
    pred = TBM.data_vg_ref("identity", torch.from_numpy(X[0].astype(np.float64)),
                           tuple(torch.from_numpy(w[0].astype(np.float64)) for w in ws),
                           (torch.from_numpy(bs[0][0].astype(np.float64)),),
                           torch.zeros(n, dtype=torch.float64))[0].numpy()
    targets = f32(pred - _cancelling(n, seed=4))[None]
    plain, f64, jax_ref = _references("identity", X, ix, ws, bs, targets)
    got = emulate(X, ix, ws, bs, targets, "identity", ctas=2)
    for want in (f64, jax_ref):
        assert max(_worst(got, want)) <= REL_TOL
    # the f32 plain version's sums over n in the CPU BLAS's order: no
    # further from it than it lies from f64, plus REL_TOL
    for e, p in zip(_worst(got, plain), _worst(plain, f64)):
        assert e <= p + REL_TOL
    assert _worst(got, f64)[2] <= REL_TOL / 2  # dW0
    drift = emulate(X, ix, ws, bs, targets, "identity", ctas=2, chained=True)
    assert _worst(drift, f64)[2] > 3 * REL_TOL  # dW0: fails, with room


@pytest.mark.parametrize("NB,n,per_sm", [(1, 4096, 1), (1, 4096, 2), (32, 4096, 2),
                                         (64, 4096, 2), (64, 4096, 3), (1, 4097, 2),
                                         (32, 1000, 3), (5, 31, 1), (3, 70, 2)])
def test_every_individual_is_counted_once(NB, n, per_sm):
    """One wave (per_sm x 132 CTAs, at most one per item) split evenly over
    the NB x ceil(n / 32) items covers each instance's individuals below n
    exactly once; each CTA's partial row c + j of an instance j it touches
    is its own and lies below ctas + NB; and the reduce's CTA range of each
    instance is exactly the CTAs that touched it. Within a tile, warp w's
    columns 8 w + 2 t + {0, 1} (phase A) and the k-steps 8 ks + t, + 4
    (phase B) cover the 32 individuals once each."""
    tiles = -(-n // TILE)
    items = NB * tiles
    ctas = min(per_sm * 132, items)
    seen = np.zeros((NB, n), np.int64)
    touched, slots = {}, set()
    for c in range(ctas):
        run = range(items * c // ctas, items * (c + 1) // ctas)
        assert len(run) >= 1
        for it in run:
            j, tl = divmod(it, tiles)
            ind = tl * TILE + np.arange(TILE)
            np.add.at(seen[j], ind[ind < n], 1)
            touched.setdefault(j, set()).add(c)
            slots.add((c, j))
    assert np.all(seen == 1)
    assert len({c + j for c, j in slots}) == len(slots)
    assert max(c + j for c, j in slots) < ctas + NB
    for j, cs in touched.items():
        first, last = cta_of(j * tiles, ctas, items), cta_of((j + 1) * tiles - 1, ctas, items)
        assert cs == set(range(first, last + 1))
    phase_a = sorted(8 * w + 2 * t + c for w in range(WARPS) for t in range(4) for c in range(2))
    phase_b = sorted(8 * ks + t + 4 * h for ks in range(TILE // 8) for t in range(4)
                     for h in range(2))
    assert phase_a == phase_b == list(range(TILE))
    if NB == 1 and n == 4096:
        assert ctas == 128  # the one-instance call: 128 of the 132 SMs busy


@pytest.mark.parametrize("act,slope", [("relu", 0.0), ("leaky_relu", 0.01)])
def test_kink_allowance_counts_a_term_at_the_kink(act, slope):
    """The card checks' allowance at relu's and leaky_relu's kink
    (tests/test_torch_cuda_kernels.py ``kink_allowance``), on the CPU: one
    pre-activation exactly at 0 (unit 0, individual 5) gives exactly that
    individual's gradient terms x (1 - slope) and zero elsewhere, and covers
    the gradient with that term taken on either side; a smooth activation
    has none, and more near terms than a handful fail."""
    from test_torch_cuda_kernels import kink_allowance

    rng = np.random.default_rng(7)
    m, n, k = 6, 20, 4
    xT = torch.from_numpy(rng.integers(-8, 9, (m, n)) / 8.0)
    w0 = torch.from_numpy(rng.integers(-8, 9, (m, k)) / 8.0)
    wo = torch.from_numpy(rng.standard_normal((k, 1)) * 0.5).float().double()
    b0 = torch.from_numpy(rng.standard_normal(k) * 0.1).float().double()
    b0[0] = -(w0[:, 0] @ xT[:, 5])
    target = torch.from_numpy(rng.standard_normal(n)).float().double()
    ws, bs = (w0.float(), wo.float()), (b0.float(),)
    assert float((w0[:, 0] @ xT[:, 5]) + b0[0]) == 0.0
    allow = kink_allowance(act, xT.float(), ws, bs, target.float())
    y, _, dws, dbs = TBM.data_vg_ref(act, xT, (w0, wo), (b0,), target)
    err5 = float(y[5] - target[5])
    want_w0 = torch.zeros(m, k, dtype=torch.float64)
    want_w0[:, 0] = (xT[:, 5] * wo[0, 0] * err5).abs() * (1 - slope)
    want_b0 = torch.zeros(k, dtype=torch.float64)
    want_b0[0] = abs(wo[0, 0] * err5) * (1 - slope)
    assert torch.allclose(allow[0], want_w0, rtol=1e-12, atol=1e-15)
    assert torch.all(allow[1] == 0)  # w_out: a0 = 0 on either side of the kink
    assert torch.allclose(allow[2], want_b0, rtol=1e-12, atol=1e-15)
    # the term on the other side of the kink: within the allowance of the plain version
    flipped = dws[0].clone()
    flipped[:, 0] += xT[:, 5] * wo[0, 0] * err5 * (1 - slope)
    assert torch.all((flipped - dws[0]).abs() <= allow[0] + 1e-15)
    assert kink_allowance("tanh", xT.float(), ws, bs, target.float()) is None
    with pytest.raises(AssertionError, match="at the kink"):
        signs = torch.tensor([1.0, -1.0] * (m // 2))[:, None].expand(m, k)
        kink_allowance(act, torch.ones(m, n), (signs.contiguous(), wo.float()),
                       (torch.full((k,), 1e-9),), target.float())
