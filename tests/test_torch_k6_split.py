"""The arithmetic of K6 (rs_bann_tpu_torch/csrc/traj_dense.cu,
``traj_dense_kernel``: its gradient phase on the device code of
csrc/dense_vg_mma.cuh, its fixed work split and its update phase) on the
CPU: the kernel runs only on the card, so this file holds an emulation of
one launch, written here and not in the package, and holds a 3-step
trajectory of it to the port's plain version (``integrate_chains_ref``, f32),
to the same plain version in f64, and to the JAX package's
``integrate_chains`` (its Pallas kernel in interpret mode, as its own tests
run it), within REL_TOL of the largest entry of each output.

The emulation follows the kernel's data path. The work split: instances
(branch g, chunk of CC chains), items (instance, tile of 32 individuals)
split evenly over the CTAs, which are R per instance where the wave holds
one per instance and else one wave whose CTAs take several instances in
turn; group i of a CTA runs chain i of the chunk (none past C), one
partial row per (segment, chain), row (b + j) CC + i. Each tile of a
segment as K8's emulation (tests/test_torch_k8_split.py) computes it, with
its split of every operand other than the staged weights (hi = x
truncated to tf32, lo = x - hi rounded to tf32): the five products in
3xTF32 with the tensor cores at their worst, each
fragment's three MMAs from zero accumulators joined by round-to-nearest f32
adds, the tile's dW0 and dW1 added to the group's accumulators, the small
sums per thread, then over the quad's lanes and the warps in order. The
update phase: per (branch, chain, coordinate) the segments' rows added in
order, then the prior gradient, err, the two half kicks and the drift in
f32, as the kernel writes them. Last, the pointer and strides the wrapper
passes for each layout of a per-layer tensor that the folded transition
makes, read as the kernel reads them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_bann_tpu.ops import branch_mlp as JBM
from rs_bann_tpu.ops import leapfrog as JL
from rs_bann_tpu_torch.ops import branch_mlp as TBM
from rs_bann_tpu_torch.ops import leapfrog as TL
from test_torch_k4_split import act_np, act_prime_np, f32, fma
from test_torch_k8_split import TILE, WARPS, cta_of, km_of, mma3, pad, product, split_int, tf32

REL_TOL = 1e-4  # as the card's check of K6 after 3 steps (tests/test_torch_cuda_kernels.py)

F32 = np.float32


def work_split(G, C, n, cc, wave):
    """The kernel's plan for a wave of ``wave`` resident CTAs: (chunks,
    instances NB, tiles per branch, CTAs, CTAs per instance R or 0)."""
    chunks = -(-C // cc)
    NB, tiles = G * chunks, -(-n // TILE)
    if wave >= NB:
        rper = min(tiles, wave // NB)
        return chunks, NB, tiles, NB * rper, rper
    return chunks, NB, tiles, wave, 0


def segments(NB, tiles, ctas):
    """Each CTA's run as (CTA b, instance j, its tiles in order)."""
    items = NB * tiles
    out = []
    for b in range(ctas):
        run = range(items * b // ctas, items * (b + 1) // ctas)
        for it in run:
            j, tl = divmod(it, tiles)
            if not out or out[-1][:2] != (b, j):
                out.append((b, j, []))
            out[-1][2].append(tl)
    return out


def instance_rows(j, NB, tiles, ctas, rper):
    """The update phase's CTAs of instance j: (first, count)."""
    if rper:
        return j * rper, rper
    items = NB * tiles
    first = cta_of(j * tiles, ctas, items)
    return first, cta_of((j + 1) * tiles - 1, ctas, items) - first + 1


def segment(xg, tg, ws, bs, act, tls):
    """One group's run over the tiles ``tls`` of its branch for one chain:
    xg [m, n], tg [n], ws/bs the chain's layers (W [in, out]). Returns its
    partial row, its predictions ({individual: y_pred}) and its err^2 (f64:
    each thread's, over the quad's lanes and the warps in order, as K7 and
    K8 sum it)."""
    m, n = xg.shape
    depth, k0, s = len(ws) - 2, ws[0].shape[-1], ws[-1].shape[-2]
    KM = km_of(k0, s)
    K16 = max(KM, 16)
    m8, m16 = -(-m // 8) * 8, -(-m // 16) * 16
    W0T, b0 = pad(ws[0].T, (K16, m8)), pad(bs[0], (K16,))
    wo = pad(ws[-1][:, 0], (K16,))
    if depth:
        W1T, W1 = pad(ws[1].T, (K16, KM)), pad(ws[1], (K16, KM))
        b1 = pad(bs[1], (K16,))
    acc = {"dW0": None, "dW1": None}
    small = np.zeros((3, WARPS, 4, K16), F32)
    preds, e2 = {}, np.zeros((WARPS, 4))
    lanes = lambda v: v.reshape(K16, WARPS, 4, 2).transpose(3, 1, 2, 0)  # noqa: E731
    for tl in tls:
        xt = np.zeros((m16, TILE), F32)
        cols = np.arange(tl * TILE, min(n, (tl + 1) * TILE))
        xt[:m, :len(cols)] = xg[:, cols]
        valid = np.arange(tl * TILE, (tl + 1) * TILE) < n
        tgt = np.zeros(TILE, F32)
        tgt[:len(cols)] = tg[cols]
        # ---- phase A (units as rows, the tile's individuals as columns)
        z0 = f32(product(W0T, xt[:m8], m8) + b0[:, None])
        a0 = act_np(act, z0)
        last = a0
        if depth:
            z1 = f32(product(W1T, a0[:KM], KM) + b1[:, None])
            a1 = act_np(act, z1)
            last = a1
        p = np.zeros((8, TILE), F32)
        for mt in range(K16 // 16):
            for h in range(2):
                for g in range(8):
                    u = 16 * mt + g + 8 * h
                    p[g] = fma(wo[u], last[u], p[g])
        for o in (1, 2, 4):
            p = f32(p + p[np.arange(8) ^ o])
        err = np.where(valid, f32(p[0] - tgt), F32(0))
        preds.update(zip(cols.tolist(), p[0][:len(cols)].tolist()))
        ew = err.reshape(WARPS, 4, 2).astype(np.float64)  # thread (w, t): 8 w + 2 t, then + 1
        e2 = e2 + ew[..., 0] ** 2 + ew[..., 1] ** 2
        errs = lanes(np.broadcast_to(err, (K16, TILE)))
        if depth:
            dz1 = f32(f32(wo[:, None] * err) * act_prime_np(act, z1, a1))
            for c2, (dzc, ac) in enumerate(zip(lanes(dz1), lanes(a1))):
                small[2] = fma(ac, errs[c2], small[2])
                small[1] = f32(small[1] + dzc)
            dz0 = f32(product(W1, dz1[:KM], KM) * act_prime_np(act, z0, a0))
        else:
            dz0 = f32(f32(wo[:, None] * err) * act_prime_np(act, z0, a0))
            for c2, ac in enumerate(lanes(a0)):
                small[2] = fma(ac, errs[c2], small[2])
        for dzc in lanes(dz0):
            small[0] = f32(small[0] + dzc)
        # ---- phase B: the tile's dW0 = X dz0^T, dW1 = a0 dz1^T, then into the group's sums
        pairs = [("dW0", xt, dz0[:KM])] + ([("dW1", a0, dz1[:KM])] if depth else [])
        for name, A, D in pairs:
            sa, sb = split_int(A), split_int(D.T)
            t_acc = np.zeros((A.shape[0], KM), F32)
            for ks in range(0, TILE, 8):
                t_acc = mma3(t_acc, tuple(q[:, ks:ks + 8] for q in sa),
                             tuple(q[ks:ks + 8] for q in sb))
            acc[name] = t_acc if acc[name] is None else f32(acc[name] + t_acc)
    # ---- the flush: the small sums over the quad's lanes and the warps in order
    for o in (1, 2):
        small = f32(small + small[:, :, np.arange(4) ^ o])
    w = small[:, :, 0]
    tot = f32(f32(f32(w[:, 0] + w[:, 1]) + w[:, 2]) + w[:, 3])
    row = [acc["dW0"][:m, :k0].ravel(), tot[0, :k0]]
    if depth:
        row += [acc["dW1"][:k0, :s].ravel(), tot[1, :s]]
    row.append(tot[2, :s])
    ws2 = (e2[:, 0] + e2[:, 1]) + (e2[:, 2] + e2[:, 3])
    return np.concatenate(row), preds, ((ws2[0] + ws2[1]) + ws2[2]) + ws2[3]


def flat(ws, bs):
    """[G, C, ...] layers -> [G, C, P] in the kernel's order W0, b0, (W1, b1), w_out."""
    G, C = ws[0].shape[:2]
    parts = []
    for w, b in zip(ws[:-1], bs):
        parts += [w.reshape(G, C, -1), b.reshape(G, C, -1)]
    return np.concatenate(parts + [ws[-1].reshape(G, C, -1)], axis=-1)


def unflat(v, like_w, like_b):
    ws, bs, ix = [], [], 0
    for w, b in zip(like_w[:-1], like_b):
        ws.append(v[..., ix:ix + w[0, 0].size].reshape(w.shape))
        ix += w[0, 0].size
        bs.append(v[..., ix:ix + b.shape[-1]].reshape(b.shape))
        ix += b.shape[-1]
    ws.append(v[..., ix:].reshape(like_w[-1].shape))
    return ws, bs


def emulate(act, xT, targets, err, weights, biases, p_w, p_b, eps_w, eps_b, lam_w, lam_b, steps,
            l1, cc, wave):
    """One K6 launch. Returns (w_L, b_L, pw_L, pb_L) as numpy lists."""
    G, m, n = xT.shape
    C = targets.shape[1]
    chunks, NB, tiles, ctas, rper = work_split(G, C, n, cc, wave)
    q, pm = flat(weights, biases), flat(p_w, p_b)
    eps, lam = flat(eps_w, eps_b), flat(lam_w, lam_b)
    P = q.shape[-1]
    segs = segments(NB, tiles, ctas)
    for l in range(steps + 1):
        partial = np.full(((ctas + NB) * cc, P), np.nan, F32)
        ws, bs = unflat(q, weights, biases)
        for b, j, tls in segs:
            g = j // chunks
            for i in range(cc):
                c = (j % chunks) * cc + i
                if c < C:
                    partial[(b + j) * cc + i] = segment(
                        xT[g], targets[g, c], [w[g, c] for w in ws], [v[g, c] for v in bs], act,
                        tls)[0]
        for g in range(G):
            for c in range(C):
                j, i = g * chunks + c // cc, c % cc
                first, nseg = instance_rows(j, NB, tiles, ctas, rper)
                tot = np.zeros(P, F32)
                for r in range(nseg):
                    row = partial[(first + r + j) * cc + i]
                    assert not np.isnan(row).any()
                    tot = f32(tot + row)
                qq, pp, ep = q[g, c], pm[g, c], eps[g, c]
                prior = np.sign(qq).astype(F32) if l1 else qq
                gr = f32(f32(-lam[g, c] * prior) - f32(err[g, c] * tot))
                if l > 0:
                    pp = f32(pp + f32(f32(F32(0.5) * ep) * gr))
                if l < steps:
                    pp = f32(pp + f32(f32(F32(0.5) * ep) * gr))
                    qq = f32(qq + f32(ep * pp))
                q[g, c], pm[g, c] = qq, pp
    return (*unflat(q, weights, biases), *unflat(pm, p_w, p_b))


def _inputs(G, C, m, n, k, depth, seed):
    rng = np.random.default_rng(seed)
    widths = [(m, k), (k, k), (k, 1)] if depth else [(m, k), (k, 1)]

    def mk(sc):
        return [(rng.standard_normal((G, C, i, o)) * sc).astype(F32) for i, o in widths]

    def mkb(sc):
        return [(rng.standard_normal((G, C, o)) * sc).astype(F32) for _, o in widths[:-1]]

    weights, p_w = mk(0.3), mk(0.5)
    eps_w = [np.abs(e) * F32(0.01) for e in mk(1.0)]
    lam_w = [np.abs(e) + F32(0.5) for e in mk(1.0)]
    biases, p_b = mkb(0.1), mkb(0.5)
    eps_b = [np.abs(e) * F32(0.01) for e in mkb(1.0)]
    lam_b = [np.zeros_like(e) for e in mkb(1.0)]
    xT = rng.standard_normal((G, m, n)).astype(F32)
    xT[:, m - 2:] = 0  # padded marker rows: zero X, zero momentum and step size
    for lst in (p_w, eps_w):
        lst[0][:, :, m - 2:] = 0
    targets = rng.standard_normal((G, C, n)).astype(F32)
    err = (np.abs(rng.standard_normal((G, C))) + 0.5).astype(F32)
    return xT, targets, err, weights, biases, p_w, p_b, eps_w, eps_b, lam_w, lam_b


def _references(act, args, steps, l1):
    def torch_args(dtype):
        return [tuple(torch.from_numpy(v.astype(dtype)) for v in a) if isinstance(a, list)
                else torch.from_numpy(a.astype(dtype)) for a in args]

    refs = []
    for dtype in (np.float32, np.float64):
        out = TL.integrate_chains_ref(act, *torch_args(dtype), steps, l1=l1)
        refs.append([[v.numpy() for v in part] for part in out])
    JBM.FORCE = "interpret"
    try:
        jout = JL.integrate_chains(
            act, *(tuple(map(jnp.asarray, a)) if isinstance(a, list) else jnp.asarray(a)
                   for a in args), steps, l1=l1, interpret=True)
    finally:
        JBM.FORCE = None
    refs.append([[np.asarray(v) for v in part] for part in jout])
    return refs


CASES = [  # (G, C, m, n, k, depth, act, l1, CC, wave)
    (2, 3, 24, 100, 8, 0, "identity", False, 2, 5),  # a ragged chunk and n, a CTA per instance
    (2, 3, 24, 100, 8, 0, "tanh", True, 2, 9),       # lasso, R = 2 CTAs per instance
    (2, 2, 20, 70, 12, 1, "relu", True, 2, 5),       # depth 1, m not a multiple of 8, R = 2
    (3, 2, 16, 64, 16, 1, "tanh", False, 1, 4),      # one wave over 6 instances: runs cross them
    (2, 5, 24, 96, 8, 1, "silu", False, 2, 7),       # C = 5: chunks 2, 2, 1
]


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: "g{}_c{}_m{}_n{}_k{}_d{}_{}_l1{}_cc{}_w{}".format(*c))
def test_emulation_matches_plain_f64_and_jax(case):
    G, C, m, n, k, depth, act, l1, cc, wave = case
    steps = 3
    args = _inputs(G, C, m, n, k, depth, seed=m + n + C)
    got = emulate(act, *args, steps, l1, cc, wave)
    flat_got = [v for part in got for v in part]
    assert all(np.all(np.isfinite(v)) for v in flat_got)
    for want in _references(act, args, steps, l1):
        flat_want = [v for part in want for v in part]
        assert [v.shape for v in flat_got] == [v.shape for v in flat_want]
        errs = [np.abs(a.astype(np.float64) - b).max() / max(1.0, np.abs(b).max())
                for a, b in zip(flat_got, flat_want)]
        assert max(errs) <= REL_TOL, errs
    # the padded marker rows never move
    assert np.all(got[0][0][:, :, m - 2:] == args[3][0][:, :, m - 2:])
    assert np.all(got[2][0][:, :, m - 2:] == 0)


SPLITS = [  # (G, C, n, CC, wave, R): the flagship at CC = 2 and one CTA per SM
    (64, 4, 4096, 2, 132, 1),
    (64, 1, 4096, 1, 264, 4),     # G = 64, n = 4,096 at R = 4
    (3, 2, 1300, 2, 132, 41),     # a ragged n: a CTA a tile
    (300, 4, 257, 2, 132, 0),     # G above the resident CTAs: one wave over 600 instances
    (64, 4, 4096, 1, 396, 1),     # C = 4 at CC = 1
    (8, 5, 1000, 2, 20, 0),       # C = 5, a ragged chunk, fewer CTAs than instances
    (7, 5, 1000, 2, 50, 2),       # C = 5, R = 2
    (5, 1, 700, 2, 16, 3),        # C = 1 under CC = 2: the second group idles
]


@pytest.mark.parametrize("G,C,n,cc,wave,R", SPLITS)
def test_the_split_counts_each_chain_and_individual_once(G, C, n, cc, wave, R):
    """Every (branch, chain, individual < n) is counted exactly once per
    evaluation; each (CTA, instance, group) has a partial row of its own
    below (CTAs + NB) CC; the update phase's rows of an instance are
    exactly the CTAs that ran it; and at the flagship an evaluation writes
    at most 15 MB of partial rows (3.2 MB: one row per CTA and chain)."""
    chunks, NB, tiles, ctas, rper = work_split(G, C, n, cc, wave)
    assert rper == R and ctas <= wave
    seen = np.zeros((G, C, n), np.int64)
    rows, touched = set(), {}
    for b, j, tls in segments(NB, tiles, ctas):
        g = j // chunks
        touched.setdefault(j, []).append(b)
        for i in range(cc):
            c = (j % chunks) * cc + i
            if c >= C:
                continue
            row = (b + j) * cc + i
            assert row not in rows and row < (ctas + NB) * cc
            rows.add(row)
            for tl in tls:
                ind = tl * TILE + np.arange(TILE)
                np.add.at(seen[g, c], ind[ind < n], 1)
    assert np.all(seen == 1)
    for j in range(NB):
        first, nseg = instance_rows(j, NB, tiles, ctas, rper)
        assert touched[j] == list(range(first, first + nseg))
    if rper:
        assert all(len(v) == rper for v in touched.values())
        assert len(segments(NB, tiles, ctas)) == ctas  # one segment per CTA
    if (G, C, n) == (64, 4, 4096):
        P = 64 * 32 + 32 + 32 * 32 + 32 + 32
        written = 4 * len(rows) * P
        assert written <= 15e6
        if cc == 2:
            assert written == 4 * 128 * 2 * P  # 3.24 MB, against 104 MB in the first K6


def test_integer_split_error():
    """K6's split (split_int, as dense_vg_mma.cuh split2_int does it on the
    bits): hi + lo is x to 2^-21 of |x| (lo keeps 11 bits of x - hi, which
    is below a tf32 ulp of x), so hi*hi + hi*lo + lo*hi is a b to 2^-20 of
    |a b|, over magnitudes from 2^-60 to 2^60; a NaN (CUDA's 0x7FFFFFFF
    included) or an infinity stays so in hi."""
    rng = np.random.default_rng(0)
    a = (rng.uniform(0.5, 1, 100_000) * 2.0 ** rng.integers(-60, 60, 100_000)
         * rng.choice([-1, 1], 100_000)).astype(F32)
    b = rng.permutation(a)
    (ah, al), (bh, bl) = split_int(a), split_int(b)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    assert np.all(np.abs(ah.astype(np.float64) + al - a64) <= 2.0 ** -21 * np.abs(a64))
    assert np.all(tf32(ah) == ah) and np.all(tf32(al) == al)
    assert np.all(np.abs(ah) <= np.abs(a))
    prod = ah.astype(np.float64) * bh + ah.astype(np.float64) * bl + al.astype(np.float64) * bh
    assert np.all(np.abs(prod - a64 * b64) <= 2.0 ** -20 * np.abs(a64 * b64))
    special = np.array([0x7FFFFFFF, 0xFFC00000, 0x7F800000, 0xFF800000], np.uint32).view(F32)
    with np.errstate(invalid="ignore"):  # lo = inf - inf
        hi = split_int(special)[0]
    assert np.all(np.isnan(hi[:2])) and list(hi[2:]) == [np.inf, -np.inf]


def _fold_layouts():
    """[G, C, ...] views as the folded transition hands them to K6: [C, G]
    storage transposed, the step sizes and prior factors expanded from
    per-row, per-layer and per-bias precisions, err expanded over branches;
    and a weight whose trailing dims are not contiguous."""
    G, C, m, k = 3, 2, 5, 4
    gen = torch.Generator().manual_seed(3)
    r = lambda *s: torch.rand(s, generator=gen)  # noqa: E731
    w = r(C, G, m, k)
    return {
        "weight": (r(C, G, m, k).transpose(0, 1), False),
        "ard eps": ((1 / r(C, G, m, 1)).expand_as(w).transpose(0, 1), True),
        "base lam": (r(C, G, 1, 1).expand_as(w).transpose(0, 1), True),
        "w_out lam": (r(C, G, 1, 1).expand(C, G, k, 1).transpose(0, 1), True),
        "bias eps": (r(C, G, 1).expand(C, G, k).transpose(0, 1), True),
        "eps, not broadcast": (r(C, G, m, k).transpose(0, 1), True),
        "bias lam, not broadcast": (r(C, G, k).transpose(0, 1), True),
        "err": (r(1, C).expand(G, C), False),
        "weight, trailing dims transposed": (r(G, C, k, m).transpose(2, 3), False),
    }


@pytest.mark.parametrize("kind", list(_fold_layouts()))
def test_the_wrapper_passes_each_tensor_as_it_lies(kind):
    """What ``_integrate_dense_cuda`` hands the C entry for one per-layer
    tensor (``pass_instances``, each by ``_instances``): read at the strides
    it passes as the kernel reads it (the step sizes and prior factors at
    (g, c, row, column), the
    others at (g, c) plus the element's index), every element is the
    tensor's. Broadcast step sizes and prior factors are passed in place
    (stride 0, no copy); only a tensor with non-contiguous trailing dims
    that the kernel reads as contiguous is copied."""
    t, any_strides = _fold_layouts()[kind]
    held, ptr, (sg, sc, sr, sk) = TBM._instances(t, kind, t.shape, t.device, any_strides)
    G, C = t.shape[:2]
    rows, cols = tuple(t.shape[2:]) if t.dim() == 4 else (1, t[0, 0].numel())
    if any_strides:
        assert ptr == t.data_ptr() and held is t
        read = held.as_strided((G, C, rows, cols), (sg, sc, sr, sk))
    else:
        assert (ptr == t.data_ptr()) == t[0, 0].is_contiguous()
        read = held.as_strided((G, C, rows * cols), (sg, sc, 1)).reshape(G, C, rows, cols)
    assert torch.equal(read, t.reshape(G, C, rows, cols))
