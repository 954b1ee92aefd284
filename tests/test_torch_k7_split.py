"""The arithmetic of K7 (rs_bann_tpu_torch/csrc/vg_chains.cuh,
``vg_chains_kernel`` and csrc/branch_vg_chains.cu's fixed-order reduce, on
the device code of csrc/dense_vg_mma.cuh) on the CPU: the kernel runs only
on the card, so this file holds an emulation of one launch, written here and
not in the package, and holds it to the port's plain version
(``data_vg_chains_ref``, f32), to the same plain version in f64, and to the
JAX package's ``data_vg_chains(..., f32=True)`` (its Pallas kernel in
interpret mode, as its own tests run it), within REL_TOL of the largest
entry of each output.

The emulation follows the kernel's data path. The work split, as K6's
(tests/test_torch_k6_split.py): instances (branch g, chunk of CC chains),
items (instance, tile of 32 individuals) split evenly over one wave of CTAs,
R per instance where the wave holds one per instance and else the wave's
CTAs taking several instances in turn; group i of a CTA runs chain i of the
chunk (none past C). Each group's run over an instance's tiles (a segment)
as K6's emulation computes it: the five products in 3xTF32 with the tensor
cores at their worst, the staged weights split by cvt.rna and every other
operand by split2_int, each fragment's three MMAs joined by
round-to-nearest f32 adds, the small sums per thread then over the quad's
lanes and the warps in order; y_pred from the lanes' butterfly, err^2 per
thread in f64. One partial row and one err^2 per (segment, chain), in row
(b + j) CC + i. The reduce: per (branch, chain) the rows of its CTAs in
kSlices slices, each summed from zero, the slices in order; rss in f64.
Last, the pointers and strides the wrapper passes for each per-layer tensor,
``predict_chains``' transposed views included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_bann_tpu.ops import branch_mlp as JBM
from rs_bann_tpu_torch.ops import branch_mlp as TBM
from test_torch_k6_split import segment, segments, work_split
from test_torch_k8_split import SLICES, TILE, cta_of

REL_TOL = 1e-4  # as the card's check of K7 (tests/test_torch_cuda_kernels.py)

F32 = np.float32


def reduce_rows(rows, e2s):
    """One chain's gradients and rss from its segment rows in order: slice
    sl adds rows sl, sl + kSlices, ... from zero (f32; err^2 in f64), then
    the slices are added in order."""
    tot, dtot = None, None
    for sl in range(SLICES):
        sf, sd = np.zeros(rows.shape[1], F32), 0.0
        for q in range(sl, len(rows), SLICES):
            sf = (sf + rows[q]).astype(F32)
            sd += e2s[q]
        tot = sf if tot is None else (tot + sf).astype(F32)
        dtot = sd if dtot is None else dtot + sd
    return tot, F32(dtot)


def emulate(act, xT, weights, biases, targets, cc, wave):
    """One K7 launch with its reduce on ``wave`` resident CTAs of ``cc``
    chains. Returns (y_pred [G, C, n], rss [G, C], dws, dbs) as numpy."""
    G, m, n = xT.shape
    C = targets.shape[1]
    depth, k0, s = len(weights) - 2, weights[0].shape[-1], weights[-1].shape[-2]
    P = TBM._flat_size(m, k0, s, depth)
    chunks, NB, tiles, ctas, _ = work_split(G, C, n, cc, wave)
    partial = np.full(((ctas + NB) * cc, P), np.nan, F32)
    e2 = np.full((ctas + NB) * cc, np.nan)
    y = np.full((G, C, n), np.nan, F32)
    for b, j, tls in segments(NB, tiles, ctas):
        g = j // chunks
        for i in range(cc):
            c = (j % chunks) * cc + i
            if c >= C:
                continue
            row, preds, e = segment(xT[g], targets[g, c], [w[g, c] for w in weights],
                                    [v[g, c] for v in biases], act, tls)
            partial[(b + j) * cc + i], e2[(b + j) * cc + i] = row, e
            y[g, c, list(preds)] = list(preds.values())
    grads, rss = np.zeros((G, C, P), F32), np.zeros((G, C), F32)
    items = NB * tiles
    for g in range(G):
        for c in range(C):
            j, i = g * chunks + c // cc, c % cc
            first = cta_of(j * tiles, ctas, items)
            nseg = cta_of((j + 1) * tiles - 1, ctas, items) - first + 1
            idx = [(first + j + q) * cc + i for q in range(nseg)]
            assert not np.isnan(partial[idx]).any()
            grads[g, c], rss[g, c] = reduce_rows(partial[idx], e2[idx])
    dws, dbs = TBM._grad_views(torch.from_numpy(grads), (G, C), m, k0, s, depth)
    return y, rss, [v.numpy() for v in dws], [v.numpy() for v in dbs]


def _inputs(G, C, m, n, k, depth, seed):
    rng = np.random.default_rng(seed)
    widths = [(m, k), (k, k), (k, 1)] if depth else [(m, k), (k, 1)]
    ws = [(rng.standard_normal((G, C, i, o)) * 0.3).astype(F32) for i, o in widths]
    bs = [(rng.standard_normal((G, C, o)) * 0.1).astype(F32) for _, o in widths[:-1]]
    xT = rng.standard_normal((G, m, n)).astype(F32)
    xT[:, m - 2:] = 0  # padded marker rows
    return xT, ws, bs, rng.standard_normal((G, C, n)).astype(F32)


def _flat(r):
    return [r[0], r[1], *r[2], *r[3]]


def _references(act, xT, ws, bs, targets):
    refs = []
    for dtype in (np.float32, np.float64):
        t = lambda a: torch.from_numpy(np.asarray(a).astype(dtype))  # noqa: E731
        out = TBM.data_vg_chains(act, t(xT), tuple(map(t, ws)), tuple(map(t, bs)), t(targets))
        refs.append([v.numpy() for v in _flat(out)])
    JBM.FORCE = "interpret"
    try:
        jout = JBM.data_vg_chains(act, jnp.asarray(xT), tuple(map(jnp.asarray, ws)),
                                  tuple(map(jnp.asarray, bs)), jnp.asarray(targets), f32=True)
    finally:
        JBM.FORCE = None
    refs.append([np.asarray(v) for v in _flat(jout)])
    return refs


CASES = [  # (G, C, m, n, k, depth, act, CC, wave)
    (2, 1, 24, 100, 8, 0, "identity", 1, 5),   # one chain, a ragged n, R = 2
    (2, 3, 20, 70, 12, 1, "tanh", 2, 5),       # C = 3: chunks of 2 and 1, m not a multiple of 8
    (3, 4, 24, 64, 16, 1, "relu", 2, 4),       # one wave over 6 instances: runs cross them
    (2, 4, 40, 130, 8, 0, "silu", 2, 9),       # C = 4, R = 2, m not a multiple of 16
    (1, 3, 16, 33, 32, 1, "leaky_relu", 1, 7),  # width 32 at CC = 1, n one past a tile
]


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: "g{}_c{}_m{}_n{}_k{}_d{}_{}_cc{}_w{}".format(*c))
def test_emulation_matches_plain_f64_and_jax(case):
    G, C, m, n, k, depth, act, cc, wave = case
    xT, ws, bs, targets = _inputs(G, C, m, n, k, depth, seed=m + n + C)
    got = _flat(emulate(act, xT, ws, bs, targets, cc, wave))
    assert all(np.all(np.isfinite(v)) for v in got)
    for want in _references(act, xT, ws, bs, targets):
        assert [np.shape(v) for v in got] == [np.shape(v) for v in want]
        errs = [np.abs(a.astype(np.float64) - b).max() / max(1.0, np.abs(b).max())
                for a, b in zip(got, want)]
        assert max(errs) <= REL_TOL, errs
    assert np.all(got[2][:, :, m - 2:] == 0)  # the padded marker rows' dW0


SPLITS = [  # (G, C, n, CC, wave, R)
    (64, 4, 4096, 2, 264, 2),   # the flagship's forward-only pass: 2 CTAs of 2 chains per SM
    (64, 4, 4096, 2, 132, 1),   # its value and gradient: 1 per SM
    (3, 3, 1300, 2, 132, 22),   # C = 3, a ragged chunk and n
    (5, 1, 700, 1, 396, 22),    # one chain
    (300, 4, 257, 2, 132, 0),   # one wave over 600 instances
    (7, 5, 100, 2, 20, 0),      # fewer CTAs than instances, a ragged chunk
]


@pytest.mark.parametrize("G,C,n,cc,wave,R", SPLITS)
def test_the_split_counts_each_chain_and_individual_once(G, C, n, cc, wave, R):
    """Every (branch, chain, individual < n) is counted exactly once; each
    (CTA, instance, group) has a row and an err^2 of its own below (CTAs +
    NB) CC; the reduce's rows of a chain are exactly the CTAs that ran its
    instance; at the flagship a gradient call writes 3.24 MB of partial
    rows (104 MB in K7's first design)."""
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
    items = NB * tiles
    for j in range(NB):
        first = cta_of(j * tiles, ctas, items)
        nseg = cta_of((j + 1) * tiles - 1, ctas, items) - first + 1
        assert touched[j] == list(range(first, first + nseg))
    if (G, C, n, wave) == (64, 4, 4096, 132):
        P = 64 * 32 + 32 + 32 * 32 + 32 + 32
        assert 4 * len(rows) * P == 4 * 128 * 2 * P  # 3.24 MB
        assert 4 * G * C * -(-n // 128) * P > 100e6


def _value_pass_layouts():
    """Per-layer [G, C, ...] tensors as K7's callers hand them: the folded
    transition's value passes (``predict_chains``) [C, G] storage transposed
    to [G, C]; contiguous [G, C] tensors (the tests, chip_smoke); a weight
    whose trailing dims are not contiguous (copied)."""
    G, C, m, k = 3, 2, 5, 4
    gen = torch.Generator().manual_seed(4)
    r = lambda *s: torch.rand(s, generator=gen)  # noqa: E731
    return {
        "W0 of predict_chains": r(C, G, m, k).transpose(0, 1),
        "bias of predict_chains": r(C, G, k).transpose(0, 1),
        "w_out of predict_chains": r(C, G, k, 1).transpose(0, 1),
        "W0, contiguous": r(G, C, m, k),
        "targets": r(G, C, 7),
        "W0, trailing dims transposed": r(G, C, k, m).transpose(2, 3),
    }


@pytest.mark.parametrize("kind", list(_value_pass_layouts()))
def test_the_wrapper_passes_each_tensor_as_it_lies(kind):
    """What ``_vg_chains_cuda`` hands the C entry for one tensor
    (``chain_instances``): read as the kernel reads it (element (g, c, i) at
    the pointer plus g sg + c sc + i), every element is the tensor's; a
    tensor whose trailing dims are contiguous, the transposed views of
    ``predict_chains`` among them, is passed in place (no copy)."""
    t = _value_pass_layouts()[kind]
    G, C = t.shape[:2]
    (held,), (ptr,), (sg, sc, _, _) = TBM.pass_instances([(t, kind, t.shape, False)], t.device)
    assert (ptr == t.data_ptr()) == t[0, 0].is_contiguous()
    if "transposed" not in kind:
        assert ptr == t.data_ptr() and held is t
    size = t[0, 0].numel()
    read = held.as_strided((G, C, size), (sg, sc, 1))
    assert torch.equal(read, t.reshape(G, C, size))


@pytest.mark.parametrize("depth", [0, 1])
def test_chain_instances_give_every_layer_in_its_slot(depth):
    """``chain_instances`` on ``predict_chains``' views: the targets, then W0,
    b0, W1, b1, w_out (W1 and b1 null at depth 0), each read in place."""
    G, C, m, k, n = 3, 2, 6, 4, 9
    gen = torch.Generator().manual_seed(5)
    dims = [(m, k)] + ([(k, k)] if depth else []) + [(k, 1)]
    ws = tuple(torch.rand((C, G) + d, generator=gen).transpose(0, 1) for d in dims)
    bs = tuple(torch.rand((C, G, d[1]), generator=gen).transpose(0, 1) for d in dims[:-1])
    target = torch.rand((G, C, n), generator=gen)
    keep, ptrs, strides = TBM.chain_instances(target, ws, bs, torch.device("cpu"))
    slots = [target] + TBM.layer_slots(ws, bs, depth)
    assert len(ptrs) == 6 and len(strides) == 24
    for k_, t in enumerate(slots):
        if t is None:
            assert ptrs[k_] is None and strides[4 * k_: 4 * k_ + 4] == [0, 0, 0, 0]
            continue
        assert ptrs[k_] == t.data_ptr()  # in place
        sg, sc = strides[4 * k_: 4 * k_ + 2]
        size = t[0, 0].numel()
        assert torch.equal(t.as_strided((G, C, size), (sg, sc, 1)), t.reshape(G, C, size))
    assert TBM.chain_instances(None, ws, bs, torch.device("cpu"))[1][0] is None
