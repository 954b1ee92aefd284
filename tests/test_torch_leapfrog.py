"""The port's whole-trajectory leapfrog (rs_bann_tpu_torch/ops/leapfrog.py,
plain versions of K5 and K6) against the JAX package's
``integrate_chains_packed`` and ``integrate_chains``.

The same numpy inputs go through both; JAX runs its Pallas kernels in
interpret mode (f32), the packed one once bytes-resident and once
grid-streamed (``RS_BANN_TRAJ_STREAM=1``). Tolerance atol 3e-5, rtol 2e-4,
the JAX package's own bound for its kernel against autodiff: each step's
gradient is a sum over n in another order, and L steps compound it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_bann_tpu.ops import branch_mlp as JBM
from rs_bann_tpu.ops import leapfrog as JL
from rs_bann_tpu.ops.packed_matmul import pack_strided
from rs_bann_tpu_torch.ops import leapfrog as TL

# the cases of tests/test_leapfrog_packed.py
CASES = [
    ("tanh", False, 1024, 1),
    # n not a multiple of the 512-individual pack group: the padding mask
    ("identity", False, 700, 0),
    ("identity", True, 1536, 0),
]


def _inputs(act, n, depth):
    rng = np.random.default_rng(1)
    G, C, m, m_pad, h, s = 2, 3, 12, 16, 8, 8
    widths = [(m_pad, h), (h, s), (s, 1)] if depth == 1 else [(m_pad, s), (s, 1)]

    def mk(sc):
        return tuple((rng.standard_normal((G, C, i, o)) * sc).astype(np.float32) for i, o in widths)

    def mkb(sc):
        return tuple((rng.standard_normal((G, C, o)) * sc).astype(np.float32) for _, o in widths[:-1])

    weights, p_w = mk(0.3), mk(0.5)
    eps_w = tuple(np.abs(e) * 0.01 for e in mk(1.0))
    lam_w = tuple(np.abs(e) + 0.5 for e in mk(1.0))
    biases, p_b = mkb(0.1), mkb(0.5)
    eps_b = tuple(np.abs(e) * 0.01 for e in mkb(1.0))
    lam_b = tuple(np.zeros_like(e) for e in mkb(1.0))
    geno = rng.integers(0, 3, size=(G, m, n)).astype(np.float32)
    bytes_g = np.stack([pack_strided(np.pad(geno[g], ((0, m_pad - m), (0, 0)))) for g in range(G)])
    shift = np.zeros((G, m_pad), np.float32)
    scale = np.zeros((G, m_pad), np.float32)
    shift[:, :m] = geno.mean(axis=2)
    sd = geno.std(axis=2)
    scale[:, :m] = np.where(sd > 0, 1.0 / np.maximum(sd, 1e-12), 0.0)
    targets = rng.standard_normal((G, C, n)).astype(np.float32)
    err = (np.abs(rng.standard_normal((G, C))) + 0.5).astype(np.float32)
    return (bytes_g, scale, shift, targets, err, weights, biases, p_w, p_b,
            eps_w, eps_b, lam_w, lam_b)


@pytest.mark.parametrize("stream", [False, True], ids=["resident", "streamed"])
@pytest.mark.parametrize("act,l1,n,depth", CASES)
def test_integrate_chains_packed_ref_matches_jax(act, l1, n, depth, stream, monkeypatch):
    if stream:
        monkeypatch.setenv("RS_BANN_TRAJ_STREAM", "1")
    L_steps = 4
    args = _inputs(act, n, depth)

    def J(a):
        return tuple(map(jnp.asarray, a)) if isinstance(a, tuple) else jnp.asarray(a)

    def T(a):
        return tuple(map(torch.from_numpy, a)) if isinstance(a, tuple) else torch.from_numpy(a)

    JBM.FORCE = "interpret"
    try:
        jout = JL.integrate_chains_packed(act, *map(J, args), L_steps, n, l1=l1, interpret=True)
    finally:
        JBM.FORCE = None
    tout = TL.integrate_chains_packed(act, *map(T, args), L_steps, n, l1=l1)
    for tpart, jpart in zip(tout, jout):
        assert len(tpart) == len(jpart)
        for t, j in zip(tpart, jpart):
            assert t.shape == j.shape
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=3e-5, rtol=2e-4)


def test_cpu_tensors_run_the_plain_version():
    args = tuple(
        tuple(map(torch.from_numpy, a)) if isinstance(a, tuple) else torch.from_numpy(a)
        for a in _inputs("identity", 700, 0)
    )
    before = TL.integrate_chains_packed.launches
    out = TL.integrate_chains_packed("identity", *args, 2, 700)
    ref = TL.integrate_chains_packed_ref("identity", *args, 2, 700)
    assert TL.integrate_chains_packed.launches == before  # no kernel on the CPU
    for a, b in zip(out, ref):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        TL.integrate_chains_packed("softplus", *args, 2, 700)


def _live_block(live, k0=16, seed=4):
    """Positions, momenta, step sizes and prior precisions of a depth-0
    block (2 branches, 3 chains, m 24) whose layer-0 columns from ``live``
    on have zero weight and momentum, as padded columns have; their step
    sizes and precisions are not zero, as on the folded path."""
    rng = np.random.default_rng(seed)
    m = 24

    def block(scale, dead=True):
        ws = (rng.standard_normal((2, 3, m, k0)), rng.standard_normal((2, 3, k0, 1)))
        bs = (rng.standard_normal((2, 3, k0)),)
        ws = tuple(torch.from_numpy((np.abs(w) * scale).astype(np.float32)) for w in ws)
        bs = tuple(torch.from_numpy((np.abs(b) * scale).astype(np.float32)) for b in bs)
        if dead:
            for t in ws[:1] + bs:
                t[..., live:] = 0
            ws[1][..., live:, :] = 0
        return ws, bs

    return block(0.3), block(1.0), block(0.01, dead=False), block(2.0, dead=False)


@pytest.mark.parametrize("live,poke,want", [
    (10, None, 10),
    (10, ("momentum", 12), 13),  # a nonzero momentum of the output layer
    (10, ("eps", 14), 15),  # a step size that is not finite
    (10, ("lam", 11), 12),  # a prior precision that is not finite
    (16, None, 16),
])
def test_live_width(live, poke, want):
    """K5's wrapper computes only a depth-0 block's live columns: 1 + the
    last column with a nonzero weight or momentum, or a step size or prior
    precision that is not finite."""
    from rs_bann_tpu_torch.ops.branch_mlp import flat_params

    (w, b), (pw, pb), (ew, eb), (lw, lb) = _live_block(live)
    if poke is not None:
        what, col = poke
        {"momentum": pw, "eps": ew, "lam": lw}[what][1][1, 2, col, 0] = (
            0.5 if what == "momentum" else float("inf"))
    flat = [flat_params(ws, bs) for ws, bs in ((w, b), (pw, pb), (ew, eb), (lw, lb))]
    assert TL.live_width(16, *flat) == want


def test_dead_columns_are_left_as_they_are():
    """A column with zero weight and momentum (its step size and prior
    precision not zero) comes out of the plain trajectory exactly as it went
    in, and the live columns do not depend on it: what lets K5 skip it."""
    (w, b), (pw, pb), (ew, eb), (lw, lb) = _live_block(10)
    rng = np.random.default_rng(5)
    m, n = 24, 700
    vals = rng.integers(0, 3, size=(2, m, n)).astype(np.float32)
    by = torch.from_numpy(np.stack([pack_strided(v) for v in vals]))
    scale = torch.from_numpy((rng.random((2, m)) + 0.5).astype(np.float32))
    shift = torch.from_numpy(rng.random((2, m)).astype(np.float32))
    targets = torch.from_numpy(rng.standard_normal((2, 3, n)).astype(np.float32))
    err = torch.full((2, 3), 0.7)

    def run(cols):
        def cut(ts):
            return (ts[0][..., :cols], ts[1][..., :cols, :])

        def cutb(ts):
            return (ts[0][..., :cols],)

        return TL.integrate_chains_packed_ref(
            "tanh", by, scale, shift, targets, err, cut(w), cutb(b), cut(pw), cutb(pb),
            cut(ew), cutb(eb), cut(lw), cutb(lb), 3, n)

    wide, narrow = run(16), run(10)
    for got16, got10, start in zip(wide, narrow, (w, b, pw, pb)):
        for t16, t10, t0 in zip(got16, got10, start):
            lead = (slice(None),) * (t16.dim() - (2 if t16.shape[-1] == 1 else 1))
            assert torch.equal(t16[lead + (slice(10, None),)], t0[lead + (slice(10, None),)])
            # the CPU's matmuls round another way at another width: f32 sums
            # over 700 individuals, 3 steps
            np.testing.assert_allclose(t16[lead + (slice(0, 10),)].numpy(), t10.numpy(),
                                       rtol=1e-5, atol=1e-6)


def _dense_inputs(n):
    """The inputs of tests/test_leapfrog.py: G 2, C 3, m 16, h 8, s 8."""
    rng = np.random.default_rng(0)
    G, C, m, h, s = 2, 3, 16, 8, 8
    widths = [(m, h), (h, s), (s, 1)]

    def mk(sc):
        return tuple((rng.standard_normal((G, C, i, o)) * sc).astype(np.float32) for i, o in widths)

    def mkb(sc):
        return tuple((rng.standard_normal((G, C, o)) * sc).astype(np.float32) for _, o in widths[:-1])

    weights, p_w = mk(0.3), mk(0.5)
    eps_w = tuple(np.abs(e) * 0.01 for e in mk(1.0))
    lam_w = tuple(np.abs(e) + 0.5 for e in mk(1.0))
    biases, p_b = mkb(0.1), mkb(0.5)
    eps_b = tuple(np.abs(e) * 0.01 for e in mkb(1.0))
    lam_b = tuple(np.zeros_like(e) for e in mkb(1.0))
    xT = rng.standard_normal((G, m, n)).astype(np.float32)
    targets = rng.standard_normal((G, C, n)).astype(np.float32)
    err = (np.abs(rng.standard_normal((G, C))) + 0.5).astype(np.float32)
    return xT, targets, err, weights, biases, p_w, p_b, eps_w, eps_b, lam_w, lam_b


# the cases of tests/test_leapfrog.py: n 128-aligned, and n neither 128- nor
# tile-aligned with the lasso prior
@pytest.mark.parametrize("act,l1,n", [("tanh", False, 384), ("identity", True, 333)])
def test_integrate_chains_ref_matches_jax(act, l1, n):
    L_steps = 5
    args = _dense_inputs(n)
    JBM.FORCE = "interpret"
    try:
        jout = JL.integrate_chains(
            act, *(tuple(map(jnp.asarray, a)) if isinstance(a, tuple) else jnp.asarray(a)
                   for a in args), L_steps, l1=l1, interpret=True)
    finally:
        JBM.FORCE = None
    tout = TL.integrate_chains(
        act, *(tuple(map(torch.from_numpy, a)) if isinstance(a, tuple) else torch.from_numpy(a)
               for a in args), L_steps, l1=l1)
    for tpart, jpart in zip(tout, jout):
        assert len(tpart) == len(jpart)
        for t, j in zip(tpart, jpart):
            assert t.shape == j.shape
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=3e-5, rtol=2e-4)
