"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc; marked ``cuda`` and skipped elsewhere. The
repository's conftest imports jax, which the GPU machine need not have, so
run these with ``python -m pytest --noconftest tests/test_torch_cuda_kernels.py``.

Shapes are small but cover what the full-shape checks in chip_smoke.py do
not: every activation, depth 0 and 1, a ragged n, a batched G, lasso
(K5, K6), more than one marker tile and a k not a multiple of 16 (K3,
K9b), X read in place through an index (K8b), and the wrappers'
refusals. Tolerances: K2 and K9a atol 1e-4 (f32
sums over <= 300 markers in another order); K3 and K9b rtol 1e-4 of the
largest entry (sums over n); K4, K7 and K8 y_pred atol 1e-4 and
gradients rtol 1e-4 against the largest entry (sums over n in another
order); K5 and K6 rtol 1e-4 of the largest entry after 3 steps (the same
sums, compounded).
"""

import numpy as np
import pytest
import torch

from rs_bann_tpu_torch.models.density import PackedX
from rs_bann_tpu_torch.ops import branch_mlp as BM
from rs_bann_tpu_torch.ops import leapfrog as TL
from rs_bann_tpu_torch.ops import packed_matmul as PM

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bytes(rng, G, m, n, dev):
    vals = rng.integers(0, 3, size=(G, m, n)).astype(np.float32)
    return torch.from_numpy(np.stack([PM.pack_strided(v) for v in vals])).to(dev)


@pytest.mark.parametrize("act", PM.FUSED_ACTIVATIONS)
@pytest.mark.parametrize("k", [8, 16, 40])
def test_packed_linear_kernel_matches_plain(dev, act, k):
    rng = np.random.default_rng(0)
    G, m, n = 3, 104, 1300
    by = _bytes(rng, G, m, n, dev)
    a = torch.from_numpy(rng.standard_normal((G, m, k)).astype(np.float32)).to(dev) * 0.2
    off = torch.from_numpy(rng.standard_normal((G, k)).astype(np.float32)).to(dev)
    before = PM.packed_linear.launches
    out = PM.packed_linear(by, a, off, n, act)
    assert PM.packed_linear.launches == before + 1
    ref = PM.packed_linear_ref(by, a, off, n, act)
    torch.cuda.synchronize()
    assert out.shape == (G, n, k)
    assert (out - ref).abs().max().item() <= 1e-4
    single = PM.packed_linear(by[1], a[1], off[1], n, act)
    assert torch.equal(single, out[1])


@pytest.mark.parametrize("k", [16, 64, 5])
def test_packed_matmul_kernel_matches_plain(dev, k):
    """K9a (K2's kernel without its epilogue) against its plain version."""
    rng = np.random.default_rng(6)
    G, m, n = 3, 104, 1300
    by = _bytes(rng, G, m, n, dev)
    a = torch.from_numpy(rng.standard_normal((G, m, k)).astype(np.float32)).to(dev) * 0.2
    before = PM.packed_matmul.launches
    z = PM.packed_matmul(by, a, n)
    assert PM.packed_matmul.launches == before + 1
    ref = PM.packed_matmul_ref(by, a, n)
    torch.cuda.synchronize()
    assert z.shape == (G, n, k)
    assert (z - ref).abs().max().item() <= 1e-4
    assert torch.equal(PM.packed_matmul(by[1], a[1], n), z[1])


def _rel_close(got, ref, tol=1e-4):
    return (got - ref).abs().max().item() <= tol * max(ref.abs().max().item(), 1.0)


@pytest.mark.parametrize("act", PM.FUSED_ACTIVATIONS)
@pytest.mark.parametrize("m,n,k", [(104, 1300, 16), (300, 2100, 5), (24, 700, 40)])
def test_packed_linear_vjp_kernel_matches_plain(dev, act, m, n, k):
    """K3 against its plain version: ragged n, several marker and feature
    tiles, exactly-zero outputs (relu, leaky_relu: h' = 0 there)."""
    rng = np.random.default_rng(7)
    G = 3
    by = _bytes(rng, G, m, n, dev)
    g = torch.from_numpy(rng.standard_normal((G, n, k)).astype(np.float32)).to(dev)
    out = torch.from_numpy(rng.standard_normal((G, n, k)).astype(np.float32)).to(dev)
    out[:, ::7] = 0.0
    if act == "tanh":
        out = torch.tanh(out)
    before = PM.packed_linear_vjp.launches
    da, d_off = PM.packed_linear_vjp(by, g, out, n, act)
    assert PM.packed_linear_vjp.launches == before + 1
    da_ref, d_off_ref = PM.packed_linear_vjp_ref(by, g, out, n, act)
    torch.cuda.synchronize()
    assert da.shape == (G, m, k) and d_off.shape == (G, k)
    assert _rel_close(da, da_ref) and _rel_close(d_off, d_off_ref)
    # the same inputs give the same bits: fixed-order partial sums
    da2, d_off2 = PM.packed_linear_vjp(by, g, out, n, act)
    assert torch.equal(da, da2) and torch.equal(d_off, d_off2)
    da1, d_off1 = PM.packed_linear_vjp(by[2], g[2], out[2], n, act)
    assert _rel_close(da1, da_ref[2]) and _rel_close(d_off1, d_off_ref[2])


@pytest.mark.parametrize("m,n,k", [(104, 1300, 16), (300, 513, 5)])
def test_packed_matmul_vjp_kernel_matches_plain(dev, m, n, k):
    rng = np.random.default_rng(8)
    G = 2
    by = _bytes(rng, G, m, n, dev)
    g = torch.from_numpy(rng.standard_normal((G, n, k)).astype(np.float32)).to(dev)
    before = PM.packed_matmul_vjp.launches
    da = PM.packed_matmul_vjp(by, g, n)
    assert PM.packed_matmul_vjp.launches == before + 1
    ref = PM.packed_matmul_vjp_ref(by, g, n)
    torch.cuda.synchronize()
    assert da.shape == (G, m, k) and _rel_close(da, ref)
    assert torch.equal(da, PM.packed_matmul_vjp(by, g, n))


@pytest.mark.parametrize("act", ["identity", "tanh", "silu"])
def test_autograd_through_the_packed_layer0_on_the_card(dev, act):
    """The density's packed forward and autograd on the card (K2 + K3, or
    K9a + K9b under silu) against the same on the CPU's plain versions."""
    from rs_bann_tpu_torch.models import density as D

    rng = np.random.default_rng(9)
    G, m, n = 2, 104, 1300
    by = _bytes(rng, G, m, n, dev)
    scale, shift = torch.rand(G, m) + 0.5, torch.rand(G, m) * 2
    w = (torch.from_numpy(rng.standard_normal((G, m, 16)).astype(np.float32)) * 0.2,
         torch.from_numpy(rng.standard_normal((G, 16, 1)).astype(np.float32)))
    b = (torch.from_numpy(rng.standard_normal((G, 16)).astype(np.float32)) * 0.1,)
    y = torch.randn(G, n)
    grads = []
    for d in (dev, torch.device("cpu")):
        x = PackedX(by.to(d), scale.to(d), shift.to(d), n)
        ws = [t.to(d).requires_grad_() for t in w]
        bs = [t.to(d).requires_grad_() for t in b]
        rss = D.branch_rss(act, ws, bs, x, y.to(d))
        grads.append([t.cpu() for t in torch.autograd.grad(rss.sum(), ws + bs)])
    for got, ref in zip(*grads):
        assert _rel_close(got, ref)


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("act", BM.SUPPORTED_ACTIVATIONS)
def test_data_vg_packed_kernel_matches_plain(dev, depth, act):
    rng = np.random.default_rng(1)
    m, n = 104, 1300
    by = _bytes(rng, 1, m, n, dev)[0]
    widths = [m] + ([16] if depth else []) + [16, 1]
    ws = tuple(torch.from_numpy((rng.standard_normal((widths[i], widths[i + 1])) * 0.2)
                                .astype(np.float32)).to(dev) for i in range(len(widths) - 1))
    bs = tuple(torch.from_numpy((rng.standard_normal(widths[i + 1]) * 0.1).astype(np.float32)).to(dev)
               for i in range(len(widths) - 2))
    x = PackedX(by, torch.rand(m, device=dev) + 0.5, torch.rand(m, device=dev) * 2, n)
    target = torch.randn(n, device=dev)
    before = BM.data_vg_packed.launches
    y, rss, dws, dbs = BM.data_vg_packed(act, x, ws, bs, target)
    assert BM.data_vg_packed.launches == before + 1
    s = x.w_scale
    wf = (s[:, None] * ws[0],) + ws[1:]
    bf = (bs[0] - x.shift @ wf[0],) + bs[1:]
    y_ref, dws_ref, dbs_ref = BM.data_vg_packed_ref(act, by, target, wf, bf, n)
    torch.cuda.synchronize()
    assert (y - y_ref).abs().max().item() <= 1e-4
    dws_ref = (s[:, None] * dws_ref[0] - (x.shift * s)[:, None] * dbs_ref[0],) + dws_ref[1:]
    for got, ref in zip(dws + dbs, dws_ref + dbs_ref):
        assert got.shape == ref.shape
        assert (got - ref).abs().max().item() <= 1e-4 * max(ref.abs().max().item(), 1.0)
    # the same inputs give the same bits: no float atomics
    y2, _, dws2, _ = BM.data_vg_packed(act, x, ws, bs, target)
    assert torch.equal(y, y2) and all(torch.equal(a, b) for a, b in zip(dws, dws2))


def _traj_inputs(rng, dev, nb, C, m, n, depth):
    widths = [(m, 16), (16, 8), (8, 1)] if depth else [(m, 16), (16, 1)]

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def mk(sc):
        return tuple(t(rng.standard_normal((nb, C, i, o)) * sc) for i, o in widths)

    def mkb(sc):
        return tuple(t(rng.standard_normal((nb, C, o)) * sc) for _, o in widths[:-1])

    by = _bytes(rng, nb, m, n, dev)
    scale, shift = t(rng.random((nb, m)) + 0.5), t(rng.random((nb, m)) * 2)
    targets, err = t(rng.standard_normal((nb, C, n))), t(rng.random((nb, C)) * 0.5 + 0.5)
    weights, p_w, biases, p_b = mk(0.2), mk(1.0), mkb(0.1), mkb(1.0)
    eps_w = tuple(e.abs() * 1e-3 for e in mk(1.0))
    eps_b = tuple(e.abs() * 1e-3 for e in mkb(1.0))
    lam_w = tuple(e.abs() + 0.5 for e in mk(1.0))
    lam_b = tuple(torch.zeros_like(b) for b in biases)
    return (by, scale, shift, targets, err, weights, biases, p_w, p_b, eps_w, eps_b, lam_w, lam_b)


@pytest.mark.parametrize("depth,act,l1", [(0, "identity", False), (0, "relu", True), (1, "tanh", False)])
def test_integrate_chains_packed_kernel_matches_plain(dev, depth, act, l1):
    """K5 against its plain version: 3 steps, rtol 1e-4 of the largest entry
    (f32 sums over n in another order, compounded over the steps)."""
    rng = np.random.default_rng(3)
    nb, C, m, n, steps = 3, 2, 104, 1300, 3
    args = _traj_inputs(rng, dev, nb, C, m, n, depth)
    before = TL.integrate_chains_packed.launches
    out = TL.integrate_chains_packed(act, *args, steps, n, l1=l1)
    assert TL.integrate_chains_packed.launches == before + 1
    ref = TL.integrate_chains_packed_ref(act, *args, steps, n, l1=l1)
    torch.cuda.synchronize()
    for got_part, ref_part in zip(out, ref):
        for got, want in zip(got_part, ref_part):
            assert got.shape == want.shape
            assert (got - want).abs().max().item() <= 1e-4 * max(want.abs().max().item(), 1.0)
    # the same inputs give the same bits: fixed-order sums, no float atomics
    again = TL.integrate_chains_packed(act, *args, steps, n, l1=l1)
    assert all(torch.equal(a, b) for pa, pb in zip(out, again) for a, b in zip(pa, pb))


def _live_traj_inputs(rng, dev, live, k0):
    """Depth-0 K5 inputs at m = 104, C = 2, n = 1300 whose layer-0 columns
    from ``live`` on are dead (zero weight and momentum; their step sizes
    and prior precisions are not zero, as on the folded path), stored at
    width k0."""
    args = list(_traj_inputs(rng, dev, 3, 2, 104, 1300, 0))
    for ix in (5, 7):  # weights, momenta: W0 [.., m, k], w_out [.., k, 1]
        w0, wo = (t.clone() for t in args[ix])
        w0[..., live:], wo[..., live:, :] = 0, 0
        args[ix] = (w0, wo)
    for ix in (6, 8):  # their biases b0 [.., k]
        b0 = args[ix][0].clone()
        b0[..., live:] = 0
        args[ix] = (b0,)

    def stored(ts, bias=False):
        return (ts[0][..., :k0].contiguous(),) if bias else (
            ts[0][..., :k0].contiguous(), ts[1][..., :k0, :].contiguous())

    for ix in (5, 7, 9, 11):
        args[ix] = stored(args[ix])
    for ix in (6, 8, 10, 12):
        args[ix] = stored(args[ix], bias=True)
    return tuple(args)


@pytest.mark.parametrize("live,narrow", [(10, 10), (10, 12), (13, 13)])
def test_integrate_chains_packed_computes_only_the_live_columns(dev, live, narrow):
    """K5 at depth 0 on a block whose columns from ``live`` on are dead,
    stored at width 16: within 1e-4 of the plain version, the dead columns
    exactly as they went in, the live ones bit for bit what the same
    columns give stored at width ``narrow`` (KM is the smallest of 8, 12,
    16, 24, 32 holding ``live`` either way), and a bit-identical repeat."""
    from rs_bann_tpu_torch.ops import _build

    assert _build.lib().traj_packed_km(16, 16, live, 0) == (12 if live <= 12 else 16)
    rng = np.random.default_rng(7)
    wide = _live_traj_inputs(rng, dev, live, 16)
    w_narrow = _live_traj_inputs(np.random.default_rng(7), dev, live, narrow)
    steps, n = 3, 1300
    out = TL.integrate_chains_packed("tanh", *wide, steps, n)
    ref = TL.integrate_chains_packed_ref("tanh", *wide, steps, n)
    out_n = TL.integrate_chains_packed("tanh", *w_narrow, steps, n)
    again = TL.integrate_chains_packed("tanh", *wide, steps, n)
    torch.cuda.synchronize()
    starts = (wide[5], wide[6], wide[7], wide[8])
    for got_p, ref_p, nar_p, start_p, again_p in zip(out, ref, out_n, starts, again):
        for got, want, nar, start, rep in zip(got_p, ref_p, nar_p, start_p, again_p):
            assert (got - want).abs().max().item() <= 1e-4 * max(want.abs().max().item(), 1.0)
            assert torch.equal(got, rep)
            col = (slice(None),) * (got.dim() - (2 if got.shape[-1] == 1 and got.dim() == 4 else 1))
            assert torch.equal(got[col + (slice(live, None),)], start[col + (slice(live, None),)])
            assert torch.equal(got[col + (slice(0, live),)], nar[col + (slice(0, live),)])


def _dense_inputs(rng, dev, G, C, m, n, k, depth):
    widths = [(m, k), (k, k), (k, 1)] if depth else [(m, k), (k, 1)]

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def mk(sc):
        return tuple(t(rng.standard_normal((G, C, i, o)) * sc) for i, o in widths)

    def mkb(sc):
        return tuple(t(rng.standard_normal((G, C, o)) * sc) for _, o in widths[:-1])

    xT = t(rng.standard_normal((G, m, n)))
    return xT, t(rng.standard_normal((G, C, n))), mk(0.2), mkb(0.1), mk, mkb


# depth, activation, n (ragged and not a multiple of 4 included), width
DENSE_CASES = [(0, "identity", 333, 8), (0, "relu", 512, 16), (1, "tanh", 1300, 32),
               (1, "silu", 701, 16), (1, "leaky_relu", 257, 8)]


@pytest.mark.parametrize("depth,act,n,k", DENSE_CASES)
def test_data_vg_chains_kernel_matches_plain(dev, depth, act, n, k):
    rng = np.random.default_rng(4)
    xT, target, ws, bs, _, _ = _dense_inputs(rng, dev, 3, 2, 40, n, k, depth)
    before = BM.data_vg_chains.launches
    y, rss, dws, dbs = BM.data_vg_chains(act, xT, ws, bs, target)
    y_fwd = BM.forward_chains(act, xT, ws, bs)
    assert BM.data_vg_chains.launches == before + 2
    y_ref, rss_ref, dws_ref, dbs_ref = BM.data_vg_chains_ref(act, xT, ws, bs, target)
    torch.cuda.synchronize()
    assert (y - y_ref).abs().max().item() <= 1e-4
    assert (y_fwd - y_ref).abs().max().item() <= 1e-4
    assert (rss - rss_ref).abs().max().item() <= 1e-4 * rss_ref.abs().max().item()
    for got, ref in zip(dws + dbs, dws_ref + dbs_ref):
        assert got.shape == ref.shape
        assert (got - ref).abs().max().item() <= 1e-4 * max(ref.abs().max().item(), 1.0)
    # the same inputs give the same bits: no float atomics
    y2, _, dws2, dbs2 = BM.data_vg_chains(act, xT, ws, bs, target)
    assert torch.equal(y, y2) and all(torch.equal(a, b) for a, b in zip(dws + dbs, dws2 + dbs2))


@pytest.mark.parametrize("depth,act,l1", [(0, "identity", False), (1, "relu", True), (1, "tanh", False)])
def test_integrate_chains_kernel_matches_plain(dev, depth, act, l1):
    """K6 against its plain version: 3 steps, rtol 1e-4 of the largest entry."""
    rng = np.random.default_rng(5)
    G, C, n, steps = 3, 2, 1300, 3
    xT, targets, weights, biases, mk, mkb = _dense_inputs(rng, dev, G, C, 40, n, 16, depth)
    p_w, p_b = mk(1.0), mkb(1.0)
    eps_w = tuple(e.abs() * 1e-3 for e in mk(1.0))
    eps_b = tuple(e.abs() * 1e-3 for e in mkb(1.0))
    lam_w = tuple(e.abs() + 0.5 for e in mk(1.0))
    lam_b = tuple(torch.zeros_like(b) for b in biases)
    err = torch.rand(G, C, device=dev) * 0.5 + 0.5
    args = (xT, targets, err, weights, biases, p_w, p_b, eps_w, eps_b, lam_w, lam_b, steps)
    before = TL.integrate_chains.launches
    out = TL.integrate_chains(act, *args, l1=l1)
    assert TL.integrate_chains.launches == before + 1
    ref = TL.integrate_chains_ref(act, *args, l1=l1)
    torch.cuda.synchronize()
    for got_part, ref_part in zip(out, ref):
        for got, want in zip(got_part, ref_part):
            assert got.shape == want.shape
            assert (got - want).abs().max().item() <= 1e-4 * max(want.abs().max().item(), 1.0)
    again = TL.integrate_chains(act, *args, l1=l1)
    assert all(torch.equal(a, b) for pa, pb in zip(out, again) for a, b in zip(pa, pb))


def test_dense_limits_agree_with_the_kernels(dev):
    from rs_bann_tpu_torch.ops import _build

    lib = _build.lib()
    for shape in [(64, 32, 32, 1), (40, 16, 16, 0), (254, 32, 32, 1), (300, 32, 32, 1),
                  (64, 64, 32, 1), (64, 8, 8, 2)]:
        assert lib.dense_chains_smem(*shape) == BM.dense_chains_smem(*shape), shape


def test_packed_limits_agree_with_the_kernels(dev):
    from rs_bann_tpu_torch.ops import _build

    lib = _build.lib()
    for shape in [(64, 32, 32, 1), (40, 16, 16, 0), (254, 32, 32, 1), (300, 32, 32, 1),
                  (64, 64, 32, 1), (64, 8, 8, 2), (104, 16, 16, 0), (975, 16, 16, 0),
                  (976, 16, 16, 0), (936, 16, 16, 0), (937, 16, 16, 0), (23, 32, 32, 1),
                  (24, 32, 32, 1)]:
        assert lib.branch_vg_packed_smem(*shape) == BM.branch_vg_packed_smem(*shape), shape
        assert lib.traj_packed_smem(*shape) == BM.traj_packed_smem(*shape), shape


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    rng = np.random.default_rng(2)
    m, n = 104, 700
    by = _bytes(rng, 1, m, n, dev)[0]
    with pytest.raises(TypeError):
        PM.packed_linear(by, torch.zeros(m, 8, device=dev, dtype=torch.float64),
                         torch.zeros(8, device=dev, dtype=torch.float64), n, "identity")
    with pytest.raises(TypeError):
        PM.packed_matmul(by, torch.zeros(m, 8, device=dev, dtype=torch.float64), n)
    with pytest.raises(ValueError):  # cotangent rows != n
        PM.packed_matmul_vjp(by, torch.zeros(n + 1, 8, device=dev), n)
    with pytest.raises(ValueError):  # the bytes hold fewer than n individuals
        PM.packed_linear_vjp(by, torch.zeros(4 * by.shape[-1] + 1, 8, device=dev),
                             torch.zeros(4 * by.shape[-1] + 1, 8, device=dev),
                             4 * by.shape[-1] + 1, "tanh")
    x = PackedX(by, torch.ones(m, device=dev), torch.zeros(m, device=dev), n)
    deep = (torch.zeros(m, 8, device=dev), torch.zeros(8, 8, device=dev),
            torch.zeros(8, 8, device=dev), torch.zeros(8, 1, device=dev))
    with pytest.raises(NotImplementedError):  # depth 2
        BM.data_vg_packed("tanh", x, deep, tuple(torch.zeros(8, device=dev) for _ in range(3)),
                          torch.zeros(n, device=dev))
    wide = (torch.zeros(m, 64, device=dev), torch.zeros(64, 1, device=dev))
    with pytest.raises(NotImplementedError):  # width above 32
        BM.data_vg_packed("tanh", x, wide, (torch.zeros(64, device=dev),), torch.zeros(n, device=dev))
    wide_c = (torch.zeros(1, 2, m, 64, device=dev), torch.zeros(1, 2, 64, 1, device=dev))
    bias_c = (torch.zeros(1, 2, 64, device=dev),)
    with pytest.raises(NotImplementedError):  # K5 width above 32
        TL.integrate_chains_packed(
            "tanh", by[None], torch.ones(1, m, device=dev), torch.zeros(1, m, device=dev),
            torch.zeros(1, 2, n, device=dev), torch.ones(1, 2, device=dev), wide_c, bias_c,
            wide_c, bias_c, wide_c, bias_c, wide_c, bias_c, 2, n)
    xT = torch.zeros(1, m, n, device=dev)
    with pytest.raises(NotImplementedError):  # K7 width above 32
        BM.data_vg_chains("tanh", xT, wide_c, bias_c, torch.zeros(1, 2, n, device=dev))
    with pytest.raises(NotImplementedError):  # K6 width above 32
        TL.integrate_chains("tanh", xT, torch.zeros(1, 2, n, device=dev), torch.ones(1, 2, device=dev),
                            wide_c, bias_c, wide_c, bias_c, wide_c, bias_c, wide_c, bias_c, 2)


def _vg_dense_inputs(rng, dev, lead, m, n, k, depth):
    widths = [(m, k), (k, k), (k, 1)] if depth else [(m, k), (k, 1)]

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    ws = tuple(t(rng.standard_normal(lead + (i, o)) * 0.2) for i, o in widths)
    bs = tuple(t(rng.standard_normal(lead + (o,)) * 0.1) for _, o in widths[:-1])
    return ws, bs, t(rng.standard_normal(lead + (n,)))


def _vg_close(got, ref):
    y, rss, dws, dbs = got
    y_ref, rss_ref, dws_ref, dbs_ref = ref
    assert (y - y_ref).abs().max().item() <= 1e-4
    assert _rel_close(rss, rss_ref)
    for g, r in zip(dws + dbs, dws_ref + dbs_ref):
        assert g.shape == r.shape and _rel_close(g, r)


@pytest.mark.parametrize("depth,act,n,k", DENSE_CASES)
def test_data_vg_kernel_matches_plain(dev, depth, act, n, k):
    """K8a (one branch, one instance) against its plain version; identical
    bits on a repeat."""
    rng = np.random.default_rng(12)
    xT = torch.from_numpy(rng.standard_normal((40, n)).astype(np.float32)).to(dev)
    ws, bs, target = _vg_dense_inputs(rng, dev, (), 40, n, k, depth)
    before = BM.data_vg.launches
    got = BM.data_vg(act, xT, ws, bs, target)
    assert BM.data_vg.launches == before + 1
    torch.cuda.synchronize()
    assert got[2][-1].shape == (ws[-1].shape[0], 1)
    _vg_close(got, BM.data_vg_ref(act, xT, ws, bs, target))
    again = BM.data_vg(act, xT, ws, bs, target)
    assert all(torch.equal(a, b) for a, b in zip([got[0], *got[2], *got[3]],
                                                 [again[0], *again[2], *again[3]]))


@pytest.mark.parametrize("depth,act,n,k", DENSE_CASES)
def test_data_vg_blocked_kernel_matches_plain(dev, depth, act, n, k):
    """K8b: 5 instances on X of 3 branches through ix (repeats included),
    against its plain version; X read in place through ix gives the bits of
    the gathered X; the forward-only instantiation gives y_pred's bits;
    identical bits on a repeat."""
    rng = np.random.default_rng(13)
    X = torch.from_numpy(rng.standard_normal((3, 40, n)).astype(np.float32)).to(dev)
    ix = torch.tensor([2, 0, 2, 1, 0], dtype=torch.int32, device=dev)
    ws, bs, targets = _vg_dense_inputs(rng, dev, (5,), 40, n, k, depth)
    before = (BM.data_vg_blocked.launches, BM.forward_blocked.launches)
    got = BM.data_vg_blocked(act, X, ix, ws, bs, targets)
    y_fwd = BM.forward_blocked(act, X, ix, ws, bs)
    assert (BM.data_vg_blocked.launches, BM.forward_blocked.launches) == (before[0] + 1,
                                                                         before[1] + 1)
    torch.cuda.synchronize()
    _vg_close(got, BM.data_vg_blocked_ref(act, X, ix, ws, bs, targets))
    assert torch.equal(y_fwd, got[0])
    flat = lambda o: [o[0], *o[2], *o[3]]  # noqa: E731
    gathered = BM.data_vg_blocked(act, X[ix.long()].contiguous(), None, ws, bs, targets)
    assert all(torch.equal(a, b) for a, b in zip(flat(got), flat(gathered)))
    again = BM.data_vg_blocked(act, X, ix, ws, bs, targets)
    assert all(torch.equal(a, b) for a, b in zip(flat(got), flat(again)))


def test_dense_vg_wrappers_refuse_what_the_kernel_does_not_take(dev):
    """K8 beyond K6/K7's limits raises NotImplementedError on the card (the
    plain version never runs there)."""
    rng = np.random.default_rng(14)
    m, n = 40, 300
    X = torch.zeros(2, m, n, device=dev)
    ix = torch.zeros(2, dtype=torch.int32, device=dev)
    for depth, k in ((2, 8), (1, 64)):
        ws = tuple(torch.zeros((2, i, o), device=dev) for i, o in
                   [(m, k)] + [(k, k)] * depth + [(k, 1)])
        bs = tuple(torch.zeros((2, k), device=dev) for _ in range(depth + 1))
        targets = torch.zeros(2, n, device=dev)
        with pytest.raises(NotImplementedError):
            BM.data_vg_blocked("tanh", X, ix, ws, bs, targets)
        with pytest.raises(NotImplementedError):
            BM.forward_blocked("tanh", X, ix, ws, bs)
        with pytest.raises(NotImplementedError):
            BM.data_vg("tanh", X[0], tuple(w[0] for w in ws), tuple(b[0] for b in bs),
                       targets[0])
    ws, bs, targets = _vg_dense_inputs(rng, dev, (3,), m, n, 8, 0)
    with pytest.raises(ValueError):  # 3 instances on 2 branches need an index
        BM.data_vg_blocked("tanh", X, None, ws, bs, targets)
