"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc; marked ``cuda`` and skipped elsewhere. The
repository's conftest imports jax, which the GPU machine need not have, so
run these with ``python -m pytest --noconftest tests/test_torch_cuda_kernels.py``.

Shapes are small but cover what the full-shape checks in chip_smoke.py do
not: every activation, depth 0 and 1, a ragged n, a batched G, lasso
(K5, K6), more than one marker tile and a k not a multiple of 16 (K3,
K9b), X read in place through an index (K8b), K5's chunks of chains (C
not a multiple of the chunk, one chain a chunk at a large m_pad), K4 at
k0 = 8, 16 and 32, a width stored wider than it is and the largest m it
admits (its launches counted by torch.profiler), K8 at the dense
flagship's branch (one instance, and 64 through an index) and the largest m
it admits (its launches counted too), K6 with one chain, five (a ragged
chunk), more instances than resident CTAs, depth 0 at width 8, the
flagship's block at L = 1 and the largest m it admits (one call one device
op), K5 and K6 with the per-coordinate step sizes of dual averaging and
mass adaptation in the fold's transposed views (and a whole folded packed
block with them: its padded columns stay exactly 0), K6, K7 and K8 on
their deep design (depth 2 and 3, widths 40-64; K6 at L = 1 and 30), and
the wrappers' refusals.
Tolerances: K2 and K9a atol 1e-4 (f32
sums over <= 300 markers in another order), and 1e-4 of the largest entry
with weights spanning 1e-6 to 1e3; K3 and K9b rtol 1e-4 of the
largest entry (sums over n), and no further from the plain version run in
f64 than the f32 plain version, plus 1e-4; K4, K7 and K8 y_pred atol 1e-4 and
gradients (K4: and rss) rtol 1e-4 against the largest entry (sums over n
in another order), each entry of the gradients at relu and leaky_relu less
its kink allowance (``kink_allowance``), K4 and K8 against the plain
version in f64 too; K5 and K6 rtol 1e-4 of the largest entry after 3 steps (the same
sums, compounded; K6 against the plain version in f64 too), K5's chunks 1e-4 after 1 step and 1e-3 after 30 (as
chip_smoke's REL_TOL and REL_TOL_TRAJ).
"""

import math

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
@pytest.mark.parametrize("k", [5, 8, 16, 40, 64])
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


@pytest.mark.parametrize("k", [16, 64, 5, 8, 40])
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


def _rel_close(got, ref, tol=1e-4, allow=None):
    """|got - ref| within ``tol`` of max(1, the largest |ref|), each entry
    after taking off its ``allow`` (``kink_allowance``)."""
    diff = (got - ref).abs()
    if allow is not None:
        diff = (diff - allow.to(diff.dtype)).clamp(min=0)
    return diff.max().item() <= tol * max(ref.abs().max().item(), 1.0)


KINK_ROUNDINGS = 32  # "near the kink": |z| < 32 x 2^-24 x the magnitude of z's terms
KINK_TERMS = 8  # the most near-kink terms one check may meet at any size, and
KINK_SHARE = 4e-4  # the most, as a share of its pre-activations, past that: twice
# the share the deep K4 shapes meet (up to 2e-4 at depth 2, width 56, where
# the error bound compounds through the layers)


def kink_allowance(act, xT, weights, biases, target, fold=None):
    """For relu and leaky_relu, per gradient entry (in the order weights,
    then biases), what the pre-activations within a few f32 roundings of the
    kink can move it: the plain version's pre-activations in f64 take the
    terms (layer, unit, individual) with |z| < KINK_ROUNDINGS x 2^-24 x the
    sum of |z|'s terms (a z whose terms are all zero is exact on both sides) (a bound on the f32 sums' own error carried through
    the layers), and each such term adds the f64 magnitude of its
    individual's gradient term x (1 - slope): the difference of the f64
    gradients with h' of that term at 1 and at the slope. Either side of the
    kink is then counted. Asserts at most max(KINK_TERMS, KINK_SHARE x the
    pre-activations) such terms, so the allowance cannot hide a fault (a
    few individuals' terms of the n each entry sums); None (no allowance)
    for the smooth
    activations. xT [..., m, n] and the weights [..., in, out] (leading axes
    as the plain versions broadcast them); ``fold`` = (w_scale, shift)
    folds the standardization into layer 0 as K4 does."""
    if act not in ("relu", "leaky_relu"):
        return None
    slope = 0.0 if act == "relu" else 0.01
    d = torch.float64
    x, t = xT.to(d), target.to(d)
    leaves = [v.detach().to(d) for v in tuple(weights) + tuple(biases)]
    L = len(weights)

    def layers(params):
        ws, bs = list(params[:L]), list(params[L:])
        if fold is not None:
            sc, sh = (v.to(d) for v in fold)
            ws[0] = sc[:, None] * ws[0]
            bs[0] = bs[0] - sh @ ws[0]
        return ws, bs

    with torch.no_grad():  # the f64 pre-activations and the bound of their f32 error
        ws, bs = layers(leaves)
        a, err, near = x, torch.zeros_like(x), []
        for l in range(L - 1):
            wt = ws[l].transpose(-1, -2)
            z = wt @ a + bs[l][..., None]
            err = wt.abs() @ (a.abs() + err) + bs[l].abs()[..., None]
            near.append(z.abs() < KINK_ROUNDINGS * 2.0 ** -24 * err)  # exact zeros: no side
            a = BM._act_apply(act, z)
    terms = [(l, tuple(i)) for l, nm in enumerate(near) for i in nm.nonzero().tolist()]
    cap = max(KINK_TERMS, math.ceil(KINK_SHARE * sum(nm.numel() for nm in near)))
    assert len(terms) <= cap, f"{len(terms)} pre-activations at the kink (at most {cap})"

    def grads(l_force, at, hp_force):
        params = [v.clone().requires_grad_(True) for v in leaves]
        with torch.enable_grad():
            ws, bs = layers(params)
            a = x
            for l in range(L - 1):
                z = ws[l].transpose(-1, -2) @ a + bs[l][..., None]
                hp = (z > 0).to(d) + slope * (z < 0).to(d)
                if l == l_force:
                    hp = hp.index_put(tuple(torch.tensor([i], device=hp.device) for i in at),
                                      torch.tensor([hp_force], dtype=d, device=hp.device))
                a = BM._act_apply(act, z).detach() + (z - z.detach()) * hp
            pred = torch.sum(ws[-1] * a, dim=-2)
            return torch.autograd.grad(0.5 * torch.sum((pred - t) ** 2), params)

    allow = [torch.zeros_like(v) for v in leaves]
    for l, at in terms:
        for k, (g1, g0) in enumerate(zip(grads(l, at, 1.0), grads(l, at, slope))):
            allow[k] = allow[k] + (g1 - g0).abs()
    return allow


# (m, n): one marker chunk and a half (24), the main path's m_pad (104), two
# marker slabs at k >= 40 (300); n past the last full group of 512 and
# below 4 * B
K2_SHAPES = [(24, 700), (104, 1300), (300, 2100)]


@pytest.mark.parametrize("act", PM.FUSED_ACTIVATIONS + ("none",))
@pytest.mark.parametrize("k", [5, 8, 16, 40, 64, 100])
@pytest.mark.parametrize("m,n", K2_SHAPES)
def test_packed_linear_kernel_wide_weights(dev, act, k, m, n):
    """K2 (every fused activation) and K9a ("none") against their plain
    versions within REL_TOL of the largest entry of the pre-activation (each
    fused activation is 1-Lipschitz, so that is the sums' rounding scale;
    for identity and K9a the largest entry of the output), with ``a``
    spanning 1e-6 to 1e3 in magnitude (the lo part of the bf16 split
    matters), k over one to eight column tiles and two passes (100), m over
    one and two slabs; a repeat gives the same bits."""
    rng = np.random.default_rng(11)
    G = 2
    by = _bytes(rng, G, m, n, dev)
    mag = 10.0 ** rng.uniform(-6, 3, (G, m, k))
    a = torch.from_numpy((mag * rng.choice([-1.0, 1.0], (G, m, k))).astype(np.float32)).to(dev)
    off = torch.from_numpy(rng.standard_normal((G, k)).astype(np.float32)).to(dev)
    if act == "none":
        got, ref = PM.packed_matmul(by, a, n), PM.packed_matmul_ref(by, a, n)
        again = PM.packed_matmul(by, a, n)
    else:
        got, ref = PM.packed_linear(by, a, off, n, act), PM.packed_linear_ref(by, a, off, n, act)
        again = PM.packed_linear(by, a, off, n, act)
    torch.cuda.synchronize()
    assert got.shape == (G, n, k)
    scale = max(1.0, (PM.packed_matmul_ref(by, a, n) + (off[:, None] if act != "none" else 0))
                .abs().max().item())
    assert (got - ref).abs().max().item() <= 1e-4 * scale
    assert torch.equal(got, again)


def test_packed_linear_plan_covers_slabs_and_passes(dev):
    """The shapes above reach the kernel's marker slabs and column passes."""
    assert PM.packed_linear_plan(2, 104, 384, 40, 1300)["slabs"] == 1
    assert PM.packed_linear_plan(2, 300, 640, 64, 2100)["slabs"] == 2
    assert PM.packed_linear_plan(2, 104, 384, 100, 1300)["passes"] == 2
    assert PM.packed_linear_plan(2, 300, 640, 16, 2100, fused=False)["slabs"] == 1


def _vjp_f64(by, g, out, n, act):
    """K3's plain version in f64 (K9b's with ``act`` None)."""
    from rs_bann_tpu_torch.ops.activations import prime_from_out

    x = PM.unpack_strided(by, n).double()
    if act is None:
        return (x @ g.double(),)
    dz = g.double() * prime_from_out(act, out).double()
    return x @ dz, dz.sum(dim=-2)


def _no_further_from_f64(got, ref, ref64, tol=1e-4, allow=None):
    """The kernel lies no further from f64 than the f32 plain version, plus
    tol of the largest entry; each of the kernel's entries after taking off
    its ``allow`` (``kink_allowance``, one per output)."""
    def err(a, b, al=None):
        diff = (a.double() - b).abs()
        if al is not None:
            diff = (diff - al.to(diff.dtype)).clamp(min=0)
        return diff.max().item() / max(b.abs().max().item(), 1.0)
    allow = allow or [None] * len(got)
    return all(err(a, c, al) <= err(b, c) + tol for a, b, c, al in zip(got, ref, ref64, allow))


@pytest.mark.parametrize("act", PM.FUSED_ACTIVATIONS)
@pytest.mark.parametrize("m,n,k", [(104, 1300, 16), (300, 2100, 5), (24, 700, 40)])
def test_packed_linear_vjp_kernel_matches_plain(dev, act, m, n, k):
    """K3 against its plain version (and f64): ragged n, several marker and
    feature tiles, exactly-zero outputs (relu, leaky_relu: h' = 0 there)."""
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
    assert _no_further_from_f64((da, d_off), (da_ref, d_off_ref), _vjp_f64(by, g, out, n, act))
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
    assert _no_further_from_f64((da,), (ref,), _vjp_f64(by, g, None, n, None))
    assert torch.equal(da, PM.packed_matmul_vjp(by, g, n))


@pytest.mark.parametrize("k", [1, 4])
def test_packed_matmul_vjp_kernel_with_a_broadcast_cotangent(dev, k):
    """K9b as the marker scan's u0 takes it: a block of G = 10 branches,
    the chains' residuals [n, k] broadcast over the branches (``expand``),
    k = 1 (one chain, or the sequential schedule) and 4 (the main path's
    C): against the plain version on the same broadcast cotangent and on
    its contiguous copy, no further from f64 than the f32 plain version,
    and a bit-identical repeat; then ``marker_u0``, K9b and the
    standardization w_scale * (raw - shift * sum e), against the plain
    standardized product ((decode - shift) * w_scale) @ e in f32, within
    1e-4 of its largest entry, and in f64 as K9b is."""
    from rs_bann_tpu_torch.models import density as D

    rng = np.random.default_rng(20 + k)
    G, m, n = 10, 104, 1300
    by = _bytes(rng, G, m, n, dev)
    e = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(dev)
    g = e.expand(G, n, k)
    before = PM.packed_matmul_vjp.launches
    da = PM.packed_matmul_vjp(by, g, n)
    assert PM.packed_matmul_vjp.launches == before + 1
    ref = PM.packed_matmul_vjp_ref(by, g.contiguous(), n)
    torch.cuda.synchronize()
    assert da.shape == (G, m, k) and _rel_close(da, ref)
    assert _no_further_from_f64((da,), (ref,), _vjp_f64(by, g, None, n, None))
    assert torch.equal(da, PM.packed_matmul_vjp(by, g.contiguous(), n))

    raw = PM.unpack_strided(by, n)
    shift = raw.mean(-1)
    w_scale = 1.0 / raw.std(-1).clamp(min=1e-3)
    w_scale[:, -1] = 0.0  # a padded marker
    x = D.PackedX(by, w_scale, shift, n)
    u0 = D.marker_u0(x, e)
    assert torch.equal(u0, D.marker_u0(x, e))

    def plain(dtype):
        xs = (raw.to(dtype) - shift[..., None].to(dtype)) * w_scale[..., None].to(dtype)
        return xs @ e.to(dtype)

    u0_ref, u0_64 = plain(torch.float32), plain(torch.float64)
    assert u0.shape == (G, m, k) and _rel_close(u0, u0_ref)
    assert _no_further_from_f64((u0,), (u0_ref,), (u0_64,))
    assert torch.all(u0[:, -1] == 0)


@pytest.mark.parametrize("act", ["identity", "tanh", None], ids=lambda a: a or "K9b")
def test_packed_bwd_kernels_at_the_warm_start_block(dev, act):
    """K3 (identity, tanh) and K9b at the GD warm start's block: G = 10, m =
    104, n = 100,000, k = 16, against the f32 plain version and f64, with a
    bit-identical repeat and exactly one counted call."""
    gen = torch.Generator(dev).manual_seed(12)
    G, m, n, k = 10, 104, 100_000, 16
    by = torch.randint(0, 256, (G, m, -(-n // 512) * 128), dtype=torch.uint8, device=dev,
                       generator=gen)
    g = torch.randn((G, n, k), device=dev, generator=gen)
    out = torch.randn((G, n, k), device=dev, generator=gen)
    if act == "tanh":
        out = torch.tanh(out)
    counter = PM.packed_linear_vjp if act else PM.packed_matmul_vjp
    before = counter.launches
    if act:
        got = PM.packed_linear_vjp(by, g, out, n, act)
        ref = PM.packed_linear_vjp_ref(by, g, out, n, act)
        again = PM.packed_linear_vjp(by, g, out, n, act)
    else:
        got = (PM.packed_matmul_vjp(by, g, n),)
        ref = (PM.packed_matmul_vjp_ref(by, g, n),)
        again = (PM.packed_matmul_vjp(by, g, n),)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    assert all(_rel_close(a, b) for a, b in zip(got, ref))
    assert _no_further_from_f64(got, ref, _vjp_f64(by, g, out, n, act))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


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


@pytest.mark.parametrize("act", ["identity", "tanh", "silu"])
def test_joint_potential_gradient_on_the_card(dev, act):
    """The joint HMC potential's value and gradient in every coordinate
    (weights, biases, the three precisions) for C = 2 chains x B = 3
    branches of a packed block at the live width, as the hybrid sweep's
    joint transition evaluates it: one K2 and one K3 launch (K9a and K9b
    under silu) for all six instances, against the same on the CPU's plain
    versions within 1e-4 of the largest entry, and no further from the same
    function in f64 (on the standardized genotypes, feature-major) than the
    plain version, plus 1e-4."""
    from rs_bann_tpu_torch.models import NetArch
    from rs_bann_tpu_torch.models import density as D
    from rs_bann_tpu_torch.models import params as P
    from rs_bann_tpu_torch.models.init import InitCfg, init_net

    C, B, m, n, live = 2, 3, 104, 1300, 10
    arch = NetArch.from_width_rules([100] * B, 0, ("fixed", live), ("fixed", live), activation=act)
    state, _ = init_net(arch, "ridge_ard", InitCfg(seed=2, init_gamma_shape=3.0,
                                                    init_gamma_scale=1.0), device="cpu")
    rng = np.random.default_rng(11)
    by = _bytes(rng, B, m, n, torch.device("cpu"))
    scale = torch.rand(B, m) + 0.5
    scale[:, 100:] = 0.0  # the padded markers
    shift = torch.rand(B, m) * 2

    def chains(t):
        return torch.stack([t * (1.0 + 0.05 * c) for c in range(C)])

    leaves = ([chains(w) for w in state.params.weights] + [chains(b) for b in state.params.biases]
              + [chains(p) for p in state.precisions.weights]
              + [chains(p) for p in state.precisions.biases] + [torch.tensor([[1.3], [0.9]])])
    nw = arch.num_layers
    st = D.branch_statics(arch, "cpu")
    y = torch.randn(C, B, n)
    reg, hyper = torch.full((C, B), 0.7), D.Hyperparameters()
    fwd, bwd = ((PM.packed_linear, PM.packed_linear_vjp) if act != "silu"
                else (PM.packed_matmul, PM.packed_matmul_vjp))

    def value_and_grad(d, x, dtype, k_live):
        ts = [t.to(d, dtype).expand(C, B).requires_grad_() if t.dim() == 2 and t.shape[-1] == 1
              else t.to(d, dtype).requires_grad_() for t in leaves]
        stat = type(st)(*(tuple(a.to(d, dtype) for a in f) if isinstance(f, tuple)
                          else f.to(d, dtype) for f in st))
        ld, _ = D.joint_potential_fn("ridge_ard", act, k_live)(
            ts[:nw], ts[nw:2 * nw - 1], ts[2 * nw - 1:3 * nw - 1], ts[3 * nw - 1:-1], ts[-1],
            x, y.to(d, dtype), hyper, stat, reg.to(d, dtype), 2.0 * B * live)
        return [ld] + list(torch.autograd.grad(ld.sum(), ts))

    x_card = PackedX(by.to(dev), scale.to(dev), shift.to(dev), n)
    before = fwd.launches, bwd.launches
    card = [t.cpu() for t in value_and_grad(dev, x_card, torch.float32, live)]
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    ref = value_and_grad("cpu", PackedX(by, scale, shift, n), torch.float32, live)
    xs = (PM.unpack_strided(by, n).double() - shift[..., None].double()) * scale[..., None].double()
    ref64 = value_and_grad("cpu", D.FeatX(xs), torch.float64, None)
    # the live columns: the feature-major f64 run takes the padded ones too
    # (their weights are 0, so their gradients are too)
    assert all(torch.isfinite(t).all() for t in card)
    for got, want in zip(card, ref):
        assert _rel_close(got, want.detach())
    assert _no_further_from_f64([t.detach() for t in card], [t.detach() for t in ref],
                                [t.detach() for t in ref64])


# (depth, m, n, k0, live width): K4 at the card test's shape; m not a
# multiple of 16 and n not of 512; k0 = 8, 16 and 32; width 10 stored at 16;
# and at depth 0 the largest m the admission rule takes at each register
# width (a single byte buffer)
K4_SHAPES = [(0, 104, 1300, 16, 16), (0, 40, 1100, 16, 10), (0, 24, 700, 8, 8),
             (0, 300, 2100, 32, 32), (1, 104, 1300, 16, 16)]
K4_LARGEST = [(0, 1266, 900, 8, 8), (0, 975, 900, 16, 10), (0, 607, 900, 32, 32)]


def _k4_inputs(rng, depth, m, n, k0, live, dev):
    by = _bytes(rng, 1, m, n, dev)[0]
    widths = [m] + ([16] if depth else []) + [k0, 1]
    ws = [(rng.standard_normal((widths[i], widths[i + 1])) * 0.2).astype(np.float32)
          for i in range(len(widths) - 1)]
    bs = [(rng.standard_normal(widths[i + 1]) * 0.1).astype(np.float32)
          for i in range(len(widths) - 2)]
    if not depth:  # a width stored wider than it is
        ws[0][:, live:] = ws[1][live:] = bs[0][live:] = 0
    ws = tuple(torch.from_numpy(w).to(dev) for w in ws)
    bs = tuple(torch.from_numpy(b).to(dev) for b in bs)
    x = PackedX(by, torch.rand(m, device=dev) + 0.5, torch.rand(m, device=dev) * 2, n)
    return x, ws, bs, torch.randn(n, device=dev)


def _device_ops(fn):
    """fn()'s result and the names of the device ops it ran (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def _one_op(call, names):
    """call()'s result and its device ops, which must be exactly ``names``
    in order (any other device op fails at once; a trace that lost an event,
    as CUPTI now and then does after many profiling sessions in one process,
    is taken again)."""
    for _ in range(5):
        out, ops = _device_ops(call)
        assert all(any(nm in o for nm in names) for o in ops), ops
        if len(ops) == len(names):
            break
    assert len(ops) == len(names) and all(nm in o for nm, o in zip(names, ops)), ops
    return out


def _k4_check(act, x, ws, bs, target):
    """K4 against its plain version, and against the plain version in f64;
    one call is one count and exactly its two kernels and no other device
    op (in the deep design after the one concatenation of the weights);
    repeats give the same bits."""
    before = BM.data_vg_packed.launches
    y, rss, dws, dbs = BM.data_vg_packed(act, x, ws, bs, target)
    assert BM.data_vg_packed.launches == before + 1
    first = (y, rss) + dws + dbs

    def repeat():
        again = BM.data_vg_packed(act, x, ws, bs, target)
        return again[:2] + again[2] + again[3]

    if len(ws) == 2 and ws[0].shape[1] <= 32:
        again = _one_op(repeat, ["vg_packed0_kernel", "reduce0_kernel"])
    else:  # the deep design: the weights' flat layout, then its two kernels
        again = _one_op(repeat, ["CatArrayBatchedCopy", "vg_deep_kernel", "reduce_deep_kernel"])
    # the same inputs give the same bits: no float atomics
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    # the plain version with the wrapper's fold, every step in f64 and in f32
    # as the wrapper's; at relu's and leaky_relu's kink each near term
    # counted on either side. The gradients are sums over n that cancel, so
    # against the f32 plain version they are held to the nearer reference:
    # no further from f64 than it is, plus the tolerance
    allow = kink_allowance(act, PM.unpack_strided(x.bytes, x.n), ws, bs, target,
                           fold=(x.w_scale, x.shift))
    allow = allow or [None] * (len(ws) + len(bs))
    refs = {}
    for dtype in (torch.float64, torch.float32):
        s, sh, t = (v.to(dtype) for v in (x.w_scale, x.shift, target))
        wf = (s[:, None] * ws[0].to(dtype),) + tuple(w.to(dtype) for w in ws[1:])
        bf = (bs[0].to(dtype) - sh @ wf[0],) + tuple(b.to(dtype) for b in bs[1:])
        y_ref, dws_ref, dbs_ref = BM.data_vg_packed_ref(act, x.bytes, t, wf, bf, x.n)
        assert (y - y_ref).abs().max().item() <= 1e-4
        rss_ref = torch.sum((y_ref - t) ** 2)
        assert abs(rss.item() - rss_ref.item()) <= 1e-4 * max(rss_ref.item(), 1.0)
        dws_ref = (s[:, None] * dws_ref[0] - (sh * s)[:, None] * dbs_ref[0],) + dws_ref[1:]
        refs[dtype] = dws_ref + dbs_ref
        for got, ref in zip(dws + dbs, refs[dtype]):
            assert got.shape == ref.shape
    for got, ref, al in zip(dws + dbs, refs[torch.float64], allow):
        assert _rel_close(got.double(), ref, allow=al)
    assert _no_further_from_f64(dws + dbs, refs[torch.float32], refs[torch.float64], allow=allow)
    return dws


@pytest.mark.parametrize("shape", K4_SHAPES, ids=lambda s: "d{}_m{}_n{}_k{}_live{}".format(*s))
@pytest.mark.parametrize("act", BM.SUPPORTED_ACTIVATIONS)
def test_data_vg_packed_kernel_matches_plain(dev, act, shape):
    rng = np.random.default_rng(1)
    depth, m, n, k0, live = shape
    _k4_check(act, *_k4_inputs(rng, depth, m, n, k0, live, dev))


# draws of the first case above (torch's generator seeded so first, as
# scripts/repeat_k4_torch.py draws them) whose db0 lay beyond the tolerance
# from the f32 plain version (1.020x and 2.222x) while the f32 plain
# version lay 0.974x and 2.137x from f64 and K4 0.046x and 0.090x
K4_DRAWS = [182, 757]


@pytest.mark.parametrize("seed", K4_DRAWS, ids=lambda s: f"seed{s}")
def test_data_vg_packed_kernel_at_a_drawn_case(dev, seed):
    torch.manual_seed(seed)
    _k4_check("identity", *_k4_inputs(np.random.default_rng(1), *K4_SHAPES[0], dev))


@pytest.mark.parametrize("shape", K4_LARGEST, ids=lambda s: "m{}_k{}".format(s[1], s[3]))
def test_data_vg_packed_runs_every_admitted_m(dev, shape):
    """Every m that branch_vg_packed_smem admits at depth 0 still runs."""
    depth, m, n, k0, live = shape
    assert BM.branch_vg_packed_smem(m, k0, k0, 0) > 0
    assert BM.branch_vg_packed_smem(m + 1, k0, k0, 0) < 0
    assert BM.branch_vg_packed0_plan(m, 256, n, k0)["buffers"] == 1
    x, ws, bs, target = _k4_inputs(np.random.default_rng(2), depth, m, n, k0, live, dev)
    dws = _k4_check("tanh", x, ws, bs, target)
    assert torch.all(dws[0][:, live:] == 0)


# (depth, m, n, hidden width h, summary width s): K4's deep design
# (csrc/packed_deep.cuh) at depth 1 to 3, widths 6 to 64 (every width
# class), depth 0 at widths 40 and 56, n ragged and not a multiple of 64;
# every activation at every shape (relu and leaky_relu meet 15 to 43
# pre-activations within kink_allowance's bound of the kink at the three
# widest, under its cap there)
K4_DEEP_SHAPES = [(1, 104, 1300, 16, 16), (2, 104, 1300, 56, 56), (3, 40, 1100, 6, 8),
                  (2, 24, 700, 40, 24), (0, 104, 1300, 56, 56), (0, 300, 2100, 40, 40),
                  (1, 104, 2100, 64, 64), (2, 224, 900, 56, 56)]
K4_DEEP_CASES = [(act, shape) for shape in K4_DEEP_SHAPES for act in BM.SUPPORTED_ACTIVATIONS]


def _k4_deep_inputs(rng, depth, m, n, h, s, dev):
    """One branch of depth hidden layers of width h and a summary layer of
    width s, every input drawn from ``rng``."""
    by = _bytes(rng, 1, m, n, dev)[0]
    outs = [h] * depth + [s, 1]
    dims = list(zip([m] + outs[:-1], outs))

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    ws = tuple(t(rng.standard_normal(d) * 0.5 / np.sqrt(d[0])) for d in dims)
    bs = tuple(t(rng.standard_normal(d[1]) * 0.1) for d in dims[:-1])
    x = PackedX(by, t(rng.random(m) + 0.5), t(rng.random(m) * 2), n)
    return x, ws, bs, t(rng.standard_normal(n))


@pytest.mark.parametrize("act,shape", K4_DEEP_CASES,
                         ids=lambda a: a if isinstance(a, str) else "d{}_m{}_n{}_h{}_s{}".format(*a))
def test_data_vg_packed_deep_kernel_matches_plain(dev, act, shape):
    """K4's deep design against its plain version in f32 and f64 (the
    rules of _k4_check), one count a call, exactly its kernels, identical
    repeats; its plan takes the shape's width class and one partial row of
    the flat layout and err^2 per CTA."""
    depth, m, n, h, s = shape
    x, ws, bs, target = _k4_deep_inputs(np.random.default_rng(7), depth, m, n, h, s, dev)
    plan = BM.branch_vg_packed_deep_plan(m, x.bytes.shape[1], n, h, s, depth)
    assert plan["km"] == next(k for k in (8, 16, 32, 64) if max(h, s) <= k)
    assert plan["row"] >= BM._flat_size(m, h, s, depth) + 1
    _k4_check(act, x, ws, bs, target)


# (nb, C, m, n, depth, h, s, activation, l1): K5's deep design at depth 1
# to 3 and depth 0 at widths 40 and 56, C = 1 to 4 (chunks of several
# chains where they fit), more (branch, chunk, tile) items than blocks
K5_DEEP_CASES = [(3, 2, 104, 1300, 1, 16, 16, "tanh", False),
                 (2, 2, 104, 1300, 2, 40, 40, "tanh", False),
                 (2, 4, 104, 1300, 2, 56, 56, "identity", True),
                 (3, 3, 40, 700, 3, 8, 6, "silu", False),
                 (2, 4, 104, 1300, 0, 56, 56, "identity", False),
                 (1, 1, 24, 513, 2, 16, 8, "relu", True)]


@pytest.mark.parametrize("steps,tol", [(1, 1e-4), (30, 1e-3)])
@pytest.mark.parametrize("nb,C,m,n,depth,h,s,act,l1", K5_DEEP_CASES)
def test_integrate_chains_packed_deep_kernel_matches_plain(dev, nb, C, m, n, depth, h, s, act, l1,
                                                          steps, tol):
    """K5's deep design against its plain version: rtol 1e-4 of the largest
    entry at L = 1, 1e-3 at L = 30 (f32 sums in another order, compounded),
    one count a call, identical repeats."""
    rng = np.random.default_rng(11)
    outs = [h] * depth + [s, 1]
    dims = list(zip([m] + outs[:-1], outs))

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def mk(sc):
        return tuple(t(rng.standard_normal((nb, C, i, o)) * sc / np.sqrt(i)) for i, o in dims)

    def mkb(sc):
        return tuple(t(rng.standard_normal((nb, C, o)) * sc) for _, o in dims[:-1])

    by = _bytes(rng, nb, m, n, dev)
    scale, shift = t(rng.random((nb, m)) + 0.5), t(rng.random((nb, m)) * 2)
    targets, err = t(rng.standard_normal((nb, C, n))), t(rng.random((nb, C)) * 0.5 + 0.5)
    ws, p_w, bs, p_b = mk(1.0), mk(4.0), mkb(0.1), mkb(1.0)
    eps_w = tuple(e.abs() * 2e-4 for e in mk(1.0))
    eps_b = tuple(e.abs() * 2e-4 for e in mkb(1.0))
    lam_w = tuple(e.abs() + 0.5 for e in mk(1.0))
    lam_b = tuple(torch.zeros_like(b) for b in bs)
    args = (by, scale, shift, targets, err, ws, bs, p_w, p_b, eps_w, eps_b, lam_w, lam_b)
    plan = TL.traj_packed_plan(m, h, s, h, depth, nb, C, by.shape[-1], n)
    assert plan["slots"] >= 1 and C % plan["cc"] == 0
    before = TL.integrate_chains_packed.launches
    out = TL.integrate_chains_packed(act, *args, steps, n, l1=l1)
    assert TL.integrate_chains_packed.launches == before + 1
    ref = TL.integrate_chains_packed_ref(act, *args, steps, n, l1=l1)
    torch.cuda.synchronize()
    for got_part, ref_part in zip(out, ref):
        for got, want in zip(got_part, ref_part):
            assert got.shape == want.shape
            assert (got - want).abs().max().item() <= tol * max(want.abs().max().item(), 1.0)
    again = TL.integrate_chains_packed(act, *args, steps, n, l1=l1)
    assert all(torch.equal(a, b) for pa, pb in zip(out, again) for a, b in zip(pa, pb))
    moved = max((a - b).abs().max().item() for a, b in zip(out[0], ws))
    assert moved > 0


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


def _live_traj_inputs(rng, dev, live, k0, C=2, m=104, nb=3):
    """Depth-0 K5 inputs at n = 1300 (m = 104, C = 2 and nb = 3 unless
    given) whose layer-0 columns from ``live`` on are dead (zero weight and
    momentum; their step sizes and prior precisions are not zero, as on the
    folded path), stored at width k0."""
    args = list(_traj_inputs(rng, dev, nb, C, m, 1300, 0))
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


# (C, m_pad, live width, activation, l1) of a depth-0 block stored at width
# 16: C = 1, 3 and 5 leave a chunk of CC = 2 chains (KM = 12) partly or
# wholly past C; m_pad = 936 with all 16 columns live fits shared memory only
# at one chain a chunk
CHUNK_CASES = [(1, 104, 10, "identity", False), (3, 104, 10, "tanh", False),
               (5, 104, 10, "identity", True), (4, 936, 16, "tanh", False)]


@pytest.mark.parametrize("steps,tol", [(1, 1e-4), (30, 1e-3)])
@pytest.mark.parametrize("C,m,live,act,l1", CHUNK_CASES)
def test_integrate_chains_packed_chunks_match_plain(dev, C, m, live, act, l1, steps, tol):
    """K5's depth-0 chunks of CC chains against ``integrate_chains_packed_ref``:
    within REL_TOL (L = 1) and REL_TOL_TRAJ (L = 30) of the largest entry
    (f32 sums in another order, the standardization folded into the weights,
    compounded over the steps), the dead columns exactly as they went in, and
    a bit-identical repeat. The launch takes the CC the case is built for."""
    want_cc = 1 if C == 1 or m > 104 else 2
    args = _live_traj_inputs(np.random.default_rng(11), dev, live, 16, C=C, m=m, nb=2)
    n = 1300
    plan = TL.traj_packed_plan(m, 16, 16, live, 0, 2, C, args[0].shape[-1], n)
    assert plan["cc"] == want_cc and plan["ctas_per_sm"] >= 1
    before = TL.integrate_chains_packed.launches
    out = TL.integrate_chains_packed(act, *args, steps, n, l1=l1)
    assert TL.integrate_chains_packed.launches == before + 1
    ref = TL.integrate_chains_packed_ref(act, *args, steps, n, l1=l1)
    again = TL.integrate_chains_packed(act, *args, steps, n, l1=l1)
    torch.cuda.synchronize()
    starts = (args[5], args[6], args[7], args[8])
    for got_p, ref_p, start_p, again_p in zip(out, ref, starts, again):
        for got, want, start, rep in zip(got_p, ref_p, start_p, again_p):
            assert got.shape == want.shape
            assert (got - want).abs().max().item() <= tol * max(want.abs().max().item(), 1.0)
            assert torch.equal(got, rep)
            col = (slice(None),) * (got.dim() - (2 if got.shape[-1] == 1 and got.dim() == 4 else 1))
            assert torch.equal(got[col + (slice(live, None),)], start[col + (slice(live, None),)])


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


def _k7_check(act, xT, ws, bs, target):
    """K7 against its plain version in f32 and in f64 (y_pred atol 1e-4, rss
    and gradients 1e-4 of max(1, the largest entry), each gradient entry at
    relu and leaky_relu less its kink allowance); the forward-only call's
    y_pred the same bits; one value-and-gradient call is one count and
    exactly the pass and its reduce, a forward-only call one count and
    exactly its pass (the deep design: each after the concatenation of the
    weights); repeats give the same bits."""
    before = BM.data_vg_chains.launches
    y, rss, dws, dbs = BM.data_vg_chains(act, xT, ws, bs, target)
    y_fwd = BM.forward_chains(act, xT, ws, bs)
    assert BM.data_vg_chains.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(y, y_fwd)
    allow = kink_allowance(act, xT[:, None], ws, bs, target) or [None] * len(ws + bs)
    for dtype in (torch.float32, torch.float64):
        y_ref, rss_ref, dws_ref, dbs_ref = BM.data_vg_chains_ref(
            act, xT.to(dtype), _f64(ws, dtype), _f64(bs, dtype), target.to(dtype))
        assert (y.to(dtype) - y_ref).abs().max().item() <= 1e-4
        assert _rel_close(rss.to(dtype), rss_ref)
        for got, ref, al in zip(dws + dbs, dws_ref + dbs_ref, allow):
            assert got.shape == ref.shape
            assert _rel_close(got.to(dtype), ref, allow=al)
    # the same inputs give the same bits: no float atomics. The deep design
    # concatenates the weights into their flat layout first
    pre, kern = ((["CatArrayBatchedCopy"], "run_kernel")
                 if BM.dense_deep(ws[0].shape[-1], ws[-1].shape[-2], len(ws) - 2)
                 else ([], "vg_chains_kernel"))
    y2, rss2, dws2, dbs2 = _one_op(lambda: BM.data_vg_chains(act, xT, ws, bs, target),
                                   pre + [kern, "vg_chains_reduce"])
    assert torch.equal(y, y2) and torch.equal(rss, rss2)
    assert all(torch.equal(a, b) for a, b in zip(dws + dbs, dws2 + dbs2))
    assert torch.equal(y_fwd, _one_op(lambda: BM.forward_chains(act, xT, ws, bs), pre + [kern]))


@pytest.mark.parametrize("depth,act,n,k", DENSE_CASES)
def test_data_vg_chains_kernel_matches_plain(dev, depth, act, n, k):
    rng = np.random.default_rng(4)
    xT, target, ws, bs, _, _ = _dense_inputs(rng, dev, 3, 2, 40, n, k, depth)
    _k7_check(act, xT, ws, bs, target)


# G, C, m, n, width, depth, activation: one chain; three (a ragged chunk of
# two); the flagship's width with five chains; more instances than one
# wave holds
K7_CASES = [(3, 1, 40, 700, 16, 1, "tanh"), (3, 3, 24, 333, 8, 0, "silu"),
            (4, 5, 64, 1100, 32, 1, "tanh"), (300, 4, 24, 257, 32, 1, "tanh")]


@pytest.mark.parametrize("G,C,m,n,k,depth,act", K7_CASES)
def test_data_vg_chains_kernel_shapes(dev, G, C, m, n, k, depth, act):
    rng = np.random.default_rng(22)
    plan = BM.vg_chains_plan(G, C, m, n, k, k, depth, act=act)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert plan["ctas"] <= plan["ctas_per_sm"] * sms  # one wave
    if G == 300:
        assert plan["ctas"] < G * plan["chunks"]  # the wave's CTAs take several instances
    xT, target, ws, bs, _, _ = _dense_inputs(rng, dev, G, C, m, n, k, depth)
    _k7_check(act, xT, ws, bs, target)


def test_data_vg_chains_reads_the_value_pass_inputs_in_place(dev):
    """``predict_chains``' own inputs on a FeatX: [C, G] weights as [G, C]
    views (models/density.py), y_pred the bits of the same weights made
    contiguous, one forward-only launch and no copy."""
    from rs_bann_tpu_torch.models import density as D

    rng = np.random.default_rng(23)
    G, C, m, n, k = 3, 4, 40, 333, 16
    xT, _, ws, bs, _, _ = _dense_inputs(rng, dev, G, C, m, n, k, 1)
    ws_cg = tuple(w.transpose(0, 1).contiguous() for w in ws)  # [C, G, ...] storage
    bs_cg = tuple(b.transpose(0, 1).contiguous() for b in bs)
    got = _one_op(lambda: D.predict_chains("tanh", ws_cg, bs_cg, D.FeatX(xT)),
                  ["vg_chains_kernel"])
    assert torch.equal(got, BM.forward_chains("tanh", xT, ws, bs).transpose(0, 1))


@pytest.mark.parametrize("m,k,depth", [(263, 32, 1), (345, 16, 1), (390, 8, 0)],
                         ids=lambda v: str(v))
def test_data_vg_chains_runs_every_admitted_m(dev, m, k, depth):
    """The largest m_pad that the parent's rule admitted at each register
    width (one chain per CTA, one X buffer) still runs on K7."""
    from test_torch_dense_smem import old_dense_chains_smem

    assert old_dense_chains_smem(m, k, k, depth) > 0 > old_dense_chains_smem(m + 1, k, k, depth)
    assert BM.vg_chains_plan(2, 2, m, 301, k, k, depth)["cc"] in (1, 2)
    rng = np.random.default_rng(24)
    xT, target, ws, bs, _, _ = _dense_inputs(rng, dev, 2, 2, m, 301, k, depth)
    _k7_check("tanh", xT, ws, bs, target)


def _traj_dense_inputs(rng, dev, G, C, m, n, k, depth, steps):
    xT, targets, weights, biases, mk, mkb = _dense_inputs(rng, dev, G, C, m, n, k, depth)
    p_w, p_b = mk(1.0), mkb(1.0)
    eps_w = tuple(e.abs() * 1e-3 for e in mk(1.0))
    eps_b = tuple(e.abs() * 1e-3 for e in mkb(1.0))
    lam_w = tuple(e.abs() + 0.5 for e in mk(1.0))
    lam_b = tuple(torch.zeros_like(b) for b in biases)
    err = torch.rand(G, C, device=dev) * 0.5 + 0.5
    return (xT, targets, err, weights, biases, p_w, p_b, eps_w, eps_b, lam_w, lam_b, steps)


def _k6_check(act, args, l1, tol=1e-4):
    """K6 against its plain version in f32 and in f64, rtol ``tol`` of the
    largest entry; one call is one count and exactly one device op, the
    kernel (the wrapper reads the per-layer inputs in place; the deep
    design after the four concatenations into the flat layout); a repeat
    gives the same bits. Returns the result."""
    before = TL.integrate_chains.launches
    out = TL.integrate_chains(act, *args, l1=l1)
    assert TL.integrate_chains.launches == before + 1
    torch.cuda.synchronize()
    for dtype in (torch.float32, torch.float64):
        cast = [tuple(t.to(dtype) for t in a) if isinstance(a, tuple)
                else a.to(dtype) if isinstance(a, torch.Tensor) else a for a in args]
        ref = TL.integrate_chains_ref(act, *cast, l1=l1)
        for got_part, ref_part in zip(out, ref):
            for got, want in zip(got_part, ref_part):
                assert got.shape == want.shape
                assert (got.to(dtype) - want).abs().max().item() <= tol * max(
                    want.abs().max().item(), 1.0)
    ws = args[3]
    ops = (["CatArrayBatchedCopy"] * 4 + ["traj_dense_deep_kernel"]
           if BM.dense_deep(ws[0].shape[-1], ws[-1].shape[-2], len(ws) - 2)
           else ["traj_dense_kernel"])
    again = _one_op(lambda: TL.integrate_chains(act, *args, l1=l1), ops)
    assert all(torch.equal(a, b) for pa, pb in zip(out, again) for a, b in zip(pa, pb))
    return out


@pytest.mark.parametrize("depth,act,l1", [(0, "identity", False), (1, "relu", True), (1, "tanh", False)])
def test_integrate_chains_kernel_matches_plain(dev, depth, act, l1):
    """K6 against its plain version in f32 and f64: 3 steps, rtol 1e-4 of
    the largest entry; exactly its launch; identical bits on a repeat."""
    rng = np.random.default_rng(5)
    G, C, n, steps = 3, 2, 1300, 3
    _k6_check(act, _traj_dense_inputs(rng, dev, G, C, 40, n, 16, depth, steps), l1)


# G, C, m, n, width, depth, activation, lasso: one chain; five (chunks of
# 2, 2 and 1); more instances than resident CTAs (one wave whose CTAs take
# several); depth 0 at width 8
K6_CASES = [(3, 1, 40, 1300, 16, 1, "tanh", False), (3, 5, 40, 701, 16, 1, "silu", False),
            (300, 4, 24, 257, 32, 1, "tanh", False), (3, 2, 40, 333, 8, 0, "leaky_relu", True)]


@pytest.mark.parametrize("G,C,m,n,k,depth,act,l1", K6_CASES)
def test_integrate_chains_kernel_shapes(dev, G, C, m, n, k, depth, act, l1):
    rng = np.random.default_rng(17)
    plan = TL.traj_dense_plan(G, C, m, n, k, k, depth, act)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert plan["ctas"] <= plan["ctas_per_sm"] * sms
    if G == 300:
        assert plan["ctas"] < G * plan["chunks"]  # one wave over the instances
    _k6_check(act, _traj_dense_inputs(rng, dev, G, C, m, n, k, depth, 3), l1)


@pytest.mark.parametrize("model_type,l1", [("ridge_ard", False), ("lasso_base", True)])
def test_integrate_chains_reads_the_folds_inputs_in_place(dev, model_type, l1):
    """The folded transition's own inputs (samplers/hmc.py ``fold``):
    izmailov step sizes and prior factors expanded from [C, G, in, 1] and
    [C, G, 1, 1] precisions (stride 0 in their trailing dims), err expanded
    over branches, every tensor a [G, C] view of [C, G] storage. One call is
    the K6 launch alone, no copy, and agrees with the plain version."""
    from rs_bann_tpu_torch.samplers import hmc as TH
    from rs_bann_tpu_torch.samplers.mcmc_cfg import MCMCCfg

    rng = np.random.default_rng(21)
    G, C, m, n, k, steps = 3, 2, 40, 333, 16, 3
    xT, targets, weights, biases, _, _ = _dense_inputs(rng, dev, G, C, m, n, k, 1)

    def cg(ts):  # [G, C, ...] -> [C, G, ...] storage
        return tuple(t.transpose(0, 1).contiguous() for t in ts)

    def bc(ts):  # the fold's [C, G, ...] -> [G, C, ...] views
        return tuple(t.transpose(0, 1) for t in ts)

    ws, bs = cg(weights), cg(biases)
    pos = lambda *shape: torch.rand(shape, device=dev) + 0.5  # noqa: E731
    w_prec = (pos(C, G, m, 1), pos(C, G, k, 1), pos(C, G, 1, 1))
    b_prec = (pos(C, G, 1), pos(C, G, 1))
    cfg = MCMCCfg(hmc_step_size_factor=0.1, hmc_integration_length=steps)
    eps_w, eps_b = TH.step_sizes(None, model_type, cfg, ws, bs, w_prec, b_prec, None)
    lam_w = tuple(lam.expand_as(w) for lam, w in zip(w_prec, ws))
    lam_b = tuple(torch.zeros_like(b) for b in bs)
    assert eps_w[0].stride(-1) == 0 and eps_b[0].stride(-1) == 0 and lam_w[0].stride(-1) == 0
    p_w, p_b = cg(tuple(torch.randn_like(w) for w in weights)), cg(
        tuple(torch.randn_like(b) for b in biases))
    err = (torch.rand(C, device=dev) + 0.5)[None, :].expand(G, -1)
    args = (xT, targets.transpose(0, 1).contiguous().transpose(0, 1), err, *map(
        bc, (ws, bs, p_w, p_b, eps_w, eps_b, lam_w, lam_b)), steps)
    _k6_check("tanh", args, l1)


def test_integrate_chains_at_the_flagship_shape(dev):
    """The dense flagship's block (G = 64, C = 4, m = 64, k0 = s = 32, depth
    1, n = 4,096, tanh) at L = 1: two chains per CTA on each X tile, one CTA
    per (branch, chunk)."""
    rng = np.random.default_rng(18)
    plan = TL.traj_dense_plan(64, 4, 64, 4096, 32, 32, 1, "tanh")
    assert plan["cc"] == 2 and plan["chunks"] == 2 and plan["tiles"] == 128
    assert plan["ctas"] == 128  # R = 1 CTA per instance at one CTA per SM
    _k6_check("tanh", _traj_dense_inputs(rng, dev, 64, 4, 64, 4096, 32, 1, 1), False)


@pytest.mark.parametrize("m,k,depth", [(263, 32, 1), (345, 16, 1), (390, 8, 0)],
                         ids=lambda v: str(v))
def test_integrate_chains_runs_every_admitted_m(dev, m, k, depth):
    """The largest m_pad that the parent's rule (dense_chains_smem) admitted
    at each register width: K6 fits it (one chain per CTA where two do not
    fit)."""
    from test_torch_dense_smem import old_dense_chains_smem

    assert old_dense_chains_smem(m, k, k, depth) > 0 > old_dense_chains_smem(m + 1, k, k, depth)
    assert BM.traj_dense_smem(m, k, k, depth) > 0
    assert TL.traj_dense_plan(2, 2, m, 301, k, k, depth, "tanh")["cc"] in (1, 2)
    rng = np.random.default_rng(19)
    _k6_check("tanh", _traj_dense_inputs(rng, dev, 2, 2, m, 301, k, depth, 2), False)


# the dense deep design's shapes: depth 2 to 4, widths 40 to 64, the first
# refused (tests/test_torch_branch_mlp.py DENSE_LIMITS by hand)
DENSE_LIMIT_SHAPES = [(104, 56, 56, 2), (104, 56, 56, 0), (104, 16, 16, 3), (104, 64, 64, 3),
                      (104, 64, 64, 4), (104, 40, 40, 2), (24, 40, 24, 1), (16, 64, 64, 4),
                      (16, 64, 64, 5), (104, 72, 72, 0), (320, 56, 56, 2), (336, 56, 56, 2),
                      (104, 48, 40, 3), (1000, 8, 8, 2)]


def test_dense_limits_agree_with_the_kernels(dev):
    from rs_bann_tpu_torch.ops import _build

    lib = _build.lib()
    for shape in [(64, 32, 32, 1), (40, 16, 16, 0), (254, 32, 32, 1), (300, 32, 32, 1),
                  (64, 64, 32, 1), (64, 8, 8, 2), (263, 32, 32, 1), (345, 16, 16, 1),
                  (390, 8, 8, 0), (330, 32, 32, 1), (331, 32, 32, 1)] + DENSE_LIMIT_SHAPES:
        for rule in ("traj_dense_smem", "vg_chains_smem", "vg_dense_smem"):
            assert getattr(lib, rule)(*shape, 0) == getattr(BM, rule)(*shape), (rule, shape)


def test_packed_limits_agree_with_the_kernels(dev):
    from rs_bann_tpu_torch.ops import _build

    lib = _build.lib()
    for shape in [(64, 32, 32, 1), (40, 16, 16, 0), (254, 32, 32, 1), (300, 32, 32, 1),
                  (64, 64, 32, 1), (64, 8, 8, 2), (104, 16, 16, 0), (975, 16, 16, 0),
                  (976, 16, 16, 0), (936, 16, 16, 0), (937, 16, 16, 0), (23, 32, 32, 1),
                  (24, 32, 32, 1), (104, 56, 56, 0), (104, 56, 56, 2), (224, 56, 56, 2),
                  (225, 56, 56, 2), (104, 72, 72, 0), (16, 64, 64, 4), (16, 64, 64, 5),
                  (104, 40, 56, 3), (1000, 8, 8, 1)]:
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
    # K2 and K9a copy the byte tiles in 16-byte units: bytes off that boundary
    shifted = torch.empty(by.numel() + 1, dtype=torch.uint8, device=dev)[1:].view(by.shape)
    shifted.copy_(by)
    with pytest.raises(ValueError):
        PM.packed_linear(shifted, torch.zeros(m, 8, device=dev), torch.zeros(8, device=dev), n,
                         "identity")
    with pytest.raises(ValueError):
        PM.packed_matmul(shifted, torch.zeros(m, 8, device=dev), n)
    with pytest.raises(ValueError):  # cotangent rows != n
        PM.packed_matmul_vjp(by, torch.zeros(n + 1, 8, device=dev), n)
    with pytest.raises(ValueError):  # the bytes hold fewer than n individuals
        PM.packed_linear_vjp(by, torch.zeros(4 * by.shape[-1] + 1, 8, device=dev),
                             torch.zeros(4 * by.shape[-1] + 1, 8, device=dev),
                             4 * by.shape[-1] + 1, "tanh")
    x = PackedX(by, torch.ones(m, device=dev), torch.zeros(m, device=dev), n)
    deep = ((torch.zeros(m, 64, device=dev),) + tuple(torch.zeros(64, 64, device=dev)
                                                      for _ in range(5))
            + (torch.zeros(64, 1, device=dev),))
    with pytest.raises(NotImplementedError):  # depth 5 at width 64: past shared memory
        BM.data_vg_packed("tanh", x, deep, tuple(torch.zeros(64, device=dev) for _ in range(6)),
                          torch.zeros(n, device=dev))
    wide = (torch.zeros(m, 72, device=dev), torch.zeros(72, 1, device=dev))
    with pytest.raises(NotImplementedError):  # width above 64
        BM.data_vg_packed("tanh", x, wide, (torch.zeros(72, device=dev),), torch.zeros(n, device=dev))
    wide_p = (torch.zeros(1, 2, m, 72, device=dev), torch.zeros(1, 2, 72, 1, device=dev))
    bias_p = (torch.zeros(1, 2, 72, device=dev),)
    with pytest.raises(NotImplementedError):  # K5 width above 64
        TL.integrate_chains_packed(
            "tanh", by[None], torch.ones(1, m, device=dev), torch.zeros(1, m, device=dev),
            torch.zeros(1, 2, n, device=dev), torch.ones(1, 2, device=dev), wide_p, bias_p,
            wide_p, bias_p, wide_p, bias_p, wide_p, bias_p, 2, n)
    wide_c = (torch.zeros(1, 2, m, 72, device=dev), torch.zeros(1, 2, 72, 1, device=dev))
    bias_c = (torch.zeros(1, 2, 72, device=dev),)
    xT = torch.zeros(1, m, n, device=dev)
    with pytest.raises(NotImplementedError):  # K7 width above 64
        BM.data_vg_chains("tanh", xT, wide_c, bias_c, torch.zeros(1, 2, n, device=dev))
    with pytest.raises(NotImplementedError):  # K6 width above 64
        TL.integrate_chains("tanh", xT, torch.zeros(1, 2, n, device=dev), torch.ones(1, 2, device=dev),
                            wide_c, bias_c, wide_c, bias_c, wide_c, bias_c, wide_c, bias_c, 2)


def _vg_dense_inputs(rng, dev, lead, m, n, k, depth):
    widths = [(m, k), (k, k), (k, 1)] if depth else [(m, k), (k, 1)]

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    ws = tuple(t(rng.standard_normal(lead + (i, o)) * 0.2) for i, o in widths)
    bs = tuple(t(rng.standard_normal(lead + (o,)) * 0.1) for _, o in widths[:-1])
    return ws, bs, t(rng.standard_normal(lead + (n,)))


def _vg_close(got, ref, allow=None):
    y, rss, dws, dbs = got
    y_ref, rss_ref, dws_ref, dbs_ref = ref
    assert (y - y_ref).abs().max().item() <= 1e-4
    assert _rel_close(rss, rss_ref)
    for g, r, al in zip(dws + dbs, dws_ref + dbs_ref, allow or [None] * len(dws + dbs)):
        assert g.shape == r.shape and _rel_close(g, r, allow=al)


def _k8_check(act, call, ref, xT, ws, bs, targets, kernel_launches):
    """K8 (``call()``) against its plain version ``ref(dtype)`` in f32 and in
    f64, each entry of the gradients less its kink allowance; one call
    issues exactly the pass and its reduce, and no other device op (the deep
    design: after the concatenation of the weights); a repeat gives the same
    bits. Returns the first result."""
    flat = lambda o: [o[0], o[1], *o[2], *o[3]]  # noqa: E731
    before = kernel_launches()
    got = call()
    assert kernel_launches() == before + 1
    torch.cuda.synchronize()
    allow = kink_allowance(act, xT, ws, bs, targets)
    for dtype in (torch.float32, torch.float64):
        _vg_close(got, ref(dtype), allow)
    ops = (["CatArrayBatchedCopy", "run_kernel", "vg_dense_reduce"]
           if BM.dense_deep(ws[0].shape[-1], ws[-1].shape[-2], len(ws) - 2)
           else ["vg_dense_kernel", "vg_dense_reduce"])
    again = _one_op(call, ops)
    assert all(torch.equal(a, b) for a, b in zip(flat(got), flat(again)))
    return got


def _f64(ts, dtype):
    return tuple(t.to(dtype) for t in ts)


@pytest.mark.parametrize("depth,act,n,k", DENSE_CASES)
def test_data_vg_kernel_matches_plain(dev, depth, act, n, k):
    """K8a (one branch, one instance) against its plain version in f32 and
    f64; exactly its launches; identical bits on a repeat."""
    rng = np.random.default_rng(12)
    xT = torch.from_numpy(rng.standard_normal((40, n)).astype(np.float32)).to(dev)
    ws, bs, target = _vg_dense_inputs(rng, dev, (), 40, n, k, depth)
    got = _k8_check(
        act, lambda: BM.data_vg(act, xT, ws, bs, target),
        lambda dt: BM.data_vg_ref(act, xT.to(dt), _f64(ws, dt), _f64(bs, dt), target.to(dt)),
        xT, ws, bs, target, lambda: BM.data_vg.launches)
    assert got[2][-1].shape == (ws[-1].shape[0], 1)


@pytest.mark.parametrize("depth,act,n,k", DENSE_CASES)
def test_data_vg_blocked_kernel_matches_plain(dev, depth, act, n, k):
    """K8b: 5 instances on X of 3 branches through ix (repeats included),
    against its plain version in f32 and f64; X read in place through ix
    gives the bits of the gathered X; the forward-only instantiation gives
    y_pred's bits; identical bits on a repeat."""
    rng = np.random.default_rng(13)
    X = torch.from_numpy(rng.standard_normal((3, 40, n)).astype(np.float32)).to(dev)
    ix = torch.tensor([2, 0, 2, 1, 0], dtype=torch.int32, device=dev)
    ws, bs, targets = _vg_dense_inputs(rng, dev, (5,), 40, n, k, depth)
    got = _k8_check(
        act, lambda: BM.data_vg_blocked(act, X, ix, ws, bs, targets),
        lambda dt: BM.data_vg_blocked_ref(act, X.to(dt), ix, _f64(ws, dt), _f64(bs, dt),
                                          targets.to(dt)),
        X[ix.long()], ws, bs, targets, lambda: BM.data_vg_blocked.launches)
    before = BM.forward_blocked.launches
    y_fwd = BM.forward_blocked(act, X, ix, ws, bs)
    assert BM.forward_blocked.launches == before + 1
    assert torch.equal(y_fwd, got[0])
    flat = lambda o: [o[0], o[1], *o[2], *o[3]]  # noqa: E731
    gathered = BM.data_vg_blocked(act, X[ix.long()].contiguous(), None, ws, bs, targets)
    assert all(torch.equal(a, b) for a, b in zip(flat(got), flat(gathered)))


# the dense flagship's branch (m_pad = 64, k0 = s = 32, depth 1, n = 4,096):
# one instance (K8a, a wave of 128 CTAs of one tile each) and 64 instances
# on X read through a shuffled index (K8b)
@pytest.mark.parametrize("NB", [1, 64])
def test_data_vg_blocked_at_the_flagship_shape(dev, NB):
    rng = np.random.default_rng(15)
    m, n, k = 64, 4096, 32
    X = torch.from_numpy(rng.standard_normal((64, m, n)).astype(np.float32)).to(dev)
    ix = torch.from_numpy(rng.permutation(64)[:NB].astype(np.int32)).to(dev)
    ws, bs, targets = _vg_dense_inputs(rng, dev, (NB,), m, n, k, 1)
    plan = BM.vg_dense_plan(NB, m, n, k, k, 1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert plan["tiles"] == 128
    assert plan["ctas"] == min(NB * 128, plan["ctas_per_sm"] * sms)  # one wave
    got = _k8_check(
        "tanh", lambda: BM.data_vg_blocked("tanh", X, ix, ws, bs, targets),
        lambda dt: BM.data_vg_blocked_ref("tanh", X.to(dt), ix, _f64(ws, dt), _f64(bs, dt),
                                          targets.to(dt)),
        X[ix.long()], ws, bs, targets, lambda: BM.data_vg_blocked.launches)
    assert torch.equal(BM.forward_blocked("tanh", X, ix, ws, bs), got[0])


# the largest m_pad that the parent's rule (dense_chains_smem) admitted at
# each register width (one X tile buffer in shared memory), ragged n
K8_LARGEST = [(263, 32, 1), (345, 16, 1), (390, 8, 0)]


@pytest.mark.parametrize("m,k,depth", K8_LARGEST, ids=lambda v: str(v))
def test_data_vg_runs_every_admitted_m(dev, m, k, depth):
    from test_torch_dense_smem import old_dense_chains_smem

    assert old_dense_chains_smem(m, k, k, depth) > 0 > old_dense_chains_smem(m + 1, k, k, depth)
    assert BM.vg_dense_smem(m, k, k, depth) > 0
    n = 301
    assert BM.vg_dense_plan(2, m, n, k, k, depth)["buffers"] in (1, 2)
    rng = np.random.default_rng(16)
    X = torch.from_numpy(rng.standard_normal((2, m, n)).astype(np.float32)).to(dev)
    ws, bs, targets = _vg_dense_inputs(rng, dev, (2,), m, n, k, depth)
    _k8_check(
        "tanh", lambda: BM.data_vg_blocked("tanh", X, None, ws, bs, targets),
        lambda dt: BM.data_vg_blocked_ref("tanh", X.to(dt), None, _f64(ws, dt), _f64(bs, dt),
                                          targets.to(dt)),
        X, ws, bs, targets, lambda: BM.data_vg_blocked.launches)


def test_dense_vg_wrappers_refuse_what_the_kernel_does_not_take(dev):
    """K8 beyond K6/K7's limits (depth 5 at width 64 past shared memory, a
    width above 64) raises NotImplementedError on the card (the plain
    version never runs there)."""
    rng = np.random.default_rng(14)
    m, n = 40, 300
    X = torch.zeros(2, m, n, device=dev)
    ix = torch.zeros(2, dtype=torch.int32, device=dev)
    for depth, k in ((5, 64), (1, 72)):
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


# (depth, m, n, h, s): the dense deep design (csrc/dense_deep.cuh) at depth
# 2 and 3 and at depth 0 and 1 past width 32: the default widths (56), a
# summary layer narrower than the hidden ones, a ragged n, n not a multiple
# of 4 (4-byte copies), m not a multiple of 16. At depth 3 width 64 relu and
# leaky_relu meet 300-1,500 pre-activations within the f32 bound of the
# kink (1.4e-3 of them, past kink_allowance's cap): that shape runs the
# smooth activations, the kinked ones run the other five
DENSE_DEEP_SHAPES = [(2, 104, 1300, 56, 56), (3, 40, 1100, 16, 8), (0, 104, 1300, 56, 56),
                     (1, 24, 701, 40, 24), (2, 64, 333, 8, 8), (3, 104, 700, 64, 64)]
DENSE_DEEP_CASES = [(act, shape) for shape in DENSE_DEEP_SHAPES
                    for act in BM.SUPPORTED_ACTIVATIONS
                    if not (act in ("relu", "leaky_relu") and shape[0] == 3 and shape[3] == 64)]


def _dense_deep_inputs(rng, dev, lead, depth, m, h, s):
    """Weights [*lead, in, out] and biases [*lead, out] of depth hidden
    layers of width h and a summary layer of width s, scaled by fan-in."""
    outs = [h] * depth + [s, 1]
    dims = list(zip([m] + outs[:-1], outs))

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    ws = tuple(t(rng.standard_normal(lead + d) * 0.7 / np.sqrt(d[0])) for d in dims)
    bs = tuple(t(rng.standard_normal(lead + (d[1],)) * 0.1) for d in dims[:-1])
    return ws, bs


def _ids(a):
    return a if isinstance(a, str) else "d{}_m{}_n{}_h{}_s{}".format(*a)


@pytest.mark.parametrize("act,shape", DENSE_DEEP_CASES, ids=_ids)
def test_data_vg_chains_deep_kernel_matches_plain(dev, act, shape):
    """K7's deep design (G = 3, C = 2) by ``_k7_check``; its plan takes the
    shape's width class, one chain a CTA and one wave."""
    depth, m, n, h, s = shape
    rng = np.random.default_rng(31)
    xT = torch.from_numpy(rng.standard_normal((3, m, n)).astype(np.float32)).to(dev)
    ws, bs = _dense_deep_inputs(rng, dev, (3, 2), depth, m, h, s)
    target = torch.from_numpy(rng.standard_normal((3, 2, n)).astype(np.float32)).to(dev)
    plan = BM.vg_chains_plan(3, 2, m, n, h, s, depth, act=act)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert plan["km"] == next(k for k in (8, 16, 32, 64) if max(h, s) <= k) and plan["cc"] == 1
    assert plan["ctas"] <= plan["ctas_per_sm"] * sms and plan["tiles"] == -(-n // 64)
    _k7_check(act, xT, ws, bs, target)


@pytest.mark.parametrize("act,shape", DENSE_DEEP_CASES, ids=_ids)
def test_data_vg_deep_kernel_matches_plain(dev, act, shape):
    """K8a's and K8b's deep design: one instance, then 5 instances on X of 3
    branches through ix, by ``_k8_check``; the forward-only instantiation
    gives y_pred's bits."""
    depth, m, n, h, s = shape
    rng = np.random.default_rng(32)
    X = torch.from_numpy(rng.standard_normal((3, m, n)).astype(np.float32)).to(dev)
    ws, bs = _dense_deep_inputs(rng, dev, (), depth, m, h, s)
    target = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    _k8_check(act, lambda: BM.data_vg(act, X[1], ws, bs, target),
              lambda dt: BM.data_vg_ref(act, X[1].to(dt), _f64(ws, dt), _f64(bs, dt),
                                        target.to(dt)),
              X[1], ws, bs, target, lambda: BM.data_vg.launches)
    ix = torch.tensor([2, 0, 2, 1, 0], dtype=torch.int32, device=dev)
    ws, bs = _dense_deep_inputs(rng, dev, (5,), depth, m, h, s)
    targets = torch.from_numpy(rng.standard_normal((5, n)).astype(np.float32)).to(dev)
    got = _k8_check(
        act, lambda: BM.data_vg_blocked(act, X, ix, ws, bs, targets),
        lambda dt: BM.data_vg_blocked_ref(act, X.to(dt), ix, _f64(ws, dt), _f64(bs, dt),
                                          targets.to(dt)),
        X[ix.long()], ws, bs, targets, lambda: BM.data_vg_blocked.launches)
    before = BM.forward_blocked.launches
    assert torch.equal(BM.forward_blocked(act, X, ix, ws, bs), got[0])
    assert BM.forward_blocked.launches == before + 1
    plan = BM.vg_dense_plan(5, m, n, h, s, depth, act=act)
    assert plan["slots"] == plan["ctas"] + 5 and plan["tiles"] == -(-n // 64)


# (G, C, m, n, depth, h, s, activation, l1)
K6_DEEP_CASES = [(3, 2, 104, 1300, 2, 56, 56, "tanh", False),
                 (2, 4, 104, 700, 0, 56, 56, "identity", True),
                 (3, 3, 40, 1100, 3, 16, 8, "silu", False),
                 (2, 1, 24, 513, 2, 40, 24, "relu", True)]


@pytest.mark.parametrize("steps,tol", [(1, 1e-4), (30, 1e-3)])
@pytest.mark.parametrize("G,C,m,n,depth,h,s,act,l1", K6_DEEP_CASES)
def test_integrate_chains_deep_kernel_matches_plain(dev, G, C, m, n, depth, h, s, act, l1, steps,
                                                   tol):
    """K6's deep design against its plain version in f32 and f64 by
    ``_k6_check``: rtol 1e-4 of the largest entry at L = 1, 1e-3 at L = 30
    (f32 sums in another order, compounded); the targets in the fold's
    transposed view, read in place."""
    rng = np.random.default_rng(33)
    xT = torch.from_numpy(rng.standard_normal((G, m, n)).astype(np.float32)).to(dev)
    ws, bs = _dense_deep_inputs(rng, dev, (G, C), depth, m, h, s)
    p_w, p_b = _dense_deep_inputs(rng, dev, (G, C), depth, m, h, s)
    p_w, p_b = tuple(4 * p for p in p_w), tuple(10 * p for p in p_b)
    e_w, e_b = _dense_deep_inputs(rng, dev, (G, C), depth, m, h, s)
    eps_w = tuple(e.abs() * 2e-3 for e in e_w)
    eps_b = tuple(e.abs() * 2e-2 for e in e_b)
    lam_w = tuple(e.abs() + 0.5 for e in _dense_deep_inputs(rng, dev, (G, C), depth, m, h, s)[0])
    lam_b = tuple(torch.zeros_like(b) for b in bs)
    targets = torch.from_numpy(rng.standard_normal((C, G, n)).astype(np.float32)).to(dev)
    err = (torch.rand(G, C, device=dev) * 0.5 + 0.5)
    args = (xT, targets.transpose(0, 1), err, ws, bs, p_w, p_b, eps_w, eps_b, lam_w, lam_b, steps)
    plan = TL.traj_dense_plan(G, C, m, n, h, s, depth, act)
    assert plan["cc"] == 1 and plan["tiles"] == -(-n // 64)
    out = _k6_check(act, args, l1, tol=tol)
    assert max((a - b).abs().max().item() for a, b in zip(out[0], ws)) > 0


def _adapted_block(dev, model_type, act, depth, C, B, m, n, width, L, seed, packed=True):
    """A hybrid block as the folded sweep hands it to K5 (``packed``) or K6
    under dual averaging and mass adaptation: C chains x B branches of an
    initial state (m markers, layer widths ``width`` stored at the next
    multiple of 8), each chain's perturbed; per-(chain, branch) factors and
    mass estimates (``_mass_std`` of a Welford M2 at count 3), so the step
    sizes, sized for trajectories of L steps, are full per-coordinate
    tensors; every per-layer input in the
    sampler's [C, B] storage, handed over as [B, C] views. Returns (the
    kernel's arguments after ``act``, the step sizes [C, B, ...], the live
    width)."""
    from rs_bann_tpu_torch.models import NetArch
    from rs_bann_tpu_torch.models import net as TN
    from rs_bann_tpu_torch.models import params as TP
    from rs_bann_tpu_torch.models.init import InitCfg, init_net
    from rs_bann_tpu_torch.samplers import hmc as TH
    from rs_bann_tpu_torch.samplers.mcmc_cfg import MCMCCfg

    rng = np.random.default_rng(seed)
    gen = torch.Generator(dev).manual_seed(seed)
    arch = NetArch.uniform(B, m, width, depth, width, activation=act)
    state, _ = init_net(arch, model_type, InitCfg(seed=seed), device=dev)

    def chains(ts, sd):  # [B, ...] -> [C, B, ...], each chain perturbed
        return tuple(t[None] * (1.0 + sd * torch.randn((C,) + t.shape, generator=gen,
                                                       device=dev)) for t in ts)

    ws, bs = chains(state.params.weights, 0.2), chains(state.params.biases, 0.2)
    wp, bp = chains(state.precisions.weights, 0.1), chains(state.precisions.biases, 0.1)
    P = TH.flatten_wb(ws, bs).shape[-1]
    m2 = torch.rand((C, B, P), generator=gen, device=dev) * 0.05
    mass_w, mass_b = TN._mass_std(model_type, m2, 3.0, wp, bp, ws, bs)
    factors = torch.exp(torch.rand((C, B), generator=gen, device=dev) - 2.0)
    cfg = MCMCCfg(hmc_integration_length=L, hmc_step_size_mode="dual_averaging",
                  mass_adaptation=True)
    eps_w, eps_b = TH.step_sizes(None, model_type, cfg, ws, bs, wp, bp, None, factors, mass_w,
                                 mass_b)
    mw, mb = TP.weight_masks(arch, dev), TP.bias_masks(arch, dev)
    p_w = tuple(torch.randn(w.shape, generator=gen, device=dev) * k for w, k in zip(ws, mw))
    p_b = tuple(torch.randn(b.shape, generator=gen, device=dev) * k for b, k in zip(bs, mb))
    lam_w = tuple(lam.expand_as(w) for lam, w in zip(wp, ws))
    lam_b = tuple(torch.zeros_like(b) for b in bs)
    targets = torch.randn((C, B, n), generator=gen, device=dev)
    err = (torch.rand(C, generator=gen, device=dev) + 0.5)[None, :].expand(B, -1)

    def bc(ts):  # the fold's [C, B, ...] -> [B, C, ...] views
        return tuple(t.transpose(0, 1) for t in ts)

    layers = tuple(map(bc, (ws, bs, p_w, p_b, eps_w, eps_b, lam_w, lam_b)))
    assert not layers[4][0].is_contiguous() and layers[4][0].stride(-1) == 1
    if packed:
        vals = np.zeros((B, arch.m_pad, n), np.float32)
        vals[:, :m] = rng.integers(0, 3, size=(B, m, n))
        by = torch.from_numpy(np.stack([PM.pack_strided(v) for v in vals])).to(dev)
        scale = torch.zeros(B, arch.m_pad, device=dev)
        shift = torch.zeros(B, arch.m_pad, device=dev)
        scale[:, :m] = torch.from_numpy(1.0 / vals[:, :m].std(axis=2)).to(dev)
        shift[:, :m] = torch.from_numpy(vals[:, :m].mean(axis=2)).to(dev)
        x = (by, scale, shift)
    else:
        xT = torch.zeros(B, arch.m_pad, n, device=dev)
        xT[:, :m] = torch.randn((B, m, n), generator=gen, device=dev)
        x = (xT,)
    return (*x, targets.transpose(0, 1), err, *layers), (eps_w, eps_b), width


@pytest.mark.parametrize("steps,tol", [(1, 1e-4), (30, 1e-3)])
@pytest.mark.parametrize("model_type,l1", [("ridge_ard", False), ("lasso_ard", True)])
def test_integrate_chains_packed_with_mass_scaled_step_sizes(dev, model_type, l1, steps, tol):
    """K5 on the main path's block shape (B = 10, C = 4, m = 100 stored at
    104, width 10 stored at 16, identity, depth 0) under dual averaging and
    mass adaptation: per-coordinate step sizes (sized for L = 30), nonzero
    on the padded columns too, in the fold's transposed views. Within
    REL_TOL (L = 1) and REL_TOL_TRAJ (L = 30) of its plain version; the
    padded columns' weights and momenta stay exactly 0; a repeat gives the
    same bits."""
    n = 1300
    args, (eps_w, _), live = _adapted_block(dev, model_type, "identity", 0, 4, 10, 100, n, 10,
                                            30, 31)
    assert eps_w[0][..., live:].abs().min() > 0  # padded columns step too
    before = TL.integrate_chains_packed.launches
    out = TL.integrate_chains_packed("identity", *args, steps, n, l1=l1)
    assert TL.integrate_chains_packed.launches == before + 1
    ref = TL.integrate_chains_packed_ref("identity", *args, steps, n, l1=l1)
    again = TL.integrate_chains_packed("identity", *args, steps, n, l1=l1)
    torch.cuda.synchronize()
    for got_p, ref_p, rep_p in zip(out, ref, again):
        for got, want, rep in zip(got_p, ref_p, rep_p):
            assert got.shape == want.shape
            assert (got - want).abs().max().item() <= tol * max(want.abs().max().item(), 1.0)
            assert torch.equal(got, rep)
    for w, pw in ((out[0], out[2]), (ref[0], ref[2])):  # W0 [.., m, k], w_out [.., k, 1]
        assert torch.all(w[0][..., live:] == 0) and torch.all(w[1][..., live:, :] == 0)
        assert torch.all(pw[0][..., live:] == 0) and torch.all(pw[1][..., live:, :] == 0)
    assert torch.all(out[1][0][..., live:] == 0)


@pytest.mark.parametrize("steps,tol", [(3, 1e-4), (64, 1e-3)])
@pytest.mark.parametrize("model_type,l1", [("ridge_base", False), ("lasso_base", True)])
def test_integrate_chains_with_mass_scaled_step_sizes(dev, model_type, l1, steps, tol):
    """K6 at the dense flagship's widths (C = 4 chains x B = 8 branches, m =
    64, h = s = 32, tanh, depth 1) under dual averaging and mass
    adaptation: the per-coordinate step sizes in the fold's transposed,
    non-contiguous views, read where they lie. Against its plain version in
    f32 and f64, rtol 1e-4 after 3 steps and 1e-3 after L = 64 (the step
    sizes sized for L = 64, as the sampler sizes them); one call is the
    launch alone; a repeat gives the same bits."""
    args, _, _ = _adapted_block(dev, model_type, "tanh", 1, 4, 8, 64, 1024, 32, 64, 32,
                                packed=False)
    _k6_check("tanh", args + (steps,), l1, tol=tol)


def test_folded_packed_block_with_mass_keeps_padded_columns_zero(dev):
    """A whole folded block transition on the card (``make_transition_batch``:
    the value passes on the live width, one K5 launch) under dual averaging
    and mass adaptation, where the mass-scaled step sizes of the padded
    columns are not zero: their weights, biases and momenta come out
    exactly 0, and a repeat gives the same bits."""
    from rs_bann_tpu_torch.models import NetArch
    from rs_bann_tpu_torch.models import net as TN
    from rs_bann_tpu_torch.models import params as TP
    from rs_bann_tpu_torch.models.init import InitCfg, init_net
    from rs_bann_tpu_torch.samplers import hmc as TH
    from rs_bann_tpu_torch.samplers.mcmc_cfg import MCMCCfg

    C, B, m, n, width = 4, 10, 100, 1300, 10
    rng = np.random.default_rng(33)
    gen = torch.Generator(dev).manual_seed(33)
    arch = NetArch.uniform(B, m, width, 0, width, activation="identity")
    state, _ = init_net(arch, "ridge_ard", InitCfg(seed=33), device=dev)

    def chains(ts):
        return tuple(t[None].expand((C,) + t.shape).contiguous() for t in ts)

    ws, bs = chains(state.params.weights), chains(state.params.biases)
    wp, bp = chains(state.precisions.weights), chains(state.precisions.biases)
    m2 = torch.rand((C, B, TH.flatten_wb(ws, bs).shape[-1]), generator=gen, device=dev)
    mass_w, mass_b = TN._mass_std("ridge_ard", m2, 3.0, wp, bp, ws, bs)
    factors = torch.exp(torch.rand((C, B), generator=gen, device=dev) - 2.0)
    vals = np.zeros((B, arch.m_pad, n), np.float32)
    vals[:, :m] = rng.integers(0, 3, size=(B, m, n))
    scale = np.zeros((B, arch.m_pad), np.float32)
    shift = np.zeros((B, arch.m_pad), np.float32)
    scale[:, :m], shift[:, :m] = 1.0 / vals[:, :m].std(axis=2), vals[:, :m].mean(axis=2)
    x = PackedX(torch.from_numpy(np.stack([PM.pack_strided(v) for v in vals])).to(dev),
                torch.from_numpy(scale).to(dev), torch.from_numpy(shift).to(dev), n)
    targets = torch.randn((C, B, n), generator=gen, device=dev)
    err = torch.rand(C, generator=gen, device=dev) + 0.5
    momenta = (tuple(torch.randn(w.shape, generator=gen, device=dev) for w in ws),
               tuple(torch.randn(b.shape, generator=gen, device=dev) for b in bs))
    cfg = MCMCCfg(hmc_integration_length=30, hmc_step_size_mode="dual_averaging",
                  mass_adaptation=True, update_mode="hybrid", num_chains=C)
    fold = TH.make_transition_batch("ridge_ard", "identity", cfg)
    eps_w, _ = TH.step_sizes(None, "ridge_ard", cfg, ws, bs, wp, bp, None, factors, mass_w,
                             mass_b)
    assert eps_w[0][..., width:].abs().min() > 0

    def call():
        return fold(ws, bs, wp, bp, err, x, targets, TP.weight_masks(arch, dev),
                    TP.bias_masks(arch, dev), momenta, k_live=width, step_factors=factors,
                    mass_w=mass_w, mass_b=mass_b)

    before = TL.integrate_chains_packed.launches
    prop = call()
    assert TL.integrate_chains_packed.launches == before + 1
    again = call()
    torch.cuda.synchronize()
    assert torch.all(prop.weights[0][..., width:] == 0)
    assert torch.all(prop.weights[1][..., width:, :] == 0)
    assert torch.all(prop.biases[0][..., width:] == 0)
    assert torch.isfinite(prop.y_pred_prop).all() and not prop.dead.all()
    for a, b in zip(prop, again):
        for t, u in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(t, u)


# ------------------------------------------------- the marker scan


def _scan_inputs(dev, I, m, s, seed, n=200, G=3):
    """Inputs of the marker scan for I instances over G branch Grams of m
    markers (the last of every odd instance padded, the last column padded
    where s > 1) and its draws, from a seed."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    x = rng.standard_normal((G, m, n)).astype(np.float32) / np.sqrt(n / 50)
    gram = np.einsum("gin,gjn->gij", x, x)
    gram = np.triu(gram) + np.triu(gram, 1).transpose(0, 2, 1)
    gix = rng.integers(0, G, I)
    rm = np.ones((I, m), np.float32)
    rm[1::2, -1] = 0.0
    cm = np.ones((I, s), np.float32)
    if s > 1:
        cm[:, -1] = 0.0
    W0 = rng.standard_normal((I, m, s)) * 0.3 * rm[..., None] * cm[:, None]
    w_out = rng.standard_normal((I, s)) * cm
    beta = rng.standard_normal((I, m)) * (rng.random((I, m)) < 0.2)
    u0 = np.einsum("iaj,ij->ia", gram[gix], beta) + rng.standard_normal((I, m))
    eta = rng.uniform(0.3, 3.0, (I, m, s))
    order = torch.argsort(torch.rand((I, m), generator=gen), dim=-1).to(dev)
    return (t(gram), torch.from_numpy(gix).to(dev), t(u0), t(W0), t(w_out), t(eta),
            t(rng.uniform(0.5, 2.0, I)), t(rng.uniform(0.1, 0.6, I)), t(rm), t(cm), False, order,
            t(rng.random((I, m))), t(rng.standard_normal((I, m))),
            t(rng.standard_normal((I, m, s))))


@pytest.mark.parametrize("I", [1, 40, 400])
@pytest.mark.parametrize("s", [8, 16, 32, 56])
@pytest.mark.parametrize("m", [24, 104, 256])
def test_marker_scan_kernel_matches_plain(dev, m, s, I):
    """The scan kernel against its plain version on the same draws: z equal
    except on an instance whose first disagreement is a near tie of the
    plain version in f64 (|u - p| < 1e-5; counted and printed), W0_new
    within 1e-4 of max(1, max |W0_new|) on the others (sums of s terms and
    the u updates rounded in another order), padded columns and excluded
    rows exactly 0, identical bits on a repeat."""
    from rs_bann_tpu_torch.ops import marker_scan as MS

    args = _scan_inputs(dev, I, m, s, seed=m + s + I)
    before = MS.marker_scan.launches
    z, W = MS.marker_scan(*args)
    assert MS.marker_scan.launches == before + 1
    z2, W2 = MS.marker_scan(*args)
    torch.cuda.synchronize()
    assert torch.equal(z, z2) and torch.equal(W, W2)
    z_ref, W_ref = MS.marker_scan_ref(*args)
    f64 = [a.double() if isinstance(a, torch.Tensor) and a.is_floating_point() else a
           for a in args]
    *_, p64 = MS.marker_scan_ref(*f64, probs=True)
    same, ties = MS.scan_ties(z, z_ref, args[11], args[12], p64)
    print(f"m {m} s {s} I {I}: {ties} near-tie instances")
    assert int(same.sum()) >= I - max(1, I // 20)
    same = same.to(dev)
    err = (W[same] - W_ref[same]).abs().max().item()
    assert err <= 1e-4 * max(1.0, W_ref[same].abs().max().item())
    assert torch.all(W[..., args[9][0] == 0] == 0) and torch.all(W[z == 0] == 0)
    assert torch.all(z[args[8] == 0] == 0) and 0 < int(z.sum()) < int(args[8].sum())


def test_marker_scan_kernel_forced_and_limits(dev):
    """force keeps every true marker in; the kernel takes m_pad up to
    MAX_M and s_pad up to MAX_S (what the CLI admits) and raises beyond
    them."""
    from rs_bann_tpu_torch.ops import marker_scan as MS

    args = list(_scan_inputs(dev, 40, 104, 16, seed=1))
    args[10] = True
    z, W = MS.marker_scan(*args)
    z_ref, W_ref = MS.marker_scan_ref(*args)
    assert torch.equal(z, args[8]) and torch.equal(z_ref, z)
    assert (W - W_ref).abs().max().item() <= 1e-4 * max(1.0, W_ref.abs().max().item())
    args = list(_scan_inputs(dev, 2, MS.MAX_M, MS.MAX_S, seed=3))
    args[10] = True
    z, W = MS.marker_scan(*args)
    z_ref, W_ref = MS.marker_scan_ref(*args)
    assert torch.equal(z, z_ref)
    assert (W - W_ref).abs().max().item() <= 1e-4 * max(1.0, W_ref.abs().max().item())
    for m, s in ((MS.MAX_M + 1, 8), (24, MS.MAX_S + 1)):
        with pytest.raises(RuntimeError, match="marker_scan_f32"):
            MS.marker_scan(*_scan_inputs(dev, 2, m, s, seed=2))


@pytest.mark.parametrize("s", [8, 16, 56])
def test_marker_scan_kernel_reads_broadcast_eta_in_place(dev, s):
    """Ridge's slab precisions, the rows' precisions broadcast over the
    columns (column stride 0), read in place give the same bits as their
    contiguous copy, and agree with the plain version."""
    from rs_bann_tpu_torch.ops import marker_scan as MS

    args = list(_scan_inputs(dev, 40, 104, s, seed=4))
    args[5] = args[5][..., :1].contiguous().expand(40, 104, s)
    assert args[5].stride() == (104, 1, 0)
    z, W = MS.marker_scan(*args)
    z_ref, W_ref = MS.marker_scan_ref(*args)
    dense = list(args)
    dense[5] = args[5].contiguous()
    z2, W2 = MS.marker_scan(*dense)
    torch.cuda.synchronize()
    assert torch.equal(z, z2) and torch.equal(W, W2)
    f64 = [a.double() if isinstance(a, torch.Tensor) and a.is_floating_point() else a
           for a in args]
    *_, p64 = MS.marker_scan_ref(*f64, probs=True)
    same, _ = MS.scan_ties(z, z_ref, args[11], args[12], p64)
    assert int(same.sum()) >= 40 - 2
    same = same.to(dev)
    assert (W[same] - W_ref[same]).abs().max().item() <= 1e-4 * max(
        1.0, W_ref[same].abs().max().item())


# ------------------------------------ feature-major X stored in bf16 (--x-bf16)

# (depth, m, n, h, s, activation): the first design (csrc/dense_vg_mma.cuh)
# at depth 1 width 32 (16-byte copies of 8 values) and depth 0 width 8 with
# n not a multiple of 8 (plain loads and stores); the deep design
# (csrc/dense_deep.cuh) at depth 2 width 56 and depth 3 width 16 with a
# ragged n
XBF16_SHAPES = [(1, 64, 1000, 32, 32, "tanh"), (0, 40, 333, 8, 8, "identity"),
                (2, 104, 1300, 56, 56, "tanh"), (3, 24, 701, 16, 8, "silu")]


def _xbf16(rng, shape, dev):
    """Standard normal X in f32, rounded once to bf16, on the card."""
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev).to(
        torch.bfloat16)


def _same_bits(a, b):
    flat = lambda o: [t for p in o for t in (p if isinstance(p, tuple) else (p,))]  # noqa: E731
    return all(torch.equal(u, v) for u, v in zip(flat(a), flat(b)))


def _xbf16_ids(a):
    return "d{}_m{}_n{}_h{}_s{}_{}".format(*a)


def _near_plain(got, ref):
    """Every output within 1e-4 of max(1, the largest entry) of the plain
    version's, in f32 and in f64 (``ref(dtype)``); no profiling session:
    the f32 kernels' checks count the device ops of the same wrappers."""
    flat = lambda o: [t for p in o for t in (p if isinstance(p, tuple) else (p,))]  # noqa: E731
    for dtype in (torch.float32, torch.float64):
        want = flat(ref(dtype))
        assert len(want) == len(flat(got))
        for a, b in zip(flat(got), want):
            assert a.shape == b.shape and _rel_close(a.to(dtype), b)


@pytest.mark.parametrize("shape", XBF16_SHAPES, ids=_xbf16_ids)
def test_dense_kernels_on_bf16_x_match_plain_and_the_f32_kernel(dev, shape):
    """K7 (both forms), K8a, K8b (through an index) and K6 (L = 3) on X
    stored in bf16: each within 1e-4 of the largest entry of its plain
    version on the same bf16 X (in f32 and f64), the same bits on a repeat
    and as the f32-X kernel on X upcast (the products leave out only X's
    zero low part); each call counts one ``xbf16_launches`` and one
    ``launches``, the f32-X call no ``xbf16_launches``."""
    depth, m, n, h, s, act = shape
    rng = np.random.default_rng(41)
    G, C = 3, 2
    xb = _xbf16(rng, (G, m, n), dev)
    ws, bs = _dense_deep_inputs(rng, dev, (G, C), depth, m, h, s)
    target = torch.from_numpy(rng.standard_normal((G, C, n)).astype(np.float32)).to(dev)

    def counted(wrapper, call):
        """call() once: one launch, one of them on bf16 X"""
        before = (wrapper.launches, wrapper.xbf16_launches)
        out = call()
        assert (wrapper.launches, wrapper.xbf16_launches) == (before[0] + 1, before[1] + 1)
        return out

    def f32_same(wrapper, call_b, call_f):
        """the bf16-X call repeated, and the f32-X call on X upcast, give its bits"""
        first = counted(wrapper, call_b)
        assert _same_bits(first, call_b())
        before = wrapper.xbf16_launches
        assert _same_bits(first, call_f())
        assert wrapper.xbf16_launches == before
        return first

    got = f32_same(BM.data_vg_chains, lambda: BM.data_vg_chains(act, xb, ws, bs, target),
                   lambda: BM.data_vg_chains(act, xb.float(), ws, bs, target))
    _near_plain(got, lambda dt: BM.data_vg_chains_ref(act, xb.to(dt), _f64(ws, dt), _f64(bs, dt),
                                                      target.to(dt)))
    fwd = f32_same(BM.data_vg_chains, lambda: BM.forward_chains(act, xb, ws, bs),
                   lambda: BM.forward_chains(act, xb.float(), ws, bs))
    assert torch.equal(fwd, got[0])
    plan = BM.vg_chains_plan(G, C, m, n, h, s, depth, act=act, x_dtype=torch.bfloat16)
    assert plan["smem"] < BM.vg_chains_plan(G, C, m, n, h, s, depth, act=act)["smem"]

    w1, b1, t1 = tuple(w[1, 0] for w in ws), tuple(b[1, 0] for b in bs), target[1, 0]
    got = f32_same(BM.data_vg, lambda: BM.data_vg(act, xb[1], w1, b1, t1),
                   lambda: BM.data_vg(act, xb[1].float(), w1, b1, t1))
    _near_plain(got, lambda dt: BM.data_vg_ref(act, xb[1].to(dt), _f64(w1, dt), _f64(b1, dt),
                                               t1.to(dt)))
    ix = torch.tensor([2, 0, 2, 1, 0], dtype=torch.int32, device=dev)
    w5, b5 = _dense_deep_inputs(rng, dev, (5,), depth, m, h, s)
    t5 = torch.from_numpy(rng.standard_normal((5, n)).astype(np.float32)).to(dev)
    got = f32_same(BM.data_vg_blocked, lambda: BM.data_vg_blocked(act, xb, ix, w5, b5, t5),
                   lambda: BM.data_vg_blocked(act, xb.float(), ix, w5, b5, t5))
    _near_plain(got, lambda dt: BM.data_vg_blocked_ref(act, xb.to(dt), ix, _f64(w5, dt),
                                                       _f64(b5, dt), t5.to(dt)))
    fwd = f32_same(BM.forward_blocked, lambda: BM.forward_blocked(act, xb, ix, w5, b5),
                   lambda: BM.forward_blocked(act, xb.float(), ix, w5, b5))
    assert torch.equal(fwd, got[0])

    p_w, p_b = _dense_deep_inputs(rng, dev, (G, C), depth, m, h, s)
    e_w, e_b = _dense_deep_inputs(rng, dev, (G, C), depth, m, h, s)
    eps_w, eps_b = tuple(e.abs() * 2e-3 for e in e_w), tuple(e.abs() * 2e-2 for e in e_b)
    lam_w = tuple(e.abs() + 0.5 for e in _dense_deep_inputs(rng, dev, (G, C), depth, m, h, s)[0])
    lam_b = tuple(torch.zeros_like(b) for b in bs)
    err = torch.rand(G, C, device=dev) * 0.5 + 0.5
    rest = (target, err, ws, bs, p_w, p_b, eps_w, eps_b, lam_w, lam_b, 3)
    out = f32_same(TL.integrate_chains, lambda: TL.integrate_chains(act, xb, *rest),
                   lambda: TL.integrate_chains(act, xb.float(), *rest))

    def ref(dt):
        cast = [tuple(t.to(dt) for t in a) if isinstance(a, tuple)
                else a.to(dt) if isinstance(a, torch.Tensor) else a for a in rest]
        return TL.integrate_chains_ref(act, xb.to(dt), *cast)

    _near_plain(out, ref)
    assert max((a - b).abs().max().item() for a, b in zip(out[0], ws)) > 0


def test_dense_limits_on_bf16_x_agree_with_the_kernels(dev):
    """The C rules of K6, K7 and K8 on bf16 X (``x_bf16`` = 1) and their
    Python mirrors (``x_dtype=torch.bfloat16``) agree, at the shapes of
    tests/test_torch_branch_mlp.py DENSE_LIMITS_XBF16 and the f32 ones."""
    from rs_bann_tpu_torch.ops import _build

    lib = _build.lib()
    for shape in [(64, 32, 32, 1), (40, 16, 16, 0), (104, 16, 16, 1), (384, 32, 32, 1),
                  (385, 32, 32, 1), (288, 56, 56, 2), (289, 56, 56, 2)] + DENSE_LIMIT_SHAPES:
        for rule in ("traj_dense_smem", "vg_chains_smem", "vg_dense_smem"):
            assert getattr(lib, rule)(*shape, 1) == getattr(BM, rule)(
                *shape, torch.bfloat16), (rule, shape)


def test_dense_kernels_on_bf16_x_run_every_admitted_m(dev):
    """The largest m_pad each design admits on bf16 X (more than on f32 X)
    runs: K7 at depth 1 width 32 (384), K6 at depth 2 width 56 (288), each
    within 1e-4 of the largest entry of its plain version in f32 and f64."""
    rng = np.random.default_rng(42)
    assert BM.vg_chains_smem(384, 32, 32, 1, torch.bfloat16) > 0 > BM.vg_chains_smem(384, 32, 32, 1)
    xb = _xbf16(rng, (2, 384, 301), dev)
    ws, bs = _dense_deep_inputs(rng, dev, (2, 2), 1, 384, 32, 32)
    target = torch.from_numpy(rng.standard_normal((2, 2, 301)).astype(np.float32)).to(dev)
    _near_plain(BM.data_vg_chains("tanh", xb, ws, bs, target),
                lambda dt: BM.data_vg_chains_ref("tanh", xb.to(dt), _f64(ws, dt), _f64(bs, dt),
                                                 target.to(dt)))
    assert BM.traj_dense_smem(288, 56, 56, 2, torch.bfloat16) > 0 > BM.traj_dense_smem(288, 56, 56,
                                                                                       2)
    xb = _xbf16(rng, (1, 288, 257), dev)
    ws, bs = _dense_deep_inputs(rng, dev, (1, 2), 2, 288, 56, 56)
    p_w, p_b = _dense_deep_inputs(rng, dev, (1, 2), 2, 288, 56, 56)
    eps_w, eps_b = tuple(1e-3 * torch.ones_like(w) for w in ws), tuple(
        1e-3 * torch.ones_like(b) for b in bs)
    lam_w, lam_b = tuple(torch.ones_like(w) for w in ws), tuple(torch.zeros_like(b) for b in bs)
    target = torch.from_numpy(rng.standard_normal((1, 2, 257)).astype(np.float32)).to(dev)
    rest = (target, torch.ones(1, 2, device=dev), ws, bs, p_w, p_b, eps_w, eps_b, lam_w, lam_b, 1)

    def ref(dt):
        cast = [tuple(t.to(dt) for t in a) if isinstance(a, tuple)
                else a.to(dt) if isinstance(a, torch.Tensor) else a for a in rest]
        return TL.integrate_chains_ref("tanh", xb.to(dt), *cast)

    _near_plain(TL.integrate_chains("tanh", xb, *rest), ref)
