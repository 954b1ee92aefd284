"""Feature-major X stored in bf16 (``--x-bf16``) and bf16 inputs of the plain
products (``--bf16``) on the CPU, against the JAX package.

The same numpy inputs go through both packages; X is the f32 values
rounded once to bf16 on each side. The JAX package runs its Pallas kernels
in interpret mode (``branch_mlp.FORCE = "interpret"``), where every operand
is cast to f32: bf16 X exactly, the weights unrounded.

1. The storage: the port's ``to_feature_major(dtype=bf16)`` holds the JAX
   package's bits.
2. The kernels' plain versions on bf16 X (K8a ``data_vg``, K8b
   ``data_vg_blocked`` and ``forward_blocked``, K7 ``data_vg_chains`` and
   ``forward_chains``, K6 ``integrate_chains`` at L = 1 and 3) against the
   JAX kernels on the same bf16 X, within 1e-4 of each output's largest
   entry, at depth 1 (the first design's shapes) and depth 2 at width 40
   (the deep design's); each is the plain version on the upcast f32 X, bit
   for bit.
3. ``matmul``, ``matmul_fm``, ``forward`` and ``predict`` under
   ``--x-bf16``, under ``--bf16`` and under both, on a FeatX, on packed
   genotypes and on dense sample-major X, against the JAX package's (rtol
   1e-5 with atol 1e-5: sums in another order; under ``--bf16`` a few
   entries whose inputs round to bf16 on either side of a boundary in the
   two packages, within one bf16 step); ``_bf16_pair``'s ``TypeError``.
4. The marker scan's products on a bf16 FeatX: ``marker_gram`` is the JAX
   package's bf16 ``X_J @ X_J.T`` (each sum rounded once to bf16; within
   one bf16 rounding of it), ``marker_u0`` its f32 ``X_J @ e``.
5. One folded block transition on a bf16 FeatX, draw for draw against the
   JAX package's chain rule (rtol 1e-4), and the sweep's snapshot operator
   (``snapshot_chains``, and K8's forward on ``predict_weights``: the JAX
   package's ``D.predict``, W0 rounded to bf16) against the transition's
   own (``predict_chains``: the kernel's, W0 unrounded).
6. ``train-new --feat-major --x-bf16 --cpu`` trains on X stored in bf16 and
   the JAX package predicts its samples as the port does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_bann_tpu.io.bed import BedVM as JBedVM
from rs_bann_tpu.io.genotypes import CompressedGenotypes as JCompressedGenotypes
from rs_bann_tpu.group.grouping import UniformGrouping as JUniformGrouping
from rs_bann_tpu.models import density as JD
from rs_bann_tpu.models import init as JI
from rs_bann_tpu.models import params as JP
from rs_bann_tpu.models.arch import NetArch
from rs_bann_tpu.models.data import pack_stacked as j_pack_stacked
from rs_bann_tpu.ops import branch_mlp as JBM
from rs_bann_tpu.ops import leapfrog as JL
from rs_bann_tpu.samplers import hmc as JH
from rs_bann_tpu.samplers.mcmc_cfg import MCMCCfg
from rs_bann_tpu_torch.io import BedVM, UniformGrouping
from rs_bann_tpu_torch.io.genotypes import CompressedGenotypes
from rs_bann_tpu_torch.models import density as TD
from rs_bann_tpu_torch.models.data import pack_stacked
from rs_bann_tpu_torch.ops import branch_mlp as TBM
from rs_bann_tpu_torch.ops import leapfrog as TL
from rs_bann_tpu_torch.samplers import hmc as TH
from test_torch_cli import _predict_matches_jax, _train_args, data, run_cli  # noqa: F401
from test_torch_copies import port

M, M_PAD, N = 12, 16, 300
# depth, hidden width h, summary width s, activation: the first design's
# depth 1 and the deep design's depth 2 at a padded width of 40
CASES = [(1, 8, 8, "tanh"), (2, 40, 40, "identity")]


@pytest.fixture(autouse=True)
def _interpret_and_f32():
    JBM.FORCE = "interpret"
    try:
        yield
    finally:
        JBM.FORCE = None
        JD.set_compute_dtype(None)
        TD.set_compute_dtype(None)


def T(a):
    return tuple(map(T, a)) if isinstance(a, tuple) else torch.from_numpy(np.array(a))


def J(a):
    return tuple(map(jnp.asarray, a)) if isinstance(a, tuple) else jnp.asarray(a)


def Tb(x):
    """numpy f32 -> torch bf16, rounded once to nearest even"""
    return torch.from_numpy(x).to(torch.bfloat16)


def Jb(x):
    return jnp.asarray(x, dtype=jnp.bfloat16)


def _branches(rng, lead, depth, h, s, m=M_PAD, scale=0.7):
    outs = [h] * depth + [s, 1]
    dims = list(zip([m] + outs[:-1], outs))
    ws = tuple((rng.standard_normal(lead + d) * scale / np.sqrt(d[0])).astype(np.float32)
               for d in dims)
    bs = tuple((rng.standard_normal(lead + (d[1],)) * 0.1).astype(np.float32) for d in dims[:-1])
    return ws, bs


def _x(rng, lead):
    """Standardized-like feature-major X [..., M_PAD, N] (f32); the padded
    marker rows are zero."""
    x = np.zeros(lead + (M_PAD, N), np.float32)
    x[..., :M, :] = rng.standard_normal(lead + (M, N))
    return x


def _near(t, j, frac=1e-4):
    """Within ``frac`` of the largest entry of the JAX output."""
    j = np.asarray(j, np.float64)
    assert tuple(t.shape) == j.shape
    scale = max(float(np.abs(j).max()), 1e-30)
    np.testing.assert_allclose(t.double().numpy(), j, rtol=0, atol=frac * scale)


def _same(a, b):
    for t, u in zip(a, b):
        if isinstance(t, tuple):
            _same(t, u)
        else:
            assert torch.equal(t, u)


# ------------------------------------------------------------- 1. storage


def test_feature_major_bf16_storage_has_the_jax_bits(data):  # noqa: F811
    bed = BedVM.from_file(data / "train")
    jbed = JBedVM.from_file(data / "train")
    arch = NetArch.uniform(3, 10, 4, 1, 4, activation="tanh")
    t = CompressedGenotypes(bed, UniformGrouping(3, 10)).to_feature_major(
        port(arch), "cpu", dtype=torch.bfloat16).X.xT
    j = JCompressedGenotypes(jbed, JUniformGrouping(3, 10)).to_feature_major(
        arch, dtype="bfloat16").X.xT
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), np.asarray(j).view(np.int16))
    f32 = CompressedGenotypes(bed, UniformGrouping(3, 10)).to_feature_major(port(arch), "cpu").X.xT
    assert torch.equal(t, f32.to(torch.bfloat16)) and not torch.equal(t.float(), f32)


# ------------------------------------------ 2. the kernels' plain versions


@pytest.mark.parametrize("depth,h,s,act", CASES, ids=lambda a: str(a))
def test_k8_plain_versions_on_bf16_x_match_jax(depth, h, s, act):
    rng = np.random.default_rng(depth * 10 + h)
    ws, bs = _branches(rng, (), depth, h, s)
    xT, target = _x(rng, ()), rng.standard_normal(N).astype(np.float32)
    jout = JBM.data_vg(act, Jb(xT), J(ws), J(bs), J(target))
    tout = TBM.data_vg(act, Tb(xT), T(ws), T(bs), T(target))
    for t, j in zip([tout[0], tout[1], *tout[2], *tout[3]],
                    [jout[0], jout[1], *jout[2], *jout[3]]):
        _near(t, j)
    _same(tout, TBM.data_vg(act, Tb(xT).float(), T(ws), T(bs), T(target)))

    ws, bs = _branches(rng, (4,), depth, h, s)
    X = _x(rng, (3,))
    ix = np.array([2, 0, 2, 1], np.int32)
    targets = rng.standard_normal((4, N)).astype(np.float32)
    jout = jax.vmap(lambda x, w, b, t: JBM.data_vg(act, x, w, b, t))(
        Jb(X)[ix], J(ws), J(bs), J(targets))
    tout = TBM.data_vg_blocked(act, Tb(X), T(ix), T(ws), T(bs), T(targets))
    for t, j in zip([tout[0], tout[1], *tout[2], *tout[3]],
                    [jout[0], jout[1], *jout[2], *jout[3]]):
        _near(t, j)
    assert torch.equal(TBM.forward_blocked(act, Tb(X), T(ix), T(ws), T(bs)), tout[0])


@pytest.mark.parametrize("depth,h,s,act", CASES, ids=lambda a: str(a))
def test_k7_plain_versions_on_bf16_x_match_jax(depth, h, s, act):
    rng = np.random.default_rng(depth + h)
    G, C = 2, 3
    ws, bs = _branches(rng, (G, C), depth, h, s)
    xT = _x(rng, (G,))
    target = rng.standard_normal((G, C, N)).astype(np.float32)
    jout = JBM.data_vg_chains(act, Jb(xT), J(ws), J(bs), J(target), f32=True)
    tout = TBM.data_vg_chains(act, Tb(xT), T(ws), T(bs), T(target))
    for t, j in zip([tout[0], tout[1], *tout[2], *tout[3]],
                    [jout[0], jout[1], *jout[2], *jout[3]]):
        _near(t, j)
    _same(tout, TBM.data_vg_chains(act, Tb(xT).float(), T(ws), T(bs), T(target)))
    assert torch.equal(TBM.forward_chains(act, Tb(xT), T(ws), T(bs)), tout[0])


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("depth,h,s,act", CASES, ids=lambda a: str(a))
def test_k6_plain_version_on_bf16_x_matches_jax(depth, h, s, act, steps):
    rng = np.random.default_rng(3 + depth)
    G, C = 2, 2
    ws, bs = _branches(rng, (G, C), depth, h, s)
    p_w, p_b = _branches(rng, (G, C), depth, h, s, scale=1.0)
    e_w, e_b = _branches(rng, (G, C), depth, h, s)
    eps_w = tuple(np.abs(e) * np.float32(5e-3) for e in e_w)
    eps_b = tuple(np.abs(e) * np.float32(5e-2) for e in e_b)
    lam_w = tuple(np.abs(e) + np.float32(0.5) for e in _branches(rng, (G, C), depth, h, s)[0])
    lam_b = tuple(np.zeros_like(b) for b in bs)
    xT = _x(rng, (G,))
    targets = rng.standard_normal((G, C, N)).astype(np.float32)
    err = (rng.random((G, C)) * 0.5 + 0.5).astype(np.float32)
    rest = (targets, err, ws, bs, p_w, p_b, eps_w, eps_b, lam_w, lam_b)
    jout = JL.integrate_chains(act, Jb(xT), *map(J, rest), steps, interpret=True)
    tout = TL.integrate_chains(act, Tb(xT), *map(T, rest), steps)
    for tpart, jpart in zip(tout, jout):
        for t, j in zip(tpart, jpart):
            _near(t, j)
    _same(tout, TL.integrate_chains(act, Tb(xT).float(), *map(T, rest), steps))


# ------------------------------------------------ 3. the plain products


def _set(dtype):
    JD.set_compute_dtype(dtype)
    TD.set_compute_dtype(dtype)


def _close(t, j):
    """rtol 1e-5 with atol 1e-5, but under --bf16 for the entries where an
    input that two products round to bf16 lies on either side of a rounding
    boundary in the two packages (its f32 value from sums in another order):
    at most 1% of them, each within one bf16 step (2^-8) of the largest."""
    t, j = t.double().numpy(), np.asarray(j, np.float64)
    assert t.shape == j.shape
    off = ~np.isclose(t, j, rtol=1e-5, atol=1e-5)
    if TD.compute_dtype() is None:
        assert not off.any(), np.abs(t - j).max()
    else:
        assert off.mean() <= 0.01 and np.abs(t - j).max() <= 2.0 ** -8 * np.abs(j).max()


@pytest.mark.parametrize("x_bf16,bf16", [(True, False), (False, True), (True, True)],
                         ids=["x-bf16", "bf16", "both"])
def test_products_forward_and_predict_match_jax(x_bf16, bf16):
    rng = np.random.default_rng(11)
    _set("bfloat16" if bf16 else None)
    ws, bs = _branches(rng, (), 2, 8, 8)
    xT = _x(rng, ())
    tx, jx = (Tb(xT), Jb(xT)) if x_bf16 else (T(xT), J(xT))
    a = rng.standard_normal((N, M_PAD)).astype(np.float32)
    _close(TD.matmul_fm(T(ws[0]), tx), JD.matmul_fm(J(ws[0]), jx))
    _close(TD.matmul(T(a), T(ws[0])), JD.matmul(J(a), J(ws[0])))
    if x_bf16:
        xs = np.ascontiguousarray(xT.T)
        _close(TD.matmul(Tb(xs), T(ws[0])), JD.matmul(Jb(xs), J(ws[0])))
    tpre, tacts = TD.forward("tanh", T(ws), T(bs), TD.FeatX(tx))
    jpre, jacts = JD.forward("tanh", J(ws), J(bs), JD.FeatX(jx))
    for t, j in zip(tpre + tacts, jpre + jacts):
        _close(t, j)
    _close(TD.predict("tanh", T(ws), T(bs), TD.FeatX(tx)),
           JD.predict("tanh", J(ws), J(bs), JD.FeatX(jx)))
    # the plain products round W0 (x-bf16) and every input (bf16): not the kernel's
    gap = (TD.predict("tanh", T(ws), T(bs), TD.FeatX(tx))
           - TBM.forward_chains("tanh", tx[None], tuple(w[None, None] for w in T(ws)),
                                tuple(b[None, None] for b in T(bs)))[0, 0]).abs().max()
    assert gap > 1e-5


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_packed_and_sample_major_predict_match_jax(data, bf16):  # noqa: F811
    """Packed genotypes (K2's layer 0; the hidden and output products plain)
    and dense sample-major X under --bf16 and without it."""
    rng = np.random.default_rng(12)
    _set("bfloat16" if bf16 else None)
    arch = NetArch.uniform(3, 10, 8, 1, 8, activation="tanh")
    jbed = JBedVM.from_file(data / "train")
    jx = j_pack_stacked(arch, jbed, JUniformGrouping(3, 10), np.zeros(jbed.num_individuals)).X
    bed = BedVM.from_file(data / "train")
    tx = pack_stacked(port(arch), bed, UniformGrouping(3, 10), np.zeros(bed.num_individuals),
                      "cpu").X
    ws, bs = _branches(rng, (3,), 1, 8, 8, m=arch.m_pad)
    _close(TD.predict("tanh", T(ws), T(bs), tx), jax.vmap(
        lambda w, b, x: JD.predict("tanh", w, b, x))(J(ws), J(bs), jx))
    xs = rng.standard_normal((3, 50, arch.m_pad)).astype(np.float32)
    _close(TD.predict("tanh", T(ws), T(bs), T(xs)),
           jax.vmap(lambda w, b, x: JD.predict("tanh", w, b, x))(J(ws), J(bs), J(xs)))


def test_bf16_pair_refuses_other_mismatches():
    f32, f64 = torch.ones(2, 2), torch.ones(2, 2, dtype=torch.float64)
    with pytest.raises(TypeError, match="only the bf16-stored-X vs f32-weights pair"):
        TD.matmul(f32, f64)
    with pytest.raises(TypeError, match="only the bf16-stored-X vs f32-weights pair"):
        TD.matmul_fm(f32, torch.ones(2, 2, dtype=torch.int32))
    with pytest.raises(TypeError):
        JD.matmul(jnp.ones((2, 2)), jnp.ones((2, 2), jnp.int32))
    with pytest.raises(ValueError):
        TD.set_compute_dtype("float16")


# ------------------------------------------------- 4. the marker scan


def test_marker_gram_and_u0_on_bf16_x_match_jax():
    rng = np.random.default_rng(13)
    xT = _x(rng, (2,)) * np.float32(3.0)
    e = rng.standard_normal((N, 2)).astype(np.float32)
    x = TD.FeatX(Tb(xT))
    gram = TD.marker_gram(x)
    for g in range(2):
        jg = Jb(xT)[g] @ Jb(xT)[g].T
        assert jg.dtype == jnp.bfloat16
        jg = np.asarray(jg.astype(jnp.float32))
        assert torch.equal(gram[g], gram[g].to(torch.bfloat16).float())  # bf16 values
        # one bf16 rounding of the same f32 sum: equal, or one ulp where the
        # two f32 sums fall on either side of a rounding boundary
        np.testing.assert_allclose(gram[g].numpy(), jg, rtol=2.0 ** -8, atol=0)
        assert np.mean(gram[g].numpy() == jg) > 0.95
        ju = np.asarray(Jb(xT)[g] @ J(e))
        assert ju.dtype == np.float32
        np.testing.assert_allclose(TD.marker_u0(x[g], T(e)).numpy(), ju, rtol=1e-5, atol=1e-5)
    f32 = TD.marker_gram(TD.FeatX(Tb(xT).float()))
    assert 0 < (gram - f32).abs().max() <= 2.0 ** -8 * f32.abs().max()


# ----------------------------------- 5. the folded transition and the snapshot


def test_folded_transition_on_bf16_x_matches_jax_draw_for_draw():
    rng = np.random.default_rng(5)
    C, G, m, model_type, act = 2, 2, 12, "ridge_base", "tanh"
    arch = NetArch.uniform(G, m, 6, 1, 6, activation=act)
    state, _ = JI.init_net(arch, model_type, JI.InitCfg(seed=2))
    xT = np.zeros((G, arch.m_pad, N), np.float32)
    xT[:, :m] = rng.standard_normal((G, m, N))

    def chains(tree, sd):  # [G, ...] -> [C, G, ...], each chain perturbed
        return tuple(np.asarray(a)[None] * (1.0 + sd * rng.standard_normal((C,) + a.shape))
                     .astype(np.float32) for a in tree)

    ws, bs = chains(state.params.weights, 0.2), chains(state.params.biases, 0.2)
    wp, bp = chains(state.precisions.weights, 0.1), chains(state.precisions.biases, 0.1)
    err = np.array([1.1, 0.7], np.float32)
    targets = rng.standard_normal((C, G, N)).astype(np.float32)
    mw, mb = JP.weight_masks(arch), JP.bias_masks(arch)
    cfg = MCMCCfg(hmc_integration_length=2, hmc_step_size_factor=0.1, update_mode="parallel",
                  num_chains=C)
    keys = jax.random.split(jax.random.key(7), C * G).reshape(C, G)
    nw = len(ws) + len(bs)

    def momenta(i, shape):  # the chain rule's per-(g, c) derivation
        def mom(k):
            _, k_mom, _ = jax.random.split(k, 3)
            return jax.random.normal(jax.random.split(k_mom, nw)[i], shape)
        return np.asarray(jax.vmap(jax.vmap(mom))(keys))

    p_w = [momenta(i, w.shape[2:]) for i, w in enumerate(ws)]
    p_b = [momenta(len(ws) + i, b.shape[2:]) for i, b in enumerate(bs)]
    transition = JH.make_hmc_step(model_type, act, cfg, defer_accept=True)
    batch = JH.make_transition_batch(model_type, act, cfg, transition, lean_ok=True)
    jp = jax.vmap(
        batch, in_axes=(0, 0, 0, 0, 0, 0, None, 0, None, None, None, None, None, None, None)
    )(keys, J(ws), J(bs), J(wp), J(bp), jnp.asarray(err), JD.FeatX(Jb(xT)),
      jnp.asarray(targets), J(mw), J(mb), jnp.asarray(JP.param_counts(arch), jnp.float32),
      jnp.ones(G), None, None, None)
    fold = TH.make_transition_batch(model_type, act, port(cfg))
    x = TD.FeatX(Tb(xT))
    tws, tbs = T(ws), T(bs)
    tp = fold(tws, tbs, T(wp), T(bp), T(err), x, T(targets), T(tuple(mw)), T(tuple(mb)),
              (T(tuple(p_w)), T(tuple(p_b))))
    np.testing.assert_array_equal(tp.dead.numpy(), np.asarray(jp.dead))
    for t, j in zip(tp.weights + tp.biases, tuple(jp.weights) + tuple(jp.biases)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-6)
    for f in ("y_pred_prop", "y_pred0", "prior_prop", "prior0", "kin_prop", "kin0"):
        np.testing.assert_allclose(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)),
                                   rtol=1e-4, atol=1e-5)

    # the sweep's snapshot is the JAX package's D.predict (W0 rounded), not
    # the transition's operator: the two differ, so the fold makes its own
    # initial value pass on a bf16 FeatX
    assert not TD.same_operator(x) and TD.same_operator(TD.FeatX(Tb(xT).float()))
    snap = TD.snapshot_chains(act, tws, tbs, x)
    jsnap = jax.vmap(jax.vmap(lambda w, b, xg: JD.predict(act, w, b, JD.FeatX(xg)),
                              in_axes=(0, 0, 0)), in_axes=(0, 0, None))(J(ws), J(bs), Jb(xT))
    np.testing.assert_allclose(snap.numpy(), np.asarray(jsnap), rtol=1e-5, atol=1e-5)
    assert (snap - tp.y_pred0).abs().max() > 1e-4
    ix = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    flat = tuple(t.reshape((C * G,) + t.shape[2:]) for t in tws)
    flatb = tuple(t.reshape((C * G,) + t.shape[2:]) for t in tbs)
    def each():  # predict on each (chain, branch) instance's branch ix of x
        return torch.stack([TD.predict(act, tuple(w[i] for w in flat),
                                       tuple(b[i] for b in flatb), x[int(ix[i])])
                            for i in range(C * G)])

    # unfolded (ix): K8's forward on predict_weights, the same operator
    blocked = TD.snapshot_chains(act, tws, tbs, x, ix=ix)
    assert blocked.shape == (C, G, x.n)
    np.testing.assert_allclose(blocked.reshape(C * G, -1).numpy(), each().numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(blocked.reshape(C * G, -1).numpy(), TBM.forward_blocked(
        act, x.xT, ix, TD.predict_weights(flat, x), flatb).numpy())
    _set("bfloat16")
    np.testing.assert_allclose(TD.snapshot_chains(act, tws, tbs, x).numpy(),
                               TD.predict(act, tws, tbs, x).numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(TD.snapshot_chains(act, tws, tbs, x, ix=ix).reshape(
        C * G, -1).numpy(), each().numpy(), rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------- 6. the CLI


def test_train_new_x_bf16_trains_on_bf16_x_and_jax_reads_the_samples(data, tmp_path,  # noqa: F811
                                                                     monkeypatch):
    import rs_bann_tpu_torch.train as TT

    seen = []
    real = TT.train

    def spy(net, dtr, *a, **k):
        seen.append((dtr.X.xT.dtype, k["test_data"].X.xT.dtype))
        return real(net, dtr, *a, **k)

    monkeypatch.setattr(TT, "train", spy)
    argv = _train_args(data, tmp_path, "--feat-major", "--x-bf16", "--update-mode", "parallel",
                       "--num-chains", "2")
    argv[4:7] = ["ridge_base", "tanh", "1"]
    out = run_cli(*argv, "--fixed-summary-layer-width", "4")
    assert seen == [(torch.bfloat16, torch.bfloat16)]
    run = tmp_path / out.strip().splitlines()[-1].split("/")[-1]
    for c in range(2):
        _predict_matches_jax(data, run / "models" / f"chain{c}",
                             ["1.npz", "2.npz", "3.npz", "4.npz"], packed=False)


@pytest.mark.parametrize("x_bf16", [False, True], ids=["f32", "x-bf16"])
def test_the_cli_asks_the_rules_on_x_s_dtype(data, tmp_path, x_bf16):  # noqa: F811
    """On a (faked) CUDA device the CLI asks K6's and K7's shared-memory
    rules on X's storage dtype: branches of 288 markers at depth 2 and width
    56 fit a bf16 X tile and are refused on f32 X."""
    from rs_bann_tpu_torch.cli import main as cli_main
    from rs_bann_tpu_torch.cli.args import mcmc_cfg_from_args
    from rs_bann_tpu_torch.models import NetArch as TNetArch

    argv = _train_args(data, tmp_path, "--feat-major", "--update-mode", "parallel",
                       "--num-chains", "2", *(["--x-bf16"] if x_bf16 else []))
    args = cli_main.build_parser().parse_args([str(a) for a in argv])
    cfg = mcmc_cfg_from_args(args, str(tmp_path))
    arch = TNetArch.from_width_rules([288] * 4, 2, ("fixed", 56), ("fixed", 56),
                                     activation="tanh")
    bad = cli_main._beyond_kernels(args, cfg, arch, torch.device("cuda"))
    assert (bad == []) == x_bf16
