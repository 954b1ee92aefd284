"""The port's dense per-step value and gradient (K8a, K8b) and the paths that
run it, against the JAX package, in three parts.

1. ``data_vg_ref`` (the plain version of K8a) against JAX's ``data_vg``
   unvmapped, and ``data_vg_blocked_ref`` (K8b's) against ``jax.vmap`` of it,
   which its custom_vmap rule sends to the branch-blocked kernel; JAX's
   Pallas kernels in interpret mode. Tolerances: y_pred and rss rtol 1e-5,
   atol 2e-5; every gradient within 1e-4 of its largest entry (sums over n
   in another order).
2. The batched lean body (``make_lean_batch``, one K8b call per gradient
   for every instance) against the per-(chain, branch) loop of
   ``make_hmc_step(defer_accept=True)`` it replaces, on the same draws: one
   transition, and three sweeps of ``make_hybrid_sweep(fold=False)`` on a
   shared and on a per-chain permutation, rtol 1e-4 (the batched and the
   single matmuls sum in another order, compounded over L steps).
3. An ensemble of independent sequential chains on feature-major X, port
   (K8a's plain version per leapfrog step) against JAX, held by the paired
   4-SE bound of tests/test_torch_slice.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_bann_tpu.io.genotypes import CompressedGenotypes as JCompressedGenotypes
from rs_bann_tpu.models import density as JD
from rs_bann_tpu.models import init as JI
from rs_bann_tpu.models import net as JN
from rs_bann_tpu.models.arch import NetArch
from rs_bann_tpu.ops import branch_mlp as JBM
from rs_bann_tpu.samplers.mcmc_cfg import MCMCCfg
from rs_bann_tpu.train import prepare_state_for_training as j_prepare
from rs_bann_tpu_torch.models import density as TD
from rs_bann_tpu_torch.models import net as TN
from rs_bann_tpu_torch.models import params as TP
from rs_bann_tpu_torch.ops import branch_mlp as TBM
from rs_bann_tpu_torch.samplers import hmc as TH
from rs_bann_tpu_torch.train import prepare_state_for_training
from test_torch_copies import port

from test_torch_dense_chains import _feat_data
from test_torch_slice import HYPER

M, M_PAD = 20, 24


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def interpret():
    JBM.FORCE = "interpret"
    try:
        yield
    finally:
        JBM.FORCE = None


def _branches(rng, lead, depth):
    """Weights and biases of branches of the given depth with leading axes
    ``lead`` (widths <= 16)."""
    widths = [M_PAD, 16] + [8] * depth + [1]
    ws = tuple((rng.standard_normal(lead + (widths[i], widths[i + 1])) * 0.3).astype(np.float32)
               for i in range(len(widths) - 1))
    bs = tuple((rng.standard_normal(lead + (widths[i + 1],)) * 0.1).astype(np.float32)
               for i in range(len(widths) - 2))
    return ws, bs


def _x(rng, lead, n):
    """Feature-major X [..., M_PAD, n]; the padded marker rows are zero."""
    x = np.zeros(lead + (M_PAD, n), np.float32)
    x[..., :M, :] = rng.standard_normal(lead + (M, n))
    return x


def _close_outputs(t, j):
    ty, trss, tdws, tdbs = t
    jy, jrss, jdws, jdbs = j
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(trss.numpy(), np.asarray(jrss), rtol=1e-5, atol=2e-5)
    assert len(tdws) == len(jdws) and len(tdbs) == len(jdbs)
    for a, b in zip(tdws + tdbs, tuple(jdws) + tuple(jdbs)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4 * float(np.abs(np.asarray(b)).max()))


# ----------------------------------------------- 1. the plain versions


@pytest.mark.parametrize("act,depth", [(a, d) for d in (0, 1) for a in TBM.SUPPORTED_ACTIVATIONS]
                         + [("tanh", 2)])
def test_data_vg_ref_matches_jax(interpret, act, depth):
    """K8a: one branch, n = 300 at depth 0 and 384 above (a ragged last
    tile and an exact one); the depth-2 case holds the plain version alone
    (the kernel takes depth 0 and 1)."""
    n = 300 if depth == 0 else 384
    rng = np.random.default_rng(depth * 10 + len(act))
    ws, bs = _branches(rng, (), depth)
    xT, target = _x(rng, (), n), rng.standard_normal(n).astype(np.float32)
    jout = JBM.data_vg(act, jnp.asarray(xT), tuple(map(jnp.asarray, ws)),
                       tuple(map(jnp.asarray, bs)), jnp.asarray(target))
    tout = TBM.data_vg(act, T(xT), tuple(map(T, ws)), tuple(map(T, bs)), T(target))
    _close_outputs(tout, jout)
    assert tout[2][-1].shape == (ws[-1].shape[0], 1)  # the output layer's own orientation
    # padded marker rows get exactly zero gradient, so they never move
    assert np.all(tout[2][0].numpy()[M:] == 0)


@pytest.mark.parametrize("nb,act,depth,n", [(4, "tanh", 1, 300), (8, "relu", 0, 384),
                                            (8, "silu", 1, 300)])
def test_data_vg_blocked_ref_matches_jax_vmap(interpret, nb, act, depth, n):
    """K8b: nb instances, instance i on X[ix[i]] with a non-identity ix
    (repeats included) into X of 6 branches, against jax.vmap(data_vg) on
    the gathered X."""
    rng = np.random.default_rng(nb + depth)
    ws, bs = _branches(rng, (nb,), depth)
    X = _x(rng, (6,), n)
    ix = rng.integers(0, 6, nb).astype(np.int32)
    assert not np.array_equal(ix, np.arange(nb))
    targets = rng.standard_normal((nb, n)).astype(np.float32)
    jout = jax.vmap(lambda x, w, b, t: JBM.data_vg(act, x, w, b, t))(
        jnp.asarray(X[ix]), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)),
        jnp.asarray(targets))
    args = (T(X), T(ix), tuple(map(T, ws)), tuple(map(T, bs)))
    tout = TBM.data_vg_blocked(act, *args, T(targets))
    _close_outputs(tout, jout)
    np.testing.assert_array_equal(TBM.forward_blocked(act, *args).numpy(), tout[0].numpy())


# ----------------------------------- 2. the batched lean body == the loop


def _loop_lean(model_type, act, cfg):
    """The per-(chain, branch) loop the batched lean body replaces:
    make_hmc_step(defer_accept=True) instance by instance on FeatX
    x[ix[i]], with make_lean_batch's signature."""
    step = TH.make_hmc_step(model_type, act, cfg, defer_accept=True)

    def lean(gen, weights, biases, w_prec, b_prec, err_prec, x, ix, targets, masks_w, masks_b,
             n_params, momenta, step_factor=None, mass_w=None, mass_b=None, row_pins=None):
        props = []
        for i in range(ix.shape[0]):
            def one(ts):
                return None if ts is None else tuple(t[i] for t in ts)

            props.append(step(gen, one(weights), one(biases), one(w_prec), one(b_prec),
                              err_prec[i], x[int(ix[i])], targets[i], one(masks_w),
                              one(masks_b), n_params[i],
                              momenta=(one(momenta[0]), one(momenta[1])),
                              step_factor=None if step_factor is None else step_factor[i],
                              mass_w=one(mass_w), mass_b=one(mass_b),
                              row_pins=None if row_pins is None else row_pins[i]))
        return TH.HMCProposal(
            tuple(torch.stack(t) for t in zip(*(p.weights for p in props))),
            tuple(torch.stack(t) for t in zip(*(p.biases for p in props))),
            *(torch.stack([p[f] for p in props]) for f in range(2, len(TH.HMCProposal._fields))))

    return lean


def _close(a, b, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("mode,factor", [("izmailov", 0.5), ("random", 0.05)])
def test_lean_batch_equals_the_per_instance_loop(mode, factor):
    """One block transition of 6 instances on 4 branches (repeats in ix),
    ridge_ard tanh depth 1; the random step-size mode draws instance by
    instance in both."""
    rng = np.random.default_rng(11)
    NB, G, n = 6, 4, 300
    arch = NetArch.uniform(G, M, 6, 1, 5, activation="tanh")
    state, _ = JI.init_net(arch, "ridge_ard", JI.InitCfg(seed=3))
    ix = np.array([2, 0, 3, 3, 1, 0])

    def inst(tree, sd=0.0):
        return tuple(T(np.asarray(a)[ix] * (1.0 + sd * rng.standard_normal(
            (NB,) + np.asarray(a).shape[1:])).astype(np.float32)) for a in tree)

    ws, bs = inst(state.params.weights, 0.2), inst(state.params.biases, 0.2)
    wp, bp = inst(state.precisions.weights), inst(state.precisions.biases)
    mw, mb = inst(TP.weight_masks(port(arch), "cpu")), inst(TP.bias_masks(port(arch), "cpu"))
    n_params = T(np.asarray(TP.param_counts(port(arch)), np.float32)[ix])
    x = TD.FeatX(T(_x(rng, (G,), n)))
    targets = T(rng.standard_normal((NB, n)).astype(np.float32))
    err = T(rng.uniform(0.5, 1.5, NB).astype(np.float32))
    momenta = (tuple(torch.randn(w.shape, generator=torch.Generator().manual_seed(1))
                     for w in ws),
               tuple(torch.randn(b.shape, generator=torch.Generator().manual_seed(2))
                     for b in bs))
    cfg = port(MCMCCfg(hmc_integration_length=4, hmc_step_size_mode=mode,
                       hmc_step_size_factor=factor))
    props = []
    for make in (TH.make_lean_batch, _loop_lean):
        props.append(make("ridge_ard", "tanh", cfg)(
            torch.Generator().manual_seed(5), ws, bs, wp, bp, err, x, T(ix.astype(np.int32)),
            targets, mw, mb, n_params, momenta))
    batch, loop = props
    np.testing.assert_array_equal(batch.dead.numpy(), loop.dead.numpy())
    assert not bool(batch.dead.all())
    for a, b in zip(batch.weights + batch.biases, loop.weights + loop.biases):
        _close(a, b, atol=1e-6)
    for f in ("y_pred_prop", "y_pred0", "prior_prop", "prior0", "kin_prop", "kin0"):
        _close(getattr(batch, f), getattr(loop, f))


@pytest.mark.parametrize("shared", [True, False], ids=["shared perm", "per-chain perm"])
def test_unfolded_hybrid_sweep_batched_equals_the_loop(monkeypatch, shared):
    """Three sweeps of the unfolded hybrid sweep on a FeatX (C = 2, blocks of
    2 of G = 4), the batched lean body against the per-(chain, branch) loop,
    from one generator state: the same accept counts, and the state and the
    residual within rtol 1e-4. The batched sweep makes L + 2 K8b calls and
    one forward-only K8 call per block."""
    C, G, m, n, L = 2, 4, 8, 300, 4
    arch = NetArch.uniform(G, m, 4, 1, 4, activation="tanh")
    jstate, _ = JI.init_net(arch, "ridge_base", JI.InitCfg(seed=0))
    *_, td = _feat_data(G, m, n, 4, arch)
    cfg = port(MCMCCfg(hmc_integration_length=L, update_mode="hybrid", block_size=2,
                       num_chains=C, seed=0, hybrid_shared_perm=shared))
    calls = {"data_vg_blocked": 0, "forward_blocked": 0}
    for name, module in (("data_vg_blocked", TBM), ("forward_blocked", TD)):
        def counted(*a, _fn=getattr(module, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(module, name, counted)
    runs = []
    for make in (TH.make_lean_batch, _loop_lean):
        monkeypatch.setattr(TN, "make_lean_batch", make)
        net = prepare_state_for_training(TN.Net(
            "ridge_base", port(arch), TD.Hyperparameters(*HYPER),
            TP.state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")), None)
        sweep = TN.make_hybrid_sweep("ridge_base", "tanh", port(arch), cfg, net.hyper, "cpu",
                                     fold=False)
        carry = net.init_carry(td.X, td.y, chains=C)
        gen = torch.Generator().manual_seed(1)
        for _ in range(3):
            carry, st = sweep(carry, td.X, td.y, gen)
        runs.append((carry, st, dict(calls)))
    (cb, sb, nb), (cl, sl, nl) = runs
    assert nb == {"data_vg_blocked": 3 * (G // 2) * (L + 2), "forward_blocked": 3 * (G // 2)}
    assert nl["data_vg_blocked"] == nb["data_vg_blocked"]  # the loop calls K8a instead
    assert torch.equal(sb.counts, sl.counts) and int(sb.counts[:, 0].sum()) > 0
    _close(cb.residual, cl.residual)
    for a, b in zip(TP.state_leaves(cb.state), TP.state_leaves(cl.state)):
        _close(a, b)


# ---------------------------------------------- 3. sequential posteriors


def test_sequential_feat_major_chains_posterior_matches_jax(monkeypatch):
    """Posterior means of the error precision and the train mse after
    burn-in, port vs JAX, sequential schedule on feature-major X (ridge_base,
    tanh, depth 1): R independent chains per package from one initial state
    (the port's as one run of R chains, chain after chain; JAX's under a
    chain vmap), each summarized by its mean over sweeps burn+1..T. Bound:
    |mean_port - mean_jax| <= 4 * sqrt(var_port / R + var_jax / R), the
    exact standard error of the difference of independent chain summaries
    (normal two-sided tail 6e-5). Each port branch update takes L + 1 K8a
    calls."""
    G, m, n, L, R, burn, T_ = 2, 10, 700, 4, 20, 3, 8
    arch = NetArch.from_width_rules([m] * G, 1, ("fixed", 4), ("fixed", 4), activation="tanh")
    cfg = MCMCCfg(hmc_integration_length=L, hmc_step_size_factor=0.5, chain_length=T_)
    jstate, _ = JI.init_net(arch, "ridge_base", JI.InitCfg(seed=1))
    bed, grouping, y, td = _feat_data(G, m, n, 8, arch)

    jnet = j_prepare(JN.Net("ridge_base", arch, JD.Hyperparameters(*HYPER), jstate), None)
    jd = JCompressedGenotypes(bed, grouping).to_feature_major(arch, y)
    jsweep = jax.jit(jax.vmap(jnet.make_sweep(cfg), in_axes=(0, None, None)))
    carry = jax.jit(jax.vmap(lambda k: jnet.init_carry(jd.X, jd.y, k)))(
        jax.random.split(jax.random.key(0), R))
    carry = jax.tree.map(lambda a: jnp.asarray(a, a.dtype), carry)
    j_err, j_mse = [], []
    for _ in range(T_):
        carry, st = jsweep(carry, jd.X, jd.y)
        j_err.append(np.asarray(carry.state.precisions.error))
        j_mse.append(np.asarray(st.mse_train))

    calls = [0]
    data_vg = TBM.data_vg

    def counted(*a, **kw):
        calls[0] += 1
        return data_vg(*a, **kw)

    monkeypatch.setattr(TBM, "data_vg", counted)
    tnet = prepare_state_for_training(TN.Net(
        "ridge_base", port(arch), TD.Hyperparameters(*HYPER),
        TP.state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")), None)
    tsweep = tnet.make_chain_sweep(dataclasses.replace(port(cfg), num_chains=R))
    tcarry, gen = tnet.init_carry(td.X, td.y, chains=R), torch.Generator().manual_seed(0)
    t_err, t_mse = [], []
    for _ in range(T_):
        tcarry, st = tsweep(tcarry, td.X, td.y, gen)
        t_err.append(tcarry.state.precisions.error.numpy().copy())
        t_mse.append(st.mse_train.numpy())
    assert calls[0] == R * T_ * G * (L + 1)

    counts = st.counts.sum(dim=0)
    assert int(counts[0]) / int(counts.sum()) > 0.2  # the comparison needs moving chains
    for name, t, j in [("error precision", t_err, j_err), ("train mse", t_mse, j_mse)]:
        t = np.asarray(t).T[:, burn:].mean(axis=1)  # [R] chain summaries
        j = np.asarray(j).T[:, burn:].mean(axis=1)
        bound = 4 * np.sqrt(t.var(ddof=1) / R + j.var(ddof=1) / R)
        assert abs(t.mean() - j.mean()) <= bound, (name, t.mean(), j.mean(), bound)
