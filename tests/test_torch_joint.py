"""The port's joint HMC and joint gradient descent against the JAX package.

1. ``D.joint_potential_fn`` (the joint -U over the parameters and the
   precisions) and its autograd gradient in every coordinate against
   ``jax.value_and_grad`` of JAX's, on packed genotypes with padded rows
   (rtol 1e-5; each gradient's entries within 1e-5 of its largest). One
   known difference: JAX's lasso output term sums ``jnp.abs``, whose
   gradient at 0 is 1, so the padded output rows (exactly 0) feel a prior
   force of -lambda_out there; the port's is 0 (sign(0) = 0, as every L1
   term of both packages' marginal densities).
2. One joint HMC transition draw for draw: the test derives JAX's step-size
   uniforms, momenta and accept uniform from its key as
   ``make_hmc_step_joint`` does and hands them to the port. Weights,
   biases, the three precisions, y_pred and log_density within rtol 1e-4
   (each gradient is a sum over n in another order, compounded over L
   steps), the code equal, the accept probability within atol 1e-3.
3. The batched form ([C, B] instances on one block: one forward and one
   backward launch per evaluation) equals each instance on its own (port
   only).
4. Joint gradient descent against JAX's on packed and feature-major
   genotypes, and a run that ends with the error precision below 0, which
   both reject.
5. The sweeps: a hybrid joint sweep keeps residual = y - bias - sum of the
   predictions; after a sequential one every branch holds the output
   precision the last accepted branch left.
6. R4's toy (ROADMAP Queue 3, PARITY.json's joint row at fac = 0.03):
   ensembles of independent short sequential joint chains from one start
   in each package, held by the paired 4-SE bound of
   tests/test_torch_slice.py on the test r2, the acceptance and the mean
   error precision.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_bann_tpu.group.grouping import UniformGrouping
from rs_bann_tpu.io.bed import BedVM, pack_genotypes
from rs_bann_tpu.models import density as JD
from rs_bann_tpu.models import init as JI
from rs_bann_tpu.models import net as JN
from rs_bann_tpu.models import params as JP
from rs_bann_tpu.models.arch import NetArch
from rs_bann_tpu.models.data import pack_stacked as j_pack_stacked
from rs_bann_tpu.samplers import hmc as JH
from rs_bann_tpu.samplers.mcmc_cfg import MCMCCfg
from rs_bann_tpu.train import prepare_state_for_training as j_prepare
from rs_bann_tpu_torch.models import density as TD
from rs_bann_tpu_torch.models import net as TN
from rs_bann_tpu_torch.models import params as TP
from rs_bann_tpu_torch.models.data import pack_stacked as t_pack_stacked
from rs_bann_tpu_torch.samplers import hmc as TH
from rs_bann_tpu_torch.train import prepare_state_for_training
from test_torch_copies import port
from test_torch_hybrid import _packed
from test_torch_slice import HYPER, _toy

N = 700


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small ops per leapfrog step: one intra-op thread keeps the test
    workers from waiting on each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def T(a):
    return torch.from_numpy(np.array(a))


def J(t):
    return tuple(map(jnp.asarray, t))


def _inputs(model_type, act, depth, G=1, seed=4):
    """G packed branches of m = 20 markers (m_pad 24: padded rows), the same
    standardized genotypes feature-major, a state from init_net with
    Gamma(3, 1) initial precisions (biases drawn too), and a target with a
    linear signal. Returns numpy arrays."""
    rng = np.random.default_rng(seed)
    arch = NetArch(m=(20,) * G, h=(6,) * G, s=(5,) * G, depth=depth, activation=act)
    state, _ = JI.init_net(arch, model_type, JI.InitCfg(seed=seed, init_gamma_shape=3.0,
                                                        init_gamma_scale=1.0))
    ws, bs, wp, bp = (tuple(np.asarray(a) for a in t) for t in (
        state.params.weights, state.params.biases, state.precisions.weights,
        state.precisions.biases))
    by, scale, shift = _packed(rng, G, 20, arch.m_pad, N)
    vals = np.stack([_decode(b) for b in by])
    xT = ((vals - shift[..., None]) * scale[..., None]).astype(np.float32)
    y = (np.einsum("gm,gmn->gn", rng.standard_normal((G, arch.m_pad)), xT) * 0.3
         + rng.standard_normal((G, N))).astype(np.float32)
    return arch, ws, bs, wp, bp, (by, scale, shift), xT, y


def _decode(by):
    from rs_bann_tpu_torch.ops.packed_matmul import unpack_strided

    return unpack_strided(T(by), N).numpy()


def _xs(layout, by, scale, shift, xT):
    """(JAX's x, the port's x) of one layout."""
    if layout == "packed":
        return (JD.PackedX(jnp.asarray(by), jnp.asarray(scale), jnp.asarray(shift), N),
                TD.PackedX(T(by), T(scale), T(shift), N))
    return JD.FeatX(jnp.asarray(xT)), TD.FeatX(T(xT))


def _statics(arch, g=0):
    return (JD.slice_branch(JD.branch_statics(arch), g),
            TD.slice_branch(TD.branch_statics(port(arch), "cpu"), g))


def _close(t, j, rtol=1e-4, atol=1e-6):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol)


# ------------------------------------------------- 1. the joint potential


@pytest.mark.parametrize("model_type", ["ridge_base", "ridge_ard", "lasso_ard"])
def test_joint_potential_and_gradient_match_jax(model_type):
    arch, ws, bs, wp, bp, (by, scale, shift), xT, y = _inputs(model_type, "tanh", 1)
    ws, bs, wp, bp = (tuple(a[0] for a in t) for t in (ws, bs, wp, bp))
    jx, tx = _xs("packed", by[0], scale[0], shift[0], xT[0])
    jst, tst = _statics(arch)
    err, rso, n_out = 1.3, 0.7, 15.0
    jf = JD.joint_potential_fn(model_type, "tanh")
    jld, jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2, 3, 4)))(
        J(ws), J(bs), J(wp), J(bp), jnp.asarray(err), jx, jnp.asarray(y[0]),
        JD.Hyperparameters(*HYPER), jst, jnp.asarray(rso), n_out)

    leaves = [T(a).requires_grad_(True) for a in ws + bs + wp + bp + (np.float32(err),)]
    nw, nb = len(ws), len(bs)
    ld, y_pred = TD.joint_potential_fn(model_type, "tanh")(
        leaves[:nw], leaves[nw:nw + nb], leaves[nw + nb:2 * nw + nb], leaves[2 * nw + nb:-1],
        leaves[-1], tx, T(y[0]), TD.Hyperparameters(*HYPER), tst, torch.tensor(rso), n_out)
    grads = torch.autograd.grad(ld, leaves)
    ld = ld.detach()
    assert float(ld) == pytest.approx(float(jld), rel=1e-5)
    _close(y_pred.detach(), JD.predict("tanh", J(ws), J(bs), jx), rtol=1e-5, atol=1e-5)
    want = [np.asarray(a) for a in jax.tree.leaves(jg)]
    assert all(np.all(np.isfinite(g.numpy())) for g in grads)
    for i, (t, j) in enumerate(zip(grads, want)):
        t = t.numpy()
        if model_type.startswith("lasso") and i == nw - 1:
            pad = ws[-1] == 0  # the output layer's padded rows
            assert pad.any()
            lam_out = float(wp[-1].reshape(()))
            np.testing.assert_allclose(j[pad], -lam_out, rtol=1e-6)  # JAX: d|w|/dw = 1 at 0
            assert np.all(t[pad] == 0.0)  # the port: sign(0) = 0
            t, j = t[~pad], j[~pad]
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5 * np.abs(j).max())


# --------------------------------------------- 2. one transition, draw for draw

DRAW_CASES = [
    # layout, model type, activation, depth, factor, sample_shared
    ("packed", "ridge_ard", "identity", 0, 0.003, True),
    ("feat", "ridge_base", "tanh", 1, 0.02, False),
]


def _jax_draws(key, leaves):
    """The step-size uniforms, momenta and accept uniform JAX's
    make_hmc_step_joint derives from ``key``, per leaf in flatten order."""
    k_eps, k_mom, k_acc = jax.random.split(key, 3)
    ek = jax.random.split(k_eps, len(leaves))
    mk = jax.random.split(k_mom, len(leaves))
    eps_u = [T(jax.random.uniform(k, np.shape(a))) for k, a in zip(ek, leaves)]
    mom = [T(jax.random.normal(k, np.shape(a))) for k, a in zip(mk, leaves)]
    return eps_u, mom, float(jax.random.uniform(k_acc, ()))


@pytest.mark.parametrize("layout,model_type,act,depth,factor,sample", DRAW_CASES,
                         ids=lambda a: str(a))
def test_one_joint_transition_draw_for_draw(layout, model_type, act, depth, factor, sample):
    arch, ws, bs, wp, bp, (by, scale, shift), xT, y = _inputs(model_type, act, depth)
    ws, bs, wp, bp = (tuple(a[0] for a in t) for t in (ws, bs, wp, bp))
    jx, tx = _xs(layout, by[0], scale[0], shift[0], xT[0])
    jst, tst = _statics(arch)
    cfg = MCMCCfg(hmc_integration_length=8, hmc_step_size_factor=factor,
                  hmc_step_size_mode="random", joint_hmc=True)
    mw = tuple(m[0] for m in JP.weight_masks(arch))
    mb = tuple(m[0] for m in JP.bias_masks(arch))
    n_params, n_prec = float(arch.num_params_branch(0)), float(1 + 2 * (arch.num_layers - 1) + 1)
    err, rso, n_out = 1.3, 0.7, 15.0
    key = jax.random.key(9)
    eps_u, mom, u = _jax_draws(key, ws + bs + wp + bp + (np.float32(err),))

    jres, jwp, jbp, jep = jax.jit(JH.make_hmc_step_joint(model_type, act, cfg, sample, sample))(
        key, J(ws), J(bs), J(wp), J(bp), jnp.asarray(err), jx, jnp.asarray(y[0]), J(mw), J(mb),
        jnp.asarray(n_params), jnp.asarray(n_prec), JD.Hyperparameters(*HYPER), jst,
        jnp.asarray(rso), n_out)
    out = TH.make_hmc_step_joint(model_type, act, port(cfg), sample)(
        None, *(tuple(map(T, t)) for t in (ws, bs, wp, bp)), torch.tensor(err), tx, T(y[0]),
        tuple(map(T, mw)), tuple(map(T, mb)), torch.tensor(n_params), n_prec,
        TD.Hyperparameters(*HYPER), tst, torch.tensor(rso), n_out, eps_u=eps_u, momenta=mom, u=u)
    tres = out.result
    assert int(tres.code) == int(jres.code)
    ours = tres.weights + tres.biases + out.w_prec + out.b_prec + (out.err_prec,)
    theirs = tuple(jres.weights) + tuple(jres.biases) + tuple(jwp) + tuple(jbp) + (jep,)
    for t, j in zip(ours, theirs):
        _close(t, j)
    _close(tres.y_pred, jres.y_pred, atol=1e-5)
    np.testing.assert_allclose(float(tres.log_density), float(jres.log_density), rtol=1e-4)
    np.testing.assert_allclose(float(tres.accept_prob), float(jres.accept_prob), atol=1e-3)
    # the start's prediction, the sweeps' snapshot
    _close(out.y_pred0, JD.predict(act, J(ws), J(bs), jx), rtol=1e-5, atol=1e-5)
    if not sample:  # the frozen shared scalars are left exactly as they were
        assert float(out.err_prec) == np.float32(err)
        assert torch.equal(out.w_prec[-1], T(wp[-1]))


# ------------------------------------ 3. a [C, B] block equals its instances


@pytest.mark.parametrize("layout,act,depth", [("packed", "identity", 0), ("packed", "silu", 0),
                                              ("packed-own", "identity", 0),
                                              ("feat", "tanh", 1)])
def test_batched_block_equals_instance_by_instance(layout, act, depth):
    """C = 2 chains x B = 3 branches in one call (on packed genotypes the
    chains side by side in one forward launch per evaluation; at depth 0 on
    the live width, as the hybrid sweep calls it; ``packed-own``: each
    chain its own block of branches, the [C, B] instances flattened onto
    the blocks gathered into one of C * B branches, as the hybrid sweep
    calls it with --per-chain-block-perm) against each instance alone, with
    the same draws and the shared scalars frozen."""
    C, B = 2, 3
    arch, ws, bs, wp, bp, (by, scale, shift), xT, y = _inputs("ridge_ard", act, depth, G=B,
                                                                seed=6)
    gen = torch.Generator().manual_seed(1)
    own = layout == "packed-own"
    gix = torch.tensor([[0, 1, 2], [2, 0, 1]]) if own else torch.arange(B).expand(C, B)

    def chains(t):  # [B, ...] -> [C, B, ...], each chain a little apart
        t = T(t)
        return torch.stack([t * (1.0 + 0.01 * c) for c in range(C)])

    ws, bs, wp, bp = (tuple(map(chains, t)) for t in (ws, bs, wp, bp))
    _, tx = _xs(layout.split("-")[0], by, scale, shift, xT)
    tst = TD.branch_statics(port(arch), "cpu")
    mw, mb = TP.weight_masks(port(arch), "cpu"), TP.bias_masks(port(arch), "cpu")
    n_params = TD.branch_statics(port(arch), "cpu").n_params
    err = torch.tensor([[1.1], [1.4]]).expand(C, B)
    rso, n_out = torch.full((C, B), 0.7), 15.0
    cfg = port(MCMCCfg(hmc_integration_length=6, hmc_step_size_factor=0.02,
                       hmc_step_size_mode="random", joint_hmc=True))
    leaves = ws + bs + wp + bp + (err,)
    eps_u = [torch.rand(t.shape, generator=gen) for t in leaves]
    mom = [torch.randn(t.shape, generator=gen) for t in leaves]
    u = torch.rand((C, B), generator=gen)
    resid = T(y)[gix] * 0.5  # [C, B, n]: each instance's residual
    k_live = 5 if depth == 0 else None
    step = TH.make_hmc_step_joint("ridge_ard", act, cfg, False, k_live=k_live)
    args = (ws, bs, wp, bp, err, resid, mw, mb, n_params, tst, rso, eps_u, mom, u)
    if own:  # every per-branch input at its instance's branch, then [C, B] -> [C * B]
        ws, bs, wp, bp, err, resid, mw, mb, n_params, tst, rso, eps_u, mom, u = TN._map(
            lambda t: t.reshape((C * B,) + t.shape[2:]),
            args[:6] + TN._map(lambda t: t[gix], args[6:10]) + args[10:])
    blk = step(None, ws, bs, wp, bp, err, tx[gix.reshape(-1)] if own else tx, resid, mw, mb,
               n_params, 4.0 + 2 * depth, TD.Hyperparameters(*HYPER), tst, rso, n_out,
               eps_u=eps_u, momenta=mom, u=u, residual=True)
    if own:
        blk = TN._map(lambda t: t.reshape((C, B) + t.shape[1:]), blk)
    ws, bs, wp, bp, err, resid, mw, mb, n_params, tst, rso, eps_u, mom, u = args
    one_step = TH.make_hmc_step_joint("ridge_ard", act, cfg, False)
    codes = []
    for c in range(C):
        for j in range(B):
            g = int(gix[c, j])

            def one(ts):
                return tuple(t[c, j] for t in ts)

            out = one_step(None, one(ws), one(bs), one(wp), one(bp), err[c, j], tx[g],
                           resid[c, j], tuple(t[g] for t in mw), tuple(t[g] for t in mb),
                           n_params[g], 4.0 + 2 * depth,
                           TD.Hyperparameters(*HYPER), TD.slice_branch(tst, g), rso[c, j], n_out,
                           eps_u=[e[c, j] for e in eps_u], momenta=[p[c, j] for p in mom],
                           u=u[c, j], residual=True)
            codes.append(int(out.result.code))
            assert int(blk.result.code[c, j]) == codes[-1]
            for a, b in zip(blk.result.weights + blk.result.biases + blk.w_prec + blk.b_prec,
                            out.result.weights + out.result.biases + out.w_prec + out.b_prec):
                _close(a[c, j], b, rtol=1e-5, atol=1e-6)
            for a, b in ((blk.result.y_pred, out.result.y_pred), (blk.y_pred0, out.y_pred0)):
                _close(a[c, j], b, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(float(blk.result.accept_prob[c, j]),
                                       float(out.result.accept_prob), atol=1e-4)
    assert TH.ACCEPTED in codes  # the comparison needs moving instances


# -------------------------------------------------------- 4. joint GD


@pytest.mark.parametrize("layout,act,depth", [("packed", "identity", 0), ("feat", "tanh", 1)])
def test_joint_gradient_descent_matches_jax(layout, act, depth):
    """The descent, then (packed) the same call from an error precision
    whose gradient sends it below 0 in L steps: both packages reject and
    keep the start state."""
    arch, ws, bs, wp, bp, (by, scale, shift), xT, y = _inputs("ridge_ard", act, depth)
    ws, bs, wp, bp = (tuple(a[0] for a in t) for t in (ws, bs, wp, bp))
    jx, tx = _xs(layout, by[0], scale[0], shift[0], xT[0])
    jst, tst = _statics(arch)
    cfg = MCMCCfg(hmc_integration_length=5, hmc_step_size_factor=1e-4,
                  gradient_descent_joint=True)
    mw = tuple(m[0] for m in JP.weight_masks(arch))
    mb = tuple(m[0] for m in JP.bias_masks(arch))
    n_params, n_prec = float(arch.num_params_branch(0)), float(1 + 2 * (arch.num_layers - 1) + 1)
    rso, n_out = 0.7, 15.0
    jgd = jax.jit(JH.make_gradient_descent_joint("ridge_ard", act, cfg))
    tgd = TH.make_gradient_descent_joint("ridge_ard", act, port(cfg))
    for err, want in ((1.3, TH.ACCEPTED), (60.0, TH.REJECTED)) if layout == "packed" else \
            ((1.3, TH.ACCEPTED),):
        jres, jwp, jbp, jep = jgd(
            jax.random.key(0), J(ws), J(bs), J(wp), J(bp), jnp.asarray(err), jx,
            jnp.asarray(y[0]), J(mw), J(mb), jnp.asarray(n_params), jnp.asarray(n_prec),
            JD.Hyperparameters(*HYPER), jst, jnp.asarray(rso), n_out)
        out = tgd(None, *(tuple(map(T, t)) for t in (ws, bs, wp, bp)), torch.tensor(err), tx,
                  T(y[0]), tuple(map(T, mw)), tuple(map(T, mb)), torch.tensor(n_params), n_prec,
                  TD.Hyperparameters(*HYPER), tst, torch.tensor(rso), n_out)
        tres = out.result
        assert int(tres.code) == int(jres.code) == want
        assert float(tres.accept_prob) == float(jres.accept_prob)
        ours = tres.weights + tres.biases + out.w_prec + out.b_prec + (out.err_prec,)
        theirs = tuple(jres.weights) + tuple(jres.biases) + tuple(jwp) + tuple(jbp) + (jep,)
        for t, j in zip(ours, theirs):
            _close(t, j)
        _close(tres.y_pred, jres.y_pred, atol=1e-5)
        np.testing.assert_allclose(float(tres.log_density), float(jres.log_density), rtol=1e-4)
        if want == TH.REJECTED:  # the start state, untouched
            for t, a in zip(ours, ws + bs + wp + bp + (np.float32(err),)):
                assert torch.equal(t, T(a))


# -------------------------------------------------------- 5. the sweeps


def _toy_net(model_type, act, depth, G=3, m=10):
    arch = NetArch.from_width_rules([m] * G, depth, ("fixed", 6), ("fixed", 5), activation=act)
    state, _ = JI.init_net(arch, model_type, JI.InitCfg(seed=3, init_gamma_shape=3.0,
                                                        init_gamma_scale=1.0))
    tnet = TN.Net(model_type, port(arch), TD.Hyperparameters(*HYPER),
                  TP.state_from_numpy(jax.tree.map(np.asarray, state), "cpu"))
    return arch, state, prepare_state_for_training(tnet, None)


@pytest.mark.parametrize("mode", ["hybrid", "hybrid-own-blocks", "parallel", "sequential"])
def test_joint_sweeps_keep_the_residual(mode):
    """One joint sweep of C = 2 chains (hybrid in blocks of one branch,
    shared by the chains or each chain's own, parallel, or sequential chain
    after chain): the carried residual stays y - bias - sum of the
    predictions. Sequentially every branch then holds one output
    precision, the one the last accepted branch left (a Gibbs draw per
    block otherwise)."""
    arch, _, tnet = _toy_net("ridge_ard", "tanh", 1)
    bed, grouping, y = _toy(3, 10, N, seed=5)
    data = t_pack_stacked(port(arch), bed, grouping, y, "cpu")
    hybrid = mode.startswith("hybrid")
    cfg = port(MCMCCfg(update_mode=mode.split("-")[0], block_size=1 if hybrid else 0,
                       hybrid_shared_perm=mode == "hybrid", num_chains=2, seed=2,
                       hmc_integration_length=4, hmc_step_size_factor=0.003,
                       hmc_step_size_mode="random", joint_hmc=True))
    sweep = tnet.make_chain_sweep(cfg)
    carry = tnet.init_carry(data.X, data.y, chains=2)
    start = [t.clone() for t in (carry.state.precisions.weights[0], carry.state.precisions.error)]
    carry, st = sweep(carry, data.X, data.y, torch.Generator().manual_seed(0))
    assert int(st.counts.sum()) == 2 * 3 and int(st.counts[:, 0].sum()) > 0
    for c in range(2):
        s = TN.P.map_state(lambda a: a[c], carry.state)
        want = data.y - tnet.predict(data.X, s)
        _close(carry.residual[c], want, rtol=1e-4, atol=1e-4)
    lam_out = carry.state.precisions.weights[-1]
    assert torch.all(lam_out == lam_out[:, :1])  # one output precision per chain
    assert not torch.equal(carry.state.precisions.weights[0], start[0])  # the transitions moved
    if mode == "sequential":  # ... the error precision too
        assert not torch.equal(carry.state.precisions.error, start[1])
    assert all(torch.isfinite(t).all() for t in TN._carry_tensors(carry) if t.is_floating_point())


def test_joint_gd_refuses_other_schedules():
    arch, _, tnet = _toy_net("ridge_ard", "identity", 0)
    for mode in ("hybrid", "parallel"):
        with pytest.raises(NotImplementedError, match="requires sequential mode"):
            tnet.make_chain_sweep(port(MCMCCfg(update_mode=mode, gradient_descent_joint=True)))


# ------------------------------------------------------- 6. R4's toy


def test_r4_toy_joint_ensemble_matches_jax():
    """PARITY.json's joint row at fac = 0.03 (ridge_base, G = 4, m = 10, n =
    800, h2 = 0.8, depth 0, widths 10/5, random step sizes, sequential
    joint HMC): R chains per package from one start, each summarized by its
    acceptance, the mean error precision over sweeps burn+1..T, and the
    test r2 of its posterior-mean prediction over those sweeps.

    Bound: |mean_port - mean_jax| <= 4 * sqrt(var_port / R + var_jax / R)
    over the R chain summaries (independent chains: the exact standard
    error of the difference; a normal two-sided tail of 6e-5)."""
    G, m, n, n_test, L, R, burn, T_ = 4, 10, 800, 300, 8, 16, 1, 4
    train_bed, test_bed, grouping, y, y_test = _toy_split(G, m, n, n_test, seed=29, h2=0.8)
    arch = NetArch.from_width_rules([m] * G, 0, ("fixed", 10), ("fixed", 5), activation="tanh")
    cfg = MCMCCfg(hmc_integration_length=L, hmc_step_size_factor=0.03, chain_length=T_,
                  hmc_step_size_mode="random", joint_hmc=True)
    jstate, _ = JI.init_net(arch, "ridge_base", JI.InitCfg(seed=1, init_gamma_shape=3.0,
                                                            init_gamma_scale=1.0))

    jnet = j_prepare(JN.Net("ridge_base", arch, JD.Hyperparameters(), jstate), None)
    jd = j_pack_stacked(arch, train_bed, grouping, y)
    jt = j_pack_stacked(arch, test_bed, grouping, y_test)
    jsweep = jax.jit(jax.vmap(jnet.make_sweep(cfg), in_axes=(0, None, None)))
    carry = jax.jit(jax.vmap(lambda k: jnet.init_carry(jd.X, jd.y, k)))(
        jax.random.split(jax.random.key(0), R))
    carry = jax.tree.map(lambda a: jnp.asarray(a, a.dtype), carry)
    jpredict = jax.jit(jax.vmap(lambda s: JN.Net("ridge_base", arch, jnet.hyper, s).predict(jt.X)))
    j_err, j_pred = [], []
    for _ in range(T_):
        carry, st = jsweep(carry, jd.X, jd.y)
        j_err.append(np.asarray(carry.state.precisions.error))
        j_pred.append(np.asarray(jpredict(carry.state)))
    j_counts = np.asarray(st.counts)

    td = t_pack_stacked(port(arch), train_bed, grouping, y, "cpu")
    tt = t_pack_stacked(port(arch), test_bed, grouping, y_test, "cpu")
    tnet = prepare_state_for_training(TN.Net(
        "ridge_base", port(arch), TD.Hyperparameters(),
        TP.state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")), None)
    tsweep = tnet.make_chain_sweep(dataclasses.replace(port(cfg), num_chains=R))
    tcarry, gen = tnet.init_carry(td.X, td.y, chains=R), torch.Generator().manual_seed(0)
    t_err, t_pred = [], []
    for _ in range(T_):
        tcarry, st = tsweep(tcarry, td.X, td.y, gen)
        t_err.append(tcarry.state.precisions.error.numpy().copy())
        t_pred.append(np.stack([
            tnet.predict(tt.X, TN.P.map_state(lambda a: a[c], tcarry.state)).numpy()
            for c in range(R)]))
    t_counts = st.counts.numpy()

    def r2(preds):  # [T, R, n_test] -> [R] test r2 of each chain's posterior mean
        pm = np.asarray(preds)[burn:].mean(axis=0)
        return np.array([np.corrcoef(p, y_test)[0, 1] ** 2 for p in pm])

    summaries = {
        "test r2": (r2(t_pred), r2(j_pred)),
        "acceptance": (t_counts[:, 0] / t_counts.sum(axis=1),
                       j_counts[:, 0] / j_counts.sum(axis=1)),
        "mean error precision": (np.asarray(t_err)[burn:].mean(axis=0),
                                 np.asarray(j_err)[burn:].mean(axis=0)),
    }
    assert summaries["acceptance"][0].mean() > 0.2  # the comparison needs moving chains
    for name, (t, j) in summaries.items():
        bound = 4 * np.sqrt(t.var(ddof=1) / R + j.var(ddof=1) / R)
        print(f"R4 toy {name}: port {t.mean():.4f}, JAX {j.mean():.4f}, 4-SE bound {bound:.4f}")
        assert abs(t.mean() - j.mean()) <= bound, (name, t.mean(), j.mean(), bound)


def _toy_split(G, m, n, n_test, seed, h2):
    """A train and a test set of one population (tests/test_torch_slice.py
    ``_toy``'s phenotype model: 30% of the markers causal at heritability
    ``h2``), the phenotype scaled to the training set's unit variance, as
    the simulator's is."""
    full = BedVM.random(n + n_test, G * m, seed=seed)
    vals = full.get_cols(np.arange(G * m))  # [markers, individuals]
    train = BedVM(pack_genotypes(vals[:, :n]), n, G * m)
    test = BedVM(pack_genotypes(vals[:, n:]), n_test, G * m)
    xs = (vals.T - train.col_means) / train.col_stds
    rng = np.random.default_rng(seed)
    beta = rng.standard_normal(G * m) * (rng.random(G * m) < 0.3)
    g = xs @ beta
    y = g + rng.standard_normal(n + n_test) * g[:n].std() * np.sqrt((1 - h2) / h2)
    y = ((y - y[:n].mean()) / y[:n].std()).astype(np.float32)
    return train, test, UniformGrouping(G, m), y[:n], y[n:]
