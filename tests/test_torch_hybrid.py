"""The port's hybrid schedule against the JAX package, in five parts.

1. The lean deferred-accept proposal (``make_hmc_step(defer_accept=True)``)
   draw for draw: JAX's momenta are derived from its key as make_hmc_step
   derives them and handed to the port. rtol 1e-4 (sums over n in another
   order, compounded over L steps); JAX's K4 runs in interpret mode.
2. The folded block transition (``make_transition_batch``) against JAX's
   under a chain vmap, its whole-trajectory kernel in interpret mode, with
   the per-(chain, branch) momenta derived as its chain rule derives them.
   rtol 1e-4, as in part 1.
3. ``_live_accept_select`` against JAX's, given the same proposal, visiting
   order and uniforms (rtol 1e-5: one length-n reduction per branch).
4. The port's folded hybrid sweep (C = 2, plain K5) against its unfolded
   one (each chain and branch on the plain K4), draw for draw over 3 sweeps
   (rtol 2e-4, atol 2e-5: the JAX package's bound for the same twin test,
   tests/test_leapfrog.py).
5. An ensemble of independent hybrid chains, port against JAX, held by the
   paired 4-SE bound of tests/test_torch_slice.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_bann_tpu.models import density as JD
from rs_bann_tpu.models import init as JI
from rs_bann_tpu.models import net as JN
from rs_bann_tpu.models import params as JP
from rs_bann_tpu.models.arch import NetArch
from rs_bann_tpu.models.data import pack_stacked as j_pack_stacked
from rs_bann_tpu.ops import branch_mlp as JBM
from rs_bann_tpu.ops.packed_matmul import pack_strided
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

from test_torch_slice import HYPER, _toy

N = 700


def T(a):
    return torch.from_numpy(np.array(a))


def _packed(rng, G, m, m_pad, n):
    vals = np.zeros((G, m_pad, n), np.float32)
    vals[:, :m] = rng.integers(0, 3, size=(G, m, n))
    by = np.stack([pack_strided(v) for v in vals])
    scale = np.zeros((G, m_pad), np.float32)
    shift = np.zeros((G, m_pad), np.float32)
    scale[:, :m] = 1.0 / vals[:, :m].std(axis=2)
    shift[:, :m] = vals[:, :m].mean(axis=2)
    return by, scale, shift


def _interpret(fn, *args):
    JBM.FORCE = "interpret"
    try:
        return fn(*args)
    finally:
        JBM.FORCE = None


def _close(t, j, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


# --------------------------------------------------- 1. the lean proposal

LEAN_CASES = [
    # model type, activation, depth, step factor, max |dH|
    ("ridge_ard", "identity", 0, 0.05, 10.0),
    ("lasso_base", "tanh", 1, 0.5, 10.0),
    ("lasso_ard", "leaky_relu", 0, 0.05, 10.0),
    ("ridge_base", "relu", 1, 0.5, 1e-3),  # diverges: dead
]


@pytest.mark.parametrize("model_type,act,depth,factor,max_err", LEAN_CASES)
def test_lean_proposal_draw_for_draw(model_type, act, depth, factor, max_err):
    rng = np.random.default_rng(3)
    arch = NetArch(m=(20,), h=(8,), s=(6,), depth=depth, activation=act)
    state, _ = JI.init_net(arch, model_type, JI.InitCfg(seed=4))
    ws, bs, wp, bp = (tuple(np.asarray(a[0]) for a in t) for t in (
        state.params.weights, state.params.biases, state.precisions.weights,
        state.precisions.biases))
    by, scale, shift = (a[0] for a in _packed(rng, 1, 20, arch.m_pad, N))
    y = rng.standard_normal(N).astype(np.float32)
    cfg = MCMCCfg(hmc_integration_length=3, hmc_step_size_factor=factor,
                  hmc_max_hamiltonian_error=max_err)
    mw = tuple(m[0] for m in JP.weight_masks(arch))
    mb = tuple(m[0] for m in JP.bias_masks(arch))
    n_params, err = float(arch.num_params_branch(0)), 1.3

    key = jax.random.key(9)
    _, k_mom, _ = jax.random.split(key, 3)
    mkeys = jax.random.split(k_mom, len(ws) + len(bs))
    p_w = tuple(np.asarray(jax.random.normal(k, w.shape)) for k, w in zip(mkeys, ws))
    p_b = tuple(np.asarray(jax.random.normal(k, b.shape)) for k, b in zip(mkeys[len(ws):], bs))

    J = lambda t: tuple(map(jnp.asarray, t))  # noqa: E731
    jp = _interpret(JH.make_hmc_step(model_type, act, cfg, defer_accept=True), key, J(ws), J(bs),
                    J(wp), J(bp), jnp.asarray(err),
                    JD.PackedX(jnp.asarray(by), jnp.asarray(scale), jnp.asarray(shift), N),
                    jnp.asarray(y), J(mw), J(mb), jnp.asarray(n_params))
    tp = TH.make_hmc_step(model_type, act, port(cfg), defer_accept=True)(
        torch.Generator(), *(tuple(map(T, t)) for t in (ws, bs, wp, bp)), torch.tensor(err),
        TD.PackedX(T(by), T(scale), T(shift), N), T(y), tuple(map(T, mw)), tuple(map(T, mb)),
        torch.tensor(n_params), momenta=(tuple(map(T, p_w)), tuple(map(T, p_b))),
    )
    assert isinstance(tp, TH.HMCProposal)
    assert bool(tp.dead) == bool(jp.dead) == (max_err < 1.0)
    for t, j in zip(tp.weights + tp.biases, tuple(jp.weights) + tuple(jp.biases)):
        _close(t, j, atol=1e-6)
    _close(tp.y_pred_prop, jp.y_pred_prop)
    _close(tp.y_pred0, jp.y_pred0)
    for f in ("prior_prop", "prior0", "kin_prop", "kin0"):
        _close(getattr(tp, f), getattr(jp, f))


# ---------------------------------------- 2. the folded block transition

# depth 1 of the folded path is held by part 4 and tests/test_torch_leapfrog.py
FOLD_CASES = [
    # model type, activation, depth, step-size mode, step factor
    ("ridge_ard", "identity", 0, "izmailov", 0.1),
    ("lasso_ard", "identity", 0, "izmailov", 0.1),
    ("ridge_ard", "identity", 0, "std_scaled", 0.01),
]


def _fold_case(model_type, act, depth, mode, factor, width=6):
    """A block of C = 2 chains x G = 3 branches (width 6 stored at 8 unless
    given), its momenta from JAX's chain rule, and JAX's folded proposals.
    Returns (the port's fold arguments, JAX's proposal, the port's cfg)."""
    rng = np.random.default_rng(5)
    C, G, m = 2, 3, 12
    arch = NetArch.uniform(G, m, width, depth, width, activation=act)
    state, _ = JI.init_net(arch, model_type, JI.InitCfg(seed=2))
    by, scale, shift = _packed(rng, G, m, arch.m_pad, N)

    def chains(tree, sd):  # [G, ...] -> [C, G, ...], each chain perturbed
        return tuple(np.asarray(a)[None] * (1.0 + sd * rng.standard_normal((C,) + a.shape))
                     .astype(np.float32) for a in tree)

    ws, bs = chains(state.params.weights, 0.2), chains(state.params.biases, 0.2)
    wp = chains(state.precisions.weights, 0.1)
    bp = chains(state.precisions.biases, 0.1)
    err = np.array([1.1, 0.7], np.float32)
    targets = rng.standard_normal((C, G, N)).astype(np.float32)
    mw, mb = JP.weight_masks(arch), JP.bias_masks(arch)
    cfg = MCMCCfg(hmc_integration_length=3, hmc_step_size_mode=mode, hmc_step_size_factor=factor,
                  update_mode="hybrid", num_chains=C)

    keys = jax.random.split(jax.random.key(7), C * G).reshape(C, G)
    p_w, p_b = [], []
    for i, w in enumerate(ws):  # the chain rule's per-(g, c) derivation
        def mom(k, i=i, shape=w.shape[2:]):
            _, k_mom, _ = jax.random.split(k, 3)
            return jax.random.normal(jax.random.split(k_mom, len(ws) + len(bs))[i], shape)
        p_w.append(np.asarray(jax.vmap(jax.vmap(mom))(keys)))
    for i, b in enumerate(bs):
        def momb(k, i=i, shape=b.shape[2:]):
            _, k_mom, _ = jax.random.split(k, 3)
            return jax.random.normal(jax.random.split(k_mom, len(ws) + len(bs))[len(ws) + i],
                                     shape)
        p_b.append(np.asarray(jax.vmap(jax.vmap(momb))(keys)))

    J = lambda t: tuple(map(jnp.asarray, t))  # noqa: E731
    jx = JD.PackedX(jnp.asarray(by), jnp.asarray(scale), jnp.asarray(shift), N)
    transition = JH.make_hmc_step(model_type, act, cfg, defer_accept=True)
    batch = JH.make_transition_batch(model_type, act, cfg, transition, lean_ok=True)
    n_params = jnp.asarray(JP.param_counts(arch), jnp.float32)

    def run():
        return jax.vmap(
            batch, in_axes=(0, 0, 0, 0, 0, 0, None, 0, None, None, None, None, None, None, None)
        )(keys, J(ws), J(bs), J(wp), J(bp), jnp.asarray(err), jx, jnp.asarray(targets),
          J(mw), J(mb), n_params, jnp.ones(G), None, None, None)

    fold_args = ((*(tuple(map(T, t)) for t in (ws, bs, wp, bp)), T(err),
                  TD.PackedX(T(by), T(scale), T(shift), N), T(targets), tuple(map(T, mw)),
                  tuple(map(T, mb)), (tuple(map(T, p_w)), tuple(map(T, p_b)))))
    return fold_args, _interpret(run), port(cfg)


@pytest.mark.parametrize("model_type,act,depth,mode,factor", FOLD_CASES)
def test_folded_block_transition_matches_jax_chain_rule(model_type, act, depth, mode, factor):
    fold_args, jp, cfg = _fold_case(model_type, act, depth, mode, factor)
    fold = TH.make_transition_batch(model_type, act, cfg)
    tp = fold(*fold_args)
    np.testing.assert_array_equal(tp.dead.numpy(), np.asarray(jp.dead))
    for t, j in zip(tp.weights + tp.biases, tuple(jp.weights) + tuple(jp.biases)):
        _close(t, j, atol=1e-6)
    for f in ("y_pred_prop", "y_pred0", "prior_prop", "prior0", "kin_prop", "kin0"):
        _close(getattr(tp, f), getattr(jp, f))


@pytest.mark.parametrize("model_type,act,depth,mode,factor", FOLD_CASES[:2])
def test_folded_transition_on_the_live_columns_accepts_alike(model_type, act, depth, mode,
                                                              factor):
    """The value passes cut to the live width (6 of the 8 stored columns):
    the same proposals as the uncut passes and JAX's, and the same accept
    decisions for the same accept draws."""
    fold_args, jp, cfg = _fold_case(model_type, act, depth, mode, factor)
    ws = fold_args[0]
    assert torch.all(ws[0][..., 6:] == 0) and torch.all(ws[1][..., 6:, :] == 0)
    fold = TH.make_transition_batch(model_type, act, cfg)
    full, cut = fold(*fold_args), fold(*fold_args, k_live=6)
    np.testing.assert_array_equal(cut.dead.numpy(), np.asarray(jp.dead))
    for f in ("y_pred_prop", "y_pred0"):
        _close(getattr(cut, f), getattr(full, f), rtol=1e-5, atol=1e-6)
        _close(getattr(cut, f), getattr(jp, f))
    for t, u in zip(cut.weights + cut.biases, full.weights + full.biases):
        assert torch.equal(t, u)  # the trajectory does not see the cut
    gen = torch.Generator().manual_seed(3)
    C, B = cut.dead.shape
    order = torch.argsort(torch.rand((C, B), generator=gen), dim=-1)
    us = torch.rand((C, B), generator=gen)
    err, targets = fold_args[4], fold_args[6]
    residual = targets[:, 0] - full.y_pred0[:, 0]
    res = [TN._live_accept_select(residual, p.y_pred0, p, err, fold_args[0], fold_args[1], order,
                                  us) for p in (full, cut)]
    np.testing.assert_array_equal(res[0].code.numpy(), res[1].code.numpy())


@pytest.mark.parametrize("act", ["identity", "tanh", "silu"])
def test_predict_chains_on_the_live_columns_matches_uncut_and_jax(act):
    """predict_chains with k_live (K2 or K9a on C * k_live columns) against
    the uncut pass and JAX's predict of each chain and branch, at the
    repository's f32 parity tolerance."""
    rng = np.random.default_rng(8)
    C, G, m, width = 3, 2, 20, 6
    arch = NetArch.uniform(G, m, width, 0, width, activation=act)
    state, _ = JI.init_net(arch, "ridge_ard", JI.InitCfg(seed=4))
    by, scale, shift = _packed(rng, G, m, arch.m_pad, N)
    ws = tuple((np.asarray(w)[None] * (1.0 + 0.2 * rng.standard_normal((C,) + w.shape)))
               .astype(np.float32) for w in state.params.weights)
    bs = tuple((np.asarray(b)[None] * (1.0 + 0.2 * rng.standard_normal((C,) + b.shape)))
               .astype(np.float32) for b in state.params.biases)
    assert ws[0].shape[-1] == 8 and not np.any(ws[0][..., width:]) and not np.any(bs[0][..., width:])
    x = TD.PackedX(T(by), T(scale), T(shift), N)
    tw, tb = tuple(map(T, ws)), tuple(map(T, bs))
    full, cut = TD.predict_chains(act, tw, tb, x), TD.predict_chains(act, tw, tb, x, width)
    _close(cut, full.numpy(), rtol=1e-5, atol=1e-6)
    for c in range(C):
        for j in range(G):
            jx = JD.PackedX(jnp.asarray(by[j]), jnp.asarray(scale[j]), jnp.asarray(shift[j]), N)
            want = JD.predict(act, tuple(jnp.asarray(w[c, j]) for w in ws),
                              tuple(jnp.asarray(b[c, j]) for b in bs), jx)
            _close(cut[c, j], want)


# ----------------------------------------------------- 3. the live accept


def _jax_live_accept_select():
    """JAX's _live_accept_select, a closure of its hybrid sweep."""
    arch = NetArch.uniform(2, 4, 2, 0, 2, activation="identity")
    state, _ = JI.init_net(arch, "ridge_ard", JI.InitCfg(seed=0))
    sweep = JN.Net("ridge_ard", arch, JD.Hyperparameters(), state).make_sweep(
        MCMCCfg(update_mode="hybrid"))
    cells = dict(zip(sweep.__code__.co_freevars, (c.cell_contents for c in sweep.__closure__)))
    return cells["_live_accept_select"]


def test_live_accept_select_matches_jax():
    rng = np.random.default_rng(11)
    C, B, n = 2, 5, 60
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    residual = f32(C, n)
    preds = f32(C, B, n)
    ws, bs = (f32(C, B, 4, 3), f32(C, B, 3, 1)), (f32(C, B, 3),)
    prop = dict(
        weights=(f32(C, B, 4, 3), f32(C, B, 3, 1)), biases=(f32(C, B, 3),),
        y_pred_prop=preds + 0.05 * f32(C, B, n), y_pred0=preds + 0.01 * f32(C, B, n),
        prior_prop=f32(C, B), prior0=f32(C, B), kin_prop=np.abs(f32(C, B)) * 2,
        kin0=np.abs(f32(C, B)) * 2, dead=np.zeros((C, B), bool),
    )
    prop["dead"][0, 1] = prop["dead"][1, 3] = True
    err = np.array([1.5, 0.8], np.float32)
    keys = jax.random.split(jax.random.key(3), C)
    jsel = _jax_live_accept_select()
    order, us, jres = [], [], []
    for c in range(C):
        k_ord, k_u = jax.random.split(keys[c])
        order.append(np.asarray(jax.random.permutation(k_ord, B)))
        us.append(np.asarray(jax.random.uniform(k_u, (B,))))
        jprop = JH.HMCProposal(
            **{k: (tuple(jnp.asarray(a[c]) for a in v) if isinstance(v, tuple) else
                   jnp.asarray(v[c])) for k, v in prop.items()},
            uturn_step=jnp.zeros(B, jnp.int32))
        jres.append(jsel(keys[c], jnp.asarray(residual[c]), jnp.asarray(preds[c]), jprop,
                         jnp.asarray(err[c]), tuple(jnp.asarray(a[c]) for a in ws),
                         tuple(jnp.asarray(a[c]) for a in bs)))
    tprop = TH.HMCProposal(**{k: (tuple(map(T, v)) if isinstance(v, tuple) else T(v))
                              for k, v in prop.items()})
    tres = TN._live_accept_select(T(residual), T(preds), tprop, T(err), tuple(map(T, ws)),
                                  tuple(map(T, bs)), T(np.stack(order)), T(np.stack(us)))
    codes = np.stack([np.asarray(r.code) for r in jres])
    np.testing.assert_array_equal(tres.code.numpy(), codes)
    assert {0, 1, 2} <= set(codes.ravel().tolist())  # accepts, rejects and dead ones
    for c in range(C):
        for t, j in zip(tres.weights + tres.biases, tuple(jres[c].weights) + tuple(jres[c].biases)):
            np.testing.assert_array_equal(t[c].numpy(), np.asarray(j))
        _close(tres.y_pred[c], jres[c].y_pred, rtol=1e-5, atol=1e-6)
        _close(tres.accept_prob[c], jres[c].accept_prob, rtol=1e-5, atol=1e-6)


# ------------------------------------------ 4. folded == unfolded, in the port


@pytest.mark.parametrize("model_type,act,depth", [
    ("ridge_ard", "identity", 0), ("lasso_ard", "identity", 0), ("ridge_base", "tanh", 1),
])
def test_folded_hybrid_sweep_matches_unfolded(model_type, act, depth):
    C, G, m = 2, 4, 8
    arch = NetArch.uniform(G, m, 4, depth, 4, activation=act)
    jstate, _ = JI.init_net(arch, model_type, JI.InitCfg(seed=0))
    bed, grouping, y = _toy(G, m, N, seed=4)
    td = t_pack_stacked(port(arch), bed, grouping, y, "cpu")
    cfg = MCMCCfg(hmc_integration_length=4, update_mode="hybrid", block_size=2, num_chains=C,
                  seed=0)
    assert TN.chain_fold_eligible(model_type, act, port(cfg))
    runs = []
    for fold in (True, False):
        net = prepare_state_for_training(TN.Net(
            model_type, port(arch), TD.Hyperparameters(*HYPER),
            TP.state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")), None)
        sweep = TN.make_hybrid_sweep(model_type, act, port(arch), port(cfg), net.hyper, "cpu", fold=fold)
        carry, gen = net.init_carry(td.X, td.y, chains=C), torch.Generator().manual_seed(1)
        for _ in range(3):
            carry, st = sweep(carry, td.X, td.y, gen)
        runs.append((carry, st))
    (cf, sf), (cu, su) = runs
    assert torch.equal(sf.counts, su.counts) and int(sf.counts[:, 0].sum()) > 0
    _close(cf.residual, cu.residual, rtol=2e-4, atol=2e-5)
    for a, b in zip(TP.state_leaves(cf.state), TP.state_leaves(cu.state)):
        _close(a, b, rtol=2e-4, atol=2e-5)


# --------------------------------------------------------- 5. posteriors


def test_hybrid_chains_posterior_matches_jax():
    """Posterior means of the error precision and the train mse after
    burn-in, port vs JAX: R independent hybrid chains per package from one
    initial state (the port's in one folded run of R chains), each chain
    summarized by its mean over sweeps burn+1..T.

    Bound: |mean_port - mean_jax| <= 4 * sqrt(var_port / R + var_jax / R),
    the exact standard error of the difference of independent chain
    summaries (normal two-sided tail 6e-5). One block holds every branch,
    so the block permutation, which the two packages draw from different
    generators, does not change the Markov kernel.
    """
    G, m, n, L, R, burn, T_ = 2, 10, N, 4, 24, 3, 8
    bed, grouping, y = _toy(G, m, n, seed=8)
    arch = NetArch.from_width_rules([m] * G, 0, ("fixed", 4), ("fixed", 4), activation="identity")
    cfg = MCMCCfg(hmc_integration_length=L, hmc_step_size_factor=0.2, chain_length=T_,
                  update_mode="hybrid", block_size=G, num_chains=R)
    jstate, _ = JI.init_net(arch, "ridge_ard", JI.InitCfg(seed=1))

    jnet = j_prepare(JN.Net("ridge_ard", arch, JD.Hyperparameters(*HYPER), jstate), None)
    jd = j_pack_stacked(arch, bed, grouping, y)
    jsweep = jax.jit(jax.vmap(jnet.make_sweep(cfg), in_axes=(0, None, None)))
    carry = jax.jit(jax.vmap(lambda k: jnet.init_carry(jd.X, jd.y, k)))(
        jax.random.split(jax.random.key(0), R))
    carry = jax.tree.map(lambda a: jnp.asarray(a, a.dtype), carry)
    j_err, j_mse = [], []
    for _ in range(T_):
        carry, st = jsweep(carry, jd.X, jd.y)
        j_err.append(np.asarray(carry.state.precisions.error))
        j_mse.append(np.asarray(st.mse_train))

    td = t_pack_stacked(port(arch), bed, grouping, y, "cpu")
    tnet = prepare_state_for_training(TN.Net(
        "ridge_ard", port(arch), TD.Hyperparameters(*HYPER),
        TP.state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")), None)
    tsweep = TN.make_hybrid_sweep("ridge_ard", "identity", port(arch), port(cfg), tnet.hyper, "cpu")
    tcarry, gen = tnet.init_carry(td.X, td.y, chains=R), torch.Generator().manual_seed(0)
    t_err, t_mse = [], []
    for _ in range(T_):
        tcarry, st = tsweep(tcarry, td.X, td.y, gen)
        t_err.append(tcarry.state.precisions.error.numpy().copy())
        t_mse.append(st.mse_train.numpy())

    counts = st.counts.sum(dim=0)
    assert int(counts[0]) / int(counts.sum()) > 0.2  # the comparison needs moving chains
    for name, t, j in [("error precision", t_err, j_err), ("train mse", t_mse, j_mse)]:
        t = np.asarray(t).T[:, burn:].mean(axis=1)  # [R] chain summaries
        j = np.asarray(j).T[:, burn:].mean(axis=1)
        bound = 4 * np.sqrt(t.var(ddof=1) / R + j.var(ddof=1) / R)
        assert abs(t.mean() - j.mean()) <= bound, (name, t.mean(), j.mean(), bound)
