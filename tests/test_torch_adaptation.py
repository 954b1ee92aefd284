"""The port's dual-averaging step sizes and diagonal mass adaptation against
the JAX package, in five parts.

1. The pure pieces: ``_da_update``, ``_welford``, ``_prior_var_trees``,
   ``_mass_std``, ``flatten_wb`` / ``unflatten_wb`` and ``step_sizes`` with
   ``step_factor``, ``mass_w`` and ``mass_b``, batched over [C, G] in the
   port and vmapped per branch in JAX. rtol 1e-6 (atol 1e-6 where a sum
   cancels: the port's clock is a Python number, JAX's an f32 array). The
   initial adaptation state of ``init_carry`` bit for bit.
2. The folded block transition (``make_transition_batch``) with adapted
   factors [C, B] and masses [C, B, ...] passed in, on packed genotypes and
   on a FeatX, against JAX's chain rule under a chain vmap, its
   whole-trajectory kernel in interpret mode, the momenta derived as the
   chain rule derives them. rtol 1e-4, as tests/test_torch_hybrid.py.
3. The sweeps' carry updates, warm and frozen: one sweep of the port's
   hybrid (folded and unfolded) and sequential schedules with the
   adaptation's inputs and updates recorded; JAX's own code of its block
   body (rs_bann_tpu/models/net.py:1985-1989, 2046-2052, 2152-2161,
   2201-2216) and of its branch update (:1091-1102, 1151-1181), run on the
   same carry, the same accept probabilities and the same accept-selected
   parameters, must give the same factors, masses and adapted state
   (rtol 1e-6); a frozen sweep leaves the state bit for bit.
4. Ensembles of independent chains with both options (hybrid and
   sequential), port against JAX, by the paired 4-SE bound of
   tests/test_torch_hybrid.py; and the port's counterpart of JAX's
   ``test_mass_adaptation_posterior_matches_unadapted``.
5. The port's folded sweeps against its unfolded ones with both options,
   draw for draw over 3 sweeps (two warm, one frozen; rtol 2e-4 as
   ``test_folded_hybrid_sweep_matches_unfolded``, atol 2e-4: the DA update
   carries the accept probability's f32 rounding into the step sizes).
"""

import glob
import math

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
from rs_bann_tpu.samplers import hmc as JH
from rs_bann_tpu.samplers.mcmc_cfg import MCMCCfg
from rs_bann_tpu.train import prepare_state_for_training as j_prepare
from rs_bann_tpu_torch.models import density as TD
from rs_bann_tpu_torch.models import net as TN
from rs_bann_tpu_torch.models import params as TP
from rs_bann_tpu_torch.models.data import pack_stacked as t_pack_stacked
from rs_bann_tpu_torch.samplers import hmc as TH
from rs_bann_tpu_torch.train import prepare_state_for_training, train
from test_torch_copies import port
from test_torch_dense_chains import _feat_data
from test_torch_hybrid import _interpret, _packed

from test_torch_slice import HYPER, _toy

N = 333
ADAPT = dict(hmc_step_size_mode="dual_averaging", mass_adaptation=True)
MODELS = ["ridge_ard", "lasso_base", "std_normal"]
ADAPT_FIELDS = ("da_log_eps", "da_log_eps_bar", "da_h_bar", "mm_mean", "mm_m2")


def T(a):
    return torch.from_numpy(np.array(a))


def J(t):
    return tuple(map(jnp.asarray, t))


def _close(t, j, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _tree_close(ts, js, rtol=1e-6, atol=0.0):
    assert len(ts) == len(js)
    for t, j in zip(ts, js):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j, rtol=rtol, atol=atol)


def _vmap2(fn):  # a per-branch JAX function over [C, G] leading axes
    return jax.vmap(jax.vmap(fn))


def _block(model_type, C=2, G=3, depth=1, seed=0):
    """Weights, biases and precisions of C x G branches (m = 12 markers,
    widths 6 stored at 8), each chain's perturbed, as numpy [C, G, ...]."""
    rng = np.random.default_rng(seed)
    arch = NetArch.uniform(G, 12, 6, depth, 6, activation="tanh")
    state, _ = JI.init_net(arch, model_type, JI.InitCfg(seed=seed + 1))

    def chains(tree, sd):
        return tuple(np.asarray(a)[None] * (1.0 + sd * rng.standard_normal((C,) + a.shape))
                     .astype(np.float32) for a in tree)

    return (arch, chains(state.params.weights, 0.2), chains(state.params.biases, 0.2),
            chains(state.precisions.weights, 0.1), chains(state.precisions.biases, 0.1), rng)


# --------------------------------------------------------- 1. pure pieces


@pytest.mark.parametrize("t", [1.0, 2.0, 37.0])
def test_da_update_matches_jax(t):
    rng = np.random.default_rng(int(t))
    h_bar, leb = (rng.standard_normal((2, 5)).astype(np.float32) * s for s in (0.1, 1.0))
    alpha = rng.random((2, 5)).astype(np.float32)
    cfg = MCMCCfg(hmc_step_size_factor=0.05, target_accept=0.7)
    mu = math.log(10.0 * cfg.hmc_step_size_factor)
    jout = JN._da_update(cfg, jnp.float32(t), jnp.asarray(h_bar), jnp.asarray(leb),
                         jnp.asarray(alpha), mu)
    tout = TN._da_update(port(cfg), t, T(h_bar), T(leb), T(alpha), mu)
    _tree_close(tout, jout, atol=1e-6)
    assert (TN._DA_GAMMA, TN._DA_T0, TN._DA_KAPPA, TN._MASS_SHRINK) == (
        JN._DA_GAMMA, JN._DA_T0, JN._DA_KAPPA, JN._MASS_SHRINK)


def test_welford_matches_jax():
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((7, 2, 3, 11)).astype(np.float32)
    jm, jm2 = jnp.zeros((2, 3, 11)), jnp.zeros((2, 3, 11))
    tm, tm2 = torch.zeros((2, 3, 11)), torch.zeros((2, 3, 11))
    for i, x in enumerate(xs):
        jm, jm2 = JN._welford(jm, jm2, jnp.asarray(x), jnp.float32(i + 1))
        tm, tm2 = TN._welford(tm, tm2, T(x), float(i + 1))
    _tree_close((tm, tm2), (jm, jm2))


@pytest.mark.parametrize("model_type", MODELS + ["lasso_ard", "ridge_base"])
def test_prior_var_trees_matches_jax(model_type):
    _, ws, bs, wp, bp, _ = _block(model_type)
    jw, jb = _vmap2(lambda wp_g, bp_g, w, b: JN._prior_var_trees(model_type, wp_g, bp_g, w, b))(
        J(wp), J(bp), J(ws), J(bs))
    tw, tb = TN._prior_var_trees(model_type, tuple(map(T, wp)), tuple(map(T, bp)),
                                 tuple(map(T, ws)), tuple(map(T, bs)))
    _tree_close(tw + tb, tuple(jw) + tuple(jb))


@pytest.mark.parametrize("count", [0.0, 1.0, 3.0])
@pytest.mark.parametrize("model_type", MODELS)
def test_mass_std_matches_jax(model_type, count):
    arch, ws, bs, wp, bp, rng = _block(model_type)
    P = sum(w[0, 0].size for w in ws) + sum(b[0, 0].size for b in bs)
    mean = rng.standard_normal((2, 3, P)).astype(np.float32)
    m2 = (rng.random((2, 3, P)) * 0.3).astype(np.float32)
    jw, jb = _vmap2(lambda mn, q, wp_g, bp_g, w, b: JN._mass_std(
        model_type, mn, q, jnp.float32(count), wp_g, bp_g, w, b))(
        jnp.asarray(mean), jnp.asarray(m2), J(wp), J(bp), J(ws), J(bs))
    tw, tb = TN._mass_std(model_type, T(m2), count, tuple(map(T, wp)),
                          tuple(map(T, bp)), tuple(map(T, ws)), tuple(map(T, bs)))
    _tree_close(tw + tb, tuple(jw) + tuple(jb))


def test_flatten_wb_matches_jax_and_round_trips():
    _, ws, bs, *_ = _block("ridge_ard")
    jflat = _vmap2(JH.flatten_wb)(J(ws), J(bs))
    tflat = TH.flatten_wb(tuple(map(T, ws)), tuple(map(T, bs)))
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    tw, tb = TH.unflatten_wb(tflat, tuple(map(T, ws)), tuple(map(T, bs)))
    for t, a in zip(tw + tb, ws + bs):
        np.testing.assert_array_equal(t.numpy(), a)
    one_w, one_b = TH.unflatten_wb(tflat[1, 2], tuple(T(w[1, 2]) for w in ws),
                                   tuple(T(b[1, 2]) for b in bs))
    for t, a in zip(one_w + one_b, ws + bs):
        np.testing.assert_array_equal(t.numpy(), a[1, 2])


@pytest.mark.parametrize("mass", [False, True], ids=["no-mass", "mass"])
def test_init_carry_adaptation_state_matches_jax(mass):
    """Net.init_carry's adaptation state, one chain and stacked for C = 3:
    log eps and log eps_bar at log(step factor), h_bar 0, and the Welford
    state [G, P_flat] of zeros with mass adaptation, [G, 0] without, as
    JAX's init_carry makes it."""
    arch = _block("ridge_ard")[0]
    jstate, _ = JI.init_net(arch, "ridge_ard", JI.InitCfg(seed=1))
    bed, grouping, y = _toy(arch.num_branches, 12, N, seed=2)
    jd = j_pack_stacked(arch, bed, grouping, y)
    td = t_pack_stacked(port(arch), bed, grouping, y, "cpu")
    jnet = JN.Net("ridge_ard", arch, JD.Hyperparameters(*HYPER), jstate)
    tnet = TN.Net("ridge_ard", port(arch), TD.Hyperparameters(*HYPER),
                  TP.state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu"))
    jc = jnet.init_carry(jd.X, jd.y, jax.random.key(0), 0.3, mass)
    one = tnet.init_carry(td.X, td.y, step_size_factor=0.3, mass_adaptation=mass)
    stacked = tnet.init_carry(td.X, td.y, chains=3, step_size_factor=0.3, mass_adaptation=mass)
    for name in ADAPT_FIELDS:
        want = np.asarray(getattr(jc, name))
        np.testing.assert_array_equal(getattr(one, name).numpy(), want)
        np.testing.assert_array_equal(getattr(stacked, name).numpy(), np.stack([want] * 3))
    assert one.sweeps == stacked.sweeps == 0 and float(jc.da_t) == 0.0


@pytest.mark.parametrize("factor", ["cfg", "adapted"])
@pytest.mark.parametrize("mass", [False, True], ids=["no-mass", "mass"])
@pytest.mark.parametrize("mode", ["izmailov", "std_scaled", "dual_averaging"])
@pytest.mark.parametrize("model_type", MODELS)
def test_step_sizes_with_factor_and_mass_match_jax(model_type, mode, mass, factor):
    """step_sizes over a [C, G] block with a per-branch factor (a [C, G]
    tensor broadcast over each layer) and per-coordinate masses, against
    JAX's per-branch step_sizes vmapped over the block."""
    _, ws, bs, wp, bp, rng = _block(model_type)
    cfg = MCMCCfg(hmc_step_size_mode=mode, hmc_step_size_factor=0.3, hmc_integration_length=7)
    fac = (rng.random((2, 3)) * 0.5 + 0.05).astype(np.float32) if factor == "adapted" else None
    mw = tuple((rng.random(w.shape) + 0.2).astype(np.float32) for w in ws) if mass else None
    mb = tuple((rng.random(b.shape) + 0.2).astype(np.float32) for b in bs) if mass else None

    def one(w, b, wp_g, bp_g, f, msw, msb):
        return JH.step_sizes(None, model_type, cfg, w, b, wp_g, bp_g, None, f, msw, msb)

    axes = (0, 0, 0, 0, None if fac is None else 0, 0 if mass else None, 0 if mass else None)
    args = (J(ws), J(bs), J(wp), J(bp), None if fac is None else jnp.asarray(fac),
            J(mw) if mass else None, J(mb) if mass else None)
    jw, jb = jax.vmap(jax.vmap(one, in_axes=axes), in_axes=axes)(*args)
    tw, tb = TH.step_sizes(None, model_type, port(cfg), tuple(map(T, ws)), tuple(map(T, bs)),
                           tuple(map(T, wp)), tuple(map(T, bp)), None,
                           None if fac is None else T(fac),
                           tuple(map(T, mw)) if mass else None, tuple(map(T, mb)) if mass else None)
    _tree_close(tw + tb, tuple(jw) + tuple(jb))


# ------------------------------------- 2. the folded block transition

# layout, model type, activation, depth, step-size mode, mass adaptation
FOLD_CASES = [
    ("packed", "ridge_ard", "identity", 0, "dual_averaging", True),
    ("packed", "lasso_ard", "identity", 0, "dual_averaging", True),
    ("packed", "ridge_ard", "identity", 0, "dual_averaging", False),
    ("packed", "ridge_ard", "identity", 0, "std_scaled", True),
    ("feat", "ridge_base", "tanh", 1, "dual_averaging", True),
    ("feat", "lasso_base", "tanh", 1, "izmailov", True),
]


@pytest.mark.parametrize("layout,model_type,act,depth,mode,mass", FOLD_CASES)
def test_adapted_folded_transition_matches_jax_chain_rule(layout, model_type, act, depth, mode,
                                                          mass):
    """A block of C = 2 chains x G = 3 branches with each (chain, branch)'s
    adapted factor (dual averaging only, as the sweeps pass it) and mass,
    its momenta from JAX's chain rule, against JAX's folded proposals."""
    C, G, m = 2, 3, 12
    rng = np.random.default_rng(5)
    arch = NetArch.uniform(G, m, 6, depth, 6, activation=act)
    state, _ = JI.init_net(arch, model_type, JI.InitCfg(seed=2))
    if layout == "packed":
        by, scale, shift = _packed(rng, G, m, arch.m_pad, N)
        jx = JD.PackedX(jnp.asarray(by), jnp.asarray(scale), jnp.asarray(shift), N)
        tx = TD.PackedX(T(by), T(scale), T(shift), N)
    else:
        xT = np.zeros((G, arch.m_pad, N), np.float32)
        xT[:, :m] = rng.standard_normal((G, m, N))
        jx, tx = JD.FeatX(jnp.asarray(xT)), TD.FeatX(T(xT))

    def chains(tree, sd):
        return tuple(np.asarray(a)[None] * (1.0 + sd * rng.standard_normal((C,) + a.shape))
                     .astype(np.float32) for a in tree)

    ws, bs = chains(state.params.weights, 0.2), chains(state.params.biases, 0.2)
    wp, bp = chains(state.precisions.weights, 0.1), chains(state.precisions.biases, 0.1)
    err = np.array([1.1, 0.7], np.float32)
    targets = rng.standard_normal((C, G, N)).astype(np.float32)
    mw, mb = JP.weight_masks(arch), JP.bias_masks(arch)
    cfg = MCMCCfg(hmc_integration_length=3, hmc_step_size_mode=mode, hmc_step_size_factor=0.1,
                  update_mode="hybrid", num_chains=C, mass_adaptation=mass)
    adaptive = mode == "dual_averaging"
    fac = (np.exp(rng.uniform(-3.0, -1.5, (C, G)))).astype(np.float32)
    sd = 0.05 if mode == "std_scaled" else 1.0
    msw = tuple((sd * (0.2 + rng.random(w.shape))).astype(np.float32) for w in ws)
    msb = tuple((sd * (0.2 + rng.random(b.shape))).astype(np.float32) for b in bs)

    keys = jax.random.split(jax.random.key(7), C * G).reshape(C, G)
    nw = len(ws) + len(bs)

    def momenta(i, shape):  # the chain rule's per-(g, c) derivation
        def mom(k):
            _, k_mom, _ = jax.random.split(k, 3)
            return jax.random.normal(jax.random.split(k_mom, nw)[i], shape)
        return np.asarray(jax.vmap(jax.vmap(mom))(keys))

    p_w = tuple(momenta(i, w.shape[2:]) for i, w in enumerate(ws))
    p_b = tuple(momenta(len(ws) + i, b.shape[2:]) for i, b in enumerate(bs))

    transition = JH.make_hmc_step(model_type, act, cfg, defer_accept=True)
    batch = JH.make_transition_batch(model_type, act, cfg, transition, lean_ok=True)
    n_params = jnp.asarray(JP.param_counts(arch), jnp.float32)
    m_ax = 0 if mass else None

    def run():
        return jax.vmap(
            batch, in_axes=(0, 0, 0, 0, 0, 0, None, 0, None, None, None, 0, m_ax, m_ax, None)
        )(keys, J(ws), J(bs), J(wp), J(bp), jnp.asarray(err), jx, jnp.asarray(targets),
          J(mw), J(mb), n_params, jnp.asarray(fac), J(msw) if mass else None,
          J(msb) if mass else None, None)

    jp = _interpret(run)
    fold = TH.make_transition_batch(model_type, act, port(cfg))
    tp = fold(*(tuple(map(T, t)) for t in (ws, bs, wp, bp)), T(err), tx, T(targets),
              tuple(map(T, mw)), tuple(map(T, mb)), (tuple(map(T, p_w)), tuple(map(T, p_b))),
              step_factors=T(fac) if adaptive else None,
              mass_w=tuple(map(T, msw)) if mass else None,
              mass_b=tuple(map(T, msb)) if mass else None)
    np.testing.assert_array_equal(tp.dead.numpy(), np.asarray(jp.dead))
    assert not tp.dead.all()  # some trajectories must be compared, not only frozen
    for t, j in zip(tp.weights + tp.biases, tuple(jp.weights) + tuple(jp.biases)):
        _close(t, j, atol=1e-6)
    for f in ("y_pred_prop", "y_pred0", "prior_prop", "prior0", "kin_prop", "kin0"):
        _close(getattr(tp, f), getattr(jp, f))
    if layout == "packed" and depth == 0:  # the padded columns stay exactly 0
        assert torch.all(tp.weights[0][..., 6:] == 0) and torch.all(tp.weights[1][..., 6:, :] == 0)
        assert torch.all(tp.biases[0][..., 6:] == 0)


# ---------------------------------------- 3. the sweeps' carry updates


def _j_inputs(model_type, cfg, da_t, snap, c, ix, wp, bp, ws, bs):
    """JAX's factor and mass for chain c's branches ``ix`` (its block body
    :1985-1989, 2046-2052; its branch update :1091-1102), from the carry
    ``snap`` (numpy [C, ...]) at the sweep's start."""
    da_t = jnp.float32(da_t)
    warm = da_t < cfg.burn_in
    factor = jnp.exp(jnp.where(warm, snap["da_log_eps"][c][ix], snap["da_log_eps_bar"][c][ix]))
    cnt = jnp.minimum(da_t, float(cfg.burn_in))
    one = lambda mn, q, wp_g, bp_g, w, b: JN._mass_std(  # noqa: E731
        model_type, mn, q, cnt, wp_g, bp_g, w, b)
    mean, m2 = jnp.asarray(snap["mm_mean"][c][ix]), jnp.asarray(snap["mm_m2"][c][ix])
    if np.ndim(ix) == 0:
        mass = one(mean, m2, J(wp), J(bp), J(ws), J(bs))
    else:
        mass = jax.vmap(one)(mean, m2, J(wp), J(bp), J(ws), J(bs))
    return factor, mass


def _j_update(cfg, da_t, state, c, ix, alpha, ws, bs):
    """JAX's DA and Welford updates (block body :2152-2161, 2201-2216;
    branch update :1151-1181) of chain c's branches ``ix`` in ``state``
    (numpy [C, ...], updated in place)."""
    da_t = jnp.float32(da_t)
    warm = da_t < cfg.burn_in
    t = da_t + 1.0
    mu = math.log(10.0 * cfg.hmc_step_size_factor)
    h, le, leb = JN._da_update(cfg, t, jnp.asarray(state["da_h_bar"][c][ix]),
                               jnp.asarray(state["da_log_eps_bar"][c][ix]), jnp.asarray(alpha),
                               mu)
    for name, new in (("da_h_bar", h), ("da_log_eps", le), ("da_log_eps_bar", leb)):
        state[name][c][ix] = np.asarray(jnp.where(warm, new, state[name][c][ix]))
    flat = (JH.flatten_wb(J(ws), J(bs)) if np.ndim(ix) == 0
            else jax.vmap(JH.flatten_wb)(J(ws), J(bs)))
    mean, m2 = JN._welford(jnp.asarray(state["mm_mean"][c][ix]),
                           jnp.asarray(state["mm_m2"][c][ix]), flat, t)
    state["mm_mean"][c][ix] = np.asarray(jnp.where(warm, mean, state["mm_mean"][c][ix]))
    state["mm_m2"][c][ix] = np.asarray(jnp.where(warm, m2, state["mm_m2"][c][ix]))


def _recorded_sweep(monkeypatch, model_type, act, depth, cfg, fold, sweeps, chains):
    """One sweep of the port's schedule on a packed toy (G = 4, m = 8) from a
    carry whose adaptation state is random and whose clock reads
    ``sweeps``, with every ``_Adaptation.inputs`` and ``update`` call
    recorded. Returns (the carry before, as numpy, the carry after, the
    records)."""
    G, m = 4, 8
    arch = NetArch.uniform(G, m, 4, depth, 4, activation=act)
    jstate, _ = JI.init_net(arch, model_type, JI.InitCfg(seed=0))
    bed, grouping, y = _toy(G, m, N, seed=4)
    td = t_pack_stacked(port(arch), bed, grouping, y, "cpu")
    net = prepare_state_for_training(TN.Net(
        model_type, port(arch), TD.Hyperparameters(*HYPER),
        TP.state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")), None)
    if chains is None:  # the sequential schedule's own one-chain carry
        carry = net.init_carry(td.X, td.y, step_size_factor=cfg.hmc_step_size_factor,
                               mass_adaptation=True)
        sweep = TN.make_sweep(model_type, act, port(arch), cfg, net.hyper, "cpu")
    else:
        carry = net.init_carry(td.X, td.y, chains=chains,
                               step_size_factor=cfg.hmc_step_size_factor, mass_adaptation=True)
        sweep = TN.make_hybrid_sweep(model_type, act, port(arch), cfg, net.hyper, "cpu",
                                     fold=fold)
    rng = np.random.default_rng(sweeps)
    for name in ADAPT_FIELDS:
        t = getattr(carry, name)
        t.copy_(torch.from_numpy(rng.uniform(0.05, 0.4, t.shape).astype(np.float32)))
    carry.da_log_eps.log_()
    carry.da_log_eps_bar.log_()
    carry = carry._replace(sweeps=sweeps)
    before = {name: getattr(carry, name).numpy().copy() for name in ADAPT_FIELDS}
    records = {"inputs": [], "update": []}
    inputs, update = TN._Adaptation.inputs, TN._Adaptation.update

    def rec_inputs(self, carry, index, wp, bp, ws, bs):
        out = inputs(self, carry, index, wp, bp, ws, bs)
        # the sequential sweep passes views, which later branch updates move
        records["inputs"].append((index, *(tuple(t.clone() for t in a) for a in (wp, bp, ws, bs)),
                                  out))
        return out

    def rec_update(self, carry, index, alpha, ws, bs):
        records["update"].append((index, alpha.clone(), tuple(w.clone() for w in ws),
                                  tuple(b.clone() for b in bs)))
        return update(self, carry, index, alpha, ws, bs)

    monkeypatch.setattr(TN._Adaptation, "inputs", rec_inputs)
    monkeypatch.setattr(TN._Adaptation, "update", rec_update)
    after, _ = sweep(carry, td.X, td.y, torch.Generator().manual_seed(1))
    assert after.sweeps == sweeps + 1
    return before, after, records


def _per_chain(index, chains):
    """(chain, branch index) pairs of an _Adaptation index: (cix [C, 1],
    ixs [C, B]) of a block, or a branch g of the one-chain sequential
    carry."""
    if chains is None:
        return [(None, index)]
    cix, ixs = index
    return [(c, ixs[c].numpy()) for c in range(cix.shape[0])]


SWEEP_CASES = [
    # model type, activation, depth, schedule (chains; None: sequential)
    ("ridge_ard", "identity", 0, "folded", 2),
    ("lasso_base", "tanh", 1, "folded", 2),
    ("ridge_ard", "identity", 0, "unfolded", 2),
    ("ridge_base", "tanh", 1, "sequential", None),
    ("lasso_ard", "identity", 0, "sequential", None),
]


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "frozen"])
@pytest.mark.parametrize("model_type,act,depth,schedule,chains", SWEEP_CASES)
def test_sweep_adaptation_matches_jax_given_the_accepts(monkeypatch, model_type, act, depth,
                                                        schedule, chains, warm):
    """The factors and masses each transition got, and the adapted state
    after the sweep, against JAX's code on the same carry, accept
    probabilities and accept-selected parameters. A warm sweep (clock 2,
    burn-in 5: t = 3, count 2) moves every branch's state once; a frozen one
    (clock 5) leaves it bit for bit and reads log eps_bar."""
    burn, da_t = 5, 2 if warm else 5
    cfg = MCMCCfg(hmc_integration_length=3, hmc_step_size_factor=0.3, burn_in=burn,
                  chain_length=10, update_mode="sequential" if chains is None else "hybrid",
                  block_size=2, num_chains=chains or 1, seed=0, **ADAPT)
    before, after, records = _recorded_sweep(monkeypatch, model_type, act, depth, port(cfg),
                                             schedule == "folded" if chains else None, da_t,
                                             chains)
    snap = {k: v if chains else v[None] for k, v in before.items()}
    G = after.lpd_local.shape[-1]
    assert len(records["inputs"]) == len(records["update"]) == G // (1 if chains is None else 2)
    seen = []
    for index, wp, bp, ws, bs, (factor, (mass_w, mass_b)) in records["inputs"]:
        for c, ix in _per_chain(index, chains):
            sel = (lambda t: t) if c is None else (lambda t, c=c: t[c])  # noqa: E731
            jf, (jmw, jmb) = _j_inputs(model_type, cfg, da_t, snap, c or 0, ix,
                                       *(tuple(sel(t).numpy() for t in a)
                                         for a in (wp, bp, ws, bs)))
            _close(sel(factor), jf, rtol=1e-6, atol=0)
            _tree_close(tuple(map(sel, mass_w + mass_b)), tuple(jmw) + tuple(jmb))
    state = {k: v.copy() for k, v in snap.items()}
    for index, alpha, ws, bs in records["update"]:
        for c, ix in _per_chain(index, chains):
            sel = (lambda t: t) if c is None else (lambda t, c=c: t[c])  # noqa: E731
            _j_update(cfg, da_t, state, c or 0, ix, sel(alpha).numpy(),
                      tuple(sel(w).numpy() for w in ws), tuple(sel(b).numpy() for b in bs))
            seen.extend(np.atleast_1d(ix) + G * (c or 0))
            # the recorded parameters are the accept-selected ones the sweep kept
            for w, kept in zip(ws, after.state.params.weights):
                np.testing.assert_array_equal(sel(w).numpy(), (kept if c is None else kept[c])[ix])
    assert sorted(seen) == list(range(G * (chains or 1)))  # each branch once
    accepts = torch.cat([a.reshape(-1) for _, a, _, _ in records["update"]])
    assert torch.all((accepts >= 0) & (accepts <= 1)) and accepts.max() > 0
    for name in ADAPT_FIELDS:
        got = getattr(after, name).numpy()
        want = state[name] if chains else state[name][0]
        if warm:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
            assert not np.array_equal(got, before[name])
        else:
            np.testing.assert_array_equal(got, before[name])


# --------------------------------------------------------- 4. posteriors


def _paired_bound(t_err, t_mse, j_err, j_mse, R, burn):
    for name, t, j in [("error precision", t_err, j_err), ("train mse", t_mse, j_mse)]:
        t = np.asarray(t)[:, burn:].mean(axis=1)  # [R] chain summaries
        j = np.asarray(j)[:, burn:].mean(axis=1)
        bound = 4 * np.sqrt(t.var(ddof=1) / R + j.var(ddof=1) / R)
        assert abs(t.mean() - j.mean()) <= bound, (name, t.mean(), j.mean(), bound)


@pytest.mark.parametrize("schedule", ["hybrid", "sequential"])
def test_adapted_chains_posterior_matches_jax(schedule):
    """Posterior means of the error precision and the train mse, port vs
    JAX, with dual averaging and mass adaptation over the first 4 of 10
    sweeps: R independent chains per package from one initial state at a
    step factor of 1 (too large: the adaptation must bring it down), each
    chain summarized by its mean over sweeps 5..10. The adaptation is part
    of each chain's law, so the paired bound of
    ``test_hybrid_chains_posterior_matches_jax`` holds it too: |mean_port -
    mean_jax| <= 4 * sqrt(var_port / R + var_jax / R). One block holds every
    branch in the hybrid schedule."""
    G, m, n, L, R, burn, T_ = 2, 10, 700, 4, 24, 4, 10
    bed, grouping, y = _toy(G, m, n, seed=8)
    arch = NetArch.from_width_rules([m] * G, 0, ("fixed", 4), ("fixed", 4), activation="identity")
    cfg = MCMCCfg(hmc_integration_length=L, hmc_step_size_factor=1.0, chain_length=T_,
                  burn_in=burn, update_mode=schedule, block_size=G, num_chains=R, **ADAPT)
    jstate, _ = JI.init_net(arch, "ridge_ard", JI.InitCfg(seed=1))

    jnet = j_prepare(JN.Net("ridge_ard", arch, JD.Hyperparameters(*HYPER), jstate), None)
    jd = j_pack_stacked(arch, bed, grouping, y)
    jsweep = jax.jit(jax.vmap(jnet.make_sweep(cfg), in_axes=(0, None, None)))
    carry = jax.jit(jax.vmap(lambda k: jnet.init_carry(jd.X, jd.y, k, 1.0, True)))(
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
    tsweep = tnet.make_chain_sweep(port(cfg))
    tcarry = tnet.init_carry(td.X, td.y, chains=R, step_size_factor=1.0, mass_adaptation=True)
    gen = torch.Generator().manual_seed(0)
    t_err, t_mse = [], []
    for _ in range(T_):
        tcarry, st = tsweep(tcarry, td.X, td.y, gen)
        t_err.append(tcarry.state.precisions.error.numpy().copy())
        t_mse.append(st.mse_train.numpy())

    counts = st.counts.sum(dim=0)
    assert int(counts[0]) / int(counts.sum()) > 0.2  # the comparison needs moving chains
    assert not torch.any(tcarry.da_log_eps_bar == 0.0)  # every branch adapted
    _paired_bound(np.asarray(t_err).T, np.asarray(t_mse).T, np.asarray(j_err).T,
                  np.asarray(j_mse).T, R, burn + 1)


def test_mass_adaptation_posterior_matches_unadapted(tmp_path):
    """The port's counterpart of JAX's test of the same name
    (tests/test_mass_adaptation.py): the same posterior with and without
    the mass matrix, which changes only the proposal: the posterior-mean
    predictions of two trainings with dual averaging, one with mass
    adaptation, correlate above 0.95 and both accept more than 30%."""
    arch = NetArch.from_width_rules([10, 10], 0, ("fixed", 5), ("fixed", 5), activation="tanh")
    bed, grouping, y = _toy(2, 10, 300, seed=7, h2=0.7)
    td = t_pack_stacked(port(arch), bed, grouping, y, "cpu")
    jstate, _ = JI.init_net(arch, "ridge_base", JI.InitCfg(seed=1))
    preds = {}
    for mass in (False, True):
        net = TN.Net("ridge_base", port(arch), TD.Hyperparameters(),
                     TP.state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu"))
        cfg = port(MCMCCfg(chain_length=100, burn_in=30, hmc_integration_length=20,
                           hmc_step_size_mode="dual_averaging", mass_adaptation=mass,
                           outpath=str(tmp_path / f"mass{mass}"), seed=5))
        _, stats = train(net, td, cfg, torch.Generator().manual_seed(5))
        assert stats.acceptance_rate() > 0.3, (mass, stats.acceptance_rate())
        files = sorted(glob.glob(str(tmp_path / f"mass{mass}" / "models" / "*.npz")))
        assert len(files) == 71
        preds[mass] = torch.stack([TN.Net.load(f, "cpu").predict(td.X) for f in files]).mean(0)
    r = np.corrcoef(preds[False].numpy(), preds[True].numpy())[0, 1]
    assert r > 0.95, r


# ------------------------------------------ 5. folded == unfolded, adapted


@pytest.mark.parametrize("layout,model_type,act,depth", [
    ("packed", "ridge_ard", "identity", 0), ("packed", "ridge_base", "tanh", 1),
    ("feat", "ridge_base", "tanh", 1),
])
def test_adapted_folded_sweep_matches_unfolded(layout, model_type, act, depth):
    """Packed hybrid (blocks of 2) and feature-major parallel sweeps, C = 2,
    with dual averaging and mass adaptation over the first 2 of 3 sweeps:
    the folded arrangement against the unfolded one, draw for draw, the
    adaptation's state included: the same accept decisions, and the states
    within rtol 2e-4, atol 2e-4. The unadapted twin's atol 2e-5 does not
    hold here, and not for a difference of the arrangements: an accept
    probability is exp of a difference of f32 Hamiltonians of size err *
    rss / 2, which the two arrangements round apart (1.5e-5 in one alpha
    here), the DA update multiplies that by sqrt(t) / (gamma (t + t0)) (1.8
    at t = 1) into log eps, and a step size that much apart moves a
    trajectory's end by as much (4e-5 in the next sweep's factors, up to
    9e-5 in its proposals)."""
    C, G, m = 2, 4, 8
    arch = NetArch.uniform(G, m, 4, depth, 4, activation=act)
    jstate, _ = JI.init_net(arch, model_type, JI.InitCfg(seed=0))
    if layout == "packed":
        bed, grouping, y = _toy(G, m, N, seed=4)
        td = t_pack_stacked(port(arch), bed, grouping, y, "cpu")
    else:
        *_, td = _feat_data(G, m, N, 4, arch)
    cfg = port(MCMCCfg(hmc_integration_length=4, hmc_step_size_factor=0.5, burn_in=2,
                       chain_length=3, update_mode="hybrid" if layout == "packed" else "parallel",
                       block_size=2, num_chains=C, seed=0, **ADAPT))
    assert TN.chain_fold_eligible(model_type, act, cfg)
    runs = []
    for fold in (True, False):
        net = prepare_state_for_training(TN.Net(
            model_type, port(arch), TD.Hyperparameters(*HYPER),
            TP.state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")), None)
        sweep = TN.make_hybrid_sweep(model_type, act, port(arch), cfg, net.hyper, "cpu",
                                     fold=fold)
        carry = net.init_carry(td.X, td.y, chains=C, step_size_factor=0.5, mass_adaptation=True)
        gen = torch.Generator().manual_seed(1)
        for _ in range(3):
            carry, st = sweep(carry, td.X, td.y, gen)
        runs.append((carry, st))
    (cf, sf), (cu, su) = runs
    assert torch.equal(sf.counts, su.counts) and int(sf.counts[:, 0].sum()) > 0
    _close(cf.residual, cu.residual, rtol=2e-4, atol=2e-4)
    for a, b in zip(TP.state_leaves(cf.state), TP.state_leaves(cu.state)):
        _close(a, b, rtol=2e-4, atol=2e-4)
    for name in ADAPT_FIELDS:
        _close(getattr(cf, name), getattr(cu, name), rtol=2e-4, atol=2e-4)
    P = TH.flatten_wb(cf.state.params.weights, cf.state.params.biases).shape[-1]
    assert cf.mm_m2.shape == (C, G, P) and cf.mm_mean.abs().max() > 0
