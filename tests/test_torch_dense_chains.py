"""The port's dense flagship path (feature-major X, parallel schedule, C chains)
against the JAX package, in five parts.

1. ``data_vg_chains_ref`` (the plain version of K7) against JAX's
   ``data_vg_chains(..., f32=True)`` with its Pallas kernel in interpret
   mode, for every output, at n not a multiple of 128. rtol 1e-5 of the
   largest entry: sums over n in another order.
2. The dense folded transition (``make_transition_batch`` on a FeatX)
   against JAX's under a chain vmap, draw for draw, with the per-(chain,
   branch) momenta derived as JAX's chain rule derives them
   (rs_bann_tpu/samplers/hmc.py:1071-1103). rtol 1e-4: the trajectory's
   gradients are sums over n in another order, compounded over L steps.
3. The port's folded parallel sweep (C = 2, the plain K6 and K7) against
   its unfolded one (each chain and branch on the lean per-branch
   transition, autograd gradients), draw for draw over 3 sweeps (rtol 2e-4,
   atol 2e-5: the JAX package's bound for the same twin test,
   tests/test_leapfrog.py).
4. Ensembles of independent parallel chains, port against JAX, held by the
   paired 4-SE bound of tests/test_torch_slice.py.
5. One toy run each of ``--update-mode hybrid --feat-major`` and
   ``--update-mode parallel --packed-genotypes`` through the CLI: finite
   statistics, and the whole-trajectory calls and value passes the fold
   makes (one trajectory and two value passes per block).
"""

import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_bann_tpu.io.genotypes import CompressedGenotypes as JCompressedGenotypes
from rs_bann_tpu.models import density as JD
from rs_bann_tpu.models import init as JI
from rs_bann_tpu.models import net as JN
from rs_bann_tpu.models import params as JP
from rs_bann_tpu.models.arch import NetArch
from rs_bann_tpu.ops import branch_mlp as JBM
from rs_bann_tpu.samplers import hmc as JH
from rs_bann_tpu.samplers.mcmc_cfg import MCMCCfg
from rs_bann_tpu.train import prepare_state_for_training as j_prepare
from rs_bann_tpu_torch.cli.main import main as cli
from rs_bann_tpu_torch.io import BedVM, Phenotypes, UniformGrouping
from rs_bann_tpu_torch.io.genotypes import CompressedGenotypes
from rs_bann_tpu_torch.models import density as TD
from rs_bann_tpu_torch.models import net as TN
from rs_bann_tpu_torch.models import params as TP
from rs_bann_tpu_torch.ops import branch_mlp as TBM
from rs_bann_tpu_torch.ops import leapfrog as TL
from rs_bann_tpu_torch.samplers import hmc as TH
from rs_bann_tpu_torch.train import prepare_state_for_training
from test_torch_copies import port

from test_torch_slice import HYPER, _toy

N = 333  # not a multiple of K6/K7's 128-individual tile


def T(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


# ----------------------------------------------- 1. K7's plain version


@pytest.mark.parametrize("act,depth", [("tanh", 1), ("tanh", 0), ("identity", 1), ("identity", 0)])
def test_data_vg_chains_ref_matches_jax(act, depth):
    rng = np.random.default_rng(0)
    G, C, m = 2, 3, 16
    widths = [(m, 8), (8, 8), (8, 1)] if depth else [(m, 8), (8, 1)]
    ws = tuple((rng.standard_normal((G, C, i, o)) * 0.3).astype(np.float32) for i, o in widths)
    bs = tuple((rng.standard_normal((G, C, o)) * 0.1).astype(np.float32) for _, o in widths[:-1])
    xT = rng.standard_normal((G, m, N)).astype(np.float32)
    target = rng.standard_normal((G, C, N)).astype(np.float32)
    JBM.FORCE = "interpret"
    try:
        jout = JBM.data_vg_chains(act, jnp.asarray(xT), tuple(map(jnp.asarray, ws)),
                                  tuple(map(jnp.asarray, bs)), jnp.asarray(target), f32=True)
    finally:
        JBM.FORCE = None
    tout = TBM.data_vg_chains(act, T(xT), tuple(map(T, ws)), tuple(map(T, bs)), T(target))
    flat = lambda o: [o[0], o[1], *o[2], *o[3]]  # noqa: E731
    for t, j in zip(flat(tout), flat(jout)):
        assert t.shape == j.shape
        scale = max(1.0, float(np.abs(np.asarray(j)).max()))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5 * scale)
    np.testing.assert_array_equal(TBM.forward_chains(act, T(xT), tuple(map(T, ws)),
                                                     tuple(map(T, bs))).numpy(), tout[0].numpy())


# --------------------------------- 2. the dense folded block transition


@pytest.mark.parametrize("model_type,act,depth,factor", [("ridge_base", "tanh", 1, 0.1)])
def test_dense_folded_transition_matches_jax_chain_rule(model_type, act, depth, factor):
    rng = np.random.default_rng(5)
    C, G, m = 2, 3, 12
    arch = NetArch.uniform(G, m, 6, depth, 6, activation=act)
    state, _ = JI.init_net(arch, model_type, JI.InitCfg(seed=2))
    xT = np.zeros((G, arch.m_pad, N), np.float32)
    xT[:, :m] = rng.standard_normal((G, m, N))

    def chains(tree, sd):  # [G, ...] -> [C, G, ...], each chain perturbed
        return tuple(np.asarray(a)[None] * (1.0 + sd * rng.standard_normal((C,) + a.shape))
                     .astype(np.float32) for a in tree)

    ws, bs = chains(state.params.weights, 0.2), chains(state.params.biases, 0.2)
    wp = chains(state.precisions.weights, 0.1)
    bp = chains(state.precisions.biases, 0.1)
    err = np.array([1.1, 0.7], np.float32)
    targets = rng.standard_normal((C, G, N)).astype(np.float32)
    mw, mb = JP.weight_masks(arch), JP.bias_masks(arch)
    cfg = MCMCCfg(hmc_integration_length=3, hmc_step_size_factor=factor, update_mode="parallel",
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

    J = lambda t: tuple(map(jnp.asarray, t))  # noqa: E731
    transition = JH.make_hmc_step(model_type, act, cfg, defer_accept=True)
    batch = JH.make_transition_batch(model_type, act, cfg, transition, lean_ok=True)
    n_params = jnp.asarray(JP.param_counts(arch), jnp.float32)

    def run():
        return jax.vmap(
            batch, in_axes=(0, 0, 0, 0, 0, 0, None, 0, None, None, None, None, None, None, None)
        )(keys, J(ws), J(bs), J(wp), J(bp), jnp.asarray(err), JD.FeatX(jnp.asarray(xT)),
          jnp.asarray(targets), J(mw), J(mb), n_params, jnp.ones(G), None, None, None)

    JBM.FORCE = "interpret"
    try:
        jp = run()
    finally:
        JBM.FORCE = None
    fold = TH.make_transition_batch(model_type, act, port(cfg))
    tp = fold(*(tuple(map(T, t)) for t in (ws, bs, wp, bp)), T(err), TD.FeatX(T(xT)), T(targets),
              tuple(map(T, mw)), tuple(map(T, mb)), (tuple(map(T, p_w)), tuple(map(T, p_b))))
    np.testing.assert_array_equal(tp.dead.numpy(), np.asarray(jp.dead))
    for t, j in zip(tp.weights + tp.biases, tuple(jp.weights) + tuple(jp.biases)):
        _close(t, j, atol=1e-6)
    for f in ("y_pred_prop", "y_pred0", "prior_prop", "prior0", "kin_prop", "kin0"):
        _close(getattr(tp, f), getattr(jp, f))


# ------------------------------------------- 3. folded == unfolded, in the port


def _feat_data(G, m, n, seed, arch):
    """The port's own toy data: bed, grouping and phenotype of _toy, and the
    feature-major FeatX of it."""
    bed, grouping, y = _toy(G, m, n, seed=seed)
    tbed = BedVM(bed.data, bed.num_individuals, bed.num_markers)
    gen = CompressedGenotypes(tbed, UniformGrouping(G, m))
    return bed, grouping, y, gen.to_feature_major(port(arch), "cpu", y)


@pytest.mark.parametrize("model_type", ["ridge_base", "lasso_base"])
def test_folded_parallel_sweep_matches_unfolded(model_type):
    C, G, m = 2, 3, 8
    arch = NetArch.uniform(G, m, 4, 1, 4, activation="tanh")
    jstate, _ = JI.init_net(arch, model_type, JI.InitCfg(seed=0))
    *_, td = _feat_data(G, m, N, 4, arch)
    cfg = port(MCMCCfg(hmc_integration_length=4, update_mode="parallel", num_chains=C, seed=0))
    assert TN.chain_fold_eligible(model_type, "tanh", cfg)
    runs = []
    for fold in (True, False):
        net = prepare_state_for_training(TN.Net(
            model_type, port(arch), TD.Hyperparameters(*HYPER),
            TP.state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")), None)
        # each chain from its own weights, carried in as a chain-stacked
        # numpy state (the same draws for both arrangements)
        one = TP.state_to_numpy(net.state)
        rng = np.random.default_rng(2)
        chains = TP.state_from_numpy(TP.map_state(lambda a: np.stack(
            [a * (1.0 + 0.1 * rng.standard_normal(a.shape)) for _ in range(C)]), one), "cpu")
        sweep = TN.make_hybrid_sweep(model_type, "tanh", port(arch), cfg, net.hyper, "cpu", fold=fold)
        carry = net.init_carry(td.X, td.y, chains, chains=C)
        gen = torch.Generator().manual_seed(1)
        for _ in range(3):
            carry, st = sweep(carry, td.X, td.y, gen)
        runs.append((carry, st))
    (cf, sf), (cu, su) = runs
    assert torch.equal(sf.counts, su.counts) and int(sf.counts[:, 0].sum()) > 0
    _close(cf.residual, cu.residual, rtol=2e-4, atol=2e-5)
    for a, b in zip(TP.state_leaves(cf.state), TP.state_leaves(cu.state)):
        _close(a, b, rtol=2e-4, atol=2e-5)


# --------------------------------------------------------- 4. posteriors


def test_parallel_chains_posterior_matches_jax():
    """Posterior means of the error precision and the train mse after
    burn-in, port vs JAX: R independent parallel chains per package from one
    initial state on feature-major X (the port's in one folded run of R
    chains, JAX's under a chain vmap), each chain summarized by its mean
    over sweeps burn+1..T. Bound: |mean_port - mean_jax| <= 4 *
    sqrt(var_port / R + var_jax / R), the exact standard error of the
    difference of independent chain summaries (normal two-sided tail
    6e-5)."""
    G, m, n, L, R, burn, T_ = 2, 10, 700, 4, 24, 3, 8
    arch = NetArch.from_width_rules([m] * G, 1, ("fixed", 4), ("fixed", 4), activation="tanh")
    cfg = MCMCCfg(hmc_integration_length=L, hmc_step_size_factor=0.5, chain_length=T_,
                  update_mode="parallel", num_chains=R)
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

    tnet = prepare_state_for_training(TN.Net(
        "ridge_base", port(arch), TD.Hyperparameters(*HYPER),
        TP.state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")), None)
    tsweep = tnet.make_chain_sweep(port(cfg))
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


# -------------------------------------------- 5. the fold's calls, end to end


def _counting(monkeypatch, module, name, counts):
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        counts[name] = counts.get(name, 0) + 1
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("layout,mode,G,blocks", [
    ("--feat-major", "hybrid", 16, 8),  # blocks of default_block_size(16) = 2
    ("--packed-genotypes", "parallel", 4, 1),
])
def test_toy_runs_fold_every_block(tmp_path, monkeypatch, layout, mode, G, blocks):
    M, n, sweeps, C = 3, 300, 2, 2
    rng = np.random.default_rng(0)
    BedVM.random(n, G * M, seed=1).to_file(tmp_path / "train")
    Phenotypes(rng.standard_normal(n).astype(np.float32)).to_file(tmp_path / "train.phen")
    UniformGrouping(G, M).to_file(tmp_path / "train")
    counts = {}
    for module, name in ((TL, "integrate_chains"), (TL, "integrate_chains_packed"),
                         (TD, "forward_chains"), (TD, "packed_linear")):
        _counting(monkeypatch, module, name, counts)
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli([str(a) for a in (
            "train-new", tmp_path / "train", tmp_path / "train.phen", tmp_path / "train.groups",
            "ridge_base", "tanh", "1", sweeps, 3, "--fixed-hidden-layer-width", "4",
            "--fixed-summary-layer-width", "4", layout, "--update-mode", mode,
            "--num-chains", C, "--cpu", "-o", tmp_path / "runs")])
    run = buf.getvalue().strip().splitlines()[-1]
    stats = json.load(open(f"{run}/training_stats"))
    assert stats["num_samples"] == sweeps * G * C
    assert all(np.isfinite(stats["mse_train"] + stats["lpd"]))
    traj, value = (("integrate_chains", "forward_chains") if layout == "--feat-major"
                   else ("integrate_chains_packed", "packed_linear"))
    assert counts.get(traj) == sweeps * blocks
    # two value passes a block (snapshot/H0 and Hf); the packed path's
    # initial carry predicts through packed_linear once more
    assert counts.get(value) == 2 * sweeps * blocks + (value == "packed_linear")
    other = "integrate_chains_packed" if traj == "integrate_chains" else "integrate_chains"
    assert other not in counts
