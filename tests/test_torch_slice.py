"""The port's train-new -> predict slice against the JAX package, on packed
genotypes with the sequential schedule.

* Deterministic: the same state (carried over with ``state_from_numpy``) on
  the same packed data gives the same ``Net.predict``, ``mse`` and
  ``init_carry`` residual and LPD terms (rtol 1e-5).
* Save / load: a port-saved ``.npz`` loads in the JAX ``Net.load`` and
  predicts the same (rtol 1e-5).
* Statistical: torch generators and JAX keys give different draws, so whole
  chains are compared by their posteriors (see the test's docstring).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_bann_tpu.group.grouping import UniformGrouping
from rs_bann_tpu.io.bed import BedVM
from rs_bann_tpu.models import density as JD
from rs_bann_tpu.models import init as JI
from rs_bann_tpu.models import net as JN
from rs_bann_tpu.models.arch import NetArch
from rs_bann_tpu.models.data import pack_stacked as j_pack_stacked
from rs_bann_tpu.samplers.mcmc_cfg import MCMCCfg
from rs_bann_tpu.train import prepare_state_for_training as j_prepare
from rs_bann_tpu_torch.models import density as TD
from rs_bann_tpu_torch.models import net as TN
from rs_bann_tpu_torch.models import params as TP
from rs_bann_tpu_torch.models.data import pack_stacked as t_pack_stacked
from rs_bann_tpu_torch.train import prepare_state_for_training

HYPER = (0.001, 1000.0, 0.001, 1000.0, 0.001, 1000.0)


def _toy(G, m, n, seed, h2=0.5):
    bed = BedVM.random(n, G * m, seed=seed)
    x = bed.get_cols(np.arange(G * m)).T
    xs = (x - bed.col_means) / bed.col_stds
    rng = np.random.default_rng(seed)
    beta = rng.standard_normal(G * m) * (rng.random(G * m) < 0.3)
    g = xs @ beta
    y = g + rng.standard_normal(n) * g.std() * np.sqrt((1 - h2) / h2)
    return bed, UniformGrouping(G, m), (y - y.mean()).astype(np.float32)


def _nets(model_type, act, depth, arch_seed=3):
    arch = NetArch.from_width_rules([10, 10, 10], depth, ("fixed", 6), ("fixed", 5), activation=act)
    jstate, _ = JI.init_net(arch, model_type, JI.InitCfg(seed=arch_seed))
    tstate = TP.state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    jnet = JN.Net(model_type, arch, JD.Hyperparameters(*HYPER), jstate)
    tnet = TN.Net(model_type, arch, TD.Hyperparameters(*HYPER), tstate)
    return arch, jnet, tnet


@pytest.mark.parametrize("model_type,act,depth", [("ridge_ard", "identity", 0), ("lasso_base", "tanh", 1)])
def test_predict_mse_and_init_carry_match_jax(model_type, act, depth):
    arch, jnet, tnet = _nets(model_type, act, depth)
    bed, grouping, y = _toy(3, 10, 700, seed=5)
    jd = j_pack_stacked(arch, bed, grouping, y)
    td = t_pack_stacked(arch, bed, grouping, y, "cpu")

    np.testing.assert_allclose(tnet.predict(td.X).numpy(), np.asarray(jnet.predict(jd.X)),
                               rtol=1e-5, atol=1e-5)
    assert float(tnet.mse(td.X, td.y)) == pytest.approx(float(jnet.mse(jd.X, jd.y)), rel=1e-5)

    jc = jnet.init_carry(jd.X, jd.y, jax.random.key(0))
    tc = tnet.init_carry(td.X, td.y)
    np.testing.assert_allclose(tc.residual.numpy(), np.asarray(jc.residual), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tc.lpd_local.numpy(), np.asarray(jc.lpd_local), rtol=1e-5)
    for t, j in [(tc.lpd_out, jc.lpd_out), (tc.lpd_rss, jc.lpd_rss)]:
        assert float(t) == pytest.approx(float(j), rel=1e-5)
    # init_carry works on a copy: the net's own state is untouched
    assert tc.state.params.weights[0] is not tnet.state.params.weights[0]


def test_port_saved_model_loads_in_jax(tmp_path):
    arch, jnet, tnet = _nets("ridge_ard", "identity", 0)
    bed, grouping, y = _toy(3, 10, 300, seed=6)
    with torch.no_grad():
        tnet.state.params.weights[0].mul_(1.5)  # a state JAX never produced itself
    tnet.state = tnet.state._replace(output_bias=torch.tensor(0.25))
    tnet.save(str(tmp_path / "0.npz"))
    loaded = JN.Net.load(str(tmp_path / "0.npz"))
    assert loaded.model_type == "ridge_ard" and loaded.arch == arch
    jx = j_pack_stacked(arch, bed, grouping, y).X
    tx = t_pack_stacked(arch, bed, grouping, y, "cpu").X
    np.testing.assert_allclose(np.asarray(loaded.predict(jx)), tnet.predict(tx).numpy(),
                               rtol=1e-5, atol=1e-5)
    back = TN.Net.load(str(tmp_path / "0.npz"), "cpu")
    for a, b in zip(jax.tree.leaves(tuple(TP.state_to_numpy(back.state))),
                    jax.tree.leaves(tuple(TP.state_to_numpy(tnet.state)))):
        np.testing.assert_array_equal(a, b)


def test_sequential_chains_posterior_matches_jax():
    """Posterior means of the error precision and the train mse after
    burn-in, port vs JAX, on a 2-branch toy (ridge_ard, identity, depth 0):
    R independent chains per package from the same initial state, each
    summarized by its mean over sweeps burn+1..T.

    Bound: |mean_port - mean_jax| <= 4 * sqrt(var_port / R + var_jax / R)
    over the R chain summaries. The chains are independent, so this is the
    exact standard error of the difference; if both packages run the same
    Markov kernel, a difference beyond 4 SEs has a normal two-sided tail of
    6e-5. (One long chain per package would not do: this toy's
    scale-degenerate identity branches wander along W0 -> cW0,
    w_out -> w_out/c with autocorrelations of hundreds of sweeps.)
    """
    G, m, n, L, R, burn, T = 2, 10, 700, 4, 20, 3, 8
    bed, grouping, y = _toy(G, m, n, seed=8)
    arch = NetArch.from_width_rules([m] * G, 0, ("fixed", 4), ("fixed", 4), activation="identity")
    cfg = MCMCCfg(hmc_integration_length=L, hmc_step_size_factor=0.2, chain_length=T)
    jstate, _ = JI.init_net(arch, "ridge_ard", JI.InitCfg(seed=1))

    jnet = j_prepare(JN.Net("ridge_ard", arch, JD.Hyperparameters(*HYPER), jstate), None)
    jd = j_pack_stacked(arch, bed, grouping, y)
    jsweep = jax.jit(jax.vmap(jnet.make_sweep(cfg), in_axes=(0, None, None)))
    carry = jax.jit(jax.vmap(lambda k: jnet.init_carry(jd.X, jd.y, k)))(
        jax.random.split(jax.random.key(0), R))
    # strong-typed leaves, as the sweep returns them: one compilation, not two
    carry = jax.tree.map(lambda a: jnp.asarray(a, a.dtype), carry)
    j_err, j_mse = [], []
    for _ in range(T):
        carry, st = jsweep(carry, jd.X, jd.y)
        j_err.append(np.asarray(carry.state.precisions.error))
        j_mse.append(np.asarray(st.mse_train))

    td = t_pack_stacked(arch, bed, grouping, y, "cpu")
    t_err, t_mse, t_acc = [], [], []
    for r in range(R):
        tnet = prepare_state_for_training(TN.Net(
            "ridge_ard", arch, TD.Hyperparameters(*HYPER),
            TP.state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")), None)
        tsweep = tnet.make_sweep(cfg)
        tcarry = tnet.init_carry(td.X, td.y)
        gen = torch.Generator().manual_seed(r)
        errs, mses = [], []
        for _ in range(T):
            tcarry, st = tsweep(tcarry, td.X, td.y, gen)
            errs.append(float(tcarry.state.precisions.error))
            mses.append(float(st.mse_train))
        t_err.append(errs)
        t_mse.append(mses)
        t_acc.append(int(st.counts[0]) / int(st.counts.sum()))

    assert np.mean(t_acc) > 0.2  # the comparison needs moving chains
    for name, t, j in [("error precision", t_err, j_err), ("train mse", t_mse, j_mse)]:
        t = np.asarray(t)[:, burn:].mean(axis=1)  # [R] chain summaries
        j = np.asarray(j).T[:, burn:].mean(axis=1)
        bound = 4 * np.sqrt(t.var(ddof=1) / R + j.var(ddof=1) / R)
        assert abs(t.mean() - j.mean()) <= bound, (name, t.mean(), j.mean(), bound)
