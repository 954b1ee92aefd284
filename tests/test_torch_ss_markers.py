"""The port's per-marker spike-and-slab (``cfg.ss_markers``) against the JAX
package, on the CPU.

1. The scan (ops/marker_scan.py ``marker_scan_ref``) draw for draw against
   JAX's ``_marker_ss_scan``: JAX's draws derived from its key as the scan
   derives them (rs_bann_tpu/models/net.py:273-299, 316-317, 334-335) and
   fed to the port, on packed and dense X, ridge_ard and lasso_ard, force
   on and off. z must be equal and W0_new within 1e-4 of max(1, max |W0|):
   both sum in f32, the port in coefficient space over the whole branch
   (u = X^T e moved through the Gram), JAX in blocks of 16 markers with
   the residual moved between blocks; exact in arithmetic, so only the
   rounding differs. The Gram and u0 (``D.marker_gram``, ``D.marker_u0``)
   against numpy. The coefficient form against a literal replica that
   moves the residual after every marker, both in f64 (rtol 1e-9).
2. ``gibbs.inverse_gaussian``'s moments against JAX's and the law's; the
   excluded rows' prior draw of their precision; the sweep end's pi draw
   (Beta(1 + nz, 1 + M - nz) moments within 4 standard errors) and PIP
   running mean (exact).
3. The row pins: an excluded row whose precision is 0 (an infinite
   izmailov step) gives no NaN and stays exactly 0 through the folded
   (packed and dense), per-branch (default and lean) and batched lean
   transitions.
4. The sweeps: the folded and unfolded hybrid (packed) and parallel
   (dense) sweeps with ss_markers, from one generator, give the same chain
   (z equal, the states within rtol 2e-4, atol 2e-5, as the unadapted twin
   test of tests/test_torch_hybrid.py); the initial carry as JAX's; the
   JAX package's refusals. Ensembles: PIP vectors and the learned pi, port
   against JAX, R independent chains each, by the paired 4-SE bound of
   tests/test_torch_hybrid.py. The CLI writes ``inclusion_probs``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_bann_tpu.models import density as JD
from rs_bann_tpu.models import init as JI
from rs_bann_tpu.models import net as JN
from rs_bann_tpu.models.arch import NetArch
from rs_bann_tpu.models.data import pack_stacked as j_pack_stacked
from rs_bann_tpu.ops.packed_matmul import pack_strided
from rs_bann_tpu.samplers import gibbs as JG
from rs_bann_tpu.samplers.mcmc_cfg import MCMCCfg
from rs_bann_tpu.train import prepare_state_for_training as j_prepare
from rs_bann_tpu_torch.cli.main import main as cli
from rs_bann_tpu_torch.io import Phenotypes
from rs_bann_tpu_torch.models import density as TD
from rs_bann_tpu_torch.models import net as TN
from rs_bann_tpu_torch.models import params as TP
from rs_bann_tpu_torch.models.data import pack_stacked as t_pack_stacked
from rs_bann_tpu_torch.ops.marker_scan import marker_scan_ref
from rs_bann_tpu_torch.samplers import gibbs as TG
from rs_bann_tpu_torch.samplers import hmc as TH
from rs_bann_tpu_torch.train import prepare_state_for_training
from test_torch_copies import port
from test_torch_dense_chains import _feat_data
from test_torch_slice import HYPER, _toy


def T(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _close(t, j, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


# ------------------------------------------------------------ 1. the scan


def _scan_problem(packed, lasso, seed, n=500, m=22, m_pad=24, s_true=6, s=8):
    """One branch: its genotypes (JAX's x_g and the port's X of one branch),
    W0 (zero rows for lasso's prior draws, padded rows and columns zero),
    w_out, the rows' precisions and a residual carrying a few markers'
    signal, so that some markers come in and some go out."""
    rng = np.random.default_rng(seed)
    if packed:
        vals = np.zeros((m_pad, n), np.float32)
        vals[:m] = rng.integers(0, 3, size=(m, n))
        scale = np.zeros(m_pad, np.float32)
        mu = np.zeros(m_pad, np.float32)
        scale[:m] = 1.0 / vals[:m].std(axis=1)
        mu[:m] = vals[:m].mean(axis=1)
        by = pack_strided(vals)
        x = ((vals - mu[:, None]) * scale[:, None]).T
        jx = JD.PackedX(jnp.asarray(by), jnp.asarray(scale), jnp.asarray(mu), n)
        tx = TD.PackedX(T(by)[None], T(scale)[None], T(mu)[None], n)
    else:
        x = np.zeros((n, m_pad), np.float32)
        x[:, :m] = rng.standard_normal((n, m))
        jx = jnp.asarray(x)
        tx = TD.FeatX(T(x.T.copy())[None])
    W0 = np.zeros((m_pad, s), np.float32)
    W0[:m, :s_true] = rng.standard_normal((m, s_true)) * 0.3
    if lasso:
        W0[[3, 7, 11]] = 0.0
        W0[5, 2] = 0.0
    w_out = np.zeros((s, 1), np.float32)
    w_out[:s_true, 0] = rng.standard_normal(s_true)
    beta = np.zeros(m_pad)
    beta[rng.choice(m, 4, replace=False)] = 0.4
    resid0 = (x @ beta + rng.standard_normal(n)).astype(np.float32)
    lam_rows = rng.uniform(0.5, 3.0, m_pad).astype(np.float32)
    rm = (np.arange(m_pad) < m).astype(np.float32)
    cm = (np.arange(s) < s_true).astype(np.float32)
    return x, jx, tx, W0, w_out, resid0, lam_rows, rm, cm


def _jax_draws(key, W0, lam_rows, lasso):
    """The draws ``_marker_ss_scan`` derives from ``key``: the slab
    precisions, the visiting order, and per marker j the Bernoulli uniform,
    the normal of a_j and the row's normals (from fold_in(k_scan, j))."""
    m_pad, s = W0.shape
    key, k_eta = jax.random.split(key)
    if lasso:
        rate = jnp.maximum(lam_rows, 1e-6)[:, None]
        k_ig, k_ex = jax.random.split(k_eta)
        eta_w = JG.inverse_gaussian(k_ig, rate / jnp.maximum(jnp.abs(W0), 1e-12), rate * rate)
        s_prior = jax.random.exponential(k_ex, W0.shape) / (rate * rate / 2.0)
        eta = jnp.where(jnp.abs(W0) > 0, eta_w, 1.0 / s_prior)
    else:
        eta = jnp.broadcast_to(jnp.maximum(lam_rows, 1e-6)[:, None], (m_pad, s))
    eta = jnp.clip(eta, 1e-6, 1e12)
    k_perm, k_scan = jax.random.split(key)
    order = jax.random.permutation(k_perm, m_pad)
    uz, na, xi = [], [], []
    for j in range(m_pad):
        k_z, k_a, k_o = jax.random.split(jax.random.fold_in(k_scan, j), 3)
        uz.append(jax.random.uniform(k_z, ()))
        na.append(jax.random.normal(k_a, ()))
        xi.append(jax.random.normal(k_o, (s,)))
    return eta, order, jnp.stack(uz), jnp.stack(na), jnp.stack(xi), k_scan


@pytest.mark.parametrize("force", [False, True], ids=["drawn", "forced"])
@pytest.mark.parametrize("lasso", [False, True], ids=["ridge_ard", "lasso_ard"])
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_marker_scan_matches_jax_draw_for_draw(packed, lasso, force):
    x, jx, tx, W0, w_out, resid0, lam_rows, rm, cm = _scan_problem(packed, lasso, seed=3)
    lam_e, pi = 1.7, 0.4
    key = jax.random.key(11)
    z_j, W_j, _ = JN._marker_ss_scan(
        key, jx, jnp.asarray(W0), jnp.zeros(W0.shape[1]), jnp.asarray(w_out),
        jnp.asarray(resid0), lam_e, jnp.asarray(lam_rows), pi, jnp.asarray(rm), jnp.asarray(cm),
        force, lasso=lasso)
    eta, order, uz, na, xi, k_scan = _jax_draws(key, jnp.asarray(W0), jnp.asarray(lam_rows), lasso)
    # JAX's Bernoulli draw is its uniform below p
    for j, p in zip(range(4), (0.1, 0.5, 0.73, 0.95)):
        k_z = jax.random.split(jax.random.fold_in(k_scan, j), 3)[0]
        assert bool(jax.random.bernoulli(k_z, jnp.float32(p))) == bool(uz[j] < p)

    gram = TD.marker_gram(tx)
    u0 = TD.marker_u0(tx[0], T(resid0)[:, None])[None, :, 0]
    z_t, W_t = marker_scan_ref(
        gram, torch.zeros(1, dtype=torch.int64), u0, T(W0)[None], T(w_out[:, 0])[None],
        T(eta)[None], T([lam_e], torch.float32), T([pi], torch.float32), T(rm)[None],
        T(cm)[None], force, T(order)[None], T(uz)[None], T(na)[None], T(xi)[None])
    np.testing.assert_array_equal(z_t[0].numpy(), np.asarray(z_j))
    W_j = np.asarray(W_j)
    assert np.abs(W_t[0].numpy() - W_j).max() <= 1e-4 * max(1.0, np.abs(W_j).max())
    z = z_t[0].numpy()
    assert np.all(z[rm == 0] == 0) and np.all(W_t[0].numpy()[:, cm == 0] == 0)
    assert np.all(W_t[0].numpy()[z == 0] == 0)
    if force:
        np.testing.assert_array_equal(z, rm)
    else:  # the comparison needs markers both in and out
        assert 0 < z.sum() < rm.sum()


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_marker_gram_and_u0_match_numpy(packed):
    x, _, tx, *_ = _scan_problem(packed, False, seed=5)
    e = np.random.default_rng(1).standard_normal((x.shape[0], 3)).astype(np.float32)
    g = TD.marker_gram(tx)[0].numpy()
    want = x.T.astype(np.float64) @ x
    assert np.abs(g - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_array_equal(g, g.T)
    assert tx.gram is None  # formed once per run, explicitly, kept on the data
    assert tx.form_gram() is tx.gram and torch.equal(tx.gram, TD.marker_gram(tx))
    u0 = TD.marker_u0(tx[0], T(e)).numpy()
    want = x.T.astype(np.float64) @ e
    assert np.abs(u0 - want).max() <= 1e-5 * np.abs(want).max()
    blk = TD.marker_u0(tx, T(e))  # a block of one branch
    np.testing.assert_allclose(blk[0].numpy(), u0, rtol=1e-6, atol=1e-6)


def _residual_replica(x, e, W0, w, eta, lam_e, pi, rm, cm, force, order, uz, na, xi):
    """The scan as the reference's literal per-marker move, in numpy f64:
    the residual itself moves after every marker."""
    W, z = W0.copy(), np.zeros(W0.shape[0])
    wn2 = w @ w
    wnorm = np.sqrt(max(wn2, 1e-30))
    what = w / wnorm
    for j in order:
        x_j, row = x[:, j], W[j]
        e_mj = e + x_j * (row @ w)
        u = x_j @ e_mj
        d = cm / eta[j]
        dw = d * what
        v_a = max(what @ dw, 1e-30)
        q_a = 1.0 / v_a + lam_e * (x_j @ x_j) * wn2
        log_bf = 0.5 * np.log(1.0 / v_a / q_a) + 0.5 * (lam_e * wnorm * u) ** 2 / q_a
        p = 1.0 / (1.0 + np.exp(-(np.log(pi) - np.log1p(-pi) + log_bf)))
        zj = (1.0 if force else float(uz[j] < p)) * rm[j]
        a = lam_e * wnorm * u / q_a + na[j] / np.sqrt(q_a)
        xr = xi[j] * np.sqrt(d)
        xr = xr - dw * (xr @ what) / v_a
        W[j] = (dw / v_a) * a + xr if zj > 0 else 0.0
        z[j] = zj
        e = e_mj - x_j * (W[j] @ w)
    return z, W


def test_coefficient_form_matches_a_residual_replica_in_f64():
    """Three instances over two branches (each its own order, slab
    precisions and draws; one forced) against the per-marker residual
    replica, all in f64."""
    rng = np.random.default_rng(9)
    n, m, s, I = 200, 16, 6, 3
    xs = rng.standard_normal((2, n, m))
    xs[1, :, -1] = 0.0  # a padded marker
    gix = np.array([0, 1, 1])
    e = xs[gix, :, :3].sum(-1) * 0.5 + rng.standard_normal((I, n))
    W0 = rng.standard_normal((I, m, s)) * 0.3
    w = rng.standard_normal((I, s))
    w[:, -1] = 0.0  # a padded column
    eta = rng.uniform(0.3, 3.0, (I, m, s))
    lam_e, pi = np.array([1.3, 0.8, 2.0]), np.array([0.3, 0.5, 0.2])
    rm = np.ones((I, m))
    rm[1:, -1] = 0.0
    cm = np.ones((I, s))
    cm[:, -1] = 0.0
    W0[1:, -1] = 0.0
    W0[..., -1] = 0.0
    order = np.stack([rng.permutation(m) for _ in range(I)])
    uz, na, xi = rng.random((I, m)), rng.standard_normal((I, m)), rng.standard_normal((I, m, s))
    force = [False, False, True]
    gram = np.einsum("gni,gnj->gij", xs, xs)
    u0 = np.einsum("inj,in->ij", xs[gix], e)
    f64 = torch.float64
    for i in range(I):
        z_t, W_t = marker_scan_ref(
            T(gram, f64), T(gix[i:i + 1]), T(u0[i:i + 1], f64), T(W0[i:i + 1], f64),
            T(w[i:i + 1], f64), T(eta[i:i + 1], f64), T(lam_e[i:i + 1], f64),
            T(pi[i:i + 1], f64), T(rm[i:i + 1], f64), T(cm[i:i + 1], f64), force[i],
            T(order[i:i + 1]), T(uz[i:i + 1], f64), T(na[i:i + 1], f64), T(xi[i:i + 1], f64))
        z_r, W_r = _residual_replica(xs[gix[i]], e[i], W0[i], w[i], eta[i], lam_e[i], pi[i],
                                     rm[i], cm[i], force[i], order[i], uz[i], na[i], xi[i])
        np.testing.assert_array_equal(z_t[0].numpy(), z_r)
        np.testing.assert_allclose(W_t[0].numpy(), W_r, rtol=1e-9, atol=1e-12)
        if not force[i]:
            assert 0 < z_r.sum() < rm[i].sum()
    # all three in one call (none forced): the last as alone
    z_all, W_all = marker_scan_ref(
        T(gram, f64), T(gix), T(u0, f64), T(W0, f64), T(w, f64), T(eta, f64), T(lam_e, f64),
        T(pi, f64), T(rm, f64), T(cm, f64), False, T(order), T(uz, f64), T(na, f64), T(xi, f64))
    z_r, W_r = _residual_replica(xs[1], e[2], W0[2], w[2], eta[2], lam_e[2], pi[2], rm[2], cm[2],
                                 False, order[2], uz[2], na[2], xi[2])
    np.testing.assert_array_equal(z_all[2].numpy(), z_r)
    np.testing.assert_allclose(W_all[2].numpy(), W_r, rtol=1e-9, atol=1e-12)


# ------------------------------------------------------- 2. the Gibbs draws


@pytest.mark.parametrize("mu,lam", [(1.0, 1.0), (0.5, 4.0), (3.0, 0.8)])
def test_inverse_gaussian_moments_match_jax(mu, lam):
    """InvGauss(mu, lam): mean mu, variance mu^3 / lam; the port's 200,000
    draws and JAX's agree on the mean within 4 standard errors of their
    difference, with each other and with the law, and on the variance
    within 10%."""
    N = 200_000
    t = TG.inverse_gaussian(torch.Generator().manual_seed(3), torch.full((N,), mu), lam).numpy()
    j = np.asarray(JG.inverse_gaussian(jax.random.key(7), jnp.full(N, mu), lam))
    var = mu ** 3 / lam
    assert t.dtype == np.float32 and np.all(t > 0) and np.all(np.isfinite(t))
    assert abs(t.mean() - j.mean()) <= 4 * np.sqrt(2 * var / N)
    assert abs(t.mean() - mu) <= 4 * np.sqrt(var / N)
    assert abs(t.var() - var) <= 0.1 * var and abs(t.var() - j.var()) <= 0.1 * var


def test_inverse_gaussian_extremes_stay_finite():
    """mu far past the 1e12 cap (a weight at the 1e-12 floor) and tiny mu:
    positive finite draws, as JAX's."""
    mu = torch.tensor([1e18, 1e12, 1e-6, 1.0])
    t = TG.inverse_gaussian(torch.Generator().manual_seed(0), mu.repeat(1000), 4.0)
    assert torch.all(t > 0) and torch.all(torch.isfinite(t))


def _ard_block(N, m=10, k=4, seed=0):
    arch = NetArch.from_width_rules([m] * N, 0, ("fixed", k), ("fixed", k),
                                    activation="identity")
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((N, arch.m_pad, arch.s_pad)) * 0.5).astype(np.float32)
    b = np.zeros((N, arch.s_pad), np.float32)
    st = TD.branch_statics(port(arch), "cpu")
    return arch, T(w), T(b), st, rng


def test_excluded_rows_take_the_prior_precision():
    """With z_rows0, an excluded layer-0 row's precision is a Gamma(shape,
    scale) prior draw (mean 1, variance 0.5 here), an included one the
    posterior's (the draw without z_rows0 in law: mean ratio 1); the floor
    still applies; under the default near-improper prior the excluded
    draws are clipped into [1e-6, 1e8]."""
    N = 400
    arch, w, b, st, rng = _ard_block(N)
    z0 = T((rng.random((N, arch.m_pad)) < 0.5).astype(np.float32))
    hyper = TD.Hyperparameters(2.0, 0.5, 2.0, 0.5, 1.0, 1.0)
    gen = torch.Generator().manual_seed(0)
    wb, bb = (w, w[:, :, :1] * 0.0 + 0.1), (b,)
    (lam,), _ = TN._gibbs_local_precisions(gen, "ridge_ard", wb, bb, st, hyper, 2, z_rows0=z0)
    lam = lam[..., 0]
    true = st.row_masks[0][..., 0] > 0
    exc, inc = lam[(z0 == 0) & true], (z0 > 0) & true
    assert abs(float(exc.mean()) - 1.0) <= 4 * np.sqrt(0.5 / exc.numel())
    assert abs(float(exc.var()) - 0.5) <= 0.1
    # included rows: the ridge posterior Gamma(k + n_out / 2, 2 s / (2 + s sum w^2))
    k_post = 2.0 + st.out_counts[0][:, None] / 2.0
    th = 2 * 0.5 / (2.0 + 0.5 * torch.sum(w * w, dim=-1))
    ratio = (lam / (k_post * th))[inc]
    assert abs(float(ratio.mean()) - 1.0) <= 4 * float(ratio.std()) / np.sqrt(ratio.numel())
    (lam_f,), _ = TN._gibbs_local_precisions(gen, "ridge_ard", wb, bb, st, hyper, 2,
                                              lam_floor=0.7, z_rows0=z0)
    assert float(lam_f.min()) >= np.float32(0.7)
    (lam_d,), _ = TN._gibbs_local_precisions(gen, "lasso_ard", wb, bb, st,
                                              TD.Hyperparameters(), 2, z_rows0=z0)
    exc = lam_d[..., 0][z0 == 0]
    assert float(exc.min()) >= np.float32(1e-6) and float(exc.max()) <= np.float32(1e8)


def test_ssm_sweep_end_draws_pi_and_averages_z():
    """pi ~ Beta(1 + nz, 1 + M - nz) per chain (moments of 4,000 chains'
    draws within 4 standard errors, in [1e-4, 0.999]); fixed pi stays; the
    PIPs move only after burn-in, to the mean of z over those sweeps."""
    C, G, m_pad = 4000, 2, 8
    rows = torch.ones((G, m_pad))
    rows[1, 6:] = 0.0  # M = 14 true markers
    z = torch.zeros((C, G, m_pad))
    z[:, 0, :3] = 1.0
    z[:, 1, 7] = 1.0  # a padded marker: not counted
    carry = TN.TrainCarry(**dict.fromkeys(TN.TrainCarry._fields[:-4]), ssm_z=z,
                          ssm_pi=torch.full((C,), 0.5), ssm_pip=torch.zeros((C, G, m_pad)),
                          sweeps=2)
    cfg = port(MCMCCfg(burn_in=2, ss_markers=True))
    out = TN._ssm_sweep_end(torch.Generator().manual_seed(0), carry, cfg, rows)
    a, b = 1.0 + 3, 1.0 + 14 - 3
    mean, var = a / (a + b), a * b / ((a + b) ** 2 * (a + b + 1))
    pi = out.ssm_pi
    assert abs(float(pi.mean()) - mean) <= 4 * np.sqrt(var / C)
    assert abs(float(pi.var()) - var) <= 0.1 * var
    assert float(pi.min()) >= 1e-4 and float(pi.max()) <= 0.999
    assert torch.all(out.ssm_pip == 0)  # sweeps == burn_in: not yet
    fixed = TN._ssm_sweep_end(torch.Generator(), carry, port(MCMCCfg(
        burn_in=2, ss_markers=True, ssm_fixed_pi=True)), rows)
    assert fixed.ssm_pi is carry.ssm_pi
    pip = torch.zeros((1, G, m_pad))
    zs = [(torch.rand((1, G, m_pad)) < 0.5).float() for _ in range(3)]
    fixed_cfg = port(MCMCCfg(burn_in=2, ss_markers=True, ssm_fixed_pi=True))
    for k, zk in enumerate(zs):
        c = carry._replace(ssm_z=zk, ssm_pi=torch.full((1,), 0.5), ssm_pip=pip, sweeps=3 + k)
        TN._ssm_sweep_end(torch.Generator(), c, fixed_cfg, rows)
    torch.testing.assert_close(pip, torch.stack(zs).mean(0), rtol=1e-6, atol=1e-7)


# --------------------------------------------------------- 3. the row pins


def _pinned_block(C, B, m=8, k=4, n=300, seed=0):
    """A depth-0 identity ridge_ard block of C chains x B branches with rows
    2 and 5 excluded: zero rows whose precision is 0, so izmailov's step on
    them is infinite."""
    arch = NetArch.uniform(B, m, k, 0, k, activation="identity")
    bed, grouping, y = _toy(B, m, n, seed=seed)
    data = t_pack_stacked(port(arch), bed, grouping, y, "cpu")
    rng = np.random.default_rng(seed)
    w0 = rng.standard_normal((C, B, arch.m_pad, arch.s_pad)).astype(np.float32) * 0.3
    wo = rng.standard_normal((C, B, arch.s_pad, 1)).astype(np.float32)
    lam0 = rng.uniform(0.5, 2.0, (C, B, arch.m_pad, 1)).astype(np.float32)
    pins = np.ones((C, B, arch.m_pad), np.float32)
    pins[..., [2, 5]] = 0.0
    w0[..., [2, 5], :] = 0.0
    lam0[..., [2, 5], :] = 0.0
    ws = (T(w0), T(wo))
    bs = (torch.zeros((C, B, arch.s_pad)),)
    wps = (T(lam0), torch.full((C, B, 1, 1), 2.0))
    bps = (torch.ones((C, B, 1)),)
    masks_w = tuple(m_[None].expand(C, -1, -1, -1) for m_ in TP.weight_masks(port(arch), "cpu"))
    masks_b = tuple(m_[None].expand(C, -1, -1) for m_ in TP.bias_masks(port(arch), "cpu"))
    gen = torch.Generator().manual_seed(1)
    momenta = (tuple(torch.randn(w.shape, generator=gen) for w in ws),
               tuple(torch.randn(b_.shape, generator=gen) for b_ in bs))
    targets = data.y.expand(C, B, -1) * 0.1
    return arch, data.X, ws, bs, wps, bps, masks_w, masks_b, momenta, targets, T(pins)


def _check_pinned(w0, y, pins):
    assert torch.all(torch.isfinite(w0)) and torch.all(torch.isfinite(y))
    assert torch.all(w0[pins == 0] == 0)
    assert torch.any(w0[pins > 0] != 0)


@pytest.mark.parametrize("path", ["fold-packed", "fold-dense", "step", "lean-step",
                                  "lean-batch"])
def test_row_pins_keep_excluded_rows_at_zero(path):
    C, B = 2, 2
    arch, X, ws, bs, wps, bps, mw, mb, momenta, targets, pins = _pinned_block(C, B)
    cfg = port(MCMCCfg(hmc_integration_length=5, hmc_step_size_factor=0.1))
    eps_w, _ = TH.step_sizes(None, "ridge_ard", cfg, ws, bs, wps, bps, None)
    assert torch.all(torch.isinf(eps_w[0][pins == 0]))  # what the pins must not pass on
    err = torch.tensor([0.02, 0.03])  # a stable trajectory at these steps
    if path.startswith("fold"):
        x = X if path == "fold-packed" else TD.FeatX(TD._standardized_rows(X, 0, B))
        fold = TH.make_transition_batch("ridge_ard", "identity", cfg)
        prop = fold(ws, bs, wps, bps, err, x, targets, mw, mb, momenta, row_pins=pins)
        _check_pinned(prop.weights[0], prop.y_pred_prop, pins)
        assert not torch.any(prop.dead)
        return
    if path == "lean-batch":
        xf = TD.FeatX(TD._standardized_rows(X, 0, B))
        lean = TH.make_lean_batch("ridge_ard", "identity", cfg)

        def flat(ts):
            return tuple(t.reshape((C * B,) + t.shape[2:]) for t in ts)

        prop = lean(None, flat(ws), flat(bs), flat(wps), flat(bps), err.repeat_interleave(B), xf,
                    torch.arange(B).repeat(C).to(torch.int32), targets.reshape(C * B, -1),
                    flat(mw), flat(mb), torch.full((C * B,), 40.0),
                    (flat(momenta[0]), flat(momenta[1])), row_pins=pins.reshape(C * B, -1))
        _check_pinned(prop.weights[0], prop.y_pred_prop, pins.reshape(C * B, -1))
        return
    step = TH.make_hmc_step("ridge_ard", "identity", cfg, defer_accept=path == "lean-step")
    for c in range(C):
        for j in range(B):
            def one(ts):
                return tuple(t[c, j] for t in ts)

            out = step(torch.Generator().manual_seed(c), one(ws), one(bs), one(wps), one(bps),
                       err[c], X[j], targets[c, j], one(mw), one(mb), torch.tensor(40.0),
                       momenta=(one(momenta[0]), one(momenta[1])), u=0.0,
                       row_pins=pins[c, j])
            y = out.y_pred_prop if path == "lean-step" else out.y_pred
            _check_pinned(out.weights[0], y, pins[c, j])
            if path == "step":
                assert int(out.code) == 0  # u = 0 accepts a live trajectory


# ------------------------------------------------------------ 4. the sweeps


def _ssm_cfg(**kw):
    base = dict(hmc_integration_length=4, hmc_step_size_factor=0.3, ss_markers=True,
                ssm_pi=0.3, ssm_warmup=1, burn_in=1, seed=0)
    base.update(kw)
    return port(MCMCCfg(**base))


@pytest.mark.parametrize("layout,model_type", [("packed", "ridge_ard"), ("packed", "lasso_ard"),
                                               ("feat", "ridge_ard")])
def test_ss_markers_folded_sweep_matches_unfolded(layout, model_type):
    """Packed hybrid (blocks of 2) and feature-major parallel sweeps, C = 2,
    ss_markers with a warm-up of one sweep and a learned pi, 3 sweeps:
    folded and unfolded from one generator state give the same z, the same
    accept decisions and the same chain within rtol 2e-4, atol 2e-5."""
    C, G, m = 2, 4, 8
    arch = NetArch.uniform(G, m, 4, 0, 4, activation="identity")
    jstate, _ = JI.init_net(arch, model_type, JI.InitCfg(seed=0))
    if layout == "packed":
        bed, grouping, y = _toy(G, m, 333, seed=4)
        td = t_pack_stacked(port(arch), bed, grouping, y, "cpu")
    else:
        *_, td = _feat_data(G, m, 333, 4, arch)
    cfg = _ssm_cfg(update_mode="hybrid" if layout == "packed" else "parallel", block_size=2,
                   num_chains=C, chain_length=3)
    assert TN.chain_fold_eligible(model_type, "identity", cfg)
    runs = []
    for fold in (True, False):
        net = prepare_state_for_training(TN.Net(
            model_type, port(arch), TD.Hyperparameters(*HYPER),
            TP.state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")), None)
        sweep = TN.make_hybrid_sweep(model_type, "identity", port(arch), cfg, net.hyper, "cpu",
                                     fold=fold)
        carry = net.init_carry(td.X, td.y, chains=C, ss_markers=True, ssm_pi=0.3)
        td.X.form_gram()
        gen = torch.Generator().manual_seed(1)
        for _ in range(3):
            carry, st = sweep(carry, td.X, td.y, gen)
        runs.append((carry, st))
    (cf, sf), (cu, su) = runs
    assert torch.equal(cf.ssm_z, cu.ssm_z) and torch.equal(sf.counts, su.counts)
    n_true = int(TD.branch_statics(port(arch), "cpu").row_masks[0].sum())
    assert 0 < int(cf.ssm_z.sum()) < n_true * C
    _close(cf.residual, cu.residual, rtol=2e-4, atol=2e-5)
    for a, b in zip(TP.state_leaves(cf.state), TP.state_leaves(cu.state)):
        _close(a, b, rtol=2e-4, atol=2e-5)
    _close(cf.ssm_pi, cu.ssm_pi, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(cf.ssm_pip, cu.ssm_pip)
    excluded = cf.ssm_z == 0
    assert torch.all(cf.state.params.weights[0][excluded] == 0)


@pytest.mark.parametrize("schedule,layout", [("sequential", "packed"),
                                             ("per-chain-blocks", "packed"),
                                             ("per-chain-blocks", "feat")])
def test_ss_markers_schedules_pin_excluded_rows(schedule, layout):
    """The sequential schedule (C = 2, one chain after another) and the
    hybrid with each chain's own block permutation (its scans one call per
    block, u0 per chain), 3 sweeps: excluded rows exactly 0, the carry
    finite, the PIPs the mean of z over the sweeps after burn-in, pi
    learned per chain."""
    G, m = 4, 10
    arch = NetArch.uniform(G, m, 4, 0, 4, activation="identity")
    jstate, _ = JI.init_net(arch, "ridge_ard", JI.InitCfg(seed=0))
    if layout == "packed":
        bed, grouping, y = _toy(G, m, 300, seed=2)
        td = t_pack_stacked(port(arch), bed, grouping, y, "cpu")
    else:
        *_, td = _feat_data(G, m, 300, 2, arch)
    net = prepare_state_for_training(TN.Net(
        "ridge_ard", port(arch), TD.Hyperparameters(*HYPER),
        TP.state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")), None)
    kw = {} if schedule == "sequential" else dict(update_mode="hybrid", block_size=2,
                                                   hybrid_shared_perm=False)
    cfg = _ssm_cfg(num_chains=2, chain_length=3, **kw)
    assert schedule == "sequential" or not TN.chain_fold_eligible("ridge_ard", "identity", cfg)
    sweep = net.make_chain_sweep(cfg)
    carry = net.init_carry(td.X, td.y, chains=2, ss_markers=True, ssm_pi=0.3)
    td.X.form_gram()
    gen = torch.Generator().manual_seed(0)
    zs = []
    for _ in range(3):
        carry, st = sweep(carry, td.X, td.y, gen)
        zs.append(carry.ssm_z.clone())
    assert torch.all(carry.state.params.weights[0][carry.ssm_z == 0] == 0)
    assert torch.all(torch.isfinite(carry.residual)) and torch.any(carry.ssm_z == 0)
    torch.testing.assert_close(carry.ssm_pip, torch.stack(zs[1:]).mean(0))
    assert carry.ssm_pi.shape == (2,) and not torch.equal(carry.ssm_pi, torch.full((2,), 0.3))
    assert int(st.counts.sum()) == 3 * 2 * G


@pytest.mark.parametrize("schedule", ["sequential", "hybrid"])
def test_ss_markers_sweep_needs_the_grams(schedule):
    """A sweep with the marker scan refuses data whose branch Grams were
    not formed (``X.form_gram()``, which ``train`` calls once per run)
    rather than forming them inside a sampling sweep."""
    G, m = 2, 6
    arch = NetArch.uniform(G, m, 4, 0, 4, activation="identity")
    bed, grouping, y = _toy(G, m, 120, seed=2)
    td = t_pack_stacked(port(arch), bed, grouping, y, "cpu")
    jstate, _ = JI.init_net(arch, "ridge_ard", JI.InitCfg(seed=0))
    net = prepare_state_for_training(TN.Net(
        "ridge_ard", port(arch), TD.Hyperparameters(*HYPER),
        TP.state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")), None)
    kw = {} if schedule == "sequential" else dict(update_mode="hybrid", block_size=1)
    sweep = net.make_chain_sweep(_ssm_cfg(num_chains=1, **kw))
    carry = net.init_carry(td.X, td.y, chains=1, ss_markers=True, ssm_pi=0.3)
    with pytest.raises(ValueError, match="form_gram"):
        sweep(carry, td.X, td.y, torch.Generator().manual_seed(0))
    td.X.form_gram()
    carry, _ = sweep(carry, td.X, td.y, torch.Generator().manual_seed(0))
    assert torch.all(torch.isfinite(carry.residual))


def test_init_carry_ss_markers_state_matches_jax():
    arch = NetArch.uniform(3, 10, 4, 0, 4, activation="identity")
    bed, grouping, y = _toy(3, 10, 200, seed=1)
    jstate, _ = JI.init_net(arch, "ridge_ard", JI.InitCfg(seed=0))
    jd = j_pack_stacked(arch, bed, grouping, y)
    jc = JN.Net("ridge_ard", arch, JD.Hyperparameters(*HYPER), jstate).init_carry(
        jd.X, jd.y, jax.random.key(0), ss_markers=True, ssm_pi=0.2)
    td = t_pack_stacked(port(arch), bed, grouping, y, "cpu")
    tnet = TN.Net("ridge_ard", port(arch), TD.Hyperparameters(*HYPER),
                  TP.state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu"))
    for chains in (None, 2):
        tc = tnet.init_carry(td.X, td.y, chains=chains, ss_markers=True, ssm_pi=0.2)
        lead = () if chains is None else (2,)
        for name in ("ssm_z", "ssm_pi", "ssm_pip"):
            j = np.asarray(getattr(jc, name))
            want = np.broadcast_to(j, lead + j.shape)
            np.testing.assert_array_equal(getattr(tc, name).numpy(), want)
    off = tnet.init_carry(td.X, td.y, chains=2)
    assert off.ssm_z.shape == (2, 3, 0) and off.ssm_pip.shape == (2, 3, 0)


@pytest.mark.parametrize("model_type,act,depth", [("ridge_ard", "tanh", 0),
                                                  ("ridge_ard", "identity", 1),
                                                  ("ridge_base", "identity", 0)])
def test_ss_markers_refused_where_jax_refuses(model_type, act, depth):
    arch = NetArch.uniform(2, 8, 4, depth, 4, activation=act)
    cfg = _ssm_cfg(update_mode="hybrid", num_chains=2)
    assert TN.ssm_unsupported(model_type, port(arch))
    for make in (TN.make_hybrid_sweep, TN.make_sweep):
        with pytest.raises(NotImplementedError):
            make(model_type, act, port(arch), cfg, TD.Hyperparameters(), "cpu")
    with pytest.raises(AssertionError):
        JN.make_sweep(model_type, act, arch, MCMCCfg(ss_markers=True), JD.Hyperparameters())
    assert "ss_markers" not in TN.unported_options(cfg)


def test_ss_markers_ensembles_match_jax():
    """PIPs and the learned pi, port against JAX: R independent hybrid
    chains per package from one initial state (one block of all G
    branches, so the block permutation, drawn by the packages from
    different generators, does not change the kernel), ss_markers with a
    warm-up of one sweep and pi learned from 0.3, T sweeps, burn-in 3. Each
    chain's summaries: its PIP per marker (the mean of z over the sweeps
    after burn-in, the carry's running mean) and its mean pi over those
    sweeps. Bound per summary, as tests/test_torch_hybrid.py: |mean_port -
    mean_jax| <= 4 sqrt(var_port / R + var_jax / R), plus 1e-6 for a
    marker both packages always include."""
    G, m, n, L, R, burn, T_ = 4, 12, 256, 4, 24, 3, 10
    bed, grouping, y = _toy(G, m, n, seed=8)
    arch = NetArch.from_width_rules([m] * G, 0, ("fixed", 4), ("fixed", 4), activation="identity")
    cfg = MCMCCfg(hmc_integration_length=L, hmc_step_size_factor=0.2, chain_length=T_,
                  burn_in=burn, update_mode="hybrid", block_size=G, num_chains=R,
                  ss_markers=True, ssm_pi=0.3, ssm_warmup=1)
    jstate, _ = JI.init_net(arch, "ridge_ard", JI.InitCfg(seed=1))
    jnet = j_prepare(JN.Net("ridge_ard", arch, JD.Hyperparameters(*HYPER), jstate), None)
    jd = j_pack_stacked(arch, bed, grouping, y)
    jsweep = jax.jit(jax.vmap(jnet.make_sweep(cfg), in_axes=(0, None, None)))
    carry = jax.jit(jax.vmap(lambda k: jnet.init_carry(jd.X, jd.y, k, ss_markers=True,
                                                       ssm_pi=0.3)))(
        jax.random.split(jax.random.key(0), R))
    j_pi = []
    for _ in range(T_):
        carry, _ = jsweep(carry, jd.X, jd.y)
        j_pi.append(np.asarray(carry.ssm_pi))
    j_pip = np.asarray(carry.ssm_pip)

    td = t_pack_stacked(port(arch), bed, grouping, y, "cpu")
    tnet = prepare_state_for_training(TN.Net(
        "ridge_ard", port(arch), TD.Hyperparameters(*HYPER),
        TP.state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")), None)
    tsweep = tnet.make_chain_sweep(port(cfg))
    tcarry = tnet.init_carry(td.X, td.y, chains=R, ss_markers=True, ssm_pi=0.3)
    td.X.form_gram()
    gen = torch.Generator().manual_seed(0)
    t_pi = []
    for _ in range(T_):
        tcarry, st = tsweep(tcarry, td.X, td.y, gen)
        t_pi.append(tcarry.ssm_pi.numpy().copy())
    t_pip = tcarry.ssm_pip.numpy()

    counts = st.counts.sum(dim=0)
    assert int(counts[0]) / int(counts.sum()) > 0.2  # the comparison needs moving chains
    true = np.asarray(TD.branch_statics(port(arch), "cpu").row_masks[0][..., 0]) > 0
    t_sum = np.concatenate([t_pip[:, true], np.asarray(t_pi).T[:, burn:].mean(1)[:, None]], 1)
    j_sum = np.concatenate([j_pip[:, true], np.asarray(j_pi).T[:, burn:].mean(1)[:, None]], 1)
    bound = 4 * np.sqrt(t_sum.var(0, ddof=1) / R + j_sum.var(0, ddof=1) / R) + 1e-6
    diff = np.abs(t_sum.mean(0) - j_sum.mean(0))
    assert np.all(diff <= bound), (diff - bound).max()
    assert 0.05 < t_pip[:, true].mean() < 0.95  # markers both in and out


@pytest.mark.parametrize("extra", [[], ["--gd-warmup", "1"]], ids=["", "gd-warmup"])
def test_cli_train_new_writes_inclusion_probs(tmp_path, extra):
    """train-new --ss-markers on the CPU (packed hybrid, C = 4, the
    recipe's adaptation; after a GD warm start too, which runs no scan):
    ``inclusion_probs`` with pip_markers per branch of its true m, in [0,
    1], and pi_markers at the fixed pi; the saved samples' excluded rows
    are 0 where the PIP is 0."""
    G, m, n = 3, 10, 400
    bed, grouping, y = _toy(G, m, n, seed=3)
    bed.to_file(str(tmp_path / "train"))
    Phenotypes(y).to_file(str(tmp_path / "train.phen"))
    grouping.to_file(str(tmp_path / "train"))
    out = tmp_path / "runs"
    cli(["train-new", str(tmp_path / "train"), str(tmp_path / "train.phen"),
         str(tmp_path / "train.groups"), "ridge_ard", "identity", "0", "4", "5",
         "--fixed-hidden-layer-width", "4", "--packed-genotypes", "--update-mode", "hybrid",
         "--num-chains", "4", "--burn-in", "2", "--step-size-mode", "dual_averaging",
         "--mass-adaptation", "--ss-markers", "--ssm-fixed-pi", "--ssm-pi", "0.2",
         "--ssm-warmup", "1", "--cpu", "-o", str(out), *extra])
    (run,) = list(out.iterdir())
    assert "_ssm" in run.name
    probs = json.load(open(run / "inclusion_probs"))
    assert [len(p) for p in probs["pip_markers"]] == [m] * G
    pip = np.asarray(probs["pip_markers"])
    assert np.all((pip >= 0) & (pip <= 1)) and probs["pi_markers"] == pytest.approx(0.2)
    assert np.any(pip < 1)
    w0 = np.load(run / "models" / "chain0" / "4.npz")["w0"]
    assert np.all(w0[:, :m][pip == 0] == 0)
    assert os.path.exists(run / "models" / "chain3" / "4.npz")


@pytest.mark.parametrize("model_type,act", [("ridge_ard", "tanh"), ("ridge_base", "identity")])
def test_cli_refuses_ss_markers_where_jax_refuses(tmp_path, model_type, act):
    bed, grouping, y = _toy(2, 8, 200, seed=1)
    bed.to_file(str(tmp_path / "train"))
    Phenotypes(y).to_file(str(tmp_path / "train.phen"))
    grouping.to_file(str(tmp_path / "train"))
    with pytest.raises(SystemExit) as e:
        cli(["train-new", str(tmp_path / "train"), str(tmp_path / "train.phen"),
             str(tmp_path / "train.groups"), model_type, act, "0", "2", "3",
             "--packed-genotypes", "--ss-markers", "--cpu", "-o", str(tmp_path / "runs")])
    assert "ss_markers needs" in str(e.value.code)
    assert not (tmp_path / "runs").exists()  # refused before writing anything
