"""The packed kernels' new shapes on the CPU: depth above 1 and padded
widths up to 64 (the JAX CLI's default width rule gives h = s = 50, padded
56, at a group of 100 markers), against the JAX package.

The port's plain versions of K4 and K5 (which its kernels are held to on
the card) run the shapes the card now takes; the JAX package runs its
Pallas kernels in interpret mode (f32), as its own tests run them. The
same numpy inputs go through both.

1. ``data_vg_packed`` at depth 2 and 3 and at widths 40 and 56 (n ragged:
   not a multiple of the 512-individual pack group): rtol 1e-4 of each
   array's largest entry (sums over n in another order), y_pred atol 1e-5.
2. ``integrate_chains_packed`` at depth 2, width 40, C = 2, and at depth 0,
   width 56: rtol 1e-4 with the JAX package's atol 3e-5 for its kernel
   against autodiff (each step's gradient a sum over n, L steps compound).
3. The folded hybrid block transition at depth 2 draw for draw, the
   momenta JAX's chain rule derives handed to the port: rtol 1e-4.
4. An ensemble of independent depth-2 tanh hybrid chains, port against
   JAX, by the paired 4-SE bound of tests/test_torch_slice.py.
5. The marker scan at width 56 (identity depth 0 at the default width
   rule) draw for draw against JAX's ``_marker_ss_scan``.
6. The rules the CLI asks (K4's and K5's shared memory) at the new shapes.
"""

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
from rs_bann_tpu.ops import branch_mlp as JBM
from rs_bann_tpu.ops import leapfrog as JL
from rs_bann_tpu.ops.packed_matmul import pack_strided
from rs_bann_tpu.samplers.mcmc_cfg import MCMCCfg
from rs_bann_tpu.train import prepare_state_for_training as j_prepare
from rs_bann_tpu_torch.models import density as TD
from rs_bann_tpu_torch.models import net as TN
from rs_bann_tpu_torch.models import params as TP
from rs_bann_tpu_torch.models.data import pack_stacked as t_pack_stacked
from rs_bann_tpu_torch.ops import branch_mlp as TBM
from rs_bann_tpu_torch.ops import leapfrog as TL
from rs_bann_tpu_torch.ops.marker_scan import marker_scan_ref
from rs_bann_tpu_torch.samplers import hmc as TH
from rs_bann_tpu_torch.train import prepare_state_for_training
from test_torch_copies import port
from test_torch_hybrid import _close, _fold_case
from test_torch_slice import HYPER, _toy
from test_torch_ss_markers import _jax_draws, _scan_problem

M, M_PAD, N = 20, 24, 700


@pytest.fixture(autouse=True)
def _interpret():
    JBM.FORCE = "interpret"
    try:
        yield
    finally:
        JBM.FORCE = None


def T(a):
    return tuple(map(torch.from_numpy, a)) if isinstance(a, tuple) else torch.from_numpy(a)


def J(a):
    return tuple(map(jnp.asarray, a)) if isinstance(a, tuple) else jnp.asarray(a)


def _widths(depth, h, s):
    """Layer shapes [(in, out)] of a branch: [h] * depth + [s, 1]."""
    outs = [h] * depth + [s, 1]
    return list(zip([M_PAD] + outs[:-1], outs))


def _geno(rng, G):
    vals = np.zeros((G, M_PAD, N), np.float32)
    vals[:, :M] = rng.integers(0, 3, size=(G, M, N))
    by = np.stack([pack_strided(v) for v in vals])
    scale = np.zeros((G, M_PAD), np.float32)
    shift = np.zeros((G, M_PAD), np.float32)
    scale[:, :M] = 1.0 / vals[:, :M].std(axis=2)
    shift[:, :M] = vals[:, :M].mean(axis=2)
    return by, scale, shift


# ------------------------------------------------- 1. K4's plain version

VG_CASES = [  # depth, hidden width h, summary width s, activation
    (2, 8, 8, "tanh"),
    (3, 16, 8, "silu"),
    (2, 40, 40, "leaky_relu"),
    (2, 56, 56, "tanh"),
    (0, 56, 56, "identity"),
    (1, 40, 56, "relu"),
]


@pytest.mark.parametrize("depth,h,s,act", VG_CASES, ids=lambda a: str(a))
def test_data_vg_packed_matches_jax_at_the_new_shapes(depth, h, s, act):
    rng = np.random.default_rng(depth * 100 + h + s)
    by, scale, shift = (a[0] for a in _geno(rng, 1))
    ws = tuple((rng.standard_normal(d) * 0.3 / np.sqrt(d[0] / 8)).astype(np.float32)
               for d in _widths(depth, h, s))
    bs = tuple((rng.standard_normal(d[1]) * 0.1).astype(np.float32)
               for d in _widths(depth, h, s)[:-1])
    target = rng.standard_normal(N).astype(np.float32)
    jy, jrss, jdws, jdbs = JBM.data_vg_packed(
        act, JD.PackedX(J(by), J(scale), J(shift), N), J(ws), J(bs), J(target))
    ty, trss, tdws, tdbs = TBM.data_vg_packed(
        act, TD.PackedX(T(by), T(scale), T(shift), N), T(ws), T(bs), T(target))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(float(trss), float(jrss), rtol=1e-4)
    assert len(tdws) == len(jdws) == depth + 2 and len(tdbs) == len(jdbs) == depth + 1
    for t, j in zip(tdws + tdbs, jdws + jdbs):
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4 * np.abs(np.asarray(j)).max())
    assert np.all(tdws[0].numpy()[M:] == 0)  # padded marker rows never move


# --------------------------------------------------- 2. K5's plain version

TRAJ_CASES = [  # activation, l1, depth, h, s
    ("tanh", False, 2, 40, 40),
    ("identity", True, 0, 56, 56),
]


def _traj_inputs(depth, h, s, seed=1):
    rng = np.random.default_rng(seed)
    G, C = 2, 2
    shapes = _widths(depth, h, s)

    def mk(sc):
        return tuple((rng.standard_normal((G, C, i, o)) * sc / np.sqrt(i / 8)).astype(np.float32)
                     for i, o in shapes)

    def mkb(sc):
        return tuple((rng.standard_normal((G, C, o)) * sc).astype(np.float32) for _, o in shapes[:-1])

    by, scale, shift = _geno(rng, G)
    weights, p_w = mk(0.3), mk(0.5)
    eps_w = tuple(np.abs(e) * 0.01 for e in mk(1.0))
    lam_w = tuple(np.abs(e) + 0.5 for e in mk(1.0))
    biases, p_b = mkb(0.1), mkb(0.5)
    eps_b = tuple(np.abs(e) * 0.01 for e in mkb(1.0))
    lam_b = tuple(np.zeros_like(e) for e in mkb(1.0))
    targets = rng.standard_normal((G, C, N)).astype(np.float32)
    err = (np.abs(rng.standard_normal((G, C))) + 0.5).astype(np.float32)
    return (by, scale, shift, targets, err, weights, biases, p_w, p_b, eps_w, eps_b, lam_w, lam_b)


@pytest.mark.parametrize("act,l1,depth,h,s", TRAJ_CASES, ids=lambda a: str(a))
def test_integrate_chains_packed_matches_jax_at_the_new_shapes(act, l1, depth, h, s):
    args = _traj_inputs(depth, h, s)
    jout = JL.integrate_chains_packed(act, *map(J, args), 4, N, l1=l1, interpret=True)
    tout = TL.integrate_chains_packed(act, *map(T, args), 4, N, l1=l1)
    for tpart, jpart in zip(tout, jout):
        assert len(tpart) == len(jpart)
        for t, j in zip(tpart, jpart):
            assert t.shape == j.shape
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=3e-5,
                                       rtol=1e-4)


# ----------------------------------------- 3. the folded block transition


# model type, activation, width, step-size mode, step factor: at width 40 a
# step small enough that no trajectory diverges (JAX's izmailov step at
# factor 0.01 already kills half of them), so the comparison runs on
# trajectories that stay in range
FOLD2_CASES = [("ridge_ard", "tanh", 6, "izmailov", 0.1),
               ("ridge_ard", "tanh", 40, "std_scaled", 0.002)]


@pytest.mark.parametrize("model_type,act,width,mode,factor", FOLD2_CASES)
def test_folded_depth2_transition_draw_for_draw(model_type, act, width, mode, factor):
    fold_args, jp, cfg = _fold_case(model_type, act, 2, mode, factor, width=width)
    tp = TH.make_transition_batch(model_type, act, cfg)(*fold_args)
    np.testing.assert_array_equal(tp.dead.numpy(), np.asarray(jp.dead))
    assert len(tp.weights) == 4
    for t, j in zip(tp.weights + tp.biases, tuple(jp.weights) + tuple(jp.biases)):
        _close(t, j, atol=1e-6)
    for f in ("y_pred_prop", "y_pred0", "prior_prop", "prior0", "kin_prop", "kin0"):
        _close(getattr(tp, f), getattr(jp, f))


# --------------------------------------------------------- 4. posteriors


def test_depth2_hybrid_chains_posterior_matches_jax():
    """Posterior means of the error precision and the train mse after
    burn-in at depth 2, tanh: R independent hybrid chains per package from
    one initial state (the port's in one folded run of R chains, the
    schedule train-new runs), each chain summarized by its mean over sweeps
    burn+1..T.

    Bound: |mean_port - mean_jax| <= 4 * sqrt(var_port / R + var_jax / R),
    the exact standard error of the difference of independent chain
    summaries. One block holds every branch, so the block permutation,
    which the two packages draw from different generators, does not change
    the Markov kernel.
    """
    G, m, n, L, R, burn, T_ = 2, 10, N, 4, 24, 3, 8
    bed, grouping, y = _toy(G, m, n, seed=8)
    arch = NetArch.from_width_rules([m] * G, 2, ("fixed", 4), ("fixed", 4), activation="tanh")
    cfg = MCMCCfg(hmc_integration_length=L, hmc_step_size_factor=0.2, chain_length=T_,
                  update_mode="hybrid", block_size=G, num_chains=R)
    jstate, _ = JI.init_net(arch, "ridge_ard", JI.InitCfg(seed=1))

    jnet = j_prepare(JN.Net("ridge_ard", arch, JD.Hyperparameters(*HYPER), jstate), None)
    jd = j_pack_stacked(arch, bed, grouping, y)
    jsweep = jax.jit(jax.vmap(jnet.make_sweep(cfg), in_axes=(0, None, None)))
    carry = jax.jit(jax.vmap(lambda k: jnet.init_carry(jd.X, jd.y, k)))(
        jax.random.split(jax.random.key(0), R))
    j_err, j_mse = [], []
    for _ in range(T_):
        carry, st = jsweep(carry, jd.X, jd.y)
        j_err.append(np.asarray(carry.state.precisions.error))
        j_mse.append(np.asarray(st.mse_train))

    td = t_pack_stacked(port(arch), bed, grouping, y, "cpu")
    tnet = prepare_state_for_training(TN.Net(
        "ridge_ard", port(arch), TD.Hyperparameters(*HYPER),
        TP.state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")), None)
    tsweep = TN.make_hybrid_sweep("ridge_ard", "tanh", port(arch), port(cfg), tnet.hyper, "cpu")
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


# ------------------------------------------------------ 5. the marker scan


@pytest.mark.parametrize("lasso", [False, True], ids=["ridge_ard", "lasso_ard"])
def test_marker_scan_at_width_56_matches_jax_draw_for_draw(lasso):
    """The scan at the default width rule's layer 0 (50 columns padded to
    56, beyond one column a lane of the kernel's warp)."""
    x, jx, tx, W0, w_out, resid0, lam_rows, rm, cm = _scan_problem(
        True, lasso, seed=7, s_true=50, s=56)
    lam_e, pi = 1.7, 0.4
    key = jax.random.key(13)
    z_j, W_j, _ = JN._marker_ss_scan(
        key, jx, jnp.asarray(W0), jnp.zeros(W0.shape[1]), jnp.asarray(w_out),
        jnp.asarray(resid0), lam_e, jnp.asarray(lam_rows), pi, jnp.asarray(rm), jnp.asarray(cm),
        False, lasso=lasso)
    eta, order, uz, na, xi, _ = _jax_draws(key, jnp.asarray(W0), jnp.asarray(lam_rows), lasso)
    gram = TD.marker_gram(tx)
    u0 = TD.marker_u0(tx[0], torch.from_numpy(resid0)[:, None])[None, :, 0]

    def t(a, dtype=None):
        a = torch.from_numpy(np.array(a))
        return a if dtype is None else a.to(dtype)

    z_t, W_t = marker_scan_ref(
        gram, torch.zeros(1, dtype=torch.int64), u0, t(W0)[None], t(w_out[:, 0])[None],
        t(eta)[None], t([lam_e], torch.float32), t([pi], torch.float32), t(rm)[None],
        t(cm)[None], False, t(order)[None], t(uz)[None], t(na)[None], t(xi)[None])
    np.testing.assert_array_equal(z_t[0].numpy(), np.asarray(z_j))
    W_j = np.asarray(W_j)
    assert np.abs(W_t[0].numpy() - W_j).max() <= 1e-4 * max(1.0, np.abs(W_j).max())
    z = z_t[0].numpy()
    assert 0 < z.sum() < rm.sum()  # markers both in and out
    assert np.all(W_t[0].numpy()[:, cm == 0] == 0) and np.all(W_t[0].numpy()[z == 0] == 0)


# ----------------------------------------------------------- 6. the rules


@pytest.mark.parametrize("depth,h,want", [(2, 50, True), (0, 50, True), (1, 16, True),
                                          (3, 50, True), (0, 72, False)])
def test_default_width_rule_shapes_are_admitted(depth, h, want):
    """The genome-scale branch (m = 100, padded 104) at the JAX CLI's
    default widths (h = s = 50, padded 56) and the other shapes the card
    now runs; width 72 stays refused."""
    arch = NetArch.from_width_rules([100], depth, ("fixed", h), ("fraction_of_hidden", 1.0))
    widths = (arch.layer_out_pad(0), arch.s_pad)
    for rule in (TBM.branch_vg_packed_smem, TBM.traj_packed_smem):
        assert (rule(arch.m_pad, *widths, depth) > 0) == want
