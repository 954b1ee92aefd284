"""The port's gradient descent and per-branch gradients against the JAX package,
on packed genotypes.

1. The GD transition (``make_gradient_descent``) against JAX's on the same
   numpy inputs, L = 5: GD draws nothing, so the results compare element by
   element. rtol 1e-4: each gradient is a sum over n in another order, and
   the line search compounds it over the iterations. The inputs are chosen
   so that no line-search comparison of two rss values lies within 1e-6
   (relative) of a tie, where f32 sums in another order could flip it.
2. The hybrid block's batched GD (all the block's branches in one
   transition) against each branch's own, against the same frozen targets
   (rtol 1e-5), and one GD hybrid sweep keeps the residual bookkeeping
   (residual = y - bias - sum of predictions, rtol 1e-4).
3. ``Net.gradients`` against JAX's ``Net.gradients`` on a packed toy with
   the same state (``state_from_numpy``), every entry of a branch's
   gradient within 1e-4 of that gradient's largest entry (sums over n in
   another order; a bias gradient that cancels to ~0 at the initial state
   is rounding on both sides, so each array is not held to its own scale).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_bann_tpu.models import density as JD
from rs_bann_tpu.models import init as JI
from rs_bann_tpu.models import params as JP
from rs_bann_tpu.models.arch import NetArch
from rs_bann_tpu.models.data import pack_stacked as j_pack_stacked
from rs_bann_tpu.samplers import hmc as JH
from rs_bann_tpu.samplers.mcmc_cfg import MCMCCfg
from rs_bann_tpu_torch.models import density as TD
from rs_bann_tpu_torch.models import net as TN
from rs_bann_tpu_torch.models.data import pack_stacked as t_pack_stacked
from rs_bann_tpu_torch.samplers import hmc as TH
from rs_bann_tpu_torch.train import gd_warmup_cfg, prepare_state_for_training
from test_torch_copies import port
from test_torch_hybrid import _packed
from test_torch_slice import _nets, _toy

N = 700


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The line search runs many small ops; with the test workers sharing the
    cores, one intra-op thread keeps them from waiting on each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def T(a):
    return torch.from_numpy(np.array(a))


def _gd_inputs(act, depth, G=1, seed=4):
    """One packed branch (or G), its initial weights and precisions and a
    target with a linear signal."""
    rng = np.random.default_rng(seed)
    arch = NetArch(m=(20,) * G, h=(8,) * G, s=(6,) * G, depth=depth, activation=act)
    state, _ = JI.init_net(arch, "ridge_ard", JI.InitCfg(seed=seed))
    ws, bs, wp, bp = (tuple(np.asarray(a) for a in t) for t in (
        state.params.weights, state.params.biases, state.precisions.weights,
        state.precisions.biases))
    by, scale, shift = _packed(rng, G, 20, arch.m_pad, N)
    xs = (rng.integers(0, 3, (G, 20, N)) - 1.0).astype(np.float32)
    y = (np.einsum("gm,gmn->gn", rng.standard_normal((G, 20)), xs) * 0.3
         + rng.standard_normal((G, N))).astype(np.float32)
    return arch, ws, bs, wp, bp, (by, scale, shift), y


CASES = [("ridge_ard", "identity", 0), ("ridge_ard", "tanh", 1), ("ridge_base", "silu", 0)]


@pytest.mark.parametrize("model_type,act,depth", CASES)
def test_gd_transition_matches_jax(model_type, act, depth):
    arch, ws, bs, wp, bp, (by, scale, shift), y = _gd_inputs(act, depth)
    ws, bs, wp, bp = (tuple(a[0] for a in t) for t in (ws, bs, wp, bp))
    cfg = MCMCCfg(hmc_integration_length=5, hmc_step_size_factor=1e-3, gradient_descent=True)
    mw = tuple(m[0] for m in JP.weight_masks(arch))
    mb = tuple(m[0] for m in JP.bias_masks(arch))
    n_params, err = float(arch.num_params_branch(0)), 1.3

    J = lambda t: tuple(map(jnp.asarray, t))  # noqa: E731
    jres = jax.jit(JH.make_gradient_descent(model_type, act, cfg))(
        jax.random.key(0), J(ws), J(bs), J(wp), J(bp), jnp.asarray(err),
        JD.PackedX(jnp.asarray(by[0]), jnp.asarray(scale[0]), jnp.asarray(shift[0]), N),
        jnp.asarray(y[0]), J(mw), J(mb), jnp.asarray(n_params))
    tx = TD.PackedX(T(by[0]), T(scale[0]), T(shift[0]), N)
    tres = TH.make_gradient_descent(model_type, act, port(cfg))(
        None, *(tuple(map(T, t)) for t in (ws, bs, wp, bp)), torch.tensor(err), tx, T(y[0]),
        tuple(map(T, mw)), tuple(map(T, mb)), torch.tensor(n_params))
    assert int(tres.code) == int(jres.code) == TH.ACCEPTED
    assert float(tres.accept_prob) == float(jres.accept_prob) == 1.0
    for t, j in zip(tres.weights + tres.biases, tuple(jres.weights) + tuple(jres.biases)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tres.y_pred.numpy(), np.asarray(jres.y_pred), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(tres.log_density), float(jres.log_density), rtol=1e-4)
    # the descent moved the branch and lowered the rss
    rss0 = float(TD.branch_rss(act, tuple(map(T, ws)), tuple(map(T, bs)), tx, T(y[0])))
    assert float(((tres.y_pred - T(y[0])) ** 2).sum()) < rss0


@pytest.mark.parametrize("act,depth", [("identity", 0), ("tanh", 1), ("silu", 0)])
def test_batched_block_gd_equals_branch_by_branch(act, depth):
    """A block of 3 branches in one transition (one forward and one backward
    per gradient, one forward per probe, each branch's line search its own)
    against each branch alone, against the same frozen targets."""
    B = 3
    arch, ws, bs, wp, bp, (by, scale, shift), y = _gd_inputs(act, depth, G=B, seed=6)
    gd = TH.make_gradient_descent("ridge_ard", act, MCMCCfg(
        hmc_integration_length=5, hmc_step_size_factor=1e-3, gradient_descent=True))
    tx = TD.PackedX(T(by), T(scale), T(shift), N)
    args = [tuple(map(T, t)) for t in (ws, bs, wp, bp)]
    err = torch.tensor(0.8)
    blk = gd(None, *args, err, tx, T(y), None, None, None)
    assert blk.code.shape == (B,) and blk.y_pred.shape == (B, N)
    for j in range(B):
        one = gd(None, *(tuple(a[j] for a in t) for t in args), err, tx[j], T(y[j]),
                 None, None, None)
        # the batched and the single-branch matmuls sum in f32 in orders that
        # depend on the CPU's BLAS: the tolerance held against JAX above
        for a, b in zip(blk.weights + blk.biases, one.weights + one.biases):
            np.testing.assert_allclose(a[j].numpy(), b.numpy(), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(blk.y_pred[j].numpy(), one.y_pred.numpy(), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(float(blk.log_density[j]), float(one.log_density), rtol=1e-4)


def test_gd_hybrid_sweep_keeps_the_residual():
    """One GD sweep of the hybrid schedule (blocks of one branch, C = 2, the chains
    batched per block) and the chain-by-chain warm-start sweep: every update
    counts as accepted, and the carried residual stays y - bias - sum of
    the branch predictions."""
    arch, jnet, tnet = _nets("ridge_ard", "tanh", 1)
    bed, grouping, y = _toy(3, 10, N, seed=5)
    data = t_pack_stacked(port(arch), bed, grouping, y, "cpu")
    tnet = prepare_state_for_training(tnet, None)
    cfg = port(MCMCCfg(update_mode="hybrid", block_size=1, num_chains=2, seed=2,
                       hmc_integration_length=5))
    gen = torch.Generator().manual_seed(0)
    for chain_by_chain in (False, True):
        gd_cfg = gd_warmup_cfg(cfg) if chain_by_chain else dataclasses.replace(
            cfg, gradient_descent=True, hmc_step_size_factor=1e-3)
        sweep = tnet.make_chain_sweep(gd_cfg, chain_by_chain=chain_by_chain)
        carry = tnet.init_carry(data.X, data.y, chains=2)
        carry, st = sweep(carry, data.X, data.y, gen)
        assert st.counts.tolist() == [[3, 0, 0], [3, 0, 0]]
        for c in range(2):
            s = TN.P.map_state(lambda a: a[c], carry.state)
            want = data.y - tnet.predict(data.X, s)
            np.testing.assert_allclose(carry.residual[c].numpy(), want.numpy(), rtol=1e-4,
                                       atol=1e-4)
        assert float(st.mse_train.max()) < float(tnet.mse(data.X, data.y))


@pytest.mark.parametrize("model_type,act,depth", [("ridge_ard", "identity", 0),
                                                  ("lasso_base", "tanh", 1),
                                                  ("ridge_base", "silu", 1)])
def test_net_gradients_match_jax(model_type, act, depth):
    arch, jnet, tnet = _nets(model_type, act, depth)
    bed, grouping, y = _toy(3, 10, N, seed=7)
    jd = j_pack_stacked(arch, bed, grouping, y)
    td = t_pack_stacked(port(arch), bed, grouping, y, "cpu")
    jg = jnet.gradients(jd.X, jd.y)
    tg = tnet.gradients(td.X, td.y)
    assert len(tg) == len(jg) == arch.num_branches
    for (tw, tb), (jw, jb) in zip(tg, jg):
        assert len(tw) == len(jw) and len(tb) == len(jb)
        pairs = [(np.asarray(t), np.asarray(j)) for t, j in zip(tw + tb, tuple(jw) + tuple(jb))]
        scale = max(np.abs(j).max() for _, j in pairs)
        for t, j in pairs:
            assert t.shape == j.shape
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-4 * scale)
