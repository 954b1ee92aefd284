"""The port's densities (rs_bann_tpu_torch/models/density.py) against the JAX
package's: the five prior log-densities with their gradients, the packed
forward / predict, the joint LPD terms, and the reference's golden values
that tests/test_density.py pins for the JAX package.

Tolerance rtol 1e-5 (f32 sums in another order) unless a golden value pins
its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_bann_tpu.models import density as JD
from rs_bann_tpu.models.arch import NetArch
from rs_bann_tpu.ops import activations as JA
from rs_bann_tpu.ops.packed_matmul import pack_strided
from rs_bann_tpu_torch.models import density as TD
from rs_bann_tpu_torch.ops import activations as TA
from test_torch_copies import port

T = torch.from_numpy


def _branch(rng, ard, widths=(24, 8, 16, 1)):
    ws = [(rng.standard_normal((widths[i], widths[i + 1])) * 0.5).astype(np.float32)
          for i in range(len(widths) - 1)]
    ws[0][3, :] = 0.0  # an exactly-zero row: the L1 gradient there is 0
    bs = [(rng.standard_normal(widths[i + 1]) * 0.5).astype(np.float32)
          for i in range(len(widths) - 2)]
    wp = [
        rng.uniform(0.5, 3.0, (widths[i], 1) if ard and i < len(widths) - 2 else (1, 1)).astype(np.float32)
        for i in range(len(widths) - 1)
    ]
    return ws, bs, wp


@pytest.mark.parametrize("model_type", JD.MODEL_TYPES)
def test_prior_log_densities_and_gradients_match_jax(model_type):
    rng = np.random.default_rng(0)
    ws, bs, wp = _branch(rng, JD.is_ard(model_type))

    def jprior(w, b):
        return JD.log_density_wrt_weights(model_type, w, tuple(map(jnp.asarray, wp))) + \
            JD.log_density_wrt_biases(model_type, b)

    jw, jb = tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs))
    jval = float(jprior(jw, jb))
    jgw, jgb = jax.grad(jprior, argnums=(0, 1))(jw, jb)

    tw = tuple(T(w).requires_grad_() for w in ws)
    tb = tuple(T(b).requires_grad_() for b in bs)
    twp = tuple(map(T, wp))
    tval = TD.log_density_wrt_weights(model_type, tw, twp) + TD.log_density_wrt_biases(model_type, tb)
    agw_agb = [
        torch.zeros_like(x) if g is None else g
        for g, x in zip(torch.autograd.grad(tval, tw + tb, allow_unused=True), tw + tb)
    ]
    pgw, pgb = TD.prior_grad(model_type, [w.detach() for w in tw], [b.detach() for b in tb], twp)

    assert float(tval.detach()) == pytest.approx(jval, rel=1e-5)
    for auto, closed, j in zip(agw_agb, pgw + pgb, tuple(jgw) + tuple(jgb)):
        np.testing.assert_allclose(auto.numpy(), np.asarray(j), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(closed.numpy(), np.asarray(j), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("act", ["identity", "relu", "leaky_relu", "tanh", "silu"])
def test_activations_and_derivatives_match_jax(act):
    z = np.linspace(-4.0, 4.0, 81, dtype=np.float32)  # holds z = 0 exactly
    ja = np.asarray(JA.activation(act)(jnp.asarray(z)))
    jd = np.asarray(JA.dhdx(act)(jnp.asarray(z)))
    ta = TA.apply(act, T(z))
    np.testing.assert_allclose(ta.numpy(), ja, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(TA.prime(act, T(z), ta).numpy(), jd, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("act", ["identity", "tanh", "silu"])
def test_packed_forward_and_predict_match_jax(act):
    """The packed forward (K2's plain version; under silu K9a's, unfused,
    with its pre-activation) against JAX's."""
    rng = np.random.default_rng(1)
    G, m, n = 2, 24, 700
    by = np.stack([pack_strided(rng.integers(0, 3, (m, n)).astype(np.float32)) for _ in range(G)])
    scale = rng.uniform(0.5, 2.0, (G, m)).astype(np.float32)
    shift = rng.uniform(0.0, 2.0, (G, m)).astype(np.float32)
    branches = [_branch(rng, True) for _ in range(G)]
    ws = [np.stack([b[0][l] for b in branches]) for l in range(3)]
    bs = [np.stack([b[1][l] for b in branches]) for l in range(2)]

    tx = TD.PackedX(T(by), T(scale), T(shift), n)
    stacked = TD.predict(act, tuple(map(T, ws)), tuple(map(T, bs)), tx)
    assert stacked.shape == (G, n)
    for g in range(G):
        jx = JD.PackedX(jnp.asarray(by[g]), jnp.asarray(scale[g]), jnp.asarray(shift[g]), n)
        jw = tuple(jnp.asarray(w[g]) for w in ws)
        jb = tuple(jnp.asarray(b[g]) for b in bs)
        jpre, jacts = JD.forward(act, jw, jb, jx)
        pre, tacts = TD.forward(act, tuple(T(w[g]) for w in ws), tuple(T(b[g]) for b in bs), tx[g])
        if act == "silu":
            np.testing.assert_allclose(pre[0].numpy(), np.asarray(jpre[0]), rtol=1e-5, atol=1e-5)
        else:
            assert pre[0] is None
        assert len(tacts) == len(jacts)
        for t, j in zip(tacts, jacts):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            stacked[g].numpy(), np.asarray(JD.predict(act, jw, jb, jx)), rtol=1e-5, atol=1e-5
        )


@pytest.mark.parametrize("act", ["identity", "tanh", "silu"])
def test_chain_folded_predict_matches_jax(act):
    """predict_chains (C chains' layer 0 side by side in one K2 call, or one
    K9a call under silu) against JAX's predict of each chain and branch."""
    rng = np.random.default_rng(2)
    C, B, m, n = 3, 2, 24, 700
    by = np.stack([pack_strided(rng.integers(0, 3, (m, n)).astype(np.float32)) for _ in range(B)])
    scale = rng.uniform(0.5, 2.0, (B, m)).astype(np.float32)
    shift = rng.uniform(0.0, 2.0, (B, m)).astype(np.float32)
    nets = [[_branch(rng, True) for _ in range(B)] for _ in range(C)]
    ws = [np.stack([np.stack([b[0][l] for b in row]) for row in nets]) for l in range(3)]
    bs = [np.stack([np.stack([b[1][l] for b in row]) for row in nets]) for l in range(2)]

    out = TD.predict_chains(act, tuple(map(T, ws)), tuple(map(T, bs)),
                            TD.PackedX(T(by), T(scale), T(shift), n))
    assert out.shape == (C, B, n)
    for c in range(C):
        for j in range(B):
            jx = JD.PackedX(jnp.asarray(by[j]), jnp.asarray(scale[j]), jnp.asarray(shift[j]), n)
            want = JD.predict(act, tuple(jnp.asarray(w[c, j]) for w in ws),
                              tuple(jnp.asarray(b[c, j]) for b in bs), jx)
            np.testing.assert_allclose(out[c, j].numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_joint_terms_match_jax():
    rng = np.random.default_rng(2)
    arch = NetArch(m=(20,), h=(8,), s=(16,), depth=1, pad_multiple=8)
    hyper = (1.5, 2.0, 0.5, 3.0, 2.5, 4.0)
    for model_type in JD.MODEL_TYPES:
        ws, bs, wp = _branch(rng, JD.is_ard(model_type))
        bp = [np.full((1,), 1.7, np.float32), np.full((1,), 0.6, np.float32)]
        jst = JD.slice_branch(JD.branch_statics(arch), 0)
        tst = TD.slice_branch(TD.branch_statics(port(arch), "cpu"), 0)
        j = JD.joint_local_term(model_type, *(tuple(map(jnp.asarray, a)) for a in (ws, bs, wp, bp)),
                                JD.Hyperparameters(*hyper), jst)
        t = TD.joint_local_term(model_type, *(tuple(map(T, a)) for a in (ws, bs, wp, bp)),
                                TD.Hyperparameters(*hyper), tst)
        assert float(t) == pytest.approx(float(j), rel=1e-5)
        j = JD.joint_output_term(model_type, tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, wp)),
                                 JD.Hyperparameters(*hyper), jnp.asarray(3.0), 40.0)
        t = TD.joint_output_term(model_type, tuple(map(T, ws)), tuple(map(T, wp)),
                                 TD.Hyperparameters(*hyper), torch.tensor(3.0), 40.0)
        assert float(t) == pytest.approx(float(j), rel=1e-5)
    j = JD.joint_rss_term(jnp.asarray(2.5), jnp.asarray(40.0), JD.Hyperparameters(*hyper), 700.0)
    t = TD.joint_rss_term(torch.tensor(2.5), torch.tensor(40.0), TD.Hyperparameters(*hyper), 700.0)
    assert float(t) == pytest.approx(float(j), rel=1e-5)


# ------------------------------------------- golden values (tests/test_density.py)

GOLD_ARCH = NetArch(m=(3,), h=(2,), s=(1,), depth=1, pad_multiple=1)
GOLD_X = torch.tensor([[1.0, 1.0, 0.0], [0.0, 1.0, 2.0], [0.0, 2.0, 0.0], [2.0, 0.0, 1.0]])
GOLD_Y = torch.tensor([0.0, 2.0, 1.0, 1.5])
GOLD_HYPER = TD.Hyperparameters(3.0, 2.0, 3.0, 2.0, 4.0, 5.0)


def _gold_branch():
    ws = (torch.tensor([[0.0, 3.0], [1.0, 4.0], [2.0, 5.0]]), torch.tensor([[1.0], [2.0]]),
          torch.tensor([[2.0]]))
    bs = (torch.tensor([0.0, 1.0]), torch.tensor([2.0]))
    return ws, bs


def test_golden_forward_and_rss():
    ws, bs = _gold_branch()
    _, acts = TD.forward("tanh", ws, bs, GOLD_X)
    exp0 = [0.7615942, 0.9999092, 0.9640276, 0.9640276, 0.99999976, 1.0, 0.99999994, 1.0]
    np.testing.assert_allclose(acts[0].numpy().T.reshape(-1), exp0, rtol=1e-4)
    np.testing.assert_allclose(acts[1].numpy().reshape(-1),
                               [0.99985373, 0.99990916, 0.9999024, 0.9999024], rtol=1e-4)
    np.testing.assert_allclose(acts[2].numpy().reshape(-1),
                               [1.9997075, 1.9998183, 1.9998049, 1.9998049], rtol=1e-4)
    assert float(TD.branch_rss("tanh", ws, bs, GOLD_X, GOLD_Y)) == pytest.approx(5.248245, rel=1e-4)


def test_golden_joint_density():
    ws, bs = _gold_branch()
    lam = tuple(torch.full((1, 1), 2.0) for _ in range(3))
    blam = tuple(torch.full((1,), 2.0) for _ in range(2))
    st = TD.slice_branch(TD.branch_statics(port(GOLD_ARCH), "cpu"), 0)
    rss = TD.branch_rss("tanh", ws, bs, GOLD_X, GOLD_Y)
    assert float(TD.joint_rss_term(torch.tensor(2.0), rss, GOLD_HYPER, 4.0)) == pytest.approx(
        -2.182509, rel=1e-4)
    ld_w = TD._joint_local_weights("ridge_base", ws, lam, GOLD_HYPER, st) + TD._joint_output_weights(
        "ridge_base", ws, lam, GOLD_HYPER, torch.tensor(0.0), torch.tensor(1.0))
    assert float(ld_w) == pytest.approx(-58.428806, rel=1e-4)
    assert float(TD._joint_biases(bs, blam, GOLD_HYPER, st)) == pytest.approx(-3.1876905, rel=1e-4)


def test_golden_marginal_gradient():
    """The reference's hand-written backprop + prior gradients, by autograd."""
    ws, bs = _gold_branch()
    ws = tuple(w.requires_grad_() for w in ws)
    bs = tuple(b.requires_grad_() for b in bs)
    lam = tuple(torch.full((1, 1), 1.0) for _ in range(3))
    rss = TD.branch_rss("tanh", ws, bs, GOLD_X, GOLD_Y)
    ld = TD.log_density("ridge_base", ws, bs, lam, torch.tensor(1.0), rss)
    g = torch.autograd.grad(ld, ws + bs)
    np.testing.assert_allclose(g[0].numpy().T.reshape(-1),
                               [-0.0005189283, -1.0005465, -2.0000138, -3.0, -4.0, -5.0],
                               rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(g[1].numpy().reshape(-1), [-1.0014552, -2.0017552], rtol=1e-3)
    np.testing.assert_allclose(g[2].numpy().reshape(-1), [-5.4986963], rtol=1e-4)
    np.testing.assert_allclose(g[3].numpy(), [-0.00053271546, 0.0], rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(g[4].numpy(), [-0.0017552058], rtol=2e-3)
