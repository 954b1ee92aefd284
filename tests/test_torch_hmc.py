"""The port's HMC (rs_bann_tpu_torch/samplers/hmc.py) against the JAX package.

``step_sizes`` must match in every deterministic mode (rtol 1e-6) and the
random mode must draw U(0, 1) * factor * n_params^(-1/4). One full
transition is held draw for draw: the test derives JAX's own momenta and
accept uniform from its key the way ``make_hmc_step`` does, hands them to
the port, and the port's HMCResult must match JAX's (weights, biases, code,
y_pred, log_density) to rtol 1e-4 and its accept probability to atol
1e-3, with JAX's fused K4 kernel (packed genotypes) or K8a (a FeatX) in
interpret mode on its path. rtol 1e-4: each leapfrog step's gradient is a sum over n
in another order, and L steps compound it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_bann_tpu.models import density as JD
from rs_bann_tpu.models import init as JI
from rs_bann_tpu.models import params as JP
from rs_bann_tpu.models.arch import NetArch
from rs_bann_tpu.ops import branch_mlp as JBM
from rs_bann_tpu.ops.packed_matmul import pack_strided
from rs_bann_tpu.samplers import hmc as JH
from rs_bann_tpu.samplers.mcmc_cfg import MCMCCfg
from rs_bann_tpu_torch.models import density as TD
from rs_bann_tpu_torch.samplers import hmc as TH
from test_torch_copies import port

N = 700


def _branch(model_type, act, depth, seed):
    arch = NetArch(m=(20,), h=(8,), s=(6,), depth=depth, activation=act)
    state, _ = JI.init_net(arch, model_type, JI.InitCfg(seed=seed))
    g = lambda tree: tuple(np.asarray(a[0]) for a in tree)  # noqa: E731
    return (arch, g(state.params.weights), g(state.params.biases),
            g(state.precisions.weights), g(state.precisions.biases))


@pytest.mark.parametrize("mode", ["uniform", "std_scaled", "izmailov", "dual_averaging"])
@pytest.mark.parametrize("model_type", ["ridge_ard", "lasso_base", "std_normal"])
def test_step_sizes_match_jax(mode, model_type):
    arch, ws, bs, wp, bp = _branch(model_type, "tanh", 1, seed=1)
    cfg = MCMCCfg(hmc_step_size_mode=mode, hmc_step_size_factor=0.7, hmc_integration_length=12)
    n_params = float(arch.num_params_branch(0))
    jw, jb = JH.step_sizes(jax.random.key(0), model_type, cfg, *(tuple(map(jnp.asarray, t))
                           for t in (ws, bs, wp, bp)), n_params)
    tw, tb = TH.step_sizes(torch.Generator(), model_type, port(cfg), *(tuple(map(torch.from_numpy, t))
                           for t in (ws, bs, wp, bp)), torch.tensor(n_params))
    for t, j in zip(tw + tb, tuple(jw) + tuple(jb)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)


def test_random_step_sizes_are_scaled_uniforms():
    arch, ws, bs, wp, bp = _branch("ridge_base", "tanh", 0, seed=2)
    cfg = MCMCCfg(hmc_step_size_mode="random", hmc_step_size_factor=0.7)
    n_params = torch.tensor(float(arch.num_params_branch(0)))
    prop = float(n_params ** -0.25 * 0.7)
    tw, tb = TH.step_sizes(torch.Generator().manual_seed(0), "ridge_base", port(cfg),
                           *(tuple(map(torch.from_numpy, t)) for t in (ws, bs, wp, bp)), n_params)
    u = torch.cat([t.reshape(-1) for t in tw + tb]).numpy() / prop
    assert [t.shape for t in tw] == [w.shape for w in ws]
    assert np.all((u >= 0) & (u < 1)) and abs(u.mean() - 0.5) < 5 * np.sqrt(1 / 12 / u.size)


CASES = [
    # model type, activation, depth, step factor, max |dH|
    ("ridge_ard", "identity", 0, 0.02, 10.0),
    ("lasso_base", "tanh", 1, 0.5, 10.0),
    ("lasso_ard", "silu", 1, 0.05, 10.0),
    ("std_normal", "leaky_relu", 0, 0.5, 10.0),  # izmailov ignores the factor
    ("ridge_base", "relu", 1, 0.5, 1e-3),  # diverges: rejected early
]


@pytest.mark.parametrize("layout,model_type,act,depth,factor,max_err", [
    pytest.param(layout, *c, id=("" if layout == "packed" else "feat-") + "-".join(map(str, c)))
    for layout in ("packed", "feat") for c in CASES])
def test_one_transition_draw_for_draw(layout, model_type, act, depth, factor, max_err):
    """On packed genotypes (K4 on both sides) or on a FeatX of the same
    standardized genotypes (K8a: JAX's data_vg under FORCE, the port's
    data_vg)."""
    rng = np.random.default_rng(3)
    arch, ws, bs, wp, bp = _branch(model_type, act, depth, seed=4)
    m_pad = arch.m_pad
    vals = np.zeros((m_pad, N), np.float32)
    vals[:20] = rng.integers(0, 3, size=(20, N))
    by = pack_strided(vals)
    scale = np.zeros(m_pad, np.float32)
    shift = np.zeros(m_pad, np.float32)
    scale[:20] = 1.0 / vals[:20].std(axis=1)
    shift[:20] = vals[:20].mean(axis=1)
    xs = (vals[:20] - shift[:20, None]) * scale[:20, None]
    xT = np.zeros((m_pad, N), np.float32)
    xT[:20] = xs
    y = (rng.standard_normal(20) @ xs * 0.3 + rng.standard_normal(N)).astype(np.float32)
    cfg = MCMCCfg(hmc_integration_length=8, hmc_step_size_factor=factor,
                  hmc_max_hamiltonian_error=max_err)
    mw = tuple(m[0] for m in JP.weight_masks(arch))
    mb = tuple(m[0] for m in JP.bias_masks(arch))
    n_params = float(arch.num_params_branch(0))
    err = 1.3

    # JAX's own draws, derived from its key as make_hmc_step derives them
    key = jax.random.key(9)
    _, k_mom, k_acc = jax.random.split(key, 3)
    mkeys = jax.random.split(k_mom, len(ws) + len(bs))
    p_w = tuple(np.asarray(jax.random.normal(k, w.shape)) * m for k, w, m in zip(mkeys, ws, mw))
    p_b = tuple(np.asarray(jax.random.normal(k, b.shape)) * m
                for k, b, m in zip(mkeys[len(ws):], bs, mb))
    u = float(jax.random.uniform(k_acc, ()))

    JBM.FORCE = "interpret"
    try:
        jx = (JD.PackedX(jnp.asarray(by), jnp.asarray(scale), jnp.asarray(shift), N)
              if layout == "packed" else JD.FeatX(jnp.asarray(xT)))
        jres = JH.make_hmc_step(model_type, act, cfg)(
            key, *(tuple(map(jnp.asarray, t)) for t in (ws, bs, wp, bp)), jnp.asarray(err), jx,
            jnp.asarray(y), tuple(map(jnp.asarray, mw)), tuple(map(jnp.asarray, mb)),
            jnp.asarray(n_params),
        )
    finally:
        JBM.FORCE = None

    def T(a):
        return torch.from_numpy(np.array(a))

    tres = TH.make_hmc_step(model_type, act, port(cfg))(
        torch.Generator(), *(tuple(map(T, t)) for t in (ws, bs, wp, bp)), torch.tensor(err),
        TD.PackedX(T(by), T(scale), T(shift), N) if layout == "packed" else TD.FeatX(T(xT)),
        T(y), tuple(map(T, mw)), tuple(map(T, mb)),
        torch.tensor(n_params), momenta=(tuple(map(T, p_w)), tuple(map(T, p_b))), u=u,
    )
    assert int(tres.code) == int(jres.code)
    if max_err < 1.0:
        assert int(tres.code) == TH.REJECTED_EARLY
    for t, j in zip(tres.weights + tres.biases, tuple(jres.weights) + tuple(jres.biases)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tres.y_pred.numpy(), np.asarray(jres.y_pred), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(tres.log_density), float(jres.log_density), rtol=1e-4)
    # exp(log_acc) carries the absolute error of log_acc, a difference of two
    # potentials of size ~n: atol 1e-3
    np.testing.assert_allclose(float(tres.accept_prob), float(jres.accept_prob), atol=1e-3)

