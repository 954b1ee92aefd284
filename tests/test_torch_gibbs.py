"""The port's conjugate Gibbs draws against the JAX package's.

Conditional parameters: both packages' Gamma samplers are replaced by a
recorder, and the (shape, scale) of every conditional drawn by the branch
update's precision steps must agree to rtol 1e-6. Draws: torch generators
and JAX keys give different numbers, so the port's draws are held to the
analytic distribution instead: the mean and variance of 20,000 draws from a
fixed seed within 5 standard errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_bann_tpu.models import density as JD
from rs_bann_tpu.models import net as JN
from rs_bann_tpu.models.arch import NetArch
from rs_bann_tpu.samplers import gibbs as JG
from rs_bann_tpu_torch.models import density as TD
from rs_bann_tpu_torch.models import net as TN
from rs_bann_tpu_torch.samplers import gibbs as TG

ARCH = NetArch(m=(20,), h=(8,), s=(5,), depth=1)
HYPER = (1.5, 2.0, 0.5, 3.0, 2.5, 4.0)
N_DRAWS = 20_000


def _recorder(log, to_array):
    """A stand-in Gamma sampler that logs its parameters and returns the mean."""

    def fake_gamma(_key, shape, scale):
        shape = np.asarray(shape, np.float64)
        scale = np.asarray(scale, np.float64)
        log.append(np.broadcast_arrays(shape, scale))
        return to_array(np.asarray(shape * scale, np.float32))

    return fake_gamma


@pytest.mark.parametrize("model_type", ["ridge_base", "ridge_ard", "lasso_base", "lasso_ard"])
def test_conditional_parameters_match_jax(model_type, monkeypatch):
    rng = np.random.default_rng(0)
    L = ARCH.num_layers
    ws = [rng.standard_normal((ARCH.layer_in_pad(l), ARCH.layer_out_pad(l))).astype(np.float32)
          for l in range(L)]
    bs = [rng.standard_normal(ARCH.layer_out_pad(l)).astype(np.float32) for l in range(L - 1)]
    residual = rng.standard_normal(700).astype(np.float32)

    jlog, tlog = [], []
    monkeypatch.setattr(JG, "_gamma", _recorder(jlog, jnp.asarray))
    monkeypatch.setattr(TG, "_gamma", _recorder(tlog, torch.from_numpy))

    jh, th = JD.Hyperparameters(*HYPER), TD.Hyperparameters(*HYPER)
    key = jax.random.key(0)
    JN._gibbs_local_precisions(
        key, model_type, tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)),
        JD.slice_branch(JD.branch_statics(ARCH), 0), jh, L, lam_floor=0.01,
    )
    JN._gibbs_output_precision(key, model_type, jnp.asarray(3.5), 5.0, jh)
    JG.error_precision_posterior(key, jh, jnp.asarray(residual))
    JG.ridge_single_precision_posterior(key, 0.3, 7.0, jnp.asarray(1.25))

    gen = torch.Generator()
    TN._gibbs_local_precisions(
        gen, model_type, tuple(map(torch.from_numpy, ws)), tuple(map(torch.from_numpy, bs)),
        TD.slice_branch(TD.branch_statics(ARCH, "cpu"), 0), th, L, lam_floor=0.01,
    )
    TN._gibbs_output_precision(gen, model_type, torch.tensor(3.5), 5.0, th)
    TG.error_precision_posterior(gen, th, torch.from_numpy(residual))
    TG.ridge_single_precision_posterior(gen, 0.3, 7.0, torch.tensor(1.25))

    assert len(jlog) == len(tlog) == 2 * (L - 1) + 3
    for (js, jsc), (ts, tsc) in zip(jlog, tlog):
        np.testing.assert_allclose(ts, js, rtol=1e-6)
        np.testing.assert_allclose(tsc, jsc, rtol=1e-6)


def test_lam_floor_applies_to_weight_precisions_only():
    """Healthy-looking zero weights would draw tiny precisions; the floor
    lifts the weight precisions but leaves the bias precisions alone."""
    L = ARCH.num_layers
    ws = tuple(torch.full((ARCH.layer_in_pad(l), ARCH.layer_out_pad(l)), 50.0) for l in range(L))
    bs = tuple(torch.full((ARCH.layer_out_pad(l),), 50.0) for l in range(L - 1))
    gen = torch.Generator().manual_seed(0)
    wp, bp = TN._gibbs_local_precisions(
        gen, "ridge_ard", ws, bs, TD.slice_branch(TD.branch_statics(ARCH, "cpu"), 0),
        TD.Hyperparameters(), L, lam_floor=0.01,
    )
    assert all(float(w.min()) >= np.float32(0.01) for w in wp)
    assert all(float(b.max()) < 0.01 for b in bp)


@pytest.mark.parametrize("shape", [0.5, 1.0, 5.0, 350.0])
def test_gamma_draws_by_distribution(shape):
    scale = 2.0
    gen = torch.Generator().manual_seed(11)
    x = TG._gamma(gen, torch.full((N_DRAWS,), shape), scale).double().numpy()
    assert x.dtype == np.float64 and np.all(x >= 0)
    mean, var = shape * scale, shape * scale**2
    assert abs(x.mean() - mean) <= 5 * np.sqrt(var / N_DRAWS)
    # sd of the sample variance: var * sqrt((2 + 6/k) / N) for Gamma(k)
    assert abs(x.var() - var) <= 5 * var * np.sqrt((2 + 6 / shape) / N_DRAWS)


def test_gamma_uses_only_its_generator():
    a = TG._gamma(torch.Generator().manual_seed(5), torch.full((100,), 3.0), 1.0)
    torch.manual_seed(123)  # the global RNG must not matter
    b = TG._gamma(torch.Generator().manual_seed(5), torch.full((100,), 3.0), 1.0)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_output_bias_draws_by_distribution():
    rng = np.random.default_rng(3)
    r = torch.from_numpy(rng.standard_normal(700).astype(np.float32) + 0.4)
    err, bias_prec = torch.tensor(1.7), torch.tensor(0.2)
    gen = torch.Generator().manual_seed(2)
    x = np.array([float(TG.sample_output_bias(gen, r, err, bias_prec)) for _ in range(N_DRAWS)])
    denom = 700 * 1.7 + 0.2
    mean, var = 1.7 / denom * float(r.sum()), 1.0 / denom
    assert abs(x.mean() - mean) <= 5 * np.sqrt(var / N_DRAWS)
    assert abs(x.var() - var) <= 5 * var * np.sqrt(2 / N_DRAWS)
