"""Conjugate Gibbs updates for precision hyperparameters.

Counterpart of rs_bann_tpu/samplers/gibbs.py. Every draw takes an explicit
``torch.Generator``. PyTorch's own Gamma sampler accepts none, so ``_gamma``
is Marsaglia and Tsang's method written on ``torch.randn``/``torch.rand``.

Parameterization: Gamma(shape k, scale theta).
"""

from __future__ import annotations

import torch


def _gamma(gen: torch.Generator, shape, scale) -> torch.Tensor:
    """Independent Gamma(shape, scale) draws, one per element of the
    broadcast of (shape, scale), as f32 on the generator's device.

    Marsaglia & Tsang (2000): for a >= 1, with d = a - 1/3 and
    c = 1/sqrt(9d), draw x ~ N(0,1), u ~ U(0,1), v = (1 + cx)^3 and accept
    d*v when v > 0 and log u < x^2/2 + d - dv + d log v. Shapes below 1
    draw Gamma(a + 1) and multiply by u^(1/a). Runs in f64 (for large d the
    acceptance test cancels in f32); rejected elements are redrawn until
    all are accepted (acceptance is above 95% for every shape).
    """
    dev = gen.device
    a = torch.as_tensor(shape, dtype=torch.float64, device=dev)
    theta = torch.as_tensor(scale, dtype=torch.float64, device=dev)
    out_shape = torch.broadcast_shapes(a.shape, theta.shape)
    a = a.expand(out_shape)
    boost = a < 1.0
    d = torch.where(boost, a + 1.0, a) - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros(out_shape, dtype=torch.float64, device=dev)
    done = torch.zeros(out_shape, dtype=torch.bool, device=dev)
    while True:
        x = torch.randn(out_shape, generator=gen, dtype=torch.float64, device=dev)
        u = torch.rand(out_shape, generator=gen, dtype=torch.float64, device=dev)
        v = (1.0 + c * x) ** 3
        log_v = torch.log(torch.where(v > 0, v, 1.0))
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * log_v)
        out = torch.where(ok & ~done, d * v, out)
        done = done | ok
        if bool(done.all()):
            break
    u_boost = torch.rand(out_shape, generator=gen, dtype=torch.float64, device=dev)
    out = torch.where(boost, out * u_boost ** (1.0 / a), out)
    return (out * theta).to(torch.float32)


def ridge_posterior_params(prior_shape, prior_scale, sum_of_squares, n):
    """(shape, scale) of lambda | w ~ Gamma(k + n/2, 2s / (2 + s * sum w^2))."""
    return prior_shape + n / 2.0, 2.0 * prior_scale / (2.0 + prior_scale * sum_of_squares)


def lasso_posterior_params(prior_shape, prior_scale, sum_of_abs, n):
    """(shape, scale) of lambda | w ~ Gamma(k + n, s / (1 + s * sum |w|))."""
    return prior_shape + n, prior_scale / (1.0 + prior_scale * sum_of_abs)


def ridge_precision_posterior(gen, prior_shape, prior_scale, sum_of_squares, n):
    return _gamma(gen, *ridge_posterior_params(prior_shape, prior_scale, sum_of_squares, n))


def lasso_precision_posterior(gen, prior_shape, prior_scale, sum_of_abs, n):
    return _gamma(gen, *lasso_posterior_params(prior_shape, prior_scale, sum_of_abs, n))


def gamma_many(gen, params) -> list:
    """One Gamma draw per element of each (shape, scale) pair of ``params``,
    all from a single ``_gamma`` call (one host synchronization); returns
    the draws in the broadcast shape of each pair."""
    pairs = [torch.broadcast_tensors(torch.as_tensor(k, device=gen.device),
                                     torch.as_tensor(th, device=gen.device))
             for k, th in params]
    draws = _gamma(gen, torch.cat([k.reshape(-1) for k, _ in pairs]),
                   torch.cat([th.reshape(-1) for _, th in pairs]))
    out, ix = [], 0
    for k, _ in pairs:
        out.append(draws[ix : ix + k.numel()].reshape(k.shape))
        ix += k.numel()
    return out


def ridge_single_precision_posterior(gen, prior_shape, prior_scale, value):
    """Scalar-parameter case, used for the output bias prior precision."""
    return ridge_precision_posterior(gen, prior_shape, prior_scale, value * value, 1.0)


def error_precision_posterior(gen, hyper, residual):
    """lambda_e | r: the ridge posterior on the residual vector [..., n]
    (one draw per leading index, e.g. per chain), with the output layer's
    hyperparameters as its prior."""
    rss = torch.sum(residual * residual, dim=-1)
    n = float(residual.shape[-1])
    return ridge_precision_posterior(gen, hyper.output_shape, hyper.output_scale, rss, n)


def sample_output_bias(gen, residual_plus_bias, error_precision, bias_precision):
    """Normal posterior draw of the global intercept; ``residual_plus_bias``
    [..., n] is the residual with the current bias added back."""
    n = float(residual_plus_bias.shape[-1])
    denom = n * error_precision + bias_precision
    mean = error_precision / denom * torch.sum(residual_plus_bias, dim=-1)
    std = torch.sqrt(1.0 / denom)
    z = torch.randn(mean.shape, generator=gen, device=gen.device)
    return mean + std * z
