"""Hamiltonian Monte Carlo for one branch on packed genotypes.

Counterpart of rs_bann_tpu/samplers/hmc.py ``step_sizes`` and the default
body of ``make_hmc_step``. Each leapfrog step's potential and gradient come
from the fused packed value-and-gradient (ops/branch_mlp.py, kernel K4) plus
the closed-form prior gradient, so a transition of L steps runs K4 exactly
L + 1 times.

Early termination follows the JAX package: once |Delta H| exceeds the
threshold (or H turns NaN) the carried state freezes through ``where`` and
the remaining steps still run, with no host synchronization inside the
trajectory; the transition is then rejected early and keeps its start.

Step-size modes:
  izmailov   eps = factor*pi/(2 sqrt(lambda) L) per weight group (ridge,
             std_normal); lasso uses factor/(4 lambda L)
  std_scaled eps = factor/sqrt(lambda)
  random     eps ~ U(0,1) * factor * n_params^(-1/4) per coordinate
  uniform    eps = factor

Result codes: 0 = accepted, 1 = rejected at end, 2 = rejected early.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from rs_bann_tpu.samplers.mcmc_cfg import MCMCCfg

from ..models import density as D
from ..ops import branch_mlp

ACCEPTED, REJECTED, REJECTED_EARLY = 0, 1, 2


class HMCResult(NamedTuple):
    weights: tuple
    biases: tuple
    code: torch.Tensor  # int64 0-d, one of ACCEPTED/REJECTED/REJECTED_EARLY
    y_pred: torch.Tensor  # [n] prediction at the returned params
    log_density: torch.Tensor  # -U at the returned params
    accept_prob: torch.Tensor  # Metropolis acceptance probability (0 if diverged)


def _mul_add(xs, eps, ps, frac=1.0):
    return tuple(x + frac * e * p for x, e, p in zip(xs, eps, ps))


def _kinetic(p_w, p_b):
    return 0.5 * sum(torch.sum(p * p) for p in p_w + p_b)


def step_sizes(
    gen, model_type: str, cfg: MCMCCfg, weights, biases, w_precisions,
    b_precisions, n_params,
):
    """Per-coordinate leapfrog step sizes for (weights, biases).

    Dual averaging (whose adaptation waits) uses the izmailov shape with the
    cfg factor.
    """
    mode = cfg.hmc_step_size_mode
    factor = cfg.hmc_step_size_factor
    if mode == "dual_averaging":
        mode = "izmailov"
    L = cfg.hmc_integration_length
    if mode == "uniform":
        eps_w = tuple(torch.full_like(w, factor) for w in weights)
        eps_b = tuple(torch.full_like(b, factor) for b in biases)
    elif mode == "random":
        prop = n_params ** (-0.25) * factor

        def draw(t):
            return torch.rand(t.shape, generator=gen, device=t.device) * prop

        eps_w = tuple(draw(w) for w in weights)
        eps_b = tuple(draw(b) for b in biases)
    elif mode == "std_scaled":
        eps_w = tuple(
            (factor / torch.sqrt(lam)).expand_as(w) for w, lam in zip(weights, w_precisions)
        )
        eps_b = tuple(
            (factor / torch.sqrt(lam)).expand_as(b) for b, lam in zip(biases, b_precisions)
        )
    elif mode == "izmailov":
        # the reference's std_normal izmailov ignores the factor
        fac = 1.0 if model_type == "std_normal" else factor
        if D.is_lasso(model_type):
            eps_w = tuple(
                (factor / (4.0 * lam * L)).expand_as(w)
                for w, lam in zip(weights, w_precisions)
            )
        else:
            eps_w = tuple(
                (fac * math.pi / (2.0 * torch.sqrt(lam) * L)).expand_as(w)
                for w, lam in zip(weights, w_precisions)
            )
        eps_b = tuple(
            (fac * math.pi / (2.0 * torch.sqrt(lam) * L)).expand_as(b)
            for b, lam in zip(biases, b_precisions)
        )
    else:
        raise ValueError(mode)
    return eps_w, eps_b


def make_hmc_step(model_type: str, act_name: str, cfg: MCMCCfg):
    """Build the marginal HMC transition for one branch.

    Returned signature:
      hmc(gen, weights, biases, w_precisions, b_precisions, error_precision,
          x, y, masks_w, masks_b, n_params, momenta=None, u=None) -> HMCResult
    ``x`` is a single-branch PackedX. ``momenta`` = (p_w, p_b) and the accept
    uniform ``u`` may be passed in; otherwise they are drawn from ``gen``.
    """
    L = cfg.hmc_integration_length
    max_err = cfg.hmc_max_hamiltonian_error

    def vg(weights, biases, w_precisions, error_precision, x, y):
        y_pred, rss, dws, dbs = branch_mlp.data_vg_packed(act_name, x, weights, biases, y)
        prior = D.log_density_wrt_weights(
            model_type, weights, w_precisions
        ) + D.log_density_wrt_biases(model_type, biases)
        pgw, pgb = D.prior_grad(model_type, weights, biases, w_precisions)
        ld = prior - error_precision * rss / 2.0
        gw = tuple(p - error_precision * d for p, d in zip(pgw, dws))
        gb = tuple(p - error_precision * d for p, d in zip(pgb, dbs))
        return ld, y_pred, gw, gb

    def hmc(
        gen, weights, biases, w_precisions, b_precisions, error_precision, x, y,
        masks_w, masks_b, n_params, momenta=None, u=None,
    ):
        if not isinstance(x, D.PackedX):
            raise NotImplementedError("the port's HMC runs on packed genotypes only")
        eps_w, eps_b = step_sizes(
            gen, model_type, cfg, weights, biases, w_precisions, b_precisions, n_params
        )
        if momenta is None:
            momenta = (
                tuple(torch.randn(w.shape, generator=gen, device=w.device) for w in weights),
                tuple(torch.randn(b.shape, generator=gen, device=b.device) for b in biases),
            )
        # padded coordinates get zero momentum, so they never move
        p_w = tuple(p * m for p, m in zip(momenta[0], masks_w))
        p_b = tuple(p * m for p, m in zip(momenta[1], masks_b))

        ld0, y_pred0, g_w, g_b = vg(weights, biases, w_precisions, error_precision, x, y)
        neg_h0 = ld0 - _kinetic(p_w, p_b)

        # With a fixed trajectory length the JAX body's `done` flag equals
        # `dead`: a diverged trajectory freezes and stays frozen.
        w, b, pw, pb, gw, gb, ld, yp = weights, biases, p_w, p_b, g_w, g_b, ld0, y_pred0
        dead = torch.zeros((), dtype=torch.bool, device=ld0.device)
        for _ in range(L):
            pw1 = _mul_add(pw, eps_w, gw, 0.5)
            pb1 = _mul_add(pb, eps_b, gb, 0.5)
            w1 = _mul_add(w, eps_w, pw1)
            b1 = _mul_add(b, eps_b, pb1)
            ld1, yp1, gw1, gb1 = vg(w1, b1, w_precisions, error_precision, x, y)
            pw1 = _mul_add(pw1, eps_w, gw1, 0.5)
            pb1 = _mul_add(pb1, eps_b, gb1, 0.5)
            neg_h = ld1 - _kinetic(pw1, pb1)
            # NaN-safe: a NaN comparison is False, so ~(|dH| <= max) catches NaN
            dead = dead | ~(torch.abs(neg_h - neg_h0) <= max_err)

            def keep(old, new):
                return tuple(torch.where(dead, o, n) for o, n in zip(old, new))

            w, b, pw, pb = keep(w, w1), keep(b, b1), keep(pw, pw1), keep(pb, pb1)
            gw, gb = keep(gw, gw1), keep(gb, gb1)
            ld = torch.where(dead, ld, ld1)
            yp = torch.where(dead, yp, yp1)

        log_acc = (ld - _kinetic(pw, pb)) - neg_h0
        if u is None:
            u = torch.rand((), generator=gen, device=ld0.device)
        # accepted iff not dead and u < exp(log_acc); NaN log_acc rejects
        mh_ok = torch.log(torch.as_tensor(u, device=ld0.device)) < log_acc
        accepted = ~dead & mh_ok
        code = torch.where(
            dead, REJECTED_EARLY, torch.where(mh_ok, ACCEPTED, REJECTED)
        )
        alpha = torch.where(
            dead | torch.isnan(log_acc),
            0.0,
            torch.clamp(torch.exp(log_acc), max=1.0),
        )

        def sel(new, old):
            return tuple(torch.where(accepted, n, o) for n, o in zip(new, old))

        return HMCResult(
            weights=sel(w, weights),
            biases=sel(b, biases),
            code=code,
            y_pred=torch.where(accepted, yp, y_pred0),
            log_density=torch.where(accepted, ld, ld0),
            accept_prob=alpha,
        )

    return hmc
