"""The block net and its Gibbs sweeps.

Counterpart of rs_bann_tpu/models/net.py for three schedules:

* sequential: every sweep visits the branches in a fresh random order (the
  reference's random-scan Gibbs) and, per branch, draws the error
  precision, the branch's local precisions and the shared output-layer
  precision from their conjugate conditionals, runs one HMC transition
  against the live residual, updates the log-posterior bookkeeping and
  redraws the output bias.
* hybrid: the sweep walks random blocks of branches. Per block the Gibbs
  draws are batched over the block (and the chains), every branch of the
  block proposes a lean HMC move against the block's frozen residual, and
  the proposals are accepted one by one, in a random order, against the
  live residual (``_live_accept_select``): an exact Metropolis-within-Gibbs
  kernel. With a shared block permutation, one whole-trajectory call (K5
  on packed genotypes, K6 on a FeatX) integrates the whole block for all
  chains, one chain included (``chain_fold_eligible``); otherwise each
  (chain, branch) runs its own lean transition: K4 per branch on packed
  genotypes; on a FeatX all of the block's (chain, branch) pairs at once,
  one K8b call per leapfrog step, each reading its branch of X in place.
* parallel: the hybrid sweep with one block of all G branches in their own
  order, every sweep (``make_hybrid_sweep``).

With ``cfg.gradient_descent`` every schedule takes the gradient-descent
transition (samplers/hmc.make_gradient_descent) in place of HMC, with no
live accept and no fold: the hybrid block runs it for all its branches at
once, against the block's frozen targets, and takes the results as they
are. The trainer's GD warm start (``cfg.gd_warmup``) is such a sweep.

Under ``hmc_step_size_mode="dual_averaging"`` and ``cfg.mass_adaptation``
every schedule adapts, per chain and branch, the step factor and a
diagonal mass estimate over the sweeps below ``cfg.burn_in`` and then
freezes them (``_Adaptation``); the carry holds their state.

With ``cfg.ss_markers`` (per-marker spike-and-slab, identity depth-0
``ridge_ard`` or ``lasso_ard`` branches) every branch update first runs the
collapsed conjugate scan over its layer-0 rows (``_marker_scans``: the
draws here, the scan one launch of csrc/marker_scan.cu for all of a block's
(chain, branch) instances, ops/marker_scan.py), which draws each marker's
inclusion z and row; the HMC transition then pins the excluded rows at 0
(samplers/hmc.pin_rows), excluded rows take their precision from the prior,
and each sweep ends with the inclusion probability's Gibbs draw and the
posterior inclusion probabilities' running mean (``_ssm_sweep_end``). The
carry holds z, pi and the PIPs.

A carry for C chains (``Net.init_carry(..., chains=C)``) stacks every
tensor of the one-chain carry on a leading [C] axis; ``make_chain_sweep``
sweeps such a carry under either schedule (the sequential one chain after
chain). The sweeps update the carry's stacked tensors in place, so the
device holds one copy of the state; ``Net.init_carry`` clones the state it
starts from.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.activations import canonical
from ..ops.branch_mlp import SUPPORTED_ACTIVATIONS, forward_blocked
from ..ops.marker_scan import marker_scan
from ..samplers import gibbs
from ..samplers.hmc import (
    HMCProposal,
    HMCResult,
    flatten_wb,
    make_gradient_descent,
    make_hmc_step,
    make_lean_batch,
    make_transition_batch,
    unflatten_wb,
)
from ..samplers.mcmc_cfg import MCMCCfg
from . import NetArch
from . import density as D
from . import params as P
from .params import NetState, StackedParams, StackedPrecisions


class TrainCarry(NamedTuple):
    """One chain's carry; a carry for C chains has a leading [C] axis on
    every tensor, the state's included."""

    state: NetState
    residual: torch.Tensor  # [n]
    lpd_local: torch.Tensor  # [G]
    lpd_out: torch.Tensor
    lpd_rss: torch.Tensor
    counts: torch.Tensor  # [3] int64: accepted / rejected / rejected-early
    # dual-averaging step-size adaptation (Hoffman & Gelman 2014), per
    # branch; inert unless hmc_step_size_mode == "dual_averaging"
    da_log_eps: torch.Tensor  # [G]
    da_log_eps_bar: torch.Tensor  # [G]
    da_h_bar: torch.Tensor  # [G]
    # diagonal-mass-matrix adaptation (cfg.mass_adaptation): Welford mean
    # and M2 of each branch's padded-flat params (``flatten_wb``) over the
    # warm-up sweeps; [G, 0] placeholders when it is off
    mm_mean: torch.Tensor  # [G, P_flat]
    mm_m2: torch.Tensor  # [G, P_flat]
    # per-marker spike-and-slab (cfg.ss_markers): layer-0 row inclusion
    # indicators (starting at 1), the marker inclusion probability and the
    # post-burn-in running mean of z; [G, 0] placeholders when it is off
    ssm_z: torch.Tensor  # [G, m_pad]
    ssm_pi: torch.Tensor  # scalar
    ssm_pip: torch.Tensor  # [G, m_pad]
    # completed sweeps: keys the hybrid's shared permutation and is the
    # JAX package's da_t, the adaptation's clock (warm while below burn_in)
    sweeps: int = 0


class SweepStats(NamedTuple):
    counts: torch.Tensor  # cumulative [3]
    mse_train: torch.Tensor
    lpd: torch.Tensor


# MCMCCfg settings whose code paths wait for later slices of the port,
# each with the value that keeps it off
_UNPORTED = {
    "joint_hmc": False,
    "gradient_descent_joint": False,
    "spike_slab": False,
    "ss_rows": False,
    "tempering": False,
    "hmc_traj_length_mode": "fixed",
    "trajectories": False,
    "num_grad": False,
    "num_grad_traj": False,
}


def ssm_unsupported(model_type: str, arch: NetArch) -> Optional[str]:
    """Why ``cfg.ss_markers`` cannot run on this model, or None: the JAX
    package's guards (net.py:791-806). The collapsed move needs a branch
    output linear in each layer-0 row (identity, depth 0) and a slab
    precision per row (``ridge_ard``, ``lasso_ard``)."""
    if arch.depth != 0 or canonical(arch.activation) != "identity":
        return "ss_markers needs the identity depth-0 architecture"
    if model_type not in ("ridge_ard", "lasso_ard"):
        return "ss_markers needs per-row slab precisions (ridge_ard or lasso_ard)"
    return None


def _check_ssm(model_type: str, arch: NetArch, cfg: MCMCCfg, gd: bool) -> bool:
    """Whether the sweep runs the marker scan (``cfg.ss_markers``, not under
    gradient descent, as in the JAX package); raises where it cannot."""
    if not cfg.ss_markers or gd:
        return False
    why = ssm_unsupported(model_type, arch)
    if why:
        raise NotImplementedError(why)
    return True


def unported_options(cfg: MCMCCfg) -> list:
    """Names of the cfg settings this port cannot honour yet."""
    bad = [k for k, v in _UNPORTED.items() if getattr(cfg, k) != v]
    if cfg.update_mode != "sequential" and not cfg.live_accept and not cfg.gradient_descent:
        bad.append("live_accept=False")
    return bad


# --------------------------------------------------------------------------
# Step-size and mass adaptation
# --------------------------------------------------------------------------

# dual-averaging constants (Hoffman & Gelman 2014, the NUTS paper's defaults)
_DA_GAMMA, _DA_T0, _DA_KAPPA = 0.05, 10.0, 0.75

# pseudo-observations shrinking the Welford variance toward the prior
# variance (Stan's windowed-adaptation regularization, aimed at the prior
# scale, so that count 0 gives the izmailov rule exactly)
_MASS_SHRINK = 5.0


def _da_update(cfg, t, h_bar, log_eps_bar, alpha, mu):
    """One dual-averaging update at iteration ``t`` (a number or a tensor)
    of h_bar, log_eps_bar and the acceptance probabilities alpha (tensors
    over any leading axes); returns (h_bar, log_eps, log_eps_bar)."""
    eta = 1.0 / (t + _DA_T0)
    h_bar = (1.0 - eta) * h_bar + eta * (cfg.target_accept - alpha)
    log_eps = mu - t ** 0.5 / _DA_GAMMA * h_bar
    w = t ** (-_DA_KAPPA)
    log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
    return h_bar, log_eps, log_eps_bar


def _prior_var_trees(model_type, wp_g, bp_g, w_like, b_like):
    """Per-coordinate prior variances (the mass estimate's shrinkage
    target), shaped as w_like / b_like over any leading axes: ridge N(0,
    1/lam) -> 1/lam; lasso Laplace(lam) -> 2/lam^2; biases always ridge."""
    if D.is_lasso(model_type):
        var_w = tuple((2.0 / (lam * lam)).expand_as(w) for w, lam in zip(w_like, wp_g))
    else:
        var_w = tuple((1.0 / lam).expand_as(w) for w, lam in zip(w_like, wp_g))
    var_b = tuple((1.0 / lam).expand_as(b) for b, lam in zip(b_like, bp_g))
    return var_w, var_b


def _mass_std(model_type, m2_g, count, wp_g, bp_g, w_like, b_like):
    """Per-coordinate posterior-std estimate: the Welford variance over
    ``count`` warm-up states (m2_g [..., P_flat]; ``count`` a number),
    shrunk toward the current prior variance. Returns (mass_w, mass_b)
    shaped as w_like / b_like. (The JAX package's takes the Welford mean
    too, and does not read it.)"""
    emp_var = m2_g / max(count - 1.0, 1.0)
    ew, eb = unflatten_wb(emp_var, w_like, b_like)
    pw, pb = _prior_var_trees(model_type, wp_g, bp_g, w_like, b_like)
    wgt = count / (count + _MASS_SHRINK)
    mass_w = tuple(torch.sqrt(wgt * e + (1.0 - wgt) * p) for e, p in zip(ew, pw))
    mass_b = tuple(torch.sqrt(wgt * e + (1.0 - wgt) * p) for e, p in zip(eb, pb))
    return mass_w, mass_b


def _welford(mean, m2, x, n):
    """One Welford update at new count ``n`` (elementwise over any shape)."""
    delta = x - mean
    mean = mean + delta / n
    m2 = m2 + delta * (x - mean)
    return mean, m2


class _Adaptation:
    """The sweeps' dual-averaging and mass adaptation (the JAX package's
    make_sweep, net.py:1085-1185, 1553-1760, 1984-2216), for one branch of
    the sequential sweep or a [C, B] block of the hybrid and parallel ones.
    The clock is the carry's completed sweeps (JAX's da_t), a host integer,
    so whether a sweep is warm (sweeps < burn_in) costs no device sync.

    ``inputs`` gives the transition's factor (exp(log eps) while warm,
    exp(log eps_bar) after) and mass (``_mass_std`` at count min(sweeps,
    burn_in), from the carry before the transition); ``update`` runs, in a
    warm sweep only, the DA update on the accept probabilities and the
    Welford update on the accept-selected parameters, both at t = sweeps +
    1, and writes them into the carry in place at ``index``: a fixed number
    of tensor ops whatever the block's size."""

    def __init__(self, model_type: str, cfg: MCMCCfg, gd: bool):
        self.model_type = model_type
        self.cfg = cfg
        self.adaptive = cfg.hmc_step_size_mode == "dual_averaging"
        self.mass = cfg.mass_adaptation and not gd
        self.mu = math.log(10.0 * cfg.hmc_step_size_factor)

    def inputs(self, carry: TrainCarry, index, wp, bp, ws, bs):
        """(step factor or None, (mass_w, mass_b) or (None, None)) of the
        branches at ``index`` (an int, or (chain, branch) index tensors)."""
        warm = carry.sweeps < self.cfg.burn_in
        factor = mass_w = mass_b = None
        if self.adaptive:
            factor = torch.exp((carry.da_log_eps if warm else carry.da_log_eps_bar)[index])
        if self.mass:
            cnt = float(min(carry.sweeps, self.cfg.burn_in))
            mass_w, mass_b = _mass_std(self.model_type, carry.mm_m2[index], cnt, wp, bp, ws, bs)
        return factor, (mass_w, mass_b)

    def update(self, carry: TrainCarry, index, accept_prob, ws, bs):
        if carry.sweeps >= self.cfg.burn_in:
            return
        t = float(carry.sweeps + 1)
        if self.adaptive:
            h, le, leb = _da_update(self.cfg, t, carry.da_h_bar[index],
                                    carry.da_log_eps_bar[index], accept_prob, self.mu)
            carry.da_h_bar[index] = h
            carry.da_log_eps[index] = le
            carry.da_log_eps_bar[index] = leb
        if self.mass:
            mean, m2 = _welford(carry.mm_mean[index], carry.mm_m2[index], flatten_wb(ws, bs), t)
            carry.mm_mean[index] = mean
            carry.mm_m2[index] = m2


# --------------------------------------------------------------------------
# Gibbs draws
# --------------------------------------------------------------------------


def _gibbs_local_precisions(gen, model_type, w_b, b_b, st_b, hyper, num_layers, lam_floor=0.0,
                            z_rows0=None):
    """Gibbs draw of the local weight and bias precisions of one branch or
    of a batch of them (leading axes, e.g. [C, B] of a hybrid block):
    weights [..., in, out], biases [..., out], statics [...]. Bias
    precisions are always ridge-updated; ``lam_floor`` floors the WEIGHT
    precisions only (biases are unregularized in the marginal potential).
    ``z_rows0`` [..., in] (per-marker spike-and-slab, ARD): an excluded
    layer-0 row is the spike, not a slab draw, so its precision takes the
    PRIOR draw Gamma(shape, scale), clipped to [1e-6, 1e8] (the JAX
    package's net.py:587-599: the near-improper default hyperprior
    underflows f32 to 0, and a 0 slab precision would make the re-entry
    draw infinite). All the Gamma draws come from one ``_gamma`` call: one
    host synchronization per call, not one per branch or layer."""
    L = num_layers
    dims = (-2, -1)
    params = []
    for l in range(L - 1):
        shape, scale = hyper.layer(l, L)
        w = w_b[l]
        if D.is_ard(model_type):
            n = st_b.out_counts[l][..., None, None]
            stat = (torch.sum(torch.abs(w), dim=-1, keepdim=True) if D.is_lasso(model_type)
                    else torch.sum(w * w, dim=-1, keepdim=True))
        else:
            n = st_b.w_counts[l][..., None, None]
            stat = (torch.sum(torch.abs(w), dim=dims, keepdim=True) if D.is_lasso(model_type)
                    else torch.sum(w * w, dim=dims, keepdim=True))
        post = gibbs.lasso_posterior_params if D.is_lasso(model_type) else gibbs.ridge_posterior_params
        params.append(post(shape, scale, stat, n))
        params.append(gibbs.ridge_posterior_params(
            shape, scale, torch.sum(b_b[l] ** 2, dim=-1, keepdim=True), st_b.b_counts[l][..., None]
        ))
    prior = z_rows0 is not None and D.is_ard(model_type)
    if prior:
        shape, scale = hyper.layer(0, L)
        params.append((shape, torch.full_like(z_rows0[..., None], scale)))
    draws = gibbs.gamma_many(gen, params)
    lam = list(draws[0:2 * (L - 1):2])
    if prior:
        lam[0] = torch.where(z_rows0[..., None] > 0, lam[0], torch.clamp(draws[-1], 1e-6, 1e8))
    new_wp = tuple(torch.clamp(d, min=lam_floor) if lam_floor > 0 else d for d in lam)
    return new_wp, tuple(draws[1:2 * (L - 1):2])


def _gibbs_output_precision(gen, model_type, reg_all, n_out, hyper):
    """Shared output-layer precision draw."""
    if model_type == "std_normal":
        return torch.ones((), device=gen.device)
    if D.is_lasso(model_type):
        lam = gibbs.lasso_precision_posterior(
            gen, hyper.output_shape, hyper.output_scale, reg_all, n_out
        )
    else:
        lam = gibbs.ridge_precision_posterior(
            gen, hyper.output_shape, hyper.output_scale, reg_all, n_out
        )
    return torch.clamp(lam, min=1e-10)


def _reg_all(model_type, params: StackedParams):
    """Summary stat of all branches' output weights (per chain when stacked)."""
    return torch.sum(D.summary_stat(model_type, params.weights[-1]), dim=-1)


def _update_output_bias(cfg, hyper, gen, residual, bias, bias_prec, err_prec):
    """Add the bias back to the residual [..., n], redraw it (or take the
    mean), subtract it again."""
    residual = residual + bias[..., None]
    if cfg.sampled_output_bias:
        bias_prec = gibbs.ridge_single_precision_posterior(
            gen, hyper.output_shape, hyper.output_scale, bias
        )
        bias = gibbs.sample_output_bias(gen, residual, err_prec, bias_prec)
    else:
        bias = torch.mean(residual, dim=-1)
    return residual - bias[..., None], bias, bias_prec


# --------------------------------------------------------------------------
# Per-marker spike-and-slab
# --------------------------------------------------------------------------


def _marker_scans(gen, lasso, force, gram, gix, u0, W0, w_out, lam_rows, err, pi, row_mask,
                  col_mask):
    """The marker scans of I (chain, branch) instances (the JAX package's
    ``_marker_ss_scan``, net.py:218, each): their draws from ``gen``, then
    one ``marker_scan`` call. gix [I] each instance's branch of ``gram``
    (the data's, ``D.marker_gram``); u0 [I, m] = X_g^T e at the current
    parameters; W0 [I, m, s]; w_out [I, s]; lam_rows [I, m] the rows' ARD precisions; err
    and pi [I]; row_mask [I, m], col_mask [I, s]; ``force`` keeps every true
    marker in (the warm-up). The slab precisions: ridge lam_rows on every
    column; lasso the Park-Casella augmentation's draws, InvGauss(r / |w|,
    r^2) where w != 0 and the prior's 1 / Exp(r^2 / 2) where w = 0, r the
    Laplace rate; both floored at 1e-6 and clipped to [1e-6, 1e12]. Then
    each instance's visiting order, Bernoulli uniforms, normals of a_j and
    of the row. Returns (z [I, m], W0_new [I, m, s])."""
    I, m, s = W0.shape
    dev = W0.device
    rate = torch.clamp(lam_rows, min=1e-6)[..., None]
    if lasso:
        eta_w = gibbs.inverse_gaussian(gen, rate / torch.clamp(W0.abs(), min=1e-12), rate * rate)
        s_prior = torch.empty_like(W0).exponential_(generator=gen) / (rate * rate / 2.0)
        eta = torch.clamp(torch.where(W0.abs() > 0, eta_w, 1.0 / s_prior), 1e-6, 1e12)
    else:  # the row's precision on every column, read in place
        eta = torch.clamp(rate, 1e-6, 1e12).expand(I, m, s)
    order = torch.argsort(torch.rand((I, m), generator=gen, device=dev), dim=-1)
    u_z = torch.rand((I, m), generator=gen, device=dev)
    n_a = torch.randn((I, m), generator=gen, device=dev)
    xi = torch.randn((I, m, s), generator=gen, device=dev)
    return marker_scan(gram, gix, u0, W0, w_out, eta, err, pi, row_mask, col_mask, force, order,
                       u_z, n_a, xi)


def _require_gram(X) -> None:
    """The marker scan reads the data's branch Grams, formed once per run by
    ``X.form_gram()`` before the sweeps (``train`` does it)."""
    if X.gram is None:
        raise ValueError("ss_markers: the data's branch Grams are not formed; call "
                         "X.form_gram() before the first sweep")


def _ssm_sweep_end(gen, carry: TrainCarry, cfg: MCMCCfg, marker_rows) -> TrainCarry:
    """The end of a sweep with the marker scan, after ``sweeps`` was
    incremented (the JAX package's ``ssm_sweep_end``, net.py:1256): unless
    ``cfg.ssm_fixed_pi``, pi ~ Beta(1 + nz, 1 + M - nz) per chain, nz the
    included true markers of M, clipped to [1e-4, 0.999] and drawn as
    Ga(a) / (Ga(a) + Ga(b)) (one ``_gamma`` call); then, once sweeps >
    burn_in, the running mean of z over the sweeps after burn-in, the
    posterior inclusion probabilities (in place). ``marker_rows`` [G, m_pad]
    are the true markers."""
    if not cfg.ssm_fixed_pi:
        nz = torch.sum(carry.ssm_z * marker_rows, dim=(-2, -1))
        tot = float(marker_rows.sum())
        ga, gb = gibbs.gamma_many(gen, [(1.0 + nz, 1.0), (1.0 + tot - nz, 1.0)])
        carry = carry._replace(ssm_pi=torch.clamp(ga / (ga + gb), 1e-4, 0.999))
    post = carry.sweeps - cfg.burn_in
    if post > 0:
        carry.ssm_pip.add_((carry.ssm_z - carry.ssm_pip) / float(post))
    return carry


# --------------------------------------------------------------------------
# Sweeps
# --------------------------------------------------------------------------


def default_block_size(G: int) -> int:
    """Largest divisor of G not above G // 8 (at least 1): about 8 sequential
    block rounds per sweep."""
    target = max(G // 8, 1)
    for b in range(target, 0, -1):
        if G % b == 0:
            return b
    return 1


def chain_fold_eligible(model_type: str, act: str, cfg: MCMCCfg) -> bool:
    """True when the hybrid or parallel sweep integrates each block for all
    chains in one whole-trajectory call (samplers/hmc.make_transition_batch):
    the parallel schedule, or the hybrid one with its shared per-sweep block
    permutation (each chain's own permutation would give each chain another
    block of genotypes), the live accept, fixed-length marginal HMC with
    izmailov, std_scaled or dual-averaging step sizes (with or without mass
    adaptation), and an activation the kernels take; with or without the
    per-marker spike-and-slab (whose scan runs before the fold and whose row
    pins reach the kernels as step sizes and momenta), as in the JAX
    package. The trainer folds whenever this holds, for any number of chains. On a
    CUDA tensor a branch beyond the kernels' limits makes the kernels'
    wrappers raise (the CLI refuses it before training); it never runs on
    the plain version."""
    return (
        (cfg.update_mode == "parallel" or (cfg.update_mode == "hybrid" and cfg.hybrid_shared_perm))
        and cfg.live_accept
        and not (cfg.joint_hmc or cfg.gradient_descent or cfg.gradient_descent_joint)
        and not (cfg.spike_slab or cfg.ss_rows)
        and not cfg.trajectories
        and not (cfg.num_grad or cfg.num_grad_traj)
        and cfg.hmc_traj_length_mode == "fixed"
        and cfg.hmc_step_size_mode in ("izmailov", "std_scaled", "dual_averaging")
        and act in SUPPORTED_ACTIVATIONS
    )


def _shared_perm(seed: int, sweep: int, G: int) -> torch.Tensor:
    """The hybrid's block permutation of one sweep, shared by all chains:
    drawn on the CPU from a generator seeded from (seed ^ 0x5EED5EED, sweep),
    so the card and the CPU walk the same blocks."""
    gen = torch.Generator().manual_seed(
        ((seed ^ 0x5EED5EED) & 0xFFFFFFFF) << 32 | (sweep & 0xFFFFFFFF)
    )
    return torch.randperm(G, generator=gen)


def _live_accept_select(residual0, preds_blk, prop: HMCProposal, err, old_w, old_b, order, us):
    """Sequential live-residual Metropolis accepts for a block of proposals.

    residual0 [C, n] is y - bias - sum_g pred_g over all branches; preds_blk
    [C, B, n] the block's snapshot predictions; ``prop`` the block's
    proposals ([C, B] leaves); err [C]; ``order`` [C, B] the visiting order
    of each chain (a permutation of the block) and ``us`` [C, B] its accept
    uniforms, used in visiting order. An accepted branch moves the live
    residual the next branch of its chain tests against. Both ends of each
    ratio go through the proposal's own operator (y_pred0, y_pred_prop).
    Returns an HMCResult of [C, B] accept-selected params, codes and
    acceptance probabilities.
    """
    C, B = order.shape
    cix = torch.arange(C, device=order.device)
    r = residual0
    accept = torch.zeros((C, B), dtype=torch.bool, device=r.device)
    code = torch.zeros((C, B), dtype=torch.int64, device=r.device)
    alpha = torch.zeros((C, B), dtype=r.dtype, device=r.device)
    for i in range(B):
        g = order[:, i]
        tgt = r + preds_blk[cix, g]
        d0 = tgt - prop.y_pred0[cix, g]
        d = tgt - prop.y_pred_prop[cix, g]
        log_acc = (prop.prior_prop[cix, g] - err * torch.sum(d * d, dim=-1) / 2.0
                   - prop.kin_prop[cix, g]) - (
            prop.prior0[cix, g] - err * torch.sum(d0 * d0, dim=-1) / 2.0 - prop.kin0[cix, g])
        dead = prop.dead[cix, g]
        # NaN log_acc rejects: a NaN comparison is False
        mh_ok = torch.log(us[:, i]) < log_acc
        acc = ~dead & mh_ok
        accept[cix, g] = acc
        code[cix, g] = torch.where(dead, 2, torch.where(mh_ok, 0, 1))
        alpha[cix, g] = torch.where(dead | torch.isnan(log_acc), 0.0,
                                    torch.clamp(torch.exp(log_acc), max=1.0))
        r = torch.where(acc[:, None], d, r)

    def sel(new, old):
        return torch.where(accept.reshape((C, B) + (1,) * (new.dim() - 2)), new, old)

    return HMCResult(
        weights=tuple(sel(n, o) for n, o in zip(prop.weights, old_w)),
        biases=tuple(sel(n, o) for n, o in zip(prop.biases, old_b)),
        code=code,
        y_pred=torch.where(accept[..., None], prop.y_pred_prop, preds_blk),
        log_density=torch.zeros((C, B), dtype=r.dtype, device=r.device),
        accept_prob=alpha,
    )


def _stack_proposals(props, C, B) -> HMCProposal:
    """[C * B] per-branch HMCProposals (chain-major) -> one with [C, B] leaves."""
    def st(ts):
        t = torch.stack(list(ts))
        return t.reshape((C, B) + t.shape[1:])

    return HMCProposal(
        weights=tuple(st(ws) for ws in zip(*(p.weights for p in props))),
        biases=tuple(st(bs) for bs in zip(*(p.biases for p in props))),
        **{f: st(getattr(p, f) for p in props) for f in HMCProposal._fields[2:]},
    )


def _gd_block(transition, w_b, b_b, wp_b, bp_b, err_prec, x_c, targets) -> HMCResult:
    """Gradient descent for a block of every chain ([C, B] leaves), chain by
    chain, each chain's B branches in one batched transition against their
    frozen targets; ``x_c[c]`` is chain c's block of genotypes."""
    outs = []
    for c in range(len(x_c)):
        def one(ts):
            return tuple(t[c] for t in ts)

        outs.append(transition(None, one(w_b), one(b_b), one(wp_b), one(bp_b), err_prec[c],
                               x_c[c], targets[c], None, None, None))
    return HMCResult(
        weights=tuple(torch.stack(ws) for ws in zip(*(o.weights for o in outs))),
        biases=tuple(torch.stack(bs) for bs in zip(*(o.biases for o in outs))),
        **{f: torch.stack([getattr(o, f) for o in outs]) for f in HMCResult._fields[2:]},
    )


def make_hybrid_sweep(model_type: str, act: str, arch: NetArch, cfg: MCMCCfg, hyper, device,
                      fold: Optional[bool] = None):
    """Build the hybrid or parallel sweep over a carry of C = cfg.num_chains
    chains: sweep(carry, X, y, gen) -> (TrainCarry, SweepStats), every
    tensor with a leading [C] axis.

    ``fold`` picks the block transition: one whole-trajectory call for the
    whole block and all chains (True: K5 on packed genotypes, K6 on a
    FeatX), or each (chain, branch) on its own lean transition (False: K4
    per branch on packed genotypes; on a FeatX the lean body batched over
    the block's (chain, branch) pairs, ``make_lean_batch``, with the
    snapshot predictions from K8's forward-only pass, both reading X in
    place). The default folds when ``chain_fold_eligible`` holds. Both
    consume the same random draws, so for one generator state they give the
    same chain up to f32 rounding.

    Under ``cfg.gradient_descent`` (the JAX block body with ``live_accept``
    off) each chain's block runs one batched gradient-descent transition
    over its branches against the block's frozen targets, the results are
    taken as they are, and the residual moves by the sum of the block's
    prediction changes. It draws no momenta and no accept uniforms.

    The parallel schedule (rs_bann_tpu ``sweep_parallel``, net.py:1376) is
    ``block_update`` over the single block arange(G): one error-precision
    draw with its floor, the local precisions of all G branches in one
    batched Gamma call, then the output precision, the snapshot predictions
    and targets, one folded transition over all G, the live accept over all
    G in a random order, the LPD bookkeeping, the output bias and the
    counts. On the default configuration the two agree step for step; the
    port draws in another order (one Gamma call for all local precisions,
    not one key per branch).

    With ``cfg.ss_markers`` each block follows the JAX block body
    (net.py:1923-1943, 2090-2096): the local precisions with the excluded
    rows' prior draws, the snapshot predictions and targets, the marker
    scans of all the block's (chain, branch) instances against the
    block-start residual in one launch (``scan_block``), layer 0 replaced
    and z written, the transition with the row pins and its initial-state
    value pass at the post-scan layer 0, then the live accept on the
    snapshot rebased to it, ``residual += sum_B (preds - y_pred0)``.
    """
    bad = unported_options(cfg)
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")
    statics = D.branch_statics(arch, device)
    masks_w = P.weight_masks(arch, device)
    masks_b = P.bias_masks(arch, device)
    G, L = arch.num_branches, arch.num_layers
    C = max(int(cfg.num_chains), 1)
    parallel = cfg.update_mode == "parallel"
    shared = parallel or cfg.hybrid_shared_perm
    if parallel:
        Bk = G
    else:
        Bk = cfg.block_size if cfg.block_size > 0 else default_block_size(G)
    if G % Bk:
        raise ValueError(f"block_size {Bk} must divide the number of branches {G}")
    eligible = chain_fold_eligible(model_type, act, cfg)
    if fold and not eligible:
        raise ValueError("this configuration cannot fold the chains")
    folded = eligible if fold is None else fold
    n_out_tot = float(arch.total_output_weights)
    sample_local = not cfg.fixed_param_precisions and model_type != "std_normal"
    lam_e_floor = float(cfg.lam_e_floor)
    lam_row_floor = float(cfg.lam_row_floor)
    lasso = D.is_lasso(model_type)
    gd = cfg.gradient_descent
    transition = (make_gradient_descent(model_type, act, cfg) if gd
                  else make_hmc_step(model_type, act, cfg, defer_accept=True))
    fold_transition = make_transition_batch(model_type, act, cfg) if folded else None
    lean_batch = make_lean_batch(model_type, act, cfg)
    adapt = _Adaptation(model_type, cfg, gd=gd)
    ssm = _check_ssm(model_type, arch, cfg, gd)
    marker_rows = statics.row_masks[0][..., 0]  # [G, m_pad] true markers
    cix = torch.arange(C, device=device)[:, None]
    # at depth 0 the packed value passes take layer 0's true width: the
    # padded columns' weights, biases and w_out rows are zero (masked
    # momenta), so they add nothing
    k_live = max(arch.s) if arch.depth == 0 else None

    def flat(ts):  # [C, Bk, ...] -> [C * Bk, ...], chain-major
        return tuple(t.reshape((C * Bk,) + t.shape[2:]) for t in ts)

    def unflat(t):  # [C * Bk, ...] -> [C, Bk, ...]
        return t.reshape((C, Bk) + t.shape[1:])

    def scan_block(carry, gen, X, x_blk, ix, ixs, w_b, wp_b, err_prec, residual):
        """The marker scans of the block's [C, Bk] (chain, branch)
        instances, chain-major, in one ``marker_scan`` call, against the
        block-start residual: u0 from one K9b launch (or matmul) on the
        shared block, else one per chain. Writes z into the carry; returns
        (w_b with the new layer 0, z [C, Bk, m_pad])."""
        if shared and ix is None:
            u0 = D.marker_u0(x_blk, residual.transpose(0, 1)).permute(2, 0, 1)
        else:  # each chain's own block, or a FeatX read in place
            u0 = torch.stack([
                D.marker_u0(x_blk[c] if isinstance(x_blk, list) else X[ixs[c]],
                            residual[c, :, None])[..., 0] for c in range(C)])
        gix = ixs.reshape(-1)
        z, w0 = _marker_scans(
            gen, lasso, carry.sweeps < cfg.ssm_warmup, X.gram, gix,
            u0.reshape(C * Bk, -1), flat(w_b[:1])[0], w_b[-1].reshape(C * Bk, -1),
            wp_b[0].reshape(C * Bk, -1), err_prec.repeat_interleave(Bk),
            carry.ssm_pi.repeat_interleave(Bk), marker_rows[gix], masks_b[0][gix])
        carry.ssm_z[cix, ixs] = unflat(z)
        return (unflat(w0),) + tuple(w_b[1:]), unflat(z)

    def hmc_block(gen, w_b, b_b, wp_b, bp_b, err_prec, x, ix, targets, preds, mw_b, mb_b, st_b,
                  residual, factors, mass, pins):
        """The block's HMC proposals (folded; on a FeatX every (chain,
        branch) of the block in one batched lean body reading X in place
        through ``ix``; else per (chain, branch) against each chain's ``x[c]``
        when the permutation is not shared), accepted one by one against the
        live residual. ``factors`` [C, Bk] (or None) and ``mass`` (per-layer
        [C, Bk, ...] estimates, or Nones) are the adapted step factors and
        mass; ``pins`` [C, Bk, m_pad] the marker scan's row pins, or None.
        With pins the snapshot ``preds`` (taken before the scan) is rebased
        to the proposals' own initial-state predictions first. Returns (the
        accept-selected HMCResult, the residual and the predictions the
        accept ran against)."""
        momenta = (
            tuple(torch.randn(w.shape, generator=gen, device=gen.device) for w in w_b),
            tuple(torch.randn(b.shape, generator=gen, device=gen.device) for b in b_b),
        )
        mass_w, mass_b = mass
        if folded:
            prop = fold_transition(w_b, b_b, wp_b, bp_b, err_prec, x, targets, mw_b, mb_b,
                                   momenta, y_pred0=None if ssm else preds, k_live=k_live,
                                   step_factors=factors, mass_w=mass_w, mass_b=mass_b,
                                   row_pins=pins)
        elif ix is not None:
            p = lean_batch(gen, flat(w_b), flat(b_b), flat(wp_b), flat(bp_b),
                           err_prec.repeat_interleave(Bk), x, ix, targets.reshape(C * Bk, -1),
                           flat(mw_b), flat(mb_b), st_b.n_params.reshape(-1),
                           (flat(momenta[0]), flat(momenta[1])),
                           step_factor=None if factors is None else factors.reshape(-1),
                           mass_w=None if mass_w is None else flat(mass_w),
                           mass_b=None if mass_b is None else flat(mass_b),
                           row_pins=None if pins is None else pins.reshape(C * Bk, -1))
            prop = HMCProposal(tuple(map(unflat, p.weights)), tuple(map(unflat, p.biases)),
                               *map(unflat, p[2:]))
        else:
            props = []
            for c in range(C):
                for j in range(Bk):
                    def one(ts):
                        return None if ts is None else tuple(t[c, j] for t in ts)

                    props.append(transition(
                        gen, one(w_b), one(b_b), one(wp_b), one(bp_b), err_prec[c],
                        x[j] if shared else x[c][j], targets[c, j], one(mw_b), one(mb_b),
                        st_b.n_params[c, j], momenta=(one(momenta[0]), one(momenta[1])),
                        step_factor=None if factors is None else factors[c, j],
                        mass_w=one(mass_w), mass_b=one(mass_b),
                        row_pins=None if pins is None else pins[c, j],
                    ))
            prop = _stack_proposals(props, C, Bk)
        if pins is not None:
            residual = residual + torch.sum(preds - prop.y_pred0, dim=1)
            preds = prop.y_pred0
        order = torch.argsort(torch.rand((C, Bk), generator=gen, device=gen.device), dim=-1)
        us = torch.rand((C, Bk), generator=gen, device=gen.device)
        res = _live_accept_select(residual, preds, prop, err_prec, w_b, b_b, order, us)
        return res, residual, preds

    def block_update(carry: TrainCarry, ixs, X, var_y, gen) -> TrainCarry:
        """One block: ixs [C, Bk], the same row for every chain when the
        permutation is ``shared``; ``folded`` runs one whole-trajectory call."""
        state, residual = carry.state, carry.residual
        params, precisions = state.params, state.precisions
        wp, bp = precisions.weights, precisions.biases

        def take(a):  # [C, G, ...] -> [C, Bk, ...]
            return a[cix, ixs]

        st_b = type(statics)(*(tuple(a[ixs] for a in f) if isinstance(f, tuple) else f[ixs]
                               for f in statics))
        mw_b = tuple(m[ixs] for m in masks_w)
        mb_b = tuple(m[ixs] for m in masks_b)
        w_b = tuple(take(w) for w in params.weights)
        b_b = tuple(take(b) for b in params.biases)

        err_prec = gibbs.error_precision_posterior(gen, hyper, residual)  # [C]
        if lam_e_floor > 0:
            err_prec = torch.clamp(err_prec, min=lam_e_floor / (var_y + 1e-30))
        if sample_local:
            new_wp, new_bp = _gibbs_local_precisions(
                gen, model_type, w_b, b_b, st_b, hyper, L, lam_floor=lam_row_floor,
                z_rows0=take(carry.ssm_z) if ssm else None,
            )
            for l in range(L - 1):
                wp[l][cix, ixs] = new_wp[l]
                bp[l][cix, ixs] = new_bp[l]
            lam_out = _gibbs_output_precision(
                gen, model_type, _reg_all(model_type, params), n_out_tot, hyper
            )
            wp[L - 1].copy_(lam_out.reshape(-1, 1, 1, 1).expand_as(wp[L - 1]))
        wp_b = tuple(take(a) for a in wp)
        bp_b = tuple(take(a) for a in bp)

        ix = None
        if isinstance(X, D.FeatX) and not (folded or gd):
            # every (chain, branch) reads its branch of X in place
            x_blk, ix = X, ixs.reshape(-1).to(torch.int32)
            preds = unflat(forward_blocked(act, X.xT, ix, flat(w_b), flat(b_b)))
        elif shared:  # the block's genotypes, shared by the chains
            x_blk = X if parallel else X[ixs[0]]
            preds = D.predict_chains(act, w_b, b_b, x_blk, k_live)  # [C, Bk, n]
        else:  # each chain's own block
            x_blk = [X[ixs[c]] for c in range(C)]
            preds = torch.stack([
                D.predict(act, tuple(w[c] for w in w_b), tuple(b[c] for b in b_b), x_blk[c])
                for c in range(C)
            ])
        targets = residual[:, None, :] + preds
        if gd:
            res = _gd_block(transition, w_b, b_b, wp_b, bp_b, err_prec,
                            [x_blk] * C if shared else x_blk, targets)
        else:
            pins = None
            if ssm:
                w_b, pins = scan_block(carry, gen, X, x_blk, ix, ixs, w_b, wp_b, err_prec,
                                       residual)
            # the factors and masses of the block's [C, Bk] branches, once
            factors, mass = adapt.inputs(carry, (cix, ixs), wp_b, bp_b, w_b, b_b)
            res, residual, preds = hmc_block(gen, w_b, b_b, wp_b, bp_b, err_prec, x_blk, ix,
                                             targets, preds, mw_b, mb_b, st_b, residual,
                                             factors, mass, pins)
        for l in range(L):
            params.weights[l][cix, ixs] = res.weights[l]
        for l in range(L - 1):
            params.biases[l][cix, ixs] = res.biases[l]
        residual = residual + torch.sum(preds - res.y_pred, dim=1)
        # DA on the live accept's probabilities, Welford on the accept-selected
        # parameters
        adapt.update(carry, (cix, ixs), res.accept_prob, res.weights, res.biases)

        # log posterior density bookkeeping
        carry.lpd_local[cix, ixs] = D.joint_local_term(
            model_type, res.weights, res.biases, wp_b, bp_b, hyper, st_b
        )
        w0 = tuple(w[:, 0] for w in params.weights)
        lpd_out = D.joint_output_term(
            model_type, w0, tuple(a[:, 0] for a in wp), hyper,
            _reg_all(model_type, params) - D.summary_stat(model_type, w0[-1]), n_out_tot,
        )
        lpd_rss = D.joint_rss_term(
            err_prec, torch.sum(residual**2, dim=-1), hyper, float(residual.shape[-1])
        )
        residual, bias, bias_prec = _update_output_bias(
            cfg, hyper, gen, residual, state.output_bias, state.output_bias_precision, err_prec
        )
        carry.counts.add_(torch.nn.functional.one_hot(res.code, 3).sum(dim=1))
        return carry._replace(
            state=NetState(params, StackedPrecisions(wp, bp, err_prec), bias, bias_prec),
            residual=residual,
            lpd_out=lpd_out,
            lpd_rss=lpd_rss,
        )

    def sweep(carry: TrainCarry, X, y, gen):
        if ssm:
            _require_gram(X)
        var_y = torch.var(y, unbiased=False)
        if parallel:
            perm = torch.arange(G, device=device).expand(C, G)
        elif cfg.hybrid_shared_perm:
            perm = _shared_perm(cfg.seed, carry.sweeps, G).to(device).expand(C, G)
        else:
            perm = torch.stack([torch.randperm(G, generator=gen, device=gen.device)
                                for _ in range(C)]).to(device)
        for r in range(G // Bk):
            carry = block_update(carry, perm[:, r * Bk : (r + 1) * Bk], X, var_y, gen)
        carry = carry._replace(sweeps=carry.sweeps + 1)
        if ssm:
            carry = _ssm_sweep_end(gen, carry, cfg, marker_rows)
        n = float(carry.residual.shape[-1])
        return carry, SweepStats(
            counts=carry.counts.clone(),
            mse_train=torch.sum(carry.residual**2, dim=-1) / n,
            lpd=carry.lpd_rss + carry.lpd_out + torch.sum(carry.lpd_local, dim=-1),
        )

    return sweep


def _carry_tensors(carry: TrainCarry) -> list:
    return P.state_leaves(carry.state) + [getattr(carry, f) for f in TrainCarry._fields[1:-1]]


def chain_carry(carry: TrainCarry, c: int) -> TrainCarry:
    """Chain c of a stacked carry, as views into it."""
    return TrainCarry(
        state=P.map_state(lambda a: a[c], carry.state),
        **{f: getattr(carry, f)[c] for f in TrainCarry._fields[1:-1]},
        sweeps=carry.sweeps,
    )


def stack_carries(carries) -> TrainCarry:
    """One-chain carries -> a carry with a leading [C] axis (copies)."""
    return TrainCarry(
        state=P.map_state(lambda *a: torch.stack(a), *(c.state for c in carries)),
        **{f: torch.stack([getattr(c, f) for c in carries]) for f in TrainCarry._fields[1:-1]},
        sweeps=carries[0].sweeps,
    )


def _chain_slice(carry: TrainCarry, c: int) -> TrainCarry:
    """Chain c of a stacked carry as a one-chain stacked carry ([1] axis),
    as views into it."""
    return TrainCarry(
        state=P.map_state(lambda a: a[c:c + 1], carry.state),
        **{f: getattr(carry, f)[c:c + 1] for f in TrainCarry._fields[1:-1]},
        sweeps=carry.sweeps,
    )


def make_chain_sweep(model_type: str, act: str, arch: NetArch, cfg: MCMCCfg, hyper, device,
                     chain_by_chain: bool = False):
    """The sweep of cfg's schedule over a carry of cfg.num_chains chains
    (leading [C] axis): the hybrid or parallel sweep, or the sequential one
    run on each chain in turn. ``chain_by_chain`` runs the hybrid or
    parallel sweep on each chain in turn too (the JAX trainer's ``lax.map``
    over chains, which its GD warm start takes)."""
    hybrid = cfg.update_mode in ("hybrid", "parallel")
    if hybrid and not chain_by_chain:
        return make_hybrid_sweep(model_type, act, arch, cfg, hyper, device)
    if hybrid:
        sweep1 = make_hybrid_sweep(model_type, act, arch,
                                   dataclasses.replace(cfg, num_chains=1), hyper, device)
        view = _chain_slice
    else:
        sweep1 = make_sweep(model_type, act, arch, cfg, hyper, device)
        view = chain_carry

    def sweep(carry: TrainCarry, X, y, gen):
        stats = []
        for c in range(carry.residual.shape[0]):
            one, st = sweep1(view(carry, c), X, y, gen)
            stats.append(SweepStats(*(t[0] for t in st)) if hybrid else st)
            # write back what the one-chain sweep replaced rather than
            # updated in place
            for dst, src in zip(_carry_tensors(view(carry, c)), _carry_tensors(one)):
                if dst.data_ptr() != src.data_ptr():
                    dst.copy_(src)
        return carry._replace(sweeps=carry.sweeps + 1), SweepStats(
            *(torch.stack(f) for f in zip(*stats))
        )

    return sweep


def make_sweep(model_type: str, act: str, arch: NetArch, cfg: MCMCCfg, hyper, device):
    """Build the one-iteration sequential Gibbs sweep:
    sweep(carry, X, y, gen) -> (TrainCarry, SweepStats). With
    ``cfg.ss_markers`` each branch update runs the marker scan of its branch
    against the live residual before its transition (the JAX package's
    net.py:1009-1021, row pins :1111-1112): one instance of ``marker_scan``."""
    bad = unported_options(cfg)
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")
    statics = D.branch_statics(arch, device)
    masks_w = P.weight_masks(arch, device)
    masks_b = P.bias_masks(arch, device)
    G, L = arch.num_branches, arch.num_layers
    n_out_tot = float(arch.total_output_weights)
    sample_local = not cfg.fixed_param_precisions and model_type != "std_normal"
    transition = (make_gradient_descent(model_type, act, cfg) if cfg.gradient_descent
                  else make_hmc_step(model_type, act, cfg))
    lam_e_floor = float(cfg.lam_e_floor)
    lam_row_floor = float(cfg.lam_row_floor)
    adapt = _Adaptation(model_type, cfg, gd=cfg.gradient_descent)
    ssm = _check_ssm(model_type, arch, cfg, cfg.gradient_descent)
    lasso = D.is_lasso(model_type)
    marker_rows = statics.row_masks[0][..., 0]  # [G, m_pad] true markers

    def branch_update(carry: TrainCarry, g: int, X, var_y, gen) -> TrainCarry:
        state, residual = carry.state, carry.residual
        params, precisions = state.params, state.precisions
        w_g = tuple(w[g] for w in params.weights)  # views into the stacked state
        b_g = tuple(b[g] for b in params.biases)
        mw_g = tuple(m[g] for m in masks_w)
        mb_g = tuple(m[g] for m in masks_b)
        st_g = D.slice_branch(statics, g)
        x_g = X[g]
        wp, bp = precisions.weights, precisions.biases

        err_prec = gibbs.error_precision_posterior(gen, hyper, residual)
        if lam_e_floor > 0:
            err_prec = torch.clamp(err_prec, min=lam_e_floor / (var_y + 1e-30))
        if sample_local:
            new_wp_g, new_bp_g = _gibbs_local_precisions(
                gen, model_type, w_g, b_g, st_g, hyper, L, lam_floor=lam_row_floor,
                z_rows0=carry.ssm_z[g] if ssm else None,
            )
            for l in range(L - 1):
                wp[l][g] = new_wp_g[l]
                bp[l][g] = new_bp_g[l]
            lam_out = _gibbs_output_precision(
                gen, model_type, _reg_all(model_type, params), n_out_tot, hyper
            )
            wp[L - 1].fill_(lam_out)
        wp_g = tuple(a[g] for a in wp)
        bp_g = tuple(a[g] for a in bp)

        target = residual + D.predict(act, w_g, b_g, x_g)
        pins = None
        if ssm:
            gix = torch.full((1,), g, dtype=torch.int64, device=residual.device)
            z, w0 = _marker_scans(
                gen, lasso, carry.sweeps < cfg.ssm_warmup, X.gram, gix,
                D.marker_u0(x_g, residual[:, None])[None, :, 0], w_g[0][None],
                w_g[-1][None, :, 0], wp_g[0][None, :, 0], err_prec.reshape(1),
                carry.ssm_pi.reshape(1), marker_rows[g][None], mb_g[0][None])
            w_g = (w0[0],) + tuple(w_g[1:])
            pins = z[0]
            carry.ssm_z[g] = pins
        if cfg.gradient_descent:
            res = transition(
                gen, w_g, b_g, wp_g, bp_g, err_prec, x_g, target, mw_g, mb_g, st_g.n_params
            )
        else:
            factor, (mass_w, mass_b) = adapt.inputs(carry, g, wp_g, bp_g, w_g, b_g)
            res = transition(
                gen, w_g, b_g, wp_g, bp_g, err_prec, x_g, target, mw_g, mb_g, st_g.n_params,
                step_factor=factor, mass_w=mass_w, mass_b=mass_b, row_pins=pins,
            )
        # DA on the accept probability, Welford on the accepted parameters
        adapt.update(carry, g, res.accept_prob, res.weights, res.biases)
        residual = target - res.y_pred
        for l in range(L):
            params.weights[l][g] = res.weights[l]
        for l in range(L - 1):
            params.biases[l][g] = res.biases[l]
        w_g = tuple(w[g] for w in params.weights)

        # log posterior density bookkeeping (w_g / b_g now see the new values)
        carry.lpd_local[g] = D.joint_local_term(model_type, w_g, b_g, wp_g, bp_g, hyper, st_g)
        reg_sum_others = _reg_all(model_type, params) - D.summary_stat(model_type, w_g[-1])
        lpd_out = D.joint_output_term(model_type, w_g, wp_g, hyper, reg_sum_others, n_out_tot)
        lpd_rss = D.joint_rss_term(
            err_prec, torch.sum(residual**2), hyper, float(residual.shape[0])
        )
        residual, bias, bias_prec = _update_output_bias(
            cfg, hyper, gen, residual, state.output_bias, state.output_bias_precision,
            err_prec,
        )
        carry.counts.index_add_(0, res.code.reshape(1), torch.ones_like(carry.counts[:1]))
        return carry._replace(
            state=NetState(params, StackedPrecisions(wp, bp, err_prec), bias, bias_prec),
            residual=residual,
            lpd_out=lpd_out,
            lpd_rss=lpd_rss,
        )

    def sweep(carry: TrainCarry, X, y, gen):
        if ssm:
            _require_gram(X)
        var_y = torch.var(y, unbiased=False)
        perm = torch.randperm(G, generator=gen, device=gen.device).tolist()
        for g in perm:
            carry = branch_update(carry, g, X, var_y, gen)
        carry = carry._replace(sweeps=carry.sweeps + 1)
        if ssm:
            carry = _ssm_sweep_end(gen, carry, cfg, marker_rows)
        n = float(carry.residual.shape[0])
        return carry, SweepStats(
            counts=carry.counts.clone(),
            mse_train=torch.sum(carry.residual**2) / n,
            lpd=carry.lpd_rss + carry.lpd_out + torch.sum(carry.lpd_local),
        )

    return sweep


def clone_state(s: NetState) -> NetState:
    return P.map_state(torch.clone, s)


class Net:
    """Full model: architecture + hyperparameters + sampler state."""

    # stacked per-branch activations larger than this are computed in chunks
    # of branches, so genome-scale n does not hold all G at once
    PREDICT_CHUNK_BYTES = 2_000_000_000

    def __init__(self, model_type: str, arch: NetArch, hyper: D.Hyperparameters,
                 state: NetState):
        if model_type not in D.MODEL_TYPES:
            raise ValueError(f"unknown model type {model_type}")
        self.model_type = model_type
        self.arch = arch
        self.hyper = hyper
        self.state = state

    @property
    def device(self) -> torch.device:
        return self.state.output_bias.device

    # ------------------------------------------------------------- predict
    def predict(self, X, state: Optional[NetState] = None) -> torch.Tensor:
        """y_hat [n] = bias + sum of branch predictions."""
        state = state if state is not None else self.state
        act = self.arch.activation
        n = X.n if isinstance(X, (D.PackedX, D.FeatX)) else X.shape[1]
        out = state.output_bias + torch.zeros(n, device=state.output_bias.device)
        for part in self._branch_map(
                lambda x, ws, bs: torch.sum(D.predict(act, ws, bs, x), dim=0), X, state):
            out = out + part
        return out

    def _chunk(self, n: int, width: Optional[int] = None) -> int:
        """Branches per chunk of a stacked pass over ``n`` individuals that
        holds ``width`` f32 values per individual and branch (default: the
        widest layer's), so each chunk holds at most PREDICT_CHUNK_BYTES."""
        if width is None:
            width = max(self.arch.layer_out_pad(l) for l in range(self.arch.num_layers))
        return max(1, int(self.PREDICT_CHUNK_BYTES // (4 * n * width)))

    def _branch_map(self, f, X, state: NetState, width: Optional[int] = None) -> list:
        """[f(x, weights, biases)] over chunks of branches (``_chunk``: at
        most PREDICT_CHUNK_BYTES, 2 GB, of ``width`` f32 values per
        individual and branch), each call on its chunk's genotypes and
        parameters: one K2 (or K9a) launch per chunk on packed genotypes,
        where the JAX package maps the branches one by one once their
        stack passes its TPU budget (net.py:2299-2317). At chip_smoke's
        shape (G = 100, n = 100,000, m_pad = 104) the effect-size stack is
        4.16 GB; chunks of 48 branches keep each under 2 GB."""
        n = X.n if isinstance(X, (D.PackedX, D.FeatX)) else X.shape[1]
        G, chunk = self.arch.num_branches, self._chunk(n, width)
        return [f(X[s:e], tuple(w[s:e] for w in state.params.weights),
                  tuple(b[s:e] for b in state.params.biases))
                for s, e in ((s, min(G, s + chunk)) for s in range(0, G, chunk))]

    def mse(self, X, y, state: Optional[NetState] = None) -> torch.Tensor:
        r = self.predict(X, state) - y
        return torch.sum(r * r) / y.shape[0]

    def gradients(self, X, y, state: Optional[NetState] = None):
        """Per-branch gradients of the marginal log density in (weights,
        biases) (the reference's net.rs gradients): a list over branches of
        (weight grads, bias grads), each the padded per-branch numpy array.

        The branches' potentials are separable, so each chunk of branches
        (all G at genome scale) takes one forward and one backward pass: on
        packed genotypes one K2 and one K3 launch (K9a and K9b under silu)
        where the JAX package loops over the branches."""
        state = state if state is not None else self.state
        pot = D.potential_fn(self.model_type, self.arch.activation)
        n = X.n if isinstance(X, (D.PackedX, D.FeatX)) else X.shape[1]
        G, L = self.arch.num_branches, self.arch.num_layers
        chunk = self._chunk(n)
        out = []
        for s in range(0, G, chunk):
            e = min(G, s + chunk)
            ws = [w[s:e].detach().requires_grad_(True) for w in state.params.weights]
            bs = [b[s:e].detach().requires_grad_(True) for b in state.params.biases]
            with torch.enable_grad():
                ld = pot(ws, bs, tuple(a[s:e] for a in state.precisions.weights),
                         state.precisions.error, X[s:e], y)
                grads = [g.cpu().numpy() for g in torch.autograd.grad(torch.sum(ld), ws + bs)]
            out.extend((tuple(g[j] for g in grads[:L]), tuple(g[j] for g in grads[L:]))
                       for j in range(e - s))
        return out

    # ------------------------------------------------------------- analysis
    def branch_r2s(self, X, y, state: Optional[NetState] = None) -> torch.Tensor:
        """Per-branch 1 - rss / ssq(y) of each branch's prediction alone,
        [G]."""
        state = state if state is not None else self.state
        act = self.arch.activation

        def one(x, ws, bs):
            r = D.predict(act, ws, bs, x) - y
            return 1.0 - torch.sum(r * r, dim=-1) / torch.sum(y * y)

        return torch.cat(self._branch_map(one, X, state))

    def activations(self, X, state: Optional[NetState] = None) -> list:
        """Per-branch per-layer activations: a list over branches of lists
        over layers of numpy arrays [n, width_pad] (sample-major on every
        layout), the last the output column [n, 1]."""
        state = state if state is not None else self.state
        act = self.arch.activation

        def one(x, ws, bs):
            acts = D.forward(act, ws, bs, x)[1]
            if isinstance(x, D.FeatX):  # hidden activations are feature-major
                acts = [a.transpose(-1, -2) for a in acts[:-1]] + acts[-1:]
            acts = [a.cpu().numpy() for a in acts]
            return [[a[j] for a in acts] for j in range(acts[0].shape[0])]

        return [branch for part in self._branch_map(one, X, state) for branch in part]

    def _effect_width(self) -> int:
        return max(self.arch.m_pad, *(self.arch.layer_out_pad(l)
                                      for l in range(self.arch.num_layers)))

    def effect_sizes(self, X, state: Optional[NetState] = None) -> torch.Tensor:
        """Input gradients d y_hat / d x of every branch, [G, n, m_pad]
        (``D.effect_sizes``), chunk by chunk of branches."""
        state = state if state is not None else self.state
        act = self.arch.activation
        return torch.cat(self._branch_map(lambda x, ws, bs: D.effect_sizes(act, ws, bs, x),
                                          X, state, self._effect_width()))

    def population_effect_sizes(self, X, state: Optional[NetState] = None) -> list:
        """Each true marker's mean input gradient over the individuals, the
        branches' markers one after another. Each chunk's gradients are
        reduced as they come, so the [G, n, m_pad] stack never forms."""
        state = state if state is not None else self.state
        act = self.arch.activation
        means = torch.cat(self._branch_map(
            lambda x, ws, bs: torch.mean(D.effect_sizes(act, ws, bs, x), dim=-2),
            X, state, self._effect_width())).cpu().numpy()
        return [v for g in range(self.arch.num_branches)
                for v in means[g, : self.arch.m[g]].tolist()]

    def perturb(self, params_by: Optional[float], precisions_by: Optional[float]) -> "Net":
        """Add ``params_by`` to every true (unpadded) weight and bias and
        ``precisions_by`` to every precision, the error precision included
        (the JAX package's ``Net.perturb``); None leaves them as they are."""
        s = self.state
        if params_by is not None:
            mw = P.weight_masks(self.arch, self.device)
            mb = P.bias_masks(self.arch, self.device)
            s = s._replace(params=StackedParams(
                tuple(w + params_by * m for w, m in zip(s.params.weights, mw)),
                tuple(b + params_by * m for b, m in zip(s.params.biases, mb)),
            ))
        if precisions_by is not None:
            q = s.precisions
            s = s._replace(precisions=StackedPrecisions(
                tuple(w + precisions_by for w in q.weights),
                tuple(b + precisions_by for b in q.biases),
                q.error + precisions_by,
            ))
        self.state = s
        return self

    # --------------------------------------------------------------- io
    def save(self, path: str, state: Optional[NetState] = None):
        """Write the JAX package's .npz model format (rs_bann_tpu Net.load
        reads it)."""
        s = P.state_to_numpy(state if state is not None else self.state)
        arrays = {}
        for l, w in enumerate(s.params.weights):
            arrays[f"w{l}"] = w
        for l, b in enumerate(s.params.biases):
            arrays[f"b{l}"] = b
        for l, w in enumerate(s.precisions.weights):
            arrays[f"wp{l}"] = w
        for l, b in enumerate(s.precisions.biases):
            arrays[f"bp{l}"] = b
        arrays["error_precision"] = s.precisions.error
        arrays["output_bias"] = s.output_bias
        arrays["output_bias_precision"] = s.output_bias_precision
        meta = {
            "model_type": self.model_type,
            "arch": {
                "m": list(self.arch.m),
                "h": list(self.arch.h),
                "s": list(self.arch.s),
                "depth": self.arch.depth,
                "activation": self.arch.activation,
                "pad_multiple": self.arch.pad_multiple,
            },
            "hyper": list(self.hyper),
        }
        arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
        np.savez(path, **arrays)

    @staticmethod
    def load(path: str, device) -> "Net":
        z = np.load(path if str(path).endswith(".npz") else str(path) + ".npz")
        meta = json.loads(bytes(z["meta_json"]).decode())
        a = meta["arch"]
        arch = NetArch(
            m=tuple(a["m"]), h=tuple(a["h"]), s=tuple(a["s"]), depth=a["depth"],
            activation=a["activation"], pad_multiple=a["pad_multiple"],
        )
        L = arch.num_layers
        state = P.state_from_numpy(
            NetState(
                StackedParams(
                    tuple(z[f"w{l}"] for l in range(L)),
                    tuple(z[f"b{l}"] for l in range(L - 1)),
                ),
                StackedPrecisions(
                    tuple(z[f"wp{l}"] for l in range(L)),
                    tuple(z[f"bp{l}"] for l in range(L - 1)),
                    z["error_precision"],
                ),
                z["output_bias"],
                z["output_bias_precision"],
            ),
            device,
        )
        return Net(meta["model_type"], arch, D.Hyperparameters(*meta["hyper"]), state)

    # ------------------------------------------------------------- training
    def init_carry(self, X, y, state: Optional[NetState] = None,
                   chains: Optional[int] = None, step_size_factor: float = 1.0,
                   mass_adaptation: bool = False, ss_markers: bool = False,
                   ssm_pi: float = 0.5) -> TrainCarry:
        """residual = y - bias - sum_g pred_g and the initial LPD terms, on a
        copy of the state.

        With ``chains``, a carry for that many chains (leading [C] axis):
        every chain starts from ``state``, or each from its own slice of a
        chain-stacked state.

        The dual-averaging state starts at log eps = log eps_bar =
        log(``step_size_factor``), h_bar = 0; ``mass_adaptation`` sizes the
        Welford accumulators ([G, P_flat] when on, [G, 0] placeholders when
        off: the state is two parameter-sized copies). ``ss_markers`` sizes
        the per-marker spike-and-slab state: z at 1 and the PIPs at 0, [G,
        m_pad] ([G, 0] when off), and pi at ``ssm_pi``."""
        if chains is not None:
            s = self.state if state is None else state
            kw = dict(step_size_factor=step_size_factor, mass_adaptation=mass_adaptation,
                      ss_markers=ss_markers, ssm_pi=ssm_pi)
            if s.params.weights[0].dim() == 4:  # [C, G, in, out]
                return stack_carries([self.init_carry(X, y, P.map_state(lambda a: a[c], s), **kw)
                                      for c in range(chains)])
            return stack_carries([self.init_carry(X, y, s, **kw)] * chains)
        s = clone_state(self.state if state is None else state)
        residual = y - self.predict(X, s)
        statics = D.branch_statics(self.arch, self.device)
        G = self.arch.num_branches
        lpd_local = torch.stack([
            D.joint_local_term(
                self.model_type,
                tuple(w[g] for w in s.params.weights),
                tuple(b[g] for b in s.params.biases),
                tuple(a[g] for a in s.precisions.weights),
                tuple(a[g] for a in s.precisions.biases),
                self.hyper,
                D.slice_branch(statics, g),
            )
            for g in range(G)
        ])
        reg_all = _reg_all(self.model_type, s.params)
        w0 = tuple(w[0] for w in s.params.weights)
        wp0 = tuple(a[0] for a in s.precisions.weights)
        lpd_out = D.joint_output_term(
            self.model_type, w0, wp0, self.hyper,
            reg_all - D.summary_stat(self.model_type, w0[-1]),
            float(self.arch.total_output_weights),
        )
        lpd_rss = D.joint_rss_term(
            s.precisions.error, torch.sum(residual**2), self.hyper,
            float(residual.shape[0]),
        )
        flat_dim = (sum(math.prod(w.shape[1:]) for w in s.params.weights)
                    + sum(math.prod(b.shape[1:]) for b in s.params.biases)
                    if mass_adaptation else 0)
        log_eps0 = torch.full((G,), math.log(step_size_factor), device=self.device)
        m_ss = self.arch.m_pad if ss_markers else 0
        return TrainCarry(
            state=s,
            residual=residual,
            lpd_local=lpd_local,
            lpd_out=lpd_out,
            lpd_rss=lpd_rss,
            counts=torch.zeros(3, dtype=torch.int64, device=self.device),
            da_log_eps=log_eps0,
            da_log_eps_bar=log_eps0.clone(),
            da_h_bar=torch.zeros(G, device=self.device),
            mm_mean=torch.zeros((G, flat_dim), device=self.device),
            mm_m2=torch.zeros((G, flat_dim), device=self.device),
            ssm_z=torch.ones((G, m_ss), device=self.device),
            ssm_pi=torch.tensor(ssm_pi, dtype=torch.float32, device=self.device),
            ssm_pip=torch.zeros((G, m_ss), device=self.device),
        )

    def make_sweep(self, cfg: MCMCCfg):
        return make_sweep(
            self.model_type, self.arch.activation, self.arch, cfg, self.hyper, self.device
        )

    def make_chain_sweep(self, cfg: MCMCCfg, chain_by_chain: bool = False):
        return make_chain_sweep(
            self.model_type, self.arch.activation, self.arch, cfg, self.hyper, self.device,
            chain_by_chain,
        )
