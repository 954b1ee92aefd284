"""Hamiltonian Monte Carlo on packed and feature-major genotypes, and
gradient descent.

Counterpart of rs_bann_tpu/samplers/hmc.py ``step_sizes``, ``HMCProposal``,
``make_hmc_step`` (the default body and the deferred-accept lean body, the
latter also over a batch of instances: ``make_lean_batch``), the
chain-folded block transition of ``make_transition_batch`` and the MAP
transition ``make_gradient_descent``.

Per branch, each leapfrog step's potential and gradient come from the fused
value-and-gradient (ops/branch_mlp.py): K4 on packed genotypes, K8a on a
FeatX (the JAX package's dispatch under ``branch_mlp.FORCE``), plus the
closed-form prior gradient: a default transition of L steps takes L + 1
gradients, a lean (deferred-accept) one L + 2. ``make_lean_batch`` runs the
lean body for every (chain, branch) of an unfolded block on a FeatX at
once, one K8b call per gradient. The folded block transition integrates
all branches of a block for all C chains in one call of a whole-trajectory
kernel (ops/leapfrog.py: K5 on packed genotypes, K6 on a FeatX), between
two forward-only value passes through ``D.predict_chains`` (K2, or K7's
forward).

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

from ..models import density as D
from ..ops import branch_mlp
from .mcmc_cfg import MCMCCfg

ACCEPTED, REJECTED, REJECTED_EARLY = 0, 1, 2


class HMCProposal(NamedTuple):
    """A raw HMC proposal with what an external Metropolis test needs.

    The leapfrog map is reversible and volume-preserving for any potential,
    so the trajectory may integrate a stale potential (the block's frozen
    residual) while the accept runs later against the live conditional
    (models/net.py ``_live_accept_select``):

        log a = [prior(q') - err * rss_live(q') / 2 - K(p')]
              - [prior(q)  - err * rss_live(q)  / 2 - K(p)]

    ``y_pred0`` is the prediction at q through the same operator as
    ``y_pred_prop``, so both ends of the ratio share one operator.
    """

    weights: tuple  # proposal q'
    biases: tuple
    y_pred_prop: torch.Tensor  # [..., n] prediction at q'
    y_pred0: torch.Tensor  # [..., n] prediction at q
    prior_prop: torch.Tensor  # marginal log-prior terms at q'
    prior0: torch.Tensor  # ... at q
    kin_prop: torch.Tensor  # K(p_final)
    kin0: torch.Tensor  # K(p_initial)
    dead: torch.Tensor  # bool: |Delta H| above the threshold or NaN (always reject)


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


def _lean_trajectory(vg, weights, biases, eps_w, eps_b, p_w, p_b, L, max_err, kinetic):
    """The deferred-accept lean body: L plain leapfrog steps, then the final
    value through the same ``vg`` operator as the initial one, and divergence
    tested once at the end (dead iff the final |Delta H| exceeds ``max_err``
    or is NaN; the test is symmetric under reversal). ``vg(w, b)`` returns
    (ld, y_pred, grad_w, grad_b, prior); ``kinetic(p_w, p_b)`` K(p)."""
    ld0, y_pred0, gw, gb, prior0 = vg(weights, biases)
    kin0 = kinetic(p_w, p_b)
    w, b, pw, pb = weights, biases, p_w, p_b
    for _ in range(L):
        pw, pb = _mul_add(pw, eps_w, gw, 0.5), _mul_add(pb, eps_b, gb, 0.5)
        w, b = _mul_add(w, eps_w, pw), _mul_add(b, eps_b, pb)
        _, _, gw, gb, _ = vg(w, b)
        pw, pb = _mul_add(pw, eps_w, gw, 0.5), _mul_add(pb, eps_b, gb, 0.5)
    ld_f, y_pred_f, _, _, prior_f = vg(w, b)
    kin_f = kinetic(pw, pb)
    # NaN-safe: a NaN comparison is False, so ~(|dH| <= max) catches NaN
    dead = ~(torch.abs((ld_f - kin_f) - (ld0 - kin0)) <= max_err)
    return HMCProposal(w, b, y_pred_f, y_pred0, prior_f, prior0, kin_f, kin0, dead)


def make_hmc_step(model_type: str, act_name: str, cfg: MCMCCfg, defer_accept: bool = False):
    """Build the marginal HMC transition for one branch.

    Returned signature:
      hmc(gen, weights, biases, w_precisions, b_precisions, error_precision,
          x, y, masks_w, masks_b, n_params, momenta=None, u=None) -> HMCResult
    ``x`` is a single-branch PackedX or FeatX. ``momenta`` = (p_w, p_b) and the accept
    uniform ``u`` may be passed in; otherwise they are drawn from ``gen``.

    With ``defer_accept`` (the hybrid schedule's live accept) it returns an
    HMCProposal from the lean body instead (``_lean_trajectory``).
    """
    L = cfg.hmc_integration_length
    max_err = cfg.hmc_max_hamiltonian_error

    def vg(weights, biases, w_precisions, error_precision, x, y):
        if isinstance(x, D.PackedX):
            y_pred, rss, dws, dbs = branch_mlp.data_vg_packed(act_name, x, weights, biases, y)
        else:
            y_pred, rss, dws, dbs = branch_mlp.data_vg(act_name, x.xT, weights, biases, y)
        prior = D.log_density_wrt_weights(
            model_type, weights, w_precisions
        ) + D.log_density_wrt_biases(model_type, biases)
        pgw, pgb = D.prior_grad(model_type, weights, biases, w_precisions)
        ld = prior - error_precision * rss / 2.0
        gw = tuple(p - error_precision * d for p, d in zip(pgw, dws))
        gb = tuple(p - error_precision * d for p, d in zip(pgb, dbs))
        return ld, y_pred, gw, gb, prior

    def hmc(
        gen, weights, biases, w_precisions, b_precisions, error_precision, x, y,
        masks_w, masks_b, n_params, momenta=None, u=None,
    ):
        if not isinstance(x, (D.PackedX, D.FeatX)):
            raise NotImplementedError("the port's HMC runs on packed or feature-major genotypes")
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
        if defer_accept:
            return _lean_trajectory(
                lambda w, b: vg(w, b, w_precisions, error_precision, x, y),
                weights, biases, eps_w, eps_b, p_w, p_b, L, max_err, _kinetic)

        ld0, y_pred0, g_w, g_b, _ = vg(weights, biases, w_precisions, error_precision, x, y)
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
            ld1, yp1, gw1, gb1, _ = vg(w1, b1, w_precisions, error_precision, x, y)
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


def _kinetic_batch(p_w, p_b, lead=2):
    """K(p) per index of the ``lead`` leading axes of the momenta ([C, B, ...]
    by default)."""
    return 0.5 * sum(torch.sum(p * p, dim=tuple(range(lead, p.dim()))) for p in p_w + p_b)


def make_lean_batch(model_type: str, act_name: str, cfg: MCMCCfg):
    """The deferred-accept lean body of ``make_hmc_step`` over a leading [NB]
    axis of independent (chain, branch) instances on feature-major X: one
    ``branch_mlp.data_vg_blocked`` call (K8b) per gradient serves them all,
    L + 2 launches per block transition, where JAX vmaps the lean body over
    the block's branches and its custom_vmap rule sends each gradient to its
    branch-blocked kernel.

      lean(gen, weights, biases, w_prec, b_prec, err_prec, x, ix, targets,
           masks_w, masks_b, n_params, momenta) -> HMCProposal, [NB] leaves

    weights/biases/precisions/masks/momenta per layer [NB, ...]; err_prec and
    n_params [NB]; ``x`` the FeatX of all G branches, instance i reading
    branch ix[i] in place; targets [NB, n]; ``momenta`` = (p_w, p_b)
    unmasked standard normals. Per-instance step sizes, kinetic energies and
    ``dead``. It consumes the draws that make_hmc_step(defer_accept=True)
    called instance by instance with the same momenta consumes (none, except
    the random step-size mode's, drawn here in the same order), so both give
    the same proposals up to f32 rounding.
    """
    L = cfg.hmc_integration_length
    max_err = cfg.hmc_max_hamiltonian_error
    random_eps = cfg.hmc_step_size_mode == "random"

    def lean(gen, weights, biases, w_prec, b_prec, err_prec, x, ix, targets, masks_w, masks_b,
             n_params, momenta):
        if random_eps:  # instance by instance, as the per-branch calls draw them
            def one(ts, i):
                return tuple(t[i] for t in ts)

            per = [step_sizes(gen, model_type, cfg, one(weights, i), one(biases, i),
                              one(w_prec, i), one(b_prec, i), n_params[i])
                   for i in range(ix.shape[0])]
            eps_w = tuple(torch.stack(e) for e in zip(*(p[0] for p in per)))
            eps_b = tuple(torch.stack(e) for e in zip(*(p[1] for p in per)))
        else:
            eps_w, eps_b = step_sizes(gen, model_type, cfg, weights, biases, w_prec, b_prec,
                                      n_params)
        p_w = tuple(p * m for p, m in zip(momenta[0], masks_w))
        p_b = tuple(p * m for p, m in zip(momenta[1], masks_b))

        def vg(w, b):
            y_pred, rss, dws, dbs = branch_mlp.data_vg_blocked(act_name, x.xT, ix, w, b, targets)
            prior = D.log_density_wrt_weights(model_type, w, w_prec) + D.log_density_wrt_biases(
                model_type, b)
            pgw, pgb = D.prior_grad(model_type, w, b, w_prec)

            def err(t):  # err_prec [NB] against a [NB, ...] leaf
                return err_prec.reshape((-1,) + (1,) * (t.dim() - 1))

            gw = tuple(p - err(d) * d for p, d in zip(pgw, dws))
            gb = tuple(p - err(d) * d for p, d in zip(pgb, dbs))
            return prior - err_prec * rss / 2.0, y_pred, gw, gb, prior

        return _lean_trajectory(vg, weights, biases, eps_w, eps_b, p_w, p_b, L, max_err,
                                lambda pw, pb: _kinetic_batch(pw, pb, lead=1))

    return lean


def make_transition_batch(model_type: str, act_name: str, cfg: MCMCCfg):
    """The chain-folded block transition: deferred-accept HMC proposals for
    every branch of a block and every chain, integrated by one K5 call
    (packed genotypes) or one K6 call (a FeatX), picked by the type of x.

    Counterpart of the chain rule of rs_bann_tpu ``make_transition_batch``,
    written as a plain function over [C, B] instead of a vmap rule:

      fold(weights, biases, w_prec, b_prec, err_prec, x, targets, masks_w,
           masks_b, momenta, y_pred0=None) -> HMCProposal with [C, B] leaves

    weights/biases/precisions/momenta per layer [C, B, ...]; err_prec [C];
    ``x`` the block's PackedX (bytes [B, m_pad, Bytes]) or FeatX (xT
    [B, m_pad, n]), shared by the chains; targets [C, B, n]; masks [B, ...]
    or [C, B, ...]; ``momenta`` = (p_w, p_b) unmasked standard normals.
    ``y_pred0`` may pass the block's snapshot predictions at the current
    state when they come from ``D.predict_chains`` on the same inputs (then
    they are the H0 value pass); otherwise that pass runs here. Step sizes
    follow the per-branch rule per (chain, branch) (izmailov or
    std_scaled).
    """
    from ..ops.leapfrog import integrate_chains, integrate_chains_packed

    if cfg.hmc_step_size_mode not in ("izmailov", "std_scaled"):
        raise NotImplementedError(
            f"the folded transition takes izmailov or std_scaled step sizes, "
            f"not {cfg.hmc_step_size_mode}"
        )
    L = cfg.hmc_integration_length
    max_err = cfg.hmc_max_hamiltonian_error
    l1 = D.is_lasso(model_type)
    std_normal = model_type == "std_normal"

    def prior(ws, bs, wps):
        return D.log_density_wrt_weights(model_type, ws, wps) + D.log_density_wrt_biases(
            model_type, bs
        )

    def fold(weights, biases, w_prec, b_prec, err_prec, x, targets, masks_w, masks_b, momenta,
             y_pred0=None):
        eps_w, eps_b = step_sizes(None, model_type, cfg, weights, biases, w_prec, b_prec, None)
        p_w = tuple(p * m for p, m in zip(momenta[0], masks_w))
        p_b = tuple(p * m for p, m in zip(momenta[1], masks_b))
        # prior precision factors in the weight layout: grad = -lam * w
        # (-lam * sign(w) for lasso); biases are unregularized in the
        # marginal density except under std_normal's unit precisions
        if std_normal:
            lam_w = tuple(torch.ones_like(w) for w in weights)
            lam_b = tuple(torch.ones_like(b) for b in biases)
        else:
            lam_w = tuple(lam.expand_as(w) for lam, w in zip(w_prec, weights))
            lam_b = tuple(torch.zeros_like(b) for b in biases)
        if y_pred0 is None:
            y_pred0 = D.predict_chains(act_name, weights, biases, x)
        err = err_prec[:, None]

        def neg_h(y_pred, ws, bs, pws, pbs):
            rss = torch.sum((y_pred - targets) ** 2, dim=-1)
            pri, kin = prior(ws, bs, w_prec), _kinetic_batch(pws, pbs)
            return pri - err * rss / 2.0 - kin, pri, kin

        neg_h0, prior0, kin0 = neg_h(y_pred0, weights, biases, p_w, p_b)

        def bc(ts):  # [C, B, ...] <-> [B, C, ...]
            return tuple(t.transpose(0, 1) for t in ts)

        B = targets.shape[1]
        state = (bc(weights), bc(biases), bc(p_w), bc(p_b), bc(eps_w), bc(eps_b), bc(lam_w),
                 bc(lam_b))
        err_bc = err_prec[None, :].expand(B, -1)
        if isinstance(x, D.FeatX):
            out = integrate_chains(act_name, x.xT, targets.transpose(0, 1), err_bc, *state, L,
                                   l1=l1)
        else:
            out = integrate_chains_packed(act_name, x.bytes, x.w_scale, x.shift,
                                          targets.transpose(0, 1), err_bc, *state, L, x.n, l1=l1)
        w_f, b_f, pw_f, pb_f = (bc(t) for t in out)
        y_pred_f = D.predict_chains(act_name, w_f, b_f, x)
        neg_h_f, prior_f, kin_f = neg_h(y_pred_f, w_f, b_f, pw_f, pb_f)
        dead = ~(torch.abs(neg_h_f - neg_h0) <= max_err)
        return HMCProposal(w_f, b_f, y_pred_f, y_pred0, prior_f, prior0, kin_f, kin0, dead)

    return fold


def make_gradient_descent(model_type: str, act_name: str, cfg: MCMCCfg):
    """MAP optimization in place of HMC (the reference's branch_sampler.rs
    gradient descent): per outer iteration, the gradient of the marginal
    log density, then a doubling/halving line search on the rss along it.

    The JAX package's ``lax.while_loop`` is a host loop here: probe the
    step factor ss0 and 2 ss0, take x2 or x1/2, step while the rss falls,
    then back off one step. The gradient comes from autograd of
    ``D.potential_fn`` (on packed genotypes: K2 or K9a forward, K3 or K9b
    backward); the probes and the final value pass need no gradient and run
    under ``torch.no_grad``.

    Returned signature, as ``make_hmc_step``'s:
      gd(gen, weights, biases, w_precisions, b_precisions, error_precision,
         x, y, masks_w, masks_b, n_params, momenta=None, u=None) -> HMCResult
    It draws nothing and ignores gen, b_precisions, the masks, n_params,
    momenta and u. Every tensor may carry leading batch axes, e.g. [B] over
    a hybrid block of branches with ``x`` the block's PackedX: the branches'
    potentials are separable, so one forward and one backward launch serve
    the whole block per gradient, one forward launch per probe, and a
    branch whose line search has ended keeps its step while the others go on
    (as a vmapped ``while_loop`` freezes it). The result is each branch's
    own gradient descent. ``code`` is ACCEPTED and ``accept_prob`` 1.
    """
    L = cfg.hmc_integration_length
    factor = cfg.hmc_step_size_factor
    pot = D.potential_fn(model_type, act_name)

    def rss_at(weights, biases, x, y):
        r = D.predict(act_name, weights, biases, x) - y
        return torch.sum(r * r, dim=-1)

    def grad(weights, biases, w_precisions, error_precision, x, y):
        ws = [w.detach().requires_grad_(True) for w in weights]
        bs = [b.detach().requires_grad_(True) for b in biases]
        with torch.enable_grad():
            ld = pot(ws, bs, w_precisions, error_precision, x, y)
            grads = torch.autograd.grad(torch.sum(ld), ws + bs)
        return tuple(grads[: len(ws)]), tuple(grads[len(ws):])

    def gd(gen, weights, biases, w_precisions, b_precisions, error_precision, x, y,
           masks_w, masks_b, n_params, momenta=None, u=None):
        del gen, b_precisions, masks_w, masks_b, n_params, momenta, u
        batch = weights[-1].shape[:-2]
        dev = weights[-1].device

        def moved(ts, gs, ss):  # ts + ss * gs, ss [batch] broadcast per leaf
            return tuple(t + ss.reshape(batch + (1,) * (t.dim() - len(batch))) * g
                         for t, g in zip(ts, gs))

        w, b = tuple(weights), tuple(biases)
        with torch.no_grad():
            for _ in range(L):
                gw, gb = grad(w, b, w_precisions, error_precision, x, y)

                def probe(ss):
                    return rss_at(moved(w, gw, ss), moved(b, gb, ss), x, y)

                ss0 = torch.full(batch, factor, dtype=torch.float32, device=dev)
                prev = probe(ss0)
                fac = torch.where(probe(2.0 * ss0) < prev, 2.0, 0.5)
                ss = ss0 * fac
                curr = probe(ss)
                active = curr < prev
                while bool(torch.any(active)):
                    ss = torch.where(active, ss * fac, ss)
                    new = probe(ss)
                    prev = torch.where(active, curr, prev)
                    curr = torch.where(active, new, curr)
                    active = curr < prev
                ss_f = ss / fac
                w, b = moved(w, gw, ss_f), moved(b, gb, ss_f)
            y_pred = D.predict(act_name, w, b, x)
            r = y_pred - y
            ld = D.log_density(model_type, w, b, w_precisions, error_precision,
                               torch.sum(r * r, dim=-1))
        return HMCResult(
            weights=w,
            biases=b,
            code=torch.full(batch, ACCEPTED, dtype=torch.int64, device=dev),
            y_pred=y_pred,
            log_density=ld,
            accept_prob=torch.ones(batch, dtype=torch.float32, device=dev),
        )

    return gd
