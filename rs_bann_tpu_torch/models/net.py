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
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.branch_mlp import SUPPORTED_ACTIVATIONS, forward_blocked
from ..samplers import gibbs
from ..samplers.hmc import (
    HMCProposal,
    HMCResult,
    make_gradient_descent,
    make_hmc_step,
    make_lean_batch,
    make_transition_batch,
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
    sweeps: int = 0  # completed sweeps (keys the hybrid's shared permutation)


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
    "ss_markers": False,
    "ss_rows": False,
    "tempering": False,
    "mass_adaptation": False,
    "hmc_traj_length_mode": "fixed",
    "trajectories": False,
    "num_grad": False,
    "num_grad_traj": False,
    "effect_sizes": False,
}


def unported_options(cfg: MCMCCfg) -> list:
    """Names of the cfg settings this port cannot honour yet."""
    bad = [k for k, v in _UNPORTED.items() if getattr(cfg, k) != v]
    if cfg.update_mode != "sequential" and not cfg.live_accept and not cfg.gradient_descent:
        bad.append("live_accept=False")
    if cfg.hmc_step_size_mode == "dual_averaging":
        bad.append("hmc_step_size_mode=dual_averaging")
    return bad


# --------------------------------------------------------------------------
# Gibbs draws
# --------------------------------------------------------------------------


def _gibbs_local_precisions(gen, model_type, w_b, b_b, st_b, hyper, num_layers, lam_floor=0.0):
    """Gibbs draw of the local weight and bias precisions of one branch or
    of a batch of them (leading axes, e.g. [C, B] of a hybrid block):
    weights [..., in, out], biases [..., out], statics [...]. Bias
    precisions are always ridge-updated; ``lam_floor`` floors the WEIGHT
    precisions only (biases are unregularized in the marginal potential).
    All the Gamma draws come from one ``_gamma`` call: one host
    synchronization per call, not one per branch or layer."""
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
    draws = gibbs.gamma_many(gen, params)
    new_wp = tuple(torch.clamp(d, min=lam_floor) if lam_floor > 0 else d for d in draws[0::2])
    return new_wp, tuple(draws[1::2])


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
    izmailov or std_scaled step sizes, and an activation the kernels take.
    The trainer folds whenever this holds, for any number of chains. On a
    CUDA tensor a branch beyond the kernels' limits makes the kernels'
    wrappers raise (the CLI refuses it before training); it never runs on
    the plain version."""
    return (
        (cfg.update_mode == "parallel" or (cfg.update_mode == "hybrid" and cfg.hybrid_shared_perm))
        and cfg.live_accept
        and not (cfg.joint_hmc or cfg.gradient_descent or cfg.gradient_descent_joint)
        and not (cfg.spike_slab or cfg.ss_markers or cfg.ss_rows)
        and not cfg.trajectories
        and not (cfg.num_grad or cfg.num_grad_traj)
        and cfg.hmc_traj_length_mode == "fixed"
        and cfg.hmc_step_size_mode in ("izmailov", "std_scaled")
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
    gd = cfg.gradient_descent
    transition = (make_gradient_descent(model_type, act, cfg) if gd
                  else make_hmc_step(model_type, act, cfg, defer_accept=True))
    fold_transition = make_transition_batch(model_type, act, cfg) if folded else None
    lean_batch = make_lean_batch(model_type, act, cfg)
    cix = torch.arange(C, device=device)[:, None]

    def flat(ts):  # [C, Bk, ...] -> [C * Bk, ...], chain-major
        return tuple(t.reshape((C * Bk,) + t.shape[2:]) for t in ts)

    def unflat(t):  # [C * Bk, ...] -> [C, Bk, ...]
        return t.reshape((C, Bk) + t.shape[1:])

    def hmc_block(gen, w_b, b_b, wp_b, bp_b, err_prec, x, ix, targets, preds, mw_b, mb_b, st_b,
                  residual):
        """The block's HMC proposals (folded; on a FeatX every (chain,
        branch) of the block in one batched lean body reading X in place
        through ``ix``; else per (chain, branch) against each chain's ``x[c]``
        when the permutation is not shared), accepted one by one against the
        live residual."""
        momenta = (
            tuple(torch.randn(w.shape, generator=gen, device=gen.device) for w in w_b),
            tuple(torch.randn(b.shape, generator=gen, device=gen.device) for b in b_b),
        )
        if folded:
            prop = fold_transition(w_b, b_b, wp_b, bp_b, err_prec, x, targets, mw_b, mb_b,
                                   momenta, y_pred0=preds)
        elif ix is not None:
            p = lean_batch(gen, flat(w_b), flat(b_b), flat(wp_b), flat(bp_b),
                           err_prec.repeat_interleave(Bk), x, ix, targets.reshape(C * Bk, -1),
                           flat(mw_b), flat(mb_b), st_b.n_params.reshape(-1),
                           (flat(momenta[0]), flat(momenta[1])))
            prop = HMCProposal(tuple(map(unflat, p.weights)), tuple(map(unflat, p.biases)),
                               *map(unflat, p[2:]))
        else:
            props = []
            for c in range(C):
                for j in range(Bk):
                    def one(ts):
                        return tuple(t[c, j] for t in ts)

                    props.append(transition(
                        gen, one(w_b), one(b_b), one(wp_b), one(bp_b), err_prec[c],
                        x[j] if shared else x[c][j], targets[c, j], one(mw_b), one(mb_b),
                        st_b.n_params[c, j], momenta=(one(momenta[0]), one(momenta[1])),
                    ))
            prop = _stack_proposals(props, C, Bk)
        order = torch.argsort(torch.rand((C, Bk), generator=gen, device=gen.device), dim=-1)
        us = torch.rand((C, Bk), generator=gen, device=gen.device)
        return _live_accept_select(residual, preds, prop, err_prec, w_b, b_b, order, us)

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
                gen, model_type, w_b, b_b, st_b, hyper, L, lam_floor=lam_row_floor
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
            preds = D.predict_chains(act, w_b, b_b, x_blk)  # [C, Bk, n]
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
            res = hmc_block(gen, w_b, b_b, wp_b, bp_b, err_prec, x_blk, ix, targets, preds, mw_b,
                            mb_b, st_b, residual)
        for l in range(L):
            params.weights[l][cix, ixs] = res.weights[l]
        for l in range(L - 1):
            params.biases[l][cix, ixs] = res.biases[l]
        residual = residual + torch.sum(preds - res.y_pred, dim=1)

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
        return TrainCarry(
            state=NetState(params, StackedPrecisions(wp, bp, err_prec), bias, bias_prec),
            residual=residual,
            lpd_local=carry.lpd_local,
            lpd_out=lpd_out,
            lpd_rss=lpd_rss,
            counts=carry.counts,
            sweeps=carry.sweeps,
        )

    def sweep(carry: TrainCarry, X, y, gen):
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
        n = float(carry.residual.shape[-1])
        return carry, SweepStats(
            counts=carry.counts.clone(),
            mse_train=torch.sum(carry.residual**2, dim=-1) / n,
            lpd=carry.lpd_rss + carry.lpd_out + torch.sum(carry.lpd_local, dim=-1),
        )

    return sweep


def _carry_tensors(carry: TrainCarry) -> list:
    return P.state_leaves(carry.state) + [carry.residual, carry.lpd_local, carry.lpd_out,
                                          carry.lpd_rss, carry.counts]


def chain_carry(carry: TrainCarry, c: int) -> TrainCarry:
    """Chain c of a stacked carry, as views into it."""
    return TrainCarry(
        state=P.map_state(lambda a: a[c], carry.state),
        residual=carry.residual[c], lpd_local=carry.lpd_local[c], lpd_out=carry.lpd_out[c],
        lpd_rss=carry.lpd_rss[c], counts=carry.counts[c], sweeps=carry.sweeps,
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
    sweep(carry, X, y, gen) -> (TrainCarry, SweepStats)."""
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
                gen, model_type, w_g, b_g, st_g, hyper, L, lam_floor=lam_row_floor
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
        res = transition(
            gen, w_g, b_g, wp_g, bp_g, err_prec, x_g, target, mw_g, mb_g, st_g.n_params
        )
        residual = target - res.y_pred
        for l in range(L):
            params.weights[l][g] = res.weights[l]
        for l in range(L - 1):
            params.biases[l][g] = res.biases[l]

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
        return TrainCarry(
            state=NetState(params, StackedPrecisions(wp, bp, err_prec), bias, bias_prec),
            residual=residual,
            lpd_local=carry.lpd_local,
            lpd_out=lpd_out,
            lpd_rss=lpd_rss,
            counts=carry.counts,
        )

    def sweep(carry: TrainCarry, X, y, gen):
        var_y = torch.var(y, unbiased=False)
        perm = torch.randperm(G, generator=gen, device=gen.device).tolist()
        for g in perm:
            carry = branch_update(carry, g, X, var_y, gen)
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
        n = X.n if isinstance(X, (D.PackedX, D.FeatX)) else X.shape[1]
        G = self.arch.num_branches
        chunk = self._chunk(n)
        out = state.output_bias + torch.zeros(n, device=state.output_bias.device)
        for s in range(0, G, chunk):
            e = min(G, s + chunk)
            preds = D.predict(
                self.arch.activation,
                tuple(w[s:e] for w in state.params.weights),
                tuple(b[s:e] for b in state.params.biases),
                X[s:e],
            )
            out = out + torch.sum(preds, dim=0)
        return out

    def _chunk(self, n: int) -> int:
        """Branches per chunk of a stacked pass over ``n`` individuals."""
        width = max(self.arch.layer_out_pad(l) for l in range(self.arch.num_layers))
        return max(1, int(self.PREDICT_CHUNK_BYTES // (4 * n * width)))

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
                   chains: Optional[int] = None) -> TrainCarry:
        """residual = y - bias - sum_g pred_g and the initial LPD terms, on a
        copy of the state.

        With ``chains``, a carry for that many chains (leading [C] axis):
        every chain starts from ``state``, or each from its own slice of a
        chain-stacked state."""
        if chains is not None:
            s = self.state if state is None else state
            if s.params.weights[0].dim() == 4:  # [C, G, in, out]
                return stack_carries([self.init_carry(X, y, P.map_state(lambda a: a[c], s))
                                      for c in range(chains)])
            return stack_carries([self.init_carry(X, y, s)] * chains)
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
        return TrainCarry(
            state=s,
            residual=residual,
            lpd_local=lpd_local,
            lpd_out=lpd_out,
            lpd_rss=lpd_rss,
            counts=torch.zeros(3, dtype=torch.int64, device=self.device),
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
