"""The block net and its sequential Gibbs sweep.

Counterpart of rs_bann_tpu/models/net.py for the sequential schedule: every
sweep visits the branches in a fresh random order (the reference's
random-scan Gibbs) and, per branch, draws the error precision, the branch's
local precisions and the shared output-layer precision from their conjugate
conditionals, runs one HMC transition against the live residual, updates
the log-posterior bookkeeping and redraws the output bias.

The sweep updates the carry's stacked tensors in place, one branch slice at
a time, so the device holds one copy of the state; ``Net.init_carry`` clones
the state it starts from.
"""

from __future__ import annotations

import json
from typing import NamedTuple, Optional

import numpy as np
import torch

from rs_bann_tpu.samplers.mcmc_cfg import MCMCCfg

from ..samplers import gibbs
from ..samplers.hmc import make_hmc_step
from . import NetArch
from . import density as D
from . import params as P
from .params import NetState, StackedParams, StackedPrecisions


class TrainCarry(NamedTuple):
    state: NetState
    residual: torch.Tensor  # [n]
    lpd_local: torch.Tensor  # [G]
    lpd_out: torch.Tensor
    lpd_rss: torch.Tensor
    counts: torch.Tensor  # [3] int64: accepted / rejected / rejected-early


class SweepStats(NamedTuple):
    counts: torch.Tensor  # cumulative [3]
    mse_train: torch.Tensor
    lpd: torch.Tensor


# MCMCCfg settings whose code paths wait for later slices of the port,
# each with the value that keeps it off
_UNPORTED = {
    "update_mode": "sequential",
    "num_chains": 1,
    "joint_hmc": False,
    "gradient_descent": False,
    "gradient_descent_joint": False,
    "gd_warmup": 0,
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
    if cfg.hmc_step_size_mode == "dual_averaging":
        bad.append("hmc_step_size_mode=dual_averaging")
    return bad


# --------------------------------------------------------------------------
# Gibbs draws
# --------------------------------------------------------------------------


def _gibbs_local_precisions(gen, model_type, w_g, b_g, statics_g, hyper, num_layers,
                            lam_floor=0.0):
    """Per-branch Gibbs draw of the local weight and bias precisions; bias
    precisions are always ridge-updated. ``lam_floor`` floors the WEIGHT
    precisions only (biases are unregularized in the marginal potential)."""
    L = num_layers
    new_wp, new_bp = [], []
    for l in range(L - 1):
        shape, scale = hyper.layer(l, L)
        w = w_g[l]
        if D.is_ard(model_type):
            ncols = statics_g.out_counts[l]
            if D.is_lasso(model_type):
                l1_rows = torch.sum(torch.abs(w), dim=1, keepdim=True)
                lam = gibbs.lasso_precision_posterior(gen, shape, scale, l1_rows, ncols)
            else:
                ssq_rows = torch.sum(w * w, dim=1, keepdim=True)
                lam = gibbs.ridge_precision_posterior(gen, shape, scale, ssq_rows, ncols)
        else:
            nvar = statics_g.w_counts[l]
            if D.is_lasso(model_type):
                lam = gibbs.lasso_precision_posterior(
                    gen, shape, scale, torch.sum(torch.abs(w)), nvar
                ).reshape(1, 1)
            else:
                lam = gibbs.ridge_precision_posterior(
                    gen, shape, scale, torch.sum(w * w), nvar
                ).reshape(1, 1)
        if lam_floor > 0:
            lam = torch.clamp(lam, min=lam_floor)
        new_wp.append(lam)
        new_bp.append(
            gibbs.ridge_precision_posterior(
                gen, shape, scale, torch.sum(b_g[l] ** 2), statics_g.b_counts[l]
            ).reshape(1)
        )
    return tuple(new_wp), tuple(new_bp)


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
    return D.summary_stat(model_type, params.weights[-1])


def _update_output_bias(cfg, hyper, gen, residual, bias, bias_prec, err_prec):
    """Add the bias back to the residual, redraw it (or take the mean),
    subtract it again."""
    residual = residual + bias
    if cfg.sampled_output_bias:
        bias_prec = gibbs.ridge_single_precision_posterior(
            gen, hyper.output_shape, hyper.output_scale, bias
        )
        bias = gibbs.sample_output_bias(gen, residual, err_prec, bias_prec)
    else:
        bias = torch.mean(residual)
    return residual - bias, bias, bias_prec


# --------------------------------------------------------------------------
# Sweep
# --------------------------------------------------------------------------


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
    transition = make_hmc_step(model_type, act, cfg)
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
    p, q = s.params, s.precisions
    return NetState(
        StackedParams(tuple(w.clone() for w in p.weights), tuple(b.clone() for b in p.biases)),
        StackedPrecisions(
            tuple(w.clone() for w in q.weights), tuple(b.clone() for b in q.biases),
            q.error.clone(),
        ),
        s.output_bias.clone(),
        s.output_bias_precision.clone(),
    )


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
        n = X.n if isinstance(X, D.PackedX) else X.shape[1]
        width = max(self.arch.layer_out_pad(l) for l in range(self.arch.num_layers))
        G = self.arch.num_branches
        chunk = max(1, int(self.PREDICT_CHUNK_BYTES // (4 * n * width)))
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

    def mse(self, X, y, state: Optional[NetState] = None) -> torch.Tensor:
        r = self.predict(X, state) - y
        return torch.sum(r * r) / y.shape[0]

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
    def init_carry(self, X, y, state: Optional[NetState] = None) -> TrainCarry:
        """residual = y - bias - sum_g pred_g and the initial LPD terms, on a
        copy of the state."""
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
