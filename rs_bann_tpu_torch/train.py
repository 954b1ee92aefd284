"""Training loop: runs the Gibbs sweep for chain_length iterations, records
statistics and writes posterior model samples and artifact streams.

Counterpart of rs_bann_tpu/train.py for one chain, with the same artifacts:
  * ``models/<ix>.npz``   posterior samples, in the JAX package's format
  * ``hyperparams``       JSON model hyperparameters
  * ``trace``             JSONL, one line per iteration with all branch
                          params and precisions (with cfg.trace)
  * ``training_stats``    JSON acceptance counts and mse / lpd series
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from rs_bann_tpu.samplers.mcmc_cfg import MCMCCfg

from .models.data import StackedData
from .models.init import DEFAULT_INIT_OUTPUT_LAYER_PRECISION
from .models.net import Net
from .models.params import StackedPrecisions, state_to_numpy

log = logging.getLogger("rs_bann_tpu_torch")


class TrainingStats:
    def __init__(self):
        self.num_samples = 0
        self.num_accepted = 0
        self.num_early_rejected = 0
        self.mse_train = []
        self.mse_test = None
        self.lpd = []

    def update_counts(self, counts):
        self.num_accepted = int(counts[0])
        self.num_early_rejected = int(counts[2])
        self.num_samples = int(counts.sum())

    def acceptance_rate(self):
        return self.num_accepted / max(self.num_samples, 1)

    def early_rejection_rate(self):
        return self.num_early_rejected / max(self.num_samples, 1)

    def end_rejection_rate(self):
        return (
            self.num_samples - self.num_early_rejected - self.num_accepted
        ) / max(self.num_samples, 1)

    def to_file(self, outdir):
        rec = {
            "num_samples": self.num_samples,
            "num_accepted": self.num_accepted,
            "num_early_rejected": self.num_early_rejected,
            "mse_train": self.mse_train,
            "mse_test": self.mse_test,
            "lpd": self.lpd,
        }
        with open(os.path.join(outdir, "training_stats"), "w") as f:
            json.dump(rec, f)


def _write_hyperparams(net: Net, cfg: MCMCCfg):
    hp = {
        "branch_hyperparams": [
            {
                "num_params": net.arch.num_params_branch(g),
                "num_markers": net.arch.m[g],
                "layer_widths": net.arch.layer_widths(g),
            }
            for g in range(net.arch.num_branches)
        ],
        "precision_hyperparams": {
            "dense": {"shape": net.hyper.dense_shape, "scale": net.hyper.dense_scale},
            "summary": {"shape": net.hyper.summary_shape, "scale": net.hyper.summary_scale},
            "output": {"shape": net.hyper.output_shape, "scale": net.hyper.output_scale},
        },
    }
    with open(cfg.hyperparam_path(), "w") as f:
        json.dump(hp, f)


def _trace_line(net: Net, state) -> list:
    """One trace record: all branch params and precisions, true entries only."""
    arch = net.arch
    s = state_to_numpy(state)
    ins = arch.layer_in_counts()
    outs = arch.layer_out_counts()
    rec = []
    for g in range(arch.num_branches):
        weights = [
            s.params.weights[l][g][: ins[l][g], : outs[l][g]].reshape(-1, order="F").tolist()
            for l in range(arch.num_layers)
        ]
        biases = [
            s.params.biases[l][g][: outs[l][g]].tolist() for l in range(arch.num_layers - 1)
        ]
        wprec = [s.precisions.weights[l][g].reshape(-1).tolist() for l in range(arch.num_layers)]
        bprec = [
            s.precisions.biases[l][g].reshape(-1).tolist() for l in range(arch.num_layers - 1)
        ]
        rec.append(
            {
                "num_markers": arch.m[g],
                "layer_widths": arch.layer_widths(g),
                "params": {"weights": weights, "biases": biases},
                "precisions": {
                    "weight_precisions": wprec,
                    "bias_precisions": bprec,
                    "error_precision": [float(s.precisions.error)],
                },
            }
        )
    return rec


def prepare_state_for_training(net: Net, fixed_precision: Optional[float]):
    """Set the global initial values before the first sweep: error precision
    2.0 and output-layer precision 0.05 (or the fixed value)."""
    lam_out = fixed_precision if fixed_precision is not None else DEFAULT_INIT_OUTPUT_LAYER_PRECISION
    if net.model_type == "std_normal":
        lam_out = 1.0
    p = net.state.precisions
    L = net.arch.num_layers
    wp = tuple(torch.full_like(p.weights[l], lam_out) if l == L - 1 else p.weights[l]
               for l in range(L))
    err = torch.tensor(2.0, device=net.device)
    net.state = net.state._replace(precisions=StackedPrecisions(wp, p.biases, err))
    return net


def train(
    net: Net,
    train_data: StackedData,
    cfg: MCMCCfg,
    gen: torch.Generator,
    test_data: Optional[StackedData] = None,
    report_interval: int = 1,
    fixed_param_precision: Optional[float] = None,
):
    """Run one MCMC chain, drawing from ``gen``. Returns (net, TrainingStats);
    ``net.state`` is left at the final iteration."""
    os.makedirs(cfg.outpath, exist_ok=True)
    save_models = cfg.chain_length > cfg.burn_in
    if save_models:
        os.makedirs(cfg.models_path(), exist_ok=True)
    _write_hyperparams(net, cfg)
    prepare_state_for_training(net, fixed_param_precision)

    sweep = net.make_sweep(cfg)
    X, y = train_data.X, train_data.y
    carry = net.init_carry(X, y)
    stats = TrainingStats()
    trace_f = open(cfg.trace_path(), "w") if cfg.trace else None

    def save_sample(state, ix):
        net.save(os.path.join(cfg.models_path(), f"{ix}.npz"), state)

    def record(carry, mse_train, lpd):
        stats.mse_train.append(float(mse_train))
        stats.lpd.append(float(lpd))
        if test_data is not None:
            if stats.mse_test is None:
                stats.mse_test = []
            stats.mse_test.append(float(net.mse(test_data.X, test_data.y, carry.state)))
        if trace_f is not None:
            trace_f.write(json.dumps(_trace_line(net, carry.state)) + "\n")

    try:
        record(
            carry,
            torch.sum(carry.residual**2) / y.shape[0],
            carry.lpd_rss + carry.lpd_out + torch.sum(carry.lpd_local),
        )
        if cfg.burn_in == 0 and save_models:
            save_sample(carry.state, 0)

        t0 = time.time()
        for chain_ix in range(1, cfg.chain_length + 1):
            carry, st = sweep(carry, X, y, gen)
            record(carry, st.mse_train, st.lpd)
            stats.update_counts(st.counts.cpu().numpy())
            if chain_ix >= cfg.burn_in and save_models:
                save_sample(carry.state, chain_ix)
            if chain_ix % report_interval == 0:
                msg = (
                    f"i: {chain_ix} \t | acc: {stats.acceptance_rate():.2f} \t | "
                    f"early_rej: {stats.early_rejection_rate():.2f} \t | "
                    f"end_rej: {stats.end_rejection_rate():.2f} \t | "
                    f"mse(trn): {stats.mse_train[-1]:.4f}"
                )
                if stats.mse_test is not None:
                    msg += f" \t | mse(tst): {stats.mse_test[-1]:.4f}"
                msg += f" | lpd: {stats.lpd[-1]:.4f}"
                log.info(msg)
        elapsed = time.time() - t0
    finally:
        if trace_f is not None:
            trace_f.close()
    lf = cfg.chain_length * cfg.hmc_integration_length * net.arch.num_branches
    log.info("Completed training: %.2fs, %.0f leapfrog steps/s", elapsed, lf / max(elapsed, 1e-9))
    stats.to_file(cfg.outpath)
    net.state = carry.state
    return net, stats
