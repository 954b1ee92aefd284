"""Training loop: runs the Gibbs sweep for chain_length iterations, records
statistics and writes posterior model samples and artifact streams.

Counterpart of rs_bann_tpu/train.py, with the same artifacts:
  * ``models/<ix>.npz``   posterior samples, in the JAX package's format
                          (``models/chain<c>/<ix>.npz`` with C > 1 chains)
  * ``hyperparams``       JSON model hyperparameters
  * ``trace``             JSONL, one line per iteration with all branch
                          params and precisions of chain 0 (with cfg.trace)
  * ``training_stats``    JSON acceptance counts (summed over chains) and
                          mse / lpd series (means over chains; test mse the
                          mean of the per-chain test mse)
  * ``inclusion_probs``   with cfg.ss_markers, JSON ``pip_markers`` (chain
                          0's posterior inclusion probability of every true
                          marker, per branch) and ``pi_markers`` (its
                          marker inclusion probability)
  * ``effect_sizes/<ix>_<g>`` with cfg.effect_sizes, CSV of chain 0's input
                          gradients on the training genotypes, n rows of
                          branch g's m_g markers
  * ``checkpoint.npz``    with a checkpoint interval, the whole sampler
                          state (``save_checkpoint``), from which a run
                          resumes bit for bit
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from .models.data import StackedData
from .models.init import DEFAULT_INIT_OUTPUT_LAYER_PRECISION
from .models.net import Net, TrainCarry
from .models.params import StackedPrecisions, map_state, state_to_numpy
from .samplers.mcmc_cfg import MCMCCfg

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


def gd_warmup_cfg(cfg: MCMCCfg) -> MCMCCfg:
    """The configuration of the GD warm start's sweeps, with the JAX
    trainer's overrides: gradient descent, a static step-size mode (GD sets
    its own rate by line search; the mode only builds the transition), the
    factor at most 1e-3, at most 20 iterations, and none of joint HMC,
    trajectory recording, mass adaptation, tempering or spike-and-slab. So
    the warm start leaves the dual-averaging and mass-adaptation state as
    it is, and the trainer starts the sweep counter (their clock) again
    after it. Gradient descent runs no marker scan (in the JAX package
    too), so ss_markers is off as well: the configuration would otherwise
    be refused (``MCMCCfg``: ss_markers applies to marginal HMC only), and
    the carry's inclusion state waits for the sampling sweeps."""
    return dataclasses.replace(
        cfg, gradient_descent=True, joint_hmc=False, trajectories=False,
        mass_adaptation=False, tempering=False, spike_slab=False, ss_markers=False,
        hmc_traj_length_mode="fixed",
        hmc_step_size_mode="izmailov",
        hmc_step_size_factor=min(cfg.hmc_step_size_factor, 1e-3),
        hmc_integration_length=min(cfg.hmc_integration_length, 20),
    )


# marks the port's checkpoints; the JAX package's hold leaf-indexed arrays
CHECKPOINT_FORMAT = "rs_bann_tpu_torch checkpoint 1"


def _items(tree):
    """(field name or index, value) of a NamedTuple or a tuple."""
    return zip(tree._fields, tree) if hasattr(tree, "_fields") else enumerate(tree)


def _named(tree, prefix: str = "") -> list:
    """(name, tensor) of every tensor of a carry, named by its field path:
    ``state.params.weights.0``, ``residual``, ... (``sweeps`` is kept
    apart)."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    return [nt for k, v in _items(tree) if not isinstance(v, int)
            for nt in _named(v, f"{prefix}.{k}" if prefix else str(k))]


def _rebuild(tree, arrays, prefix: str = ""):
    """``tree`` with every tensor replaced by ``arrays[name]`` on its device."""
    if isinstance(tree, torch.Tensor):
        return torch.as_tensor(arrays[prefix], device=tree.device)
    vals = [v if isinstance(v, int) else _rebuild(v, arrays, f"{prefix}.{k}" if prefix else str(k))
            for k, v in _items(tree)]
    return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)


def save_checkpoint(path, carry: TrainCarry, chain_ix: int, stats: TrainingStats,
                    gen: torch.Generator) -> int:
    """Write the whole sampler state to ``path`` (.npz): every carry tensor
    under its field path, the sweep counter, the generator's state and its
    device type, ``chain_ix`` and the statistics the JAX package keeps
    (mse_train, mse_test, lpd), so a run resumes bit for bit. The file is
    written beside ``path`` and then moved over it, so a run cut while
    writing keeps its last checkpoint. The port's own format: its draws are
    not the JAX package's. Returns the bytes written."""
    arrays = {name: t.detach().cpu().numpy() for name, t in _named(carry)}
    arrays["sweeps"] = np.asarray(carry.sweeps, np.int64)
    arrays["generator_state"] = gen.get_state().numpy()
    meta = {"format": CHECKPOINT_FORMAT, "chain_ix": chain_ix,
            "generator_device": gen.device.type,
            "stats": {"mse_train": stats.mse_train, "mse_test": stats.mse_test,
                      "lpd": stats.lpd}}
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    tmp = f"{path}.partial"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return os.path.getsize(path)


def read_checkpoint(path, carry_like: TrainCarry, device_type: str):
    """The arrays and meta of the checkpoint at ``path``, after the checks a
    resume makes before anything is written: it must be the port's (not
    the JAX package's), its generator must be of ``device_type``, and its
    arrays must have the names, shapes and dtypes of ``carry_like``'s.
    Raises ValueError naming the mismatch."""
    with np.load(path) as z:
        files = set(z.files)
        meta = json.loads(bytes(z["meta_json"]).decode()) if "meta_json" in files else {}
        if "key_ixs" in meta or "leaf0" in files:
            raise ValueError(f"{path} is a checkpoint of the JAX package (leaf-indexed "
                             "arrays and a JAX PRNG key); the port resumes only its own "
                             "checkpoints, whose draws differ")
        if meta.get("format") != CHECKPOINT_FORMAT:
            raise ValueError(f"{path} is not a checkpoint of this package")
        if meta["generator_device"] != device_type:
            raise ValueError(f"{path} holds a {meta['generator_device']} generator's state; "
                             f"this run draws on {device_type}")
        arrays = {k: z[k] for k in files}
    want = {name: (tuple(t.shape), str(t.dtype).split(".")[-1])
            for name, t in _named(carry_like)}
    have = {name: (a.shape, a.dtype.name) for name, a in arrays.items()
            if name not in ("meta_json", "sweeps", "generator_state")}
    bad = [f"{k}: checkpoint {have.get(k, 'missing')}, run {want[k]}"
           for k in want if have.get(k) != want[k]]
    bad += [f"{k}: not in this run's carry" for k in have if k not in want]
    if bad:
        raise ValueError(f"{path} does not match this run's carry: " + "; ".join(bad))
    return arrays, meta


def load_checkpoint(path, carry_like: TrainCarry, gen: torch.Generator):
    """Restore a checkpoint (``read_checkpoint``'s checks first): returns
    (carry, chain_ix, stats dict) with ``gen`` set to the saved state."""
    arrays, meta = read_checkpoint(path, carry_like, gen.device.type)
    carry = _rebuild(carry_like, arrays)._replace(sweeps=int(arrays["sweeps"]))
    gen.set_state(torch.from_numpy(arrays["generator_state"].copy()))
    return carry, meta["chain_ix"], meta["stats"]


def initial_carry(net: Net, train_data: StackedData, cfg: MCMCCfg,
                  fixed_param_precision: Optional[float] = None) -> TrainCarry:
    """The carry of cfg.num_chains chains that the trainer starts from:
    ``net.state`` prepared for training (``prepare_state_for_training``)."""
    prepare_state_for_training(net, fixed_param_precision)
    return net.init_carry(train_data.X, train_data.y, chains=max(int(cfg.num_chains), 1),
                          step_size_factor=cfg.hmc_step_size_factor,
                          mass_adaptation=cfg.mass_adaptation, ss_markers=cfg.ss_markers,
                          ssm_pi=cfg.ssm_pi)


def _write_effect_sizes(net: Net, X, model_ix: int, outdir: str, state) -> None:
    """effect_sizes/<model_ix>_<g> CSV: n rows of branch g's m_g input
    gradients (the JAX package's ``_write_effect_sizes``)."""
    es = net.effect_sizes(X, state).cpu().numpy()  # [G, n, m_pad]
    for g in range(net.arch.num_branches):
        np.savetxt(os.path.join(outdir, f"{model_ix}_{g}"), es[g][:, : net.arch.m[g]],
                   delimiter=",", fmt="%.7g")


def train(
    net: Net,
    train_data: StackedData,
    cfg: MCMCCfg,
    gen: torch.Generator,
    test_data: Optional[StackedData] = None,
    report_interval: int = 1,
    fixed_param_precision: Optional[float] = None,
    checkpoint_interval: int = 0,
    resume_from: Optional[str] = None,
):
    """Run cfg.num_chains MCMC chains, all drawing from ``gen`` (the
    sequential schedule runs them one after another in every sweep; the
    hybrid one block by block). With ``cfg.gd_warmup`` > 0 (and not already
    a gradient-descent run), that many gradient-descent sweeps of the
    schedule (``gd_warmup_cfg``) start every chain, one chain after another,
    before the first record; the acceptance counts and the sweep counter
    (the clock of the step-size and mass adaptation) then start again from
    0. With ``cfg.ss_markers`` the data's branch Grams (``X.form_gram()``)
    are formed once before the first sweep, their time logged apart.

    ``checkpoint_interval`` > 0 writes <outpath>/checkpoint.npz
    (``save_checkpoint``) after every that many sweeps and after the last.
    ``resume_from`` restores one (refusing, before anything is written, a
    checkpoint that does not fit: ``read_checkpoint``), skips the GD warm
    start and the initial record, and runs the sweeps after the saved one
    up to cfg.chain_length, as the JAX package does: the statistics' series
    go on from the saved ones, and the acceptance counts, which the carry
    holds, from the saved counts; the samples and the trace get the resumed
    sweeps only. On one device the result is the uninterrupted run's bit
    for bit.
    Returns (net, TrainingStats); ``net.state`` is left at chain 0's final
    iteration."""
    C = max(int(cfg.num_chains), 1)
    sweep = net.make_chain_sweep(cfg)
    X, y = train_data.X, train_data.y
    carry = initial_carry(net, train_data, cfg, fixed_param_precision)
    stats = TrainingStats()
    start_ix = 0
    if resume_from is not None:
        carry, start_ix, saved = load_checkpoint(resume_from, carry, gen)
        stats.mse_train, stats.mse_test, stats.lpd = (
            saved["mse_train"], saved["mse_test"], saved["lpd"])
        log.info("resumed from %s at iteration %d", resume_from, start_ix)
    os.makedirs(cfg.outpath, exist_ok=True)
    save_models = cfg.chain_length > cfg.burn_in
    if save_models:
        os.makedirs(cfg.models_path(), exist_ok=True)
        if cfg.effect_sizes:
            os.makedirs(cfg.effect_sizes_path(), exist_ok=True)
    _write_hyperparams(net, cfg)

    if start_ix == 0 and cfg.gd_warmup > 0 and not (
            cfg.gradient_descent or cfg.gradient_descent_joint):
        gd_sweep = net.make_chain_sweep(gd_warmup_cfg(cfg), chain_by_chain=True)
        t0 = time.time()
        for _ in range(cfg.gd_warmup):
            carry, _ = gd_sweep(carry, X, y, gen)
        carry.counts.zero_()
        carry = carry._replace(sweeps=0)
        log.info("gd warm start: %d sweeps, %.3fs", cfg.gd_warmup, time.time() - t0)
    if cfg.ss_markers and not cfg.gradient_descent:  # the marker scan's data, once
        t0 = time.time()
        float(X.form_gram()[0, 0, 0])  # waits for the device
        log.info("branch Grams for the marker scan: %.3fs", time.time() - t0)
    trace_f = open(cfg.trace_path(), "a" if resume_from is not None else "w") if cfg.trace else None

    def chain(state, c):
        return map_state(lambda a: a[c], state)

    def save_sample(state, ix):
        if C == 1:
            net.save(os.path.join(cfg.models_path(), f"{ix}.npz"), chain(state, 0))
            return
        for c in range(C):
            d = os.path.join(cfg.models_path(), f"chain{c}")
            os.makedirs(d, exist_ok=True)
            net.save(os.path.join(d, f"{ix}.npz"), chain(state, c))

    def record(carry, mse_train, lpd):
        stats.mse_train.append(float(torch.mean(mse_train)))
        stats.lpd.append(float(torch.mean(lpd)))
        if test_data is not None:
            if stats.mse_test is None:
                stats.mse_test = []
            stats.mse_test.append(float(np.mean([
                float(net.mse(test_data.X, test_data.y, chain(carry.state, c))) for c in range(C)
            ])))
        if trace_f is not None:
            trace_f.write(json.dumps(_trace_line(net, chain(carry.state, 0))) + "\n")

    try:
        if start_ix == 0:
            record(
                carry,
                torch.sum(carry.residual**2, dim=-1) / y.shape[0],
                carry.lpd_rss + carry.lpd_out + torch.sum(carry.lpd_local, dim=-1),
            )
            if cfg.burn_in == 0 and save_models:
                save_sample(carry.state, 0)

        t0 = time.time()
        for chain_ix in range(start_ix + 1, cfg.chain_length + 1):
            carry, st = sweep(carry, X, y, gen)
            record(carry, st.mse_train, st.lpd)
            stats.update_counts(st.counts.sum(dim=0).cpu().numpy())
            if chain_ix >= cfg.burn_in and save_models:
                save_sample(carry.state, chain_ix)
                if cfg.effect_sizes:
                    _write_effect_sizes(net, X, chain_ix, cfg.effect_sizes_path(),
                                        chain(carry.state, 0))
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
            if checkpoint_interval > 0 and (chain_ix % checkpoint_interval == 0
                                            or chain_ix == cfg.chain_length):
                tc = time.perf_counter()
                size = save_checkpoint(os.path.join(cfg.outpath, "checkpoint.npz"), carry,
                                       chain_ix, stats, gen)
                log.info("checkpoint at iteration %d: %d bytes in %.3f ms", chain_ix, size,
                         1e3 * (time.perf_counter() - tc))
        elapsed = time.time() - t0
    finally:
        if trace_f is not None:
            trace_f.close()
    lf = (cfg.chain_length - start_ix) * cfg.hmc_integration_length * net.arch.num_branches * C
    log.info("Completed training: %.2fs, %.0f leapfrog steps/s", elapsed, lf / max(elapsed, 1e-9))
    stats.to_file(cfg.outpath)
    if cfg.ss_markers:  # chain 0's, the true markers of each branch
        pip = carry.ssm_pip[0].cpu().numpy()
        with open(os.path.join(cfg.outpath, "inclusion_probs"), "w") as f:
            json.dump({"pip_markers": [pip[g, : net.arch.m[g]].tolist()
                                       for g in range(net.arch.num_branches)],
                       "pi_markers": float(carry.ssm_pi[0])}, f)
    net.state = chain(carry.state, 0)
    return net, stats
