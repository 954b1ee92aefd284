"""Run analysis for ``analyze``: the port's own copy of the loaders and
summaries of rs_bann_tpu/vis.py that it uses (training statistics, the
trace, per-parameter ESS, the posterior mean against a simulation's truth).
Plain numpy, no device work; the JAX package's plotting helpers are not
ported.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def load_training_stats(outdir) -> dict:
    with open(Path(outdir) / "training_stats") as f:
        return json.load(f)


def load_trace(outdir) -> list:
    """trace JSONL -> list (iterations) of list (branches) of dicts (params
    and precisions per branch)."""
    out = []
    with open(Path(outdir) / "trace") as f:
        for line in f:
            if line.strip():
                out.append(json.loads(line))
    return out


def trace_param_matrix(trace, branch_ix: int) -> np.ndarray:
    """[iterations, num_params] flattened in the reference's param_vec order
    (weights column-major per layer, then biases)."""
    rows = []
    for it in trace:
        b = it[branch_ix]
        vec = []
        for w in b["params"]["weights"]:
            vec.extend(w)
        for bias in b["params"]["biases"]:
            vec.extend(bias)
        rows.append(vec)
    return np.asarray(rows, np.float32)


def load_true_params(sim_outdir):
    """model.params written by simulate-* (list of branch dicts)."""
    with open(Path(sim_outdir) / "model.params") as f:
        return json.load(f)


def posterior_mean_vs_truth(trace, true_params, burn_in: int = 0) -> dict:
    """Per-branch correlation and RMSE of the posterior-mean params against
    the generating model's params."""
    out = {}
    for g in range(len(true_params)):
        post_mean = trace_param_matrix(trace, g)[burn_in:].mean(axis=0)
        tv = []
        for w in true_params[g]["params"]["weights"]:
            tv.extend(w)
        for b in true_params[g]["params"]["biases"]:
            tv.extend(b)
        tv = np.asarray(tv, np.float32)
        if tv.shape != post_mean.shape:
            raise ValueError(
                f"param count mismatch branch {g}: {tv.shape} vs {post_mean.shape}"
            )
        denom = post_mean.std() * tv.std()
        corr = (float(((post_mean - post_mean.mean()) * (tv - tv.mean())).mean() / denom)
                if denom > 0 else float("nan"))
        out[g] = {"corr": corr, "rmse": float(np.sqrt(((post_mean - tv) ** 2).mean()))}
    return out


def autocorr(x: np.ndarray, max_lag: int = None) -> np.ndarray:
    """Normalized autocorrelation of a 1-D chain via FFT."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    if max_lag is None:
        max_lag = n - 1
    x = x - x.mean()
    nfft = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, nfft)
    acov = np.fft.irfft(f * np.conj(f))[: max_lag + 1]
    if acov[0] == 0:
        return np.zeros(max_lag + 1)
    return (acov / acov[0]).real


def ess(x: np.ndarray) -> float:
    """Effective sample size with Geyer's initial positive sequence
    truncation (sum consecutive autocorrelation pairs until negative)."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    if n < 4 or x.std() == 0:
        return float(n)
    rho = autocorr(x)
    s = 0.0
    for t in range(1, n // 2):
        pair = rho[2 * t - 1] + (rho[2 * t] if 2 * t < len(rho) else 0.0)
        if pair < 0:
            break
        s += pair
    return float(n / (1.0 + 2.0 * s))


def ess_per_param(trace_matrix: np.ndarray) -> np.ndarray:
    """ESS for each column of an [iterations, params] matrix."""
    return np.array([ess(trace_matrix[:, j]) for j in range(trace_matrix.shape[1])])
