"""Network initialization.

Counterpart of rs_bann_tpu/models/init.py. The draws run on the host from
``np.random.default_rng(seed)`` in exactly the JAX package's order, so the
initial state is bit-identical to it; only the last step moves the arrays
to the device.

Initialization schemes:
  * default: W ~ N(0, 1/m_g), biases 0
  * fixed variance v: W, b ~ N(0, v)
  * Gamma(k, s) init: per layer, precision = k*s (prior mean) or a prior
    draw; W ~ N(0, 1/precision); biases likewise
  * marker sparsification: zero the input-weight rows of excluded markers

Precisions start at the per-group maximum likelihood (count / sum of
squares, clamped at 1e6) or a fixed value; the output layer's is pooled
across branches.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import NetArch
from . import density as D
from .params import NetState, StackedParams, StackedPrecisions

DEFAULT_INIT_OUTPUT_LAYER_PRECISION = 0.05
INIT_ERROR_PRECISION = 2.0
ML_PRECISION_CLAMP = 1e6


@dataclasses.dataclass(frozen=True)
class InitCfg:
    init_param_variance: Optional[float] = None
    init_gamma_shape: Optional[float] = None
    init_gamma_scale: Optional[float] = None
    sample_precisions: bool = False
    num_effective_markers: Optional[int] = None
    proportion_effective_markers: Optional[float] = None
    fixed_param_precision: Optional[float] = None
    seed: int = 0


def _excluded_markers(rng: np.random.Generator, m: int, cfg: InitCfg) -> np.ndarray:
    """Boolean [m] mask of markers to zero out (True = excluded)."""
    if cfg.num_effective_markers is not None:
        num = min(cfg.num_effective_markers, m)
        excl = np.zeros(m, bool)
        excl[rng.choice(m, size=m - num, replace=False)] = True
        return excl
    if cfg.proportion_effective_markers is not None and cfg.proportion_effective_markers < 1.0:
        return rng.random(m) >= cfg.proportion_effective_markers
    return np.zeros(m, bool)


def _init_arrays(arch: NetArch, model_type: str, cfg: InitCfg):
    """Host arrays (ws, bs, wp, bp, eff_mask), drawn in the JAX package's order."""
    rng = np.random.default_rng(cfg.seed)
    G, L = arch.num_branches, arch.num_layers
    ins = arch.layer_in_counts()
    outs = arch.layer_out_counts()

    ws = [
        np.zeros((G, arch.layer_in_pad(l), arch.layer_out_pad(l)), np.float32)
        for l in range(L)
    ]
    bs = [np.zeros((G, arch.layer_out_pad(l)), np.float32) for l in range(L - 1)]
    eff_mask = np.zeros((G, arch.m_pad), np.float32)

    gamma = None
    if cfg.init_gamma_shape is not None and cfg.init_gamma_scale is not None:
        gamma = (cfg.init_gamma_shape, cfg.init_gamma_scale)

    def draw_prec():
        if cfg.sample_precisions:
            return rng.gamma(gamma[0], gamma[1])
        return gamma[0] * gamma[1]

    for g in range(G):
        m = arch.m[g]
        eff_mask[g, :m] = 1.0
        for l in range(L):
            i, o = int(ins[l][g]), int(outs[l][g])
            if gamma is not None:
                std = (1.0 / draw_prec()) ** 0.5
            elif cfg.init_param_variance is not None:
                std = cfg.init_param_variance**0.5
            else:
                std = (1.0 / m) ** 0.5
            ws[l][g, :i, :o] = rng.normal(0.0, std, size=(i, o))
        for l in range(L - 1):
            o = int(outs[l][g])
            if gamma is not None:
                bs[l][g, :o] = rng.normal(0.0, (1.0 / draw_prec()) ** 0.5, size=o)
            elif cfg.init_param_variance is not None:
                bs[l][g, :o] = rng.normal(0.0, cfg.init_param_variance**0.5, size=o)
            # default: biases stay 0
        excl = _excluded_markers(rng, m, cfg)
        if excl.any():
            ws[0][g, :m][excl, :] = 0.0
            eff_mask[g, :m][excl] = 0.0

    ard = D.is_ard(model_type)
    wp = []
    for l in range(L):
        if cfg.fixed_param_precision is not None:
            if ard:
                raise NotImplementedError(
                    "ARD models with fixed param precisions are not supported; "
                    "use a Base model"
                )
            wp.append(np.full((G, 1, 1), cfg.fixed_param_precision, np.float32))
            continue
        if ard and l < L - 1:
            ssq_rows = np.sum(ws[l] ** 2, axis=2, keepdims=True)  # [G, in_pad, 1]
            count = np.asarray(outs[l], np.float32)[:, None, None]
            lam = np.where(ssq_rows > 0, count / np.maximum(ssq_rows, 1e-30), 1.0)
        else:
            ssq = np.sum(ws[l] ** 2, axis=(1, 2), keepdims=True)
            count = (np.asarray(ins[l] * outs[l], np.float32))[:, None, None]
            lam = np.where(ssq > 0, count / np.maximum(ssq, 1e-30), ML_PRECISION_CLAMP)
        wp.append(np.minimum(lam, ML_PRECISION_CLAMP).astype(np.float32))

    # pooled output layer precision across all branches
    if cfg.fixed_param_precision is None:
        tot = float(np.sum(ws[L - 1] ** 2))
        pooled = G / tot if tot > 0 else ML_PRECISION_CLAMP
        wp[L - 1] = np.full((G, 1, 1), min(pooled, ML_PRECISION_CLAMP), np.float32)

    bp = []
    for l in range(L - 1):
        if cfg.fixed_param_precision is not None:
            bp.append(np.full((G, 1), cfg.fixed_param_precision, np.float32))
        else:
            ssq = np.sum(bs[l] ** 2, axis=1, keepdims=True)
            count = np.asarray(outs[l], np.float32)[:, None]
            lam = np.where(ssq > 0, count / np.maximum(ssq, 1e-30), ML_PRECISION_CLAMP)
            bp.append(np.minimum(lam, ML_PRECISION_CLAMP).astype(np.float32))

    if model_type == "std_normal":
        wp = [np.ones_like(a) for a in wp]
        bp = [np.ones_like(a) for a in bp]
    return ws, bs, wp, bp, eff_mask


def init_net(arch: NetArch, model_type: str, cfg: InitCfg = InitCfg(), device="cpu"):
    """Initial NetState on ``device`` and the effective-marker mask [G, m_pad]."""
    ws, bs, wp, bp, eff_mask = _init_arrays(arch, model_type, cfg)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    state = NetState(
        params=StackedParams(tuple(t(w) for w in ws), tuple(t(b) for b in bs)),
        precisions=StackedPrecisions(
            tuple(t(a) for a in wp), tuple(t(a) for a in bp), t(INIT_ERROR_PRECISION)
        ),
        output_bias=t(0.0),
        output_bias_precision=t(1.0),
    )
    return state, t(eff_mask)
