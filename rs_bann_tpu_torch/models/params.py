"""Stacked parameter and precision state of all branches.

Counterpart of rs_bann_tpu/models/params.py, with the same layouts:

  * ``weights[l]``:  [G, in_pad(l), out_pad(l)]
  * ``biases[l]``:   [G, out_pad(l)]                (no bias on output layer)
  * weight precisions per layer: [G, 1, 1] (base priors and the output
    layer) or [G, in_pad(l), 1] (ARD, local layers)
  * ``bias_precisions[l]``: [G, 1]
  * ``error``: a 0-d tensor, global across branches.

Padded weight and bias entries are exactly 0 and carry zero momentum in HMC,
so unmasked reductions are exact; only counts use the true widths of the
``NetArch`` (rs_bann_tpu/models/arch.py, shared with the JAX package).

``state_from_numpy`` / ``state_to_numpy`` carry a state between the two
packages as numpy arrays, which is how the tests hold the port against JAX.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import NetArch


class StackedParams(NamedTuple):
    weights: Tuple[torch.Tensor, ...]  # per layer [G, in_pad, out_pad]
    biases: Tuple[torch.Tensor, ...]  # per layer [G, out_pad], len = num_layers-1


class StackedPrecisions(NamedTuple):
    weights: Tuple[torch.Tensor, ...]  # per layer [G,1,1] or [G,in_pad,1]
    biases: Tuple[torch.Tensor, ...]  # per layer [G,1]
    error: torch.Tensor  # 0-d


class NetState(NamedTuple):
    """Full sampler state of the net (one chain)."""

    params: StackedParams
    precisions: StackedPrecisions
    output_bias: torch.Tensor  # 0-d
    output_bias_precision: torch.Tensor  # 0-d


# ----------------------------------------------------------------- masks


def weight_masks(arch: NetArch, device) -> Tuple[torch.Tensor, ...]:
    """Per-layer [G, in_pad, out_pad] {0,1} masks of real weights."""
    ins = arch.layer_in_counts()
    outs = arch.layer_out_counts()
    masks = []
    for l in range(arch.num_layers):
        ip, op = arch.layer_in_pad(l), arch.layer_out_pad(l)
        im = np.arange(ip)[None, :] < ins[l][:, None]
        om = np.arange(op)[None, :] < outs[l][:, None]
        m = np.asarray(im[:, :, None] & om[:, None, :], np.float32)
        masks.append(torch.from_numpy(m).to(device))
    return tuple(masks)


def bias_masks(arch: NetArch, device) -> Tuple[torch.Tensor, ...]:
    outs = arch.layer_out_counts()
    masks = []
    for l in range(arch.num_layers - 1):
        om = np.arange(arch.layer_out_pad(l))[None, :] < outs[l][:, None]
        masks.append(torch.from_numpy(np.asarray(om, np.float32)).to(device))
    return tuple(masks)


# ------------------------------------------------------- per-branch counts


def weight_counts(arch: NetArch) -> Tuple[np.ndarray, ...]:
    """Per-layer [G] true number of weights."""
    ins = arch.layer_in_counts()
    outs = arch.layer_out_counts()
    return tuple(np.asarray(ins[l] * outs[l], np.float32) for l in range(arch.num_layers))


def bias_counts(arch: NetArch) -> Tuple[np.ndarray, ...]:
    outs = arch.layer_out_counts()
    return tuple(np.asarray(outs[l], np.float32) for l in range(arch.num_layers - 1))


def param_counts(arch: NetArch) -> np.ndarray:
    """[G] true number of params (weights + biases) per branch."""
    return np.asarray(
        [arch.num_params_branch(g) for g in range(arch.num_branches)], np.float32
    )


# --------------------------------------------------- numpy interchange


def state_from_numpy(state, device) -> NetState:
    """A NetState of f32 tensors on ``device`` from any NetState-shaped tree
    of arrays (e.g. ``jax.tree.map(np.asarray, jax_state)``)."""

    def t(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    p, q = state.params, state.precisions
    return NetState(
        StackedParams(tuple(t(w) for w in p.weights), tuple(t(b) for b in p.biases)),
        StackedPrecisions(
            tuple(t(w) for w in q.weights), tuple(t(b) for b in q.biases), t(q.error)
        ),
        t(state.output_bias),
        t(state.output_bias_precision),
    )


def state_to_numpy(state: NetState) -> NetState:
    """The same tree with every tensor as a numpy array on the host."""

    def a(x):
        return x.detach().cpu().numpy()

    p, q = state.params, state.precisions
    return NetState(
        StackedParams(tuple(a(w) for w in p.weights), tuple(a(b) for b in p.biases)),
        StackedPrecisions(
            tuple(a(w) for w in q.weights), tuple(a(b) for b in q.biases), a(q.error)
        ),
        a(state.output_bias),
        a(state.output_bias_precision),
    )
