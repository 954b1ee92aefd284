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

A state of C chains has a leading [C] axis on every tensor (weights
[C, G, in_pad, out_pad], error [C], ...). ``map_state`` applies a function
leaf by leaf, e.g. to take chain c (``lambda a: a[c]``) or to stack chains.

``state_from_numpy`` / ``state_to_numpy`` carry a state, one chain's or
chain-stacked, between the two packages as numpy arrays, which is how the
tests hold the port against JAX.
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


# ------------------------------------------------------- tree helpers


def map_state(fn, *states) -> NetState:
    """NetState whose every leaf is fn(leaf of each of ``states``)."""
    ps = [s.params for s in states]
    qs = [s.precisions for s in states]
    return NetState(
        StackedParams(
            tuple(fn(*w) for w in zip(*(p.weights for p in ps))),
            tuple(fn(*b) for b in zip(*(p.biases for p in ps))),
        ),
        StackedPrecisions(
            tuple(fn(*w) for w in zip(*(q.weights for q in qs))),
            tuple(fn(*b) for b in zip(*(q.biases for q in qs))),
            fn(*(q.error for q in qs)),
        ),
        fn(*(s.output_bias for s in states)),
        fn(*(s.output_bias_precision for s in states)),
    )


def state_leaves(state: NetState) -> list:
    p, q = state.params, state.precisions
    return [*p.weights, *p.biases, *q.weights, *q.biases, q.error, state.output_bias,
            state.output_bias_precision]


# --------------------------------------------------- numpy interchange


def state_from_numpy(state, device) -> NetState:
    """A NetState of f32 tensors on ``device`` from any NetState-shaped tree
    of arrays (e.g. ``jax.tree.map(np.asarray, jax_state)``), one chain's or
    chain-stacked."""
    return map_state(lambda a: torch.as_tensor(np.array(a, np.float32), device=device), state)


def state_to_numpy(state: NetState) -> NetState:
    """The same tree with every tensor as a numpy array on the host."""
    return map_state(lambda x: x.detach().cpu().numpy(), state)
