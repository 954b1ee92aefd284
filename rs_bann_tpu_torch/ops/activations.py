"""Activation functions and their derivatives.

Counterpart of rs_bann_tpu/ops/activations.py, with the same names and the
same semantics (LeakyReLU slope 0.01 on the negative side; relu written
as z * (z > 0) so NaN propagates). ``ACT_CODES`` numbers the activations
for the CUDA kernels (csrc/packed_decode.cuh act_apply / act_prime).
"""

from __future__ import annotations

import torch

ACT_CODES = {"identity": 0, "relu": 1, "leaky_relu": 2, "tanh": 3, "silu": 4}

# Canonical names used in serialized args.json files by the reference CLI
# (clap ValueEnum kebab-case of Tanh/ReLU/LeakyReLU/SiLU/Identity).
CLI_NAMES = {
    "tanh": "tanh",
    "re-lu": "relu",
    "relu": "relu",
    "leaky-re-lu": "leaky_relu",
    "leaky_relu": "leaky_relu",
    "si-lu": "silu",
    "silu": "silu",
    "identity": "identity",
}


def canonical(name: str) -> str:
    key = name.strip().lower().replace(" ", "")
    if key in CLI_NAMES:
        return CLI_NAMES[key]
    raise ValueError(f"unknown activation function: {name}")


def apply(name: str, z: torch.Tensor) -> torch.Tensor:
    """h(z) for the given activation name."""
    name = canonical(name)
    if name == "identity":
        return z
    if name == "relu":
        return z * (z > 0)
    if name == "leaky_relu":
        return z * (z > 0) + 0.01 * z * (z < 0)
    if name == "tanh":
        return torch.tanh(z)
    return z * torch.sigmoid(z)


def prime(name: str, z: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """h'(z) given the pre-activation z and a = h(z)."""
    name = canonical(name)
    if name == "identity":
        return torch.ones_like(z)
    if name == "relu":
        return (z > 0).to(z.dtype)
    if name == "leaky_relu":
        return torch.where(z > 0, 1.0, torch.where(z < 0, 0.01, 0.0)).to(z.dtype)
    if name == "tanh":
        return 1.0 - a * a
    s = torch.sigmoid(z)
    return s * (1.0 + z * (1.0 - s))
