"""2-bit group-strided genotypes and the fused packed layer 0 (K2).

Counterpart of rs_bann_tpu/ops/packed_matmul.py. The genotype bytes keep
the JAX package's group-strided layout (``pack_strided``): individuals come
in groups of 512; byte column j of a group holds individuals j, j+128,
j+256 and j+384 in bit pairs (0, 2, 4, 6). Code 00 -> 2, 01 -> 0 (missing,
also the padding past n), 10 -> 1, 11 -> 0.

``packed_linear`` computes ``act(decode(bytes)[:, :n]^T @ a + off)``. On a
CUDA tensor it launches the hand-written kernel in csrc/packed_linear.cu;
on a CPU tensor it runs ``packed_linear_ref``, the plain PyTorch version
the kernel is held against. Both take an optional leading branch axis G.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .activations import ACT_CODES
from .activations import apply as _act_apply

GROUP = 512  # individuals per strided group
GBYTES = GROUP // 4  # bytes per marker per group

# genotype value -> 2-bit code (PLINK bed encoding)
_VALUE_TO_CODE = np.array([0b11, 0b10, 0b00], np.uint8)

# Activations whose fused kernel epilogue the JAX package also fuses
# (their derivative is recoverable from the output); silu needs K9.
FUSED_ACTIVATIONS = ("identity", "relu", "leaky_relu", "tanh")


def pack_strided(vals: np.ndarray) -> np.ndarray:
    """[m, n] genotypes {0,1,2} -> group-strided packed [m, ceil(n/512)*128].

    Within each 512-individual group, byte j carries individuals
    (j, j+128, j+256, j+384) in bit pairs (0, 2, 4, 6). Missing tail
    individuals get code 01 (decodes to 0).
    """
    m, n = vals.shape
    ngroups = -(-n // GROUP)
    codes = np.full((m, ngroups * GROUP), 0b01, np.uint8)
    codes[:, :n] = _VALUE_TO_CODE[vals.astype(np.int64)]
    codes = codes.reshape(m, ngroups, 4, GBYTES)  # [m, g, quarter, j]
    out = (
        codes[:, :, 0, :]
        | (codes[:, :, 1, :] << 2)
        | (codes[:, :, 2, :] << 4)
        | (codes[:, :, 3, :] << 6)
    )
    return np.ascontiguousarray(out.reshape(m, ngroups * GBYTES))


def unpack_strided(bytes_mb: torch.Tensor, n: int) -> torch.Tensor:
    """Group-strided packed [..., m, B] -> [..., m, n] f32 genotypes."""
    *lead, m, B = bytes_mb.shape
    b = bytes_mb.reshape(*lead, m, B // GBYTES, GBYTES)
    codes = torch.cat([(b >> (2 * q)) & 0b11 for q in range(4)], dim=-1)
    # code c -> genotype (18 >> 2c) & 3: 00 -> 2, 01 -> 0, 10 -> 1, 11 -> 0
    vals = (torch.full_like(codes, 18) >> (codes + codes)) & 0b11
    return vals.to(torch.float32).reshape(*lead, m, B * 4)[..., :n]


def packed_linear_ref(bytes_mb, a, off, n: int, act: str) -> torch.Tensor:
    """Plain PyTorch version of K2: decode to f32, then matmul + offset +
    activation. bytes [..., m, B], a [..., m, k], off [..., k] -> [..., n, k]."""
    dec = unpack_strided(bytes_mb, n)
    z = dec.transpose(-1, -2) @ a + off.unsqueeze(-2)
    return _act_apply(act, z)


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _packed_linear_cuda(bytes_g, a, off, n: int, act: str) -> torch.Tensor:
    """Launch csrc/packed_linear.cu on [G, m, B] bytes; returns [G, n, k]."""
    G, m, B = bytes_g.shape
    k = a.shape[-1]
    dev = bytes_g.device
    if B % GBYTES or n > 4 * B or n <= 0:
        raise ValueError(f"bad packed shape: B={B}, n={n}")
    _check(bytes_g, "bytes", torch.uint8, (G, m, B), dev)
    _check(a, "a", torch.float32, (G, m, k), dev)
    _check(off, "off", torch.float32, (G, k), dev)
    out = torch.empty((G, n, k), dtype=torch.float32, device=dev)
    lib = _build.lib()
    vp = ctypes.c_void_p
    status = lib.packed_linear_f32(
        vp(bytes_g.data_ptr()), vp(a.data_ptr()), vp(off.data_ptr()),
        vp(out.data_ptr()), G, m, B, k, n, ACT_CODES[act],
        vp(_build.stream_ptr(bytes_g)),
    )
    _build.check(status, "packed_linear_f32")
    packed_linear.launches += 1
    return out


def packed_linear(bytes_mb, a, off, n: int, act: str) -> torch.Tensor:
    """out[..., n, k] = act(decode(bytes_mb)[..., :, :n]^T @ a + off).

    ``bytes_mb`` [m, B] or [G, m, B] uint8 in the group-strided layout;
    ``a`` [..., m, k] = w_scale * W0 and ``off`` [..., k] = b0 - shift @ a
    fold the standardization in (models/density.py). ``act`` must be one of
    FUSED_ACTIVATIONS. A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel (and raises if it cannot).
    """
    if act not in FUSED_ACTIVATIONS:
        raise ValueError(f"activation not fusable: {act}")
    if bytes_mb.device.type == "cpu":
        return packed_linear_ref(bytes_mb, a, off, n, act)
    if bytes_mb.dim() == 2:
        return _packed_linear_cuda(
            bytes_mb[None], a[None].contiguous(), off[None].contiguous(), n, act
        )[0]
    return _packed_linear_cuda(bytes_mb, a.contiguous(), off.contiguous(), n, act)


packed_linear.launches = 0  # kernel launches since the last reset
