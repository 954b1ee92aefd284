"""Training data held on the device.

Counterpart of rs_bann_tpu/models/data.py. ``pack_stacked`` builds the 2-bit
packed form: the genotypes stay group-strided bytes on the device, 16x
smaller than standardized f32, and the kernels decode them in place.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.packed_matmul import GBYTES, GROUP, pack_strided
from . import NetArch
from .density import PackedX


class StackedData(NamedTuple):
    X: object  # a stacked PackedX, or dense standardized [G, n, m_pad]
    y: torch.Tensor  # [n]


def pack_stacked(arch: NetArch, bed, grouping, y, device) -> StackedData:
    """Packed stacked data: X is a PackedX whose tensors have a leading branch
    axis (bytes [G, m_pad, B], w_scale and shift [G, m_pad])."""
    n = bed.num_individuals
    G = arch.num_branches
    B = -(-n // GROUP) * GBYTES  # group-strided bytes per marker
    by = np.empty((G, arch.m_pad, B), np.uint8)
    scale = np.zeros((G, arch.m_pad), np.float32)
    shift = np.zeros((G, arch.m_pad), np.float32)
    raw = np.zeros((arch.m_pad, n), np.float32)
    for g in range(G):
        ixs = np.asarray(grouping.group(g))
        raw[:] = 0.0
        raw[: arch.m[g]] = bed.get_cols(ixs)
        by[g] = pack_strided(raw)
        std = bed.col_stds[ixs]
        scale[g, : arch.m[g]] = np.where(std > 0, 1.0 / np.where(std > 0, std, 1.0), 0.0)
        shift[g, : arch.m[g]] = bed.col_means[ixs]
    X = PackedX(
        torch.from_numpy(by).to(device),
        torch.from_numpy(scale).to(device),
        torch.from_numpy(shift).to(device),
        n,
    )
    return StackedData(X, torch.as_tensor(np.array(y, np.float32), device=device))
