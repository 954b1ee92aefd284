"""Grouped genotypes: BedVM + MarkerGrouping -> per-branch device tensors.

Counterpart of rs_bann_tpu/io/genotypes.py: 2-bit packed (``to_packed``),
dense sample-major (``to_stacked``) and dense feature-major
(``to_feature_major``), the last two standardized f32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models import NetArch
from ..models.data import StackedData, pack_stacked
from ..models.density import FeatX
from . import BedVM, MarkerGrouping, Phenotypes


class CompressedGenotypes:
    def __init__(self, bed: BedVM, groups: MarkerGrouping):
        self.bed = bed
        self.groups = groups

    @property
    def num_individuals(self) -> int:
        return self.bed.num_individuals

    def num_markers_per_group(self):
        return self.groups.group_sizes()

    def x_group(self, ix: int) -> np.ndarray:
        """[n, m_g] standardized genotypes of group ``ix``."""
        return self.bed.get_submatrix_standardized(self.groups.group(ix))

    def to_packed(self, arch: NetArch, device, y: Optional[np.ndarray] = None) -> StackedData:
        """2-bit packed form on ``device`` for the fused decode kernels."""
        if y is None:
            y = np.zeros(self.num_individuals, np.float32)
        return pack_stacked(arch, self.bed, self.groups, y, device)

    def _dense(self, arch: NetArch, device, y, feature_major: bool) -> StackedData:
        n = self.num_individuals
        G = arch.num_branches
        X = np.zeros((G, arch.m_pad, n) if feature_major else (G, n, arch.m_pad), np.float32)
        for g in range(G):
            xg = self.x_group(g)
            if feature_major:
                X[g, : arch.m[g], :] = xg.T
            else:
                X[g, :, : arch.m[g]] = xg
        X = torch.from_numpy(X).to(device)
        if y is None:
            y = np.zeros(n, np.float32)
        y = torch.as_tensor(np.array(y, np.float32), device=device)
        return StackedData(FeatX(X) if feature_major else X, y)

    def to_stacked(self, arch: NetArch, device, y: Optional[np.ndarray] = None) -> StackedData:
        """Dense sample-major standardized X [G, n, m_pad] on ``device``."""
        return self._dense(arch, device, y, feature_major=False)

    def to_feature_major(self, arch: NetArch, device,
                         y: Optional[np.ndarray] = None) -> StackedData:
        """Dense feature-major standardized ``FeatX`` (xT [G, m_pad, n], f32)
        on ``device``: the flagship's layout."""
        return self._dense(arch, device, y, feature_major=True)


class Data:
    """Genotypes + phenotypes pair."""

    def __init__(self, gen: CompressedGenotypes, phen: Phenotypes):
        if gen.num_individuals != phen.y.shape[0]:
            raise ValueError(
                f"{gen.num_individuals} genotyped individuals but "
                f"{phen.y.shape[0]} phenotypes"
            )
        self.gen = gen
        self.phen = phen

    @property
    def num_individuals(self):
        return self.gen.num_individuals

    def num_markers_per_branch(self):
        return self.gen.num_markers_per_group()

    def to_packed(self, arch: NetArch, device) -> StackedData:
        return self.gen.to_packed(arch, device, self.phen.y)

    def to_stacked(self, arch: NetArch, device) -> StackedData:
        return self.gen.to_stacked(arch, device, self.phen.y)

    def to_feature_major(self, arch: NetArch, device) -> StackedData:
        return self.gen.to_feature_major(arch, device, self.phen.y)
