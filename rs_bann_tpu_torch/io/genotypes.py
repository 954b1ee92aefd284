"""Grouped genotypes: BedVM + MarkerGrouping -> per-branch packed tensors.

Counterpart of rs_bann_tpu/io/genotypes.py for the packed path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..models import NetArch
from ..models.data import StackedData, pack_stacked
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

    def to_packed(self, arch: NetArch, device, y: Optional[np.ndarray] = None) -> StackedData:
        """2-bit packed form on ``device`` for the fused decode kernels."""
        if y is None:
            y = np.zeros(self.num_individuals, np.float32)
        return pack_stacked(arch, self.bed, self.groups, y, device)


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
