"""Marker groupings: assignment of SNP indices to branches.

The port's own copy of the groupings of rs_bann_tpu/group/grouping.py that
the ported commands use (the external two-column file and the uniform
split); the gene-window and LD groupings wait for ``group-by-genes`` and
``group-by-ld``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional


class MarkerGrouping:
    """group ix -> list of marker indices."""

    def __init__(self, groups: Dict[int, List[int]]):
        self.groups = groups

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    def group(self, ix: int) -> Optional[List[int]]:
        return self.groups.get(ix)

    def group_sizes(self) -> List[int]:
        sizes = [0] * self.num_groups
        for k, v in self.groups.items():
            sizes[k] = len(v)
        return sizes

    def to_file(self, stem):
        """Two-column ``marker_ix<TAB>group_ix`` .groups file."""
        path = Path(stem).with_suffix(".groups")
        with open(path, "w") as f:
            for gix in range(self.num_groups):
                for mix in self.groups[gix]:
                    f.write(f"{mix}\t{gix}\n")


class UniformGrouping(MarkerGrouping):
    """k groups x m consecutive markers."""

    def __init__(self, num_groups: int, num_markers_per_group: int):
        super().__init__({
            g: list(range(g * num_markers_per_group, (g + 1) * num_markers_per_group))
            for g in range(num_groups)
        })


class ExternalGrouping(MarkerGrouping):
    """Two-column grouping file; group ids must be contiguous and 0-based."""

    @staticmethod
    def from_file(path) -> "ExternalGrouping":
        groups: Dict[int, List[int]] = {}
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                fields = line.split()
                mix, gix = int(fields[0]), int(fields[1])
                groups.setdefault(gix, []).append(mix)
        if any(k >= len(groups) for k in groups):
            raise ValueError("ExternalGrouping must have continuous, 0-based group indices.")
        return ExternalGrouping(groups)
