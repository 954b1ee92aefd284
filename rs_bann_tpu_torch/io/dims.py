"""Bed dimensions from a .dims file or .fam/.bim line counts (the port's own
copy of rs_bann_tpu/io/dims.py)."""

from __future__ import annotations

import dataclasses
from pathlib import Path


def _count_lines(path: Path) -> int:
    with open(path, "rb") as f:
        return sum(1 for line in f if line.strip())


@dataclasses.dataclass
class BedDims:
    num_individuals: int
    num_markers: int

    @staticmethod
    def from_dims_file(stem) -> "BedDims":
        fields = Path(stem).with_suffix(".dims").read_text().split()
        return BedDims(int(fields[0]), int(fields[1]))

    @staticmethod
    def from_plink_fileset(stem) -> "BedDims":
        stem = Path(stem)
        return BedDims(_count_lines(stem.with_suffix(".fam")), _count_lines(stem.with_suffix(".bim")))

    @staticmethod
    def from_stem(stem) -> "BedDims":
        """.dims first, falling back to .fam/.bim."""
        try:
            return BedDims.from_dims_file(stem)
        except (FileNotFoundError, IndexError, ValueError):
            return BedDims.from_plink_fileset(stem)
