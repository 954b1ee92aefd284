"""Phenotype file I/O (the port's own copy of rs_bann_tpu/io/phen.py).

The reference stores phenotypes as bincode of ``struct Phenotypes { y:
Vec<f32> }``: a little-endian u64 length followed by little-endian f32
values.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


class Phenotypes:
    def __init__(self, y):
        self.y = np.asarray(y, np.float32).reshape(-1)

    @staticmethod
    def from_file(path) -> "Phenotypes":
        raw = Path(path).read_bytes()
        (n,) = struct.unpack("<Q", raw[:8])
        y = np.frombuffer(raw[8 : 8 + 4 * n], "<f4")
        if y.shape[0] != n:
            raise ValueError(f"Truncated .phen file: expected {n} values")
        return Phenotypes(y)

    def to_file(self, path):
        with open(path, "wb") as f:
            f.write(struct.pack("<Q", self.y.shape[0]))
            f.write(self.y.astype("<f4").tobytes())
