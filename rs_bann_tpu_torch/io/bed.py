"""PLINK .bed genotype I/O: variant-major, 2-bit packed, held compressed.

The port's own copy of rs_bann_tpu/io/bed.py, with the NumPy versions of its
codec (rs_bann_tpu/io/native.py's fallbacks) in place of the C++ one.

PLINK 1.9 bed encoding, variant-major: 3 magic bytes 0x6c 0x1b 0x01, then
ceil(n/4) bytes per marker column; each byte holds 4 genotypes, lowest bit
pair first. 2-bit codes: 00 -> 2 (hom A1), 10 -> 1 (het), 11 -> 0 (hom A2),
01 (missing) -> decoded as 0 (impute beforehand).
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .dims import BedDims

BED_SIGNATURE = bytes([0x6C, 0x1B, 0x01])
# genotype value -> 2-bit code
_VALUE_TO_CODE = np.array([0b11, 0b10, 0b00], np.uint8)
# 2-bit code -> genotype value
_CODE_TO_VALUE = np.array([2.0, 0.0, 1.0, 0.0], np.float32)
# markers decoded at a time for the column statistics (bounds host memory)
_STATS_CHUNK = 1024


def _make_lookup() -> np.ndarray:
    """[256, 4] byte -> 4 genotype f32s."""
    b = np.arange(256, dtype=np.uint16)
    out = np.empty((256, 4), np.float32)
    for i in range(4):
        out[:, i] = _CODE_TO_VALUE[(b >> (2 * i)) & 0b11]
    return out


BED_LOOKUP = _make_lookup()


def decode_bed_bytes(data: np.ndarray, num_individuals: int) -> np.ndarray:
    """[..., bytes_per_col] uint8 -> [..., num_individuals] f32."""
    vals = BED_LOOKUP[data]  # [..., bytes, 4]
    vals = vals.reshape(*data.shape[:-1], data.shape[-1] * 4)
    return vals[..., :num_individuals]


def pack_genotypes(vals: np.ndarray) -> np.ndarray:
    """[..., n] genotypes {0,1,2} -> [..., ceil(n/4)] packed uint8."""
    n = vals.shape[-1]
    nbytes = (n + 3) // 4
    padded = np.zeros((*vals.shape[:-1], nbytes * 4), np.uint8)
    padded[..., :n] = _VALUE_TO_CODE[vals.astype(np.int64)]
    padded = padded.reshape(*vals.shape[:-1], nbytes, 4)
    out = np.zeros((*vals.shape[:-1], nbytes), np.uint8)
    for i in range(4):
        out |= padded[..., i] << (2 * i)
    return out


def col_stats(data: np.ndarray, n: int):
    """Per-marker (means, population stds) over packed columns [m, bytes]."""
    means = np.empty(data.shape[0], np.float32)
    stds = np.empty(data.shape[0], np.float32)
    for s in range(0, data.shape[0], _STATS_CHUNK):
        full = decode_bed_bytes(data[s : s + _STATS_CHUNK], n)
        means[s : s + _STATS_CHUNK] = full.mean(axis=1)
        stds[s : s + _STATS_CHUNK] = full.std(axis=1)
    return means, stds


class BedVM:
    """Variant-major bed file in memory, compressed."""

    def __init__(self, data, num_individuals, num_markers):
        self.num_individuals = int(num_individuals)
        self.num_markers = int(num_markers)
        self.num_bytes_per_col = (self.num_individuals + 3) // 4
        self.data = np.asarray(data, np.uint8).reshape(self.num_markers, self.num_bytes_per_col)
        # population std
        self.col_means, self.col_stds = col_stats(self.data, self.num_individuals)
        for ix in np.nonzero(self.col_stds == 0)[0]:
            logging.getLogger("rs_bann_tpu_torch").warning(
                "No variation in marker %d; standardized access divides by zero", ix)

    @staticmethod
    def random(
        num_individuals: int,
        num_markers: int,
        mafs: Optional[Sequence[float]] = None,
        seed: Optional[int] = None,
    ) -> "BedVM":
        """Binomial(2, maf) genotypes; columns with zero variance are redrawn."""
        rng = np.random.default_rng(seed)
        maf = (np.asarray(mafs, np.float64) if mafs is not None
               else rng.uniform(0.01, 0.5, num_markers))
        cols = rng.binomial(2, maf[:, None], size=(num_markers, num_individuals)).astype(np.int8)
        while True:
            flat = np.all(cols == cols[:, :1], axis=1)
            if not flat.any():
                break
            if mafs is None:
                maf[flat] = rng.uniform(0.01, 0.5, int(flat.sum()))
            cols[flat] = rng.binomial(
                2, maf[flat][:, None], size=(int(flat.sum()), num_individuals)).astype(np.int8)
        return BedVM(pack_genotypes(cols), num_individuals, num_markers)

    @staticmethod
    def from_file(stem) -> "BedVM":
        """Read .bed; dims from .dims, else .fam/.bim line counts."""
        stem = Path(stem)
        dims = BedDims.from_stem(stem)
        raw = stem.with_suffix(".bed").read_bytes()
        sig = raw[:3]
        if sig[0] != BED_SIGNATURE[0]:
            raise ValueError("False first byte in .bed; expected 0x6c")
        if sig[1] != BED_SIGNATURE[1]:
            raise ValueError("False second byte in .bed; expected 0x1b")
        if sig[2] == 0x00:
            raise ValueError(
                "SampleMajor .bed formats are not supported; convert to VariantMajor format")
        if sig[2] != 0x01:
            raise ValueError("False third byte in .bed; expected 0x00 or 0x01")
        data = np.frombuffer(raw[3:], np.uint8)
        nbpc = (dims.num_individuals + 3) // 4
        return BedVM(data[: dims.num_markers * nbpc], dims.num_individuals, dims.num_markers)

    def to_file(self, stem):
        """Write .bed + .dims."""
        stem = Path(stem)
        os.makedirs(stem.parent, exist_ok=True)
        with open(stem.with_suffix(".bed"), "wb") as f:
            f.write(BED_SIGNATURE)
            f.write(self.data.tobytes())
        with open(stem.with_suffix(".dims"), "w") as f:
            f.write(f"{self.num_individuals}\t{self.num_markers}")

    def get_cols(self, col_ixs) -> np.ndarray:
        """[len(ixs), n] raw genotypes."""
        return decode_bed_bytes(self.data[np.asarray(col_ixs)], self.num_individuals)

    def get_submatrix_standardized(self, col_ixs) -> np.ndarray:
        """[n, len(ixs)] standardized; zero-variance markers map to 0."""
        ixs = np.asarray(col_ixs)
        raw = self.get_cols(ixs).T
        sd = self.col_stds[ixs]
        return (raw - self.col_means[ixs]) * np.where(sd > 0, 1.0 / np.where(sd > 0, sd, 1), 0.0)
