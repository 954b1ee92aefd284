#!/usr/bin/env python3
"""Time the first-use build of the PyTorch port's CUDA kernels under two
sets of nvcc flags.

    python3 scripts/build_time_torch.py [--extra=-split-compile=0]

Compiles every rs_bann_tpu_torch/csrc/*.cu as ops/_build.py does (one
``nvcc -c`` per source, all started together) into a temporary directory,
once with ``_build.NVCC_FLAGS`` less the ``--extra`` flags ("base") and
once with them ("extra"), in the order base, extra, extra, base, so that
a drift of the machine falls on both. Prints the card and its power limit,
the CPU count, then one line per build: each source's seconds and the
whole build's (the slowest source). Nothing is linked or loaded, and the
library that chip_smoke.py uses is left alone.
"""

import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    from rs_bann_tpu_torch.ops import _build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--extra", default="-split-compile=0",
                    help="flags added to NVCC_FLAGS for the second variant (space separated)")
    args = ap.parse_args()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi: not found")
    print(f"cpus {os.cpu_count()}, nvcc {_build.nvcc()}")
    cu, _ = _build._sources()
    extra = args.extra.split()
    base = [f for f in _build.NVCC_FLAGS if f not in extra]
    variants = {"base": base, "extra": base + extra}
    totals = {k: [] for k in variants}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in ("base", "extra", "extra", "base"):
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir:
            _, codes, seconds, text = _build.compile_all(_build.nvcc(), variants[name], cu, tmpdir)
        if any(codes):
            raise RuntimeError(f"nvcc failed under {name} ({codes}):\n{text}")
        totals[name].append(max(seconds))
        each = ", ".join(f"{p.name} {s:.1f}" for p, s in zip(cu, seconds))
        print(f"{name} ({' '.join(variants[name][len(base):]) or 'without the extra flags'}): "
              f"whole build {max(seconds):.1f} s; {each}")
    for name, t in totals.items():
        print(f"{name}: whole build s {', '.join(f'{x:.1f}' for x in t)}")


if __name__ == "__main__":
    main()
