"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a`` (all in
parallel) and linked into one shared library with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers). The library lands in
``build/rs_bann_tpu_torch/`` at the root of the checkout, named by a hash
of the sources, so an unchanged tree reuses it and a changed one rebuilds.
``build.log`` there gives each source's compile time and ``ptxas -v``
(registers, spills).

Nothing here runs at import. ``lib()`` builds on first use and raises if
there is no ``nvcc`` or no CUDA device: the kernels have no quiet fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "rs_bann_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    # split each source's optimisation over the machine's threads: the
    # whole build ~80 s instead of ~100 s on 8 cores (PERF.md, build time)
    "-split-compile=0",
]

_LIB = None


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def nvcc() -> str:
    """Path of the CUDA compiler."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librsbann_kernels_{h.hexdigest()[:16]}.so"


def compile_all(compiler: str, flags, cu, tmpdir):
    """``nvcc -c`` every source in ``cu`` into ``tmpdir``, all started
    together. Returns (objects, return codes, seconds from the start until
    each process ended, the log text: each source's seconds, then nvcc's
    output)."""
    objs = [Path(tmpdir) / f"{p.stem}.o" for p in cu]
    logs = [Path(tmpdir) / f"{p.stem}.log" for p in cu]
    procs = []
    for src, obj, log in zip(cu, objs, logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [compiler, *flags, "-c", "-o", str(obj), str(src)],
                stdout=f, stderr=subprocess.STDOUT,
            ))
    start = time.perf_counter()
    seconds = [None] * len(procs)
    while None in seconds:
        for k, p in enumerate(procs):
            if seconds[k] is None and p.poll() is not None:
                seconds[k] = time.perf_counter() - start
        time.sleep(0.1)
    codes = [p.returncode for p in procs]
    text = "".join(f"{src.name}: {sec:.1f} s\n" for src, sec in zip(cu, seconds))
    text += "".join(log.read_text() for log in logs)
    return objs, codes, seconds, text


def build() -> Path:
    """Compile the kernels unless a library for these sources exists: one
    ``nvcc -c`` per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    compiler = nvcc()
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs, codes, _, text = compile_all(compiler, NVCC_FLAGS, cu, tmpdir)
        (BUILD_DIR / "build.log").write_text(text)
        if any(codes):
            raise RuntimeError(f"nvcc failed ({codes}):\n{text}")
        # link under a temporary name, then rename: concurrent processes
        # never load a half-written library
        tmp = Path(tmpdir) / out.name
        proc = subprocess.run(
            [compiler, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the port's CUDA kernels need a CUDA device")
    so = ctypes.CDLL(str(build()))
    vp, i = ctypes.c_void_p, ctypes.c_int
    so.packed_linear_f32.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, vp]
    so.packed_linear_f32.restype = i
    so.packed_matmul_f32.argtypes = [vp, vp, vp, i, i, i, i, i, vp]
    so.packed_matmul_f32.restype = i
    so.packed_bwd_f32.argtypes = [vp] * 7 + [i] * 9 + [vp]
    so.packed_bwd_f32.restype = i
    so.packed_bwd_tile_m.argtypes = []
    so.packed_bwd_tile_m.restype = i
    so.branch_vg_packed_f32.argtypes = [vp] * 10 + [i] * 9 + [vp]
    so.branch_vg_packed_f32.restype = i
    so.branch_vg_packed_smem.argtypes = [i, i, i, i]
    so.branch_vg_packed_smem.restype = ctypes.c_longlong
    so.traj_packed_f32.argtypes = [vp] * 10 + [i] * 12 + [vp]
    so.traj_packed_f32.restype = i
    so.traj_packed_smem.argtypes = [i, i, i, i]
    so.traj_packed_smem.restype = ctypes.c_longlong
    so.vg_chains_f32.argtypes = [vp] * 6 + [i] * 10 + [vp]
    so.vg_chains_f32.restype = i
    so.dense_chains_smem.argtypes = [i, i, i, i]
    so.dense_chains_smem.restype = ctypes.c_longlong
    so.traj_dense_f32.argtypes = [vp] * 8 + [i] * 11 + [vp]
    so.traj_dense_f32.restype = i
    so.vg_dense_f32.argtypes = [vp] * 7 + [i] * 9 + [vp]
    so.vg_dense_f32.restype = i
    _LIB = so
    return so


def check(status: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: cudaError_t {status}")


def stream_ptr(t) -> int:
    """PyTorch's current CUDA stream on t's device, as an integer."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
