"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers: a build takes seconds, not minutes). The library lands in
``build/rs_bann_tpu_torch/`` at the root of the checkout, named by a hash
of the sources, so an unchanged tree reuses it and a changed one rebuilds.

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
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "rs_bann_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    compiler = nvcc()
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: concurrent processes never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(
        [compiler, *NVCC_FLAGS, "-o", tmp, *map(str, cu)],
        capture_output=True, text=True,
    )
    (BUILD_DIR / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
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
    so.branch_vg_packed_f32.argtypes = [vp] * 10 + [i] * 9 + [vp]
    so.branch_vg_packed_f32.restype = i
    so.branch_vg_packed_smem.argtypes = [i, i, i, i]
    so.branch_vg_packed_smem.restype = ctypes.c_longlong
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
