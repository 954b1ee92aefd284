"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a`` (all in
parallel) into an object, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers). Each object is cached in ``build/rs_bann_tpu_torch/obj/`` at the
root of the checkout under a key that hashes its source, every
``csrc/*.cuh`` and the flags, so an edit to one ``.cu`` recompiles that
source alone and an edit to a header recompiles them all; the library is
named by its objects' keys. ``build.log`` there says which sources were
compiled (with their seconds) and which reused, then gives each source's
``ptxas -v`` (registers, spills).

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


def _keys() -> dict:
    """Each source's object key: a hash of the source, every header and the
    flags."""
    cu, cuh = _sources()
    common = hashlib.sha256()
    for p in cuh:
        common.update(p.name.encode())
        common.update(p.read_bytes())
    common.update(" ".join(NVCC_FLAGS).encode())
    keys = {}
    for p in cu:
        h = common.copy()
        h.update(p.name.encode())
        h.update(p.read_bytes())
        keys[p] = h.hexdigest()[:16]
    return keys


def _object(src: Path, key: str) -> Path:
    return BUILD_DIR / "obj" / f"{src.stem}_{key}.o"


def library_path() -> Path:
    h = hashlib.sha256("".join(_keys().values()).encode())
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
    """Compile the sources whose objects are not cached (one ``nvcc -c``
    each, all started together), then link, unless a library of these
    objects exists."""
    out = library_path()
    if out.exists():
        return out
    compiler = nvcc()
    keys = _keys()
    objs = {src: _object(src, key) for src, key in keys.items()}
    missing = [src for src, obj in objs.items() if not obj.exists()]
    (BUILD_DIR / "obj").mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        head = ""
        if missing:
            tmp_objs, codes, seconds, text = compile_all(compiler, NVCC_FLAGS, missing, tmpdir)
            for src, tmp, code, sec in zip(missing, tmp_objs, codes, seconds):
                if code == 0:  # each object and its log written under a temporary
                    # name, then renamed: concurrent builds never see half an object
                    os.replace(Path(tmpdir) / f"{src.stem}.log", objs[src].with_suffix(".log"))
                    os.replace(tmp, objs[src])
                    head += f"{src.name}: {sec:.1f} s\n"
            if any(codes):
                (BUILD_DIR / "build.log").write_text(text)
                raise RuntimeError(f"nvcc failed ({codes}):\n{text}")
        head += "".join(f"{src.name}: reused {obj.name}\n"
                        for src, obj in objs.items() if src not in missing)
        logs = "".join(f"==== {src.name}\n" + obj.with_suffix(".log").read_text()
                       for src, obj in objs.items() if obj.with_suffix(".log").exists())
        (BUILD_DIR / "build.log").write_text(head + logs)
        # link under a temporary name, then rename: concurrent processes
        # never load a half-written library
        tmp = Path(tmpdir) / out.name
        proc = subprocess.run(
            [compiler, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs.values())],
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
    so.traj_packed_f32.argtypes = [vp] * 10 + [i] * 13 + [vp]
    so.traj_packed_f32.restype = i
    so.traj_packed_smem.argtypes = [i, i, i, i]
    so.traj_packed_smem.restype = ctypes.c_longlong
    so.traj_packed_km.argtypes = [i, i, i, i]
    so.traj_packed_km.restype = i
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
