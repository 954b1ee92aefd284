#!/usr/bin/env python3
"""Where K6's time goes (rs_bann_tpu_torch/csrc/traj_dense.cu), on one
NVIDIA GPU: the kernel with one piece at a time taken out or changed.

    python3 scripts/ablate_k6_torch.py [--root DIR] [--variants NAME,...]

Each variant is the checkout's traj_dense.cu with its copies of
csrc/traj_dense.cuh (the kernel) and csrc/dense_vg_mma.cuh (the tile's
phases, the split and the joins) edited as below (each edit asserts that
its anchor is there), compiled by nvcc into its own library (all variants
in parallel; tanh's f32-X instantiations only; the bf16-X ones linked in
from the main build's object of csrc/traj_dense_xbf16.cu) and called
through the same C entry point:
  kernel        unchanged
  no_phase_b    phase B (dW0 and dW1 over each tile) removed
  no_mma_a      phase A's three products skipped (their sums zero)
  hh_only       each fragment's hi*hi product alone (1xTF32: no lo*hi,
                hi*lo and their joins)
  no_split      the operands' split taken out (hi = the f32 bits, lo = 0;
                the three products and joins stay)
  cvt_split     the split by cvt.rna.tf32 (K8's), not by integer operations
  two_barriers  a second CTA-wide barrier at the end of each tile
  no_update     the update phase skipped (the grid syncs stay)
  cc1           one chain per CTA (kMaxCC = 1): no X tile shared by chains
Every variant but ``kernel``, ``cvt_split``, ``two_barriers`` and ``cc1``
gives wrong numbers; only its time means anything. The case:
the dense flagship's block (G = 64, C = 4, m_pad = 64, k0 = s = 32, depth 1,
n = 4,096, tanh) at L = 64; then the cost of an evaluation beyond its
tiles: ``kernel`` at n = 32 (one tile per instance, 128 CTAs) and at G = C
= 1, n = 32 (one CTA), each from L = 0 and L = 64. Times: CUDA-event
medians of 5 calls. The last line is a JSON object of the numbers.
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

G, C, M, N, K = 64, 4, 64, 4096, 32
RUNS = 5
TANH_ONLY = ("template <int KM, bool DEEP, int CC, bool XB>\nconst void* kernel_act(int act) {",
             "template <int KM, bool XB>\nconst void* kernel_km")
EDITS = {  # variant: [(file, old, new)]
    "no_phase_b": [("dense_vg_mma.cuh", "for (int u = w; u < u0 + u1; u += kWarps) {",
                    "for (int u = w; u < 0; u += kWarps) {")],
    "no_mma_a": [("dense_vg_mma.cuh", "(gs.w0f, xt, m8 / 8,", "(gs.w0f, xt, 0,"),
                 ("dense_vg_mma.cuh", "(gs.w1a, gs.a0t, NT,", "(gs.w1a, gs.a0t, 0,"),
                 ("dense_vg_mma.cuh", "(gs.w1b, gs.dz1t, NT,", "(gs.w1b, gs.dz1t, 0,")],
    "hh_only": [("dense_vg_mma.cuh", "    mma_tf32_zero(lh, al, bh0, bh1);\n"
                 "    mma_tf32_zero(hl, ah, bl0, bl1);\n#pragma unroll\n"
                 "    for (int e = 0; e < 4; ++e) acc[e] += hh[e] + (lh[e] + hl[e]);",
                 "#pragma unroll\n    for (int e = 0; e < 4; ++e) acc[e] += hh[e];")],
    "no_split": [("dense_vg_mma.cuh",
                  "    hi = __float_as_uint(x) & 0xffffe000u;\n"
                  "    lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;",
                  "    hi = __float_as_uint(x);\n    lo = 0u;")],
    "cvt_split": [("dense_vg_mma.cuh",
                   "    hi = __float_as_uint(x) & 0xffffe000u;\n"
                   "    lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;",
                   "    split2(x, hi, lo);")],
    "two_barriers": [("traj_dense.cuh", "            } else {\n                buf ^= 1;",
                      "            } else {\n                __syncthreads();\n"
                      "                buf ^= 1;")],
    "no_update": [("traj_dense.cuh",
                   "        update_layer<0, CC>(a, l);\n        update_layer<1, CC>(a, l);",
                   "        if (a.steps < 0) update_layer<0, CC>(a, l);\n"
                   "        if (a.steps < 0) update_layer<1, CC>(a, l);"),
                  ("traj_dense.cuh", "            update_layer<2, CC>(a, l);\n"
                   "            update_layer<3, CC>(a, l);\n        }\n"
                   "        update_layer<4, CC>(a, l);",
                   "            if (a.steps < 0) update_layer<2, CC>(a, l);\n"
                   "            if (a.steps < 0) update_layer<3, CC>(a, l);\n        }\n"
                   "        if (a.steps < 0) update_layer<4, CC>(a, l);")],
    "cc1": [("traj_dense.cuh", "constexpr int kMaxCC = 2;", "constexpr int kMaxCC = 1;")],
}


def variant(csrc, out, name):
    """Write ``name``'s traj_dense.cu, traj_dense.cuh and dense_vg_mma.cuh
    into ``out``, with the checkout's dense_deep.cuh (which includes
    dense_vg_mma.cuh: the variant's copy, found beside it)."""
    out.mkdir(parents=True, exist_ok=True)
    files = {f: (csrc / f).read_text()
             for f in ("traj_dense.cu", "traj_dense.cuh", "dense_vg_mma.cuh", "dense_deep.cuh")}
    k = files["traj_dense.cuh"]
    a, b = (k.index(s) for s in TANH_ONLY)
    files["traj_dense.cuh"] = (k[:a] + TANH_ONLY[0] + "\n    return reinterpret_cast<const "
                               "void*>(&traj_dense_kernel<KM, DEEP, 3, CC, XB>);\n}\n\n" + k[b:])
    for f, old, new in EDITS.get(name, []):
        assert old in files[f], (name, old)
        files[f] = files[f].replace(old, new)
    for f, text in files.items():
        (out / f).write_text(text)


def cuda_ms(fn):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def case(dev, g, c, n):
    """X, and the C entry's pointer and stride arrays (per-layer tensors
    made once, contiguous), for g branches, c chains, n individuals."""
    import torch

    gen = torch.Generator(dev).manual_seed(1)
    X = torch.randn((g, M, n), device=dev, generator=gen)
    dims = [(M, K), (K,), (K, K), (K,), (K, 1)]
    keep = [torch.randn((g, c, n), device=dev, generator=gen),
            torch.rand((g, c), device=dev, generator=gen) + 0.5]
    for kind in ("w", "pw", "eps", "lam", "out", "out"):
        for d in dims:
            t = torch.randn((g, c) + d, device=dev, generator=gen)
            keep.append({"w": 0.2 * t, "pw": t, "eps": 1e-3 * t.abs(), "lam": t.abs() + 0.5,
                         "out": torch.empty_like(t)}[kind])
    ptrs = [t.data_ptr() for t in keep]
    # over branches and chains, then the last two dims' (a bias's first unused)
    strides = [s for t in keep for s in t.stride()[:2] + t.stride()[-2:]]
    vp = ctypes.c_void_p
    return X, keep, (vp * 32)(*ptrs), (ctypes.c_longlong * 128)(*strides)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--variants", default="kernel," + ",".join(EDITS))
    opts = ap.parse_args()
    root = Path(opts.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ablate_k6_torch: needs a CUDA device")
    from rs_bann_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{smi}; torch {torch.__version__}")
    csrc = root / "rs_bann_tpu_torch" / "csrc"
    out_dir = root / "build" / "ablate_k6"
    names = opts.variants.split(",")
    _build.build()  # the main build's objects: the bf16-X kernels the entries reach
    xbf16 = [str(_build._object(src, key)) for src, key in _build._keys().items()
             if src.name == "traj_dense_xbf16.cu"]
    procs = {}
    for name in names:
        d = out_dir / name
        variant(csrc, d, name)
        procs[name] = subprocess.Popen(  # the variant's headers first, then the checkout's
            [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(d), "-I", str(csrc), "-o",
             str(d / "lib.so"), str(d / "traj_dense.cu"), *xbf16],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"ablate_k6_torch: nvcc failed on {name}:\n{log}")
        so = ctypes.CDLL(str(out_dir / name / "lib.so"))
        so.traj_dense_f32.argtypes = [vp] * 4 + [i64] + [i32] * 11 + [vp]
        so.traj_dense_f32.restype = i32
        so.traj_dense_plan.argtypes = [i32] * 9 + [ctypes.POINTER(i64)]
        so.traj_dense_plan.restype = i32
        libs[name] = so
    dev = torch.device("cuda")
    stream = vp(torch.cuda.current_stream().cuda_stream)
    res = {"device": smi, "ms": {}}

    def timed(so, g, c, n, steps):
        X, keep, ptrs, strides = case(dev, g, c, n)
        plan = (i64 * 9)()
        _build.check(so.traj_dense_plan(g, c, M, n, K, K, 1, 3, 0, plan), "traj_dense_plan")
        scratch = torch.empty(plan[7], dtype=torch.uint8, device=dev)
        args = (vp(X.data_ptr()), ptrs, strides, vp(scratch.data_ptr()), plan[7], g, c, M, n, K,
                K, 1, steps, 3, 0, 0, stream)
        return cuda_ms(lambda: _build.check(so.traj_dense_f32(*args), "traj_dense_f32"))

    for name, so in libs.items():
        res["ms"][name] = timed(so, G, C, N, 64)
        print(f"{name}: L=64 {res['ms'][name]:.3f} ms", flush=True)
    if "kernel" in libs:
        so = libs["kernel"]
        for label, g, c in (("one tile per instance", G, C), ("one CTA", 1, 1)):
            l0, l64 = timed(so, g, c, 32, 0), timed(so, g, c, 32, 64)
            res["ms"][label] = {"L=0": l0, "L=64": l64, "per_evaluation_us": (l64 - l0) / 64 * 1e3}
            print(f"{label} (G {g}, C {c}, n 32): L=0 {l0:.4f} ms, L=64 {l64:.4f} ms, "
                  f"{(l64 - l0) / 64 * 1e3:.2f} us per evaluation", flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
