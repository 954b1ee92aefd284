#!/usr/bin/env python3
"""Where K8's time goes (rs_bann_tpu_torch/csrc/branch_vg_dense.cu), on one
NVIDIA GPU: the kernel with one phase at a time taken out.

    python3 scripts/ablate_k8_torch.py [--root DIR] [--variants NAME,...]

Each variant is the checkout's branch_vg_dense.cu and its copy of
csrc/dense_vg_mma.cuh (the tile's phases, the flush and the X copy) with a
phase removed by an edit of their text (each edit asserts that its anchor
is there), compiled by nvcc into its own library (all variants in
parallel; the deep design's and the bf16-X kernels its entries reach
linked in from the main build's objects of csrc/branch_vg_chains*.cu and
csrc/branch_fwd_chains*.cu) and called through the same C entry point:
  kernel      unchanged
  no_stage    the weight fragments not staged (stale shared memory)
  no_mma_a    phase A's three products skipped (their sums zero)
  no_phase_b  phase B (dW0, dW1) removed
  no_flush    dW0's partial rows not written (the reduce reads stale rows)
  no_copy     the X tiles not copied (stale tiles)
Every variant but ``kernel`` gives wrong numbers; only its time means
anything. Cases: the dense flagship's branch (m_pad = 64, k0 = s = 32,
depth 1, n = 4,096) at NB = 1, 32 and 64, under tanh and identity (the
activations' cost). Times: CUDA-event medians of 7 runs of 20
back-to-back calls (the pass and its reduce), per call. Then the SASS
instruction count of each instantiation of the main build's object
(cuobjdump), which bounds what one tile's straight-line code asks of the
instruction cache. The last line is a JSON object of the numbers.
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

M, N, K = 64, 4096, 32
RUNS, BACK_TO_BACK = 7, 20
EDITS = {  # variant: [(file, old, new)]
    "no_stage": [("branch_vg_dense.cu", "            stage_weights_from<MT, K16, DEEP, GRAD>(",
                  "            if (m < 0) stage_weights_from<MT, K16, DEEP, GRAD>(")],
    "no_mma_a": [("dense_vg_mma.cuh", "(gs.w0f, xt, m8 / 8,", "(gs.w0f, xt, 0,"),
                 ("dense_vg_mma.cuh", "(gs.w1a, gs.a0t, NT,", "(gs.w1a, gs.a0t, 0,"),
                 ("dense_vg_mma.cuh", "(gs.w1b, gs.dz1t, NT,", "(gs.w1b, gs.dz1t, 0,")],
    "no_phase_b": [("dense_vg_mma.cuh", "for (int u = w; u < u0 + u1; u += kWarps) {",
                    "for (int u = w; u < 0; u += kWarps) {")],
    "no_flush": [("dense_vg_mma.cuh", "    if (lane < k0) {\n        for (int mm = w; mm < m;",
                  "    if (lane < 0) {\n        for (int mm = w; mm < m;")],
    "no_copy": [("dense_vg_mma.cuh", "    const int i0 = tl * kT;\n    if (vec16) {",
                 "    const int i0 = tl * kT;\n    cp_async_commit();\n    return;\n"
                 "    if (vec16) {")],
}


def variant(csrc, out, name):
    """Write ``name``'s branch_vg_dense.cu and dense_vg_mma.cuh into ``out``,
    with the checkout's dense_deep.cuh (which includes dense_vg_mma.cuh: the
    variant's copy, found beside it)."""
    out.mkdir(parents=True, exist_ok=True)
    files = {f: (csrc / f).read_text()
             for f in ("branch_vg_dense.cu", "dense_vg_mma.cuh", "dense_deep.cuh")}
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
        for _ in range(BACK_TO_BACK):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / BACK_TO_BACK)
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--variants", default="kernel,no_stage,no_mma_a,no_phase_b,no_flush,no_copy")
    opts = ap.parse_args()
    root = Path(opts.root).resolve()
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(Path(__file__).resolve().parent))  # sass_k5_torch

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ablate_k8_torch: needs a CUDA device")
    from rs_bann_tpu_torch.ops import _build
    from rs_bann_tpu_torch.ops import branch_mlp as BM
    from rs_bann_tpu_torch.ops.activations import ACT_CODES
    from sass_k5_torch import cuobjdump, functions

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{smi}; torch {torch.__version__}")
    csrc = root / "rs_bann_tpu_torch" / "csrc"
    out_dir = root / "build" / "ablate_k8"
    names = opts.variants.split(",")
    _build.build()  # the main build's objects: the run kernels the entries reach
    others = [str(_build._object(src, key)) for src, key in _build._keys().items()
              if src.name.startswith(("branch_vg_chains", "branch_fwd_chains"))]
    procs = {}
    for name in names:
        d = out_dir / name
        variant(csrc, d, name)
        procs[name] = subprocess.Popen(  # the variant's header first, then the checkout's
            [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(d), "-I", str(csrc), "-o",
             str(d / "lib.so"), str(d / "branch_vg_dense.cu"), *others],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, res = {}, {"device": smi, "ms": {}}
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"ablate_k8_torch: nvcc failed on {name}:\n{log}")
        so = ctypes.CDLL(str(out_dir / name / "lib.so"))
        so.vg_dense_f32.argtypes = [vp] * 10 + [ctypes.c_longlong] + [i32] * 9 + [vp]
        so.vg_dense_f32.restype = i32
        libs[name] = so
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(1)
    X = torch.randn((64, M, N), device=dev, generator=gen)
    P = M * K + K + K * K + K + K
    for NB in (1, 32, 64):
        ix = torch.randperm(64, device=dev, generator=gen)[:NB].to(torch.int32)
        ws = [torch.randn((NB, M, K), device=dev, generator=gen) / 8,
              torch.randn((NB, K, K), device=dev, generator=gen) / 6,
              torch.randn((NB, K, 1), device=dev, generator=gen) / 6]
        bs = [torch.randn((NB, K), device=dev, generator=gen) * 0.1 for _ in range(2)]
        t = torch.randn((NB, N), device=dev, generator=gen)
        plan = BM.vg_dense_plan(NB, M, N, K, K, 1)  # the scratch bytes: the same for any act
        out = torch.empty(NB * (N + P + 1), device=dev)
        scratch = torch.empty(plan["scratch"], dtype=torch.uint8, device=dev)
        for act in ("tanh", "identity"):
            row = {}
            for name, so in libs.items():
                args = (vp(X.data_ptr()), vp(ix.data_ptr()), vp(t.data_ptr()), vp(ws[0].data_ptr()),
                        vp(bs[0].data_ptr()), vp(ws[1].data_ptr()), vp(bs[1].data_ptr()),
                        vp(ws[2].data_ptr()), vp(out.data_ptr()), vp(scratch.data_ptr()),
                        plan["scratch"], NB, M, N, K, K, 1, ACT_CODES[act], 1, 0,
                        vp(torch.cuda.current_stream().cuda_stream))
                row[name] = cuda_ms(lambda: _build.check(so.vg_dense_f32(*args), name))
            label = f"NB={NB} {act}"
            res["ms"][label] = row
            print(f"{label}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items()), flush=True)
    _build.lib()
    src_cu = _build.CSRC / "branch_vg_dense.cu"
    text = subprocess.run([cuobjdump(), "-sass", str(_build._object(src_cu, _build._keys()[src_cu]))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    funcs, _ = functions(text)
    res["sass_instructions"] = {fn: len(ins) for fn, ins in funcs.items()}
    for fn, count in res["sass_instructions"].items():
        print(f"sass {fn[-60:]}: {count} instructions")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
