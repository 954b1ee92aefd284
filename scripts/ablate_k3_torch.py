#!/usr/bin/env python3
"""Where K3's and K9b's time goes (rs_bann_tpu_torch/csrc/packed_bwd.cu), on
one NVIDIA GPU: the kernel with one phase at a time taken out.

    python3 scripts/ablate_k3_torch.py [--root DIR] [--variants NAME,...]

Each variant is the checkout's packed_bwd.cu with a phase removed by an
edit of its text (each edit asserts that its anchor is there), compiled
alone by nvcc into its own library (all variants in parallel) and called
through the same C entry point:
  kernel       unchanged
  no_mma       the MMA pass removed: the copies, the dz pass, the flush
  no_dz        the dz pass removed: the copies and the MMAs (on stale planes)
  copies_only  both removed: the cp.async stream, the syncs and the flush
  no_copy      the copies removed: the dz pass and the MMAs on stale tiles
  mma_only     the copies and the dz pass removed: the MMA pass alone
  no_decode    the A fragments taken from the byte words as they are (no
               genotype decode) instead of grad_a_frag
  chained      each fragment's three MMAs into the running accumulator (no
               f32 adds: not exact, for its cost only)
Every variant but ``kernel`` gives wrong numbers; only its time means
anything. Shapes (n = 100,000, m_pad = 104, k = 16): the GD warm start's
block (G = 10) at identity, tanh and K9b, and G = 100 at identity and tanh.
Times: CUDA-event medians of 7 runs of 20 back-to-back calls (the pass and
its reduce), per call. The last line is a JSON object of the numbers.
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

SHAPES = ((10, "identity"), (10, "tanh"), (10, None), (100, "identity"), (100, "tanh"))
M_PAD, N, K, B = 104, 100_000, 16, 25_088
RUNS, BACK_TO_BACK = 7, 20
DZ = "        // dz pass: thread (column col"
DZ_END = "        __syncthreads();  // the planes are staged"
MMA = "        // MMA pass: warp w's four k-steps"
MMA_END = "        if (i + 1 < i_end && (i + 1) / p.tiles == v) {"
COPY = "    auto load = [&](long long i, int buf) {\n"
DECODE = "grad_a_frag(wr[mt], wr8[mt], b, af);"
SPLIT = "mma_split3_add(acc[mt][nt], af, bf[nt]);"


def cut(src, start, end):
    a, b = src.index(start), src.index(end)
    return src[:a] + src[b:]


def variant(src, name):
    """packed_bwd.cu with ``name``'s phase taken out."""
    if name in ("no_mma", "copies_only", "mma_only", "no_dz", "no_copy"):
        assert DZ in src and MMA in src and COPY in src
    if name in ("no_dz", "copies_only", "mma_only"):
        src = cut(src, DZ, DZ_END)
    if name in ("no_mma", "copies_only"):
        src = cut(src, MMA, MMA_END)
    if name in ("no_copy", "mma_only"):
        src = src.replace(COPY, COPY + "        cp_async_commit();\n        return;\n")
    if name == "no_decode":
        assert DECODE in src
        src = src.replace(DECODE, "af[0] = wr[mt] ^ b; af[1] = wr8[mt]; af[2] = wr[mt] + b; "
                                  "af[3] = wr8[mt] + b;")
    if name == "chained":
        assert SPLIT in src
        src = src.replace(SPLIT, "{ mma_bf16(acc[mt][nt], af, bf[nt][0].x, bf[nt][0].y); "
                                 "mma_bf16(acc[mt][nt], af, bf[nt][1].x, bf[nt][1].y); "
                                 "mma_bf16(acc[mt][nt], af, bf[nt][2].x, bf[nt][2].y); }")
    return src


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
    ap.add_argument("--variants", default="kernel,no_mma,no_dz,copies_only,no_copy,mma_only,"
                                          "no_decode,chained")
    opts = ap.parse_args()
    root = Path(opts.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ablate_k3_torch: needs a CUDA device")
    from rs_bann_tpu_torch.ops import _build
    from rs_bann_tpu_torch.ops import packed_matmul as PM
    from rs_bann_tpu_torch.ops.activations import apply

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{smi}; torch {torch.__version__}")
    csrc = root / "rs_bann_tpu_torch" / "csrc"
    src = (csrc / "packed_bwd.cu").read_text()
    out_dir = root / "build" / "ablate_k3"
    out_dir.mkdir(parents=True, exist_ok=True)
    names = opts.variants.split(",")
    procs = {}
    for name in names:
        cu = out_dir / f"packed_bwd_{name}.cu"
        cu.write_text(variant(src, name))
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(csrc), "-o",
             str(out_dir / f"lib_{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, res = {}, {"device": smi, "ptxas": {}, "ms": {}}
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"ablate_k3_torch: nvcc failed on {name}:\n{log}")
        res["ptxas"][name] = [l.split(":", 1)[-1].strip() for l in log.splitlines()
                              if "registers" in l]
        so = ctypes.CDLL(str(out_dir / f"lib_{name}.so"))
        so.packed_bwd_f32.argtypes = [vp] * 4 + [ctypes.c_longlong, vp, vp] + [i32] * 7 + [vp]
        so.packed_bwd_f32.restype = i32
        so.packed_bwd_plan.argtypes = [i32] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
        so.packed_bwd_plan.restype = i32
        libs[name] = so
    dev = torch.device("cuda")
    for G, act in SHAPES:
        gen = torch.Generator(dev).manual_seed(G)
        by = torch.randint(0, 256, (G, M_PAD, B), dtype=torch.uint8, device=dev, generator=gen)
        g = torch.randn((G, N, K), device=dev, generator=gen)
        out = apply(act, torch.randn((G, N, K), device=dev, generator=gen)) if act else g
        fused = act is not None
        code = PM.ACT_CODES[act] if fused else 0
        label = f"G={G} {act or 'K9b'}"
        row = {}
        for name, so in libs.items():
            plan = (ctypes.c_longlong * len(PM.BWD_PLAN_FIELDS))()
            _build.check(so.packed_bwd_plan(int(fused), code, G, M_PAD, B, K, N, plan), name)
            plan = dict(zip(PM.BWD_PLAN_FIELDS, plan))
            part = torch.empty(plan["rows"] * plan["row"], device=dev)
            da, doff = torch.empty((G, M_PAD, K), device=dev), torch.empty((G, K), device=dev)
            args = (vp(by.data_ptr()), vp(g.data_ptr()), vp(out.data_ptr()), vp(part.data_ptr()),
                    part.numel(), vp(da.data_ptr()), vp(doff.data_ptr()), G, M_PAD, B, K, N,
                    code, int(fused), vp(torch.cuda.current_stream().cuda_stream))
            row[name] = cuda_ms(lambda: _build.check(so.packed_bwd_f32(*args), name))
        res["ms"][label] = row
        print(f"{label}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items()), flush=True)
        del by, g, out
    for name, lines in res["ptxas"].items():
        print(f"ptxas {name}: {'; '.join(lines)}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
