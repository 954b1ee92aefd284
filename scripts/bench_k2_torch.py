#!/usr/bin/env python3
"""K2 and K9a (rs_bann_tpu_torch/csrc/packed_linear.cu) at the shapes the
port runs them, on one NVIDIA GPU: the quick loop for work on that kernel.

    python3 scripts/bench_k2_torch.py [--root DIR] [--save F] [--compare F] [--sass]

Four shapes, n = 100,000 individuals, m = 100 markers per branch (m_pad =
104), bytes uint8 [G, 104, 25088]:
  value64  the chain-folded value pass of a hybrid block, G = 10, k = C x
           16 = 64 (the 4 chains' stored width)
  value40  the same on the live columns, k = 4 x 10 = 40
  slice    every branch at once (test-set prediction), G = 100, k = 16
  probe    the GD warm start's line-search probe, one block, G = 10, k = 16
The inputs come from a seed: random genotype bytes, A = w_scale * W0 with
W0 ~ N(0, 0.1^2) and the padded markers' rows zero, off ~ N(0, 1).

For each shape and for K2 (identity, tanh) and K9a it holds the kernel
against its plain version (decode to f32, then torch.matmul; TF32 off)
within REL_TOL of the largest entry, with a bit-identical repeat, and
prints the CUDA-event median of 7 of the wrapper's call, of the launch
alone (20 back-to-back launches through the C entry point, per launch), of
the plain version and of torch.matmul on the already-decoded f32 X (the
yardstick: the kernel also decodes); the bytes bound (bytes read and
written once over 3.35 TB/s), the tensor bound (3 bf16 products per f32
one at 989 TFLOP/s), the f32 FMA bound (67 TFLOP/s) and the share of the
bytes bound the launch reaches; and the launch's plan (column tiles,
slabs, CTAs) where the checkout has one.

  --root DIR   import rs_bann_tpu_torch from DIR: another checkout (say the
               parent commit, unpacked with ``git archive`` into a directory
               that .gitignore lists), to time its kernel on the same inputs
  --save F     write every checked output to F (torch.save): every 61st
               32-bit word and a checksum (the sum of all words as integers)
  --compare F  compare them with those another run saved: the sampled words
               that differ, the worst difference (within REL_TOL of the
               largest entry) and the outputs whose checksums differ
  --sass       count the instructions of each packed_linear kernel in the
               built object (cuobjdump -sass), in the whole function and in
               the loop that holds its MMAs: HMMA, FFMA, I2F, PRMT, LDS, STS,
               STG, cp.async (LDGSTS), spill loads and stores
The last line is a JSON object of the numbers.
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

M, N = 100, 100_000
SHAPES = {"value64": (10, 64), "value40": (10, 40), "slice": (100, 16), "probe": (10, 16)}
RUNS, BACK_TO_BACK = 7, 20
SAMPLE = 61  # --save keeps every 61st output word and a checksum of all of them
PEAK_F32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES_S = 67e12, 989e12, 3.35e12  # H100 SXM
REL_TOL = 1e-4  # as chip_smoke.py


def cuda_ms(fn, runs=RUNS, per=1):
    """Median milliseconds of ``per`` calls of fn() over ``runs`` timed runs
    after a warm-up, per call."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)


def rel_err(got, ref):
    return (got - ref).abs().max().item() / max(1.0, ref.abs().max().item())


def inputs(G, k, dev, seed):
    import torch

    gen = torch.Generator(dev).manual_seed(seed)
    m_pad, B = -(-M // 8) * 8, -(-N // 512) * 128
    by = torch.randint(0, 256, (G, m_pad, B), dtype=torch.uint8, device=dev, generator=gen)
    a = 0.1 * torch.randn((G, m_pad, k), device=dev, generator=gen)
    a[:, M:] = 0.0
    off = torch.randn((G, k), device=dev, generator=gen)
    return by, a, off


COUNTED = ("HMMA", "FFMA", "I2F", "PRMT", "LDS", "STS", "STG", "LDL", "STL", "LDGSTS")


def sass_counts(obj):
    """Instruction counts of each packed_linear kernel in ``obj``: the whole
    function, and the innermost loop that holds its MMAs (the marker-chunk
    loop)."""
    from sass_k5_torch import cuobjdump, functions, loops

    text = subprocess.run([cuobjdump(), "-sass", str(obj)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    funcs, label_at = functions(text)
    out = {}
    for name, ins in funcs.items():
        if "packed_linear" not in name:
            continue

        def count(ops):
            c = {"instructions": len(ops)}
            for op in ops:
                base = op.split(".")[0]
                if base in COUNTED:
                    c[base] = c.get(base, 0) + 1
            return c

        out[name] = {"function": count([op for _, op, _ in ins])}
        bodies = [[op for addr, op, _ in ins if start <= addr <= end]
                  for start, end in loops(name, ins, label_at)]
        mma = [b for b in bodies if any(op.startswith("HMMA") for op in b)]
        if mma:  # the innermost loop that holds the MMAs
            out[name]["mma_loop"] = count(min(mma, key=len))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--save")
    ap.add_argument("--compare")
    ap.add_argument("--sass", action="store_true")
    opts = ap.parse_args()
    sys.path.insert(0, str(Path(opts.root).resolve()))
    sys.path.insert(0, str(Path(__file__).resolve().parent))  # sass_k5_torch

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_k2_torch: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from rs_bann_tpu_torch.ops import _build
    from rs_bann_tpu_torch.ops import packed_matmul as PM

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{smi}; torch {torch.__version__}; rs_bann_tpu_torch from {PM.__file__}")
    t0 = time.perf_counter()
    lib = _build.lib()
    build_s = time.perf_counter() - t0
    log = _build.BUILD_DIR / "build.log"
    print(f"build {build_s:.1f} s: " + ", ".join(
        l for l in log.read_text().splitlines() if ".cu: " in l))
    ptx, cur = [], False
    for line in log.read_text().splitlines():  # ptxas -v of packed_linear.cu's kernels
        if "Compiling entry function" in line:
            cur = "packed_linear" in line
            if cur:
                ptx.append(line.split("'")[1])
        elif cur and ("registers" in line or "spill" in line):
            ptx.append("  " + line.strip())
    print("\n".join(ptx))

    dev = torch.device("cuda")
    res = {"device": smi, "build_s": build_s, "shapes": {}}
    saved = {}
    vp = ctypes.c_void_p
    for seed, (label, (G, k)) in enumerate(SHAPES.items()):
        by, a, off = inputs(G, k, dev, seed)
        m_pad, B = by.shape[1:]
        x = PM.unpack_strided(by, N)  # [G, m, n] f32, decoded once
        flop = 2 * G * m_pad * N * k
        nbytes = by.numel() + 4 * (a.numel() + off.numel()) + 4 * G * N * k
        bytes_ms = 1e3 * nbytes / PEAK_BYTES_S
        tensor_ms = 1e3 * 3 * flop / PEAK_BF16_FLOPS
        f32_ms = 1e3 * flop / PEAK_F32_FLOPS
        mm_ms = cuda_ms(lambda: torch.matmul(x.transpose(-1, -2), a))
        row = {"G": G, "k": k, "bytes_bound_ms": bytes_ms, "tensor_bound_ms": tensor_ms,
               "f32_bound_ms": f32_ms, "matmul_decoded_ms": mm_ms}
        if hasattr(PM, "packed_linear_plan"):
            row["plan"] = PM.packed_linear_plan(G, m_pad, B, k, N)
        print(f"{label}: bytes {tuple(by.shape)}, k {k}: bounds bytes {bytes_ms:.4f} ms, "
              f"tensor {tensor_ms:.4f} ms, f32 FMA {f32_ms:.4f} ms; torch.matmul on the decoded "
              f"f32 X {mm_ms:.4f} ms; plan {row.get('plan')}")
        out = torch.empty((G, N, k), device=dev)
        for fn_name, act in (("K2", "identity"), ("K2", "tanh"), ("K9a", None)):
            if act is None:
                def kernel():
                    return PM.packed_matmul(by, a, N)

                def plain():
                    return PM.packed_matmul_ref(by, a, N)

                def launch():
                    lib.packed_matmul_f32(vp(by.data_ptr()), vp(a.data_ptr()), vp(out.data_ptr()),
                                          G, m_pad, B, k, N, vp(_build.stream_ptr(by)))
            else:
                def kernel():
                    return PM.packed_linear(by, a, off, N, act)

                def plain():
                    return PM.packed_linear_ref(by, a, off, N, act)

                code = PM.ACT_CODES[act]

                def launch():
                    lib.packed_linear_f32(vp(by.data_ptr()), vp(a.data_ptr()), vp(off.data_ptr()),
                                          vp(out.data_ptr()), G, m_pad, B, k, N, code,
                                          vp(_build.stream_ptr(by)))
            got, ref, again = kernel(), plain(), kernel()
            torch.cuda.synchronize()
            err = rel_err(got, ref)
            same = torch.equal(got, again)
            if not (err <= REL_TOL and same):
                raise AssertionError(f"{label} {fn_name} {act}: rel err {err} (tol {REL_TOL}), "
                                     f"identical repeat {same}")
            name = f"{label}/{fn_name}" + (f"/{act}" if act else "")
            words = got.view(torch.int32).view(-1)
            saved[name] = {"sample": got.view(-1)[::SAMPLE].cpu(),
                           "checksum": int(words.to(torch.int64).sum()),
                           "max_abs": got.abs().max().item()}
            del got, ref, again
            ms = cuda_ms(kernel)
            launch_ms = cuda_ms(launch, per=BACK_TO_BACK)
            plain_ms = cuda_ms(plain)
            print(f"  {name}: wrapper {ms:.4f} ms, launch {launch_ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms; {100 * bytes_ms / launch_ms:.1f}% of the bytes bound; "
                  f"rel err {err:.3e}, identical repeat")
            row[name.split("/", 1)[1]] = {"ms": ms, "launch_ms": launch_ms, "plain_ms": plain_ms,
                                          "bytes_share": bytes_ms / launch_ms, "max_rel_err": err}
        res["shapes"][label] = row
        del by, a, off, x, out

    if opts.save:
        torch.save(saved, opts.save)
    if opts.compare:
        other = torch.load(opts.compare)
        worst, bits, sums = 0.0, 0, 0
        for name, t in saved.items():
            o = other[name]
            bits += int((t["sample"].view(torch.int32) != o["sample"].view(torch.int32)).sum())
            worst = max(worst, (t["sample"] - o["sample"]).abs().max().item()
                        / max(1.0, o["max_abs"]))
            sums += t["checksum"] != o["checksum"]
        print(f"against {opts.compare}: {bits} of {sum(t['sample'].numel() for t in saved.values())}"
              f" sampled words differ in their bits, worst rel difference {worst:.3e}; "
              f"{sums} of {len(saved)} outputs differ in their checksum")
        res["compare"] = {"sampled_bits_differ": bits, "max_rel_diff": worst,
                          "checksums_differ": sums}
        if worst > REL_TOL:
            raise AssertionError(f"outputs differ from {opts.compare} by {worst}")
    if opts.sass:
        src = _build.CSRC / "packed_linear.cu"
        res["sass"] = sass_counts(_build._object(src, _build._keys()[src]))
        for fn, c in res["sass"].items():
            print(f"  sass {fn}: {c}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
