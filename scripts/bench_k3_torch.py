#!/usr/bin/env python3
"""K3 and K9b (rs_bann_tpu_torch/csrc/packed_bwd.cu, ``packed_linear_vjp``
and ``packed_matmul_vjp``) at the shapes the port runs them, on one NVIDIA
GPU: the quick loop for work on that kernel.

    python3 scripts/bench_k3_torch.py [--root DIR] [--save F] [--compare F] [--sass]

Bytes uint8 [G, m_pad, B] from a seed (every code, the missing one too),
the cotangent g ~ N(0, 1) [G, n, k], the saved output act(z) for z ~ N(0,
1); n = 100,000 (B = 25,088), shapes:
  warm   the GD warm start's block: G = 10, m_pad = 104, k = 16 (800
         launches per warm-start sweep of 4 chains)
  g100   every branch at once (one ``gradients`` sample): G = 100
  m13    G = 10, m_pad = 13 (one marker tile of 16)
  m300   G = 10, m_pad = 300 (marker slabs)
  k8     G = 10, m_pad = 104, k = 8 (one column tile of 8)
  k40    G = 10, m_pad = 104, k = 40 (column slabs)
For each it runs K3 at every fused activation and K9b, holds each against
its plain version (decode to f32, then torch.matmul; TF32 off) within
REL_TOL of the largest entry of each output, with a bit-identical repeat,
prints how far the kernel and the plain version each lie from the plain
version run in f64, and prints the CUDA-event medians of 7 of: the launch
pair alone (20 back-to-back calls of the C entry point on buffers made
once, per call: the pass and its reduce, each kernel's device time from
torch.profiler beside it), the wrapper's call and the plain version's;
``torch.matmul`` on the already-decoded f32 X (it skips the decode and h');
the bounds: the bytes as implemented (the bytes, g, the saved output only
where h' reads it, dA and d_off, each once, over 3.35 TB/s), three bf16
tensor-core products per f32 one at 989 TFLOP/s, and the f32 FMAs at 67
TFLOP/s; the share of the bytes bound that the launch reaches; the
launch's plan where the checkout has one; and ``ptxas -v``'s registers
and spills of the packed_bwd kernels.

  --root DIR   import rs_bann_tpu_torch from DIR: another checkout (say the
               parent commit, unpacked with ``git archive`` into a directory
               that .gitignore lists), to time its kernel on the same inputs
  --save F     write every checked output (dA, d_off) to F (torch.save)
  --compare F  compare them with those another run saved: the words that
               differ and the worst difference (within REL_TOL of the
               largest entry)
  --sass       count the instructions of each packed_bwd kernel in the
               built object (cuobjdump -sass), in the whole function and in
               each loop that holds MMAs: HMMA, FFMA, I2F, PRMT, LDS, STS,
               STG, LDG, cp.async (LDGSTS), spill loads and stores
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

N = 100_000
SHAPES = {  # name -> (G, m_pad, k)
    "warm": (10, 104, 16),
    "g100": (100, 104, 16),
    "m13": (10, 13, 16),
    "m300": (10, 300, 16),
    "k8": (10, 104, 8),
    "k40": (10, 104, 40),
}
CASES = ("identity", "relu", "leaky_relu", "tanh", None)  # K3 by activation, then K9b
RUNS, BACK_TO_BACK = 7, 20
PEAK_F32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES_S = 67e12, 989e12, 3.35e12  # H100 SXM
REL_TOL = 1e-4  # as chip_smoke.py
COUNTED = ("HMMA", "FFMA", "I2F", "PRMT", "LDS", "STS", "STG", "LDG", "LDL", "STL", "LDGSTS")


def cuda_ms(fn, runs=RUNS):
    """Median milliseconds of fn() over ``runs`` timed runs after a warm-up."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(got, want):
    """The largest difference of any output over max(1, its largest entry)."""
    return max((a.double() - b.double()).abs().max().item()
               / max(1.0, b.double().abs().max().item()) for a, b in zip(got, want))


def launcher(PM, _build, by, g, out, n, act):
    """BACK_TO_BACK calls of the C entry point on buffers made once: the pass
    and its reduce. K9b when ``act`` is None. An older checkout's entry
    takes its grid from the wrapper's chunks."""
    import torch

    lib = _build.lib()
    vp = ctypes.c_void_p
    G, m, B = by.shape
    k = g.shape[-1]
    fused = act is not None
    code = PM.ACT_CODES[act] if fused else 0
    dev = by.device
    da = torch.empty((G, m, k), device=dev)
    doff = torch.empty((G, k), device=dev)
    stream = vp(_build.stream_ptr(by))
    if hasattr(PM, "packed_bwd_plan"):
        plan = PM.packed_bwd_plan(G, m, B, k, n, act or "identity", fused)
        part = torch.empty(plan["rows"] * plan["row"], device=dev)
        args = (vp(by.data_ptr()), vp(g.data_ptr()), vp(out.data_ptr() if fused else 0),
                vp(part.data_ptr()), part.numel(), vp(da.data_ptr()),
                vp(doff.data_ptr() if fused else 0), G, m, B, k, n, code, int(fused), stream)
        keep = (da, doff, part)
    else:  # the f32 kernel before the tensor-core one: its grid from the wrapper's chunks
        tiles = -(-m // lib.packed_bwd_tile_m()) * -(-k // 16)
        gpc, chunks = PM.bwd_chunks(G * tiles, B // 128)
        part = torch.empty((G, chunks, m, k), device=dev)
        doff_part = torch.empty((G, chunks, k), device=dev)
        args = (vp(by.data_ptr()), vp(g.data_ptr()), vp(out.data_ptr() if fused else 0),
                vp(part.data_ptr()), vp(doff_part.data_ptr() if fused else 0), vp(da.data_ptr()),
                vp(doff.data_ptr() if fused else 0), G, m, B, k, n, code, int(fused), gpc, chunks,
                stream)
        keep = (da, doff, part, doff_part)

    def run():
        for _ in range(BACK_TO_BACK):
            _build.check(lib.packed_bwd_f32(*args), "packed_bwd_f32")

    run.buffers = keep  # alive as long as the launcher
    return run


def device_us(run):
    """The device time of each kernel that run() launches, in us per call of
    the C entry (torch.profiler; run() makes BACK_TO_BACK calls)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = {}
    for a in prof.key_averages():
        if a.device_type == DeviceType.CUDA:
            v = getattr(a, "self_device_time_total", None)
            v = getattr(a, "self_cuda_time_total", 0.0) if v is None else v
            name = "reduce" if "reduce" in a.key else "pass" if "packed_bwd" in a.key else a.key
            out[name] = out.get(name, 0.0) + v / BACK_TO_BACK
    return out


def sass_counts(obj):
    """Instruction counts of each packed_bwd kernel in ``obj``: the whole
    function and every loop that holds MMAs."""
    from sass_k5_torch import cuobjdump, functions, loops

    text = subprocess.run([cuobjdump(), "-sass", str(obj)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    funcs, label_at = functions(text)

    def count(ops):
        c = {"instructions": len(ops)}
        for op in ops:
            base = op.split(".")[0]
            if base in COUNTED:
                c[base] = c.get(base, 0) + 1
        return c

    out = {}
    for name, ins in funcs.items():
        if "packed_bwd" not in name:
            continue
        out[name] = {"function": count([op for _, op, _ in ins])}
        bodies = [[op for addr, op, _ in ins if start <= addr <= end]
                  for start, end in loops(name, ins, label_at)]
        mma = [b for b in bodies if any(op.startswith("HMMA") for op in b)]
        if mma:
            out[name]["mma_loops"] = [count(b) for b in sorted(mma, key=len)]
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
        raise SystemExit("bench_k3_torch: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from rs_bann_tpu_torch.ops import _build
    from rs_bann_tpu_torch.ops import packed_matmul as PM
    from rs_bann_tpu_torch.ops.activations import apply, prime_from_out

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{smi}; torch {torch.__version__}; rs_bann_tpu_torch from {PM.__file__}")
    t0 = time.perf_counter()
    _build.lib()
    build_s = time.perf_counter() - t0
    log = _build.BUILD_DIR / "build.log"
    print(f"build {build_s:.1f} s: " + ", ".join(
        l for l in log.read_text().splitlines() if ".cu: " in l))
    ptx, cur = {}, None
    for line in log.read_text().splitlines():  # ptxas -v of packed_bwd.cu's kernels
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            cur = name if "packed_bwd" in name else None
        elif cur and ("registers" in line or "spill" in line):
            ptx.setdefault(cur, []).append(line.split(":", 1)[-1].strip())
    for name, lines in ptx.items():
        print(f"ptxas {name}: " + "; ".join(lines))

    dev = torch.device("cuda")
    res = {"device": smi, "build_s": build_s, "ptxas": ptx, "shapes": {}}
    saved = {}
    for seed, (label, (G, m_pad, k)) in enumerate(SHAPES.items()):
        gen = torch.Generator(dev).manual_seed(seed)
        B = -(-N // 512) * 128
        by = torch.randint(0, 256, (G, m_pad, B), dtype=torch.uint8, device=dev, generator=gen)
        g = torch.randn((G, N, k), device=dev, generator=gen)
        z = torch.randn((G, N, k), device=dev, generator=gen)
        x = PM.unpack_strided(by, N)  # [G, m, n] f32, decoded once
        x64 = x.double()
        flop = 2 * G * m_pad * N * k
        row = {"G": G, "m_pad": m_pad, "n": N, "k": k,
               "tensor_bound_ms": 1e3 * 3 * flop / PEAK_BF16_FLOPS,
               "f32_bound_ms": 1e3 * flop / PEAK_F32_FLOPS,
               "matmul_decoded_ms": cuda_ms(lambda: torch.matmul(x, g))}
        if hasattr(PM, "packed_bwd_plan"):
            row["plan"] = {a or "K9b": PM.packed_bwd_plan(G, m_pad, B, k, N, a or "identity",
                                                          a is not None)
                           for a in ("identity", "tanh", None)}
        print(f"{label}: bytes {tuple(by.shape)}, n {N}, k {k}: tensor bound "
              f"{row['tensor_bound_ms']:.4f} ms, f32 FMA {row['f32_bound_ms']:.4f} ms; "
              f"torch.matmul on the decoded f32 X (no decode, no h') "
              f"{row['matmul_decoded_ms']:.4f} ms; plan {row.get('plan')}")
        for act in CASES:
            fused = act is not None
            name = act or "K9b"
            out = apply(act, z) if fused else z
            # the bytes as implemented: the saved output only where h' reads it
            nbytes = by.numel() + 4 * (g.numel() + G * m_pad * k)
            if fused:
                nbytes += 4 * G * k + (4 * out.numel() if act != "identity" else 0)
            bytes_ms = 1e3 * nbytes / PEAK_BYTES_S
            if fused:
                def kernel():
                    return PM.packed_linear_vjp(by, g, out, N, act)

                def plain():
                    return PM.packed_linear_vjp_ref(by, g, out, N, act)
                dz64 = g.double() * prime_from_out(act, out).double()
                want64 = (x64 @ dz64, dz64.sum(dim=-2))
                del dz64
            else:
                def kernel():
                    return (PM.packed_matmul_vjp(by, g, N),)

                def plain():
                    return (PM.packed_matmul_vjp_ref(by, g, N),)
                want64 = (x64 @ g.double(),)
            got, want, again = kernel(), plain(), kernel()
            torch.cuda.synchronize()
            err, err64, plain64 = rel_err(got, want), rel_err(got, want64), rel_err(want, want64)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            if not (err <= REL_TOL and err64 <= plain64 + REL_TOL and same):
                raise AssertionError(f"{label} {name}: rel err {err} (f64: kernel {err64}, plain "
                                     f"{plain64}; tol {REL_TOL}), identical repeat {same}")
            saved[f"{label}/{name}"] = [t.cpu() for t in got]
            del got, want, again, want64
            run = launcher(PM, _build, by, g, out, N, act)
            launch_ms = cuda_ms(run) / BACK_TO_BACK
            dev_us = device_us(run)
            del run
            ms = cuda_ms(kernel)
            plain_ms = cuda_ms(plain)
            print(f"  {label}/{name}: launch {launch_ms:.4f} ms (device: "
                  + ", ".join(f"{a} {v:.2f} us" for a, v in dev_us.items())
                  + f"), wrapper {ms:.4f} ms, plain {plain_ms:.4f} ms; bytes bound {bytes_ms:.4f}"
                  f" ms, {100 * bytes_ms / launch_ms:.1f}% of it; rel err {err:.3e} (against "
                  f"f64: kernel {err64:.3e}, plain {plain64:.3e}), identical repeat")
            row[name] = {"launch_ms": launch_ms, "device_us": dev_us, "ms": ms,
                         "plain_ms": plain_ms, "bytes_bound_ms": bytes_ms,
                         "bytes_share": bytes_ms / launch_ms, "max_rel_err": err,
                         "max_rel_err_f64": err64, "plain_max_rel_err_f64": plain64}
            del out
        res["shapes"][label] = row
        del by, g, z, x, x64
        torch.cuda.empty_cache()

    if opts.save:
        torch.save(saved, opts.save)
    if opts.compare:
        other = torch.load(opts.compare)
        worst, bits, total = 0.0, 0, 0
        for name, ts in saved.items():
            for a, b in zip(ts, other[name]):
                bits += int((a.view(torch.int32) != b.view(torch.int32)).sum())
                total += a.numel()
                worst = max(worst, (a - b).abs().max().item() / max(1.0, b.abs().max().item()))
        print(f"against {opts.compare}: {bits} of {total} output words differ in their bits, "
              f"worst rel difference {worst:.3e}")
        res["compare"] = {"words_differ": bits, "words": total, "max_rel_diff": worst}
        if worst > REL_TOL:
            raise AssertionError(f"outputs differ from {opts.compare} by {worst}")
    if opts.sass:
        src = _build.CSRC / "packed_bwd.cu"
        res["sass"] = sass_counts(_build._object(src, _build._keys()[src]))
        for fn, c in res["sass"].items():
            print(f"  sass {fn}: {c}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
