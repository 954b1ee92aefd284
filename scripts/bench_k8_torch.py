#!/usr/bin/env python3
"""K8a and K8b (rs_bann_tpu_torch/csrc/branch_vg_dense.cu, ``data_vg`` and
``data_vg_blocked``) at the dense flagship's shape on one NVIDIA GPU: the
quick loop for work on that kernel.

    python3 scripts/bench_k8_torch.py [--root DIR] [--save F] [--compare F]

The dense flagship's branch (bench.py workload 1): X [64, 64, 4096] f32
from a seed, tanh, depth 1, k0 = s = 32, weights W ~ N(0, 1 / fan_in),
targets the plain prediction plus N(0, 1) noise. Cases:
  K8a NB=1   one instance on branch 32 (the sequential schedule's step)
  K8b NB=32  4 chains x a random block of 8 branches each, X through ix
  K8b NB=64  one chain's 64 branches (the parallel schedule, unfolded)
For each it holds the kernel against its plain version (``data_vg_ref``)
in f32 and in f64 within REL_TOL of the largest entry of each output, with
a bit-identical repeat, and prints the CUDA-event medians of 7 of: the
launch alone (20 back-to-back calls of the C entry on buffers made once:
the pass and its reduce, each kernel's device time from torch.profiler
beside it), the wrapper's call, the plain version's. The bounds: the bytes (each X branch
read once, targets, weights in, y_pred and gradients out) over 3.35 TB/s;
the work as implemented, three tf32 tensor-core products per f32 one
(3xTF32) at 494.7 TFLOP/s for the five products; the f32 FMAs at 67
TFLOP/s. Then K7 (``data_vg_chains``, ``forward_chains``) and K6
(``integrate_chains``, 2 steps) at the flagship's shape, C = 4, whose
outputs ``--compare`` holds bit for bit. ``ptxas -v``'s registers and
spills of K8's kernels from the build log.

  --root DIR   import rs_bann_tpu_torch from DIR: another checkout (say the
               parent commit, unpacked with ``git archive`` into a directory
               that .gitignore lists), to time its kernels on the same inputs
  --save F     write every checked output to F (torch.save)
  --compare F  compare them with those another run saved: the 32-bit words
               that differ, the worst difference of K8's outputs (within
               REL_TOL of the largest entry), and K6's and K7's words that
               differ (none allowed)
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

G, M, N, K = 64, 64, 4096, 32  # the dense flagship: branches, m_pad, individuals, widths
RUNS, BACK_TO_BACK = 7, 20
PEAK_F32_FLOPS, PEAK_TF32_FLOPS, PEAK_BYTES_S = 67e12, 494.7e12, 3.35e12  # H100 SXM
REL_TOL = 1e-4  # as chip_smoke.py


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


def inputs(dev):
    """X [G, M, N], and per case (ix, weights, biases, targets) from a seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(8)
    X = torch.from_numpy(rng.standard_normal((G, M, N)).astype(np.float32)).to(dev)
    blocks = np.concatenate([rng.permutation(G)[:8] for _ in range(4)])
    cases = {}
    for name, ix in (("K8a NB=1", np.array([G // 2])), ("K8b NB=32", blocks),
                     ("K8b NB=64", np.arange(G))):
        NB = len(ix)

        def t(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

        ws = (t(rng.standard_normal((NB, M, K)) / np.sqrt(M)),
              t(rng.standard_normal((NB, K, K)) / np.sqrt(K)),
              t(rng.standard_normal((NB, K, 1)) / np.sqrt(K)))
        bs = (t(rng.standard_normal((NB, K)) * 0.1), t(rng.standard_normal((NB, K)) * 0.1))
        cases[name] = (torch.from_numpy(ix.astype(np.int32)).to(dev), ws, bs)
    return X, cases


def flat(r):
    return [r[0], r[1], *r[2], *r[3]]


def rel_err(got, want):
    """The largest difference of any output over max(1, its largest entry)."""
    return max((a.double() - b.double()).abs().max().item()
               / max(1.0, b.double().abs().max().item()) for a, b in zip(flat(got), flat(want)))


def launcher(BM, _build, X, ix, ws, bs, targets):
    """BACK_TO_BACK calls of the C entry point on buffers made once: the
    pass and its reduce. Works on the first K8 too (its entry takes the
    flat weights and a partial row per 128-individual tile)."""
    import torch

    from rs_bann_tpu_torch.ops.activations import ACT_CODES

    lib = _build.lib()
    vp = ctypes.c_void_p
    NB = ws[0].shape[0]
    P = M * K + K + K * K + K + K
    stream = vp(_build.stream_ptr(X))
    if hasattr(BM, "vg_dense_plan"):
        plan = BM.vg_dense_plan(NB, M, N, K, K, 1)
        out = torch.empty(NB * (N + P + 1), device=X.device)
        scratch = torch.empty(plan["scratch"], dtype=torch.uint8, device=X.device)
        args = (vp(X.data_ptr()), vp(ix.data_ptr()), vp(targets.data_ptr()), vp(ws[0].data_ptr()),
                vp(bs[0].data_ptr()), vp(ws[1].data_ptr()), vp(bs[1].data_ptr()),
                vp(ws[2].data_ptr()), vp(out.data_ptr()), vp(scratch.data_ptr()), plan["scratch"],
                NB, M, N, K, K, 1, ACT_CODES["tanh"], 1) + (
                    (0,) if hasattr(BM, "x_bf16") else ()) + (stream,)
        keep = (out, scratch)
    else:  # the first K8: flat weights [NB, 1, P], a partial row per 128-individual tile
        q = BM.flat_params(tuple(w.unsqueeze(1) for w in ws), tuple(b.unsqueeze(1) for b in bs))
        y = torch.empty((NB, N), device=X.device)
        partial = torch.empty((NB, -(-N // 128), P), device=X.device)
        grads = torch.empty((NB, P), device=X.device)
        args = (vp(X.data_ptr()), vp(ix.data_ptr()), vp(targets.data_ptr()), vp(q.data_ptr()),
                vp(y.data_ptr()), vp(partial.data_ptr()), vp(grads.data_ptr()), NB, M, N, K, K,
                P, 1, ACT_CODES["tanh"], 1, stream)
        keep = (q, y, partial, grads)

    def run():
        for _ in range(BACK_TO_BACK):
            _build.check(lib.vg_dense_f32(*args), "vg_dense_f32")

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
            name = "reduce" if "reduce" in a.key else "pass" if "vg_dense" in a.key else a.key
            out[name] = out.get(name, 0.0) + v / BACK_TO_BACK
    return out


def chains_outputs(BM, TL, X, dev):
    """K7 and K6 at the flagship's shape, C = 4: their outputs, to hold bit
    for bit against another checkout's."""
    import numpy as np
    import torch

    rng = np.random.default_rng(9)
    C = 4

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    ws = (t(rng.standard_normal((G, C, M, K)) / np.sqrt(M)),
          t(rng.standard_normal((G, C, K, K)) / np.sqrt(K)),
          t(rng.standard_normal((G, C, K, 1)) / np.sqrt(K)))
    bs = (t(rng.standard_normal((G, C, K)) * 0.1), t(rng.standard_normal((G, C, K)) * 0.1))
    targets = t(rng.standard_normal((G, C, N)))
    k7 = BM.data_vg_chains("tanh", X, ws, bs, targets)
    k7f = BM.forward_chains("tanh", X, ws, bs)

    def like(ts, sc):
        return tuple(t(rng.standard_normal(a.shape) * sc) for a in ts)

    eps_w = tuple(e.abs() for e in like(ws, 1e-3))
    eps_b = tuple(e.abs() for e in like(bs, 1e-3))
    lam_w = tuple(e.abs() + 0.5 for e in like(ws, 1.0))
    lam_b = tuple(torch.zeros_like(b) for b in bs)
    err = t(rng.uniform(0.5, 1.0, (G, C)))
    k6 = TL.integrate_chains("tanh", X, targets, err, ws, bs, like(ws, 1.0), like(bs, 1.0),
                             eps_w, eps_b, lam_w, lam_b, 2)
    out = {"K7": [k7[0], k7[1], *k7[2], *k7[3]], "K7 forward": [k7f],
           "K6": [x for part in k6 for x in (part if isinstance(part, (tuple, list)) else [part])]}
    return {k: [v.detach().cpu() for v in vs] for k, vs in out.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--save")
    ap.add_argument("--compare")
    opts = ap.parse_args()
    sys.path.insert(0, str(Path(opts.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_k8_torch: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from rs_bann_tpu_torch.ops import _build
    from rs_bann_tpu_torch.ops import branch_mlp as BM
    from rs_bann_tpu_torch.ops import leapfrog as TL

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{smi}; torch {torch.__version__}; rs_bann_tpu_torch from {BM.__file__}")
    t0 = time.perf_counter()
    _build.lib()
    build_s = time.perf_counter() - t0
    log = _build.BUILD_DIR / "build.log"
    print(f"build {build_s:.1f} s: " + ", ".join(
        ln for ln in log.read_text().splitlines() if ".cu: " in ln))
    ptx, cur = {}, None
    for line in log.read_text().splitlines():  # ptxas -v of branch_vg_dense.cu's kernels
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            cur = name if ("vg_dense" in name or "reduce_dense" in name) else None
        elif cur and ("registers" in line or "spill" in line):
            ptx.setdefault(cur, []).append(line.split(":", 1)[-1].strip())
    for name, lines in ptx.items():
        print(f"ptxas {name}: " + "; ".join(lines))

    dev = torch.device("cuda")
    X, cases = inputs(dev)
    res = {"device": smi, "build_s": build_s, "ptxas": ptx, "cases": {}}
    saved = {}
    gen = torch.Generator(dev).manual_seed(10)
    for name, (ix, ws, bs) in cases.items():
        NB = len(ix)
        targets = BM.forward_blocked_ref("tanh", X, ix, ws, bs) + torch.randn(
            (NB, N), device=dev, generator=gen)

        def call():
            return BM.data_vg_blocked("tanh", X, ix, ws, bs, targets)

        def ref(dt):
            c = lambda ts: tuple(v.to(dt) for v in ts)  # noqa: E731
            return BM.data_vg_blocked_ref("tanh", X.to(dt), ix, c(ws), c(bs), targets.to(dt))

        got, again, want, want64 = call(), call(), ref(torch.float32), ref(torch.float64)
        err, err64, plain64 = rel_err(got, want), rel_err(got, want64), rel_err(want, want64)
        same = all(torch.equal(a, b) for a, b in zip(flat(got), flat(again)))
        if not (err <= REL_TOL and err64 <= REL_TOL and same):
            raise AssertionError(f"{name}: rel err {err}, against f64 {err64} (tol {REL_TOL}), "
                                 f"identical repeat {same}")
        saved[name] = [v.detach().cpu() for v in flat(got)]
        n_x = len(set(ix.tolist()))
        mma = 2 * NB * N * (2 * M * K + 3 * K * K)  # the five products' FLOPs
        fmas = (M * K + K * K + K) + (M * K + 2 * K * K + K)
        nbytes = 4 * (n_x * M * N + 2 * NB * N + 2 * NB * (M * K + K * K + 3 * K) + NB)
        row = {"NB": NB, "distinct_x": n_x,
               "bytes_bound_ms": 1e3 * nbytes / PEAK_BYTES_S,
               "tensor_bound_ms": 1e3 * 3 * mma / PEAK_TF32_FLOPS,
               "f32_bound_ms": 1e3 * 2 * NB * N * fmas / PEAK_F32_FLOPS}
        row["bound_ms"] = max(row["bytes_bound_ms"], row["tensor_bound_ms"])
        if hasattr(BM, "vg_dense_plan"):
            row["plan"] = BM.vg_dense_plan(NB, M, N, K, K, 1)
        run = launcher(BM, _build, X, ix, ws, bs, targets)
        row["launch_ms"] = cuda_ms(run) / BACK_TO_BACK
        row["device_us"] = device_us(run)
        row["wrapper_ms"] = cuda_ms(call)
        t1 = time.perf_counter()
        for _ in range(200):
            call()
        torch.cuda.synchronize()
        row["host_call_ms"] = (time.perf_counter() - t1) * 1e3 / 200
        row["plain_ms"] = cuda_ms(lambda: ref(torch.float32))
        row.update(max_rel_err=err, max_rel_err_f64=err64, plain_max_rel_err_f64=plain64)
        print(f"{name}: launch {row['launch_ms']:.4f} ms (device: "
              + ", ".join(f"{k} {v:.2f} us" for k, v in row["device_us"].items())
              + f"), wrapper {row['wrapper_ms']:.4f} ms (host {row['host_call_ms']:.4f} ms a "
              f"call), plain {row['plain_ms']:.4f} ms; bounds: bytes {row['bytes_bound_ms']:.4f}, "
              f"3xTF32 {row['tensor_bound_ms']:.4f}, f32 {row['f32_bound_ms']:.4f} ms; share of "
              f"the bound {row['bound_ms'] / row['launch_ms']:.3f}; rel err {err:.3e} (f64: "
              f"kernel {err64:.3e}, plain {plain64:.3e}); plan {row.get('plan')}; identical repeat")
        res["cases"][name] = row
    saved.update(chains_outputs(BM, TL, X, dev))
    if opts.save:
        torch.save(saved, opts.save)
    if opts.compare:
        other = torch.load(opts.compare)
        res["compare"] = {}
        for name, ts in saved.items():
            o = other[name]
            bits = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum()) for a, b in zip(ts, o))
            total = sum(a.numel() for a in ts)
            worst = max((a.double() - b.double()).abs().max().item()
                        / max(1.0, b.double().abs().max().item()) for a, b in zip(ts, o))
            res["compare"][name] = {"words_differ": bits, "words": total, "max_rel_diff": worst}
            print(f"against {opts.compare}: {name}: {bits} of {total} words differ, worst rel "
                  f"difference {worst:.3e}")
            if name.startswith("K6") or name.startswith("K7"):
                if bits:
                    raise AssertionError(f"{name}: outputs differ from {opts.compare}")
            elif worst > REL_TOL:
                raise AssertionError(f"{name}: outputs differ from {opts.compare} by {worst}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
