#!/usr/bin/env python3
"""K4 (rs_bann_tpu_torch/csrc/branch_vg_packed.cu, ``data_vg_packed``) at the
shapes the port runs it, on one NVIDIA GPU: the quick loop for work on that
kernel.

    python3 scripts/bench_k4_torch.py [--root DIR] [--save F] [--compare F] [--trials N] [--sass]

One branch of packed bytes uint8 [m_pad, B], n individuals, weights from a
seed (W0 ~ N(0, 0.2^2), w_out ~ N(0, 0.5^2), the padded markers' rows and
scale zero), shapes:
  seq      the packed sequential sweep's branch: m_pad = 104, k0 = 16, n =
           100,000, B = 25,088 (identity and tanh)
  card     the card test's: m_pad = 104, n = 1,300
  m13      m_pad = 13, n = 100,000 (one marker tile of 16)
  m300     m_pad = 300, n = 100,000
  k8, k32  k0 = 8 and 32 at m_pad = 104, n = 100,000
  depth1   depth 1, W1 [16, 16] (the deep design, csrc/packed_deep.cuh)

For each it holds K4 against its plain version (the wrapper's f32 fold,
rss and unfold around ``data_vg_packed_ref``) within REL_TOL of the
largest entry of each output, with a bit-identical repeat, prints how far
each of the two lies from the plain version run in f64, and prints the
CUDA-event medians of 7 of: the launch alone (20 back-to-back calls of the
C entry on buffers made once, per call: the pass and its reduce, with each
kernel's device time from torch.profiler beside it; at depth
0 in a checkout with the tensor-core kernel that includes the fold, rss and
unfold, in an older one the wrapper did those around it), the wrapper's call
(``data_vg_packed``) and the plain version's; the bounds (the bytes, each
input read once and each output written once, over 3.35 TB/s; the work as
implemented, three bf16 tensor-core products per f32 one at 989 TFLOP/s;
the f32 FMAs at 67 TFLOP/s); the launch's plan where the checkout has one;
and ``ptxas -v``'s registers and spills of K4's kernels.

  --root DIR   import rs_bann_tpu_torch from DIR: another checkout (say the
               parent commit, unpacked with ``git archive`` into a directory
               that .gitignore lists), to time its kernel on the same inputs
  --save F     write every checked output to F (torch.save): every 61st word
               of y_pred and a checksum, the gradients and rss in full
  --compare F  compare them with those another run saved: the sampled words
               that differ, the worst difference (within REL_TOL of the
               largest entry) and the outputs whose checksums differ
  --trials N   accuracy at the card shape over N seeded inputs and all five
               activations: the worst error of K4 and of the f32 plain
               version, each against the plain version in f64, and of K4
               against the f32 plain version (relative to the largest entry
               of each output; at relu and leaky_relu a pre-activation within
               rounding of 0 takes the other branch, so one individual's
               gradient term moves)
  --sass       count the instructions of each K4 kernel in the built object
               (cuobjdump -sass), in the whole function and in each loop that
               holds MMAs: HMMA, FFMA, I2F, PRMT, LDS, STS, STG, LDG, cp.async
               (LDGSTS), spill loads and stores
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

# name -> (m_pad, n, k0, depth, activations)
SHAPES = {
    "seq": (104, 100_000, 16, 0, ("identity", "tanh")),
    "card": (104, 1_300, 16, 0, ("identity",)),
    "m13": (13, 100_000, 16, 0, ("identity",)),
    "m300": (300, 100_000, 16, 0, ("identity",)),
    "k8": (104, 100_000, 8, 0, ("identity",)),
    "k32": (104, 100_000, 32, 0, ("identity",)),
    "depth1": (104, 100_000, 16, 1, ("identity",)),
}
RUNS, BACK_TO_BACK = 7, 20
SAMPLE = 61
PEAK_F32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES_S = 67e12, 989e12, 3.35e12  # H100 SXM
REL_TOL = 1e-4  # as chip_smoke.py
COUNTED = ("HMMA", "FFMA", "I2F", "PRMT", "LDS", "STS", "STG", "LDG", "LDL", "STL", "LDGSTS")


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


def inputs(m_pad, n, k0, depth, dev, seed):
    import torch

    from rs_bann_tpu_torch.models.density import PackedX

    gen = torch.Generator(dev).manual_seed(seed)
    B = -(-n // 512) * 128
    m = m_pad - 3 if m_pad > 8 else m_pad  # the last rows padding
    by = torch.randint(0, 256, (m_pad, B), dtype=torch.uint8, device=dev, generator=gen)
    scale = torch.rand(m_pad, device=dev, generator=gen) + 0.5
    shift = 2 * torch.rand(m_pad, device=dev, generator=gen)
    scale[m:] = 0.0
    shift[m:] = 0.0
    widths = [m_pad] + ([16] if depth else []) + [k0, 1]
    ws = [0.2 * torch.randn((widths[i], widths[i + 1]), device=dev, generator=gen)
          for i in range(len(widths) - 1)]
    ws[0][m:] = 0.0
    ws[-1] *= 2.5
    bs = [0.1 * torch.randn(widths[i + 1], device=dev, generator=gen)
          for i in range(len(widths) - 2)]
    target = torch.randn(n, device=dev, generator=gen)
    return PackedX(by, scale, shift, n), tuple(ws), tuple(bs), target


def plain(BM, act, x, ws, bs, target):
    """K4's plain version with the wrapper's f32 fold, rss and unfold."""
    import torch

    wf = (x.w_scale[:, None] * ws[0],) + ws[1:]
    bf = (bs[0] - x.shift @ wf[0],) + bs[1:]
    y, dws, dbs = BM.data_vg_packed_ref(act, x.bytes, target, wf, bf, x.n)
    dW0 = x.w_scale[:, None] * dws[0] - (x.shift * x.w_scale)[:, None] * dbs[0]
    return y, torch.sum((y - target) ** 2), (dW0,) + dws[1:], dbs


def plain64(act, x, ws, bs, target):
    """The same in f64 throughout (the decode from packed_matmul, so that an
    older checkout can run it too)."""
    import torch

    from rs_bann_tpu_torch.ops.activations import apply
    from rs_bann_tpu_torch.ops.packed_matmul import unpack_strided

    d = torch.float64
    s, sh, t = x.w_scale.to(d), x.shift.to(d), target.to(d)
    wf = [(s[:, None] * ws[0].to(d)).requires_grad_(True)]
    wf += [w.to(d).requires_grad_(True) for w in ws[1:]]
    bf = [(bs[0].to(d) - sh @ wf[0].detach()).requires_grad_(True)]
    bf += [b.to(d).requires_grad_(True) for b in bs[1:]]
    with torch.enable_grad():
        a = unpack_strided(x.bytes, x.n).to(d).T
        for w, b in zip(wf[:-1], bf):
            a = apply(act, a @ w + b)
        y = (a @ wf[-1])[:, 0]
        g = torch.autograd.grad(0.5 * torch.sum((y - t) ** 2), wf + bf)
    dws, dbs = g[:len(wf)], g[len(wf):]
    dW0 = s[:, None] * dws[0] - (sh * s)[:, None] * dbs[0]
    return y.detach(), torch.sum((y.detach() - t) ** 2), (dW0,) + dws[1:], dbs


def flat(r):
    return (r[0], r[1]) + tuple(r[2]) + tuple(r[3])


def rel_err(got, want):
    """The largest difference of any output over max(1, its largest entry)."""
    return max((a.double() - b.double()).abs().max().item()
               / max(1.0, b.double().abs().max().item()) for a, b in zip(flat(got), flat(want)))


def launcher(BM, _build, act, x, ws, bs, target):
    """BACK_TO_BACK calls of the C entry point on buffers made once: the pass
    and its reduce (plus, at depth 0 with the tensor-core kernel, the fold,
    rss and unfold inside them)."""
    import torch

    from rs_bann_tpu_torch.ops.activations import ACT_CODES

    lib = _build.lib()
    vp = ctypes.c_void_p
    m, B = x.bytes.shape
    n, k0, s = x.n, ws[0].shape[1], ws[-1].shape[0]
    depth = len(ws) - 2
    stream = vp(_build.stream_ptr(x.bytes))
    if depth == 0 and hasattr(BM, "branch_vg_packed0_plan"):
        plan = BM.branch_vg_packed0_plan(m, B, n, k0)
        out = torch.empty(n + m * k0 + 2 * k0 + 1, device=x.bytes.device)
        part = torch.empty(plan["ctas"] * plan["row"], device=x.bytes.device)
        args = (vp(x.bytes.data_ptr()), vp(target.data_ptr()), vp(ws[0].data_ptr()),
                vp(bs[0].data_ptr()), vp(ws[1].data_ptr()), vp(x.w_scale.data_ptr()),
                vp(x.shift.data_ptr()), vp(out.data_ptr()), vp(part.data_ptr()), part.numel(),
                vp(out.data_ptr() + 4 * n), m, B, n, k0, ACT_CODES[act], stream)
        keep = (out, part)
        fn = lib.branch_vg_packed0_f32
    elif hasattr(lib, "branch_vg_packed_deep_f32"):  # the deep design, folding inside
        plan = BM.branch_vg_packed_deep_plan(m, B, n, k0, s, depth)
        q = BM.flat_params(ws, bs)
        out = torch.empty(n + q.numel() + 1, device=x.bytes.device)
        part = torch.empty(plan["ctas"] * plan["row"], device=x.bytes.device)
        args = (vp(x.bytes.data_ptr()), vp(target.data_ptr()), vp(q.data_ptr()),
                vp(x.w_scale.data_ptr()), vp(x.shift.data_ptr()), vp(out.data_ptr()),
                vp(part.data_ptr()), part.numel(), vp(out.data_ptr() + 4 * n), m, B, n, k0, s,
                depth, ACT_CODES[act], stream)
        keep = (q, out, part)
        fn = lib.branch_vg_packed_deep_f32
    else:  # the first f32 kernel on pre-folded weights (checkouts before the deep design)
        w0p = (x.w_scale[:, None] * ws[0]).contiguous()
        off = (bs[0] - x.shift @ w0p).contiguous()
        wout = ws[-1].reshape(s).contiguous()
        w1, b1 = (ws[1], bs[1]) if depth else (wout, wout)
        P = m * k0 + k0 + (k0 * s + s if depth else 0) + s
        y = torch.empty(n, device=x.bytes.device)
        part = torch.empty((B // 128, P), device=x.bytes.device)
        grads = torch.empty(P, device=x.bytes.device)
        args = (vp(x.bytes.data_ptr()), vp(target.data_ptr()), vp(w0p.data_ptr()),
                vp(off.data_ptr()), vp(w1.data_ptr()), vp(b1.data_ptr()), vp(wout.data_ptr()),
                vp(y.data_ptr()), vp(part.data_ptr()), vp(grads.data_ptr()), 1, m, B, n, k0, s,
                P, depth, ACT_CODES[act], stream)
        keep = (w0p, off, wout, y, part, grads)
        fn = lib.branch_vg_packed_f32

    def run():
        for _ in range(BACK_TO_BACK):
            _build.check(fn(*args), "K4 entry")

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
            name = ("reduce" if "reduce" in a.key else
                    "pass" if "vg_packed" in a.key or "vg_deep" in a.key else a.key)
            out[name] = out.get(name, 0.0) + v / BACK_TO_BACK
    return out


def sass_counts(obj):
    """Instruction counts of each K4 kernel in ``obj``: the whole function and
    every loop that holds MMAs."""
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
        if "vg_packed" not in name and "reduce" not in name:
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
    ap.add_argument("--trials", type=int, default=0)
    opts = ap.parse_args()
    sys.path.insert(0, str(Path(opts.root).resolve()))
    sys.path.insert(0, str(Path(__file__).resolve().parent))  # sass_k5_torch

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_k4_torch: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from rs_bann_tpu_torch.ops import _build
    from rs_bann_tpu_torch.ops import branch_mlp as BM

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{smi}; torch {torch.__version__}; rs_bann_tpu_torch from {BM.__file__}")
    t0 = time.perf_counter()
    _build.lib()
    build_s = time.perf_counter() - t0
    log = _build.BUILD_DIR / "build.log"
    print(f"build {build_s:.1f} s: " + ", ".join(
        l for l in log.read_text().splitlines() if ".cu: " in l))
    ptx, cur = {}, None
    for line in log.read_text().splitlines():  # ptxas -v of branch_vg_packed.cu's kernels
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            cur = name if ("vg_packed" in name or "reduce0" in name
                           or "reduce_partials" in name) else None
        elif cur and ("registers" in line or "spill" in line):
            ptx.setdefault(cur, []).append(line.split(":", 1)[-1].strip())
    for name, lines in ptx.items():
        print(f"ptxas {name}: " + "; ".join(lines))

    dev = torch.device("cuda")
    res = {"device": smi, "build_s": build_s, "ptxas": ptx, "shapes": {}}
    saved = {}
    for seed, (label, (m_pad, n, k0, depth, acts)) in enumerate(SHAPES.items()):
        x, ws, bs, target = inputs(m_pad, n, k0, depth, dev, seed)
        B = x.bytes.shape[1]
        s = ws[-1].shape[0]
        # the layer-0 products (forward and dW0') and the output layer's per
        # individual, plus the hidden layer's at depth 1
        fmas = 2 * (m_pad * k0 + s) + (3 * k0 * s if depth else 0)
        flop = 2 * n * fmas
        nbytes = (x.bytes.numel() + 4 * (2 * m_pad + 2 * n + 2 * sum(w.numel() for w in ws)
                                          + 2 * sum(b.numel() for b in bs)))
        row = {"m_pad": m_pad, "n": n, "k0": k0, "depth": depth,
               "bytes_bound_ms": 1e3 * nbytes / PEAK_BYTES_S,
               "tensor_bound_ms": 1e3 * 3 * flop / PEAK_BF16_FLOPS,
               "f32_bound_ms": 1e3 * flop / PEAK_F32_FLOPS}
        if depth == 0 and hasattr(BM, "branch_vg_packed0_plan"):
            row["plan"] = BM.branch_vg_packed0_plan(m_pad, B, n, k0)
        print(f"{label}: bytes {tuple(x.bytes.shape)}, n {n}, k0 {k0}, depth {depth}: bounds bytes "
              f"{row['bytes_bound_ms']:.4f} ms, tensor {row['tensor_bound_ms']:.4f} ms, f32 FMA "
              f"{row['f32_bound_ms']:.4f} ms; plan {row.get('plan')}")
        for act in acts:
            got = BM.data_vg_packed(act, x, ws, bs, target)
            want = plain(BM, act, x, ws, bs, target)
            again = BM.data_vg_packed(act, x, ws, bs, target)
            want64 = plain64(act, x, ws, bs, target)
            err, err64, plain_err64 = rel_err(got, want), rel_err(got, want64), rel_err(want, want64)
            same = all(torch.equal(a, b) for a, b in zip(flat(got), flat(again)))
            if not (err <= REL_TOL and same):
                raise AssertionError(f"{label} {act}: rel err {err} (tol {REL_TOL}), "
                                     f"identical repeat {same}")
            name = f"{label}/{act}"
            words = got[0].view(torch.int32)
            saved[name] = {"y_sample": got[0][::SAMPLE].cpu(),
                           "y_checksum": int(words.to(torch.int64).sum()),
                           "y_max": got[0].abs().max().item(),
                           "rest": [t.cpu() for t in flat(got)[1:]]}
            run = launcher(BM, _build, act, x, ws, bs, target)
            launch_ms = cuda_ms(run) / BACK_TO_BACK
            dev_us = device_us(run)
            ms = cuda_ms(lambda: BM.data_vg_packed(act, x, ws, bs, target))
            plain_ms = cuda_ms(lambda: plain(BM, act, x, ws, bs, target))
            print(f"  {name}: launch {launch_ms:.4f} ms (device: "
                  + ", ".join(f"{k} {v:.2f} us" for k, v in dev_us.items())
                  + f"), wrapper {ms:.4f} ms, plain {plain_ms:.4f} ms; tensor bound share "
                  f"{row['tensor_bound_ms'] / launch_ms:.3f}; rel err {err:.3e} (against f64: "
                  f"kernel {err64:.3e}, plain {plain_err64:.3e}), identical repeat")
            row[act] = {"launch_ms": launch_ms, "device_us": dev_us, "ms": ms,
                        "plain_ms": plain_ms, "max_rel_err": err, "max_rel_err_f64": err64,
                        "plain_max_rel_err_f64": plain_err64}
        res["shapes"][label] = row
        del x, ws, bs, target

    if opts.trials:
        m_pad, n, k0, depth, _ = SHAPES["card"]
        worst = {}
        for seed in range(opts.trials):
            x, ws, bs, target = inputs(m_pad, n, k0, depth, dev, 1000 + seed)
            for act in BM.SUPPORTED_ACTIVATIONS:
                got, want = BM.data_vg_packed(act, x, ws, bs, target), plain(BM, act, x, ws, bs, target)
                want64 = plain64(act, x, ws, bs, target)
                w = worst.setdefault(act, {"kernel_f64": 0.0, "plain_f64": 0.0, "kernel_plain": 0.0})
                for key, e in (("kernel_f64", rel_err(got, want64)),
                               ("plain_f64", rel_err(want, want64)),
                               ("kernel_plain", rel_err(got, want))):
                    w[key] = max(w[key], e)
        res["trials"] = {"n": opts.trials, "worst": worst}
        for act, w in worst.items():
            print(f"card shape, {opts.trials} seeds, {act}: worst rel err of the kernel against "
                  f"f64 {w['kernel_f64']:.3e}, of the f32 plain version against f64 "
                  f"{w['plain_f64']:.3e}, of the kernel against the f32 plain version "
                  f"{w['kernel_plain']:.3e}")
    if opts.save:
        torch.save(saved, opts.save)
    if opts.compare:
        other = torch.load(opts.compare)
        worst, bits, sums, total = 0.0, 0, 0, 0
        for name, t in saved.items():
            o = other[name]
            bits += int((t["y_sample"].view(torch.int32) != o["y_sample"].view(torch.int32)).sum())
            total += t["y_sample"].numel()
            worst = max(worst, (t["y_sample"] - o["y_sample"]).abs().max().item()
                        / max(1.0, o["y_max"]))
            sums += t["y_checksum"] != o["y_checksum"]
            for a, b in zip(t["rest"], o["rest"]):
                bits += int((a.view(torch.int32) != b.view(torch.int32)).sum())
                total += a.numel()
                worst = max(worst, (a - b).abs().max().item() / max(1.0, b.abs().max().item()))
        print(f"against {opts.compare}: {bits} of {total} compared words differ in their bits, "
              f"worst rel difference {worst:.3e}; {sums} of {len(saved)} y_pred checksums differ")
        res["compare"] = {"words_differ": bits, "words": total, "max_rel_diff": worst,
                          "checksums_differ": sums}
        if worst > REL_TOL:
            raise AssertionError(f"outputs differ from {opts.compare} by {worst}")
    if opts.sass:
        src = _build.CSRC / "branch_vg_packed.cu"
        res["sass"] = sass_counts(_build._object(src, _build._keys()[src]))
        for fn, c in res["sass"].items():
            print(f"  sass {fn}: {c}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
