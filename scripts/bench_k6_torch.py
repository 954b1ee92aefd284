#!/usr/bin/env python3
"""K6 (rs_bann_tpu_torch/csrc/traj_dense.cu, ``integrate_chains`` on a
CUDA tensor) at the dense flagship's shape on one NVIDIA GPU: the quick loop
for work on that kernel.

    python3 scripts/bench_k6_torch.py [--root DIR] [--save F] [--compare F] [--ablate]

The dense flagship's parallel block (bench.py workload 1): X [64, 64, 4096]
f32 from a seed, C = 4 chains, tanh, depth 1, k0 = s = 32, weights W ~ N(0,
1 / fan_in), momenta N(0, 1), step sizes 1e-3 |N(0, 1)|, prior precision
factors 0.5 + |N(0, 1)| on the weights (zero on the biases), err in [0.5,
1), targets the plain prediction plus N(0, 1) noise. For L = 1 and 64 it
holds K6 against its plain version (``integrate_chains_ref``) in f32 and in
f64, within REL_TOL (L = 1) and REL_TOL_TRAJ (L = 64) of the largest entry
of each output, with a bit-identical repeat, and prints the CUDA-event
medians of 7 of: the launch alone (the C entry on buffers made once) and
the wrapper's call (``integrate_chains``), then the plain version's once.
The bounds: the work as implemented, the five products in 3xTF32 (three
tf32 tensor-core products per f32 one) at 494.7 TFLOP/s; X read once per
gradient evaluation (with the targets, the inputs and the outputs) over
3.35 TB/s; the f32 FMAs at 67 TFLOP/s. Then the plan (CTAs, CTAs per
instance R, chains per CTA CC, chunks, X buffers, shared bytes), the
partial-row bytes each evaluation writes, and ``ptxas -v``'s registers and
spills of K6's kernels from the build log. K7 (``data_vg_chains``,
``forward_chains``) and K8 (``data_vg``, ``data_vg_blocked``) run at the
flagship's shape too, whose outputs ``--compare`` holds bit for bit.

  --root DIR   import rs_bann_tpu_torch from DIR: another checkout (say the
               parent commit, unpacked with ``git archive`` into a directory
               that .gitignore lists), to time its kernels on the same inputs
  --save F     write every checked output to F (torch.save)
  --compare F  compare them with those another run saved: the 32-bit words
               that differ and the worst difference of each; K7's and K8's
               words must not differ, K6's must agree within REL_TOL_TRAJ
  --ablate     also time the launch at L = 64 under identity (the
               activation's share), and at L = 0 (scripts/ablate_k6_torch.py
               times the kernel at one chain per CTA and with edited pieces)
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

G, C, M, N, K = 64, 4, 64, 4096, 32  # the dense flagship: branches, chains, m_pad, n, widths
RUNS = 7
PEAK_F32_FLOPS, PEAK_TF32_FLOPS, PEAK_BYTES_S = 67e12, 494.7e12, 3.35e12  # H100 SXM
REL_TOL, REL_TOL_TRAJ = 1e-4, 1e-3  # as chip_smoke.py


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


def inputs(BM, dev):
    """X [G, M, N], and the block's state, from a seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(15)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    X = t(rng.standard_normal((G, M, N)))
    dims = [(M, K), (K, K), (K, 1)]
    ws = tuple(t(rng.standard_normal((G, C, i, o)) / np.sqrt(i)) for i, o in dims)
    bs = tuple(t(rng.standard_normal((G, C, o)) * 0.1) for _, o in dims[:-1])

    def like(ts, sc):
        return tuple(t(rng.standard_normal(a.shape) * sc) for a in ts)

    targets = BM.forward_chains_ref("tanh", X, ws, bs) + t(rng.standard_normal((G, C, N)))
    eps_w = tuple(e.abs() for e in like(ws, 1e-3))
    eps_b = tuple(e.abs() for e in like(bs, 1e-3))
    lam_w = tuple(e.abs() + 0.5 for e in like(ws, 1.0))
    lam_b = tuple(torch.zeros_like(b) for b in bs)
    err = t(rng.uniform(0.5, 1.0, (G, C)))
    return X, (targets, err, ws, bs, like(ws, 1.0), like(bs, 1.0), eps_w, eps_b, lam_w, lam_b)


def flat(out):
    return [x for part in out for x in part]


def rel_err(got, want):
    """The largest difference of any output over max(1, its largest entry)."""
    return max((a.double() - b.double()).abs().max().item()
               / max(1.0, b.double().abs().max().item()) for a, b in zip(flat(got), flat(want)))


def launcher(TL, BM, _build, X, state, steps, act):
    """The C entry alone, on buffers made once. This design takes the
    per-layer tensors and writes new outputs; the first K6 design takes flat
    [G, C, P] state updated in place, and a partial row per 128-individual
    tile (its copies are made here, once)."""
    import torch

    from rs_bann_tpu_torch.ops.activations import ACT_CODES

    lib = _build.lib()
    vp = ctypes.c_void_p
    targets, err, ws, bs, p_w, p_b, eps_w, eps_b, lam_w, lam_b = state
    P = M * K + K + K * K + K + K
    stream = vp(_build.stream_ptr(X))
    code = ACT_CODES[act]
    if hasattr(TL, "traj_dense_plan"):
        plan = TL.traj_dense_plan(G, C, M, N, K, K, 1, act)
        scratch = torch.empty(plan["scratch"], dtype=torch.uint8, device=X.device)
        out = torch.empty(2 * G * C * P, device=X.device)
        outs, off = [], 0
        for tns in (ws[0], bs[0], ws[1], bs[1], ws[2]) * 2:
            outs.append(out[off: off + tns.numel()])
            off += tns.numel()
        # strides over branches and chains, then the last two dims' (a
        # bias's first unused; every tensor here is contiguous)
        ptrs = [targets.data_ptr(), err.data_ptr()]
        strides = list(targets.stride()[:2] + targets.stride()[-2:] + err.stride() * 2)
        for w_, b_ in ((ws, bs), (p_w, p_b), (eps_w, eps_b), (lam_w, lam_b)):
            for tns in (w_[0], b_[0], w_[1], b_[1], w_[2]):
                ptrs.append(tns.data_ptr())
                strides += tns.stride()[:2] + tns.stride()[-2:]
        for o, tns in zip(outs, (ws[0], bs[0], ws[1], bs[1], ws[2]) * 2):
            ptrs.append(o.data_ptr())
            strides += tns.stride()[:2] + tns.stride()[-2:]
        args = (vp(X.data_ptr()), (vp * 32)(*ptrs), (ctypes.c_longlong * 128)(*strides),
                vp(scratch.data_ptr()), plan["scratch"], G, C, M, N, K, K, 1, steps, code,
                0) + ((0,) if hasattr(TL, "x_bf16") else ()) + (stream,)
        keep = (scratch, out)
    else:
        w, pw = BM.flat_params(ws, bs), BM.flat_params(p_w, p_b)
        eps, lam = BM.flat_params(eps_w, eps_b), BM.flat_params(lam_w, lam_b)
        partial = torch.empty((G, C, -(-N // 128), P), device=X.device)
        args = (vp(X.data_ptr()), vp(targets.data_ptr()), vp(err.data_ptr()), vp(eps.data_ptr()),
                vp(lam.data_ptr()), vp(w.data_ptr()), vp(pw.data_ptr()), vp(partial.data_ptr()),
                G, C, M, N, K, K, P, 1, steps, code, 0, stream)
        keep = (w, pw, eps, lam, partial)

    def run():
        _build.check(lib.traj_dense_f32(*args), "traj_dense_f32")

    run.buffers = keep  # alive as long as the launcher
    return run


def k7_k8_outputs(BM, X, dev):
    """K7 and K8 at the flagship's shape: their outputs, to hold bit for bit
    against another checkout's."""
    import numpy as np
    import torch

    rng = np.random.default_rng(9)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    dims = [(M, K), (K, K), (K, 1)]
    ws = tuple(t(rng.standard_normal((G, C, i, o)) / np.sqrt(i)) for i, o in dims)
    bs = tuple(t(rng.standard_normal((G, C, o)) * 0.1) for _, o in dims[:-1])
    targets = t(rng.standard_normal((G, C, N)))
    k7 = BM.data_vg_chains("tanh", X, ws, bs, targets)
    out = {"K7": [k7[0], k7[1], *k7[2], *k7[3]],
           "K7 forward": [BM.forward_chains("tanh", X, ws, bs)]}
    for NB in (1, 32, 64):
        ix = torch.from_numpy(rng.permutation(G)[:NB].astype(np.int32)).to(dev)
        wb = tuple(w[:, 0][ix.long()].contiguous() for w in ws)
        bb = tuple(b[:, 0][ix.long()].contiguous() for b in bs)
        tb = targets[:, 0][ix.long()].contiguous()
        if NB == 1:
            r = BM.data_vg("tanh", X[ix[0].item()], tuple(w[0] for w in wb),
                           tuple(b[0] for b in bb), tb[0])
            out["K8a"] = [r[0], r[1], *r[2], *r[3]]
        else:
            r = BM.data_vg_blocked("tanh", X, ix, wb, bb, tb)
            out[f"K8b NB={NB}"] = [r[0], r[1], *r[2], *r[3]]
    return {k: [v.detach().reshape(-1).cpu() for v in vs] for k, vs in out.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--save")
    ap.add_argument("--compare")
    ap.add_argument("--ablate", action="store_true")
    opts = ap.parse_args()
    sys.path.insert(0, str(Path(opts.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_k6_torch: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from rs_bann_tpu_torch.ops import _build
    from rs_bann_tpu_torch.ops import branch_mlp as BM
    from rs_bann_tpu_torch.ops import leapfrog as TL

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{smi}; torch {torch.__version__}; rs_bann_tpu_torch from {TL.__file__}")
    t0 = time.perf_counter()
    _build.lib()
    build_s = time.perf_counter() - t0
    log = _build.BUILD_DIR / "build.log"
    print(f"build {build_s:.1f} s: " + ", ".join(
        ln for ln in log.read_text().splitlines() if ".cu: " in ln))
    ptx, cur = {}, None
    for line in log.read_text().splitlines():  # ptxas -v of traj_dense.cu's kernels
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            cur = name if "traj_dense" in name else None
        elif cur and ("registers" in line or "spill" in line):
            ptx.setdefault(cur, []).append(line.split(":", 1)[-1].strip())
    regs = sorted({ln for lines in ptx.values() for ln in lines})
    print(f"ptxas, {len(ptx)} K6 kernels: " + "; ".join(regs))

    dev = torch.device("cuda")
    X, state = inputs(BM, dev)
    new = hasattr(TL, "traj_dense_plan")
    P = M * K + K + K * K + K + K
    res = {"device": smi, "build_s": build_s, "ptxas": regs, "cases": {}}
    if new:
        plan = TL.traj_dense_plan(G, C, M, N, K, K, 1, "tanh")
        segs = plan["ctas"]  # one segment per CTA where the grid is R CTAs per instance
        res["plan"] = plan
        res["partial_bytes"] = 4 * segs * plan["cc"] * P
        print(f"plan {plan}; CTAs per instance R = {plan['ctas'] / (G * plan['chunks']):.2f}")
    else:
        res["partial_bytes"] = 4 * G * C * -(-N // 128) * P
    print(f"partial rows written per evaluation: {res['partial_bytes'] / 1e6:.2f} MB")
    saved = {}
    per = G * C * N
    mma = 2 * per * (2 * M * K + 3 * K * K)  # the five products' FLOPs per evaluation
    fmas = (M * K + K * K + K) + (M * K + 2 * K * K + K)
    for steps in (1, 64):
        tol = REL_TOL if steps == 1 else REL_TOL_TRAJ

        def call():
            return TL.integrate_chains("tanh", X, *state, steps)

        got, again = call(), call()
        want = TL.integrate_chains_ref("tanh", X, *state, steps)
        d64 = [v.double() if isinstance(v, torch.Tensor) else tuple(u.double() for u in v)
               for v in (X,) + state]
        want64 = TL.integrate_chains_ref("tanh", *d64, steps)
        err, err64, plain64 = rel_err(got, want), rel_err(got, want64), rel_err(want, want64)
        same = all(torch.equal(a, b) for a, b in zip(flat(got), flat(again)))
        if not (err <= tol and err64 <= tol and same):
            raise AssertionError(f"L={steps}: rel err {err}, against f64 {err64} (tol {tol}), "
                                 f"identical repeat {same}")
        saved[f"K6 L={steps}"] = [v.detach().reshape(-1).cpu() for v in flat(got)]
        evals = steps + 1
        # X once per evaluation; the targets; the state in and out
        nbytes = 4 * (evals * G * M * N + 2 * per + 6 * G * C * P)
        row = {"L": steps, "tensor_bound_ms": 1e3 * 3 * mma * evals / PEAK_TF32_FLOPS,
               "bytes_bound_ms": 1e3 * nbytes / PEAK_BYTES_S,
               "f32_bound_ms": 1e3 * 2 * per * fmas * evals / PEAK_F32_FLOPS}
        row["bound_ms"] = max(row["tensor_bound_ms"], row["bytes_bound_ms"])
        run = launcher(TL, BM, _build, X, state, steps, "tanh")
        row["launch_ms"] = cuda_ms(run)
        row["wrapper_ms"] = cuda_ms(call)
        row["plain_ms"] = cuda_ms(lambda: TL.integrate_chains_ref("tanh", X, *state, steps), runs=3)
        row.update(max_rel_err=err, max_rel_err_f64=err64, plain_max_rel_err_f64=plain64)
        if opts.ablate and new and steps == 64:
            row["identity_launch_ms"] = cuda_ms(launcher(TL, BM, _build, X, state, steps,
                                                         "identity"))
            row["L0_launch_ms"] = cuda_ms(launcher(TL, BM, _build, X, state, 0, "tanh"))
        print(f"L={steps}: launch {row['launch_ms']:.3f} ms, wrapper {row['wrapper_ms']:.3f} ms, "
              f"plain {row['plain_ms']:.3f} ms; bounds: 3xTF32 {row['tensor_bound_ms']:.3f}, "
              f"bytes {row['bytes_bound_ms']:.3f}, f32 {row['f32_bound_ms']:.3f} ms; share of "
              f"the bound {row['bound_ms'] / row['launch_ms']:.3f}; rel err {err:.3e} (f64: "
              f"kernel {err64:.3e}, plain {plain64:.3e}); identical repeat"
              + "".join(f"; {k} {v:.3f}" for k, v in row.items() if k.endswith("_launch_ms")))
        res["cases"][f"L={steps}"] = row
    per_eval = (res["cases"]["L=64"]["launch_ms"] - res["cases"]["L=1"]["launch_ms"]) / 63
    res["per_evaluation_ms"] = per_eval
    print(f"per gradient evaluation {per_eval:.4f} ms (from L = 1 and 64)")
    saved.update(k7_k8_outputs(BM, X, dev))
    if opts.save:
        torch.save(saved, opts.save)
    if opts.compare:
        other = torch.load(opts.compare)
        res["compare"] = {}
        for name, ts in saved.items():
            o = other[name]
            bits = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                       for a, b in zip(ts, o))
            total = sum(a.numel() for a in ts)
            worst = max((a.double() - b.double()).abs().max().item()
                        / max(1.0, b.double().abs().max().item()) for a, b in zip(ts, o))
            res["compare"][name] = {"words_differ": bits, "words": total, "max_rel_diff": worst}
            print(f"against {opts.compare}: {name}: {bits} of {total} words differ, worst rel "
                  f"difference {worst:.3e}")
            if name.startswith("K6"):
                if worst > REL_TOL_TRAJ:
                    raise AssertionError(f"{name}: outputs differ from {opts.compare} by {worst}")
            elif bits:
                raise AssertionError(f"{name}: outputs differ from {opts.compare}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
