#!/usr/bin/env python3
"""K7 (rs_bann_tpu_torch/csrc/branch_vg_chains.cu, ``data_vg_chains`` and
``forward_chains`` on a CUDA tensor) at the dense flagship's shape on one
NVIDIA GPU: the quick loop for work on that kernel.

    python3 scripts/bench_k7_torch.py [--root DIR] [--save F] [--compare F]

The dense flagship's parallel block (bench.py workload 1): X [64, 64, 4096]
f32 from a seed, C = 4 chains, tanh, depth 1, k0 = s = 32, weights W ~ N(0,
1 / fan_in), targets the plain prediction plus N(0, 1) noise. It holds K7's
value-and-gradient and forward-only calls against the plain version
(``data_vg_chains_ref``) in f32 and in f64 within REL_TOL of the largest
entry of each output (y_pred atol REL_TOL), with a bit-identical repeat, and
prints the CUDA-event medians of 7 of: the launch alone (the C entry on
buffers made once; with the gradient the pass and its reduce) and the
wrapper's call, then the plain version's. The bounds: the work as
implemented, the products in 3xTF32 (three tf32 tensor-core products per f32
one) at 494.7 TFLOP/s (forward: Z0 and Z1; with the gradient the five of
csrc/dense_vg_mma.cuh); X, the weights, the targets and the outputs moved
once over 3.35 TB/s; the f32 FMAs at 67 TFLOP/s. Then the plan of each
(CTAs, CTAs per SM, chains per CTA CC, X buffers, shared bytes) and the
partial-row bytes a gradient call writes, and ``ptxas -v``'s registers and
spills of K7's kernels from the build log.

K6 (``integrate_chains`` at L = 1 and 64) and K8 (``data_vg``,
``data_vg_blocked`` at NB = 32 and 64) run at the flagship's shape too;
``--compare`` holds K6's outputs bit for bit against another run's and
reports by how many 32-bit words and how far K7's and K8's moved.

  --root DIR   import rs_bann_tpu_torch from DIR: another checkout (say the
               parent commit, unpacked with ``git archive`` into a directory
               that .gitignore lists), to time its kernels on the same inputs
  --save F     write every checked output to F (torch.save)
  --compare F  compare them with those another run saved
The last line is a JSON object of the numbers.
"""

import argparse
import ctypes
import json
import sys
import time
from pathlib import Path

from _timing import (PEAK_BYTES_S, PEAK_F32_FLOPS, PEAK_TF32_FLOPS, cuda_ms, rel_err, smi,
                     words_differ)

G, C, M, N, K = 64, 4, 64, 4096, 32  # the dense flagship: branches, chains, m_pad, n, widths
REL_TOL = 1e-4  # as chip_smoke.py


def inputs(BM, dev):
    """X [G, M, N], the chains' weights, and targets, from a seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(16)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    X = t(rng.standard_normal((G, M, N)))
    dims = [(M, K), (K, K), (K, 1)]
    ws = tuple(t(rng.standard_normal((G, C, i, o)) / np.sqrt(i)) for i, o in dims)
    bs = tuple(t(rng.standard_normal((G, C, o)) * 0.1) for _, o in dims[:-1])
    targets = BM.forward_chains_ref("tanh", X, ws, bs) + t(rng.standard_normal((G, C, N)))
    return X, ws, bs, targets


def launcher(BM, _build, X, ws, bs, targets, grad):
    """The C entry alone, on buffers made once. This design reads the
    per-layer tensors in place; the first K7 design takes flat [G, C, P]
    weights and a partial row per 128-individual tile (made here, once)."""
    import torch

    from rs_bann_tpu_torch.ops.activations import ACT_CODES

    lib = _build.lib()
    vp = ctypes.c_void_p
    P = M * K + K + K * K + K + K
    stream = vp(_build.stream_ptr(X))
    code = ACT_CODES["tanh"]
    if hasattr(BM, "vg_chains_plan"):
        plan = BM.vg_chains_plan(G, C, M, N, K, K, 1, grad)
        keep, ptrs, strides = BM.chain_instances(targets if grad else None, ws, bs, X.device)
        out = torch.empty(G * C * (N + P + 1) if grad else G * C * N, device=X.device)
        scratch = torch.empty(max(plan["scratch"], 8), dtype=torch.uint8, device=X.device)
        args = (vp(X.data_ptr()), (vp * 6)(*ptrs), (ctypes.c_longlong * 24)(*strides),
                vp(out.data_ptr()), vp(scratch.data_ptr()), plan["scratch"], G, C, M, N, K, K, 1,
                code, int(grad)) + ((0,) if hasattr(BM, "x_bf16") else ()) + (stream,)
        keep += [out, scratch]
    else:
        q = BM.flat_params(ws, bs)
        y = torch.empty((G, C, N), device=X.device)
        partial = torch.empty((G, C, -(-N // 128), P), device=X.device)
        grads = torch.empty((G, C, P), device=X.device)
        args = (vp(X.data_ptr()), vp(targets.data_ptr() if grad else 0), vp(q.data_ptr()),
                vp(y.data_ptr()), vp(partial.data_ptr() if grad else 0),
                vp(grads.data_ptr() if grad else 0), G, C, M, N, K, K, P, 1, code, int(grad),
                stream)
        keep = [q, y, partial, grads]

    def run():
        _build.check(lib.vg_chains_f32(*args), "vg_chains_f32")

    run.buffers = keep  # alive as long as the launcher
    return run


def k6_k8_outputs(BM, TL, X, ws, bs, targets, dev):
    """K6 at L = 1 and 64 and K8 at the flagship's shape: their outputs, to
    compare with another checkout's."""
    import numpy as np
    import torch

    rng = np.random.default_rng(17)

    def like(ts, sc):
        return tuple(torch.from_numpy((rng.standard_normal(a.shape) * sc).astype(np.float32))
                     .to(dev) for a in ts)

    eps_w = tuple(e.abs() for e in like(ws, 1e-3))
    eps_b = tuple(e.abs() for e in like(bs, 1e-3))
    lam_w = tuple(e.abs() + 0.5 for e in like(ws, 1.0))
    lam_b = tuple(torch.zeros_like(b) for b in bs)
    err = torch.from_numpy(rng.uniform(0.5, 1.0, (G, C)).astype(np.float32)).to(dev)
    out = {}
    for steps in (1, 64):
        r = TL.integrate_chains("tanh", X, targets, err, ws, bs, like(ws, 1.0), like(bs, 1.0),
                                eps_w, eps_b, lam_w, lam_b, steps)
        out[f"K6 L={steps}"] = [v for part in r for v in part]
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
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--save")
    ap.add_argument("--compare")
    opts = ap.parse_args()
    sys.path.insert(0, str(Path(opts.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_k7_torch: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from rs_bann_tpu_torch.ops import _build
    from rs_bann_tpu_torch.ops import branch_mlp as BM
    from rs_bann_tpu_torch.ops import leapfrog as TL

    card = smi()
    print(f"{card}; torch {torch.__version__}; rs_bann_tpu_torch from {BM.__file__}")
    t0 = time.perf_counter()
    _build.lib()
    build_s = time.perf_counter() - t0
    log = (_build.BUILD_DIR / "build.log").read_text()
    print(f"build {build_s:.1f} s: " + ", ".join(ln for ln in log.splitlines() if ".cu: " in ln))
    ptx, cur = {}, None
    for line in log.splitlines():  # ptxas -v of K7's kernels
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            cur = name if "vg_chains" in name else None
        elif cur and ("registers" in line or "spill" in line):
            ptx.setdefault(cur, []).append(line.split(":", 1)[-1].strip())
    regs = sorted({ln for lines in ptx.values() for ln in lines})
    print(f"ptxas, {len(ptx)} K7 kernels: " + "; ".join(regs))

    dev = torch.device("cuda")
    X, ws, bs, targets = inputs(BM, dev)
    per, P = G * C * N, M * K + K + K * K + K + K
    res = {"device": card, "build_s": build_s, "ptxas": regs, "cases": {}}
    d64 = lambda ts: tuple(t.double() for t in ts)  # noqa: E731
    ref = BM.data_vg_chains_ref("tanh", X, ws, bs, targets)
    ref64 = BM.data_vg_chains_ref("tanh", X.double(), d64(ws), d64(bs), targets.double())
    flat = lambda r: [r[0], r[1], *r[2], *r[3]]  # noqa: E731
    saved = {}
    for grad in (False, True):
        name = "value and gradient" if grad else "forward"

        def call():
            if grad:
                return flat(BM.data_vg_chains("tanh", X, ws, bs, targets))
            return [BM.forward_chains("tanh", X, ws, bs)]

        got, again = call(), call()
        want, want64 = (flat(ref), flat(ref64)) if grad else ([ref[0]], [ref64[0]])
        y_err = max((got[0].double() - w[0].double()).abs().max().item() for w in (want, want64))
        err, err64 = rel_err(got, want), rel_err(got, want64)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        if not (y_err <= REL_TOL and err <= REL_TOL and err64 <= REL_TOL and same):
            raise AssertionError(f"K7 {name}: y_pred {y_err}, rel err {err}, against f64 "
                                 f"{err64} (tol {REL_TOL}), identical repeat {same}")
        saved[f"K7 {name}"] = got
        fwd = M * K + K * K
        mma = 2 * per * (fwd + (M * K + 2 * K * K) if grad else fwd)
        fmas = (M * K + K * K + K) + ((M * K + 2 * K * K + K) if grad else 0)
        # X, y_pred and the weights; with the gradient the targets, the gradients and rss
        nbytes = 4 * (G * M * N + per + G * C * P + (per + G * C * (P + 1) if grad else 0))
        row = {"tensor_bound_ms": 1e3 * 3 * mma / PEAK_TF32_FLOPS,
               "bytes_bound_ms": 1e3 * nbytes / PEAK_BYTES_S,
               "f32_bound_ms": 1e3 * 2 * per * fmas / PEAK_F32_FLOPS}
        row["bound_ms"] = max(row["tensor_bound_ms"], row["bytes_bound_ms"])
        row["launch_ms"] = cuda_ms(launcher(BM, _build, X, ws, bs, targets, grad))
        row["wrapper_ms"] = cuda_ms(call)
        row["plain_ms"] = cuda_ms(
            (lambda: BM.data_vg_chains_ref("tanh", X, ws, bs, targets)) if grad
            else (lambda: BM.forward_chains_ref("tanh", X, ws, bs)))
        row.update(max_rel_err=err, max_rel_err_f64=err64)
        if hasattr(BM, "vg_chains_plan"):
            plan = row["plan"] = BM.vg_chains_plan(G, C, M, N, K, K, 1, grad)
            # one row per (segment, chain): a segment is a CTA's run over one instance
            nb, ctas = G * plan["chunks"], plan["ctas"]
            items = nb * plan["tiles"]
            cta = lambda x: ((x + 1) * ctas - 1) // items  # noqa: E731
            segs = sum(cta((j + 1) * plan["tiles"] - 1) - cta(j * plan["tiles"]) + 1
                       for j in range(nb))
            row["partial_bytes"] = 4 * segs * plan["cc"] * P if grad else 0
        else:  # a row per (branch, chain, tile of 128)
            row["partial_bytes"] = 4 * G * C * -(-N // 128) * P if grad else 0
        print(f"K7 {name}: launch {row['launch_ms']:.4f} ms, wrapper {row['wrapper_ms']:.4f} ms, "
              f"plain {row['plain_ms']:.3f} ms; bounds: 3xTF32 {row['tensor_bound_ms']:.4f}, "
              f"bytes {row['bytes_bound_ms']:.4f}, f32 {row['f32_bound_ms']:.4f} ms; share of "
              f"the bound {row['bound_ms'] / row['launch_ms']:.3f}; rel err {err:.3e} (f64 "
              f"{err64:.3e}); identical repeat; {row.get('plan', '')} "
              f"partial rows {row.get('partial_bytes', 0) / 1e6:.2f} MB")
        res["cases"][name] = row
    saved.update(k6_k8_outputs(BM, TL, X, ws, bs, targets, dev))
    saved = {k: [v.detach().reshape(-1).cpu() for v in vs] for k, vs in saved.items()}
    if opts.save:
        torch.save(saved, opts.save)
    if opts.compare:
        other = torch.load(opts.compare)
        res["compare"] = {}
        for name, ts in saved.items():
            bits, total = words_differ(ts, other[name])
            worst = rel_err(ts, other[name])
            res["compare"][name] = {"words_differ": bits, "words": total, "max_rel_diff": worst}
            print(f"against {opts.compare}: {name}: {bits} of {total} words differ, worst rel "
                  f"difference {worst:.3e}")
            if name.startswith("K6") and bits:
                raise AssertionError(f"{name}: outputs differ from {opts.compare}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
