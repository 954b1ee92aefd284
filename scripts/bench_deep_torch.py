#!/usr/bin/env python3
"""Parent against change for the packed kernels' deep design
(rs_bann_tpu_torch/csrc/packed_deep.cuh), on one NVIDIA GPU.

    python3 scripts/bench_deep_torch.py [--root DIR] [--save F] [--compare F]

Two parts, every input drawn from a seed, no CLI run and no data files:

1. The main path's outputs, to be compared bit for bit between two
   checkouts: K4 at depth 0 (one branch, m_pad 104, n 100,000, width 10
   stored at 16, identity and tanh), K5 at the hybrid block (depth 0, B 10,
   C 4, width 10 stored at 16, L 30, identity), the marker scan at the block
   (40 instances, m_pad 104, width 16), K6 at the dense flagship (G 64, C 4,
   m 64, h = s = 32, depth 1, n 4,096, tanh, L 8), K7 (value and gradient,
   and forward only) and K8 (one instance, and 32 through an index) there;
   and the packed deep design at depth 2, width 56, tanh (K4 on the branch,
   K5 on the block at L 2), whose hidden-layer code the dense deep design
   (csrc/dense_deep.cuh) shares; and the dense deep design itself there on
   f32 X (B 10, C 4, n 20,000: K6 at L 2, K7 both forms, K8a, K8b on 40
   instances).
2. Depth 1 at width 16 (m_pad 104, n 100,000, identity): K4 on one branch
   and K5 on the block (B 10, C 4, L 30), each held to its plain version
   (REL_TOL; 1e-3 for K5 at L 30), with its CUDA-event time (median of 7,
   K5 of 3), the wrapper's call as the sampler makes it, and the device
   time of its kernels from torch.profiler. A checkout before the deep
   design runs its first f32 kernels there.

  --root DIR   import rs_bann_tpu_torch from DIR: another checkout (the
               parent, unpacked with ``git archive`` into a directory that
               .gitignore lists), on the same inputs
  --save F     write part 1's outputs to F (torch.save)
  --compare F  count the 32-bit words of part 1's outputs that differ from
               F's; exit non-zero if any does
Compare in one call: parent, change, change, parent. The last line is a
JSON object of the numbers.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

REL_TOL, REL_TOL_TRAJ = 1e-4, 1e-3  # as chip_smoke.py
N, M_PAD, B, C, L = 100_000, 104, 10, 4, 30


def cuda_ms(fn, runs=7):
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


def device_ms(fn, calls=3):
    """Device milliseconds per call of fn(), summed over every device op
    (torch.profiler), and the ops' names."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA]

    def us(a):
        v = getattr(a, "self_device_time_total", None)
        return getattr(a, "self_cuda_time_total", 0.0) if v is None else v

    return sum(us(a) for a in rows) / 1e3 / calls, sorted({a.key[:60] for a in rows})


def rel_err(got, want):
    return max((a.double() - b.double()).abs().max().item()
               / max(1.0, b.double().abs().max().item()) for a, b in zip(got, want))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--save")
    ap.add_argument("--compare")
    opts = ap.parse_args()
    sys.path.insert(0, str(Path(opts.root).resolve()))
    import numpy as np
    import torch

    from rs_bann_tpu_torch.models.density import PackedX
    from rs_bann_tpu_torch.ops import _build
    from rs_bann_tpu_torch.ops import branch_mlp as BM
    from rs_bann_tpu_torch.ops import leapfrog as LF
    from rs_bann_tpu_torch.ops import marker_scan as MS

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{smi}; root {opts.root}; library {_build.build().name}")
    rng = np.random.default_rng(0)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a)).to(dev, dtype)

    def packed(nb, m, n):
        """Random bytes [nb, m, ceil(n / 512) * 128] and a standardization."""
        by = t(rng.integers(0, 256, (nb, m, -(-n // 512) * 128)), torch.uint8)
        return by, t(rng.random((nb, m)) + 0.5), t(rng.random((nb, m)) * 2)

    def layers(lead, dims, sc=0.3):
        ws = tuple(t(rng.standard_normal(lead + d) * sc / np.sqrt(d[0])) for d in dims)
        bs = tuple(t(rng.standard_normal(lead + d[1:]) * 0.1) for d in dims[:-1])
        return ws, bs

    out, numbers = {}, {"root": opts.root, "card": smi}

    # ---- 1. the main path's outputs
    by, sc, sh = packed(1, M_PAD, N)
    x = PackedX(by[0], sc[0], sh[0], N)
    ws, bs = layers((), [(M_PAD, 16), (16, 1)])
    ws = (ws[0] * t(np.arange(16) < 10), ws[1] * t(np.arange(16) < 10)[:, None])
    bs = (bs[0] * t(np.arange(16) < 10),)
    target = t(rng.standard_normal(N))
    for act in ("identity", "tanh"):
        y, rss, dws, dbs = BM.data_vg_packed(act, x, ws, bs, target)
        for k, v in enumerate((y, rss) + tuple(dws) + tuple(dbs)):
            out[f"K4 depth 0 {act} {k}"] = v
    by5, sc5, sh5 = packed(B, M_PAD, N)
    w5, b5 = layers((B, C), [(M_PAD, 16), (16, 1)])
    live = t(np.arange(16) < 10)
    w5 = (w5[0] * live, w5[1] * live[:, None])
    b5 = (b5[0] * live,)
    p5 = (tuple(t(rng.standard_normal(w.shape)) * (w != 0) for w in w5),
          tuple(t(rng.standard_normal(b.shape)) * (b != 0) for b in b5))
    eps5 = (tuple(torch.full_like(w, 2e-4) for w in w5), tuple(torch.full_like(b, 2e-4) for b in b5))
    lam5 = (tuple(torch.full_like(w, 1.0) for w in w5), tuple(torch.zeros_like(b) for b in b5))
    tg5, err5 = t(rng.standard_normal((B, C, N))), t(rng.random((B, C)) + 0.5)
    k5 = LF.integrate_chains_packed("identity", by5, sc5, sh5, tg5, err5, w5, b5, *p5, *eps5,
                                    *lam5, L, N)
    for k, v in enumerate(t_ for part in k5 for t_ in part):
        out[f"K5 depth 0 {k}"] = v
    I, m, s = 40, M_PAD, 16
    gram = t(rng.standard_normal((10, m, m)) * 0.1)
    gram = gram @ gram.transpose(1, 2) + 4 * torch.eye(m, device=dev)
    scan_args = (gram, torch.arange(I, device=dev) % 10, t(rng.standard_normal((I, m))),
                 t(rng.standard_normal((I, m, s)) * 0.3), t(rng.standard_normal((I, s))),
                 t(rng.uniform(0.3, 3.0, (I, m, s))), t(rng.uniform(0.5, 2.0, I)),
                 t(rng.uniform(0.1, 0.6, I)), t(np.arange(m) < 100)[None].expand(I, m).contiguous(),
                 t(np.arange(s) < 10)[None].expand(I, s).contiguous(), False,
                 torch.argsort(t(rng.random((I, m))), dim=-1), t(rng.random((I, m))),
                 t(rng.standard_normal((I, m))), t(rng.standard_normal((I, m, s))))
    z, W = MS.marker_scan(*scan_args)
    out["scan z"], out["scan W"] = z, W
    G, FC, FM, FN, FH = 64, 4, 64, 4096, 32
    xT = t(rng.standard_normal((G, FM, FN)))
    fw, fb = layers((G, FC), [(FM, FH), (FH, FH), (FH, 1)])
    fp = layers((G, FC), [(FM, FH), (FH, FH), (FH, 1)], sc=1.0)
    feps = (tuple(torch.full_like(w, 1e-3) for w in fw), tuple(torch.full_like(b, 1e-3) for b in fb))
    flam = (tuple(torch.ones_like(w) for w in fw), tuple(torch.ones_like(b) for b in fb))
    ftg, ferr = t(rng.standard_normal((G, FC, FN))), t(rng.random((G, FC)) + 0.5)
    k6 = LF.integrate_chains("tanh", xT, ftg, ferr, fw, fb, *fp, *feps, *flam, 8)
    for k, v in enumerate(t_ for part in k6 for t_ in part):
        out[f"K6 {k}"] = v
    k7 = BM.data_vg_chains("tanh", xT, fw, fb, ftg)
    for k, v in enumerate((k7[0], k7[1]) + tuple(k7[2]) + tuple(k7[3])):
        out[f"K7 {k}"] = v
    out["K7 forward"] = BM.forward_chains("tanh", xT, fw, fb)
    one = (tuple(w[0, 0] for w in fw), tuple(b[0, 0] for b in fb))
    k8a = BM.data_vg("tanh", xT[0], *one, ftg[0, 0])
    for k, v in enumerate((k8a[0], k8a[1]) + tuple(k8a[2]) + tuple(k8a[3])):
        out[f"K8a {k}"] = v
    ix = torch.arange(32, device=dev, dtype=torch.int32) * 2
    blk = (tuple(w[:32, 0] for w in fw), tuple(b[:32, 0] for b in fb))
    k8b = BM.data_vg_blocked("tanh", xT, ix, *blk, ftg[:32, 0])
    for k, v in enumerate((k8b[0], k8b[1]) + tuple(k8b[2]) + tuple(k8b[3])):
        out[f"K8b {k}"] = v
    # the packed deep design at depth 2, width 56 (its hidden layers are the
    # code the dense deep design shares): K4 on one branch, K5 on the block
    dims = [(M_PAD, 56), (56, 56), (56, 56), (56, 1)]
    dw, db = layers((), dims)
    k4d = BM.data_vg_packed("tanh", x, dw, db, target)
    for k, v in enumerate((k4d[0], k4d[1]) + tuple(k4d[2]) + tuple(k4d[3])):
        out[f"K4deep {k}"] = v
    dw5, db5 = layers((B, C), dims)
    dp5 = layers((B, C), dims, sc=1.0)
    deps5 = (tuple(torch.full_like(w, 2e-4) for w in dw5),
             tuple(torch.full_like(b, 2e-4) for b in db5))
    dlam5 = (tuple(torch.ones_like(w) for w in dw5), tuple(torch.zeros_like(b) for b in db5))
    k5d = LF.integrate_chains_packed("tanh", by5, sc5, sh5, tg5, err5, dw5, db5, *dp5, *deps5,
                                     *dlam5, 2, N)
    for k, v in enumerate(t_ for part in k5d for t_ in part):
        out[f"K5deep {k}"] = v
    # the dense deep design at depth 2, width 56 on f32 X (csrc/dense_deep.cuh):
    # K6 on the block at L 2, K7 (both forms), K8a, and K8b on 40 instances
    ND = 20_000
    xd = t(rng.standard_normal((B, M_PAD, ND)))
    ddw, ddb = layers((B, C), dims)
    ddp = layers((B, C), dims, sc=1.0)
    ddeps = (tuple(torch.full_like(w, 2e-4) for w in ddw),
             tuple(torch.full_like(b, 2e-4) for b in ddb))
    ddlam = (tuple(torch.ones_like(w) for w in ddw), tuple(torch.zeros_like(b) for b in ddb))
    dtg, derr = t(rng.standard_normal((B, C, ND))), t(rng.random((B, C)) + 0.5)
    k6d = LF.integrate_chains("tanh", xd, dtg, derr, ddw, ddb, *ddp, *ddeps, *ddlam, 2)
    for k, v in enumerate(t_ for part in k6d for t_ in part):
        out[f"K6deep {k}"] = v
    k7d = BM.data_vg_chains("tanh", xd, ddw, ddb, dtg)
    for k, v in enumerate((k7d[0], k7d[1]) + tuple(k7d[2]) + tuple(k7d[3])):
        out[f"K7deep {k}"] = v
    out["K7deep forward"] = BM.forward_chains("tanh", xd, ddw, ddb)
    k8ad = BM.data_vg("tanh", xd[0], tuple(w[0, 0] for w in ddw), tuple(b[0, 0] for b in ddb),
                      dtg[0, 0])
    for k, v in enumerate((k8ad[0], k8ad[1]) + tuple(k8ad[2]) + tuple(k8ad[3])):
        out[f"K8adeep {k}"] = v
    ixd = (torch.arange(B * C, device=dev) % B).to(torch.int32)
    k8bd = BM.data_vg_blocked("tanh", xd, ixd, tuple(w.reshape((B * C,) + w.shape[2:]) for w in ddw),
                              tuple(b.reshape((B * C,) + b.shape[2:]) for b in ddb),
                              dtg.reshape(B * C, ND))
    for k, v in enumerate((k8bd[0], k8bd[1]) + tuple(k8bd[2]) + tuple(k8bd[3])):
        out[f"K8bdeep {k}"] = v
    torch.cuda.synchronize()
    saved = {k: v.detach().reshape(-1).float().cpu() for k, v in out.items()}
    if opts.save:
        torch.save(saved, opts.save)
    differ = None
    if opts.compare:
        ref = torch.load(opts.compare)
        differ = {}
        for k, v in saved.items():
            differ[k] = int((v.view(torch.int32) != ref[k].view(torch.int32)).sum())
        by_kernel = {}
        for k, d in differ.items():
            name = k.split()[0]
            by_kernel[name] = by_kernel.get(name, 0) + d
        total = {name: sum(v.numel() for k, v in saved.items() if k.split()[0] == name)
                 for name in by_kernel}
        print("words that differ from " + opts.compare + ": "
              + ", ".join(f"{k} {d} of {total[k]}" for k, d in by_kernel.items()))
        numbers["words_differ"] = by_kernel

    # ---- 2. depth 1 at width 16: K4 on one branch, K5 on the block
    ws1, bs1 = layers((), [(M_PAD, 16), (16, 16), (16, 1)])
    got = BM.data_vg_packed("identity", x, ws1, bs1, target)
    wf = (x.w_scale[:, None] * ws1[0],) + ws1[1:]
    bf = (bs1[0] - x.shift @ wf[0],) + bs1[1:]
    y_ref, dws_ref, dbs_ref = BM.data_vg_packed_ref("identity", x.bytes, target, wf, bf, N)
    dW0 = x.w_scale[:, None] * dws_ref[0] - (x.shift * x.w_scale)[:, None] * dbs_ref[0]
    k4_err = rel_err((got[0],) + tuple(got[2]) + tuple(got[3]),
                     (y_ref, dW0) + tuple(dws_ref[1:]) + tuple(dbs_ref))
    k4_ms = cuda_ms(lambda: BM.data_vg_packed("identity", x, ws1, bs1, target))
    k4_dev, k4_ops = device_ms(lambda: BM.data_vg_packed("identity", x, ws1, bs1, target))
    print(f"K4 depth 1 width 16 (m_pad {M_PAD}, n {N}): wrapper {k4_ms:.4f} ms, device "
          f"{k4_dev:.4f} ms ({k4_ops}), against the plain version {k4_err:.2e}")
    w51, b51 = layers((B, C), [(M_PAD, 16), (16, 16), (16, 1)])
    p51 = layers((B, C), [(M_PAD, 16), (16, 16), (16, 1)], sc=1.0)
    eps51 = (tuple(torch.full_like(w, 1e-4) for w in w51),
             tuple(torch.full_like(b, 1e-4) for b in b51))
    lam51 = (tuple(torch.ones_like(w) for w in w51), tuple(torch.zeros_like(b) for b in b51))
    args = (by5, sc5, sh5, tg5, err5, w51, b51, *p51, *eps51, *lam51, L, N)
    k5d = LF.integrate_chains_packed("tanh", *args)
    k5_ref = LF.integrate_chains_packed_ref("tanh", *args)
    k5_err = rel_err([t_ for part in k5d for t_ in part], [t_ for part in k5_ref for t_ in part])
    del k5_ref
    k5_ms = cuda_ms(lambda: LF.integrate_chains_packed("tanh", *args), runs=3)
    k5_dev, k5_ops = device_ms(lambda: LF.integrate_chains_packed("tanh", *args), calls=1)
    print(f"K5 depth 1 width 16 (B {B}, C {C}, L {L}, tanh): {k5_ms:.3f} ms, device "
          f"{k5_dev:.3f} ms ({k5_ops}), against the plain version {k5_err:.2e}")
    numbers.update({"k4_depth1_ms": k4_ms, "k4_depth1_device_ms": k4_dev, "k4_depth1_err": k4_err,
                    "k5_depth1_ms": k5_ms, "k5_depth1_device_ms": k5_dev, "k5_depth1_err": k5_err})
    print(json.dumps(numbers))
    if k4_err > REL_TOL or k5_err > REL_TOL_TRAJ:
        raise SystemExit("a kernel disagrees with its plain version")
    if differ and any(differ.values()):
        raise SystemExit("the main path's outputs moved")


if __name__ == "__main__":
    main()
