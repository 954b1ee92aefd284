#!/usr/bin/env python3
"""K4 (``data_vg_packed``, csrc/branch_vg_packed.cu) on one case of the card
tests, drawn anew many times in one process on one NVIDIA GPU: how close
each draw comes to the tests' tolerance, and whether the kernel repeats
its bits.

    python3 scripts/repeat_k4_torch.py [--repeats N] [--act identity]

The case is tests/test_torch_cuda_kernels.py's
``test_data_vg_packed_kernel_matches_plain`` at depth 0, m = 104, n =
1,300, k0 = 16, all 16 columns live: its genotypes and weights come from
numpy's seed 1, as the test's do, and its w_scale, shift and target from
torch's global generator, as the test's do (unseeded there); here that
generator is seeded with the repeat's number first, so a draw can be made
again. For every draw and every output (y, rss, dW0, w_out, b0) it prints
the largest difference from the plain version, in f32 and in f64, over the
test's tolerance (1e-4 of max(1, the largest entry); above 1 fails), and
whether a second launch gave the same bits. The last line is a JSON object
of the numbers.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CASE = (0, 104, 1300, 16, 16)  # depth, m, n, k0, live
TOL = 1e-4


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=300)
    ap.add_argument("--act", default="identity")
    opts = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("repeat_k4_torch: needs a CUDA device")
    import test_torch_cuda_kernels as T
    from rs_bann_tpu_torch.ops import branch_mlp as BM

    dev = torch.device("cuda")
    names = ("y", "rss", "dW0", "w_out", "b0")
    rows = []
    for seed in range(opts.repeats):
        torch.manual_seed(seed)
        x, ws, bs, target = T._k4_inputs(np.random.default_rng(1), *CASE, dev)
        y, rss, dws, dbs = BM.data_vg_packed(opts.act, x, ws, bs, target)
        again = BM.data_vg_packed(opts.act, x, ws, bs, target)
        got = (y, rss.reshape(1)) + tuple(dws) + tuple(dbs)
        same = all(torch.equal(a, b) for a, b in
                   zip(got, (again[0], again[1].reshape(1)) + tuple(again[2]) + tuple(again[3])))
        row = {"seed": seed, "same_bits": same}
        for dtype in (torch.float32, torch.float64):
            s, sh, t = (v.to(dtype) for v in (x.w_scale, x.shift, target))
            wf = (s[:, None] * ws[0].to(dtype),) + tuple(w.to(dtype) for w in ws[1:])
            bf = (bs[0].to(dtype) - sh @ wf[0],) + tuple(b.to(dtype) for b in bs[1:])
            y_ref, dws_ref, dbs_ref = BM.data_vg_packed_ref(opts.act, x.bytes, t, wf, bf, x.n)
            rss_ref = torch.sum((y_ref - t) ** 2).reshape(1)
            dws_ref = (s[:, None] * dws_ref[0] - (sh * s)[:, None] * dbs_ref[0],) + dws_ref[1:]
            ref = (y_ref, rss_ref) + tuple(dws_ref) + tuple(dbs_ref)
            for name, a, b in zip(names, got, ref):
                # y: the test's atol 1e-4; the others relative to max(1, the largest entry)
                scale = 1.0 if name == "y" else max(b.abs().max().item(), 1.0)
                err = (a.to(dtype) - b).abs().max().item()
                row[f"{name}_{'f32' if dtype == torch.float32 else 'f64'}"] = err / (TOL * scale)
        rows.append(row)
        worst = max(v for k, v in row.items() if k not in ("seed", "same_bits"))
        if worst > 1 or not same:
            print(f"seed {seed}: over the tolerance or not repeated: {row}", flush=True)
    keys = [k for k in rows[0] if k not in ("seed", "same_bits")]
    summary = {k: max(r[k] for r in rows) for k in keys}
    failing = [r["seed"] for r in rows
               if not r["same_bits"] or max(r[k] for k in keys) > 1]
    print(f"{opts.act} d0_m104_n1300_k16_live16, {opts.repeats} draws: largest error over the "
          f"tolerance per output {summary}; draws over it or not repeated: {failing}")
    print(json.dumps({"act": opts.act, "repeats": opts.repeats, "worst": summary,
                      "failing_seeds": failing, "rows": rows}))


if __name__ == "__main__":
    main()
