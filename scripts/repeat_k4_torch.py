#!/usr/bin/env python3
"""K4 (``data_vg_packed``, csrc/branch_vg_packed.cu) on one case of the card
tests, drawn anew many times in one process on one NVIDIA GPU: how close
each draw comes to the tests' tolerance, and whether the kernel repeats
its bits.

    python3 scripts/repeat_k4_torch.py [--repeats N | --seeds S ...] [--act identity]

The case is tests/test_torch_cuda_kernels.py's
``test_data_vg_packed_kernel_matches_plain`` at depth 0, m = 104, n =
1,300, k0 = 16, all 16 columns live: its genotypes and weights come from
numpy's seed 1, as the test's do, and its w_scale, shift and target from
torch's global generator, as the test's do (unseeded there); here that
generator is seeded with the draw's number first (0 .. N - 1, or the
given seeds), so a draw can be made again. For every draw and every output
(y, rss, dW0, w_out, b0) it prints three distances over the test's
tolerance (1e-4 of max(1, the largest entry of the reference); y's is an
absolute 1e-4): K4 from the plain version in f32 (``_f32``), K4 from the
plain version in f64 (``_f64``), and the f32 plain version from the f64
one (``plain_f64``); and whether a second launch gave the same bits. A
draw fails as the test's check (``_k4_check``) fails: K4 more than the
tolerance from f64, y or rss more than it from the f32 plain version, a
gradient further from f64 than the f32 plain version is plus the
tolerance, or bits that do not repeat. The last line is a JSON object of
the numbers.
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
    ap.add_argument("--seeds", type=int, nargs="+", help="these draws instead of 0 .. N - 1")
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
    seeds = opts.seeds if opts.seeds else range(opts.repeats)
    for seed in seeds:
        torch.manual_seed(seed)
        x, ws, bs, target = T._k4_inputs(np.random.default_rng(1), *CASE, dev)
        y, rss, dws, dbs = BM.data_vg_packed(opts.act, x, ws, bs, target)
        again = BM.data_vg_packed(opts.act, x, ws, bs, target)
        got = (y, rss.reshape(1)) + tuple(dws) + tuple(dbs)
        same = all(torch.equal(a, b) for a, b in
                   zip(got, (again[0], again[1].reshape(1)) + tuple(again[2]) + tuple(again[3])))
        row, refs = {"seed": seed, "same_bits": same}, {}
        for dtype in (torch.float32, torch.float64):
            s, sh, t = (v.to(dtype) for v in (x.w_scale, x.shift, target))
            wf = (s[:, None] * ws[0].to(dtype),) + tuple(w.to(dtype) for w in ws[1:])
            bf = (bs[0].to(dtype) - sh @ wf[0],) + tuple(b.to(dtype) for b in bs[1:])
            y_ref, dws_ref, dbs_ref = BM.data_vg_packed_ref(opts.act, x.bytes, t, wf, bf, x.n)
            rss_ref = torch.sum((y_ref - t) ** 2).reshape(1)
            dws_ref = (s[:, None] * dws_ref[0] - (sh * s)[:, None] * dbs_ref[0],) + dws_ref[1:]
            refs[dtype] = (y_ref, rss_ref) + tuple(dws_ref) + tuple(dbs_ref)
        for name, a, b, b64 in zip(names, got, refs[torch.float32], refs[torch.float64]):
            # y: the test's atol 1e-4; the others relative to max(1, the largest entry)
            scale = 1.0 if name == "y" else max(b64.abs().max().item(), 1.0)
            scale32 = 1.0 if name == "y" else max(b.abs().max().item(), 1.0)
            row[f"{name}_f32"] = (a - b).abs().max().item() / (TOL * scale32)
            row[f"{name}_f64"] = (a.double() - b64).abs().max().item() / (TOL * scale)
            row[f"{name}_plain_f64"] = (b.double() - b64).abs().max().item() / (TOL * scale)
        rows.append(row)
        if fails(row) or opts.seeds:
            print(f"seed {seed}: {'fails' if fails(row) else 'passes'}: {row}", flush=True)
    keys = [k for k in rows[0] if k not in ("seed", "same_bits")]
    summary = {k: max(r[k] for r in rows) for k in keys}
    failing = [r["seed"] for r in rows if fails(r)]
    print(f"{opts.act} d0_m104_n1300_k16_live16, {len(rows)} draws: largest distance over the "
          f"tolerance per output {summary}; draws that fail: {failing}")
    print(json.dumps({"act": opts.act, "draws": len(rows), "worst": summary,
                      "failing_seeds": failing, "rows": rows}))


def fails(row):
    """The test's rule (``_k4_check``) on one draw's distances."""
    grads = ("dW0", "w_out", "b0")
    return (not row["same_bits"] or max(row[f"{o}_f64"] for o in ("y", "rss") + grads) > 1
            or row["y_f32"] > 1 or row["rss_f32"] > 1
            or any(row[f"{o}_f64"] > row[f"{o}_plain_f64"] + 1 for o in grads))


if __name__ == "__main__":
    main()
