#!/usr/bin/env python3
"""K5 (rs_bann_tpu_torch/csrc/traj_packed.cu) on one packed hybrid block at
the main path's shape, on one NVIDIA GPU: the quick loop for work on K5.

    python3 scripts/bench_k5_torch.py [--root DIR] [--save F] [--compare F]

The inputs come from a seed, with no CLI run and no data files: B = 10
branches of m = 100 markers (m_pad = 104), C = 4 chains, n = 100,000
individuals. Genotypes are drawn on the card (per-marker allele
frequencies 0.05-0.5) and packed in the group-strided layout, bytes uint8
[10, 104, 25088]; each marker is standardized by its mean and standard
deviation, padded markers have scale 0. The net is ridge_ard, identity,
depth 0, width 10 padded to 16: init_net's state, the masks, izmailov step
sizes and precisions at the means of their first Gibbs conditionals, as in
chip_smoke.py phase 5 and on the folded path: the padded columns have zero
weights and momenta (their step sizes are not zero).

It builds the kernels, holds K5 against ``integrate_chains_packed_ref`` at
L = 1 (REL_TOL) and L = 30 (REL_TOL_TRAJ), each with a bit-identical
repeat, checks at L = 30 that the same live columns stored at width 10 give
the same bits as stored at 16, and prints K5's CUDA-event median of 7, the
plain version's, the bound on the live work, the share of the f32 peak,
the chains per chunk (CC) and resident blocks per SM the launch uses, and
the registers and spills of traj_packed.cu's kernels from build.log.

  --root DIR   import rs_bann_tpu_torch from DIR: another checkout (say the
               parent commit, unpacked with ``git archive`` into a directory
               that .gitignore lists), to time its K5 on the same inputs
  --save F     write K5's L = 30 outputs to F (torch.save)
  --compare F  compare them with those another run saved: identical bits
               expected, else agreement within REL_TOL_TRAJ
The last line is a JSON object of the numbers.
"""

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

B, C, M, N, WIDTH, L = 10, 4, 100, 100_000, 10, 30
RUNS = 7
PEAK_F32_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12  # H100 SXM, as chip_smoke.py
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


def rel_err(got, ref):
    return (got - ref).abs().max().item() / max(1.0, ref.abs().max().item())


def genotypes(dev, gen):
    """Packed bytes [B, m_pad, Bytes], w_scale and shift [B, m_pad], and a
    phenotype [n] of chip_smoke.py's scale: h2 = 0.5 over 100 groups with
    500 causal markers, of which this block's 10 groups hold 50 (the other
    groups' genetic variance joins the noise)."""
    import torch

    m_pad, groups = -(-M // 8) * 8, -(-N // 512)
    freq = 0.05 + 0.45 * torch.rand((B, M, 1), device=dev, generator=gen)
    geno = sum((torch.rand((B, M, N), device=dev, generator=gen) < freq).to(torch.uint8)
               for _ in range(2))  # 0, 1, 2 copies
    mean = geno.float().mean(-1)
    sd = geno.float().std(-1, unbiased=False)
    causal = torch.randperm(B * M, device=dev, generator=gen)[:50]
    x_c = (geno.reshape(B * M, N)[causal].float() - mean.reshape(-1)[causal, None]) \
        / sd.reshape(-1)[causal, None]
    g = torch.randn(50, device=dev, generator=gen) @ x_c
    y = g + (950.0 ** 0.5) * torch.randn(N, device=dev, generator=gen)
    del x_c
    code = torch.tensor([3, 2, 0], dtype=torch.uint8, device=dev)[geno.long()]  # 0->11, 1->10, 2->00
    codes = torch.full((B, m_pad, groups * 512), 1, dtype=torch.uint8, device=dev)  # 01: none
    codes[:, :M, :N] = code
    del geno, code
    q = codes.reshape(B, m_pad, groups, 4, 128)
    by = (q[:, :, :, 0] | (q[:, :, :, 1] << 2) | (q[:, :, :, 2] << 4) | (q[:, :, :, 3] << 6))
    scale = torch.zeros((B, m_pad), device=dev)
    shift = torch.zeros((B, m_pad), device=dev)
    scale[:, :M], shift[:, :M] = 1.0 / sd, mean
    return by.reshape(B, m_pad, groups * 128).contiguous(), scale, shift, y


def block(dev, gen):
    """(bytes, w_scale, shift, targets, err, weights, biases, p_w, p_b,
    eps_w, eps_b, lam_w, lam_b) of one hybrid block, every chain from the
    same start."""
    import torch

    from rs_bann_tpu_torch.models import NetArch
    from rs_bann_tpu_torch.models import params as P
    from rs_bann_tpu_torch.models.init import InitCfg, init_net
    from rs_bann_tpu_torch.samplers import MCMCCfg
    from rs_bann_tpu_torch.samplers import hmc as H

    by, scale, shift, y = genotypes(dev, gen)
    arch = NetArch.uniform(B, M, WIDTH, 0, activation="identity")
    state, _ = init_net(arch, "ridge_ard", InitCfg(seed=0), device=dev)

    def chains_of(ts):
        return tuple(t.unsqueeze(1).expand((B, C) + t.shape[1:]).contiguous() for t in ts)

    ws, bs = chains_of(state.params.weights), chains_of(state.params.biases)
    mws, mbs = chains_of(P.weight_masks(arch, dev)), chains_of(P.bias_masks(arch, dev))

    def post_mean(count, ssq):  # Gamma(0.001, 1000) priors
        return (0.001 + count / 2) * 2000.0 / (2.0 + 1000.0 * ssq)

    lam_out = post_mean(float(arch.total_output_weights), (state.params.weights[1] ** 2).sum().item())
    wps = (post_mean(float(WIDTH), (ws[0] ** 2).sum(-1, keepdim=True)),
           torch.full_like(ws[1][..., :1, :], lam_out))
    bps = (post_mean(float(WIDTH), (bs[0] ** 2).sum(-1, keepdim=True)),)
    eps_w, eps_b = H.step_sizes(None, "ridge_ard", MCMCCfg(hmc_integration_length=L),
                                ws, bs, wps, bps, None)
    p_w = tuple(torch.randn(w.shape, device=dev, generator=gen) * m for w, m in zip(ws, mws))
    p_b = tuple(torch.randn(b.shape, device=dev, generator=gen) * m for b, m in zip(bs, mbs))
    targets = y + 0.1 * torch.randn((B, C, N), device=dev, generator=gen)
    err = torch.full((B, C), 1.0 / y.var().item(), device=dev)
    lam_w = tuple(lam.expand_as(w).contiguous() for lam, w in zip(wps, ws))
    lam_b = tuple(torch.zeros_like(b) for b in bs)
    return (by, scale, shift, targets, err, ws, bs, p_w, p_b, eps_w, eps_b, lam_w, lam_b)


def narrow(args, k):
    """The same block with layer 0 stored at width k (the first k columns)."""
    def cut(ts):
        return (ts[0][..., :k].contiguous(), ts[1][..., :k, :].contiguous())

    def cutb(ts):
        return (ts[0][..., :k].contiguous(),)

    out = list(args)
    for ix in (5, 7, 9, 11):
        out[ix] = cut(args[ix])
    for ix in (6, 8, 10, 12):
        out[ix] = cutb(args[ix])
    return tuple(out)


def ptxas(build_log):
    """Registers and spills of each traj_packed_kernel instantiation."""
    found, cur = [], None
    for line in build_log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S*traj_packed_kernel\S*)'", line)
        if m:
            # <KM, CC> (depth 0; <KM, CC, DEEP> and <KM, DEEP> in earlier checkouts)
            t = re.search(r"traj_packed_kernelILi(\d+)E(?:Li(\d+)E)?(?:Lb([01])E)?E", m.group(1))
            cur = ({"km": int(t.group(1)), "cc": int(t.group(2) or 1),
                    "depth": int(t.group(3) or 0)} if t else {"name": m.group(1)})
            found.append(cur)
        elif "Compiling entry function" in line:
            cur = None
        elif cur is not None:
            s = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if s:
                cur["spill_stores"], cur["spill_loads"] = int(s.group(1)), int(s.group(2))
            r = re.search(r"Used (\d+) registers", line)
            if r:
                cur["registers"] = int(r.group(1))
    return found


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--save")
    ap.add_argument("--compare")
    opts = ap.parse_args()
    sys.path.insert(0, str(Path(opts.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_k5_torch: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from rs_bann_tpu_torch.ops import _build
    from rs_bann_tpu_torch.ops import leapfrog as LF

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{smi}; torch {torch.__version__}; rs_bann_tpu_torch from {LF.__file__}")
    t0 = time.perf_counter()
    lib = _build.lib()
    build_s = time.perf_counter() - t0
    log = _build.BUILD_DIR / "build.log"
    print(f"build {build_s:.1f} s: " + ", ".join(
        l for l in log.read_text().splitlines() if ".cu: " in l))
    regs = ptxas(log)
    for r in regs:
        print(f"  traj_packed_kernel {r}")

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    args = block(dev, torch.Generator(dev).manual_seed(9))
    torch.cuda.synchronize()
    print(f"inputs: bytes {tuple(args[0].shape)}, {time.perf_counter() - t0:.1f} s")
    m_pad, k0 = args[0].shape[1], args[5][0].shape[-1]
    k_live = LF.live_width(k0, *(LF.flat_params(args[ix], args[ix + 1]) for ix in (5, 7, 9, 11))
                           ) if hasattr(LF, "live_width") else WIDTH
    km = lib.traj_packed_km(k0, k0, k_live, 0) if hasattr(lib, "traj_packed_km") else 16
    # chains per chunk and resident blocks per SM (checkouts since the
    # launch plan; the occupancy entry before it, since the chunks of
    # chains; one chain at a time and the occupancy API before that)
    if hasattr(LF, "traj_packed_plan"):
        plan = LF.traj_packed_plan(m_pad, k0, k0, k_live, 0, args[0].shape[0], C,
                                   args[0].shape[-1], N)
        cc, per_sm, smem = plan["cc"], plan["ctas_per_sm"], plan["smem"]
    elif hasattr(LF, "traj_packed_occupancy"):
        cc, per_sm, smem = LF.traj_packed_occupancy(m_pad, k0, k0, k_live, 0, C)
    else:
        cc, per_sm, smem = 1, None, None
    print(f"B {B}, C {C}, m_pad {m_pad}, n {N}, width {WIDTH} stored at {k0}: "
          f"k_live {k_live}, KM {km}, CC {cc}, {per_sm} blocks per SM, {smem} bytes of shared "
          f"memory per block")
    for r in regs:
        if r.get("km") == km and r.get("cc") == cc and r.get("depth") == 0:
            print(f"  the launched instantiation: {r}")

    res = {"device": smi, "build_s": build_s, "k_live": k_live, "km": km, "cc": cc,
           "blocks_per_sm": per_sm, "smem": smem, "ptxas": regs}
    for steps, tol in ((1, REL_TOL), (L, REL_TOL_TRAJ)):
        out = LF.integrate_chains_packed("identity", *args, steps, N)
        ref = LF.integrate_chains_packed_ref("identity", *args, steps, N)
        again = LF.integrate_chains_packed("identity", *args, steps, N)
        torch.cuda.synchronize()
        err = max(rel_err(a, b) for o, r in zip(out, ref) for a, b in zip(o, r))
        same = all(torch.equal(a, b) for o, o2 in zip(out, again) for a, b in zip(o, o2))
        if not (err <= tol and same):
            raise AssertionError(f"L={steps}: rel err {err} (tol {tol}), identical repeat {same}")
        ms = cuda_ms(lambda: LF.integrate_chains_packed("identity", *args, steps, N))
        plain_ms = cuda_ms(lambda: LF.integrate_chains_packed_ref("identity", *args, steps, N))
        # the live work: forward and backward of B x C branch MLPs at width
        # k_live over n individuals, at the start and at each of L steps
        fmas = (steps + 1) * B * C * N * 2 * (m_pad * k_live + k_live)
        bound_ms = 1e3 * 2 * fmas / PEAK_F32_FLOPS
        padded_ms = bound_ms * (m_pad * k0 + k0) / (m_pad * k_live + k_live)
        print(f"L={steps}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
              f"(live work; {padded_ms:.3f} on the {k0} stored columns), "
              f"{100 * bound_ms / ms:.1f}% of the f32 peak on the live work "
              f"({100 * padded_ms / ms:.1f}% counted on {k0}); rel err {err:.3e}, "
              f"identical repeat")
        res[f"L{steps}"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "padded_bound_ms": padded_ms, "max_rel_err": err}
        del ref, again

    # the live columns stored at width k_live: the same bits
    k_n = max(k_live, 1)
    out_n = LF.integrate_chains_packed("identity", *narrow(args, k_n), L, N)
    for o, on in zip(out, out_n):
        for a, b in zip(o, on):
            ix = (slice(None),) * (a.dim() - (2 if a.dim() == 4 and a.shape[-1] == 1 else 1))
            if not torch.equal(a[ix + (slice(0, k_n),)], b):
                raise AssertionError(f"stored at {k0} and at {k_n}: the live columns differ")
    print(f"L={L}: the live columns stored at width {k_n} give the same bits")

    names = ("W0", "w_out", "b0", "pW0", "pw_out", "pb0")
    flat = dict(zip(names, (t.cpu() for o in out for t in o)))
    if opts.save:
        torch.save(flat, opts.save)
    if opts.compare:
        other = torch.load(opts.compare)
        worst, bits = 0.0, 0
        for name, t in flat.items():
            o = other[name]
            bits += int((t.view(torch.int32) != o.view(torch.int32)).sum())
            if not torch.equal(t, o):
                worst = max(worst, rel_err(t, o))
        print(f"against {opts.compare}: {bits} words differ in their bits, "
              f"worst rel difference {worst:.3e}")
        res["compare"] = {"bits_differ": bits, "max_rel_diff": worst}
        if worst > REL_TOL_TRAJ:
            raise AssertionError(f"K5's outputs differ from {opts.compare} by {worst}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
