#!/usr/bin/env python3
"""Time and profile the PyTorch port's sweeps on one NVIDIA GPU.

    python3 scripts/profile_hybrid_torch.py [--flagship | --gd | --recipe] [--only NAME]
        [--sweeps 3] [--out FILE] [--root DIR]

Without ``--flagship`` the shape is chip_smoke.py's packed one: G = 100
groups of 100 markers, n = 100,000, ridge_ard, identity, depth 0, width 10,
L = 30, the hybrid schedule in blocks of 10. With ``--flagship`` it is the
dense flagship of chip_smoke.py phase 9 (bench.py workload 1): G = 64
groups of 64 markers, n = 4,096, feature-major X, ridge_base, tanh, depth
1, h = s = 32, L = 64, the parallel schedule. Random genotypes and a sparse
linear phenotype made from seed 1. The cases:

  C=4 folded      four chains, every block transition one whole-trajectory
                  call (K5 packed, K6 dense)
  C=1 folded      one chain, the same
  C=1 unfolded    one chain, each branch its own lean transition: K4 per
                  leapfrog step on packed genotypes (L + 2 calls per branch);
                  on dense ones the block's branches batched, one K8b call
                  per step
  C=1 sequential  the sequential schedule, one chain: one K4 (packed) or
                  K8a (flagship) call per branch and leapfrog step, G x (L +
                  1) per sweep; the packed one is the default of
                  ``train-new --packed-genotypes``, the flagship's the JAX
                  bench's self-baseline

For each it prints the milliseconds of ``--sweeps`` sweeps (the first pays
the kernel build and warm-up), the acceptance rate and the kernel
launches per sweep (K2, K4, K5, or K7, K6, K8a, K8b and K8's forward-only
pass). Each case then runs one sweep under torch.profiler and prints its
wall time, the device's kernel time and busy share (kernel time / wall)
and the launches of all kinds; the profiler tables go to ``--out``. In the
packed unfolded and sequential cases and the flagship's sequential one the
profiled sweep also splits its wall time into K4's (K8a's) device time,
the host time inside ``data_vg_packed`` (``data_vg``: the wrapper, its
checks, allocations and launches; a record_function range around each
call), the rest of the HMC step (the transition's host time outside the
wrapper) and the rest of the sweep. ``--only`` runs the cases
whose name holds one of the comma-separated NAMEs. ``--groups``, ``--n`` and ``--device cpu`` shrink
the run for a check without a card (no profile then). ``--root DIR``
imports rs_bann_tpu_torch from another checkout (say the parent commit,
unpacked with ``git archive``), to profile its code in the same call.

With ``--recipe`` the cases are the packed hybrid, C = 4, folded, with the
genome-scale recipe's options (``docs/GENOME_SCALE.md``: dual-averaging
step sizes and mass adaptation at burn-in 1, and per-marker
spike-and-slab at a fixed pi of 0.1 with a warm-up of one sweep), and the
same without ss_markers: the first sweep adapts and keeps every marker in,
the later ones are frozen and draw z. The ss_markers case first times the
branch Grams' one-off formation (``X.form_gram()``) and, in its profiled
sweep, the device shares of the scan kernel and of K9b (its u0).

With ``--gd`` the cases are the trainer's GD warm-start sweep
(``train.gd_warmup_cfg``: gradient descent, at most 20 iterations, each
hybrid block's branches batched, the C = 4 chains one after another) at
the packed shape, identity (K2 forward, K3 backward) and silu (K9a, K9b),
with each case's launches per sweep and, in the profiled sweep, the
backward kernel's share of the device time.
"""

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np


M, L, WIDTH, N_CAUSAL = 100, 30, 10, 500
FLAG_M, FLAG_L, FLAG_WIDTH = 64, 64, 32  # the dense flagship
K4_KERNELS = ("vg_packed", "reduce0", "reduce_partials")  # K4's pass and reduce, any version
K8_KERNELS = ("vg_dense", "reduce_dense")  # K8's pass and reduce, any version
RANGES = ("kernel wrapper", "HMC step")  # record_function ranges of the split
LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel", "cudaLaunchKernelExC",
                "cuLaunchKernel", "cuLaunchKernelEx")


def make_data(G, n, device, flagship=False):
    """Genotypes of G groups of M markers and a sparse linear phenotype at
    h2 = 0.5 (centred), as chip_smoke.py makes them: packed, or with
    ``flagship`` feature-major dense."""
    from rs_bann_tpu_torch.io import BedVM, UniformGrouping
    from rs_bann_tpu_torch.io.genotypes import CompressedGenotypes
    from rs_bann_tpu_torch.models import NetArch
    from rs_bann_tpu_torch.models.data import pack_stacked

    m = FLAG_M if flagship else M
    rng = np.random.default_rng(1)
    bed = BedVM.random(n, G * m, mafs=rng.uniform(0.05, 0.5, G * m), seed=1)
    causal = np.sort(rng.choice(G * m, size=min(N_CAUSAL, G * m), replace=False))
    g = ((bed.get_cols(causal).T - bed.col_means[causal]) / bed.col_stds[causal]) \
        @ rng.standard_normal(causal.size)
    y = (g + g.std() * rng.standard_normal(n))
    y = (y - y.mean()).astype(np.float32)
    if flagship:
        arch = NetArch.from_width_rules([m] * G, 1, ("fixed", FLAG_WIDTH), ("fixed", FLAG_WIDTH),
                                        activation="tanh")
        return arch, CompressedGenotypes(bed, UniformGrouping(G, m)).to_feature_major(
            arch, device, y)
    arch = NetArch.from_width_rules([m] * G, 0, ("fixed", WIDTH), ("fraction_of_hidden", 1.0),
                                    activation="identity")
    return arch, pack_stacked(arch, bed, UniformGrouping(G, m), y, device)


def traced(fn, label):
    """fn inside a torch.profiler range named ``label``."""
    from torch.profiler import record_function

    def wrapped(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)

    return wrapped


def profiled_sweep(torch, sweep, carry, data, gen, out, watch=(), split=None):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        carry, _ = sweep(carry, data.X, data.y, gen)
        torch.cuda.synchronize()
        wall_ms = 1000.0 * (time.perf_counter() - t0)
    avgs = prof.key_averages()

    def self_device_us(a):
        v = getattr(a, "self_device_time_total", None)
        return getattr(a, "self_cuda_time_total", 0.0) if v is None else v

    # the device's own events (kernels, copies, fills): an aten op's row
    # repeats the time of the kernels it launched, so host rows are left out,
    # and so are the device rows of this script's own ranges (RANGES)
    on_device = [a for a in avgs if a.device_type == DeviceType.CUDA and a.key not in RANGES]
    device_ms = sum(self_device_us(a) for a in on_device) / 1000.0
    launches = sum(a.count for a in avgs if a.key in LAUNCH_NAMES)
    sync_ms = sum(a.self_cpu_time_total for a in avgs if a.key == "cudaStreamSynchronize") / 1000.0
    print(f"  profiled sweep: wall {wall_ms:.1f} ms, device time {device_ms:.1f} ms "
          f"({100.0 * device_ms / wall_ms:.1f}% busy), launches {launches}, "
          f"host in cudaStreamSynchronize {sync_ms:.1f} ms")
    by_device = sorted(on_device, key=self_device_us, reverse=True)
    for a in by_device[:3]:
        print(f"  device share: {a.key[:60]} {self_device_us(a) / 1000.0:.1f} ms "
              f"({100.0 * self_device_us(a) / 1000.0 / device_ms:.1f}%), {a.count} calls")
    if split:  # the kernel's device time; host time in its wrapper, the HMC step, the rest
        label, kernels = split
        k4_ms = sum(self_device_us(a) for a in on_device
                    if any(k in a.key for k in kernels)) / 1000.0
        k4_calls = sum(a.count for a in on_device if any(k in a.key for k in kernels))
        host = {a.key: a.cpu_time_total / 1000.0 for a in avgs
                if a.key in RANGES and a.device_type == DeviceType.CPU}
        wrapper_ms, hmc_ms = host.get(RANGES[0], 0.0), host.get(RANGES[1], 0.0)
        print(f"  split: {label} device {k4_ms:.1f} ms ({k4_calls} kernels, "
              f"{100.0 * k4_ms / wall_ms:.1f}% of wall); host in the {label} wrapper "
              f"{wrapper_ms:.1f} ms ({100.0 * wrapper_ms / wall_ms:.1f}%); rest of the HMC step "
              f"{hmc_ms - wrapper_ms:.1f} ms ({100.0 * (hmc_ms - wrapper_ms) / wall_ms:.1f}%); "
              f"rest of the sweep {wall_ms - hmc_ms:.1f} ms; busy {100.0 * device_ms / wall_ms:.1f}%")
    for name in watch:  # kernels whose (mangled) name holds ``name``
        rows = [a for a in on_device if name in a.key]
        ms = sum(self_device_us(a) for a in rows) / 1000.0
        print(f"  device share of {name}: {ms:.1f} ms ({100.0 * ms / device_ms:.1f}%), "
              f"{sum(a.count for a in rows)} calls")
    if out is not None:
        key = ("self_device_time_total" if hasattr(by_device[0], "self_device_time_total")
               else "self_cuda_time_total")
        out.write(avgs.table(sort_by=key, row_limit=25) + "\n")
        out.write(avgs.table(sort_by="self_cpu_time_total", row_limit=15) + "\n")
    return carry


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--flagship", action="store_true",
                    help="the dense flagship (parallel, feature-major) instead of packed hybrid")
    ap.add_argument("--gd", action="store_true",
                    help="the GD warm-start sweep at the packed shape, identity and silu")
    ap.add_argument("--recipe", action="store_true",
                    help="the packed hybrid, C = 4, with the recipe's adaptation and ss_markers")
    ap.add_argument("--sweeps", type=int, default=3)
    ap.add_argument("--groups", type=int, default=None, help="100 packed, 64 flagship")
    ap.add_argument("--n", type=int, default=None, help="100,000 packed, 4,096 flagship")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="file for the profiler tables")
    ap.add_argument("--only", default=None,
                    help="run the cases whose name holds one of these (comma-separated)")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout to import rs_bann_tpu_torch from")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    from rs_bann_tpu_torch.models import density as D
    from rs_bann_tpu_torch.models import net as NM
    from rs_bann_tpu_torch.models.init import InitCfg, init_net
    from rs_bann_tpu_torch.models.net import Net, make_chain_sweep, make_hybrid_sweep
    from rs_bann_tpu_torch.ops import branch_mlp as BM
    from rs_bann_tpu_torch.ops import leapfrog as LF
    from rs_bann_tpu_torch.ops import marker_scan as MS
    from rs_bann_tpu_torch.ops import packed_matmul as PM
    from rs_bann_tpu_torch.samplers import MCMCCfg
    from rs_bann_tpu_torch.train import gd_warmup_cfg, prepare_state_for_training

    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise SystemExit("profile_hybrid_torch: no CUDA device")
        torch.backends.cuda.matmul.allow_tf32 = False
        import subprocess

        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip())
    flag = args.flagship
    G = args.groups or (64 if flag else 100)
    n = args.n or (4096 if flag else 100_000)
    t0 = time.perf_counter()
    arch, data = make_data(G, n, dev, flag)
    print(f"data {time.perf_counter() - t0:.1f} s: G {G}, m {FLAG_M if flag else M}, n {n}")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out = open(args.out, "w") if args.out and on_card else None
    watch = ()
    if flag:
        model, mode, steps = "ridge_base", "parallel", FLAG_L
        kernels = (BM.data_vg_chains, LF.integrate_chains, BM.data_vg, BM.data_vg_blocked,
                   BM.forward_blocked)
        names = "(K7, K6, K8a, K8b, K8 forward-only)"
        cases = [("C=4 folded", "tanh", 4, True), ("C=1 folded", "tanh", 1, True),
                 ("C=1 unfolded", "tanh", 1, False), ("C=1 sequential", "tanh", 1, None)]
    elif args.gd:
        model, mode, steps = "ridge_ard", "hybrid", L
        kernels = (PM.packed_linear, PM.packed_linear_vjp, PM.packed_matmul,
                   PM.packed_matmul_vjp)
        names, watch = "(K2, K3, K9a, K9b)", ("packed_bwd", "packed_linear")
        cases = [("GD warm start identity C=4", "identity", 4, None),
                 ("GD warm start silu C=4", "silu", 4, None)]
    elif args.recipe:
        model, mode, steps = "ridge_ard", "hybrid", L
        kernels = (PM.packed_linear, LF.integrate_chains_packed, PM.packed_matmul_vjp,
                   MS.marker_scan)
        names, watch = "(K2, K5, K9b, scan)", ("marker_scan", "packed_bwd")
        cases = [("C=4 folded recipe ss_markers", "identity", 4, True),
                 ("C=4 folded recipe without ss_markers", "identity", 4, True)]
    else:
        model, mode, steps = "ridge_ard", "hybrid", L
        kernels = (PM.packed_linear, BM.data_vg_packed, LF.integrate_chains_packed)
        names = "(K2, K4, K5)"
        cases = [("C=4 folded", "identity", 4, True), ("C=1 folded", "identity", 1, True),
                 ("C=1 unfolded", "identity", 1, False), ("C=1 sequential", "identity", 1, None)]
    if args.only:
        cases = [c for c in cases if any(o in c[0] for o in args.only.split(","))]
    try:
        for name, act, C, fold in cases:
            sequential = name.endswith("sequential")
            cfg = MCMCCfg(hmc_integration_length=steps, num_chains=C, seed=0,
                          update_mode="sequential" if sequential else mode)
            ssm = name.endswith("recipe ss_markers")
            if args.recipe:
                cfg = dataclasses.replace(
                    cfg, hmc_step_size_mode="dual_averaging", mass_adaptation=True, burn_in=1,
                    ss_markers=ssm, ssm_fixed_pi=True, ssm_pi=0.1, ssm_warmup=1)
            arch = dataclasses.replace(arch, activation=act)
            state, _ = init_net(arch, model, InitCfg(seed=0), device=dev)
            net = prepare_state_for_training(Net(model, arch, D.Hyperparameters(), state), None)
            if args.gd:
                sweep = make_chain_sweep(model, act, arch, gd_warmup_cfg(cfg), net.hyper, dev,
                                         chain_by_chain=True)
            elif sequential:
                sweep = make_chain_sweep(model, act, arch, cfg, net.hyper, dev)
            else:
                sweep = make_hybrid_sweep(model, act, arch, cfg, net.hyper, dev, fold=fold)
            carry = net.init_carry(data.X, data.y, chains=C,
                                   step_size_factor=cfg.hmc_step_size_factor,
                                   mass_adaptation=cfg.mass_adaptation, ss_markers=ssm,
                                   ssm_pi=cfg.ssm_pi)
            if ssm:  # the Grams' one-off formation, kept on the data for the sweeps
                sync()
                t0 = time.perf_counter()
                data.X.form_gram()
                sync()
                print(f"{name}: the branch Grams formed in "
                      f"{1000.0 * (time.perf_counter() - t0):.1f} ms (once per run)")
            gen = torch.Generator(dev).manual_seed(0)
            times, launches = [], []
            for _ in range(args.sweeps):
                for k in kernels:
                    k.launches = 0
                sync()
                t0 = time.perf_counter()
                carry, st = sweep(carry, data.X, data.y, gen)
                sync()
                times.append(1000.0 * (time.perf_counter() - t0))
                launches.append(tuple(k.launches for k in kernels))
            counts = st.counts.sum(dim=0)
            print(f"{name}: ms per sweep {[round(t, 3) for t in times]}, acceptance "
                  f"{int(counts[0]) / int(counts.sum()):.3f}, launches per sweep "
                  f"{names} {launches[-1]}")
            if on_card:
                if out is not None:
                    out.write(f"==== {name}\n")
                # the packed unfolded and sequential cases, the flagship's sequential one
                split = None
                if not (args.gd or fold) and (sequential or not flag):
                    split = ("K8a", K8_KERNELS) if flag else ("K4", K4_KERNELS)
                    wrapper = "data_vg" if flag else "data_vg_packed"
                if split:  # ranges around the kernel's wrapper and the HMC step
                    k4, make_step = getattr(BM, wrapper), NM.make_hmc_step
                    setattr(BM, wrapper, traced(k4, RANGES[0]))
                    getattr(BM, wrapper).launches = 0
                    NM.make_hmc_step = lambda *a, **k: traced(make_step(*a, **k), RANGES[1])
                    sweep = (make_chain_sweep(model, act, arch, cfg, net.hyper, dev)
                             if sequential else
                             make_hybrid_sweep(model, act, arch, cfg, net.hyper, dev, fold=fold))
                try:
                    profiled_sweep(torch, sweep, carry, data, gen, out, watch, split)
                finally:
                    if split:
                        NM.make_hmc_step = make_step
                        setattr(BM, wrapper, k4)
            del carry, sweep, net
    finally:
        if out is not None:
            out.close()


if __name__ == "__main__":
    main()
