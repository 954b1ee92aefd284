#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rs_bann_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):
  0. require a CUDA device; print the card, its power limit and the versions
  1. build the CUDA kernels from rs_bann_tpu_torch/csrc with nvcc
  2. K2 (packed_linear) against its plain PyTorch version at the slice's
     full shape: bytes [100, 104, 25088], k = 16, n = 100,000; identical
     bits on a repeat; its time, plain time and bound (below)
  3. K4 (data_vg_packed) against its plain version, one branch, same shape:
     depth 0 (the main path's tensor-core kernel) at all five activations
     and depth 1 identity (widths 16, 16 from a seed), each also against the
     plain version run in f64 (max_rel_err_f64), identical bits on a
     repeat; its launch alone (the pass and its reduce, back to back through
     the C entry) beside the wrapper's call, the plain version's time, and
     the bound as K2's (below)
  4. the sequential path end to end through the CLI: train-new
     --packed-genotypes (G = 100 groups of 100 markers, n = 100,000,
     ridge_ard identity depth 0, 2 sequential sweeps of L = 30, one chain)
     then predict on n = 10,000, counting the kernel launches; then the
     card's predictions against the plain version's on the CPU
  5. on one hybrid block at the full shape (B = 10 branches, C = 4 chains,
     n = 100,000): K2 at the hybrid's chain-folded value-pass shape (bytes
     [10, 104, 25088], k = C * 16 stored and C * 10 live) against its plain
     version, with a repeat, its time and bound, and predict_chains on the
     card, uncut and cut to the live width, against the CPU's; then K5
     (integrate_chains_packed) against its plain version, izmailov step
     sizes from the initial state, at L = 1 and L = 30, and the block's
     live columns (width 10 of the 16 stored) stored at width 10: the same
     bits; K5 again on phase 6b's step sizes (each chain and branch its
     dual-averaging factor and mass estimate: per-coordinate, in the fold's
     transposed views, nonzero on the padded columns), L = 1 and 30, the
     padded columns exactly 0; K5's chains per chunk, resident blocks per
     SM and each instantiation's registers and spills (ptxas -v, build.log)
  6. the hybrid path end to end through the CLI: train-new --update-mode
     hybrid --num-chains 4 (blocks of 10, every block transition one K5
     call, 2 sweeps of L = 30; the two value passes of each block one K2
     launch each on the live width, k = 4 x 10), predict on each chain's
     samples, the card's predictions against the CPU's
 6b. the same with the production recipe's adaptation, --step-size-mode
     dual_averaging --mass-adaptation, 2 sweeps at burn-in 1 (the first
     adapts, the second is frozen), each sweep recorded: exactly one K5
     launch and two value-pass K2 launches per block in each sweep (phase
     6's count), the adaptation's state moved by the first sweep and left
     bit for bit by the second, every carry tensor finite, acceptance in
     (0, 1); the adapted factors' range, ms per sweep beside phase 6's,
     predict on each chain's samples against the CPU's; then the kernel
     launches of one sweep (torch.profiler) without the options, with them
     in an adapting sweep and in a frozen one
 6c. phase 6b's run with the recipe's per-marker spike-and-slab,
     --ss-markers --ssm-fixed-pi --ssm-pi 0.1 --ssm-warmup 1 (the first
     sweep keeps every marker in, the second draws z), each sweep recorded:
     exactly one K9b launch (the scan's u0), one marker_scan launch, one K5
     launch and three value-pass K2 launches (the snapshot, the initial
     state after the scan, the final one) per block, the adaptation checks
     of 6b; at least one true marker excluded, every excluded row of each
     chain's saved W0 exactly 0, inclusion_probs with G lists of m PIPs in
     [0, 1] and pi_markers 0.1; predict on each chain's samples against
     the CPU's; ms per sweep beside 6b's and the branch Grams' one-off
     time; then, at the block (C x B = 40 instances, m_pad 104, width 16)
     on the run's final state, the scan's u0 (K9b at k = C with the
     residuals broadcast over the branches, then the standardization)
     against the plain standardized product in f32 and f64, and the scan
     kernel on it against its plain version: z equal but on near ties of
     the plain version in f64 on all but I // 20 instances, W0_new within
     REL_TOL, identical repeats, times beside the plain versions' and the
     scan's bytes bound; and the kernel
     launches (torch.profiler) of a sweep that draws z beside 6b's frozen
     sweep
 6d. phase 6c's run at burn-in 2 (sweeps 1 and 2 adapt, 3 is frozen):
     train-new 3 sweeps straight with --checkpoint-interval 1 (A), 1 sweep
     with a checkpoint (B), and 3 sweeps resumed from B's checkpoint (C):
     C's samples 2 and 3 of every chain, its final checkpoint (the whole
     carry and the generator's state), training_stats and inclusion_probs
     equal to A's bit for bit, each resumed sweep's launches and
     adaptation state A's; the checkpoint's bytes and write ms. Then
     train from A's sample 3 with --perturb-params 0.01 for one sweep, its
     perturbed start against the same command's under --cpu bit for bit;
     branch-r2 and population-effect-sizes on the training set (n =
     100,000) and activations on the test set, each on a models directory
     of one sample, the card's output against --cpu's within REL_TOL of
     max(1, the largest entry), each with its K2 launches (and their
     device time, torch.profiler) and no plain-version call on the card;
     the phase's wall time
  7. the dense flagship (bench.py workload 1: G = 64 groups of 64 markers,
     n = 4,096, ridge_base tanh depth 1, h = s = 32, C = 4 chains):
     K7 (data_vg_chains, feature-major X [64, 64, 4096]) and its
     forward-only instantiation (forward_chains) against their plain
     versions, in f32 and in f64 (max_rel_err_f64), weights from the
     flagship's initial state, each chain's perturbed; identical bits on a
     repeat; each launch alone (the C entry, back to back) beside the
     wrapper's call, the plain version's, and the bound as implemented (the
     products in 3xTF32, as K6's) with the f32 bound beside it
  8. K6 (integrate_chains) against its plain version at the same shape,
     izmailov step sizes from the initial state, at L = 1, 8 and 64;
     identical bits on a repeat; times at L = 1 and 64 beside the bound as
     implemented (3xTF32 at 494.7 TFLOP/s), the f32 bound and X's time read
     once per gradient evaluation, and the launch's grid; then at L = 1 and
     64 on phase 9b's step sizes (per-coordinate, the fold's transposed
     views read in place)
  9. the flagship end to end through the CLI: train-new --feat-major
     --update-mode parallel --num-chains 4 (2 sweeps of L = 64: exactly one
     K6 launch and two K7 launches, snapshot/H0 and Hf, per sweep; no K4 or
     K5), dense predict on each chain's samples, the card's predictions
     against the CPU's
 9b. phase 9's run with the adaptation, as phase 6b: exactly one K6 and two
     K7 launches per sweep, ms per sweep beside phase 9's, the launches of
     one sweep without and with the options
 10. K9a (packed_matmul), K3 (packed_linear_vjp, all four fused
     activations) and K9b (packed_matmul_vjp) against their plain versions
     at the slice's full shape (bytes [100, 104, 25088], k = 16, n =
     100,000; K9a also at the hybrid value pass, bytes [10, 104, 25088],
     k = 64 stored and 40 live; K3 and K9b also at the GD warm start's
     block, bytes [10, 104, 25088]), the cotangent from a seed, K3's saved
     output the plain forward at the perturbed initial state; K3 and K9b
     also against the plain version in f64 (no further from it than the
     f32 plain version, plus REL_TOL); identical bits on a repeat; K3's
     and K9b's bound from the bytes as implemented (the saved output only
     where h' reads it)
 11. identity through the CLI: train-new --update-mode hybrid --num-chains
     4 --gd-warmup 1 (one GD sweep, then 2 sweeps of L = 30): exactly
     chains x blocks x min(L, 20) = 800 K3 launches in the warm start (each
     block's branches batched), K2 for the probes and the value passes (2
     per block), 10 K5 per sweep, no K4, K9a or K9b; then gradients
     --packed-genotypes on chain 0's samples and the test set (one K2 and
     one K3 launch per sample), its JSON against the CPU's (--cpu)
 12. the same with silu: K9a in place of K2 and K9b in place of K3, no K2,
     K3 or K4; predict --packed-genotypes (K9a) and gradients (K9a + K9b),
     each against the CPU's
 13. K8a (data_vg, one flagship branch) and K8b (data_vg_blocked: 4 chains
     x a random block of 8 branches each, X read in place through an
     index; then all 64 branches of one chain) against their plain
     versions at the flagship's shape, weights from its initial state,
     each instance's perturbed; identical bits on a repeat; K8's
     forward-only instantiation against its y_pred; the launch alone (the
     pass and its reduce through the C entry), the wrapper's call, the
     plain version's, and the bound as implemented (the five products in
     3xTF32, three tf32 products per f32 one at 494.7 TFLOP/s) with the f32
     bound beside it
 14. the flagship through the CLI under the sequential schedule, one chain:
     train-new --feat-major (2 sweeps of L = 64: exactly G x (L + 1) x 2 =
     8,320 K8a launches, no other kernel), dense predict, the card's
     predictions against the CPU's
 15. the same with --update-mode hybrid --per-chain-block-perm --num-chains
     4 (each block's 4 x 8 (chain, branch) pairs in one batched lean body:
     exactly blocks x (L + 2) x 2 = 1,056 K8b launches and one forward-only
     K8 launch per block, no other kernel), predict on each chain's samples
The line before the last is a JSON object with each kernel's launches on
its path (phase 4 for K4, 6 for K2 and K5, 9 for K6 and K7, 11 for K3, 12
for K9a and K9b, 14 for K8a, 15 for K8b, 6c for marker_scan; K5's, K2's,
K6's and K7's under the adaptation, phases 6b and 9b, as
adapted_launches; K9b's as the scan's u0 in 6c as ssm_launches, beside
u0's times and error), error against
its plain version (max_abs_err, and max_rel_err: the largest difference
over max(1, largest plain entry), the ratio held to REL_TOL), times (of
the wrapper's call, except K4's, K7's and K8's: the launch alone from
back-to-back launches, the wrapper's call beside it as wrapper_ms; K7's
ms is its forward-only launch, the main path's, its value and gradient
beside it as grad_*), and the bound (the larger of its FLOPs over the
67 TFLOP/s f32 peak and its bytes, each input read once and each output
written once, over 3.35 TB/s; for K2, K9a, K4, K3, K9b, K8a, K8b, K7 and K6 the work as
implemented, three bf16 tensor-core products per f32 one at 989 TFLOP/s
(K8a, K8b, K7 and K6: three tf32 ones at 494.7 TFLOP/s), with the f32 figure
beside it as f32_bound_ms, K2's and K9a's value pass
on the live width as value_pass_*, K3's and K9b's times at the warm
start's block as warm_*); the last line is {"ok": true, "device":
{...}}. The data lives in a temporary directory, removed at the end.
"""

import contextlib
import csv
import ctypes
import io
import json
import logging
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

G, M, N_TRAIN, N_TEST = 100, 100, 100_000, 10_000
# sweeps of each CLI run (2: the phases added with the GD paths fit the
# run's time that way), leapfrog steps per trajectory
CHAIN, L = 2, 30
CHAINS, BLOCK = 4, 10  # the hybrid path: chains, branches per block
N_CAUSAL = 500  # markers with an effect in the simulated phenotype
# the dense flagship (bench.py workload 1)
FG, FM, FN_TRAIN, FN_TEST, FH = 64, 64, 4096, 1024, 32
FL, FCHAINS, FCAUSAL = 64, 4, 256
TIMED_RUNS = 7
# H100 SXM: f32 FMA peak outside the tensor cores, dense bf16 tensor-core
# peak and HBM bandwidth
PEAK_F32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES_S = 67e12, 989e12, 3.35e12
PEAK_TF32_FLOPS = 494.7e12  # dense tf32 tensor-core peak (K8's 3xTF32 products)
# max |kernel - plain| / max(1, max |plain|): both sum in f32 in different
# orders, over <= 104 markers (K2, K4's forward) or n = 100,000 (K4's and
# K5's sums); a 30-step trajectory compounds the differences (K5 at L = 30)
REL_TOL = 1e-4
REL_TOL_TRAJ = 1e-3


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs=TIMED_RUNS):
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


def bound(flop, nbytes):
    """(least ms, what bounds it) for ``flop`` f32 FLOPs and ``nbytes`` moved."""
    ops_ms, bytes_ms = 1e3 * flop / PEAK_F32_FLOPS, 1e3 * nbytes / PEAK_BYTES_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def tc_bound(flop, nbytes):
    """(least ms, what bounds it) of K2 and K9a as implemented: each f32
    product is three bf16 tensor-core products (the exact split), so 3 x
    ``flop`` at the dense bf16 peak, against ``nbytes`` moved."""
    ops_ms, bytes_ms = 3e3 * flop / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_BYTES_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def tf32_bound(flop, nbytes):
    """(least ms, what bounds it) of K8, K7 and K6 as implemented: each f32
    product is three tf32 tensor-core products (3xTF32), so 3 x ``flop`` at
    the dense tf32 peak, against ``nbytes`` moved."""
    ops_ms, bytes_ms = 3e3 * flop / PEAK_TF32_FLOPS, 1e3 * nbytes / PEAK_BYTES_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def mlp_fmas(m, k0, s, depth, grad=True):
    """FMAs of one branch MLP (W0 [m, k0], (W1 [k0, s]), w_out [s]) for one
    individual and one chain: the forward, plus the backward with ``grad``."""
    fwd = m * k0 + (k0 * s if depth else 0) + s
    return fwd + (m * k0 + (2 * k0 * s if depth else 0) + s if grad else 0)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


REL_ERR = {}  # kernel -> worst err / max(1, max |plain|), the ratio check_close gates on


def check_close(kernel, name, got, ref, tol=REL_TOL):
    """Hold one output of ``kernel`` against its plain version: the largest
    difference must be within ``tol`` of max(1, largest plain entry).
    Returns the difference; keeps the worst ratio in REL_ERR."""
    err = (got - ref).abs().max().item()
    scale = max(1.0, ref.abs().max().item())
    print(f"  {name}: max_abs_err {err:.3e} (max |plain| {scale:.3e}, rel {err / scale:.3e})")
    if not err <= tol * scale:
        raise AssertionError(f"{name}: kernel and plain version differ by {err} > {tol} * {scale}")
    REL_ERR[kernel] = max(REL_ERR.get(kernel, 0.0), err / scale)
    return err


def identical(fn, first, what):
    """Raise unless fn() gives the same bits as ``first`` (a tensor or a
    tuple of them)."""
    import torch

    again = fn()
    pairs = zip(first, again) if isinstance(first, tuple) else [(first, again)]
    if not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f"{what}: two calls with the same inputs differ")


def run_cli(cli, argv):
    """Run the port's CLI in-process; returns its standard output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli([str(a) for a in argv])
    return out.getvalue()


ADAPT_ARGS = ["--step-size-mode", "dual_averaging", "--mass-adaptation"]
# the carry's dual-averaging and mass-adaptation state
ADAPT_FIELDS = ("da_log_eps", "da_log_eps_bar", "da_h_bar", "mm_mean", "mm_m2")
LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel", "cudaLaunchKernelExC",
                "cuLaunchKernel", "cuLaunchKernelEx")


def recorded_run(cli, argv, kernels):
    """Run the port's CLI (train-new) with each sweep of the trainer's main
    loop recorded: the launches of each counted wrapper in ``kernels``
    (name -> wrapper) in that sweep, device copies of the adaptation's
    state after it, and the carry. Returns (the last line of standard
    output, the records)."""
    from rs_bann_tpu_torch.models.net import Net

    records = []
    make = Net.make_chain_sweep

    def make_chain_sweep(self, cfg, chain_by_chain=False):
        sweep = make(self, cfg, chain_by_chain)
        if chain_by_chain:  # the GD warm start's sweep
            return sweep

        def recorded(carry, X, y, gen):
            before = {k: w.launches for k, w in kernels.items()}
            carry, st = sweep(carry, X, y, gen)
            records.append({
                "launches": {k: w.launches - before[k] for k, w in kernels.items()},
                "state": {f: getattr(carry, f).clone() for f in ADAPT_FIELDS},
                "carry": carry})
            return carry, st

        return recorded

    Net.make_chain_sweep = make_chain_sweep
    try:
        return run_cli(cli, argv).strip().splitlines()[-1], records
    finally:
        Net.make_chain_sweep = make


def check_adapted(recs, stats, chains, kernels_per_sweep):
    """The checks of an adapted CLI run (2 sweeps, burn-in 1): each sweep's
    launches of each kernel as ``kernels_per_sweep`` says, the first sweep
    moved every branch's dual-averaging state (and the Welford mean), the
    second (frozen) left the adaptation's state bit for bit, every float
    tensor of the final carry is finite, and the acceptance rate is in (0,
    1). Prints the adapted factors' range; returns it."""
    import torch

    from rs_bann_tpu_torch.models.net import _carry_tensors

    if len(recs) != CHAIN:
        raise AssertionError(f"{len(recs)} sweeps recorded, expected {CHAIN}")
    for i, rec in enumerate(recs):
        if rec["launches"] != kernels_per_sweep:
            raise AssertionError(f"sweep {i + 1} launched {rec['launches']}, expected "
                                 f"{kernels_per_sweep}")
    warm, frozen = recs[0]["state"], recs[1]["state"]
    if not bool(torch.all(warm["da_log_eps_bar"] != 0.0)) or not bool(
            torch.any(warm["mm_mean"] != 0.0)):  # log eps started at log(1) = 0
        raise AssertionError("the warm sweep left some branch's adaptation state as it was")
    unchanged = {f: bool(torch.equal(warm[f], frozen[f])) for f in ADAPT_FIELDS}
    print(f"  the frozen sweep left the adaptation's state bit for bit: {unchanged}")
    if not all(unchanged.values()):
        raise AssertionError("the frozen sweep moved the adaptation's state")
    floats = [t for t in _carry_tensors(recs[-1]["carry"]) if t.is_floating_point()]
    if not bool(torch.stack([torch.isfinite(t).all() for t in floats]).all()):
        raise AssertionError("a carry tensor is not finite")
    acc = stats["num_accepted"] / stats["num_samples"]
    if not 0.0 < acc < 1.0:
        raise AssertionError(f"acceptance {acc} is not in (0, 1)")
    eps_bar = torch.exp(warm["da_log_eps_bar"])
    eps = torch.exp(warm["da_log_eps"])
    rng = (float(eps_bar.min()), float(eps_bar.max()))
    print(f"  adapted factors over {chains} chains x {eps_bar.shape[-1]} branches: "
          f"exp(log eps_bar) {rng[0]:.4g}-{rng[1]:.4g}, exp(log eps) "
          f"{float(eps.min()):.4g}-{float(eps.max()):.4g}; Welford state "
          f"{tuple(warm['mm_m2'].shape)}; acceptance {acc:.3f}; all {len(floats)} float carry "
          f"tensors finite")
    return rng


def adapted_step_sizes(model_type, steps, ws, bs, wps, bps, seed):
    """The step sizes of the adapted fold for a block whose per-layer
    tensors are [B, C, ...] (the kernels' layout): each (chain, branch)'s
    dual-averaging factor (exp of U(-2, -1)) and mass estimate (``_mass_std``
    of a Welford M2 of U(0, 0.02) at count 3) computed in the sampler's
    [C, B] storage, handed over as the fold's [B, C] views (not
    contiguous), as hmc.make_transition_batch hands them to K5 and K6."""
    import torch

    from rs_bann_tpu_torch.models.net import _mass_std
    from rs_bann_tpu_torch.samplers import MCMCCfg
    from rs_bann_tpu_torch.samplers.hmc import flatten_wb, step_sizes

    def cb(ts):  # [B, C, ...] -> [C, B, ...] storage
        return tuple(t.transpose(0, 1).contiguous() for t in ts)

    ws, bs, wps, bps = cb(ws), cb(bs), cb(wps), cb(bps)
    gen = torch.Generator(ws[0].device).manual_seed(seed)
    m2 = 0.02 * torch.rand(flatten_wb(ws, bs).shape, generator=gen, device=ws[0].device)
    mass_w, mass_b = _mass_std(model_type, m2, 3.0, wps, bps, ws, bs)
    factors = torch.exp(-1.0 - torch.rand(ws[0].shape[:2], generator=gen, device=ws[0].device))
    cfg = MCMCCfg(hmc_integration_length=steps, hmc_step_size_mode="dual_averaging",
                  mass_adaptation=True)
    eps_w, eps_b = step_sizes(None, model_type, cfg, ws, bs, wps, bps, None, factors, mass_w,
                              mass_b)
    return tuple(t.transpose(0, 1) for t in eps_w), tuple(t.transpose(0, 1) for t in eps_b)


def device_launches(fn):
    """fn()'s result and the kernel launches it made, counted by
    torch.profiler as the runtime's launch calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, sum(a.count for a in prof.key_averages() if a.key in LAUNCH_NAMES)


def sweep_launches(argv, model_type, arch, state, X, y, chains, blocks):
    """Kernel launches per sweep of the configuration ``argv`` (train-new's
    arguments, parsed as the CLI parses them) without and with
    ``ADAPT_ARGS`` (burn-in 1): the unadapted sweep, the adapted one that
    adapts and the adapted one after it (frozen), each on a fresh carry
    from ``state`` after one unprofiled sweep of the unadapted
    configuration. Prints them and each one's difference per block from
    the unadapted sweep; returns the three counts and that difference of
    the adapting sweep."""
    import torch

    from rs_bann_tpu_torch.cli.args import mcmc_cfg_from_args
    from rs_bann_tpu_torch.cli.main import build_parser
    from rs_bann_tpu_torch.models import density as D
    from rs_bann_tpu_torch.models.net import Net
    from rs_bann_tpu_torch.train import prepare_state_for_training

    counts = []
    for extra in ([], ADAPT_ARGS):
        cfg = mcmc_cfg_from_args(build_parser().parse_args([str(a) for a in argv + extra]),
                                 os.devnull)
        net = prepare_state_for_training(Net(model_type, arch, D.Hyperparameters(), state), None)
        carry = net.init_carry(X, y, chains=chains, step_size_factor=cfg.hmc_step_size_factor,
                               mass_adaptation=cfg.mass_adaptation)
        sweep = net.make_chain_sweep(cfg)
        gen = torch.Generator(X.xT.device if isinstance(X, D.FeatX) else X.bytes.device)
        gen.manual_seed(3)
        if not extra:
            sweep(net.init_carry(X, y, chains=chains), X, y, gen)  # unprofiled first sweep
        for _ in range(1 if not extra else 2):
            (carry, _), n = device_launches(lambda: sweep(carry, X, y, gen))
            counts.append(n)
    plain, warm, frozen = counts
    if not min(counts) > 0:
        raise AssertionError(f"torch.profiler saw no kernel launches in a sweep: {counts}")
    extra_per_block = (warm - plain) / blocks
    print(f"  kernel launches per sweep (torch.profiler): unadapted {plain}, adapting {warm} "
          f"({extra_per_block:+.1f} per block of {blocks}), frozen {frozen} "
          f"({(frozen - plain) / blocks:+.1f} per block)")
    return {"plain": plain, "adapting": warm, "frozen": frozen,
            "adapting_extra_per_block": extra_per_block}


SSM_ARGS = ["--ss-markers", "--ssm-fixed-pi", "--ssm-pi", "0.1", "--ssm-warmup", "1"]


def scan_block_check(X, carry, arch, ixs):
    """The marker scan's two device steps at the main path's block against
    their plain versions: the C x B (chain, branch) instances of the
    branches ``ixs`` at the state of ``carry`` (a hybrid carry after a run
    with ss_markers). First u0 = X_b^T e, one K9b launch on the block's
    bytes with the chains' residuals broadcast over the branches (k = C),
    then the standardization (``D.marker_u0``), against the plain
    standardized product ((decode - shift) * w_scale) @ e in f32 and in f64
    (no further from f64 than the f32 plain version, plus REL_TOL), with an
    identical repeat and both times. Then the scan kernel on that u0, the
    ridge slab precisions from the carry's row precisions (broadcast over
    the columns, read in place) and draws from a seed: z must agree but on
    near ties (``scan_ties``), on at least I - max(1, I // 20) instances,
    W0_new within REL_TOL of the largest entry on those, and a repeat give
    the same bits. Returns the times of both steps and of their plain
    versions, the errors, the near ties and the scan's bound (the bytes the
    kernel reads and writes: the block's B Grams once, its inputs and draws
    at their stored size, the outputs once; the operations are a few per
    byte). The comparison's launches are not counted."""
    import torch

    from rs_bann_tpu_torch.models import density as D
    from rs_bann_tpu_torch.models import params as P
    from rs_bann_tpu_torch.ops import marker_scan as MS
    from rs_bann_tpu_torch.ops import packed_matmul as PM

    dev = X.bytes.device
    C, B = carry.residual.shape[0], ixs.numel()
    I, m, s = C * B, arch.m_pad, arch.layer_out_pad(0)
    k9b_before, scan_before = PM.packed_matmul_vjp.launches, MS.marker_scan.launches

    x_b, e = X[ixs], carry.residual.transpose(0, 1)  # [n, C], as the sweep hands it
    u0_fn = lambda: D.marker_u0(x_b, e)  # noqa: E731

    def u0_plain(dtype):
        xs = (PM.unpack_strided(x_b.bytes, x_b.n).to(dtype) - x_b.shift[..., None].to(dtype)) \
            * x_b.w_scale[..., None].to(dtype)
        return xs @ e.to(dtype)

    u0 = u0_fn()
    identical(u0_fn, u0, "marker_u0 (K9b) at the block")
    u0_ref, u0_64 = u0_plain(torch.float32), u0_plain(torch.float64)
    u0_err = check_close("packed_matmul_vjp", f"u0 = X_b^T e at the block (K9b at k = {C}, "
                         f"broadcast over {B} branches, then the standardization)", u0, u0_ref)
    plain64 = (u0_ref.double() - u0_64).abs().max().item() / max(1.0, u0_64.abs().max().item())
    check_close("packed_matmul_vjp f64", f"u0 at the block (f64; the f32 plain version "
                f"{plain64:.3e})", u0.double(), u0_64, tol=plain64 + REL_TOL)
    del u0_ref, u0_64
    u0_ms = cuda_ms(u0_fn)
    u0_plain_ms = cuda_ms(lambda: u0_plain(torch.float32), runs=3)

    gen = torch.Generator(dev).manual_seed(6)
    w, lam = carry.state.params.weights, carry.state.precisions.weights[0]
    gix = ixs.repeat(C)
    eta = torch.clamp(lam[:, ixs, :, 0].reshape(I, m), 1e-6, 1e12)[..., None].expand(I, m, s)
    args = (X.gram, gix, u0.permute(2, 0, 1).reshape(I, m),
            w[0][:, ixs].reshape(I, m, s), w[1][:, ixs, :, 0].reshape(I, s), eta,
            carry.state.precisions.error.repeat_interleave(B),
            carry.ssm_pi.repeat_interleave(B),
            D.branch_statics(arch, dev).row_masks[0][gix, :, 0], P.bias_masks(arch, dev)[0][gix],
            False, torch.argsort(torch.rand((I, m), generator=gen, device=dev), dim=-1),
            torch.rand((I, m), generator=gen, device=dev),
            torch.randn((I, m), generator=gen, device=dev),
            torch.randn((I, m, s), generator=gen, device=dev))
    args = tuple(a.contiguous() if isinstance(a, torch.Tensor) and a is not eta else a
                 for a in args)
    z, W = MS.marker_scan(*args)
    identical(lambda: MS.marker_scan(*args), (z, W), "marker_scan")
    z_ref, W_ref = MS.marker_scan_ref(*args)
    f64 = [a.double() if isinstance(a, torch.Tensor) and a.is_floating_point() else a
           for a in args]
    p64 = MS.marker_scan_ref(*f64, probs=True)[2]
    same, ties = MS.scan_ties(z, z_ref, args[11], args[12], p64)
    if int(same.sum()) < I - max(1, I // 20):
        raise AssertionError(f"marker_scan: z agrees on {int(same.sum())} of {I} instances "
                             f"({ties} near ties)")
    same = same.to(dev)
    err = check_close("marker_scan", f"W0_new ({int(same.sum())} of {I} instances, {ties} near "
                      f"ties)", W[same], W_ref[same])
    if not torch.all(W[z == 0] == 0):
        raise AssertionError("the scan kernel left an excluded row nonzero")
    ms = cuda_ms(lambda: MS.marker_scan(*args))
    plain_ms = cuda_ms(lambda: MS.marker_scan_ref(*args), runs=3)
    PM.packed_matmul_vjp.launches, MS.marker_scan.launches = k9b_before, scan_before
    gram_bytes = B * m * m * 4  # the block's B Grams, each read by C instances
    moved = gram_bytes + nbytes(*(a for a in args[1:] if isinstance(a, torch.Tensor)
                                  and a is not eta), z, W) + I * m * 4  # eta: [I, m] in place
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err, "near_ties": ties,
            "bound": bound(0.0, moved), "us_per_marker": 1e3 * ms / m, "instances": I,
            "markers": m, "u0_ms": u0_ms, "u0_plain_ms": u0_plain_ms, "u0_max_abs_err": u0_err}


def ssm_sweep_launches(argv, arch, state, X, y, chains):
    """Kernel launches (torch.profiler) of one sweep of ``argv`` (train-new's
    arguments, with ss_markers), the second of a fresh carry from
    ``state`` on ``X`` (its Grams formed): the first keeps every marker in
    (warm-up 1), the second draws z."""
    import torch

    from rs_bann_tpu_torch.cli.args import mcmc_cfg_from_args
    from rs_bann_tpu_torch.cli.main import build_parser
    from rs_bann_tpu_torch.models import density as D
    from rs_bann_tpu_torch.models.net import Net
    from rs_bann_tpu_torch.train import prepare_state_for_training

    cfg = mcmc_cfg_from_args(build_parser().parse_args([str(a) for a in argv]), os.devnull)
    net = prepare_state_for_training(Net("ridge_ard", arch, D.Hyperparameters(), state), None)
    carry = net.init_carry(X, y, chains=chains, step_size_factor=cfg.hmc_step_size_factor,
                           mass_adaptation=cfg.mass_adaptation, ss_markers=True,
                           ssm_pi=cfg.ssm_pi)
    sweep = net.make_chain_sweep(cfg)
    gen = torch.Generator(X.bytes.device).manual_seed(3)
    carry, _ = sweep(carry, X, y, gen)
    (carry, _), n = device_launches(lambda: sweep(carry, X, y, gen))
    return n


# phase 6d: burn-in 2, so sweeps 1 and 2 adapt (the checkpoint falls
# between them) and sweep 3 is frozen
RESUME_ARGS = ADAPT_ARGS + SSM_ARGS + ["--burn-in", "2"]


class _StopAfterPerturb(Exception):
    pass


def _npz(path):
    import numpy as np

    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _same_arrays(a, b):
    import numpy as np

    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def _kernel_ms(prof, name):
    """Device ms of the kernels whose (mangled) name holds ``name`` and of
    all device events, from a torch.profiler run."""
    from torch.autograd import DeviceType

    def us(a):
        v = getattr(a, "self_device_time_total", None)
        return getattr(a, "self_cuda_time_total", 0.0) if v is None else v

    rows = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
    return (sum(us(a) for a in rows if name in a.key) / 1e3, sum(us(a) for a in rows) / 1e3)


def resume_phase(cli, work, hybrid_args, kernels, log_records):
    """Phase 6d: phase 6c's recipe run 3 sweeps straight with a checkpoint
    after every sweep (A), 1 sweep with a checkpoint (B), and resumed from
    B's checkpoint to 3 (C): C's samples 2 and 3 of every chain, its final
    checkpoint (the whole carry and the generator's state), training_stats
    and inclusion_probs equal to A's bit for bit, each resumed sweep's
    launches A's; the checkpoint's bytes and write ms. Then ``train`` from
    A's sample for one sweep, its perturbed start against the same
    command's under --cpu bit for bit; and ``branch-r2`` and
    ``population-effect-sizes`` on the training set, ``activations`` on the
    test set, each on a models directory of one sample, on the card against
    --cpu within REL_TOL of max(1, the largest entry), each with its K2
    launches (and their device time) and no plain-version call on the card.
    Returns the measurements."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rs_bann_tpu_torch.models import params as P
    from rs_bann_tpu_torch.models.net import Net
    from rs_bann_tpu_torch.ops import leapfrog as LF
    from rs_bann_tpu_torch.ops import packed_matmul as PM

    t_phase = time.perf_counter()
    root = os.path.join(work, "resume")

    def argv(chain_length, out, *extra):
        a = list(hybrid_args) + RESUME_ARGS
        a[7] = chain_length  # train-new's positional chain length
        return a + ["-o", os.path.join(root, out), *extra]

    first = len(log_records)
    run_a, recs_a = recorded_run(cli, argv(3, "a", "--checkpoint-interval", 1), kernels)
    ckpts = [r.args for r in log_records[first:]
             if str(r.msg).startswith("checkpoint at iteration")]
    run_b = run_cli(cli, argv(1, "b", "--checkpoint-interval", 1)).strip().splitlines()[-1]
    t0 = time.perf_counter()
    run_c, recs_c = recorded_run(cli, argv(3, "c", "--checkpoint-interval", 1, "--resume",
                                           os.path.join(run_b, "checkpoint.npz")), kernels)
    resume_s = time.perf_counter() - t0
    per_sweep = {"integrate_chains_packed": G // BLOCK, "packed_linear": 3 * (G // BLOCK),
                 "data_vg_packed": 0, "packed_matmul_vjp": G // BLOCK,
                 "marker_scan": G // BLOCK}
    launches_a = [r["launches"] for r in recs_a]
    launches_c = [r["launches"] for r in recs_c]
    print(f"  kernel launches per sweep: straight {launches_a}, resumed (sweeps 2-3) "
          f"{launches_c}")
    if launches_a != [per_sweep] * 3 or launches_c != launches_a[1:]:
        raise AssertionError("the resumed sweeps' launches are not the straight run's")
    warm1, warm2, frozen = (r["state"] for r in recs_a)
    if any(torch.equal(warm1[f], warm2[f]) for f in ("da_log_eps_bar", "mm_m2")) or not all(
            torch.equal(warm2[f], frozen[f]) for f in ADAPT_FIELDS):
        raise AssertionError("sweep 2 did not adapt or sweep 3 was not frozen")
    if not all(torch.equal(recs_c[0]["state"][f], warm2[f]) for f in ADAPT_FIELDS):
        raise AssertionError("the resumed sweep 2 adapted otherwise than the straight one")
    same = {}
    for c in range(CHAINS):
        for ix in (2, 3):
            name = os.path.join("models", f"chain{c}", f"{ix}.npz")
            same[name] = _same_arrays(_npz(os.path.join(run_a, name)),
                                      _npz(os.path.join(run_c, name)))
    same["checkpoint.npz"] = _same_arrays(_npz(os.path.join(run_a, "checkpoint.npz")),
                                          _npz(os.path.join(run_c, "checkpoint.npz")))
    for f in ("training_stats", "inclusion_probs"):
        same[f] = open(os.path.join(run_a, f)).read() == open(os.path.join(run_c, f)).read()
    stats_a = json.load(open(os.path.join(run_a, "training_stats")))
    print(f"  resumed run against the straight one, bit for bit: {same}")
    if not all(same.values()):
        raise AssertionError("the resumed run differs from the straight one")
    print(f"  mse_train of sweeps 2-3 {stats_a['mse_train'][2:]}, lpd {stats_a['lpd'][2:]}; "
          f"the resume (sweeps 2-3) {resume_s:.1f} s")
    ckpt_bytes = [int(a[1]) for a in ckpts]
    ckpt_ms = [float(a[2]) for a in ckpts]
    print(f"  checkpoint: {ckpt_bytes} bytes, written in {ckpt_ms} ms after sweeps "
          f"{[a[0] for a in ckpts]}")
    if [a[0] for a in ckpts] != [1, 2, 3]:
        raise AssertionError(f"checkpoints written: {ckpts}")
    del recs_a, recs_c

    # train from one of A's samples, perturbed; its start against --cpu's
    sample = os.path.join(run_a, "models", "chain0", "3.npz")
    train_argv = ["train", os.path.join(work, "train"), os.path.join(work, "train.phen"),
                  os.path.join(work, "train.groups"), "ridge_ard", sample, 1, L,
                  "--perturb-params", "0.01", "--packed-genotypes", "--burn-in", "0",
                  "--bfile-test", os.path.join(work, "test"), "--p-test",
                  os.path.join(work, "test.phen"), "--update-mode", "hybrid", "--num-chains",
                  CHAINS, *ADAPT_ARGS, *SSM_ARGS, "-o", os.path.join(root, "train")]
    starts, stop = [], []
    perturb = Net.perturb

    def captured(self, *a):
        out = perturb(self, *a)
        starts.append([t.cpu().clone() for t in P.state_leaves(self.state)])
        if stop:  # the --cpu run: its start is all it is for
            raise _StopAfterPerturb
        return out

    Net.perturb = captured
    try:
        LF.integrate_chains_packed.launches = 0
        t0 = time.perf_counter()
        run_t = run_cli(cli, train_argv).strip().splitlines()[-1]
        train_s = time.perf_counter() - t0
        stop.append(True)
        try:
            run_cli(cli, train_argv + ["--cpu"])
        except _StopAfterPerturb:
            pass
    finally:
        Net.perturb = perturb
    same_start = len(starts) == 2 and len(starts[0]) == len(starts[1]) and all(
        torch.equal(a, b) for a, b in zip(*starts))
    stats_t = json.load(open(os.path.join(run_t, "training_stats")))
    saved = sorted(os.listdir(os.path.join(run_t, "models", "chain0")))
    print(f"  train from {os.path.relpath(sample, work)} (--perturb-params 0.01, 1 sweep): "
          f"{os.path.basename(run_t)}, {train_s:.1f} s, K5 launches "
          f"{LF.integrate_chains_packed.launches}, samples {saved}; the perturbed start equal "
          f"to --cpu's bit for bit: {same_start}")
    if (not same_start or LF.integrate_chains_packed.launches != G // BLOCK
            or saved != ["0.npz", "1.npz"] or not all(np.isfinite(stats_t["mse_train"]))):
        raise AssertionError("train from a saved sample failed its checks")

    # the analysis commands on a models directory of one sample
    one = os.path.join(root, "one")
    os.makedirs(one)
    shutil.copy(sample, one)
    plain_calls = []
    plains = {f: getattr(PM, f) for f in ("packed_linear_ref", "packed_matmul_ref")}
    for f, fn in plains.items():
        setattr(PM, f, lambda *a, _fn=fn, _f=f: plain_calls.append(_f) or _fn(*a))
    analysis = {}
    try:
        for cmd, data in (("branch-r2", "train"), ("population-effect-sizes", "train"),
                          ("activations", "test")):
            outs = {}
            for where in ("card", "cpu"):
                models = os.path.join(root, f"{cmd}-{where}", "models")
                shutil.copytree(one, models)
                args = [cmd, os.path.join(work, data)] + (
                    [] if cmd == "activations" else [os.path.join(work, f"{data}.phen")]) + [
                    os.path.join(work, "train.groups"), "-m", models, "--packed-genotypes"]
                PM.packed_linear.launches = PM.packed_matmul.launches = 0
                del plain_calls[:]
                t0 = time.perf_counter()
                if where == "card":
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        out = run_cli(cli, args)
                        torch.cuda.synchronize()
                    k2_ms, device_ms = _kernel_ms(prof, "packed_linear_tc")
                    card = {"s": time.perf_counter() - t0, "k2_launches": PM.packed_linear.launches,
                            "k9a_launches": PM.packed_matmul.launches, "k2_ms": k2_ms,
                            "device_ms": device_ms, "plain_calls": len(plain_calls)}
                else:
                    out = run_cli(cli, args + ["--cpu"])
                    cpu_s = time.perf_counter() - t0
                if cmd == "branch-r2":
                    vals = np.asarray(list(csv.reader(io.StringIO(out))), np.float64)
                else:
                    res = json.load(open(os.path.join(os.path.dirname(models),
                                                      cmd.replace("-", "_"), "3.json")))
                    vals = (np.asarray(res, np.float64) if cmd != "activations" else
                            np.concatenate([np.asarray(a, np.float64).ravel()
                                            for branch in res for a in branch]))
                outs[where] = vals
            err = float(np.abs(outs["card"] - outs["cpu"]).max())
            scale = max(1.0, float(np.abs(outs["cpu"]).max()))
            analysis[cmd] = dict(card, cpu_s=cpu_s, max_abs_err=err, values=outs["cpu"].size)
            print(f"  {cmd} ({data} set, one sample): card {card['s']:.1f} s, --cpu "
                  f"{cpu_s:.1f} s; K2 launches {card['k2_launches']} ({card['k2_ms']:.3f} ms "
                  f"on the device of {card['device_ms']:.3f}), K9a {card['k9a_launches']}, "
                  f"plain-version calls on the card {card['plain_calls']}; {outs['cpu'].size} "
                  f"values, card vs --cpu max_abs_err {err:.3e} (max(1, largest) {scale:.3e})")
            if (outs["card"].shape != outs["cpu"].shape or not err <= REL_TOL * scale
                    or card["k2_launches"] < 1 or card["plain_calls"]
                    or not np.all(np.isfinite(outs["card"]))):
                raise AssertionError(f"{cmd}: the card's output fails its checks")
    finally:
        for f, fn in plains.items():
            setattr(PM, f, fn)
    phase_s = time.perf_counter() - t_phase
    print(f"  phase 6d: {phase_s:.1f} s in all")
    return {"checkpoint_bytes": ckpt_bytes, "checkpoint_ms": ckpt_ms,
            "resume_s": resume_s, "train_s": train_s, "analysis": analysis,
            "phase_s": phase_s}


def write_data(d, groups=G, markers=M, n_train=N_TRAIN, n_test=N_TEST, n_causal=N_CAUSAL):
    """Train and test genotypes of one population (per-marker allele
    frequencies shared), ``groups`` groups of ``markers`` markers, and a
    sparse linear phenotype at h2 = 0.5, written under ``d``."""
    import numpy as np

    from rs_bann_tpu_torch.io import BedVM, Phenotypes, UniformGrouping

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(1)
    mafs = rng.uniform(0.05, 0.5, groups * markers)
    causal = np.sort(rng.choice(groups * markers, size=n_causal, replace=False))
    beta = rng.standard_normal(n_causal)
    train = BedVM.random(n_train, groups * markers, mafs=mafs, seed=1)
    test = BedVM.random(n_test, groups * markers, mafs=mafs, seed=2)
    mu, sd = train.col_means[causal], train.col_stds[causal]
    g_train = ((train.get_cols(causal).T - mu) / sd) @ beta
    g_test = ((test.get_cols(causal).T - mu) / sd) @ beta
    noise_sd = g_train.std()  # h2 = var(g) / (var(g) + noise_sd^2) = 0.5
    y_train = g_train + noise_sd * rng.standard_normal(n_train)
    y_test = g_test + noise_sd * rng.standard_normal(n_test)
    train.to_file(os.path.join(d, "train"))
    test.to_file(os.path.join(d, "test"))
    Phenotypes(y_train).to_file(os.path.join(d, "train.phen"))
    Phenotypes(y_test).to_file(os.path.join(d, "test.phen"))
    UniformGrouping(groups, markers).to_file(os.path.join(d, "train"))
    return train, y_train, y_test


def main():
    import torch

    # ---- phase 0
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(f"phase 0: {smi}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    import numpy as np

    from rs_bann_tpu_torch.cli.main import main as cli
    from rs_bann_tpu_torch.io import BedVM, ExternalGrouping
    from rs_bann_tpu_torch.io.genotypes import CompressedGenotypes
    from rs_bann_tpu_torch.models import NetArch
    from rs_bann_tpu_torch.models.init import InitCfg, init_net
    from rs_bann_tpu_torch.models.net import Net
    from rs_bann_tpu_torch.models import density as D
    from rs_bann_tpu_torch.models import params as P
    from rs_bann_tpu_torch.ops import _build
    from rs_bann_tpu_torch.ops.activations import ACT_CODES, prime_from_out
    from rs_bann_tpu_torch.ops import branch_mlp as BM
    from rs_bann_tpu_torch.ops import leapfrog as LF
    from rs_bann_tpu_torch.ops import marker_scan as MS
    from rs_bann_tpu_torch.ops import packed_matmul as PM
    from rs_bann_tpu_torch.samplers import MCMCCfg
    from rs_bann_tpu_torch.samplers import hmc as H

    # ---- phase 1
    t0 = time.perf_counter()
    _build.lib()
    print(f"phase 1: built {_build.library_path().name} with {_build.nvcc()} in "
          f"{time.perf_counter() - t0:.1f} s")
    build_log = _build.BUILD_DIR / "build.log"
    if build_log.exists():  # each source's compile time (nvcc in parallel)
        print("  " + ", ".join(l for l in build_log.read_text().splitlines() if ".cu: " in l))

    work = tempfile.mkdtemp(prefix="rs_bann_smoke_")
    try:
        t0 = time.perf_counter()
        train_bed, y_train, y_test = write_data(work)
        print(f"data: written in {time.perf_counter() - t0:.1f} s")
        dev = torch.device("cuda")
        arch = NetArch.from_width_rules([M] * G, 0, ("fixed", 10), ("fraction_of_hidden", 1.0),
                                        activation="identity")
        groups = ExternalGrouping.from_file(os.path.join(work, "train.groups"))
        X = CompressedGenotypes(train_bed, groups).to_packed(arch, dev).X
        state, _ = init_net(arch, "ridge_ard", InitCfg(seed=0), device=dev)
        W0, b0, Wout = state.params.weights[0], state.params.biases[0], state.params.weights[1]
        print(f"  packed genotypes {tuple(X.bytes.shape)} {X.bytes.dtype}, "
              f"{X.bytes.numel() / 1e9:.2f} GB on the card")

        # ---- phase 2: K2 at the slice's full shape, all branches in one launch
        A = X.w_scale.unsqueeze(-1) * W0
        off = b0 - (X.shift.unsqueeze(-2) @ A).squeeze(-2)
        k2_err, k2_ms, k2_plain_ms = 0.0, None, None
        print("phase 2: K2 packed_linear vs plain, bytes", tuple(X.bytes.shape), "k", A.shape[-1])
        for act in ("identity", "tanh"):
            out = PM.packed_linear(X.bytes, A, off, N_TRAIN, act)
            ref = PM.packed_linear_ref(X.bytes, A, off, N_TRAIN, act)
            k2_err = max(k2_err, check_close("packed_linear", act, out, ref))
            identical(lambda: PM.packed_linear(X.bytes, A, off, N_TRAIN, act), out, f"K2 {act}")
            del out, ref
            ms = cuda_ms(lambda: PM.packed_linear(X.bytes, A, off, N_TRAIN, act))
            plain_ms = cuda_ms(lambda: PM.packed_linear_ref(X.bytes, A, off, N_TRAIN, act))
            print(f"  {act}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
            if act == "identity":  # the slice's activation
                k2_ms, k2_plain_ms = ms, plain_ms
        # the work as implemented (three bf16 tensor-core products per f32
        # one), and the f32 FMA figure beside it
        k2_flop = 2 * G * X.bytes.shape[1] * N_TRAIN * A.shape[-1]
        k2_nbytes = nbytes(X.bytes, A, off) + 4 * G * N_TRAIN * A.shape[-1]
        k2_bound, k2_f32_bound = tc_bound(k2_flop, k2_nbytes), bound(k2_flop, k2_nbytes)
        print(f"  bound {k2_bound[0]:.3f} ms ({k2_bound[1]}; f32 FMA {k2_f32_bound[0]:.3f} ms); "
              f"identity {100 * k2_bound[0] / k2_ms:.1f}% of it")

        # ---- phase 3: K4 for one branch at the slice's full shape
        print("phase 3: K4 data_vg_packed vs plain, one branch, n", N_TRAIN)
        g = G // 2
        xg = X[g]
        w_g, b_g = (W0[g], Wout[g]), (b0[g],)
        m_pad, k0 = w_g[0].shape
        target = torch.randn(N_TRAIN, device=dev, generator=torch.Generator(dev).manual_seed(0))

        def k4_plain(act, ws, bs, dtype=torch.float32):
            """K4's plain version with the wrapper's fold, rss and unfold: in
            f32 as the wrapper's, or every step in f64."""
            s, sh, t = (v.to(dtype) for v in (xg.w_scale, xg.shift, target))
            ws, bs = tuple(w.to(dtype) for w in ws), tuple(b.to(dtype) for b in bs)
            wf = (s[:, None] * ws[0],) + ws[1:]
            bf = (bs[0] - sh @ wf[0],) + bs[1:]
            y_ref, dws_ref, dbs_ref = BM.data_vg_packed_ref(act, xg.bytes, t, wf, bf, N_TRAIN)
            dW0 = s[:, None] * dws_ref[0] - (sh * s)[:, None] * dbs_ref[0]
            return y_ref, torch.sum((y_ref - t) ** 2), (dW0,) + dws_ref[1:], dbs_ref

        def k4_case(label, act, ws, bs):
            """Check one K4 call against its plain version (and, held to the
            same tolerance, against the plain version in f64) and its repeat;
            returns the largest difference from the f32 plain version."""
            got, want = BM.data_vg_packed(act, xg, ws, bs, target), k4_plain(act, ws, bs)
            want64 = k4_plain(act, ws, bs, torch.float64)
            flat = lambda r: (r[0], r[1]) + tuple(r[2]) + tuple(r[3])  # noqa: E731
            names = ["y_pred", "rss"] + [f"dW{l}" for l in range(len(ws))] + \
                [f"db{l}" for l in range(len(bs))]
            err = max(check_close("data_vg_packed", f"{label} {nm}", a, b)
                      for nm, a, b in zip(names, flat(got), flat(want)))
            for nm, a, b in zip(names, flat(got), flat(want64)):
                check_close("data_vg_packed f64", f"{label} {nm} (f64)", a.double(), b)
            identical(lambda: flat(BM.data_vg_packed(act, xg, ws, bs, target)), flat(got),
                      f"K4 {label}")
            return err

        k4_err = max(k4_case(f"depth 0 {act}", act, w_g, b_g) for act in BM.SUPPORTED_ACTIVATIONS)
        # depth 1 (its own kernel): widths 16 and 16 from a seed
        d1gen = torch.Generator(dev).manual_seed(3)
        w_d1 = (0.2 * torch.randn((m_pad, 16), device=dev, generator=d1gen),
                0.2 * torch.randn((16, 16), device=dev, generator=d1gen), Wout[g])
        b_d1 = (0.1 * torch.randn(16, device=dev, generator=d1gen),
                0.1 * torch.randn(16, device=dev, generator=d1gen))
        k4_err = max(k4_err, k4_case("depth 1 identity", "identity", w_d1, b_d1))
        # the launch alone: back-to-back calls of the C entry (the pass and its
        # reduce) on buffers made once, beside the wrapper's call
        k4_plan = BM.branch_vg_packed0_plan(m_pad, xg.bytes.shape[1], N_TRAIN, k0)
        k4_out = torch.empty(N_TRAIN + m_pad * k0 + 2 * k0 + 1, device=dev)
        k4_part = torch.empty(k4_plan["ctas"] * k4_plan["row"], device=dev)
        vp = ctypes.c_void_p
        k4_args = (vp(xg.bytes.data_ptr()), vp(target.data_ptr()), vp(w_g[0].data_ptr()),
                   vp(b_g[0].data_ptr()), vp(w_g[1].data_ptr()), vp(xg.w_scale.data_ptr()),
                   vp(xg.shift.data_ptr()), vp(k4_out.data_ptr()), vp(k4_part.data_ptr()),
                   k4_part.numel(), vp(k4_out.data_ptr() + 4 * N_TRAIN), m_pad,
                   xg.bytes.shape[1], N_TRAIN, k0, ACT_CODES["identity"],
                   vp(_build.stream_ptr(xg.bytes)))
        lib = _build.lib()

        def k4_launches_run(reps=20):
            for _ in range(reps):
                _build.check(lib.branch_vg_packed0_f32(*k4_args), "branch_vg_packed0_f32")

        k4_ms = cuda_ms(k4_launches_run) / 20
        k4_wrapper_ms = cuda_ms(lambda: BM.data_vg_packed("identity", xg, w_g, b_g, target))
        k4_plain_ms = cuda_ms(lambda: k4_plain("identity", w_g, b_g))
        # both layer-0 products (forward and dW0') and the output layer's, per
        # individual; bytes, target, weights and scale/shift in, y_pred and
        # gradients out
        k4_flop = 2 * N_TRAIN * mlp_fmas(m_pad, k0, w_g[1].shape[0], 0)
        k4_nbytes = (nbytes(xg.bytes, xg.w_scale, xg.shift, target, *w_g, *b_g) + 4 * N_TRAIN
                     + nbytes(*w_g, *b_g))
        k4_bound, k4_f32_bound = tc_bound(k4_flop, k4_nbytes), bound(k4_flop, k4_nbytes)
        print(f"  identity: launch alone {k4_ms:.4f} ms (the pass and its reduce), wrapper "
              f"{k4_wrapper_ms:.4f} ms, plain {k4_plain_ms:.3f} ms; bound {k4_bound[0]:.4f} ms "
              f"({k4_bound[1]}; f32 FMA {k4_f32_bound[0]:.4f} ms); plan {k4_plan}")
        del k4_out, k4_part

        del A, off

        # ---- phase 4: train-new -> predict through the CLI
        print("phase 4: train-new -> predict through the CLI (sequential, one chain)")
        runs = os.path.join(work, "runs")
        log_records = []
        handler = logging.Handler()
        handler.emit = log_records.append
        logging.getLogger("rs_bann_tpu_torch").addHandler(handler)
        train_args = [
            "train-new", os.path.join(work, "train"), os.path.join(work, "train.phen"),
            os.path.join(work, "train.groups"), "ridge_ard", "identity", "0", CHAIN, L,
            "--fixed-hidden-layer-width", "10", "--packed-genotypes", "--burn-in", "1",
            "--bfile-test", os.path.join(work, "test"), "--p-test", os.path.join(work, "test.phen"),
            "-o", runs,
        ]
        PM.packed_linear.launches = 0
        BM.data_vg_packed.launches = 0
        t0 = time.perf_counter()
        run = run_cli(cli, train_args).strip().splitlines()[-1]
        train_s = time.perf_counter() - t0
        out = io.StringIO(run_cli(cli, [
            "predict", os.path.join(work, "test"), os.path.join(work, "train.groups"),
            "-m", os.path.join(run, "models"), "--packed-genotypes",
        ]))
        torch.cuda.synchronize()
        k2_launches, k4_launches = PM.packed_linear.launches, BM.data_vg_packed.launches
        print(f"  kernel launches: packed_linear {k2_launches}, data_vg_packed {k4_launches}")
        if k4_launches != CHAIN * G * (L + 1):
            raise AssertionError(f"data_vg_packed launched {k4_launches} times, "
                                 f"expected {CHAIN * G * (L + 1)}")
        if k2_launches <= 0:
            raise AssertionError("packed_linear was not launched on the main path")

        stats = json.load(open(os.path.join(run, "training_stats")))
        series = stats["mse_train"] + stats["mse_test"] + stats["lpd"]
        if len(stats["mse_test"]) != CHAIN + 1 or not all(np.isfinite(series)):
            raise AssertionError(f"non-finite or missing training statistics: {stats}")
        preds = np.asarray(list(csv.reader(out)), np.float64)
        if preds.shape != (CHAIN, N_TEST) or not np.all(np.isfinite(preds)):
            raise AssertionError(f"predictions of shape {preds.shape}, finite: "
                                 f"{np.all(np.isfinite(preds))}")
        done = [r for r in log_records if str(r.msg).startswith("Completed training")]
        sweep_ms = 1000.0 * done[-1].args[0] / CHAIN
        y_hat = preds.mean(axis=0)
        r2 = 1.0 - np.mean((y_test - y_hat) ** 2) / np.var(y_test)
        print(f"  {sweep_ms:.1f} ms per sweep (G {G}, L {L}); train-new {train_s:.1f} s in all")
        print(f"  acceptance {stats['num_accepted'] / stats['num_samples']:.3f}, "
              f"early rejection {stats['num_early_rejected'] / stats['num_samples']:.3f}")
        print(f"  mse train {stats['mse_train'][-1]:.4f}, mse test {stats['mse_test'][-1]:.4f}, "
              f"test r2 of the posterior mean {r2:.4f}")

        # the card's predictions against the plain version on the CPU
        net = Net.load(os.path.join(run, "models", f"{CHAIN}.npz"), "cpu")
        test_gen = CompressedGenotypes(BedVM.from_file(os.path.join(work, "test")), groups)
        cpu_pred = net.predict(test_gen.to_packed(net.arch, "cpu").X).numpy()
        err = np.abs(cpu_pred - preds[-1]).max()
        print(f"  predict, card vs CPU plain version: max_abs_err {err:.3e}")
        if not err <= REL_TOL * max(1.0, np.abs(cpu_pred).max()):
            raise AssertionError("the card's predictions disagree with the CPU's")

        # ---- phase 5: K5 on one hybrid block at the slice's full shape
        print(f"phase 5: one hybrid block, B {BLOCK}, C {CHAINS}, n {N_TRAIN}")
        ixs = torch.arange(BLOCK, device=dev) * (G // BLOCK)
        x_b = X[ixs]
        gen = torch.Generator(dev).manual_seed(5)

        def chains_of(ts):  # the block's branches, the same start for every chain
            return tuple(t[ixs].unsqueeze(1).expand((BLOCK, CHAINS) + t.shape[1:]).contiguous()
                         for t in ts)

        ws, bs = chains_of(state.params.weights), chains_of(state.params.biases)
        mws, mbs = chains_of(P.weight_masks(arch, dev)), chains_of(P.bias_masks(arch, dev))
        # precisions at the means of their first Gibbs conditionals
        # (Gamma(0.001, 1000) priors): ARD rows of k0 weights, the biases,
        # the output layer shared by all branches
        def post_mean(count, ssq):
            return (0.001 + count / 2) * 2000.0 / (2.0 + 1000.0 * ssq)

        k_true = float(arch.layer_out_counts()[0][0])
        lam_out = post_mean(float(arch.total_output_weights),
                            (state.params.weights[1] ** 2).sum().item())
        wps = (post_mean(k_true, (ws[0] ** 2).sum(-1, keepdim=True)),
               torch.full_like(ws[1][..., :1, :], lam_out))
        bps = (post_mean(k_true, (bs[0] ** 2).sum(-1, keepdim=True)),)
        # one set of izmailov step sizes, sized for the main path's L
        eps_w, eps_b = H.step_sizes(None, "ridge_ard", MCMCCfg(hmc_integration_length=L),
                                    ws, bs, wps, bps, None)
        p_w = tuple(torch.randn(w.shape, device=dev, generator=gen) * m for w, m in zip(ws, mws))
        p_b = tuple(torch.randn(b.shape, device=dev, generator=gen) * m for b, m in zip(bs, mbs))
        y_dev = torch.as_tensor(y_train, dtype=torch.float32, device=dev)
        targets = y_dev + 0.1 * torch.randn((BLOCK, CHAINS, N_TRAIN), device=dev, generator=gen)
        err = torch.full((BLOCK, CHAINS), 1.0 / y_dev.var().item(), device=dev)
        lam_w = tuple(lam.expand_as(w) for lam, w in zip(wps, ws))
        lam_b = tuple(torch.zeros_like(b) for b in bs)

        # K2 at the hybrid's value-pass shape: the C chains' layer 0 side by
        # side in K2's output width, one block's bytes; each chain's weights
        # perturbed, so a column mixed up between chains shows
        kgen = torch.Generator(dev).manual_seed(6)

        def per_chain(ts):  # [B, C, ...] -> [C, B, ...], perturbed
            return tuple(t.transpose(0, 1) * (1.0 + 0.1 * torch.randn(
                t.transpose(0, 1).shape, device=dev, generator=kgen)) for t in ts)

        w_cb, b_cb = per_chain(ws), per_chain(bs)
        # the stored width (C x 16 columns) and the live one the value
        # passes take (C x the branch width, 10)
        vp_live = arch.s[0]
        for width in (ws[0].shape[-1], vp_live):
            A_c, off_c = D.chain_layer0(w_cb[0][..., :width], b_cb[0][..., :width], x_b)
            kc = A_c.shape[-1]
            print("  K2 packed_linear vs plain, chain-folded: bytes", tuple(x_b.bytes.shape),
                  "k", kc)
            got = PM.packed_linear(x_b.bytes, A_c, off_c, N_TRAIN, "identity")
            k2_err = max(k2_err, check_close(
                "packed_linear", f"identity, k {kc}", got,
                PM.packed_linear_ref(x_b.bytes, A_c, off_c, N_TRAIN, "identity")))
            identical(lambda: PM.packed_linear(x_b.bytes, A_c, off_c, N_TRAIN, "identity"), got,
                      f"K2 value pass, k {kc}")
            del got
            ms = cuda_ms(lambda: PM.packed_linear(x_b.bytes, A_c, off_c, N_TRAIN, "identity"))
            plain_ms = cuda_ms(lambda: PM.packed_linear_ref(x_b.bytes, A_c, off_c, N_TRAIN,
                                                            "identity"))
            vp_flop = 2 * BLOCK * x_b.bytes.shape[1] * N_TRAIN * kc
            vp_nbytes = nbytes(x_b.bytes, A_c, off_c) + 4 * BLOCK * N_TRAIN * kc
            vp2_bound, vp2_f32 = tc_bound(vp_flop, vp_nbytes), bound(vp_flop, vp_nbytes)
            print(f"  identity, k {kc}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                  f"{vp2_bound[0]:.3f} ms ({vp2_bound[1]}; f32 FMA {vp2_f32[0]:.3f} ms), "
                  f"{100 * vp2_bound[0] / ms:.1f}% of it; identical repeat")
            del A_c, off_c
        # the live value pass, the main path's: its numbers go to the kernels line
        k2_vp = {"value_pass_k": kc, "value_pass_ms": ms, "value_pass_plain_ms": plain_ms,
                 "value_pass_bound_ms": vp2_bound[0], "value_pass_f32_bound_ms": vp2_f32[0]}
        cpu = lambda ts: tuple(t.cpu() for t in ts)  # noqa: E731
        x_cpu = D.PackedX(*cpu((x_b.bytes, x_b.w_scale, x_b.shift)), N_TRAIN)
        full = D.predict_chains("identity", cpu(w_cb), cpu(b_cb), x_cpu)
        k2_err = max(k2_err, check_close(
            "packed_linear", "predict_chains, card vs CPU plain version",
            D.predict_chains("identity", w_cb, b_cb, x_b).cpu(), full))
        k2_err = max(k2_err, check_close(
            "packed_linear", f"predict_chains on the live width {vp_live}, card vs CPU uncut",
            D.predict_chains("identity", w_cb, b_cb, x_b, vp_live).cpu(), full))
        del w_cb, b_cb, full

        # K5 computes the block's live layer-0 columns only: the padded ones
        # have zero weights and momenta (their step sizes are not zero)
        k0 = ws[0].shape[-1]
        k_live = LF.live_width(k0, *(BM.flat_params(a, b) for a, b in (
            (ws, bs), (p_w, p_b), (eps_w, eps_b), (lam_w, lam_b))))
        k5_km = _build.lib().traj_packed_km(k0, k0, k_live, 0)
        print(f"  K5: width {arch.s[0]} stored at {k0}, live width {k_live}, register width "
              f"{k5_km}")
        k5_cc, k5_per_sm, k5_smem = LF.traj_packed_occupancy(x_b.bytes.shape[1], k0, k0, k_live, 0,
                                                             CHAINS)
        print(f"  K5: {k5_cc} chains per chunk, {k5_per_sm} resident blocks per SM, {k5_smem} "
              f"bytes of shared memory per block")
        if build_log.exists():
            sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
            from bench_k5_torch import ptxas

            for r in ptxas(build_log):
                print(f"  ptxas traj_packed_kernel<KM={r['km']}, CC={r['cc']}, depth {r['depth']}>: "
                      f"{r['registers']} registers, {r['spill_stores']} bytes of spill stores")
        if k_live != arch.s[0]:
            raise AssertionError(f"live width {k_live}, expected the branch width {arch.s[0]}")
        k5_err, k5_ms, k5_plain_ms = 0.0, None, None
        for steps, tol in ((1, REL_TOL), (L, REL_TOL_TRAJ)):
            args = (x_b.bytes, x_b.w_scale, x_b.shift, targets, err, ws, bs, p_w, p_b,
                    eps_w, eps_b, lam_w, lam_b, steps, N_TRAIN)
            out = LF.integrate_chains_packed("identity", *args)
            ref = LF.integrate_chains_packed_ref("identity", *args)
            names = ("W0", "w_out", "b0", "pW0", "pw_out", "pb0")
            for name, got, want in zip(names, [t for o in out for t in o],
                                       [t for r in ref for t in r]):
                k5_err = max(k5_err, check_close("traj_packed", f"L={steps} {name}", got, want,
                                                 tol))
            again = LF.integrate_chains_packed("identity", *args)
            if not all(torch.equal(a, b) for o, o2 in zip(out, again) for a, b in zip(o, o2)):
                raise AssertionError("K5: two calls with the same inputs differ")
            moved = (out[0][0] - ws[0]).abs().max().item()
            ms = cuda_ms(lambda: LF.integrate_chains_packed("identity", *args))
            plain_ms = cuda_ms(lambda: LF.integrate_chains_packed_ref("identity", *args))
            print(f"  L={steps}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, identical repeat, "
                  f"max |W0_L - W0_0| {moved:.3e}")
            k5_ms, k5_plain_ms = ms, plain_ms  # the main path's L
            state_bytes = nbytes(*ws, *bs)
            # the work of the function: the live columns, at the start and
            # at each of L steps
            k5_bound = bound(
                2 * BLOCK * CHAINS * N_TRAIN * (steps + 1)
                * mlp_fmas(x_b.bytes.shape[1], k_live, k_live, 0),
                nbytes(x_b.bytes, x_b.w_scale, x_b.shift, targets, err) + 8 * state_bytes)
            del ref, again
        # the live columns stored at width k_live, with no dead column: the
        # same bits; the dead columns come out as they went in
        def cut(ts, bias=False):
            return ((ts[0][..., :k_live].contiguous(),) if bias else
                    (ts[0][..., :k_live].contiguous(), ts[1][..., :k_live, :].contiguous()))

        narrow = LF.integrate_chains_packed(
            "identity", x_b.bytes, x_b.w_scale, x_b.shift, targets, err, cut(ws), cut(bs, True),
            cut(p_w), cut(p_b, True), cut(eps_w), cut(eps_b, True), cut(lam_w), cut(lam_b, True),
            L, N_TRAIN)
        for got_p, nar_p, start_p in zip(out, narrow, (ws, bs, p_w, p_b)):
            for got, nar, start in zip(got_p, nar_p, start_p):
                lead = (slice(None),) * (got.dim() - (2 if got.shape[-1] == 1 else 1))
                if not (torch.equal(got[lead + (slice(0, k_live),)], nar)
                        and torch.equal(got[lead + (slice(k_live, None),)],
                                        start[lead + (slice(k_live, None),)])):
                    raise AssertionError("K5: the live columns stored at width "
                                         f"{k_live} and at {k0} differ")
        print(f"  L={L}: the live columns stored at width {k_live} give the same bits; the "
              f"dead ones come out as they went in")
        # phase 6b's fold: per-coordinate step sizes of the adaptation, in
        # transposed views, nonzero on the padded columns too
        a_eps_w, a_eps_b = adapted_step_sizes("ridge_ard", L, ws, bs, wps, bps, 8)
        if not a_eps_w[0][..., k_live:].abs().min().item() > 0:
            raise AssertionError("the adapted step sizes of the padded columns are zero")
        for steps, tol in ((1, REL_TOL), (L, REL_TOL_TRAJ)):
            args = (x_b.bytes, x_b.w_scale, x_b.shift, targets, err, ws, bs, p_w, p_b,
                    a_eps_w, a_eps_b, lam_w, lam_b, steps, N_TRAIN)
            out = LF.integrate_chains_packed("identity", *args)
            ref = LF.integrate_chains_packed_ref("identity", *args)
            names = ("W0", "w_out", "b0", "pW0", "pw_out", "pb0")
            for name, got, want in zip(names, [t for o in out for t in o],
                                       [t for r in ref for t in r]):
                k5_err = max(k5_err, check_close(
                    "traj_packed", f"adapted step sizes, L={steps} {name}", got, want, tol))
            identical(lambda: tuple(t for o in LF.integrate_chains_packed("identity", *args)
                                    for t in o), tuple(t for o in out for t in o),
                      f"K5 with adapted step sizes, L={steps}")
            w_f, b_f = out[0], out[1]
            if not (torch.all(w_f[0][..., k_live:] == 0) and torch.all(w_f[1][..., k_live:, :] == 0)
                    and torch.all(b_f[0][..., k_live:] == 0)):
                raise AssertionError("K5 moved a padded column under the adapted step sizes")
            del ref
        k5_adapted_ms = cuda_ms(lambda: LF.integrate_chains_packed("identity", *args))
        print(f"  adapted step sizes (phase 6b's fold, [C, B] -> [B, C] views): identical "
              f"repeats, the padded columns exactly 0; L={L}: kernel {k5_adapted_ms:.3f} ms "
              f"(izmailov {k5_ms:.3f} ms)")
        del out, narrow, targets, a_eps_w, a_eps_b

        # ---- phase 6: the hybrid path, C chains, through the CLI
        print(f"phase 6: train-new --update-mode hybrid --num-chains {CHAINS} -> predict")
        PM.packed_linear.launches = 0
        PM.packed_linear.widths = {}
        BM.data_vg_packed.launches = 0
        LF.integrate_chains_packed.launches = 0
        t0 = time.perf_counter()
        run = run_cli(cli, train_args + ["--update-mode", "hybrid", "--num-chains", CHAINS])
        vp_widths = dict(PM.packed_linear.widths)  # before predict's own launches
        run = run.strip().splitlines()[-1]
        hybrid_s = time.perf_counter() - t0
        chain_preds = []
        for c in range(CHAINS):
            rows = run_cli(cli, ["predict", os.path.join(work, "test"),
                                 os.path.join(work, "train.groups"), "-m",
                                 os.path.join(run, "models", f"chain{c}"), "--packed-genotypes"])
            chain_preds.append(np.asarray(list(csv.reader(io.StringIO(rows))), np.float64))
        torch.cuda.synchronize()
        k2_hybrid = PM.packed_linear.launches
        k4_hybrid = BM.data_vg_packed.launches
        k5_launches = LF.integrate_chains_packed.launches
        print(f"  kernel launches: packed_linear {k2_hybrid}, data_vg_packed {k4_hybrid}, "
              f"integrate_chains_packed {k5_launches}")
        if k5_launches != CHAIN * (G // BLOCK):
            raise AssertionError(f"integrate_chains_packed launched {k5_launches} times, "
                                 f"expected {CHAIN * (G // BLOCK)}")
        if k4_hybrid != 0:
            raise AssertionError(f"the folded path launched data_vg_packed {k4_hybrid} times")
        if k2_hybrid <= 0:
            raise AssertionError("packed_linear was not launched on the hybrid path")
        # the value passes (2 per block) hand K2 the chains' live columns
        print(f"  train-new's K2 launches by width k: {vp_widths}; the value passes' live "
              f"width {vp_live} (k = {CHAINS} x {vp_live} = {CHAINS * vp_live}): K2 there "
              f"{k2_vp['value_pass_ms']:.3f} ms, plain {k2_vp['value_pass_plain_ms']:.3f} ms, "
              f"bound {k2_vp['value_pass_bound_ms']:.3f} ms (phase 5)")
        if vp_widths.get(CHAINS * vp_live) != CHAIN * (G // BLOCK) * 2:
            raise AssertionError(f"the value passes launched K2 at widths {vp_widths}, expected "
                                 f"{CHAIN * (G // BLOCK) * 2} at {CHAINS * vp_live}")
        stats = json.load(open(os.path.join(run, "training_stats")))
        series = stats["mse_train"] + stats["mse_test"] + stats["lpd"]
        if len(stats["mse_test"]) != CHAIN + 1 or not all(np.isfinite(series)):
            raise AssertionError(f"non-finite or missing training statistics: {stats}")
        if stats["num_samples"] != CHAIN * G * CHAINS:
            raise AssertionError(f"{stats['num_samples']} branch updates counted, "
                                 f"expected {CHAIN * G * CHAINS}")
        preds = np.concatenate(chain_preds)
        if preds.shape != (CHAINS * CHAIN, N_TEST) or not np.all(np.isfinite(preds)):
            raise AssertionError(f"hybrid predictions of shape {preds.shape}, finite: "
                                 f"{np.all(np.isfinite(preds))}")
        done = [r for r in log_records if str(r.msg).startswith("Completed training")]
        hybrid_sweep_ms = 1000.0 * done[-1].args[0] / CHAIN
        r2_h = 1.0 - np.mean((y_test - preds.mean(axis=0)) ** 2) / np.var(y_test)
        print(f"  {hybrid_sweep_ms:.1f} ms per sweep of {CHAINS} chains (G {G}, L {L}, "
              f"blocks of {BLOCK}); train-new {hybrid_s:.1f} s in all")
        print(f"  acceptance {stats['num_accepted'] / stats['num_samples']:.3f}, "
              f"early rejection {stats['num_early_rejected'] / stats['num_samples']:.3f}")
        print(f"  mse train {stats['mse_train'][-1]:.4f}, mse test {stats['mse_test'][-1]:.4f}, "
              f"test r2 of the {CHAINS}-chain posterior mean {r2_h:.4f}")
        net = Net.load(os.path.join(run, "models", "chain0", f"{CHAIN}.npz"), "cpu")
        cpu_pred = net.predict(test_gen.to_packed(net.arch, "cpu").X).numpy()
        err = np.abs(cpu_pred - chain_preds[0][-1]).max()
        print(f"  predict, card vs CPU plain version: max_abs_err {err:.3e}")
        if not err <= REL_TOL * max(1.0, np.abs(cpu_pred).max()):
            raise AssertionError("the card's hybrid predictions disagree with the CPU's")

        # ---- phase 6b: the hybrid path with the recipe's adaptation
        print(f"phase 6b: train-new --update-mode hybrid --num-chains {CHAINS} "
              f"{' '.join(ADAPT_ARGS)} -> predict (burn-in 1: the first sweep adapts, the "
              f"second is frozen)")
        packed_kernels = {"integrate_chains_packed": LF.integrate_chains_packed,
                          "packed_linear": PM.packed_linear, "data_vg_packed": BM.data_vg_packed}
        for counted in packed_kernels.values():
            counted.launches = 0
        PM.packed_linear.widths = {}
        hybrid_args = train_args + ["--update-mode", "hybrid", "--num-chains", CHAINS]
        t0 = time.perf_counter()
        run, recs = recorded_run(cli, hybrid_args + ADAPT_ARGS, packed_kernels)
        vp_widths_a = dict(PM.packed_linear.widths)  # before predict's own launches
        adapted_s = time.perf_counter() - t0
        k5_adapted = LF.integrate_chains_packed.launches
        k2_adapted = vp_widths_a.get(CHAINS * vp_live, 0)
        print(f"  kernel launches per sweep: {[r['launches'] for r in recs]}; train-new's K2 "
              f"launches by width k: {vp_widths_a} (phase 6: {vp_widths})")
        # per sweep: one K5 launch and two value passes (K2 at the live width) a block
        stats = json.load(open(os.path.join(run, "training_stats")))
        adapted_factors = check_adapted(recs, stats, CHAINS, {
            "integrate_chains_packed": G // BLOCK, "packed_linear": 2 * (G // BLOCK),
            "data_vg_packed": 0})
        if k2_adapted != vp_widths.get(CHAINS * vp_live):
            raise AssertionError(f"the adapted run's value passes launched K2 {k2_adapted} "
                                 f"times at k = {CHAINS * vp_live}, phase 6's "
                                 f"{vp_widths.get(CHAINS * vp_live)}")
        series = stats["mse_train"] + stats["mse_test"] + stats["lpd"]
        if len(stats["mse_test"]) != CHAIN + 1 or not all(np.isfinite(series)):
            raise AssertionError(f"non-finite or missing training statistics: {stats}")
        chain_preds = []
        for c in range(CHAINS):
            rows = run_cli(cli, ["predict", os.path.join(work, "test"),
                                 os.path.join(work, "train.groups"), "-m",
                                 os.path.join(run, "models", f"chain{c}"), "--packed-genotypes"])
            chain_preds.append(np.asarray(list(csv.reader(io.StringIO(rows))), np.float64))
        preds = np.concatenate(chain_preds)
        if preds.shape != (CHAINS * CHAIN, N_TEST) or not np.all(np.isfinite(preds)):
            raise AssertionError(f"adapted predictions of shape {preds.shape}, finite: "
                                 f"{np.all(np.isfinite(preds))}")
        done = [r for r in log_records if str(r.msg).startswith("Completed training")]
        adapted_sweep_ms = 1000.0 * done[-1].args[0] / CHAIN
        r2_a = 1.0 - np.mean((y_test - preds.mean(axis=0)) ** 2) / np.var(y_test)
        print(f"  {adapted_sweep_ms:.1f} ms per sweep of {CHAINS} chains with the adaptation, "
              f"{hybrid_sweep_ms:.1f} without (phase 6); train-new {adapted_s:.1f} s in all")
        print(f"  mse train {stats['mse_train'][-1]:.4f}, mse test {stats['mse_test'][-1]:.4f}, "
              f"test r2 of the {CHAINS}-chain posterior mean {r2_a:.4f}")
        net = Net.load(os.path.join(run, "models", "chain0", f"{CHAIN}.npz"), "cpu")
        cpu_pred = net.predict(test_gen.to_packed(net.arch, "cpu").X).numpy()
        err = np.abs(cpu_pred - chain_preds[0][-1]).max()
        print(f"  predict, card vs CPU plain version: max_abs_err {err:.3e}")
        if not err <= REL_TOL * max(1.0, np.abs(cpu_pred).max()):
            raise AssertionError("the card's adapted predictions disagree with the CPU's")
        packed_launches = sweep_launches(
            hybrid_args, "ridge_ard", arch, state, X,
            torch.as_tensor(y_train, dtype=torch.float32, device=dev), CHAINS, G // BLOCK)
        adapted_runs = {"packed": {
            "sweep_ms": adapted_sweep_ms, "unadapted_sweep_ms": hybrid_sweep_ms,
            "k5_launches": k5_adapted, "k2_value_passes": k2_adapted,
            "factors": adapted_factors, "launches_per_sweep": packed_launches}}
        del recs

        # ---- phase 6c: the recipe with per-marker spike-and-slab
        print(f"phase 6c: phase 6b's train-new with {' '.join(SSM_ARGS)} -> predict (burn-in "
              f"1: the first sweep keeps every marker in, the second draws z)")
        ssm_kernels = dict(packed_kernels, packed_matmul_vjp=PM.packed_matmul_vjp,
                           marker_scan=MS.marker_scan)
        for counted in ssm_kernels.values():
            counted.launches = 0
        PM.packed_linear.widths = {}
        t0 = time.perf_counter()
        run, recs = recorded_run(cli, hybrid_args + ADAPT_ARGS + SSM_ARGS, ssm_kernels)
        vp_widths_s = dict(PM.packed_linear.widths)  # before predict's own launches
        ssm_s = time.perf_counter() - t0
        scan_launches, k9b_ssm = MS.marker_scan.launches, PM.packed_matmul_vjp.launches
        print(f"  kernel launches per sweep: {[r['launches'] for r in recs]}; train-new's K2 "
              f"launches by width k: {vp_widths_s}")
        # per sweep and block: the scan's u0 (K9b), the scan, K5, and three
        # value passes (the snapshot, y_pred0 at the post-scan layer 0, Hf)
        stats = json.load(open(os.path.join(run, "training_stats")))
        check_adapted(recs, stats, CHAINS, {
            "integrate_chains_packed": G // BLOCK, "packed_linear": 3 * (G // BLOCK),
            "data_vg_packed": 0, "packed_matmul_vjp": G // BLOCK, "marker_scan": G // BLOCK})
        if vp_widths_s.get(CHAINS * vp_live) != CHAIN * 3 * (G // BLOCK):
            raise AssertionError(f"the value passes launched K2 at widths {vp_widths_s}, expected "
                                 f"{CHAIN * 3 * (G // BLOCK)} at {CHAINS * vp_live}")
        carry = recs[-1]["carry"]
        true = (D.branch_statics(arch, dev).row_masks[0][..., 0] > 0).cpu().numpy()
        z = carry.ssm_z.cpu().numpy()
        excluded = (z == 0) & true
        if not excluded.any() or not (z[:, ~true] == 0).all():
            raise AssertionError(f"{int(excluded.sum())} true markers excluded, padded ones "
                                 f"in: {int((z[:, ~true] != 0).sum())}")
        for c in range(CHAINS):
            w0 = np.load(os.path.join(run, "models", f"chain{c}", f"{CHAIN}.npz"))["w0"]
            if not np.array_equal(w0, carry.state.params.weights[0][c].cpu().numpy()):
                raise AssertionError(f"chain {c}'s saved W0 is not the run's last state")
            if not np.all(w0[excluded[c]] == 0):
                raise AssertionError(f"chain {c}: an excluded row of the saved W0 is not 0")
        probs = json.load(open(os.path.join(run, "inclusion_probs")))
        pip = np.concatenate([np.asarray(p) for p in probs["pip_markers"]])
        if [len(p) for p in probs["pip_markers"]] != [M] * G or not np.all(
                (pip >= 0) & (pip <= 1)):
            raise AssertionError("inclusion_probs: pip_markers not G lists of m in [0, 1]")
        if abs(probs["pi_markers"] - 0.1) > 1e-7:
            raise AssertionError(f"pi_markers {probs['pi_markers']}, expected the fixed 0.1")
        print(f"  after sweep 2: {int(excluded.sum())} of {CHAINS * G * M} true markers "
              f"excluded, their rows of every chain's saved W0 exactly 0; inclusion_probs: "
              f"{G} branches of {M}, mean pip {pip.mean():.4f}, pi_markers "
              f"{probs['pi_markers']:.7g}")
        series = stats["mse_train"] + stats["mse_test"] + stats["lpd"]
        if len(stats["mse_test"]) != CHAIN + 1 or not all(np.isfinite(series)):
            raise AssertionError(f"non-finite or missing training statistics: {stats}")
        for c in range(CHAINS):
            rows = run_cli(cli, ["predict", os.path.join(work, "test"),
                                 os.path.join(work, "train.groups"), "-m",
                                 os.path.join(run, "models", f"chain{c}"), "--packed-genotypes"])
            card = np.asarray(list(csv.reader(io.StringIO(rows))), np.float64)
            net = Net.load(os.path.join(run, "models", f"chain{c}", f"{CHAIN}.npz"), "cpu")
            cpu_pred = net.predict(test_gen.to_packed(net.arch, "cpu").X).numpy()
            err = np.abs(cpu_pred - card[-1]).max()
            if card.shape != (CHAIN, N_TEST) or not err <= REL_TOL * max(
                    1.0, np.abs(cpu_pred).max()):
                raise AssertionError(f"chain {c}: the card's predictions {card.shape} disagree "
                                     f"with the CPU's by {err}")
        print(f"  predict on each chain's samples, card vs CPU plain version: within "
              f"{REL_TOL} of the largest prediction")
        done = [r for r in log_records if str(r.msg).startswith("Completed training")]
        ssm_sweep_ms = 1000.0 * done[-1].args[0] / CHAIN
        gram_s = [r for r in log_records if str(r.msg).startswith("branch Grams")][-1].args[0]
        print(f"  {ssm_sweep_ms:.1f} ms per sweep of {CHAINS} chains with ss_markers, "
              f"{adapted_sweep_ms:.1f} without (phase 6b); the branch Grams, formed once "
              f"before the sweeps, {1000.0 * gram_s:.1f} ms; train-new {ssm_s:.1f} s in all; "
              f"acceptance {stats['num_accepted'] / stats['num_samples']:.3f}")
        ixs_c = torch.arange(BLOCK, device=dev) * (G // BLOCK)
        X.form_gram()
        scan = scan_block_check(X, carry, arch, ixs_c)
        print(f"  u0 at the block (K9b and the standardization): {scan['u0_ms']:.4f} ms, plain "
              f"(decode, standardize, matmul) {scan['u0_plain_ms']:.3f} ms; identical repeats")
        print(f"  marker_scan at the block ({scan['instances']} instances of {scan['markers']} "
              f"markers, width {arch.layer_out_pad(0)}): kernel {scan['ms']:.4f} ms "
              f"({scan['us_per_marker']:.3f} us per dependent marker step), plain "
              f"{scan['plain_ms']:.3f} ms, bytes bound {scan['bound'][0]:.5f} ms; identical "
              f"repeats")
        ssm_launch = ssm_sweep_launches(hybrid_args + ADAPT_ARGS + SSM_ARGS, arch, state, X,
                                        torch.as_tensor(y_train, dtype=torch.float32,
                                                        device=dev), CHAINS)
        frozen = packed_launches["frozen"]
        print(f"  kernel launches of a sweep that draws z (torch.profiler): {ssm_launch} "
              f"({(ssm_launch - frozen) / (G // BLOCK):+.1f} per block beside phase 6b's frozen "
              f"sweep, {frozen})")
        ssm_run = {"sweep_ms": ssm_sweep_ms, "adapted_sweep_ms": adapted_sweep_ms,
                   "gram_ms": 1000.0 * gram_s,
                   "launches_per_sweep": ssm_launch, "excluded": int(excluded.sum()),
                   "mean_pip": float(pip.mean())}
        del recs, carry

        # ---- phase 6d: checkpoint, resume, train and the analysis commands
        print(f"phase 6d: phase 6c's train-new at burn-in 2, 3 sweeps straight against 1, a "
              f"checkpoint and a resume to 3; train from a sample; branch-r2, "
              f"population-effect-sizes, activations on the card and under --cpu")
        resume_run = resume_phase(cli, work, hybrid_args, ssm_kernels, log_records)

        # ---- phase 7: K7 at the dense flagship's shape
        fdir = os.path.join(work, "flagship")
        t0 = time.perf_counter()
        f_bed, fy_train, fy_test = write_data(fdir, FG, FM, FN_TRAIN, FN_TEST, FCAUSAL)
        farch = NetArch.from_width_rules([FM] * FG, 1, ("fixed", FH), ("fixed", FH),
                                         activation="tanh")
        fgroups = ExternalGrouping.from_file(os.path.join(fdir, "train.groups"))
        fdata = CompressedGenotypes(f_bed, fgroups).to_feature_major(farch, dev)
        xT = fdata.X.xT
        fy = torch.as_tensor(fy_train, dtype=torch.float32, device=dev)
        fgen = torch.Generator(dev).manual_seed(7)
        print(f"phase 7: K7 data_vg_chains vs plain at the dense flagship's shape: xT "
              f"{tuple(xT.shape)}, C {FCHAINS}, tanh depth 1, h = s = {FH} (data "
              f"{time.perf_counter() - t0:.1f} s)")
        # the flagship's initial state, one copy per chain with its weights
        # perturbed (so a mixed-up chain shows), carried to the card as a
        # chain-stacked numpy state
        s0 = P.state_to_numpy(init_net(farch, "ridge_base", InitCfg(seed=0), device="cpu")[0])
        prng = np.random.default_rng(7)

        def stacked(a, sd=0.0):
            return np.stack([a * (1.0 + sd * prng.standard_normal(a.shape))
                             for _ in range(FCHAINS)]).astype(np.float32)

        fchains = P.state_from_numpy(P.NetState(
            P.StackedParams(tuple(stacked(w, 0.1) for w in s0.params.weights),
                            tuple(stacked(b, 0.1) for b in s0.params.biases)),
            P.StackedPrecisions(tuple(map(stacked, s0.precisions.weights)),
                                tuple(map(stacked, s0.precisions.biases)),
                                stacked(s0.precisions.error)),
            stacked(s0.output_bias), stacked(s0.output_bias_precision)), dev)

        def flag_chains(ts):  # [C, G, ...] -> [G, C, ...]
            return tuple(t.transpose(0, 1).contiguous() for t in ts)

        fws = flag_chains(fchains.params.weights)
        fbs = flag_chains(fchains.params.biases)
        ftargets = fy + 0.1 * torch.randn((FG, FCHAINS, FN_TRAIN), device=dev, generator=fgen)
        out = BM.data_vg_chains("tanh", xT, fws, fbs, ftargets)
        ref = BM.data_vg_chains_ref("tanh", xT, fws, fbs, ftargets)
        ref64 = BM.data_vg_chains_ref("tanh", xT.double(), tuple(w.double() for w in fws),
                                      tuple(b.double() for b in fbs), ftargets.double())
        flat7 = lambda r: [r[0], r[1], *r[2], *r[3]]  # noqa: E731
        names = ("y_pred", "rss", "dW0", "dW1", "dw_out", "db0", "db1")
        k7_err = 0.0
        for name, got, want, want64 in zip(names, flat7(out), flat7(ref), flat7(ref64)):
            k7_err = max(k7_err, check_close("data_vg_chains", name, got, want))
            check_close("data_vg_chains f64", f"{name} (f64)", got.double(), want64)
        y_fwd = BM.forward_chains("tanh", xT, fws, fbs)
        k7_err = max(k7_err, check_close("data_vg_chains", "forward-only y_pred", y_fwd,
                                           ref[0]))
        check_close("data_vg_chains f64", "forward-only y_pred (f64)", y_fwd.double(), ref64[0])
        if not torch.equal(y_fwd, out[0]):
            raise AssertionError("K7: the forward-only y_pred differs from the gradient pass's")
        again = BM.data_vg_chains("tanh", xT, fws, fbs, ftargets)
        if not all(torch.equal(a, b) for a, b in zip(flat7(out), flat7(again))):
            raise AssertionError("K7: two calls with the same inputs differ")
        if not torch.equal(y_fwd, BM.forward_chains("tanh", xT, fws, fbs)):
            raise AssertionError("K7 forward-only: two calls with the same inputs differ")
        del out, ref, ref64, again, y_fwd
        fm, fk0, fs = xT.shape[1], fws[0].shape[-1], fws[-1].shape[-2]
        P7 = fm * fk0 + fk0 + fk0 * fs + fs + fs

        def k7_launch_ms(grad, reps=20):
            """CUDA-event ms of one K7 call of the C entry (forward only, or
            the pass and its fixed-order reduce), from runs of ``reps``
            back-to-back calls on buffers made once."""
            plan = BM.vg_chains_plan(FG, FCHAINS, fm, FN_TRAIN, fk0, fs, 1, grad)
            keep, ptrs, strides = BM.chain_instances(ftargets if grad else None, fws, fbs,
                                                     xT.device)
            per7 = FG * FCHAINS
            out7 = torch.empty(per7 * (FN_TRAIN + P7 + 1) if grad else per7 * FN_TRAIN, device=dev)
            scratch = torch.empty(max(plan["scratch"], 8), dtype=torch.uint8, device=dev)
            vp = ctypes.c_void_p
            c_args = (vp(xT.data_ptr()), (vp * 6)(*ptrs), (ctypes.c_longlong * 24)(*strides),
                      vp(out7.data_ptr()), vp(scratch.data_ptr()), plan["scratch"], FG, FCHAINS,
                      fm, FN_TRAIN, fk0, fs, 1, ACT_CODES["tanh"], int(grad),
                      vp(_build.stream_ptr(xT)))
            lib = _build.lib()

            def run():
                for _ in range(reps):
                    _build.check(lib.vg_chains_f32(*c_args), "vg_chains_f32")

            ms = cuda_ms(run) / reps
            del keep, out7, scratch
            return ms, plan

        k7_ms, k7_plan = k7_launch_ms(False)
        k7_grad_ms, k7_grad_plan = k7_launch_ms(True)
        k7_wrapper_ms = cuda_ms(lambda: BM.forward_chains("tanh", xT, fws, fbs))
        k7_grad_wrapper_ms = cuda_ms(lambda: BM.data_vg_chains("tanh", xT, fws, fbs, ftargets))
        k7_plain_ms = cuda_ms(lambda: BM.forward_chains_ref("tanh", xT, fws, fbs))
        k7_grad_plain_ms = cuda_ms(lambda: BM.data_vg_chains_ref("tanh", xT, fws, fbs, ftargets))
        per = FG * FCHAINS * FN_TRAIN
        param_bytes = nbytes(*fws, *fbs)
        k7_bytes = nbytes(xT) + param_bytes + 4 * per  # X and the weights in, y_pred out
        k7_grad_bytes = k7_bytes + nbytes(ftargets) + param_bytes + 4 * FG * FCHAINS
        k7_f32_bound = bound(2 * per * mlp_fmas(fm, fk0, fs, 1, grad=False), k7_bytes)
        k7_grad_f32_bound = bound(2 * per * mlp_fmas(fm, fk0, fs, 1), k7_grad_bytes)

        # as implemented: Z0 and Z1 forward; with the gradient the five products
        k7_bound = tf32_bound(2 * per * (fm * fk0 + fk0 * fs), k7_bytes)
        k7_grad_bound = tf32_bound(2 * per * (2 * fm * fk0 + 3 * fk0 * fs), k7_grad_bytes)
        print(f"  forward only: launch {k7_ms:.4f} ms (wrapper {k7_wrapper_ms:.4f} ms), plain "
              f"{k7_plain_ms:.3f} ms, bound {k7_bound[0]:.4f} ms ({k7_bound[1]}; 3xTF32 as "
              f"implemented; f32 {k7_f32_bound[0]:.4f} ms); plan {k7_plan}; identical repeat")
        print(f"  value and gradient: launch {k7_grad_ms:.4f} ms (the pass and its reduce; "
              f"wrapper {k7_grad_wrapper_ms:.4f} ms), plain {k7_grad_plain_ms:.3f} ms, bound "
              f"{k7_grad_bound[0]:.4f} ms ({k7_grad_bound[1]}; f32 {k7_grad_f32_bound[0]:.4f} "
              f"ms); plan {k7_grad_plan}; identical repeat")

        # ---- phase 8: K6 at the same shape
        print(f"phase 8: K6 integrate_chains vs plain at the same shape, L = 1, 8, {FL}")
        fwp = flag_chains(fchains.precisions.weights)
        fbp = flag_chains(fchains.precisions.biases)
        f_eps_w, f_eps_b = H.step_sizes(None, "ridge_base", MCMCCfg(hmc_integration_length=FL),
                                        fws, fbs, fwp, fbp, None)
        f_pw = tuple(torch.randn(w.shape, device=dev, generator=fgen) * m[:, None]
                     for w, m in zip(fws, P.weight_masks(farch, dev)))
        f_pb = tuple(torch.randn(b.shape, device=dev, generator=fgen) * m[:, None]
                     for b, m in zip(fbs, P.bias_masks(farch, dev)))
        f_lam_w = tuple(lam.expand_as(w) for lam, w in zip(fwp, fws))
        f_lam_b = tuple(torch.zeros_like(b) for b in fbs)
        ferr = torch.full((FG, FCHAINS), 1.0 / fy.var().item(), device=dev)
        k6_err, k6_errs = 0.0, {}
        for steps, tol in ((1, REL_TOL), (8, REL_TOL_TRAJ), (FL, REL_TOL_TRAJ)):
            args = (xT, ftargets, ferr, fws, fbs, f_pw, f_pb, f_eps_w, f_eps_b, f_lam_w, f_lam_b,
                    steps)
            out = LF.integrate_chains("tanh", *args)
            ref = LF.integrate_chains_ref("tanh", *args)
            names = ("W0", "W1", "w_out", "b0", "b1", "pW0", "pW1", "pw_out", "pb0", "pb1")
            errs = [check_close("traj_dense", f"L={steps} {name}", got, want, tol)
                    for name, got, want in
                    zip(names, [t for o in out for t in o], [t for r in ref for t in r])]
            k6_errs[steps] = max(errs)
            k6_err = max(k6_err, k6_errs[steps])
            again = LF.integrate_chains("tanh", *args)
            if not all(torch.equal(a, b) for o, o2 in zip(out, again) for a, b in zip(o, o2)):
                raise AssertionError("K6: two calls with the same inputs differ")
            moved = (out[0][0] - fws[0]).abs().max().item()
            del out, ref, again
            if steps == 8:
                continue
            ms = cuda_ms(lambda: LF.integrate_chains("tanh", *args))
            plain_ms = cuda_ms(lambda: LF.integrate_chains_ref("tanh", *args))
            # each input read once (X, targets, err, positions, momenta, step
            # sizes, prior factors) and the end written once
            k6_bytes = nbytes(xT, ftargets, ferr) + 6 * param_bytes
            x_stream_ms = 1e3 * (steps + 1) * nbytes(xT) / PEAK_BYTES_S  # X once per evaluation
            k6_f32_bound = bound(2 * per * (steps + 1) * mlp_fmas(fm, fk0, fs, 1), k6_bytes)
            # as implemented: the five products of each evaluation in 3xTF32
            # (three tf32 tensor-core products per f32 one) at the tf32 peak
            k6_bound = tf32_bound(2 * per * (steps + 1) * (2 * fm * fk0 + 3 * fk0 * fs), k6_bytes)
            plan = LF.traj_dense_plan(FG, FCHAINS, fm, FN_TRAIN, fk0, fs, 1, "tanh")
            print(f"  L={steps}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                  f"{k6_bound[0]:.3f} ms ({k6_bound[1]}; 3xTF32 as implemented; f32 "
                  f"{k6_f32_bound[0]:.3f} ms; X read once per evaluation {x_stream_ms:.3f} ms), "
                  f"identical repeat, max |W0_L - W0_0| {moved:.3e}; {plan['ctas']} CTAs of "
                  f"{plan['cc']} chains")
            k6_ms, k6_plain_ms = ms, plain_ms  # the main path's L
        print("  max abs err against L: " + ", ".join(f"L={k} {v:.3e}" for k, v in k6_errs.items()))
        # phase 9b's fold: per-coordinate step sizes of the adaptation, read
        # where they lie in the fold's transposed views
        a_eps_w, a_eps_b = adapted_step_sizes("ridge_base", FL, fws, fbs, fwp, fbp, 9)
        if a_eps_w[0].is_contiguous() or a_eps_w[0].stride(-1) != 1:
            raise AssertionError("the adapted step sizes are not the fold's transposed views")
        for steps, tol in ((1, REL_TOL), (FL, REL_TOL_TRAJ)):
            args = (xT, ftargets, ferr, fws, fbs, f_pw, f_pb, a_eps_w, a_eps_b, f_lam_w, f_lam_b,
                    steps)
            out = LF.integrate_chains("tanh", *args)
            ref = LF.integrate_chains_ref("tanh", *args)
            for name, got, want in zip(names, [t for o in out for t in o],
                                       [t for r in ref for t in r]):
                k6_err = max(k6_err, check_close(
                    "traj_dense", f"adapted step sizes, L={steps} {name}", got, want, tol))
            identical(lambda: tuple(t for o in LF.integrate_chains("tanh", *args) for t in o),
                      tuple(t for o in out for t in o), f"K6 with adapted step sizes, L={steps}")
            del out, ref
        k6_adapted_ms = cuda_ms(lambda: LF.integrate_chains("tanh", *args))
        print(f"  adapted step sizes (phase 9b's fold, [C, G] -> [G, C] views): identical "
              f"repeats; L={FL}: kernel {k6_adapted_ms:.3f} ms (izmailov {k6_ms:.3f} ms)")
        del fws, fbs, ftargets, f_pw, f_pb, f_eps_w, f_eps_b, f_lam_w, f_lam_b, fdata, xT, fchains
        del a_eps_w, a_eps_b

        # ---- phase 9: the dense flagship through the CLI
        print(f"phase 9: train-new --feat-major --update-mode parallel --num-chains {FCHAINS} "
              f"-> predict (G {FG}, m {FM}, n {FN_TRAIN}, tanh depth 1, h = s = {FH}, L {FL})")
        for counted in (PM.packed_linear, BM.data_vg_packed, LF.integrate_chains_packed,
                        BM.data_vg_chains, LF.integrate_chains):
            counted.launches = 0
        mse_k7 = [0]  # K7 launches inside the per-sweep test mse
        net_mse = Net.mse

        def counted_mse(self, *a, **kw):
            before = BM.data_vg_chains.launches
            try:
                return net_mse(self, *a, **kw)
            finally:
                mse_k7[0] += BM.data_vg_chains.launches - before

        Net.mse = counted_mse
        flag_args = [
            "train-new", os.path.join(fdir, "train"), os.path.join(fdir, "train.phen"),
            os.path.join(fdir, "train.groups"), "ridge_base", "tanh", "1", CHAIN, FL,
            "--fixed-hidden-layer-width", FH, "--fixed-summary-layer-width", FH,
            "--feat-major", "--update-mode", "parallel", "--num-chains", FCHAINS,
            "--burn-in", "1", "--bfile-test", os.path.join(fdir, "test"),
            "--p-test", os.path.join(fdir, "test.phen"), "-o", runs,
        ]
        t0 = time.perf_counter()
        try:
            run = run_cli(cli, flag_args).strip().splitlines()[-1]
        finally:
            Net.mse = net_mse
        flag_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        k6_launches, k7_train = LF.integrate_chains.launches, BM.data_vg_chains.launches
        k4_flag, k5_flag = BM.data_vg_packed.launches, LF.integrate_chains_packed.launches
        chain_preds = []
        for c in range(FCHAINS):
            rows = run_cli(cli, ["predict", os.path.join(fdir, "test"),
                                 os.path.join(fdir, "train.groups"), "-m",
                                 os.path.join(run, "models", f"chain{c}")])
            chain_preds.append(np.asarray(list(csv.reader(io.StringIO(rows))), np.float64))
        torch.cuda.synchronize()
        k7_launches = k7_train - mse_k7[0]
        print(f"  kernel launches in train-new: traj_dense {k6_launches}, data_vg_chains "
              f"{k7_launches} in the sweeps and {mse_k7[0]} in the per-sweep test mse, "
              f"data_vg_packed {k4_flag}, traj_packed {k5_flag}; data_vg_chains in predict "
              f"{BM.data_vg_chains.launches - k7_train}")
        if k6_launches != CHAIN:
            raise AssertionError(f"integrate_chains launched {k6_launches} times, expected {CHAIN}")
        if k7_launches != 2 * CHAIN:
            raise AssertionError(f"data_vg_chains launched {k7_launches} times in the sweeps, "
                                 f"expected {2 * CHAIN}")
        if k4_flag or k5_flag:
            raise AssertionError("the dense flagship launched a packed kernel")
        stats = json.load(open(os.path.join(run, "training_stats")))
        series = stats["mse_train"] + stats["mse_test"] + stats["lpd"]
        if len(stats["mse_test"]) != CHAIN + 1 or not all(np.isfinite(series)):
            raise AssertionError(f"non-finite or missing training statistics: {stats}")
        if stats["num_samples"] != CHAIN * FG * FCHAINS:
            raise AssertionError(f"{stats['num_samples']} branch updates counted, "
                                 f"expected {CHAIN * FG * FCHAINS}")
        preds = np.concatenate(chain_preds)
        if preds.shape != (FCHAINS * CHAIN, FN_TEST) or not np.all(np.isfinite(preds)):
            raise AssertionError(f"flagship predictions of shape {preds.shape}, finite: "
                                 f"{np.all(np.isfinite(preds))}")
        done = [r for r in log_records if str(r.msg).startswith("Completed training")]
        flag_sweep_ms = 1000.0 * done[-1].args[0] / CHAIN
        r2_f = 1.0 - np.mean((fy_test - preds.mean(axis=0)) ** 2) / np.var(fy_test)
        print(f"  {flag_sweep_ms:.1f} ms per sweep of {FCHAINS} chains, "
              f"{flag_sweep_ms / FCHAINS:.1f} ms per chain-sweep; train-new {flag_s:.1f} s in all")
        print(f"  acceptance {stats['num_accepted'] / stats['num_samples']:.3f}, "
              f"early rejection {stats['num_early_rejected'] / stats['num_samples']:.3f}")
        print(f"  mse train {stats['mse_train'][-1]:.4f}, mse test {stats['mse_test'][-1]:.4f}, "
              f"test r2 of the {FCHAINS}-chain posterior mean {r2_f:.4f}")
        net = Net.load(os.path.join(run, "models", "chain0", f"{CHAIN}.npz"), "cpu")
        f_test = CompressedGenotypes(BedVM.from_file(os.path.join(fdir, "test")), fgroups)
        cpu_pred = net.predict(f_test.to_stacked(net.arch, "cpu").X).numpy()
        err = np.abs(cpu_pred - chain_preds[0][-1]).max()
        print(f"  predict, card vs CPU plain version: max_abs_err {err:.3e}")
        if not err <= REL_TOL * max(1.0, np.abs(cpu_pred).max()):
            raise AssertionError("the card's flagship predictions disagree with the CPU's")

        # ---- phase 9b: the flagship with the recipe's adaptation
        print(f"phase 9b: phase 9's train-new with {' '.join(ADAPT_ARGS)} -> predict")
        dense_kernels = {"integrate_chains": LF.integrate_chains,
                         "data_vg_chains": BM.data_vg_chains,
                         "integrate_chains_packed": LF.integrate_chains_packed,
                         "data_vg_packed": BM.data_vg_packed}
        for counted in dense_kernels.values():
            counted.launches = 0
        t0 = time.perf_counter()
        run, recs = recorded_run(cli, flag_args + ADAPT_ARGS, dense_kernels)
        flag_adapted_s = time.perf_counter() - t0
        k6_adapted = LF.integrate_chains.launches
        k7_adapted = sum(r["launches"]["data_vg_chains"] for r in recs)
        print(f"  kernel launches per sweep: {[r['launches'] for r in recs]}")
        # per sweep, as phase 9: one K6 launch and two K7 value passes
        stats = json.load(open(os.path.join(run, "training_stats")))
        flag_factors = check_adapted(recs, stats, FCHAINS, {
            "integrate_chains": 1, "data_vg_chains": 2, "integrate_chains_packed": 0,
            "data_vg_packed": 0})
        series = stats["mse_train"] + stats["mse_test"] + stats["lpd"]
        if len(stats["mse_test"]) != CHAIN + 1 or not all(np.isfinite(series)):
            raise AssertionError(f"non-finite or missing training statistics: {stats}")
        chain_preds = []
        for c in range(FCHAINS):
            rows = run_cli(cli, ["predict", os.path.join(fdir, "test"),
                                 os.path.join(fdir, "train.groups"), "-m",
                                 os.path.join(run, "models", f"chain{c}")])
            chain_preds.append(np.asarray(list(csv.reader(io.StringIO(rows))), np.float64))
        preds = np.concatenate(chain_preds)
        if preds.shape != (FCHAINS * CHAIN, FN_TEST) or not np.all(np.isfinite(preds)):
            raise AssertionError(f"adapted flagship predictions of shape {preds.shape}, "
                                 f"finite: {np.all(np.isfinite(preds))}")
        done = [r for r in log_records if str(r.msg).startswith("Completed training")]
        flag_adapted_ms = 1000.0 * done[-1].args[0] / CHAIN
        r2_fa = 1.0 - np.mean((fy_test - preds.mean(axis=0)) ** 2) / np.var(fy_test)
        print(f"  {flag_adapted_ms:.1f} ms per sweep of {FCHAINS} chains with the adaptation, "
              f"{flag_sweep_ms:.1f} without (phase 9); train-new {flag_adapted_s:.1f} s in all")
        print(f"  mse train {stats['mse_train'][-1]:.4f}, mse test {stats['mse_test'][-1]:.4f}, "
              f"test r2 of the {FCHAINS}-chain posterior mean {r2_fa:.4f}")
        net = Net.load(os.path.join(run, "models", "chain0", f"{CHAIN}.npz"), "cpu")
        cpu_pred = net.predict(f_test.to_stacked(net.arch, "cpu").X).numpy()
        err = np.abs(cpu_pred - chain_preds[0][-1]).max()
        print(f"  predict, card vs CPU plain version: max_abs_err {err:.3e}")
        if not err <= REL_TOL * max(1.0, np.abs(cpu_pred).max()):
            raise AssertionError("the card's adapted flagship predictions disagree with the CPU's")
        fdata = CompressedGenotypes(f_bed, fgroups).to_feature_major(farch, dev, fy_train)
        flag_launches = sweep_launches(
            flag_args, "ridge_base", farch,
            init_net(farch, "ridge_base", InitCfg(seed=0), device=dev)[0], fdata.X, fdata.y,
            FCHAINS, 1)
        adapted_runs["flagship"] = {
            "sweep_ms": flag_adapted_ms, "unadapted_sweep_ms": flag_sweep_ms,
            "k6_launches": k6_adapted, "k7_launches": k7_adapted, "factors": flag_factors,
            "launches_per_sweep": flag_launches}
        del recs, fdata

        # ---- phase 10: K9a, K3 and K9b at the slice's full shape
        print(f"phase 10: K9a packed_matmul, K3 packed_linear_vjp and K9b packed_matmul_vjp vs "
              f"plain, bytes {tuple(X.bytes.shape)}, k {W0.shape[-1]}, n {N_TRAIN}")
        ggen = torch.Generator(dev).manual_seed(10)
        # the forward's operands at the initial state, perturbed
        W0p = W0 * (1.0 + 0.1 * torch.randn(W0.shape, device=dev, generator=ggen))
        A = X.w_scale.unsqueeze(-1) * W0p
        off = b0 - (X.shift.unsqueeze(-2) @ A).squeeze(-2)
        k = A.shape[-1]
        cot = torch.randn((G, N_TRAIN, k), device=dev, generator=ggen)  # the cotangent g
        flop = 2 * G * X.bytes.shape[1] * N_TRAIN * k
        out_bytes = 4 * G * N_TRAIN * k

        k9a_err = check_close("packed_matmul", "Z", PM.packed_matmul(X.bytes, A, N_TRAIN),
                              PM.packed_matmul_ref(X.bytes, A, N_TRAIN))
        identical(lambda: PM.packed_matmul(X.bytes, A, N_TRAIN),
                  PM.packed_matmul(X.bytes, A, N_TRAIN), "K9a")
        k9a_ms = cuda_ms(lambda: PM.packed_matmul(X.bytes, A, N_TRAIN))
        k9a_plain_ms = cuda_ms(lambda: PM.packed_matmul_ref(X.bytes, A, N_TRAIN))
        k9a_nbytes = nbytes(X.bytes, A) + out_bytes
        k9a_bound, k9a_f32_bound = tc_bound(flop, k9a_nbytes), bound(flop, k9a_nbytes)
        print(f"  K9a G={G}, k={k}: kernel {k9a_ms:.3f} ms, plain {k9a_plain_ms:.3f} ms, bound "
              f"{k9a_bound[0]:.3f} ms ({k9a_bound[1]}; f32 FMA {k9a_f32_bound[0]:.3f} ms), "
              f"{100 * k9a_bound[0] / k9a_ms:.1f}% of it; identical repeat")
        # K9a at the silu hybrid value pass: one block's bytes, C chains side
        # by side, at the stored width and at the live one the value passes take
        w_cb = tuple(t.transpose(0, 1).contiguous() for t in chains_of((W0p, Wout)))
        b_cb = tuple(t.transpose(0, 1).contiguous() for t in chains_of((b0,)))
        for width in (w_cb[0].shape[-1], vp_live):
            A_c, _ = D.chain_layer0(w_cb[0][..., :width], b_cb[0][..., :width], x_b)
            kc = A_c.shape[-1]
            got = PM.packed_matmul(x_b.bytes, A_c, N_TRAIN)
            k9a_err = max(k9a_err, check_close(
                "packed_matmul", f"Z, value pass B={BLOCK}, k={kc}", got,
                PM.packed_matmul_ref(x_b.bytes, A_c, N_TRAIN)))
            identical(lambda: PM.packed_matmul(x_b.bytes, A_c, N_TRAIN), got, "K9a value pass")
            del got
            vp_ms = cuda_ms(lambda: PM.packed_matmul(x_b.bytes, A_c, N_TRAIN))
            vp_plain_ms = cuda_ms(lambda: PM.packed_matmul_ref(x_b.bytes, A_c, N_TRAIN))
            vp_flop = 2 * BLOCK * x_b.bytes.shape[1] * N_TRAIN * kc
            vp_nbytes = nbytes(x_b.bytes, A_c) + 4 * BLOCK * N_TRAIN * kc
            vp_bound, vp_f32 = tc_bound(vp_flop, vp_nbytes), bound(vp_flop, vp_nbytes)
            print(f"  K9a value pass B={BLOCK}, k={kc}: kernel {vp_ms:.3f} ms, plain "
                  f"{vp_plain_ms:.3f} ms, bound {vp_bound[0]:.3f} ms ({vp_bound[1]}; f32 FMA "
                  f"{vp_f32[0]:.3f} ms), {100 * vp_bound[0] / vp_ms:.1f}% of it; identical repeat")
            del A_c
        k9a_vp = {"value_pass_k": kc, "value_pass_ms": vp_ms, "value_pass_plain_ms": vp_plain_ms,
                  "value_pass_bound_ms": vp_bound[0], "value_pass_f32_bound_ms": vp_f32[0]}
        del w_cb, b_cb

        # K3 (every fused activation) and K9b at G = 100 (one `gradients`
        # sample) and at the GD warm start's block (its first 10 branches:
        # 800 launches per warm-start sweep), each against the f32 plain
        # version and the plain version in f64 (no further from it than the
        # f32 plain version, plus REL_TOL); the bound from the bytes as
        # implemented: the saved output only where h' reads it (not at
        # identity, not for K9b), dA and d_off written once
        bwd_err = {"packed_linear_vjp": 0.0, "packed_matmul_vjp": 0.0}
        bwd_runs = {}  # (shape, activation or None for K9b) -> times and bounds
        for shape, nb in (("G=100", G), ("warm-start block", BLOCK)):
            xb, cot_b = X.bytes[:nb], cot[:nb]
            x64 = PM.unpack_strided(xb, N_TRAIN).double()
            flop_b = 2 * nb * xb.shape[1] * N_TRAIN * k
            for act in PM.FUSED_ACTIVATIONS + (None,):
                name = "packed_linear_vjp" if act else "packed_matmul_vjp"
                tag = f"{'K3 ' + act if act else 'K9b'} {shape}"
                if act:
                    res = PM.packed_linear_ref(xb, A[:nb], off[:nb], N_TRAIN, act)  # saved output
                    fn = lambda: PM.packed_linear_vjp(xb, cot_b, res, N_TRAIN, act)  # noqa: E731
                    ref_fn = lambda: PM.packed_linear_vjp_ref(xb, cot_b, res, N_TRAIN,  # noqa: E731
                                                              act)
                    dz64 = cot_b.double() * prime_from_out(act, res).double()
                    want64 = (x64 @ dz64, dz64.sum(dim=-2))
                    del dz64
                else:
                    res = None
                    fn = lambda: (PM.packed_matmul_vjp(xb, cot_b, N_TRAIN),)  # noqa: E731
                    ref_fn = lambda: (PM.packed_matmul_vjp_ref(xb, cot_b, N_TRAIN),)  # noqa: E731
                    want64 = (x64 @ cot_b.double(),)
                got, want = fn(), ref_fn()
                for out_name, a, b, c in zip(("dA", "d_off"), got, want, want64):
                    bwd_err[name] = max(bwd_err[name], check_close(name, f"{tag} {out_name}", a, b))
                    plain64 = (b.double() - c).abs().max().item() / max(1.0, c.abs().max().item())
                    check_close(f"{name} f64", f"{tag} {out_name} (f64; the f32 plain version "
                                f"{plain64:.3e})", a.double(), c, tol=plain64 + REL_TOL)
                identical(fn, got, tag)
                del got, want, want64
                if act in ("identity", "tanh", None):
                    ms, plain_ms = cuda_ms(fn), cuda_ms(ref_fn)
                    moved = nbytes(xb, cot_b) + 4 * nb * xb.shape[1] * k
                    if act:
                        moved += 4 * nb * k + (nbytes(res) if act != "identity" else 0)
                    tc, f32 = tc_bound(flop_b, moved), bound(flop_b, moved)
                    print(f"  {tag}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                          f"{tc[0]:.3f} ms ({tc[1]}, {moved / 1e6:.1f} MB; f32 FMA {f32[0]:.3f} "
                          f"ms), {100 * tc[0] / ms:.1f}% of it; identical repeat")
                    bwd_runs[shape, act] = {"ms": ms, "plain_ms": plain_ms, "bound": tc,
                                            "f32_bound_ms": f32[0]}
                del res
            del x64

        del X, state, x_b, A, off, cot, W0p

        # ---- phases 11 and 12: the GD warm start, hybrid sampling, predict and
        # gradients through the CLI, identity (K2 + K3) and silu (K9a + K9b)
        counted = {"packed_linear": PM.packed_linear, "packed_matmul": PM.packed_matmul,
                   "packed_linear_vjp": PM.packed_linear_vjp,
                   "packed_matmul_vjp": PM.packed_matmul_vjp,
                   "data_vg_packed": BM.data_vg_packed,
                   "traj_packed": LF.integrate_chains_packed}
        warm_counts = {}

        def snapshot(record):  # the counts when the trainer logs its warm start
            if str(record.msg).startswith("gd warm start"):
                warm_counts.update({n: f.launches for n, f in counted.items()})

        warm_handler = logging.Handler()
        warm_handler.emit = snapshot
        logging.getLogger("rs_bann_tpu_torch").addHandler(warm_handler)
        blocks, gd_steps = G // BLOCK, min(L, 20)
        gd_runs = {}
        for phase, act in ((11, "identity"), (12, "silu")):
            fwd = "packed_linear" if act == "identity" else "packed_matmul"
            bwd = "packed_linear_vjp" if act == "identity" else "packed_matmul_vjp"
            print(f"phase {phase}: {act}: train-new --update-mode hybrid --num-chains {CHAINS} "
                  f"--gd-warmup 1 ({CHAIN} sweeps of L {L}) -> predict, gradients")
            for f in counted.values():
                f.launches = 0
            warm_counts.clear()
            mse_fwd = [0]  # forward launches inside the per-sweep test mse

            def counted_mse(self, *a, **kw):
                before = counted[fwd].launches
                try:
                    return net_mse(self, *a, **kw)
                finally:
                    mse_fwd[0] += counted[fwd].launches - before

            Net.mse = counted_mse
            argv = list(train_args)
            i = argv.index("identity")
            argv[i] = act
            t0 = time.perf_counter()
            try:
                run = run_cli(cli, argv + ["--update-mode", "hybrid", "--num-chains", CHAINS,
                                           "--gd-warmup", "1"]).strip().splitlines()[-1]
            finally:
                Net.mse = net_mse
            gd_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            total = {n: f.launches for n, f in counted.items()}
            warm = dict(warm_counts)
            sweeps = {n: total[n] - warm[n] for n in total}
            sweeps[fwd] -= mse_fwd[0]
            print(f"  kernel launches in the warm start: {warm}")
            print(f"  in the {CHAIN} sweeps: {sweeps}; in the per-sweep test mse: "
                  f"{fwd} {mse_fwd[0]}")
            want = {bwd: CHAINS * blocks * gd_steps, "traj_packed": 0, "data_vg_packed": 0}
            for n, v in want.items():
                if warm[n] != v:
                    raise AssertionError(f"warm start: {n} launched {warm[n]} times, expected {v} "
                                         f"(each block's branches batched: chains x blocks x "
                                         f"iterations)")
            if warm[fwd] < 4 * want[bwd]:  # per iteration one gradient and >= 3 probes
                raise AssertionError(f"warm start: {fwd} launched {warm[fwd]} times")
            want = {fwd: 2 * blocks * CHAIN, "traj_packed": blocks * CHAIN, bwd: 0,
                    "data_vg_packed": 0}
            for n, v in want.items():
                if sweeps[n] != v:
                    raise AssertionError(f"sweeps: {n} launched {sweeps[n]} times, expected {v}")
            other = [n for n in ("packed_linear", "packed_matmul", "packed_linear_vjp",
                                 "packed_matmul_vjp") if n not in (fwd, bwd)]
            if any(total[n] for n in other):
                raise AssertionError(f"{act} launched {[(n, total[n]) for n in other]}")
            print(f"  batched over each block: {want[fwd] // 2} value-pass pairs, "
                  f"{CHAINS * blocks * gd_steps} {bwd} launches = chains x blocks x "
                  f"min(L, 20)")
            stats = json.load(open(os.path.join(run, "training_stats")))
            series = stats["mse_train"] + stats["mse_test"] + stats["lpd"]
            if len(stats["mse_test"]) != CHAIN + 1 or not all(np.isfinite(series)):
                raise AssertionError(f"non-finite or missing training statistics: {stats}")
            if stats["num_samples"] != CHAIN * G * CHAINS:
                raise AssertionError(f"{stats['num_samples']} branch updates counted, "
                                     f"expected {CHAIN * G * CHAINS}")
            warm_rec = [r for r in log_records if str(r.msg).startswith("gd warm start")][-1]
            done = [r for r in log_records if str(r.msg).startswith("Completed training")][-1]
            warm_ms, sweep_ms = 1000.0 * warm_rec.args[1], 1000.0 * done.args[0] / CHAIN
            print(f"  warm start {warm_ms:.1f} ms (one GD sweep of {CHAINS} chains); "
                  f"{sweep_ms:.1f} ms per sweep, {sweep_ms / CHAINS:.1f} ms per chain-sweep; "
                  f"train-new {gd_s:.1f} s in all")
            print(f"  acceptance {stats['num_accepted'] / stats['num_samples']:.3f}, "
                  f"early rejection {stats['num_early_rejected'] / stats['num_samples']:.3f}; "
                  f"mse train {stats['mse_train'][-1]:.4f}, mse test {stats['mse_test'][-1]:.4f}")
            models = os.path.join(run, "models", "chain0")
            if act == "silu":  # predict on the card (K9a) against the CPU
                before = PM.packed_matmul.launches
                rows = run_cli(cli, ["predict", os.path.join(work, "test"),
                                     os.path.join(work, "train.groups"), "-m", models,
                                     "--packed-genotypes"])
                card = np.asarray(list(csv.reader(io.StringIO(rows))), np.float64)
                if PM.packed_matmul.launches - before != CHAIN:
                    raise AssertionError("predict did not launch packed_matmul once per sample")
                net = Net.load(os.path.join(models, f"{CHAIN}.npz"), "cpu")
                cpu_pred = net.predict(test_gen.to_packed(net.arch, "cpu").X).numpy()
                err = np.abs(cpu_pred - card[-1]).max()
                print(f"  predict, card vs CPU plain version: max_abs_err {err:.3e}")
                scale = max(1.0, np.abs(cpu_pred).max())
                if not (np.all(np.isfinite(card)) and err <= REL_TOL * scale):
                    raise AssertionError("the card's silu predictions disagree with the CPU's")
            # gradients on the test set, on the card and on the CPU
            grads = {}
            for where in ("card", "cpu"):
                before = {n: counted[n].launches for n in (fwd, bwd)}
                t0 = time.perf_counter()
                gdir = run_cli(cli, ["gradients", os.path.join(work, "test"),
                                     os.path.join(work, "test.phen"),
                                     os.path.join(work, "train.groups"), "-m", models,
                                     "--packed-genotypes"] + (["--cpu"] if where == "cpu" else [])
                               ).strip().splitlines()[-1]
                secs = time.perf_counter() - t0
                grads[where] = {f: json.load(open(os.path.join(gdir, f)))
                                for f in sorted(os.listdir(gdir))}
                used = {n: counted[n].launches - before[n] for n in (fwd, bwd)}
                print(f"  gradients on the {where} ({N_TEST} test individuals): {secs:.1f} s, "
                      f"launches {used}")
                want_n = len(grads[where]) if where == "card" else 0
                if used != {fwd: want_n, bwd: want_n}:
                    raise AssertionError(f"gradients launched {used}, expected {want_n} each")
            if sorted(grads["card"]) != sorted(grads["cpu"]) or not grads["card"]:
                raise AssertionError("gradients wrote other files on the card and the CPU")
            worst = 0.0
            for f in grads["card"]:
                for bc, bp in zip(grads["card"][f], grads["cpu"][f]):
                    for key in ("wrt_weights", "wrt_biases"):
                        for a, b in zip(bc[key], bp[key]):
                            a, b = np.asarray(a), np.asarray(b)
                            if a.shape != b.shape or not np.all(np.isfinite(a)):
                                raise AssertionError(f"gradient {key} of shape {a.shape}")
                            rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
                            worst = max(worst, rel)
            print(f"  gradients, card vs CPU plain version: worst max_abs_err / max |CPU| "
                  f"{worst:.3e} over {len(grads['card'])} samples x {G} branches")
            if not worst <= REL_TOL:
                raise AssertionError("the card's gradients disagree with the CPU's")
            gd_runs[act] = {"launches": total, "warm_ms": warm_ms, "sweep_ms": sweep_ms}
        logging.getLogger("rs_bann_tpu_torch").removeHandler(warm_handler)

        # ---- phase 13: K8a and K8b at the dense flagship's shape
        xT = CompressedGenotypes(f_bed, fgroups).to_feature_major(farch, dev).X.xT
        print(f"phase 13: K8a data_vg and K8b data_vg_blocked vs plain at the dense flagship's "
              f"shape: xT {tuple(xT.shape)}, tanh depth 1, h = s = {FH}")
        k8gen = np.random.default_rng(13)

        def instances(ix):  # the initial state's branches ix, each instance perturbed
            def one(tree):
                return tuple(torch.as_tensor(
                    (a[ix] * (1.0 + 0.1 * k8gen.standard_normal((len(ix),) + a.shape[1:])))
                    .astype(np.float32), device=dev) for a in tree)

            return one(s0.params.weights), one(s0.params.biases)

        def k8_launch_ms(X, ix, ws, bs, targets, reps=20):
            """CUDA-event ms of one K8 call of the C entry (the pass and its
            fixed-order reduce, rss included), from runs of ``reps``
            back-to-back calls on buffers made once."""
            NB, (_, m, n) = ws[0].shape[0], X.shape
            k0, s = ws[0].shape[-1], ws[-1].shape[-2]
            P = m * k0 + k0 + k0 * s + s + s
            plan = BM.vg_dense_plan(NB, m, n, k0, s, 1)
            out = torch.empty(NB * (n + P + 1), device=dev)
            scratch = torch.empty(plan["scratch"], dtype=torch.uint8, device=dev)
            vp = ctypes.c_void_p
            c_args = (vp(X.data_ptr()), vp(0 if ix is None else ix.data_ptr()),
                      vp(targets.data_ptr()), vp(ws[0].data_ptr()), vp(bs[0].data_ptr()),
                      vp(ws[1].data_ptr()), vp(bs[1].data_ptr()), vp(ws[2].data_ptr()),
                      vp(out.data_ptr()), vp(scratch.data_ptr()), plan["scratch"], NB, m, n, k0,
                      s, 1, ACT_CODES["tanh"], 1, vp(_build.stream_ptr(X)))
            lib = _build.lib()

            def run():
                for _ in range(reps):
                    _build.check(lib.vg_dense_f32(*c_args), "vg_dense_f32")

            return cuda_ms(run) / reps

        def k8_case(name, label, fn, ref, args, ix_x, nb, raw):
            """Check, repeat and time one K8 call (the wrapper, and with ``raw``
            = (X, ix, weights, biases, targets) with a leading instance axis,
            the launch alone); returns (err, ms, wrapper ms, plain ms, bound,
            f32 bound)."""
            out, want = fn(*args), ref(*args)
            names = ("y_pred", "rss", "dW0", "dW1", "dw_out", "db0", "db1")
            err = max(check_close(name, f"{label} {nm}", got, w) for nm, got, w in
                      zip(names, [out[0], out[1], *out[2], *out[3]],
                          [want[0], want[1], *want[2], *want[3]]))
            again = fn(*args)
            if not all(torch.equal(a, b) for a, b in zip([out[0], *out[2], *out[3]],
                                                         [again[0], *again[2], *again[3]])):
                raise AssertionError(f"{label}: two calls with the same inputs differ")
            wrapper_ms, plain_ms = cuda_ms(lambda: fn(*args)), cuda_ms(lambda: ref(*args))
            ms = k8_launch_ms(*raw)
            ws, bs = args[-3], args[-2]
            # the X branches read, each once; targets and weights in, y_pred and gradients out
            moved = (4 * len(set(ix_x)) * fm * FN_TRAIN + nbytes(args[-1], out[0])
                     + 2 * nbytes(*ws, *bs))
            f32_bound = bound(2 * nb * FN_TRAIN * mlp_fmas(fm, fk0, fs, 1), moved)
            # as implemented: the five products in 3xTF32 (three tf32 tensor-core
            # products per f32 one) at the dense tf32 peak
            case_bound = tf32_bound(2 * nb * FN_TRAIN * (2 * fm * fk0 + 3 * fk0 * fs), moved)
            print(f"  {label}: kernel {ms:.4f} ms (launch alone; the wrapper {wrapper_ms:.4f} ms), "
                  f"plain {plain_ms:.4f} ms, bound {case_bound[0]:.4f} ms ({case_bound[1]}; "
                  f"3xTF32 as implemented; f32 {f32_bound[0]:.4f} ms); identical repeat")
            return err, ms, wrapper_ms, plain_ms, case_bound, f32_bound

        g = FG // 2
        ws1, bs1 = instances([g])
        t1 = fy + 0.1 * torch.randn(FN_TRAIN, device=dev, generator=fgen)
        k8a_err, k8a_ms, k8a_wrapper_ms, k8a_plain_ms, k8a_bound, k8a_f32_bound = k8_case(
            "data_vg", "K8a NB=1", BM.data_vg, BM.data_vg_ref,
            ("tanh", xT[g], tuple(w[0] for w in ws1), tuple(b[0] for b in bs1), t1), [g], 1,
            (xT[g][None], None, ws1, bs1, t1[None]))
        k8b = {}
        # 4 chains x a random block of 8 branches each; then one chain's 64 branches
        blocks = np.concatenate([k8gen.permutation(FG)[:8] for _ in range(FCHAINS)])
        for nb, ix_np in ((FCHAINS * 8, blocks), (FG, np.arange(FG))):
            wsb, bsb = instances(ix_np)
            tb = fy + 0.1 * torch.randn((nb, FN_TRAIN), device=dev, generator=fgen)
            ix = torch.as_tensor(ix_np, dtype=torch.int32, device=dev)
            k8b[nb] = k8_case("data_vg_blocked", f"K8b NB={nb}", BM.data_vg_blocked,
                              BM.data_vg_blocked_ref, ("tanh", xT, ix, wsb, bsb, tb), ix_np, nb,
                              (xT, ix, wsb, bsb, tb))
        k8b_err = max(v[0] for v in k8b.values())
        y_fwd = BM.forward_blocked("tanh", xT, ix, wsb, bsb)
        if not torch.equal(y_fwd, BM.data_vg_blocked("tanh", xT, ix, wsb, bsb, tb)[0]):
            raise AssertionError("K8's forward-only instantiation differs from its y_pred")
        del xT, y_fwd

        # ---- phases 14 and 15: the flagship through the CLI, sequential one
        # chain (K8a per leapfrog step) and unfolded hybrid with 4 chains (K8b
        # per leapfrog step for each block's (chain, branch) pairs)
        k8_counted = {"data_vg": BM.data_vg, "data_vg_blocked": BM.data_vg_blocked,
                      "forward_blocked": BM.forward_blocked, "data_vg_chains": BM.data_vg_chains,
                      "traj_dense": LF.integrate_chains, **counted}
        flag_args = [
            "train-new", os.path.join(fdir, "train"), os.path.join(fdir, "train.phen"),
            os.path.join(fdir, "train.groups"), "ridge_base", "tanh", "1", CHAIN, FL,
            "--fixed-hidden-layer-width", FH, "--fixed-summary-layer-width", FH, "--feat-major",
            "--burn-in", "1", "--bfile-test", os.path.join(fdir, "test"),
            "--p-test", os.path.join(fdir, "test.phen"), "-o", runs,
        ]
        fblock = FG // 8  # the hybrid's default block size at G = 64
        k8_runs = {}
        for phase, extra, chains, want in (
            (14, [], 1, {"data_vg": FG * (FL + 1) * CHAIN}),
            (15, ["--update-mode", "hybrid", "--per-chain-block-perm", "--num-chains", FCHAINS],
             FCHAINS, {"data_vg_blocked": (FG // fblock) * (FL + 2) * CHAIN,
                       "forward_blocked": (FG // fblock) * CHAIN}),
        ):
            print(f"phase {phase}: train-new --feat-major {' '.join(map(str, extra))} "
                  f"({CHAIN} sweeps of L {FL}) -> predict")
            for f in k8_counted.values():
                f.launches = 0
            t0 = time.perf_counter()
            run = run_cli(cli, flag_args + extra).strip().splitlines()[-1]
            secs = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = {n: f.launches for n, f in k8_counted.items()}
            print(f"  kernel launches in train-new: {launches}")
            for n, v in launches.items():
                if v != want.get(n, 0):
                    raise AssertionError(f"{n} launched {v} times, expected {want.get(n, 0)}")
            stats = json.load(open(os.path.join(run, "training_stats")))
            series = stats["mse_train"] + stats["mse_test"] + stats["lpd"]
            if len(stats["mse_test"]) != CHAIN + 1 or not all(np.isfinite(series)):
                raise AssertionError(f"non-finite or missing training statistics: {stats}")
            if stats["num_samples"] != CHAIN * FG * chains:
                raise AssertionError(f"{stats['num_samples']} branch updates counted, "
                                     f"expected {CHAIN * FG * chains}")
            dirs = ([os.path.join(run, "models")] if chains == 1
                    else [os.path.join(run, "models", f"chain{c}") for c in range(chains)])
            chain_preds = [np.asarray(list(csv.reader(io.StringIO(run_cli(cli, [
                "predict", os.path.join(fdir, "test"), os.path.join(fdir, "train.groups"),
                "-m", d])))), np.float64) for d in dirs]
            preds = np.concatenate(chain_preds)
            if preds.shape != (chains * CHAIN, FN_TEST) or not np.all(np.isfinite(preds)):
                raise AssertionError(f"predictions of shape {preds.shape}, finite: "
                                     f"{np.all(np.isfinite(preds))}")
            done = [r for r in log_records if str(r.msg).startswith("Completed training")][-1]
            sweep_ms = 1000.0 * done.args[0] / CHAIN
            r2 = 1.0 - np.mean((fy_test - preds.mean(axis=0)) ** 2) / np.var(fy_test)
            print(f"  {sweep_ms:.1f} ms per sweep of {chains} chain(s), "
                  f"{sweep_ms / chains:.1f} ms per chain-sweep; train-new {secs:.1f} s in all")
            print(f"  acceptance {stats['num_accepted'] / stats['num_samples']:.3f}, "
                  f"early rejection {stats['num_early_rejected'] / stats['num_samples']:.3f}; "
                  f"mse train {stats['mse_train'][-1]:.4f}, mse test {stats['mse_test'][-1]:.4f}, "
                  f"test r2 of the posterior mean {r2:.4f}")
            net = Net.load(os.path.join(dirs[0], f"{CHAIN}.npz"), "cpu")
            cpu_pred = net.predict(f_test.to_stacked(net.arch, "cpu").X).numpy()
            err = np.abs(cpu_pred - chain_preds[0][-1]).max()
            print(f"  predict, card vs CPU plain version: max_abs_err {err:.3e}")
            if not err <= REL_TOL * max(1.0, np.abs(cpu_pred).max()):
                raise AssertionError("the card's predictions disagree with the CPU's")
            k8_runs[phase] = {"launches": launches, "sweep_ms": sweep_ms}
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # no single PyTorch call computes any of these (each fuses decode, a
    # whole MLP and its backward, or a whole trajectory): library_ms is null
    kernels = [
        {"name": "packed_linear", "route": "cuda",
         "source": "rs_bann_tpu_torch/csrc/packed_linear.cu",
         "replaces": "rs_bann_tpu/ops/packed_matmul.py:202",
         "launches": k2_hybrid, "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1], "library_ms": None,
         "f32_bound_ms": k2_f32_bound[0], **k2_vp,
         "adapted_launches": adapted_runs["packed"]["k2_value_passes"]},
        {"name": "data_vg_packed", "route": "cuda",
         "source": "rs_bann_tpu_torch/csrc/branch_vg_packed.cu",
         "replaces": "rs_bann_tpu/ops/branch_mlp.py:365",
         "launches": k4_launches, "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain_ms,
         "bound_ms": k4_bound[0], "bound_by": k4_bound[1], "library_ms": None,
         "wrapper_ms": k4_wrapper_ms, "f32_bound_ms": k4_f32_bound[0],
         "ctas": k4_plan["ctas"], "ctas_per_sm": k4_plan["ctas_per_sm"],
         "max_rel_err_f64": REL_ERR["data_vg_packed f64"]},
        {"name": "traj_packed", "route": "cuda",
         "source": "rs_bann_tpu_torch/csrc/traj_packed.cu",
         "replaces": "rs_bann_tpu/ops/leapfrog.py:470",
         "launches": k5_launches, "max_abs_err": k5_err, "ms": k5_ms, "plain_ms": k5_plain_ms,
         "bound_ms": k5_bound[0], "bound_by": k5_bound[1], "library_ms": None,
         "k_live": k_live, "km": k5_km, "cc": k5_cc, "blocks_per_sm": k5_per_sm,
         "adapted_launches": adapted_runs["packed"]["k5_launches"]},
        # the flagship launches K7's forward-only instantiation (the value
        # passes; its code csrc/branch_fwd_chains.cu and csrc/vg_chains.cuh);
        # the value-and-gradient one is timed too (grad_*)
        {"name": "data_vg_chains", "route": "cuda",
         "source": "rs_bann_tpu_torch/csrc/branch_vg_chains.cu",
         "replaces": "rs_bann_tpu/ops/branch_mlp.py:649",
         "launches": k7_launches, "max_abs_err": k7_err, "ms": k7_ms, "plain_ms": k7_plain_ms,
         "bound_ms": k7_bound[0], "bound_by": k7_bound[1], "library_ms": None,
         "wrapper_ms": k7_wrapper_ms, "f32_bound_ms": k7_f32_bound[0],
         "grad_ms": k7_grad_ms, "grad_wrapper_ms": k7_grad_wrapper_ms,
         "grad_plain_ms": k7_grad_plain_ms, "grad_bound_ms": k7_grad_bound[0],
         "grad_f32_bound_ms": k7_grad_f32_bound[0], "ctas": k7_plan["ctas"], "cc": k7_plan["cc"],
         "max_rel_err_f64": REL_ERR["data_vg_chains f64"],
         "adapted_launches": adapted_runs["flagship"]["k7_launches"]},
        {"name": "traj_dense", "route": "cuda",
         "source": "rs_bann_tpu_torch/csrc/traj_dense.cu",
         "replaces": "rs_bann_tpu/ops/leapfrog.py:63",
         "launches": k6_launches, "max_abs_err": k6_err, "ms": k6_ms, "plain_ms": k6_plain_ms,
         "bound_ms": k6_bound[0], "bound_by": k6_bound[1], "library_ms": None,
         "f32_bound_ms": k6_f32_bound[0],
         "adapted_launches": adapted_runs["flagship"]["k6_launches"]},
        # launches: the GD warm start and hybrid sampling of phase 11
        # (identity, K3) and of phase 12 (silu: K9a, K9b)
        {"name": "packed_matmul", "route": "cuda",
         "source": "rs_bann_tpu_torch/csrc/packed_linear.cu",
         "replaces": "rs_bann_tpu/ops/packed_matmul.py:178",
         "launches": gd_runs["silu"]["launches"]["packed_matmul"], "max_abs_err": k9a_err,
         "ms": k9a_ms, "plain_ms": k9a_plain_ms, "bound_ms": k9a_bound[0],
         "bound_by": k9a_bound[1], "library_ms": None, "f32_bound_ms": k9a_f32_bound[0],
         **k9a_vp},
        # ms, plain_ms and bound_ms: the wrapper's call at G = 100 (K3 at
        # identity, the slice's activation); warm_*: at the warm start's block
        {"name": "packed_linear_vjp", "route": "cuda",
         "source": "rs_bann_tpu_torch/csrc/packed_bwd.cu",
         "replaces": "rs_bann_tpu/ops/packed_matmul.py:256",
         "launches": gd_runs["identity"]["launches"]["packed_linear_vjp"],
         "max_abs_err": bwd_err["packed_linear_vjp"],
         "ms": bwd_runs["G=100", "identity"]["ms"],
         "plain_ms": bwd_runs["G=100", "identity"]["plain_ms"],
         "bound_ms": bwd_runs["G=100", "identity"]["bound"][0],
         "bound_by": bwd_runs["G=100", "identity"]["bound"][1], "library_ms": None,
         "f32_bound_ms": bwd_runs["G=100", "identity"]["f32_bound_ms"],
         "tanh_ms": bwd_runs["G=100", "tanh"]["ms"],
         "tanh_bound_ms": bwd_runs["G=100", "tanh"]["bound"][0],
         "warm_ms": bwd_runs["warm-start block", "identity"]["ms"],
         "warm_plain_ms": bwd_runs["warm-start block", "identity"]["plain_ms"],
         "warm_bound_ms": bwd_runs["warm-start block", "identity"]["bound"][0],
         "warm_tanh_ms": bwd_runs["warm-start block", "tanh"]["ms"],
         "warm_tanh_bound_ms": bwd_runs["warm-start block", "tanh"]["bound"][0],
         "max_rel_err_f64": REL_ERR["packed_linear_vjp f64"]},
        {"name": "packed_matmul_vjp", "route": "cuda",
         "source": "rs_bann_tpu_torch/csrc/packed_bwd.cu",
         "replaces": "rs_bann_tpu/ops/packed_matmul.py:233",
         "launches": gd_runs["silu"]["launches"]["packed_matmul_vjp"],
         "max_abs_err": bwd_err["packed_matmul_vjp"],
         "ms": bwd_runs["G=100", None]["ms"], "plain_ms": bwd_runs["G=100", None]["plain_ms"],
         "bound_ms": bwd_runs["G=100", None]["bound"][0],
         "bound_by": bwd_runs["G=100", None]["bound"][1], "library_ms": None,
         "f32_bound_ms": bwd_runs["G=100", None]["f32_bound_ms"],
         "warm_ms": bwd_runs["warm-start block", None]["ms"],
         "warm_plain_ms": bwd_runs["warm-start block", None]["plain_ms"],
         "warm_bound_ms": bwd_runs["warm-start block", None]["bound"][0],
         "max_rel_err_f64": REL_ERR["packed_matmul_vjp f64"],
         "ssm_launches": k9b_ssm, "ssm_u0_ms": scan["u0_ms"],
         "ssm_u0_plain_ms": scan["u0_plain_ms"], "ssm_u0_max_abs_err": scan["u0_max_abs_err"]},
        # launches: the sequential flagship of phase 14 (K8a) and the unfolded
        # hybrid of phase 15 (K8b, whose times are at its NB = 32 of 4 chains
        # x 8 branches; NB = 64 and the forward-only launches beside them)
        {"name": "data_vg", "route": "cuda",
         "source": "rs_bann_tpu_torch/csrc/branch_vg_dense.cu",
         "replaces": "rs_bann_tpu/ops/branch_mlp.py:96",
         "launches": k8_runs[14]["launches"]["data_vg"], "max_abs_err": k8a_err,
         "ms": k8a_ms, "plain_ms": k8a_plain_ms, "bound_ms": k8a_bound[0],
         "bound_by": k8a_bound[1], "library_ms": None, "wrapper_ms": k8a_wrapper_ms,
         "f32_bound_ms": k8a_f32_bound[0]},
        {"name": "data_vg_blocked", "route": "cuda",
         "source": "rs_bann_tpu_torch/csrc/branch_vg_dense.cu",
         "replaces": "rs_bann_tpu/ops/branch_mlp.py:335",
         "launches": k8_runs[15]["launches"]["data_vg_blocked"], "max_abs_err": k8b_err,
         "ms": k8b[FCHAINS * 8][1], "plain_ms": k8b[FCHAINS * 8][3],
         "bound_ms": k8b[FCHAINS * 8][4][0], "bound_by": k8b[FCHAINS * 8][4][1],
         "library_ms": None, "wrapper_ms": k8b[FCHAINS * 8][2],
         "f32_bound_ms": k8b[FCHAINS * 8][5][0], "nb64_ms": k8b[FG][1],
         "nb64_wrapper_ms": k8b[FG][2], "nb64_plain_ms": k8b[FG][3],
         "nb64_bound_ms": k8b[FG][4][0],
         "forward_launches": k8_runs[15]["launches"]["forward_blocked"]},
        # no TPU kernel: the JAX package's scan is jnp inside lax.scan; its
        # floor is the chain of dependent marker steps (us_per_marker)
        {"name": "marker_scan", "route": "cuda",
         "source": "rs_bann_tpu_torch/csrc/marker_scan.cu",
         "replaces": "rs_bann_tpu/models/net.py:218",
         "launches": scan_launches, "max_abs_err": scan["max_abs_err"], "ms": scan["ms"],
         "plain_ms": scan["plain_ms"], "bound_ms": scan["bound"][0],
         "bound_by": scan["bound"][1], "library_ms": None,
         "us_per_marker": scan["us_per_marker"], "near_ties": scan["near_ties"]},
    ]
    for k in kernels:  # the scale-free error that the checks gate on
        k["max_rel_err"] = REL_ERR[k["name"]]
    print("adaptation (phases 6b, 9b): " + json.dumps(adapted_runs))
    print("ss_markers (phase 6c): " + json.dumps(ssm_run))
    print("resume and analysis (phase 6d): " + json.dumps(resume_run))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
