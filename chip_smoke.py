#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rs_bann_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):
  0. require a CUDA device; print the card, its power limit and the versions
  1. build the CUDA kernels from rs_bann_tpu_torch/csrc with nvcc (in a
     thread, while the host writes the data)
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
 6d. phase 6c's run at burn-in 2 (sweeps 1 and 2 adapt, 3 is frozen), on
     the training set cut to n = 10,000 (17d's; the same population and
     phenotype model, and no check of this half depends on n):
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
     of that sample, the card's output against --cpu's within REL_TOL of
     max(1, the largest entry), each with exactly its K2 launches (one;
     population-effect-sizes one per chunk of 48 branches, 3) and their
     device time (torch.profiler), and no plain-version call on the card;
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
     train-new --feat-major (1 sweep of L = 64 at burn-in 0, the sweep
     host-bound at ~7-11 s: exactly G x (L + 1) = 4,160 K8a launches, no
     other kernel), dense predict, the card's predictions against the
     CPU's
 15. the same with --update-mode hybrid --per-chain-block-perm --num-chains
     4 (each block's 4 x 8 (chain, branch) pairs in one batched lean body:
     exactly blocks x (L + 2) x 2 = 1,056 K8b launches and one forward-only
     K8 launch per block, no other kernel), predict on each chain's samples
 16. the packed kernels' deep design (csrc/packed_deep.cuh) at the slice's
     shape, weights from init_net: K4 on one branch (n = 100,000) and K5
     on one hybrid block (B = 10, C = 4, izmailov step sizes at factor
     0.1, L = 1 and 30) at depth 2 tanh with h = s = 50 padded 56 (the JAX
     CLI's default width rule), depth 1 identity at width 16 (the parent
     checkout's code there is timed by scripts/bench_deep_torch.py) and depth 0
     identity at width 56, each against its plain version (K4 also in
     f64: no further from it than the f32 plain version, plus REL_TOL; K5
     within REL_TOL at L = 1 and REL_TOL_TRAJ at L = 30), identical bits
     on a repeat; at L = 30 each momentum's data-term share (the plain
     version without the data term against with it), required at least 5x
     the check's limit on the weight momenta; K4's launch alone (the C
     entry) and wrapper, K5's call, the plain versions' times and the bound
     of the function's work (the live widths, layer 0 in three bf16
     products per f32 one at 989 TFLOP/s, the other products 3xTF32 at
     494.7 TFLOP/s) with the work as implemented (the padded widths, the
     hidden and output layers at the 67 TFLOP/s f32 peak) and the f32 bound
     beside it; torch.matmul on the decoded f32 X at the block's layer 0
     as the library yardstick
 16b. train-new ridge_ard tanh 2 at the default widths --update-mode hybrid
     --num-chains 4 with the adaptation (2 sweeps at burn-in 1), each sweep
     recorded: exactly 10 K5 and 20 value-pass K2 launches, no K4 launch
     and no call of any kernel's plain version (train-new and predict);
     the adaptation checks of 6b; predict on chain 0, card vs --cpu
 16c. the whole recipe (identity depth 0, --ss-markers, the adaptation) at
     the default widths (layer 0 width 56: K5's deep design and the scan's
     two columns a lane), as 16b: exactly 10 K9b, 10 marker_scan, 10 K5 and
     30 K2 launches per sweep, no plain-version call; the scan and its u0
     at the block against their plain versions (as 6c)
 17. the dense kernels' deep design (csrc/dense_deep.cuh) on phase 16's
     genotypes in feature-major f32 (xT [100, 104, 100,000]), weights
     from init_net: K8a on one branch, K8b on 4 chains x 10 branches (X
     read through an index), K7 (value and gradient, and forward only) and
     K6 (izmailov step sizes at factor 0.1, L = 1 and 30) on one hybrid
     block (B = 10, C = 4), each chain's weights perturbed, at depth 2 tanh
     with h = s = 50 padded 56 (the JAX CLI's default width rule), depth 0
     identity at width 56 and depth 3 tanh at width 16: each output
     against its plain version in f32 (REL_TOL; K6 at L = 30 REL_TOL_TRAJ)
     and in f64 (no further from it than the f32 plain version, plus the
     same), identical bits on a repeat, K6's data-term share at L = 30
     (phase 16's check); K8's and K7's launch alone (the C entry, back to
     back) beside the wrapper's call, K6's call, each plain version's time
     and the bound of the function's work (the live widths, every product
     in 3xTF32 at 494.7 TFLOP/s) with the f32 bound beside it; the plans
     and ptxas registers/spills; torch.matmul W0^T X at the block's layer
     0 as the library yardstick
 17b. train-new --feat-major ridge_ard tanh 2 at the default widths
     --update-mode hybrid --num-chains 4 with the adaptation (2 sweeps at
     burn-in 1), each sweep recorded: exactly 10 K6 and 20 forward-only K7
     launches, no K8, K4 or K5 launch and no plain-version call in
     train-new or predict; the adaptation checks of 6b; predict on chain 0,
     card vs --cpu
 17c. the recipe (identity depth 0, --ss-markers, the adaptation) at layer
     0 width 56 on --feat-major, as 17b: exactly 10 K6, 10 marker_scan and
     30 value-pass K7 launches per sweep, no K9b (the scan's u0 on a FeatX
     is one matmul)
 17d. one sweep of train-new --feat-major ridge_ard tanh 2 at the default
     widths unfolded (--update-mode hybrid --per-chain-block-perm
     --num-chains 4: exactly blocks x (L + 2) = 320 K8b launches and one
     forward-only K8 launch per block, nothing else) and sequential with
     one chain (exactly G x (L + 1) = 3,100 K8a launches, nothing else),
     predict card vs --cpu; on a training set cut to n = 10,000 (the same
     population and phenotype model; the launches do not depend on n) to
     keep the script inside its time
 18. K8a, K8b (NB = 32 through an index), K7 (value and gradient, and
     forward only) and K6 (L = 1 at REL_TOL, L = 30 at REL_TOL_TRAJ) on
     feature-major X stored in bf16 (--x-bf16): at the dense flagship's
     shape (csrc/dense_vg_mma.cuh; K7 and K6 on all 64 branches x 4 chains)
     and at 17's depth 2 h = s = 56 on the genome-scale X in bf16
     (csrc/dense_deep.cuh; K8b at NB = 40, K7 and K6 on one block): each
     against its plain version on the same bf16 X and in f64, identical on
     a repeat, and bit for bit the f32-X kernel on X upcast; each one's
     wrapper time, plain time and bound (X's bytes in bf16; layer 0's
     products in three bf16 products per f32 one at 989 TFLOP/s, the rest
     in 3xTF32; as implemented, layer 0 in two tf32 products per f32 one)
 18b. phase 9's train-new with --x-bf16: exactly one K6 and three K7
     forward launches per sweep, all on bf16 X (the sweep's snapshot
     predictions on W0 rounded to bf16, as the JAX package's D.predict
     rounds it, then the transition's two value passes), xT's bytes on the
     card half of f32's, ms per sweep beside phase 9's; then one sweep each
     unfolded (--per-chain-block-perm, 4 chains: blocks x (L + 2) K8b and
     one forward-only K8 per block) and sequential (one chain: G x (L + 1)
     K8a), all on bf16 X; predict card vs --cpu, no plain-version call;
     then with --bf16 too (the snapshot in predict's plain products with
     bf16 inputs): folded, exactly one K6 and two K7 forward launches per
     sweep, and one sweep unfolded, blocks x (L + 2) K8b and no forward-only
     K8; the folded run's last weights' snapshots, folded and unfolded (on
     a copy of each instance's branch), card vs --cpu: at most 1% of the
     entries past REL_TOL, none past one bf16 step (2^-8) of max(1, the
     largest), as the CPU tests hold --bf16 to the JAX package (a hidden
     activation rounded to bf16 from sums in another order)
 18c. 17c's recipe with --x-bf16 (17c's launches, all on bf16 X; xT 2.08
     GB), then phase 6's packed hybrid with --bf16 (10 K5 and 20 value-pass
     K2 launches per sweep, as phase 6), each predict card vs --cpu
 19. joint HMC (``--joint-hmc``): one joint transition of one hybrid block
     (B = 10, C = 4, n = 100,000, identity depth 0 width 10, L = 30, the
     shared scalars frozen, the residual in as the hybrid sweep calls it)
     on the card against the same call on the CPU's plain versions, its
     step-size uniforms, momenta and accept uniforms from a seed: the codes
     equal on all but max(1, I // 20) of the 40 instances, every output
     within REL_TOL_TRAJ on the rest, the log accept probability (a
     difference of log densities of ~4e5) within 16 f32 roundings of the
     largest log density; the joint potential's value and
     gradient (every precision included) within REL_TOL (the error
     precision's, a difference of two terms of ~n / (2 err), of the larger
     term); identical repeats; exactly 31 K2 and 31 K3 launches, no K4 or
     K5; the same with silu (K9a, K9b), its comparison with the CPU at 5
     leapfrog steps (the CPU's plain versions take ~0.7 s an evaluation)
 19b. train-new --joint-hmc --update-mode hybrid --num-chains 4 (2 sweeps):
     exactly 310 K2 and 310 K3 launches per sweep (one of each per
     evaluation for a block's 4 x 10 instances), no K4, K5 or scan launch,
     train-new's own 13 K2 (the start's residual and each record's test mse
     per chain), acceptance above 0, predict on chain 0 card vs the CPU;
     then --update-mode parallel (31 and 31 per sweep); a profiled hybrid
     sweep (K2's and K3's device time, the busy share)
 19c. one sequential sweep at n = 10,000 each of --joint-hmc (exactly 3,100
     K2 and 3,100 K3) and --gradient-descent-joint (3,100 K2, 3,000 K3):
     one output precision for every branch after it, the rejects counted,
     predict card vs the CPU; a profiled sequential joint sweep on 4 of
     its branches (the busy share)
 19d. the flagship's train-new --feat-major --joint-hmc --update-mode
     parallel --num-chains 4, one sweep of L = 64: no K6, K7, K8 or packed
     launch (plain products), predict card vs the CPU
The line before the last is a JSON object with each kernel's launches on
its path (phase 4 for K4, 6 for K2 and K5, 9 for K6 and K7, 11 for K3, 12
for K9a and K9b, 14 for K8a, 15 for K8b, 6c for marker_scan; K4's and K5's
deep design's phase-16 numbers under ``deep``, K5's launches per sweep of
16b and 16c beside them, the scan's at width 56 as ``w56``; K5's, K2's,
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
beside it as f32_bound_ms; the deep design's as in phase 16, its work as
implemented as impl_bound_ms; the dense deep design's entries
traj_dense_deep, data_vg_chains_deep (its forward-only launch; the value
and gradient under ``grad``), data_vg_deep and data_vg_blocked_deep at
phase 17's depth 2 width 56, every shape under ``shapes``, launches in
17b and 17d; the bf16-X forms (phase 18) as traj_dense_xbf16,
data_vg_chains_xbf16, data_vg_xbf16 and data_vg_blocked_xbf16, the
flagship's numbers with the deep design's under ``deep``, launches in
18b, the bound's layer 0 in three bf16 products per f32 one at 989
TFLOP/s (X exact in bf16) and the rest in 3xTF32, the work as implemented
(layer 0 in two tf32 products) as impl_bound_ms; K2's and K9a's value pass
on the live width as value_pass_*, K3's and K9b's times at the warm
start's block as warm_*; K2's, K3's, K9a's and K9b's on the joint paths,
phases 19-19c, as joint_*); the last line is {"ok": true, "device":
{...}}. The data lives in a temporary directory, removed at the end.
"""

import contextlib
import csv
import ctypes
import dataclasses
import io
import json
import logging
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
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
MAIN_DEEP = "depth 2 tanh, h = s = 56"  # phase 17's shape on the slice's main path
N_17D = 10_000  # phases 6d's and 17d's training individuals (their checks do not depend on n)


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


def deep_fmas(m, h, s, depth):
    """FMAs of one branch MLP of ``depth`` hidden layers of width h and a
    summary layer of width s, for one individual and one chain, forward and
    backward: (layer 0's two products, every other layer's)."""
    dims = [(h, h)] * (depth - 1) + ([(h, s)] if depth else [])
    k0 = h if depth else s
    return 2 * m * k0, sum(i * o for i, o in dims) * 3 + 2 * s


def deep_bound(n_evals, live, padded, depth, nbytes_moved):
    """The deep design's bounds for ``n_evals`` (individual, chain)
    evaluations against the bytes it must move: (least ms, what bounds it)
    of the function's work, the live widths ``live`` = (m, h, s) with every
    product at the card's f32-exact tensor-core rate (layer 0 three bf16
    products per f32 one at 989 TFLOP/s, the genotype the exact operand, as
    K2 and K4 at depth 0; the hidden and output products 3xTF32 at 494.7
    TFLOP/s, as K6-K8); the ms of the work as implemented (the padded
    widths ``padded``, layer 0 as above, the hidden and output layers on
    the f32 cores at 67 TFLOP/s); and the ms of every live FMA at the f32
    peak."""
    bytes_ms = 1e3 * nbytes_moved / PEAK_BYTES_S
    l0, rest = deep_fmas(*live, depth)
    ops_ms = 2e3 * n_evals * (3 * l0 / PEAK_BF16_FLOPS + 3 * rest / PEAK_TF32_FLOPS)
    p0, prest = deep_fmas(*padded, depth)
    impl_ms = max(2e3 * n_evals * (3 * p0 / PEAK_BF16_FLOPS + prest / PEAK_F32_FLOPS), bytes_ms)
    f32_ms = max(2e3 * n_evals * (l0 + rest) / PEAK_F32_FLOPS, bytes_ms)
    return ((ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")), impl_ms, f32_ms


# the plain versions no path on the card may call (phases 16b-17d count them)
PLAIN_VERSIONS = (("leapfrog", "integrate_chains_packed_ref"), ("branch_mlp", "data_vg_packed_ref"),
                  ("packed_matmul", "packed_linear_ref"), ("packed_matmul", "packed_matmul_ref"),
                  ("packed_matmul", "packed_linear_vjp_ref"),
                  ("packed_matmul", "packed_matmul_vjp_ref"), ("marker_scan", "marker_scan_ref"),
                  ("leapfrog", "integrate_chains_ref"), ("branch_mlp", "data_vg_chains_ref"),
                  ("branch_mlp", "forward_chains_ref"), ("branch_mlp", "data_vg_ref"),
                  ("branch_mlp", "data_vg_blocked_ref"), ("branch_mlp", "forward_blocked_ref"))


@contextlib.contextmanager
def plain_calls():
    """Count calls of the kernels' plain versions while the block runs:
    yields a dict name -> calls."""
    import importlib

    calls, saved = {}, []
    for mod_name, fn in PLAIN_VERSIONS:
        mod = importlib.import_module(f"rs_bann_tpu_torch.ops.{mod_name}")
        orig = getattr(mod, fn)
        calls[fn] = 0

        def counted(*a, _orig=orig, _fn=fn, **kw):
            calls[_fn] += 1
            return _orig(*a, **kw)

        saved.append((mod, fn, orig))
        setattr(mod, fn, counted)
    try:
        yield calls
    finally:
        for mod, fn, orig in saved:
            setattr(mod, fn, orig)


def cli_phase(cli, work, argv, kernels, log_records, test_gen, y_test, per_sweep, packed=True,
              sweeps=CHAIN, widths=(56, 56)):
    """One train-new run of ``argv`` (hybrid or parallel with C = CHAINS
    chains, or one chain) at padded widths ``widths`` (the default rule's
    56; None: not checked): each sweep recorded
    with the launches of each counted wrapper in ``kernels`` (exactly
    ``per_sweep``), no plain-version call in train-new or predict, the
    adaptation checks of phase 6b where ``argv`` adapts, finite statistics,
    and chain 0's last sample predicted on the card (``--packed-genotypes``
    or feature-major) against the CPU's. Returns the run, the records and
    its numbers."""
    import numpy as np
    import torch

    from rs_bann_tpu_torch.models.net import Net

    for counted in kernels.values():
        counted.launches = 0
    t0 = time.perf_counter()
    with plain_calls() as calls:
        run, recs = recorded_run(cli, argv, kernels)
        train_s = time.perf_counter() - t0
        before = {k: w.launches for k, w in kernels.items()}
        chain0 = os.path.join(run, "models", "chain0")
        rows = run_cli(cli, ["predict", os.path.join(work, "test"),
                             os.path.join(work, "train.groups"), "-m",
                             chain0 if os.path.isdir(chain0) else os.path.join(run, "models")]
                       + (["--packed-genotypes"] if packed else []))
        torch.cuda.synchronize()
    predict_launches = {k: w.launches - before[k] for k, w in kernels.items()}
    print(f"  kernel launches per sweep: {[r['launches'] for r in recs]}; predict: "
          f"{predict_launches}; plain-version calls: {calls}")
    if any(calls.values()):
        raise AssertionError(f"a plain version ran on the card: {calls}")
    stats = json.load(open(os.path.join(run, "training_stats")))
    chains = int(argv[argv.index("--num-chains") + 1]) if "--num-chains" in argv else 1
    if "--mass-adaptation" in argv:
        factors = check_adapted(recs, stats, chains, per_sweep)
    else:
        factors = None
        if len(recs) != sweeps or any(r["launches"] != per_sweep for r in recs):
            raise AssertionError(f"launches per sweep {[r['launches'] for r in recs]}, expected "
                                 f"{sweeps} x {per_sweep}")
    series = stats["mse_train"] + stats["mse_test"] + stats["lpd"]
    if len(stats["mse_test"]) != sweeps + 1 or not all(np.isfinite(series)):
        raise AssertionError(f"non-finite or missing training statistics: {stats}")
    card = np.asarray(list(csv.reader(io.StringIO(rows))), np.float64)
    models = os.path.join(run, "models", "chain0")
    models = models if os.path.isdir(models) else os.path.join(run, "models")
    saved = [f for f in os.listdir(models) if f.endswith(".npz")]  # at burn-in 0 also 0.npz
    net = Net.load(os.path.join(models, f"{sweeps}.npz"), "cpu")
    if widths and (net.arch.depth, net.arch.layer_out_pad(0), net.arch.s_pad) != (
            int(argv[6]), *widths):
        raise AssertionError(f"the run's branches: depth {net.arch.depth}, widths "
                             f"{net.arch.layer_out_pad(0)}/{net.arch.s_pad}")
    x_cpu = (test_gen.to_packed(net.arch, "cpu") if packed
             else test_gen.to_feature_major(net.arch, "cpu")).X
    cpu_pred = net.predict(x_cpu).numpy()
    perr = np.abs(cpu_pred - card[-1]).max()
    if card.shape != (len(saved), len(y_test)) or not perr <= REL_TOL * max(
            1.0, np.abs(cpu_pred).max()):
        raise AssertionError(f"the card's predictions {card.shape} disagree with the CPU's "
                             f"by {perr}")
    done = [r for r in log_records if str(r.msg).startswith("Completed training")]
    sweep_ms = 1000.0 * done[-1].args[0] / sweeps
    r2 = 1.0 - np.mean((y_test - card.mean(axis=0)) ** 2) / np.var(y_test)
    print(f"  {sweep_ms:.1f} ms per sweep of {chains} chains; train-new {train_s:.1f} s in "
          f"all; acceptance {stats['num_accepted'] / stats['num_samples']:.3f}; mse train "
          f"{stats['mse_train'][-1]:.4f}, test {stats['mse_test'][-1]:.4f}, test r2 of chain "
          f"0's posterior mean {r2:.4f}; predict card vs CPU {perr:.3e}")
    return run, recs, {"sweep_ms": sweep_ms, "train_s": train_s, "factors": factors,
                       "launches_per_sweep": recs[-1]["launches"],
                       "train_launches": before, "predict_launches": predict_launches,
                       "acceptance": stats["num_accepted"] / stats["num_samples"]}


def deep_phases(cli, work, train_bed, groups, y_train, y_test, log_records):
    """Phases 16-16c: the packed kernels' deep design (any depth, padded
    widths up to 64) at the genome-scale shape and the JAX CLI's default
    width rule (h = s = 50, padded 56), on the training genotypes
    ``train_bed`` packed anew. Returns their numbers."""
    import numpy as np
    import torch

    from rs_bann_tpu_torch.io import BedVM
    from rs_bann_tpu_torch.io.genotypes import CompressedGenotypes
    from rs_bann_tpu_torch.models import NetArch
    from rs_bann_tpu_torch.models import density as D
    from rs_bann_tpu_torch.models import params as P
    from rs_bann_tpu_torch.models.init import InitCfg, init_net
    from rs_bann_tpu_torch.models.net import Net
    from rs_bann_tpu_torch.ops import _build
    from rs_bann_tpu_torch.ops import branch_mlp as BM
    from rs_bann_tpu_torch.ops import leapfrog as LF
    from rs_bann_tpu_torch.ops import marker_scan as MS
    from rs_bann_tpu_torch.ops import packed_matmul as PM
    from rs_bann_tpu_torch.ops.activations import ACT_CODES
    from rs_bann_tpu_torch.samplers import MCMCCfg
    from rs_bann_tpu_torch.samplers import hmc as H

    dev = torch.device("cuda")
    lib = _build.lib()
    out = {"k4": {}, "k5": {}}
    rule = ("fraction_of_input", 0.5), ("fraction_of_hidden", 1.0)  # the JAX CLI's defaults
    archs = {
        "depth 2 tanh, h = s = 56": NetArch.from_width_rules([M] * G, 2, *rule, activation="tanh"),
        "depth 1 identity, width 16": NetArch.from_width_rules([M] * G, 1, ("fixed", 16),
                                                               ("fixed", 16),
                                                               activation="identity"),
        "depth 0 identity, width 56": NetArch.from_width_rules([M] * G, 0, *rule,
                                                               activation="identity"),
    }
    build_log = _build.BUILD_DIR / "build.log"
    if build_log.exists():
        import re

        text, cur = build_log.read_text(), None
        for line in text.splitlines():
            m_ = re.search(r"Compiling entry function '\S*(vg_deep_kernel|traj_deep_kernel)ILi(\d+)E",
                           line)
            if m_:
                cur = f"{m_.group(1)}<KM={m_.group(2)}>"
            elif "Compiling entry function" in line:
                cur = None
            elif cur and "Used" in line:
                print(f"  ptxas {cur}: {line.split(':', 1)[1].strip()}")
            elif cur and "spill" in line:
                print(f"  ptxas {cur}: {line.strip()}")

    # the packed bytes and standardization depend on m_pad alone (104 here)
    X = CompressedGenotypes(train_bed, groups).to_packed(archs["depth 0 identity, width 56"],
                                                         dev).X

    # ---- phase 16: K4 on one branch and K5 on one hybrid block
    print("phase 16: the deep design (csrc/packed_deep.cuh): K4 on one branch and K5 on one "
          f"hybrid block (B {BLOCK}, C {CHAINS}) against their plain versions, n {N_TRAIN}")
    g = G // 2
    xg = X[g]
    target = torch.randn(N_TRAIN, device=dev, generator=torch.Generator(dev).manual_seed(0))
    ixs = torch.arange(BLOCK, device=dev) * (G // BLOCK)
    x_b = X[ixs]
    y_dev = torch.as_tensor(y_train, dtype=torch.float32, device=dev)
    for label, arch in archs.items():
        act, depth = arch.activation, arch.depth
        h, s = arch.layer_out_pad(0), arch.s_pad
        state, _ = init_net(arch, "ridge_ard", InitCfg(seed=0), device=dev)
        ws, bs = tuple(w[g] for w in state.params.weights), tuple(b[g] for b in state.params.biases)
        m_pad = ws[0].shape[0]
        live = (arch.m[g], arch.h[g], arch.s[g])  # the function's widths (every branch alike)

        def k4_plain(dtype=torch.float32):
            sc, sh, t = (v.to(dtype) for v in (xg.w_scale, xg.shift, target))
            w_, b_ = tuple(w.to(dtype) for w in ws), tuple(b.to(dtype) for b in bs)
            wf = (sc[:, None] * w_[0],) + w_[1:]
            bf = (b_[0] - sh @ wf[0],) + b_[1:]
            y_ref, dws_ref, dbs_ref = BM.data_vg_packed_ref(act, xg.bytes, t, wf, bf, N_TRAIN)
            dW0 = sc[:, None] * dws_ref[0] - (sh * sc)[:, None] * dbs_ref[0]
            return (y_ref, torch.sum((y_ref - t) ** 2), dW0) + dws_ref[1:] + dbs_ref

        def k4_call():
            y, rss, dws, dbs = BM.data_vg_packed(act, xg, ws, bs, target)
            return (y, rss) + dws + dbs

        got, want, want64 = k4_call(), k4_plain(), k4_plain(torch.float64)
        names = ["y_pred", "rss"] + [f"dW{l}" for l in range(len(ws))] + \
            [f"db{l}" for l in range(len(bs))]
        k4_err = max(check_close("data_vg_packed", f"K4 {label} {nm}", a, b)
                     for nm, a, b in zip(names, got, want))
        for nm, a, b, b64 in zip(names, got, want, want64):  # no further from f64 than f32's
            plain64 = (b.double() - b64).abs().max().item() / max(1.0, b64.abs().max().item())
            check_close("data_vg_packed f64", f"K4 {label} {nm} (f64; f32 plain {plain64:.2e})",
                        a.double(), b64, tol=plain64 + REL_TOL)
        identical(k4_call, got, f"K4 {label}")
        plan = BM.branch_vg_packed_deep_plan(m_pad, xg.bytes.shape[1], N_TRAIN, h, s, depth)
        q = BM.flat_params(ws, bs)
        Pf = q.numel()
        k4_out = torch.empty(N_TRAIN + Pf + 1, device=dev)
        k4_part = torch.empty(plan["ctas"] * plan["row"], device=dev)
        vp = ctypes.c_void_p
        k4_args = (vp(xg.bytes.data_ptr()), vp(target.data_ptr()), vp(q.data_ptr()),
                   vp(xg.w_scale.data_ptr()), vp(xg.shift.data_ptr()), vp(k4_out.data_ptr()),
                   vp(k4_part.data_ptr()), k4_part.numel(), vp(k4_out.data_ptr() + 4 * N_TRAIN),
                   m_pad, xg.bytes.shape[1], N_TRAIN, h, s, depth, ACT_CODES[act],
                   vp(_build.stream_ptr(xg.bytes)))

        def k4_launches_run(reps=10):
            for _ in range(reps):
                _build.check(lib.branch_vg_packed_deep_f32(*k4_args), "branch_vg_packed_deep_f32")

        k4_ms = cuda_ms(k4_launches_run, runs=5) / 10
        k4_wrapper_ms = cuda_ms(k4_call, runs=5)
        k4_plain_ms = cuda_ms(k4_plain, runs=3)
        k4_bound, k4_impl, k4_f32 = deep_bound(N_TRAIN, live, (m_pad, h, s), depth,
                                               nbytes(xg.bytes, xg.w_scale, xg.shift, target, q)
                                               + 4 * (N_TRAIN + Pf + 1))
        print(f"  K4 {label}: launch alone {k4_ms:.4f} ms (the pass and its reduce), wrapper "
              f"{k4_wrapper_ms:.4f} ms, plain {k4_plain_ms:.3f} ms; bound {k4_bound[0]:.4f} ms "
              f"({k4_bound[1]}, live widths {live}; as implemented {k4_impl:.4f} ms, f32 "
              f"{k4_f32:.4f} ms); plan {plan}; identical repeat")
        out["k4"][label] = {"ms": k4_ms, "wrapper_ms": k4_wrapper_ms, "plain_ms": k4_plain_ms,
                            "bound_ms": k4_bound[0], "bound_by": k4_bound[1],
                            "impl_bound_ms": k4_impl, "f32_bound_ms": k4_f32,
                            "max_abs_err": k4_err, "plan": plan}
        del got, want, want64, k4_out, k4_part

        # K5 on the block: izmailov step sizes (factor 0.1, where the data
        # term moves every weight momentum well past the check's limit; at
        # 0.01 the hidden layers' moved 2-3x it) from the initial
        # precisions, the same start for every chain, targets around the
        # phenotype; L = 1 and L
        gen = torch.Generator(dev).manual_seed(5)

        def chains_of(ts):
            return tuple(t[ixs].unsqueeze(1).expand((BLOCK, CHAINS) + t.shape[1:]).contiguous()
                         for t in ts)

        bw, bb = chains_of(state.params.weights), chains_of(state.params.biases)
        mws, mbs = chains_of(P.weight_masks(arch, dev)), chains_of(P.bias_masks(arch, dev))
        wps, bps = chains_of(state.precisions.weights), chains_of(state.precisions.biases)
        eps_w, eps_b = H.step_sizes(None, "ridge_ard", MCMCCfg(hmc_integration_length=L,
                                                               hmc_step_size_factor=0.1),
                                    bw, bb, wps, bps, None)
        p_w = tuple(torch.randn(w.shape, device=dev, generator=gen) * mk for w, mk in zip(bw, mws))
        p_b = tuple(torch.randn(b.shape, device=dev, generator=gen) * mk for b, mk in zip(bb, mbs))
        targets = y_dev + 0.1 * torch.randn((BLOCK, CHAINS, N_TRAIN), device=dev, generator=gen)
        err = torch.full((BLOCK, CHAINS), 1.0 / y_dev.var().item(), device=dev)
        lam_w = tuple(lam.expand_as(w) for lam, w in zip(wps, bw))
        lam_b = tuple(lam.expand_as(b) for lam, b in zip(bps, bb))
        plan5 = LF.traj_packed_plan(m_pad, h, s, h, depth, BLOCK, CHAINS, x_b.bytes.shape[-1],
                                    N_TRAIN)
        k5_err = 0.0
        for steps, tol in ((1, REL_TOL), (L, REL_TOL_TRAJ)):
            args = (x_b.bytes, x_b.w_scale, x_b.shift, targets, err, bw, bb, p_w, p_b,
                    eps_w, eps_b, lam_w, lam_b, steps, N_TRAIN)
            got = LF.integrate_chains_packed(act, *args)
            ref = LF.integrate_chains_packed_ref(act, *args)
            for k, (a, b) in enumerate(zip([t for o in got for t in o], [t for r in ref for t in r])):
                k5_err = max(k5_err, check_close("traj_packed", f"K5 {label}, L={steps}, out {k}",
                                                 a, b, tol))
            identical(lambda: tuple(t for o in LF.integrate_chains_packed(act, *args) for t in o),
                      tuple(t for o in got for t in o), f"K5 {label}, L={steps}")
            if steps == L:
                # the data term's share of each momentum at L, over its
                # check's limit: the plain version against itself without
                # the data term (err 0). A kernel whose data gradient were
                # wrong by more than limit / share would fail the check
                nodata = LF.integrate_chains_packed_ref(act, *args[:4], torch.zeros_like(err),
                                                        *args[5:])
                data_effect = {}
                for kind, refs, nods, p0s in (("pw", ref[2], nodata[2], p_w),
                                              ("pb", ref[3], nodata[3], p_b)):
                    for l, (a, b, p0) in enumerate(zip(refs, nods, p0s)):
                        limit = tol * max(1.0, a.abs().max().item())
                        data_effect[f"{kind}{l}"] = {
                            "moved": (a - p0).abs().max().item(),
                            "data": (a - b).abs().max().item(), "limit": limit}
                print(f"  K5 {label}, L={L}: max |p_L - p_0|, the data term's share and the "
                      f"check's limit per momentum: " + ", ".join(
                          f"{k} {v['moved']:.3e}/{v['data']:.3e}/{v['limit']:.1e}"
                          for k, v in data_effect.items()))
                weak = {k: v for k, v in data_effect.items()
                        if k.startswith("pw") and v["data"] < 5 * v["limit"]}
                if weak:
                    raise AssertionError(f"K5 {label}: the data term moves these weight momenta "
                                         f"less than 5x the check's limit, so the check cannot "
                                         f"see a wrong gradient: {weak}")
                del nodata
            del ref
        moved = (got[0][0] - bw[0]).abs().max().item()
        k5_ms = cuda_ms(lambda: LF.integrate_chains_packed(act, *args), runs=3)
        k5_plain_ms = cuda_ms(lambda: LF.integrate_chains_packed_ref(act, *args), runs=1)
        k5_bound, k5_impl, k5_f32 = deep_bound(BLOCK * CHAINS * N_TRAIN * (L + 1), live,
                                               (m_pad, h, s), depth,
                                               nbytes(x_b.bytes, x_b.w_scale, x_b.shift, targets,
                                                      err) + 8 * nbytes(*bw, *bb))
        print(f"  K5 {label}: L={L} {k5_ms:.3f} ms, plain {k5_plain_ms:.3f} ms, bound "
              f"{k5_bound[0]:.3f} ms ({k5_bound[1]}, live widths {live}; as implemented "
              f"{k5_impl:.3f} ms, f32 {k5_f32:.3f} ms); plan {plan5}; identical repeats; "
              f"max |W0_L - W0_0| {moved:.3e}")
        out["k5"][label] = {"ms": k5_ms, "plain_ms": k5_plain_ms, "bound_ms": k5_bound[0],
                            "bound_by": k5_bound[1], "impl_bound_ms": k5_impl,
                            "f32_bound_ms": k5_f32, "max_abs_err": k5_err, "plan": plan5,
                            "data_effect": data_effect}
        del got, targets, bw, bb, p_w, p_b, eps_w, eps_b

    # the library yardstick: torch.matmul on the decoded f32 X at the
    # block's layer 0 (K5's forward product for the C chains side by side)
    xs = PM.unpack_strided(x_b.bytes, N_TRAIN).float().transpose(1, 2)  # [B, n, m]
    w_lib = torch.randn((BLOCK, xs.shape[-1], CHAINS * 56), device=dev)
    out["library_ms"] = cuda_ms(lambda: torch.matmul(xs, w_lib))
    print(f"  torch.matmul on the decoded f32 X at the block's layer 0 ([{BLOCK}, {N_TRAIN}, "
          f"{xs.shape[-1]}] x [{xs.shape[-1]}, {CHAINS} x 56]): {out['library_ms']:.3f} ms")
    del xs, w_lib

    # ---- phase 16b: the slice through the CLI, depth 2 tanh at the default widths
    print(f"phase 16b: train-new ridge_ard tanh 2 at the default widths --update-mode hybrid "
          f"--num-chains {CHAINS} {' '.join(ADAPT_ARGS)} -> predict")
    runs = os.path.join(work, "runs_deep")
    base = ["train-new", os.path.join(work, "train"), os.path.join(work, "train.phen"),
            os.path.join(work, "train.groups"), "ridge_ard", "tanh", "2", CHAIN, L,
            "--packed-genotypes", "--burn-in", "1", "--bfile-test", os.path.join(work, "test"),
            "--p-test", os.path.join(work, "test.phen"), "-o", runs, "--update-mode", "hybrid",
            "--num-chains", CHAINS] + ADAPT_ARGS
    kernels = {"integrate_chains_packed": LF.integrate_chains_packed,
               "packed_linear": PM.packed_linear, "data_vg_packed": BM.data_vg_packed}
    test_gen = CompressedGenotypes(BedVM.from_file(os.path.join(work, "test")), groups)

    blocks = G // BLOCK
    _, recs, out["16b"] = cli_phase(cli, work, base, kernels, log_records, test_gen, y_test, {
        "integrate_chains_packed": blocks, "packed_linear": 2 * blocks, "data_vg_packed": 0})
    del recs

    # ---- phase 16c: the whole recipe at the default widths
    print(f"phase 16c: train-new ridge_ard identity 0 at the default widths (layer 0 width 56) "
          f"with {' '.join(ADAPT_ARGS + SSM_ARGS)} -> predict")
    argv = list(base)
    argv[5:7] = ["identity", "0"]
    kernels = dict(kernels, packed_matmul_vjp=PM.packed_matmul_vjp, marker_scan=MS.marker_scan)
    _, recs, out["16c"] = cli_phase(cli, work, argv + SSM_ARGS, kernels, log_records, test_gen,
                                    y_test, {
        "integrate_chains_packed": blocks, "packed_linear": 3 * blocks, "data_vg_packed": 0,
        "packed_matmul_vjp": blocks, "marker_scan": blocks})
    carry = recs[-1]["carry"]
    arch0 = archs["depth 0 identity, width 56"]
    X.form_gram()
    out["scan"] = scan_block_check(X, carry, arch0, ixs)
    print(f"  marker_scan at the block ({out['scan']['instances']} instances, width 56): kernel "
          f"{out['scan']['ms']:.4f} ms ({out['scan']['us_per_marker']:.3f} us per dependent "
          f"marker step), plain {out['scan']['plain_ms']:.3f} ms; identical repeats")
    del recs, carry
    return out


def dense_fmas(m, h, s, depth, grad=True):
    """FMAs of one dense branch MLP of ``depth`` hidden layers of width h and
    a summary layer of width s (at depth 0 layer 0 has width s), for one
    individual and one chain: the forward, plus the backward with ``grad``
    (dW0, and per hidden and summary layer its dW and the product back)."""
    dims = [(h, h)] * (depth - 1) + ([(h, s)] if depth else [])
    k0, hid = (h if depth else s), sum(i * o for i, o in dims)
    return m * k0 + hid + s + (m * k0 + 2 * hid + s if grad else 0)


def dense_bounds(n_evals, live, depth, nbytes_moved, grad=True):
    """The bounds of ``n_evals`` (individual, chain) evaluations of the dense
    MLP at the live widths ``live`` = (m, h, s): (least ms, what bounds it)
    with every product in 3xTF32 at 494.7 TFLOP/s (the card's f32-exact
    tensor-core rate, as K6-K8 run layer 0), and the ms of the same FMAs
    at the 67 TFLOP/s f32 peak; each against ``nbytes_moved``."""
    flop = 2.0 * n_evals * dense_fmas(*live, depth, grad)
    return tf32_bound(flop, nbytes_moved), bound(flop, nbytes_moved)[0]


def dense_deep_phases(cli, work, train_bed, groups, y_train, y_test, log_records):
    """Phases 17-17d: the dense kernels' deep design (csrc/dense_deep.cuh:
    any depth, padded widths up to 64) at the genome-scale shape in
    feature-major f32 (m_pad 104, n 100,000) and the JAX CLI's default
    width rule (h = s = 50, padded 56). Returns their numbers."""
    import numpy as np
    import torch

    from rs_bann_tpu_torch.io import BedVM
    from rs_bann_tpu_torch.io.genotypes import CompressedGenotypes
    from rs_bann_tpu_torch.models import NetArch
    from rs_bann_tpu_torch.models import params as P
    from rs_bann_tpu_torch.models.init import InitCfg, init_net
    from rs_bann_tpu_torch.ops import _build
    from rs_bann_tpu_torch.ops import branch_mlp as BM
    from rs_bann_tpu_torch.ops import leapfrog as LF
    from rs_bann_tpu_torch.ops import marker_scan as MS
    from rs_bann_tpu_torch.ops import packed_matmul as PM
    from rs_bann_tpu_torch.ops.activations import ACT_CODES
    from rs_bann_tpu_torch.samplers import MCMCCfg
    from rs_bann_tpu_torch.samplers import hmc as H

    dev = torch.device("cuda")
    lib = _build.lib()
    vp = ctypes.c_void_p
    out = {"k8a": {}, "k8b": {}, "k7": {}, "k7_fwd": {}, "k6": {}}
    rule = ("fraction_of_input", 0.5), ("fraction_of_hidden", 1.0)  # the JAX CLI's defaults
    archs = {
        "depth 2 tanh, h = s = 56": NetArch.from_width_rules([M] * G, 2, *rule, activation="tanh"),
        "depth 0 identity, width 56": NetArch.from_width_rules([M] * G, 0, *rule,
                                                               activation="identity"),
        "depth 3 tanh, width 16": NetArch.from_width_rules([M] * G, 3, ("fixed", 16),
                                                           ("fixed", 16), activation="tanh"),
    }
    build_log = _build.BUILD_DIR / "build.log"
    if build_log.exists():
        import re

        text, cur = build_log.read_text(), None
        for line in text.splitlines():
            m_ = re.search(r"Compiling entry function '\S*(run_kernel|traj_dense_deep_kernel)ILi(\d+)E"
                           r"Lb(\d)E(Lb(\d))?", line)
            if m_:  # run_kernel<KM, GRAD, XB>, traj_dense_deep_kernel<KM, XB>
                grad = "" if m_.group(5) is None else (", grad" if m_.group(3) == "1" else ", fwd")
                xb = m_.group(5) if m_.group(5) is not None else m_.group(3)
                cur = f"{m_.group(1)}<KM={m_.group(2)}{grad}{', bf16 X' if xb == '1' else ''}>"
            elif "Compiling entry function" in line:
                cur = None
            elif cur and "Used" in line:
                print(f"  ptxas {cur}: {line.split(':', 1)[1].strip()}")
            elif cur and "spill" in line:
                print(f"  ptxas {cur}: {line.strip()}")

    # feature-major f32 X of the training genotypes; m_pad 104 at every width
    t0 = time.perf_counter()
    X = CompressedGenotypes(train_bed, groups).to_feature_major(
        archs["depth 0 identity, width 56"], dev).X
    print(f"phase 17: the dense deep design (csrc/dense_deep.cuh): K8a on one branch, K8b on "
          f"{CHAINS} chains x {BLOCK} branches through an index, K7 (value and gradient, and "
          f"forward only) and K6 on one hybrid block (B {BLOCK}, C {CHAINS}), n {N_TRAIN}; "
          f"xT {tuple(X.xT.shape)} f32 ({time.perf_counter() - t0:.1f} s)")
    g = G // 2
    xg = X.xT[g]
    ixs = torch.arange(BLOCK, device=dev) * (G // BLOCK)
    xb = X.xT[ixs].contiguous()
    y_dev = torch.as_tensor(y_train, dtype=torch.float32, device=dev)
    gen = torch.Generator(dev).manual_seed(9)
    target = y_dev + 0.1 * torch.randn(N_TRAIN, device=dev, generator=gen)
    ix40 = ixs.repeat(CHAINS).to(torch.int32)  # instance c B + b reads branch ixs[b]
    targets = y_dev + 0.1 * torch.randn((BLOCK, CHAINS, N_TRAIN), device=dev, generator=gen)

    def names_of(L_):
        return (["y_pred", "rss"] + [f"dW{l}" for l in range(L_)]
                + [f"db{l}" for l in range(L_ - 1)])

    def hold(kernel, label, names, got, want, want64, tol=REL_TOL):
        """f32 within ``tol``; f64 no further than the f32 plain version, plus ``tol``."""
        err = max(check_close(kernel, f"{label} {nm}", a, b, tol)
                  for nm, a, b in zip(names, got, want))
        for nm, a, b, b64 in zip(names, got, want, want64):
            plain64 = (b.double() - b64).abs().max().item() / max(1.0, b64.abs().max().item())
            check_close(kernel + " f64", f"{label} {nm} (f64; f32 plain {plain64:.2e})",
                        a.double(), b64, tol=plain64 + tol)
        return err

    def flat(o):
        return (o[0], o[1]) + tuple(o[2]) + tuple(o[3])

    for label, arch in archs.items():
        act, depth, code = arch.activation, arch.depth, ACT_CODES[arch.activation]
        h, s = arch.layer_out_pad(0), arch.s_pad
        state, _ = init_net(arch, "ridge_ard", InitCfg(seed=0), device=dev)
        ws, bs = tuple(w[g] for w in state.params.weights), tuple(b[g] for b in state.params.biases)
        m_pad = ws[0].shape[0]
        live = (arch.m[g], arch.h[g], arch.s[g])
        names = names_of(len(ws))

        def cast(ts, dt):
            return tuple(t.to(dt) for t in ts)

        # ---- K8a: one branch
        k8a = lambda: flat(BM.data_vg(act, xg, ws, bs, target))  # noqa: E731
        k8a_plain = lambda dt=torch.float32: flat(BM.data_vg_ref(  # noqa: E731
            act, xg.to(dt), cast(ws, dt), cast(bs, dt), target.to(dt)))
        got = k8a()
        err = hold("data_vg_deep", f"K8a {label}", names, got, k8a_plain(), k8a_plain(torch.float64))
        identical(k8a, got, f"K8a {label}")
        q = BM.flat_params(ws, bs)
        Pf = q.numel()
        plan = BM.vg_dense_plan(1, m_pad, N_TRAIN, h, s, depth, act=act)
        buf = torch.empty(N_TRAIN + Pf + 1, device=dev)
        scr = torch.empty(plan["scratch"], dtype=torch.uint8, device=dev)
        c_args = (vp(xg.data_ptr()), None, vp(target.data_ptr()), vp(q.data_ptr()),
                  vp(buf.data_ptr()), vp(scr.data_ptr()), plan["scratch"], 1, m_pad, N_TRAIN, h,
                  s, depth, code, 1, 0, vp(_build.stream_ptr(xg)))

        def k8a_alone(reps=10):
            for _ in range(reps):
                _build.check(lib.vg_dense_deep_f32(*c_args), "vg_dense_deep_f32")

        ms, wrapper_ms = cuda_ms(k8a_alone, runs=5) / 10, cuda_ms(k8a, runs=5)
        plain_ms = cuda_ms(k8a_plain, runs=3)
        bnd, f32b = dense_bounds(N_TRAIN, live, depth,
                                 nbytes(xg, target, q) + 4 * (N_TRAIN + Pf + 1))
        print(f"  K8a {label}: launch alone {ms:.4f} ms (the pass and its reduce), wrapper "
              f"{wrapper_ms:.4f} ms, plain {plain_ms:.3f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}, "
              f"live widths {live}, 3xTF32), f32 {f32b:.4f} ms; plan {plan}; identical repeat")
        out["k8a"][label] = {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                             "bound_ms": bnd[0], "bound_by": bnd[1], "f32_bound_ms": f32b,
                             "max_abs_err": err, "plan": plan}
        del got, buf, scr

        # ---- K8b: C x B instances on the block's branches, X read through ix
        noise = torch.Generator(dev).manual_seed(10)

        def per_chain(ts):  # [B, ...] of the block -> [C B, ...], each chain perturbed
            return tuple((t[ixs][None] * (1 + 0.05 * torch.randn(
                (CHAINS,) + t[ixs].shape, device=dev, generator=noise))).reshape(
                    (CHAINS * BLOCK,) + t.shape[1:]).contiguous() for t in ts)

        wb, bb = per_chain(state.params.weights), per_chain(state.params.biases)
        tb = targets.transpose(0, 1).reshape(CHAINS * BLOCK, N_TRAIN).contiguous()
        k8b = lambda: flat(BM.data_vg_blocked(act, X.xT, ix40, wb, bb, tb))  # noqa: E731
        ix_b = torch.arange(CHAINS * BLOCK, device=dev) % BLOCK  # the same branches in xb
        k8b_plain = lambda dt=torch.float32: flat(BM.data_vg_blocked_ref(  # noqa: E731
            act, xb.to(dt), ix_b, cast(wb, dt), cast(bb, dt), tb.to(dt)))
        got = k8b()
        err = hold("data_vg_blocked_deep", f"K8b {label}", names, got, k8b_plain(),
                   k8b_plain(torch.float64))
        identical(k8b, got, f"K8b {label}")
        qb = BM.flat_params(wb, bb)
        plan = BM.vg_dense_plan(CHAINS * BLOCK, m_pad, N_TRAIN, h, s, depth, act=act)
        buf = torch.empty(CHAINS * BLOCK * (N_TRAIN + Pf + 1), device=dev)
        scr = torch.empty(plan["scratch"], dtype=torch.uint8, device=dev)
        c_args = (vp(X.xT.data_ptr()), vp(ix40.data_ptr()), vp(tb.data_ptr()), vp(qb.data_ptr()),
                  vp(buf.data_ptr()), vp(scr.data_ptr()), plan["scratch"], CHAINS * BLOCK,
                  m_pad, N_TRAIN, h, s, depth, code, 1, 0, vp(_build.stream_ptr(xg)))

        def k8b_alone(reps=3):
            for _ in range(reps):
                _build.check(lib.vg_dense_deep_f32(*c_args), "vg_dense_deep_f32")

        ms, wrapper_ms = cuda_ms(k8b_alone, runs=3) / 3, cuda_ms(k8b, runs=3)
        plain_ms = cuda_ms(k8b_plain, runs=3)
        bnd, f32b = dense_bounds(CHAINS * BLOCK * N_TRAIN, live, depth,
                                 nbytes(xb, tb, qb, ix40) + 4 * buf.numel())
        print(f"  K8b {label}: launch alone {ms:.4f} ms (NB {CHAINS * BLOCK}), wrapper "
              f"{wrapper_ms:.4f} ms, plain {plain_ms:.3f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}), "
              f"f32 {f32b:.4f} ms; plan {plan}; identical repeat")
        out["k8b"][label] = {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                             "bound_ms": bnd[0], "bound_by": bnd[1], "f32_bound_ms": f32b,
                             "max_abs_err": err, "plan": plan}
        del got, buf, scr

        # ---- K7 on the block: [B, C] instances, each chain perturbed
        def block(ts):  # [C B, ...] -> [B, C, ...]
            return tuple(t.reshape((CHAINS, BLOCK) + t.shape[1:]).transpose(0, 1).contiguous()
                         for t in ts)

        w7, b7 = block(wb), block(bb)
        k7 = lambda: flat(BM.data_vg_chains(act, xb, w7, b7, targets))  # noqa: E731
        k7_plain = lambda dt=torch.float32: flat(BM.data_vg_chains_ref(  # noqa: E731
            act, xb.to(dt), cast(w7, dt), cast(b7, dt), targets.to(dt)))
        got = k7()
        err = hold("data_vg_chains_deep", f"K7 {label}", names, got, k7_plain(),
                   k7_plain(torch.float64))
        identical(k7, got, f"K7 {label}")
        fwd = lambda: BM.forward_chains(act, xb, w7, b7)  # noqa: E731
        fwd_plain = lambda dt=torch.float32: BM.forward_chains_ref(  # noqa: E731
            act, xb.to(dt), cast(w7, dt), cast(b7, dt))
        y_fwd = fwd()
        err_fwd = hold("data_vg_chains_deep", f"K7 forward-only {label}", ["y_pred"], [y_fwd],
                       [fwd_plain()], [fwd_plain(torch.float64)])
        identical(fwd, y_fwd, f"K7 forward-only {label}")
        if not torch.equal(y_fwd, got[0]):
            raise AssertionError(f"K7 {label}: the forward-only y_pred differs from the pass's")
        q7 = BM.flat_params(w7, b7)
        nums = {}
        for grad in (True, False):
            plan = BM.vg_chains_plan(BLOCK, CHAINS, m_pad, N_TRAIN, h, s, depth, grad, act)
            size = BLOCK * CHAINS * ((N_TRAIN + Pf + 1) if grad else N_TRAIN)
            buf = torch.empty(size, device=dev)
            scr = torch.empty(max(plan["scratch"], 8), dtype=torch.uint8, device=dev)
            c_args = (vp(xb.data_ptr()), vp(targets.data_ptr()), N_TRAIN * CHAINS, N_TRAIN,
                      vp(q7.data_ptr()), vp(buf.data_ptr()), vp(scr.data_ptr()), plan["scratch"],
                      BLOCK, CHAINS, m_pad, N_TRAIN, h, s, depth, code, int(grad), 0,
                      vp(_build.stream_ptr(xb)))

            def k7_alone(reps=3, c_args=c_args):
                for _ in range(reps):
                    _build.check(lib.vg_chains_deep_f32(*c_args), "vg_chains_deep_f32")

            ms = cuda_ms(k7_alone, runs=3) / 3
            wrapper_ms = cuda_ms(k7 if grad else fwd, runs=3)
            plain_ms = cuda_ms(k7_plain if grad else fwd_plain, runs=3)
            moved = nbytes(xb, q7) + 4 * size + (nbytes(targets) if grad else 0)
            bnd, f32b = dense_bounds(BLOCK * CHAINS * N_TRAIN, live, depth, moved, grad)
            kind = "value and gradient" if grad else "forward only"
            print(f"  K7 {kind} {label}: launch alone {ms:.4f} ms, wrapper {wrapper_ms:.4f} ms, "
                  f"plain {plain_ms:.3f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}), f32 {f32b:.4f} "
                  f"ms; plan {plan}; identical repeat")
            nums[grad] = {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                          "bound_ms": bnd[0], "bound_by": bnd[1], "f32_bound_ms": f32b,
                          "max_abs_err": err if grad else err_fwd, "plan": plan}
            del buf, scr
        out["k7"][label], out["k7_fwd"][label] = nums[True], nums[False]
        del got, y_fwd

        # ---- K6 on the block: izmailov step sizes (factor 0.1) from the
        # initial precisions, each chain's weights perturbed, L = 1 and L
        def chains_of(ts):
            return tuple(t[ixs].unsqueeze(1).expand((BLOCK, CHAINS) + t.shape[1:]).contiguous()
                         for t in ts)

        bw, bbias = w7, b7
        mws, mbs = chains_of(P.weight_masks(arch, dev)), chains_of(P.bias_masks(arch, dev))
        wps, bps = chains_of(state.precisions.weights), chains_of(state.precisions.biases)
        eps_w, eps_b = H.step_sizes(None, "ridge_ard", MCMCCfg(hmc_integration_length=L,
                                                               hmc_step_size_factor=0.1),
                                    bw, bbias, wps, bps, None)
        p_w = tuple(torch.randn(w.shape, device=dev, generator=gen) * mk for w, mk in zip(bw, mws))
        p_b = tuple(torch.randn(b.shape, device=dev, generator=gen) * mk
                    for b, mk in zip(bbias, mbs))
        err6 = torch.full((BLOCK, CHAINS), 1.0 / y_dev.var().item(), device=dev)
        lam_w = tuple(lam.expand_as(w) for lam, w in zip(wps, bw))
        lam_b = tuple(lam.expand_as(b) for lam, b in zip(bps, bbias))
        plan6 = LF.traj_dense_plan(BLOCK, CHAINS, m_pad, N_TRAIN, h, s, depth, act)
        k6_err, data_effect = 0.0, {}
        for steps, tol in ((1, REL_TOL), (L, REL_TOL_TRAJ)):
            args = (xb, targets, err6, bw, bbias, p_w, p_b, eps_w, eps_b, lam_w, lam_b, steps)
            got = tuple(t for o in LF.integrate_chains(act, *args) for t in o)
            ref = tuple(t for o in LF.integrate_chains_ref(act, *args) for t in o)
            args64 = tuple(tuple(t.double() for t in a) if isinstance(a, tuple)
                           else a.double() if isinstance(a, torch.Tensor) else a for a in args)
            ref64 = tuple(t for o in LF.integrate_chains_ref(act, *args64) for t in o)
            k6_err = max(k6_err, hold("traj_dense_deep", f"K6 {label}, L={steps}",
                                      [f"out {k}" for k in range(len(got))], got, ref, ref64, tol))
            identical(lambda: tuple(t for o in LF.integrate_chains(act, *args) for t in o), got,
                      f"K6 {label}, L={steps}")
            if steps == L:  # the data term's share of each momentum, as phase 16
                nodata = LF.integrate_chains_ref(act, *args[:2], torch.zeros_like(err6), *args[3:])
                nw, nb_ = len(bw), len(bbias)  # got and ref: w, b, pw, pb flattened
                pw_ref, pb_ref = ref[nw + nb_:2 * nw + nb_], ref[2 * nw + nb_:]
                for kind, refs, nods, p0s in (("pw", pw_ref, nodata[2], p_w),
                                              ("pb", pb_ref, nodata[3], p_b)):
                    for l, (a, b, p0) in enumerate(zip(refs, nods, p0s)):
                        limit = tol * max(1.0, a.abs().max().item())
                        data_effect[f"{kind}{l}"] = {
                            "moved": (a - p0).abs().max().item(),
                            "data": (a - b).abs().max().item(), "limit": limit}
                print(f"  K6 {label}, L={L}: max |p_L - p_0|, the data term's share and the "
                      f"check's limit per momentum: " + ", ".join(
                          f"{k} {v['moved']:.3e}/{v['data']:.3e}/{v['limit']:.1e}"
                          for k, v in data_effect.items()))
                weak = {k: v for k, v in data_effect.items()
                        if k.startswith("pw") and v["data"] < 5 * v["limit"]}
                if weak:
                    raise AssertionError(f"K6 {label}: the data term moves these weight momenta "
                                         f"less than 5x the check's limit: {weak}")
                del nodata
            del ref, ref64
        k6_ms = cuda_ms(lambda: LF.integrate_chains(act, *args), runs=3)
        k6_plain_ms = cuda_ms(lambda: LF.integrate_chains_ref(act, *args), runs=1)
        bnd, f32b = dense_bounds(BLOCK * CHAINS * N_TRAIN * (L + 1), live, depth,
                                 nbytes(xb, targets, err6) + 8 * nbytes(*bw, *bbias))
        print(f"  K6 {label}: L={L} {k6_ms:.3f} ms, plain {k6_plain_ms:.3f} ms, bound "
              f"{bnd[0]:.3f} ms ({bnd[1]}, live widths {live}, 3xTF32), f32 {f32b:.3f} ms; "
              f"plan {plan6}; identical repeats")
        out["k6"][label] = {"ms": k6_ms, "plain_ms": k6_plain_ms, "bound_ms": bnd[0],
                            "bound_by": bnd[1], "f32_bound_ms": f32b, "max_abs_err": k6_err,
                            "plan": plan6, "data_effect": data_effect}
        del got, bw, bbias, p_w, p_b, eps_w, eps_b, w7, b7, wb, bb

    # the library yardstick: torch.matmul W0^T X at the block's layer 0 (the
    # C chains' columns side by side)
    w_lib = torch.randn((BLOCK, CHAINS * 56, xb.shape[1]), device=dev)
    out["library_ms"] = cuda_ms(lambda: torch.matmul(w_lib, xb))
    print(f"  torch.matmul W0^T X at the block's layer 0 ([{BLOCK}, {CHAINS} x 56, "
          f"{xb.shape[1]}] x [{xb.shape[1]}, {N_TRAIN}]): {out['library_ms']:.3f} ms")
    del w_lib, xb, xg, X

    # ---- phases 17b-17d: the CLI on --feat-major at the default widths
    runs = os.path.join(work, "runs_dense_deep")
    base = ["train-new", os.path.join(work, "train"), os.path.join(work, "train.phen"),
            os.path.join(work, "train.groups"), "ridge_ard", "tanh", "2", CHAIN, L,
            "--feat-major", "--burn-in", "1", "--bfile-test", os.path.join(work, "test"),
            "--p-test", os.path.join(work, "test.phen"), "-o", runs]
    folded = ["--update-mode", "hybrid", "--num-chains", CHAINS] + ADAPT_ARGS
    kernels = {"integrate_chains": LF.integrate_chains, "data_vg_chains": BM.data_vg_chains,
               "data_vg": BM.data_vg, "data_vg_blocked": BM.data_vg_blocked,
               "forward_blocked": BM.forward_blocked, "data_vg_packed": BM.data_vg_packed,
               "integrate_chains_packed": LF.integrate_chains_packed,
               "packed_matmul_vjp": PM.packed_matmul_vjp}
    test_gen = CompressedGenotypes(BedVM.from_file(os.path.join(work, "test")), groups)
    blocks = G // BLOCK
    none = {k: 0 for k in kernels}
    print(f"phase 17b: train-new --feat-major ridge_ard tanh 2 at the default widths "
          f"{' '.join(map(str, folded))} -> predict")
    _, recs, out["17b"] = cli_phase(cli, work, base + folded, kernels, log_records, test_gen,
                                    y_test, dict(none, integrate_chains=blocks,
                                                 data_vg_chains=2 * blocks), packed=False)
    out["17b_runs"] = [r["launches"] for r in recs]
    del recs

    print(f"phase 17c: train-new --feat-major ridge_ard identity 0 at the default widths (layer "
          f"0 width 56) with {' '.join(ADAPT_ARGS + SSM_ARGS)} -> predict")
    argv = list(base)
    argv[5:7] = ["identity", "0"]
    kernels_c = dict(kernels, marker_scan=MS.marker_scan)
    _, recs, out["17c"] = cli_phase(cli, work, argv + folded + SSM_ARGS, kernels_c, log_records,
                                    test_gen, y_test,
                                    dict(none, integrate_chains=blocks, data_vg_chains=3 * blocks,
                                         marker_scan=blocks), packed=False)
    del recs

    # 17d: one sweep each, without the adaptation, kept (burn-in 0), on a
    # training set of the same population and phenotype model cut to n =
    # N_17D: the schedules' launches do not depend on n, and at n =
    # 100,000 the two runs' data loads and sweeps took ~85 s of the
    # script's 1,200
    small, y_test_s = small_data(work)
    test_s = CompressedGenotypes(BedVM.from_file(os.path.join(small, "test")), groups)
    one = ["train-new", os.path.join(small, "train"), os.path.join(small, "train.phen"),
           os.path.join(small, "train.groups"), "ridge_ard", "tanh", "2", 1, L, "--feat-major",
           "--burn-in", "0", "--bfile-test", os.path.join(small, "test"), "--p-test",
           os.path.join(small, "test.phen"), "-o", runs]
    print(f"phase 17d: train-new --feat-major ridge_ard tanh 2 at the default widths, n {N_17D}, "
          f"one sweep: --update-mode hybrid --per-chain-block-perm --num-chains {CHAINS}, then "
          f"sequential with one chain -> predict")
    _, recs, out["17d_unfolded"] = cli_phase(
        cli, small, one + ["--update-mode", "hybrid", "--per-chain-block-perm", "--num-chains",
                           CHAINS], kernels, log_records, test_s, y_test_s,
        dict(none, data_vg_blocked=blocks * (L + 2), forward_blocked=blocks), packed=False,
        sweeps=1)
    out["17d_unfolded_runs"] = [r["launches"] for r in recs]
    del recs
    _, recs, out["17d_sequential"] = cli_phase(cli, small, one, kernels, log_records, test_s,
                                               y_test_s, dict(none, data_vg=G * (L + 1)),
                                               packed=False, sweeps=1)
    out["17d_sequential_runs"] = [r["launches"] for r in recs]
    del recs
    return out


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


def resume_phase(cli, work, full, hybrid_args, kernels, log_records):
    """Phase 6d: phase 6c's recipe run 3 sweeps straight with a checkpoint
    after every sweep (A), 1 sweep with a checkpoint (B), and resumed from
    B's checkpoint to 3 (C): C's samples 2 and 3 of every chain, its final
    checkpoint (the whole carry and the generator's state), training_stats
    and inclusion_probs equal to A's bit for bit, each resumed sweep's
    launches A's; the checkpoint's bytes and write ms. Then ``train`` from
    A's sample for one sweep, its perturbed start against the same
    command's under --cpu bit for bit; each on the data under ``work``.
    Then ``branch-r2`` and ``population-effect-sizes`` on the training set
    under ``full`` (n = 100,000, where population-effect-sizes takes its
    branches in chunks), ``activations`` on its test set, each on a models
    directory of A's sample, on the card against --cpu within REL_TOL of
    max(1, the largest entry), each with exactly its K2 launches (and their
    device time) and no plain-version call on the card. Returns the
    measurements."""
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

    # the analysis commands on a models directory of one sample, on the
    # full data: one K2 launch per sample, population-effect-sizes' [n,
    # m_pad] effect sizes of 100 branches in chunks of 48 under 2 GB at n =
    # 100,000 (Net._branch_map) one per chunk
    k2_want = {"branch-r2": 1, "population-effect-sizes": 3, "activations": 1}
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
                args = [cmd, os.path.join(full, data)] + (
                    [] if cmd == "activations" else [os.path.join(full, f"{data}.phen")]) + [
                    os.path.join(full, "train.groups"), "-m", models, "--packed-genotypes"]
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
                    or card["k2_launches"] != k2_want[cmd] or card["plain_calls"]
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


class Xbf16:
    """A dense wrapper's launches on bf16 X (its ``xbf16_launches``), read
    and reset as the counters of ``cli_phase`` are."""

    def __init__(self, wrapper):
        self.wrapper = wrapper

    @property
    def launches(self):
        return self.wrapper.xbf16_launches

    @launches.setter
    def launches(self, value):
        self.wrapper.xbf16_launches = value


@contextlib.contextmanager
def x_seen():
    """Record the dtype and the bytes of the training X each train-new hands
    the trainer (a list of (dtype, bytes))."""
    import rs_bann_tpu_torch.train as TT

    seen, real = [], TT.train

    def spy(net, dtr, *a, **k):
        seen.append((str(dtr.X.xT.dtype), dtr.X.xT.numel() * dtr.X.xT.element_size()))
        return real(net, dtr, *a, **k)

    TT.train = spy
    try:
        yield seen
    finally:
        TT.train = real


def xb_bound(n_evals, fmas0, fmas_rest, nbytes_moved):
    """The bounds of a dense kernel on bf16 X, against ``nbytes_moved`` (X in
    bf16) over 3.35 TB/s: (least ms, what bounds it) of the function's work
    at the card's f32-exact tensor-core rates, as ``deep_bound`` counts it:
    layer 0's products (``fmas0`` per evaluation: z0 and dW0) in three bf16
    products per f32 one at 989 TFLOP/s (X exact in bf16, the operand that
    is not split), every other product (``fmas_rest``) in 3xTF32 at 494.7
    TFLOP/s; and the ms of the work as implemented, layer 0 in two tf32
    products per f32 one (X exact in tf32, its zero low part left out) and
    the rest in three, all at 494.7 TFLOP/s."""
    bytes_ms = 1e3 * nbytes_moved / PEAK_BYTES_S
    ops_ms = 2e3 * n_evals * (3 * fmas0 / PEAK_BF16_FLOPS + 3 * fmas_rest / PEAK_TF32_FLOPS)
    impl_ms = max(2e3 * n_evals * (2 * fmas0 + 3 * fmas_rest) / PEAK_TF32_FLOPS, bytes_ms)
    return ((ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")), impl_ms


def bf16_phases(cli, work, train_bed, groups, y_train, y_test, log_records, flag, train_args,
                hybrid_sweep_ms):
    """Phases 18-18c: K6, K7 (both forms), K8a and K8b on feature-major X
    stored in bf16 (--x-bf16) on both device codes, the flagship through the
    CLI with --x-bf16 on every schedule, 17c's recipe with --x-bf16 and
    phase 6's packed hybrid with --bf16. ``flag``: the flagship's data
    (phase 7) and phase 9's ms per sweep. Returns their numbers."""
    import numpy as np
    import torch

    from rs_bann_tpu_torch.io import BedVM
    from rs_bann_tpu_torch.io.genotypes import CompressedGenotypes
    from rs_bann_tpu_torch.models import NetArch
    from rs_bann_tpu_torch.models import density as D
    from rs_bann_tpu_torch.models import params as P
    from rs_bann_tpu_torch.models.init import InitCfg, init_net
    from rs_bann_tpu_torch.ops import branch_mlp as BM
    from rs_bann_tpu_torch.ops import leapfrog as LF
    from rs_bann_tpu_torch.ops import marker_scan as MS
    from rs_bann_tpu_torch.ops import packed_matmul as PM
    from rs_bann_tpu_torch.samplers import MCMCCfg
    from rs_bann_tpu_torch.samplers import hmc as H

    dev, XB = torch.device("cuda"), torch.bfloat16
    out = {"flagship": {}, "deep": {}}
    names = {"data_vg_chains_xbf16": "K7", "traj_dense_xbf16": "K6", "data_vg_xbf16": "K8a",
             "data_vg_blocked_xbf16": "K8b"}

    def flat(o):
        return (o[0], o[1]) + tuple(o[2]) + tuple(o[3])

    def cast(ts, dt):
        return tuple(t.to(dt) for t in ts)

    def check(kernel, label, fn, plain, xb, tol=REL_TOL, runs=TIMED_RUNS):
        """The bf16-X form of ``kernel``: fn(x) (a tuple of outputs) on the
        bf16 X ``xb`` against plain(x, dtype), the plain version on the same
        bf16 X (upcast exactly): f32 within ``tol``, f64 no further than the
        f32 plain version plus ``tol``; identical on a repeat; the f32-X
        kernel on X upcast gives the same bits (the products leave out only
        X's zero low part). Returns (err, ms of the wrapper's call, plain
        ms, ms of the f32-X kernel's call on X upcast: the same work on
        twice X's bytes, timed in the same call)."""
        got = fn(xb)
        want, want64 = plain(xb, torch.float32), plain(xb, torch.float64)
        err = 0.0
        for k, (a, b, b64) in enumerate(zip(got, want, want64)):
            err = max(err, check_close(kernel, f"{label} out {k}", a, b, tol))
            plain64 = (b.double() - b64).abs().max().item() / max(1.0, b64.abs().max().item())
            check_close(kernel + " f64", f"{label} out {k} (f64; f32 plain {plain64:.2e})",
                        a.double(), b64, tol=plain64 + tol)
        del want, want64
        identical(lambda: fn(xb), got, label)
        xf = xb.float()
        f32 = fn(xf)
        differ = [k for k, (a, b) in enumerate(zip(got, f32)) if not torch.equal(a, b)]
        if differ:
            raise AssertionError(f"{label}: outputs {differ} differ from the f32-X kernel's on "
                                 f"the upcast X")
        del got, f32
        ms = cuda_ms(lambda: fn(xb), runs=runs)
        f32_ms = cuda_ms(lambda: fn(xf), runs=runs)
        plain_ms = cuda_ms(lambda: plain(xb, torch.float32), runs=min(runs, 3))
        del xf
        print(f"  {label}: wrapper {ms:.4f} ms (the f32-X kernel on X upcast {f32_ms:.4f} ms), "
              f"plain {plain_ms:.3f} ms; identical repeat; bit for bit the f32-X kernel on X "
              f"upcast")
        return err, ms, plain_ms, f32_ms

    def kernels_on(xb, label, ws, bs, ix, block_ix, targets1, targets, chains_ws, chains_bs,
                   wps, bps, masks, depth, live, act, model_type, res):
        """K8a on branch ix[0] of xb's branches, K8b on ``len(ix)``
        instances through ``ix``, K7 (both forms) and K6 (L = 1, L) on the
        block ``block_ix`` of C chains; each one's check, time and bound
        into ``res``."""
        m, h, s = live
        k0 = h if depth else s
        fm0 = m * k0
        fall = {g: dense_fmas(m, h, s, depth, g) for g in (True, False)}
        n = xb.shape[-1]
        g = int(ix[0])
        w1, b1 = tuple(w[0] for w in ws), tuple(b[0] for b in bs)
        fn = lambda x: flat(BM.data_vg(act, x[0], w1, b1, targets1[0]))  # noqa: E731
        plain = lambda x, dt: flat(BM.data_vg_ref(  # noqa: E731
            act, x[0], cast(w1, dt), cast(b1, dt), targets1[0].to(dt)))
        err, ms, plain_ms, f32_ms = check("data_vg_xbf16", f"K8a {label}", fn, plain,
                                          xb[g:g + 1])
        bnd, impl = xb_bound(n, 2 * fm0, fall[True] - 2 * fm0,
                       nbytes(xb[g], targets1[0], *w1, *b1) + 4 * (n + sum(w.numel() for w in w1 + b1) + 1))
        res["data_vg_xbf16"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                "bound_ms": bnd[0], "bound_by": bnd[1], "impl_bound_ms": impl,
                                "f32_x_ms": f32_ms}
        NB = len(ix)
        fn = lambda x: flat(BM.data_vg_blocked(act, x, ix, ws, bs, targets1))  # noqa: E731
        plain = lambda x, dt: flat(BM.data_vg_blocked_ref(  # noqa: E731
            act, x, ix, cast(ws, dt), cast(bs, dt), targets1.to(dt)))
        err, ms, plain_ms, f32_ms = check("data_vg_blocked_xbf16", f"K8b {label} NB={NB}", fn,
                                          plain, xb, runs=3)
        xbytes = 2 * len(set(ix.tolist())) * xb.shape[1] * n  # each branch read once
        bnd, impl = xb_bound(NB * n, 2 * fm0, fall[True] - 2 * fm0,
                       xbytes + nbytes(targets1, *ws, *bs) + 4 * NB * (n + 1) + nbytes(*ws, *bs))
        res["data_vg_blocked_xbf16"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                        "bound_ms": bnd[0], "bound_by": bnd[1], "impl_bound_ms": impl,
                                        "nb": NB, "f32_x_ms": f32_ms}
        xk = xb[block_ix].contiguous()
        Bk, C = len(block_ix), chains_ws[0].shape[1]
        fn = lambda x: flat(BM.data_vg_chains(act, x, chains_ws, chains_bs, targets))  # noqa: E731
        plain = lambda x, dt: flat(BM.data_vg_chains_ref(  # noqa: E731
            act, x, cast(chains_ws, dt), cast(chains_bs, dt), targets.to(dt)))
        err, ms, plain_ms, f32_ms = check("data_vg_chains_xbf16", f"K7 value and gradient {label}",
                                          fn, plain, xk, runs=3)
        params = nbytes(*chains_ws, *chains_bs)
        per = Bk * C * n
        bnd, impl = xb_bound(per, 2 * fm0, fall[True] - 2 * fm0,
                       nbytes(xk, targets) + 2 * params + 4 * (per + Bk * C))
        grad = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "impl_bound_ms": impl, "f32_x_ms": f32_ms}
        fn = lambda x: (BM.forward_chains(act, x, chains_ws, chains_bs),)  # noqa: E731
        plain = lambda x, dt: (BM.forward_chains_ref(  # noqa: E731
            act, x, cast(chains_ws, dt), cast(chains_bs, dt)),)
        err, ms, plain_ms, f32_ms = check("data_vg_chains_xbf16", f"K7 forward only {label}", fn,
                                          plain, xk, runs=3)
        bnd, impl = xb_bound(per, fm0, fall[False] - fm0, nbytes(xk) + params + 4 * per)
        res["data_vg_chains_xbf16"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                       "bound_ms": bnd[0], "bound_by": bnd[1], "impl_bound_ms": impl,
                                       "grad": grad, "f32_x_ms": f32_ms}
        eps_w, eps_b = H.step_sizes(None, model_type, MCMCCfg(hmc_integration_length=L,
                                                               hmc_step_size_factor=0.1),
                                    chains_ws, chains_bs, wps, bps, None)
        tgen = torch.Generator(dev).manual_seed(181)
        p_w = tuple(torch.randn(w.shape, device=dev, generator=tgen) * mk
                    for w, mk in zip(chains_ws, masks[0]))
        p_b = tuple(torch.randn(b.shape, device=dev, generator=tgen) * mk
                    for b, mk in zip(chains_bs, masks[1]))
        err6 = torch.full((Bk, C), 1.0 / targets.var().item(), device=dev)
        lam_w = tuple(lam.expand_as(w) for lam, w in zip(wps, chains_ws))
        lam_b = tuple(torch.zeros_like(b) for b in chains_bs)
        k6 = {}
        for steps, tol in ((1, REL_TOL), (L, REL_TOL_TRAJ)):
            rest = (targets, err6, chains_ws, chains_bs, p_w, p_b, eps_w, eps_b, lam_w, lam_b)

            def fn(x, rest=rest, steps=steps):
                return tuple(t for o in LF.integrate_chains(act, x, *rest, steps) for t in o)

            def plain(x, dt, rest=rest, steps=steps):
                r = tuple(cast(a, dt) if isinstance(a, tuple) else a.to(dt) for a in rest)
                return tuple(t for o in LF.integrate_chains_ref(act, x, *r, steps) for t in o)

            k6[steps] = check("traj_dense_xbf16", f"K6 {label}, L={steps}", fn, plain, xk, tol,
                              runs=3)
        err = max(v[0] for v in k6.values())
        bnd, impl = xb_bound(per * (L + 1), 2 * fm0, fall[True] - 2 * fm0,
                       nbytes(xk, targets, err6) + 8 * params)
        res["traj_dense_xbf16"] = {"max_abs_err": err, "ms": k6[L][1], "plain_ms": k6[L][2],
                                   "bound_ms": bnd[0], "bound_by": bnd[1], "impl_bound_ms": impl,
                                   "steps": L,
                                   "l1_ms": k6[1][1], "f32_x_ms": k6[L][3],
                                   "l1_f32_x_ms": k6[1][3]}
        for k, v in res.items():
            print(f"  {names[k]} {label}: bound {v['bound_ms']:.4f} ms ({v['bound_by']}; X in "
                  f"bf16, layer 0 in three bf16 products per f32 one, the rest in 3xTF32), as "
                  f"implemented {v['impl_bound_ms']:.4f} ms (layer 0 in two tf32 products)")

    # ---- phase 18 (flagship): dense_vg_mma.cuh on bf16 X
    fdir, farch = flag["dir"], flag["arch"]
    t0 = time.perf_counter()
    fx = CompressedGenotypes(flag["bed"], flag["groups"]).to_feature_major(farch, dev, dtype=XB).X
    f32_bytes = fx.xT.numel() * 4
    print(f"phase 18: K8a, K8b, K7 and K6 on feature-major X stored in bf16: the dense flagship's "
          f"shape (csrc/dense_vg_mma.cuh), xT {tuple(fx.xT.shape)} bf16, {nbytes(fx.xT)} bytes "
          f"on the card (f32: {f32_bytes}; {time.perf_counter() - t0:.1f} s)")
    state = init_net(farch, "ridge_base", InitCfg(seed=0), device=dev)[0]
    pgen = torch.Generator(dev).manual_seed(18)

    def perturbed(ts, lead):  # [G, ...] -> [*lead(ix), ...], each instance perturbed
        return tuple((t[lead] * (1 + 0.1 * torch.randn(t[lead].shape, device=dev,
                                                         generator=pgen))).contiguous() for t in ts)

    fy = torch.as_tensor(flag["y_train"], dtype=torch.float32, device=dev)
    blocks = torch.as_tensor(np.concatenate([np.random.default_rng(18 + c).permutation(FG)[:8]
                                             for c in range(FCHAINS)]), device=dev)
    ix = blocks.to(torch.int32)
    ws, bs = perturbed(state.params.weights, blocks), perturbed(state.params.biases, blocks)
    t1 = fy + 0.1 * torch.randn((len(ix), FN_TRAIN), device=dev, generator=pgen)
    allg = torch.arange(FG, device=dev)[:, None].expand(FG, FCHAINS)
    cws, cbs = perturbed(state.params.weights, allg), perturbed(state.params.biases, allg)
    ctargets = fy + 0.1 * torch.randn((FG, FCHAINS, FN_TRAIN), device=dev, generator=pgen)
    wps = tuple(t[allg].contiguous() for t in state.precisions.weights)
    bps = tuple(t[allg].contiguous() for t in state.precisions.biases)
    masks = (tuple(m[allg] for m in P.weight_masks(farch, dev)),
             tuple(m[allg] for m in P.bias_masks(farch, dev)))
    kernels_on(fx.xT, "flagship", ws, bs, ix, torch.arange(FG, device=dev), t1, ctargets, cws,
               cbs, wps, bps, masks, 1, (FM, FH, FH), "tanh", "ridge_base", out["flagship"])
    out["flagship"]["x_bytes"] = nbytes(fx.xT)
    out["flagship"]["x_f32_bytes"] = f32_bytes
    del fx, ws, bs, cws, cbs, ctargets, t1

    # ---- phase 18 (deep): dense_deep.cuh on the genome-scale X in bf16
    rule = ("fraction_of_input", 0.5), ("fraction_of_hidden", 1.0)
    arch = NetArch.from_width_rules([M] * G, 2, *rule, activation="tanh")
    t0 = time.perf_counter()
    X = CompressedGenotypes(train_bed, groups).to_feature_major(arch, dev, dtype=XB).X
    print(f"phase 18: the same at {MAIN_DEEP} on the genome-scale X in bf16 "
          f"(csrc/dense_deep.cuh): xT {tuple(X.xT.shape)}, {nbytes(X.xT)} bytes on the card "
          f"({time.perf_counter() - t0:.1f} s)")
    state = init_net(arch, "ridge_ard", InitCfg(seed=0), device=dev)[0]
    ixs = torch.arange(BLOCK, device=dev) * (G // BLOCK)
    ix40 = ixs.repeat(CHAINS)
    y_dev = torch.as_tensor(y_train, dtype=torch.float32, device=dev)
    ws, bs = perturbed(state.params.weights, ix40), perturbed(state.params.biases, ix40)
    t1 = y_dev + 0.1 * torch.randn((len(ix40), N_TRAIN), device=dev, generator=pgen)
    blk = ixs[:, None].expand(BLOCK, CHAINS)
    cws, cbs = perturbed(state.params.weights, blk), perturbed(state.params.biases, blk)
    ctargets = y_dev + 0.1 * torch.randn((BLOCK, CHAINS, N_TRAIN), device=dev, generator=pgen)
    wps = tuple(t[blk].contiguous() for t in state.precisions.weights)
    bps = tuple(t[blk].contiguous() for t in state.precisions.biases)
    masks = (tuple(m[blk] for m in P.weight_masks(arch, dev)),
             tuple(m[blk] for m in P.bias_masks(arch, dev)))
    kernels_on(X.xT, MAIN_DEEP, ws, bs, ix40.to(torch.int32), ixs, t1, ctargets, cws, cbs, wps,
               bps, masks, 2, (arch.m[0], arch.h[0], arch.s[0]), "tanh", "ridge_ard", out["deep"])
    out["deep"]["x_bytes"] = nbytes(X.xT)
    del X, ws, bs, cws, cbs, ctargets, t1

    # ---- phase 18b: the flagship through the CLI on bf16 X, every schedule
    counted = {"integrate_chains": LF.integrate_chains, "data_vg_chains": BM.data_vg_chains,
               "data_vg": BM.data_vg, "data_vg_blocked": BM.data_vg_blocked,
               "forward_blocked": BM.forward_blocked}
    kernels = dict(counted, **{f"{k}_xbf16": Xbf16(w) for k, w in counted.items()},
                   data_vg_packed=BM.data_vg_packed,
                   integrate_chains_packed=LF.integrate_chains_packed)
    none = {k: 0 for k in kernels}

    def both(**kw):  # each count for the wrapper and for its bf16-X launches
        return dict(none, **kw, **{f"{k}_xbf16": v for k, v in kw.items()})

    runs = os.path.join(work, "runs_bf16")
    fargs = ["train-new", os.path.join(fdir, "train"), os.path.join(fdir, "train.phen"),
             os.path.join(fdir, "train.groups"), "ridge_base", "tanh", "1", CHAIN, FL,
             "--fixed-hidden-layer-width", FH, "--fixed-summary-layer-width", FH, "--feat-major",
             "--x-bf16", "--burn-in", "1", "--bfile-test", os.path.join(fdir, "test"),
             "--p-test", os.path.join(fdir, "test.phen"), "-o", runs]
    ftest = CompressedGenotypes(BedVM.from_file(os.path.join(fdir, "test")), flag["groups"])
    print(f"phase 18b: phase 9's train-new with --x-bf16 (--update-mode parallel --num-chains "
          f"{FCHAINS}) -> predict")
    with x_seen() as seen:
        _, recs, out["18b"] = cli_phase(
            cli, fdir, fargs + ["--update-mode", "parallel", "--num-chains", FCHAINS], kernels,
            log_records, ftest, flag["y_test"], both(integrate_chains=1, data_vg_chains=3),
            packed=False, widths=(FH, FH))
    out["18b"]["x"] = seen
    out["18b_runs"] = [r["launches"] for r in recs]
    print(f"  xT on the card: {seen} (f32: {f32_bytes} bytes); {out['18b']['sweep_ms']:.1f} ms "
          f"per sweep on bf16 X, {flag['sweep_ms']:.1f} on f32 X (phase 9)")
    if seen != [("torch.bfloat16", f32_bytes // 2)]:
        raise AssertionError(f"phase 18b trained on {seen}")
    one = list(fargs)
    one[7], one[one.index("--burn-in") + 1] = 1, "0"
    fblock = FG // 8  # the hybrid's default block size at G = 64
    print("phase 18b: one sweep each with --x-bf16, unfolded (--update-mode hybrid "
          f"--per-chain-block-perm --num-chains {FCHAINS}) and sequential (one chain)")
    _, recs, out["18b_unfolded"] = cli_phase(
        cli, fdir, one + ["--update-mode", "hybrid", "--per-chain-block-perm", "--num-chains",
                          FCHAINS], kernels, log_records, ftest, flag["y_test"],
        both(data_vg_blocked=(FG // fblock) * (FL + 2), forward_blocked=FG // fblock),
        packed=False, sweeps=1, widths=(FH, FH))
    out["18b_unfolded_runs"] = [r["launches"] for r in recs]
    _, recs, out["18b_sequential"] = cli_phase(
        cli, fdir, one, kernels, log_records, ftest, flag["y_test"], both(data_vg=FG * (FL + 1)),
        packed=False, sweeps=1, widths=(FH, FH))
    out["18b_sequential_runs"] = [r["launches"] for r in recs]

    # --bf16 on the bf16 FeatX: the sweep's snapshot in predict's plain
    # products (folded on the block, unfolded on a copy of each instance's
    # branch), the kernels as without it
    print(f"phase 18b: phase 9's train-new with --x-bf16 --bf16 (--update-mode parallel "
          f"--num-chains {FCHAINS}), then one sweep unfolded")
    _, recs, out["18b_bf16"] = cli_phase(
        cli, fdir, fargs + ["--bf16", "--update-mode", "parallel", "--num-chains", FCHAINS],
        kernels, log_records, ftest, flag["y_test"], both(integrate_chains=1, data_vg_chains=2),
        packed=False, widths=(FH, FH))
    out["18b_bf16_runs"] = [r["launches"] for r in recs]
    carry = recs[-1]["carry"]
    _, recs, out["18b_bf16_unfolded"] = cli_phase(
        cli, fdir, one + ["--bf16", "--update-mode", "hybrid", "--per-chain-block-perm",
                          "--num-chains", FCHAINS], kernels, log_records, ftest, flag["y_test"],
        both(data_vg_blocked=(FG // fblock) * (FL + 2)), packed=False, sweeps=1, widths=(FH, FH))
    out["18b_bf16_unfolded_runs"] = [r["launches"] for r in recs]
    # those snapshots of the folded run's last weights, on the card against
    # --cpu's: folded on all branches, unfolded on each chain's own block
    ws_, bs_ = carry.state.params.weights, carry.state.params.biases
    ix = torch.as_tensor(np.concatenate([np.random.default_rng(182 + c).permutation(FG)[:fblock]
                                         for c in range(FCHAINS)]), dtype=torch.int32)
    own = (torch.arange(FCHAINS)[:, None], ix.long().reshape(FCHAINS, fblock))
    xg = {where: CompressedGenotypes(flag["bed"], flag["groups"]).to_feature_major(
        farch, where, dtype=XB).X for where in ("cpu", "cuda")}
    prev = D.compute_dtype()
    D.set_compute_dtype("bfloat16")
    snaps = {}
    try:
        for where in ("cpu", "cuda"):
            w, b = tuple(t.to(where) for t in ws_), tuple(t.to(where) for t in bs_)
            with plain_calls() as calls:
                snaps[where] = (
                    D.snapshot_chains("tanh", w, b, xg[where]),
                    D.snapshot_chains("tanh", tuple(t[own] for t in w), tuple(t[own] for t in b),
                                      xg[where], ix=ix.to(where)))
                torch.cuda.synchronize()
    finally:
        D.set_compute_dtype(prev)
    # --bf16 rounds each hidden activation to bf16 before the next product:
    # where its f32 value (sums in another order on the card) lies across a
    # rounding boundary from the CPU's, the two differ by one bf16 step of
    # it. So, as tests/test_torch_x_bf16.py holds the port to the JAX
    # package: at most 1% of the entries past REL_TOL, none past one bf16
    # step (2^-8) of max(1, the largest)
    for label, card, cpu in zip(("folded", "unfolded"), snaps["cuda"], snaps["cpu"]):
        diff = (card.cpu() - cpu).abs()
        err, scale = diff.max().item(), max(1.0, cpu.abs().max().item())
        off = (diff > REL_TOL * scale).double().mean().item()
        print(f"  --bf16 snapshot {label} {tuple(cpu.shape)}: card vs --cpu {err:.3e} (max(1, "
              f"largest) {scale:.3e}), {off:.2e} of the entries past REL_TOL; plain-version "
              f"calls on the card {calls}")
        if (card.shape != cpu.shape or not err <= 2.0 ** -8 * scale or not off <= 0.01
                or any(calls.values()) or not torch.isfinite(card).all()):
            raise AssertionError(f"--bf16 snapshot {label}: the card's fails its checks")
        out["18b_bf16"][f"snapshot_{label}_err"] = err
        out["18b_bf16"][f"snapshot_{label}_past_rel_tol"] = off
    del recs, carry, xg, snaps

    # ---- phase 18c: 17c's recipe on bf16 X, then phase 6's packed hybrid with --bf16
    print(f"phase 18c: phase 17c's train-new with --x-bf16 ({' '.join(ADAPT_ARGS + SSM_ARGS)}) "
          f"-> predict")
    argv = ["train-new", os.path.join(work, "train"), os.path.join(work, "train.phen"),
            os.path.join(work, "train.groups"), "ridge_ard", "identity", "0", CHAIN, L,
            "--feat-major", "--x-bf16", "--burn-in", "1", "--bfile-test",
            os.path.join(work, "test"), "--p-test", os.path.join(work, "test.phen"), "-o", runs,
            "--update-mode", "hybrid", "--num-chains", CHAINS] + ADAPT_ARGS + SSM_ARGS
    kernels_c = dict(kernels, marker_scan=MS.marker_scan, packed_matmul_vjp=PM.packed_matmul_vjp)
    nb = G // BLOCK
    test_gen = CompressedGenotypes(BedVM.from_file(os.path.join(work, "test")), groups)
    with x_seen() as seen:
        _, recs, out["18c"] = cli_phase(
            cli, work, argv, kernels_c, log_records, test_gen, y_test,
            dict(both(integrate_chains=nb, data_vg_chains=3 * nb), marker_scan=nb,
                 packed_matmul_vjp=0), packed=False)
    out["18c"]["x"] = seen
    print(f"  xT on the card: {seen}")
    if len(seen) != 1 or seen[0][0] != "torch.bfloat16" or seen[0][1] != 2 * G * 104 * N_TRAIN:
        raise AssertionError(f"phase 18c trained on {seen}")
    out["18c_runs"] = [r["launches"] for r in recs]
    print(f"phase 18c: phase 6's train-new --update-mode hybrid --num-chains {CHAINS} with --bf16 "
          f"-> predict")
    packed = {"integrate_chains_packed": LF.integrate_chains_packed,
              "packed_linear": PM.packed_linear, "data_vg_packed": BM.data_vg_packed,
              "integrate_chains": LF.integrate_chains, "data_vg_chains": BM.data_vg_chains}
    _, recs, out["18c_packed"] = cli_phase(
        cli, work, train_args + ["--update-mode", "hybrid", "--num-chains", CHAINS, "--bf16"],
        packed, log_records, test_gen, y_test,
        {"integrate_chains_packed": nb, "packed_linear": 2 * nb, "data_vg_packed": 0,
         "integrate_chains": 0, "data_vg_chains": 0}, packed=True, widths=None)
    print(f"  {out['18c_packed']['sweep_ms']:.1f} ms per sweep with --bf16, {hybrid_sweep_ms:.1f} "
          f"without (phase 6)")
    del recs
    return out


# joint HMC (phases 19-19c at the genome-scale packed shape, 19d at the
# flagship's): the step factors of the CLI runs. The trainer starts at
# error precision 2.0, far from its conditional (~n / rss, 1e-3 here), so
# the sequential runs, which move it, take small ones. Joint GD's gradient
# in it is ~-rss / 2 = -5e6 at n = 10,000, so at 1e-8 each step moves it by
# ~-0.05: the first branches' updates take it down to ~0.5 and every later
# branch's L steps take it below 0, so the CLI's joint GD sweep runs the
# reject path (99 of 100 at L = 30); no one factor fixes that, as the
# error precision's curvature there, n / (2 err^2) = 5e9, wants a factor
# below ~4e-10, at which the weights do not move. Phase 19's joint GD
# block, from the error precision's conditional on a standardized residual
# (err ~1, curvature ~n / 2), checks accepted updates: at n = 100,000 a
# factor of 1e-7 keeps every coordinate's step stable over L = 30 steps
# (1e-6 does at n = 10,000, 1e-5 does not).
JOINT_FACTOR, JOINT_SEQ_FACTOR, JOINT_GD_FACTOR, JOINT_GD_BLOCK_FACTOR = 0.003, 1e-4, 1e-8, 1e-7
# the sequential sweeps' integration length (phase 19c): its launches,
# G x (L + 1), and checks do not depend on it, and the host-bound sweep's
# time does, ~7 ms an evaluation
JOINT_SEQ_L = 10


def joint_transition_check(X, state, arch, y_train, act, steps=L, gd_steps=None):
    """Phase 19 for one activation: one joint transition of one hybrid block
    (B = BLOCK branches x C = CHAINS chains, the shared scalars frozen, as
    the hybrid sweep calls it: the residual in, the target from the start's
    prediction) on the card, against the same call on the CPU's plain
    versions on the same inputs and draws (the step-size uniforms, the
    momenta and the accept uniforms, from a seed): the codes equal on all
    but max(1, I // 20) of the I instances (an accept within f32 rounding of
    its uniform), every output within REL_TOL_TRAJ of its largest entry on
    the rest, log a (the accept probability's log, a difference of two log
    densities) within 16 f32 roundings of the largest log density, this
    comparison at ``steps`` leapfrog steps (the CPU's plain versions take
    ~0.7 s an evaluation at this shape); the joint potential's value and
    gradient alone (every precision included) within REL_TOL of the
    largest entry (the error precision's gradient, a difference of two
    terms of ~n / (2 err_prec), of the larger term); identical repeats;
    exactly L + 1 forward and L + 1 backward launches (K2 and K3, K9a and
    K9b under silu) and no K4 or K5. With ``gd_steps``, also one joint GD
    transition of the block (``joint_gd_block``). Returns its numbers."""
    import torch

    from rs_bann_tpu_torch.models import density as D
    from rs_bann_tpu_torch.models import params as P
    from rs_bann_tpu_torch.models.net import _reg_all
    from rs_bann_tpu_torch.ops import branch_mlp as BM
    from rs_bann_tpu_torch.ops import leapfrog as LF
    from rs_bann_tpu_torch.ops import packed_matmul as PM
    from rs_bann_tpu_torch.samplers import MCMCCfg
    from rs_bann_tpu_torch.samplers import hmc as H

    dev = X.bytes.device
    fwd, bwd = ((PM.packed_linear, PM.packed_linear_vjp) if act != "silu"
                else (PM.packed_matmul, PM.packed_matmul_vjp))
    gen = torch.Generator(dev).manual_seed(19)
    ixs = (torch.arange(BLOCK, device=dev) * (G // BLOCK)).expand(CHAINS, BLOCK)
    x_b = X[ixs[0]]

    def block(ts, spread=0.0):  # [G, ...] -> [C, B, ...], chain c scaled by 1 + spread * N(0, 1)
        out = []
        for t in ts:
            t = t[ixs]
            out.append(t * (1.0 + spread * torch.randn(t.shape, device=dev, generator=gen)))
        return tuple(out)

    ws, bs = block(state.params.weights, 0.1), block(state.params.biases, 0.1)
    wps, bps = block(state.precisions.weights), block(state.precisions.biases)
    st = D.branch_statics(arch, dev)
    st_b = type(st)(*(tuple(a[ixs] for a in f) if isinstance(f, tuple) else f[ixs] for f in st))
    mw, mb = tuple(m[ixs] for m in P.weight_masks(arch, dev)), tuple(
        m[ixs] for m in P.bias_masks(arch, dev))
    y = torch.as_tensor(y_train, dtype=torch.float32, device=dev)
    resid = y - y.mean() + 0.1 * torch.randn((CHAINS, 1, N_TRAIN), device=dev, generator=gen) \
        - D.predict_chains(act, ws, bs, x_b).sum(dim=1, keepdim=True)
    err = (N_TRAIN / (resid ** 2).sum(dim=-1)).expand(CHAINS, BLOCK)  # each chain's
    reg = _reg_all("ridge_ard", state.params) - D.summary_stat("ridge_ard", ws[-1])
    n_prec, n_out, hyper = float(1 + 2 * (arch.num_layers - 1) + 1), float(
        arch.total_output_weights), D.Hyperparameters()
    leaves = ws + bs + wps + bps + (err,)
    eps_u = [torch.rand(t.shape, device=dev, generator=gen) for t in leaves]
    mom = [torch.randn(t.shape, device=dev, generator=gen) for t in leaves]
    u = torch.rand((CHAINS, BLOCK), device=dev, generator=gen)
    k_live = arch.s[0]
    cfg = MCMCCfg(hmc_integration_length=L, hmc_step_size_factor=JOINT_FACTOR,
                  hmc_step_size_mode="random", joint_hmc=True)
    step = H.make_hmc_step_joint("ridge_ard", act, cfg, sample_shared=False, k_live=k_live)
    vg = H._joint_vg("ridge_ard", act, k_live)

    def on(d, ts):
        if isinstance(ts, (tuple, list)):
            return type(ts)(on(d, t) for t in ts)
        return ts.to(d) if isinstance(ts, torch.Tensor) else ts

    def args(d):
        x = x_b if d == dev else D.PackedX(*on(d, (x_b.bytes, x_b.w_scale, x_b.shift)), N_TRAIN)
        st_d = type(st_b)(*on(d, tuple(st_b)))
        return ((None,) + on(d, (ws, bs, wps, bps, err)) + (x, on(d, resid), on(d, mw),
                on(d, mb), on(d, st_b.n_params), n_prec, hyper, st_d, on(d, reg), n_out),
                dict(eps_u=on(d, eps_u), momenta=on(d, mom), u=on(d, u), residual=True))

    def flat(o):
        return (o.result.weights + o.result.biases + o.w_prec + o.b_prec
                + (o.err_prec, o.result.y_pred, o.y_pred0, o.result.log_density))

    names = ([f"W{l}" for l in range(len(ws))] + [f"b{l}" for l in range(len(bs))]
             + [f"wprec{l}" for l in range(len(ws))] + [f"bprec{l}" for l in range(len(bs))]
             + ["err_prec", "y_pred", "y_pred0", "log_density"])
    a, kw = args(dev)
    counts = {n: c.launches for n, c in (("fwd", fwd), ("bwd", bwd), ("k4", BM.data_vg_packed),
                                         ("k5", LF.integrate_chains_packed))}
    if act == "identity":  # every launch of the call, by torch.profiler
        card, device_n = device_launches(lambda: step(*a, **kw))
    else:
        card, device_n = step(*a, **kw), None
    used = {n: c.launches - counts[n] for n, c in (("fwd", fwd), ("bwd", bwd),
                                                  ("k4", BM.data_vg_packed),
                                                  ("k5", LF.integrate_chains_packed))}
    print(f"  {act}: launches {used} ({fwd.__name__}, {bwd.__name__})"
          + (f"; all device launches (torch.profiler) {device_n}" if device_n else ""))
    if used != {"fwd": L + 1, "bwd": L + 1, "k4": 0, "k5": 0}:
        raise AssertionError(f"the joint block transition launched {used}, expected {L + 1} "
                             f"forward and {L + 1} backward, no K4 or K5")
    identical(lambda: flat(step(*a, **kw)) + (card.result.accept_prob,),
              flat(card) + (card.result.accept_prob,), f"the joint block transition ({act})")
    ms = cuda_ms(lambda: step(*a, **kw), runs=3)
    if steps != L:  # the comparison's own length, on both sides
        step = H.make_hmc_step_joint("ridge_ard", act, dataclasses.replace(
            cfg, hmc_integration_length=steps), sample_shared=False, k_live=k_live)
        card = step(*a, **kw)
    t0 = time.perf_counter()
    ca, ckw = args("cpu")
    ref = step(*ca, **ckw)
    plain_s = time.perf_counter() - t0
    same = (card.result.code.cpu() == ref.result.code)
    I = CHAINS * BLOCK
    print(f"  codes card {card.result.code.flatten().tolist()}")
    if int(same.sum()) < I - max(1, I // 20):
        raise AssertionError(f"the card's and the CPU's accepts agree on {int(same.sum())} of {I}")
    err_max = 0.0
    for name, got, want in zip(names, flat(card), flat(ref)):
        lead = same.reshape(same.shape + (1,) * (want.dim() - 2))
        got, want = torch.where(lead, got.cpu(), 0.0), torch.where(lead, want, 0.0)
        err_max = max(err_max, check_close(f"joint transition {act}", f"{act} joint transition "
                                           f"{name}", got, want, REL_TOL_TRAJ))
    # log a is a difference of log densities of up to max |ld| each, which
    # f32 resolves to max |ld| * 2^-23: log a held to 16 such roundings (0
    # on both sides where the trajectory died)
    a_card, a_ref = card.result.accept_prob.cpu()[same], ref.result.accept_prob[same]
    live = (a_card > 0) & (a_ref > 0)
    log_a_tol = 16 * 2.0 ** -23 * ref.result.log_density.abs().max().item()
    log_a_err = ((torch.log(a_card[live]) - torch.log(a_ref[live])).abs().max().item()
                 if bool(live.any()) else 0.0)
    print(f"  {act} joint transition accept_prob: max |log a_card - log a_cpu| {log_a_err:.3e} "
          f"(16 f32 roundings of max |log density|: {log_a_tol:.3e}); max |a_card - a_cpu| "
          f"{(a_card - a_ref).abs().max().item():.3e}")
    if not (torch.equal(a_card[~live], a_ref[~live]) and log_a_err <= log_a_tol):
        raise AssertionError(f"{act}: the card's and the CPU's accept probabilities differ")
    acc = card.result.code.eq(H.ACCEPTED).float().mean().item()
    # the joint potential's value and gradient alone, at the start
    def value_and_grad(p):  # (-U, then its gradient in every coordinate) at the start
        ld, _, grads, _ = vg(list(p[1] + p[2] + p[3] + p[4]) + [p[5]], len(ws), len(bs), p[6],
                             p[7], hyper, p[13], p[14], n_out, None)
        return (ld,) + tuple(grads)

    g_card = value_and_grad(a)
    identical(lambda: value_and_grad(a), g_card, f"the joint potential's gradient ({act})")
    g_err = 0.0
    for name, got, want in zip(["-U"] + [f"d(-U)/d{nm}" for nm in names], g_card,
                               value_and_grad(ca)):
        tol = REL_TOL
        if name == "d(-U)/derr_prec":  # (n - 2) / (2 err) - rss / 2 + the prior's terms
            terms = (N_TRAIN / 2.0 / ca[5]).abs().max().item()
            tol = REL_TOL * max(1.0, terms) / max(1.0, want.abs().max().item())
        g_err = max(g_err, check_close(f"joint gradient {act}", f"{act} {name}", got.cpu(),
                                       want, tol))
    print(f"  {act}: the card's transition {ms:.2f} ms (L = {L}, {I} instances), the CPU's "
          f"plain versions {1e3 * plain_s:.1f} ms (L = {steps}); accepted {acc:.3f}; codes "
          f"agree on {int(same.sum())} of {I}; identical repeats")
    out = {"launches": used, "device_launches": device_n, "ms": ms, "plain_steps": steps,
           "plain_ms": 1e3 * plain_s, "max_abs_err": err_max, "grad_max_abs_err": g_err,
           "log_accept_err": log_a_err,
           "codes_agree": int(same.sum()), "instances": I, "accepted": acc}
    if gd_steps:
        # the residual standardized per chain, the error precision at its
        # conditional n / rss (~1)
        r_gd = resid / resid.std(dim=-1, keepdim=True)
        a, ca = list(a), list(ca)
        a[5], a[7] = (N_TRAIN / (r_gd ** 2).sum(dim=-1)).expand(CHAINS, BLOCK), r_gd
        ca[5], ca[7] = a[5].cpu(), r_gd.cpu()
        out["gd"] = joint_gd_block(act, cfg, a, ca, fwd, bwd, names, flat, gd_steps)
    return out


def joint_gd_block(act, cfg, a, ca, fwd, bwd, names, flat, steps):
    """One joint GD transition of phase 19's block (every instance from the
    error precision's conditional on a standardized residual, factor
    JOINT_GD_BLOCK_FACTOR) on the card, against the same call on the CPU's
    plain versions: every instance accepted on both sides, exactly L + 1
    forward and L backward launches, identical repeats, and, at ``steps``
    steps on both sides, each coordinate's move (end - start) within
    REL_TOL_TRAJ of a scale plus one f32 rounding of its largest start
    entry per step: the weights' and biases' scale the largest move among
    them all (GD's step is the factor times the gradient in all of them; a
    bias's gradient is a sum over n of terms that cancel, so f32 resolves
    it to a part of the largest gradient, not of its own), each
    precision's its own largest move; y_pred and the log density within
    REL_TOL_TRAJ of their largest entry. Returns its numbers."""
    import torch

    from rs_bann_tpu_torch.samplers import hmc as H

    gcfg = dataclasses.replace(cfg, hmc_step_size_factor=JOINT_GD_BLOCK_FACTOR, joint_hmc=False,
                               gradient_descent_joint=True)
    gd = H.make_gradient_descent_joint("ridge_ard", act, gcfg)
    before = (fwd.launches, bwd.launches)
    card = gd(*a, residual=True)
    used = (fwd.launches - before[0], bwd.launches - before[1])
    accepted = int(card.result.code.eq(H.ACCEPTED).sum())
    I = card.result.code.numel()
    print(f"  {act} joint GD block (factor {JOINT_GD_BLOCK_FACTOR}, L = {L}): launches {used}; "
          f"accepted {accepted}, rejected {I - accepted} of {I}")
    if used != (L + 1, L):
        raise AssertionError(f"the joint GD block launched {used}, expected ({L + 1}, {L})")
    if accepted != I:
        raise AssertionError(f"the joint GD block accepted {accepted} of {I}")
    identical(lambda: flat(gd(*a, residual=True)), flat(card), f"the joint GD block ({act})")
    ms = cuda_ms(lambda: gd(*a, residual=True), runs=3)
    gd = H.make_gradient_descent_joint("ridge_ard", act, dataclasses.replace(
        gcfg, hmc_integration_length=steps))
    card = gd(*a, residual=True)
    t0 = time.perf_counter()
    ref = gd(*ca, residual=True)
    plain_s = time.perf_counter() - t0
    if not (bool(card.result.code.eq(H.ACCEPTED).all())
            and bool(ref.result.code.eq(H.ACCEPTED).all())):
        raise AssertionError(f"the joint GD block at {steps} steps rejected on the card or the CPU")
    start = ca[1] + ca[2] + ca[3] + ca[4] + (ca[5],)
    n_par = len(ca[1]) + len(ca[2])
    par_move = max((w - q0).abs().max().item() for w, q0 in zip(flat(ref)[:n_par], start))
    err_max = 0.0
    for i, (name, got, want, q0) in enumerate(zip(names, flat(card), flat(ref), start)):
        move, want_move = got.cpu() - q0, want - q0
        err = (move - want_move).abs().max().item()
        scale = par_move if i < n_par else want_move.abs().max().item()
        tol = REL_TOL_TRAJ * scale + steps * 2.0 ** -23 * q0.abs().max().item()
        print(f"  {act} joint GD {name}: move {want_move.abs().max().item():.3e}, card vs CPU "
              f"{err:.3e} (tolerance {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"joint GD {name}: the card's and the CPU's moves differ by "
                                 f"{err} > {tol}")
        err_max = max(err_max, err)
    for name, got, want in list(zip(names, flat(card), flat(ref)))[len(start):]:
        err_max = max(err_max, check_close(f"joint GD {act}", f"{act} joint GD {name}",
                                           got.cpu(), want, REL_TOL_TRAJ))
    print(f"  {act} joint GD block: the card's {ms:.2f} ms (L = {L}), the CPU's plain versions "
          f"{1e3 * plain_s:.1f} ms ({steps} steps); every instance accepted; identical repeats")
    return {"launches": used, "ms": ms, "plain_steps": steps, "plain_ms": 1e3 * plain_s,
            "max_abs_err": err_max, "accepted": accepted, "rejected": I - accepted}


def loaded_sweeps(label, argv, model_type, arch, state, X, y, chains, kernels, per_sweep,
                  sweeps=1, names=None):
    """``sweeps`` sweeps of train-new's configuration ``argv`` (``label``) on a fresh
    carry from ``state``, on the data already on the card (no command's
    data load): each with exactly ``per_sweep`` launches of the counted
    wrappers ``kernels``, finite statistics and accepted updates. With
    ``names`` the last sweep runs under torch.profiler (the device's
    activity only: the host's op events of ~70,000 launches take a minute
    to sort), which gives the busy share and the device ms of the kernels
    whose names hold each of ``names``. Returns the wall ms of each sweep
    (host clock around it; ``sweep_ms`` the last's) and those numbers."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rs_bann_tpu_torch.cli.args import mcmc_cfg_from_args
    from rs_bann_tpu_torch.cli.main import build_parser
    from rs_bann_tpu_torch.models import density as D
    from rs_bann_tpu_torch.models.net import Net
    from rs_bann_tpu_torch.train import prepare_state_for_training

    cfg = mcmc_cfg_from_args(build_parser().parse_args([str(a) for a in argv]), os.devnull)
    net = prepare_state_for_training(Net(model_type, arch, D.Hyperparameters(), state), None)
    sweep = net.make_chain_sweep(cfg)
    gen = torch.Generator(X.bytes.device if isinstance(X, D.PackedX) else X.xT.device)
    gen.manual_seed(3)
    carry = net.init_carry(X, y, chains=chains)
    walls, launches = [], []
    for i in range(sweeps):
        before = {k: w.launches for k, w in kernels.items()}
        torch.cuda.synchronize()
        profiled = bool(names) and i == sweeps - 1
        with (profile(activities=[ProfilerActivity.CUDA]) if profiled
              else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            carry, stats = sweep(carry, X, y, gen)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        launches.append({k: w.launches - before[k] for k, w in kernels.items()})
    counts = stats.counts.sum(dim=0)
    acceptance = float(counts[0]) / float(counts.sum())
    out = {"sweep_ms": walls[-1], "sweeps_ms": walls, "launches_per_sweep": launches[0],
           "acceptance": acceptance}
    print(f"  {label} on the loaded data: {sweeps} sweep(s) of "
          f"{', '.join(f'{w:.1f}' for w in walls)} ms; launches {launches}; acceptance "
          f"{acceptance:.3f}")
    if any(n != per_sweep for n in launches):
        raise AssertionError(f"launches per sweep {launches}, expected {per_sweep}")
    finite = all(bool(torch.isfinite(t).all()) for t in (stats.mse_train, stats.lpd))
    if not (finite and acceptance > 0.0):
        raise AssertionError(f"non-finite statistics or nothing accepted: {stats}")
    if names:
        rows = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA]

        def ms(a):
            v = getattr(a, "self_device_time_total", None)
            return (getattr(a, "self_cuda_time_total", 0.0) if v is None else v) / 1e3

        device = sum(ms(a) for a in rows)
        prof_out = {"wall_ms": walls[-1], "device_ms": device, "busy": device / walls[-1],
                    "launches": sum(a.count for a in rows)}
        for name in names:
            prof_out[f"{name}_ms"] = sum(ms(a) for a in rows if name in a.key)
        print(f"  profiled sweep: {walls[-1]:.1f} ms on the host clock, {device:.1f} ms of device "
              f"time (busy {100 * prof_out['busy']:.1f}%), " + ", ".join(
                  f"{n} {prof_out[f'{n}_ms']:.1f} ms ({100 * prof_out[f'{n}_ms'] / walls[-1]:.1f}%)"
                  for n in names) + f"; {prof_out['launches']} device kernels")
        out["profile"] = prof_out
    return out


def joint_phases(cli, work, X, arch, y_train, y_test, train_args, log_records, flag):
    """Phases 19-19d: joint HMC and joint gradient descent (``--joint-hmc``,
    ``--gradient-descent-joint``). 19: one joint block transition, card
    against the CPU's plain versions, identity (K2 + K3) and silu (K9a +
    K9b), and one joint GD block transition (identity) whose updates are
    all accepted. 19b: train-new --joint-hmc hybrid (C = CHAINS) at the
    genome-scale shape, 2 sweeps: exactly blocks x (L + 1) K2 and K3
    launches per sweep (all chains of a block in one launch per
    evaluation), no K4, K5 or marker-scan launch, the trainer's own K2
    launches (the start's residual, each record's test mse per chain)
    exactly, acceptance above 0, predict on chain 0 card vs the CPU; then
    on the data it loaded, the parallel sweep (L + 1 of each, twice, the
    second profiled: K2's and K3's share and the busy share) and the hybrid
    sweep with --per-chain-block-perm (blocks x (L + 1) of each: the chains'
    own blocks gathered into one launch). 19c: one sequential sweep each
    of --joint-hmc (G x (L + 1) K2 and K3) and --gradient-descent-joint
    (G x (L + 1) K2, G x L K3) at n = N_17D and L = JOINT_SEQ_L, one
    output precision for every branch after it, and a profiled sequential
    sweep's busy share (4 branches of it). 19d: the flagship's
    --feat-major --joint-hmc parallel sweep (C = FCHAINS): no K6, K7 or K8
    launch (plain products), predict card vs the CPU. Returns their
    numbers."""
    import torch

    from rs_bann_tpu_torch.io import BedVM, ExternalGrouping
    from rs_bann_tpu_torch.io.genotypes import CompressedGenotypes
    from rs_bann_tpu_torch.io.phen import Phenotypes
    from rs_bann_tpu_torch.models import NetArch
    from rs_bann_tpu_torch.models.init import InitCfg, init_net
    from rs_bann_tpu_torch.models.net import default_block_size
    from rs_bann_tpu_torch.ops import branch_mlp as BM
    from rs_bann_tpu_torch.ops import leapfrog as LF
    from rs_bann_tpu_torch.ops import marker_scan as MS
    from rs_bann_tpu_torch.ops import packed_matmul as PM

    out = {}
    t_phase = time.perf_counter()
    state, _ = init_net(arch, "ridge_ard", InitCfg(seed=0), device=X.bytes.device)
    print(f"phase 19: one joint transition of one hybrid block (B {BLOCK}, C {CHAINS}, n "
          f"{N_TRAIN}, L {L}, step factor {JOINT_FACTOR}), card vs the CPU's plain versions")
    # silu's comparison with the CPU at 5 steps keeps the phases' time (its
    # launches, repeat and time at L as identity's)
    out["19"] = {act: joint_transition_check(X, state, arch, y_train, act, steps, gd_steps)
                 for act, steps, gd_steps in (("identity", L, 3), ("silu", 5, None))}
    out["19"]["s"] = time.perf_counter() - t_phase

    packed = {"packed_linear": PM.packed_linear, "packed_linear_vjp": PM.packed_linear_vjp,
              "packed_matmul": PM.packed_matmul, "packed_matmul_vjp": PM.packed_matmul_vjp,
              "data_vg_packed": BM.data_vg_packed, "traj_packed": LF.integrate_chains_packed,
              "marker_scan": MS.marker_scan}
    none = {k: 0 for k in packed}
    blocks = G // default_block_size(G)  # the CLI's hybrid blocks: BLOCK branches each
    test_gen = CompressedGenotypes(BedVM.from_file(os.path.join(work, "test")),
                                   ExternalGrouping.from_file(os.path.join(work, "train.groups")))
    joint = list(train_args) + ["--joint-hmc", "--step-size", JOINT_FACTOR]
    evals = blocks * (L + 1)
    t0 = time.perf_counter()
    print(f"phase 19b: train-new --packed-genotypes --joint-hmc --update-mode hybrid "
          f"--num-chains {CHAINS} ({CHAIN} sweeps of L {L}, step factor {JOINT_FACTOR}) "
          f"-> predict on chain 0")
    _, recs, res = cli_phase(
        cli, work, joint + ["--update-mode", "hybrid", "--num-chains", CHAINS], packed,
        log_records, test_gen, y_test,
        dict(none, packed_linear=evals, packed_linear_vjp=evals), widths=(16, 16))
    trainer = res["train_launches"]
    # the start's residual, then each record's test mse, one per chain
    own = 1 + (CHAIN + 1) * CHAINS
    print(f"  train-new launched {trainer}: {CHAIN} x {evals} in the sweeps, {own} of the "
          f"trainer's own (1 for the start's residual, {CHAIN + 1} records x {CHAINS} "
          f"chains' test mse)")
    if trainer != dict(none, packed_linear=CHAIN * evals + own, packed_linear_vjp=CHAIN * evals):
        raise AssertionError(f"train-new launched {trainer}")
    if not res["acceptance"] > 0.0:
        raise AssertionError("the joint hybrid run accepted nothing")
    res["s"] = time.perf_counter() - t0
    out["19b_hybrid"] = res
    y = torch.as_tensor(y_train, dtype=torch.float32, device=X.bytes.device)
    for name, flags, per_sweep, sweeps, names in (
            ("parallel", ["--update-mode", "parallel"], L + 1, 2,
             ("packed_linear_tc", "packed_bwd")),
            ("own_blocks", ["--update-mode", "hybrid", "--per-chain-block-perm"], evals, 1,
             None)):
        t0 = time.perf_counter()
        label = f"--joint-hmc {' '.join(flags)} --num-chains {CHAINS}"
        print(f"phase 19b: {label}, {sweeps} sweep(s) of L {L} on the data train-new loaded")
        res = loaded_sweeps(
            label, joint + flags + ["--num-chains", CHAINS], "ridge_ard", arch, state, X, y,
            CHAINS, packed, dict(none, packed_linear=per_sweep, packed_linear_vjp=per_sweep),
            sweeps, names)
        res["s"] = time.perf_counter() - t0
        out[f"19b_{name}"] = res

    # 19c: sequential, one sweep each, on the training set cut to n = N_17D
    small, y_small_test = small_data(work)
    one = list(train_args)
    one[1:4] = [os.path.join(small, f) for f in ("train", "train.phen", "train.groups")]
    one[7], one[8], one[one.index("--burn-in") + 1] = 1, JOINT_SEQ_L, "0"
    one[one.index("--bfile-test") + 1] = os.path.join(small, "test")
    one[one.index("--p-test") + 1] = os.path.join(small, "test.phen")
    small_test = CompressedGenotypes(BedVM.from_file(os.path.join(small, "test")),
                                     ExternalGrouping.from_file(os.path.join(small,
                                                                             "train.groups")))
    seq_evals = JOINT_SEQ_L + 1
    for name, flags, per_sweep in (
            ("hmc", ["--joint-hmc", "--step-size", JOINT_SEQ_FACTOR],
             dict(none, packed_linear=G * seq_evals, packed_linear_vjp=G * seq_evals)),
            ("gd", ["--gradient-descent-joint", "--step-size", JOINT_GD_FACTOR],
             dict(none, packed_linear=G * seq_evals, packed_linear_vjp=G * JOINT_SEQ_L))):
        t0 = time.perf_counter()
        print(f"phase 19c: train-new --packed-genotypes {' '.join(map(str, flags))}, sequential, "
              f"one sweep of L {JOINT_SEQ_L} at n {N_17D}")
        run, recs, res = cli_phase(cli, small, one + flags, packed, log_records, small_test,
                                   y_small_test, per_sweep, sweeps=1, widths=(16, 16))
        lam_out = recs[-1]["carry"].state.precisions.weights[-1]
        if not bool(torch.all(lam_out == lam_out.reshape(-1)[0])):
            raise AssertionError("the branches hold different output precisions")
        stats = json.load(open(os.path.join(run, "training_stats")))
        res["rejected"] = stats["num_samples"] - stats["num_accepted"]
        res["lam_out"] = float(lam_out.reshape(-1)[0])
        print(f"  one output precision for all {G} branches: {res['lam_out']:.6g}; "
              f"{res['rejected']} of {stats['num_samples']} updates rejected")
        res["s"] = time.perf_counter() - t0
        out[f"19c_{name}"] = res
    arch_p = NetArch.from_width_rules([M] * 4, 0, ("fixed", 10), ("fraction_of_hidden", 1.0),
                                      activation="identity")
    state_p, _ = init_net(arch_p, "ridge_ard", InitCfg(seed=0), device=X.bytes.device)
    x_small = CompressedGenotypes(BedVM.from_file(os.path.join(small, "train")), ExternalGrouping
                                  .from_file(os.path.join(small, "train.groups"))).to_packed(
        arch, X.bytes.device).X[:4]
    y_small = torch.tensor(Phenotypes.from_file(os.path.join(small, "train.phen")).y,
                           dtype=torch.float32, device=X.bytes.device)
    print("  the sequential joint sweep's busy share, on 4 of its branches:")
    out["19c_profile"] = loaded_sweeps(
        "--joint-hmc (sequential, 4 branches)", one + ["--joint-hmc", "--step-size",
                                                        JOINT_SEQ_FACTOR],
        "ridge_ard", arch_p, state_p, x_small, y_small, 1, packed,
        dict(none, packed_linear=4 * seq_evals, packed_linear_vjp=4 * seq_evals), 1,
        ("packed_linear_tc", "packed_bwd"))["profile"]

    # 19d: the flagship's feature-major joint HMC: plain products, no kernel
    dense = {"integrate_chains": LF.integrate_chains, "data_vg_chains": BM.data_vg_chains,
             "data_vg": BM.data_vg, "data_vg_blocked": BM.data_vg_blocked,
             "forward_blocked": BM.forward_blocked, **packed}
    fdir = flag["dir"]
    fargs = ["train-new", os.path.join(fdir, "train"), os.path.join(fdir, "train.phen"),
             os.path.join(fdir, "train.groups"), "ridge_base", "tanh", "1", 1, FL,
             "--fixed-hidden-layer-width", FH, "--fixed-summary-layer-width", FH, "--feat-major",
             "--burn-in", "0", "--bfile-test", os.path.join(fdir, "test"),
             "--p-test", os.path.join(fdir, "test.phen"), "-o", os.path.join(work, "runs_joint"),
             "--joint-hmc", "--step-size", JOINT_FACTOR, "--update-mode", "parallel",
             "--num-chains", FCHAINS]
    t0 = time.perf_counter()
    print(f"phase 19d: the flagship's train-new --feat-major --joint-hmc --update-mode parallel "
          f"--num-chains {FCHAINS} (one sweep of L {FL}) -> predict")
    ftest = CompressedGenotypes(BedVM.from_file(os.path.join(fdir, "test")), flag["groups"])
    _, _, out["19d"] = cli_phase(cli, fdir, fargs, dense, log_records, ftest, flag["y_test"],
                                 {k: 0 for k in dense}, packed=False, sweeps=1, widths=(FH, FH))
    out["19d"]["s"] = time.perf_counter() - t0
    out["s"] = time.perf_counter() - t_phase
    print(f"  phases 19-19d: {out['s']:.1f} s in all")
    return out


def joint_numbers(joint, act, kernel):
    """A packed kernel's launches and times on the joint paths (phases
    19-19c), for its entry in the kernels line: phase 19's block transition
    (``act``'s; its CPU comparison at ``joint_block_plain_steps`` leapfrog
    steps), and under identity phase 19's joint GD block and the sweeps'
    launches per sweep."""
    block = joint["19"][act]
    fwd = "vjp" not in kernel
    out = {"joint_block_launches": block["launches"]["fwd" if fwd else "bwd"],
           "joint_block_ms": block["ms"], "joint_block_plain_ms": block["plain_ms"],
           "joint_block_plain_steps": block["plain_steps"],
           "joint_block_max_abs_err": block["max_abs_err"]}
    if act == "identity":
        gd = block["gd"]
        out.update({"joint_gd_block_launches": gd["launches"][0 if fwd else 1],
                    "joint_gd_block_ms": gd["ms"], "joint_gd_block_plain_ms": gd["plain_ms"],
                    "joint_gd_block_plain_steps": gd["plain_steps"],
                    "joint_gd_block_accepted": gd["accepted"]})
        out["joint_launches_per_sweep"] = {
            run: joint[run]["launches_per_sweep"][kernel]
            for run in ("19b_hybrid", "19b_parallel", "19b_own_blocks", "19c_hmc", "19c_gd")}
    return out


def small_data(work):
    """The training set of the same population and phenotype model cut to
    n = N_17D (phases 6d and 17d: their launches and checks do not depend on
    n), written once under ``work``; returns its directory and the test
    phenotype."""
    from rs_bann_tpu_torch.io import Phenotypes

    small = os.path.join(work, "small")
    if not os.path.exists(os.path.join(small, "test.phen")):
        write_data(small, n_train=N_17D)
    return small, Phenotypes.from_file(os.path.join(small, "test.phen")).y


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

    work = tempfile.mkdtemp(prefix="rs_bann_smoke_")
    try:
        # ---- phase 1: the build (nvcc processes) in a thread, the data
        # written on the host meanwhile
        built = {}

        def build():
            t = time.perf_counter()
            try:
                _build.build()
            except BaseException as e:  # raised again below
                built["error"] = e
            built["s"] = time.perf_counter() - t

        builder = threading.Thread(target=build)
        builder.start()
        t0 = time.perf_counter()
        train_bed, y_train, y_test = write_data(work)
        small_data(work)
        data_s = time.perf_counter() - t0
        builder.join()
        if "error" in built:
            raise built["error"]
        _build.lib()
        print(f"phase 1: built {_build.library_path().name} with {_build.nvcc()} in "
              f"{built['s']:.1f} s")
        build_log = _build.BUILD_DIR / "build.log"
        if build_log.exists():  # each source's compile time (nvcc in parallel)
            print("  " + ", ".join(l for l in build_log.read_text().splitlines()
                                   if ".cu: " in l))
        print(f"data: written in {data_s:.1f} s, during the build")
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
        k5_plan = LF.traj_packed_plan(x_b.bytes.shape[1], k0, k0, k_live, 0, BLOCK, CHAINS,
                                      x_b.bytes.shape[-1], N_TRAIN)
        k5_cc, k5_per_sm, k5_smem = k5_plan["cc"], k5_plan["ctas_per_sm"], k5_plan["smem"]
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

        # ---- phase 6d: checkpoint, resume and train on the training set cut
        # to n = N_17D (their checks do not depend on n), then the analysis
        # commands on the full one
        small, _ = small_data(work)
        print(f"phase 6d: phase 6c's train-new at burn-in 2, 3 sweeps straight against 1, a "
              f"checkpoint and a resume to 3; train from a sample (n {N_17D}); branch-r2, "
              f"population-effect-sizes, activations on the card and under --cpu (n {N_TRAIN})")
        resume_run = resume_phase(cli, small, work,
                                  [a.replace(work, small) if isinstance(a, str) else a
                                   for a in hybrid_args], ssm_kernels, log_records)

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
                      fm, FN_TRAIN, fk0, fs, 1, ACT_CODES["tanh"], int(grad), 0,
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

        del state, x_b, A, off, cot, W0p  # X: phases 19-19c

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
                      s, 1, ACT_CODES["tanh"], 1, 0, vp(_build.stream_ptr(X)))
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
        # the sequential one at one sweep: host-bound, ~7-11 s a sweep
        for phase, extra, chains, sweeps, want in (
            (14, [], 1, 1, {"data_vg": FG * (FL + 1)}),
            (15, ["--update-mode", "hybrid", "--per-chain-block-perm", "--num-chains", FCHAINS],
             FCHAINS, CHAIN, {"data_vg_blocked": (FG // fblock) * (FL + 2) * CHAIN,
                              "forward_blocked": (FG // fblock) * CHAIN}),
        ):
            print(f"phase {phase}: train-new --feat-major {' '.join(map(str, extra))} "
                  f"({sweeps} sweep(s) of L {FL}) -> predict")
            for f in k8_counted.values():
                f.launches = 0
            t0 = time.perf_counter()
            argv = list(flag_args)
            argv[7] = sweeps
            if sweeps == 1:  # a sample saved needs burn-in below the chain's length
                argv[argv.index("--burn-in") + 1] = "0"
            saved = sweeps + (sweeps == 1)  # at burn-in 0 the initial sample too
            run = run_cli(cli, argv + extra).strip().splitlines()[-1]
            secs = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = {n: f.launches for n, f in k8_counted.items()}
            print(f"  kernel launches in train-new: {launches}")
            for n, v in launches.items():
                if v != want.get(n, 0):
                    raise AssertionError(f"{n} launched {v} times, expected {want.get(n, 0)}")
            stats = json.load(open(os.path.join(run, "training_stats")))
            series = stats["mse_train"] + stats["mse_test"] + stats["lpd"]
            if len(stats["mse_test"]) != sweeps + 1 or not all(np.isfinite(series)):
                raise AssertionError(f"non-finite or missing training statistics: {stats}")
            if stats["num_samples"] != sweeps * FG * chains:
                raise AssertionError(f"{stats['num_samples']} branch updates counted, "
                                     f"expected {sweeps * FG * chains}")
            dirs = ([os.path.join(run, "models")] if chains == 1
                    else [os.path.join(run, "models", f"chain{c}") for c in range(chains)])
            chain_preds = [np.asarray(list(csv.reader(io.StringIO(run_cli(cli, [
                "predict", os.path.join(fdir, "test"), os.path.join(fdir, "train.groups"),
                "-m", d])))), np.float64) for d in dirs]
            preds = np.concatenate(chain_preds)
            if preds.shape != (chains * saved, FN_TEST) or not np.all(np.isfinite(preds)):
                raise AssertionError(f"predictions of shape {preds.shape}, finite: "
                                     f"{np.all(np.isfinite(preds))}")
            done = [r for r in log_records if str(r.msg).startswith("Completed training")][-1]
            sweep_ms = 1000.0 * done.args[0] / sweeps
            r2 = 1.0 - np.mean((fy_test - preds.mean(axis=0)) ** 2) / np.var(fy_test)
            print(f"  {sweep_ms:.1f} ms per sweep of {chains} chain(s), "
                  f"{sweep_ms / chains:.1f} ms per chain-sweep; train-new {secs:.1f} s in all")
            print(f"  acceptance {stats['num_accepted'] / stats['num_samples']:.3f}, "
                  f"early rejection {stats['num_early_rejected'] / stats['num_samples']:.3f}; "
                  f"mse train {stats['mse_train'][-1]:.4f}, mse test {stats['mse_test'][-1]:.4f}, "
                  f"test r2 of the posterior mean {r2:.4f}")
            net = Net.load(os.path.join(dirs[0], f"{sweeps}.npz"), "cpu")
            cpu_pred = net.predict(f_test.to_stacked(net.arch, "cpu").X).numpy()
            err = np.abs(cpu_pred - chain_preds[0][-1]).max()
            print(f"  predict, card vs CPU plain version: max_abs_err {err:.3e}")
            if not err <= REL_TOL * max(1.0, np.abs(cpu_pred).max()):
                raise AssertionError("the card's predictions disagree with the CPU's")
            k8_runs[phase] = {"launches": launches, "sweep_ms": sweep_ms}

        # ---- phases 16-16c: depth 2 and the default width rule
        t0 = time.perf_counter()
        deep = deep_phases(cli, work, train_bed, groups, y_train, y_test, log_records)
        print(f"  phases 16-16c: {time.perf_counter() - t0:.1f} s in all")

        # ---- phases 17-17d: the dense kernels at depth 2 and the default widths
        t0 = time.perf_counter()
        dense = dense_deep_phases(cli, work, train_bed, groups, y_train, y_test, log_records)
        print(f"  phases 17-17d: {time.perf_counter() - t0:.1f} s in all")

        # ---- phases 18-18c: the dense kernels on bf16 X, --x-bf16 and --bf16
        t0 = time.perf_counter()
        xb16 = bf16_phases(cli, work, train_bed, groups, y_train, y_test, log_records,
                           {"dir": fdir, "bed": f_bed, "groups": fgroups, "arch": farch,
                            "y_train": fy_train, "y_test": fy_test, "sweep_ms": flag_sweep_ms},
                           train_args, hybrid_sweep_ms)
        print(f"  phases 18-18c: {time.perf_counter() - t0:.1f} s in all")

        # ---- phases 19-19d: joint HMC and joint gradient descent
        joint = joint_phases(cli, work, X, arch, y_train, y_test, train_args, log_records,
                             {"dir": fdir, "groups": fgroups, "y_test": fy_test})
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
         "adapted_launches": adapted_runs["packed"]["k2_value_passes"],
         **joint_numbers(joint, "identity", "packed_linear")},
        {"name": "data_vg_packed", "route": "cuda",
         "source": "rs_bann_tpu_torch/csrc/branch_vg_packed.cu",
         "replaces": "rs_bann_tpu/ops/branch_mlp.py:365",
         "launches": k4_launches, "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain_ms,
         "bound_ms": k4_bound[0], "bound_by": k4_bound[1], "library_ms": None,
         "wrapper_ms": k4_wrapper_ms, "f32_bound_ms": k4_f32_bound[0],
         "ctas": k4_plan["ctas"], "ctas_per_sm": k4_plan["ctas_per_sm"],
         "max_rel_err_f64": REL_ERR["data_vg_packed f64"],
         "deep": deep["k4"]},
        {"name": "traj_packed", "route": "cuda",
         "source": "rs_bann_tpu_torch/csrc/traj_packed.cu",
         "replaces": "rs_bann_tpu/ops/leapfrog.py:470",
         "launches": k5_launches, "max_abs_err": k5_err, "ms": k5_ms, "plain_ms": k5_plain_ms,
         "bound_ms": k5_bound[0], "bound_by": k5_bound[1], "library_ms": None,
         "k_live": k_live, "km": k5_km, "cc": k5_cc, "blocks_per_sm": k5_per_sm,
         "adapted_launches": adapted_runs["packed"]["k5_launches"],
         "deep": deep["k5"], "deep_library_ms": deep["library_ms"],
         "deep_launches_per_sweep": {"16b": deep["16b"]["launches_per_sweep"],
                                     "16c": deep["16c"]["launches_per_sweep"]}},
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
         **k9a_vp, **joint_numbers(joint, "silu", "packed_matmul")},
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
         "max_rel_err_f64": REL_ERR["packed_linear_vjp f64"],
         **joint_numbers(joint, "identity", "packed_linear_vjp")},
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
         "ssm_u0_plain_ms": scan["u0_plain_ms"], "ssm_u0_max_abs_err": scan["u0_max_abs_err"],
         **joint_numbers(joint, "silu", "packed_matmul_vjp")},
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
        # the dense deep design (csrc/dense_deep.cuh, phases 17-17d): each
        # kernel's numbers at the slice's branch (depth 2 tanh, h = s = 56),
        # the other shapes under ``shapes``; launches in the main path's runs
        # (17b for K6 and K7, 17d for K8a and K8b)
        *[{"name": f"{name}_deep", "route": "cuda", "source": source, "replaces": replaces,
           "launches": sum(r[counter] for r in runs), **{
               k: nums[MAIN_DEEP][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "f32_bound_ms")},
           "library_ms": dense["library_ms"] if name == "traj_dense" else None,
           "wrapper_ms": nums[MAIN_DEEP].get("wrapper_ms"), "shapes": nums,
           "plan": nums[MAIN_DEEP]["plan"]}
          for name, source, replaces, counter, runs, nums in (
              ("traj_dense", "rs_bann_tpu_torch/csrc/traj_dense.cu",
               "rs_bann_tpu/ops/leapfrog.py:410", "integrate_chains", dense["17b_runs"],
               dense["k6"]),
              ("data_vg_chains", "rs_bann_tpu_torch/csrc/branch_fwd_chains.cu",
               "rs_bann_tpu/ops/branch_mlp.py:791", "data_vg_chains", dense["17b_runs"],
               dense["k7_fwd"]),
              ("data_vg", "rs_bann_tpu_torch/csrc/dense_deep.cuh",
               "rs_bann_tpu/ops/branch_mlp.py:216", "data_vg", dense["17d_sequential_runs"],
               dense["k8a"]),
              ("data_vg_blocked", "rs_bann_tpu_torch/csrc/dense_deep.cuh",
               "rs_bann_tpu/ops/branch_mlp.py:478", "data_vg_blocked",
               dense["17d_unfolded_runs"], dense["k8b"]))],
        # no TPU kernel: the JAX package's scan is jnp inside lax.scan; its
        # floor is the chain of dependent marker steps (us_per_marker)
        {"name": "marker_scan", "route": "cuda",
         "source": "rs_bann_tpu_torch/csrc/marker_scan.cu",
         "replaces": "rs_bann_tpu/models/net.py:218",
         "launches": scan_launches, "max_abs_err": scan["max_abs_err"], "ms": scan["ms"],
         "plain_ms": scan["plain_ms"], "bound_ms": scan["bound"][0],
         "bound_by": scan["bound"][1], "library_ms": None,
         "us_per_marker": scan["us_per_marker"], "near_ties": scan["near_ties"],
         "w56": {k: deep["scan"][k] for k in ("ms", "plain_ms", "max_abs_err", "us_per_marker",
                                              "near_ties")}},
        # the bf16-X forms of K6, K7, K8a and K8b (phases 18-18c): the
        # flagship's numbers (dense_vg_mma.cuh), the deep design's at phase
        # 17's depth 2 width 56 under ``deep``; launches in the main path's
        # bf16-X runs (18b: K6 and K7's forward folded, K8b unfolded, K8a
        # sequential), 18c's under ``recipe_launches``
        *[{"name": name, "route": "cuda", "source": source, "replaces": replaces,
           "launches": sum(r[f"{counter}_xbf16"] for r in xb16[runs]),
           **{k: xb16["flagship"][name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                                      "bound_ms", "bound_by",
                                                      "impl_bound_ms")},
           "library_ms": None, "deep": xb16["deep"][name],
           "x_bytes": xb16["flagship"]["x_bytes"], "x_f32_bytes": xb16["flagship"]["x_f32_bytes"],
           "deep_x_bytes": xb16["deep"]["x_bytes"],
           "recipe_launches": sum(r[f"{counter}_xbf16"] for r in xb16["18c_runs"])}
          for name, source, replaces, counter, runs in (
              ("traj_dense_xbf16", "rs_bann_tpu_torch/csrc/traj_dense_xbf16.cu",
               "rs_bann_tpu/ops/leapfrog.py:63", "integrate_chains", "18b_runs"),
              ("data_vg_chains_xbf16", "rs_bann_tpu_torch/csrc/branch_fwd_chains_xbf16.cu",
               "rs_bann_tpu/ops/branch_mlp.py:649", "data_vg_chains", "18b_runs"),
              ("data_vg_xbf16", "rs_bann_tpu_torch/csrc/branch_vg_dense.cu",
               "rs_bann_tpu/ops/branch_mlp.py:96", "data_vg", "18b_sequential_runs"),
              ("data_vg_blocked_xbf16", "rs_bann_tpu_torch/csrc/branch_vg_dense.cu",
               "rs_bann_tpu/ops/branch_mlp.py:335", "data_vg_blocked", "18b_unfolded_runs"))],
    ]
    for k in kernels:  # the scale-free error that the checks gate on
        k["max_rel_err"] = REL_ERR[k["name"]]
        if k["name"] == "data_vg_chains_deep":  # K7's value and gradient beside it
            k["grad"] = dense["k7"]
    print("adaptation (phases 6b, 9b): " + json.dumps(adapted_runs))
    print("ss_markers (phase 6c): " + json.dumps(ssm_run))
    print("resume and analysis (phase 6d): " + json.dumps(resume_run))
    print("depth 2 and the default widths (phases 16b, 16c): "
          + json.dumps({k: deep[k] for k in ("16b", "16c")}))
    print("feature-major depth 2 and the default widths (phases 17b-17d): "
          + json.dumps({k: dense[k] for k in ("17b", "17c", "17d_unfolded", "17d_sequential")}))
    print("joint HMC and joint GD (phases 19-19d): " + json.dumps(
        {k: v for k, v in joint.items() if k != "19"}))
    print("bf16 X and --bf16 (phases 18b, 18c): " + json.dumps(
        {k: xb16[k] for k in ("18b", "18b_unfolded", "18b_sequential", "18b_bf16",
                              "18b_bf16_unfolded", "18c", "18c_packed")}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
