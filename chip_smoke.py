#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rs_bann_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):
  0. require a CUDA device; print the card, its power limit and the versions
  1. build the CUDA kernels from rs_bann_tpu_torch/csrc with nvcc
  2. K2 (packed_linear) against its plain PyTorch version at the slice's
     full shape: bytes [100, 104, 25088], k = 16, n = 100,000
  3. K4 (data_vg_packed) against its plain version, one branch, same shape
  4. the sequential path end to end through the CLI: train-new
     --packed-genotypes (G = 100 groups of 100 markers, n = 100,000,
     ridge_ard identity depth 0, 2 sequential sweeps of L = 30, one chain)
     then predict on n = 10,000, counting the kernel launches; then the
     card's predictions against the plain version's on the CPU
  5. on one hybrid block at the full shape (B = 10 branches, C = 4 chains,
     n = 100,000): K2 at the hybrid's chain-folded value-pass shape (bytes
     [10, 104, 25088], k = C * 16) against its plain version, and
     predict_chains on the card against the CPU's; then K5
     (integrate_chains_packed) against its plain version, izmailov step
     sizes from the initial state, at L = 1 and L = 30, and the block's
     live columns (width 10 of the 16 stored) stored at width 10: the same
     bits
  6. the hybrid path end to end through the CLI: train-new --update-mode
     hybrid --num-chains 4 (blocks of 10, every block transition one K5
     call, 2 sweeps of L = 30), predict on each chain's samples, the card's
     predictions against the CPU's
  7. the dense flagship (bench.py workload 1: G = 64 groups of 64 markers,
     n = 4,096, ridge_base tanh depth 1, h = s = 32, C = 4 chains):
     K7 (data_vg_chains, feature-major X [64, 64, 4096]) and its
     forward-only instantiation (forward_chains) against their plain
     versions, weights from the flagship's initial state, each chain's
     perturbed; identical bits on a repeat
  8. K6 (integrate_chains) against its plain version at the same shape,
     izmailov step sizes from the initial state, at L = 1 and L = 64;
     identical bits on a repeat
  9. the flagship end to end through the CLI: train-new --feat-major
     --update-mode parallel --num-chains 4 (2 sweeps of L = 64: exactly one
     K6 launch and two K7 launches, snapshot/H0 and Hf, per sweep; no K4 or
     K5), dense predict on each chain's samples, the card's predictions
     against the CPU's
 10. K9a (packed_matmul), K3 (packed_linear_vjp, all four fused
     activations) and K9b (packed_matmul_vjp) against their plain versions
     at the slice's full shape (bytes [100, 104, 25088], k = 16, n =
     100,000; K9a also at the hybrid value pass, bytes [10, 104, 25088],
     k = 64), the cotangent from a seed, K3's saved output the plain
     forward at the perturbed initial state; identical bits on a repeat
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
     forward-only instantiation against its y_pred
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
for K9a and K9b, 14 for K8a, 15 for K8b), error against
its plain version (max_abs_err, and max_rel_err: the largest difference
over max(1, largest plain entry), the ratio held to REL_TOL), times (of
the wrapper's call, except K8's: its launch alone from back-to-back
launches, the wrapper's call beside it as wrapper_ms), and
the bound (the larger of its FLOPs over the
67 TFLOP/s f32 peak and its bytes, each input read once and each output
written once, over 3.35 TB/s); the last line is {"ok": true, "device":
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
# H100 SXM: f32 FMA peak outside the tensor cores and HBM bandwidth
PEAK_F32_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12
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


def run_cli(cli, argv):
    """Run the port's CLI in-process; returns its standard output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli([str(a) for a in argv])
    return out.getvalue()


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
    from rs_bann_tpu_torch.ops.activations import ACT_CODES
    from rs_bann_tpu_torch.ops import branch_mlp as BM
    from rs_bann_tpu_torch.ops import leapfrog as LF
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
            del out, ref
            ms = cuda_ms(lambda: PM.packed_linear(X.bytes, A, off, N_TRAIN, act))
            plain_ms = cuda_ms(lambda: PM.packed_linear_ref(X.bytes, A, off, N_TRAIN, act))
            print(f"  {act}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
            if act == "identity":  # the slice's activation
                k2_ms, k2_plain_ms = ms, plain_ms
        k2_bound = bound(2 * G * X.bytes.shape[1] * N_TRAIN * A.shape[-1],
                         nbytes(X.bytes, A, off) + 4 * G * N_TRAIN * A.shape[-1])

        # ---- phase 3: K4 for one branch at the slice's full shape
        print("phase 3: K4 data_vg_packed vs plain, one branch, n", N_TRAIN)
        g = G // 2
        xg = X[g]
        w_g, b_g = (W0[g], Wout[g]), (b0[g],)
        target = torch.randn(N_TRAIN, device=dev, generator=torch.Generator(dev).manual_seed(0))
        y, rss, dws, dbs = BM.data_vg_packed("identity", xg, w_g, b_g, target)
        wf = (xg.w_scale[:, None] * w_g[0], w_g[1])
        bf = (b_g[0] - xg.shift @ wf[0],)
        y_ref, dws_ref, dbs_ref = BM.data_vg_packed_ref("identity", xg.bytes, target, wf, bf, N_TRAIN)
        dW0_ref = xg.w_scale[:, None] * dws_ref[0] - (xg.shift * xg.w_scale)[:, None] * dbs_ref[0]
        k4_err = max(
            check_close("data_vg_packed", "y_pred", y, y_ref),
            check_close("data_vg_packed", "dW0", dws[0], dW0_ref),
            check_close("data_vg_packed", "db0", dbs[0], dbs_ref[0]),
            check_close("data_vg_packed", "dW1", dws[1], dws_ref[1]),
        )
        k4_ms = cuda_ms(lambda: BM.data_vg_packed("identity", xg, w_g, b_g, target))
        k4_plain_ms = cuda_ms(
            lambda: BM.data_vg_packed_ref("identity", xg.bytes, target, wf, bf, N_TRAIN))
        print(f"  kernel {k4_ms:.3f} ms, plain {k4_plain_ms:.3f} ms")
        k4_bound = bound(
            2 * N_TRAIN * mlp_fmas(xg.bytes.shape[0], w_g[0].shape[1], w_g[1].shape[0], 0),
            nbytes(xg.bytes, xg.w_scale, xg.shift, target, *w_g, *b_g) + 4 * N_TRAIN
            + nbytes(*w_g, *b_g))

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
        A_c, off_c = D.chain_layer0(w_cb[0], b_cb[0], x_b)
        print("  K2 packed_linear vs plain, chain-folded: bytes", tuple(x_b.bytes.shape),
              "k", A_c.shape[-1])
        k2_err = max(k2_err, check_close(
            "packed_linear", "identity", PM.packed_linear(x_b.bytes, A_c, off_c, N_TRAIN, "identity"),
            PM.packed_linear_ref(x_b.bytes, A_c, off_c, N_TRAIN, "identity")))
        ms = cuda_ms(lambda: PM.packed_linear(x_b.bytes, A_c, off_c, N_TRAIN, "identity"))
        plain_ms = cuda_ms(lambda: PM.packed_linear_ref(x_b.bytes, A_c, off_c, N_TRAIN, "identity"))
        print(f"  identity: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        cpu = lambda ts: tuple(t.cpu() for t in ts)  # noqa: E731
        k2_err = max(k2_err, check_close(
            "packed_linear", "predict_chains, card vs CPU plain version",
            D.predict_chains("identity", w_cb, b_cb, x_b).cpu(),
            D.predict_chains("identity", cpu(w_cb), cpu(b_cb),
                             D.PackedX(*cpu((x_b.bytes, x_b.w_scale, x_b.shift)), N_TRAIN))))
        del A_c, off_c, w_cb, b_cb

        # K5 computes the block's live layer-0 columns only: the padded ones
        # have zero weights and momenta (their step sizes are not zero)
        k0 = ws[0].shape[-1]
        k_live = LF.live_width(k0, *(BM.flat_params(a, b) for a, b in (
            (ws, bs), (p_w, p_b), (eps_w, eps_b), (lam_w, lam_b))))
        k5_km = _build.lib().traj_packed_km(k0, k0, k_live, 0)
        print(f"  K5: width {arch.s[0]} stored at {k0}, live width {k_live}, register width "
              f"{k5_km}")
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
        del out, narrow, targets

        # ---- phase 6: the hybrid path, C chains, through the CLI
        print(f"phase 6: train-new --update-mode hybrid --num-chains {CHAINS} -> predict")
        PM.packed_linear.launches = 0
        BM.data_vg_packed.launches = 0
        LF.integrate_chains_packed.launches = 0
        t0 = time.perf_counter()
        run = run_cli(cli, train_args + ["--update-mode", "hybrid", "--num-chains", CHAINS])
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
        names = ("y_pred", "rss", "dW0", "dW1", "dw_out", "db0", "db1")
        k7_err = 0.0
        for name, got, want in zip(names, [out[0], out[1], *out[2], *out[3]],
                                   [ref[0], ref[1], *ref[2], *ref[3]]):
            k7_err = max(k7_err, check_close("data_vg_chains", name, got, want))
        y_fwd = BM.forward_chains("tanh", xT, fws, fbs)
        k7_err = max(k7_err, check_close("data_vg_chains", "forward-only y_pred", y_fwd,
                                           ref[0]))
        again = BM.data_vg_chains("tanh", xT, fws, fbs, ftargets)
        if not all(torch.equal(a, b) for a, b in zip([out[0], *out[2], *out[3]],
                                                     [again[0], *again[2], *again[3]])):
            raise AssertionError("K7: two calls with the same inputs differ")
        if not torch.equal(y_fwd, BM.forward_chains("tanh", xT, fws, fbs)):
            raise AssertionError("K7 forward-only: two calls with the same inputs differ")
        del out, ref, again, y_fwd
        k7_grad_ms = cuda_ms(lambda: BM.data_vg_chains("tanh", xT, fws, fbs, ftargets))
        k7_grad_plain_ms = cuda_ms(lambda: BM.data_vg_chains_ref("tanh", xT, fws, fbs, ftargets))
        k7_ms = cuda_ms(lambda: BM.forward_chains("tanh", xT, fws, fbs))
        k7_plain_ms = cuda_ms(lambda: BM.forward_chains_ref("tanh", xT, fws, fbs))
        fm, fk0, fs = xT.shape[1], fws[0].shape[-1], fws[-1].shape[-2]
        per = FG * FCHAINS * FN_TRAIN
        param_bytes = nbytes(*fws, *fbs)
        k7_bound = bound(2 * per * mlp_fmas(fm, fk0, fs, 1, grad=False),
                         nbytes(xT) + param_bytes + 4 * per)
        k7_grad_bound = bound(2 * per * mlp_fmas(fm, fk0, fs, 1),
                              nbytes(xT, ftargets) + 2 * param_bytes + 4 * per)
        print(f"  value and gradient: kernel {k7_grad_ms:.3f} ms, plain {k7_grad_plain_ms:.3f} ms, "
              f"bound {k7_grad_bound[0]:.3f} ms ({k7_grad_bound[1]}); identical repeat")
        print(f"  forward only: kernel {k7_ms:.3f} ms, plain {k7_plain_ms:.3f} ms, "
              f"bound {k7_bound[0]:.3f} ms ({k7_bound[1]}); identical repeat")

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
            k6_bound = bound(2 * per * (steps + 1) * mlp_fmas(fm, fk0, fs, 1),
                             nbytes(xT, ftargets, ferr) + 8 * param_bytes)
            print(f"  L={steps}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                  f"{k6_bound[0]:.3f} ms ({k6_bound[1]}), identical repeat, "
                  f"max |W0_L - W0_0| {moved:.3e}")
            k6_ms, k6_plain_ms = ms, plain_ms  # the main path's L
        print("  max abs err against L: " + ", ".join(f"L={k} {v:.3e}" for k, v in k6_errs.items()))
        del fws, fbs, ftargets, f_pw, f_pb, f_eps_w, f_eps_b, f_lam_w, f_lam_b, fdata, xT, fchains

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
        t0 = time.perf_counter()
        try:
            run = run_cli(cli, [
                "train-new", os.path.join(fdir, "train"), os.path.join(fdir, "train.phen"),
                os.path.join(fdir, "train.groups"), "ridge_base", "tanh", "1", CHAIN, FL,
                "--fixed-hidden-layer-width", FH, "--fixed-summary-layer-width", FH,
                "--feat-major", "--update-mode", "parallel", "--num-chains", FCHAINS,
                "--burn-in", "1", "--bfile-test", os.path.join(fdir, "test"),
                "--p-test", os.path.join(fdir, "test.phen"), "-o", runs,
            ]).strip().splitlines()[-1]
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

        def identical(fn, first, what):
            again = fn()
            pairs = zip(first, again) if isinstance(first, tuple) else [(first, again)]
            if not all(torch.equal(a, b) for a, b in pairs):
                raise AssertionError(f"{what}: two calls with the same inputs differ")

        k9a_err = check_close("packed_matmul", "Z", PM.packed_matmul(X.bytes, A, N_TRAIN),
                              PM.packed_matmul_ref(X.bytes, A, N_TRAIN))
        identical(lambda: PM.packed_matmul(X.bytes, A, N_TRAIN),
                  PM.packed_matmul(X.bytes, A, N_TRAIN), "K9a")
        k9a_ms = cuda_ms(lambda: PM.packed_matmul(X.bytes, A, N_TRAIN))
        k9a_plain_ms = cuda_ms(lambda: PM.packed_matmul_ref(X.bytes, A, N_TRAIN))
        k9a_bound = bound(flop, nbytes(X.bytes, A) + out_bytes)
        print(f"  K9a G={G}, k={k}: kernel {k9a_ms:.3f} ms, plain {k9a_plain_ms:.3f} ms, bound "
              f"{k9a_bound[0]:.3f} ms ({k9a_bound[1]}); identical repeat")
        # K9a at the silu hybrid value pass: one block's bytes, C chains side by side
        w_cb = tuple(t.transpose(0, 1).contiguous() for t in chains_of((W0p, Wout)))
        b_cb = tuple(t.transpose(0, 1).contiguous() for t in chains_of((b0,)))
        A_c, _ = D.chain_layer0(w_cb[0], b_cb[0], x_b)
        k9a_err = max(k9a_err, check_close(
            "packed_matmul", f"Z, value pass B={BLOCK}, k={A_c.shape[-1]}",
            PM.packed_matmul(x_b.bytes, A_c, N_TRAIN),
            PM.packed_matmul_ref(x_b.bytes, A_c, N_TRAIN)))
        identical(lambda: PM.packed_matmul(x_b.bytes, A_c, N_TRAIN),
                  PM.packed_matmul(x_b.bytes, A_c, N_TRAIN), "K9a value pass")
        vp_ms = cuda_ms(lambda: PM.packed_matmul(x_b.bytes, A_c, N_TRAIN))
        vp_plain_ms = cuda_ms(lambda: PM.packed_matmul_ref(x_b.bytes, A_c, N_TRAIN))
        vp_bound = bound(2 * BLOCK * x_b.bytes.shape[1] * N_TRAIN * A_c.shape[-1],
                         nbytes(x_b.bytes, A_c) + 4 * BLOCK * N_TRAIN * A_c.shape[-1])
        print(f"  K9a value pass B={BLOCK}, k={A_c.shape[-1]}: kernel {vp_ms:.3f} ms, plain "
              f"{vp_plain_ms:.3f} ms, bound {vp_bound[0]:.3f} ms ({vp_bound[1]}); identical repeat")
        del w_cb, b_cb, A_c

        k3_err, k3_ms, k3_plain_ms = 0.0, None, None
        for act in PM.FUSED_ACTIVATIONS:
            res = PM.packed_linear_ref(X.bytes, A, off, N_TRAIN, act)  # the saved output
            got = PM.packed_linear_vjp(X.bytes, cot, res, N_TRAIN, act)
            ref = PM.packed_linear_vjp_ref(X.bytes, cot, res, N_TRAIN, act)
            k3_err = max(k3_err, check_close("packed_linear_vjp", f"{act} dA", got[0], ref[0]),
                         check_close("packed_linear_vjp", f"{act} d_off", got[1], ref[1]))
            identical(lambda: PM.packed_linear_vjp(X.bytes, cot, res, N_TRAIN, act), got,
                      f"K3 {act}")
            del got, ref
            if act in ("identity", "tanh"):
                ms = cuda_ms(lambda: PM.packed_linear_vjp(X.bytes, cot, res, N_TRAIN, act))
                plain_ms = cuda_ms(lambda: PM.packed_linear_vjp_ref(X.bytes, cot, res, N_TRAIN,
                                                                    act))
                print(f"  K3 {act}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; identical repeat")
                if act == "identity":  # the slice's activation
                    k3_ms, k3_plain_ms = ms, plain_ms
            del res
        # g and the saved output read, dA and d_off written
        k3_bound = bound(flop, nbytes(X.bytes, cot) + out_bytes
                         + 4 * G * k * (X.bytes.shape[1] + 1))
        print(f"  K3 bound {k3_bound[0]:.3f} ms ({k3_bound[1]})")

        got = PM.packed_matmul_vjp(X.bytes, cot, N_TRAIN)
        k9b_err = check_close("packed_matmul_vjp", "silu dA", got,
                              PM.packed_matmul_vjp_ref(X.bytes, cot, N_TRAIN))
        identical(lambda: PM.packed_matmul_vjp(X.bytes, cot, N_TRAIN), got, "K9b")
        del got
        k9b_ms = cuda_ms(lambda: PM.packed_matmul_vjp(X.bytes, cot, N_TRAIN))
        k9b_plain_ms = cuda_ms(lambda: PM.packed_matmul_vjp_ref(X.bytes, cot, N_TRAIN))
        k9b_bound = bound(flop, nbytes(X.bytes, cot) + 4 * G * k * X.bytes.shape[1])
        print(f"  K9b: kernel {k9b_ms:.3f} ms, plain {k9b_plain_ms:.3f} ms, bound "
              f"{k9b_bound[0]:.3f} ms ({k9b_bound[1]}); identical repeat")
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
            """CUDA-event ms of one K8 launch with its tile sum, from runs of
            ``reps`` back-to-back calls of the C entry on buffers made once:
            the wrapper's own host work (the flat weights, the views of the
            gradients) would otherwise stall the card between launches."""
            NB, (_, m, n) = ws[0].shape[0], X.shape
            q = BM.flat_params(tuple(w.unsqueeze(1) for w in ws),
                               tuple(b.unsqueeze(1) for b in bs))
            P = q.shape[-1]
            y = torch.empty((NB, n), device=dev)
            partial = torch.empty((NB, -(-n // BM.DENSE_TILE), P), device=dev)
            grads = torch.empty((NB, P), device=dev)
            vp = ctypes.c_void_p
            c_args = (vp(X.data_ptr()), vp(0 if ix is None else ix.data_ptr()),
                      vp(targets.data_ptr()), vp(q.data_ptr()), vp(y.data_ptr()),
                      vp(partial.data_ptr()), vp(grads.data_ptr()), NB, m, n,
                      ws[0].shape[-1], ws[-1].shape[-2], P, len(ws) - 2, ACT_CODES["tanh"], 1,
                      vp(_build.stream_ptr(X)))
            lib = _build.lib()

            def run():
                for _ in range(reps):
                    _build.check(lib.vg_dense_f32(*c_args), "vg_dense_f32")

            return cuda_ms(run) / reps

        def k8_case(name, label, fn, ref, args, ix_x, nb, raw):
            """Check, repeat and time one K8 call (the wrapper, and with ``raw``
            = (X, ix, weights, biases, targets) with a leading instance axis,
            the launch alone); returns (err, ms, wrapper ms, plain ms, bound)."""
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
            case_bound = bound(2 * nb * FN_TRAIN * mlp_fmas(fm, fk0, fs, 1),
                               4 * len(set(ix_x)) * fm * FN_TRAIN + nbytes(args[-1], out[0])
                               + 2 * nbytes(*ws, *bs))
            print(f"  {label}: kernel {ms:.4f} ms (launch alone; the wrapper {wrapper_ms:.4f} ms), "
                  f"plain {plain_ms:.4f} ms, bound {case_bound[0]:.4f} ms ({case_bound[1]}); "
                  f"identical repeat")
            return err, ms, wrapper_ms, plain_ms, case_bound

        g = FG // 2
        ws1, bs1 = instances([g])
        t1 = fy + 0.1 * torch.randn(FN_TRAIN, device=dev, generator=fgen)
        k8a_err, k8a_ms, k8a_wrapper_ms, k8a_plain_ms, k8a_bound = k8_case(
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
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1], "library_ms": None},
        {"name": "data_vg_packed", "route": "cuda",
         "source": "rs_bann_tpu_torch/csrc/branch_vg_packed.cu",
         "replaces": "rs_bann_tpu/ops/branch_mlp.py:365",
         "launches": k4_launches, "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain_ms,
         "bound_ms": k4_bound[0], "bound_by": k4_bound[1], "library_ms": None},
        {"name": "traj_packed", "route": "cuda",
         "source": "rs_bann_tpu_torch/csrc/traj_packed.cu",
         "replaces": "rs_bann_tpu/ops/leapfrog.py:470",
         "launches": k5_launches, "max_abs_err": k5_err, "ms": k5_ms, "plain_ms": k5_plain_ms,
         "bound_ms": k5_bound[0], "bound_by": k5_bound[1], "library_ms": None,
         "k_live": k_live, "km": k5_km},
        # the flagship launches K7's forward-only instantiation (the value
        # passes); the value-and-gradient one runs inside K6 and is timed too
        {"name": "data_vg_chains", "route": "cuda",
         "source": "rs_bann_tpu_torch/csrc/branch_vg_chains.cu",
         "replaces": "rs_bann_tpu/ops/branch_mlp.py:649",
         "launches": k7_launches, "max_abs_err": k7_err, "ms": k7_ms, "plain_ms": k7_plain_ms,
         "bound_ms": k7_bound[0], "bound_by": k7_bound[1], "library_ms": None,
         "grad_ms": k7_grad_ms, "grad_plain_ms": k7_grad_plain_ms,
         "grad_bound_ms": k7_grad_bound[0]},
        {"name": "traj_dense", "route": "cuda",
         "source": "rs_bann_tpu_torch/csrc/traj_dense.cu",
         "replaces": "rs_bann_tpu/ops/leapfrog.py:63",
         "launches": k6_launches, "max_abs_err": k6_err, "ms": k6_ms, "plain_ms": k6_plain_ms,
         "bound_ms": k6_bound[0], "bound_by": k6_bound[1], "library_ms": None},
        # launches: the GD warm start and hybrid sampling of phase 11
        # (identity, K3) and of phase 12 (silu: K9a, K9b)
        {"name": "packed_matmul", "route": "cuda",
         "source": "rs_bann_tpu_torch/csrc/packed_linear.cu",
         "replaces": "rs_bann_tpu/ops/packed_matmul.py:178",
         "launches": gd_runs["silu"]["launches"]["packed_matmul"], "max_abs_err": k9a_err,
         "ms": k9a_ms, "plain_ms": k9a_plain_ms, "bound_ms": k9a_bound[0],
         "bound_by": k9a_bound[1], "library_ms": None, "value_pass_ms": vp_ms,
         "value_pass_plain_ms": vp_plain_ms, "value_pass_bound_ms": vp_bound[0]},
        {"name": "packed_linear_vjp", "route": "cuda",
         "source": "rs_bann_tpu_torch/csrc/packed_bwd.cu",
         "replaces": "rs_bann_tpu/ops/packed_matmul.py:256",
         "launches": gd_runs["identity"]["launches"]["packed_linear_vjp"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
         "library_ms": None},
        {"name": "packed_matmul_vjp", "route": "cuda",
         "source": "rs_bann_tpu_torch/csrc/packed_bwd.cu",
         "replaces": "rs_bann_tpu/ops/packed_matmul.py:233",
         "launches": gd_runs["silu"]["launches"]["packed_matmul_vjp"], "max_abs_err": k9b_err,
         "ms": k9b_ms, "plain_ms": k9b_plain_ms, "bound_ms": k9b_bound[0],
         "bound_by": k9b_bound[1], "library_ms": None},
        # launches: the sequential flagship of phase 14 (K8a) and the unfolded
        # hybrid of phase 15 (K8b, whose times are at its NB = 32 of 4 chains
        # x 8 branches; NB = 64 and the forward-only launches beside them)
        {"name": "data_vg", "route": "cuda",
         "source": "rs_bann_tpu_torch/csrc/branch_vg_dense.cu",
         "replaces": "rs_bann_tpu/ops/branch_mlp.py:96",
         "launches": k8_runs[14]["launches"]["data_vg"], "max_abs_err": k8a_err,
         "ms": k8a_ms, "plain_ms": k8a_plain_ms, "bound_ms": k8a_bound[0],
         "bound_by": k8a_bound[1], "library_ms": None, "wrapper_ms": k8a_wrapper_ms},
        {"name": "data_vg_blocked", "route": "cuda",
         "source": "rs_bann_tpu_torch/csrc/branch_vg_dense.cu",
         "replaces": "rs_bann_tpu/ops/branch_mlp.py:335",
         "launches": k8_runs[15]["launches"]["data_vg_blocked"], "max_abs_err": k8b_err,
         "ms": k8b[FCHAINS * 8][1], "plain_ms": k8b[FCHAINS * 8][3],
         "bound_ms": k8b[FCHAINS * 8][4][0], "bound_by": k8b[FCHAINS * 8][4][1],
         "library_ms": None, "wrapper_ms": k8b[FCHAINS * 8][2], "nb64_ms": k8b[FG][1],
         "nb64_wrapper_ms": k8b[FG][2], "nb64_plain_ms": k8b[FG][3],
         "nb64_bound_ms": k8b[FG][4][0],
         "forward_launches": k8_runs[15]["launches"]["forward_blocked"]},
    ]
    for k in kernels:  # the scale-free error that the checks gate on
        k["max_rel_err"] = REL_ERR[k["name"]]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
