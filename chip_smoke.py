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
     ridge_ard identity depth 0, 4 sequential sweeps of L = 30, one chain)
     then predict on n = 10,000, counting the kernel launches; then the
     card's predictions against the plain version's on the CPU
  5. on one hybrid block at the full shape (B = 10 branches, C = 4 chains,
     n = 100,000): K2 at the hybrid's chain-folded value-pass shape (bytes
     [10, 104, 25088], k = C * 16) against its plain version, and
     predict_chains on the card against the CPU's; then K5
     (integrate_chains_packed) against its plain version, izmailov step
     sizes from the initial state, at L = 1 and L = 30
  6. the hybrid path end to end through the CLI: train-new --update-mode
     hybrid --num-chains 4 (blocks of 10, every block transition one K5
     call, 4 sweeps of L = 30), predict on each chain's samples, the card's
     predictions against the CPU's
The line before the last is a JSON object with each kernel's launches,
error against its plain version and times; the last line is
{"ok": true, "device": {...}}. The data lives in a temporary directory,
removed at the end.
"""

import contextlib
import csv
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
CHAIN, L = 4, 30
CHAINS, BLOCK = 4, 10  # the hybrid path: chains, branches per block
N_CAUSAL = 500  # markers with an effect in the simulated phenotype
TIMED_RUNS = 7
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


def check_close(name, got, ref, tol=REL_TOL):
    err = (got - ref).abs().max().item()
    scale = max(1.0, ref.abs().max().item())
    print(f"  {name}: max_abs_err {err:.3e} (max |plain| {scale:.3e})")
    if not err <= tol * scale:
        raise AssertionError(f"{name}: kernel and plain version differ by {err} > {tol} * {scale}")
    return err


def run_cli(cli, argv):
    """Run the port's CLI in-process; returns its standard output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli([str(a) for a in argv])
    return out.getvalue()


def write_data(d):
    """Train (n = 100,000) and test (n = 10,000) genotypes of one population
    (per-marker allele frequencies shared), 100 groups of 100 markers, and a
    sparse linear phenotype at h2 = 0.5."""
    import numpy as np

    from rs_bann_tpu_torch.io import BedVM, Phenotypes, UniformGrouping

    rng = np.random.default_rng(1)
    mafs = rng.uniform(0.05, 0.5, G * M)
    causal = np.sort(rng.choice(G * M, size=N_CAUSAL, replace=False))
    beta = rng.standard_normal(N_CAUSAL)
    train = BedVM.random(N_TRAIN, G * M, mafs=mafs, seed=1)
    test = BedVM.random(N_TEST, G * M, mafs=mafs, seed=2)
    mu, sd = train.col_means[causal], train.col_stds[causal]
    g_train = ((train.get_cols(causal).T - mu) / sd) @ beta
    g_test = ((test.get_cols(causal).T - mu) / sd) @ beta
    noise_sd = g_train.std()  # h2 = var(g) / (var(g) + noise_sd^2) = 0.5
    y_train = g_train + noise_sd * rng.standard_normal(N_TRAIN)
    y_test = g_test + noise_sd * rng.standard_normal(N_TEST)
    train.to_file(os.path.join(d, "train"))
    test.to_file(os.path.join(d, "test"))
    Phenotypes(y_train).to_file(os.path.join(d, "train.phen"))
    Phenotypes(y_test).to_file(os.path.join(d, "test.phen"))
    UniformGrouping(G, M).to_file(os.path.join(d, "train"))
    return train, y_train, y_test


def main():
    import torch

    # ---- phase 0
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
            k2_err = max(k2_err, check_close(act, out, ref))
            del out, ref
            ms = cuda_ms(lambda: PM.packed_linear(X.bytes, A, off, N_TRAIN, act))
            plain_ms = cuda_ms(lambda: PM.packed_linear_ref(X.bytes, A, off, N_TRAIN, act))
            print(f"  {act}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
            if act == "identity":  # the slice's activation
                k2_ms, k2_plain_ms = ms, plain_ms

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
            check_close("y_pred", y, y_ref),
            check_close("dW0", dws[0], dW0_ref),
            check_close("db0", dbs[0], dbs_ref[0]),
            check_close("dW1", dws[1], dws_ref[1]),
        )
        k4_ms = cuda_ms(lambda: BM.data_vg_packed("identity", xg, w_g, b_g, target))
        k4_plain_ms = cuda_ms(
            lambda: BM.data_vg_packed_ref("identity", xg.bytes, target, wf, bf, N_TRAIN))
        print(f"  kernel {k4_ms:.3f} ms, plain {k4_plain_ms:.3f} ms")

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
            "identity", PM.packed_linear(x_b.bytes, A_c, off_c, N_TRAIN, "identity"),
            PM.packed_linear_ref(x_b.bytes, A_c, off_c, N_TRAIN, "identity")))
        ms = cuda_ms(lambda: PM.packed_linear(x_b.bytes, A_c, off_c, N_TRAIN, "identity"))
        plain_ms = cuda_ms(lambda: PM.packed_linear_ref(x_b.bytes, A_c, off_c, N_TRAIN, "identity"))
        print(f"  identity: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        cpu = lambda ts: tuple(t.cpu() for t in ts)  # noqa: E731
        k2_err = max(k2_err, check_close(
            "predict_chains, card vs CPU plain version",
            D.predict_chains("identity", w_cb, b_cb, x_b).cpu(),
            D.predict_chains("identity", cpu(w_cb), cpu(b_cb),
                             D.PackedX(*cpu((x_b.bytes, x_b.w_scale, x_b.shift)), N_TRAIN))))
        del A_c, off_c, w_cb, b_cb

        k5_err, k5_ms, k5_plain_ms = 0.0, None, None
        for steps, tol in ((1, REL_TOL), (L, REL_TOL_TRAJ)):
            args = (x_b.bytes, x_b.w_scale, x_b.shift, targets, err, ws, bs, p_w, p_b,
                    eps_w, eps_b, lam_w, lam_b, steps, N_TRAIN)
            out = LF.integrate_chains_packed("identity", *args)
            ref = LF.integrate_chains_packed_ref("identity", *args)
            names = ("W0", "w_out", "b0", "pW0", "pw_out", "pb0")
            for name, got, want in zip(names, [t for o in out for t in o],
                                       [t for r in ref for t in r]):
                k5_err = max(k5_err, check_close(f"L={steps} {name}", got, want, tol))
            again = LF.integrate_chains_packed("identity", *args)
            if not all(torch.equal(a, b) for o, o2 in zip(out, again) for a, b in zip(o, o2)):
                raise AssertionError("K5: two calls with the same inputs differ")
            moved = (out[0][0] - ws[0]).abs().max().item()
            ms = cuda_ms(lambda: LF.integrate_chains_packed("identity", *args))
            plain_ms = cuda_ms(lambda: LF.integrate_chains_packed_ref("identity", *args))
            print(f"  L={steps}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, identical repeat, "
                  f"max |W0_L - W0_0| {moved:.3e}")
            k5_ms, k5_plain_ms = ms, plain_ms  # the main path's L
            del out, ref, again
        del X, state, x_b, targets

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
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = [
        {"name": "packed_linear", "route": "cuda",
         "source": "rs_bann_tpu_torch/csrc/packed_linear.cu",
         "replaces": "rs_bann_tpu/ops/packed_matmul.py:202",
         "launches": k2_hybrid, "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms},
        {"name": "data_vg_packed", "route": "cuda",
         "source": "rs_bann_tpu_torch/csrc/branch_vg_packed.cu",
         "replaces": "rs_bann_tpu/ops/branch_mlp.py:365",
         "launches": k4_launches, "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain_ms},
        {"name": "traj_packed", "route": "cuda",
         "source": "rs_bann_tpu_torch/csrc/traj_packed.cu",
         "replaces": "rs_bann_tpu/ops/leapfrog.py:470",
         "launches": k5_launches, "max_abs_err": k5_err, "ms": k5_ms, "plain_ms": k5_plain_ms},
    ]
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
