"""Command-line interface of the PyTorch port: ``train-new``, ``train``,
``predict``, ``gradients``, ``branch-r2``, ``activations``,
``population-effect-sizes`` and ``analyze``.

Counterpart of rs_bann_tpu/cli/main.py with the same arguments (the port's
own copies of the JAX package's argparse helpers, cli/args.py) and the same
run-directory naming, args.json, model samples and output files. Training
takes 2-bit packed genotypes (``--packed-genotypes``) or dense
feature-major ones (``--feat-major``) under every schedule: the folded
parallel or hybrid sweep on K6 and K7, the sequential one on K8a, the
unfolded hybrid one (``--per-chain-block-perm``) on K8b; it writes a
checkpoint with ``--checkpoint-interval`` and resumes one, bit for bit,
with ``--resume``. ``train`` continues from a saved sample. The
analysis commands take packed or dense genotypes and map the branches in
chunks (``Net._branch_map``: one K2, or K9a, launch per chunk on packed
ones). Options whose code paths wait for later slices of the port exit
non-zero with "not ported yet".

The device is CUDA unless ``--cpu`` is given; without a CUDA device and
without ``--cpu`` the commands exit non-zero. Every random draw comes from
one ``torch.Generator`` on that device, seeded from ``--seed``.
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
import os
import sys
from pathlib import Path

from .args import (
    ACTIVATIONS,
    add_bfile_phen_args,
    add_mcmc_args,
    add_train_io_args,
    mcmc_cfg_from_args,
    mode_suffixes,
    model_type,
    run_outdir_name,
    scan_models,
)

log = logging.getLogger("rs_bann_tpu_torch")


def _device(args):
    import torch

    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        sys.exit("error: no CUDA device found; pass --cpu to run on the CPU")
    return torch.device("cuda")


def set_replicate_ix(parent_dir, outdir_name) -> Path:
    """First free ``<outdir_name>_rep<k>`` directory under ``parent_dir``."""
    rep = 1
    while True:
        p = Path(parent_dir) / f"{outdir_name}_rep{rep}"
        if not p.exists():
            return p
        rep += 1


def _unported(args, cfg) -> list:
    """Options of ``args`` whose code paths are not ported yet."""
    from ..models.net import unported_options

    bad = unported_options(cfg)
    for flag in ("bf16", "x_bf16"):
        if getattr(args, flag):
            bad.append("--" + flag.replace("_", "-"))
    if not (args.packed_genotypes or args.feat_major):
        bad.append("dense sample-major genotypes (pass --packed-genotypes or --feat-major)")
    return bad


def _beyond_kernels(args, cfg, arch, device) -> list:
    """On a CUDA device a feature-major sweep runs every branch on K6/K7
    (folded) or K8 (sequential or unfolded), and a packed HMC sweep on K5
    (folded) or K4 (sequential or unfolded); a branch beyond their limits
    (depth above 1, a width above 32, too many markers for shared memory) is
    refused rather than run on the plain version. Packed gradient descent
    runs K2, K3 and K9 at any width. With ``--ss-markers`` the marker scan's
    kernel takes m_pad up to ops/marker_scan.MAX_M and a layer-0 width up
    to MAX_S. The CPU runs the plain versions at any shape."""
    from ..models.net import chain_fold_eligible
    from ..ops import branch_mlp as BM
    from ..ops import marker_scan as MS

    if device.type != "cuda" or (args.packed_genotypes and cfg.gradient_descent):
        return []
    bad = []
    if cfg.ss_markers and (arch.m_pad > MS.MAX_M or arch.layer_out_pad(0) > MS.MAX_S):
        bad.append(f"--ss-markers beyond the marker scan CUDA kernel's limits ({arch.m_pad} "
                   f"markers, width {arch.layer_out_pad(0)}; it takes up to {MS.MAX_M} markers "
                   f"and width {MS.MAX_S})")
    # train-new names the activation; train takes the saved model's
    act = getattr(args, "activation_function", None) or arch.activation
    folded = chain_fold_eligible(args.model_type, act, cfg)
    if args.feat_major:  # folded: K6 for the trajectories, K7 for the value passes
        rules, kernels = (((BM.traj_dense_smem, BM.vg_chains_smem), "K6/K7") if folded
                          else ((BM.vg_dense_smem,), "K8"))
        layout = "--feat-major"
    else:
        rules, kernels = (((BM.traj_packed_smem,), "K5") if folded
                          else ((BM.branch_vg_packed_smem,), "K4"))
        layout = "--packed-genotypes"
    widths = (arch.layer_out_pad(0), arch.s_pad)
    if all(rule(arch.m_pad, *widths, arch.depth) >= 0 for rule in rules):
        return bad
    return bad + [f"{layout} branches beyond the {kernels} CUDA kernels' limits (depth "
                  f"{arch.depth}, {arch.m_pad} markers, widths {widths[0]}/{widths[1]}; they take "
                  f"depth 0 or 1, widths up to 32 and 227 KB of shared memory)"]


def _load_train_data(args):
    from ..io import BedVM, ExternalGrouping, Phenotypes
    from ..io.genotypes import CompressedGenotypes, Data

    grouping = ExternalGrouping.from_file(args.groups)
    train = Data(
        CompressedGenotypes(BedVM.from_file(args.bfile_train), grouping),
        Phenotypes.from_file(args.p_train),
    )
    test = None
    if args.bfile_test and args.p_test:
        test = Data(
            CompressedGenotypes(BedVM.from_file(args.bfile_test), grouping),
            Phenotypes.from_file(args.p_test),
        )
    elif args.bfile_test or args.p_test:
        log.info("No complete test data provided, proceeding without")
    return train, test


def _refuse_arch(args, cfg, model_type: str, arch, device) -> None:
    """Exit where the architecture cannot run: ss_markers as the JAX
    package refuses it, or beyond the kernels (``_beyond_kernels``)."""
    from ..models.net import ssm_unsupported

    why = ssm_unsupported(model_type, arch) if cfg.ss_markers else None
    if why:  # as the JAX package refuses it
        sys.exit(f"error: {why}")
    bad = _beyond_kernels(args, cfg, arch, device)
    if bad:
        sys.exit("error: not ported yet: " + ", ".join(bad))


def _run_training(args, cfg, outdir, net, device, train_data, test_data) -> None:
    """The rest of train-new and train: the data on the device in the
    layout the flags ask for, a resume's checks (before anything is
    written), args.json, then training; prints the run directory."""
    import torch

    from ..train import initial_carry, read_checkpoint, train

    load = "to_feature_major" if args.feat_major else "to_packed"
    dtr = getattr(train_data, load)(net.arch, device)
    dte = getattr(test_data, load)(net.arch, device) if test_data is not None else None
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    if args.resume is not None:
        try:
            read_checkpoint(args.resume, initial_carry(net, dtr, cfg, args.fixed_param_precision),
                            device.type)
        except (OSError, ValueError) as e:
            sys.exit(f"error: --resume: {e}")
    os.makedirs(outdir, exist_ok=True)
    with open(cfg.args_path(), "w") as f:
        json.dump({k: v for k, v in vars(args).items() if k != "func"}, f, indent=2)
    log.info("Training net")
    train(
        net, dtr, cfg, gen, test_data=dte, report_interval=args.report_interval,
        fixed_param_precision=args.fixed_param_precision,
        checkpoint_interval=args.checkpoint_interval, resume_from=args.resume,
    )
    print(outdir)


def cmd_train_new(args):
    from ..models import NetArch
    from ..models import density as D
    from ..models.init import InitCfg, init_net
    from ..models.net import Net

    outdir = set_replicate_ix(args.outpath, run_outdir_name(args))
    cfg = mcmc_cfg_from_args(args, str(outdir))
    if args.packed_genotypes and args.feat_major:
        sys.exit("error: --feat-major and --packed-genotypes are mutually exclusive")
    bad = _unported(args, cfg)
    if bad:
        sys.exit("error: not ported yet: " + ", ".join(bad))
    device = _device(args)

    log.info("Loading data.")
    train_data, test_data = _load_train_data(args)
    hlwr = (
        ("fixed", args.fixed_hidden_layer_width)
        if args.fixed_hidden_layer_width is not None
        else ("fraction_of_input", args.relative_hidden_layer_width)
    )
    slwr = (
        ("fixed", args.fixed_summary_layer_width)
        if args.fixed_summary_layer_width is not None
        else ("fraction_of_hidden", args.relative_summary_layer_width)
    )
    log.info("Building net")
    arch = NetArch.from_width_rules(
        train_data.num_markers_per_branch(), args.branch_depth, hlwr, slwr,
        activation=args.activation_function,
    )
    _refuse_arch(args, cfg, args.model_type, arch, device)
    state, _ = init_net(
        arch, args.model_type,
        InitCfg(fixed_param_precision=args.fixed_param_precision, seed=args.seed),
        device=device,
    )
    hyper = D.Hyperparameters(args.dpk, args.dps, args.spk, args.sps, args.opk, args.ops)
    net = Net(args.model_type, arch, hyper, state)
    for g in range(arch.num_branches):
        if arch.num_params_branch(g) > train_data.num_individuals:
            log.warning(
                "Num params > num individuals in branch %d (with %d params, %d individuals)",
                g, arch.num_params_branch(g), train_data.num_individuals,
            )
    _run_training(args, cfg, outdir, net, device, train_data, test_data)


def cmd_train(args):
    """Continue training from a saved sample (the JAX package's ``train``):
    the sample's net, perturbed by ``--perturb-params`` /
    ``--perturb-precisions``, trained under the MCMC arguments into
    ``<model stem>_cl.._il.._<mode>_st.._dtheta.._dlambda..<suffixes>``."""
    from ..models.net import Net

    model_path = Path(args.model_file)
    if not model_path.is_file():
        log.error("Specified model: No such file found")
        sys.exit(66)
    name = (
        f"{model_path.stem}_cl{args.chain_length}_il{args.integration_length}"
        f"_{args.step_size_mode}_st{args.step_size}"
        f"_dtheta{args.perturb_params or 0.0}_dlambda{args.perturb_precisions or 0.0}"
    )
    outdir = set_replicate_ix(args.outpath, name + mode_suffixes(args))
    cfg = mcmc_cfg_from_args(args, str(outdir))
    if args.packed_genotypes and args.feat_major:
        sys.exit("error: --feat-major and --packed-genotypes are mutually exclusive")
    bad = _unported(args, cfg)
    if bad:
        sys.exit("error: not ported yet: " + ", ".join(bad))
    device = _device(args)
    log.info("Loading net")
    net = Net.load(str(model_path), device)
    net.perturb(args.perturb_params, args.perturb_precisions)
    _refuse_arch(args, cfg, net.model_type, net.arch, device)
    train_data, test_data = _load_train_data(args)
    _run_training(args, cfg, outdir, net, device, train_data, test_data)


def _genotypes(args):
    from ..io import BedVM, ExternalGrouping
    from ..io.genotypes import CompressedGenotypes

    return CompressedGenotypes(BedVM.from_file(args.bfile), ExternalGrouping.from_file(args.groups))


def _load_x(args, gen, arch, device):
    """The genotypes as the saved models' architecture stacks them: 2-bit
    packed with ``--packed-genotypes``, else dense sample-major."""
    load = gen.to_packed if args.packed_genotypes else gen.to_stacked
    return load(arch, device).X


def cmd_predict(args):
    device = _device(args)
    w = csv.writer(sys.stdout)
    for _, net, X in _each_model(args, device):
        w.writerow(net.predict(X).cpu().numpy().tolist())


def cmd_gradients(args):
    """Per-branch log-density gradients of each saved model, written to
    ``<model_path>/../gradients/<ix>.json`` in the JAX package's payload."""
    device = _device(args)
    y = _phenotypes(args, device)
    outdir = Path(args.model_path).parent / "gradients"
    outdir.mkdir(parents=True, exist_ok=True)
    for path, net, X in _each_model(args, device):
        payload = [
            {"wrt_weights": [g.tolist() for g in gw], "wrt_biases": [g.tolist() for g in gb]}
            for gw, gb in net.gradients(X, y)
        ]
        with open(outdir / f"{path.stem}.json", "w") as f:
            json.dump(payload, f)
    print(outdir)


def _each_model(args, device):
    """(model file, Net on ``device``, the genotypes as its architecture
    stacks them) for every sample in ``args.model_path``."""
    from ..models.net import Net

    gen = _genotypes(args)
    X = None
    for path in scan_models(args.model_path):
        net = Net.load(str(path), device)
        if X is None:
            X = _load_x(args, gen, net.arch, device)
        yield path, net, X


def _phenotypes(args, device):
    import torch

    from ..io import Phenotypes

    return torch.tensor(Phenotypes.from_file(args.phen).y, dtype=torch.float32, device=device)


def cmd_branch_r2(args):
    """Each branch's r2 alone, one CSV row per saved model, to standard
    output."""
    device = _device(args)
    y = _phenotypes(args, device)
    w = csv.writer(sys.stdout)
    for _, net, X in _each_model(args, device):
        w.writerow(net.branch_r2s(X, y).cpu().numpy().tolist())


def cmd_activations(args):
    """Every branch's activations of each saved model, true widths only, to
    ``<model_path>/../activations/<ix>.json``."""
    device = _device(args)
    outdir = Path(args.model_path).parent / "activations"
    outdir.mkdir(parents=True, exist_ok=True)
    for path, net, X in _each_model(args, device):
        payload = [
            [a[:, : net.arch.layer_widths(g)[l]].tolist() for l, a in enumerate(branch)]
            for g, branch in enumerate(net.activations(X))
        ]
        with open(outdir / f"{path.stem}.json", "w") as f:
            json.dump(payload, f)
    print(outdir)


def cmd_population_effect_sizes(args):
    """Each true marker's mean input gradient over the individuals, per
    saved model, to ``<model_path>/../population_effect_sizes/<ix>.json``."""
    device = _device(args)
    _phenotypes(args, device)  # read as the JAX package does, though unused
    outdir = Path(args.model_path).parent / "population_effect_sizes"
    outdir.mkdir(parents=True, exist_ok=True)
    for path, net, X in _each_model(args, device):
        with open(outdir / f"{path.stem}.json", "w") as f:
            json.dump(net.population_effect_sizes(X), f)
    print(outdir)


def cmd_analyze(args):
    """Summarize a training run as JSON on standard output: the JAX
    package's ``analyze`` (acceptance, final mse and lpd, inclusion
    probabilities, each branch's median parameter ESS from the trace, the
    posterior mean against a simulation's truth). Its plots are not ported
    yet."""
    import numpy as np

    from .. import vis

    if args.plots:
        sys.exit("error: not ported yet: analyze --plots")
    st = vis.load_training_stats(args.rundir)
    out = {
        "iterations": len(st["mse_train"]) - 1,
        "acceptance_rate": round(st["num_accepted"] / max(st["num_samples"], 1), 3),
        "early_rejection_rate": round(st["num_early_rejected"] / max(st["num_samples"], 1), 3),
        "mse_train_final": round(st["mse_train"][-1], 4),
        "lpd_final": round(st["lpd"][-1], 2),
    }
    if st.get("mse_test"):
        out["mse_test_final"] = round(st["mse_test"][-1], 4)
    ip_path = os.path.join(args.rundir, "inclusion_probs")
    if os.path.exists(ip_path):
        with open(ip_path) as f:
            rec = json.load(f)
        if "pi" in rec:
            out["inclusion_pi"] = round(rec["pi"], 3)
            out["branch_inclusion_probs"] = [round(p, 3) for p in rec["pip"]]
        if "pi_markers" in rec:
            out["marker_inclusion_pi"] = round(rec["pi_markers"], 4)
            out["markers_pip_gt_half"] = sum(
                1 for row in rec["pip_markers"] for p in row if p > 0.5)
    if os.path.exists(os.path.join(args.rundir, "trace")):
        trace = vis.load_trace(args.rundir)
        burn = args.burn_in if args.burn_in is not None else len(trace) // 2
        mats = [vis.trace_param_matrix(trace, g) for g in range(len(trace[0]))]
        out["median_param_ess_per_branch"] = [
            round(float(np.median(vis.ess_per_param(m[burn:]))), 1) for m in mats]
        if args.sim:
            tp = vis.load_true_params(args.sim)
            out["posterior_mean_vs_truth"] = {
                str(k): {kk: round(vv, 4) for kk, vv in v.items()}
                for k, v in vis.posterior_mean_vs_truth(trace, tp, burn).items()
            }
    print(json.dumps(out, indent=2))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rs-bann-tpu-torch",
        description="Bayesian branch networks for genomic prediction (PyTorch/CUDA)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("train-new", help="Train new model on .bed data.")
    add_train_io_args(g)
    g.add_argument("model_type", type=model_type)
    g.add_argument("activation_function", choices=ACTIVATIONS)
    g.add_argument("branch_depth", type=int)
    g.add_argument("--relative-hidden-layer-width", type=float, default=0.5)
    g.add_argument("--fixed-hidden-layer-width", type=int, default=None)
    g.add_argument("--relative-summary-layer-width", type=float, default=1.0)
    g.add_argument("--fixed-summary-layer-width", type=int, default=None)
    g.add_argument("--dpk", type=float, default=0.001)
    g.add_argument("--dps", type=float, default=1000.0)
    g.add_argument("--spk", type=float, default=0.001)
    g.add_argument("--sps", type=float, default=1000.0)
    g.add_argument("--opk", type=float, default=0.001)
    g.add_argument("--ops", type=float, default=1000.0)
    add_mcmc_args(g)
    g.set_defaults(func=cmd_train_new)

    g = sub.add_parser("train", help="Continue training a saved model.")
    add_train_io_args(g)
    g.add_argument("model_type", type=model_type)
    g.add_argument("model_file")
    g.add_argument("--perturb-params", type=float, default=None)
    g.add_argument("--perturb-precisions", type=float, default=None)
    add_mcmc_args(g)
    g.set_defaults(func=cmd_train)

    g = sub.add_parser("predict", help="Predict phenotypes with saved models.")
    g.add_argument("bfile")
    g.add_argument("groups")
    g.add_argument("-m", "--model-path", default="./models")
    g.add_argument("--cpu", action="store_true", help="run on the CPU")
    g.add_argument(
        "--packed-genotypes", action="store_true",
        help="keep genotypes 2-bit packed on the device (else dense sample-major f32)",
    )
    g.set_defaults(func=cmd_predict)

    g = sub.add_parser("branch-r2", help="Per-branch r2 for each saved model.")
    add_bfile_phen_args(g)
    g.set_defaults(func=cmd_branch_r2)

    g = sub.add_parser("activations", help="Node activations of saved models.")
    g.add_argument("bfile")
    g.add_argument("groups")
    g.add_argument("-m", "--model-path", default="./models")
    g.add_argument("--cpu", action="store_true", help="run on the CPU")
    g.add_argument(
        "--packed-genotypes", action="store_true",
        help="keep genotypes 2-bit packed on the device (else dense sample-major f32)",
    )
    g.set_defaults(func=cmd_activations)

    g = sub.add_parser("gradients", help="Log-density gradients of saved models.")
    add_bfile_phen_args(g)
    g.set_defaults(func=cmd_gradients)

    g = sub.add_parser("population-effect-sizes",
                       help="Population mean marker effect sizes per saved model.")
    add_bfile_phen_args(g)
    g.set_defaults(func=cmd_population_effect_sizes)

    g = sub.add_parser("analyze", help="Summarize a training run (stats, ESS, truth recovery).")
    g.add_argument("rundir")
    g.add_argument("--sim", default=None, help="sim outdir with model.params")
    g.add_argument("--burn-in", type=int, default=None)
    g.add_argument("--plots", default=None, help="write PNG plots here (not ported yet)")
    g.set_defaults(func=cmd_analyze)
    return p


def main(argv=None):
    import torch

    # f32 throughout: accept-ratio value passes must not round through TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = build_parser().parse_args(argv)
    level = logging.DEBUG if getattr(args, "debug_prints", False) else logging.INFO
    logging.basicConfig(level=level, format="%(asctime)s %(levelname)s [%(name)s] %(message)s")
    args.func(args)


if __name__ == "__main__":
    main()
