"""Command-line interface of the PyTorch port: ``train-new``, ``predict`` and
``gradients``.

Counterpart of rs_bann_tpu/cli/main.py with the same arguments (the port's
own copies of the JAX package's argparse helpers, cli/args.py) and the same
run-directory naming, args.json, model samples and predict CSV. Training
takes 2-bit packed genotypes (``--packed-genotypes``) or dense
feature-major ones (``--feat-major``) under every schedule: the folded
parallel or hybrid sweep on K6 and K7, the sequential one on K8a, the
unfolded hybrid one (``--per-chain-block-perm``) on K8b. ``predict`` and
``gradients`` take packed or dense genotypes. Options whose
code paths wait for later slices of the port exit non-zero with "not ported
yet".

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
    add_mcmc_args,
    add_train_io_args,
    mcmc_cfg_from_args,
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
    if args.checkpoint_interval > 0:
        bad.append("--checkpoint-interval")
    if args.resume is not None:
        bad.append("--resume")
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
    folded = chain_fold_eligible(args.model_type, args.activation_function, cfg)
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


def cmd_train_new(args):
    import torch

    from ..models import NetArch
    from ..models import density as D
    from ..models.init import InitCfg, init_net
    from ..models.net import Net, ssm_unsupported
    from ..train import train

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
    why = ssm_unsupported(args.model_type, arch) if cfg.ss_markers else None
    if why:  # as the JAX package refuses it
        sys.exit(f"error: {why}")
    bad = _beyond_kernels(args, cfg, arch, device)
    if bad:
        sys.exit("error: not ported yet: " + ", ".join(bad))
    os.makedirs(outdir, exist_ok=True)
    with open(cfg.args_path(), "w") as f:
        json.dump({k: v for k, v in vars(args).items() if k != "func"}, f, indent=2)
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
    load = "to_feature_major" if args.feat_major else "to_packed"
    dtr = getattr(train_data, load)(arch, device)
    dte = getattr(test_data, load)(arch, device) if test_data is not None else None
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    log.info("Training net")
    train(
        net, dtr, cfg, gen, test_data=dte, report_interval=args.report_interval,
        fixed_param_precision=args.fixed_param_precision,
    )
    print(outdir)


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
    from ..models.net import Net

    device = _device(args)
    gen = _genotypes(args)
    w = csv.writer(sys.stdout)
    X = None
    for path in scan_models(args.model_path):
        net = Net.load(str(path), device)
        if X is None:
            X = _load_x(args, gen, net.arch, device)
        w.writerow(net.predict(X).cpu().numpy().tolist())


def cmd_gradients(args):
    """Per-branch log-density gradients of each saved model, written to
    ``<model_path>/../gradients/<ix>.json`` in the JAX package's payload."""
    import torch

    from ..io import Phenotypes
    from ..models.net import Net

    device = _device(args)
    gen = _genotypes(args)
    y = torch.tensor(Phenotypes.from_file(args.phen).y, dtype=torch.float32, device=device)
    outdir = Path(args.model_path).parent / "gradients"
    outdir.mkdir(parents=True, exist_ok=True)
    X = None
    for path in scan_models(args.model_path):
        net = Net.load(str(path), device)
        if X is None:
            X = _load_x(args, gen, net.arch, device)
        payload = [
            {"wrt_weights": [g.tolist() for g in gw], "wrt_biases": [g.tolist() for g in gb]}
            for gw, gb in net.gradients(X, y)
        ]
        with open(outdir / f"{path.stem}.json", "w") as f:
            json.dump(payload, f)
    print(outdir)


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

    g = sub.add_parser("gradients", help="Log-density gradients of saved models.")
    g.add_argument("bfile")
    g.add_argument("phen")
    g.add_argument("groups")
    g.add_argument("-m", "--model-path", default="./models")
    g.add_argument("--cpu", action="store_true", help="run on the CPU")
    g.add_argument(
        "--packed-genotypes", action="store_true",
        help="keep genotypes 2-bit packed on the device (else dense sample-major f32)",
    )
    g.set_defaults(func=cmd_gradients)
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
