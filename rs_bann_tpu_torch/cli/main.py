"""Command-line interface of the PyTorch port: ``train-new`` and ``predict``.

Counterpart of rs_bann_tpu/cli/main.py with the same arguments (the argparse
helpers are the JAX package's, shared by import) and the same run-directory
naming, args.json, model samples and predict CSV. Options whose code paths
wait for later slices of the port exit non-zero with "not ported yet".

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

from rs_bann_tpu.cli.main import (
    ACTIVATIONS,
    _add_mcmc_args,
    _add_train_io_args,
    _mcmc_cfg_from_args,
    _model_type,
    _run_outdir_name,
    _scan_models,
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
    for flag in ("feat_major", "bf16", "x_bf16"):
        if getattr(args, flag):
            bad.append("--" + flag.replace("_", "-"))
    if args.checkpoint_interval > 0:
        bad.append("--checkpoint-interval")
    if args.resume is not None:
        bad.append("--resume")
    if not args.packed_genotypes:
        bad.append("dense genotypes (pass --packed-genotypes)")
    elif args.activation_function == "silu":
        bad.append("silu on --packed-genotypes (needs the unfused packed kernel K9)")
    return bad


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
    from ..models.net import Net
    from ..train import train

    outdir = set_replicate_ix(args.outpath, _run_outdir_name(args))
    cfg = _mcmc_cfg_from_args(args, str(outdir))
    bad = _unported(args, cfg)
    if bad:
        sys.exit("error: not ported yet: " + ", ".join(bad))
    device = _device(args)

    log.info("Loading data.")
    train_data, test_data = _load_train_data(args)
    os.makedirs(outdir, exist_ok=True)
    with open(cfg.args_path(), "w") as f:
        json.dump({k: v for k, v in vars(args).items() if k != "func"}, f, indent=2)

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
    dtr = train_data.to_packed(arch, device)
    dte = test_data.to_packed(arch, device) if test_data is not None else None
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    log.info("Training net")
    train(
        net, dtr, cfg, gen, test_data=dte, report_interval=args.report_interval,
        fixed_param_precision=args.fixed_param_precision,
    )
    print(outdir)


def cmd_predict(args):
    from ..io import BedVM, ExternalGrouping
    from ..io.genotypes import CompressedGenotypes
    from ..models.net import Net

    if not args.packed_genotypes:
        sys.exit("error: not ported yet: dense genotypes (pass --packed-genotypes)")
    device = _device(args)
    gen = CompressedGenotypes(
        BedVM.from_file(args.bfile), ExternalGrouping.from_file(args.groups)
    )
    w = csv.writer(sys.stdout)
    X = None
    for path in _scan_models(args.model_path):
        net = Net.load(str(path), device)
        if X is None:
            X = gen.to_packed(net.arch, device).X
        w.writerow(net.predict(X).cpu().numpy().tolist())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rs-bann-tpu-torch",
        description="Bayesian branch networks for genomic prediction (PyTorch/CUDA)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("train-new", help="Train new model on .bed data.")
    _add_train_io_args(g)
    g.add_argument("model_type", type=_model_type)
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
    _add_mcmc_args(g)
    g.set_defaults(func=cmd_train_new)

    g = sub.add_parser("predict", help="Predict phenotypes with saved models.")
    g.add_argument("bfile")
    g.add_argument("groups")
    g.add_argument("-m", "--model-path", default="./models")
    g.add_argument("--cpu", action="store_true", help="run on the CPU")
    g.add_argument(
        "--packed-genotypes", action="store_true",
        help="keep genotypes 2-bit packed on the device (the port's only form)",
    )
    g.set_defaults(func=cmd_predict)
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
