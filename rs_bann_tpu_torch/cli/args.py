"""The command-line arguments the port shares with the JAX package.

The port's own copy of the argparse helpers of rs_bann_tpu/cli/main.py
(``_add_mcmc_args``, ``_add_train_io_args``, ``_mcmc_cfg_from_args``,
``_mode_suffixes``, ``_run_outdir_name``, ``_scan_models`` and the analysis
commands' ``bpgm``), with every flag name and default
kept, so ``args.json``, run directories and ``hyperparams`` files come out
as the JAX package writes them (tests/test_torch_copies.py compares the two
parsers).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from ..samplers.mcmc_cfg import STEP_SIZE_MODES, MCMCCfg

MODEL_TYPES = {
    "ridge-base": "ridge_base",
    "ridge-ard": "ridge_ard",
    "lasso-base": "lasso_base",
    "lasso-ard": "lasso_ard",
    "std-normal": "std_normal",
    "linear": "linear",
    "ridge_base": "ridge_base",
    "ridge_ard": "ridge_ard",
    "lasso_base": "lasso_base",
    "lasso_ard": "lasso_ard",
    "std_normal": "std_normal",
}

ACTIVATIONS = ["tanh", "relu", "leaky_relu", "silu", "identity"]


def model_type(s: str) -> str:
    if s not in MODEL_TYPES:
        raise argparse.ArgumentTypeError(
            f"unknown model type {s!r}; choose from {sorted(set(MODEL_TYPES))}")
    return MODEL_TYPES[s]


def add_mcmc_args(p: argparse.ArgumentParser):
    """The MCMC arguments of ``train-new`` and ``train``."""
    p.add_argument("chain_length", type=int, help="full model chain length")
    p.add_argument("integration_length", type=int, help="hmc integration length")
    p.add_argument("--max-hamiltonian-error", type=float, default=10.0)
    p.add_argument("--step-size", type=float, default=1.0)
    p.add_argument("--report-interval", type=int, default=1)
    p.add_argument("--fixed-param-precision", type=float, default=None)
    p.add_argument("--step-size-mode", choices=list(STEP_SIZE_MODES), default="izmailov")
    p.add_argument("-d", "--debug-prints", action="store_true")
    p.add_argument("--trace", action="store_true")
    p.add_argument("--trajectories", action="store_true")
    p.add_argument("--num-grad-traj", action="store_true")
    p.add_argument("--num-grad", action="store_true")
    p.add_argument("--gradient-descent", action="store_true")
    p.add_argument("--gradient-descent-joint", action="store_true")
    p.add_argument("--burn-in", type=int, default=None)
    p.add_argument("-j", "--joint-hmc", action="store_true")
    p.add_argument("--sampled-output-bias", action="store_true")
    p.add_argument("--effect-sizes", action="store_true")
    p.add_argument("--num-chains", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--update-mode", choices=["sequential", "parallel", "hybrid"],
                   default="sequential")
    p.add_argument("--block-size", type=int, default=0,
                   help="hybrid mode: branches per parallel block")
    p.add_argument("--lam-e-floor", type=float, default=0.01,
                   help="divergence guard: floor the error precision at this / var(y) "
                   "(0 disables)")
    p.add_argument("--lam-row-floor", type=float, default=1e-6,
                   help="divergence guard: floor local weight precisions (0 disables)")
    p.add_argument("--per-chain-block-perm", action="store_true",
                   help="hybrid mode: draw each chain's block permutation on its own "
                   "(the chains then cannot share one trajectory call)")
    p.add_argument("--gd-warmup", type=int, default=0,
                   help="gradient-descent sweeps before sampling")
    p.add_argument("--mass-adaptation", action="store_true",
                   help="adapt a diagonal mass matrix during burn-in")
    p.add_argument("--traj-length-mode", choices=["fixed", "jittered", "uturn"],
                   default="fixed", help="dynamic trajectory lengths")
    p.add_argument("--spike-slab", action="store_true",
                   help="spike-and-slab branch selection")
    p.add_argument("--ss-pi", type=float, default=0.5,
                   help="prior inclusion probability")
    p.add_argument("--ss-fixed-pi", action="store_true",
                   help="keep the inclusion probability fixed at --ss-pi")
    p.add_argument("--ss-warmup", type=int, default=-1,
                   help="force all branches included for the first N sweeps "
                   "(-1 = half the burn-in)")
    p.add_argument("--ss-markers", action="store_true",
                   help="per-marker spike-and-slab")
    p.add_argument("--ssm-pi", type=float, default=0.5,
                   help="prior marker-inclusion probability")
    p.add_argument("--ssm-fixed-pi", action="store_true")
    p.add_argument("--ssm-warmup", type=int, default=0,
                   help="force all markers included for the first N sweeps")
    p.add_argument("--ss-rows", action="store_true",
                   help="per-marker selection for nonlinear branches")
    p.add_argument("--ssr-pi", type=float, default=0.5,
                   help="prior row-inclusion probability")
    p.add_argument("--ssr-fixed-pi", action="store_true")
    p.add_argument("--ssr-spike", type=float, default=1e4,
                   help="spike (excluded-row) precision")
    p.add_argument("--ssr-warmup", type=int, default=0,
                   help="force all rows on the slab for the first N sweeps")
    p.add_argument("--ssr-shape", type=float, default=1.0,
                   help="slab Gamma shape for layer-0 rows under --ss-rows")
    p.add_argument("--ssr-scale", type=float, default=1.0,
                   help="slab Gamma scale for layer-0 rows under --ss-rows")
    p.add_argument("--tempering", action="store_true",
                   help="parallel tempering over the chain axis")
    p.add_argument("--max-temperature", type=float, default=4.0,
                   help="hottest tempering slot's temperature (1/beta)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 matmul inputs (f32 accumulation)")
    p.add_argument("--checkpoint-interval", type=int, default=0,
                   help="write <run>/checkpoint.npz every N iterations")
    p.add_argument("--resume", default=None,
                   help="resume exactly from a checkpoint.npz")
    p.add_argument("--packed-genotypes", action="store_true",
                   help="keep genotypes 2-bit packed on the device, decoded inside the kernels")
    p.add_argument("--feat-major", action="store_true",
                   help="feature-major dense genotypes [G, m_pad, n] (mutually exclusive "
                   "with --packed-genotypes)")
    p.add_argument("--x-bf16", action="store_true",
                   help="store feature-major genotypes in bfloat16 (requires --feat-major)")


def add_bfile_phen_args(p: argparse.ArgumentParser):
    """The arguments of ``branch-r2``, ``gradients`` and
    ``population-effect-sizes``: genotypes, phenotypes, groups, models."""
    p.add_argument("bfile")
    p.add_argument("phen")
    p.add_argument("groups")
    p.add_argument("-m", "--model-path", default="./models")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument(
        "--packed-genotypes", action="store_true",
        help="keep genotypes 2-bit packed on the device (else dense sample-major f32)",
    )


def add_train_io_args(p: argparse.ArgumentParser):
    p.add_argument("bfile_train", help="stem of train .bed(+.bim+.fam|.dims)")
    p.add_argument("p_train", help="train phenotype .phen file")
    p.add_argument("groups", help="path to grouping file")
    p.add_argument("--bfile-test", default=None)
    p.add_argument("--p-test", default=None)
    p.add_argument("-o", "--outpath", default="./")


def mcmc_cfg_from_args(args, outpath: str) -> MCMCCfg:
    return MCMCCfg(
        hmc_step_size_factor=args.step_size,
        hmc_max_hamiltonian_error=args.max_hamiltonian_error,
        hmc_integration_length=args.integration_length,
        hmc_step_size_mode=args.step_size_mode,
        chain_length=args.chain_length,
        burn_in=args.burn_in if args.burn_in is not None else -1,
        outpath=outpath,
        trace=args.trace,
        trajectories=args.trajectories,
        num_grad_traj=args.num_grad_traj,
        num_grad=args.num_grad,
        gradient_descent=args.gradient_descent,
        gradient_descent_joint=args.gradient_descent_joint,
        joint_hmc=args.joint_hmc,
        fixed_param_precisions=args.fixed_param_precision is not None,
        sampled_output_bias=args.sampled_output_bias,
        effect_sizes=args.effect_sizes,
        num_chains=args.num_chains,
        seed=args.seed,
        update_mode=args.update_mode,
        block_size=args.block_size,
        lam_e_floor=args.lam_e_floor,
        lam_row_floor=args.lam_row_floor,
        hybrid_shared_perm=not args.per_chain_block_perm,
        gd_warmup=args.gd_warmup,
        mass_adaptation=args.mass_adaptation,
        tempering=args.tempering,
        max_temperature=args.max_temperature,
        hmc_traj_length_mode=args.traj_length_mode,
        spike_slab=args.spike_slab,
        ss_pi=args.ss_pi,
        ss_update_pi=not args.ss_fixed_pi,
        ss_warmup=args.ss_warmup,
        ss_markers=args.ss_markers,
        ssm_pi=args.ssm_pi,
        ssm_fixed_pi=args.ssm_fixed_pi,
        ssm_warmup=args.ssm_warmup,
        ss_rows=args.ss_rows,
        ssr_pi=args.ssr_pi,
        ssr_fixed_pi=args.ssr_fixed_pi,
        ssr_spike=args.ssr_spike,
        ssr_warmup=args.ssr_warmup,
        ssr_shape=args.ssr_shape,
        ssr_scale=args.ssr_scale,
    )


def mode_suffixes(args) -> str:
    """Sampler-mode suffix of the run directory name."""
    name = ""
    if args.joint_hmc:
        name += "_joint"
    if args.mass_adaptation:
        name += "_mass"
    if args.traj_length_mode != "fixed":
        name += f"_{args.traj_length_mode}"
    if args.spike_slab:
        name += "_ss"
    if args.ss_markers:
        name += "_ssm"
    if args.ss_rows:
        name += "_ssr"
    if args.tempering:
        name += f"_pt{args.max_temperature}"
    if args.gradient_descent:
        name += "_gd"
    if args.gradient_descent_joint:
        name += "_gdj"
    if args.fixed_param_precision is not None:
        name += f"_fp{args.fixed_param_precision}"
    return name


def run_outdir_name(args) -> str:
    """train-new's run directory name: the hyperparameter set."""
    name = (
        f"{args.model_type}_{args.activation_function}_d{args.branch_depth}"
        f"_cl{args.chain_length}_il{args.integration_length}"
        f"_{args.step_size_mode}_st{args.step_size}"
        f"_dpk{args.dpk}_dps{args.dps}_spk{args.spk}_sps{args.sps}"
        f"_opk{args.opk}_ops{args.ops}"
    )
    name += mode_suffixes(args)
    if args.fixed_hidden_layer_width is not None:
        name += f"_fhlw{args.fixed_hidden_layer_width}"
    else:
        name += f"_rhlw{args.relative_hidden_layer_width}"
    if args.fixed_summary_layer_width is not None:
        name += f"_fslw{args.fixed_summary_layer_width}"
    else:
        name += f"_rslw{args.relative_summary_layer_width}"
    return name


def scan_models(model_path):
    """Sorted ``<ix>.npz`` model sample files; exits on an empty directory."""
    p = Path(model_path)
    if not p.is_dir():
        sys.exit(f"error: model path is not a directory: {p}")
    files = [q for q in p.iterdir() if q.is_file() and q.suffix == ".npz"]
    if not files:
        hint = f" (did you mean {p / 'models'}?)" if (p / "models").is_dir() else ""
        sys.exit(f"error: no <ix>.npz model samples found in {p}{hint}")
    return sorted(files, key=lambda q: int(q.stem))
