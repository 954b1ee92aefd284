"""MCMC configuration.

The port's own copy of rs_bann_tpu/samplers/mcmc_cfg.py ``MCMCCfg``: the
same fields, defaults and checks, so an ``args.json`` or a configuration
built from one CLI means the same to both packages
(tests/test_torch_copies.py holds the two together). Settings whose code
paths the port has not reached yet are refused by
``models/net.unported_options``, not here.
"""

from __future__ import annotations

import dataclasses
import os

STEP_SIZE_MODES = ("uniform", "random", "std_scaled", "izmailov", "dual_averaging")


@dataclasses.dataclass(frozen=True)
class MCMCCfg:
    hmc_step_size_factor: float = 1.0
    hmc_max_hamiltonian_error: float = 10.0
    hmc_integration_length: int = 100
    hmc_step_size_mode: str = "izmailov"
    chain_length: int = 100
    burn_in: int = -1  # -1 -> chain_length - 1
    outpath: str = "./"
    trace: bool = False
    trajectories: bool = False
    num_grad_traj: bool = False
    num_grad: bool = False
    gradient_descent: bool = False
    gradient_descent_joint: bool = False
    joint_hmc: bool = False
    fixed_param_precisions: bool = False
    sampled_output_bias: bool = False
    effect_sizes: bool = False
    num_chains: int = 1
    seed: int = 0
    target_accept: float = 0.8  # dual-averaging adaptation target
    sweeps_per_call: int = 0
    # "sequential" (random-scan Gibbs over the branches), "parallel" (every
    # branch proposes against one residual snapshot per sweep) or "hybrid"
    # (sequential over random blocks of block_size branches, parallel
    # within a block)
    update_mode: str = "sequential"
    block_size: int = 0  # hybrid: branches per block (0: default_block_size)
    # hybrid: the per-sweep block permutation is drawn from (seed, sweep) and
    # shared by every chain, which lets one trajectory call serve all chains
    hybrid_shared_perm: bool = True
    ss_rows: bool = False  # per-marker row mixture for nonlinear branches
    ssr_pi: float = 0.5
    ssr_fixed_pi: bool = False
    ssr_spike: float = 1e4
    ssr_warmup: int = 0
    ssr_shape: float = 1.0
    ssr_scale: float = 1.0
    # divergence guards: the error precision is floored at lam_e_floor /
    # var(y), the local weight precisions at lam_row_floor (bias precisions
    # are exempt); healthy chains never reach either floor; 0 disables
    lam_e_floor: float = 0.01
    lam_row_floor: float = 0.01
    # parallel / hybrid: trajectories against the frozen snapshot residual,
    # Metropolis accepts one by one against the live residual (an exact
    # Metropolis-within-Gibbs kernel)
    live_accept: bool = True
    gd_warmup: int = 0
    mass_adaptation: bool = False
    hmc_traj_length_mode: str = "fixed"  # "fixed", "jittered" or "uturn"
    spike_slab: bool = False  # branch-level spike-and-slab
    ss_pi: float = 0.5
    ss_update_pi: bool = True
    ss_warmup: int = -1  # -1 -> half the burn-in
    ss_markers: bool = False  # per-marker spike-and-slab
    ssm_pi: float = 0.5
    ssm_fixed_pi: bool = False
    ssm_warmup: int = 0
    tempering: bool = False  # parallel tempering across the chain axis
    max_temperature: float = 4.0

    def __post_init__(self):
        if self.burn_in < 0:
            object.__setattr__(self, "burn_in", max(self.chain_length - 1, 0))
        marginal = not (self.joint_hmc or self.gradient_descent or self.gradient_descent_joint)
        checks = [
            (self.hmc_step_size_mode in STEP_SIZE_MODES,
             f"unknown step size mode {self.hmc_step_size_mode}"),
            (self.update_mode in ("sequential", "parallel", "hybrid"),
             f"unknown update mode {self.update_mode}"),
            (self.hmc_traj_length_mode in ("fixed", "jittered", "uturn"),
             f"unknown trajectory length mode {self.hmc_traj_length_mode}"),
            (not self.fixed_param_precisions
             or not (self.joint_hmc or self.gradient_descent_joint),
             "fixed precisions and joint hmc / gd are mutually exclusive"),
            (not self.tempering or self.num_chains >= 2,
             "tempering needs num_chains >= 2 (one slot per temperature)"),
            (not self.tempering or self.max_temperature > 1.0, "max_temperature must be > 1"),
            (not self.tempering or marginal, "tempering applies to marginal HMC only"),
            (not self.spike_slab or marginal, "spike_slab applies to marginal HMC only"),
            (not self.spike_slab or 0.0 < self.ss_pi < 1.0, "ss_pi must be in (0, 1)"),
            (not self.ss_markers or marginal, "ss_markers applies to marginal HMC only"),
            (not self.ss_markers or 0.0 < self.ssm_pi < 1.0, "ssm_pi must be in (0, 1)"),
            (self.hmc_traj_length_mode == "fixed" or marginal,
             "dynamic trajectory lengths apply to marginal HMC only"),
            # izmailov sets eps ~ 1/L, which pins the u-turn at ~2L steps
            (self.hmc_traj_length_mode != "uturn" or self.hmc_step_size_mode != "izmailov",
             "uturn trajectory-length adaptation needs a length-independent step size"),
            (not self.mass_adaptation or not (self.joint_hmc or self.gradient_descent_joint),
             "mass adaptation applies to marginal HMC only"),
            (not self.mass_adaptation
             or self.hmc_step_size_mode in ("izmailov", "std_scaled", "dual_averaging"),
             "mass adaptation needs a precision-shaped step-size mode"),
        ]
        for ok, msg in checks:
            if not ok:
                raise ValueError(msg)
        if self.spike_slab and self.ss_warmup < 0:
            object.__setattr__(self, "ss_warmup", self.burn_in // 2)

    # ---- output paths
    def hyperparam_path(self):
        return os.path.join(self.outpath, "hyperparams")

    def trace_path(self):
        return os.path.join(self.outpath, "trace")

    def trajectories_path(self):
        return os.path.join(self.outpath, "traj")

    def args_path(self):
        return os.path.join(self.outpath, "args.json")

    def models_path(self):
        return os.path.join(self.outpath, "models")

    def effect_sizes_path(self):
        return os.path.join(self.outpath, "effect_sizes")
