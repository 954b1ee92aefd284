"""Gibbs draws and HMC transitions.

The sampler configuration (``MCMCCfg``) is the JAX package's plain
dataclass, shared by import.
"""

from rs_bann_tpu.samplers.mcmc_cfg import MCMCCfg

__all__ = ["MCMCCfg"]
