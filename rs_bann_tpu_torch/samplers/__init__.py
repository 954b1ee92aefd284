"""Gibbs draws and HMC transitions."""

from .mcmc_cfg import MCMCCfg

__all__ = ["MCMCCfg"]
