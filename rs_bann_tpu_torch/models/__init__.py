"""Branch networks: state, densities, initialization, data and the sweep."""

from .arch import NetArch

__all__ = ["NetArch"]
