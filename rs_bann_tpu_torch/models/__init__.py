"""Branch networks: state, densities, initialization, data and the sweep.

The static architecture (``NetArch``) is the JAX package's numpy-only
description, shared by import.
"""

from rs_bann_tpu.models.arch import NetArch

__all__ = ["NetArch"]
