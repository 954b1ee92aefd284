"""Genotype, phenotype and grouping I/O.

The readers and writers are the JAX package's numpy-only modules, shared by
import so both packages read and write the same files; ``genotypes`` builds
the port's device tensors from them.
"""

from rs_bann_tpu.group.grouping import ExternalGrouping, MarkerGrouping, UniformGrouping
from rs_bann_tpu.io.bed import BedVM
from rs_bann_tpu.io.phen import Phenotypes

__all__ = ["BedVM", "ExternalGrouping", "MarkerGrouping", "Phenotypes", "UniformGrouping"]
