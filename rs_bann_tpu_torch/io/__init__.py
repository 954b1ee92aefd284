"""Genotype, phenotype and grouping I/O.

The readers and writers are the port's own copies of the JAX package's
(``bed``, ``dims``, ``phen`` and ``group/grouping.py``), so both packages
read and write the same files; ``genotypes`` builds the port's device
tensors from them.
"""

from ..group.grouping import ExternalGrouping, MarkerGrouping, UniformGrouping
from .bed import BedVM
from .phen import Phenotypes

__all__ = ["BedVM", "ExternalGrouping", "MarkerGrouping", "Phenotypes", "UniformGrouping"]
