"""HMC framework for the two-flavor Schwinger model.

A from-scratch JAX/XLA re-design of the capabilities of the C++/MPI
reference (Fabian2598/SchwingerModel): 2D U(1) lattice gauge theory with two
degenerate flavors of Wilson fermions, pseudofermions, conjugate-gradient
inversion of DD+, leapfrog molecular dynamics, Metropolis accept/reject,
plaquette / gauge-action / chiral-condensate observables with jackknife
errors, and byte-compatible binary gauge-configuration I/O.

Design: the gauge field is stored as real link *angles* theta (U = e^{i theta})
so that the leapfrog link update is an addition and unitarity is exact in any
floating-point precision; the Wilson-Dirac stencil is written against a small
shift/reduction "geometry" abstraction so the identical math runs on a single
device (jnp.roll) or sharded over a 2D device mesh (shard_map + ppermute halo
exchange); independent chains are vmapped; everything hot is jit-compiled.
"""

from schwingermodel_tpu.config import (
    LatticeParams,
    HMCParams,
    CGParams,
    RunParams,
)
from schwingermodel_tpu.ops.geometry import Geometry, ShardedGeometry
from schwingermodel_tpu.models.schwinger import SchwingerModel

__all__ = [
    "LatticeParams",
    "HMCParams",
    "CGParams",
    "RunParams",
    "Geometry",
    "ShardedGeometry",
    "SchwingerModel",
]

__version__ = "0.1.0"
