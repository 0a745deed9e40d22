"""psulvsb_tpu — Probabilistic Self-Update Line-Vector-Set-Based Point Cloud
Registration on the GPU.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference C++/Eigen implementation (ivpml84079/Probabilistic-Self-Update-
Line-Vector-Set-Based-Point-Cloud-Registration, itself a fork of MIT-SPARK
TEASER++), re-designed for batched accelerator execution:

- static shapes + active masks everywhere (no dynamic Eigen resizes),
- batched hypothesis evaluation via vmap (replaces the serial RANSAC
  basic-iteration loop),
- `lax.while_loop` / `lax.scan` for all data-dependent control flow,
- explicit loop-carried state (the reference keeps warm-start state in
  file-scope C++ globals: reference teaser/src/registration.cc:40-50),
- sharding over registration pairs via `jax.sharding.Mesh` + shard_map.

Public API mirrors `teaser::RobustRegistrationSolver` (reference
teaser/include/teaser/registration.h:326-832) plus a functional
`register_pair` interface.
"""

from psulvsb_tpu.solver.config import (
    SolverParams,
    RotationEstimationAlgorithm,
    InlierSelectionMode,
    InlierGraphFormulation,
)
from psulvsb_tpu.solver.solution import RegistrationSolution
from psulvsb_tpu.api import RobustRegistrationSolver, register_pair

__version__ = "0.5.0"

__all__ = [
    "SolverParams",
    "RegistrationSolution",
    "RobustRegistrationSolver",
    "RotationEstimationAlgorithm",
    "InlierSelectionMode",
    "InlierGraphFormulation",
    "register_pair",
    "__version__",
]
