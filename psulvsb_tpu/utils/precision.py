"""Precision-pinned matmul for the registration compute path.

On NVIDIA Ampere and Hopper, a float32 jnp.matmul may run in TF32 (10-bit
mantissa, ~1e-3 relative error). The registration math compares residuals
against noise bounds of 1e-2..5e-2 on unit-scale coordinates, where TF32
rounding flips inlier tests; every matmul on that path uses HIGHEST
precision (full float32). The affected
matmuls are small (3xN / consensus-grid contractions), so the cost is
negligible next to the elementwise work.
"""

import functools

import jax
import jax.numpy as jnp

mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
