"""User-facing API mirroring teaser::RobustRegistrationSolver.

The reference class (registration.h:326-832) is stateful: construct with
Params, call solve(src, dst), query getSolution()/inlier getters. That shape
is preserved here for 1:1 driver ports; the functional core
(`register_pair`) is the idiomatic JAX entry point.
"""

from __future__ import annotations

import warnings

import jax
import jax.numpy as jnp
import numpy as np

from psulvsb_tpu.solver.config import SolverParams
from psulvsb_tpu.solver.solution import RegistrationSolution
from psulvsb_tpu.solver.psulvsb import psulvsb_solve
from psulvsb_tpu.solver.classic import solve_decoupled


def register_pair(
    src,
    dst,
    params: SolverParams,
    key: jax.Array,
    keep_mask=None,
) -> tuple[RegistrationSolution, dict]:
    """Functional PSULVSB registration of one correspondence set.

    src/dst: (3, C) arrays. keep_mask: optional (C,) int32 {1, 0, -1}
    histogram pre-filter mask (defaults to all-kept, i.e. the reduced set
    equals the original set).
    """
    src = jnp.asarray(src)
    dst = jnp.asarray(dst)
    if keep_mask is None:
        keep_mask = jnp.ones((src.shape[1],), jnp.int32)
    return psulvsb_solve(src, dst, keep_mask, params, key)


def _solver_dtype(src: np.ndarray, dst: np.ndarray):
    """Dtype the solve runs in: f64 inputs keep f64 when the runtime
    supports it (jax_enable_x64 — the reference pipeline is f64 Eigen
    end-to-end), otherwise downcast to f32 with a warning rather than
    silently (an f64 caller must not get f32 results unannounced). Everything else runs f32 (the accelerator default)."""
    if np.result_type(src.dtype, dst.dtype) == np.float64:
        if jax.config.read("jax_enable_x64"):
            return jnp.float64
        warnings.warn(
            "float64 input downcast to float32: enable x64 "
            "(jax.enable_x64(True) or JAX_ENABLE_X64=1) to solve in "
            "f64 like the reference's Eigen pipeline.",
            stacklevel=3,
        )
    return jnp.float32


class RobustRegistrationSolver:
    """Class-shaped facade over the functional solver (parity with
    registration.h:326-832 and the pybind11 binding surface,
    python/teaserpp_python/teaserpp_python.cc:24-208)."""

    Params = SolverParams

    def __init__(self, params: SolverParams | None = None, seed: int = 0):
        self.params = params or SolverParams()
        self._key = jax.random.PRNGKey(seed)
        self._solution: RegistrationSolution | None = None
        self._info: dict = {}

    def _next_key(self) -> jax.Array:
        self._key, sub = jax.random.split(self._key)
        return sub

    def reset(self, params: SolverParams) -> None:
        """registration.h:747-783 — reinitialize with new params."""
        self.params = params
        self._solution = None
        self._info = {}

    def solve(self, src, dst, correspondences=None, keep_mask=None) -> RegistrationSolution:
        """Solve registration.

        Either solve(src_points, dst_points, correspondences) with (3, N)
        clouds and an iterable of (i, j) index pairs (registration.cc:511-524),
        or solve(src_corr, dst_corr) with pre-matched (3, C) matrices
        (the PSULVSB overload, registration.cc:622).
        """
        if hasattr(src, "asarray"):  # PointCloud container
            src = src.asarray()
        if hasattr(dst, "asarray"):
            dst = dst.asarray()
        src = np.asarray(src)
        dst = np.asarray(dst)
        if correspondences is not None:
            corr = np.asarray(correspondences, dtype=np.int64)
            src = src[:, corr[:, 0]]
            dst = dst[:, corr[:, 1]]
        keep = (
            None
            if keep_mask is None
            else jnp.asarray(np.asarray(keep_mask), jnp.int32)
        )
        dtype = _solver_dtype(src, dst)
        sol, info = register_pair(
            jnp.asarray(src, dtype),
            jnp.asarray(dst, dtype),
            self.params,
            self._next_key(),
            keep_mask=keep,
        )
        self._solution = sol
        self._info = info
        return sol

    def solve_decoupled(self, src, dst) -> RegistrationSolution:
        """Classic single-pass decoupled solve (no PSULVSB loops)."""
        src = np.asarray(src)
        dst = np.asarray(dst)
        dtype = _solver_dtype(src, dst)
        sol, info = solve_decoupled(
            jnp.asarray(src, dtype),
            jnp.asarray(dst, dtype),
            self.params,
            self._next_key(),
        )
        self._solution = sol
        self._info = info
        return sol

    # --- getters mirroring registration.h:600-746 --------------------------
    def getSolution(self) -> RegistrationSolution:
        if self._solution is None:
            raise RuntimeError("call solve() first")
        return self._solution

    def getInlierCounter(self):
        return self._info.get("inlier_counter")

    def getFinalInliers(self):
        return self._info.get("final_inliers")

    def _mask(self, name: str):
        if self._solution is None:
            raise RuntimeError("call solve() first")
        m = self._info.get(name)
        if m is None:
            raise RuntimeError(
                f"{name} not produced by the last solve (registration.h:600-746 "
                "getters are populated by solve() and solve_decoupled())"
            )
        return m

    def getScaleInliersMask(self):
        """(L,) bool over the winning basic TIM set (registration.h:618)."""
        return self._mask("scale_inliers")

    def getRotationInliersMask(self):
        """(L,) bool over the winning basic TIM set (registration.h:661)."""
        return self._mask("rotation_inliers")

    def getTranslationInliersMask(self):
        """(C,) bool over points (registration.h:697)."""
        return self._mask("translation_inliers")

    def getBasicTIMEndpoints(self):
        """(i, j) original-point column indices of the winning basic TIM set
        — the map the TIM-level masks index through (the reference exposes
        the analogous src/dst TIM maps, registration.h:707-746)."""
        return self._mask("basic_tims_i"), self._mask("basic_tims_j")
