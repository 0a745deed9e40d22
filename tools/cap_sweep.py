"""Cap sweep — find the fastest (sampled_cap, basic_cap, hypothesis_batch)
at equal correctness.

The static caps (solver/config.py) bound the sampled/basic TIM sets and the
vmapped hypothesis batch; they are the main device-time lever, and the best
point moves whenever the solver's round structure changes (round 3: the
lazy clique seed made (2048, 256, 4) beat round 2's (4096, 1024, 16) by
~2.5x at equal recall). Re-run this after any change to the round/local
loop structure.

For each grid point this measures the time per solve of K fused solves
inside one jitted lax.scan with a carried data dependency (one dispatch
for all K) on two fixtures: the bunny anchor (1889
corrs, 90% outliers) and a hostile high-outlier pair (95%), and checks the
rotation/translation are still correct on both.

Usage:
    python tools/cap_sweep.py [k_reps]        # on the GPU
    JAX_PLATFORMS=cpu python tools/cap_sweep.py 2   # structure smoke only
"""

from __future__ import annotations

import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np

from psulvsb_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

from psulvsb_tpu.core.metrics import angular_error_deg_np
from psulvsb_tpu.eval.synthetic import make_synthetic_pair, synthetic_cloud
from psulvsb_tpu.solver.config import SolverParams
from psulvsb_tpu.solver.fused import psulvsb_register

GRID = [
    (2048, 256, 4),
    (2048, 512, 4),
    (2048, 256, 8),
    (2048, 256, 16),
    (1024, 256, 4),
    (4096, 512, 8),
]

# Materialized-pool capacities swept alongside (r4: pool_cap is the other
# big device-time lever — the init compaction's top-k scales with it;
# 131072 slots forced a full C^2 sort worth >half the solve).
POOL_GRID = [8192, 16384, 32768]


def fixtures():
    src = jnp.asarray(synthetic_cloud(1889, seed=0))
    easy = make_synthetic_pair(
        jax.random.PRNGKey(1), src, noise_bound=0.05, outlier_rate=0.9
    )
    hard = make_synthetic_pair(
        jax.random.PRNGKey(2), src, noise_bound=0.01, outlier_rate=0.95,
        outlier_mode="mismatch",
    )
    return [("easy90", easy, 0.05), ("hard95", hard, 0.01)]


def device_ms(solve, src, dst, keep, key, k):
    """Time per solve of K reps in one scan, with a carried perturbation so
    XLA cannot hoist the solve."""

    @jax.jit
    def scanned(s0):
        def body(c, _):
            out = solve(s0 + c * 1e-9, dst, keep, key)
            return c + out.rotation[0, 0] * 1e-20, None

        c, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=k)
        return c

    np.asarray(scanned(src))  # compile + warm
    t0 = time.monotonic()
    np.asarray(scanned(src))
    return (time.monotonic() - t0) / k * 1e3


def main():
    k = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    fx = fixtures()
    print(f"{'caps':24s}  " + "  ".join(f"{n:>18s}" for n, _, _ in fx))
    grid = [(sc, bc, hb, pc) for (sc, bc, hb) in GRID for pc in POOL_GRID]
    for caps in grid:
        sc, bc, hb, pc = caps
        cells = []
        for _name, pair, nb in fx:
            params = SolverParams.preset_artificial(
                noise_bound=nb, noise_bound_dataset=nb,
                sampled_cap=sc, basic_cap=bc, hypothesis_batch=hb,
                pool_cap=pc,
            )

            def solve(s, d, kp, ky, p=params):
                return psulvsb_register(s, d, kp, ky, p)

            keep = jnp.ones((pair.src.shape[1],), jnp.int32)
            ms = device_ms(solve, pair.src, pair.dst, keep,
                           jax.random.PRNGKey(3), k)
            sol = jax.jit(solve)(pair.src, pair.dst, keep, jax.random.PRNGKey(3))
            re = angular_error_deg_np(
                np.asarray(pair.transform.rotation), np.asarray(sol.rotation)
            )
            te = float(np.linalg.norm(
                np.asarray(sol.translation)
                - np.asarray(pair.transform.translation)
            ))
            ok = "ok " if (re < 5.0 and te < 0.3) else "BAD"
            cells.append(f"{ms:7.1f} ms {ok} {re:4.1f}d")
        print(f"{str(caps):24s}  " + "  ".join(f"{c:>18s}" for c in cells))


if __name__ == "__main__":
    main()
