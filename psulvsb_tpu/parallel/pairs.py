"""Multi-chip scaling: registration pairs over a device mesh.

The reference has no distributed story (SURVEY.md §2.3 — OpenMP threads in
one process); its dataset sweeps (1623 3DMatch pairs, 555 KITTI pairs,
teaser_cpp_ply_main.cc:244-795) solve pairs serially. The scaling axis here is
the pair batch: a 1-D `jax.sharding.Mesh` over "pairs", each device
solving its shard with the fused one-dispatch solver, and recall metrics
reduced with `psum` across the cards.

No intra-solve communication exists or is needed — one pair fits one chip —
so the sharding is pure data parallelism with a final collective reduction,
the layout that keeps every byte of cross-card traffic to the (tiny) metric
vector.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from psulvsb_tpu.solver.config import SolverParams
from psulvsb_tpu.solver.fused import psulvsb_register
from psulvsb_tpu.solver.solution import RegistrationSolution


def make_pair_mesh(devices=None, axis_name: str = "pairs") -> Mesh:
    """1-D mesh over all (or given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


@functools.partial(jax.jit, static_argnames=("params", "vectorized"))
def register_batch(
    src_batch: jax.Array,  # (B, 3, C)
    dst_batch: jax.Array,  # (B, 3, C)
    keep_batch: jax.Array,  # (B, C) int32
    keys: jax.Array,  # (B, 2) PRNG keys
    params: SolverParams,
    vectorized: bool = False,
) -> RegistrationSolution:
    """Single-device batch of fused solves.

    Default is `lax.map` (sequential per pair): the fused solver's
    host-round scan exits early via a done-flag `lax.cond`, which a vmap
    would degrade to a select (every pair then pays max_host_rounds —
    measured ~1.6x slower per pair). Sequential keeps the early exit;
    multi-chip scaling comes from sharding pairs across devices
    (register_batch_sharded), not from vmapping within one.
    """
    solve = lambda args: psulvsb_register(args[0], args[1], args[2], args[3], params)
    if vectorized:
        return jax.vmap(
            lambda s, d, k, key: psulvsb_register(s, d, k, key, params)
        )(src_batch, dst_batch, keep_batch, keys)
    return jax.lax.map(solve, (src_batch, dst_batch, keep_batch, keys))


def register_batch_sharded(
    mesh: Mesh,
    src_batch,
    dst_batch,
    keep_batch,
    keys,
    params: SolverParams,
    axis_name: str = "pairs",
):
    """Shard the pair batch over the mesh; each device vmaps its shard.

    Returns (per-pair solutions (replicated layout preserved as sharded
    outputs), summary dict with psum-reduced totals: solved count and
    inlier-count sum — the recall aggregation as one psum across the cards).
    """

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name)),
        out_specs=(P(axis_name), P()),
        # The solver's loop carries mix mesh-varying data with replicated
        # constants (e.g. zero-initialized counters), which trips the static
        # varying-manual-axes check; the program is still valid SPMD.
        check_vma=False,
    )
    def solve_shard(src_s, dst_s, keep_s, keys_s):
        sols = jax.lax.map(
            lambda args: psulvsb_register(args[0], args[1], args[2], args[3], params),
            (src_s, dst_s, keep_s, keys_s),
        )
        valid_count = jnp.sum(sols.valid.astype(jnp.int32))
        inlier_sum = jnp.sum(sols.final_inlier_count)
        totals = jax.lax.psum(
            jnp.stack([valid_count, inlier_sum]), axis_name=axis_name
        )
        return sols, totals

    sols, totals = solve_shard(src_batch, dst_batch, keep_batch, keys)
    return sols, {"valid_pairs": totals[0], "inlier_sum": totals[1]}
