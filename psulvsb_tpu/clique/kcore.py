"""Inlier selection via graph cores/cliques — device-side forms.

Equivalent of teaser::MaxCliqueSolver::findMaxClique
(/root/reference/teaser/src/graph.cc:12-125), which wraps the PMC library:
k-core bounds -> heuristic clique -> optional exact branch-and-bound. On
the device the adjacency lives as a dense (N, N) bool/float matrix and:

- core numbers   = iterative peeling fixpoint (matrix-vector degree products),
- KCORE_HEU mode = vertices whose core number equals the max core
  (graph.cc:66-82),
- PMC_HEU mode   = greedy clique seeded by core-ordered vertices
  (pmc_heu equivalent: grow a clique inside the candidate neighborhood by
  max-degree-first selection),
- PMC_EXACT      = exact branch-and-bound in native C++ via
  `psulvsb_tpu.clique.pmc` (host callback; branch-and-bound does not map to
  dense device kernels). Falls back to the greedy heuristic when the native library
  is unavailable.

All functions take/return fixed-size masks so they compose with jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _degrees(adj: jax.Array, alive: jax.Array) -> jax.Array:
    return (adj & alive[None, :]).sum(axis=1) * alive


def core_numbers(adj: jax.Array, active: jax.Array | None = None) -> jax.Array:
    """Core number of every vertex by iterative peeling.

    adj: (N, N) bool, symmetric, no self loops. Returns (N,) int32.
    Peels at increasing k: vertices removed while their degree < k get core
    number k-1. A `lax.while_loop` over k with an inner degree-threshold
    fixpoint — O(N) matrix-vector rounds worst case, each a dense (N, N) op.
    """
    n = adj.shape[0]
    if active is None:
        active = jnp.ones((n,), dtype=bool)
    adj = adj & active[None, :] & active[:, None]
    adj = adj & ~jnp.eye(n, dtype=bool)

    def cond(state):
        k, alive, _ = state
        return jnp.any(alive)

    def body(state):
        k, alive, cores = state

        # Remove all vertices with degree < k until fixpoint.
        def peel_cond(a):
            deg = _degrees(adj, a)
            return jnp.any(a & (deg < k))

        def peel_body(a):
            deg = _degrees(adj, a)
            return a & (deg >= k)

        new_alive = jax.lax.while_loop(peel_cond, peel_body, alive)
        # Vertices that died at this k have core number k - 1... but they
        # survived degree >= k-1 at the previous level, so core = k - 1.
        died = alive & ~new_alive
        cores = jnp.where(died, k - 1, cores)
        # Vertices still alive have core >= k.
        cores = jnp.where(new_alive, k, cores)
        return k + 1, new_alive, cores

    _, _, cores = jax.lax.while_loop(
        cond, body, (jnp.int32(1), active, jnp.zeros((n,), jnp.int32))
    )
    return cores


def max_kcore_mask(adj: jax.Array, active: jax.Array | None = None) -> jax.Array:
    """Vertices whose core number equals the max core — the KCORE_HEU
    "clique" (graph.cc:72-82)."""
    cores = core_numbers(adj, active)
    return cores == jnp.max(cores)


def triangle_scores(adj: jax.Array, active: jax.Array | None = None) -> jax.Array:
    """Per-vertex triangle count diag(A^3) — the matmul-native greedy ordering
    for DENSE noisy consistency graphs.

    Core numbers (PMC's kcore ordering) break on the scale-estimation
    ratio-histogram window: its noise region is dense enough that noise
    vertices out-core the inlier clique, and the core-seeded greedy lands
    in noise (measured greedy 5 vs exact 121 at C=2000, 93% mismatch —
    docs/CLIQUE_AUDIT.md). Triangles through a clique vertex grow ~k^2
    with clique size while a p-dense noise vertex gets ~d^2 p/2, so
    triangle ordering separates where degree/core cannot: with it greedy
    matched exact on every audited collapse case. Two (N, N) matmuls —
    matrix-unit work, no host callback."""
    n = adj.shape[0]
    if active is not None:
        adj = adj & active[None, :] & active[:, None]
    a = adj.astype(jnp.float32)
    a2 = jax.lax.dot_general(
        a, a, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return jnp.sum(a2 * a, axis=1)


def greedy_clique(
    adj: jax.Array,
    active: jax.Array | None = None,
    order_scores: jax.Array | None = None,
) -> jax.Array:
    """Greedy clique: start from the best-scored vertex, repeatedly add the
    candidate (adjacent to all current members) with the highest score.
    Score defaults to core number (PMC's `heu_strat = "kcore"`; graph.cc:50).

    Returns (N,) bool clique membership mask.
    """
    n = adj.shape[0]
    if active is None:
        active = jnp.ones((n,), dtype=bool)
    adj = adj & active[None, :] & active[:, None]
    adj = adj & ~jnp.eye(n, dtype=bool)
    if order_scores is None:
        order_scores = core_numbers(adj, active).astype(jnp.float32)
    scores = jnp.where(active, order_scores, -jnp.inf)

    seed = jnp.argmax(scores)
    clique = jnp.zeros((n,), bool).at[seed].set(active[seed])
    candidates = adj[seed] & active

    def cond(state):
        _, cand = state
        return jnp.any(cand)

    def body(state):
        clique, cand = state
        s = jnp.where(cand, scores, -jnp.inf)
        v = jnp.argmax(s)
        clique = clique.at[v].set(True)
        cand = cand & adj[v]
        cand = cand.at[v].set(False)
        return clique, cand

    clique, _ = jax.lax.while_loop(cond, body, (clique, candidates))
    return clique


def max_clique_mask(
    adj: jax.Array,
    active: jax.Array | None = None,
    mode: str = "heu",
    kcore_heuristic_threshold: float = 0.5,
) -> jax.Array:
    """Dispatch equivalent of MaxCliqueSolver::findMaxClique modes.

    mode: "kcore" (KCORE_HEU), "heu" (PMC_HEU-like greedy), "exact"
    (native branch-and-bound via psulvsb_tpu.clique.pmc — host path; inside
    jit use "heu" and reserve "exact" for the escalated b_rate == 1.0 stage
    where the reference invokes PMC).
    """
    if mode == "kcore":
        return max_kcore_mask(adj, active)
    if mode == "heu":
        return greedy_clique(adj, active)
    if mode == "exact":
        from psulvsb_tpu.clique.pmc import exact_max_clique_mask

        return exact_max_clique_mask(adj, active)
    raise ValueError(f"unknown clique mode {mode!r}")
