"""Greedy-vs-exact clique audit at REFERENCE scale (VERDICT r4 #4).

The solver's escalation path seeds from a greedy clique over the exact
(C, C) consistency graph (solver/psulvsb.py::_clique_seed_stage); the
reference runs exact PMC (graph.cc:84-124). r4's evidence that greedy
matches exact came from n=300 fixtures; this audit harvests the graphs the
solver ACTUALLY builds at the full-scale regime — C in {2000, 5000},
mismatch AND clustered (decoy-rigid colluding groups) outliers at 90-95%,
known-scale beta window and scale-estimation ratio window — via the shared
`dense_consistency_adjacency`, and compares the on-device greedy clique
size against the native exact branch-and-bound.

Usage: python tools/clique_scale_audit.py [--out docs/CLIQUE_AUDIT.md]
Runs on CPU (graph construction is one matmul-free pass at audit scale; the
native B&B is host code).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, ".")

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")

from psulvsb_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from psulvsb_tpu.clique.kcore import greedy_clique, triangle_scores
from psulvsb_tpu.clique.pmc import exact_max_clique, native_available
from psulvsb_tpu.eval.synthetic import synthetic_cloud, make_synthetic_pair
from psulvsb_tpu.solver.config import SolverParams
from psulvsb_tpu.solver.psulvsb import dense_consistency_adjacency


def audit_case(c, rate, mode, estimate_scaling, seed):
    base = jnp.asarray(synthetic_cloud(c, seed=seed), jnp.float32)
    pair = make_synthetic_pair(
        jax.random.PRNGKey(seed * 7919 + 13), base, noise_bound=0.01,
        outlier_rate=rate, max_translation=2.0, outlier_mode=mode,
    )
    params = SolverParams.preset_3dmatch(
        estimate_scaling=estimate_scaling, sampled_cap=2048,
        basic_cap=256, hypothesis_batch=4,
    )
    active = jnp.ones((c,), bool)
    if estimate_scaling:
        # Pool members for the peak estimate: inlier pairs by construction
        # (the stage receives peak+-1 window members; the GT-inlier chain is
        # a faithful stand-in for the audit).
        inl = np.where(~np.asarray(pair.outlier_mask))[0]
        ri = jnp.asarray(inl[:-1], jnp.int32)
        rj = jnp.asarray(inl[1:], jnp.int32)
        rp = jnp.asarray(ri.shape[0], jnp.int32)
    else:
        ri = rj = jnp.zeros((1,), jnp.int32)
        rp = jnp.asarray(0, jnp.int32)
    adj = dense_consistency_adjacency(
        pair.src, pair.dst, ri, rj, rp, params, active
    )
    t0 = time.monotonic()
    g_mask = np.asarray(greedy_clique(adj))
    t_greedy = time.monotonic() - t0
    t0 = time.monotonic()
    gt_mask = np.asarray(
        greedy_clique(adj, order_scores=triangle_scores(adj))
    )
    t_tri = time.monotonic() - t0
    adj_np = np.asarray(adj)
    t0 = time.monotonic()
    exact = exact_max_clique(adj_np, time_limit_s=600.0)
    t_exact = time.monotonic() - t0
    g = int(g_mask.sum())
    gt = int(gt_mask.sum())
    e = len(exact)
    n_inl = int((~np.asarray(pair.outlier_mask)).sum())
    return {
        "C": c, "rate": rate, "mode": mode,
        "window": "ratio-hist" if estimate_scaling else "beta",
        "inliers": n_inl, "core_greedy": g, "tri_greedy": gt, "exact": e,
        "ratio": round(gt / max(e, 1), 4),
        "t_tri_s": round(t_tri, 2), "t_exact_s": round(t_exact, 2),
        "edges": int(adj_np.sum()) // 2,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="docs/CLIQUE_AUDIT.md")
    args = ap.parse_args()
    assert native_available(), "native exact clique library not built"

    cases = []
    for c in (2000, 5000):
        for rate, mode in ((0.95, "mismatch"), (0.93, "mismatch"),
                           (0.9, "clustered"), (0.95, "clustered")):
            for es in (False, True):
                cases.append(audit_case(c, rate, mode, es, seed=c + int(rate * 100)))
                print(cases[-1], flush=True)

    lines = [
        "# Greedy-vs-exact clique at reference scale",
        "",
        "Graphs are the solver's own (`dense_consistency_adjacency`, the",
        "exact (C, C) membership grid the escalation seed builds), at the",
        "full-scale regime: C in {2000, 5000}, 90-95% outliers, mismatch",
        "and clustered (decoy-rigid colluding groups), both membership",
        "windows. Exact = native branch-and-bound (native/maxclique.cpp),",
        "600 s budget. Generated by `tools/clique_scale_audit.py`;",
        "asserted at C=2048 by tests/test_clique.py::TestGreedyVsExactAtScale.",
        "",
        "| C | rate | mode | window | inliers | core-greedy |"
        " tri-greedy | exact | tri/exact | t_tri s | t_exact s | edges |",
        "|---|------|------|--------|---------|-------------|"
        "-----------|-------|-----------|---------|-----------|-------|",
    ]
    for r in cases:
        lines.append(
            f"| {r['C']} | {r['rate']} | {r['mode']} | {r['window']} |"
            f" {r['inliers']} | {r['core_greedy']} | {r['tri_greedy']} |"
            f" {r['exact']} | {r['ratio']} |"
            f" {r['t_tri_s']} | {r['t_exact_s']} | {r['edges']} |"
        )
    worst = min(r["ratio"] for r in cases)
    worst_core = min(r["core_greedy"] / max(r["exact"], 1) for r in cases)
    lines += [
        "",
        f"Worst TRIANGLE-greedy/exact ratio over the sweep: **{worst}** "
        f"(core-number greedy bottomed at {worst_core:.4f} on the dense "
        "ratio-histogram graphs — the collapse that moved the solver to "
        "triangle ordering, clique/kcore.py::triangle_scores).",
    ]
    lines += [
        "",
        "## Interpretation",
        "",
        "See the committed docs/CLIQUE_AUDIT.md interpretation section:",
        "beta-window (the reference's clique stage graph) reads 0.96-1.0;",
        "the sub-0.95 triangle cases are decoy-rigid ratio-window traps",
        "where multi-start and lookahead greedy were measured NOT to help,",
        "the clique only seeds a warm start, and exact_clique_callback=True",
        "remains the exact-parity escape hatch.",
    ]
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {args.out}; worst ratio {worst}")


if __name__ == "__main__":
    main()
