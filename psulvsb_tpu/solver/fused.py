"""Fully-jitted PSULVSB solve — the whole two-level RANSAC as one XLA
program.

`psulvsb_solve` (solver/psulvsb.py) keeps the host-round loop in Python to
honor the reference's wall-clock budget check (registration.cc:1475) and for
stage-by-stage debuggability. This module compiles the complete solve —
host rounds as a `lax.scan` with a done-flag, rate escalation as a carried
ladder index — into a single program:

- one device dispatch per solve (no host round-trip between rounds),
- vmap/shard_map composable: the 3DMatch 1623-pair sweep runs as a sharded
  batch over a `jax.sharding.Mesh` (see parallel/pairs.py),
- divergence: no host clock readable inside jit, so the reference's 60 s
  budget (registration.cc:1475) is applied as a TRACE-TIME projection —
  the scan length is capped at time_budget_s / fused_round_ceiling_s
  rounds (see `fused_scan_rounds`); with the reference caps the confidence
  test + the 5-round cap + longholi always terminate first.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from psulvsb_tpu.solver.basic import WarmState
from psulvsb_tpu.solver.config import SolverParams, RATE_SCHEDULE
from psulvsb_tpu.solver.psulvsb import (
    HostState,
    _init_stage,
    _sample_stage,
    _local_stage,
    _host_stage,
    _self_update_pairs,
    _finalize_stage,
    _clique_seed_stage,
)
from psulvsb_tpu.solver.solution import RegistrationSolution


def fused_scan_rounds(params: SolverParams) -> int:
    """Static host-round count for the fused scan: `max_host_rounds`
    capped by the projected wall-clock budget.

    The staged solver checks the host clock between rounds
    (registration.cc:1475); one fused XLA program cannot. The budget is
    therefore enforced when the program is BUILT: at most
    time_budget_s / fused_round_ceiling_s rounds are compiled, with the
    ceiling a pessimistic per-round device-time bound (config.py). At the
    reference caps this never binds — it exists so growing
    `max_host_rounds` cannot silently discard the 60 s semantics."""
    rounds = params.max_host_rounds
    if (
        params.fused_round_ceiling_s > 0
        and params.time_budget_s > 0
        and math.isfinite(params.time_budget_s)
    ):
        budget_rounds = max(
            1, int(params.time_budget_s / params.fused_round_ceiling_s)
        )
        rounds = min(rounds, budget_rounds)
    return rounds


class _RoundCarry(NamedTuple):
    key: jax.Array
    hs: HostState
    warm: WarmState
    best_sampled: WarmState
    red_i: jax.Array  # (R,) compacted reduced-set pair indices
    red_j: jax.Array
    red_count: jax.Array  # () int32 — |reduced| (possibly an estimate)
    red_pool: jax.Array  # () int32 — materialized members in red_i/red_j
    rate_idx: jax.Array  # () int32 into RATE_SCHEDULE
    longholi: jax.Array  # () bool
    done: jax.Array  # () bool
    rounds: jax.Array  # () int32
    seeded: jax.Array  # () bool — lazy clique seed already ran


@functools.partial(jax.jit, static_argnames=("params", "_gnc_path"))
def psulvsb_register(
    ori_src: jax.Array,
    ori_dst: jax.Array,
    keep_mask: jax.Array,
    key: jax.Array,
    params: SolverParams,
    _gnc_path: str = "auto",
) -> RegistrationSolution:
    """One-dispatch PSULVSB solve. Same semantics as
    psulvsb_solve (solver/psulvsb.py), with the wall-clock budget applied
    as a trace-time round-count projection (`fused_scan_rounds`) instead
    of a between-rounds host clock check.

    `_gnc_path` is private: eval/kernel_checks.check_gnc_solve sets it to
    compare the GNC kernel with the XLA loop (see _local_stage)."""
    c = ori_src.shape[1]
    dtype = ori_src.dtype
    keep_mask = keep_mask.astype(jnp.int32)

    key, k_init = jax.random.split(key)
    red_i0, red_j0, red_count0, red_pool0 = _init_stage(
        ori_src, ori_dst, keep_mask, params, k_init
    )

    n_reduced = jnp.sum(keep_mask == 1).astype(dtype)
    n_real = jnp.maximum(jnp.sum(keep_mask >= -1), 1).astype(dtype)
    thr = jnp.asarray(params.pr_noise, dtype) * (1.0 + n_reduced / n_real)

    l_rates = jnp.asarray([r[0] for r in RATE_SCHEDULE], dtype)
    b_rates = jnp.asarray([r[1] for r in RATE_SCHEDULE], dtype)
    last_rate = len(RATE_SCHEDULE) - 1

    lazy_clique = params.clique_lazy

    def round_body(carry: _RoundCarry, _):
        def run(carry: _RoundCarry) -> _RoundCarry:
            key, k_samp, k_local, k_host = jax.random.split(carry.key, 4)
            # Derived (not split) so the per-round streams match the staged
            # solver's 4-way split exactly (parity tests compare the two).
            k_seed = jax.random.fold_in(k_host, 0x5EED)
            l_rate = l_rates[carry.rate_idx]
            b_rate = b_rates[carry.rate_idx]
            b_one = carry.rate_idx == last_rate

            s_i, s_j, s_ok, s_count, s_pts = _sample_stage(
                carry.red_i, carry.red_j, carry.red_count, carry.red_pool,
                l_rate, params, k_samp, c,
            )
            local = _local_stage(
                ori_src, ori_dst, s_i, s_j, s_ok, s_count, s_pts,
                b_rate, b_one, carry.hs.host_r, carry.warm, thr, params, k_local,
                gnc_path=_gnc_path,
            )
            hs, new_corr, _take = _host_stage(
                ori_src, ori_dst, carry.hs, local.best, local.local_r, b_one,
                thr, params, k_host,
            )
            warm = WarmState(
                scale=hs.best.scale,
                rotation=hs.best.rotation,
                translation=hs.best.translation,
                first_time=jnp.zeros((), bool),
            )
            stop = (hs.pro_host > params.host_confidence) | carry.longholi
            longholi = carry.longholi | (carry.rate_idx == last_rate)
            rate_idx = jnp.where(
                local.escalate & (carry.rate_idx < last_rate),
                carry.rate_idx + 1,
                carry.rate_idx,
            )
            red_i, red_j, red_count, red_pool = jax.lax.cond(
                jnp.any(new_corr),
                lambda: _self_update_pairs(
                    carry.red_i, carry.red_j, carry.red_count, carry.red_pool,
                    new_corr, hs.inl_kept, params,
                ),
                lambda: (carry.red_i, carry.red_j, carry.red_count, carry.red_pool),
            )
            seeded = carry.seeded
            if lazy_clique:
                # Lazy clique-seeded warm start (config.py clique_init="auto"):
                # run the (C, C) adjacency + greedy-clique + chain-TIM seed
                # ONLY when this round escalated the rate ladder (stagnation
                # at >= 97% mismatch outliers) and only once. Inside lax.cond
                # the untaken branch does not execute, so converging pairs
                # never pay the seed's device time.
                want = local.escalate & ~carry.seeded & ~stop

                def run_seed(w):
                    sw, seed_ok = _clique_seed_stage(
                        ori_src, ori_dst, red_i, red_j, red_pool, params,
                        k_seed, hs.keep_mask == 1,
                    )
                    return WarmState(
                        scale=jnp.where(seed_ok, sw.scale, w.scale),
                        rotation=jnp.where(seed_ok, sw.rotation, w.rotation),
                        translation=jnp.where(
                            seed_ok, sw.translation, w.translation
                        ),
                        first_time=w.first_time & ~seed_ok,
                    )

                warm = jax.lax.cond(want, run_seed, lambda w: w, warm)
                seeded = carry.seeded | want
            return _RoundCarry(
                key=key,
                hs=hs,
                warm=warm,
                best_sampled=local.best,
                red_i=red_i,
                red_j=red_j,
                red_count=red_count,
                red_pool=red_pool,
                rate_idx=rate_idx,
                longholi=longholi,
                done=stop,
                rounds=carry.rounds + 1,
                seeded=seeded,
            )

        carry = jax.lax.cond(carry.done, lambda c_: c_, run, carry)
        return carry, None

    warm0 = WarmState.initial(dtype)
    if params.gror_init:
        # GROR initial alignment seeding the warm state (same semantics as
        # psulvsb_solve; registration_artificial.cc:571-576), traced into
        # the single dispatch. Falls back to the cold start when GROR finds
        # fewer than 3 inliers.
        from psulvsb_tpu.gror.gror import _gror_core

        g = _gror_core(
            ori_src.astype(jnp.float32), ori_dst.astype(jnp.float32),
            keep_mask > -2, params.gror_resolution, params.gror_k_optimal,
        )
        gror_ok = jnp.sum(g.inliers) >= 3
        warm0 = WarmState(
            scale=jnp.ones((), dtype),
            rotation=jnp.where(gror_ok, g.rotation.astype(dtype), warm0.rotation),
            translation=jnp.where(
                gror_ok, g.translation.astype(dtype), warm0.translation
            ),
            first_time=~gror_ok,
        )
    if params.clique_eager:
        # Eager clique-seeded warm start (solver/psulvsb.py::
        # _clique_seed_stage; clique_init="auto" instead defers the seed to
        # the first escalation inside the round loop below):
        # greedy clique over the reduced-set consistency graph + chain-TIM
        # decoupled solve, adopted when the clique has >= clique_seed_min_size
        # members. Composes with gror_init: a successful clique seed wins
        # (it is built from this pair's own consistency graph).
        key, k_seed = jax.random.split(key)
        sw, seed_ok = _clique_seed_stage(
            ori_src, ori_dst, red_i0, red_j0, red_pool0, params, k_seed,
            keep_mask == 1,
        )
        warm0 = WarmState(
            scale=jnp.where(seed_ok, sw.scale, warm0.scale),
            rotation=jnp.where(seed_ok, sw.rotation, warm0.rotation),
            translation=jnp.where(seed_ok, sw.translation, warm0.translation),
            first_time=warm0.first_time & ~seed_ok,
        )

    init = _RoundCarry(
        key=key,
        hs=HostState.initial(c, keep_mask, dtype),
        warm=warm0,
        best_sampled=WarmState.initial(dtype),
        red_i=red_i0,
        red_j=red_j0,
        red_count=red_count0,
        red_pool=red_pool0,
        rate_idx=jnp.int32(0),
        longholi=jnp.zeros((), bool),
        done=jnp.zeros((), bool),
        rounds=jnp.int32(0),
        seeded=jnp.zeros((), bool),
    )
    final, _ = jax.lax.scan(round_body, init, None, length=fused_scan_rounds(params))

    hs = final.hs
    if params.enable_refinement:
        rotation, translation, _refined = jax.lax.cond(
            hs.best_count > 0,
            lambda: _finalize_stage(
                ori_src, ori_dst, hs, final.best_sampled, params
            ),
            lambda: (hs.best.rotation, hs.best.translation, jnp.zeros((), bool)),
        )
    else:
        rotation, translation = hs.best.rotation, hs.best.translation
    return RegistrationSolution(
        valid=hs.best_count > 0,
        scale=hs.best.scale,
        rotation=rotation,
        translation=translation,
        final_inlier_count=hs.best_count,
    )
