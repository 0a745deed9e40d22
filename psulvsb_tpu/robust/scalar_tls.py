"""Scalar robust estimators — the batched forms of ScalarTLSEstimator.

The reference's `ScalarTLSEstimator` (teaser/src/registration.cc:53-320) has
three behaviors, all re-expressed here as fixed-shape vector programs:

1. `estimate_tiled` (registration.cc:206-320): adaptive-voting TLS — sort the
   2N interval endpoints, evaluate every one of the 2N-1 interval centers
   against every measurement, pick the minimum-cost consensus. The C++ loop
   tiling + OpenMP is exactly a dense (2N-1, N) elementwise grid on the VPU
   -> `tls_vote`.

2. scale mode (`STswitch == 0`, registration.cc:67-119): 1-point RANSAC to
   0.99 confidence with optional warm start, then inverse-variance-weighted
   mean over the winning consensus set -> `scale_consensus_1pt`. The serial
   draw-score-update loop becomes one (K, N) consensus matrix + a cumulative
   max that replays the sequential confidence-stopping rule exactly.

3. translation mode (`STswitch >= 1`, registration.cc:121-203): max-interval
   stabbing — sort 2N (+2 warm-start) endpoints, sweep with a running count
   and running inverse-variance-weighted mean, early-accept best interval
   -> `max_stabbing`, expressed as sort + cumsum (no sweep loop).

All functions take an `active` mask so padded lanes never vote.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from psulvsb_tpu.utils.precision import mm

_BIG = 1e30


def tls_vote(
    x: jax.Array,
    ranges: jax.Array,
    active: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Adaptive-voting truncated-least-squares scalar estimate.

    Equivalent of ScalarTLSEstimator::estimate_tiled (registration.cc:206-320):
      h        = sort([x - ranges, x + ranges])            (2N endpoints)
      centers  = midpoints of consecutive endpoints        (2N-1 candidates)
      for each center c_i: consensus_ij = |x_j - c_i| <= ranges_j
        x_hat_i = sum_j w_j x_j [consensus] / sum_j w_j [consensus],
                  w_j = 1/ranges_j^2
        cost_i  = sum_j (x_j - x_hat_i)^2 [consensus] + sum_j ranges_j [~consensus]
      estimate = x_hat[argmin cost]; inliers = |x - estimate| <= ranges

    (The reference accumulates plain `ranges(j)` for non-consensus
    measurements despite the variable name `ranges_inverse_sum` —
    registration.cc:261; replicated.)

    Returns (estimate, inlier mask over the N measurements).
    """
    n = x.shape[0]
    if active is None:
        active = jnp.ones((n,), dtype=bool)
    # Push padded endpoints to +inf so they sort to the tail and their
    # centers never win (their consensus sets are identical to real ones or
    # cost +inf below).
    lo = jnp.where(active, x - ranges, _BIG)
    hi = jnp.where(active, x + ranges, _BIG)
    h = jnp.sort(jnp.concatenate([lo, hi]))
    centers = (h[:-1] + h[1:]) / 2.0  # (2N-1,)

    weights = jnp.where(active, 1.0 / (ranges * ranges), 0.0)

    # (2N-1, N) consensus grid — the dense VPU form of the C++ tiled loops.
    diff = jnp.abs(x[None, :] - centers[:, None])
    consensus = (diff <= ranges[None, :]) & active[None, :]
    cons_f = consensus.astype(x.dtype)

    dot_xw = mm(cons_f, x * weights)
    dot_w = mm(cons_f, weights)
    x_hat = dot_xw / jnp.where(dot_w > 0, dot_w, 1.0)

    resid = (x[None, :] - x_hat[:, None]) * cons_f
    sq_cost = jnp.sum(resid * resid * active[None, :].astype(x.dtype), axis=1)
    ranges_out = mm((1.0 - cons_f) * active[None, :].astype(x.dtype), ranges)
    cost = sq_cost + ranges_out
    # Centers derived from padded endpoints or with empty consensus are
    # invalid candidates.
    cost = jnp.where((dot_w > 0) & (jnp.abs(centers) < _BIG / 2), cost, jnp.inf)

    best = jnp.argmin(cost)
    estimate = x_hat[best]
    inliers = (jnp.abs(x - estimate) <= ranges) & active
    return estimate, inliers


def scale_consensus_1pt(
    x: jax.Array,
    ranges: jax.Array,
    key: jax.Array,
    active: jax.Array | None = None,
    warm_value: jax.Array | None = None,
    use_warm: jax.Array | bool = False,
    max_draws: int = 256,
    confidence: float = 0.99,
) -> tuple[jax.Array, jax.Array]:
    """1-point RANSAC scalar consensus with confidence stopping + weighted
    refinement (scale mode of ScalarTLSEstimator, registration.cc:67-119).

    The reference loop draws one measurement at a time, counts its consensus
    set over all N, tracks the best, and stops when
    1 - (1 - best/N)^iterations >= confidence. Here all `max_draws` candidate
    draws are scored at once as a (K, N) grid; the sequential stopping rule
    is replayed with a cumulative max, so the returned estimate is the one
    the serial loop would have accepted (same candidate distribution; the
    draw sequence differs from C's rand()).

    Warm start (`!first_time`, registration.cc:76-86): candidate 0 is
    `warm_value` and counts as the first iteration.

    Refinement (registration.cc:106-118): inverse-variance-weighted mean of
    the winning consensus set.
    """
    n = x.shape[0]
    if active is None:
        active = jnp.ones((n,), dtype=bool)
    n_active = jnp.maximum(jnp.sum(active), 1).astype(x.dtype)
    use_warm = jnp.asarray(use_warm)
    if warm_value is None:
        warm_value = jnp.zeros((), dtype=x.dtype)

    # Draw K candidate values from the active measurements (with
    # replacement, like `rand() % N`). All-inactive input (fully padded
    # hypothesis) falls back to uniform draws — NaN sampling probabilities
    # would otherwise poison candidates/estimate/inliers silently; the
    # caller's masks drop the garbage-but-finite result either way.
    any_active = jnp.any(active)
    probs = jnp.where(any_active, active.astype(x.dtype), 1.0)
    probs = probs / jnp.sum(probs)
    idx = jax.random.choice(key, n, shape=(max_draws,), replace=True, p=probs)
    candidates = x[idx]
    candidates = jnp.where(
        (jnp.arange(max_draws) == 0) & use_warm, warm_value, candidates
    )

    # (K, N) consensus counts.
    cons = (jnp.abs(x[None, :] - candidates[:, None]) <= ranges[None, :]) & active[None, :]
    counts = jnp.sum(cons, axis=1).astype(x.dtype)

    # Replay the sequential stopping rule: after t+1 draws the best count is
    # cummax(counts)[t]; stop at the first t where confidence is reached.
    best_so_far = jax.lax.cummax(counts)
    iters = jnp.arange(1, max_draws + 1, dtype=x.dtype)
    conf = 1.0 - jnp.power(1.0 - best_so_far / n_active, iters)
    reached = conf >= confidence
    stop_t = jnp.argmax(reached)  # first True; 0 if never (use all draws)
    stop_t = jnp.where(jnp.any(reached), stop_t, max_draws - 1)

    # Winner = first candidate achieving the best count within the window.
    # (The serial loop only replaces on strict improvement, so the first
    # maximum wins.)
    in_window = jnp.arange(max_draws) <= stop_t
    masked_counts = jnp.where(in_window, counts, -1.0)
    winner = jnp.argmax(masked_counts)
    estimate0 = candidates[winner]

    inliers = (jnp.abs(x - estimate0) <= ranges) & active
    w = jnp.where(inliers, 1.0 / (ranges * ranges), 0.0)
    sum_left = jnp.sum(w)
    sum_right = jnp.sum(w * x)
    refined = jnp.where(sum_left > 0, sum_right / jnp.maximum(sum_left, 1e-30), estimate0)
    return refined, inliers


def max_stabbing(
    x: jax.Array,
    noise: jax.Array | float,
    active: jax.Array | None = None,
    warm_value: jax.Array | None = None,
    use_warm: jax.Array | bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Max-interval-stabbing scalar estimate (translation mode of
    ScalarTLSEstimator, registration.cc:121-203).

    Each measurement spans [x_i - noise, x_i + noise]. Find the point stabbed
    by the most intervals; the estimate is the (equal-weight) mean of the
    stabbed measurements — the reference accumulates 1/noise^2 weights that
    cancel in the ratio.

    Vectorized sweep: sort 2(N+1) endpoints (starts before ends on ties);
    running count = cumsum(+1/-1). At each END event the reference checks the
    count *before* removal and snapshots sum/count, keeping the first strict
    maximum. With the start-first tie order, count-before-removal at end
    event e equals cumsum_through_e + 1 and mean-sum equals
    cumsum(delta*x)_through_e + x_e.

    The warm slot (`!first_time`, registration.cc:136-161) adds one interval
    at warm_value ± noise; it participates in both count and mean exactly as
    in the reference.
    """
    n = x.shape[0]
    if active is None:
        active = jnp.ones((n,), dtype=bool)
    use_warm = jnp.asarray(use_warm)
    if warm_value is None:
        warm_value = jnp.zeros((), dtype=x.dtype)
    noise = jnp.asarray(noise, dtype=x.dtype)

    xs = jnp.concatenate([x, warm_value[None]])
    act = jnp.concatenate([active, use_warm[None]])

    starts = jnp.where(act, xs - noise, _BIG)
    ends = jnp.where(act, xs + noise, _BIG)
    vals = jnp.concatenate([starts, ends])
    deltas = jnp.concatenate(
        [jnp.where(act, 1.0, 0.0), jnp.where(act, -1.0, 0.0)]
    ).astype(x.dtype)
    xrep = jnp.concatenate([xs, xs])

    # Sort by (value, -delta): starts (+1) before ends (-1) at equal value.
    order = jnp.lexsort((-deltas, vals))
    vals_s = vals[order]
    deltas_s = deltas[order]
    x_s = xrep[order]

    cnt = jnp.cumsum(deltas_s)
    xsum = jnp.cumsum(deltas_s * x_s)

    is_end = deltas_s < 0
    count_at_check = cnt + 1.0
    sum_at_check = xsum + x_s
    score = jnp.where(is_end, count_at_check, -1.0)
    best = jnp.argmax(score)  # first maximum, like the strict > in C++
    estimate = sum_at_check[best] / jnp.maximum(count_at_check[best], 1.0)

    inliers = (jnp.abs(x - estimate) <= noise) & active
    return estimate, inliers


class ScalarTLSEstimator:
    """Class facade mirroring teaser::ScalarTLSEstimator
    (registration.h:107-133). `estimate` reproduces the PSULVSB-modified
    dual-mode behavior via explicit arguments instead of the reference's
    STswitch/first_time globals (registration.cc:41-42); `estimate_tiled`
    is the stock adaptive-voting estimator."""

    def __init__(self, key=None):
        self._key = key if key is not None else jax.random.PRNGKey(0)

    def estimate(self, x, ranges, mode: str = "scale", warm_value=None,
                 noise=None):
        """mode="scale": 1-point RANSAC consensus (STswitch == 0 path);
        mode="translation": max-interval stabbing (STswitch >= 1 path;
        `noise` is the per-axis translation noise, default ranges[0])."""
        x = jnp.asarray(x)
        ranges = jnp.asarray(ranges)
        if mode == "scale":
            self._key, sub = jax.random.split(self._key)
            return scale_consensus_1pt(
                x, ranges, sub,
                warm_value=None if warm_value is None else jnp.asarray(warm_value),
                use_warm=warm_value is not None,
            )
        if mode == "translation":
            n = ranges[0] if noise is None else jnp.asarray(noise)
            return max_stabbing(
                x, n,
                warm_value=None if warm_value is None else jnp.asarray(warm_value),
                use_warm=warm_value is not None,
            )
        raise ValueError(f"unknown mode {mode!r}")

    def estimate_tiled(self, x, ranges, s: int = 64):
        """Stock TEASER adaptive voting (registration.cc:206-320). The tile
        size `s` is a CPU cache-blocking knob with no meaning here; accepted
        for signature parity and ignored."""
        del s
        return tls_vote(jnp.asarray(x), jnp.asarray(ranges))
