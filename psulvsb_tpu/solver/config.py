"""Solver configuration — one frozen dataclass replacing the reference's
four config layers (Params struct + compile-time dataset macros + hard-coded
constants + driver globals; see SURVEY.md §5 "Config / flag system").

Field-by-field parity with teaser::RobustRegistrationSolver::Params
(/root/reference/teaser/include/teaser/registration.h:378-473), plus the
constants the reference buries in registration.cc:
- noise_bound_dataset / pr_noise      registration.cc:32-36 (#define NOISE_BOUND,
                                      PrNoise = 2*NOISE_BOUND)
- rotation_similar = 0.01             registration.cc:48
- local_max_iter = 10                 registration.cc:49
- inner-loop override noise_bound=0.05, cbar2=1, GNC_TLS, cost_thr=0.005
                                      registration.cc:938-945
- sampling-rate escalation schedule   registration.cc:1377-1388
- host confidence 0.99 / 5 rounds     registration.cc:772,781
- 60 s wall-clock budget              registration.cc:1475
plus static capacity knobs (padded sizes) that replace dynamic resizes.
"""

from __future__ import annotations

import dataclasses
import enum


class RotationEstimationAlgorithm(enum.IntEnum):
    """registration.h:343-346."""

    GNC_TLS = 0
    FGR = 1


class InlierSelectionMode(enum.IntEnum):
    """registration.h:356-361."""

    PMC_EXACT = 0
    PMC_HEU = 1
    KCORE_HEU = 2
    NONE = 3


class InlierGraphFormulation(enum.IntEnum):
    """registration.h:370-373."""

    CHAIN = 0
    COMPLETE = 1


# Rate escalation ladder: (L_sampled_rate, b_sampled_rate) —
# registration.cc:776-777 initial values and :1377-1388 transitions.
RATE_SCHEDULE = ((0.1, 0.3), (0.2, 0.3), (0.5, 0.3), (1.0, 1.0))


@dataclasses.dataclass(frozen=True)
class SolverParams:
    # --- teaser::RobustRegistrationSolver::Params parity -------------------
    noise_bound: float = 0.01
    cbar2: float = 1.0
    estimate_scaling: bool = True
    rotation_estimation_algorithm: RotationEstimationAlgorithm = (
        RotationEstimationAlgorithm.GNC_TLS
    )
    rotation_gnc_factor: float = 1.4
    rotation_max_iterations: int = 100
    rotation_cost_threshold: float = 1e-6
    rotation_tim_graph: InlierGraphFormulation = InlierGraphFormulation.CHAIN
    inlier_selection_mode: InlierSelectionMode = InlierSelectionMode.PMC_EXACT
    kcore_heuristic_threshold: float = 0.5
    # PMC_EXACT semantics inside the jitted solver: by default the escalated
    # b_rate == 1.0 clique round runs the on-device greedy heuristic (the
    # reference invokes the exact PMC branch-and-bound there, graph.cc:84-124
    # — combinatorial search does not map to dense device kernels). Set True
    # to route that round through a jax.pure_callback into the native C++
    # exact solver (clique/pmc.py). Off by default: a host callback stalls
    # the device program and the greedy mask is empirically equivalent on
    # scale-consistency graphs (see README "divergences").
    exact_clique_callback: bool = False
    use_max_clique: bool = True  # deprecated upstream; kept for parity
    max_clique_exact_solution: bool = True  # deprecated upstream
    max_clique_time_limit: float = 3600.0

    # --- dataset-level constants (compile-time macros in the reference) ----
    # PrNoise = 2 * NOISE_BOUND (registration.cc:36); the dataset noise bound
    # is the #define at registration.cc:32-35, independent of the per-solve
    # noise_bound above.
    noise_bound_dataset: float = 0.01

    # --- PSULVSB loop constants (hard-coded in the reference) --------------
    inner_noise_bound: float = 0.05  # registration.cc:938
    inner_cbar2: float = 1.0  # registration.cc:939
    inner_rotation_max_iterations: int = 100  # registration.cc:941
    inner_rotation_gnc_factor: float = 1.4  # registration.cc:942
    inner_rotation_cost_threshold: float = 0.005  # registration.cc:945
    rotation_similar: float = 0.01  # registration.cc:48
    local_max_iter: int = 10  # registration.cc:49
    local_confidence: float = 0.99  # Tpro_local, registration.cc:898
    host_confidence: float = 0.99  # Tpro_host, registration.cc:772
    max_host_rounds: int = 5  # qr_round_bound_limit, registration.cc:781
    time_budget_s: float = 60.0  # registration.cc:1475
    # Projected budget for the fused one-dispatch solver (solver/fused.py):
    # the whole host-round loop compiles into one lax.scan, so the host
    # clock the staged path checks between rounds (registration.cc:1475)
    # cannot be read mid-program. Instead the budget binds at TRACE time:
    # the scan length is min(max_host_rounds, time_budget_s /
    # fused_round_ceiling_s), with the ceiling a deliberately pessimistic
    # per-round device-time bound (20 ms per ROUND, far above a whole
    # warm fused solve). It never binds at the reference caps (60 s / 20 ms
    # = 3000 rounds vs the 5-round cap) but guarantees the 60 s semantics
    # survive if a caller grows max_host_rounds. <= 0 disables.
    fused_round_ceiling_s: float = 0.02
    stagnation_min_pro_local: float = 0.2  # registration.cc:1361

    # Histogram (registration.cc:687-688).
    hist_max_scale: float = 10000.0
    hist_bins_per_unit: int = 20

    # --- GROR initial alignment (registration_artificial.cc:571-576) -------
    # When on, GROR (gror/gror.py, ia_gror.hpp:368 equivalent) runs once
    # before the PSULVSB loop and its (R, t) seeds the warm state — the
    # artificial-data variant's initial-alignment stage. The local loop then
    # baselines hypotheses against the GROR solution (a hypothesis must beat
    # its sampled inlier count to displace it) and the early-accept
    # similarity test can fire against it from the first batch.
    gror_init: bool = False
    gror_resolution: float = 0.1  # cloud resolution; thresholds are 2x this
    gror_k_optimal: int = 800  # registration_artificial.cc:536

    # --- clique-seeded warm start (an addition to the reference) -----------
    # The faithful known-scale path feeds ALL basic TIMs to GNC
    # (registration.cc:984-991), which plateaus at >= 97% mismatch outliers;
    # the reference's harness escapes only via its 60 s budget. The compacted
    # reduced set is already a consistency graph (beta-window members at
    # known scale, peak+-1 ratio bins under scale estimation), so one greedy
    # clique over it + a chain-TIM decoupled solve over the clique points
    # yields a near-correct transform, which seeds the warm state: the local
    # loop baselines every hypothesis batch against it (a hypothesis must
    # beat its sampled inlier count to displace it) and host scoring adopts
    # it. Fully in-jit. The seed graph is rebuilt EXACTLY over the (C, C)
    # pair grid at seed time (known scale: beta window; estimate_scaling:
    # peak+-1 ratio bins with the peak from the pool-member median) rather
    # than scattered from the materialized pool — the pool is a uniform
    # thinning (config.pool_cap) and edge thinning destroys cliqueness
    # (measured 3DLoMatch recall 1.0 -> 0.967 from a thinned seed graph).
    # Under estimate_scaling the seed fires too: r4 ungated it after the
    # full-scale unknownScale protocol measured recall 0.967 -> 1.0 from
    # the ratio-window seed (7 of 8 failures were GNC plateaus with a
    # correct peak), with no poisoning observed across hostile 95-97%
    # sweeps (an earlier pool-edge ratio graph DID poison — RE 161 deg —
    # which is why pre-r4 builds gated it off).
    #
    # Modes: "auto" (default) runs the seed LAZILY — inside the round loop,
    # once, on the first stagnation-escalation signal — so easy pairs never
    # pay its (C, C) adjacency + greedy-clique cost (lazy rescues every
    # measured 98%-outlier failure, recall 0.975 -> 1.0 on the 240-pair
    # 3DLoMatch protocol). "eager" seeds before round 0
    # (bool True accepted as an alias); "off"/False disables.
    clique_init: str | bool = "auto"
    clique_cap: int = 256  # max clique members compacted for the seed solve
    clique_seed_min_size: int = 4  # below this the seed is discarded

    # --- algorithm-variant switches ----------------------------------------
    # The reference ships the PSULVSB family as separate source files
    # (SURVEY.md §0): registration_best.cc == the canonical algorithm (both
    # flags on); registration_WT.cc == the prior C-RANSAC baseline (no
    # probabilistic self-update, no weighted-SVD refinement); the nested
    # 2025-07-30 registration.cc == self-update commented out. Here they are
    # config flags.
    enable_self_update: bool = True
    enable_refinement: bool = True

    # --- global-translation rescue (an addition to the reference) ----------
    # The reference solves translation over the ROTATION-INLIER subset only
    # (registration.cc:1114-1154, 1248-1250). Under repeated scene geometry
    # that subset aliases: TIMs are translation-invariant, so matches onto a
    # TRANSLATED COPY of a repeated structure agree with the true inliers
    # through the scale and rotation stages and split only at translation,
    # where the subset can prefer the wrong copy. Measured on the end-to-end
    # front-end protocol (real FPFH matches, ~1% inlier rate): 3/120 failing
    # pairs whose solver pose carried LESS global support than ground truth,
    # all three recovered by re-stabbing translation over ALL real
    # correspondences under the final rotation, gated on the global support
    # count strictly improving (docs/FRONTEND_FAILURES.md). Off by default:
    # the gate makes it a no-op wherever the subset stab already found the
    # global mode, but it adds a dense (C, C) vote to finalize — enable it
    # for descriptor-front-end regimes (frontend_solver_params does).
    translation_rescue: bool = False

    # Reduced-set construction:
    # - "dense": exact membership over the (C, C) pair grid (direct-
    #   difference TIM lengths, exact full-range histogram peak) +
    #   hashed-priority approx_max_k compaction.
    # - "exact": gather-based sweep of the full O(C^2) TIM universe (the
    #   reference-literal form); peak + compaction are sort-based.
    # - "exact_hist": exact histogram peak and |reduced| from a row-blocked
    #   sweep of the pair grid (ops/pair_grid.py, O(block * C) memory),
    #   reduced pool rejection-sampled against the peak. estimate_scaling
    #   only (known scale has no histogram).
    # - "exact_beta": exact known-scale |reduced| from the same row-blocked
    #   sweep of the beta-window test, reduced pool rejection-sampled.
    #   Known scale only.
    # - "sampled": estimate the peak from a pair subsample and
    #   rejection-sample the reduced set (uniform over the reduced set).
    # - "auto": by C alone — "dense" up to dense_init_max_c, else
    #   "exact_hist" (estimate_scaling) / "exact_beta" (known scale).
    init_mode: str = "auto"
    # Largest C the dense init materializes (C, C) f32 grids for (about
    # 1.1 GB of device memory at 8192; beyond it "auto" switches to the
    # row-blocked sweeps).
    dense_init_max_c: int = 8192
    init_peak_sample: int = 1 << 20  # pairs used to locate the peak bin
    init_reject_budget: int = 1 << 21  # pair draws for reduced-set filling

    # --- capacity knobs (static shapes replacing dynamic resizes) ----------
    # Upper bound on the compacted reduced line-vector set. The O(C^2) TIM
    # universe is touched exactly once (histogram + compaction at init);
    # every per-round op works on this compacted index array instead. When
    # the true reduced set exceeds the cap it is uniformly decimated.
    reduced_cap: int = 131072
    # Slot capacity of the MATERIALIZED reduced pool (the compacted
    # (i, j) index arrays the rounds actually sample from). Decoupled from
    # reduced_cap (which only clamps the |reduced| COUNT driving the
    # floor(|reduced| * rate) sample-size rule): per round the sampler
    # consumes at most sampled_cap TIMs, and drawing without replacement
    # from a uniform random pool-subset of the reduced set is marginally
    # identical to drawing from the full set (exchangeability) — only the
    # cross-round joint distribution correlates slightly, a divergence
    # class the reference itself has (it re-samples one fixed reduced set
    # every round). Materializing fewer slots saves device time: the dense
    # init's hashed-priority compaction is an approx_max_k whose cost scales
    # with k (a full sort of the C^2 priorities at large k).
    pool_cap: int = 16384
    # Pool slots the init fill leaves FREE so self-update appends always
    # have somewhere to land (with fill == capacity, a reduced set larger
    # than the pool would start full and silently drop every self-update
    # TIM — worse than the old 131072 behavior at bunny scale). Effective
    # reserve = min(pool_reserve, pool // 8).
    pool_reserve: int = 2048
    # Cap on points admitted per self-update round and on the kept-inlier
    # member list the new TIMs pair against (registration.cc:803-827).
    self_update_new_cap: int = 64
    self_update_member_cap: int = 512
    # Upper bound on TIM indices kept in the sampled set per host round.
    sampled_cap: int = 4096
    # Upper bound on TIMs per basic (hypothesis) set.
    basic_cap: int = 2048
    # Hypotheses evaluated in parallel per local batch (vmap width). The
    # reference evaluates 1 per basic iteration; local_r advances by the
    # number of hypotheses consumed.
    hypothesis_batch: int = 16
    # Hard ceiling on local batches per host round, as a multiple of
    # local_max_iter (see _local_stage): the serial reference's local loop
    # has no such ceiling — it runs until confidence/stagnation/early-accept
    # — but between those bounds pro_local is monotone in local_r, so
    # ceiling_factor * local_max_iter hypotheses cover all but
    # mid-confidence plateaus (sampled inlier rate ~0.02-0.05, where
    # confidence needs local_r in the hundreds). On a plateau the round
    # proceeds to host scoring exactly as a confidence exit would; raise the
    # factor for serial-faithful termination (tests/test_registration.py
    # has the adversarial plateau fixture showing outcome equivalence).
    local_batch_ceiling_factor: int = 4
    # Draws for the 1-point RANSAC scale consensus.
    scale_max_draws: int = 256
    # Scale estimator: "ransac1pt" (the fork's RANSAC-mode ScalarTLSEstimator,
    # registration.cc:67-119) or "vote" (upstream's deterministic adaptive
    # voting estimate_tiled, registration.cc:206-320 — O(L^2) grid, use for
    # upstream/MATLAB parity or small TIM sets).
    scale_estimator: str = "ransac1pt"
    # Rotation-from-correlation method inside the GNC loop: "power"
    # (shifted power iteration, pure matmuls — fastest under vmapped
    # while_loops) or "eigh" (exact 4x4 eigendecomposition).
    gnc_rot_method: str = "power"

    @property
    def pr_noise(self) -> float:
        """PrNoise = 2 * dataset noise bound (registration.cc:36)."""
        return 2.0 * self.noise_bound_dataset

    @property
    def clique_eager(self) -> bool:
        """Seed before round 0 (clique_init="eager"; True is an alias)."""
        self._check_clique_init()
        return self.clique_init in (True, "eager")

    @property
    def clique_lazy(self) -> bool:
        """Seed once, in-loop, on the first escalation (clique_init="auto")."""
        self._check_clique_init()
        return self.clique_init == "auto"

    def _check_clique_init(self) -> None:
        if self.clique_init not in (True, False, "eager", "auto", "off"):
            raise ValueError(
                f"clique_init must be 'auto'|'eager'|'off' (or a bool), "
                f"got {self.clique_init!r}"
            )

    def resolve_inlier_selection(self) -> InlierSelectionMode:
        """Deprecated-field handling (registration.cc:628-637)."""
        mode = self.inlier_selection_mode
        if not self.use_max_clique:
            mode = InlierSelectionMode.NONE
        elif not self.max_clique_exact_solution:
            mode = InlierSelectionMode.PMC_HEU
        return mode

    def effective_clique_algorithm(self) -> str:
        """What the clique stage ACTUALLY runs — the honest name the enum
        alone doesn't give (`PMC_EXACT` with
        `exact_clique_callback=False` runs the on-device greedy, a measured
        stand-in for exact PMC backed by docs/CLIQUE_AUDIT.md, not exact
        search). Recorded in harness fingerprints so artifacts never
        promise exactness the path didn't run."""
        mode = self.resolve_inlier_selection()
        if mode == InlierSelectionMode.NONE:
            return "none"
        if mode == InlierSelectionMode.KCORE_HEU:
            return "kcore-heuristic"
        if mode == InlierSelectionMode.PMC_EXACT and self.exact_clique_callback:
            return "native-exact-callback"
        return "greedy-kcore (exact-audited)"

    def replace(self, **kw) -> "SolverParams":
        return dataclasses.replace(self, **kw)

    # Dataset presets replacing the reference's compile-time #define blocks
    # (registration.cc:32-35, PSULVSB.cc:24, registration_WT.cc:33).
    # Keyword overrides win over the preset values.
    @staticmethod
    def preset_3dmatch(**kw) -> "SolverParams":
        return SolverParams(**{"noise_bound": 0.01, "noise_bound_dataset": 0.01, **kw})

    @staticmethod
    def preset_kitti(**kw) -> "SolverParams":
        return SolverParams(**{"noise_bound": 0.1, "noise_bound_dataset": 0.1, **kw})

    @staticmethod
    def preset_artificial(**kw) -> "SolverParams":
        return SolverParams(
            **{
                "noise_bound": 0.05,
                "noise_bound_dataset": 0.05,
                "estimate_scaling": False,
                **kw,
            }
        )

    @staticmethod
    def preset_artificial_gror(**kw) -> "SolverParams":
        """Artificial-data variant with GROR initial alignment
        (registration_artificial.cc:571-576: GROR seeds the solver on the
        synthetic protocol; resolution = the protocol noise bound)."""
        return SolverParams.preset_artificial(
            **{"gror_init": True, "gror_resolution": 0.05, **kw}
        )

    @staticmethod
    def preset_whu_tls(**kw) -> "SolverParams":
        return SolverParams(**{"noise_bound": 0.15, "noise_bound_dataset": 0.15, **kw})

    # Variant presets (SURVEY.md §0 ground truth on variants).
    @staticmethod
    def preset_cransac_wt(**kw) -> "SolverParams":
        """registration_WT.cc: prior C-RANSAC baseline — NOISE_BOUND 0.05,
        no self-update, no weighted-SVD refinement."""
        return SolverParams(
            **{
                "noise_bound": 0.05,
                "noise_bound_dataset": 0.05,
                "enable_self_update": False,
                "enable_refinement": False,
                **kw,
            }
        )

    @staticmethod
    def preset_psulvsb_2025_07(**kw) -> "SolverParams":
        """Nested TEASER-plusplus/teaser/src/registration.cc (2025-07-30
        experiment): self-update block commented out, outer bound from
        ransac_max_iterations = 5."""
        return SolverParams(
            **{"enable_self_update": False, "max_host_rounds": 5, **kw}
        )
