"""Solver options.

Mirrors the reference option set (reference: src/options.jl:1-14) with the same
defaults, plus new knobs for machinery the reference lacks (Quu regularization,
line-search grid size).  The dataclass is frozen and hashable so it can be closed
over by ``jax.jit``-compiled solve functions as a static configuration: changing
an option builds a new compiled program, matching XLA's trace-once model.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Options:
    # --- reference-parity options (src/options.jl:1-14) ---
    line_search: str = "armijo"  # "armijo" | "none"
    max_iterations: int = 100
    max_dual_updates: int = 10
    min_step_size: float = 1.0e-5
    objective_tolerance: float = 1.0e-3
    lagrangian_gradient_tolerance: float = 1.0e-3
    constraint_tolerance: float = 5.0e-3
    constraint_norm: float = math.inf  # reference hardcodes Inf-norm; so do we
    initial_constraint_penalty: float = 1.0
    scaling_penalty: float = 10.0
    max_penalty: float = 1.0e8
    verbose: bool = False

    # --- Armijo parameters (reference: src/forward_pass.jl:4-6) ---
    armijo_c1: float = 1.0e-4
    max_line_search_iterations: int = 25

    # --- new: adaptive Quu regularization (reference has none and never checks
    # its Cholesky, src/backward_pass.jl:69-73; see SURVEY.md "hard parts" #1) ---
    regularization_initial: float = 0.0
    regularization_min: float = 1.0e-6
    regularization_max: float = 1.0e12
    regularization_scale: float = 10.0
    max_regularization_steps: int = 20

    # --- new: adaptive AL penalty schedule (stall-gated growth).  The
    # reference multiplies the penalty by scaling_penalty after EVERY dual
    # update (src/augmented_lagrangian.jl:87-110) — one decade per round no
    # matter what the round achieved.  Measured on acrobot at reference
    # defaults, inner solves right after a dual update exit spuriously (a
    # floor-step accept trips the |dJ| test), wasting whole AL rounds while
    # the penalty crawls toward the decade that actually restructures the
    # trajectory.  With adaptive_penalty=True a round that fails to cut the
    # violation by penalty_stall_gate multiplies the penalty by an extra
    # scaling_penalty_stalled, reaching the working range in 1-2 rounds
    # (acrobot T=101: 99 -> 37 total inner iterations; T=51: 115 -> 65; no
    # change on problems the reference schedule already handles well).
    # Tolerances and the dual-ascent rule are unchanged.  Set False for the
    # exact reference schedule. ---
    adaptive_penalty: bool = True
    penalty_stall_gate: float = 0.25
    scaling_penalty_stalled: float = 100.0

    # --- new: fuse the outer AL loop and inner iLQR loop into ONE while loop
    # with per-instance AL state (default).  Under vmap the nested loops cost
    # the SUM over AL rounds of each round's max iteration count across the
    # batch; the fused loop costs only the max TOTAL count (measured B=4096
    # parity bench: per-instance max 238 iterations, nested loop trips 500+).
    # Per-instance semantics are identical (same iterate sequence, stopping
    # rules, and dual-update points; round-boundary objective is rebased
    # algebraically instead of re-evaluated).  False restores the nested
    # two-level loop. ---
    fused_al_loop: bool = True

    # --- new: in-flight progress lines from INSIDE the jitted solve (one per
    # AL round, via jax.debug.callback) — the reference prints during the
    # solve (src/solve.jl:40-45); `verbose` here renders the full table only
    # after the solve returns.  Zero cost when False (nothing is traced).
    # Meant for long single-instance solves; under vmap it fires per instance.
    live_progress: bool = False

    # --- new: per-iteration metric traces (cost / gradient / violation / step)
    # returned as arrays from the jitted solve; disable for maximum-throughput
    # batched sweeps where the trace buffers cost HBM bandwidth ---
    record_traces: bool = True

    # --- new: horizon-scan unroll factor (lax.scan unroll=) — amortizes
    # per-step loop overhead at some compile-time/program-size cost ---
    scan_unroll: int = 4

    # --- new: backward-pass implementation selector ---
    # "scan": sequential reverse lax.scan (default, matches reference recursion)
    # "associative": jax.lax.associative_scan parallel-prefix Riccati (O(log T) depth)
    # "packed": SL-layout derive -> Pallas-Triton backward pipeline
    #           (ops/packed_pipeline.py): under vmap the whole derivative +
    #           backward + Armijo-slope chain runs batch-trailing so the
    #           derivative stacks are born in the kernel's layout;
    #           single-instance calls, and batches whose recursion is the
    #           XLA scan (ops/packed_backward.py::riccati_impl), take the
    #           per-instance scan path
    # "auto" (default): associative for single-instance (latency-bound)
    #           solves, scan under vmap (throughput-bound batches) — the
    #           regime rule ops/backward.py::_assoc_wins; batched solves
    #           through make_batched_solve_fn additionally select the SL
    #           solver where parallel/batch.py::use_sl_solver says so
    backward_pass: str = "auto"

    # --- new: inexact early AL rounds (part of the adaptive schedule).
    # Converging every INTERMEDIATE AL subproblem to the full tolerances
    # wastes iterations refining a trajectory the next dual update is about
    # to restructure anyway: the slowest percentile of a batched parity
    # solve spends 41.6 iterations/round across 4-5 rounds
    # (benchmarks/tail_analysis.py) while the bulk needs 17.8.  With a cap,
    # a round hitting this many inner iterations is TRUNCATED as a pure
    # penalty-continuation step: the penalty grows (plain scaling_penalty),
    # but no dual ascent fires (ascending from an unconverged subproblem
    # writes garbage multipliers — measured batch failures) and the round
    # does not count against max_dual_updates (burning the dual budget on
    # truncations stranded the hardest 0.05% of a 4096 batch).  Rounds that
    # converge before the cap behave exactly as without it; the FIRST round
    # (lambda=0, rho=rho0 — it establishes the nominal trajectory) and the
    # last possible dual round always get the full max_iterations budget, and
    # a global max_iterations*max_dual_updates bound (the uncapped
    # algorithm's own worst case) guarantees termination.  Exit criteria
    # and tolerances are unchanged.  None = every round runs to
    # max_iterations (exact reference semantics). ---
    early_round_iteration_cap: "int | None" = None

    # --- new: progress gate for early_round_iteration_cap truncations.
    # A round may TRUNCATE only while the instance's max constraint
    # violation is GEOMETRICALLY below the previous AL round boundary's
    # (viol < truncation_progress_factor * viol_prev) — a round that
    # reaches the cap without that much feasibility progress keeps
    # iterating to its natural end (and so performs a proper dual ascent).
    # This blocks the measured truncation failure mode at its signature:
    # schedule-fragile instances ride an unbroken run of near-no-progress
    # truncations — penalty escalating (or, under a frozen penalty, doing
    # nothing at all), duals never ascending (reference ascent rule:
    # src/augmented_lagrangian.jl:87-110) — until the iteration budget is
    # exhausted and they exit infeasible.  A strict-decrease gate
    # (factor 1.0) was measured INSUFFICIENT: a doom-looping lane shaving
    # ~0.03%/round off its violation passes strict decrease forever
    # (tests/test_solve_sl.py frozen-penalty scenario, lane stuck at 1.049
    # vs tol 5e-3).  Healthy truncated rounds (the ones that carry the
    # cap's throughput win) cut the violation by several-x per round —
    # far below the default 0.75 factor — and pass untouched.  Ignored
    # when early_round_iteration_cap is None. ---
    truncation_requires_progress: bool = True
    truncation_progress_factor: float = 0.75

    # --- new: consecutive-truncation limit for early_round_iteration_cap.
    # An instance may truncate at most this many AL rounds IN A ROW; the
    # next round then runs to natural completion (and so performs a proper
    # dual ascent).  With the progress gate above (the primary safety
    # mechanism — it reacts to the doom-loop's signature, stalled
    # feasibility, instead of penalizing healthy streaks) this is a pure
    # backstop: streaks of PROGRESSING truncations are legitimate and
    # forcing a full round every 2 of them was measured as a throughput
    # REGRESSION on the parity bench.  Ignored when
    # early_round_iteration_cap is None. ---
    max_consecutive_truncations: int = 16

    # --- new: hard TOTAL inner-iteration budget across all AL rounds
    # (real-time-iteration mode; None = unlimited).  Unlike max_iterations
    # (a PER-ROUND cap), exhausting this budget stops the solve outright —
    # no dual update fires at the truncation point, so a capped warm-started
    # MPC step degrades to a truncated-but-sane solve instead of compounding
    # mid-convergence dual ascents (measured: capping via max_iterations=5
    # diverged acrobot MPC to viol 3e7 AND ran slower than uncapped). ---
    max_total_iterations: "int | None" = None

    # --- new: constraint-aware line-search acceptance (MPC transients) ---
    # Among the Armijo-accepted candidates, prefer the largest step that
    # does not WORSEN the max constraint violation (beyond the tolerance);
    # fall back to the plain Armijo winner when no accepted candidate
    # qualifies, so convergence behavior is preserved.  Motivation: a
    # budget-truncated MPC step can accept a long step that trades
    # feasibility for cost mid-ascent, producing transient violation
    # spikes (README MPC table, budget 8: worst transient 0.019); the
    # violation filter suppresses exactly those acceptances.  The
    # per-candidate violation is accumulated in the scoring scan's carry
    # (no extra rollouts) on both the per-instance path (what MPC uses)
    # and the SL batched solver (so batched MPC farms keep the SL layout).
    constraint_aware_acceptance: bool = False

    # --- new: full DDP (second-order dynamics terms) ---
    # The reference's backward pass is Gauss-Newton iLQR: it drops the
    # dynamics curvature terms sum_i Vx_i * d2f_i (src/backward_pass.jl:42-90
    # forms Q** from first-order f terms only).  With ddp=True the backward
    # recursion adds them (ops/backward.py::riccati_step f2 terms; tensors
    # from core/spec.py::hess_fn via jacfwd of the Jacobians, so manual user
    # Jacobians are honored).  Gains use Tassa-style STATE regularization
    # with a 1e-3-weighted diagonal share (ops/backward.py riccati_step DDP
    # branch): plain control-regularized DDP was measured wandering to a
    # 5x-worse acrobot local optimum in 321 iterations; with state reg it
    # reaches a BETTER optimum than GN (objective 176.7 vs 254.9 at
    # reference defaults, f64, T=101) in a similar count (144 vs 122).
    # Measured honestly: linear dynamics match GN exactly in exact
    # arithmetic (same iterate counts; <=1e-12 numerical difference from
    # compiled-program fusion ordering — tests/test_ddp.py), car converges
    # but needs ~5x the iterations (81 vs 16) — curvature helps or hurts
    # per problem, which is why the default is False.  Constraint curvature
    # stays Gauss-Newton
    # (standard AL-DDP practice; the AL penalty Hessian keeps the
    # reference's form, ops/al.py).
    #
    # Restrictions: the contraction needs Vx(t+1) inside the step, so DDP
    # requires the sequential scan recursion — incompatible with
    # backward_pass="associative" (per-step elements must not depend on
    # downstream V) and "packed" (the kernel does not carry the
    # second-derivative stacks); "auto" resolves to the scan.  The SL batched
    # solver falls back to the vmap path (parallel/batch.py::_sl_eligible).
    ddp: bool = False

    # --- new: batched-solver implementation selector ---
    # "auto": where parallel/batch.py::use_sl_solver says so (the platforms
    #         on which it measured faster) and the options allow it
    #         (backward_pass "packed"/"auto", no traces/live_progress/ddp,
    #         the fused AL loop), batched solves run the SL-layout solver
    #         (core/solve_sl.py) — the whole loop in [T, *dims, S, 128];
    #         everything else vmaps the per-instance solve (identical
    #         per-instance semantics either way)
    # "vmap": always vmap the per-instance solve
    # "sl":   require the SL solver (raises if options are incompatible)
    batched_solver: str = "auto"

    def __post_init__(self):
        if self.line_search not in ("armijo", "none"):
            raise ValueError(f"unknown line_search {self.line_search!r}")
        if self.backward_pass not in (
            "scan", "associative", "packed", "auto"
        ):
            raise ValueError(f"unknown backward_pass {self.backward_pass!r}")
        if self.batched_solver not in ("auto", "vmap", "sl"):
            raise ValueError(f"unknown batched_solver {self.batched_solver!r}")
        if self.ddp and self.backward_pass in ("associative", "packed"):
            raise ValueError(
                f'ddp=True requires the sequential scan recursion (the DDP '
                f'contraction uses Vx(t+1) inside the step); '
                f'backward_pass={self.backward_pass!r} is incompatible — '
                'use "scan" or "auto"'
            )
        if self.ddp and self.batched_solver == "sl":
            raise ValueError(
                "ddp=True is not supported by the SL batched solver (its "
                'backward recursion carries no second-derivative '
                'stacks); use batched_solver="vmap" or "auto"'
            )
        if self.max_total_iterations is not None and self.max_total_iterations < 1:
            raise ValueError("max_total_iterations must be >= 1")
        if not (0.0 < self.truncation_progress_factor <= 1.0):
            raise ValueError(
                "truncation_progress_factor must be in (0, 1]"
            )
        if (self.early_round_iteration_cap is not None
                and self.early_round_iteration_cap < 1):
            raise ValueError("early_round_iteration_cap must be >= 1")
        if self.max_consecutive_truncations < 1:
            raise ValueError("max_consecutive_truncations must be >= 1")

    @property
    def num_step_sizes(self) -> int:
        """Number of line-search candidates alpha_j = 0.5**j.

        Reproduces the reference's serial halving loop (src/forward_pass.jl:28-54):
        step sizes are tried from 1.0 downward while alpha >= min_step_size, capped
        at max_line_search_iterations trials.  Here all candidates are rolled out in
        one vmapped batch and the largest acceptable alpha is selected, which is
        semantically identical to first-accept serial backtracking.
        """
        if self.min_step_size <= 0:
            return self.max_line_search_iterations
        n = int(math.floor(math.log2(1.0 / self.min_step_size))) + 1
        # guard: 0.5**(n-1) must be >= min_step_size
        while n > 1 and 0.5 ** (n - 1) < self.min_step_size:
            n -= 1
        return min(n, self.max_line_search_iterations)
