"""Straggler-compaction driver (core/solve_compact.py) vs the single-shot
SL solver.

Compaction only reschedules WHERE each lane's iterations run (chunked
dispatches, lane moves between batch shapes); the per-instance update
sequence is untouched, so every Solution field must match the single-shot
SL solve exactly.  Run on CPU, where the backward recursion is the XLA scan
reference.
"""

import jax
import jax.numpy as jnp
import numpy as np

from iterativelqr_tpu import Options
from iterativelqr_tpu.core.solve_compact import make_compacted_solve_fn
from iterativelqr_tpu.core.spec import build_spec
from iterativelqr_tpu.models import car
from iterativelqr_tpu.ops.rollout import open_loop_rollout
from iterativelqr_tpu.parallel.batch import make_batched_solve_fn

_BASE = dict(
    record_traces=False,
    backward_pass="packed",
    max_iterations=10,
    max_dual_updates=4,
)


def _spread_batch(T, B, dtype=jnp.float32):
    """Perturbed car swing-in: iteration counts spread ~8-27, so the live
    set collapses mid-solve (measured: ~17% live by iteration 18) and the
    driver actually re-packs 2048 -> 1024."""
    dynamics, objective, constraints, x1, xT = car.problem(T)
    spec = build_spec(dynamics, objective, constraints)
    x0 = jnp.zeros((B, spec.nx), dtype).at[:, : x1.shape[0]].set(
        x1.astype(dtype)
    )
    x0 = x0 + 0.3 * jax.random.normal(jax.random.PRNGKey(11), (B, spec.nx), dtype)
    us = jnp.full((B, T - 1, spec.nu), 0.01, dtype)
    ws = jnp.zeros((B, T, max(spec.npar, 0)), dtype)
    xs = jax.vmap(lambda x, u, w: open_loop_rollout(spec, x, u, w))(x0, us, ws)
    return spec, xs, us, ws


def _assert_solutions_equal(out, ref):
    # the iterate sequence (everything the solver loop carries) must be
    # BITWISE identical: compaction only reschedules where lanes run
    for name in (
        "xs", "us", "objective", "max_violation", "status", "iterations",
        "al_iterations", "step_size", "duals", "penalty", "reg",
    ):
        np.testing.assert_array_equal(
            np.asarray(getattr(out, name)), np.asarray(getattr(ref, name)),
            err_msg=name,
        )
    # exit diagnostics (K/k/gradient_norm) are recomputed from that
    # bitwise-identical state, but in a separately-jitted finish program
    # whose fusion rounds differently from the eager/fused single-shot path.
    # Almost all entries agree to rounding; at PD-MARGINAL exits (warm
    # re-solves decay reg to its minimum) a last-bit difference can flip the
    # Cholesky ok test and hence the regularization retry, legitimately
    # changing that instance's reported gains — so assert near-total
    # agreement rather than universal closeness.
    for name in ("K", "k", "gradient_norm"):
        a = np.asarray(getattr(out, name), np.float64)
        b = np.asarray(getattr(ref, name), np.float64)
        mismatch = np.abs(a - b) > 5e-2 + 5e-2 * np.abs(b)
        assert mismatch.mean() < 0.005, (
            f"{name}: {mismatch.mean():.4%} of entries beyond tolerance"
        )


def test_compacted_matches_single_shot_with_repack():
    T, B = 8, 2048
    spec, xs, us, ws = _spread_batch(T, B)
    opts = Options(batched_solver="sl", **_BASE)
    ref = make_batched_solve_fn(spec, opts)(xs, us, ws)
    it = np.asarray(ref.iterations)
    # the scenario must actually have a tail that lets the driver re-pack:
    # at the iteration-18 chunk boundary, under half the batch still live
    # (so B_next = 1024 <= B/2) while some lanes keep iterating past it
    assert float((it > 18).mean()) < 0.5
    assert int(it.max()) > 18
    out = make_compacted_solve_fn(
        spec, opts, chunk=6, rescue=False
    )(xs, us, ws)
    _assert_solutions_equal(out, ref)


def test_compacted_matches_single_shot_no_repack():
    # B at the 1024 granularity floor: chunking only, no lane moves
    T, B = 8, 64
    spec, xs, us, ws = _spread_batch(T, B)
    opts = Options(batched_solver="sl", **_BASE)
    ref = make_batched_solve_fn(spec, opts)(xs, us, ws)
    out = make_compacted_solve_fn(
        spec, opts, chunk=4, rescue=False
    )(xs, us, ws)
    _assert_solutions_equal(out, ref)


def test_compacted_dual_warm_start():
    """Warm-started compacted solve == warm single-shot SL solve."""
    T, B = 8, 64
    spec, xs, us, ws = _spread_batch(T, B)
    opts = Options(batched_solver="sl", **_BASE)
    cold = make_batched_solve_fn(spec, opts)(xs, us, ws)
    from iterativelqr_tpu.core.solve_sl import make_batched_solve_sl

    ref = make_batched_solve_sl(
        spec, opts, dual_warm_start=True
    )(xs, us, ws, cold.duals, cold.penalty)
    out = make_compacted_solve_fn(
        spec, opts, chunk=4, dual_warm_start=True,
        rescue=False,
    )(xs, us, ws, cold.duals, cold.penalty)
    _assert_solutions_equal(out, ref)


def test_rescue_resolves_capped_failures():
    """Any lane the truncated (early_round_iteration_cap) schedule leaves
    infeasible must be re-solved at the exact uncapped schedule and patched
    into the Solution: the capped driver's solved set is a superset of the
    uncapped solver's.  Scenario: frozen penalty (scaling_penalty=1) makes
    feasibility REQUIRE dual ascent; cap=1 with BOTH in-solver safety
    mechanisms disabled (progress gate off, limiter off) never ascends, so
    at least one lane exits infeasible and triggers the rescue."""
    T, B = 8, 16
    dynamics, objective, constraints, x1, _ = car.problem(T)
    spec = build_spec(dynamics, objective, constraints)
    x0 = jnp.zeros((B, spec.nx), jnp.float32).at[:, : x1.shape[0]].set(
        x1.astype(jnp.float32)
    ) + 0.1 * jax.random.normal(jax.random.PRNGKey(11), (B, spec.nx),
                                jnp.float32)
    us = jnp.full((B, T - 1, spec.nu), 0.01, jnp.float32)
    ws = jnp.zeros((B, T, max(spec.npar, 0)), jnp.float32)
    from iterativelqr_tpu.ops.rollout import open_loop_rollout

    xs = jax.vmap(lambda x, u, w: open_loop_rollout(spec, x, u, w))(
        x0, us, ws
    )
    opts = Options(
        record_traces=False, backward_pass="packed", max_iterations=10,
        max_dual_updates=10, batched_solver="sl",
        scaling_penalty=1.0, adaptive_penalty=False,
        early_round_iteration_cap=1, max_consecutive_truncations=999,
        truncation_requires_progress=False,
    )
    tol = opts.constraint_tolerance
    bare = make_compacted_solve_fn(
        spec, opts, chunk=8, rescue=False
    )(xs, us, ws)
    failed = np.flatnonzero(np.asarray(bare.max_violation) > tol)
    assert failed.size >= 1, "scenario no longer exercises the failure mode"
    out = make_compacted_solve_fn(
        spec, opts, chunk=8, rescue=True
    )(xs, us, ws)
    v = np.asarray(out.max_violation)
    assert bool((v <= tol).all()), f"rescue left lanes infeasible: {v.max()}"
    # rescued rows are exactly the uncapped solver's iterate sequence;
    # untouched rows are exactly the capped driver's
    import dataclasses as _dc

    ref = make_batched_solve_fn(
        spec, _dc.replace(opts, early_round_iteration_cap=None),
        )(xs, us, ws)
    ok = np.setdiff1d(np.arange(B), failed)
    for name in ("xs", "us", "objective", "max_violation", "iterations",
                 "duals", "penalty"):
        a = np.asarray(getattr(out, name))
        np.testing.assert_array_equal(
            a[failed], np.asarray(getattr(ref, name))[failed],
            err_msg=f"{name} (rescued rows)",
        )
        np.testing.assert_array_equal(
            a[ok], np.asarray(getattr(bare, name))[ok],
            err_msg=f"{name} (untouched rows)",
        )


def test_compacted_multi_device_matches_single():
    """Per-device compaction (devices=...) splits the batch into per-device
    sub-batches with interleaved driver loops; per-lane results must be
    bitwise the single-device driver's (lanes are independent — only the
    batch shapes they ride differ)."""
    T, B = 8, 2048
    spec, xs, us, ws = _spread_batch(T, B)
    opts = Options(batched_solver="sl", **_BASE)
    ref = make_compacted_solve_fn(spec, opts, chunk=6)(
        xs, us, ws
    )
    devs = jax.devices()[:2]
    assert len(devs) == 2
    out = make_compacted_solve_fn(
        spec, opts, chunk=6, devices=devs
    )(xs, us, ws)
    _assert_solutions_equal(out, ref)


def test_generalized_rescue_resolves_uncapped_failures():
    """lanes that exit infeasible under ANY schedule (no
    early_round_iteration_cap involved) get one grain-sized re-solve under
    ``rescue_options`` and their Solution rows patched.  Scenario: a
    deliberately tight iteration budget leaves 11/16 lanes infeasible; the
    rescue schedule (full budget + the default escalated
    regularization_initial=1e-3) solves every one of them — including lane
    11, which NO unregularized budget fixes (measured stuck at violation
    0.344 even at 100x10 iterations: the conditioning-divergence signature
    the strong rescue's reg floor is designed for)."""
    import dataclasses as _dc

    T, B = 8, 16
    spec, xs, us, ws = _spread_batch(T, B)
    opts = Options(
        record_traces=False, backward_pass="packed", batched_solver="sl",
        max_iterations=4, max_dual_updates=2,
    )
    tol = opts.constraint_tolerance
    bare = make_compacted_solve_fn(
        spec, opts, chunk=8, rescue=False
    )(xs, us, ws)
    failed = np.flatnonzero(
        ~(np.asarray(bare.max_violation) <= tol)
    )
    assert failed.size >= 1, "scenario no longer produces a failed lane"

    ropts = _dc.replace(opts, max_iterations=30, max_dual_updates=10,
                        regularization_initial=1e-3)
    out = make_compacted_solve_fn(
        spec, opts, chunk=8, rescue=True,
        rescue_options=ropts,
    )(xs, us, ws)
    v = np.asarray(out.max_violation)
    assert bool((v <= tol).all()), f"rescue left lanes infeasible: {v.max()}"

    # rescued rows are exactly the rescue-schedule solver's results from the
    # ORIGINAL inputs; untouched rows are exactly the bare driver's
    ref = make_batched_solve_fn(spec, ropts)(xs, us, ws)
    ok = np.setdiff1d(np.arange(B), failed)
    for name in ("xs", "us", "objective", "max_violation", "iterations",
                 "duals", "penalty"):
        a = np.asarray(getattr(out, name))
        np.testing.assert_array_equal(
            a[failed], np.asarray(getattr(ref, name))[failed],
            err_msg=f"{name} (rescued rows)",
        )
        np.testing.assert_array_equal(
            a[ok], np.asarray(getattr(bare, name))[ok],
            err_msg=f"{name} (untouched rows)",
        )


def test_rescue_detects_nan_lanes(caplog):
    """A manufactured genuinely-diverging lane (f32 overflow at init -> NaN
    violation) must be DETECTED as failed (NaN > tol is False — the
    detection uses ~(viol <= tol)) and re-solved; an unsolvable lane stays
    NaN (honest accounting), everything else stays solved."""
    import logging

    T, B = 8, 16
    spec, xs, us, ws = _spread_batch(T, B)
    opts = Options(
        record_traces=False, backward_pass="packed", batched_solver="sl",
        max_iterations=10, max_dual_updates=4,
    )
    xs = xs.at[3].set(xs[3] * jnp.float32(1e25))  # overflow -> NaN lane
    with caplog.at_level(logging.WARNING,
                         logger="iterativelqr_tpu.core.solve_compact"):
        out = make_compacted_solve_fn(
            spec, opts, chunk=8, rescue=True
        )(xs, us, ws)
    assert any("strong rescue" in r.message for r in caplog.records), (
        "NaN lane did not trigger the strong rescue"
    )
    v = np.asarray(out.max_violation)
    assert np.isnan(v[3]) or v[3] > opts.constraint_tolerance
