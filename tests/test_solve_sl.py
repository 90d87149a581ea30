"""SL-layout batched solver (core/solve_sl.py) vs the vmap path.

The SL solver runs the ENTIRE fused AL x iLQR loop in SL layout
``[T, *dims, S, 128]``; per-instance semantics must match vmapping the
per-instance fused solve (same iterate sequence, stopping rules, dual-update
points).  On CPU the backward recursion is the XLA scan reference; the
kernel is pinned against it in tests/test_riccati_kernel.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from iterativelqr_tpu import Options
from iterativelqr_tpu.core.spec import build_spec
from iterativelqr_tpu.models import acrobot, car
from iterativelqr_tpu.ops.rollout import open_loop_rollout
from iterativelqr_tpu.parallel.batch import make_batched_solve_fn


def _batch(mod, T, B, u0, dtype=jnp.float32):
    dynamics, objective, constraints, x1, xT = mod.problem(T)
    spec = build_spec(dynamics, objective, constraints)
    key = jax.random.PRNGKey(3)
    x0 = jnp.zeros((B, spec.nx), dtype).at[:, : x1.shape[0]].set(
        x1.astype(dtype)
        + 0.02 * jax.random.normal(key, (B, x1.shape[0]), dtype)
    )
    us = jnp.full((B, T - 1, spec.nu), u0, dtype)
    ws = jnp.zeros((B, T, max(spec.npar, 0)), dtype)
    xs = jax.vmap(lambda x, u, w: open_loop_rollout(spec, x, u, w))(
        x0, us, ws
    )
    return spec, xs, us, ws


_BASE = dict(
    record_traces=False,
    backward_pass="packed",
    max_iterations=12,
    max_dual_updates=3,
)


@pytest.mark.parametrize("mod,T,u0", [(acrobot, 9, 0.05), (car, 8, 0.01)])
def test_sl_solver_matches_vmap(mod, T, u0):
    B = 4
    spec, xs, us, ws = _batch(mod, T, B, u0)
    # vmap reference: without the kernel the custom_vmap rule takes the
    # per-instance scan path, which the packed pipeline is pinned against
    ref_fn = make_batched_solve_fn(
        spec, Options(batched_solver="vmap", **_BASE)
    )
    sl_fn = make_batched_solve_fn(
        spec, Options(batched_solver="sl", **_BASE))
    ref = ref_fn(xs, us, ws)
    out = sl_fn(xs, us, ws)
    for name in ("xs", "us", "objective", "max_violation", "gradient_norm"):
        np.testing.assert_allclose(
            np.asarray(getattr(out, name)),
            np.asarray(getattr(ref, name)),
            rtol=2e-3, atol=2e-3, err_msg=name,
        )
    # the iterate sequence (not just the fixed point) must match
    np.testing.assert_array_equal(
        np.asarray(out.iterations), np.asarray(ref.iterations)
    )
    np.testing.assert_array_equal(
        np.asarray(out.al_iterations), np.asarray(ref.al_iterations)
    )
    np.testing.assert_array_equal(
        np.asarray(out.status), np.asarray(ref.status)
    )


def test_sl_solver_shared_ws_in_axes():
    B = 3
    spec, xs, us, ws = _batch(acrobot, 9, B, 0.05)
    opts = Options(batched_solver="sl", **_BASE)
    fn = make_batched_solve_fn(
        spec, opts, in_axes=(0, 0, None))
    out = fn(xs, us, ws[0])
    fn_b = make_batched_solve_fn(spec, opts)
    ref = fn_b(xs, us, ws)
    np.testing.assert_allclose(
        np.asarray(out.xs), np.asarray(ref.xs), rtol=1e-6, atol=1e-6
    )


def test_sl_requires_compatible_options():
    spec, *_ = _batch(acrobot, 9, 2, 0.05)
    with pytest.raises(ValueError):
        make_batched_solve_fn(
            spec,
            Options(batched_solver="sl", record_traces=True,
                    backward_pass="packed"),
            )


def test_sl_solver_unconstrained_nc0():
    """nc=0 (pure iLQR) through the SL solver: zero-width constraint arrays
    must flow through the packed pipeline and AL machinery untouched."""
    from iterativelqr_tpu.core.spec import Constraint
    from iterativelqr_tpu.models import pendulum

    T, B = 8, 2
    dynamics, objective, _, x1, xT = pendulum.problem(T)
    spec = build_spec(dynamics, objective, [Constraint() for _ in range(T)])
    assert spec.nc == 0
    key = jax.random.PRNGKey(5)
    x0 = jnp.zeros((B, spec.nx), jnp.float32).at[:, : x1.shape[0]].set(
        x1.astype(jnp.float32)
        + 0.3 * jax.random.normal(key, (B, x1.shape[0]), jnp.float32)
    )
    us = 0.5 * jax.random.normal(
        jax.random.PRNGKey(6), (B, T - 1, spec.nu), jnp.float32
    )
    ws = jnp.zeros((B, T, max(spec.npar, 0)), jnp.float32)
    xs = jax.vmap(lambda x, u, w: open_loop_rollout(spec, x, u, w))(
        x0, us, ws
    )
    base = dict(record_traces=False, backward_pass="packed",
                max_iterations=8, max_dual_updates=2)
    ref = make_batched_solve_fn(
        spec, Options(batched_solver="vmap", **base)
    )(xs, us, ws)
    out = make_batched_solve_fn(
        spec, Options(batched_solver="sl", **base))(xs, us, ws)
    assert int(np.max(np.asarray(ref.iterations))) > 1
    np.testing.assert_array_equal(
        np.asarray(out.iterations), np.asarray(ref.iterations)
    )
    np.testing.assert_allclose(
        np.asarray(out.xs), np.asarray(ref.xs), rtol=2e-3, atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(out.objective), np.asarray(ref.objective),
        rtol=2e-3, atol=2e-3,
    )


def test_sl_sharded_matches_unsharded():
    """SL solver under shard_map on the virtual 8-device mesh: each device
    solves its local shard independently; result must match the unsharded
    SL solve."""
    from iterativelqr_tpu.parallel.shard import (
        default_mesh,
        make_sharded_solve_fn,
        shard_batch,
    )

    B = 8
    spec, xs, us, ws = _batch(acrobot, 9, B, 0.05)
    opts = Options(
        batched_solver="sl", record_traces=False, backward_pass="packed",
        max_iterations=4, max_dual_updates=2,
    )
    mesh = default_mesh()
    assert mesh.size == 8
    sharded = make_sharded_solve_fn(
        spec, opts, mesh=mesh, with_stats=True)
    xs_s, us_s, ws_s = shard_batch(mesh, "batch", xs, us, ws)
    sol_s, stats = sharded(xs_s, us_s, ws_s)
    ref = make_batched_solve_fn(spec, opts)(xs, us, ws)
    np.testing.assert_allclose(
        np.asarray(sol_s.xs), np.asarray(ref.xs), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_array_equal(
        np.asarray(sol_s.iterations), np.asarray(ref.iterations)
    )
    assert np.isfinite(float(stats.mean_objective))


@pytest.mark.parametrize(
    "solver,platform,want",
    [("auto", "cpu", False), ("auto", "gpu", True), ("vmap", "gpu", False),
     ("sl", "cpu", True)],
)
def test_use_sl_solver_by_platform(solver, platform, want):
    """batched_solver="auto" takes the SL solver on the GPU (the measured
    winner) and vmap on the CPU; "sl" and "vmap" are not overridden."""
    from iterativelqr_tpu.parallel.batch import use_sl_solver

    opts = Options(batched_solver=solver, **_BASE)
    assert use_sl_solver(opts, platform=platform) == want
    # ineligible options never take the SL solver under auto
    traced = Options(batched_solver=solver, **dict(_BASE, record_traces=True))
    if solver == "auto":
        assert not use_sl_solver(traced, platform=platform)


def test_auto_selects_vmap_on_cpu():
    """auto on CPU must silently use the vmap path (use_sl_solver)."""
    spec, xs, us, ws = _batch(acrobot, 9, 2, 0.05)
    fn = make_batched_solve_fn(
        spec, Options(batched_solver="auto", **_BASE)
    )
    sol = fn(xs, us, ws)
    assert sol.xs.shape[0] == 2


def test_sl_matches_vmap_with_early_round_cap():
    """Inexact early rounds (early_round_iteration_cap) must produce the
    same iterate sequence through the SL solver as through the vmap path,
    including the truncated-round stall exemption in the AL transition."""
    B = 4
    spec, xs, us, ws = _batch(acrobot, 9, B, 0.05)
    base = dict(_BASE, early_round_iteration_cap=3)
    ref = make_batched_solve_fn(
        spec, Options(batched_solver="vmap", **base)
    )(xs, us, ws)
    out = make_batched_solve_fn(
        spec, Options(batched_solver="sl", **base))(xs, us, ws)
    # the cap must actually fire somewhere (rounds of exactly 3 iterations)
    assert int(np.max(np.asarray(ref.al_iterations))) >= 2
    np.testing.assert_array_equal(
        np.asarray(out.iterations), np.asarray(ref.iterations)
    )
    np.testing.assert_array_equal(
        np.asarray(out.al_iterations), np.asarray(ref.al_iterations)
    )
    np.testing.assert_allclose(
        np.asarray(out.xs), np.asarray(ref.xs), rtol=2e-3, atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(out.penalty), np.asarray(ref.penalty), rtol=1e-5
    )


def test_sl_dual_warm_start_matches_vmap():
    """Batched dual warm start through the SL solver must match the vmapped
    warm per-instance solve (batched-MPC re-solve path)."""
    B = 3
    spec, xs, us, ws = _batch(car, 8, B, 0.01)
    base = dict(_BASE)
    # carried duals/penalties from a cold solve
    cold = make_batched_solve_fn(
        spec, Options(batched_solver="sl", **base))(xs, us, ws)
    duals0, pen0 = cold.duals, cold.penalty
    ref = make_batched_solve_fn(
        spec, Options(batched_solver="vmap", **base), dual_warm_start=True
    )(xs, us, ws, duals0, pen0)
    out = make_batched_solve_fn(
        spec, Options(batched_solver="sl", **base), dual_warm_start=True,
    )(xs, us, ws, duals0, pen0)
    np.testing.assert_array_equal(
        np.asarray(out.iterations), np.asarray(ref.iterations)
    )
    np.testing.assert_allclose(
        np.asarray(out.xs), np.asarray(ref.xs), rtol=2e-3, atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(out.objective), np.asarray(ref.objective),
        rtol=2e-3, atol=2e-3,
    )
    # warm solves converge at least as fast as cold ones
    assert int(np.max(np.asarray(out.iterations))) <= int(
        np.max(np.asarray(cold.iterations))
    )


def test_consecutive_truncation_limiter_restores_convergence():
    """With a frozen penalty (scaling_penalty=1) feasibility REQUIRES dual
    ascent — an unbroken run of truncated rounds (no ascent) can never
    converge.  Both safety mechanisms must independently recover every
    instance the unguarded truncation schedule loses: the progress gate
    (truncation_requires_progress, the default — no-progress rounds run to
    natural completion and so perform a real ascent) and the
    consecutive-truncation limiter backstop; and the vmap path must agree
    with the SL path on the default safety semantics.  (AL ascent
    semantics: /root/reference/src/augmented_lagrangian.jl:87-110.)"""
    T, B = 8, 16
    dynamics, objective, constraints, x1, _ = car.problem(T)
    spec = build_spec(dynamics, objective, constraints)
    # spread wide enough that at least one instance needs the ascent the
    # unlimited-truncation schedule denies it
    x0 = jnp.zeros((B, spec.nx), jnp.float32).at[:, : x1.shape[0]].set(
        x1.astype(jnp.float32)
    ) + 0.1 * jax.random.normal(jax.random.PRNGKey(11), (B, spec.nx),
                                jnp.float32)
    us = jnp.full((B, T - 1, spec.nu), 0.01, jnp.float32)
    ws = jnp.zeros((B, T, max(spec.npar, 0)), jnp.float32)
    xs = jax.vmap(lambda x, u, w: open_loop_rollout(spec, x, u, w))(
        x0, us, ws
    )
    base = dict(
        record_traces=False, backward_pass="packed", max_iterations=10,
        max_dual_updates=10, batched_solver="sl",
        scaling_penalty=1.0, adaptive_penalty=False,
    )

    def run(**kw):
        return make_batched_solve_fn(
            spec, Options(**base, **kw))(xs, us, ws)

    tol = Options(**base).constraint_tolerance
    ref = run()  # uncapped
    assert bool((np.asarray(ref.max_violation) <= tol).all())
    # all safety off: pure penalty-continuation, at least one lane stuck
    loose = run(
        early_round_iteration_cap=1, max_consecutive_truncations=999,
        truncation_requires_progress=False,
    )
    n_stuck = int((np.asarray(loose.max_violation) > tol).sum())
    assert n_stuck >= 1, "scenario no longer exercises the failure mode"
    # progress gate alone (the default mechanism): every lane recovered
    gated = run(early_round_iteration_cap=1,
                max_consecutive_truncations=999)
    assert bool((np.asarray(gated.max_violation) <= tol).all())
    # legacy streak limiter alone: every lane recovered
    lim = run(early_round_iteration_cap=1, max_consecutive_truncations=2,
              truncation_requires_progress=False)
    assert bool((np.asarray(lim.max_violation) <= tol).all())
    # and the vmap path implements the same default safety semantics
    cap_default = run(early_round_iteration_cap=1)
    cap_vmap = make_batched_solve_fn(
        spec, Options(**{**base, "batched_solver": "vmap"},
                      early_round_iteration_cap=1)
    )(xs, us, ws)
    assert bool((np.asarray(cap_default.max_violation) <= tol).all())
    np.testing.assert_array_equal(
        np.asarray(cap_default.iterations), np.asarray(cap_vmap.iterations)
    )
    np.testing.assert_array_equal(
        np.asarray(cap_default.al_iterations),
        np.asarray(cap_vmap.al_iterations)
    )


def test_sl_constraint_aware_acceptance_matches_vmap():
    """constraint_aware_acceptance on the SL path (batched MPC farms keep
    the SL layout): per-candidate violations are
    accumulated in the SL scoring scan's carry and the preference rule
    must pick the same candidates as the vmap path (ops/forward.py)."""
    B = 4
    spec, xs, us, ws = _batch(acrobot, 9, B, 0.05)
    opts = dict(_BASE, constraint_aware_acceptance=True)
    ref = make_batched_solve_fn(
        spec, Options(batched_solver="vmap", **opts)
    )(xs, us, ws)
    out = make_batched_solve_fn(
        spec, Options(batched_solver="sl", **opts))(xs, us, ws)
    for name in ("xs", "us", "objective", "max_violation", "step_size"):
        np.testing.assert_allclose(
            np.asarray(getattr(out, name)),
            np.asarray(getattr(ref, name)),
            rtol=2e-3, atol=2e-3, err_msg=name,
        )
    np.testing.assert_array_equal(
        np.asarray(out.iterations), np.asarray(ref.iterations)
    )
    # auto now keeps the SL layout with the filter on (no vmap fallback)
    from iterativelqr_tpu.parallel.batch import _sl_eligible

    assert _sl_eligible(
        Options(constraint_aware_acceptance=True, record_traces=False),
        None,
    )


def test_sl_constraint_aware_two_block_tail():
    """The violation filter must interact correctly with the two-block
    line search: with a wide candidate grid (na > 8) a lane whose head
    acceptances all worsen the violation must still find its preferred
    candidate in the tail block (settled-gate correctness)."""
    B = 2
    spec, xs, us, ws = _batch(car, 8, B, 0.01)
    # na = 17 with the reference min_step_size -> head 8 + tail 9
    opts = dict(_BASE, constraint_aware_acceptance=True,
                min_step_size=1.0e-5)
    ref = make_batched_solve_fn(
        spec, Options(batched_solver="vmap", **opts)
    )(xs, us, ws)
    out = make_batched_solve_fn(
        spec, Options(batched_solver="sl", **opts))(xs, us, ws)
    np.testing.assert_array_equal(
        np.asarray(out.iterations), np.asarray(ref.iterations)
    )
    np.testing.assert_allclose(
        np.asarray(out.xs), np.asarray(ref.xs), rtol=2e-3, atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(out.step_size), np.asarray(ref.step_size),
        rtol=1e-6, atol=1e-6,
    )
