"""Forward pass: Armijo line search over vmapped candidate step sizes.

The reference backtracks serially, halving alpha and re-rolling out until the
Armijo condition holds (reference: src/forward_pass.jl:26-54).  Here the
whole candidate grid alpha_j = 0.5**j is rolled out *at once* (one extra vmap
axis) and the largest acceptable alpha is selected —
semantically identical to first-accept backtracking, but one device round
instead of a data-dependent loop (SURVEY.md section 7).

NaN/Inf costs from diverging rollouts reject the candidate, replacing the
reference's disabled try/catch divergence handling (src/forward_pass.jl:32-43).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.options import Options
from ..core.spec import ProblemSpec
from . import linalg_small
from .rollout import closed_loop_rollout, rollout_with_al_cost


def trajectory_sensitivities(fx, fu, K, k, unroll=1):
    """Closed-loop linearized trajectory delta used for the Armijo slope
    (reference: src/data/methods.jl:42-54):
        zx_0 = 0;  zu_t = k_t + K_t zx_t;  zx_{t+1} = fx_t zx_t + fu_t zu_t
    Returns (zx [T-1,nx], zu [T-1,nu]) — zx only needed through T-2 because the
    terminal state gradient is zero by construction (src/gradients.jl note).
    """

    def step(zx, inp):
        fx_t, fu_t, K_t, k_t = inp
        mv = linalg_small.matvec
        zu = k_t + mv(K_t, zx)
        zx_next = mv(fx_t, zx) + mv(fu_t, zu)
        return zx_next, (zx, zu)

    zx0 = jnp.zeros(fx.shape[-1], fx.dtype)
    _, (zx, zu) = jax.lax.scan(step, zx0, (fx, fu, K, k), unroll=unroll)
    return zx, zu


def armijo_slope(Qx, Qu, p, zx, zu):
    """gradient' * delta_z with the Lagrangian gradient
    Lx_t = Qx_t - p_t, Lu_t = Qu_t (reference: src/solve.jl:67-83 +
    src/forward_pass.jl:18-23)."""
    return jnp.sum((Qx - p) * zx) + jnp.sum(Qu * zu)


def line_search(
    spec: ProblemSpec,
    objective_fn,  # (xs, us) -> (J, c)
    xbar,
    ubar,
    ws,
    K,
    k,
    slope,
    J_prev,
    c_prev,
    options: Options,
    duals,
    penalty,
):
    """Parallel-alpha Armijo search.

    Returns (xs, us, J, c, status, step_size): the accepted candidate promoted
    to nominal, or the unchanged nominal with status=False on failure
    (reference: src/forward_pass.jl:44-56).

    Candidate objectives are accumulated *inside* the rollout scan
    (``rollout_with_al_cost``, carry-only — materializing [n_alpha, T, nx]
    candidate stacks dominated HBM traffic) and only the winning candidate is
    re-rolled to recover its trajectory and constraint values.  The accepted
    objective returned is the *scoring scan's* value ``J_c[idx]`` — the number
    the Armijo test actually validated — so a different XLA fusion of the
    winner re-roll can never report an objective that violates the accepted
    Armijo bound or perturb the next iteration's ``J_prev``.
    """
    if options.line_search == "none":
        # unconditional full step (reference: src/options.jl:2 line_search
        # :none skips backtracking; only rollout divergence rejects)
        xs, us = closed_loop_rollout(
            spec, xbar, ubar, ws, K, k, 1.0, unroll=options.scan_unroll
        )
        J, c = objective_fn(xs, us)
        ok = jnp.isfinite(J)
        return (
            jnp.where(ok, xs, xbar),
            jnp.where(ok, us, ubar),
            jnp.where(ok, J, J_prev),
            jnp.where(ok, c, c_prev),
            ok,
            jnp.ones((), xbar.dtype),
        )

    na = options.num_step_sizes
    alphas = 0.5 ** jnp.arange(na, dtype=xbar.dtype)

    # score every candidate with a trajectory-free (carry-only) rollout, then
    # re-roll only the winner below.  (A two-block head/tail split with the
    # tail under lax.cond — the SL solver's structure, ops/sl_ops.py — was
    # measured to REGRESS this path's single-instance solve latency, the cond
    # splitting the scoring into separately-scheduled scans; the one-shot
    # grid stays.  Not yet re-measured on the H100.)
    viol_filter = options.constraint_aware_acceptance and spec.nc > 0

    def score_alpha(alpha):
        out = rollout_with_al_cost(
            spec, xbar, ubar, ws, K, k, alpha, duals, penalty,
            unroll=options.scan_unroll, cost_only=True,
            with_viol=viol_filter,
        )
        return (out[2], out[4]) if viol_filter else out[2]

    c1 = jnp.asarray(options.armijo_c1, xbar.dtype)
    if viol_filter:
        J_c, viol_c = jax.vmap(score_alpha)(alphas)
    else:
        J_c = jax.vmap(score_alpha)(alphas)

    accept = (J_c <= J_prev + c1 * alphas * slope) & jnp.isfinite(J_c)
    status = jnp.any(accept)
    idx = jnp.argmax(accept)  # first (largest-alpha) accepted candidate
    if viol_filter:
        # constraint-aware acceptance (options.py): among the accepted
        # candidates prefer the largest step that does not worsen the max
        # violation (beyond the tolerance); fall back to the plain Armijo
        # winner when none qualifies, preserving convergence behavior
        from . import al as al_ops

        ineq = jnp.asarray(spec.ineq_mask)
        cmask = jnp.asarray(spec.c_mask)
        viol_prev = al_ops.max_violation(c_prev, ineq, cmask)
        tol = jnp.asarray(options.constraint_tolerance, xbar.dtype)
        preferred = accept & (viol_c <= jnp.maximum(viol_prev, tol))
        idx = jnp.where(jnp.any(preferred), jnp.argmax(preferred), idx)

    # re-roll ONLY the winning candidate; its trajectory AND constraint
    # values come out of the same scan (no separate constraint pass)
    xs_w, us_w, _J_w, c_win = rollout_with_al_cost(
        spec, xbar, ubar, ws, K, k, alphas[idx], duals, penalty,
        unroll=options.scan_unroll,
    )
    xs = jnp.where(status, xs_w, xbar)
    us = jnp.where(status, us_w, ubar)
    J = jnp.where(status, J_c[idx], J_prev)
    c = jnp.where(status, c_win, c_prev)
    # on failure the reference's loop exits having halved past min_step_size
    step_size = jnp.where(status, alphas[idx], alphas[-1] * 0.5)
    return xs, us, J, c, status, step_size
