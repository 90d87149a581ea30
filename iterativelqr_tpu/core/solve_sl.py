"""SL-layout batched solver: the whole fused AL x iLQR loop in one layout.

The ``vmap(make_solve_fn(...))`` path produces batch-LEADING arrays whose
tiny minormost state dims (nx=4, nu=1) put the batch on a strided axis.
This module runs the ENTIRE batched solve in "SL" layout — every array
``[T, *dims, S, 128]`` with the batch riding the two trailing axes — so every
elementwise op, reduction, rollout scan and the backward recursion
(ops/packed_backward.py) reads the batch contiguously.  Layout conversion
happens exactly once at entry and once at exit.

Per-instance semantics are identical to the fused loop in core/solve.py
(same iterate sequence, stopping rules, dual-update points — reference
citations live there); tests/test_solve_sl.py checks batch-for-batch
agreement with the vmap path.

Restrictions (callers fall back to the vmap path): no user callback, no
record_traces, no live_progress, fused_al_loop only.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.packed_backward import BATCH_GRAIN
from ..ops.packed_pipeline import make_derive_backward_sl
from ..ops.sl_ops import SLOps, from_sl, to_sl
from .options import Options
from .solve import Solution
from .spec import ProblemSpec


class _SLCarry(NamedTuple):
    xs: jax.Array        # [T, nx, S, L]
    us: jax.Array        # [T-1, nu, S, L]
    duals: jax.Array     # [T, nc, S, L]
    penalty: jax.Array   # [T, nc, S, L]
    J: jax.Array         # [S, L]
    c: jax.Array         # [T, nc, S, L]
    reg: jax.Array       # [S, L]
    viol_prev: jax.Array
    al_it: jax.Array     # [S, L] int32
    inner_it: jax.Array
    total_it: jax.Array
    status: jax.Array    # [S, L] bool
    step_size: jax.Array
    viol: jax.Array
    stop: jax.Array      # [S, L] bool
    trunc_streak: jax.Array  # [S, L] int32


class SLParts(NamedTuple):
    """The SL solver split into separately-jittable pieces, so the
    straggler-compaction driver (core/solve_compact.py) can run the loop in
    bounded chunks at shrinking batch shapes.  ``init`` and ``finish``
    convert layouts at entry/exit; ``body`` is one solver iteration on the
    SL carry."""

    init: callable    # (xs [B,T,nx], us, ws) -> (_SLCarry, ws_sl)  (padded)
    body: callable    # ws_sl -> (_SLCarry -> _SLCarry)
    finish: callable  # (_SLCarry, ws_sl, B) -> Solution (batch-leading)


def make_sl_parts(
    spec: ProblemSpec, options: Options = Options(),
    dual_warm_start: bool = False,
) -> SLParts:
    if options.record_traces:
        raise ValueError("SL batched solver does not record traces; "
                         "use the vmap path (record_traces=True)")
    if options.live_progress:
        raise ValueError("SL batched solver does not support live_progress")
    if not options.fused_al_loop:
        raise ValueError("SL batched solver implements the fused AL loop")
    if options.ddp:
        raise ValueError(
            "SL batched solver does not support ddp=True (its backward "
            "recursion carries no second-derivative stacks); use the vmap path"
        )

    o = options
    nc, T = spec.nc, spec.T
    ops = SLOps(spec, o)
    derive = make_derive_backward_sl(spec, o)

    def body(ws):
        def _body(s: _SLCarry) -> _SLCarry:
            live = ~s.stop
            K, k, slope, grad, reg = derive(
                s.xs, s.us, ws, s.duals, s.penalty, s.c, s.reg
            )
            stop_grad = grad < o.lagrangian_gradient_tolerance
            # `need`: lanes whose line-search result survives into the carry
            # (stopped and gradient-converged lanes discard it) — lets the
            # two-block scoring skip its tail block (ops/sl_ops.py)
            xs_n, us_n, J_n, c_n, status, step = ops.line_search(
                s.xs, s.us, ws, K, k, slope, s.J, s.c, s.duals, s.penalty,
                need=live & ~stop_grad,
            )
            # barrier: see the stale-carry note in core/solve.py
            xs_n, us_n, J_n, c_n = jax.lax.optimization_barrier(
                (xs_n, us_n, J_n, c_n)
            )
            keep = ~stop_grad
            xs_n = jnp.where(keep, xs_n, s.xs)
            us_n = jnp.where(keep, us_n, s.us)
            J_n = jnp.where(keep, J_n, s.J)
            c_n = jnp.where(keep, c_n, s.c)
            status = jnp.where(keep, status, s.status)
            step = jnp.where(keep, step, s.step_size)

            inner1 = s.inner_it + 1
            round_end = (
                stop_grad
                | (jnp.abs(J_n - s.J) < o.objective_tolerance)
                | (~status)
                | (inner1 >= o.max_iterations)
            )
            viol = ops.max_violation(c_n)
            truncated = jnp.zeros(inner1.shape, bool)
            if o.early_round_iteration_cap is not None:
                # inexact early rounds: penalty-continuation truncation —
                # no ascent, no dual-budget consumption; termination via the
                # uncapped worst-case bound (core/solve.py fused body).
                # first round never truncates; truncation requires GEOMETRIC
                # progress (violation below truncation_progress_factor * the
                # previous round boundary's — strict decrease admits an
                # infinitesimal-progress doom loop), with the
                # consecutive-truncation limit as a backstop (core/solve.py
                # fused body note; options.py)
                cap_fired = (
                    (inner1 >= o.early_round_iteration_cap)
                    & (s.al_it > 0)
                    & (s.al_it + 1 < o.max_dual_updates)
                    & (s.trunc_streak < o.max_consecutive_truncations)
                )
                if o.truncation_requires_progress:
                    cap_fired = cap_fired & (
                        viol < o.truncation_progress_factor * s.viol_prev
                    )
                truncated = cap_fired & ~round_end
                round_end = round_end | cap_fired
            feasible = viol <= o.constraint_tolerance
            solve_done = round_end & (
                feasible | (s.al_it + 1 >= o.max_dual_updates)
            )
            if o.early_round_iteration_cap is not None:
                solve_done = solve_done | (
                    s.total_it + 1 >= o.max_iterations * o.max_dual_updates
                )
            if o.max_total_iterations is not None:
                # budget exhausted: stop outright, no dual update (options.py)
                solve_done = solve_done | (
                    s.total_it + 1 >= o.max_total_iterations
                )
            do_update = round_end & ~solve_done

            new_duals, new_pen = ops.al_transition(
                c_n, viol, s.duals, s.penalty, s.viol_prev, truncated
            )
            duals2 = jnp.where(do_update, new_duals, s.duals)
            pen2 = jnp.where(do_update, new_pen, s.penalty)
            if nc > 0:
                J_reb = (
                    J_n
                    - ops.al_terms(c_n, s.duals, s.penalty)
                    + ops.al_terms(c_n, duals2, pen2)
                )
                J2 = jnp.where(do_update, J_reb, J_n)
            else:
                J2 = J_n

            w = lambda new, old: jnp.where(live, new, old)
            return _SLCarry(
                xs=w(xs_n, s.xs), us=w(us_n, s.us),
                duals=w(duals2, s.duals), penalty=w(pen2, s.penalty),
                J=w(J2, s.J), c=w(c_n, s.c), reg=w(reg, s.reg),
                viol_prev=w(
                    jnp.where(round_end, viol, s.viol_prev), s.viol_prev
                ),
                al_it=w(
                    s.al_it
                    + (round_end & ~truncated).astype(s.al_it.dtype),
                    s.al_it,
                ),
                inner_it=w(jnp.where(round_end, 0, inner1), s.inner_it),
                total_it=w(s.total_it + 1, s.total_it),
                status=w(status, s.status), step_size=w(step, s.step_size),
                viol=w(viol, s.viol),
                stop=w(solve_done, s.stop),
                trunc_streak=w(
                    jnp.where(
                        round_end,
                        jnp.where(truncated, s.trunc_streak + 1, 0),
                        s.trunc_streak,
                    ),
                    s.trunc_streak,
                ),
            )

        return _body

    def init(xs_b, us_b, ws_b, duals_b=None, pen_b=None):
        B = xs_b.shape[0]
        dtype = xs_b.dtype
        Bp = -(-B // BATCH_GRAIN) * BATCH_GRAIN
        S = Bp // 128

        def pad(a):
            if Bp == B:
                return a
            # edge-replicate: padding lanes run a REAL instance so they can
            # never wedge batch-wide reductions (reg retries, loop cond)
            # with NaN garbage; sliced off at exit
            rep = jnp.broadcast_to(a[-1:], (Bp - B,) + a.shape[1:])
            return jnp.concatenate([a, rep], axis=0)

        xs = to_sl(pad(xs_b), S)
        us = to_sl(pad(us_b), S)
        ws = to_sl(pad(ws_b), S)
        if dual_warm_start:
            # carried multipliers/penalties from a previous solve
            # (reference analog: repeated solve! reuses them until reset,
            # src/solve.jl:95-103; here explicit, like make_solve_fn's
            # dual_warm_start)
            duals0 = to_sl(pad(duals_b), S)
            pen0 = to_sl(pad(pen_b), S)
        else:
            duals0 = jnp.zeros((T, nc, S, 128), dtype)
            pen0 = jnp.full(
                (T, nc, S, 128), o.initial_constraint_penalty, dtype
            )
        with jax.default_matmul_precision("float32"):
            J0, c0 = ops.al_objective(xs, us, ws, duals0, pen0)
        zi = jnp.zeros((S, 128), jnp.int32)
        carry = _SLCarry(
            xs=xs, us=us, duals=duals0, penalty=pen0, J=J0, c=c0,
            reg=jnp.full((S, 128), o.regularization_initial, dtype),
            viol_prev=jnp.full((S, 128), jnp.inf, dtype),
            al_it=zi, inner_it=zi, total_it=zi,
            status=jnp.ones((S, 128), bool),
            step_size=jnp.ones((S, 128), dtype),
            viol=ops.max_violation(c0),
            stop=jnp.zeros((S, 128), bool),
            trunc_streak=zi,
        )
        return carry, ws

    def finish(s: _SLCarry, ws, B) -> Solution:
        dtype = s.xs.dtype
        with jax.default_matmul_precision("float32"):
            # user-facing violation: evaluated FRESH at the returned
            # trajectory (core/solve.py::_finish)
            _, c_fin = ops.al_objective(s.xs, s.us, ws, s.duals, s.penalty)
            viol_fin = ops.max_violation(c_fin)
            # exit-consistent gains/gradient about the RETURNED trajectory
            K_f, k_f, _, grad_f, _ = derive(
                s.xs, s.us, ws, s.duals, s.penalty, c_fin, s.reg
            )

        out = lambda a: from_sl(a)[:B]
        ztr = jnp.zeros((B, 1, 1), dtype)
        return Solution(
            xs=out(s.xs), us=out(s.us), K=out(K_f), k=out(k_f),
            objective=out(s.J), gradient_norm=out(grad_f),
            max_violation=out(viol_fin), status=out(s.status),
            iterations=out(s.total_it), al_iterations=out(s.al_it),
            step_size=out(s.step_size),
            duals=out(s.duals), penalty=out(s.penalty), reg=out(s.reg),
            trace_cost=ztr, trace_gradient_norm=ztr,
            trace_violation=ztr, trace_step_size=ztr,
            trace_mask=jnp.zeros((B, 1, 1), bool),
            tol_constraint=jnp.full((B,), o.constraint_tolerance, dtype),
        )

    def body_prec(ws):
        inner = body(ws)

        def _b(s):
            with jax.default_matmul_precision("float32"):
                return inner(s)

        return _b

    return SLParts(init=init, body=body_prec, finish=finish)


def make_batched_solve_sl(
    spec: ProblemSpec, options: Options = Options(),
    dual_warm_start: bool = False,
):
    """Build ``(xs [B,T,nx], us [B,T-1,nu], ws [B,T,npar]) -> Solution``
    (batch-leading Solution, like make_batched_solve_fn).  With
    ``dual_warm_start`` the callable takes two extra batch-leading arrays
    ``(duals0 [B,T,nc], penalty0 [B,T,nc])`` — carried multipliers for
    re-solves (batched MPC farms)."""
    parts = make_sl_parts(
        spec, options, dual_warm_start=dual_warm_start
    )

    def solve_batch(xs_init, us_init, ws_b, *warm) -> Solution:
        B = xs_init.shape[0]
        # full-f32 matmul precision: see the note in core/solve.py::solve
        # (applied inside each part; the while_loop body re-enters it)
        carry, ws = parts.init(xs_init, us_init, ws_b, *warm)
        s = jax.lax.while_loop(
            lambda s: ~jnp.all(s.stop), parts.body(ws), carry
        )
        return parts.finish(s, ws, B)

    return solve_batch
