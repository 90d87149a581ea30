"""Solver drivers: inner iLQR loop and outer augmented-Lagrangian loop.

Functional re-design of the reference drivers (reference: src/solve.jl):

* ``ilqr`` — the inner unconstrained minimization (src/solve.jl:1-51) as a
  ``lax.while_loop``: line search, fresh derivatives, regularized backward
  pass, convergence on Lagrangian-gradient norm / objective decrease /
  line-search failure — same criteria, same defaults.
* ``al_solve`` — the outer dual loop (src/solve.jl:88-129): inner solve,
  violation check, dual ascent + penalty scaling, optional user callback for
  continuation schemes.
* Unconstrained problems are simply AL problems with zero constraint rows:
  the violation is identically zero so the outer loop exits after one inner
  solve, replacing the reference's type-dispatch (src/solve.jl:137-143) with a
  single compiled program.

The whole solve is one jitted program; under ``jax.vmap`` the while-loops mask
per-instance automatically, so a batch finishes when its last instance
converges and converged instances stop changing (SURVEY.md section 7).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops import al as al_ops
from ..ops import derivatives as dv
from ..ops.backward import backward_pass
from ..ops.forward import armijo_slope, line_search, trajectory_sensitivities
from .options import Options
from .spec import ProblemSpec


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Solution:
    """Result pytree of a solve (padded arrays; see ProblemSpec masks)."""

    xs: jax.Array  # [T, nx] nominal states
    us: jax.Array  # [T-1, nu] nominal actions
    K: jax.Array  # [T-1, nu, nx] feedback gains
    k: jax.Array  # [T-1, nu] feedforward
    objective: jax.Array  # final (augmented) objective
    gradient_norm: jax.Array  # inf-norm of the Lagrangian gradient
    max_violation: jax.Array  # inf-norm constraint violation
    status: jax.Array  # last line search succeeded
    iterations: jax.Array  # total inner iterations
    al_iterations: jax.Array  # outer dual updates performed
    step_size: jax.Array  # last accepted step size
    duals: jax.Array  # [T, nc]
    penalty: jax.Array  # [T, nc]
    reg: jax.Array  # final regularization carry
    # traces: [max_dual_updates, max_iterations]; valid where trace_mask
    trace_cost: jax.Array
    trace_gradient_norm: jax.Array
    trace_violation: jax.Array
    trace_step_size: jax.Array
    trace_mask: jax.Array
    # the constraint tolerance the solve ran with, carried so `converged`
    # reflects the actual options (reference: src/options.jl:8) rather than a
    # hardcoded default
    tol_constraint: jax.Array

    @property
    def converged(self):
        return self.max_violation <= self.tol_constraint


class _InnerCarry(NamedTuple):
    xs: jax.Array
    us: jax.Array
    J: jax.Array
    c: jax.Array
    K: jax.Array
    k: jax.Array
    reg: jax.Array
    grad_norm: jax.Array
    status: jax.Array
    stop: jax.Array
    it: jax.Array
    viol: jax.Array
    step_size: jax.Array
    tr_cost: jax.Array
    tr_grad: jax.Array
    tr_viol: jax.Array
    tr_step: jax.Array
    tr_mask: jax.Array


class _FusedCarry(NamedTuple):
    xs: jax.Array
    us: jax.Array
    ws: jax.Array
    duals: jax.Array
    penalty: jax.Array
    J: jax.Array
    c: jax.Array
    reg: jax.Array
    viol_prev: jax.Array
    al_it: jax.Array
    inner_it: jax.Array
    total_it: jax.Array
    status: jax.Array
    step_size: jax.Array
    viol: jax.Array
    stop: jax.Array
    trunc_streak: jax.Array
    trace_cost: jax.Array
    trace_grad: jax.Array
    trace_viol: jax.Array
    trace_step: jax.Array
    trace_mask: jax.Array


class _OuterCarry(NamedTuple):
    xs: jax.Array
    us: jax.Array
    ws: jax.Array
    duals: jax.Array
    penalty: jax.Array
    reg: jax.Array
    al_it: jax.Array
    stop: jax.Array
    total_iters: jax.Array
    J: jax.Array
    grad_norm: jax.Array
    viol: jax.Array
    viol_prev: jax.Array
    status: jax.Array
    step_size: jax.Array
    trunc_streak: jax.Array
    K: jax.Array
    k: jax.Array
    trace_cost: jax.Array
    trace_grad: jax.Array
    trace_viol: jax.Array
    trace_step: jax.Array
    trace_mask: jax.Array


@dataclasses.dataclass
class CallbackState:
    """State handed to the user AL callback (reference hook:
    src/solve.jl:124-125, intended for continuation/homotopy schemes).
    The callback must be a pure, jittable (CallbackState) -> CallbackState."""

    xs: jax.Array
    us: jax.Array
    ws: jax.Array
    duals: jax.Array
    penalty: jax.Array
    al_iteration: jax.Array


def make_solve_fn(
    spec: ProblemSpec,
    options: Options = Options(),
    callback: Optional[Callable[[CallbackState], CallbackState]] = None,
    dual_warm_start: bool = False,
    backward_impl: Optional[Callable] = None,
):
    """Build the pure solve function ``(xs_init, us_init, ws) -> Solution``.

    ``ws`` is the [T, npar] per-timestep parameter trajectory; duals/penalties
    are reset at entry (reference: src/solve.jl:95-103).  With
    ``dual_warm_start=True`` the signature becomes
    ``(xs_init, us_init, ws, duals0, penalty0) -> Solution`` so MPC loops can
    carry multipliers across re-solves (a capability the reference's
    reset-on-entry precludes).

    ``backward_impl``: optional Riccati-recursion override with the
    ``ops.backward.backward_pass_scan`` signature (wrapped in the standard
    regularization retry loop) — how the horizon-sharded backward reaches
    the full solver (``parallel.make_long_horizon_solve_fn``).
    """
    if backward_impl is not None and options.backward_pass == "packed":
        raise ValueError(
            'backward_impl cannot be combined with backward_pass="packed" '
            "(the packed pipeline owns its own backward kernel)"
        )
    if backward_impl is not None and options.ddp:
        raise ValueError(
            "backward_impl cannot be combined with ddp=True (the DDP terms "
            "supply their own scan recursion)"
        )
    nc = spec.nc
    x_mask = jnp.asarray(spec.x_mask)
    u_mask = jnp.asarray(spec.u_mask)
    c_mask = jnp.asarray(spec.c_mask)
    ineq = jnp.asarray(spec.ineq_mask)
    armijo = options.line_search == "armijo"

    def al_objective(xs, us, ws, duals, penalty):
        J = dv.total_cost(spec, xs, us, ws)
        c = dv.constraint_values(spec, xs, us, ws)
        if nc > 0:
            J = J + al_ops.al_terms(c, duals, penalty, ineq)
        return J, c

    def derive(xs, us, ws, duals, penalty, c, reg):
        """Derivative stacks + AL augmentation + backward pass.

        Kept as separate vmapped stacks: the fused single-pass variant
        (dv.stage_derivatives) was faster in isolation but regressed the
        full solve (layout interactions with the surrounding program); not
        yet measured on the H100.
        """
        fx, fu = dv.dynamics_jacobians(spec, xs, us, ws)
        gx, gu = dv.cost_gradients(spec, xs, us, ws)
        gxx, guu, gux = dv.cost_hessians(spec, xs, us, ws)
        if nc > 0:
            cx, cu = dv.constraint_jacobians(spec, xs, us, ws)
            dgx, dgu, dgxx, dguu, dgux = al_ops.al_gradient_terms(
                c, cx, cu, duals, penalty, ineq
            )
            gx, gu = gx + dgx, gu + dgu
            gxx, guu, gux = gxx + dgxx, guu + dguu, gux + dgux
        impl = backward_impl
        if options.ddp:
            # full DDP: dynamics curvature contracted with Vx(t+1) inside
            # the scan step (ops/backward.py::riccati_step f2 terms); the
            # tensors are closed over, so the regularization retry loop
            # re-runs the same recursion unchanged
            from ..ops.backward import backward_pass_scan

            f2 = dv.dynamics_hessians(spec, xs, us, ws)
            impl = functools.partial(
                backward_pass_scan, unroll=options.scan_unroll, f2=f2
            )
        K, k, Qx, Qu, p, _ok, reg_next = backward_pass(
            fx, fu, gx, gu, gxx, guu, gux, u_mask, reg, options,
            impl=impl,
        )
        # Lagrangian gradient inf-norm over valid dims
        # (reference: src/solve.jl:67-83 + norm at :35)
        lx = jnp.abs(Qx - p) * x_mask[:-1]
        lu = jnp.abs(Qu) * u_mask
        grad_norm = jnp.maximum(jnp.max(lx), jnp.max(lu))
        return fx, fu, K, k, Qx, Qu, p, grad_norm, reg_next

    if options.backward_pass == "packed":
        from ..ops.packed_pipeline import make_derive_backward

        _packed_dispatch = make_derive_backward(spec, options)

        def derive_and_slope(xs, us, ws, duals, penalty, c, reg):
            return _packed_dispatch(xs, us, ws, duals, penalty, c, reg)

    else:

        def derive_and_slope(xs, us, ws, duals, penalty, c, reg):
            fx, fu, K, k, Qx, Qu, p, grad_norm, reg_next = derive(
                xs, us, ws, duals, penalty, c, reg
            )
            if armijo:
                zx, zu = trajectory_sensitivities(
                    fx, fu, K, k, unroll=options.scan_unroll
                )
                slope = armijo_slope(Qx, Qu, p, zx, zu)
            else:
                slope = jnp.zeros((), xs.dtype)
            return K, k, slope, grad_norm, reg_next

    def viol_of(c):
        return al_ops.max_violation(c, ineq, c_mask)

    def al_transition(c_fresh, viol_fresh, duals, penalty, viol_prev,
                      truncated=False):
        """Dual/penalty update for one AL round boundary (see the
        adaptive_penalty notes in core/options.py).  Returns the POST-update
        pair; callers gate application with jnp.where.

        ``truncated``: the round ended via early_round_iteration_cap, not by
        converging.  A truncated round is a pure penalty-continuation step:
        the penalty grows (plain x scaling_penalty — its reduced progress
        must not read as a stall; the stalled x100 multiplier compounding
        across truncated rounds broke 0.1% of a 4096 acrobot batch) but the
        DUAL ASCENT IS SKIPPED — ascending from an unconverged subproblem
        writes garbage multipliers whose linear term then drags later rounds
        to a bad region (measured: 2/4096 instances burned all 10 rounds at
        10x the typical objective and exited infeasible)."""
        if nc == 0:
            return duals, penalty
        truncated = jnp.asarray(truncated)  # python-bool ~ is arithmetic
        if options.adaptive_penalty:
            stalled = (
                viol_fresh > options.penalty_stall_gate * viol_prev
            ) & ~truncated
            scale_eff = jnp.where(
                stalled,
                options.scaling_penalty * options.scaling_penalty_stalled,
                options.scaling_penalty,
            )
        else:
            stalled = jnp.asarray(False)
            scale_eff = options.scaling_penalty
        new_duals, new_penalty = al_ops.dual_update(
            c_fresh, duals, penalty, ineq, scale_eff, options.max_penalty
        )
        if options.adaptive_penalty:
            # skip the ascent while stalled: lambda += rho*c with large rho
            # and large c manufactures huge multipliers whose linear term
            # rewards constraint-crashing steps (measured f32 divergence)
            new_duals = jnp.where(stalled, duals, new_duals)
        # truncated rounds never ascend (see docstring)
        new_duals = jnp.where(truncated, duals, new_duals)
        return new_duals, new_penalty

    def ilqr(xs, us, ws, duals, penalty, reg, it_offset=0, it_cap=None,
             viol_gate=None):
        """Inner iLQR loop, restructured for single-trace bodies.

        The reference order is {derive+backward before the loop; loop: forward,
        derive+backward, check} (src/solve.jl:9-51).  Tracing `derive` twice
        (entry + body) dominates jit lowering time, so here the body is
        {derive+backward at the current nominal; gradient-tolerance check;
        forward line search} with the line-search result discarded when the
        gradient test already fired — the same sequence of accepted nominals
        and the same stopping criteria, traced once.
        """
        dtype = xs.dtype
        obj_fn = lambda xs_, us_: al_objective(xs_, us_, ws, duals, penalty)
        J0, c0 = obj_fn(xs, us)
        n_tr = options.max_iterations if options.record_traces else 1
        zrow = jnp.zeros((n_tr,), dtype)
        carry = _InnerCarry(
            xs=xs, us=us, J=J0, c=c0,
            K=jnp.zeros((spec.T - 1, spec.nu, spec.nx), dtype),
            k=jnp.zeros((spec.T - 1, spec.nu), dtype),
            reg=reg, grad_norm=jnp.asarray(jnp.inf, dtype),
            status=jnp.asarray(True), stop=jnp.asarray(False),
            it=jnp.asarray(0), viol=viol_of(c0),
            step_size=jnp.ones((), dtype),
            tr_cost=zrow, tr_grad=zrow, tr_viol=zrow, tr_step=zrow,
            tr_mask=jnp.zeros((n_tr,), bool),
        )

        def cond(s: _InnerCarry):
            c = (~s.stop) & (s.it < options.max_iterations)
            if it_cap is not None:
                # inexact early AL rounds (options.early_round_iteration_cap)
                at_cap = s.it >= it_cap
                if viol_gate is not None:
                    # truncation requires geometric progress: at the cap the
                    # round keeps iterating until the violation is below
                    # truncation_progress_factor * the previous round
                    # boundary's (options.py; identical decision points to
                    # the fused body's in-round gate)
                    at_cap = at_cap & (
                        s.viol
                        < options.truncation_progress_factor * viol_gate
                    )
                c = c & ~at_cap
            if options.max_total_iterations is not None:
                c = c & (it_offset + s.it < options.max_total_iterations)
            return c

        def body(s: _InnerCarry):
            K, k, slope, grad_norm, reg = derive_and_slope(
                s.xs, s.us, ws, duals, penalty, s.c, s.reg
            )
            # gradient stop at the current nominal
            # (reference: src/solve.jl:48, checked there post-forward at the
            # same point; also fires at the warm-started initial nominal)
            stop_grad = grad_norm < options.lagrangian_gradient_tolerance
            xs_n, us_n, J_n, c_n, status, step = line_search(
                spec, obj_fn, s.xs, s.us, ws, K, k, slope, s.J, s.c, options,
                duals=duals, penalty=penalty,
            )
            # barrier: an XLA CPU while-loop miscompilation was observed to
            # deliver a stale `c` carry (one iteration behind xs/J — verified
            # impossible in the program semantics and absent under
            # disable_jit); the barrier pins these values together before the
            # carry update.  Solution.max_violation is additionally recomputed
            # from the final trajectory at exit.
            xs_n, us_n, J_n, c_n = jax.lax.optimization_barrier(
                (xs_n, us_n, J_n, c_n)
            )
            # discard the step if the gradient test already converged
            keep = ~stop_grad
            xs_n = jnp.where(keep, xs_n, s.xs)
            us_n = jnp.where(keep, us_n, s.us)
            J_n = jnp.where(keep, J_n, s.J)
            c_n = jnp.where(keep, c_n, s.c)
            status = jnp.where(keep, status, s.status)
            step = jnp.where(keep, step, s.step_size)

            it = s.it + 1
            viol = viol_of(c_n)
            # convergence (reference: src/solve.jl:48-50).  A Tassa-style
            # "escalate reg and keep iterating on line-search trouble" inner
            # loop was tried and measured WORSE (the escalated reg poisons
            # subsequent AL rounds and wedges acrobot); the spurious
            # floor-step |dJ| exits after dual updates are instead handled by
            # the outer loop's stall-gated penalty growth (adaptive_penalty).
            stop = (
                stop_grad
                | (jnp.abs(J_n - s.J) < options.objective_tolerance)
                | (~status)
            )
            return _InnerCarry(
                xs=xs_n, us=us_n, J=J_n, c=c_n, K=K, k=k,
                reg=reg, grad_norm=grad_norm, status=status, stop=stop,
                it=it, viol=viol, step_size=step,
                tr_cost=s.tr_cost.at[s.it].set(J_n) if options.record_traces else s.tr_cost,
                tr_grad=s.tr_grad.at[s.it].set(grad_norm) if options.record_traces else s.tr_grad,
                tr_viol=s.tr_viol.at[s.it].set(viol) if options.record_traces else s.tr_viol,
                tr_step=s.tr_step.at[s.it].set(step) if options.record_traces else s.tr_step,
                tr_mask=s.tr_mask.at[s.it].set(True) if options.record_traces else s.tr_mask,
            )

        return jax.lax.while_loop(cond, body, carry)

    def fused_loop(xs, us, ws, duals0, penalty0) -> _FusedCarry:
        """Single fused AL x iLQR while-loop (default path).

        The nested two-level loop (outer dual updates x inner iLQR) costs, under
        ``vmap``, SUM over rounds of the PER-ROUND MAX iteration count across
        instances — instances' rounds don't align, so a 4-round batch pays far
        more masked iterations than any single instance runs (measured on the
        B=4096 parity bench: per-instance max 238 total iterations but ~500+
        masked loop trips).  Fusing both levels into one loop with per-instance
        AL state (duals/penalty/round counters in the carry, dual updates
        applied via masks at each instance's own round boundaries) bounds the
        batch at MAX over instances of their TOTAL iterations.

        Per-instance semantics match the nested path: same derive/line-search
        sequence, same stopping rules, same dual-update points.  The only
        deviation: at a round boundary the next round's initial objective is
        REBASED algebraically (J - al_terms(old) + al_terms(new)) instead of
        re-evaluated from scratch — bitwise-identical up to fp association.
        """
        dtype = xs.dtype
        n_tr = options.max_iterations if options.record_traces else 1
        n_al = options.max_dual_updates if options.record_traces else 1
        J0, c0 = al_objective(xs, us, ws, duals0, penalty0)
        zt = jnp.zeros((n_al, n_tr), dtype)
        carry = _FusedCarry(
            xs=xs, us=us, ws=ws, duals=duals0, penalty=penalty0,
            J=J0, c=c0,
            reg=jnp.asarray(options.regularization_initial, dtype),
            viol_prev=jnp.asarray(jnp.inf, dtype),
            al_it=jnp.asarray(0), inner_it=jnp.asarray(0),
            total_it=jnp.asarray(0),
            status=jnp.asarray(True), step_size=jnp.ones((), dtype),
            viol=viol_of(c0), stop=jnp.asarray(False),
            trunc_streak=jnp.asarray(0),
            trace_cost=zt, trace_grad=zt, trace_viol=zt, trace_step=zt,
            trace_mask=jnp.zeros(zt.shape, bool),
        )

        def cond(s: _FusedCarry):
            return ~s.stop

        def body(s: _FusedCarry):
            K, k, slope, grad_norm, reg = derive_and_slope(
                s.xs, s.us, s.ws, s.duals, s.penalty, s.c, s.reg
            )
            stop_grad = grad_norm < options.lagrangian_gradient_tolerance
            obj_fn = lambda xs_, us_: al_objective(
                xs_, us_, s.ws, s.duals, s.penalty
            )
            xs_n, us_n, J_n, c_n, status, step = line_search(
                spec, obj_fn, s.xs, s.us, s.ws, K, k, slope, s.J, s.c,
                options, duals=s.duals, penalty=s.penalty,
            )
            # barrier: see the nested body's note on the XLA CPU while-loop
            # stale-carry miscompilation
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
            # inner-round convergence (reference: src/solve.jl:48-50) or
            # iteration budget exhausted
            round_end = (
                stop_grad
                | (jnp.abs(J_n - s.J) < options.objective_tolerance)
                | (~status)
                | (inner1 >= options.max_iterations)
            )
            viol = viol_of(c_n)
            truncated = jnp.asarray(False)
            if options.early_round_iteration_cap is not None:
                # inexact early rounds: truncate rounds at the cap, as pure
                # penalty-continuation steps (options.py).  A truncated
                # round neither ascends nor counts against max_dual_updates
                # (burning the dual budget on truncations was measured to
                # strand the hardest 0.05% of a 4096 batch at max_penalty
                # with no rounds left); termination is guaranteed by the
                # uncapped algorithm's own worst-case iteration bound below.
                # the FIRST round (lambda=0, rho=rho0) always runs to natural
                # completion: it establishes the nominal trajectory, and
                # truncating it mid-swing was measured to strand the hardest
                # instances in a line-search-failure/ascent doom loop.
                # Truncation requires GEOMETRIC progress
                # (truncation_requires_progress, the default): a round at
                # the cap keeps iterating until the violation is below
                # truncation_progress_factor * the previous round
                # boundary's — strict decrease alone was measured
                # insufficient (an infinitesimal-progress doom loop passes
                # it forever; options.py).  The consecutive-truncation
                # limit is a backstop on top (options.py).
                cap_fired = (
                    (inner1 >= options.early_round_iteration_cap)
                    & (s.al_it > 0)
                    & (s.al_it + 1 < options.max_dual_updates)
                    & (s.trunc_streak
                       < options.max_consecutive_truncations)
                )
                if options.truncation_requires_progress:
                    cap_fired = cap_fired & (
                        viol
                        < options.truncation_progress_factor * s.viol_prev
                    )
                truncated = cap_fired & ~round_end
                round_end = round_end | cap_fired
            feasible = viol <= options.constraint_tolerance
            solve_done = round_end & (
                feasible | (s.al_it + 1 >= options.max_dual_updates)
            )
            if options.early_round_iteration_cap is not None:
                solve_done = solve_done | (
                    s.total_it + 1
                    >= options.max_iterations * options.max_dual_updates
                )
            if options.max_total_iterations is not None:
                # budget exhausted: stop outright, suppressing the dual
                # update a round_end would otherwise fire (see options.py)
                solve_done = solve_done | (
                    s.total_it + 1 >= options.max_total_iterations
                )
            do_update = round_end & ~solve_done

            new_duals, new_penalty = al_transition(
                c_n, viol, s.duals, s.penalty, s.viol_prev, truncated
            )
            duals2 = jnp.where(do_update, new_duals, s.duals)
            pen2 = jnp.where(do_update, new_penalty, s.penalty)
            if nc > 0:
                # rebase the carried objective onto the new AL parameters so
                # the next iteration's J_prev equals the new round's J0
                J_reb = (
                    J_n
                    - al_ops.al_terms(c_n, s.duals, s.penalty, ineq)
                    + al_ops.al_terms(c_n, duals2, pen2, ineq)
                )
                J2 = jnp.where(do_update, J_reb, J_n)
            else:
                J2 = J_n

            ws2 = s.ws
            if callback is not None:
                cb = callback(
                    CallbackState(
                        xs=xs_n, us=us_n, ws=s.ws,
                        duals=duals2, penalty=pen2, al_iteration=s.al_it,
                    )
                )
                xs_cb = jnp.where(do_update, cb.xs, xs_n)
                us_cb = jnp.where(do_update, cb.us, us_n)
                ws2 = jnp.where(do_update, cb.ws, s.ws)
                duals2 = jnp.where(do_update, cb.duals, duals2)
                pen2 = jnp.where(do_update, cb.penalty, pen2)
                # a callback may have changed the problem: re-evaluate the
                # objective (only traced when a callback exists)
                J_cb, c_cb = al_objective(xs_cb, us_cb, ws2, duals2, pen2)
                xs_n = xs_cb
                us_n = us_cb
                J2 = jnp.where(do_update, J_cb, J2)
                c_n = jnp.where(do_update, c_cb, c_n)

            if options.live_progress:
                from ..utils.printing import live_progress_line

                jax.lax.cond(
                    round_end,
                    lambda a, b, c_, d, e: jax.debug.callback(
                        live_progress_line, a, b, c_, d, e, ordered=False
                    ),
                    lambda a, b, c_, d, e: None,
                    s.al_it, inner1, J_n, grad_norm, viol,
                )

            rt = options.record_traces
            ai, ii = s.al_it, s.inner_it
            return _FusedCarry(
                xs=xs_n, us=us_n, ws=ws2, duals=duals2, penalty=pen2,
                J=J2, c=c_n, reg=reg,
                viol_prev=jnp.where(round_end, viol, s.viol_prev),
                al_it=s.al_it + (round_end & ~truncated).astype(s.al_it.dtype),
                inner_it=jnp.where(round_end, 0, inner1),
                total_it=s.total_it + 1,
                status=status, step_size=step, viol=viol,
                stop=solve_done,
                trunc_streak=jnp.where(
                    round_end,
                    jnp.where(truncated, s.trunc_streak + 1, 0),
                    s.trunc_streak,
                ),
                trace_cost=s.trace_cost.at[ai, ii].set(J_n) if rt else s.trace_cost,
                trace_grad=s.trace_grad.at[ai, ii].set(grad_norm) if rt else s.trace_grad,
                trace_viol=s.trace_viol.at[ai, ii].set(viol) if rt else s.trace_viol,
                trace_step=s.trace_step.at[ai, ii].set(step) if rt else s.trace_step,
                trace_mask=s.trace_mask.at[ai, ii].set(True) if rt else s.trace_mask,
            )

        return jax.lax.while_loop(cond, body, carry)

    def solve(xs_init, us_init, ws) -> Solution:
        # Accelerator matmuls may default to reduced precision (TF32 for f32
        # on the GPU), which destroys Riccati-recursion conditioning
        # (observed: most of a batch fails to converge).  The matrices here
        # are tiny, so full-f32 precision costs nothing.
        with jax.default_matmul_precision("float32"):
            return _solve(xs_init, us_init, ws, None, None)

    def solve_warm(xs_init, us_init, ws, duals0, penalty0) -> Solution:
        with jax.default_matmul_precision("float32"):
            return _solve(xs_init, us_init, ws, duals0, penalty0)

    def _solve(xs_init, us_init, ws, duals0, penalty0) -> Solution:
        dtype = xs_init.dtype
        T = spec.T
        if duals0 is None:
            duals0 = jnp.zeros((T, nc), dtype)
        if penalty0 is None:
            penalty0 = jnp.full((T, nc), options.initial_constraint_penalty, dtype)
        if options.fused_al_loop:
            s = fused_loop(xs_init, us_init, ws, duals0, penalty0)
            return _finish(
                s.xs, s.us, s.ws, s.duals, s.penalty, s.reg, s.J,
                s.status, s.step_size, s.total_it, s.al_it,
                s.trace_cost, s.trace_grad, s.trace_viol, s.trace_step,
                s.trace_mask, dtype,
            )
        n_tr = options.max_iterations if options.record_traces else 1
        n_al = options.max_dual_updates if options.record_traces else 1
        zt = jnp.zeros((n_al, n_tr), dtype)
        carry = _OuterCarry(
            xs=xs_init, us=us_init, ws=ws,
            duals=duals0, penalty=penalty0,
            reg=jnp.asarray(options.regularization_initial, dtype),
            al_it=jnp.asarray(0), stop=jnp.asarray(False),
            total_iters=jnp.asarray(0),
            J=jnp.zeros((), dtype), grad_norm=jnp.zeros((), dtype),
            viol=jnp.zeros((), dtype),
            viol_prev=jnp.asarray(jnp.inf, dtype),
            status=jnp.asarray(True),
            step_size=jnp.ones((), dtype),
            trunc_streak=jnp.asarray(0),
            K=jnp.zeros((T - 1, spec.nu, spec.nx), dtype),
            k=jnp.zeros((T - 1, spec.nu), dtype),
            trace_cost=zt, trace_grad=zt, trace_viol=zt, trace_step=zt,
            trace_mask=jnp.zeros(zt.shape, bool),
        )

        def cond(s: _OuterCarry):
            c = (~s.stop) & (s.al_it < options.max_dual_updates)
            if options.early_round_iteration_cap is not None:
                # truncated rounds don't consume the dual budget, so bound
                # termination by the uncapped algorithm's own worst case
                c = c & (
                    s.total_iters
                    < options.max_iterations * options.max_dual_updates
                )
            return c

        def body(s: _OuterCarry):
            it_cap = None
            if options.early_round_iteration_cap is not None:
                # last possible round runs to max_iterations; earlier rounds
                # are truncated (inexact early rounds, options.py).  A round
                # after max_consecutive_truncations straight truncations also
                # runs full, so a real dual ascent fires (options.py)
                it_cap = jnp.where(
                    (s.al_it == 0)
                    | (s.al_it + 1 >= options.max_dual_updates)
                    | (s.trunc_streak
                       >= options.max_consecutive_truncations),
                    options.max_iterations,
                    options.early_round_iteration_cap,
                )
            inner = ilqr(
                s.xs, s.us, s.ws, s.duals, s.penalty, s.reg, s.total_iters,
                it_cap,
                viol_gate=(
                    s.viol_prev
                    if (it_cap is not None
                        and options.truncation_requires_progress)
                    else None
                ),
            )
            # break *before* the dual update when already feasible
            # (reference: src/solve.jl:113-121).  The violation and the dual
            # ascent both use constraints evaluated FRESH at the inner
            # solution (one cheap stack per AL round): the carried c inside
            # the inner while-loop was observed to arrive one iteration stale
            # under an XLA CPU miscompilation (see the barrier note in the
            # inner body), and stop/dual decisions must never ride on it.
            c_fresh = dv.constraint_values(spec, inner.xs, inner.us, s.ws)
            viol_fresh = viol_of(c_fresh)
            stop = viol_fresh <= options.constraint_tolerance
            if options.max_total_iterations is not None:
                # budget exhausted: stop outright, no dual update (options.py)
                stop = stop | (
                    s.total_iters + inner.it >= options.max_total_iterations
                )
            truncated = jnp.asarray(False)
            if it_cap is not None:
                # round ended by the cap, not by converging (inner stop
                # flag unset and the budget consumed).  A gated round that
                # ran all the way to max_iterations (progress never made)
                # ended like an uncapped round and must ascend normally.
                truncated = (
                    (~inner.stop)
                    & (inner.it >= it_cap)
                    & (it_cap < options.max_iterations)
                    & (inner.it < options.max_iterations)
                )
            if nc > 0:
                new_duals, new_penalty = al_transition(
                    c_fresh, viol_fresh, s.duals, s.penalty, s.viol_prev,
                    truncated,
                )
                duals = jnp.where(stop, s.duals, new_duals)
                penalty = jnp.where(stop, s.penalty, new_penalty)
            else:
                duals, penalty = s.duals, s.penalty
                stop = jnp.asarray(True)
            if options.live_progress:
                from ..utils.printing import live_progress_line

                jax.debug.callback(
                    live_progress_line,
                    s.al_it, inner.it, inner.J, inner.grad_norm, viol_fresh,
                    ordered=False,
                )
            ws_next = s.ws
            xs_next, us_next = inner.xs, inner.us
            if callback is not None:
                cb = callback(
                    CallbackState(
                        xs=inner.xs, us=inner.us, ws=s.ws,
                        duals=duals, penalty=penalty,
                        al_iteration=s.al_it,
                    )
                )
                # apply only while the outer loop continues
                xs_next = jnp.where(stop, xs_next, cb.xs)
                us_next = jnp.where(stop, us_next, cb.us)
                ws_next = jnp.where(stop, s.ws, cb.ws)
                duals = jnp.where(stop, duals, cb.duals)
                penalty = jnp.where(stop, penalty, cb.penalty)
            return _OuterCarry(
                xs=xs_next, us=us_next, ws=ws_next,
                duals=duals, penalty=penalty, reg=inner.reg,
                al_it=s.al_it + jnp.where(truncated, 0, 1), stop=stop,
                total_iters=s.total_iters + inner.it,
                J=inner.J, grad_norm=inner.grad_norm, viol=viol_fresh,
                viol_prev=viol_fresh,
                status=inner.status, step_size=inner.step_size,
                trunc_streak=jnp.where(truncated, s.trunc_streak + 1, 0),
                K=inner.K, k=inner.k,
                trace_cost=s.trace_cost.at[s.al_it].set(inner.tr_cost) if options.record_traces else s.trace_cost,
                trace_grad=s.trace_grad.at[s.al_it].set(inner.tr_grad) if options.record_traces else s.trace_grad,
                trace_viol=s.trace_viol.at[s.al_it].set(inner.tr_viol) if options.record_traces else s.trace_viol,
                trace_step=s.trace_step.at[s.al_it].set(inner.tr_step) if options.record_traces else s.trace_step,
                trace_mask=s.trace_mask.at[s.al_it].set(inner.tr_mask) if options.record_traces else s.trace_mask,
            )

        s = jax.lax.while_loop(cond, body, carry)
        return _finish(
            s.xs, s.us, s.ws, s.duals, s.penalty, s.reg, s.J,
            s.status, s.step_size, s.total_iters, s.al_it,
            s.trace_cost, s.trace_grad, s.trace_viol, s.trace_step,
            s.trace_mask, dtype,
        )

    def _finish(xs, us, ws, duals, penalty, reg, J, status, step_size,
                total_iters, al_it, tr_cost, tr_grad, tr_viol, tr_step,
                tr_mask, dtype) -> Solution:
        # report the violation of the trajectory actually returned, evaluated
        # fresh — the carried value tracks the loop's view and must never be
        # the user-facing number
        c_final = dv.constraint_values(spec, xs, us, ws)
        viol_final = viol_of(c_final)
        # Re-derive gains/gradient about the RETURNED trajectory: inside the
        # loop K/k/grad_norm are computed at the pre-step nominal, so on
        # objective-tolerance or max-iteration exits they lag the accepted
        # trajectory by one step.  The reference re-derives after every
        # forward pass (src/solve.jl:28-32) and so always reports matching
        # gains; one extra derive per solve (~1% of a batched solve) restores
        # that invariant.
        K_f, k_f, _, grad_f, _ = derive_and_slope(
            xs, us, ws, duals, penalty, c_final, reg
        )
        return Solution(
            xs=xs, us=us, K=K_f, k=k_f,
            objective=J, gradient_norm=grad_f,
            max_violation=viol_final, status=status,
            iterations=total_iters, al_iterations=al_it,
            step_size=step_size, duals=duals, penalty=penalty,
            reg=reg,
            trace_cost=tr_cost, trace_gradient_norm=tr_grad,
            trace_violation=tr_viol, trace_step_size=tr_step,
            trace_mask=tr_mask,
            tol_constraint=jnp.asarray(options.constraint_tolerance, dtype),
        )

    return solve_warm if dual_warm_start else solve
