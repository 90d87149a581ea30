"""SL-layout batch ops: line search, AL machinery, objective evaluation.

The building blocks of the SL batched solver (core/solve_sl.py).  Every array
carries the batch split over the two TRAILING axes — shape
``[T, *dims, S, 128]`` with ``B = S * 128`` — so each elementwise op reads
the batch contiguously, where the batch-leading layout of the plain ``vmap``
path puts the tiny state dims (nx=4, nu=1) minormost.

Semantics per instance are identical to the batch-leading ops
(ops/forward.py, ops/rollout.py, ops/al.py); reference citations live there.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.spec import ProblemSpec
from .packed_pipeline import _grouped_bt2


def map2(fn):
    """vmap a per-(x,u,w) function over the two trailing (S, 128) axes."""
    return jax.vmap(
        jax.vmap(fn, in_axes=-1, out_axes=-1), in_axes=-1, out_axes=-1
    )


def map3(fn):
    """map2 plus a leading line-search-candidate axis on (x, u); w is shared
    across candidates."""
    return jax.vmap(map2(fn), in_axes=(0, 0, None), out_axes=0)


def _switch(ti, branches, *args):
    if len(branches) == 1:
        return branches[0](*args)
    return jax.lax.switch(ti, branches, *args)


def to_sl(a, S):
    """[B, leading...] -> [leading..., S, 128] (B = S*128 exactly)."""
    a = a.reshape((S, 128) + a.shape[1:])
    return jnp.moveaxis(a, (0, 1), (-2, -1))


def from_sl(a):
    """[leading..., S, 128] -> [S*128, leading...]."""
    a = jnp.moveaxis(a, (-2, -1), (0, 1))
    return a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:])


class SLOps:
    """Per-spec SL-layout operations, built once and closed over by the
    solver loop."""

    def __init__(self, spec: ProblemSpec, options):
        self.spec = spec
        self.options = options
        T, nc = spec.T, spec.nc
        Tm1 = T - 1

        # constraint-aware acceptance scores candidates by their max
        # violation accumulated in the scoring scan's carry
        self._viol_filter = (
            options.constraint_aware_acceptance and spec.nc > 0
        )
        self.ineq_t = jnp.asarray(spec.ineq_mask)          # [T, nc] bool
        self.cmask_t = jnp.asarray(spec.c_mask)            # [T, nc] bool
        self.ineq_sl = self.ineq_t[:, :, None, None]
        self.cmask_sl = self.cmask_t[:, :, None, None]

        self.dyn2 = [map2(f) for f in spec.dyn_eval]
        self.cost2 = [map2(f) for f in spec.cost_eval]
        self.con2 = [map2(f) for f in spec.con_eval]
        self.dyn3 = [map3(f) for f in spec.dyn_eval]
        self.cost3 = [map3(f) for f in spec.cost_eval]
        self.con3 = [map3(f) for f in spec.con_eval]

        self.td = jnp.asarray(spec.dyn_tidx)
        self.tg = jnp.asarray(spec.cost_tidx[:Tm1])
        self.tc = jnp.asarray(spec.con_tidx[:Tm1])
        self.gT = int(spec.cost_tidx[-1])
        self.cT = int(spec.con_tidx[-1])

        # grouped parallel (over t) cost+constraint evaluation for the
        # entry objective / fresh exit constraints (same stage-type grouping
        # as the packed derive pipeline)
        n_con = len(spec.con_eval)
        self.comb_gc = (
            spec.cost_tidx[:Tm1].astype(np.int64) * n_con + spec.con_tidx[:Tm1]
        )
        fns = {}
        for key in np.unique(self.comb_gc):
            gi, ci = divmod(int(key), n_con)
            g, cf = spec.cost_eval[gi], spec.con_eval[ci]

            def per_t(x, u, w, g=g, cf=cf):
                if nc > 0:
                    return g(x, u, w), cf(x, u, w)
                return (g(x, u, w),)

            fns[int(key)] = per_t
        self.eval_fns = fns

    # --- AL scalar machinery (SL analogs of ops/al.py) ---------------------

    def al_terms(self, c, duals, penalty):
        """Full-trajectory AL term: [T,nc,S,L] inputs -> [S,L]."""
        if self.spec.nc == 0:
            return jnp.zeros(c.shape[-2:], c.dtype)
        inactive = self.ineq_sl & (c < 0.0) & (duals == 0.0)
        a = jnp.where(inactive, 0.0, 1.0).astype(c.dtype)
        return jnp.sum(
            duals * c + 0.5 * a * penalty * c * c, axis=(0, 1)
        )

    def max_violation(self, c):
        """[T,nc,S,L] -> [S,L] inf-norm violation."""
        if self.spec.nc == 0:
            return jnp.zeros(c.shape[-2:], c.dtype)
        v = jnp.where(self.ineq_sl, jnp.maximum(c, 0.0), jnp.abs(c))
        v = jnp.where(self.cmask_sl, v, 0.0)
        return jnp.max(v, axis=(0, 1))

    def al_transition(self, c, viol, duals, penalty, viol_prev,
                      truncated=False):
        """Stall-gated dual/penalty update (core/solve.py::al_transition,
        incl. the truncated-round stall exemption); returns the POST-update
        pair, caller gates application."""
        o = self.options
        if self.spec.nc == 0:
            return duals, penalty
        truncated = jnp.asarray(truncated)
        if o.adaptive_penalty:
            stalled = (
                viol > o.penalty_stall_gate * viol_prev           # [S,L]
            ) & ~truncated
            scale_eff = jnp.where(
                stalled,
                o.scaling_penalty * o.scaling_penalty_stalled,
                o.scaling_penalty,
            )
        else:
            stalled = jnp.zeros(viol.shape, bool)
            scale_eff = jnp.full(viol.shape, o.scaling_penalty, c.dtype)
        new_duals = duals + penalty * c
        new_duals = jnp.where(
            self.ineq_sl, jnp.maximum(new_duals, 0.0), new_duals
        )
        new_penalty = jnp.minimum(
            scale_eff[None, None] * penalty, o.max_penalty
        )
        if o.adaptive_penalty:
            new_duals = jnp.where(stalled, duals, new_duals)
        # truncated rounds grow the penalty but never ascend
        # (core/solve.py::al_transition docstring)
        new_duals = jnp.where(truncated, duals, new_duals)
        return new_duals, new_penalty

    # --- objective / constraint evaluation ---------------------------------

    def al_objective(self, xs, us, ws, duals, penalty):
        """Parallel-over-t evaluation: [T,nx,S,L] etc -> (J [S,L],
        c [T,nc,S,L]).  SL analog of core/solve.py::al_objective."""
        spec = self.spec
        nc = spec.nc
        T = spec.T
        dtype = xs.dtype
        S = xs.shape[-2]
        outs = _grouped_bt2(
            self.eval_fns, self.comb_gc, T - 1, (xs[:-1], us, ws[:-1])
        )
        if nc > 0:
            g, c_head = outs
        else:
            (g,) = outs
        u0 = jnp.zeros((spec.nu, S, 128), dtype)
        gT = self.cost2[self.gT](xs[-1], u0, ws[-1])
        J = jnp.sum(g, axis=0) + gT
        if nc > 0:
            cT = self.con2[self.cT](xs[-1], u0, ws[-1])
            c = jnp.concatenate([c_head, cT[None]], axis=0)
            J = J + self.al_terms(c, duals, penalty)
        else:
            c = jnp.zeros((T, 0) + xs.shape[-2:], dtype)
        return J, c

    # --- line search --------------------------------------------------------

    def line_search(self, xbar, ubar, ws, K, k, slope, J_prev, c_prev,
                    duals, penalty, need=None):
        """Parallel-alpha Armijo search, SL layout end to end.

        Same algorithm as ops/forward.py::line_search: every candidate
        alpha_j = 0.5**j is scored with a trajectory-free rollout (AL
        objective accumulated in the scan carry), the largest acceptable
        alpha per instance wins, and ONE winner re-roll (with the
        per-instance winning alpha riding the batch lanes) recovers the
        trajectory and constraint values.  The accepted objective is the
        scoring scan's value (see the forward.py docstring for why).

        Two-block scoring: candidates split into a head block (8) scored
        always and a tail block scored under ``lax.cond`` ONLY when some
        lane in ``need`` (result-consuming lanes; None = all) has no head
        acceptance.  The head block accepts in the overwhelming majority of
        iterations (largest accepted alpha is the winner, so the tail can
        only matter to lanes with no head acceptance), cutting the dominant
        per-iteration cost of wide reference grids (num_step_sizes=17 at
        min_step_size=1e-5) nearly in half with bit-identical selection.

        Returns (xs, us, J, c, status, step_size) in SL shapes.
        """
        spec = self.spec
        o = self.options
        nc = spec.nc
        dtype = xbar.dtype
        S = xbar.shape[-2]
        nu, nx = spec.nu, spec.nx
        Tm1 = spec.T - 1

        scan_inputs = (
            self.td, self.tg, self.tc,
            xbar[:-1], ubar, ws[:-1], K, k,
            duals[:-1], penalty[:-1], self.ineq_t[:-1], self.cmask_t[:-1],
        )

        def roll(alpha_sl, emit):
            """One closed-loop rollout at per-instance step size
            ``alpha_sl`` [S,L]; J accumulated in-carry; trajectory +
            constraints emitted when ``emit``."""

            def step(carry, inp):
                x, J = carry
                td, tg, tc, xb, ub, w, K_t, k_t, lam_t, rho_t, iq_t, _ = inp
                dx = x - xb
                # broadcast-multiply-reduce: tiny contractions must never
                # lower to dot_general (ops/linalg_small.py lesson)
                u = (
                    ub
                    + jnp.sum(K_t * dx[None], axis=1)
                    + alpha_sl[None] * k_t
                )
                g = _switch(tg, self.cost2, x, u, w)
                J = J + g
                c_t = None
                if nc > 0:
                    c_t = _switch(tc, self.con2, x, u, w)
                    iq = iq_t[:, None, None]
                    inactive = iq & (c_t < 0.0) & (lam_t == 0.0)
                    a = jnp.where(inactive, 0.0, 1.0).astype(dtype)
                    J = J + jnp.sum(
                        lam_t * c_t + 0.5 * a * rho_t * c_t * c_t, axis=0
                    )
                xn = _switch(td, self.dyn2, x, u, w)
                if emit:
                    ys = (x, u, c_t) if nc > 0 else (x, u)
                else:
                    # scalar dummy, not an empty pytree: see the XLA CPU
                    # miscompilation note in ops/rollout.py
                    ys = jnp.zeros((), dtype)
                return (xn, J), ys

            (x_last, J), ys = jax.lax.scan(
                step, (xbar[0], jnp.zeros((S, 128), dtype)), scan_inputs,
                unroll=o.scan_unroll,
            )
            u0 = jnp.zeros((nu, S, 128), dtype)
            gT = self.cost2[self.gT](x_last, u0, ws[-1])
            J = J + gT
            cT = None
            if nc > 0:
                cT = self.con2[self.cT](x_last, u0, ws[-1])
                iq = self.ineq_t[-1][:, None, None]
                inactive = iq & (cT < 0.0) & (duals[-1] == 0.0)
                a = jnp.where(inactive, 0.0, 1.0).astype(dtype)
                J = J + jnp.sum(
                    duals[-1] * cT + 0.5 * a * penalty[-1] * cT * cT, axis=0
                )
            if not emit:
                return J
            if nc > 0:
                xs_head, us, c_head = ys
                c = jnp.concatenate([c_head, cT[None]], axis=0)
            else:
                xs_head, us = ys
                c = jnp.zeros((spec.T, 0, S, 128), dtype)
            xs = jnp.concatenate([xs_head, x_last[None]], axis=0)
            return xs, us, J, c

        if o.line_search == "none":
            # unconditional full step (reference: src/options.jl:2)
            ones = jnp.ones((S, 128), dtype)
            xs_w, us_w, J_w, c_w = roll(ones, emit=True)
            ok = jnp.isfinite(J_w)
            return (
                jnp.where(ok, xs_w, xbar),
                jnp.where(ok, us_w, ubar),
                jnp.where(ok, J_w, J_prev),
                jnp.where(ok, c_w, c_prev),
                ok,
                ones,
            )

        na = o.num_step_sizes
        alphas = 0.5 ** jnp.arange(na, dtype=dtype)
        c1 = jnp.asarray(o.armijo_c1, dtype)

        viol_filter = self._viol_filter

        def score_block(alphas_blk):
            """Score a block of candidates in one scan: the candidate axis
            rides axis 0 of the carry, shared per-step inputs read once.
            With constraint_aware_acceptance the per-candidate max violation
            (ops/rollout.py ``viol_of`` semantics) is accumulated in the
            carry alongside the objective."""
            nb = alphas_blk.shape[0]

            def score_step(carry, inp):
                if viol_filter:
                    x, J, V = carry            # [nb,nx,S,L], [nb,S,L], [nb,S,L]
                else:
                    x, J = carry
                td, tg, tc, xb, ub, w, K_t, k_t, lam_t, rho_t, iq_t, cm_t = inp
                dx = x - xb[None]
                u = (
                    ub[None]
                    + jnp.sum(K_t[None] * dx[:, None], axis=2)
                    + alphas_blk[:, None, None, None] * k_t[None]
                )
                g = _switch(tg, self.cost3, x, u, w)
                J = J + g
                if nc > 0:
                    c_t = _switch(tc, self.con3, x, u, w)  # [nb,nc,S,L]
                    iq = iq_t[None, :, None, None]
                    lam = lam_t[None]
                    rho = rho_t[None]
                    inactive = iq & (c_t < 0.0) & (lam == 0.0)
                    a = jnp.where(inactive, 0.0, 1.0).astype(dtype)
                    J = J + jnp.sum(
                        lam * c_t + 0.5 * a * rho * c_t * c_t, axis=1
                    )
                    if viol_filter:
                        v = jnp.where(iq, jnp.maximum(c_t, 0.0),
                                      jnp.abs(c_t))
                        v = jnp.where(cm_t[None, :, None, None], v, 0.0)
                        V = jnp.maximum(V, jnp.max(v, axis=1))
                xn = _switch(td, self.dyn3, x, u, w)
                carry_out = (xn, J, V) if viol_filter else (xn, J)
                return carry_out, jnp.zeros((), dtype)

            x0 = jnp.broadcast_to(xbar[0][None], (nb, nx, S, 128))
            carry0 = (x0, jnp.zeros((nb, S, 128), dtype))
            if viol_filter:
                carry0 = carry0 + (jnp.zeros((nb, S, 128), dtype),)
            carry_end, _ = jax.lax.scan(
                score_step, carry0, scan_inputs, unroll=o.scan_unroll,
            )
            if viol_filter:
                x_last, J_b, V_b = carry_end
            else:
                x_last, J_b = carry_end
            u0 = jnp.zeros((nb, nu, S, 128), dtype)
            gT = self.cost3[self.gT](x_last, u0, ws[-1])
            J_b = J_b + gT
            if nc > 0:
                cT = self.con3[self.cT](x_last, u0, ws[-1])
                iq = self.ineq_t[-1][None, :, None, None]
                lam = duals[-1][None]
                rho = penalty[-1][None]
                inactive = iq & (cT < 0.0) & (lam == 0.0)
                a = jnp.where(inactive, 0.0, 1.0).astype(dtype)
                J_b = J_b + jnp.sum(
                    lam * cT + 0.5 * a * rho * cT * cT, axis=1
                )
                if viol_filter:
                    v = jnp.where(iq, jnp.maximum(cT, 0.0), jnp.abs(cT))
                    v = jnp.where(
                        self.cmask_t[-1][None, :, None, None], v, 0.0
                    )
                    V_b = jnp.maximum(V_b, jnp.max(v, axis=1))
            if viol_filter:
                return J_b, V_b
            return J_b

        def acc(J_blk, alphas_blk):
            return (
                J_blk
                <= J_prev[None]
                + c1 * alphas_blk[:, None, None] * slope[None]
            ) & jnp.isfinite(J_blk)

        n1 = min(8, na)
        if viol_filter:
            # constraint-aware acceptance (options.py; vmap-path analog in
            # ops/forward.py): among the accepted candidates prefer the
            # largest step whose max violation does not worsen beyond
            # max(previous violation, tolerance)
            viol_gate = jnp.maximum(
                self.max_violation(c_prev),
                jnp.asarray(o.constraint_tolerance, dtype),
            )                                               # [S,L]
        V_head = V_c = None
        head = score_block(alphas[:n1])
        J_head = head[0] if viol_filter else head
        if viol_filter:
            V_head = head[1]
        if na > n1:
            # tail block only when some result-consuming lane is unsettled
            # by the head (the winner is the LARGEST accepted alpha, so the
            # tail cannot change lanes that already accepted in the head).
            # With the violation filter, "settled" additionally requires a
            # head candidate that is accepted AND violation-preferred — a
            # lane whose head acceptances all worsen the violation may find
            # its preferred candidate in the tail.
            head_acc = acc(J_head, alphas[:n1])
            if viol_filter:
                head_ok = jnp.any(
                    head_acc & (V_head <= viol_gate[None]), axis=0
                )                                           # [S,L]
            else:
                head_ok = jnp.any(head_acc, axis=0)         # [S,L]
            settled = head_ok if need is None else (head_ok | ~need)
            blk_shape = (na - n1,) + J_head.shape[1:]
            if viol_filter:
                J_tail, V_tail = jax.lax.cond(
                    jnp.all(settled),
                    lambda: (jnp.full(blk_shape, jnp.inf, dtype),
                             jnp.full(blk_shape, jnp.inf, dtype)),
                    lambda: score_block(alphas[n1:]),
                )
                V_c = jnp.concatenate([V_head, V_tail], axis=0)
            else:
                J_tail = jax.lax.cond(
                    jnp.all(settled),
                    lambda: jnp.full(blk_shape, jnp.inf, dtype),
                    lambda: score_block(alphas[n1:]),
                )
            J_c = jnp.concatenate([J_head, J_tail], axis=0)
        else:
            J_c = J_head
            V_c = V_head

        accept = acc(J_c, alphas)
        status = jnp.any(accept, axis=0)                   # [S,L]
        idx = jnp.argmax(accept, axis=0)                   # [S,L]
        if viol_filter:
            preferred = accept & (V_c <= viol_gate[None])
            idx = jnp.where(
                jnp.any(preferred, axis=0),
                jnp.argmax(preferred, axis=0), idx,
            )
        alpha_win = alphas[idx]
        J_win = jnp.take_along_axis(J_c, idx[None], axis=0)[0]

        xs_w, us_w, _J_reroll, c_w = roll(alpha_win, emit=True)
        xs = jnp.where(status, xs_w, xbar)
        us = jnp.where(status, us_w, ubar)
        J = jnp.where(status, J_win, J_prev)
        c = jnp.where(status, c_w, c_prev)
        step_size = jnp.where(status, alpha_win, alphas[-1] * 0.5)
        return xs, us, J, c, status, step_size
