"""Experiment harness for adaptive AL penalty/dual schedules.

Runs the jitted INNER solve one AL round at a time (max_dual_updates=1 +
dual_warm_start) and drives candidate outer schedules in Python, so schedule
variants iterate without re-lowering the full program.  Total inner iterations
is the device-time proxy being minimized; convergence at unchanged tolerances is
the constraint.  The winning schedule ships inside core/solve.py
(options.adaptive_penalty); this lab stays as the measurement tool.

Usage: python benchmarks/al_schedule_lab.py [--schedules ref,stall ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from iterativelqr_tpu.utils.compile_cache import setup_compile_cache

setup_compile_cache()

import jax.numpy as jnp
import numpy as np

from iterativelqr_tpu.core.options import Options
from iterativelqr_tpu.core.solve import make_solve_fn
from iterativelqr_tpu.core.spec import build_spec
from iterativelqr_tpu.models import acrobot, car, particle
from iterativelqr_tpu.ops import al as al_ops
from iterativelqr_tpu.ops import derivatives as dv
from iterativelqr_tpu.ops.rollout import open_loop_rollout


def build(name):
    if name == "particle":
        T = 11
        dynamics, objective, constraints, x1, xT = particle.problem(T)
        u0 = 0.0
    elif name == "car":
        T = 51
        dynamics, objective, constraints, x1, xT = car.problem(T)
        u0 = 0.01
    elif name == "acrobot51":
        T = 51
        dynamics, objective, constraints, x1, xT = acrobot.problem(T)
        u0 = 0.05
    elif name == "acrobot101":
        T = 101
        dynamics, objective, constraints, x1, xT = acrobot.problem(T)
        u0 = 0.05
    else:
        raise ValueError(name)
    spec = build_spec(dynamics, objective, constraints)
    us = jnp.full((T - 1, spec.nu), u0, jnp.float64)
    if name == "car":
        # reference: examples/car.jl:37 uses [0.01, 0.01] controls
        us = jnp.full((T - 1, spec.nu), 0.01, jnp.float64)
    ws = jnp.zeros((T, spec.npar), jnp.float64)
    x0 = jnp.zeros(spec.nx, jnp.float64).at[: x1.shape[0]].set(x1)
    xs = open_loop_rollout(spec, x0, us, ws)
    return spec, xs, us, ws


def run_schedule(spec, xs, us, ws, schedule, opts=Options(), max_rounds=10):
    """Drive one inner solve per round; `schedule(state) -> (duals, penalty,
    inner_opts_overrides)` decides the next round."""
    T, nc = spec.T, spec.nc
    ineq = jnp.asarray(spec.ineq_mask)
    c_mask = jnp.asarray(spec.c_mask)
    inner_cache = {}

    def inner(local_opts, xs, us, ws, duals, penalty):
        key = local_opts
        if key not in inner_cache:
            inner_cache[key] = jax.jit(
                make_solve_fn(
                    spec,
                    dataclasses.replace(local_opts, max_dual_updates=1),
                    dual_warm_start=True,
                )
            )
        return inner_cache[key](xs, us, ws, duals, penalty)

    duals = jnp.zeros((T, nc), jnp.float64)
    penalty = jnp.full((T, nc), opts.initial_constraint_penalty, jnp.float64)
    total_inner = 0
    viol_prev = np.inf
    history = []
    state = {}
    for r in range(max_rounds):
        local_opts, state = schedule.round_options(r, viol_prev, opts, state)
        sol = inner(local_opts, xs, us, ws, duals, penalty)
        xs, us = sol.xs, sol.us
        total_inner += int(sol.iterations)
        c = dv.constraint_values(spec, xs, us, ws)
        viol = float(al_ops.max_violation(c, ineq, c_mask))
        history.append((r, int(sol.iterations), viol, float(jnp.max(penalty)) if nc else 0.0))
        if viol <= opts.constraint_tolerance:
            return dict(converged=True, rounds=r + 1, total_inner=total_inner,
                        viol=viol, history=history)
        duals, penalty, state = schedule.update(
            c, duals, penalty, ineq, viol, viol_prev, opts, state
        )
        viol_prev = viol
    return dict(converged=False, rounds=max_rounds, total_inner=total_inner,
                viol=viol, history=history)


class RefSchedule:
    """Reference behavior: always dual-ascent, always rho *= scale."""

    def round_options(self, r, viol_prev, opts, state):
        return opts, state

    def update(self, c, duals, penalty, ineq, viol, viol_prev, opts, state):
        d, p = al_ops.dual_update(
            c, duals, penalty, ineq, opts.scaling_penalty, opts.max_penalty
        )
        return d, p, state


class StallSchedule:
    """Dual ascent every round; extra penalty growth only when violation
    stalls (did not decrease by `gate`)."""

    def __init__(self, gate=0.25, extra=10.0):
        self.gate, self.extra = gate, extra

    def round_options(self, r, viol_prev, opts, state):
        return opts, state

    def update(self, c, duals, penalty, ineq, viol, viol_prev, opts, state):
        improved = viol <= self.gate * viol_prev
        scale = opts.scaling_penalty * (1.0 if improved else self.extra)
        d = duals + penalty * c
        d = jnp.where(ineq, jnp.maximum(d, 0.0), d)
        p = jnp.minimum(scale * penalty, opts.max_penalty)
        return d, p, state


class NoGrowthOnProgress:
    """ALTRO-flavor: if violation improved well, only dual ascent (keep rho);
    else rho *= scale."""

    def __init__(self, gate=0.25):
        self.gate = gate

    def round_options(self, r, viol_prev, opts, state):
        return opts, state

    def update(self, c, duals, penalty, ineq, viol, viol_prev, opts, state):
        improved = viol <= self.gate * viol_prev
        scale = 1.0 if improved else opts.scaling_penalty
        d = duals + penalty * c
        d = jnp.where(ineq, jnp.maximum(d, 0.0), d)
        p = jnp.minimum(scale * penalty, opts.max_penalty)
        return d, p, state


class TightInner:
    """Reference schedule but with tighter inner objective tolerance (the
    1-iteration premature inner exits are the suspected pathology)."""

    def __init__(self, obj_tol=1e-6):
        self.obj_tol = obj_tol

    def round_options(self, r, viol_prev, opts, state):
        return dataclasses.replace(opts, objective_tolerance=self.obj_tol), state

    def update(self, c, duals, penalty, ineq, viol, viol_prev, opts, state):
        d, p = al_ops.dual_update(
            c, duals, penalty, ineq, opts.scaling_penalty, opts.max_penalty
        )
        return d, p, state


class ViolScaledObjTol:
    """Inner |dJ| stop scaled to the CONSTRAINT scale: tolerance =
    objective_tolerance * min(1, (tol_c / viol)^2)-ish — tight while
    infeasible, reference-loose once feasible."""

    def round_options(self, r, viol_prev, opts, state):
        if not np.isfinite(viol_prev):
            f = 1e-4
        else:
            f = min(1.0, (opts.constraint_tolerance / viol_prev) ** 1)
        tol = max(opts.objective_tolerance * f, 1e-10)
        return dataclasses.replace(opts, objective_tolerance=tol), state

    def update(self, c, duals, penalty, ineq, viol, viol_prev, opts, state):
        d, p = al_ops.dual_update(
            c, duals, penalty, ineq, opts.scaling_penalty, opts.max_penalty
        )
        return d, p, state


class Combined:
    """Tight-while-infeasible inner tolerance + stall-gated extra growth."""

    def __init__(self, gate=0.25, extra=10.0):
        self.gate, self.extra = gate, extra

    def round_options(self, r, viol_prev, opts, state):
        if not np.isfinite(viol_prev) or viol_prev > opts.constraint_tolerance:
            tol = opts.objective_tolerance * 1e-4
        else:
            tol = opts.objective_tolerance
        return dataclasses.replace(opts, objective_tolerance=tol), state

    def update(self, c, duals, penalty, ineq, viol, viol_prev, opts, state):
        improved = viol <= self.gate * viol_prev
        scale = opts.scaling_penalty * (1.0 if improved else self.extra)
        d = duals + penalty * c
        d = jnp.where(ineq, jnp.maximum(d, 0.0), d)
        p = jnp.minimum(scale * penalty, opts.max_penalty)
        return d, p, state


SCHEDULES = {
    "ref": RefSchedule(),
    "stall": StallSchedule(),
    "nogrow": NoGrowthOnProgress(),
    "tight6": TightInner(1e-6),
    "tight8": TightInner(1e-8),
    "violtol": ViolScaledObjTol(),
    "combined": Combined(),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--schedules", default="ref,stall,nogrow,tight6,violtol,combined")
    ap.add_argument("--problems", default="particle,car,acrobot51,acrobot101")
    args = ap.parse_args()
    for pname in args.problems.split(","):
        spec, xs, us, ws = build(pname)
        for sname in args.schedules.split(","):
            r = run_schedule(spec, xs, us, ws, SCHEDULES[sname])
            print(json.dumps({
                "problem": pname, "schedule": sname,
                "converged": r["converged"], "rounds": r["rounds"],
                "total_inner": r["total_inner"], "viol": round(r["viol"], 8),
                "history": [[h[0], h[1], round(h[2], 6), h[3]] for h in r["history"]],
            }), flush=True)


if __name__ == "__main__":
    main()
