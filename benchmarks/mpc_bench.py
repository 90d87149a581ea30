"""Warm-started MPC step latency.

Measures the steady-state receding-horizon step — shift previous plan,
re-roll from the measured state, warm-started re-solve, emit first action —
for a single acrobot controller at T=51 and T=101.  The relevant number for a
control loop is the STEADY-STATE warm step (the plan barely changes between
steps), not the cold solve: warm inner solves run
only a handful of iterations.

Plant simulation: the controller's own discrete dynamics plus a small state
disturbance, so every re-solve does real work.

Prints one JSON line per configuration.

Usage: python benchmarks/mpc_bench.py [--cpu] [--steps 30]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import jax
import jax.numpy as jnp


def run_case(T, opts_kwargs, carry_duals, steps, dtype):
    import numpy as np

    from iterativelqr_tpu import Options
    from iterativelqr_tpu.core.mpc import make_mpc_controller
    from iterativelqr_tpu.core.spec import build_spec
    from iterativelqr_tpu.models import acrobot
    from iterativelqr_tpu.ops.rollout import open_loop_rollout

    dynamics, objective, constraints, x1, xT = acrobot.problem(T)
    spec = build_spec(dynamics, objective, constraints)
    ctrl_kwargs = {
        k: opts_kwargs.pop(k)
        for k in ("max_step_iterations",)
        if k in opts_kwargs
    }
    opts = Options(verbose=False, record_traces=False, **opts_kwargs)
    init, step = make_mpc_controller(
        spec, opts, carry_duals=carry_duals, **ctrl_kwargs
    )
    step = jax.jit(step)

    us = jnp.full((T - 1, spec.nu), 0.05, dtype)
    ws = jnp.zeros((T, max(spec.npar, 0)), dtype)
    x0 = jnp.zeros(spec.nx, dtype)
    xs = open_loop_rollout(spec, x0, us, ws)
    state = init(xs, us, ws)

    f = spec.dyn_eval[0]
    plant = jax.jit(lambda x, u, w: f(x, u, w))

    rng = np.random.default_rng(0)
    x = x0
    # warm-up phase: first steps pay compilation + initial plan settling
    lat = []
    viols = []
    iters = []
    # XLA:CPU x64 workaround: feeding the fused solve's f64 outputs back as
    # inputs to the same executable corrupts the heap (upstream aliasing
    # bug; repro in CLAUDE.md) — break the buffer chain with host copies.
    # Never applied on the GPU (would add host round trips to the measurement).
    host_copy = jax.default_backend() == "cpu" and dtype == jnp.float64
    for i in range(steps):
        t0 = time.perf_counter()
        out = step(state, x, ws)
        jax.block_until_ready(out.action)
        lat.append(time.perf_counter() - t0)
        state = out.state
        if host_copy:
            state = jax.tree.map(
                lambda a: jnp.asarray(np.asarray(a)), state
            )
        viols.append(float(out.solution.max_violation))
        iters.append(int(out.solution.iterations))
        dist = jnp.asarray(
            0.002 * rng.standard_normal(spec.nx), dtype
        )
        x = plant(x, out.action, ws[0]) + dist
    steady = lat[5:]
    # transient envelope: worst constraint violation
    # across steady steps, and the longest consecutive run of infeasible
    # steps (steps-to-refeasibility after an excursion)
    tol = opts.constraint_tolerance
    worst_run, run = 0, 0
    for v in viols[5:]:
        run = run + 1 if v > tol else 0
        worst_run = max(worst_run, run)
    return {
        "horizon": T,
        "carry_duals": carry_duals,
        "steady_ms": round(1e3 * sum(steady) / len(steady), 2),
        "p50_ms": round(1e3 * sorted(steady)[len(steady) // 2], 2),
        "max_ms": round(1e3 * max(steady), 2),
        "cold_ms": round(1e3 * lat[1], 2),  # lat[0] includes compile
        "mean_inner_iters": round(sum(iters[5:]) / len(iters[5:]), 1),
        "worst_transient_viol": round(max(viols[5:]), 4),
        "max_consec_infeasible_steps": worst_run,
        "backend": jax.default_backend(),
        **{k: v for k, v in opts_kwargs.items() if k != "verbose"},
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--horizons", default="51,101")
    ap.add_argument(
        "--budgets", default=None,
        help="comma list of max_step_iterations budgets to sweep "
        "(e.g. 3,5,8,12); default: full convergence + budget 5",
    )
    ap.add_argument(
        "--ddp", action="store_true",
        help="also sweep Options(ddp=True) variants (full second-order "
        "dynamics terms; forces the scan backward — see core/options.py)",
    )
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if not args.cpu and jax.devices()[0].platform != "gpu":
        sys.exit("mpc_bench: JAX finds no GPU (pass --cpu for a CPU run)")
    from iterativelqr_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    dtype = jnp.float64 if args.cpu else jnp.float32
    if args.cpu:
        jax.config.update("jax_enable_x64", True)

    if args.budgets is not None:
        sweeps = [
            dict(backward_pass="auto", max_step_iterations=int(b))
            for b in args.budgets.split(",")
        ]
    else:
        sweeps = [
            dict(backward_pass="auto"),
            dict(backward_pass="auto", max_step_iterations=5),
        ]
    if args.ddp:
        sweeps = sweeps + [dict(s, ddp=True) for s in sweeps]
    for T in [int(t) for t in args.horizons.split(",")]:
        for kwargs in sweeps:
            for carry in [True]:
                r = run_case(T, dict(kwargs), carry, args.steps, dtype)
                print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
