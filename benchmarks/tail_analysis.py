"""Iteration-tail analysis for the batched parity solve.

The batched while-loop runs until the SLOWEST instance converges, so wall
clock is set by the iteration-count tail, not the mean (measured at B=4096
parity: mean 72, max 216 -> a 3x gap).  This script reproduces the bench
protocol, then prints the iteration distribution and what the stragglers
are doing (AL rounds vs inner iterations, final violations/penalties), to
decide between schedule fixes and straggler compaction.

Usage: python benchmarks/tail_analysis.py [--preset parity] [--batch 4096]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--horizon", type=int, default=101)
    ap.add_argument("--preset", choices=["tuned", "parity"], default="parity")
    ap.add_argument("--early-cap", type=int, default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    if jax.devices()[0].platform != "gpu":
        sys.exit("tail_analysis: JAX finds no GPU")

    from iterativelqr_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    from iterativelqr_tpu import Options
    from iterativelqr_tpu.core.spec import build_spec
    from iterativelqr_tpu.models import acrobot
    from iterativelqr_tpu.parallel import make_batched_solve_fn

    T, B = args.horizon, args.batch
    dynamics, objective, constraints, x1, xT = acrobot.problem(T)
    spec = build_spec(dynamics, objective, constraints)
    if args.preset == "tuned":
        opts = Options(
            verbose=False, record_traces=False,
            initial_constraint_penalty=1000.0, min_step_size=4.0e-3,
        )
    else:
        opts = Options(verbose=False, record_traces=False)
    if args.early_cap is not None:
        import dataclasses
        opts = dataclasses.replace(opts, early_round_iteration_cap=args.early_cap)

    dtype = jnp.float32
    key = jax.random.PRNGKey(0)
    x0 = 0.05 * jax.random.normal(key, (B, spec.nx), dtype)
    xs = jnp.zeros((B, T, spec.nx), dtype).at[:, 0, :].set(x0)
    us = 0.05 * jnp.ones((B, T - 1, spec.nu), dtype)
    ws = jnp.zeros((B, T, max(spec.npar, 0)), dtype)

    sol = make_batched_solve_fn(spec, opts)(xs, us, ws)
    it = np.asarray(sol.iterations)
    al = np.asarray(sol.al_iterations)
    viol = np.asarray(sol.max_violation)
    pen = np.asarray(sol.penalty).max(axis=(1, 2))

    pct = lambda q: float(np.percentile(it, q))
    print(json.dumps({
        "preset": args.preset, "batch": B,
        "iters": {"mean": round(float(it.mean()), 1),
                  "p50": pct(50), "p90": pct(90), "p99": pct(99),
                  "p999": pct(99.9), "max": int(it.max())},
        "live_frac_at": {str(k): round(float((it > k).mean()), 4)
                         for k in (64, 96, 128, 160, 192)},
    }))
    # what the stragglers look like
    # worst by violation first (failures), then by iterations
    orderv = np.argsort(-viol)
    order = np.argsort(-it)
    for i in list(orderv[:4]) + list(order[:8]):
        print(json.dumps({
            "inst": int(i), "iters": int(it[i]), "al_rounds": int(al[i]),
            "viol": float(viol[i]), "max_penalty": float(pen[i]),
            "objective": round(float(np.asarray(sol.objective)[i]), 3),
            "grad_norm": float(np.asarray(sol.gradient_norm)[i]),
        }))
    # mean inner iterations per AL round, tail vs bulk
    tail = it >= np.percentile(it, 99)
    print(json.dumps({
        "bulk_iters_per_round": round(float((it[~tail] / np.maximum(al[~tail], 1)).mean()), 1),
        "tail_iters_per_round": round(float((it[tail] / np.maximum(al[tail], 1)).mean()), 1),
        "bulk_rounds": round(float(al[~tail].mean()), 2),
        "tail_rounds": round(float(al[tail].mean()), 2),
    }))


if __name__ == "__main__":
    main()
