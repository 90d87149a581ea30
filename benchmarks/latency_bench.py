"""Single-instance cold/warm solve latency breakdown.

Where does a B=1 constrained solve spend its time on the device?
Sweeps backward_pass x scan_unroll at acrobot T=101, reports warm solve
latency, per-iteration cost, and an upper bound on per-dispatch overhead
from a no-op program round trip.

Prints one JSON line per configuration plus one "dispatch_floor" line.

Usage: python benchmarks/latency_bench.py [--cpu] [--horizon 101] [--reps 5]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import jax
import jax.numpy as jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--horizon", type=int, default=101)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if not args.cpu and jax.devices()[0].platform != "gpu":
        sys.exit("latency_bench: JAX finds no GPU (pass --cpu for a CPU run)")
    from iterativelqr_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    from iterativelqr_tpu import Options
    from iterativelqr_tpu.core.solve import make_solve_fn
    from iterativelqr_tpu.core.spec import build_spec
    from iterativelqr_tpu.models import acrobot

    T = args.horizon
    dynamics, objective, constraints, x1, xT = acrobot.problem(T)
    spec = build_spec(dynamics, objective, constraints)
    dtype = jnp.float32
    xs = jnp.zeros((T, spec.nx), dtype).at[0].set(x1.astype(dtype))
    us = 0.05 * jnp.ones((T - 1, spec.nu), dtype)
    ws = jnp.zeros((T, max(spec.npar, 0)), dtype)

    # device round-trip floor: a trivial program dispatched + synced — the
    # irreducible per-dispatch cost everything below contains exactly once
    # (the whole solve is ONE while-loop program; per-ITERATION dispatch
    # overhead is zero by construction)
    noop = jax.jit(lambda x: x + 1.0)
    x = jnp.zeros((8, 128), dtype)
    jax.block_until_ready(noop(x))
    t0 = time.perf_counter()
    for _ in range(20):
        jax.block_until_ready(noop(x))
    floor_ms = (time.perf_counter() - t0) / 20 * 1e3
    print(json.dumps({
        "stage": "dispatch_floor", "ms": round(floor_ms, 3),
        "backend": jax.default_backend(),
    }), flush=True)

    for bp in ("scan", "associative", "auto"):
        for unroll in (1, 4, 8):
            opts = Options(
                verbose=False, record_traces=False,
                backward_pass=bp, scan_unroll=unroll,
            )
            solve = jax.jit(make_solve_fn(spec, opts))
            t_c0 = time.perf_counter()
            sol = solve(xs, us, ws)
            jax.block_until_ready(sol.xs)
            cold_s = time.perf_counter() - t_c0
            t0 = time.perf_counter()
            for _ in range(args.reps):
                sol = solve(xs, us, ws)
                jax.block_until_ready(sol.xs)
            warm = (time.perf_counter() - t0) / args.reps
            iters = int(sol.iterations)
            print(json.dumps({
                "stage": f"solve_b1_{bp}_unroll{unroll}",
                "ms": round(warm * 1e3, 1),
                "cold_first_call_s": round(cold_s, 1),
                "iterations": iters,
                "ms_per_iteration": round(warm * 1e3 / max(iters, 1), 3),
                "violation": float(sol.max_violation),
                "backend": jax.default_backend(),
            }), flush=True)


if __name__ == "__main__":
    main()
