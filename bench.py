"""Headline benchmark: batched acrobot swing-up, T=101, solves/sec/chip.

Metric (BASELINE.json): iLQR solves/sec/chip at acrobot T=101, wall-clock to
constraint violation < tolerance.  The batch is CANONICAL_BATCH (8192)
perturbed initial conditions — BASELINE.json configs[3] names 4096 — sharded
over all local devices; every instance must actually converge (the solved
fraction is recomputed from the returned trajectories and reported).

The benchmark needs a GPU: with none, it prints one JSON error line and
exits non-zero.  It never falls back to the CPU.

Baseline: the reference publishes no numbers and Julia is not in this image
(BASELINE.md), so ``vs_baseline`` is measured against the sequential
single-core NumPy implementation of the same algorithm
(benchmarks/numpy_reference.py) solving the same problem in float64 — the
honest stand-in for the reference's single-threaded CPU execution model.  The
baseline is measured once and cached in benchmarks/baseline_local.json.

A default (no-flag) run measures BOTH presets — "tuned" (hot AL schedule +
8-alpha grid) and "parity" (the library defaults, i.e. ``Options()``).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...} —
the headline value is the tuned preset; parity rides along as
``parity_value`` / ``parity_solved_fraction``.  Every record names the
device it ran on (platform, device_kind, device count).
"""

import argparse
import json
import os
import sys
import time

# The canonical deployment's batch (BASELINE.json configs[3] scaled to
# fill one card: the derivative stacks at B=8192 are ~150 MB).
CANONICAL_BATCH = 8192


def measure_baseline(T, cache_path):
    """Single-core NumPy solves/sec at acrobot T (cached)."""
    if os.path.exists(cache_path):
        with open(cache_path) as f:
            data = json.load(f)
        if data.get("T") == T:
            return data["solves_per_sec"], data
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "benchmarks"))
    import numpy as np
    from numpy_reference import acrobot_problem, solve

    prob, x1, xT = acrobot_problem(T)
    us = 0.05 * np.ones((T - 1, prob.m))
    xs = np.zeros((T, prob.n))
    for t in range(T - 1):
        xs[t + 1] = prob.f(xs[t], us[t])
    # warm once (allocator/caches), then time
    solve(prob, xs, us)
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        _, _, info = solve(prob, xs, us)
    dt = (time.perf_counter() - t0) / reps
    assert info["max_violation"] <= 5.0e-3, "baseline failed to converge"
    data = {
        "T": T,
        "solves_per_sec": 1.0 / dt,
        "seconds_per_solve": dt,
        "iterations": info["iterations"],
        "impl": "benchmarks/numpy_reference.py (sequential, float64, 1 core)",
    }
    with open(cache_path, "w") as f:
        json.dump(data, f, indent=1)
    return data["solves_per_sec"], data


def preset_options(preset, args):
    from iterativelqr_tpu import Options

    if preset == "tuned":
        # same tolerances/semantics as the reference defaults; hotter initial
        # penalty halves AL rounds (measured: inner iters 119 -> 61, all
        # instances still solve to 5e-3)
        opts = Options(
            verbose=False,
            record_traces=False,
            initial_constraint_penalty=1000.0,
            # 8-candidate alpha grid: identical convergence on this problem
            # (accepted steps never fall below 4e-3), ~4x cheaper line search
            min_step_size=4.0e-3,
            # inexact early AL rounds (max-iteration tail 105 -> 86 at
            # B=8192); the progress gate + consecutive-truncation limiter +
            # compaction rescue make it safe (Options docstrings,
            # core/solve_compact.py)
            early_round_iteration_cap=20,
        )
    else:
        # parity preset IS the library default: backward_pass="auto" +
        # batched_solver="auto" pick the batched solver
        # (parallel/batch.py::use_sl_solver) — no hand-set performance knobs
        opts = Options(verbose=False, record_traces=False)
    min_step = getattr(args, "min_step", None)
    penalty = getattr(args, "penalty", None)
    if (args.early_cap is not None or args.mct is not None
            or min_step is not None or penalty is not None):
        import dataclasses

        overrides = {}
        if min_step is not None:
            overrides["min_step_size"] = min_step
        if penalty is not None:
            overrides["initial_constraint_penalty"] = penalty
        if args.early_cap is not None:
            # 0 = the uncapped schedule (Options wants None, argparse can't
            # say it) — the no-cap control the tuned preset was swept
            # against; negatives are a typo, not a request for uncapped
            if args.early_cap < 0:
                raise SystemExit(
                    f"--early-cap {args.early_cap}: must be >= 1, or 0 for "
                    "the uncapped schedule"
                )
            overrides["early_round_iteration_cap"] = (
                args.early_cap if args.early_cap > 0 else None
            )
        if args.mct is not None:
            overrides["max_consecutive_truncations"] = args.mct
        opts = dataclasses.replace(opts, **overrides)
    return opts


def run_preset(args, preset):
    """Build, warm, integrity-check, and time one preset.  Returns the
    record dict (metric/value/... fields, baseline ratio added by main)."""
    import jax
    import jax.numpy as jnp

    from iterativelqr_tpu.core.spec import build_spec
    from iterativelqr_tpu.models import acrobot
    from iterativelqr_tpu.ops import derivatives as dv
    from iterativelqr_tpu.ops import packed_backward as pk
    from iterativelqr_tpu.parallel import (
        batch_stats,
        default_mesh,
        make_sharded_solve_fn,
        shard_batch,
    )
    from iterativelqr_tpu.parallel.batch import _sl_eligible, use_sl_solver

    T, B = args.horizon, args.batch
    # per-preset dispatch chunk (see --chunk help)
    chunk = args.chunk if args.chunk is not None else (
        48 if preset == "parity" else 32
    )
    devices = jax.devices()
    n_chips = len(devices)

    dynamics, objective, constraints, x1, xT = acrobot.problem(T)
    spec = build_spec(dynamics, objective, constraints)
    opts = preset_options(preset, args)

    dtype = jnp.float32
    key = jax.random.PRNGKey(0)
    # perturbed initial conditions around the hanging state (configs[3]).
    # Initialization protocol: nominal states = x0 spliced into zeros with
    # small constant controls.  (A consistent rollout of the 0.05 controls
    # swings chaotically over T=101 and a zero-control rollout start makes
    # the tuned solver grind; the integrity check below recomputes all
    # violations from the returned trajectories, so the reported solved
    # fraction is init-independent.)
    x0 = 0.05 * jax.random.normal(key, (B, spec.nx), dtype)
    xs = jnp.zeros((B, T, spec.nx), dtype).at[:, 0, :].set(x0)
    us = 0.05 * jnp.ones((B, T - 1, spec.nu), dtype)
    ws = jnp.zeros((B, T, max(spec.npar, 0)), dtype)

    # straggler compaction rides the SL solver: the batched while-loop
    # otherwise runs until the SLOWEST instance converges (parity: mean 72
    # iterations, max 216 — benchmarks/tail_analysis.py); the driver
    # re-packs the live tail into smaller batch shapes mid-solve, one
    # compaction loop per device
    use_compact = not args.no_compact and _sl_eligible(opts, None)
    if use_compact:
        from iterativelqr_tpu.core.solve_compact import make_compacted_solve_fn

        solve_raw = make_compacted_solve_fn(
            spec, opts, chunk=chunk,
            devices=devices if n_chips > 1 else None,
        )
        stats_jit = jax.jit(lambda s: batch_stats(s, opts.constraint_tolerance))

        def solve(xs, us, ws):
            sol = solve_raw(xs, us, ws)
            return sol, stats_jit(sol)
    else:
        mesh = default_mesh(devices)
        solve = make_sharded_solve_fn(spec, opts, mesh=mesh)
        xs, us, ws = shard_batch(mesh, "batch", xs, us, ws)

    # first call = compile + one solve (every per-shape compaction program
    # compiles here, on the same inputs as the timed runs): set-up, outside
    # the timed window
    t0 = time.perf_counter()
    sol, stats = solve(xs, us, ws)
    jax.block_until_ready(stats)
    first_call_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(args.reps):
        sol, stats = solve(xs, us, ws)
        jax.block_until_ready(stats)
    dt = (time.perf_counter() - t0) / args.reps

    # integrity check: violations recomputed from the returned trajectories
    # with independent ops must agree with what the solver reports
    ineq = jnp.asarray(spec.ineq_mask)
    cmask = jnp.asarray(spec.c_mask)

    def viol_one(xs_, us_):
        c = dv.constraint_values(spec, xs_, us_, ws[0])
        v = jnp.where(ineq, jnp.maximum(c, 0.0), jnp.abs(c))
        return jnp.max(jnp.where(cmask, v, 0.0))

    viol = jax.jit(jax.vmap(viol_one))(sol.xs, sol.us)
    solved_fraction = float(
        jnp.mean((viol <= opts.constraint_tolerance).astype(jnp.float32))
    )
    if abs(solved_fraction - float(stats.solved_fraction)) > 1e-6:
        raise RuntimeError(
            f"solver reports solved fraction {float(stats.solved_fraction)} "
            f"but the returned trajectories give {solved_fraction}"
        )
    solves_per_sec_per_chip = B * solved_fraction / dt / n_chips
    mem = devices[0].memory_stats() or {}
    sl = use_compact or use_sl_solver(opts)

    return {
        "metric": f"acrobot_T{T}_al_ilqr_solves_per_sec_per_chip",
        "value": solves_per_sec_per_chip,
        "unit": "solves/s/chip",
        "preset": preset,
        "batch": B,
        "chunk": chunk if use_compact else None,
        "compaction": use_compact,
        "batched_solver": "sl" if sl else "vmap",
        "backward": (pk.riccati_impl(spec.nx, spec.nu, devices[0].platform)
                     if sl else opts.backward_pass),
        "solved_fraction": solved_fraction,
        "wall_clock_s": dt,
        "first_call_s": first_call_s,
        "mean_iterations": float(jnp.mean(sol.iterations)),
        "max_iterations": int(jnp.max(sol.iterations)),
        "peak_bytes_in_use": mem.get("peak_bytes_in_use"),
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "chips": n_chips,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=CANONICAL_BATCH)
    ap.add_argument("--horizon", type=int, default=101)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--quick", action="store_true", help="small batch smoke run")
    ap.add_argument(
        "--no-compact", action="store_true",
        help="disable straggler compaction (single monolithic while-loop "
        "program; wall clock then rides the iteration-count tail)",
    )
    ap.add_argument(
        "--chunk", type=int, default=None,
        help="iterations per dispatch for the compaction driver "
        "(default: tuned 32, parity 48 — parity rides a longer iteration "
        "tail, so fewer host syncs pay there)",
    )
    ap.add_argument(
        "--early-cap", type=int, default=None,
        help="override Options.early_round_iteration_cap (schedule "
        "experiments; 0 = uncapped — the no-cap control for the tuned "
        "preset, which defaults to cap 20)",
    )
    ap.add_argument(
        "--mct", type=int, default=None,
        help="override Options.max_consecutive_truncations (schedule "
        "experiments; large values = pure truncation, safe only with the "
        "compaction driver's rescue pass)",
    )
    ap.add_argument(
        "--penalty", type=float, default=None,
        help="override Options.initial_constraint_penalty (AL schedule "
        "experiments; tuned preset default 1000)",
    )
    ap.add_argument(
        "--min-step", type=float, default=None, dest="min_step",
        help="override Options.min_step_size (line-search grid experiments: "
        "the candidate count is floor(log2(1/min_step))+1 — tuned preset "
        "4e-3 = 8 candidates, reference default 1e-5 = 17)",
    )
    ap.add_argument(
        "--preset", choices=["tuned", "parity", "both"], default=None,
        help="tuned: hot-start AL penalty schedule + 8-alpha grid (same "
        "tolerances, fewer iterations, solved_fraction checked); parity: the "
        "default options — reference tolerances and knobs with the "
        "stall-gated adaptive AL schedule (adaptive_penalty); both (the "
        "default unless --quick): tuned headline + parity fields in the same "
        "JSON line",
    )
    args = ap.parse_args()
    if args.preset is None:
        args.preset = "parity" if args.quick else "both"
    if args.quick:
        args.batch, args.reps = 64, 1

    overrides = {
        k: v
        for k, v in (
            ("batch", args.batch if args.batch != CANONICAL_BATCH else None),
            ("horizon", args.horizon if args.horizon != 101 else None),
            ("reps", args.reps if args.reps != 3 else None),
            ("no_compact", True if args.no_compact else None),
            ("chunk", args.chunk),
            ("early_cap", args.early_cap),
            ("mct", args.mct),
            ("min_step", args.min_step),
            ("penalty", args.penalty),
        )
        if v is not None
    }

    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(
            json.dumps({
                "metric": f"acrobot_T{args.horizon}_al_ilqr_solves_per_sec_per_chip",
                "value": None,
                "unit": "solves/s/chip",
                "error": "no_gpu",
                "detail": f"JAX found no GPU (default platform {platform!r})",
            }),
            flush=True,
        )
        sys.exit(1)

    # persistent compile cache: the solve program is large
    from iterativelqr_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    presets = ["tuned", "parity"] if args.preset == "both" else [args.preset]
    records = {p: run_preset(args, p) for p in presets}

    cache = os.path.join(os.path.dirname(__file__), "benchmarks", "baseline_local.json")
    baseline_sps, _ = measure_baseline(args.horizon, cache)
    for rec in records.values():
        rec["vs_baseline"] = rec["value"] / baseline_sps
        if overrides:
            rec["overrides"] = overrides

    headline = records[presets[0]]
    out = dict(headline)
    if "parity" in records and presets[0] != "parity":
        out["parity_value"] = records["parity"]["value"]
        out["parity_solved_fraction"] = records["parity"]["solved_fraction"]
        out["parity_wall_clock_s"] = records["parity"]["wall_clock_s"]
    # field order: metric/value/unit/vs_baseline first (driver contract)
    ordered = {
        k: out[k]
        for k in ("metric", "value", "unit", "vs_baseline")
    }
    ordered.update({k: v for k, v in out.items() if k not in ordered})
    print(json.dumps(ordered))


if __name__ == "__main__":
    main()
