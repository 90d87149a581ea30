"""Smoke run of the system on one NVIDIA GPU: the quickest proof that the
batched AL-iLQR solve still starts, compiles and solves on the card.

    python chip_smoke.py           # phases 1-5 on one GPU
    python chip_smoke.py --ab      # end-to-end kernel vs XLA scan vs vmap
                                   # (and the kernel's block/warp sweep)
    python chip_smoke.py --multi   # the sharded paths on all local GPUs

Phases (no arguments):
  1. the card: nvidia-smi name and power limit, JAX device kind and count;
  2. the Pallas-Triton Riccati kernel compiled for the card at acrobot and
     cartpole widths, B=8192, against the XLA scan reference (quadrotor
     widths are past the kernel's limit: the XLA scan runs there);
  3. the bench path (bench.py) for both presets at B=8192 with straggler
     compaction: solved fraction from violations recomputed from the
     returned trajectories, iterations, wall clock, first call (compile +
     one solve), peak device memory, and the solver and recursion ``auto``
     chose;
  4. float64 single-instance solves of particle, car and acrobot T=101
     against the golden fixtures (tests/test_golden.py tolerances);
  5. one B=1 acrobot solve, then five warm MPC steps.

Any failed phase exits non-zero.  With no GPU it exits non-zero before
printing any result.  The last line of a passing run is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))
B_CANON = 8192
T_CANON = 101
# Kernel vs reference, f32 on both sides: elementwise arithmetic only (no
# dot products, so no TF32), but contraction into FMAs and the order of the
# unrolled sums differ between Triton and XLA, and the 100-step recursion
# compounds last-bit differences through P.
KERNEL_RTOL = 1e-4


def _phase(name):
    print(f"\n== {name}", flush=True)


def card_info():
    _phase("1. card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    d = jax.devices()
    print(smi)
    print(f"jax device_kind={d[0].device_kind!r} count={len(d)}")
    return smi


def _random_stacks(n, m, B, Tm1, key, dtype=jnp.float32):
    """SL-layout derivative stacks of a stable, PD-cost problem."""
    S = B // 128
    ks = jax.random.split(key, 7)
    nrm = lambda k, *s: jax.random.normal(k, s + (S, 128), dtype)
    eye = lambda d: jnp.eye(d, dtype=dtype)[..., None, None]
    fx = eye(n)[None] + 0.05 * nrm(ks[0], Tm1, n, n)
    fu = 0.1 * nrm(ks[1], Tm1, n, m)
    gx = nrm(ks[2], Tm1 + 1, n)
    gu = nrm(ks[3], Tm1, m)

    def spd(k, rows, d):
        A = nrm(k, rows, d, d)
        return jnp.einsum("tiksl,tjksl->tijsl", A, A) / d + eye(d)[None]

    gxx = spd(ks[4], Tm1 + 1, n)
    guu = spd(ks[5], Tm1, m)
    gux = 0.05 * nrm(ks[6], Tm1, m, n)
    stacks = (fx, fu, gx[:-1], gu, gxx[:-1], guu, gux)
    return stacks, gxx[-1], gx[-1], jnp.zeros((S, 128), dtype)


def _acrobot_batch(B, T):
    """The bench protocol's batch: perturbed hanging starts, f32."""
    from iterativelqr_tpu.core.spec import build_spec
    from iterativelqr_tpu.models import acrobot

    dynamics, objective, constraints, _, _ = acrobot.problem(T)
    spec = build_spec(dynamics, objective, constraints)
    dtype = jnp.float32
    x0 = 0.05 * jax.random.normal(jax.random.PRNGKey(0), (B, spec.nx), dtype)
    xs = jnp.zeros((B, T, spec.nx), dtype).at[:, 0, :].set(x0)
    us = 0.05 * jnp.ones((B, T - 1, spec.nu), dtype)
    ws = jnp.zeros((B, T, max(spec.npar, 0)), dtype)
    return spec, xs, us, ws


def _preset(name):
    """bench.py's preset options with no command-line overrides."""
    sys.path.insert(0, _ROOT)
    import bench

    return bench.preset_options(name, types.SimpleNamespace(
        early_cap=None, mct=None, penalty=None, min_step=None))


def _time(fn, args, reps=10):
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def kernel_check():
    from iterativelqr_tpu.ops import packed_backward as pk

    _phase(f"2. Riccati kernel vs XLA scan reference (f32, B={B_CANON}, "
           f"T={T_CANON})")
    ok = True
    for seed, (name, n, m) in enumerate(
        (("acrobot", 4, 1), ("cartpole", 4, 1), ("quadrotor", 12, 4))
    ):
        args = _random_stacks(n, m, B_CANON, T_CANON - 1,
                              jax.random.PRNGKey(seed))
        ref = jax.jit(pk.riccati_scan_sl)
        impl = pk.riccati_impl(n, m, "gpu")
        if not pk.kernel_fits(n, m):
            # the unrolled step at these widths does not compile in minutes
            # (ops/packed_backward.py KERNEL_MAX_ENTRIES); the solver runs
            # the XLA scan here, so that is what is checked and timed
            out_r = ref(*args)
            good = all(bool(jnp.all(jnp.isfinite(a))) for a in out_r)
            print(f"  {name} (n={n}, m={m}): auto picks {impl!r} (past "
                  f"the kernel's width limit, not compiled); XLA scan "
                  f"{1e3 * _time(ref, args):.3f} ms, finite {good}")
            ok = ok and good and impl == "xla"
            continue
        t0 = time.perf_counter()
        ker = jax.jit(pk.riccati_triton).lower(*args).compile()
        t_compile = time.perf_counter() - t0
        out_k, out_r = ker(*args), ref(*args)
        worst = 0.0
        for lbl, a, b in zip(("K", "k", "Qx", "Qu", "p"), out_k, out_r):
            err = float(jnp.max(jnp.abs(a - b)))
            rel = err / max(float(jnp.max(jnp.abs(b))), 1e-30)
            worst = max(worst, rel)
            print(f"  {name:9s} {lbl:2s} max_abs_err={err:.3e} rel={rel:.3e}")
        same_ok = bool(jnp.all(out_k[5] == out_r[5]))
        t_k, t_r = _time(ker, args), _time(ref, args)
        print(f"  {name} (n={n}, m={m}): compile {t_compile:.1f}s, "
              f"kernel {1e3 * t_k:.3f} ms, XLA scan {1e3 * t_r:.3f} ms, "
              f"ok flags equal {same_ok}, auto picks {impl!r}")
        print(f"  memory_analysis: {ker.memory_analysis()}")
        if not (worst <= KERNEL_RTOL and same_ok and impl == "triton"):
            print(f"  FAIL {name}: rel err {worst:.3e} > {KERNEL_RTOL}")
            ok = False
    return ok


def bench_path():
    sys.path.insert(0, _ROOT)
    import bench

    _phase(f"3. bench path, B={B_CANON}, both presets, compaction on")
    ok = True
    for preset in ("tuned", "parity"):
        args = types.SimpleNamespace(
            horizon=T_CANON, batch=B_CANON, reps=1, chunk=None,
            no_compact=False, early_cap=None, mct=None, penalty=None,
            min_step=None,
        )
        rec = bench.run_preset(args, preset)
        print("  " + json.dumps(rec))
        if rec["solved_fraction"] != 1.0:
            print(f"  FAIL {preset}: solved_fraction {rec['solved_fraction']}")
            ok = False
    return ok


def golden_f64():
    sys.path.insert(0, os.path.join(_ROOT, "tests"))
    from test_golden import CASES, _FIX

    from iterativelqr_tpu import Options, Solver, rollout

    _phase("4. float64 single-instance solves vs golden fixtures")
    ok = True
    with jax.enable_x64(True):
        for name in ("particle", "car", "acrobot_T101"):
            build, (x_atol, u_atol) = CASES[name]
            data = np.load(os.path.join(_FIX, f"golden_{name}.npz"))
            dynamics, objective, constraints, x1, _ = build()
            solver = Solver(
                dynamics, objective, constraints,
                options=Options(verbose=False, adaptive_penalty=False),
            )
            us_list = [jnp.asarray(u) for u in data["us0"]]
            xs_list = rollout(dynamics, x1, us_list)
            solver.initialize_states(xs_list).initialize_controls(us_list)
            sol = solver.solve()
            xs, us = solver.get_trajectory()
            dx = float(np.max(np.abs(np.stack(xs) - data["xs"])))
            du = float(np.max(np.abs(np.stack(us) - data["us"])))
            viol = float(sol.max_violation)
            good = (viol <= 5e-3 and dx <= x_atol and du <= u_atol
                    and np.stack(xs).dtype == np.float64)
            print(f"  {name}: violation {viol:.2e}, max |dx| {dx:.2e} "
                  f"(tol {x_atol}), max |du| {du:.2e} (tol {u_atol}) "
                  f"{'ok' if good else 'FAIL'}")
            ok = ok and good
    return ok


def latency_and_mpc():
    from iterativelqr_tpu import Options
    from iterativelqr_tpu.core.mpc import make_mpc_controller
    from iterativelqr_tpu.core.solve import make_solve_fn
    from iterativelqr_tpu.core.spec import build_spec
    from iterativelqr_tpu.models import acrobot

    _phase(f"5. B=1 acrobot T={T_CANON} solve, then 5 warm MPC steps (f32)")
    dynamics, objective, constraints, x1, _ = acrobot.problem(T_CANON)
    spec = build_spec(dynamics, objective, constraints)
    opts = Options(verbose=False, record_traces=False)
    dtype = jnp.float32
    xs = jnp.zeros((T_CANON, spec.nx), dtype).at[0].set(x1.astype(dtype))
    us = 0.05 * jnp.ones((T_CANON - 1, spec.nu), dtype)
    ws = jnp.zeros((T_CANON, max(spec.npar, 0)), dtype)
    solve = jax.jit(make_solve_fn(spec, opts))
    t0 = time.perf_counter()
    sol = jax.block_until_ready(solve(xs, us, ws))
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    sol = jax.block_until_ready(solve(xs, us, ws))
    t_warm = time.perf_counter() - t0
    viol = float(sol.max_violation)
    print(f"  solve: violation {viol:.2e}, iterations {int(sol.iterations)}, "
          f"first call {t_cold:.2f}s, warm {1e3 * t_warm:.1f} ms")
    ok = viol <= opts.constraint_tolerance

    init, step = make_mpc_controller(spec, opts)
    step = jax.jit(step)
    state = init(sol.xs, sol.us)
    x = sol.xs[0]
    for i in range(6):
        t0 = time.perf_counter()
        out = jax.block_until_ready(step(state, x, ws))
        dt = time.perf_counter() - t0
        state = out.state
        x = dynamics[0](x, out.action) + 1e-3 * jnp.ones_like(x)
        v = float(out.solution.max_violation)
        finite = bool(jnp.all(jnp.isfinite(out.action)))
        print(f"  mpc step {i} ({'compile' if i == 0 else 'warm'}): "
              f"{1e3 * dt:.1f} ms, plan violation {v:.2e}, "
              f"iterations {int(out.solution.iterations)}")
        ok = ok and finite and v <= 10 * opts.constraint_tolerance
    return ok


def ab():
    """End to end, both presets, B=8192, one monolithic batched solve each:
    the SL solver with the kernel, the SL solver with the XLA scan, and the
    vmap solver, timed in turns after one warm call each.  Then the
    kernel's lane block x warps at acrobot widths."""
    import dataclasses
    import functools
    from unittest import mock

    from iterativelqr_tpu.ops import packed_backward as pk
    from iterativelqr_tpu.parallel import make_batched_solve_fn

    _phase(f"A/B: SL+kernel vs SL+XLA scan vs vmap, B={B_CANON}")
    spec, xs, us, ws = _acrobot_batch(B_CANON, T_CANON)
    ok = True
    for preset in ("tuned", "parity"):
        opts = _preset(preset)
        sl = dataclasses.replace(opts, batched_solver="sl")
        fns = {"sl_kernel": jax.jit(make_batched_solve_fn(spec, sl))}
        with mock.patch.object(pk, "KERNEL_MAX_ENTRIES", 0):
            fns["sl_xla"] = jax.jit(make_batched_solve_fn(spec, sl))
        fns["vmap"] = jax.jit(make_batched_solve_fn(
            spec, dataclasses.replace(opts, batched_solver="vmap")
        ))
        sols, times = {}, {k: [] for k in fns}
        for k, fn in fns.items():
            t0 = time.perf_counter()
            sols[k] = jax.block_until_ready(fn(xs, us, ws))
            print(f"  {preset} {k}: first call (compile) "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
        order = list(fns) + list(fns)[::-1]
        for _ in range(2):
            for k in order:
                t0 = time.perf_counter()
                jax.block_until_ready(fns[k](xs, us, ws).xs)
                times[k].append(time.perf_counter() - t0)
        for k in fns:
            s = sols[k]
            solved = float(jnp.mean(s.max_violation
                                    <= opts.constraint_tolerance))
            t = sorted(times[k])
            med = 0.5 * (t[len(t) // 2 - 1] + t[len(t) // 2])
            print(f"  {preset} {k}: median {med:.4f}s (runs "
                  f"{', '.join(f'{x:.4f}' for x in times[k])}), solves/s "
                  f"{B_CANON * solved / med:.1f}, solved {solved}, mean/max "
                  f"iterations {float(jnp.mean(s.iterations)):.1f}/"
                  f"{int(jnp.max(s.iterations))}", flush=True)
            # the SL variants are what the bench path ships; the vmap
            # solver has no rescue pass, so a lone f32 lane may stay
            # unsolved there, and its rate counts solved lanes only
            ok = ok and (solved == 1.0 or k == "vmap")

    args = _random_stacks(4, 1, B_CANON, T_CANON - 1, jax.random.PRNGKey(0))
    for lb in (32, 64, 128, 256):
        for nw in (1, 2, 4, 8):
            if lb < 32 * nw:
                continue
            f = jax.jit(functools.partial(pk.riccati_triton, lane_block=lb,
                                          num_warps=nw))
            print(f"  kernel lane_block={lb} num_warps={nw}: "
                  f"{1e3 * _time(f, args, reps=20):.4f} ms", flush=True)
    return ok


def multi(devices=None, per_device=B_CANON, horizon=T_CANON, options=None):
    """The sharded paths — ``make_sharded_solve_fn`` and the per-device
    compaction driver — on ``devices`` (default: all local devices) at
    B = count x ``per_device``, against the one-device compacted solve of
    the same batch (solved on the first device, one ``per_device`` slice
    at a time).  ``options`` defaults to the tuned bench preset, for
    which every lane must also be solved."""
    from iterativelqr_tpu.core.solve_compact import make_compacted_solve_fn
    from iterativelqr_tpu.parallel import (
        default_mesh,
        make_sharded_solve_fn,
        shard_batch,
    )

    devices = list(jax.devices() if devices is None else devices)
    n_dev = len(devices)
    B, T = n_dev * per_device, horizon
    require_solved = options is None
    if options is None:
        options = _preset("tuned")
    _phase(f"multi: {n_dev} devices, B={B}, T={T}")
    spec, xs, us, ws = _acrobot_batch(B, T)
    tol = options.constraint_tolerance

    def timed(fn, *a):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*a))
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*a))
        return out, t_first, time.perf_counter() - t0

    # the one-device solve of the same batch, in the per-device slices (the
    # same batch shapes, so the same compiled programs)
    one = make_compacted_solve_fn(spec, options, chunk=32)

    def one_device(xs, us, ws):
        parts = [one(*(jax.device_put(a[i * per_device:(i + 1) * per_device],
                                      devices[0]) for a in (xs, us, ws)))
                 for i in range(n_dev)]
        return jax.tree.map(
            lambda *p: np.concatenate([np.asarray(x) for x in p]), *parts
        )

    ref, c1, t1 = timed(one_device, xs, us, ws)
    print(f"  one device (compaction): first call {c1:.1f}s, {t1:.3f}s, "
          f"{B / t1:.1f} solves/s/card", flush=True)

    per_dev = make_compacted_solve_fn(spec, options, chunk=32,
                                      devices=devices)
    sol_c, c2, t2 = timed(per_dev, xs, us, ws)
    print(f"  per-device compaction: first call {c2:.1f}s, {t2:.3f}s, "
          f"{B / t2 / n_dev:.1f} solves/s/card", flush=True)

    mesh = default_mesh(devices)
    sharded = make_sharded_solve_fn(spec, options, mesh=mesh)
    xs_s, us_s, ws_s = shard_batch(mesh, "batch", xs, us, ws)
    (sol_s, _), c3, t3 = timed(sharded, xs_s, us_s, ws_s)
    placed = sorted({d.id for d in sol_s.xs.sharding.device_set})
    print(f"  make_sharded_solve_fn: first call {c3:.1f}s, {t3:.3f}s, "
          f"{B / t3 / n_dev:.1f} solves/s/card, output shards on devices "
          f"{placed}", flush=True)

    ok = placed == sorted(d.id for d in devices)
    for name, s in (("per-device compaction", sol_c),
                    ("make_sharded_solve_fn", sol_s)):
        it_eq = float(np.mean(np.asarray(s.iterations)
                              == np.asarray(ref.iterations)))
        dx = float(np.max(np.abs(np.asarray(s.xs) - np.asarray(ref.xs))))
        solved = float(np.mean(np.asarray(s.max_violation) <= tol))
        print(f"  {name} vs one device: lanes with equal iterations "
              f"{it_eq}, max |dx| {dx:.2e}, solved {solved}")
        # per-lane sequences are the one-device solve's up to rounding
        # differences between programs compiled for other batch shapes
        ok = ok and np.isfinite(dx) and it_eq >= 0.99
        if require_solved:
            ok = ok and solved == 1.0
    return ok


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ab", action="store_true",
                    help="time kernel vs XLA scan vs vmap end to end")
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded paths on all local GPUs")
    args = ap.parse_args()

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX finds no GPU (platform "
              f"{devices[0].platform!r})", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, _ROOT)
    from iterativelqr_tpu.utils.compile_cache import setup_compile_cache

    print(f"compile cache: {setup_compile_cache()}")
    card_info()
    if args.multi:
        phases = [multi]
    elif args.ab:
        phases = [ab]
    else:
        phases = [kernel_check, bench_path, golden_f64, latency_and_mpc]
    failed = []
    for ph in phases:
        t0 = time.perf_counter()
        good = ph()
        print(f"  [{ph.__name__}: {'ok' if good else 'FAILED'}, "
              f"{time.perf_counter() - t0:.1f}s]", flush=True)
        if not good:
            failed.append(ph.__name__)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))


if __name__ == "__main__":
    main()
