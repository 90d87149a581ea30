"""Measured results across the reference problems (SURVEY.md section 6).

Runs the BASELINE.md protocol on this machine: for particle (T=11), car
(T=51), and acrobot (T=51, T=101) —
  * the sequential single-core NumPy implementation (the baseline stand-in),
  * this engine, single instance, on the current JAX backend,
  * this engine, batched (B instances), on the current JAX backend,
and prints a markdown table (wall-clock to tolerance, iterations,
solves/sec).

Usage: python benchmarks/measure_all.py [--batch 1024] [--out MEASURED.md]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np

from iterativelqr_tpu.utils.compile_cache import setup_compile_cache

setup_compile_cache()

import numpy_reference as npr
from iterativelqr_tpu import Options
from iterativelqr_tpu.core.solve import make_solve_fn
from iterativelqr_tpu.core.spec import build_spec
from iterativelqr_tpu.models import acrobot, car, cartpole, particle, quadrotor
from iterativelqr_tpu.parallel import batch_stats, make_batched_solve_fn

# (name, jax problem builder, numpy-oracle builder or None, T, us0(T))
# cartpole/quadrotor are beyond the reference's example set; they have no
# oracle implementation, so their rows measure the engine only
PROBLEMS = [
    ("particle T=11", particle.problem, npr.particle_problem, 11,
     lambda T: np.zeros((T - 1, 1))),
    ("car T=51", car.problem, npr.car_problem, 51,
     lambda T: np.tile([1e-2, 1e-3], (T - 1, 1))),
    ("acrobot T=51", acrobot.problem, npr.acrobot_problem, 51,
     lambda T: 0.05 * np.ones((T - 1, 1))),
    ("acrobot T=101", acrobot.problem, npr.acrobot_problem, 101,
     lambda T: 0.05 * np.ones((T - 1, 1))),
    ("cartpole T=101", cartpole.problem, None, 101,
     lambda T: np.asarray(cartpole.swingup_controls(T))),
    ("quadrotor T=41", quadrotor.problem, None, 41,
     lambda T: np.stack([np.asarray(u) for u in quadrotor.hover_controls(T)])),
]


def run_numpy(np_problem, T, us0):
    prob, x1, xT = np_problem(T)
    us = np.asarray(us0, float)
    xs = np.zeros((prob.T, prob.n))
    for t in range(prob.T - 1):
        xs[t + 1] = prob.f(xs[t], us[t])
    npr.solve(prob, xs.copy(), us.copy())  # warm
    t0 = time.perf_counter()
    _, _, info = npr.solve(prob, xs, us)
    dt = time.perf_counter() - t0
    return dt, info["iterations"], info["max_violation"]


def run_engine(jx_problem, T, us0, batch):
    dynamics, objective, constraints, x1, xT = jx_problem(T)
    spec = build_spec(dynamics, objective, constraints)
    # library defaults: batched_solver="auto" picks the batched solver by
    # platform (parallel/batch.py::use_sl_solver)
    opts = Options(verbose=False, record_traces=False)
    dtype = jnp.float32
    us1 = jnp.asarray(np.asarray(us0), dtype)
    # dynamically consistent warm start
    from iterativelqr_tpu.ops.rollout import open_loop_rollout

    ws1 = jnp.zeros((T, max(spec.npar, 0)), dtype)
    us1p = jnp.zeros((T - 1, spec.nu), dtype).at[:, : us1.shape[1]].set(us1)
    x1p = jnp.zeros((spec.nx,), dtype).at[: x1.shape[0]].set(x1.astype(dtype))

    solve1 = jax.jit(make_solve_fn(spec, opts))
    xs1 = open_loop_rollout(spec, x1p, us1p, ws1)
    sol = solve1(xs1, us1p, ws1)
    jax.block_until_ready(sol.xs)  # compile + warm
    t0 = time.perf_counter()
    sol = solve1(xs1, us1p, ws1)
    jax.block_until_ready(sol.xs)
    dt1 = time.perf_counter() - t0

    # batched with perturbed initial conditions
    solveB = jax.jit(make_batched_solve_fn(spec, opts))
    key = jax.random.PRNGKey(0)
    x0B = x1p[None] + 0.05 * jax.random.normal(key, (batch, spec.nx), dtype)
    usB = jnp.broadcast_to(us1p, (batch, T - 1, spec.nu))
    xsB = jax.vmap(lambda x0, us: open_loop_rollout(spec, x0, us, ws1))(x0B, usB)
    wsB = jnp.broadcast_to(ws1, (batch, T, max(spec.npar, 0)))
    solB = solveB(xsB, usB, wsB)
    jax.block_until_ready(solB.xs)
    t0 = time.perf_counter()
    solB = solveB(xsB, usB, wsB)
    jax.block_until_ready(solB.xs)
    dtB = time.perf_counter() - t0
    st = batch_stats(solB)
    return (
        dt1, float(sol.max_violation), int(sol.iterations),
        dtB, float(st.solved_fraction), batch,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        sys.exit("measure_all: JAX finds no GPU")

    backend = jax.default_backend()
    lines = [
        f"# Measured results ({backend} backend, batch {args.batch})",
        "",
        "| problem | numpy 1-core (s) | iters | engine 1 solve (s) | viol | "
        "engine batched (s) | solves/s | solved frac |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for name, jx, np_, T, us0_fn in PROBLEMS:
        us0 = us0_fn(T)
        if np_ is not None:
            t_np, it_np, v_np = run_numpy(np_, T, us0)
            np_cols = f"{t_np:.3f} | {it_np}"
        else:
            np_cols = "— | —"
        t1, v1, it1, tB, frac, B = run_engine(jx, T, us0, args.batch)
        lines.append(
            f"| {name} | {np_cols} | {t1:.4f} | {v1:.1e} | "
            f"{tB:.3f} | {B / tB:.0f} | {frac:.4f} |"
        )
        print(lines[-1], flush=True)
    text = "\n".join(lines) + "\n"
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print("\n" + text)


if __name__ == "__main__":
    main()
