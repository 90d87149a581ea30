"""Batched + sharded solve sweep — the capability the reference lacks.

Solves a batch of acrobot swing-ups from perturbed initial conditions in one
jitted program, sharded over every available device (GPUs, or a
virtual CPU mesh via XLA_FLAGS=--xla_force_host_platform_device_count=8).

Run: python examples/batched_sweep.py [--batch 512] [--horizon 51]
"""

import argparse
import time

import jax
import jax.numpy as jnp

from iterativelqr_tpu import Options
from iterativelqr_tpu.core.spec import build_spec
from iterativelqr_tpu.models import acrobot
from iterativelqr_tpu.parallel import (
    default_mesh,
    make_sharded_solve_fn,
    shard_batch,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--horizon", type=int, default=51)
    args = ap.parse_args()
    T, B = args.horizon, args.batch

    devices = jax.devices()
    mesh = default_mesh(devices)
    print(f"{len(devices)} {devices[0].platform} device(s); batch {B}")

    dynamics, objective, constraints, x1, xT = acrobot.problem(T)
    spec = build_spec(dynamics, objective, constraints)
    solve = make_sharded_solve_fn(
        spec, Options(verbose=False, record_traces=False), mesh=mesh
    )

    dtype = jnp.float32
    x0 = 0.05 * jax.random.normal(jax.random.PRNGKey(0), (B, spec.nx), dtype)
    us = 0.05 * jnp.ones((B, T - 1, spec.nu), dtype)
    ws = jnp.zeros((B, T, max(spec.npar, 0)), dtype)
    from iterativelqr_tpu.ops.rollout import open_loop_rollout

    ws_one = jnp.zeros((T, max(spec.npar, 0)), dtype)
    xs = jax.vmap(lambda a, b: open_loop_rollout(spec, a, b, ws_one))(x0, us)
    xs, us, ws = shard_batch(mesh, "batch", xs, us, ws)

    t0 = time.perf_counter()
    sol, stats = solve(xs, us, ws)
    jax.block_until_ready(stats)
    print(f"compile+solve: {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    sol, stats = solve(xs, us, ws)
    jax.block_until_ready(stats)
    dt = time.perf_counter() - t0
    print(f"steady state: {dt:.3f}s -> {B / dt:.0f} solves/s")
    print(f"solved fraction: {float(stats.solved_fraction):.3f}")
    print(f"mean iterations: {float(stats.mean_iterations):.1f}")


if __name__ == "__main__":
    main()
