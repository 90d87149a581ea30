"""Pod-scale scenario sweep: 65k car+acrobot instances over a multi-host mesh.

BASELINE.json configs[4].  On a real pod slice, launch this same script on
every host (e.g. with `python -m ...` under your cluster runner); it calls
``jax.distributed.initialize`` via ``distributed_initialize()``, builds one
global mesh over all hosts' chips, and each host feeds its local shard of the
global batch.  Single-process (1 chip or a virtual CPU mesh via
``XLA_FLAGS=--xla_force_host_platform_device_count=8``) works unchanged —
that is how the dry run and CI exercise it.

The sweep solves two problem families (car obstacle + acrobot swing-up) as
two sharded batched solves and reduces convergence statistics across the
mesh (an XLA psum across devices).

Run: python examples/pod_sweep.py [--total 65536] [--quick]
"""

import argparse
import time

import jax
import jax.numpy as jnp

from iterativelqr_tpu import Options
from iterativelqr_tpu.core.spec import build_spec
from iterativelqr_tpu.models import acrobot, car
from iterativelqr_tpu.parallel import (
    default_mesh,
    distributed_initialize,
    global_batch_from_local,
    make_sharded_solve_fn,
)


def sweep(name, spec, x0_sampler, us0, T, total, mesh, opts):
    n_proc = jax.process_count()
    local = total // n_proc
    # host-local shard of the global batch
    key = jax.random.fold_in(jax.random.PRNGKey(7), jax.process_index())
    dtype = jnp.float32
    x0 = x0_sampler(key, local).astype(dtype)
    us = jnp.broadcast_to(us0.astype(dtype), (local, T - 1, spec.nu))
    ws_one = jnp.zeros((T, max(spec.npar, 0)), dtype)
    # dynamically consistent warm start (open-loop rollout), as the reference
    # examples initialize — splicing x0 into a zero trajectory underestimates
    # the initial objective and can wedge the first line search
    from iterativelqr_tpu.ops.rollout import open_loop_rollout

    xs = jax.vmap(lambda x0_, us_: open_loop_rollout(spec, x0_, us_, ws_one))(x0, us)
    ws = jnp.zeros((local, T, max(spec.npar, 0)), dtype)
    xs, us, ws = global_batch_from_local(mesh, "batch", xs, us, ws)

    solve = make_sharded_solve_fn(spec, opts, mesh=mesh)
    t0 = time.perf_counter()
    sol, stats = solve(xs, us, ws)
    jax.block_until_ready(stats)
    dt = time.perf_counter() - t0
    if jax.process_index() == 0:
        print(
            f"{name}: {total} instances in {dt:.2f}s "
            f"({total / dt:.0f} solves/s, "
            f"{total / dt / jax.device_count():.0f} /s/chip), "
            f"solved {float(stats.solved_fraction):.3f}"
        )
    return dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--total", type=int, default=65536)
    ap.add_argument("--horizon", type=int, default=51)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if args.quick:
        args.total = 256

    # On a cluster runner, jax.distributed auto-detects the coordinator
    # (SLURM, ...).  On a plain single-process
    # dev box there is nothing to detect and initialize() raises exactly
    # "coordinator_address should be defined" — that case IS the
    # documented single-process mode, so proceed with the local devices.
    # Any other init failure re-raises (parallel/shard.py rationale).
    try:
        distributed_initialize()
    except (ValueError, RuntimeError) as e:
        # message-substring match is version-fragile by nature; catching
        # both exception types jax has used for "no cluster detected"
        # keeps the fallback alive across upgrades, while anything not
        # mentioning the coordinator still re-raises
        if "coordinator" not in str(e).lower():
            raise
        print("single-process mode (no cluster coordinator detected)")
    mesh = default_mesh()
    T = args.horizon
    opts = Options(verbose=False, record_traces=False)
    half = args.total // 2

    dyn_a, obj_a, con_a, x1_a, _ = acrobot.problem(T)
    spec_a = build_spec(dyn_a, obj_a, con_a)
    sweep(
        "acrobot", spec_a,
        lambda key, n: 0.05 * jax.random.normal(key, (n, spec_a.nx)),
        0.05 * jnp.ones((T - 1, spec_a.nu)), T, half, mesh, opts,
    )

    dyn_c, obj_c, con_c, x1_c, _ = car.problem(T)
    spec_c = build_spec(dyn_c, obj_c, con_c)
    sweep(
        "car", spec_c,
        lambda key, n: 0.05 * jax.random.normal(key, (n, spec_c.nx)),
        jnp.tile(jnp.array([1.0e-2, 1.0e-3]), (T - 1, 1)), T, half, mesh, opts,
    )


if __name__ == "__main__":
    main()
