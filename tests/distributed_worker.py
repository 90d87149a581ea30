"""Worker process for the two-process distributed test (run by
tests/test_distributed.py, one invocation per process).

Each process owns a slice of virtual CPU devices, joins the cluster via
``distributed_initialize`` (localhost coordinator), assembles the global batch
from its local shard with ``global_batch_from_local``, runs the mesh-sharded
batched solve, and writes its view of the (replicated) aggregate stats plus
the full solution trajectories fetched from the global array.  The parent
asserts both processes agree and match a single-process reference solve.

Usage: python distributed_worker.py <coordinator> <num_processes> <process_id> <outdir>
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2"
)

import jax

# the workers run on CPU, like the rest of the tests (tests/conftest.py)
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np


def main():
    coordinator, num_processes, process_id, outdir = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

    from iterativelqr_tpu import Options
    from iterativelqr_tpu.core.spec import build_spec
    from iterativelqr_tpu.models import particle
    from iterativelqr_tpu.parallel.shard import (
        default_mesh,
        distributed_initialize,
        global_batch_from_local,
        make_sharded_solve_fn,
    )

    distributed_initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    assert jax.process_count() == num_processes, jax.process_count()
    n_global = len(jax.devices())
    n_local = len(jax.local_devices())
    assert n_global == num_processes * n_local, (n_global, n_local)

    T, B = 7, 8
    dynamics, objective, constraints, x1, xT = particle.problem(T)
    spec = build_spec(dynamics, objective, constraints)
    opts = Options(verbose=False)

    # deterministic global batch; each process carves out its local rows
    rng = np.random.default_rng(0)
    x0 = 0.1 * rng.standard_normal((B, spec.nx))
    xs_g = np.zeros((B, T, spec.nx))
    xs_g[:, 0, :] = x0
    us_g = np.zeros((B, T - 1, spec.nu))
    ws_g = np.zeros((B, T, max(spec.npar, 0)))

    rows_per_proc = B // num_processes
    lo = process_id * rows_per_proc
    hi = lo + rows_per_proc

    mesh = default_mesh()
    xs, us, ws = global_batch_from_local(
        mesh, "batch", xs_g[lo:hi], us_g[lo:hi], ws_g[lo:hi]
    )
    solve = make_sharded_solve_fn(spec, opts, mesh=mesh)
    sol, stats = solve(xs, us, ws)
    jax.block_until_ready(stats)

    def allgather(a):
        return np.asarray(
            jax.experimental.multihost_utils.process_allgather(a, tiled=True)
        )

    # every process sees the same replicated stats; fetch the full (global)
    # trajectories for the parent to compare across processes
    xs_full = allgather(sol.xs)
    viol_full = allgather(sol.max_violation)

    # SL-layout solver under shard_map (each device runs the SL stack on
    # its local shard; on CPU its backward recursion is the XLA scan).
    # Cross-process evidence for the multi-device SL route.
    opts_sl = Options(
        verbose=False, record_traces=False,
        batched_solver="sl", backward_pass="packed",
    )
    solve_sl = make_sharded_solve_fn(spec, opts_sl, mesh=mesh)
    sol_sl, stats_sl = solve_sl(xs, us, ws)
    jax.block_until_ready(stats_sl)
    xs_sl_full = allgather(sol_sl.xs)
    viol_sl_full = allgather(sol_sl.max_violation)

    np.savez(
        os.path.join(outdir, f"proc{process_id}.npz"),
        solved_fraction=float(stats.solved_fraction),
        mean_objective=float(stats.mean_objective),
        xs=xs_full,
        max_violation=viol_full,
        sl_solved_fraction=float(stats_sl.solved_fraction),
        sl_xs=xs_sl_full,
        sl_max_violation=viol_sl_full,
        n_global_devices=n_global,
        process_count=jax.process_count(),
    )
    jax.distributed.shutdown()


if __name__ == "__main__":
    import jax.experimental.multihost_utils  # noqa: F401  (import check early)

    main()
