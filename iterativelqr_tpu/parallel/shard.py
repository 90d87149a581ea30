"""SPMD sharding of batched solves over a device mesh.

The multi-device axis (SURVEY.md section 2.2, BASELINE.json configs[4]): the
batch of problem instances is sharded across devices with
``jax.sharding.NamedSharding``; XLA inserts the collectives (a psum for the
aggregate statistics, nothing else — per-instance solves are embarrassingly
parallel, so the program is communication-free except for the final stats
reduction).

Design notes:
* Inputs are batch-sharded, the solve is vmapped, outputs inherit the batch
  sharding; ``batch_stats`` reduces across the mesh.
* Works identically on 1 device, N devices, or N virtual CPU devices
  (``--xla_force_host_platform_device_count``), which is how the test suite
  exercises it (SURVEY.md section 4).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.options import Options
from ..core.spec import ProblemSpec
from .batch import batch_stats, make_batched_solve_fn, use_sl_solver


def default_mesh(
    devices: Optional[Sequence] = None, axis_name: str = "batch"
) -> Mesh:
    """A 1-D mesh over all (or the given) devices; the batch axis is the only
    sharded axis — problems are independent, so a 1-D mesh needs no
    communication inside the solve."""
    devices = jax.devices() if devices is None else list(devices)
    return Mesh(np.asarray(devices), (axis_name,))


def make_sharded_solve_fn(
    spec: ProblemSpec,
    options: Options = Options(),
    mesh: Optional[Mesh] = None,
    callback: Optional[Callable] = None,
    axis_name: str = "batch",
    with_stats: bool = True,
):
    """Build a jit-compiled, mesh-sharded batched solve.

    Returns ``solve(xs_init [B,...], us_init [B,...], ws [B,...])`` where B
    must be divisible by the mesh size.  Every input/output leaf is sharded on
    its leading batch dimension; if ``with_stats`` the function returns
    ``(Solution, BatchStats)`` with the stats reduction lowered to mesh-wide
    collectives.
    """
    mesh = default_mesh(axis_name=axis_name) if mesh is None else mesh
    batched = make_batched_solve_fn(spec, options, callback)
    if use_sl_solver(options, callback):
        # The SL solver retiles the batch to [.., S, 128]; under the SPMD
        # partitioner that reshape would reshard (all-gather) the batch.
        # shard_map instead runs the SL solve independently on each device's
        # local shard — communication-free, like the per-instance math — and
        # the BatchStats reduction below (outside the shard_map) still lowers
        # to mesh-wide psum.
        local = batched
        batched = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(axis_name), P(axis_name), P(axis_name)),
            out_specs=P(axis_name),
            # pallas_call's out ShapeDtypeStructs carry no varying-axes
            # annotation
            check_vma=False,
        )
    batch_sharding = NamedSharding(mesh, P(axis_name))
    replicated = NamedSharding(mesh, P())

    if with_stats:

        def fn(xs_init, us_init, ws):
            sol = batched(xs_init, us_init, ws)
            return sol, batch_stats(sol, options.constraint_tolerance)

        # pytree-prefix shardings: every Solution leaf batch-sharded, every
        # stats leaf replicated (XLA inserts the cross-mesh psum)
        out_shardings = (batch_sharding, replicated)
    else:
        fn = batched
        out_shardings = batch_sharding

    return jax.jit(
        fn,
        in_shardings=(batch_sharding, batch_sharding, batch_sharding),
        out_shardings=out_shardings,
    )


def shard_batch(mesh: Mesh, axis_name: str, *arrays):
    """Device-put host arrays with batch sharding (helper for callers)."""
    sharding = NamedSharding(mesh, P(axis_name))
    out = tuple(jax.device_put(a, sharding) for a in arrays)
    return out if len(out) > 1 else out[0]


def distributed_initialize(**kwargs):
    """Multi-host entry: wraps ``jax.distributed.initialize``.

    On a multi-host cluster each host calls this once before building meshes; the mesh
    from ``default_mesh()`` then spans all hosts' devices and global batches
    are assembled with ``jax.make_array_from_process_local_data``.  No-op only
    when already initialized; genuine init failures (bad coordinator address,
    port conflicts) re-raise — silently degrading to a single-host mesh on a
    cluster surfaces later as hangs.
    """
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError) as e:
        if "already initialized" in str(e).lower():
            return
        raise


def global_batch_from_local(mesh: Mesh, axis_name: str, *local_arrays):
    """Assemble a globally sharded batch from per-host local shards."""
    sharding = NamedSharding(mesh, P(axis_name))
    out = tuple(
        jax.make_array_from_process_local_data(sharding, np.asarray(a))
        for a in local_arrays
    )
    return out if len(out) > 1 else out[0]
