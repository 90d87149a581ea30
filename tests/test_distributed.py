"""True multi-process distributed execution.

Launches TWO actual processes on this machine, each with 2 virtual CPU
devices, joined through ``jax.distributed.initialize`` over a localhost
coordinator into a 4-device global mesh.  Each process contributes its local
batch shard via ``global_batch_from_local``; the mesh-sharded solve runs
SPMD across both processes; results must be identical across processes and
equal to a single-process solve of the same batch.

The reference has no distributed anything (SURVEY.md section 2.2); this pins
the multi-host entry path (parallel/shard.py) with real process boundaries.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_HERE = os.path.dirname(__file__)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_solve(tmp_path):
    port = _free_port()
    coordinator = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"  # workers are CPU-only
    procs = [
        subprocess.Popen(
            [
                sys.executable,
                os.path.join(_HERE, "distributed_worker.py"),
                coordinator, "2", str(pid), str(tmp_path),
            ],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=560)
        outs.append(out.decode(errors="replace"))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"

    d0 = np.load(tmp_path / "proc0.npz")
    d1 = np.load(tmp_path / "proc1.npz")
    assert int(d0["process_count"]) == 2
    assert int(d0["n_global_devices"]) == 4
    # both processes computed/assembled the same global result
    np.testing.assert_array_equal(d0["xs"], d1["xs"])
    np.testing.assert_array_equal(d0["max_violation"], d1["max_violation"])
    assert float(d0["solved_fraction"]) == float(d1["solved_fraction"])
    assert float(d0["solved_fraction"]) == 1.0

    # equals the single-process solve of the same batch (same seed protocol
    # as the worker)
    import jax
    import jax.numpy as jnp

    from iterativelqr_tpu import Options
    from iterativelqr_tpu.core.spec import build_spec
    from iterativelqr_tpu.models import particle
    from iterativelqr_tpu.parallel.batch import make_batched_solve_fn

    T, B = 7, 8
    dynamics, objective, constraints, x1, xT = particle.problem(T)
    spec = build_spec(dynamics, objective, constraints)
    rng = np.random.default_rng(0)
    x0 = 0.1 * rng.standard_normal((B, spec.nx))
    xs = jnp.zeros((B, T, spec.nx)).at[:, 0, :].set(x0)
    us = jnp.zeros((B, T - 1, spec.nu))
    ws = jnp.zeros((B, T, max(spec.npar, 0)))
    sol = jax.jit(make_batched_solve_fn(spec, Options(verbose=False)))(xs, us, ws)
    np.testing.assert_allclose(
        np.asarray(sol.xs), d0["xs"], rtol=0, atol=1e-12
    )

    # production route (SL solver under shard_map): both processes agree,
    # everything solved, and the result equals a single-process SL solve of
    # the same batch (different lane padding grouping — per-lane math is
    # independent, so agreement is near-exact)
    np.testing.assert_array_equal(d0["sl_xs"], d1["sl_xs"])
    assert float(d0["sl_solved_fraction"]) == 1.0
    sol_sl = make_batched_solve_fn(
        spec,
        Options(verbose=False, record_traces=False,
                batched_solver="sl", backward_pass="packed"),
    )(xs, us, ws)
    np.testing.assert_allclose(
        np.asarray(sol_sl.xs), d0["sl_xs"], rtol=1e-10, atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(sol_sl.max_violation), d0["sl_max_violation"],
        rtol=1e-10, atol=1e-10,
    )
