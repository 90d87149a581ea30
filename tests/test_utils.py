"""Unit tests: checkpoint round-trips, solver shell, small utilities."""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from iterativelqr_tpu import Options
from iterativelqr_tpu.core.mpc import MPCState
from iterativelqr_tpu.core.solve import make_solve_fn
from iterativelqr_tpu.core.spec import build_spec
from iterativelqr_tpu.models import particle
from iterativelqr_tpu.utils import checkpoint, compile_cache


def _state():
    return MPCState(
        xs=jnp.arange(6.0).reshape(3, 2),
        us=jnp.ones((2, 1)),
        K=jnp.zeros((2, 1, 2)),
        duals=jnp.zeros((3, 2)),
        penalty=jnp.full((3, 2), 10.0),
    )


def _like():
    s = _state()
    return jax.tree.map(jnp.zeros_like, s)


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_uses_env_dir(tmp_path, monkeypatch, restore_cache_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is used as is."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    assert compile_cache.setup_compile_cache() == str(tmp_path / "jc")
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "jc")


def test_compile_cache_default_dir_in_checkout(monkeypatch, restore_cache_dir):
    """Unset, the cache is a fixed directory inside the checkout, listed in
    .gitignore."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = compile_cache.setup_compile_cache()
    assert path == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_checkpoint_roundtrip(tmp_path):
    state = _state()
    p = checkpoint.save(os.path.join(str(tmp_path), "ckpt"), state)
    restored = checkpoint.load(p, _like())
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_npz_fallback(tmp_path, monkeypatch):
    monkeypatch.setattr(checkpoint, "_ocp", None)
    state = _state()
    p = checkpoint.save(os.path.join(str(tmp_path), "ckpt"), state)
    assert p.endswith(".npz")
    restored = checkpoint.load(p, _like())
    np.testing.assert_array_equal(
        np.asarray(restored.penalty), np.asarray(state.penalty)
    )


def test_solver_parameters_ctor_and_property():
    """Per-timestep parameters through the Solver shell (reference: problem
    parameter trajectories, src/data/problem.jl:25-46)."""
    from iterativelqr_tpu import Constraint, Cost, Dynamics, Solver, Options

    T = 7
    A = jnp.array([[1.0, 0.2], [0.0, 1.0]])
    dyn = Dynamics(lambda x, u, w: A @ x + jnp.array([0.0, 0.2]) * u[0] + w,
                   2, 1, num_parameter=2)
    stage = Cost(lambda x, u, w: 0.1 * (x @ x + u @ u), 2, 1, num_parameter=2)
    term = Cost(lambda x, u, w: 0.1 * (x @ x), 2, 0, num_parameter=2)
    params = [0.01 * jnp.ones(2) for _ in range(T)]
    solver = Solver(
        [dyn] * (T - 1), [stage] * (T - 1) + [term],
        parameters=params, options=Options(verbose=False),
    )
    assert solver.parameters.shape == (T, 2)
    np.testing.assert_allclose(np.asarray(solver.parameters[0]), 0.01)
    sol = solver.solve()
    assert bool(jnp.isfinite(sol.objective))


def test_dual_warm_start_signature():
    """make_solve_fn(dual_warm_start=True) seeds duals/penalties explicitly;
    warm-starting with the converged duals converges at least as fast."""
    from iterativelqr_tpu import Options, make_solve_fn
    from iterativelqr_tpu.core.spec import build_spec
    from iterativelqr_tpu.models import particle

    T = 11
    dynamics, objective, constraints, x1, xT = particle.problem(T)
    spec = build_spec(dynamics, objective, constraints)
    opts = Options(verbose=False)
    cold = jax.jit(make_solve_fn(spec, opts))
    warm = jax.jit(make_solve_fn(spec, opts, dual_warm_start=True))

    xs = jnp.zeros((T, spec.nx), jnp.float64).at[0].set(x1)
    us = jnp.zeros((T - 1, spec.nu), jnp.float64)
    ws = jnp.zeros((T, 0), jnp.float64)
    sol_cold = cold(xs, us, ws)
    assert float(sol_cold.max_violation) <= 5e-3

    sol_warm = warm(sol_cold.xs, sol_cold.us, ws, sol_cold.duals, sol_cold.penalty)
    assert float(sol_warm.max_violation) <= 5e-3
    assert int(sol_warm.al_iterations) <= int(sol_cold.al_iterations)


def test_solver_shell_warm_solve():
    """Solver.solve(warm_start=True)/warm_solve() carries duals+penalties
    from the previous solution (reference: repeated solve! reuses
    objective.duals until reset, src/solve.jl:95-103) — the warm re-solve
    must need fewer AL rounds than the first, and reset_duals() must restore
    cold-start behavior."""
    from iterativelqr_tpu import Options, Solver
    from iterativelqr_tpu.models import particle
    from iterativelqr_tpu.ops.rollout import rollout

    T = 11
    dynamics, objective, constraints, x1, xT = particle.problem(T)
    solver = Solver(dynamics, objective, constraints,
                    options=Options(verbose=False))
    us0 = [jnp.zeros(1)] * (T - 1)
    solver.initialize_controls(us0)
    solver.initialize_states(rollout(dynamics, x1, us0))
    sol_cold = solver.solve()
    assert float(sol_cold.max_violation) <= 5e-3

    # warm re-solve from the converged nominal + carried duals: the AL state
    # is already correct, so it must finish in strictly fewer dual updates
    sol_warm = solver.warm_solve()
    assert float(sol_warm.max_violation) <= 5e-3
    assert int(sol_warm.al_iterations) < int(sol_cold.al_iterations)
    assert int(sol_warm.iterations) <= int(sol_cold.iterations)

    # reset drops the carried duals: the next warm_solve falls back to cold
    # AL state (same duals0 as a cold solve => al_iterations go back up for a
    # perturbed start)
    solver.reset_duals()
    assert solver._duals is None
    sol_after_reset = solver.warm_solve()  # falls back to cold path
    assert float(sol_after_reset.max_violation) <= 5e-3


def test_checkpoint_numeric_leaf_order(tmp_path):
    """Leaf keys must restore in numeric order even when pad widths are mixed
    (a lexicographic sort puts leaf_10000 before leaf_2000)."""
    import numpy as _np

    path = os.path.join(str(tmp_path), "mixed.npz")
    # simulate an artifact written with inconsistent/unpadded keys
    flat = {f"leaf_{i}": _np.asarray(float(i)) for i in range(12)}
    _np.savez(path, **flat)
    like = [jnp.zeros(()) for _ in range(12)]
    restored = checkpoint.load(path, like)
    np.testing.assert_array_equal(
        np.asarray(restored), np.arange(12.0)
    )


def test_checkpoint_orbax_dir_without_orbax_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(checkpoint, "_ocp", None)
    d = os.path.join(str(tmp_path), "dir_ckpt")
    os.makedirs(d)
    try:
        checkpoint.load(d, _like())
    except RuntimeError as e:
        assert "orbax" in str(e)
    else:
        raise AssertionError("expected RuntimeError for directory checkpoint")


def test_distributed_initialize_reraises_genuine_failures(monkeypatch):
    """Only the already-initialized case is benign: a bad
    coordinator address must raise, not silently degrade to single-host."""
    from iterativelqr_tpu.parallel import shard

    def boom(**kwargs):
        raise RuntimeError("Failed to connect to coordinator 10.0.0.1:1234")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    try:
        shard.distributed_initialize(coordinator_address="10.0.0.1:1234")
    except RuntimeError:
        pass
    else:
        raise AssertionError("expected RuntimeError to propagate")

    def benign(**kwargs):
        raise RuntimeError("jax.distributed is already initialized")

    monkeypatch.setattr(jax.distributed, "initialize", benign)
    shard.distributed_initialize()  # must not raise


def test_converged_uses_options_tolerance():
    """Solution.converged reflects the constraint_tolerance the solve ran
    with, not a hardcoded 5e-3."""
    T = 11
    dynamics, objective, constraints, x1, xT = particle.problem(T)
    spec = build_spec(dynamics, objective, constraints)
    xs = jnp.zeros((T, spec.nx), jnp.float64).at[0].set(x1)
    us = jnp.zeros((T - 1, spec.nu), jnp.float64)
    ws = jnp.zeros((T, 0), jnp.float64)
    # unreachable tolerance within 2 dual updates: converged must be False
    tight = jax.jit(
        make_solve_fn(
            spec, Options(constraint_tolerance=1e-14, max_dual_updates=2)
        )
    )(xs, us, ws)
    assert float(tight.tol_constraint) == 1e-14
    assert not bool(tight.converged)
    # default tolerance: converged True
    loose = jax.jit(make_solve_fn(spec, Options()))(xs, us, ws)
    assert float(loose.tol_constraint) == 5e-3
    assert bool(loose.converged)
    # batch_stats defaults to the carried tolerance
    from iterativelqr_tpu.parallel.batch import batch_stats

    stats_tight = batch_stats(jax.tree.map(lambda l: l[None], tight))
    assert float(stats_tight.solved_fraction) == 0.0


def test_live_progress_prints(capsys):
    T = 11
    dynamics, objective, constraints, x1, xT = particle.problem(T)
    spec = build_spec(dynamics, objective, constraints)
    xs = jnp.zeros((T, spec.nx), jnp.float64).at[0].set(x1)
    us = jnp.zeros((T - 1, spec.nu), jnp.float64)
    ws = jnp.zeros((T, 0), jnp.float64)
    sol = jax.jit(make_solve_fn(spec, Options(live_progress=True)))(xs, us, ws)
    jax.effects_barrier()
    out = capsys.readouterr().out
    assert "[al  0]" in out and "viol" in out
    assert int(sol.al_iterations) >= 1
