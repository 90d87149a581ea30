"""Trajectory parity vs. an independent sequential implementation.

BASELINE.json requires the engine's solutions to match the reference
solver's state/control trajectories within tolerance on particle, car, and
acrobot.  Julia is unavailable in this image, so the oracle is
benchmarks/numpy_reference.py — the same AL-iLQR algorithm implemented
independently (sequential, float64, complex-step derivatives).  Both solvers
start from identical warm starts; their converged trajectories must agree.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np

sys.path.insert(
    0, os.path.join(os.path.dirname(__file__), os.pardir, "benchmarks")
)
import numpy_reference as npr  # noqa: E402

from iterativelqr_tpu import Options, Solver, rollout  # noqa: E402
from iterativelqr_tpu.models import acrobot, car, particle  # noqa: E402


def _np_openloop(prob, us):
    xs = np.zeros((prob.T, prob.n))
    for t in range(prob.T - 1):
        xs[t + 1] = prob.f(xs[t], us[t])
    return xs


def _solve_both(jx_problem, np_problem, us0, x_atol, u_atol):
    dynamics, objective, constraints, x1, xT = jx_problem
    # adaptive_penalty=False: this test proves ALGORITHMIC equivalence with
    # the reference's exact AL schedule (which the oracle implements).  The
    # default stall-gated schedule reaches the same feasibility at the same
    # tolerances but may select a different, equally feasible local optimum
    # on swing-up problems (different penalty homotopy path).
    solver = Solver(
        dynamics, objective, constraints,
        options=Options(verbose=False, adaptive_penalty=False),
    )
    us_list = [jnp.asarray(u) for u in us0]
    xs_list = rollout(dynamics, x1, us_list)
    solver.initialize_states(xs_list)
    solver.initialize_controls(us_list)
    sol = solver.solve()
    xs_jax, us_jax = solver.get_trajectory()

    prob, _, _ = np_problem
    us_np0 = np.asarray(us0, dtype=float)
    xs_np0 = _np_openloop(prob, us_np0)
    xs_np, us_np, info = npr.solve(prob, xs_np0, us_np0)

    assert float(sol.max_violation) <= 5.0e-3
    assert info["max_violation"] <= 5.0e-3
    np.testing.assert_allclose(np.stack(xs_jax), xs_np, atol=x_atol)
    np.testing.assert_allclose(np.stack(us_jax), us_np, atol=u_atol)


def test_particle_parity():
    T = 11
    us0 = np.zeros((T - 1, 1))
    _solve_both(particle.problem(T), npr.particle_problem(T), us0, 1e-3, 1e-3)


def test_car_parity():
    T = 51
    us0 = np.tile([1.0e-2, 1.0e-3], (T - 1, 1))
    _solve_both(car.problem(T), npr.car_problem(T), us0, 2e-2, 5e-2)


def test_acrobot_parity():
    T = 51
    us0 = 0.05 * np.ones((T - 1, 1))
    _solve_both(acrobot.problem(T), npr.acrobot_problem(T), us0, 5e-2, 2e-1)
