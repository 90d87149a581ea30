"""Golden-trajectory regression tests.

The parity suite (tests/test_reference_parity.py) proves engine == oracle; if
a refactor drifted both together nothing would catch it.  These tests compare
the engine against COMMITTED converged trajectories
(tests/fixtures/golden_*.npz, generated by tests/fixtures/make_golden.py at a
point where engine and oracle agreed).  A solution shift beyond tolerance
fails even if the oracle shifts identically.  Mirrors the reference's
solution-quality assertions (reference: test/acrobot.jl:114,
test/car.jl:74-79).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from iterativelqr_tpu import Options, Solver, rollout
from iterativelqr_tpu.models import acrobot, car, cartpole, particle, quadrotor

_FIX = os.path.join(os.path.dirname(__file__), "fixtures")

# tolerances reflect how tightly each problem's optimum is pinned by the
# objective (particle is strongly convex; acrobot swing-up is the loosest)
CASES = {
    "particle": (lambda: particle.problem(11), (1e-6, 1e-6)),
    "car": (lambda: car.problem(51), (1e-3, 5e-3)),
    "acrobot": (lambda: acrobot.problem(51), (1e-2, 5e-2)),
    # the BASELINE.json headline config: a refactor that shifts the
    # benchmarked T=101 solution fails here
    "acrobot_T101": (lambda: acrobot.problem(101), (1e-2, 5e-2)),
    "cartpole": (lambda: cartpole.problem(101), (1e-2, 5e-2)),
    "quadrotor": (lambda: quadrotor.problem(41), (1e-2, 5e-2)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden_trajectory(name):
    build, (x_atol, u_atol) = CASES[name]
    data = np.load(os.path.join(_FIX, f"golden_{name}.npz"))
    dynamics, objective, constraints, x1, xT = build()
    # reference-exact AL schedule, matching how the fixtures were generated
    # (the default adaptive schedule may pick a different feasible optimum)
    solver = Solver(dynamics, objective, constraints,
                    options=Options(verbose=False, adaptive_penalty=False))
    us_list = [jnp.asarray(u) for u in data["us0"]]
    xs_list = rollout(dynamics, x1, us_list)
    solver.initialize_states(xs_list).initialize_controls(us_list)
    sol = solver.solve()
    assert float(sol.max_violation) <= 5e-3
    xs, us = solver.get_trajectory()
    np.testing.assert_allclose(np.stack(xs), data["xs"], atol=x_atol)
    np.testing.assert_allclose(np.stack(us), data["us"], atol=u_atol)
