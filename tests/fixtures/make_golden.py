"""Generate the golden-trajectory fixtures (tests/fixtures/golden_*.npz).

Freezes the converged particle/car/acrobot trajectories at the point where
the engine and the independent NumPy oracle (benchmarks/numpy_reference.py)
agree, so a refactor that drifts BOTH implementations together still fails
tests/test_golden.py.  Mirrors the acceptance intent
of the reference's solution assertions (reference: test/acrobot.jl:114,
test/car.jl:74-79).

Run manually when a solution is *intended* to change:
    python tests/fixtures/make_golden.py
and commit the regenerated .npz files with a note on why they moved.
"""

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, os.pardir, os.pardir))
sys.path.insert(0, os.path.join(_HERE, os.pardir, os.pardir, "benchmarks"))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

import numpy_reference as npr
from iterativelqr_tpu import Options, Solver, rollout
from iterativelqr_tpu.models import acrobot, car, cartpole, particle, quadrotor

CASES = {
    # name: (jax problem, oracle problem, us0, oracle agreement atol (x, u))
    "particle": (particle.problem(11), npr.particle_problem(11),
                 np.zeros((10, 1)), (1e-3, 1e-3)),
    "car": (car.problem(51), npr.car_problem(51),
            np.tile([1.0e-2, 1.0e-3], (50, 1)), (2e-2, 5e-2)),
    "acrobot": (acrobot.problem(51), npr.acrobot_problem(51),
                0.05 * np.ones((50, 1)), (5e-2, 2e-1)),
    # the BASELINE.json headline config: a refactor
    # that shifts the benchmarked T=101 solution must fail CI
    "acrobot_T101": (acrobot.problem(101), npr.acrobot_problem(101),
                     0.05 * np.ones((100, 1)), (5e-2, 2e-1)),
    # the extra model families (protocol problems of benchmarks/measure_all.py).
    # cartpole's u gate is loose: the control rides the +/-10 saturation
    # limit and the bang-bang switch lands one step apart between engine
    # and oracle (one element, ~0.66) — the state gate (1e-1) pins the
    # trajectory; test_golden.py re-pins the engine's own us tightly
    "cartpole": (cartpole.problem(101), npr.cartpole_problem(101),
                 cartpole.swingup_controls(101), (1e-1, 8e-1)),
    "quadrotor": (quadrotor.problem(41), npr.quadrotor_problem(41),
                  np.full((40, 4), 9.81 / 4.0), (5e-2, 2e-1)),
}


def main():
    for name, (jx, np_prob, us0, (x_atol, u_atol)) in CASES.items():
        dynamics, objective, constraints, x1, xT = jx
        # reference-exact AL schedule: the oracle-agreement gate below
        # requires both implementations to follow the same penalty homotopy
        solver = Solver(dynamics, objective, constraints,
                        options=Options(verbose=False, adaptive_penalty=False))
        us_list = [jnp.asarray(u) for u in us0]
        xs_list = rollout(dynamics, x1, us_list)
        solver.initialize_states(xs_list).initialize_controls(us_list)
        sol = solver.solve()
        xs_jax, us_jax = solver.get_trajectory()
        xs_jax, us_jax = np.stack(xs_jax), np.stack(us_jax)
        assert float(sol.max_violation) <= 5e-3, name

        # oracle agreement gate: only frozen if independently reproduced
        prob, _, _ = np_prob
        xs0 = np.zeros((prob.T, prob.n))
        for t in range(prob.T - 1):
            xs0[t + 1] = prob.f(xs0[t], np.asarray(us0[t], float))
        xs_np, us_np, info = npr.solve(prob, xs0, np.asarray(us0, float))
        assert info["max_violation"] <= 5e-3, name
        np.testing.assert_allclose(xs_jax, xs_np, atol=x_atol)
        np.testing.assert_allclose(us_jax, us_np, atol=u_atol)

        out = os.path.join(_HERE, f"golden_{name}.npz")
        np.savez(
            out,
            xs=xs_jax, us=us_jax, us0=np.asarray(us0, float),
            max_violation=float(sol.max_violation),
            objective=float(sol.objective),
        )
        print(f"wrote {out}: viol={float(sol.max_violation):.2e} "
              f"J={float(sol.objective):.6f}")


if __name__ == "__main__":
    main()
