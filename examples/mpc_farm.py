"""A batched MPC farm: many receding-horizon controllers stepping in
lockstep through the SL-layout batched solver with dual warm starts.

Serving-scale MPC (one controller per vehicle/arm/plant) wants the batched
solve path, not a vmap of per-instance controllers: each step re-solves B
problems warm-started from the shifted plans, carrying AL multipliers
(``make_batched_solve_fn(dual_warm_start=True)`` — on the GPU this runs
core/solve_sl.py; on the CPU it vmaps, same semantics).

Each farm step:
  1. shift every plan one step and re-roll it from the measured state
     (dynamic consistency — see core/mpc.py for why this matters),
  2. batched warm re-solve (duals + capped penalties carried),
  3. apply each instance's first action to its (noisy) plant.

Run: python -c "import jax; jax.config.update('jax_platforms','cpu'); \
import runpy; runpy.run_path('examples/mpc_farm.py', run_name='__main__')"
"""

import jax
import jax.numpy as jnp
import numpy as np

from iterativelqr_tpu import Constraint, Cost, Dynamics, Options
from iterativelqr_tpu.core.spec import build_spec
from iterativelqr_tpu.models import particle
from iterativelqr_tpu.ops.rollout import closed_loop_rollout, open_loop_rollout
from iterativelqr_tpu.parallel import make_batched_solve_fn


def main():
    T, B, steps = 11, 32, 12
    xT = jnp.array([1.0, 0.0])
    dyn = Dynamics(particle.particle_discrete, 2, 1)
    stage = Cost(
        lambda x, u: 0.5 * jnp.sum((x - xT) ** 2) + 0.1 * jnp.sum(u**2), 2, 1
    )
    term = Cost(lambda x, u: 0.5 * jnp.sum((x - xT) ** 2), 2, 0)
    goal = Constraint(lambda x, u: x - xT, 2, 0)
    spec = build_spec(
        [dyn] * (T - 1),
        [stage] * (T - 1) + [term],
        [Constraint() for _ in range(T - 1)] + [goal],
    )
    opts = Options(
        verbose=False, record_traces=False,
        objective_tolerance=1.0e-8,  # warm re-solves: see core/mpc.py
        max_penalty=1.0e6,
    )
    dtype = jnp.float32
    ws = jnp.zeros((B, T, max(spec.npar, 0)), dtype)

    solve_cold = jax.jit(make_batched_solve_fn(spec, opts))
    solve_warm = jax.jit(make_batched_solve_fn(spec, opts, dual_warm_start=True))

    @jax.jit
    def farm_step(x_meas, sol):
        """Shift plans, re-roll from measured states, warm re-solve."""
        us_shift = jnp.concatenate([sol.us[:, 1:], sol.us[:, -1:]], axis=1)
        K_shift = jnp.concatenate([sol.K[:, 1:], sol.K[:, -1:]], axis=1)
        k0 = jnp.zeros_like(sol.k)
        xs_shift = jnp.concatenate([sol.xs[:, 1:], sol.xs[:, -1:]], axis=1)
        xs0, us0 = jax.vmap(
            lambda x0, xb, ub, Kb, kb, w: closed_loop_rollout(
                spec, xb.at[0].set(x0), ub, w, Kb, kb, 0.0
            )
        )(x_meas, xs_shift, us_shift, K_shift, k0, ws)
        # carried duals shift with the plan; penalties capped at re-entry
        duals0 = jnp.concatenate([sol.duals[:, 1:], sol.duals[:, -1:]], axis=1)
        pen0 = jnp.minimum(
            jnp.concatenate([sol.penalty[:, 1:], sol.penalty[:, -1:]], axis=1),
            1.0e4,
        )
        new_sol = solve_warm(xs0, us0, ws, duals0, pen0)
        return new_sol, new_sol.us[:, 0]

    # cold start: B particles at random positions
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(0.0, 0.3, (B, spec.nx)), dtype)
    us = jnp.zeros((B, T - 1, spec.nu), dtype)
    xs = jax.vmap(lambda x0, u, w: open_loop_rollout(spec, x0, u, w))(x, us, ws)
    sol = solve_cold(xs, us, ws)
    print(f"cold solve: mean iters {float(jnp.mean(sol.iterations)):.1f}, "
          f"max viol {float(jnp.max(sol.max_violation)):.2e}")

    f = spec.dyn_eval[0]
    for k in range(steps):
        sol, action = farm_step(x, sol)
        x = jax.vmap(lambda xi, ui: f(xi, ui, ws[0, 0]))(x, action)
        x = x + jnp.asarray(rng.normal(0.0, 0.005, x.shape), dtype)
        if k % 3 == 0 or k == steps - 1:
            print(
                f"step {k:2d}: warm iters mean "
                f"{float(jnp.mean(sol.iterations)):5.1f} max "
                f"{int(jnp.max(sol.iterations)):3d} | plan viol max "
                f"{float(jnp.max(sol.max_violation)):.2e} | dist-to-goal "
                f"mean {float(jnp.mean(jnp.linalg.norm(x - xT, axis=1))):.3f}"
            )
    assert float(jnp.max(sol.max_violation)) < 5e-3
    print("farm ok: every plan feasible at every step")


if __name__ == "__main__":
    main()
