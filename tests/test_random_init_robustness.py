"""Random-initialization robustness sweep.

The reference initializes acrobot with unit-normal random controls
(reference: examples/acrobot.jl:97 ``1.0 * randn``) and only gets
convergence by luck of the draw.  Here 32 random control initializations are
solved as one batch at DEFAULT options and every instance must reach
feasibility — robustness the solver provides by construction (adaptive
regularization + stall-gated AL schedule), not by seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from iterativelqr_tpu import Options
from iterativelqr_tpu.core.spec import build_spec
from iterativelqr_tpu.models import acrobot, car
from iterativelqr_tpu.ops.rollout import open_loop_rollout
from iterativelqr_tpu.parallel.batch import batch_stats, make_batched_solve_fn

N_SEEDS = 32


def _sweep(problem, scale, seed):
    dynamics, objective, constraints, x1, xT = problem
    spec = build_spec(dynamics, objective, constraints)
    T = spec.T
    key = jax.random.PRNGKey(seed)
    us = scale * jax.random.normal(
        key, (N_SEEDS, T - 1, spec.nu), jnp.float64
    ) * jnp.asarray(spec.u_mask, jnp.float64)
    x0 = jnp.zeros(spec.nx, jnp.float64).at[: x1.shape[0]].set(x1)
    ws = jnp.zeros((N_SEEDS, T, max(spec.npar, 0)), jnp.float64)
    xs = jax.vmap(lambda u, w: open_loop_rollout(spec, x0, u, w))(us, ws)
    solve = jax.jit(make_batched_solve_fn(spec, Options(verbose=False)))
    sol = solve(xs, us, ws)
    return batch_stats(sol), sol


def test_acrobot_random_controls_all_solve():
    # the reference's own init protocol: unit-scale normal controls
    stats, sol = _sweep(acrobot.problem(51), 1.0, seed=0)
    assert float(stats.solved_fraction) == 1.0, (
        f"solved {float(stats.solved_fraction):.3f}, "
        f"max viol {float(stats.max_violation):.2e}"
    )


def test_car_random_controls_all_solve():
    # car controls are accelerations/steering; unit-normal over 50 steps
    # produces wild spirals — 0.1 is already far rougher than the reference's
    # fixed 0.01 init (examples/car.jl:37)
    stats, sol = _sweep(car.problem(51), 0.1, seed=1)
    assert float(stats.solved_fraction) == 1.0, (
        f"solved {float(stats.solved_fraction):.3f}, "
        f"max viol {float(stats.max_violation):.2e}"
    )
