"""Horizon-axis sharding: the time-sharded backward pass must reproduce the
unsharded associative scan and the sequential backward (SURVEY.md section 5
"long-context" row; parallel/horizon.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from iterativelqr_tpu.core.spec import build_spec
from iterativelqr_tpu.models import acrobot, car
from iterativelqr_tpu.ops import derivatives as dv
from iterativelqr_tpu.ops.assoc import backward_pass_associative
from iterativelqr_tpu.ops.backward import backward_pass_scan
from iterativelqr_tpu.parallel.horizon import (
    make_horizon_sharded_backward,
    time_sharding,
)


def _stacks(mod, T, u0, seed=0):
    dynamics, objective, constraints, x1, xT = mod.problem(T)
    spec = build_spec(dynamics, objective, constraints)
    key = jax.random.PRNGKey(seed)
    us = u0 * jnp.ones((T - 1, spec.nu)) + 0.01 * jax.random.normal(
        key, (T - 1, spec.nu)
    )
    ws = jnp.zeros((T, max(spec.npar, 0)))
    xs = jnp.zeros((T, spec.nx))
    for t in range(T - 1):
        xs = xs.at[t + 1].set(spec.dyn_eval[spec.dyn_tidx[t]](
            xs[t], us[t], ws[t]
        ))
    fx, fu = dv.dynamics_jacobians(spec, xs, us, ws)
    gx, gu = dv.cost_gradients(spec, xs, us, ws)
    gxx, guu, gux = dv.cost_hessians(spec, xs, us, ws)
    um = jnp.asarray(spec.u_mask)
    return spec, (fx, fu, gx, gu, gxx, guu, gux, um)


# T=25: 25 % 8 != 0 exercises the identity-element padding; T=24 the even
# split
@pytest.mark.parametrize("mod,T,u0", [(car, 24, 0.01), (acrobot, 25, 0.05)])
def test_horizon_sharded_matches_unsharded(mod, T, u0):
    devices = jax.devices()
    assert len(devices) == 8
    mesh = Mesh(np.asarray(devices), ("time",))
    spec, (fx, fu, gx, gu, gxx, guu, gux, um) = _stacks(mod, T, u0)
    reg = jnp.zeros(())

    sharded = make_horizon_sharded_backward(mesh, "time")
    K_s, k_s, Qx_s, Qu_s, p_s, ok_s = jax.jit(sharded)(
        fx, fu, gx, gu, gxx, guu, gux, um, reg
    )
    K_a, k_a, Qx_a, Qu_a, p_a, ok_a = jax.jit(
        lambda *a: backward_pass_associative(*a)
    )(fx, fu, gx, gu, gxx, guu, gux, um, reg)
    K_q, k_q, *_rest = jax.jit(lambda *a: backward_pass_scan(*a))(
        fx, fu, gx, gu, gxx, guu, gux, um, reg
    )

    assert bool(ok_s) and bool(ok_a)
    # vs unsharded associative: same elements/operator, order differs only
    # by associativity
    np.testing.assert_allclose(np.asarray(K_s), np.asarray(K_a),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(k_s), np.asarray(k_a),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(p_s), np.asarray(p_a),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(Qu_s), np.asarray(Qu_a),
                               rtol=1e-9, atol=1e-9)
    # vs the sequential Riccati recursion (different algorithm)
    np.testing.assert_allclose(np.asarray(K_s), np.asarray(K_q),
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(np.asarray(k_s), np.asarray(k_q),
                               rtol=1e-6, atol=1e-8)


def test_horizon_sharded_placement_stays_sharded():
    """With time-sharded inputs the big stacks must come back time-sharded
    (the memory-capacity story: no device ever holds the full horizon)."""
    devices = jax.devices()
    mesh = Mesh(np.asarray(devices), ("time",))
    # T=33: the [T-1]=32 stage stacks split evenly over 8 devices; the [T]
    # cost stacks stay on default placement (their per-t use is elementwise)
    spec, (fx, fu, gx, gu, gxx, guu, gux, um) = _stacks(car, 33, 0.01)
    sh = time_sharding(mesh, "time")
    fx, fu, gu, guu, gux = (
        jax.device_put(a, sh) for a in (fx, fu, gu, guu, gux)
    )
    backward = make_horizon_sharded_backward(mesh, "time")
    K, k, Qx, Qu, p, ok = jax.jit(backward)(
        fx, fu, gx, gu, gxx, guu, gux, um, jnp.zeros(())
    )
    assert bool(ok)
    # K is [T-1, nu, nx]: the time axis must remain distributed
    assert len(K.sharding.device_set) == len(devices)


def test_long_horizon_solve_fn_end_to_end():
    """Public API: a T=513 constrained solve with the backward pass's time
    axis sharded over the 8-device mesh (parallel.make_long_horizon_solve_fn) must run end-to-end and reproduce the
    unsharded solver's iterates."""
    from iterativelqr_tpu import Options
    from iterativelqr_tpu.core.solve import make_solve_fn
    from iterativelqr_tpu.models import pendulum
    from iterativelqr_tpu.parallel import (
        make_long_horizon_solve_fn,
        time_sharding,
    )

    T = 513
    dynamics, objective, constraints, x1, xT = pendulum.problem(T)
    spec = build_spec(dynamics, objective, constraints)
    mesh = Mesh(np.asarray(jax.devices()), ("time",))
    # tiny iteration budget: this pins route/semantics, not convergence
    opts = Options(verbose=False, record_traces=False, max_iterations=4,
                   max_dual_updates=2, scan_unroll=1)
    solve_sh = jax.jit(make_long_horizon_solve_fn(spec, opts, mesh=mesh))
    solve_ref = jax.jit(make_solve_fn(spec, opts))

    xs = jnp.zeros((T, spec.nx)).at[0].set(x1)
    us = 0.01 * jnp.ones((T - 1, spec.nu))
    ws = jnp.zeros((T, max(spec.npar, 0)))
    sol = solve_sh(xs, us, ws)
    ref = solve_ref(xs, us, ws)
    np.testing.assert_allclose(
        np.asarray(sol.xs), np.asarray(ref.xs), rtol=1e-6, atol=1e-8
    )
    assert int(sol.iterations) == int(ref.iterations)
    assert np.isfinite(float(sol.objective))

    # [T-1, ...] control stack placed time-sharded (512 % 8 == 0): the
    # derivative stacks then stay distributed under jit's SPMD partitioner
    us_p = jax.device_put(us, time_sharding(mesh))
    sol_p = solve_sh(xs, us_p, ws)
    np.testing.assert_allclose(
        np.asarray(sol_p.xs), np.asarray(ref.xs), rtol=1e-6, atol=1e-8
    )

    # guard: the packed selector owns its own backward and must be rejected
    import pytest as _pytest

    with _pytest.raises(ValueError):
        make_long_horizon_solve_fn(
            spec, Options(backward_pass="packed"), mesh=mesh
        )
