"""Packed derive -> backward pipeline vs the per-instance scan path.

The batched custom-vmap rule (SL-layout derive + the Pallas-Triton kernel)
runs the kernel in interpret mode on CPU; its outputs must match vmapping
the per-instance path.  Also pins the end-to-end solve with
backward_pass="packed" (unbatched, it takes the per-instance scan path —
semantics must be unchanged).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from iterativelqr_tpu import Options
from iterativelqr_tpu.core.solve import make_solve_fn
from iterativelqr_tpu.core.spec import build_spec
from iterativelqr_tpu.models import acrobot, car
from iterativelqr_tpu.ops.packed_pipeline import make_derive_backward
from iterativelqr_tpu.ops.rollout import open_loop_rollout


def _problem_batch(mod, T, B, u0, dtype=jnp.float32):
    dynamics, objective, constraints, x1, xT = mod.problem(T)
    spec = build_spec(dynamics, objective, constraints)
    key = jax.random.PRNGKey(0)
    x0 = jnp.zeros((B, spec.nx), dtype).at[:, : x1.shape[0]].set(
        x1.astype(dtype) + 0.03 * jax.random.normal(key, (B, x1.shape[0]), dtype)
    )
    us = jnp.full((B, T - 1, spec.nu), u0, dtype)
    ws = jnp.zeros((B, T, max(spec.npar, 0)), dtype)
    xs = jax.vmap(lambda x, u, w: open_loop_rollout(spec, x, u, w))(x0, us, ws)
    duals = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (B, T, spec.nc), dtype)
    duals = jnp.where(jnp.asarray(spec.ineq_mask)[None], jnp.maximum(duals, 0.0), duals)
    penalty = jnp.full((B, T, spec.nc), 10.0, dtype)
    c = jax.vmap(
        lambda xs_, us_, ws_: __import__(
            "iterativelqr_tpu.ops.derivatives", fromlist=["x"]
        ).constraint_values(spec, xs_, us_, ws_)
    )(xs, us, ws)
    reg = jnp.zeros((B,), dtype)
    return spec, xs, us, ws, duals, penalty, c, reg


@pytest.mark.parametrize("mod,T,u0", [(acrobot, 9, 0.05), (car, 8, 0.01)])
def test_packed_pipeline_matches_per_instance(mod, T, u0):
    B = 4
    spec, xs, us, ws, duals, penalty, c, reg = _problem_batch(mod, T, B, u0)
    opts = Options(verbose=False)
    ref_fn = make_derive_backward(spec, opts, interpret=False)
    packed_fn = make_derive_backward(spec, opts, interpret=True)

    ref = jax.vmap(ref_fn)(xs, us, ws, duals, penalty, c, reg)
    out = jax.vmap(packed_fn)(xs, us, ws, duals, penalty, c, reg)
    names = ["K", "k", "slope", "grad_norm", "reg_next"]
    for name, a, b in zip(names, ref, out):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=5e-4, atol=5e-4, err_msg=name
        )


def test_solve_with_packed_option_matches_scan_solve():
    """backward_pass='packed' must not change solve semantics (unbatched it
    takes the per-instance path; this pins the wiring)."""
    T = 11
    from iterativelqr_tpu.models import particle

    dynamics, objective, constraints, x1, xT = particle.problem(T)
    spec = build_spec(dynamics, objective, constraints)
    xs = jnp.zeros((T, spec.nx), jnp.float64).at[0, : x1.shape[0]].set(x1)
    us = jnp.zeros((T - 1, spec.nu), jnp.float64)
    ws = jnp.zeros((T, 0), jnp.float64)
    a = jax.jit(make_solve_fn(spec, Options(backward_pass="scan")))(xs, us, ws)
    b = jax.jit(make_solve_fn(spec, Options(backward_pass="packed")))(xs, us, ws)
    np.testing.assert_allclose(np.asarray(a.xs), np.asarray(b.xs), atol=1e-12)
    assert int(a.iterations) == int(b.iterations)
