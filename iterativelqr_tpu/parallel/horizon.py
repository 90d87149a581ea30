"""Horizon-axis (time) sharding for very long trajectories.

SURVEY.md section 5 "long-context" row: within one chip the O(log T)
associative-scan Riccati (ops/assoc.py) covers long horizons; for horizons
whose derivative stacks outgrow one device's HBM — or when a single long
instance should use many chips — the TIME axis itself is sharded over a mesh
axis.  (Reference analog: none — src/backward_pass.jl:42-90 is a strict
sequential loop on one core; this is the multi-device extension of its
recursion.)

Design (the standard distributed-prefix decomposition):

1.  Each device builds its chunk's value-function elements locally
    (embarrassingly parallel) and runs the LOCAL reverse associative scan —
    ``res[t] = e_t (x) ... (x) e_last_local``.
2.  One tiny ``all_gather`` exchanges the n per-chunk composites (a few
    nx*nx matrices each; bytes, not megabytes, on the interconnect).
3.  Every device unrolls the n-element suffix composition of the LATER
    chunks and extends each local result — ``final[t] = res[t] (x) S_d``.
    The boundary value function a chunk needs for its last gain expansion is
    exactly ``S_d`` (the composite of everything after the chunk), so no
    extra halo exchange is required.
4.  Gains come from the usual batched Q-expansion (ops/assoc.py::_gains),
    elementwise over the sharded time axis.

Communication per backward pass: ONE all_gather of n composites — the
sequential wavefront a naive pipelined Riccati would serialize over devices
never materializes.  Depth: O(T/n + log(T/n) + n).

The time axis is padded to a multiple of the mesh axis with the combine
operator's identity element (ops/assoc.py::identity_element), so any (T, n)
pair works.  Numerics are the associative path's (same elements, same
operator, same gain expansion; composition order differs only by
associativity) — validated against the unsharded scan and the sequential
backward in tests/test_horizon_shard.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.assoc import _combine, _gains, _make_element, identity_element


def make_horizon_sharded_backward(mesh: Mesh, axis_name: str = "time"):
    """Build a backward pass with the TIME axis sharded over ``axis_name``.

    Returns ``backward(fx, fu, gx, gu, gxx, guu, gux, u_mask, reg)`` with
    the same signature and returns as ``ops.backward.backward_pass_scan``:
    ``(K [T-1,nu,nx], k [T-1,nu], Qx, Qu, p [T-1,nx], ok)``.  Inputs may be
    placed with time-axis NamedSharding (``time_sharding`` below); the
    element construction and gain expansion then stay device-local under
    jit's SPMD partitioner, and the scan core runs under ``shard_map``.
    """
    n = int(mesh.shape[axis_name])

    def backward(fx, fu, gx, gu, gxx, guu, gux, u_mask, reg):
        dtype = gx.dtype
        Tm1, nx = fx.shape[0], fx.shape[1]
        T = Tm1 + 1
        um = u_mask.astype(dtype)

        stage_elems, ok_stage = jax.vmap(
            lambda *a: _make_element(*a, reg)
        )(fx, fu, gx[:-1], gu, gxx[:-1], guu, gux, um)
        zA = jnp.zeros((1, nx, nx), dtype)
        term = (zA, jnp.zeros((1, nx), dtype), zA, -gx[-1][None],
                gxx[-1][None])
        elems = jax.tree.map(
            lambda s, t: jnp.concatenate([s, t], axis=0), stage_elems, term
        )
        # pad the time axis to a multiple of the mesh axis with identity
        # elements (no-ops under composition; they sit after the terminal
        # element and are sliced away below)
        Tp = -(-T // n) * n
        if Tp != T:
            ident = identity_element(nx, dtype)
            pad = jax.tree.map(
                lambda i: jnp.broadcast_to(i, (Tp - T,) + i.shape), ident
            )
            elems = jax.tree.map(
                lambda e, q: jnp.concatenate([e, q], axis=0), elems, pad
            )

        def scan_core(elems_loc):
            # 1. local reverse suffix scan (operator arg order: see the
            # reverse=True note in ops/assoc.py)
            res = jax.lax.associative_scan(
                jax.vmap(lambda a, b: _combine(b, a)), elems_loc,
                reverse=True, axis=0,
            )
            comp = jax.tree.map(lambda r: r[0], res)  # chunk composite
            # 2. exchange the n chunk composites
            gathered = jax.tree.map(
                lambda c: jax.lax.all_gather(c, axis_name), comp
            )
            # 3. suffix composites of LATER chunks: suf[i] = c_{i+1} (x)
            # ... (x) c_{n-1}; n is static and small — unrolled
            ident = identity_element(nx, dtype)
            sufs = [ident]
            acc = ident
            for i in range(n - 1, 0, -1):
                c_i = jax.tree.map(lambda g: g[i], gathered)
                acc = _combine(c_i, acc)
                sufs.append(acc)
            suf_stack = jax.tree.map(
                lambda *xs: jnp.stack(xs[::-1]), *sufs
            )
            d = jax.lax.axis_index(axis_name)
            S_d = jax.tree.map(lambda s: s[d], suf_stack)
            # 4. extend local results past the chunk boundary
            final = jax.vmap(lambda *e: _combine(tuple(e), S_d))(*res)
            # value function at t+1 for each local t: shift within the
            # chunk; the last local position's successor is the next
            # chunk's final[0] = c_{d+1} (x) S_{d+1} = S_d itself
            nxt = jax.tree.map(
                lambda f, s: jnp.concatenate([f[1:], s[None]], axis=0),
                final, S_d,
            )
            _, _, _, eta_f, J_f = final
            _, _, _, eta_n, J_n = nxt
            return eta_f, J_f, eta_n, J_n

        eta_f, J_f, eta_n, J_n = jax.shard_map(
            scan_core, mesh=mesh,
            in_specs=(jax.tree.map(lambda _: P(axis_name), elems),),
            out_specs=P(axis_name),
        )(elems)

        p = -eta_f[:Tm1]          # value gradient at t (assoc.py contract)
        P1 = J_n[:Tm1]            # value Hessian at t+1
        p1 = -eta_n[:Tm1]
        K, k, Qx, Qu, ok_gain = jax.vmap(
            lambda *a: _gains(*a, reg)
        )(fx, fu, gx[:-1], gu, gxx[:-1], guu, gux, um, P1, p1)
        ok = (
            jnp.all(ok_stage) & jnp.all(ok_gain)
            & jnp.all(jnp.isfinite(p)) & jnp.all(jnp.isfinite(p1))
        )
        return K, k, Qx, Qu, p, ok

    return backward


def time_sharding(mesh: Mesh, axis_name: str = "time") -> NamedSharding:
    """NamedSharding that places a [T, ...] stack's time axis over the mesh
    axis — put derivative stacks here so element construction and the gain
    expansion stay device-local around ``make_horizon_sharded_backward``."""
    return NamedSharding(mesh, P(axis_name))


def make_long_horizon_solve_fn(
    spec,
    options=None,
    *,
    mesh: Mesh,
    axis_name: str = "time",
    callback=None,
    dual_warm_start: bool = False,
):
    """Full single-instance constrained solve with the backward pass's TIME
    axis sharded over ``mesh[axis_name]`` — the public entry for horizons
    whose derivative stacks outgrow one device's HBM.

    Returns the same callable as ``core.solve.make_solve_fn`` (identical
    signature, Solution, and per-instance semantics — the sharded recursion
    composes the SAME Riccati elements with the same operator, validated in
    tests/test_horizon_shard.py); the Riccati recursion runs under
    ``shard_map`` with one all-gather of per-chunk composites per backward
    pass.  Derivative construction and the gain expansion are elementwise
    over time, so placing the initial trajectory with ``time_sharding``
    keeps the [T, nx*nx]-sized stacks distributed under jit's SPMD
    partitioner.

    Notes: ``backward_pass`` must not be "packed" (that selector is the
    batched SL pipeline; "auto"/"scan"/"associative" all route the
    override).  For best effect jit the result with the mesh's devices
    visible; batching via ``jax.vmap`` composes (the shard_map is over time,
    not batch).
    """
    from ..core.options import Options
    from ..core.solve import make_solve_fn

    options = options or Options()
    if options.backward_pass == "packed":
        raise ValueError(
            'make_long_horizon_solve_fn requires backward_pass != "packed" '
            "(the packed pipeline owns its own batched backward kernel)"
        )
    bp = make_horizon_sharded_backward(mesh, axis_name)
    return make_solve_fn(
        spec, options, callback,
        dual_warm_start=dual_warm_start, backward_impl=bp,
    )
