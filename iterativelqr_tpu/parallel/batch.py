"""Batch parallelism: solve B independent problem instances in one program.

The "data parallel" axis of this framework (SURVEY.md section 2.2): the
reference solves one problem per process with no parallelism of any kind; here
the full constrained solve is batched over initial trajectories and parameter
vectors, so thousands of instances (different initial conditions, goals,
obstacle layouts, model parameters) ride the accelerator together.

Per-instance convergence is automatic: ``lax.while_loop`` under ``vmap``
lowers to a masked loop, so converged instances stop changing while the rest
iterate (SURVEY.md section 7 "scalar convergence breaks" row).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.options import Options
from ..core.solve import Solution, make_solve_fn
from ..core.spec import ProblemSpec


# Platforms on which batched_solver="auto" picks the SL solver when the
# options allow it (measured end to end on an H100: PERF.md).
SL_PLATFORMS = ("gpu",)


def _sl_eligible(options: Options, callback) -> bool:
    """Options the SL-layout batched solver (core/solve_sl.py) supports.

    ``backward_pass="auto"`` (the default) qualifies, so a plain
    ``Options(record_traces=False)`` reaches it without hand-set knobs."""
    return (
        options.backward_pass in ("packed", "auto")
        and options.fused_al_loop
        and not options.record_traces
        and not options.live_progress
        and not options.ddp  # DDP needs the scan recursion (core/options.py)
        and callback is None
        and options.line_search in ("armijo", "none")
    )


def use_sl_solver(options: Options, callback=None, platform=None) -> bool:
    """Whether batched solves run the SL solver: ``batched_solver="sl"``
    always, ``"vmap"`` never, ``"auto"`` on ``SL_PLATFORMS`` when the
    options are eligible.  ``platform`` defaults to JAX's default backend."""
    if options.batched_solver != "auto":
        return options.batched_solver == "sl"
    if platform is None:
        platform = jax.default_backend()
    return platform in SL_PLATFORMS and _sl_eligible(options, callback)


def make_batched_solve_fn(
    spec: ProblemSpec,
    options: Options = Options(),
    callback: Optional[Callable] = None,
    in_axes=(0, 0, 0),
    dual_warm_start: bool = False,
):
    """Build ``(xs_init [B,T,nx], us_init [B,T-1,nu], ws [B,T,npar]) -> Solution``
    with a leading batch axis on every Solution leaf.

    ``in_axes`` follows vmap semantics over (xs_init, us_init, ws); pass None
    for an argument shared across the batch (e.g. one parameter trajectory for
    all initial conditions).

    ``dual_warm_start`` adds two batch-leading arguments
    ``(duals0 [B,T,nc], penalty0 [B,T,nc])`` — carried multipliers/penalties
    for warm re-solves (batched MPC farms), mirroring
    ``make_solve_fn(dual_warm_start=True)``.

    Implementation is selected by ``use_sl_solver``: the SL-layout solver
    (core/solve_sl.py — the whole loop in ``[T,*dims,S,128]``) or
    ``jax.vmap`` of the per-instance solve.
    """
    use_sl = use_sl_solver(options, callback)
    eff_in_axes = tuple(in_axes) + ((0, 0) if dual_warm_start else ())
    if use_sl:
        from ..core.solve_sl import make_batched_solve_sl

        solve_sl = make_batched_solve_sl(
            spec, options, dual_warm_start=dual_warm_start,
        )

        def solve_batch(*args) -> Solution:
            args = list(args)
            # honor vmap-style in_axes: broadcast unbatched (None) arguments
            B = None
            for a, ax in zip(args, eff_in_axes):
                if ax is not None:
                    B = a.shape[0]
            for i, ax in enumerate(eff_in_axes):
                if ax is None:
                    args[i] = jnp.broadcast_to(
                        args[i][None], (B,) + args[i].shape
                    )
            return solve_sl(*args)

        return solve_batch

    solve = make_solve_fn(spec, options, callback,
                          dual_warm_start=dual_warm_start)
    return jax.vmap(solve, in_axes=eff_in_axes)


class BatchStats(NamedTuple):
    """Aggregate convergence statistics of a batched Solution.

    The batched replacement for the reference's scalar convergence locals
    (reference: src/data/constraints.jl:28-38, src/solve.jl:40-45): under a
    sharded mesh the reductions here lower to XLA collectives (psum).
    """

    solved_fraction: jax.Array
    mean_iterations: jax.Array
    max_violation: jax.Array
    mean_violation: jax.Array
    mean_objective: jax.Array
    line_search_failures: jax.Array


def batch_stats(sol: Solution, constraint_tolerance=None) -> BatchStats:
    """Defaults to the tolerance the solve actually ran with
    (``sol.tol_constraint``); pass a value only to re-bucket at a different
    threshold."""
    if constraint_tolerance is None:
        constraint_tolerance = sol.tol_constraint
    solved = sol.max_violation <= constraint_tolerance
    return BatchStats(
        solved_fraction=jnp.mean(solved.astype(jnp.float32)),
        mean_iterations=jnp.mean(sol.iterations.astype(jnp.float32)),
        max_violation=jnp.max(sol.max_violation),
        mean_violation=jnp.mean(sol.max_violation),
        mean_objective=jnp.mean(sol.objective),
        line_search_failures=jnp.sum((~sol.status).astype(jnp.int32)),
    )
