"""User-facing Solver: a thin stateful shell over the pure solve function.

API parity with the reference (reference: src/solver.jl): construct from
per-timestep Dynamics/Cost/Constraint lists, warm-start with
``initialize_states`` / ``initialize_controls`` (src/solver.jl:56-66), call
``solve()``, read back ``get_trajectory()`` (nominal trajectory,
src/solver.jl:48-50).  All computation happens inside one jitted program; the
shell only stores the nominal trajectory between solves (which makes MPC
warm-starting and checkpointing the same operation: the solver state is an
explicit pytree).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.printing import print_solution, solver_info
from .options import Options
from .solve import CallbackState, Solution, make_solve_fn
from .spec import Constraint, Cost, Dynamics, ProblemSpec, build_spec


class Solver:
    def __init__(
        self,
        dynamics: Sequence[Dynamics],
        objective: Sequence[Cost],
        constraints: Optional[Sequence[Constraint]] = None,
        parameters: Optional[Sequence] = None,
        options: Options = Options(),
        callback: Optional[Callable[[CallbackState], CallbackState]] = None,
        dtype=jnp.float64,
    ):
        self.spec: ProblemSpec = build_spec(dynamics, objective, constraints)
        self.options = options
        # default dtype follows x64 availability (float32 without it)
        if dtype == jnp.float64 and not jax.config.jax_enable_x64:
            dtype = jnp.float32
        self.dtype = dtype
        T, nx, nu, npar = self.spec.T, self.spec.nx, self.spec.nu, self.spec.npar

        # nominal trajectory + parameter trajectory (padded)
        self._xs = jnp.zeros((T, nx), dtype)
        self._us = jnp.zeros((T - 1, nu), dtype)
        self._ws = jnp.zeros((T, npar), dtype)
        if parameters is not None:
            for t, w in enumerate(parameters):
                w = jnp.asarray(w, dtype).reshape(-1)
                if w.shape[0]:
                    self._ws = self._ws.at[t, : w.shape[0]].set(w)

        self._solve_fn = jax.jit(make_solve_fn(self.spec, options, callback))
        self._callback = callback
        # built lazily on first warm solve (a second traced program; users who
        # never warm-solve should not pay its trace time)
        self._warm_solve_fn = None
        self._duals = None
        self._penalty = None
        self.solution: Optional[Solution] = None

    # -- warm start (reference: src/solver.jl:56-66) --------------------------

    def initialize_states(self, states):
        """Seed nominal states from a [T, n] array or a list of per-t vectors.

        The nominal should be *dynamically consistent* with the seeded
        controls (produce it with ``rollout``, as the reference examples do,
        README.md:64): an inconsistent nominal has a meaningless objective
        value and can make the first Armijo test reject every step.
        """
        for t, x in enumerate(states):
            x = jnp.asarray(x, self.dtype).reshape(-1)
            self._xs = self._xs.at[t, : x.shape[0]].set(x)
        return self

    def initialize_controls(self, actions):
        for t, u in enumerate(actions):
            u = jnp.asarray(u, self.dtype).reshape(-1)
            if u.shape[0]:
                self._us = self._us.at[t, : u.shape[0]].set(u)
        return self

    # -- solve ----------------------------------------------------------------

    def solve(
        self, verbose: Optional[bool] = None, warm_start: bool = False
    ) -> Solution:
        """Solve from the current nominal trajectory.

        ``warm_start=True`` additionally carries the duals and penalties
        retained from the previous solve (reference: repeated ``solve!``
        reuses ``problem.objective.duals``/``penalties`` until
        ``reset_duals!``/``reset_penalties!``, src/solve.jl:95-103).  The
        nominal trajectory is always promoted between solves; duals are only
        reused when asked, because stale duals for a *changed* problem
        (new parameters, different target) can mislead the first AL rounds.
        """
        verbose = self.options.verbose if verbose is None else verbose
        if verbose:
            solver_info()
        if warm_start and self._duals is not None:
            if self._warm_solve_fn is None:
                self._warm_solve_fn = jax.jit(
                    make_solve_fn(
                        self.spec, self.options, self._callback,
                        dual_warm_start=True,
                    )
                )
            sol = self._warm_solve_fn(
                self._xs, self._us, self._ws, self._duals, self._penalty
            )
        else:
            sol = self._solve_fn(self._xs, self._us, self._ws)
        self.solution = sol
        # promote the solved nominal + AL state for subsequent warm solves
        self._xs, self._us = sol.xs, sol.us
        self._duals, self._penalty = sol.duals, sol.penalty
        if verbose:
            print_solution(sol)
        return sol

    def warm_solve(self, verbose: Optional[bool] = None) -> Solution:
        """``solve(warm_start=True)``: re-solve carrying duals/penalties from
        the previous solution (falls back to a cold solve if none exists)."""
        return self.solve(verbose=verbose, warm_start=True)

    def reset_duals(self):
        """Drop retained duals/penalties so the next solve cold-starts the AL
        state (reference: src/solve.jl reset between unrelated problems)."""
        self._duals = None
        self._penalty = None
        return self

    # -- accessors ------------------------------------------------------------

    def get_trajectory(self):
        """Nominal trajectory as per-timestep lists trimmed to true dims
        (reference: src/solver.jl:48-50 returns the nominal vectors)."""
        if self.solution is None:
            xs, us = self._xs, self._us
        else:
            xs, us = self.solution.xs, self.solution.us
        xs = np.asarray(xs)
        us = np.asarray(us)
        x_list = [xs[t, : int(self.spec.x_dims[t])] for t in range(self.spec.T)]
        u_list = [us[t, : int(self.spec.u_dims[t])] for t in range(self.spec.T - 1)]
        return x_list, u_list

    def current_trajectory(self):
        """Parity alias (reference: src/solver.jl:52-54).  The functional core
        promotes accepted candidates to nominal inside the jitted solve, so
        post-solve the "current" and nominal trajectories coincide."""
        return self.get_trajectory()

    @property
    def parameters(self):
        return self._ws

    @parameters.setter
    def parameters(self, ws):
        self._ws = jnp.asarray(ws, self.dtype)
