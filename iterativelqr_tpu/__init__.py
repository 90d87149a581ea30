"""iterativelqr-tpu: a batched constrained iLQR / AL-iLQR engine.

Brand-new JAX/XLA/Pallas implementation covering the capability set of
thowell/IterativeLQR.jl (see SURVEY.md): user-defined dynamics/costs/
constraints as plain JAX functions, autodiff derivative stacks, time-varying
dimensions via padding+masks, mixed equality/inequality constraints through an
augmented-Lagrangian outer loop, Armijo line search, warm starting, and
batched/pod-sharded solves.

Public API mirrors the reference exports (reference: src/IterativeLQR.jl:30-45).
"""

from .core.options import Options
from .core.solve import CallbackState, Solution, make_solve_fn
from .core.solver import Solver
from .core.spec import Constraint, Cost, Dynamics, ProblemSpec, build_spec
from .ops.rollout import rollout
from .ops.sensitivity import parameter_gradient, solution_parameter_gradient

__all__ = [
    "Cost",
    "Constraint",
    "Dynamics",
    "Options",
    "Solver",
    "Solution",
    "CallbackState",
    "ProblemSpec",
    "build_spec",
    "make_solve_fn",
    "rollout",
    "parameter_gradient",
    "solution_parameter_gradient",
]

__version__ = "0.1.0"
