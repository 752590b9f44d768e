# -*- coding: utf-8 -*-
"""george-tpu: Gaussian-process regression and inference on NVIDIA GPUs,
through JAX.

A from-scratch JAX/XLA framework with the capabilities of the
``gptune/george`` reference (see SURVEY.md): a YAML kernel DSL compiled to
vmapped JAX covariance functions, exact (batched Cholesky), hierarchical
(HODLR-class) and compact-support sparse solvers, autodiff and Hutchinson
marginal-likelihood gradients, posterior prediction and sampling, and
hyperparameter inference via NUTS/HMC, ensemble MCMC and VI with chains
sharded over device meshes.
"""

__version__ = "0.1.0"

from . import kernels  # noqa: F401
from . import metrics  # noqa: F401
from . import modeling  # noqa: F401
from . import solvers  # noqa: F401
from . import sampling  # noqa: F401
from . import diagnostics  # noqa: F401
from . import checkpoint  # noqa: F401
from .gp import GP, TINY  # noqa: F401
from .metrics import Metric, Subspace  # noqa: F401
from .solvers import (  # noqa: F401
    BasicSolver,
    TrivialSolver,
    HODLRSolver,
    HMatrixSolver,
    SparseSolver,
)

__all__ = [
    "__version__",
    "GP",
    "TINY",
    "Metric",
    "Subspace",
    "BasicSolver",
    "TrivialSolver",
    "HODLRSolver",
    "HMatrixSolver",
    "SparseSolver",
    "kernels",
    "metrics",
    "modeling",
    "solvers",
    "sampling",
]
