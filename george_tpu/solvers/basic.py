# -*- coding: utf-8 -*-
"""Exact dense solver: fused XLA Cholesky (reference ``basic.py:18-317``).

The reference's dense path assembles K with an O(n^2) C++ loop and factors
with LAPACK; here assembly is a fused vmapped JAX computation and the
factorization is XLA's blocked Cholesky, all inside one jitted function. The
reference's two out-of-tree MPI backends (SuperLU_DIST sparse-direct and
ButterflyPACK compression, ``basic.py:80-258``) are covered in-tree by
:class:`george_tpu.solvers.SparseSolver` (compact support + CG/SLQ) and
:class:`george_tpu.solvers.HODLRSolver` (hierarchical compression).
"""

import numpy as np

import jax
import jax.numpy as jnp

from .linalg import (as_points, assemble_dense, cholesky_factor,
                     chol_solve)
from ..utils import full_precision_matmuls

__all__ = ["BasicSolver"]


class BasicSolver(object):
    """Dense exact solver with a Cholesky factorization of ``K + diag``."""

    def __init__(self, kernel, verbose=False, **kwargs):
        self.kernel = kernel
        self.verbose = bool(verbose)
        self.computed = False
        self.log_determinant = None
        self._L = None
        self._x = None
        self._yerr2 = None
        # Build the fused assemble+factor once per solver; shapes re-jit
        # automatically.
        pair = kernel.pair_fn

        def _factor(theta, x, yerr2):
            K = assemble_dense(pair, theta, x, x)
            L = cholesky_factor(K, yerr2)
            logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
            return L, logdet

        self._factor_fn = jax.jit(_factor)
        self._solve_fn = jax.jit(chol_solve)

    def compute(self, x, yerr=0.0, nns=None, **kwargs):
        """Assemble and factorize ``K(x, x) + diag(yerr^2)``."""
        x = as_points(x)
        yerr2 = np.atleast_1d(np.asarray(yerr, dtype=np.float64)) ** 2
        if yerr2.size == 1:
            yerr2 = yerr2 * np.ones(len(x))
        self._x = jnp.asarray(x)
        self._yerr2 = jnp.asarray(yerr2)
        theta = jnp.asarray(self.kernel.parameter_vector)
        from ..diagnostics import timer

        with timer("basic.compute", verbose=self.verbose) as tm:
            L, logdet = tm.sync(
                self._factor_fn(theta, self._x, jnp.asarray(yerr2))
            )
        if not bool(jnp.all(jnp.isfinite(jnp.diagonal(L)))):
            raise np.linalg.LinAlgError(
                "covariance matrix is not positive definite"
            )
        self._L = L
        self.log_determinant = float(logdet)
        self.computed = True

    def apply_inverse(self, y, in_place=False):
        """``(K + diag)^{-1} y`` for a vector or matrix of RHS."""
        y = np.asarray(y, dtype=np.float64)
        return np.asarray(self._solve_fn(self._L, jnp.asarray(y)))

    @full_precision_matmuls
    def dot_solve(self, y):
        """``y^T (K + diag)^{-1} y``."""
        y = jnp.asarray(np.asarray(y, dtype=np.float64))
        z = self._solve_fn(self._L, y)
        return float(jnp.dot(y, z))

    @full_precision_matmuls
    def apply_sqrt(self, r):
        """``r @ L^T`` — sampling transport for the prior (reference
        ``basic.py:284-302``)."""
        return np.asarray(
            jnp.dot(jnp.asarray(np.asarray(r, dtype=np.float64)), self._L.T)
        )

    @full_precision_matmuls
    def apply_forward(self, y, i=0):
        """Matvec with the factorized matrix ``K + diag`` (``i == 0``) or
        with ``dK/dtheta_{i-1}`` (reference ``basic.py:214-229``)."""
        y = jnp.asarray(np.asarray(y, dtype=np.float64))
        theta = jnp.asarray(self.kernel.parameter_vector)
        pair = self.kernel.pair_fn
        if i == 0:
            K = assemble_dense(pair, theta, self._x, self._x)
            K = K + jnp.diag(self._yerr2)
        else:
            k = i - 1

            def entry_sum(th):
                return assemble_dense(pair, th, self._x, self._x)

            K = jax.jacfwd(entry_sum)(theta)[..., k]
        return np.asarray(K @ y)

    def get_inverse(self):
        n = self._L.shape[0]
        return np.asarray(self._solve_fn(self._L, jnp.eye(n)))

    def get_full(self, i=0):
        """The full factorized matrix ``K + diag`` (``i == 0``) or the dense
        ``dK/dtheta_{i-1}`` (reference ``basic.py:312``)."""
        theta = jnp.asarray(self.kernel.parameter_vector)
        if i == 0:
            K = assemble_dense(self.kernel.pair_fn, theta, self._x, self._x)
            return np.array(K + jnp.diag(self._yerr2))
        return np.array(self.kernel.get_gradient(
            np.asarray(self._x), include_frozen=True
        )[:, :, i - 1])

    # Pickling: keep the factor (dense factors are plain arrays), drop the
    # compiled closures (they rebuild lazily).
    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_factor_fn", None)
        state.pop("_solve_fn", None)
        state["_L"] = None if self._L is None else np.asarray(self._L)
        state["_x"] = None if self._x is None else np.asarray(self._x)
        if state.get("_yerr2") is not None:
            state["_yerr2"] = np.asarray(state["_yerr2"])
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        if state.get("_L") is not None:
            self._L = jnp.asarray(state["_L"])
        if state.get("_x") is not None:
            self._x = jnp.asarray(state["_x"])
        if state.get("_yerr2") is not None:
            self._yerr2 = jnp.asarray(state["_yerr2"])
        pair = self.kernel.pair_fn

        def _factor(theta, x, yerr2):
            K = assemble_dense(pair, theta, x, x)
            L = cholesky_factor(K, yerr2)
            logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
            return L, logdet

        self._factor_fn = jax.jit(_factor)
        self._solve_fn = jax.jit(chol_solve)
