# -*- coding: utf-8 -*-
"""Distance metrics for stationary kernels.

Re-implements the reference's metric layer (``src/george/metrics.py:13-141``
and ``include/george/metrics.h:17-253``) as (a) a host-side parameter-management
class following the modeling protocol and (b) pure JAX functions used by the
compiled kernel closures.

Three metric types share one parameterization convention with the reference:

* ``metric_type == 0`` (isotropic): one parameter, the log of the squared
  length scale;  ``r2 = ||dx||^2 * exp(-theta)``.
* ``metric_type == 1`` (axis-aligned): one log-scale per selected axis;
  ``r2 = sum_j dx_j^2 * exp(-theta_j)``.
* ``metric_type == 2`` (general): a full SPD matrix ``M = L L^T`` through its
  log-Cholesky parameterization — packed row-major lower triangle, diagonal
  entries stored in log space;  ``r2 = || L^{-1} dx ||^2``.
"""

import numpy as np

import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from .modeling import Model

__all__ = ["Metric", "Subspace"]


class Subspace(object):
    """A selection of input axes a kernel operates on (reference
    ``subspace.h:10-27``)."""

    def __init__(self, ndim, axes=None):
        self.ndim = int(ndim)
        if axes is None:
            axes = np.arange(self.ndim)
        self.axes = np.atleast_1d(axes).astype(int)
        if np.any(self.axes >= self.ndim):
            raise ValueError(
                "invalid axis for {0} dimensional metric".format(self.ndim)
            )


class Metric(Model):
    """Squared-distance metric with named (log-space) parameters.

    Accepts a scalar (isotropic), a 1-D array (axis-aligned) or a 2-D SPD
    matrix (general); matches the reference's ``Metric`` constructor
    (``metrics.py:25-108``).
    """

    def __init__(self, metric, bounds=None, ndim=None, axes=None, lower=True):
        if isinstance(metric, Metric):
            self.metric_type = metric.metric_type
            self.parameter_names = metric.parameter_names
            self.ndim = metric.ndim
            self.axes = metric.axes
            super(Metric, self).__init__(
                *metric.get_parameter_vector(include_frozen=True),
                bounds=metric.parameter_bounds
            )
            self.unfrozen_mask[:] = metric.unfrozen_mask
            return

        if ndim is None:
            raise ValueError("missing required parameter 'ndim'")

        subspace = Subspace(ndim, axes=axes)
        self.ndim = subspace.ndim
        self.axes = subspace.axes

        parameter_names = []
        parameters = []

        try:
            scalar = float(metric)
        except TypeError:
            metric = np.atleast_1d(metric)
            if metric.ndim == 1:
                # Axis-aligned: one squared length scale per axis.
                self.metric_type = 1
                if len(metric) != len(self.axes):
                    raise ValueError("dimension mismatch")
                if np.any(metric <= 0.0):
                    raise ValueError("invalid (negative) metric")
                for i, v in enumerate(metric):
                    parameter_names.append("log_M_{0}_{0}".format(i))
                    parameters.append(np.log(v))
            elif metric.ndim == 2:
                # General SPD matrix via log-Cholesky.
                self.metric_type = 2
                if metric.shape[0] != metric.shape[1]:
                    raise ValueError("metric must be square")
                if len(metric) != len(self.axes):
                    raise ValueError("dimension mismatch")
                L = np.linalg.cholesky(np.asarray(metric, dtype=np.float64))
                n = len(self.axes)
                for i in range(n):
                    parameter_names.append("log_L_{0}_{0}".format(i))
                    parameters.append(np.log(L[i, i]))
                    for j in range(i + 1, n):
                        parameter_names.append("L_{0}_{1}".format(i, j))
                        parameters.append(L[j, i])
            else:
                raise ValueError("invalid metric dimensions")
        else:
            self.metric_type = 0
            if scalar <= 0.0:
                raise ValueError("invalid (negative) metric")
            parameter_names.append("log_M_0_0")
            parameters.append(np.log(scalar))

        self.parameter_names = tuple(parameter_names)
        kwargs = {}
        if bounds is not None:
            kwargs["bounds"] = bounds
        super(Metric, self).__init__(*parameters, **kwargs)

    @property
    def full_size(self):
        return len(self.parameter_names)

    def to_matrix(self):
        """The metric as a dense SPD matrix over the selected axes."""
        vector = self.get_parameter_vector(include_frozen=True)
        n = len(self.axes)
        if self.metric_type == 0:
            return np.exp(vector[0]) * np.eye(n)
        if self.metric_type == 1:
            return np.diag(np.exp(vector))
        L = unpack_cholesky(vector, n)
        return np.asarray(L @ L.T)

    def __repr__(self):
        vector = self.get_parameter_vector(include_frozen=True)
        if self.metric_type == 0:
            params = ["{0}".format(float(np.exp(vector[0])))]
        elif self.metric_type == 1:
            params = ["{0}".format(repr(np.exp(vector)))]
        else:
            params = ["{0}".format(repr(self.to_matrix().tolist()))]
        params += [
            "ndim={0}".format(self.ndim),
            "axes={0}".format(repr(self.axes)),
        ]
        return "Metric({0})".format(", ".join(params))


# ---------------------------------------------------------------------------
# Functional (JAX) side
# ---------------------------------------------------------------------------

def metric_param_count(metric_type, naxes):
    """Number of parameters for a metric of the given type over ``naxes``."""
    if metric_type == 0:
        return 1
    if metric_type == 1:
        return naxes
    if metric_type == 2:
        return naxes * (naxes + 1) // 2
    raise ValueError("unknown metric_type {0}".format(metric_type))


def unpack_cholesky(theta, n):
    """Packed log-Cholesky parameters -> lower-triangular matrix L.

    Packing matches the reference (row-major lower triangle per *row of L^T's
    columns*, i.e. parameter order ``log_L_00, L_01, ..., L_0n, log_L_11,
    ...``): entry ``L_{i}_{j}`` with ``i < j`` sits at row j, column i of L.
    Diagonal entries are stored in log space.
    """
    theta = jnp.asarray(theta)
    L = jnp.zeros((n, n), dtype=theta.dtype)
    k = 0
    for i in range(n):
        L = L.at[i, i].set(jnp.exp(theta[k]))
        k += 1
        for j in range(i + 1, n):
            L = L.at[j, i].set(theta[k])
            k += 1
    return L


def metric_r2_fn(metric_type, axes, ndim):
    """Build ``r2(theta, x1, x2)`` for the given metric structure.

    ``x1``/``x2`` are single points of shape ``(ndim,)``; ``theta`` is the
    metric parameter vector. Returns the squared metric distance.
    """
    axes = tuple(int(a) for a in axes)
    naxes = len(axes)

    # Static per-axis indexing (not a gathered index array): XLA emits
    # plain slices, and the pair function stays free of captured constant
    # arrays (which would become constants of every solver program).
    def _diff(x1, x2):
        if axes == tuple(range(x1.shape[0])):
            return x1 - x2
        return jnp.stack([x1[a] - x2[a] for a in axes])

    if metric_type == 0:

        def r2(theta, x1, x2):
            d = _diff(x1, x2)
            return jnp.sum(d * d) * jnp.exp(-theta[0])

    elif metric_type == 1:

        def r2(theta, x1, x2):
            d = _diff(x1, x2)
            return jnp.sum(d * d * jnp.exp(-theta))

    elif metric_type == 2:

        def r2(theta, x1, x2):
            d = _diff(x1, x2)
            L = unpack_cholesky(theta, naxes)
            z = solve_triangular(L, d, lower=True)
            return jnp.sum(z * z)

    else:
        raise ValueError("unknown metric_type {0}".format(metric_type))

    return r2
