# -*- coding: utf-8 -*-
"""Kernel base classes and the functional (JAX) compile path.

This replaces the reference's three-layer kernel stack (Python classes in
``src/george/kernels.py``, pointwise C++ classes in ``include/george/kernels.h``
and the spec parser in ``include/george/parser.h``) with a single mechanism:
every kernel object compiles itself to a pure JAX *pair function*

    ``pair(theta, x1, x2) -> scalar``

where ``theta`` is the kernel's full parameter vector (frozen parameters
included) and ``x1``/``x2`` are single input points.  Covariance matrices are
``vmap``-ed outer products of the pair function; hyperparameter gradients are
``jax.jacfwd`` of it (replacing the reference's hand-derived C++ ``gradient``
methods); input gradients are ``jax.jacrev`` w.r.t. the points (replacing
``x1_gradient``/``x2_gradient``).

The stateful methods (``get_value``/``get_gradient``/...) mirror the reference
Python API (``kernels.py:31-245``) for drop-in compatibility and for the FD
test oracles.
"""

import numpy as np

import jax
import jax.numpy as jnp

from ..modeling import Model, ModelSet
from ..metrics import Metric, Subspace, metric_r2_fn

__all__ = [
    "Kernel",
    "Sum",
    "Product",
    "StationaryKernel",
    "NonStationaryKernel",
    "safe_sqrt",
    "M_PI",
]

M_PI = np.pi


def safe_sqrt(r2):
    """sqrt(r2) with a well-defined (zero) gradient at ``r2 == 0``.

    Plain ``jnp.sqrt`` has an infinite derivative at zero, which turns the
    diagonal entries of stationary-kernel gradients into NaN via ``inf * 0``.
    The double-``where`` trick gives the same values and the correct limits
    (matching the reference's explicit guards, e.g. ``Exp.yml`` grad).
    """
    positive = r2 > 0.0
    safe = jnp.where(positive, r2, 1.0)
    return jnp.where(positive, jnp.sqrt(safe), 0.0)


def _pairwise_matrix(pair_fn):
    """``K[i, j] = pair_fn(theta, X1[i], X2[j])`` via nested vmap."""

    def gram(theta, x1, x2):
        return jax.vmap(
            lambda a: jax.vmap(lambda b: pair_fn(theta, a, b))(x2)
        )(x1)

    return gram


class Kernel(ModelSet):
    """Abstract covariance kernel following the modeling protocol.

    Supports ``+`` and ``*`` composition (scalars are lifted to
    :class:`ConstantKernel`, reference ``kernels.py:87-104``).
    """

    is_kernel = True
    kernel_type = -1
    stationary = False
    sparse = False
    operator_type = -1
    _constant_names = ()
    _base_param_names = ()

    # ------------------------------------------------------------------
    # Algebra
    # ------------------------------------------------------------------

    def __add__(self, b):
        if not hasattr(b, "is_kernel"):
            from .generated import ConstantKernel

            return Sum(
                ConstantKernel(
                    log_constant=np.log(float(b) / self.ndim), ndim=self.ndim
                ),
                self,
            )
        return Sum(self, b)

    def __radd__(self, b):
        return self.__add__(b)

    def __mul__(self, b):
        if not hasattr(b, "is_kernel"):
            from .generated import ConstantKernel

            return Product(
                ConstantKernel(
                    log_constant=np.log(float(b) / self.ndim), ndim=self.ndim
                ),
                self,
            )
        return Product(self, b)

    def __rmul__(self, b):
        return self.__mul__(b)

    # numpy-scalar arithmetic support (reference ``kernels.py:44-54``)
    def __array_wrap__(self, array, context=None, return_scalar=False):
        if context is None:
            raise TypeError("Invalid operation")
        ufunc, args, _ = context
        if ufunc.__name__ == "multiply":
            return float(args[0]) * args[1]
        elif ufunc.__name__ == "add":
            return float(args[0]) + args[1]
        raise TypeError("Invalid operation")

    __array_priority__ = np.inf

    # ------------------------------------------------------------------
    # Attribute plumbing
    # ------------------------------------------------------------------

    def __getattr__(self, name):
        models = self.__dict__.get("models")
        if models is not None:
            if name in models:
                return models[name]
            if None in models:
                return getattr(models[None], name)
        raise AttributeError(name)

    def __getstate__(self):
        odict = self.__dict__.copy()
        odict.pop("_pair_fn", None)
        odict.pop("_fns", None)
        return odict

    def __setstate__(self, state):
        self.__dict__.update(state)

    # ------------------------------------------------------------------
    # Functional compile
    # ------------------------------------------------------------------

    @property
    def pair_fn(self):
        """The compiled pure pair function ``(theta, x1, x2) -> scalar``."""
        fn = self.__dict__.get("_pair_fn")
        if fn is None:
            fn = self._compile()
            self.__dict__["_pair_fn"] = fn
        return fn

    def _compile(self):
        raise NotImplementedError("kernel subclasses must implement _compile")

    @property
    def input_ndim(self):
        """Width of the input points consumed by :attr:`pair_fn`."""
        return self.ndim

    def get_cutoff(self):
        """Compact-support radius beyond which the kernel is exactly zero."""
        return np.inf

    # ------------------------------------------------------------------
    # Evaluation API (george-compatible)
    # ------------------------------------------------------------------

    def _eval(self, name):
        fns = self.__dict__.get("_fns")
        if fns is None:
            fns = {}
            self.__dict__["_fns"] = fns
        if name not in fns:
            pair = self.pair_fn
            if name == "gram":
                fns[name] = jax.jit(_pairwise_matrix(pair))
            elif name == "diag":
                fns[name] = jax.jit(jax.vmap(pair, in_axes=(None, 0, 0)))
            elif name == "pairs":
                fns[name] = jax.jit(jax.vmap(pair, in_axes=(None, 0, 0)))
            elif name == "grad":
                g = jax.jacfwd(pair, argnums=0)
                fns[name] = jax.jit(_pairwise_matrix(g))
            elif name == "x1grad":
                g = jax.jacrev(pair, argnums=1)
                fns[name] = jax.jit(_pairwise_matrix(g))
            elif name == "x2grad":
                g = jax.jacrev(pair, argnums=2)
                fns[name] = jax.jit(_pairwise_matrix(g))
            else:  # pragma: no cover
                raise KeyError(name)
        return fns[name]

    def parse_points(self, x):
        x = np.atleast_1d(np.asarray(x, dtype=np.float64))
        if x.ndim == 1:
            x = x[:, None]
        if x.shape[1] != self.input_ndim:
            raise ValueError("Dimension mismatch")
        return x

    @property
    def theta(self):
        """Full parameter vector as a JAX array."""
        return jnp.asarray(self.parameter_vector)

    def get_value(self, x1, x2=None, diag=False, nns=None):
        """Evaluate the covariance matrix (reference ``kernels.py:125-152``).

        With ``nns`` (any non-``None`` value), evaluates only entries within
        :func:`get_cutoff` of each other and returns a ``scipy.sparse``
        CSR matrix — the compact-support path (reference ``kernels.py:131-144``).
        """
        x1 = self.parse_points(x1)
        th = self.theta
        if x2 is None:
            if diag:
                return np.array(self._eval("diag")(th, x1, x1))
            if nns is not None:
                from ..neighbors import knn_matrix_to_csr, normalize_nns

                nns = normalize_nns(nns)
                if isinstance(nns, tuple):
                    pass  # (nbr_idx, row_ptr) CSR structure
                elif np.ndim(nns) == 2 and len(nns) == len(x1):
                    # rectangular kNN matrix (-1 = missing): use the
                    # symmetrized union pattern so the sparse covariance
                    # stays symmetric and keeps its diagonal
                    nns = knn_matrix_to_csr(nns, len(x1))
                else:
                    nns = None  # bare truthy trigger: recompute (ref behavior)
                return self._get_value_sparse(x1, nns)
            return np.array(self._eval("gram")(th, x1, x1))
        x2 = self.parse_points(x2)
        if diag:
            return np.array(self._eval("diag")(th, x1, x2))
        return np.array(self._eval("gram")(th, x1, x2))

    def _neighbor_csr(self, x):
        """CSR neighbor structure within the compact-support cutoff."""
        from ..neighbors import radius_neighbors_csr

        nbr_idx, row_ptr = radius_neighbors_csr(x, float(self.get_cutoff()))
        self.nns_saved = (nbr_idx, row_ptr)
        return nbr_idx, row_ptr

    def neighbors_to_csr(self, neighbors):
        """Flatten a ragged per-row neighbor listing (e.g. the output of
        ``BallTree.query_radius``) into ``(nbr_idx, row_ptr)`` CSR index
        arrays.  Mirrors the reference surface (``kernels.py:107-123``)."""
        from ..neighbors import ragged_to_csr

        return ragged_to_csr(neighbors)

    def _get_value_sparse(self, x, nns=None):
        """CSR covariance; ``nns`` may carry a precomputed
        ``(nbr_idx, row_ptr)`` structure (the fork's nns argument)."""
        from scipy.sparse import csr_matrix

        if nns is not None:
            nbr_idx, row_ptr = nns
            self.nns_saved = nns
        else:
            nbr_idx, row_ptr = self._neighbor_csr(x)
        counts = np.diff(row_ptr)
        rows = np.repeat(np.arange(len(x)), counts)
        vals = np.asarray(
            self._eval("pairs")(self.theta, x[rows], x[nbr_idx])
        )
        return csr_matrix((vals, nbr_idx, row_ptr), shape=(len(x), len(x)))

    def get_gradient(self, x1, x2=None, include_frozen=False, nns=None):
        """Hyperparameter gradient, shape ``(n1, n2, n_active)``."""
        mask = (
            np.ones(self.full_size, dtype=bool)
            if include_frozen
            else self.unfrozen_mask
        )
        x1 = self.parse_points(x1)
        th = self.theta
        if x2 is None:
            if nns is not None:
                return self._get_gradient_sparse(x1, mask)
            g = self._eval("grad")(th, x1, x1)
        else:
            x2 = self.parse_points(x2)
            g = self._eval("grad")(th, x1, x2)
        g = np.array(g)
        if g.ndim == 2:  # zero-parameter kernel
            g = g[:, :, None][:, :, :0]
        return g[:, :, mask]

    def _get_gradient_sparse(self, x, mask):
        from scipy.sparse import csr_matrix

        nns = getattr(self, "nns_saved", None)
        if nns is None:
            nns = self._neighbor_csr(x)
        nbr_idx, row_ptr = nns
        counts = np.diff(row_ptr)
        rows = np.repeat(np.arange(len(x)), counts)
        pair = self.pair_fn
        gfn = jax.jit(
            jax.vmap(jax.jacfwd(pair, argnums=0), in_axes=(None, 0, 0))
        )
        g = np.asarray(gfn(self.theta, x[rows], x[nbr_idx]))
        return [
            csr_matrix((g[:, i], nbr_idx, row_ptr), shape=(len(x), len(x)))
            for i in range(g.shape[1])
            if mask[i]
        ]

    def get_x1_gradient(self, x1, x2=None):
        x1 = self.parse_points(x1)
        x2 = x1 if x2 is None else self.parse_points(x2)
        return np.array(self._eval("x1grad")(self.theta, x1, x2))

    def get_x2_gradient(self, x1, x2=None):
        x1 = self.parse_points(x1)
        x2 = x1 if x2 is None else self.parse_points(x2)
        return np.array(self._eval("x2grad")(self.theta, x1, x2))

    # ------------------------------------------------------------------
    # Finite-difference self-tests.  The reference ships equivalent
    # checkers (``kernels.py:190-245``); here they are all thin wrappers
    # over one generic central-difference probe.
    # ------------------------------------------------------------------

    def _fd_probe(self, value_fn, read, write, coord, eps):
        """Central difference of ``value_fn()`` as one coordinate of a
        mutable state vector is nudged: ``read()`` returns the state,
        ``write(state)`` installs it, ``coord`` indexes into it."""
        state = read()
        pinned = state[coord]
        samples = {}
        for signed in (eps, -eps):
            state[coord] = pinned + signed
            write(state)
            samples[signed] = value_fn()
        state[coord] = pinned
        write(state)
        return (samples[eps] - samples[-eps]) / (2.0 * eps)

    def test_gradient(self, x1, x2=None, eps=1.32e-6, **kwargs):
        names = self.get_parameter_names()
        analytic = self.get_gradient(x1, x2=x2)
        value_fn = lambda: self.get_value(x1, x2=x2)
        for i in range(len(names)):
            fd = self._fd_probe(
                value_fn,
                self.get_parameter_vector, self.set_parameter_vector,
                (i,), eps,
            )
            if not np.allclose(analytic[:, :, i], fd, **kwargs):
                worst = np.max(np.abs(analytic[:, :, i] - fd))
                raise AssertionError(
                    "analytic gradient of %s w.r.t. %r deviates from the "
                    "central difference by up to %g"
                    % (type(self).__name__, names[i], worst)
                )

    def _test_x_gradient(self, which, x1, x2, eps, kwargs):
        kwargs.setdefault("atol", 0.5 * eps)
        analytic = (
            self.get_x1_gradient(x1, x2=x2) if which == 1
            else self.get_x2_gradient(x1, x2=x2)
        )
        if x2 is None:
            x2 = np.array(x1)
        xp = x1 if which == 1 else x2
        value_fn = lambda: self.get_value(x1, x2=x2)
        for i in range(len(xp)):
            for k in range(self.ndim):
                # the point arrays are nudged in place, so the install
                # callback has nothing to do
                fd = self._fd_probe(
                    value_fn, lambda: xp, lambda _: None, (i, k), eps
                )
                got = analytic[i, :, k] if which == 1 else analytic[:, i, k]
                ref = fd[i] if which == 1 else fd[:, i]
                assert np.allclose(got, ref, **kwargs), (
                    "input-gradient mismatch at point %d axis %d" % (i, k)
                )

    def test_x1_gradient(self, x1, x2=None, eps=1.32e-6, **kwargs):
        self._test_x_gradient(1, x1, x2, eps, kwargs)

    def test_x2_gradient(self, x1, x2=None, eps=1.32e-6, **kwargs):
        self._test_x_gradient(2, x1, x2, eps, kwargs)


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------

class _operator(Kernel):
    is_kernel = False
    kernel_type = -1

    def __init__(self, k1, k2):
        if k1.ndim != k2.ndim:
            raise ValueError("Dimension mismatch")
        self.ndim = k1.ndim
        self._dirty = True
        ModelSet.__init__(self, [("k1", k1), ("k2", k2)])

    @property
    def k1(self):
        return self.models["k1"]

    @property
    def k2(self):
        return self.models["k2"]

    @property
    def dirty(self):
        return self._dirty or self.k1.dirty or self.k2.dirty

    @dirty.setter
    def dirty(self, v):
        self._dirty = v
        self.k1.dirty = False
        self.k2.dirty = False

    def _compile_binary(self, combine):
        f1 = self.k1.pair_fn
        f2 = self.k2.pair_fn
        n1 = self.k1.full_size

        def pair(theta, x1, x2):
            return combine(
                f1(theta[:n1], x1, x2), f2(theta[n1:], x1, x2)
            )

        return pair


class Sum(_operator):
    is_kernel = False
    operator_type = 0

    def _compile(self):
        return self._compile_binary(lambda a, b: a + b)

    def get_cutoff(self):
        return max(self.k1.get_cutoff(), self.k2.get_cutoff())

    def __repr__(self):
        return "{0} + {1}".format(self.k1, self.k2)


class Product(_operator):
    is_kernel = False
    operator_type = 1

    def _compile(self):
        return self._compile_binary(lambda a, b: a * b)

    def get_cutoff(self):
        # A product with a compactly-supported factor is compactly supported.
        return min(self.k1.get_cutoff(), self.k2.get_cutoff())

    def __repr__(self):
        return "{0} * {1}".format(self.k1, self.k2)


# ---------------------------------------------------------------------------
# Stationary / non-stationary bases used by the generated kernel classes
# ---------------------------------------------------------------------------

class StationaryKernel(Kernel):
    """A kernel of the form ``k(r2)`` over a metric squared distance.

    The metric (isotropic / axis-aligned / general) contributes trailing
    parameters; optional per-axis ``block`` bounds zero the kernel outside a
    box (reference ``templates/kernels.h`` blocked support).
    """

    stationary = True
    _value_fn = None  # staticmethod: f(r2, *base_params, *constants)

    def _init_stationary(self, base, metric, block):
        self.ndim = metric.ndim
        self.axes = metric.axes
        self.block = block
        ModelSet.__init__(self, [(None, base), ("metric", metric)])
        self.dirty = True

    @property
    def block(self):
        if not self.blocked:
            return None
        return list(zip(self.min_block, self.max_block))

    @block.setter
    def block(self, block):
        if block is None:
            self.blocked = False
            self.min_block = -np.inf + np.zeros(len(self.axes))
            self.max_block = np.inf + np.zeros(len(self.axes))
        else:
            block = np.atleast_2d(block)
            if block.shape != (len(self.axes), 2):
                raise ValueError("dimension mismatch in block specification")
            self.blocked = True
            self.min_block, self.max_block = map(np.array, zip(*block))
        self.__dict__.pop("_pair_fn", None)
        self.__dict__.pop("_fns", None)

    def _compile(self):
        metric = self.models["metric"]
        nb = len(self._base_param_names)
        consts = tuple(
            float(getattr(self, c)) for c in self._constant_names
        )
        r2_fn = metric_r2_fn(metric.metric_type, metric.axes, self.ndim)
        value_fn = self._value_fn
        blocked = bool(self.blocked)
        if blocked:
            # static per-axis bounds (python floats): no captured constant
            # arrays in the traced pair function
            axes_s = tuple(int(a) for a in self.axes)
            bounds_s = tuple(
                (float(lo), float(hi))
                for lo, hi in zip(self.min_block, self.max_block)
            )

        def pair(theta, x1, x2):
            base = tuple(theta[i] for i in range(nb))
            r2 = r2_fn(theta[nb:], x1, x2)
            val = value_fn(r2, *base, *consts)
            if blocked:
                inside = jnp.bool_(True)
                for a, (lo, hi) in zip(axes_s, bounds_s):
                    inside = (
                        inside
                        & (x1[a] >= lo) & (x1[a] <= hi)
                        & (x2[a] >= lo) & (x2[a] <= hi)
                    )
                val = jnp.where(inside, val, 0.0)
            return val

        return pair

    def __repr__(self):
        base = self.models[None]
        params = [
            "{0}={1}".format(k, getattr(base, k))
            for k in base.parameter_names
        ]
        params += [
            "metric={0}".format(repr(self.metric)),
            "block={0}".format(repr(self.block)),
        ]
        return "{0}({1})".format(self.__class__.__name__, ", ".join(params))


class NonStationaryKernel(Kernel):
    """A kernel evaluated per input axis and summed over the selected axes
    (reference ``templates/kernels.h`` non-stationary template)."""

    stationary = False
    _value_fn = None  # staticmethod: f(x1, x2, *base_params, *constants)

    def _init_nonstationary(self, base, subspace):
        self.subspace = subspace
        self.ndim = subspace.ndim
        self.axes = subspace.axes
        ModelSet.__init__(self, [(None, base)])
        self.dirty = True

    def _compile(self):
        axes = tuple(int(a) for a in self.axes)
        nb = len(self._base_param_names)
        consts = tuple(
            float(getattr(self, c)) for c in self._constant_names
        )
        value_fn = self._value_fn

        def pair(theta, x1, x2):
            base = tuple(theta[i] for i in range(nb))
            total = jnp.zeros((), dtype=x1.dtype)
            for j in axes:
                total = total + value_fn(x1[j], x2[j], *base, *consts)
            return total

        return pair

    def __repr__(self):
        base = self.models[None]
        params = [
            "{0}={1}".format(k, getattr(base, k))
            for k in base.parameter_names
        ]
        params += [
            "ndim={0}".format(self.ndim),
            "axes={0}".format(repr(self.axes)),
        ]
        return "{0}({1})".format(self.__class__.__name__, ", ".join(params))
