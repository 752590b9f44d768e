# -*- coding: utf-8 -*-
"""Small host-side utilities (reference ``src/george/utils.py``)."""

import functools

import numpy as np

from .neighbors import nd_sort_samples  # noqa: F401  (re-export)

__all__ = [
    "multivariate_gaussian_samples",
    "nd_sort_samples",
    "numerical_gradient",
    "check_gradient",
    "full_precision_matmuls",
    "pinned_full_precision",
    "use_compile_cache",
]


def full_precision_matmuls(fn):
    """Trace ``fn`` with every dot/einsum pinned to full f32 precision.

    On an NVIDIA GPU an f32 matmul at ``Precision.DEFAULT`` may run on
    the tensor cores in TF32, which keeps a 10-bit mantissa (about three
    decimal digits). The solvers' small contractions — Gram matrices for
    the ridge skeleton interpolation, SMW cores, ACA residual updates,
    CG/Lanczos recurrences, quadratic forms — are exactly the places
    where that loss is catastrophic for a likelihood anchored at 2e-3
    relative error. Precision is baked into the jaxpr at trace time, so
    the policy sticks through jit/vmap/grad/checkpoint.

    The mode is overridable with ``GEORGE_TPU_MATMUL_PRECISION``
    (``default`` / ``high`` / ``highest``) for experiments only; the
    conditioning-critical blocks stay pinned through
    :func:`pinned_full_precision` whatever it says. The env var is read
    at CALL (trace) time, so one process can trace and compare modes."""
    import os

    import jax

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        mode = os.environ.get("GEORGE_TPU_MATMUL_PRECISION", "highest")
        with jax.default_matmul_precision(mode):
            return fn(*args, **kwargs)

    return wrapped


def pinned_full_precision(fn):
    """Like :func:`full_precision_matmuls` but NOT overridable: for the
    blocks whose conditioning makes anything below full f32 catastrophic
    (the ridge interpolation solves, SMW core assembly/inversion, leaf
    factorization) even when the experimental env knob relaxes the rest."""
    import jax

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


def multivariate_gaussian_samples(matrix, N, mean=None):
    """Samples from a multivariate Gaussian with covariance ``matrix``.

    Returns shape ``(k,)`` for ``N == 1`` else ``(N, k)`` (reference
    ``utils.py:11-33``).
    """
    if mean is None:
        mean = np.zeros(len(matrix))
    samples = np.random.multivariate_normal(mean, matrix, N)
    if N == 1:
        return samples[0]
    return samples


def numerical_gradient(f, x, dx=1.234e-6):
    g = np.empty_like(x, dtype=float)
    for i in range(len(g)):
        x[i] += dx
        fp = f(x)
        x[i] -= 2 * dx
        fm = f(x)
        x[i] += dx
        g[i] = 0.5 * (fp - fm) / dx
    return g


def check_gradient(obj, *args, **kwargs):
    """Centered-FD validation of a model's ``get_gradient`` (reference
    ``utils.py:71-92``)."""
    eps = kwargs.pop("eps", 1.23e-5)

    grad0 = obj.get_gradient(*args, **kwargs)
    vector = obj.get_parameter_vector()
    for i, v in enumerate(vector):
        vector[i] = v + eps
        obj.set_parameter_vector(vector)
        p = obj.get_value(*args, **kwargs)

        vector[i] = v - eps
        obj.set_parameter_vector(vector)
        m = obj.get_value(*args, **kwargs)

        vector[i] = v
        obj.set_parameter_vector(vector)

        grad = 0.5 * (p - m) / eps
        assert np.allclose(grad0[i], grad), (
            "grad computation failed for '{0}' ({1})".format(
                obj.get_parameter_names()[i], i
            )
        )


def use_compile_cache():
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here. Otherwise the cache lives at the fixed
    ``<checkout>/.jax_cache``: the directory is part of the cache key, so
    a path that moved between runs would never hit."""
    import os

    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache",
    )
    jax.config.update("jax_compilation_cache_dir", path)
    return path
