# -*- coding: utf-8 -*-
"""Numerical building blocks: the hierarchical solver's leaf Cholesky and
the double-single SMW core inverse (``ops/ds.py``)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from george_tpu import kernels


@pytest.mark.parametrize("m", [128, 196, 256])
def test_leaf_cholesky_f32_matches_numpy(m, monkeypatch):
    """The hierarchical solver's f32 leaf factor (batched assembly +
    XLA Cholesky, chunked) against numpy's f64 Cholesky of the same
    blocks, at the solver's leaf widths (196 is the N=1e5 bench leaf)."""
    from george_tpu.solvers import hodlr

    # force the chunked scan (2 chunks of 2 leaves) at test sizes
    monkeypatch.setattr(hodlr, "_LEAF_MATVEC_CHUNK_BYTES", 2 * m * m * 4)
    B = 4
    rng = np.random.default_rng(m)
    x = np.sort(rng.uniform(0, 4.0 * B * m / 128, B * m))[:, None]
    d = np.full(B * m, 1e-2)
    kernel = 1.2 * kernels.ExpSquaredKernel(25.0) + 0.3 * (
        kernels.Matern32Kernel(8.0)
    )
    f32 = jnp.float32
    L = np.asarray(hodlr._leaf_cholesky_chunked(
        kernel.pair_fn, jnp.asarray(kernel.parameter_vector, f32),
        jnp.asarray(x, f32).reshape(B, m, 1),
        jnp.ones((B, m), bool), jnp.asarray(d, f32).reshape(B, m),
        False,
    ))
    assert L.dtype == np.float32 and L.shape == (B, m, m)
    assert np.isfinite(L).all()
    assert np.array_equal(L, np.tril(L))
    xb = x.reshape(B, m)
    r2 = (xb[:, :, None] - xb[:, None, :]) ** 2
    r3 = np.sqrt(3.0 * r2 / 8.0)
    K = 1.2 * np.exp(-0.5 * r2 / 25.0) + 0.3 * (1 + r3) * np.exp(-r3)
    K += 1e-2 * np.eye(m)[None]
    L_ref = np.linalg.cholesky(K)
    # backward error at f32 rounding; forward error within conditioning
    rec = np.einsum("bik,bjk->bij", L.astype(np.float64), L)
    assert np.max(np.abs(rec - K)) <= 1e-5 * np.max(np.abs(K))
    assert np.max(np.abs(L - L_ref)) <= 1e-3 * np.max(np.abs(L_ref))


def test_ds_inv_logdet_matches_f64():
    """Double-single Gauss-Jordan (``ops/ds.py``) matches the f64
    reference on batches of small ill-conditioned matrices — the SMW
    core shapes/conditions it exists for (kappa up to 1e7 measured at
    N=1e6, ``hodlr._core_inv_slogdet``)."""
    from george_tpu.ops.ds import ds_inv_logdet, ds_inv_logdet_ref

    rng = np.random.default_rng(3)
    for m, kappa in ((24, 1e7), (48, 1e5), (6, 1e2)):
        p = 32
        U, _ = np.linalg.qr(rng.standard_normal((p, m, m)))
        V, _ = np.linalg.qr(rng.standard_normal((p, m, m)))
        s = np.logspace(0, -np.log10(kappa), m)
        A = (U * s[None, None, :] @ np.swapaxes(V, -1, -2)).astype(
            np.float32
        )
        inv_ds, ld_ds, sg_ds = jax.jit(ds_inv_logdet)(jnp.asarray(A))
        inv64, ld64, sg64 = ds_inv_logdet_ref(A)
        scale = np.abs(inv64).max(axis=(-2, -1), keepdims=True)
        assert np.max(np.abs(np.asarray(inv_ds) - inv64) / scale) < 1e-5
        assert np.max(np.abs(np.asarray(ld_ds) - ld64)) < 1e-3
        assert np.all(np.asarray(sg_ds) == sg64)


def test_ds_core_path_parity_small():
    """Forcing the DS core path (GEORGE_TPU_CORE_DS=1) through a full
    f32 HODLR factorization reproduces the plain-f32 log-likelihood on a
    shallow tree — the gate flips implementation, not semantics."""
    import os

    from george_tpu import kernels as K
    from george_tpu.solvers.hodlr import (
        build_structure, hodlr_factor, hodlr_solve,
    )

    rng = np.random.default_rng(11)
    n = 600
    x = np.sort(rng.uniform(0, 40, n))[:, None].astype(np.float32)
    kernel = 1.1 * K.ExpSquaredKernel(2.0)
    theta = jnp.asarray(kernel.parameter_vector, dtype=jnp.float32)
    st = build_structure(n, min_size=64, rank=16, seed=42, x_sorted=x)
    xpad = np.concatenate([x, np.repeat(x[-1:], st.n_pad - n, axis=0)])
    valid = np.zeros(st.n_pad, bool)
    valid[:n] = True
    dp = np.ones(st.n_pad, np.float32)
    rp = rng.standard_normal(st.n_pad).astype(np.float32)
    args = (kernel.pair_fn, theta, jnp.asarray(xpad, jnp.float32),
            jnp.asarray(valid), jnp.asarray(dp), st)

    def ll():
        f, ld = hodlr_factor(*args)
        z = hodlr_solve(f, st, jnp.asarray(rp))
        return float(jnp.dot(jnp.asarray(rp), z)), float(ld)

    os.environ.pop("GEORGE_TPU_CORE_DS", None)
    q0, ld0 = ll()
    os.environ["GEORGE_TPU_CORE_DS"] = "1"
    try:
        q1, ld1 = ll()
    finally:
        del os.environ["GEORGE_TPU_CORE_DS"]
    assert abs(q1 - q0) / abs(q0) < 1e-4
    assert abs(ld1 - ld0) / max(abs(ld0), 1.0) < 1e-4
