# -*- coding: utf-8 -*-
"""Hierarchical solver tests: dense-oracle comparisons at tight tolerance
(the reference pattern, ``tests/test_solvers.py:29-55``), autodiff-gradient
FD checks, and GP integration."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from george_tpu import GP, kernels
from george_tpu.solvers import BasicSolver, HODLRSolver


def _data(n=600, seed=0, span=20.0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, span, n))[:, None]
    yerr = 0.3 * np.ones(n)
    y = np.sin(x[:, 0]) + 0.3 * rng.standard_normal(n)
    return x, y, yerr


def _dense(kernel, x, yerr):
    K = kernel.get_value(x)
    K[np.diag_indices_from(K)] += yerr ** 2
    return K


@pytest.mark.parametrize(
    "kernel",
    [
        1.2 * kernels.ExpSquaredKernel(2.0),
        0.5 * kernels.Matern32Kernel(1.0)
        + 0.2 * kernels.ExpSine2Kernel(gamma=2.0, log_period=0.5),
        2.0 * kernels.Matern52Kernel(1.5),
    ],
)
def test_hodlr_vs_dense(kernel):
    x, y, yerr = _data()
    K = _dense(kernel, x, yerr)
    _, ld_true = np.linalg.slogdet(K)
    alpha_true = np.linalg.solve(K, y)

    s = HODLRSolver(kernel, min_size=64, rank=48)
    s.compute(x, yerr)
    assert abs(s.log_determinant - ld_true) < 1e-4
    a = s.apply_inverse(y)
    assert np.linalg.norm(a - alpha_true) / np.linalg.norm(alpha_true) < 1e-5
    # matvec against the dense oracle
    v = np.random.default_rng(1).standard_normal(len(x))
    mv = s.apply_forward(v)
    assert np.linalg.norm(mv - K @ v) / np.linalg.norm(K @ v) < 1e-6


def test_hodlr_dot_solve_and_multi_rhs():
    x, y, yerr = _data(500)
    kernel = 1.5 * kernels.ExpSquaredKernel(1.0)
    K = _dense(kernel, x, yerr)
    s = HODLRSolver(kernel, min_size=64, rank=32)
    s.compute(x, yerr)
    assert np.isclose(
        s.dot_solve(y), y @ np.linalg.solve(K, y), rtol=1e-6
    )
    B = np.random.default_rng(2).standard_normal((len(x), 3))
    Z = s.apply_inverse(B)
    Zt = np.linalg.solve(K, B)
    assert np.linalg.norm(Z - Zt) / np.linalg.norm(Zt) < 1e-5


def test_hodlr_gradient_matvec():
    """dK/dtheta matvecs via jvp agree with dense kernel gradients."""
    x, y, yerr = _data(400)
    kernel = 1.2 * kernels.ExpSquaredKernel(2.0)
    Kg = kernel.get_gradient(x, include_frozen=True)
    s = HODLRSolver(kernel, min_size=64, rank=32)
    s.compute(x, yerr)
    v = np.random.default_rng(3).standard_normal(len(x))
    for i in range(Kg.shape[2]):
        g = s.apply_forward(v, i + 1)
        ref = Kg[:, :, i] @ v
        # the derivative of the *compressed* operator tracks the dense dK
        # to the compression error; the ridge conditioning bounds this
        assert (
            np.linalg.norm(g - ref) / (np.linalg.norm(ref) + 1e-12) < 1e-4
        )


def test_hodlr_loglike_autodiff_gradient():
    """jax.grad through the factorization matches FD of the exact dense
    likelihood (the fused replacement for both reference gradient regimes,
    ``gp.py:440-562``)."""
    x, y, yerr = _data(500)
    kernel = 1.2 * kernels.ExpSquaredKernel(2.0)
    s = HODLRSolver(kernel, min_size=64, rank=48)
    s.compute(x, yerr)
    f = s.loglike_fn()
    th = jnp.asarray(kernel.parameter_vector)
    diag = jnp.asarray(yerr ** 2)
    r = jnp.asarray(y)
    g = np.asarray(jax.grad(f)(th, diag, r))

    def dense_ll(thv):
        k2 = 1.2 * kernels.ExpSquaredKernel(2.0)
        k2.set_parameter_vector(np.asarray(thv))
        K = _dense(k2, x, yerr)
        _, ld = np.linalg.slogdet(K)
        return -0.5 * (
            y @ np.linalg.solve(K, y) + ld + len(x) * np.log(2 * np.pi)
        )

    eps = 1e-6
    th0 = np.asarray(th)
    for i in range(len(th0)):
        tp, tm = th0.copy(), th0.copy()
        tp[i] += eps
        tm[i] -= eps
        fd = (dense_ll(tp) - dense_ll(tm)) / (2 * eps)
        assert np.isclose(g[i], fd, rtol=1e-3, atol=1e-4)


def test_gp_with_hodlr_solver():
    """GP end-to-end on the HODLR path: likelihood and gradient agree with
    the exact solver (reference ``tests/test_tutorial.py`` pattern)."""
    x, y, yerr = _data(500)
    kernel = 0.8 * kernels.Matern32Kernel(1.2)

    gp_basic = GP(kernel, solver=BasicSolver)
    gp_basic.compute(x, yerr)
    ll_b = gp_basic.log_likelihood(y)
    g_b = gp_basic.grad_log_likelihood(y)

    gp_h = GP(0.8 * kernels.Matern32Kernel(1.2), solver=HODLRSolver,
              min_size=64, rank=64)
    gp_h.compute(x, yerr)
    ll_h = gp_h.log_likelihood(y)
    g_h = gp_h.grad_log_likelihood(y)

    assert np.isclose(ll_b, ll_h, rtol=1e-6, atol=1e-4)
    assert np.allclose(g_b, g_h, rtol=1e-3, atol=1e-4)


def test_gp_predict_with_hodlr():
    x, y, yerr = _data(400)
    t = np.linspace(0, 20, 100)
    gp_b = GP(1.1 * kernels.ExpSquaredKernel(1.5))
    gp_b.compute(x, yerr)
    mu_b, var_b = gp_b.predict(y, t, return_var=True)
    gp_h = GP(1.1 * kernels.ExpSquaredKernel(1.5), solver=HODLRSolver,
              min_size=64, rank=48)
    gp_h.compute(x, yerr)
    mu_h, var_h = gp_h.predict(y, t, return_var=True)
    assert np.allclose(mu_b, mu_h, atol=1e-5)
    assert np.allclose(var_b, var_h, atol=1e-5)


def test_hodlr_2d_morton():
    """2-D inputs: Morton ordering + FPS skeletons keep the approximation
    usable (loose tolerance — weak-admissibility HODLR in 2-D, same
    qualitative behavior as the reference's sorted-input guidance)."""
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 10, (400, 2))
    yerr = 0.5 * np.ones(len(x))
    y = rng.standard_normal(len(x))
    kernel = 1.0 * kernels.ExpSquaredKernel(3.0, ndim=2)
    K = _dense(kernel, x, yerr)
    _, ld_true = np.linalg.slogdet(K)
    s = HODLRSolver(kernel, min_size=64, rank=64)
    s.compute(x, yerr)
    assert abs(s.log_determinant - ld_true) / abs(ld_true) < 5e-3
    a = s.apply_inverse(y)
    at = np.linalg.solve(K, y)
    assert np.linalg.norm(a - at) / np.linalg.norm(at) < 0.05


def test_hodlr_small_n_dense_fallback():
    """n below 2*min_size degenerates to a single dense leaf."""
    x, y, yerr = _data(80)
    kernel = 1.0 * kernels.ExpSquaredKernel(1.0)
    K = _dense(kernel, x, yerr)
    s = HODLRSolver(kernel, min_size=64, rank=16)
    s.compute(x, yerr)
    assert s._struct.L == 0
    _, ld = np.linalg.slogdet(K)
    assert np.isclose(s.log_determinant, ld, rtol=1e-10)
    assert np.allclose(s.apply_inverse(y), np.linalg.solve(K, y))


def test_gp_hodlr_hutchinson_gradient():
    """grad_mode='hutchinson' (reference compute_grad Regime B): GP
    gradient tracks the exact-solver gradient within estimator noise."""
    x, y, yerr = _data(400)
    k = 0.9 * kernels.ExpSquaredKernel(1.5)
    gp_h = GP(k, solver=HODLRSolver, min_size=64, rank=48,
              grad_mode="hutchinson", num_probes=64)
    gp_h.compute(x, yerr)
    assert gp_h.solver.matrix_free
    g_h = gp_h.grad_log_likelihood(y)

    gp_e = GP(0.9 * kernels.ExpSquaredKernel(1.5))
    gp_e.compute(x, yerr)
    g_e = gp_e.grad_log_likelihood(y)
    assert np.allclose(g_h, g_e, rtol=0.2, atol=0.5)


def test_hodlr_apply_sqrt_symmetric():
    """Symmetric factorization: ``W W^T = K`` (reference sym variant,
    ``hodlr.h:713-786``), enabling O(N r log N) prior sampling."""
    x, y, yerr = _data(500)
    kernel = 1.2 * kernels.ExpSquaredKernel(2.0)
    K = _dense(kernel, x, yerr)
    s = HODLRSolver(kernel, min_size=64, rank=48)
    s.compute(x, yerr)
    Wt = s.apply_sqrt(np.eye(len(x)))    # (W I)^T = W^T
    WWt = Wt.T @ Wt
    assert np.linalg.norm(WWt - K) / np.linalg.norm(K) < 1e-5


def test_gp_sample_with_hodlr():
    x, y, yerr = _data(400)
    gp = GP(1.0 * kernels.ExpSquaredKernel(1.5), solver=HODLRSolver,
            min_size=64, rank=48)
    gp.compute(x, yerr)
    np.random.seed(0)
    draws = gp.sample(size=6)
    assert draws.shape == (6, len(x))
    assert np.all(np.isfinite(draws))
    # scale sanity: samples have the prior's marginal scale
    marg = np.sqrt(1.0 + yerr[0] ** 2)
    assert 0.5 * marg < draws.std() < 2.0 * marg


def test_hodlr_pickle_recompute():
    """Pickling drops device state and flags not-computed (reference
    ``hodlr.py:96-104``, ``tests/test_pickle.py:22-36``)."""
    import pickle

    x, y, yerr = _data(300)
    kernel = 1.0 * kernels.ExpSquaredKernel(1.0)
    s = HODLRSolver(kernel, min_size=64, rank=32)
    s.compute(x, yerr)
    s2 = pickle.loads(pickle.dumps(s))
    assert not s2.computed
    s2.compute(x, yerr)
    assert np.isclose(s2.log_determinant, s.log_determinant, rtol=1e-8)


def test_hutchinson_loglike_and_grad_function():
    """The fused large-N entry point: exact log-likelihood, gradient
    within Hutchinson noise of the exact autodiff gradient."""
    import jax.numpy as jnp
    from george_tpu.solvers.hodlr import (
        build_structure, hodlr_factor, hodlr_solve,
        hodlr_loglike_and_grad_hutchinson,
    )

    x, y, yerr = _data(600)
    kernel = 1.2 * kernels.ExpSquaredKernel(2.0)
    pair = kernel.pair_fn
    theta = jnp.asarray(kernel.parameter_vector)
    st = build_structure(len(x), min_size=64, rank=32, seed=42, x_sorted=x)
    xpad = np.concatenate(
        [x, np.repeat(x[-1:], st.n_pad - len(x), axis=0)]
    )
    valid = np.zeros(st.n_pad, bool)
    valid[: len(x)] = True
    dp = np.ones(st.n_pad)
    dp[: len(x)] = yerr ** 2
    rp = np.zeros(st.n_pad)
    rp[: len(x)] = y
    xj, vj, dj, rj = map(jnp.asarray, (xpad, valid, dp, rp))

    def exact_ll(th):
        f, ld = hodlr_factor(pair, th, xj, vj, dj, st)
        z = hodlr_solve(f, st, rj)
        return -0.5 * (
            jnp.dot(rj, z) + ld + len(x) * jnp.log(2 * jnp.pi)
        )

    ll_e, g_e = jax.value_and_grad(exact_ll)(theta)
    ll_h, g_h = hodlr_loglike_and_grad_hutchinson(
        pair, theta, xj, vj, dj, rj, st, jax.random.PRNGKey(0),
        num_probes=48, n_real=len(x),
    )
    assert np.isclose(float(ll_e), float(ll_h), rtol=1e-10)
    assert np.allclose(np.asarray(g_e), np.asarray(g_h), rtol=0.1,
                       atol=0.5)

    # the HBM-bounded leaf sweep (lax.map chunks) must be bit-identical
    # to the one-shot batched sweep, including through the jacfwd path
    # the fused Hutchinson entry point uses (this is what bounds the
    # N=1e6 graph's leaf temporaries)
    from george_tpu.solvers import hodlr as hodlr_mod

    saved = hodlr_mod._LEAF_MATVEC_CHUNK_BYTES
    try:
        itemsize = np.dtype(xpad.dtype).itemsize
        hodlr_mod._LEAF_MATVEC_CHUNK_BYTES = 2 * st.m * st.m * itemsize
        assert hodlr_mod._leaf_chunk(
            st.n_pad // st.m, st.m, xpad.dtype
        ) is not None
        ll_c, g_c = hodlr_loglike_and_grad_hutchinson(
            pair, theta, xj, vj, dj, rj, st, jax.random.PRNGKey(0),
            num_probes=48, n_real=len(x),
        )
    finally:
        hodlr_mod._LEAF_MATVEC_CHUNK_BYTES = saved
    assert np.isclose(float(ll_h), float(ll_c), rtol=1e-12)
    assert np.allclose(np.asarray(g_h), np.asarray(g_c), rtol=1e-8)

    # the width-bounded ancestor-update grouping (the other half of the
    # N=1e6 HBM fix) must be bit-identical to the single wide
    # application: _factor_apply_inv acts on RHS columns independently,
    # so grouping only changes concat boundaries
    saved_w = hodlr_mod._ANCESTOR_UPDATE_BYTES
    try:
        itemsize = np.dtype(xpad.dtype).itemsize
        # one level's width per group
        hodlr_mod._ANCESTOR_UPDATE_BYTES = st.n_pad * st.rank * itemsize
        ll_g, g_g = hodlr_loglike_and_grad_hutchinson(
            pair, theta, xj, vj, dj, rj, st, jax.random.PRNGKey(0),
            num_probes=48, n_real=len(x),
        )
    finally:
        hodlr_mod._ANCESTOR_UPDATE_BYTES = saved_w
    assert np.isclose(float(ll_h), float(ll_g), rtol=1e-12)
    assert np.allclose(np.asarray(g_h), np.asarray(g_g), rtol=1e-8)

    # the TRANSPOSED cascade layout (the large-N form: skeleton factors
    # (c, n_pad) / RHS (k, n_pad), which is what fits the N=1e6 split in
    # HBM) computes the same factorization, log-likelihood and gradient
    # as the row layout to rounding
    saved_t = st.transposed
    try:
        st.transposed = True
        ll_s, g_s = hodlr_loglike_and_grad_hutchinson(
            pair, theta, xj, vj, dj, rj, st, jax.random.PRNGKey(0),
            num_probes=48, n_real=len(x),
        )
    finally:
        st.transposed = saved_t
    assert np.isclose(float(ll_h), float(ll_s), rtol=1e-5)
    assert np.allclose(np.asarray(g_h), np.asarray(g_s), rtol=1e-4,
                       atol=1e-6)

    # the two-program split (precomputed factors threaded in as
    # arguments — bench.py's N=1e6 HBM form) is the same computation
    f_pre = hodlr_factor(pair, theta, xj, vj, dj, st)
    ll_2, g_2 = hodlr_loglike_and_grad_hutchinson(
        pair, theta, xj, vj, dj, rj, st, jax.random.PRNGKey(0),
        num_probes=48, n_real=len(x), factors_logdet=f_pre,
    )
    assert np.isclose(float(ll_h), float(ll_2), rtol=1e-12)
    assert np.allclose(np.asarray(g_h), np.asarray(g_2), rtol=1e-8)


def test_matvec_factors_parity_and_refined_hutchinson():
    """``hodlr_matvec_factors`` (the assembly-free compressed matvec
    rebuilt from the stored factors) must agree with the fresh-assembly
    ``hodlr_matvec`` to rounding, and the ``refine_steps=1`` Hutchinson
    path (refinement + gated logdet trace correction) must reproduce the
    exact f64 likelihood — in f64 the residuals are ~eps, so the gate is
    open and the correction must be numerically inert."""
    import jax.numpy as jnp
    from george_tpu.solvers.hodlr import (
        build_structure, hodlr_factor, hodlr_matvec,
        hodlr_matvec_factors, hodlr_loglike_and_grad_hutchinson,
    )

    x, y, yerr = _data(600)
    kernel = 1.2 * kernels.ExpSquaredKernel(2.0)
    pair = kernel.pair_fn
    theta = jnp.asarray(kernel.parameter_vector)
    st = build_structure(len(x), min_size=64, rank=32, seed=42, x_sorted=x)
    xpad = np.concatenate([x, np.repeat(x[-1:], st.n_pad - len(x), axis=0)])
    valid = np.zeros(st.n_pad, bool)
    valid[: len(x)] = True
    dp = np.ones(st.n_pad)
    dp[: len(x)] = yerr ** 2
    rp = np.zeros(st.n_pad)
    rp[: len(x)] = y
    xj, vj, dj, rj = map(jnp.asarray, (xpad, valid, dp, rp))

    factors, _ = hodlr_factor(pair, theta, xj, vj, dj, st)
    V = jnp.asarray(np.random.default_rng(3).standard_normal(
        (st.n_pad, 4)))
    mv_fresh = hodlr_matvec(pair, theta, xj, vj, dj, st, V,
                            include_diag=True)
    mv_fact = hodlr_matvec_factors(factors, st, V)
    num = np.linalg.norm(np.asarray(mv_fresh - mv_fact))
    den = np.linalg.norm(np.asarray(mv_fresh))
    assert num / den < 1e-10

    ll0, g0 = hodlr_loglike_and_grad_hutchinson(
        pair, theta, xj, vj, dj, rj, st, jax.random.PRNGKey(0),
        num_probes=48, n_real=len(x),
    )
    ll1, g1 = hodlr_loglike_and_grad_hutchinson(
        pair, theta, xj, vj, dj, rj, st, jax.random.PRNGKey(0),
        num_probes=48, n_real=len(x), refine_steps=1,
    )
    assert np.isclose(float(ll0), float(ll1), rtol=1e-9, atol=1e-7)
    assert np.allclose(np.asarray(g0), np.asarray(g1), rtol=1e-6,
                       atol=1e-6)


def test_hodlr_sym_solver_parity():
    """``sym=1`` routes the whole solver protocol through the symmetric
    ``K = W W^T`` cascade (reference ``hodlr.h:713-786``): logdet,
    apply_inverse and dot_solve agree with the dense oracle and with the
    non-symmetric path."""
    x, y, yerr = _data(500)
    kernel = 1.2 * kernels.ExpSquaredKernel(2.0)
    K = _dense(kernel, x, yerr)
    _, ld_true = np.linalg.slogdet(K)
    alpha_true = np.linalg.solve(K, y)

    s = HODLRSolver(kernel, min_size=64, rank=48, sym=True)
    s.compute(x, yerr)
    assert s.sym
    assert abs(s.log_determinant - ld_true) < 1e-4
    a = s.apply_inverse(y)
    assert np.linalg.norm(a - alpha_true) / np.linalg.norm(alpha_true) < 1e-5
    assert np.isclose(s.dot_solve(y), y @ alpha_true, rtol=1e-6)


def test_hodlr_apply_inverse_sym_W_roundtrip():
    """``apply_inverse_sym_W(_transpose)`` (reference
    ``solvers/hodlr.py:72-77`` / ``hodlr.h:169-185``): W^{-1} and W^{-T}
    invert the sqrt matvec, and W^{-T} W^{-1} == K^{-1}."""
    x, y, yerr = _data(400)
    kernel = 1.0 * kernels.ExpSquaredKernel(1.5)
    K = _dense(kernel, x, yerr)
    s = HODLRSolver(kernel, min_size=64, rank=48, sym=True)
    s.compute(x, yerr)

    rng = np.random.default_rng(7)
    V = rng.standard_normal((len(x), 3))
    # round-trips through the cascade (matrix and vector RHS)
    from george_tpu.solvers.hodlr import hodlr_sqrt_matvec

    st = s._struct
    Vp, _ = s._pad_rhs(V)
    s._ensure_sym()
    WV = np.asarray(hodlr_sqrt_matvec(s._sym_factors, st, Vp))
    back = s.apply_inverse_sym_W(s._unpad(jnp.asarray(WV), False))
    assert np.allclose(back, V, atol=1e-8)
    WtV = np.asarray(
        hodlr_sqrt_matvec(s._sym_factors, st, Vp, transpose=True)
    )
    back_t = s.apply_inverse_sym_W_transpose(
        s._unpad(jnp.asarray(WtV), False)
    )
    assert np.allclose(back_t, V, atol=1e-8)
    # W^{-T} W^{-1} y == K^{-1} y
    z = s.apply_inverse_sym_W_transpose(s.apply_inverse_sym_W(y))
    assert np.allclose(z, np.linalg.solve(K, y), atol=1e-6)


def test_hodlr_sym_hutchinson_gradient():
    """sym=1 + grad_mode='hutchinson': the symmetric trace estimator
    (reference ``gp.py:544-547``) tracks the exact gradient."""
    x, y, yerr = _data(400)
    k = 0.9 * kernels.ExpSquaredKernel(1.5)
    gp_s = GP(k, solver=HODLRSolver, min_size=64, rank=48, sym=True,
              grad_mode="hutchinson", num_probes=64)
    gp_s.compute(x, yerr)
    g_s = gp_s.grad_log_likelihood(y)

    gp_e = GP(0.9 * kernels.ExpSquaredKernel(1.5))
    gp_e.compute(x, yerr)
    g_e = gp_e.grad_log_likelihood(y)
    assert np.allclose(g_s, g_e, rtol=0.2, atol=0.5)


def test_hodlr_knn_skeletons():
    """``knn=`` feeds neighbor-guided skeleton selection (the reference's
    precomputed-nns CUR path, ``_hodlr.cpp:121-128``): accuracy stays at
    the dense-oracle level, and explicitly passed ``nns`` are honored."""
    x, y, yerr = _data(500)
    kernel = 1.2 * kernels.ExpSquaredKernel(2.0)
    K = _dense(kernel, x, yerr)
    _, ld_true = np.linalg.slogdet(K)

    s = HODLRSolver(kernel, min_size=64, rank=32, knn=8)
    s.compute(x, yerr)
    assert abs(s.log_determinant - ld_true) < 1e-3
    a = s.apply_inverse(y)
    at = np.linalg.solve(K, y)
    assert np.linalg.norm(a - at) / np.linalg.norm(at) < 1e-4

    # explicit nns (the reference's compute(..., nns) contract)
    from george_tpu.neighbors import knn_indices

    s2 = HODLRSolver(kernel, min_size=64, rank=32)
    s2.compute(x, yerr, nns=knn_indices(x, 8))
    assert abs(s2.log_determinant - ld_true) < 1e-3


def test_hodlr_tol_abs_ridge_floor():
    """``tol_abs`` sets the interpolation ridge floor: a loose floor
    degrades accuracy smoothly (still finite/stable), a tiny floor matches
    the default."""
    x, y, yerr = _data(500)
    kernel = 1.2 * kernels.ExpSquaredKernel(2.0)
    s_ref = HODLRSolver(kernel, min_size=64, rank=32)
    s_ref.compute(x, yerr)
    s_tight = HODLRSolver(kernel, min_size=64, rank=32, tol_abs=1e-14)
    s_tight.compute(x, yerr)
    assert np.isclose(
        s_tight.log_determinant, s_ref.log_determinant, rtol=1e-6
    )
    s_loose = HODLRSolver(kernel, min_size=64, rank=32, tol_abs=1e-2)
    s_loose.compute(x, yerr)
    assert np.isfinite(s_loose.log_determinant)
    # looser floor => larger (but bounded) deviation
    assert abs(s_loose.log_determinant - s_ref.log_determinant) < 5.0


def test_hodlr_recompute_invalidates_caches():
    """Re-calling compute() on the same solver instance (new data AND new
    hyperparameters) must not reuse matvec/sqrt closures built over the
    old structure (regression: lazily-built _mv_fn/_sym_factors survived
    a recompute)."""
    kernel = 1.2 * kernels.ExpSquaredKernel(2.0)
    x1, y1, yerr1 = _data(300, seed=3)
    s = HODLRSolver(kernel, min_size=64, rank=32)
    s.compute(x1, yerr1)
    v1 = np.random.default_rng(4).standard_normal(len(x1))
    s.apply_forward(v1)          # builds the matvec caches
    s.apply_sqrt(v1)             # builds the symmetric caches

    x2, y2, yerr2 = _data(280, seed=5, span=12.0)
    kernel.set_parameter_vector(kernel.get_parameter_vector() + 0.3)
    s.compute(x2, yerr2)
    K2 = _dense(kernel, x2, yerr2)
    v2 = np.random.default_rng(6).standard_normal(len(x2))
    mv = s.apply_forward(v2)
    assert np.linalg.norm(mv - K2 @ v2) / np.linalg.norm(K2 @ v2) < 1e-6
    # W W^T == K for the NEW data/theta
    W = s.apply_sqrt(np.eye(len(x2)))
    assert np.linalg.norm(W.T @ W - K2) / np.linalg.norm(K2) < 1e-5


def test_hodlr_accepts_foreign_nns_forms():
    """GP.compute-normalized nns forms (CSR tuple, ragged listing, bare
    trigger) must not crash the hierarchical solver — they are sparse
    structures, accepted and ignored like the reference ctor does."""
    from george_tpu import GP

    rng = np.random.default_rng(2)
    n = 96
    x = np.sort(rng.uniform(0, 10, n))
    y = np.sin(x)
    k = kernels.ExpSquaredKernel(metric=1.0)

    base = GP(k, solver=HODLRSolver, min_size=32)
    base.compute(x, 0.1)
    ll0 = base.log_likelihood(y)

    ragged = np.array(
        [np.flatnonzero(np.abs(x - xi) < 1.0) for xi in x], dtype=object
    )
    from george_tpu.neighbors import ragged_to_csr

    for nns in (True, ragged, ragged_to_csr(ragged)):
        gp = GP(k, solver=HODLRSolver, min_size=32)
        gp.compute(x, 0.1, nns=nns)
        np.testing.assert_allclose(gp.log_likelihood(y), ll0, rtol=1e-8)


def test_hodlr_kernel_zoo_oracle():
    """HODLR vs dense across the wider kernel zoo (beyond the ExpSq/
    Matern families the other tests use). Decaying/periodic/local
    kernels must agree to oracle accuracy."""
    rng = np.random.default_rng(0)
    n = 240
    x = np.sort(rng.uniform(0, 10, n))
    y = np.sin(x) + 0.1 * rng.standard_normal(n)
    zoo = [
        1.0 * kernels.RationalQuadraticKernel(log_alpha=0.3, metric=1.2),
        1.0 * kernels.ExpKernel(1.0),
        0.7 * kernels.CosineKernel(log_period=0.5),
        1.0 * kernels.LocalGaussianKernel(location=5.0, log_width=0.5),
        0.5 * kernels.DotProductKernel(),
        kernels.ConstantKernel(log_constant=-1.0)
        + kernels.ExpSquaredKernel(1.0),
    ]
    for k in zoo:
        gpb = GP(k)
        gpb.compute(x, 0.25)
        gph = GP(k, solver=HODLRSolver, min_size=32, rank=24)
        gph.compute(x, 0.25)
        rel = abs(gph.log_likelihood(y) - gpb.log_likelihood(y)) / max(
            abs(gpb.log_likelihood(y)), 1.0
        )
        assert rel < 1e-6, (type(k).__name__, rel)


def test_hodlr_self_check_warns_on_nondecaying_kernel():
    """The weak-admissibility SMW cascade is numerically unstable for
    non-decaying kernels (the SMW cores become singular to working
    precision; the reference's identical cascade fails silently,
    ``hodlr.h:707-711``). The factorization self-check must warn."""
    import warnings

    rng = np.random.default_rng(0)
    n = 240
    x = np.sort(rng.uniform(0, 10, n))
    k = 0.2 * kernels.PolynomialKernel(log_sigma2=0.0, order=3)
    HODLRSolver._checked_configs.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        gp = GP(k, solver=HODLRSolver, min_size=32, rank=24)
        gp.compute(x, 0.25)
    assert any("self-check" in str(w.message) for w in caught)
    assert gp.solver.factor_residual > 1e-6

    # healthy kernels pass silently
    HODLRSolver._checked_configs.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        gp2 = GP(1.2 * kernels.ExpSquaredKernel(2.0),
                 solver=HODLRSolver, min_size=32, rank=24)
        gp2.compute(x, 0.25)
    assert not any("self-check" in str(w.message) for w in caught)
    assert gp2.solver.factor_residual < 1e-8

    # the check is memoized per configuration: a recompute of the same
    # structure does not re-measure
    gp2.compute(x, 0.25)
    assert gp2.solver.factor_residual is None

    # ... but the memo is theta-regime-aware: an optimizer walking a
    # length scale into a different e-fold bucket re-triggers the check
    # (instability is theta-dependent — a scale much larger than the
    # domain makes a decaying kernel effectively non-decaying)
    gp2.set_parameter_vector(gp2.get_parameter_vector() + 2.0)
    gp2.compute(x, 0.25)
    assert gp2.solver.factor_residual is not None
    # and a same-regime recompute after that stays memoized again
    gp2.compute(x, 0.25)
    assert gp2.solver.factor_residual is None


def test_hodlr_debug_flag_reports_errors(capsys):
    """``debug=1`` mirrors the reference's debug mode
    (``_hodlr.cpp:143-161``): it measures the compression error against
    the EXACT kernel and the factorization residual on every compute
    (bypassing the once-per-config memo), printing both when verbose."""
    x, y, yerr = _data(500)
    kernel = 1.2 * kernels.ExpSquaredKernel(2.0)
    s = HODLRSolver(kernel, min_size=64, rank=32, debug=True, verbose=True)
    s.compute(x, yerr)
    assert s.factor_residual is not None and s.factor_residual < 1e-8
    assert s.compression_error is not None and s.compression_error < 1e-6
    out = capsys.readouterr().out
    assert "compression rel err" in out and "factorization residual" in out

    # debug bypasses the memo: a recompute re-measures both
    s.compute(x, yerr)
    assert s.factor_residual is not None
    assert s.compression_error is not None

    # the compression error is a real exact-vs-compressed comparison: at
    # a rank too low for the data it must report a visibly larger error
    s_low = HODLRSolver(kernel, min_size=64, rank=2, debug=True)
    s_low.compute(x, yerr)
    assert s_low.compression_error > 10 * s.compression_error

    # without debug, a memoized recompute stays cheap (no measurement)
    s2 = HODLRSolver(kernel, min_size=64, rank=32)
    s2.compute(x, yerr)
    s2.compute(x, yerr)
    assert s2.factor_residual is None
    assert s2.compression_error is None


def _lcm_data(n_per=500, T=2, Q=2, seed=0):
    rng = np.random.default_rng(seed)
    xs = np.sort(rng.uniform(0, 30.0, n_per * T))
    task = np.tile(np.arange(T), n_per).astype(float)
    x = np.column_stack([xs, task])
    logBK = np.log(rng.uniform(0.3, 1.5, 2 * T * Q))
    k = kernels.LCMKernel(
        logBK,
        children=[kernels.ExpSquaredKernel(2.0),
                  kernels.Matern32Kernel(1.0)],
        T=T, Q=Q, ndim=1,
    )
    y = rng.standard_normal(n_per * T)
    yerr = 0.3 * np.ones(n_per * T)
    return k, x, y, yerr


def test_hodlr_lcm_multitask_oracle():
    """LCM multi-output through the hierarchical solver vs the dense
    oracle (the fork's core workload: its ButterflyPACK path compresses
    LCM covariances, reference ``basic.py:80-118``). The solver must
    order on the SPATIAL axes only (``LCMKernel.sort_axes``): a
    task-major ordering makes coarse off-diagonal blocks full-domain
    cross-task kernel matrices, and accuracy stalls ~5e-4 regardless of
    rank; spatially interleaved it converges with rank."""
    k, x, y, yerr = _lcm_data()
    gpb = GP(k)
    gpb.compute(x, yerr)
    ll_true = gpb.log_likelihood(y)
    g_true = gpb.grad_log_likelihood(y)

    gph = GP(k, solver=HODLRSolver, min_size=64, rank=24)
    gph.compute(x, yerr)
    ll = gph.log_likelihood(y)
    assert abs(ll - ll_true) / abs(ll_true) < 1e-6
    g = gph.grad_log_likelihood(y)
    assert np.max(np.abs(g - g_true)) / np.max(np.abs(g_true)) < 1e-4

    # cross-task prediction parity at a handful of held-out points
    t = np.column_stack([np.linspace(1, 29, 40), np.ones(40)])
    mu_b, var_b = gpb.predict(y, t, return_var=True)
    mu_h, var_h = gph.predict(y, t, return_var=True)
    assert np.max(np.abs(mu_h - mu_b)) < 1e-5
    assert np.max(np.abs(var_h - var_b)) < 1e-5


def test_hmatrix_lcm_multitask_oracle():
    """Same task-label-aware ordering through the strong-admissibility
    solver: the task column must not enter box geometry/admissibility."""
    from george_tpu.solvers import HMatrixSolver

    k, x, y, yerr = _lcm_data(n_per=400)
    gpb = GP(k)
    gpb.compute(x, yerr)
    ll_true = gpb.log_likelihood(y)

    gph = GP(k, solver=HMatrixSolver, min_size=64, rank=24)
    gph.compute(x, yerr)
    ll = gph.log_likelihood(y)
    # SLQ logdet carries MC noise; the bound is the solver's documented
    # accuracy grade, not the HODLR exact-factorization grade
    assert abs(ll - ll_true) / abs(ll_true) < 1e-3


def test_check_fused_thetas_detects_regime_walk():
    """The fused ``log_prob_fn`` path is pure, so the per-compute
    self-check never sees sampler-proposed thetas; ``check_fused_thetas``
    is the post-hoc monitor. A chain walking a Polynomial-component
    amplitude from negligible to dominant must surface a warning (the
    reference's identical cascade returns silent garbage there,
    ``hodlr.h:707-711``); a benign chain must pass silently."""
    import warnings

    rng = np.random.default_rng(3)
    n = 256
    x = np.sort(rng.uniform(0, 10, n))
    y = np.sin(x) + 0.1 * rng.standard_normal(n)
    kernel = 1.2 * kernels.ExpSquaredKernel(2.0) + np.exp(-12.0) * (
        kernels.PolynomialKernel(log_sigma2=0.0, order=3)
    )
    gp = GP(kernel, solver=HODLRSolver, min_size=32, rank=24)
    gp.compute(x, 0.25)
    theta0 = gp.get_parameter_vector()

    # a benign "chain": small jitter around the computed theta
    good = theta0[None, :] + 0.05 * rng.standard_normal((40, len(theta0)))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rep = gp.check_fused_thetas(good, y, yerr=0.25)
    assert rep is not None and rep["ok"], rep["max"]
    assert not any("residual check" in str(w.message) for w in caught)

    # a regime walk: one tail of the chain pushes the polynomial
    # amplitude up until it dominates (non-decaying regime)
    bad = good.copy()
    amp_idx = list(gp.get_parameter_names()).index(
        "kernel:k2:k1:log_constant"
    )
    bad[-1, amp_idx] = 2.0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rep = gp.check_fused_thetas(bad, y, yerr=0.25)
    assert rep is not None and not rep["ok"]
    assert any("residual check" in str(w.message) for w in caught)

    # solvers without a fused residual monitor opt out cleanly
    gpb = GP(1.2 * kernels.ExpSquaredKernel(2.0), solver=BasicSolver)
    gpb.compute(x, 0.25)
    assert gpb.check_fused_thetas(good[:, :2], y, yerr=0.25) is None


def test_debug_gradient_comparison(capsys):
    """``debug=1`` at the GP layer mirrors the reference's exact-vs-
    estimated gradient report (reference ``gp.py:556-562``): the
    matrix-free (Hutchinson) gradient is printed next to a dense-exact
    one and both are stored on the GP."""
    x, y, yerr = _data(400)
    kernel = 1.2 * kernels.ExpSquaredKernel(2.0)
    gp = GP(kernel, solver=HODLRSolver, min_size=64, rank=32,
            grad_mode="hutchinson", num_probes=64, debug=True,
            verbose=True)
    gp.compute(x, yerr)
    g = gp.grad_log_likelihood(y)
    rep = gp.debug_gradient
    assert rep is not None
    np.testing.assert_allclose(rep["estimated"], g)

    # the "exact" column is the true dense gradient
    gpb = GP(1.2 * kernels.ExpSquaredKernel(2.0), solver=BasicSolver)
    gpb.compute(x, yerr)
    gb = gpb.grad_log_likelihood(y)
    np.testing.assert_allclose(rep["exact"], gb, rtol=1e-4, atol=1e-7)

    # the estimate tracks it to compression + MC accuracy
    scale = np.maximum(np.abs(rep["exact"]), 1.0)
    assert np.max(np.abs(rep["exact"] - rep["estimated"]) / scale) < 0.2

    out = capsys.readouterr().out
    assert "grad_exact" in out and "grad_estimated" in out
