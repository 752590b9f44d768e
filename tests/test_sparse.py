# -*- coding: utf-8 -*-
"""Compact-support sparse solver tests: exact matvec/solve against the
dense oracle, stochastic logdet/gradient within estimator tolerance (the
reference fork's sparse + Hutchinson paths had NO tests — SURVEY.md §4)."""

import numpy as np
import pytest

import jax.numpy as jnp

from george_tpu import GP, kernels
from george_tpu.solvers import BasicSolver, SparseSolver


def _sparse_problem(n=300, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 40, n))[:, None]
    yerr = 0.3 * np.ones(n)
    y = np.sin(x[:, 0]) + 0.3 * rng.standard_normal(n)
    base = 1.2 * kernels.ExpSquaredKernel(2.0)
    kernel = kernels.WendlandC2Kernel(log_rc=np.log(4.0), kernel_base=base)
    return x, y, yerr, kernel


def _dense(kernel, x, yerr):
    K = kernel.get_value(x)
    K[np.diag_indices_from(K)] += yerr ** 2
    return K


def test_sparse_matvec_and_solve_exact():
    x, y, yerr, kernel = _sparse_problem()
    K = _dense(kernel, x, yerr)
    s = SparseSolver(kernel)
    s.compute(x, yerr)
    assert s.nnz < 0.3 * len(x) ** 2  # actually sparse
    v = np.random.default_rng(1).standard_normal(len(x))
    assert np.allclose(s.apply_forward(v), K @ v, atol=1e-10)
    a = s.apply_inverse(y)
    assert np.allclose(a, np.linalg.solve(K, y), atol=1e-7)
    assert np.isclose(s.dot_solve(y), y @ np.linalg.solve(K, y), rtol=1e-8)


def test_sparse_gradient_matvec_exact():
    x, y, yerr, kernel = _sparse_problem()
    Kg = kernel.get_gradient(x, include_frozen=True)
    s = SparseSolver(kernel)
    s.compute(x, yerr)
    v = np.random.default_rng(2).standard_normal(len(x))
    for i in range(Kg.shape[2]):
        assert np.allclose(
            s.apply_forward(v, i + 1), Kg[:, :, i] @ v, atol=1e-10
        )


def test_sparse_slq_logdet():
    x, y, yerr, kernel = _sparse_problem()
    K = _dense(kernel, x, yerr)
    _, ld_true = np.linalg.slogdet(K)
    s = SparseSolver(kernel, num_probes=32, num_steps=40,
                     direct=False)  # pin SLQ: this test guards the estimator
    s.compute(x, yerr)
    assert abs(s.log_determinant - ld_true) / abs(ld_true) < 0.03


def test_sparse_gp_likelihood_and_gradient():
    """GP on the sparse path tracks the exact path within estimator noise
    (reference Regime B is stochastic by design, ``gp.py:506-562``)."""
    x, y, yerr, kernel = _sparse_problem()
    gp_s = GP(kernel, solver=SparseSolver, num_probes=64, num_steps=40,
              direct=False)  # pin Hutchinson gradients
    gp_s.compute(x, yerr)
    x2, y2, yerr2, kernel2 = _sparse_problem()
    gp_d = GP(kernel2, solver=BasicSolver)
    gp_d.compute(x2, yerr2)

    ll_s = gp_s.log_likelihood(y)
    ll_d = gp_d.log_likelihood(y2)
    assert abs(ll_s - ll_d) / abs(ll_d) < 0.02

    g_s = gp_s.grad_log_likelihood(y)
    g_d = gp_d.grad_log_likelihood(y2)
    # quadratic (alpha) terms are exact; trace terms are Hutchinson
    assert np.allclose(g_s, g_d, rtol=0.15, atol=0.5)


def test_sparse_explicit_radius_and_nns():
    """An explicit radius (or precomputed CSR nns) drives the sparsity
    pattern — the fork's ``compute(x, nns, yerr)`` surface, restored as a
    keyword (``gp.py:304`` vs SURVEY.md §4 breakage note)."""
    from george_tpu.neighbors import radius_neighbors_csr

    rng = np.random.default_rng(3)
    n = 200
    x = np.sort(rng.uniform(0, 20, n))[:, None]
    yerr = 0.4 * np.ones(n)
    y = rng.standard_normal(n)
    kernel = 1.0 * kernels.ExpSquaredKernel(0.1)

    nns = radius_neighbors_csr(x, 2.0)
    s = SparseSolver(kernel, radius=2.0)
    s.compute(x, yerr, nns=nns)
    # short lengthscale: truncation negligible
    K = _dense(kernel, x, yerr)
    assert np.allclose(s.apply_inverse(y), np.linalg.solve(K, y), atol=1e-5)


def test_sparse_mesh_sharded_matches_unsharded():
    """Row-sharded solver over the device mesh: identical matvecs/solves
    (XLA inserts the gather/reduction collectives) — the in-tree
    stand-in for the reference's MPI sparse distribution."""
    import jax

    if len(jax.devices()) < 2:
        import pytest

        pytest.skip("needs a multi-device mesh")

    rng = np.random.default_rng(7)
    n = 403  # deliberately not divisible by the device count
    x = np.sort(rng.uniform(0, 40, n))[:, None]
    yerr = 0.3 * np.ones(n)
    y = np.sin(x[:, 0]) + 0.3 * rng.standard_normal(n)
    base = 1.2 * kernels.ExpSquaredKernel(2.0)
    kernel = kernels.WendlandC2Kernel(log_rc=np.log(4.0), kernel_base=base)

    s0 = SparseSolver(kernel)
    s0.compute(x, yerr)
    mesh = jax.sharding.Mesh(np.array(jax.devices()), ("data",))
    s1 = SparseSolver(kernel, mesh=mesh)
    s1.compute(x, yerr)

    assert np.allclose(s0.apply_inverse(y), s1.apply_inverse(y), atol=1e-8)
    v = rng.standard_normal(n)
    assert np.allclose(s0.apply_forward(v), s1.apply_forward(v))
    assert np.allclose(s0.apply_forward(v, 1), s1.apply_forward(v, 1))
    rel = abs(s0.log_determinant - s1.log_determinant) / abs(
        s0.log_determinant
    )
    assert rel < 0.05  # SLQ probe streams differ on the padded system


def test_sparse_get_inverse_unpadded_shape():
    """get_inverse must return (n, n) even when mesh padding rows were
    added (regression: the identity was built at the padded size, leaving
    pad columns in the result)."""
    import jax

    if len(jax.devices()) < 2:
        import pytest

        pytest.skip("needs a multi-device mesh")

    x, y, yerr, kernel = _sparse_problem(n=203)  # not divisible by ndev
    mesh = jax.sharding.Mesh(np.array(jax.devices()), ("data",))
    s = SparseSolver(kernel, mesh=mesh)
    s.compute(x, yerr)
    Kinv = s.get_inverse()
    assert Kinv.shape == (203, 203)
    K = _dense(kernel, x, yerr)
    assert np.allclose(Kinv @ K, np.eye(203), atol=1e-5)


def test_banded_dia_path_matches_ell():
    """Sorted-1-D radius neighborhoods are contiguous: the solver takes
    the gather-free DIA path and must agree exactly with the ELL form."""
    from george_tpu.solvers.sparse import (
        banded_offsets, banded_ell_tables, dia_apply, ell_apply,
        ell_values, ell_from_csr,
    )
    from george_tpu.neighbors import radius_neighbors_csr

    rng = np.random.default_rng(2)
    n = 400
    x = np.sort(rng.uniform(0, 40, n))[:, None]
    idx, ptr = radius_neighbors_csr(x, 1.5)
    band = banded_offsets(idx, ptr)
    assert band is not None
    offsets, lo, hi = band

    k = kernels.WendlandC2Kernel(
        log_rc=np.log(1.5), kernel_base=kernels.ExpSquaredKernel(0.5)
    )
    theta = jnp.asarray(k.parameter_vector)
    xj = jnp.asarray(x)
    diag = 0.01 * jnp.ones(n)
    Y = jnp.asarray(rng.standard_normal((n, 3)))

    nbr_d, mask_d = banded_ell_tables(offsets, lo, hi, n)
    vals_d = ell_values(k.pair_fn, theta, xj, jnp.asarray(nbr_d),
                        jnp.asarray(mask_d))
    out_dia = dia_apply(vals_d, offsets, diag, Y)

    nbr_e, mask_e = ell_from_csr(idx, ptr)
    vals_e = ell_values(k.pair_fn, theta, xj, jnp.asarray(nbr_e),
                        jnp.asarray(mask_e))
    out_ell = ell_apply(vals_e, jnp.asarray(nbr_e), diag, Y)
    assert np.allclose(np.asarray(out_dia), np.asarray(out_ell),
                       rtol=1e-12, atol=1e-12)

    # 2-D Morton-ish data is NOT banded -> detection declines
    x2 = rng.uniform(0, 10, (300, 2))
    idx2, ptr2 = radius_neighbors_csr(x2, 1.0)
    assert banded_offsets(idx2, ptr2) is None


def test_sparse_solver_banded_equals_reference_solve():
    """End-to-end: the solver on sorted-1-D data (DIA path active) still
    reproduces the dense solve."""
    rng = np.random.default_rng(3)
    n = 300
    x = np.sort(rng.uniform(0, 25, n))
    y = rng.standard_normal(n)
    k = 1.0 * kernels.WendlandC2Kernel(
        log_rc=np.log(2.0), kernel_base=kernels.ExpSquaredKernel(0.5)
    )
    solver = SparseSolver(k, direct=False)  # pin the DIA CG path
    solver.compute(x, 0.5)
    assert solver._dia_offsets is not None
    z = solver.apply_inverse(y)
    Kd = k.get_value(np.atleast_2d(x).T) + 0.25 * np.eye(n)
    z_ref = np.linalg.solve(Kd, y)
    assert np.allclose(z, z_ref, rtol=1e-6, atol=1e-8)


def test_sparse_fused_loglike_and_grad():
    """The fused sparse likelihood (CG via custom_linear_solve + CRN
    SLQ logdet with a Hutchinson-adjoint custom_vjp) matches the
    solver's host-path log_likelihood, and jax.grad of it matches the
    exact dense gradient to Monte-Carlo accuracy."""
    import jax

    rng = np.random.default_rng(9)
    n = 250
    x = np.sort(rng.uniform(0, 20, n))
    y = np.sin(x) + 0.1 * rng.standard_normal(n)

    def kern():
        return 1.0 * kernels.WendlandC2Kernel(
            log_rc=np.log(2.0), kernel_base=kernels.ExpSquaredKernel(0.5)
        )

    gp = GP(kern(), solver=SparseSolver, num_probes=128, num_steps=40,
            direct=False)  # pin the CG+SLQ fused program
    gp.compute(x, 0.3)
    ll_host = gp.log_likelihood(y)

    f = gp.log_prob_fn(x, y, 0.3, gate_prior=False)
    theta = jnp.asarray(gp.get_parameter_vector())
    ll_fused = float(f(theta))
    # identical SLQ probes/steps -> identical estimate up to fp noise
    assert np.isclose(ll_fused, ll_host, rtol=1e-8)

    g = np.asarray(jax.grad(f)(theta))
    assert np.all(np.isfinite(g))
    # exact reference: dense solver gradient (the quad term is exact via
    # implicit differentiation; only the trace term carries MC error)
    gp_exact = GP(kern(), solver=BasicSolver)
    gp_exact.compute(x, 0.3)
    g_ref = gp_exact.grad_log_likelihood(y)
    scale = np.abs(g_ref).max()
    assert np.allclose(g, g_ref, atol=0.1 * scale), (g, g_ref)


def test_banded_offsets_rejects_duplicate_csr():
    """A user CSR with duplicate neighbor indices passes the naive
    max-min+1 == count test but describes a different matrix — the
    banded detection must decline it (regression for a silent-wrong-
    matrix bug)."""
    from george_tpu.solvers.sparse import banded_offsets

    # row 0: [0, 1]; row 1: [1, 1, 3] (duplicate; span 3 == count 3)
    nbr_idx = np.array([0, 1, 1, 1, 3, 2, 3], dtype=np.int64)
    row_ptr = np.array([0, 2, 5, 7], dtype=np.int64)
    assert banded_offsets(nbr_idx, row_ptr) is None

    # the clean version of the same shape is accepted
    nbr_idx = np.array([0, 1, 1, 2, 3, 2, 3], dtype=np.int64)
    row_ptr = np.array([0, 2, 5, 7], dtype=np.int64)
    assert banded_offsets(nbr_idx, row_ptr) is not None


def test_sparse_fused_pdiag_boundary_rows():
    """The fused likelihood's Jacobi preconditioner must read k(x0, x0)
    for boundary rows on the banded path (regression: clipped
    out-of-band slots also point at row 0 and argmax over nbr alone
    landed on a masked zero slot, wrecking CG conditioning for tiny
    noise)."""
    import jax

    rng = np.random.default_rng(12)
    n = 200
    x = np.sort(rng.uniform(0, 15, n))
    y = np.sin(x)
    k = 1.0 * kernels.WendlandC2Kernel(
        log_rc=np.log(2.0), kernel_base=kernels.ExpSquaredKernel(0.5)
    )
    gp = GP(k, solver=SparseSolver, num_probes=64, num_steps=30,
            direct=False)  # pin the boundary-row pdiag regression path
    gp.compute(x, 0.4)
    assert gp.solver._dia_offsets is not None
    f = gp.log_prob_fn(x, y, 0.4, gate_prior=False)
    theta = jnp.asarray(gp.get_parameter_vector())
    assert np.isclose(float(f(theta)), gp.log_likelihood(y), rtol=1e-8)


def test_sparse_apply_sqrt_lanczos():
    """apply_sqrt on the ITERATIVE path is a symmetric square root:
    applying it twice reproduces (K + diag) v; gp.sample draws finite
    prior samples.  (``direct=False`` pins the Lanczos implementation —
    the banded direct path uses the triangular factor instead, tested in
    ``test_sparse_direct_banded``.)"""
    rng = np.random.default_rng(15)
    n = 220
    x = np.sort(rng.uniform(0, 18, n))
    k = 1.0 * kernels.WendlandC2Kernel(
        log_rc=np.log(2.0), kernel_base=kernels.ExpSquaredKernel(0.6)
    )
    gp = GP(k, solver=SparseSolver, direct=False)
    gp.compute(x, 0.3)

    v = rng.standard_normal(n)
    Sv = gp.solver.apply_sqrt(v, num_steps=60)
    SSv = gp.solver.apply_sqrt(Sv, num_steps=60)
    Kv = np.asarray(gp.solver.apply_forward(v))
    scale = np.abs(Kv).max()
    assert np.allclose(SSv, Kv, atol=1e-6 * scale), (
        np.abs(SSv - Kv).max(), scale
    )

    s = gp.sample(size=3)
    assert s.shape == (3, n)
    assert np.all(np.isfinite(s))


def test_gp_compute_accepts_ragged_nns():
    """BallTree.query_radius-style ragged neighbor listings are accepted
    end-to-end: GP.compute -> SparseSolver (reference trigger surface,
    ``kernels.py:131-144`` there)."""
    rng = np.random.default_rng(11)
    n = 120
    x = np.sort(rng.uniform(0, 10, n))
    y = np.sin(x) + 0.1 * rng.standard_normal(n)
    rc = 1.5
    k = kernels.WendlandC2Kernel(
        log_rc=np.log(rc), kernel_base=kernels.ExpSquaredKernel(metric=1.0)
    )
    ragged = np.array(
        [np.flatnonzero(np.abs(x - xi) < rc) for xi in x], dtype=object
    )

    gp_r = GP(k, solver=SparseSolver)
    gp_r.compute(x, 0.1, nns=ragged)
    gp_c = GP(k, solver=SparseSolver)
    gp_c.compute(x, 0.1)
    assert np.isfinite(gp_r.log_likelihood(y))
    np.testing.assert_allclose(
        gp_r.log_likelihood(y), gp_c.log_likelihood(y), rtol=1e-10
    )

    # rectangular kNN-matrix form (with -1 padding) is accepted too;
    # with enough neighbors to cover the compact support, the
    # symmetrized pattern reproduces the radius result exactly
    kcap = 48
    knn = np.full((n, kcap), -1, dtype=np.int64)
    for i in range(n):
        idx = np.argsort(np.abs(x - x[i]))[:kcap]
        knn[i, : len(idx)] = idx
    gp_k = GP(k, solver=SparseSolver)
    gp_k.compute(x, 0.1, nns=knn)
    np.testing.assert_allclose(
        gp_k.log_likelihood(y), gp_c.log_likelihood(y), rtol=1e-8
    )


def test_sparse_direct_banded():
    """The banded direct path (block-tridiagonal Cholesky,
    ``solvers/banded.py``) is EXACT: log-likelihood, gradient, fused
    log_prob_fn value+grad, solves, and the triangular square root all
    match the dense solver to near machine precision — the in-tree
    sparse-direct semantics of the reference's SuperLU backend
    (``basic.py:177,206,258`` there)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(21)
    n = 500
    x = np.sort(rng.uniform(0, 25, n))
    y = np.sin(x) + 0.1 * rng.standard_normal(n)
    k = kernels.WendlandC2Kernel(
        log_rc=np.log(1.5), kernel_base=kernels.ExpSquaredKernel(metric=1.0)
    )

    gp = GP(k, solver=SparseSolver)
    gp.compute(x, 0.1)
    assert gp.solver._direct_loglike is not None, "direct path not taken"

    gpb = GP(k, solver=BasicSolver)
    gpb.compute(x, 0.1)

    np.testing.assert_allclose(
        gp.log_likelihood(y), gpb.log_likelihood(y), rtol=1e-10
    )
    np.testing.assert_allclose(
        gp.solver.log_determinant, gpb.solver.log_determinant, rtol=1e-10
    )
    np.testing.assert_allclose(
        gp.grad_log_likelihood(y), gpb.grad_log_likelihood(y),
        rtol=1e-7, atol=1e-9,
    )

    # fused sampler surface: exact value AND exact jax.grad
    f = gp.log_prob_fn(x, y, 0.1, gate_prior=False)
    theta = jnp.asarray(gp.get_parameter_vector())
    np.testing.assert_allclose(
        float(f(theta)), gpb.log_likelihood(y), rtol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(jax.grad(f)(theta)), gpb.grad_log_likelihood(y),
        rtol=1e-7, atol=1e-9,
    )

    # solves and the BasicSolver apply_sqrt contract R^T R = K + diag
    K = gpb.get_matrix(x) + np.diag(0.01 * np.ones(n))
    v = rng.standard_normal(n)
    np.testing.assert_allclose(
        gp.solver.apply_inverse(v), np.linalg.solve(K, v), atol=1e-9
    )
    R = gp.solver.apply_sqrt(np.eye(n))
    np.testing.assert_allclose(R.T @ R, K, atol=1e-9)

    # opting out restores the iterative machinery
    gpi = GP(k, solver=SparseSolver, direct=False)
    gpi.compute(x, 0.1)
    assert gpi.solver._direct_loglike is None

    # direct=True on a non-banded structure must refuse loudly
    x2 = rng.uniform(0, 10, (64, 2))
    k2 = kernels.WendlandC2Kernel(
        log_rc=np.log(2.0),
        kernel_base=kernels.ExpSquaredKernel(metric=[1.0, 1.0], ndim=2),
        ndim=2,
    )
    with pytest.raises(ValueError):
        s = SparseSolver(k2, direct=True)
        s.compute(x2, 0.1)
