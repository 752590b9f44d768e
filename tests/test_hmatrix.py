# -*- coding: utf-8 -*-
"""Strong-admissibility H-matrix solver tests (dense oracles, CPU f64).

The reference has no strong-admissibility code; these tests hold the new
solver to the same dense-oracle standard as the weak HODLR suite
(``tests/test_hodlr.py``) on the 2-D/3-D inputs it exists for.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from george_tpu import GP, kernels
from george_tpu.solvers import BasicSolver, HMatrixSolver
from george_tpu.solvers.hmatrix import (
    HMatrixStructure,
    hmatrix_compress,
    hmatrix_matvec,
    pcg_solve,
)
from george_tpu.neighbors import morton_sort_samples


def _setup(n=1200, d=2, seed=0, ell=1.5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 10, (n, d))
    y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)
    kernel = 1.0 * kernels.ExpSquaredKernel([ell] * d, ndim=d)
    yerr = 0.1 * np.ones(n)
    return x, y, kernel, yerr


def test_structure_partitions_all_pairs():
    """Every leaf-box pair lands in exactly one of {diag, near, far}."""
    x, _, _, _ = _setup(n=900, d=2)
    xs = x[morton_sort_samples(x)]
    hs = HMatrixStructure(900, xs, min_size=32, rank=8, eta=1.0)
    B = hs.B
    covered = np.zeros((B, B), dtype=int)
    np.fill_diagonal(covered, 1)
    for i in range(B):
        for q in range(hs.near_nbr.shape[1]):
            if hs.near_mask[i, q]:
                covered[i, hs.near_nbr[i, q]] += 1
    for lev in hs.far:
        s = lev["s"]
        leaves_per_box = s // hs.m
        for a, b in zip(lev["a"], lev["b"]):
            la = np.arange(a * leaves_per_box, (a + 1) * leaves_per_box)
            lb = np.arange(b * leaves_per_box, (b + 1) * leaves_per_box)
            covered[np.ix_(la, lb)] += 1
            covered[np.ix_(lb, la)] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("d", [1, 2, 3])
def test_hmatrix_matvec_matches_dense(d):
    n = 1000
    x, _, kernel, yerr = _setup(n=n, d=d)
    perm = morton_sort_samples(x)
    xs = x[perm]
    hs = HMatrixStructure(n, xs, min_size=32, rank=16, eta=1.0)
    xpad = np.concatenate(
        [xs, np.repeat(xs[-1:], hs.n_pad - n, axis=0)]
    )
    valid = np.zeros(hs.n_pad, dtype=bool)
    valid[:n] = True
    dpad = np.ones(hs.n_pad)
    dpad[:n] = yerr ** 2
    theta = jnp.asarray(kernel.parameter_vector)
    xj, vj, dj = map(jnp.asarray, (xpad, valid, dpad))
    far = hmatrix_compress(kernel.pair_fn, theta, xj, vj, hs)

    Kd = kernel.get_value(xs) + np.diag(yerr ** 2)
    rng = np.random.default_rng(3)
    V = rng.standard_normal((n, 3))
    Vp = np.zeros((hs.n_pad, 3))
    Vp[:n] = V
    out = np.asarray(
        hmatrix_matvec(kernel.pair_fn, theta, xj, vj, dj, hs, far,
                       jnp.asarray(Vp))
    )[:n]
    ref = Kd @ V
    assert np.max(np.abs(out - ref)) / np.max(np.abs(ref)) < 1e-6


def test_solver_protocol_vs_dense():
    n = 1200
    x, y, kernel, yerr = _setup(n=n, d=2)
    s = HMatrixSolver(kernel, min_size=64, rank=16, precond_rank=64)
    s.compute(x, yerr=yerr)
    Kd = kernel.get_value(x) + np.diag(yerr ** 2)

    # solve
    rng = np.random.default_rng(4)
    v = rng.standard_normal(n)
    z = s.apply_inverse(v)
    zref = np.linalg.solve(Kd, v)
    assert np.max(np.abs(z - zref)) / np.max(np.abs(zref)) < 1e-4

    # dot_solve + logdet
    assert abs(s.dot_solve(v) - v @ zref) / abs(v @ zref) < 1e-6
    ld_ref = np.linalg.slogdet(Kd)[1]
    assert abs(s.log_determinant - ld_ref) / abs(ld_ref) < 1e-4

    # apply_forward: K matvec and dK/dtheta matvec
    fwd = s.apply_forward(v, 0)
    assert np.max(np.abs(fwd - Kd @ v)) / np.max(np.abs(Kd @ v)) < 1e-6
    dK = kernel.get_gradient(x)                  # (n, n, p)
    for i in range(len(kernel.parameter_vector)):
        got = s.apply_forward(v, i + 1)
        ref = dK[:, :, i] @ v
        scale = max(np.max(np.abs(ref)), 1e-12)
        assert np.max(np.abs(got - ref)) / scale < 1e-5


def test_gp_loglike_and_predict_vs_basic():
    n = 1100
    x, y, kernel, yerr = _setup(n=n, d=2)
    gp_b = GP(kernel, solver=BasicSolver)
    gp_b.compute(x, yerr=yerr)
    lb = gp_b.log_likelihood(y)

    gp_h = GP(kernel, solver=HMatrixSolver, min_size=64, rank=16,
              precond_rank=64)
    gp_h.compute(x, yerr=yerr)
    lh = gp_h.log_likelihood(y)
    assert abs(lh - lb) / abs(lb) < 1e-4

    t = np.random.default_rng(7).uniform(0, 10, (50, 2))
    mu_b, var_b = gp_b.predict(y, t, return_var=True)
    mu_h, var_h = gp_h.predict(y, t, return_var=True)
    assert np.max(np.abs(mu_h - mu_b)) < 1e-4 * max(1.0, np.max(np.abs(mu_b)))
    assert np.max(np.abs(var_h - var_b)) < 1e-4


def test_gp_gradient_hutchinson_tracks_exact():
    n = 1000
    x, y, kernel, yerr = _setup(n=n, d=2)
    gp_b = GP(kernel, solver=BasicSolver)
    gp_b.compute(x, yerr=yerr)
    gb = gp_b.grad_log_likelihood(y)

    gp_h = GP(kernel, solver=HMatrixSolver, min_size=64, rank=16,
              precond_rank=64, num_probes=32)
    gp_h.compute(x, yerr=yerr)
    gh = gp_h.grad_log_likelihood(y)
    # stochastic trace term: hold to ~10% of the gradient scale
    # (matches the sparse solver's Hutchinson tolerance)
    assert np.max(np.abs(gh - gb)) / np.max(np.abs(gb)) < 0.1


def test_grad_deflation_slashes_mc_noise():
    """Hutch++-style deflation: on 1-D data the FPS-column basis captures
    the kernel's whole smooth subspace, so the gradient's stochastic
    trace term collapses from O(10%) of the gradient scale to ~1e-5 at
    the SAME probe count (measured 0.17-0.20 -> ~1e-5 across seeds)."""
    rng = np.random.default_rng(0)
    n = 1200
    x = rng.uniform(0, 30.0, (n, 1))
    y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)
    kernel = 1.0 * kernels.ExpSquaredKernel(4.0)

    gp_b = GP(kernel, solver=BasicSolver)
    gp_b.compute(x, 0.1)
    gb = gp_b.grad_log_likelihood(y)
    scale = np.max(np.abs(gb))

    errs = {}
    for defl in (0, 64):
        gp_h = GP(kernel, solver=HMatrixSolver, num_probes=16,
                  grad_deflation_rank=defl)
        gp_h.compute(x, 0.1)
        gh = gp_h.grad_log_likelihood(y)
        errs[defl] = np.max(np.abs(gh - gb)) / scale
    assert errs[64] < 1e-3
    assert errs[64] < 0.1 * max(errs[0], 1e-12)


def test_grad_deflation_auto_rank_2d():
    """``grad_deflation_rank="auto"`` ties the deflation basis to the
    Nystrom spectrum. On 2-D data the kernel's effective rank grows like
    (domain/lengthscale)^2, so the old fixed rank-64 basis captured only
    a slice of the trace variance (measured ~2x noise reduction);
    resolving the rank from the captured-energy threshold recovers the
    order-of-magnitude win 1-D always had (commit-measured ~30x at the
    effective rank). n >= 1e4 so the effective rank actually exceeds the
    old fixed default."""
    n = 10_000
    x, y, kernel, yerr = _setup(n=n, d=2)
    gp_b = GP(kernel, solver=BasicSolver)
    gp_b.compute(x, yerr=yerr)
    gb = gp_b.grad_log_likelihood(y)
    scale = np.max(np.abs(gb))

    errs = {}
    for defl in (0, "auto"):
        gp_h = GP(kernel, solver=HMatrixSolver, num_probes=16,
                  nystrom_rank=512, grad_deflation_rank=defl)
        gp_h.compute(x, yerr=yerr)
        gh = gp_h.grad_log_likelihood(y)
        errs[defl] = np.max(np.abs(gh - gb)) / scale
    # auto must resolve a rank past the old fixed 64 default
    q = gp_h.solver._grad_deflation_basis()
    assert q.shape[1] > 64
    # and the trace noise must collapse relative to the plain estimator
    assert errs["auto"] < 0.2 * max(errs[0], 1e-12)


def test_grad_deflation_auto_warns_when_rank_starved():
    """When even the full Nystrom basis captures less than the energy
    threshold, the auto mode warns (the deflation is rank-starved and
    nystrom_rank is the knob) instead of silently underdelivering."""
    import warnings

    n = 4000
    x, y, kernel, yerr = _setup(n=n, d=2)
    gp_h = GP(kernel, solver=HMatrixSolver, num_probes=4,
              nystrom_rank=16, grad_deflation_rank="auto")
    gp_h.compute(x, yerr=yerr)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        gp_h.grad_log_likelihood(y)
    assert any("rank-starved" in str(w.message) for w in rec)


def test_strong_beats_weak_at_equal_rank():
    """The point of the solver: at the same skeleton rank, the strong
    partition is orders of magnitude more accurate on 2-D data."""
    from george_tpu.solvers import HODLRSolver

    n = 1500
    x, y, kernel, yerr = _setup(n=n, d=2)
    gp_b = GP(kernel, solver=BasicSolver)
    gp_b.compute(x, yerr=yerr)
    lb = gp_b.log_likelihood(y)

    gp_w = GP(kernel, solver=HODLRSolver, min_size=32, rank=16)
    gp_w.compute(x, yerr=yerr)
    err_weak = abs(gp_w.log_likelihood(y) - lb) / abs(lb)

    gp_s = GP(kernel, solver=HMatrixSolver, min_size=32, rank=16,
              precond_rank=64)
    gp_s.compute(x, yerr=yerr)
    err_strong = abs(gp_s.log_likelihood(y) - lb) / abs(lb)

    assert err_strong < 1e-4
    assert err_strong < 0.1 * err_weak


def test_general_metric_loglike_and_grad():
    """General (log-Cholesky) metric through the strong solver: the
    likelihood holds to the dense oracle, and the Hutchinson gradient
    converges toward the exact dense gradient as probes grow (the
    ~1e-1 deviation at the default 16 probes is Monte-Carlo noise, not
    structure — this pins that)."""
    rng = np.random.default_rng(0)
    n = 400
    x = rng.uniform(0, 8, (n, 2))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(n)

    def kern():
        return 1.0 * kernels.ExpSquaredKernel(
            metric=[[1.0, 0.3], [0.3, 0.8]], ndim=2
        )

    gp_b = GP(kern())
    gp_b.compute(x, 0.2)
    lb = gp_b.log_likelihood(y)
    gb = gp_b.grad_log_likelihood(y)

    gp_h = GP(kern(), solver=HMatrixSolver, min_size=32, rank=16,
              num_probes=256)
    gp_h.compute(x, 0.2)
    assert abs(gp_h.log_likelihood(y) - lb) / abs(lb) < 1e-4
    gh = gp_h.grad_log_likelihood(y)
    # error relative to the GRADIENT SCALE, not per-component: the
    # trace term is a Monte-Carlo estimate whose absolute noise is set
    # by the whole spectrum, so a component 12x smaller than the others
    # carries proportionally larger relative noise by construction
    assert np.max(np.abs(gh - gb)) / np.max(np.abs(gb)) < 2e-2


def test_pcg_solve_identity_precond():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((40, 80))
    A = A @ A.T / 80 + np.eye(40)
    b = rng.standard_normal(40)
    x, iters = pcg_solve(
        lambda v: jnp.asarray(A) @ v, lambda r: r, jnp.asarray(b),
        tol=1e-12,
    )
    assert np.allclose(np.asarray(x), np.linalg.solve(A, b), atol=1e-8)


def test_f32_nystrom_path_subprocess():
    """The f32 (accelerator) branch — Nystrom preconditioner + sandwich SLQ —
    runs in a subprocess because the suite pins float64 globally. Holds
    the f32 path to dense-oracle accuracy at its working precision.
    (Regression for the f32 instability of the weak hierarchical
    cascades, which this branch exists to avoid.)"""
    import os
    import subprocess
    import sys

    script = r"""
import numpy as np, jax
jax.config.update("jax_platforms", "cpu")
from george_tpu import kernels
from george_tpu.solvers import HMatrixSolver
rng = np.random.default_rng(3)
n = 1500
x = rng.uniform(0, 10, (n, 2))
y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)
k = 1.0 * kernels.ExpSquaredKernel([1.5, 1.5], ndim=2)
s = HMatrixSolver(k, min_size=64, rank=16, nystrom_rank=192)
s.compute(x, yerr=0.1 * np.ones(n))
Kd = np.asarray(k.get_value(x), dtype=np.float64) + np.diag(0.01 * np.ones(n))
ld_ref = np.linalg.slogdet(Kd)[1]
v = rng.standard_normal(n)
zref = np.linalg.solve(Kd, v)
z = s.apply_inverse(v)
rel = np.max(np.abs(z - zref)) / np.max(np.abs(zref))
# elementwise solve error floors at cond(K) * eps_f32 (~1e-2 here)
assert rel < 5e-2, ("solve", rel)
# the likelihood-relevant scalars are far tighter
drel = abs(s.dot_solve(v) - v @ zref) / abs(v @ zref)
assert drel < 1e-3, ("dot_solve", drel)
ldrel = abs(s.log_determinant - ld_ref) / abs(ld_ref)
assert ldrel < 5e-3, ("logdet", ldrel)
print("F32 OK", rel, drel, ldrel)
"""
    env = dict(os.environ)
    env.pop("JAX_ENABLE_X64", None)
    out = subprocess.run(
        [sys.executable, "-c", script], env=env, capture_output=True,
        text=True, timeout=900,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "F32 OK" in out.stdout


def test_hmatrix_fused_loglike_and_grad():
    """The fused strong-admissibility likelihood matches the host path
    at compute-theta (same probes/preconditioner), and jax.grad of it
    matches the exact dense gradient to Monte-Carlo accuracy."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(6)
    n = 900
    x = rng.uniform(0, 8, (n, 2))
    y = np.sin(x[:, 0]) * np.cos(0.7 * x[:, 1]) \
        + 0.1 * rng.standard_normal(n)
    yerr = 0.2 * np.ones(n)

    def kern():
        return 1.0 * kernels.ExpSquaredKernel([1.2, 1.2], ndim=2)

    gp = GP(kern(), solver=HMatrixSolver, min_size=32, rank=12,
            num_probes=96, num_steps=20)
    gp.compute(x, yerr=yerr)
    ll_host = gp.log_likelihood(y)

    f = gp.log_prob_fn(x, y, 0.2, gate_prior=False)
    theta = jnp.asarray(gp.get_parameter_vector())
    assert np.isclose(float(f(theta)), ll_host, rtol=1e-8)

    g = np.asarray(jax.grad(f)(theta))
    assert np.all(np.isfinite(g))
    gp_exact = GP(kern(), solver=BasicSolver)
    gp_exact.compute(x, yerr=yerr)
    g_ref = gp_exact.grad_log_likelihood(y)
    scale = np.abs(g_ref).max()
    assert np.allclose(g, g_ref, atol=0.1 * scale), (g, g_ref)

    # away from compute-theta the frozen-preconditioner identity stays
    # exact for the quadratic term and unbiased for the logdet: the
    # value must track the exact likelihood within SLQ noise
    th2 = theta + jnp.asarray([0.15, -0.1, 0.1])
    gp_exact.set_parameter_vector(np.asarray(th2))
    ll2_exact = gp_exact.log_likelihood(y)
    assert abs(float(f(th2)) - ll2_exact) / abs(ll2_exact) < 2e-3


def test_hmatrix_apply_sqrt_lanczos():
    """apply_sqrt is a symmetric square root of (K + diag): applying it
    twice reproduces the compressed matvec; gp.sample works."""
    rng = np.random.default_rng(21)
    n = 600
    x = rng.uniform(0, 6, (n, 2))
    gp = GP(1.0 * kernels.ExpSquaredKernel([1.0, 1.0], ndim=2),
            solver=HMatrixSolver, min_size=32, rank=12)
    gp.compute(x, 0.3)

    v = rng.standard_normal(n)
    Sv = gp.solver.apply_sqrt(v, num_steps=60)
    SSv = gp.solver.apply_sqrt(Sv, num_steps=60)
    Kv = np.asarray(gp.solver.apply_forward(v))
    scale = np.abs(Kv).max()
    assert np.allclose(SSv, Kv, atol=1e-5 * scale), (
        np.abs(SSv - Kv).max(), scale
    )

    s = gp.sample(size=2)
    assert s.shape == (2, n)
    assert np.all(np.isfinite(s))


def test_deep_tree_depth_aware_rank_and_auto_nystrom():
    """Round-5 regression: at deeper trees the FIXED far rank starved the
    coarse interaction pairs (6.3e-2 ll error at n=16000) and the fixed
    rank-256 Nystrom whitener left a +1615-nat SLQ logdet bias. The
    boundary-law depth-aware rank plus the auto-scaled whitener must
    hold the likelihood to dense-oracle accuracy on a tree DEEP enough
    that both defaults matter (min_size=32 -> several far levels with
    growing rank; auto nystrom > 256)."""
    n = 6000
    rng = np.random.default_rng(11)
    # domain scaled with n like the 2-D bench protocol, so coarse far
    # pairs carry real coupling energy
    x = rng.uniform(0, 12.0 * np.sqrt(n / 2000.0), (n, 2))
    y = np.sin(x[:, 0]) * np.cos(0.7 * x[:, 1]) + 0.1 * rng.standard_normal(n)
    yerr = 0.1 * np.ones(n)
    kernel_of = lambda: 1.0 * kernels.ExpSquaredKernel(  # noqa: E731
        [1.5, 1.5], ndim=2)

    gp_b = GP(kernel_of(), solver=BasicSolver)
    gp_b.compute(x, yerr=yerr)
    lb = gp_b.log_likelihood(y)

    gp_h = GP(kernel_of(), solver=HMatrixSolver, min_size=32, rank=12)
    gp_h.compute(x, yerr=yerr)
    hs = gp_h.solver._hs
    # the defaults actually engaged: per-depth ranks grow toward the
    # root and the whitener auto-scaled past the old fixed 256
    cs = [lev["c"] for lev in hs.far]
    assert max(cs) > min(cs)
    assert gp_h.solver.nystrom_rank_effective > 256
    lh = gp_h.log_likelihood(y)
    assert abs(lh - lb) / abs(lb) < 1e-4
