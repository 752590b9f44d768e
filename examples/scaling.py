# -*- coding: utf-8 -*-
"""Large-N example (the reference's ``docs/tutorials/scaling.rst`` +
hodlr tutorial): the hierarchical solver against the exact one, and the
compact-support sparse path.

Run on CPU: ``python examples/scaling.py [n]``
"""

import sys

import numpy as np

import jax

if jax.default_backend() == "cpu":
    jax.config.update("jax_enable_x64", True)

from george_tpu import GP, kernels, HODLRSolver, SparseSolver


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
    rng = np.random.default_rng(1234)
    x = np.sort(rng.uniform(0, 100, n))
    yerr = 0.3
    y = np.sin(0.5 * x) + yerr * rng.standard_normal(n)

    kernel = 1.0 * kernels.ExpSquaredKernel(4.0) + 0.3 * (
        kernels.Matern32Kernel(2.0)
    )

    gp_h = GP(1.0 * kernels.ExpSquaredKernel(4.0)
              + 0.3 * kernels.Matern32Kernel(2.0),
              solver=HODLRSolver, min_size=64, rank=48)
    gp_h.compute(x, yerr)
    ll_h = gp_h.log_likelihood(y)
    print("HODLR   log-likelihood: {0:.4f}".format(ll_h))

    if n <= 4000:
        gp_b = GP(kernel)
        gp_b.compute(x, yerr)
        ll_b = gp_b.log_likelihood(y)
        print("exact   log-likelihood: {0:.4f}  (|diff| = {1:.2e})".format(
            ll_b, abs(ll_b - ll_h)
        ))
        # f64 (CPU): solver parity to ~1e-7. f32 accelerators: BOTH
        # solvers carry ~1e-4-level rounding, so their DIFFERENCE sits
        # at the f32 floor (~1e-4 at n=1200)
        tol = 1e-4 if jax.config.jax_enable_x64 else 5e-4
        assert abs(ll_b - ll_h) / abs(ll_b) < tol

    # compact support: Wendland-tapered kernel + sparse solver. Sorted
    # 1-D data is banded, so this factors EXACTLY (block-tridiagonal
    # Cholesky, solvers/banded.py) — the sparse-direct semantics of the
    # reference's SuperLU backend, no CG/SLQ noise.
    tapered = kernels.WendlandC2Kernel(
        log_rc=np.log(8.0),
        kernel_base=1.0 * kernels.ExpSquaredKernel(4.0),
    )
    gp_s = GP(tapered, solver=SparseSolver)
    gp_s.compute(x, yerr)
    ll_s = gp_s.log_likelihood(y)
    print("sparse  log-likelihood: {0:.4f}  (nnz fraction {1:.3f}, "
          "direct={2})".format(
              ll_s, gp_s.solver.nnz / n ** 2,
              gp_s.solver._direct_loglike is not None,
          ))
    if gp_s.solver._direct_loglike is not None and n <= 3000:
        # the direct path is exact: cross-check against a dense solve of
        # the SAME tapered covariance
        gp_sd = GP(tapered)
        gp_sd.compute(x, yerr)
        assert abs(ll_s - gp_sd.log_likelihood(y)) < 1e-6 * abs(ll_s)

    # gradient through the hierarchical path (one autodiff sweep)
    g = gp_h.grad_log_likelihood(y)
    print("HODLR   gradient:", g)
    assert np.all(np.isfinite(g))


if __name__ == "__main__":
    main()
