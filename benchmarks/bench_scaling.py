# -*- coding: utf-8 -*-
"""Solver scaling sweep — the reference's benchmark protocol
(``docs/tutorials/scaling.rst``: best-of-K ``compute + log_likelihood``
over N), extended with gradients and the hierarchical path.

Usage::

    python benchmarks/bench_scaling.py [--grad] [--ns 50,100,...,50000]

Prints one JSON line per (solver, N).
"""

import argparse
import json
import time

import numpy as np


def best_of(fn, repeats=3):
    fn()
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--ns", default="512,1024,2048,4096,8192,16384,32768,65536"
    )
    parser.add_argument("--grad", action="store_true")
    parser.add_argument("--rank", type=int, default=32)
    parser.add_argument("--min-size", type=int, default=256)
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    from george_tpu.utils import use_compile_cache

    use_compile_cache()

    from george_tpu import kernels
    from george_tpu.solvers.linalg import assemble_dense, cholesky_factor
    from george_tpu.solvers.hodlr import (
        build_structure, hodlr_factor, hodlr_solve,
    )

    on_accelerator = jax.devices()[0].platform != "cpu"
    dtype = np.float32 if on_accelerator else np.float64
    ns = [int(v) for v in args.ns.split(",")]

    rng = np.random.default_rng(42)
    for n in ns:
        x = np.sort(rng.uniform(0, n / 100.0, n))[:, None].astype(dtype)
        y = (np.sin(0.1 * x[:, 0])
             + 0.3 * rng.standard_normal(n)).astype(dtype)
        yerr2 = (0.09 * np.ones(n)).astype(dtype)
        kernel = 1.2 * kernels.ExpSquaredKernel(25.0) + 0.3 * (
            kernels.Matern32Kernel(8.0)
        )
        pair = kernel.pair_fn
        theta = jnp.asarray(kernel.parameter_vector, dtype=dtype)
        xj, yj, ej = map(jnp.asarray, (x, y, yerr2))

        # ---- dense (reference BasicSolver equivalent) -------------------
        if n <= 20000:
            def dense_ll(th):
                K = assemble_dense(pair, th, xj, xj)
                L = cholesky_factor(K, ej)
                z = jax.scipy.linalg.solve_triangular(L, yj, lower=True)
                return -0.5 * (
                    jnp.dot(z, z)
                    + 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
                    + n * jnp.log(2.0 * jnp.pi)
                )

            f = (
                jax.jit(jax.value_and_grad(dense_ll))
                if args.grad else jax.jit(dense_ll)
            )
            t = best_of(lambda: jax.block_until_ready(f(theta)))
            print(json.dumps({
                "solver": "basic", "n": n, "grad": args.grad,
                "sec_per_eval": round(t, 5),
            }), flush=True)

        # ---- hierarchical ----------------------------------------------
        st = build_structure(
            n, min_size=args.min_size, rank=args.rank, seed=42,
            x_sorted=np.asarray(x, dtype=np.float64),
        )
        xpad = np.concatenate(
            [x, np.repeat(x[-1:], st.n_pad - n, axis=0)]
        )
        valid = np.zeros(st.n_pad, dtype=bool)
        valid[:n] = True
        diag_pad = np.ones(st.n_pad, dtype=dtype)
        diag_pad[:n] = yerr2
        r_pad = np.zeros(st.n_pad, dtype=dtype)
        r_pad[:n] = y
        xp, vp, dp, rp = map(jnp.asarray, (xpad, valid, diag_pad, r_pad))

        def hodlr_ll(th):
            fct, ld = hodlr_factor(pair, th, xp, vp, dp, st)
            z = hodlr_solve(fct, st, rp)
            return -0.5 * (
                jnp.dot(rp, z) + ld + n * jnp.log(2.0 * jnp.pi)
            )

        f = (
            jax.jit(jax.value_and_grad(hodlr_ll))
            if args.grad else jax.jit(hodlr_ll)
        )
        t = best_of(lambda: jax.block_until_ready(f(theta)))
        print(json.dumps({
            "solver": "hodlr", "n": n, "grad": args.grad,
            "rank": args.rank, "min_size": args.min_size,
            "sec_per_eval": round(t, 5),
        }), flush=True)


if __name__ == "__main__":
    main()
