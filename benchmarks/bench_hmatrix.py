# -*- coding: utf-8 -*-
"""Strong-admissibility (H-matrix) solver benchmark: 2-D GP compute +
per-evaluation log-likelihood timing, with a weak-partition (HODLR)
head-to-head at the same skeleton rank.

The reference has no strong-admissibility code (its answer to spatial
data was the external ButterflyPACK backend, ``basic.py:80-118``); this
records the solver's economics on the device it runs on.

Usage::

    python benchmarks/bench_hmatrix.py [--n 20000] [--truth-n 4000]
"""

import argparse
import json
import time

import numpy as np


def _dataset(n, rng):
    x = rng.uniform(0, 12.0 * np.sqrt(n / 2000.0), (n, 2))
    truth = np.sin(x[:, 0]) * np.cos(0.7 * x[:, 1])
    y = truth + 0.1 * rng.standard_normal(n)
    yerr = 0.1 * np.ones(n)
    return x, y, yerr


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=20000)
    parser.add_argument("--truth-n", type=int, default=4000)
    parser.add_argument("--rank", type=int, default=16)
    parser.add_argument("--min-size", type=int, default=64)
    parser.add_argument("--exact-truth", action="store_true",
                        help="compute the dense BasicSolver likelihood at "
                        "--truth-n on the fly (CPU f64; feasible to "
                        "n~2e4) instead of relying on the precomputed "
                        "n=4000 value")
    parser.add_argument("--skip-weak", action="store_true",
                        help="skip the HODLR head-to-head (for very "
                        "large n where the weak partition is known to "
                        "be the wrong tool)")
    args = parser.parse_args()

    import jax

    from george_tpu.utils import use_compile_cache

    use_compile_cache()
    if jax.default_backend() == "cpu":
        jax.config.update("jax_enable_x64", True)

    from george_tpu import GP, kernels
    from george_tpu.solvers import HMatrixSolver, HODLRSolver

    rng = np.random.default_rng(7)
    kernel_of = lambda: 1.0 * kernels.ExpSquaredKernel([1.5, 1.5], ndim=2)
    out = {"metric": "hmatrix_2d", "n": args.n, "rank": args.rank,
           "backend": jax.default_backend()}

    # --- accuracy at a size where the f32 answer can be compared against
    # the CPU-f64 exact likelihood (precomputed truth values for the
    # seeded dataset below)
    xt, yt, yerrt = _dataset(args.truth_n, np.random.default_rng(3))
    gp = GP(kernel_of(), solver=HMatrixSolver, min_size=args.min_size,
            rank=args.rank)
    gp.compute(xt, yerr=yerrt)
    ll_small = float(gp.log_likelihood(yt))
    out["ll_truth_n"] = args.truth_n
    out["ll_small"] = round(ll_small, 4)
    truth = None
    if args.exact_truth:
        # dense exact likelihood for the same seeded dataset — the
        # accuracy leg of the 2-D scaling protocol (the reference's
        # scaling.rst compares against the dense solver the same way)
        from george_tpu.solvers import BasicSolver

        t0 = time.perf_counter()
        gpx = GP(kernel_of(), solver=BasicSolver)
        gpx.compute(xt, yerr=yerrt)
        truth = float(gpx.log_likelihood(yt))
        out["exact_truth_sec"] = round(time.perf_counter() - t0, 2)
        out["ll_exact"] = round(truth, 4)
    elif args.truth_n == 4000:
        # exact f64 BasicSolver likelihood for this seeded dataset,
        # computed once on the CPU (2026-08-17); the H-matrix answer's
        # distance from it is dominated by the SLQ logdet MC noise
        truth = 2894.5753680081853
    elif args.truth_n == 16000:
        # exact f64 dense likelihood, CPU, 2026-08-20
        truth = 11762.457
    if truth is not None:
        out["ll_rel_err"] = round(abs(ll_small - truth) / abs(truth), 6)
        if not args.skip_weak:
            # weak-partition accuracy at the same rank, same small dataset
            gpwt = GP(kernel_of(), solver=HODLRSolver,
                      min_size=args.min_size, rank=args.rank)
            gpwt.compute(xt, yerr=yerrt)
            llw_small = float(gpwt.log_likelihood(yt))
            out["ll_weak_rel_err"] = round(
                abs(llw_small - truth) / abs(truth), 6
            )

    # --- timing at the headline size -----------------------------------
    x, y, yerr = _dataset(args.n, rng)

    t0 = time.perf_counter()
    gp = GP(kernel_of(), solver=HMatrixSolver, min_size=args.min_size,
            rank=args.rank)
    gp.compute(x, yerr=yerr)
    out["compute_sec_first"] = round(time.perf_counter() - t0, 2)

    # per-evaluation cost with everything compiled: recompute (compress +
    # logdet) happens inside compute(); the repeated-eval cost is the
    # preconditioned-CG solve in dot_solve
    t0 = time.perf_counter()
    ll = float(gp.log_likelihood(y))
    out["loglike_sec_first"] = round(time.perf_counter() - t0, 2)
    out["ll"] = round(ll, 2)

    # repeat log-likelihood (compiled; varied y) — the per-sampler-step
    # cost
    lt = []
    for k in range(3):
        t0 = time.perf_counter()
        _ = float(gp.log_likelihood(y + 1e-6 * (k + 1)))
        lt.append(time.perf_counter() - t0)
    out["loglike_sec_repeat"] = round(min(lt), 2)

    times = []
    for k in range(5):
        yk = y + 1e-6 * k
        t0 = time.perf_counter()
        _ = float(gp.solver.dot_solve(yk))
        times.append(time.perf_counter() - t0)
    out["solve_sec"] = round(min(times), 4)
    out["cg_iters"] = getattr(gp.solver, "last_cg_iters", None)

    # --- weak-partition head-to-head at the same rank -------------------
    if args.skip_weak:
        print(json.dumps(out), flush=True)
        return
    t0 = time.perf_counter()
    gpw = GP(kernel_of(), solver=HODLRSolver, min_size=args.min_size,
             rank=args.rank)
    gpw.compute(x, yerr=yerr)
    llw = float(gpw.log_likelihood(y))
    out["weak_compute_ll_sec_first"] = round(time.perf_counter() - t0, 2)
    out["ll_weak"] = round(llw, 2)
    wt = []
    for k in range(5):
        yk = y + 1e-6 * k
        t0 = time.perf_counter()
        _ = float(gpw.solver.dot_solve(yk))
        wt.append(time.perf_counter() - t0)
    out["weak_solve_sec"] = round(min(wt), 4)

    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
