# -*- coding: utf-8 -*-
"""NUTS samples/s/chip (BASELINE metric): vmapped chains over the fused GP
marginal likelihood (the workload of BASELINE config #4).

Usage::

    python benchmarks/bench_nuts.py [--n 1024] [--chains 16] [--samples 200]
"""

import argparse
import json
import time

import numpy as np


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=1024)
    parser.add_argument("--chains", type=int, default=16)
    parser.add_argument("--warmup", type=int, default=200)
    parser.add_argument("--samples", type=int, default=200)
    parser.add_argument("--max-depth", type=int, default=8)
    parser.add_argument("--segment", type=int, default=None)
    parser.add_argument("--target-accept", type=float, default=0.8)
    parser.add_argument("--diag-mass", action="store_true",
                        help="diagonal mass matrix (default: dense — GP "
                        "hyperparameter posteriors are strongly "
                        "correlated, dim is small)")
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    from george_tpu.utils import use_compile_cache

    use_compile_cache()

    from george_tpu import GP, kernels
    from george_tpu.sampling import sample_nuts

    rng = np.random.default_rng(0)
    n = args.n
    x = np.sort(rng.uniform(0.0, 30.0, n))
    y = np.sin(x) * np.exp(-0.05 * x) + 0.1 * rng.standard_normal(n)

    kernel = 0.5 * kernels.ExpSquaredKernel(1.3) * kernels.ExpSine2Kernel(
        gamma=2.0, log_period=0.0
    ) + 0.1 * kernels.Matern32Kernel(2.0)
    gp = GP(kernel, white_noise=np.log(1e-4), fit_white_noise=True)
    gp.compute(x, 0.1)

    # A proper posterior: the bare GP marginal likelihood plateaus as
    # amplitudes/scales run to infinity (noise-only model), so without a
    # prior the chains drift along the plateau, every trajectory maxes
    # out the tree depth, and "divergences" are plateau artifacts. A
    # weak Gaussian prior around the initialization (sd=3 in the
    # log-space parameters) is what real use looks like (the reference's
    # MCMC tutorial gates lnprob with a prior too, hyper.rst).
    center = jnp.asarray(gp.get_parameter_vector())

    def log_prior(th):
        return -0.5 * jnp.sum(((th - center) / 3.0) ** 2)

    log_prob = gp.log_prob_fn(x, y, 0.1, gate_prior=False,
                              log_prior=log_prior)

    ndim = len(gp)
    p0 = gp.get_parameter_vector()[None, :] + 1e-3 * rng.standard_normal(
        (args.chains, ndim)
    )

    # compile + warmup quality run
    t0 = time.perf_counter()
    samples, stats = sample_nuts(
        jax.random.PRNGKey(0), log_prob, jnp.asarray(p0),
        num_warmup=args.warmup, num_samples=args.samples,
        max_depth=args.max_depth, segment_size=args.segment,
        target_accept=args.target_accept,
        dense_mass=not args.diag_mass,
    )
    jax.block_until_ready(samples)
    total = time.perf_counter() - t0

    # timed run (cached compile)
    t0 = time.perf_counter()
    samples, stats = sample_nuts(
        jax.random.PRNGKey(1), log_prob, jnp.asarray(p0),
        num_warmup=args.warmup, num_samples=args.samples,
        max_depth=args.max_depth, segment_size=args.segment,
        target_accept=args.target_accept,
        dense_mass=not args.diag_mass,
    )
    jax.block_until_ready(samples)
    timed = time.perf_counter() - t0

    draws = args.samples * args.chains
    print(json.dumps({
        "metric": "nuts_samples_per_sec_per_chip",
        "n": n, "chains": args.chains, "ndim": ndim,
        "samples_per_sec": round(draws / timed, 2),
        "sec_total_with_warmup": round(timed, 2),
        "first_run_sec": round(total, 2),
        "mean_accept": round(float(np.mean(stats["accept"])), 3),
        "mean_depth": round(float(np.mean(stats["depth"])), 2),
        "divergence_frac": round(float(np.mean(stats["diverging"])), 4),
    }), flush=True)


if __name__ == "__main__":
    main()
