# -*- coding: utf-8 -*-
"""Headline benchmark (BASELINE.json metric): GP marginal log-likelihood +
gradient throughput at N=1e5 through the hierarchical (HODLR-class) solver
— the per-step cost of every optimizer/MCMC iteration at scale (reference
call stacks SURVEY.md §3.2-3.3).

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline", ...} with
the device it ran on (``platform``, ``device_kind``, ``device_count``).
It runs in the process it was started in, on JAX's default backend, and
fails loudly: there is no fallback.

Usage::

    python bench.py [n] [variant]

``variant``:

* ``smooth`` (default) — ExpSquared + Matern32, the headline workload;
* ``qp`` — the genuinely quasi-periodic BASELINE config #3 kernel
  (ExpSquared x ExpSine2, period 3.7), a harder compression target that
  needs the kernel-adaptive ACA skeletons at a higher rank.

Every (n, variant) with a recorded CPU-f64 truth value enforces an
accuracy anchor before timing — a fast-but-wrong configuration fails
instead of reporting.

``vs_baseline`` is measured against the driver-set north-star target
(N=1e6 HODLR log-lik+grad < 1 s/eval, BASELINE.md), scaled to the
benchmarked N by the O(N log^2 N) cost model the reference documents for
HODLR (``docs/user/solvers.rst``): vs_baseline > 1 means beating the
target at this N.
"""

import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np


def _throughput(fn, thetas, repeats=3):
    """Pipelined seconds/eval: queue all evaluations (distinct parameter
    vectors, as an optimizer/sampler does), sync once. This measures
    device throughput rather than per-dispatch round-trip latency.
    Returns ``(best, all_times)``; the spread of the repeats goes into
    the record."""
    import jax

    jax.block_until_ready(fn(thetas[0]))  # warm up
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        outs = [fn(th) for th in thetas]
        jax.block_until_ready(outs)
        times.append((time.perf_counter() - t0) / len(thetas))
    return min(times), times


def target_seconds(n):
    """North-star (1 s at N=1e6) scaled by N log2(N)^2."""
    cost = lambda m: m * np.log2(m) ** 2
    return 1.0 * cost(n) / cost(1e6)


# CPU-f64 truth anchors per (variant, n): value, relative tolerance.
# Values from rank-96 (1e5) / rank-64 (1e6) float64 HODLR factorizations
# of the exact seeded datasets below (skeleton-truncation cross-checks:
# qp 1e5 |rank64 - rank96| = 3.3e-7 relative; smooth 1e6
# |rank48 - rank64| = 3.5e-9). The tolerances are loose enough for the
# f32 cascade and tight enough that a reduced-precision matmul (9e-2
# under bf16 passes) or any precision regression fails loudly.
_TRUTH = {
    ("smooth", 100_000): (-23484.7706, 2e-3),
    ("qp", 100_000): (-6669.998996, 5e-3),
    ("smooth", 1_000_000): (-217929.3465, 5e-3),
}


def _dataset(variant, n, dtype):
    """Seeded benchmark datasets; MUST stay bit-compatible with the truth
    anchors above (same rng stream, same kernel constructors)."""
    from george_tpu import kernels

    rng = np.random.default_rng(42)
    x = np.sort(rng.uniform(0, 1000.0, n))[:, None]
    if variant == "smooth":
        # smooth decaying 1-D workload (the headline metric): ExpSquared
        # + Matern32 — easy rank-12 compression, our throughput target
        y = np.sin(0.1 * x[:, 0]) + 0.3 * rng.standard_normal(n)
        yerr2 = 0.09 * np.ones(n)
        kernel = 1.2 * kernels.ExpSquaredKernel(25.0) + 0.3 * (
            kernels.Matern32Kernel(8.0)
        )
        rank = 12
    else:
        # the genuinely quasi-periodic BASELINE config #3 kernel: an
        # oscillatory covariance whose off-diagonal blocks have
        # intrinsic rank ~35 — the workload the kernel-adaptive ACA
        # pivots exist for (geometric FPS pivots fail at any rank here)
        y = (np.sin(2 * np.pi * x[:, 0] / 3.7) * np.cos(0.13 * x[:, 0])
             + 0.25 * rng.standard_normal(n))
        yerr2 = 0.0625 * np.ones(n)
        kernel = 1.0 * kernels.ExpSquaredKernel(20.0) * (
            kernels.ExpSine2Kernel(gamma=1.0, log_period=np.log(3.7))
        )
        rank = 48
    return kernel, x, y, yerr2, rank


def anchor_error(variant, n, ll):
    """``(relative error, tolerance)`` of ``ll`` against the truth anchor
    of this cell, or ``None`` where the cell has no anchor."""
    anchor = _TRUTH.get((variant, n))
    if anchor is None:
        return None
    truth, tol = anchor
    return abs(float(ll) - truth) / abs(truth), tol


def check_anchor(variant, n, ll):
    """Accuracy anchor: CPU f64 truth for this exact dataset. Guards
    against a fast-but-wrong kernel or precision regression ever
    producing the headline number."""
    if not np.isfinite(float(ll)):
        raise RuntimeError("non-finite log-likelihood in benchmark")
    err = anchor_error(variant, n, ll)
    if err is not None and err[0] > err[1]:
        raise RuntimeError(
            "benchmark log-likelihood off truth by %.2e > %.0e (ll=%.3f, "
            "truth=%.3f)" % (err[0], err[1], float(ll),
                             _TRUTH[(variant, n)][0])
        )


# From this N on a cell runs in float64 on every device. In f32 the
# depth-11 cascade's error at N=1e6 hangs on which near-tied pivots the
# ACA walk picks: on an H100 it gave 1.15e-3 with host pivots and 7.8e-3
# with pivots walked on the card, against the 5e-3 anchor. f64 reproduces
# truth to 1.9e-8 there, for about 10% more time per evaluation.
F64_FROM_N = 500_000


def _x64_scope(on):
    """Scoped float64 for a cell that needs it in an f32 process."""
    import jax

    return jax.enable_x64() if on else contextlib.nullcontext()


@dataclasses.dataclass
class Cell:
    """One benchmark cell, compiled: ``vag(theta) -> (ll, grad)`` runs
    the programs in ``compiled`` (name -> ``jax.stages.Compiled``) in the
    cell's precision; ``theta`` is a host array of ``dtype``."""

    dtype: type
    theta: object
    vag: object
    compiled: dict
    pivot_seconds: float
    compile_seconds: float


def build(variant, n):
    """Seeded data, ACA pivots and the ahead-of-time compiled
    likelihood+gradient program(s) of one cell.

    Cells run f32 unless x64 is enabled or ``n >= F64_FROM_N``; those
    run f64 (scoped, so the rest of the process keeps its precision)."""
    import jax

    use_f64 = jax.config.jax_enable_x64 or n >= F64_FROM_N
    with _x64_scope(use_f64):
        return _build(variant, n, use_f64)


def _build(variant, n, use_f64):
    import jax
    import jax.numpy as jnp

    from george_tpu.solvers.hodlr import (
        build_structure, select_aca_pivots, hodlr_factor, hodlr_solve,
        hodlr_loglike_and_grad_hutchinson,
    )

    dtype = np.float64 if use_f64 else np.float32
    kernel, x, y, yerr2, rank = _dataset(variant, n, dtype)
    rank = int(os.environ.get("GEORGE_TPU_BENCH_RANK", rank))

    # min_size=128/rank=12 with ACA skeletons won the round-2 config sweep
    # for the smooth variant: 3e-8 relative log-likelihood / 1.2e-5
    # gradient error vs a rank-64 f64 reference (the kernel-adaptive
    # pivots buy back the accuracy the lower rank gives up). The
    # quasi-periodic variant needs rank 48 (intrinsic block rank ~35).
    #
    # At very large N the f32 SMW cascade is depth-limited, not
    # rank-limited: the T-update chain amplifies rounding with O(1) gain
    # per level (CPU-f32 ladder: clean at L<=11, chaotic at L=13;
    # f64-promoting the ridge or core solves does NOT fix it).
    # min_size=256 keeps N=1e6 at L=11 and halves every leaf buffer
    # against min_size=512/L=10.
    min_size = int(os.environ.get(
        "GEORGE_TPU_BENCH_MIN_SIZE", 256 if n >= 500_000 else 128,
    ))
    st = build_structure(n, min_size=min_size, rank=rank, seed=42,
                         x_sorted=x)
    layout_env = os.environ.get("GEORGE_TPU_BENCH_LAYOUT")
    if layout_env in ("row", "t"):
        st.transposed = layout_env == "t"
    xpad = np.concatenate(
        [x, np.repeat(x[-1:], st.n_pad - n, axis=0)]
    ).astype(dtype)
    valid = np.zeros(st.n_pad, dtype=bool)
    valid[:n] = True
    # kernel-adaptive skeletons (same default as HODLRSolver): tighter
    # compression per rank than geometric FPS pivots, selected once here
    # and reused across every theta evaluation
    t0 = time.perf_counter()
    select_aca_pivots(
        kernel.pair_fn,
        np.asarray(kernel.parameter_vector, dtype=dtype),
        xpad, valid, st,
    )
    pivot_seconds = time.perf_counter() - t0
    diag_pad = np.ones(st.n_pad, dtype=dtype)
    diag_pad[:n] = yerr2
    r_pad = np.zeros(st.n_pad, dtype=dtype)
    r_pad[:n] = y

    pair = kernel.pair_fn
    xj = jnp.asarray(xpad)
    vj = jnp.asarray(valid)
    dj = jnp.asarray(diag_pad)
    rj = jnp.asarray(r_pad)
    theta = jnp.asarray(kernel.parameter_vector, dtype=dtype)

    t0 = time.perf_counter()
    force_hutch = os.environ.get("GEORGE_TPU_BENCH_HUTCH") == "1"
    if n < 100_000 and not force_hutch:
        # small N: exact autodiff gradient — one reverse sweep of the
        # factorization, free of Monte-Carlo noise.
        def loglike(th):
            factors, logdet = hodlr_factor(pair, th, xj, vj, dj, st)
            z = hodlr_solve(factors, st, rj)
            return -0.5 * (
                jnp.dot(rj, z) + logdet + n * jnp.log(2.0 * jnp.pi)
            )

        vag = jax.jit(jax.value_and_grad(loglike)).lower(theta).compile()
        compiled = {"vag": vag}
    else:
        # N >= 1e5: exact quadratic terms + Hutchinson traces (the
        # reference's own large-N gradient, Regime B ``gp.py:506-562``,
        # nvec~10 probes) built forward-mode from one factorization on
        # the TRANSPOSED cascade, a multi-RHS solve and a single
        # theta-batched jvp matvec pass — the only path whose
        # reverse-sweep memory survives N >= 3e5.
        st.transposed = True
        key = jax.random.PRNGKey(0)
        # f32: one step of iterative refinement on the solves (one
        # matvec + resolve) takes out most of the f32 cascade's forward
        # error
        refine = 0 if use_f64 else 1

        if n <= 300_000:
            def vag_fn(th):
                return hodlr_loglike_and_grad_hutchinson(
                    pair, th, xj, vj, dj, rj, st, key,
                    num_probes=8, n_real=n, refine_steps=refine,
                )

            vag = jax.jit(vag_fn).lower(theta).compile()
            compiled = {"vag": vag}
        else:
            # N=1e6 class: two programs, factor and remainder, so the
            # peak is max(factor, remainder) instead of the sum. The
            # factor pytree, the data arrays and the PRNG key move
            # between them as device ARGUMENTS (a closed-over device
            # array would become a constant of the program).
            def fac_fn(th, x_, v_, d_):
                return hodlr_factor(pair, th, x_, v_, d_, st)

            def rest_fn(th, x_, v_, d_, r_, key_, factors, logdet):
                return hodlr_loglike_and_grad_hutchinson(
                    pair, th, x_, v_, d_, r_, st, key_,
                    num_probes=8, n_real=n, refine_steps=refine,
                    factors_logdet=(factors, logdet),
                )

            fac = jax.jit(fac_fn).lower(theta, xj, vj, dj).compile()
            factors_s, logdet_s = jax.eval_shape(fac_fn, theta, xj, vj, dj)
            rest = jax.jit(rest_fn).lower(
                theta, xj, vj, dj, rj, key, factors_s, logdet_s
            ).compile()
            compiled = {"factor": fac, "remainder": rest}

            def vag(th):
                factors, logdet = fac(th, xj, vj, dj)
                return rest(th, xj, vj, dj, rj, key, factors, logdet)
    compile_seconds = time.perf_counter() - t0

    def run(th):
        with _x64_scope(use_f64):
            return vag(jnp.asarray(th, dtype=dtype))

    return Cell(dtype, np.asarray(theta), run, compiled, pivot_seconds,
                compile_seconds)


def main():
    import jax

    from george_tpu.utils import use_compile_cache

    use_compile_cache()
    if len(sys.argv) > 1:
        n = int(sys.argv[1])
    else:
        # headline N on an accelerator; a tractable size on CPU-only hosts
        n = 100_000 if jax.default_backend() != "cpu" else 20_000
    variant = sys.argv[2] if len(sys.argv) > 2 else "smooth"
    if variant not in ("smooth", "qp"):
        raise SystemExit("variant must be 'smooth' or 'qp'")

    # Precision: ``highest`` everywhere unless GEORGE_TPU_MATMUL_PRECISION
    # says otherwise; every timed run is anchor-gated either way.
    cell = build(variant, n)
    ll0, _ = cell.vag(cell.theta)
    check_anchor(variant, n, ll0)

    # 16 queued evaluations: samplers/optimizers pipeline far more steps
    # than this, so the residual per-dispatch overhead is realistic
    thetas = [cell.theta + 1e-5 * k for k in range(16)]
    best, times = _throughput(cell.vag, thetas)

    dev = jax.devices()[0]
    rec = {
        "metric": "hodlr_loglik_grad_evals_per_sec%s_n%d"
                  % ("" if variant == "smooth" else "_" + variant, n),
        "value": round(1.0 / best, 3),
        "unit": "evals/s",
        "vs_baseline": round(target_seconds(n) / best, 3),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        # provenance: which precision tier timed, and how far the timed
        # program's log-likelihood sat from the CPU-f64 truth anchor
        "precision": os.environ.get("GEORGE_TPU_MATMUL_PRECISION",
                                    "highest"),
        "spread_s_per_eval": [float("%.4g" % t) for t in times],
    }
    err = anchor_error(variant, n, ll0)
    if err is not None:
        rec["anchor_rel_err"] = float("%.3g" % err[0])
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
