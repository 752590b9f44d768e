# -*- coding: utf-8 -*-
"""Per-stage profile of the N=1e5 headline evaluation.

Times each stage of the fused log-likelihood+gradient on the default
device, pipelined (16 queued evals, one sync) exactly like ``bench.py``.
The stages are host-clock differences, not device times from a trace:

  leaf_assemble   batched leaf gram blocks
  leaf_chol       batched XLA Cholesky of the leaf blocks
  lowrank         skeleton factors for all levels (_all_lowrank)
  factor          full hodlr_factor (assemble + chol + sweep)
  solve           hodlr_solve on one RHS
  loglike         forward ll only
  vag             value_and_grad (the headline op)

Usage::

    python benchmarks/profile_1e5.py [n] [variant]
"""
import json
import os
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from george_tpu.utils import full_precision_matmuls, use_compile_cache

    use_compile_cache()
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    import bench as benchmod
    from george_tpu.solvers.hodlr import (
        build_structure, select_aca_pivots, hodlr_factor, hodlr_solve,
        _all_lowrank, _block_matrix,
    )

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    variant = sys.argv[2] if len(sys.argv) > 2 else "smooth"
    on_accelerator = jax.devices()[0].platform != "cpu"
    use_f64 = (not on_accelerator) and jax.config.jax_enable_x64
    dtype = np.float64 if use_f64 else np.float32
    kernel, x, y, yerr2, rank = benchmod._dataset(variant, n, dtype)

    min_size = int(os.environ.get("GEORGE_TPU_BENCH_MIN_SIZE", 128))
    st = build_structure(n, min_size=min_size, rank=rank, seed=42,
                         x_sorted=x)
    xpad = np.concatenate(
        [x, np.repeat(x[-1:], st.n_pad - n, axis=0)]
    ).astype(dtype)
    valid = np.zeros(st.n_pad, dtype=bool)
    valid[:n] = True
    select_aca_pivots(
        kernel.pair_fn, np.asarray(kernel.parameter_vector, dtype=dtype),
        xpad, valid, st,
    )
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
    B = st.n_pad // st.m
    m = st.m

    @jax.jit
    @full_precision_matmuls
    def leaf_assemble(th):
        xb = xj.reshape(B, m, -1)
        vb = vj.reshape(B, m)
        Kb = jax.vmap(
            lambda xa, va: _block_matrix(pair, th, xa, va, xa, va,
                                         st.remat)
        )(xb, vb)
        return Kb + jax.vmap(jnp.diag)(dj.reshape(B, m))

    @jax.jit
    @full_precision_matmuls
    def leaf_chol(Kb):
        return jnp.linalg.cholesky(Kb)

    @jax.jit
    @full_precision_matmuls
    def lowrank(th):
        return [C + 0.0 * Q[..., :1, :] for C, Q in
                _all_lowrank(pair, th, xj, vj, st, dj.dtype)]

    @jax.jit
    def factor(th):
        return hodlr_factor(pair, th, xj, vj, dj, st)

    @jax.jit
    def solve_with(th):
        f, ld = hodlr_factor(pair, th, xj, vj, dj, st)
        return hodlr_solve(f, st, rj)

    def loglike(th):
        f, logdet = hodlr_factor(pair, th, xj, vj, dj, st)
        z = hodlr_solve(f, st, rj)
        return -0.5 * (jnp.dot(rj, z) + logdet
                       + n * jnp.log(2.0 * jnp.pi))

    ll_j = jax.jit(loglike)
    vag = jax.jit(jax.value_and_grad(loglike))

    thetas = [theta + 1e-5 * k for k in range(16)]
    counter = [0]

    def timed(fn, args_of):
        jax.block_until_ready(fn(args_of(thetas[0])))
        if n > 300_000:
            # big-N: queueing 16 calls would hold 16 multi-GB outputs
            # in device memory at once — block per call
            best = np.inf
            for _ in range(2):
                for _k in range(3):
                    counter[0] += 1
                    t0 = time.perf_counter()
                    jax.block_until_ready(
                        fn(args_of(theta + 1e-7 * counter[0]))
                    )
                    best = min(best, time.perf_counter() - t0)
            return best
        best = np.inf
        for _ in range(3):
            t0 = time.perf_counter()
            outs = [fn(args_of(th)) for th in thetas]
            jax.block_until_ready(outs)
            best = min(best, (time.perf_counter() - t0) / len(thetas))
        return best

    out = {"metric": "profile_1e5_" + variant, "n": n, "rank": rank}
    Kb0 = leaf_assemble(theta)
    out["leaf_assemble_ms"] = round(1e3 * timed(leaf_assemble,
                                                lambda t: t), 2)
    out["leaf_chol_ms"] = round(
        1e3 * timed(lambda t: leaf_chol(Kb0 + t[0] * 0), lambda t: t), 2
    )
    out["lowrank_ms"] = round(1e3 * timed(lowrank, lambda t: t), 2)
    out["factor_ms"] = round(1e3 * timed(factor, lambda t: t), 2)
    out["factor_solve_ms"] = round(1e3 * timed(solve_with, lambda t: t), 2)
    if n <= 300_000:
        # reverse-mode through the factorization outgrows memory above this
        # (bench.py switches to the Hutchinson split there)
        out["loglike_ms"] = round(1e3 * timed(ll_j, lambda t: t), 2)
        out["vag_ms"] = round(1e3 * timed(vag, lambda t: t), 2)
        ll0, _ = vag(theta)
        out["ll"] = float(ll0)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
