# -*- coding: utf-8 -*-
"""Smoke test of the likelihood path on an NVIDIA GPU, with truth anchors.

Drives the system once through the entry points a user calls, at the
sizes the repository supports, and checks every result against a truth
anchor or an independent float64 reference computed on the host with
numpy/scipy:

1. dense fused likelihood + gradient (``__graft_entry__.entry()``,
   n=1024) against a host-f64 value and finite-difference gradient, then
   a short NUTS run at n=512 whose segmented run must be bit-identical to
   the unsegmented one;
2. the hierarchical solver through the ``GP`` API at N=1e5 against the
   CPU-f64 truth anchor, then three L-BFGS-B steps;
3. the ``bench.py`` programs (smooth and quasi-periodic N=1e5, smooth
   N=1e6), each gated by its own anchor;
4. ``SparseSolver`` on sorted 1-D compact-support data at n=2e5: the
   banded direct solve and the CG solve must agree;
5. ``HMatrixSolver`` on 2-D data at n=16000 against a dense host-f64
   likelihood.

``--four`` runs only the multi-card phase: chain-sharded NUTS over a
4-card mesh against the same chains on one card (one f32 transition,
then the adaptation pooled across the cards, in f64), and the row-sharded
hierarchical solver at N=1e5 against the one-card log-likelihood and the
truth anchor.

Usage::

    python chip_smoke.py          # phases 1-5, one card
    python chip_smoke.py --four   # the mesh phase, four cards

Run as a script it turns XLA:GPU's autotuning off (``AUTOTUNE_OFF``), so
that the NUTS segmentation check compares programs with the same GEMM
algorithms. One process drives the card(s). Every check prints one JSON
line; the last
line of standard output, printed only when every phase passed, is
``{"ok": true, "device": {"platform", "kind", "count"}}``. Without a GPU
the script exits non-zero and prints no result.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# Tolerances against the host-f64 references, for f32 on the card. Each
# sits about an order of magnitude above the f32 error the check sees on
# a healthy build; the truth anchors of the hierarchical cells are
# bench.py's own (_TRUTH).
DENSE_LL_RTOL = 1e-4        # entry() log-likelihood, n=1024
DENSE_GRAD_RTOL = 1e-3      # entry() gradient, max-norm relative
SPARSE_SOLVE_RTOL = 1e-3    # banded direct vs CG solve, 2-norm relative
HMATRIX_LL_RTOL = 1e-3      # 2-D H-matrix vs dense log-likelihood
SMALL_ANCHOR_RTOL = 2e-3    # hierarchical vs dense where no anchor exists
MESH_LL_RTOL = 1e-3         # row-sharded vs one-card log-likelihood
# chain-sharded NUTS against the same chains on one card. One f32
# transition from the same start and key (depth <= 3) must agree to
# MESH_NUTS_ATOL: a chain mapped to the wrong shard or key moves its draw
# by O(step size). The adaptive run (f64, short: it tests the pooling,
# not the posterior) pools its first mass window across all chains, i.e.
# across the devices; the pooled inverse mass and the step size one
# transition later must agree with one card to the tolerances below.
# Eight virtual CPU devices agree to 3.8e-11 and 4.3e-9 (n=512, 8
# chains); pooling over one device's chains only moves them by 1.5 and
# 0.63. Later draws are not compared: NUTS turns any last-bit change
# into other trajectories (on one H100, every start moved 1 ulp: draws
# 6.2 apart after 20 + 10 f64 steps, 12 in f32).
MESH_NUTS_ATOL = 1e-3
MESH_MASS64_RTOL = 1e-6
MESH_STEP64_RTOL = 1e-4


def _check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def _emit(rec):
    print(json.dumps(rec, default=float), flush=True)


def _device_report(compiled=None):
    """Peak device bytes so far, and the memory analysis of ``compiled``
    (a ``jax.stages.Compiled`` or a dict of them)."""
    import jax

    rec = {}
    stats = jax.devices()[0].memory_stats()
    rec["peak_bytes_in_use"] = None if stats is None else stats.get(
        "peak_bytes_in_use")
    if compiled is not None:
        items = compiled.items() if isinstance(compiled, dict) else [
            ("step", compiled)]
        mem = {}
        for name, c in items:
            ma = c.memory_analysis()
            mem[name] = None if ma is None else {
                k: int(getattr(ma, k)) for k in (
                    "argument_size_in_bytes", "output_size_in_bytes",
                    "temp_size_in_bytes", "generated_code_size_in_bytes")
            }
        rec["memory_analysis"] = mem
    return rec


def _steady(fn, args_list):
    """Median seconds per call, each call synchronised."""
    import jax

    times = []
    for args in args_list:
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


# ---------------------------------------------------------------------------
# Host float64 references (numpy/scipy only)
# ---------------------------------------------------------------------------

def _np_loglike(K, r):
    """Dense Gaussian log-likelihood in float64 on the host."""
    import scipy.linalg as sla

    cf = sla.cho_factor(K, lower=True)
    alpha = sla.cho_solve(cf, r)
    return float(-0.5 * r @ alpha - np.sum(np.log(np.diag(cf[0])))
                 - 0.5 * len(r) * np.log(2 * np.pi))


def _np_sqdist(x1, x2, metric):
    d = (x1[:, None, :] - x2[None, :, :]) ** 2 / np.asarray(metric)
    return d.sum(-1)


def _np_matern32(r2):
    r = np.sqrt(3.0 * r2)
    return (1.0 + r) * np.exp(-r)


def _np_entry_loglike(theta, x, y, yerr2):
    """``__graft_entry__``'s model, from its full parameter vector: mean,
    log white noise, then 0.5*ExpSquared*ExpSine2 + 0.1*Matern32."""
    mean, wn, lc1, lm1, gamma, lp, lc2, lm2 = theta
    d = x[:, None, 0] - x[None, :, 0]
    K = (np.exp(lc1) * np.exp(-0.5 * d * d / np.exp(lm1))
         * np.exp(-gamma * np.sin(np.pi * d * np.exp(-lp)) ** 2)
         + np.exp(lc2) * _np_matern32(d * d / np.exp(lm2)))
    K[np.diag_indices_from(K)] += yerr2 + np.exp(wn)
    return _np_loglike(K, y - mean)


def _np_bench_cov(variant, x):
    """``bench._dataset``'s kernels (log-constants and log-metrics from
    the kernels' own parameter vectors, fixed at construction)."""
    d2 = _np_sqdist(x, x, [1.0])
    if variant == "smooth":
        return 1.2 * np.exp(-0.5 * d2 / 25.0) + 0.3 * _np_matern32(d2 / 8.0)
    d = x[:, None, 0] - x[None, :, 0]
    return (np.exp(-0.5 * d2 / 20.0)
            * np.exp(-np.sin(np.pi * d / 3.7) ** 2))


def _bench_reference(variant, n, ll):
    """``(relative error, tolerance)`` of ``ll`` against the cell's
    truth anchor, or against a dense host-f64 likelihood where the cell
    has none (small n only)."""
    import bench

    err = bench.anchor_error(variant, n, ll)
    if err is not None:
        return err
    _check(n <= 20_000, "no truth anchor for (%s, %d)" % (variant, n))
    _, x, y, yerr2, _ = bench._dataset(variant, n, np.float64)
    K = _np_bench_cov(variant, x)
    K[np.diag_indices_from(K)] += yerr2
    ref = _np_loglike(K, y)
    return abs(float(ll) - ref) / abs(ref), SMALL_ANCHOR_RTOL


def _nuts_problem(n, chains):
    """``benchmarks/bench_nuts.py``'s posterior: ``entry()``'s model on
    ``n`` points under a weak Gaussian prior (sd 3) around the start,
    with ``chains`` starts 1e-3 apart."""
    import jax.numpy as jnp

    import __graft_entry__ as g

    gp = g._make_gp()
    x, y, yerr2 = g._make_data(n)
    center = jnp.asarray(gp.get_parameter_vector())
    log_prob = gp.log_prob_fn(
        x, y, np.sqrt(yerr2), gate_prior=False,
        log_prior=lambda th: -0.5 * jnp.sum(((th - center) / 3.0) ** 2),
    )
    p0 = (gp.get_parameter_vector()[None, :]
          + 1e-3 * np.random.default_rng(0).standard_normal(
              (chains, len(gp))))
    return log_prob, p0


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_dense(nuts_n=512, chains=8, warmup=20, samples=10, segment=8):
    """``entry()`` value and gradient against host f64; NUTS segmentation
    bit-identity."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as g
    from george_tpu.sampling import sample_nuts

    fn, args = g.entry()
    theta, x, y, yerr2 = (np.asarray(a, dtype=np.float64) for a in args)
    t0 = time.perf_counter()
    step = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    ll, grad = jax.block_until_ready(step(*args))
    steady = _steady(step, [args] * 5)

    ref = _np_entry_loglike(theta, x, y, yerr2)
    h = 1e-6
    ref_grad = np.array([
        (_np_entry_loglike(theta + h * e, x, y, yerr2)
         - _np_entry_loglike(theta - h * e, x, y, yerr2)) / (2 * h)
        for e in np.eye(len(theta))
    ])
    ll_err = abs(float(ll) - ref) / abs(ref)
    grad_err = float(np.max(np.abs(np.asarray(grad) - ref_grad))
                     / np.max(np.abs(ref_grad)))
    rec = {"phase": "dense", "n": len(x), "dtype": str(np.asarray(ll).dtype),
           "compile_s": compile_s, "steady_s": steady,
           "ll": float(ll), "ll_ref_f64": ref,
           "ll_rel_err": ll_err, "ll_rtol": DENSE_LL_RTOL,
           "grad_rel_err": grad_err, "grad_rtol": DENSE_GRAD_RTOL}
    rec.update(_device_report(step))
    _emit(rec)
    _check(ll_err <= DENSE_LL_RTOL, "dense log-likelihood off: %r" % rec)
    _check(grad_err <= DENSE_GRAD_RTOL, "dense gradient off: %r" % rec)

    # NUTS over the same model at nuts_n: the segmented run (several
    # device programs) must reproduce the unsegmented one bit for bit
    log_prob, p0 = _nuts_problem(nuts_n, chains)
    runs = {}
    for seg in (None, segment):
        t0 = time.perf_counter()
        q, stats = sample_nuts(
            jax.random.PRNGKey(1), log_prob, jnp.asarray(p0),
            num_warmup=warmup, num_samples=samples, max_depth=6,
            segment_size=seg,
        )
        runs[seg] = (np.asarray(q), time.perf_counter() - t0,
                     float(np.mean(stats["accept"])))
    q_full, q_seg = runs[None][0], runs[segment][0]
    rec2 = {"phase": "nuts", "n": nuts_n, "chains": chains,
           "warmup": warmup, "samples": samples, "segment": segment,
           "first_run_s": runs[None][1], "segmented_run_s": runs[segment][1],
           "mean_accept": runs[None][2],
           "bit_identical": bool(np.array_equal(q_full, q_seg)),
           "max_abs_diff": float(np.max(np.abs(q_full - q_seg)))}
    rec2.update(_device_report())
    _emit(rec2)
    _check(np.all(np.isfinite(q_full)), "non-finite NUTS draws")
    _check(rec2["bit_identical"], "segmented NUTS run differs: %r" % rec2)
    return [rec, rec2]


def phase_hodlr_gp(n=100_000, lbfgs_steps=3):
    """The hierarchical solver through the ``GP`` API, anchored, then a
    few L-BFGS-B steps on ``gp.nll`` / ``gp.grad_nll``."""
    import scipy.optimize as so

    import bench
    from george_tpu import GP, HODLRSolver
    from george_tpu.solvers.hodlr import pivot_device

    kernel, x, y, yerr2, rank = bench._dataset("smooth", n, np.float64)
    gp = GP(kernel, solver=HODLRSolver, rank=rank, min_size=128,
            grad_mode="hutchinson")
    t0 = time.perf_counter()
    gp.compute(x[:, 0], np.sqrt(yerr2))
    compute_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ll = gp.log_likelihood(y)
    g0 = gp.grad_log_likelihood(y)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(3):
        gp.log_likelihood(y)
        gp.grad_log_likelihood(y)
    steady = (time.perf_counter() - t0) / 3
    err, tol = _bench_reference("smooth", n, ll)
    rec = {"phase": "hodlr_gp", "n": n, "rank": rank, "min_size": 128,
           "dtype": str(np.asarray(gp.solver._xpad).dtype),
           "pivot_device": "%s (float64)" % pivot_device(),
           "factor_residual": gp.solver.factor_residual,
           "compute_s": compute_s, "first_ll_grad_s": first_s,
           "steady_ll_grad_s": steady, "ll": ll,
           "anchor_rel_err": err, "anchor_rtol": tol}
    if not (err <= tol and np.all(np.isfinite(g0))):
        _emit(rec)
        raise RuntimeError("GP/HODLR log-likelihood off its anchor")

    seen = []

    def nll(p):
        v = gp.nll(p, y)
        seen.append(v)
        return v

    def grad_nll(p):
        gv = gp.grad_nll(p, y)
        seen.append(float(np.max(np.abs(gv))))
        return gv

    t0 = time.perf_counter()
    res = so.minimize(nll, gp.get_parameter_vector(), jac=grad_nll,
                      method="L-BFGS-B", options={"maxiter": lbfgs_steps})
    rec.update({"lbfgs_steps": int(res.nit), "lbfgs_evals": int(res.nfev),
                "lbfgs_s": time.perf_counter() - t0,
                "nll_start": seen[0], "nll_end": float(res.fun)})
    rec.update(_device_report())
    _emit(rec)
    _check(np.all(np.isfinite(seen)), "non-finite L-BFGS-B step: %r" % rec)
    _check(res.nit >= min(lbfgs_steps, 1), "L-BFGS-B took no step")
    return [rec]


def phase_bench(cells=(("smooth", 100_000), ("qp", 100_000),
                       ("smooth", 1_000_000))):
    """The ``bench.py`` programs, each gated by its own anchor."""
    import jax

    import bench

    recs = []
    for variant, n in cells:
        cell = bench.build(variant, n)
        ll, grad = jax.block_until_ready(cell.vag(cell.theta))
        steady = _steady(cell.vag,
                         [(cell.theta + 1e-5 * k,) for k in range(1, 6)])
        err, tol = _bench_reference(variant, n, ll)
        rec = {"phase": "bench", "variant": variant, "n": n,
               "dtype": np.dtype(cell.dtype).name,
               "pivot_s": cell.pivot_seconds,
               "compile_s": cell.compile_seconds, "steady_s": steady,
               "ll": float(ll), "anchor_rel_err": err, "anchor_rtol": tol}
        rec.update(_device_report(cell.compiled))
        _emit(rec)
        _check(err <= tol and np.all(np.isfinite(np.asarray(grad))),
               "bench cell off its anchor: %r" % rec)
        recs.append(rec)
    return recs


def phase_sparse(n=200_000):
    """Compact support on sorted 1-D data: banded direct vs CG solves."""
    from george_tpu import kernels
    from george_tpu.solvers import SparseSolver

    rng = np.random.default_rng(5)
    x = np.sort(rng.uniform(0.0, n / 10.0, n))     # ~10 points per unit
    y = np.sin(0.05 * x) + 0.3 * rng.standard_normal(n)
    kernel = kernels.WendlandC2Kernel(
        log_rc=np.log(15.0), kernel_base=kernels.ExpSquaredKernel(25.0)
    )
    out = {}
    for name, direct in (("direct", True), ("cg", False)):
        s = SparseSolver(kernel, direct=direct)
        t0 = time.perf_counter()
        s.compute(x, 0.3)
        compute_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        z = s.apply_inverse(y)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for k in range(3):
            s.apply_inverse(y + 1e-3 * k)
        out[name] = (s, z, compute_s, first_s,
                     (time.perf_counter() - t0) / 3)
    z_d, z_c = out["direct"][1], out["cg"][1]
    rel = float(np.linalg.norm(z_d - z_c) / np.linalg.norm(z_d))
    resid = float(np.linalg.norm(out["direct"][0].apply_forward(z_d) - y)
                  / np.linalg.norm(y))
    rec = {"phase": "sparse", "n": n, "nnz": out["direct"][0].nnz,
           "band": len(out["direct"][0]._dia_offsets),
           "dtype": str(z_d.dtype), "solve_rel_diff": rel,
           "solve_rtol": SPARSE_SOLVE_RTOL, "direct_residual": resid}
    for name, (_, _, c, f, st) in out.items():
        rec.update({name + "_compute_s": c, name + "_first_solve_s": f,
                    name + "_steady_solve_s": st})
    rec.update(_device_report())
    _emit(rec)
    _check(np.all(np.isfinite(z_d)) and rel <= SPARSE_SOLVE_RTOL
           and resid <= SPARSE_SOLVE_RTOL,
           "sparse direct and CG solves disagree: %r" % rec)
    return [rec]


def _hmatrix_dataset(n):
    """``benchmarks/bench_hmatrix.py``'s seeded 2-D dataset."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 12.0 * np.sqrt(n / 2000.0), (n, 2))
    y = np.sin(x[:, 0]) * np.cos(0.7 * x[:, 1]) + 0.1 * rng.standard_normal(n)
    return x, y, 0.1 * np.ones(n)


def phase_hmatrix(n=16_000):
    """2-D strong-admissibility solver against a dense host-f64
    likelihood."""
    from george_tpu import GP, kernels
    from george_tpu.gp import TINY
    from george_tpu.solvers import HMatrixSolver

    x, y, yerr = _hmatrix_dataset(n)
    gp = GP(1.0 * kernels.ExpSquaredKernel([1.5, 1.5], ndim=2),
            solver=HMatrixSolver, min_size=64, rank=16)
    t0 = time.perf_counter()
    gp.compute(x, yerr=yerr)
    compute_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ll = gp.log_likelihood(y)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for k in range(3):
        gp.log_likelihood(y + 1e-6 * (k + 1))
    steady = (time.perf_counter() - t0) / 3

    t0 = time.perf_counter()
    K = np.exp(-0.5 * _np_sqdist(x, x, [1.5, 1.5]))
    K[np.diag_indices_from(K)] += yerr ** 2 + TINY
    ref = _np_loglike(K, y)
    del K
    ref_s = time.perf_counter() - t0
    err = abs(ll - ref) / abs(ref)
    rec = {"phase": "hmatrix", "n": n, "rank": 16, "min_size": 64,
           "dtype": str(np.asarray(gp.solver._xpad).dtype),
           "compute_s": compute_s, "first_ll_s": first_s,
           "steady_ll_s": steady, "ll": ll, "ll_ref_f64": ref,
           "ref_s": ref_s, "ll_rel_err": err, "ll_rtol": HMATRIX_LL_RTOL}
    rec.update(_device_report())
    _emit(rec)
    _check(err <= HMATRIX_LL_RTOL, "H-matrix likelihood off: %r" % rec)
    return [rec]


def phase_four(n_devices=4, hodlr_n=100_000, nuts_n=512, chains=8,
               warmup=9, samples=2):
    """Chain-sharded NUTS and the row-sharded hierarchical solver over an
    ``n_devices`` mesh, each against the same work on one device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import bench
    from george_tpu import GP, HODLRSolver, parallel
    from george_tpu.sampling import sample_nuts

    _check(len(jax.devices()) >= n_devices,
           "need %d devices, have %d" % (n_devices, len(jax.devices())))
    devices = np.array(jax.devices()[:n_devices])

    log_prob, p0 = _nuts_problem(nuts_n, chains)
    key = jax.random.PRNGKey(2)
    mesh = Mesh(devices, ("chains",))
    # one f32 transition from p0 with the same key, no adaptation
    step = dict(num_warmup=0, num_samples=1, max_depth=3)
    q1_mesh, _ = parallel.sharded_sample_nuts(mesh, key, log_prob, p0,
                                              **step)
    q1_one, _ = sample_nuts(key, log_prob, jnp.asarray(p0), **step)
    q1_mesh, q1_one = np.asarray(q1_mesh), np.asarray(q1_one)
    step_diff = float(np.max(np.abs(q1_mesh - q1_one)))

    # the adaptive run in f64: one mass window, pooled across all chains,
    # i.e. across the devices, then one term-buffer transition
    run = dict(num_warmup=warmup, num_samples=samples, max_depth=6)
    res = {}
    with jax.enable_x64():
        log_prob64, p0_64 = _nuts_problem(nuts_n, chains)
        for name in ("mesh", "one"):
            t0 = time.perf_counter()
            if name == "mesh":
                q, st = parallel.sharded_sample_nuts(mesh, key, log_prob64,
                                                     p0_64, **run)
                n_shards = len(q.sharding.device_set)
            else:
                q, st = sample_nuts(key, log_prob64, jnp.asarray(p0_64),
                                    **run)
            res[name] = dict(
                q=np.asarray(q), step=np.asarray(st["step_size"]),
                mass=np.asarray(st["inv_mass"]),
                accept=float(np.mean(st["accept"])),
                seconds=time.perf_counter() - t0)
    m, o = res["mesh"], res["one"]

    def rel(a, b):
        return float(np.max(np.abs(a - b) / np.abs(b)))

    rec = {"phase": "four_nuts", "devices": n_devices, "chains": chains,
           "n": nuts_n, "f32_transition_bit_identical":
               bool(np.array_equal(q1_mesh, q1_one)),
           "f32_transition_max_abs_diff": step_diff,
           "f32_transition_atol": MESH_NUTS_ATOL,
           "warmup": warmup, "samples": samples, "dtype": str(m["q"].dtype),
           "mesh_run_s": m["seconds"], "one_run_s": o["seconds"],
           "draw_shards": n_shards, "mean_accept": m["accept"],
           "inv_mass_rel_diff": rel(m["mass"], o["mass"]),
           "inv_mass_rtol": MESH_MASS64_RTOL,
           "step_size_rel_diff": rel(m["step"], o["step"]),
           "step_size_rtol": MESH_STEP64_RTOL,
           "draws_max_abs_diff": float(np.max(np.abs(m["q"] - o["q"])))}
    _emit(rec)
    _check(m["q"].dtype == np.float64 and np.all(np.isfinite(m["q"]))
           and n_shards == n_devices
           and step_diff <= MESH_NUTS_ATOL
           and rec["inv_mass_rel_diff"] <= MESH_MASS64_RTOL
           and rec["step_size_rel_diff"] <= MESH_STEP64_RTOL,
           "chain-sharded NUTS differs from one device: %r" % rec)

    kernel, x, y, yerr2, rank = bench._dataset("smooth", hodlr_n,
                                               np.float64)
    lls, secs = {}, {}
    for name, mesh in (("mesh", Mesh(devices, ("data",))), ("one", None)):
        gpd = GP(kernel, solver=HODLRSolver, rank=rank, min_size=128,
                 mesh=mesh)
        t0 = time.perf_counter()
        gpd.compute(x[:, 0], np.sqrt(yerr2))
        lls[name] = gpd.log_likelihood(y)
        secs[name] = time.perf_counter() - t0
        if mesh is not None:
            _check(gpd.solver._row_sharding is not None,
                   "the hierarchical solver did not shard its rows")
    err, tol = _bench_reference("smooth", hodlr_n, lls["mesh"])
    rel = abs(lls["mesh"] - lls["one"]) / abs(lls["one"])
    rec2 = {"phase": "four_hodlr", "devices": n_devices, "n": hodlr_n,
            "ll_mesh": lls["mesh"], "ll_one": lls["one"],
            "mesh_compute_ll_s": secs["mesh"],
            "one_compute_ll_s": secs["one"],
            "mesh_vs_one_rel": rel, "mesh_rtol": MESH_LL_RTOL,
            "anchor_rel_err": err, "anchor_rtol": tol}
    rec2.update(_device_report())
    _emit(rec2)
    _check(rel <= MESH_LL_RTOL and err <= tol,
           "row-sharded HODLR off: %r" % rec2)
    return [rec, rec2]


def _card_line():
    """``name, power.limit`` of the card(s), as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-card mesh phase")
    args = parser.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print("chip_smoke: no GPU; JAX's default device is %s" % dev,
              file=sys.stderr)
        return 1
    import bench  # noqa: F401  (fail before any output if the repo is
    import __graft_entry__  # noqa: F401  missing beside this script)
    from george_tpu.utils import use_compile_cache

    cache = use_compile_cache()
    print("card: %s" % _card_line(), flush=True)
    print("jax %s, compile cache %s, devices %d (%s)"
          % (jax.__version__, cache, len(jax.devices()), dev.device_kind),
          flush=True)
    from george_tpu.native import kdtree

    print("native kd-tree: %s" % ("built" if kdtree.available()
                                  else "unavailable, scipy fallback"),
          flush=True)

    if args.four:
        phase_four()
    else:
        phase_dense()
        phase_hodlr_gp()
        phase_bench()
        phase_sparse()
        phase_hmatrix()
    _emit({"ok": True, "device": {"platform": dev.platform,
                                  "kind": dev.device_kind,
                                  "count": len(jax.devices())}})
    return 0


# XLA:GPU autotunes every program on its own, and a program loaded from a
# persistent compile cache keeps the GEMM algorithms its building process
# picked, so the segmented and unsegmented NUTS programs can round one
# GEMM differently (on an H100: 9.5e-7 apart after 20 + 10 steps, and
# 10.8 in the next call). Without autotuning the picks are a function of
# the GEMM alone, and the segmented run is bit-identical again.
AUTOTUNE_OFF = "--xla_gpu_autotune_level=0"

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = " ".join(
        filter(None, (os.environ.get("XLA_FLAGS"), AUTOTUNE_OFF)))
    sys.exit(main())
