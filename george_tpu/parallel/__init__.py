# -*- coding: utf-8 -*-
"""Device-mesh distribution: chain-parallel sampling and data-parallel
prediction.

The reference's distributed story is MPI inside out-of-tree backends
(SuperLU_DIST / ButterflyPACK behind ``dPy_BPACK_wrapper``,
``basic.py:11``) plus single-process emcee walkers (SURVEY.md §2.5). The
equivalents here:

* **chain parallelism** — the sampler batch axis (walkers/chains) sharded
  over a 1-D ``('chains',)`` mesh. The samplers' cross-chain reductions
  (mean acceptance for dual averaging, pooled Welford mass estimation,
  stretch-move partner lookups) are plain ``jnp`` ops on the batch axis, so
  under ``jit`` with sharded inputs XLA lowers them to ``psum`` /
  ``all_gather`` collectives (NCCL between cards) — no hand-written
  communication.
* **data parallelism** — embarrassingly parallel axes (posterior test
  points, multi-start optimizations) sharded the same way.
* **multi-host** — ``initialize()`` wraps ``jax.distributed.initialize``;
  the same jitted functions run unchanged over a multi-host mesh.
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "initialize",
    "chain_mesh",
    "shard_chains",
    "sharded_sample_nuts",
    "sharded_sample_hmc",
    "sharded_run_ensemble",
    "sharded_predict",
]


def initialize(**kwargs):
    """Initialize the multi-host runtime (no-op if single-process)."""
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError):  # already initialized / single host
        pass


def chain_mesh(n_devices=None, axis="chains"):
    """A 1-D device mesh over (up to) ``n_devices`` devices."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[: int(n_devices)]
    return Mesh(np.array(devices), axis_names=(axis,))


def shard_chains(mesh, array, axis="chains"):
    """Place ``array`` with its leading axis sharded over the mesh.

    Works across processes: when the mesh spans devices this process
    cannot address (multi-host ``initialize()``), each process contributes
    only its addressable shards — every process must pass the same
    (replicated) host array.
    """
    spec = P(axis, *([None] * (np.ndim(array) - 1)))
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() > 1:
        host = np.asarray(array)
        return jax.make_array_from_callback(
            host.shape, sharding, lambda idx: jnp.asarray(host[idx])
        )
    return jax.device_put(jnp.asarray(array), sharding)


def _batch_sharding(mesh, ndim, axis="chains"):
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def sharded_sample_nuts(mesh, key, log_prob_fn, p0, num_warmup=500,
                        num_samples=500, **opts):
    """NUTS with the chain axis sharded over ``mesh``.

    ``p0`` ``(chains, dim)`` with ``chains`` divisible by the mesh size.
    The scan output keeps chains sharded; warmup adaptation reductions run
    as cross-device collectives.
    """
    from ..sampling.hmc import _sample

    p0 = shard_chains(mesh, p0)
    with mesh:
        samples, stats = _sample(
            key, p0, log_prob_fn, int(num_warmup), int(num_samples),
            algorithm="nuts", **opts
        )
        jax.block_until_ready(samples)
    return samples, stats


def sharded_sample_hmc(mesh, key, log_prob_fn, p0, num_warmup=500,
                       num_samples=500, **opts):
    from ..sampling.hmc import _sample

    p0 = shard_chains(mesh, p0)
    with mesh:
        samples, stats = _sample(
            key, p0, log_prob_fn, int(num_warmup), int(num_samples),
            algorithm="hmc", **opts
        )
        jax.block_until_ready(samples)
    return samples, stats


def sharded_run_ensemble(mesh, key, p0, log_prob_fn, nsteps, **opts):
    """Stretch-move ensemble with walkers sharded over ``mesh``. The
    red/black cross-half partner gathers become collectives."""
    from ..sampling.ensemble import run_ensemble

    p0 = shard_chains(mesh, p0)
    with mesh:
        chain, logps, accs = run_ensemble(
            key, p0, log_prob_fn, int(nsteps), **opts
        )
        jax.block_until_ready(chain)
    return chain, logps, accs


def _device_solve_cols(solver):
    """A jit-traceable ``R (n, k) -> K^{-1} R`` for any computed solver.

    The training axis stays whole on every device; the RHS *column* axis
    (one column per test point) is the batch axis the mesh shards, so each
    solver's device solve parallelizes over test points for free."""
    L = getattr(solver, "_L", None)
    if L is not None:  # exact/dense path
        from ..solvers.linalg import chol_solve

        Lj = jnp.asarray(L)
        return lambda R: chol_solve(Lj, R)

    struct = getattr(solver, "_struct", None)
    if struct is not None and getattr(solver, "_factors", None) is not None:
        # hierarchical path: permute + pad rows into the solver's sorted
        # layout inside the trace, solve, then scatter back
        from ..solvers.hodlr import hodlr_solve, hodlr_sqrt_solve

        perm = jnp.asarray(solver._perm)
        factors = solver._factors
        sym = bool(getattr(solver, "sym", False))

        def solve_hodlr(R):
            pad = jnp.zeros((struct.n_pad - struct.n, R.shape[1]), R.dtype)
            Rp = jnp.concatenate([R[perm], pad], axis=0)
            if sym:
                Z = hodlr_sqrt_solve(
                    factors, struct,
                    hodlr_sqrt_solve(factors, struct, Rp),
                    transpose=True,
                )
            else:
                Z = hodlr_solve(factors, struct, Rp)
            return jnp.zeros_like(R).at[perm].set(Z[: struct.n])

        return solve_hodlr

    if getattr(solver, "_hs", None) is not None:  # strong H-matrix path
        hperm = jnp.asarray(solver._perm)
        n_pad = solver._hs.n_pad
        hsolve = solver._solve

        def solve_hmat(R):
            pad = jnp.zeros((n_pad - R.shape[0], R.shape[1]), R.dtype)
            Rp = jnp.concatenate([R[hperm], pad], axis=0)
            Z, _ = hsolve(Rp)
            return jnp.zeros_like(R).at[hperm].set(Z[: R.shape[0]])

        return solve_hmat

    if getattr(solver, "_solve", None) is not None:  # sparse/CG path
        theta = solver._theta
        pad_rows = solver._pad_rows
        inner = solver._solve

        def solve_sparse(R):
            if pad_rows:
                R = jnp.pad(R, ((0, pad_rows), (0, 0)))
            Z = inner(theta, R)[0]
            return Z[: Z.shape[0] - pad_rows] if pad_rows else Z

        return solve_sparse

    raise ValueError(
        "solver %r exposes no device-side solve; compute() it first"
        % type(solver).__name__
    )


def sharded_predict(mesh, gp, y, t, return_var=True):
    """Posterior prediction with the test-point axis sharded over the mesh
    (embarrassingly parallel: each device computes its slice of the cross
    covariance and the variance reduction). Works with every solver —
    exact, hierarchical (incl. ``sym=1``), sparse and strong H-matrix —
    through each solver's own device-side ``K^{-1}`` apply."""
    gp.recompute()
    alpha = jnp.asarray(gp._compute_alpha(np.asarray(y), True))
    x = jnp.asarray(gp._x)
    ts = gp.parse_samples(t)
    n_dev = np.prod([mesh.devices.size])
    n_t = len(ts)
    pad = (-n_t) % n_dev
    ts_padded = np.concatenate([ts, np.repeat(ts[-1:], pad, axis=0)])

    pair = gp.kernel.pair_fn
    theta = jnp.asarray(gp.kernel.parameter_vector)
    solve_cols = _device_solve_cols(gp.solver)

    from ..utils import full_precision_matmuls

    @full_precision_matmuls
    def predict_block(tblk):
        Kxs = jax.vmap(
            lambda a: jax.vmap(lambda b: pair(theta, a, b))(x)
        )(tblk)
        mu = Kxs @ alpha
        KinvK = solve_cols(Kxs.T)
        kdiag = jax.vmap(lambda a: pair(theta, a, a))(tblk)
        var = kdiag - jnp.sum(Kxs.T * KinvK, axis=0)
        return mu, var

    sharding = _batch_sharding(mesh, 2)
    tj = jax.device_put(jnp.asarray(ts_padded), sharding)
    with mesh:
        mu, var = jax.jit(predict_block)(tj)
        jax.block_until_ready(mu)
    mu = np.asarray(mu)[:n_t] + gp._call_mean(ts)
    var = np.asarray(var)[:n_t]
    if return_var:
        return mu, var
    return mu
