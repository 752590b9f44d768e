# -*- coding: utf-8 -*-
"""Compact-support sparse solver (matrix-free, iterative).

In-tree replacement for the reference's two out-of-tree MPI sparse
backends (``basic.py``): SuperLU_DIST distributed sparse-direct
(``model_sparse=1``, ``basic.py:121-177,258``) and ButterflyPACK compressed
factorization (``model_bpack=1``, ``basic.py:80-118``). Instead of an
unstructured CSR direct factorization — a poor fit for batched device code — the sparse
structure lives in a static **ELL (padded-neighbor) layout** built from the
host-side radius query (``neighbors.radius_neighbors_csr``; reference
BallTree, ``kernels.py:131-144``), and everything on device is dense batched
gathers and contractions:

* matvec ``(K y)[i] = sum_j k(x_i, x_nbr[i,j]) y[nbr[i,j]]`` with kernel
  entries evaluated on the fly (matrix-free) or from a precomputed
  ``(n, k_max)`` value table;
* solves by Jacobi-preconditioned conjugate gradients (``lax.while_loop``);
* ``log_determinant`` by stochastic Lanczos quadrature (SLQ) — the same
  stochastic trace philosophy as the reference's Hutchinson gradients
  (``gp.py:506-562``), applied to logdet;
* gradients by the matrix-free identity
  ``d ll / d theta = 1/2 a^T (dK/dtheta) a - 1/2 tr(K^{-1} dK/dtheta)``
  with ``dK/dtheta`` matvecs as ``jax.jvp`` of the ELL matvec and the trace
  Hutchinson-estimated with CG solves (reference Regime B, ``gp.py:524-547``).
"""

import numpy as np

import jax
import jax.numpy as jnp

from ..neighbors import radius_neighbors_csr
from .linalg import as_points
from ..utils import full_precision_matmuls

__all__ = ["SparseSolver", "ell_from_csr", "ell_matvec", "ell_values",
           "ell_apply", "dia_apply", "banded_offsets", "cg_solve",
           "cg_diff_solve", "lanczos_fn_matvec", "slq_logdet"]


def ell_from_csr(nbr_idx, row_ptr, pad_multiple=8):
    """Convert CSR neighbor lists to a padded ELL table.

    Returns ``(nbr, mask)``: ``nbr`` ``(n, k_max)`` int32 neighbor indices
    (padded entries point at row 0), ``mask`` ``(n, k_max)`` bool.
    """
    n = len(row_ptr) - 1
    counts = np.diff(row_ptr)
    k_max = int(counts.max()) if n else 0
    k_max = max(pad_multiple, -(-k_max // pad_multiple) * pad_multiple)
    nbr = np.zeros((n, k_max), dtype=np.int32)
    mask = np.zeros((n, k_max), dtype=bool)
    # vectorized scatter (a python loop over rows dominates setup time
    # beyond n ~ 1e5): entry t of the CSR stream lands at
    # (row(t), t - row_start(row(t)))
    rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    slots = np.arange(len(nbr_idx), dtype=np.int64) - np.repeat(
        np.asarray(row_ptr[:-1], dtype=np.int64), counts
    )
    nbr[rows, slots] = nbr_idx
    mask[rows, slots] = True
    return nbr, mask


def ell_values(pair_fn, theta, x, nbr, mask):
    """Masked kernel-entry table ``vals[i, j] = k(x_i, x_nbr[i, j])``,
    shape ``(n, k_max)`` — the same footprint as the neighbor table."""
    xn = x[nbr]                                     # (n, k_max, d)
    vals = jax.vmap(
        lambda xi, xns: jax.vmap(lambda xj: pair_fn(theta, xi, xj))(xns)
    )(x, xn)                                        # (n, k_max)
    return jnp.where(mask, vals, 0.0)


@full_precision_matmuls
def ell_apply(vals, nbr, diag, y):
    """``(K + diag) y`` from a precomputed value table: one neighbor
    gather + one per-row contraction per application. Iterative loops
    (CG, Lanczos) should hoist ``ell_values`` out and apply this —
    re-evaluating the kernel's transcendentals every iteration costs
    more than the gather+contract itself."""
    squeeze = y.ndim == 1
    Y = y[:, None] if squeeze else y
    out = jnp.einsum("ik,ikr->ir", vals, Y[nbr]) + diag[:, None] * Y
    return out[:, 0] if squeeze else out


def ell_matvec(pair_fn, theta, x, nbr, mask, diag, y):
    """``(K + diag) y`` with on-the-fly masked kernel entries (matrix-free
    in ``theta`` — the form to ``jax.jvp`` for dK/dtheta matvecs).

    ``y`` may be ``(n,)`` or ``(n, k)`` — the neighbor gather and the
    per-row contraction are dense ops on static shapes.
    """
    return ell_apply(ell_values(pair_fn, theta, x, nbr, mask), nbr, diag, y)


def banded_offsets(nbr_idx, row_ptr):
    """Detect a banded neighbor structure and return its diagonal offsets.

    For sorted 1-D inputs a radius query returns CONTIGUOUS neighbor
    ranges ``[lo_i, hi_i]`` around each row; the sparse matrix is then a
    variable-width band and the matvec needs no gathers at all — only
    statically shifted slices (``dia_apply``). Returns
    ``(offsets, lo, hi)`` — the offset array ``d_min..d_max`` and the
    per-row neighbor bounds — if every row is contiguous, else ``None``.
    """
    n = len(row_ptr) - 1
    if n == 0 or len(nbr_idx) == 0:
        return None
    counts = np.diff(row_ptr)
    starts = row_ptr[:-1]
    if not np.all(counts > 0):
        # empty rows cannot occur with a self-including radius query;
        # in a user CSR they would poke holes in the boundary bookkeeping
        return None
    # rows must be strictly increasing: max-min+1 == count alone is
    # fooled by duplicate indices in a user-provided CSR (e.g. [1,1,3]),
    # which would silently synthesize a DIFFERENT matrix
    d = np.diff(nbr_idx)
    row_boundary = np.zeros(len(d), dtype=bool)
    inner = row_ptr[1:-1]
    row_boundary[inner[(inner > 0) & (inner <= len(d))] - 1] = True
    if not np.all(d[~row_boundary] > 0):
        return None
    # per-row min/max in O(nnz)
    lo = np.minimum.reduceat(nbr_idx, starts[counts > 0])
    hi = np.maximum.reduceat(nbr_idx, starts[counts > 0])
    if not np.array_equal(hi - lo + 1, counts[counts > 0]):
        return None
    # rows with zero neighbors would make reduceat misalign; rebuild full
    lo_full = np.zeros(n, dtype=np.int64)
    hi_full = np.full(n, -1, dtype=np.int64)
    nz = counts > 0
    lo_full[nz], hi_full[nz] = lo, hi
    rows = np.arange(n)
    d_min = int(np.min(lo_full[nz] - rows[nz])) if nz.any() else 0
    d_max = int(np.max(hi_full[nz] - rows[nz])) if nz.any() else 0
    # sanity: the implied band must reproduce the exact sparsity count
    width = d_max - d_min + 1
    if width > 4 * max(int(counts.max()), 1):
        # pathological spread — the padded band would waste memory
        return None
    return (
        np.arange(d_min, d_max + 1, dtype=np.int64), lo_full, hi_full
    )


def banded_ell_tables(offsets, lo, hi, n):
    """Synthesize the (nbr, mask) ELL tables of a banded structure so the
    same ``ell_values`` kernel-entry evaluation serves the DIA path."""
    rows = np.arange(n, dtype=np.int64)[:, None]
    cols = rows + offsets[None, :]
    mask = (cols >= lo[:, None]) & (cols <= hi[:, None])
    mask &= (cols >= 0) & (cols < n)
    nbr = np.clip(cols, 0, n - 1).astype(np.int32)
    return nbr, mask


@full_precision_matmuls
def dia_apply(vals, offsets, diag, y):
    """``(K + diag) y`` for a banded structure: every "neighbor slot" is
    a static diagonal offset, so each contribution is an elementwise
    product with a *contiguous shifted slice* of ``y`` — no gathers, the
    memory pattern XLA fuses best."""
    squeeze = y.ndim == 1
    Y = y[:, None] if squeeze else y
    n = Y.shape[0]
    lo = int(-min(offsets))
    hi = int(max(offsets))
    Ypad = jnp.pad(Y, ((max(lo, 0), max(hi, 0)), (0, 0)))
    out = diag[:, None] * Y
    base = max(lo, 0)
    for j, d in enumerate(offsets):
        shifted = jax.lax.slice_in_dim(Ypad, base + int(d),
                                       base + int(d) + n, axis=0)
        out = out + vals[:, j:j + 1] * shifted
    return out[:, 0] if squeeze else out


@full_precision_matmuls
def lanczos_fn_matvec(matvec, b, fn, num_steps=40):
    """``f(A) b`` for SPD ``A`` by the Lanczos method: ``b`` spans a
    Krylov space ``V_m``, ``A`` restricted to it is the tridiagonal
    ``T_m``, and ``f(A) b ~= ||b|| V_m f(T_m) e1``. Exact when ``A``'s
    action on the Krylov space is captured (m >= matrix size), and
    spectrally accurate long before that for smooth ``f`` — the same
    machinery as :func:`slq_logdet` but returning the transported vector
    instead of a quadrature. ``b``: ``(n,)``."""
    dtype = b.dtype
    beta0 = jnp.linalg.norm(b)
    v0 = b / jnp.where(beta0 > 0, beta0, 1.0)

    def step(carry, _):
        v_prev, v, beta_prev = carry
        w = matvec(v) - beta_prev * v_prev
        alpha = jnp.dot(w, v)
        w = w - alpha * v
        w = w - jnp.dot(w, v_prev) * v_prev
        beta = jnp.linalg.norm(w)
        v_next = w / jnp.where(beta > 0, beta, 1.0)
        return (v, v_next, beta), (v, alpha, beta)

    _, (V, alphas, betas) = jax.lax.scan(
        step, (jnp.zeros_like(v0), v0, jnp.zeros((), dtype)), None,
        length=num_steps,
    )                                           # V: (m, n)
    T = (
        jnp.diag(alphas)
        + jnp.diag(betas[:-1], 1)
        + jnp.diag(betas[:-1], -1)
    )
    evals, evecs = jnp.linalg.eigh(T)
    coeff = evecs @ (fn(jnp.maximum(evals, 0.0)) * evecs[0, :])
    return beta0 * (V.T @ coeff)


def cg_diff_solve(matvec, b, precond_diag, tol=1e-10, maxiter=1000):
    """Differentiable SPD solve: CG wrapped in
    ``lax.custom_linear_solve`` so reverse mode flows by implicit
    differentiation (one extra CG solve for the cotangent) instead of
    trying to unroll the ``while_loop`` — that is what lets the sparse
    likelihood be a single ``jax.grad``-able program like the
    hierarchical one."""
    def solve_fn(mv, rhs):
        return cg_solve(mv, rhs, precond_diag, tol=tol,
                        maxiter=maxiter)[0]

    return jax.lax.custom_linear_solve(
        matvec, b, solve_fn, symmetric=True
    )


def cg_solve(matvec, b, precond_diag, tol=1e-10, maxiter=1000):
    """Jacobi-preconditioned CG for SPD ``A x = b`` (vector or multi-RHS)."""
    squeeze = b.ndim == 1
    B = b[:, None] if squeeze else b
    Minv = 1.0 / precond_diag

    def mv(X):
        return matvec(X)

    X = jnp.zeros_like(B)
    R = B - mv(X)
    Z = Minv[:, None] * R
    P = Z
    rz = jnp.sum(R * Z, axis=0)
    b2 = jnp.maximum(jnp.sum(B * B, axis=0), jnp.finfo(B.dtype).tiny)

    def cond(state):
        X, R, P, rz, it = state
        return jnp.logical_and(
            it < maxiter,
            jnp.any(jnp.sum(R * R, axis=0) / b2 > tol * tol),
        )

    def body(state):
        X, R, P, rz, it = state
        AP = mv(P)
        denom = jnp.sum(P * AP, axis=0)
        alpha = rz / jnp.where(denom > 0, denom, 1.0)
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * AP
        Z = Minv[:, None] * R
        rz_new = jnp.sum(R * Z, axis=0)
        beta = rz_new / jnp.where(rz > 0, rz, 1.0)
        P = Z + beta[None, :] * P
        return X, R, P, rz_new, it + 1

    X, R, _, _, iters = jax.lax.while_loop(
        cond, body, (X, R, P, rz, jnp.zeros((), jnp.int32))
    )
    return (X[:, 0] if squeeze else X), iters


@full_precision_matmuls
def slq_logdet(matvec, n, dtype, key, num_probes=16, num_steps=30,
               return_std=False):
    """Stochastic Lanczos quadrature estimate of ``log det A`` for SPD A.

    Rademacher probes, ``num_steps`` Lanczos iterations each (batched via
    ``vmap``), Gauss quadrature from the tridiagonal eigendecomposition.

    With ``return_std=True`` also returns the Monte-Carlo standard error
    of the estimate (std of the per-probe values / sqrt(num_probes)) so
    callers can judge whether the objective noise floor is acceptable.
    Variance control across hyperparameters is by **common random
    numbers**: pass the same ``key`` for every theta (the solver does, by
    seeding from its own fixed ``seed``) and the probe-set error largely
    cancels in likelihood *differences*, which is what optimizers and
    samplers consume.
    """
    probes = jax.random.rademacher(
        key, (num_probes, n), dtype=dtype
    )

    def lanczos(v0):
        v0 = v0 / jnp.linalg.norm(v0)

        def step(carry, _):
            v_prev, v, beta_prev = carry
            w = matvec(v) - beta_prev * v_prev
            alpha = jnp.dot(w, v)
            w = w - alpha * v
            # one round of full reorthogonalization-lite against v_prev
            w = w - jnp.dot(w, v_prev) * v_prev
            beta = jnp.linalg.norm(w)
            v_next = w / jnp.where(beta > 0, beta, 1.0)
            return (v, v_next, beta), (alpha, beta)

        (_, _, _), (alphas, betas) = jax.lax.scan(
            step, (jnp.zeros_like(v0), v0, jnp.zeros((), dtype)), None,
            length=num_steps,
        )
        T = (
            jnp.diag(alphas)
            + jnp.diag(betas[:-1], 1)
            + jnp.diag(betas[:-1], -1)
        )
        evals, evecs = jnp.linalg.eigh(T)
        evals = jnp.maximum(evals, jnp.finfo(dtype).tiny)
        tau2 = evecs[0, :] ** 2
        return jnp.sum(tau2 * jnp.log(evals))

    estimates = jax.vmap(lanczos)(probes)
    mean = n * jnp.mean(estimates)
    if return_std:
        stderr = (
            n * jnp.std(estimates) / jnp.sqrt(float(num_probes))
        )
        return mean, stderr
    return mean


class SparseSolver(object):
    """Compact-support sparse solver with the george solver protocol.

    Requires a kernel with a finite :func:`get_cutoff` (e.g.
    :class:`WendlandC2Kernel`) or an explicit ``radius``.

    :param kernel: covariance kernel.
    :param radius: sparsity radius override (default: kernel cutoff).
    :param cg_tol: relative CG tolerance.
    :param maxiter: CG iteration cap.
    :param num_probes: SLQ probe count for logdet / Hutchinson gradients
        (the reference uses ``nvec = 10``, ``gp.py:448``).
    :param num_steps: SLQ Lanczos steps.
    :param seed: probe RNG seed.
    :param direct: ``"auto"`` (default) factors banded single-device
        structures (sorted 1-D compact support) EXACTLY by a
        block-tridiagonal Cholesky (``solvers/banded.py``) — exact
        logdet, solves, gradients, triangular ``apply_sqrt``;
        ``False`` always uses the iterative CG + SLQ machinery;
        ``True`` requires the direct path and raises if infeasible.
    """

    matrix_free = True

    def __init__(self, kernel, radius=None, cg_tol=1e-10, maxiter=1000,
                 num_probes=16, num_steps=30, seed=42, mesh=None,
                 shard_axis="data", direct="auto", **kwargs):
        self.kernel = kernel
        self.radius = radius
        # banded DIRECT factorization (solvers/banded.py): exact logdet/
        # solves/gradients for sorted-1-D compact support — the in-tree
        # analogue of the reference's SuperLU_DIST sparse-direct backend.
        if direct not in ("auto", True, False):
            raise ValueError(
                "direct must be 'auto', True, or False, got %r" % (direct,)
            )
        self.direct = direct
        self.cg_tol = float(cg_tol)
        self.maxiter = int(maxiter)
        self.num_probes = int(num_probes)
        self.num_steps = int(num_steps)
        self.seed = int(seed)
        # Optional row sharding over a device mesh: the ELL tables and all
        # row vectors are placed sharded, and XLA inserts the collectives
        # (all-gather for the neighbor gathers, psum for CG dot products)
        # — the in-tree replacement for the reference's MPI SuperLU_DIST
        # distribution (SURVEY.md §2.5).
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.computed = False
        self.log_determinant = None
        self._x = None
        self._nbr = None
        self._mask = None
        self._diag = None

    def compute(self, x, yerr=0.0, nns=None, **kwargs):
        x = as_points(x)
        n = len(x)
        yerr2 = np.atleast_1d(np.asarray(yerr, dtype=np.float64)) ** 2
        if yerr2.size == 1:
            yerr2 = yerr2 * np.ones(n)

        radius = self.radius
        if radius is None:
            radius = self.kernel.get_cutoff()
        from ..neighbors import normalize_nns

        nns = normalize_nns(nns)
        if isinstance(nns, tuple):
            nbr_idx, row_ptr = nns
        elif nns is not None and np.ndim(nns) == 2:
            # rectangular kNN matrix (the hierarchical solver's format):
            # symmetrized union pattern incl. self-pairs — CG/SLQ need a
            # symmetric operator and the diagonal must be in the pattern
            from ..neighbors import knn_matrix_to_csr

            nbr_idx, row_ptr = knn_matrix_to_csr(nns, n)
        else:
            nbr_idx, row_ptr = radius_neighbors_csr(x, float(radius))
        self.nnz = int(row_ptr[-1])
        # banded (DIA) fast path: sorted-1-D radius neighborhoods are
        # contiguous, so the matvec becomes static shifted slices
        # instead of gathers (single-device only; under a mesh the
        # gather form is what GSPMD partitions)
        self._dia_offsets = None
        band = banded_offsets(nbr_idx, row_ptr) if self.mesh is None \
            else None
        if band is not None:
            offsets, lo_rows, hi_rows = band
            nbr_np, mask_np = banded_ell_tables(offsets, lo_rows,
                                                hi_rows, n)
            self._dia_offsets = offsets
        else:
            nbr_np, mask_np = ell_from_csr(nbr_idx, row_ptr)
        self._pad_rows = 0
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            ndev = int(np.prod(list(self.mesh.shape.values())))
            pad = (-n) % ndev
            self._pad_rows = pad
            if pad:
                # padded rows: self-neighbor only, zero mask, unit diag
                nbr_np = np.concatenate(
                    [nbr_np,
                     np.zeros((pad, nbr_np.shape[1]), nbr_np.dtype)]
                )
                mask_np = np.concatenate(
                    [mask_np,
                     np.zeros((pad, mask_np.shape[1]), bool)]
                )
                x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
                yerr2 = np.concatenate([yerr2, np.ones(pad)])
            row_shard = NamedSharding(
                self.mesh, P(self.shard_axis, None)
            )
            vec_shard = NamedSharding(self.mesh, P(self.shard_axis))
            self._nbr = jax.device_put(jnp.asarray(nbr_np), row_shard)
            self._mask = jax.device_put(jnp.asarray(mask_np), row_shard)
            # coordinates replicate (every device gathers arbitrary rows)
            self._x = jax.device_put(
                jnp.asarray(x), NamedSharding(self.mesh, P(None, None))
            )
            self._diag = jax.device_put(jnp.asarray(yerr2), vec_shard)
            self._vec_shard = vec_shard
        else:
            self._nbr = jnp.asarray(nbr_np)
            self._mask = jnp.asarray(mask_np)
            self._x = jnp.asarray(x)
            self._diag = jnp.asarray(yerr2)
        n = n + self._pad_rows

        pair = self.kernel.pair_fn
        nbr, mask, diag = self._nbr, self._mask, self._diag

        def mv(th, Y):
            return ell_matvec(pair, th, self._x, nbr, mask, diag, Y)

        self._mv = jax.jit(mv)
        theta = jnp.asarray(self.kernel.parameter_vector)
        self._theta = theta

        # Jacobi preconditioner diagonal: k(x_i, x_i) + yerr2.
        kdiag = jax.vmap(lambda xi: pair(theta, xi, xi))(self._x)
        self._pdiag = kdiag + diag

        # f32 cannot reach 1e-10 residuals: floor the tolerance at the
        # dtype's achievable accuracy so CG terminates in f32
        eff_tol = max(
            self.cg_tol, 30.0 * float(np.finfo(self._x.dtype).eps)
        )

        # Fixed-theta application for iterative loops: the kernel-entry
        # table is hoisted out of the iteration, and banded structures
        # apply by shifted slices instead of gathers (XLA fuses the D
        # shifted multiply-adds into one loop).
        offsets = self._dia_offsets

        def apply_fixed(vals, Y):
            if offsets is not None:
                return dia_apply(vals, offsets, diag, Y)
            return ell_apply(vals, nbr, diag, Y)

        def solve(th, B):
            vals = ell_values(pair, th, self._x, nbr, mask)
            return cg_solve(
                lambda Y: apply_fixed(vals, Y),
                B, self._pdiag, tol=eff_tol, maxiter=self.maxiter,
            )

        self._solve = jax.jit(solve)

        def sqrt_batch(th, B, m):
            # rows of B transported by (K + diag)^{1/2}; reuses the same
            # fixed-theta application as CG/SLQ (incl. the banded fast
            # path), with the entry table traced once per
            # (shape, m) instead of captured as a closure constant
            vals = ell_values(pair, th, self._x, nbr, mask)
            return jax.vmap(
                lambda b: lanczos_fn_matvec(
                    lambda v: apply_fixed(vals, v), b, jnp.sqrt,
                    num_steps=m,
                )
            )(B)

        self._sqrt_batch = jax.jit(sqrt_batch, static_argnums=(2,))

        # Banded DIRECT path (solvers/banded.py): exact block-tridiagonal
        # Cholesky replaces CG solves and the stochastic SLQ logdet —
        # the reference's sparse-direct semantics (SuperLU_DIST,
        # ``basic.py:177,206,258`` there) with batched (b, b) scan
        # steps.
        self._direct_loglike = None
        self._direct_grad = None
        use_direct = (
            offsets is not None
            and self.mesh is None
            and self.direct in ("auto", True)
        )
        bsz = None
        if use_direct:
            from .banded import band_block_size

            bsz = band_block_size(
                n, offsets, itemsize=self._x.dtype.itemsize
            )
            use_direct = bsz is not None
        if self.direct is True and not use_direct:
            if self.mesh is not None:
                reason = (
                    "the direct factorization is single-device only; "
                    "drop mesh= or use direct=False"
                )
            elif offsets is None:
                reason = (
                    "the structure is not banded — it needs sorted "
                    "1-D compact-support data"
                )
            else:
                reason = "the band is infeasibly wide for this n"
            raise ValueError("direct=True, but " + reason)

        if use_direct:
            from .banded import (
                band_blocks, banded_cholesky, banded_solve,
                banded_sqrt_matvec, banded_loglike_fn,
            )

            def ev(th):
                return ell_values(pair, th, self._x, nbr, mask)

            fused = banded_loglike_fn(ev, offsets, bsz, n)
            self._direct_loglike = jax.jit(fused)
            self._direct_grad = jax.jit(jax.grad(fused, argnums=(0, 1)))

            # factor ONCE at the compute-time theta (the dense solver's
            # Cholesky discipline); solves/sampling reuse the factors.
            # Every internal _solve/_sqrt_batch call site passes
            # th == self._theta, so the theta argument is vestigial here.
            Ls, Cs, ld = jax.jit(
                lambda th: banded_cholesky(
                    *band_blocks(ev(th), offsets, diag, bsz)
                )
            )(theta)
            if not bool(jnp.isfinite(ld)):
                raise np.linalg.LinAlgError(
                    "banded Cholesky log-determinant is not finite"
                )
            self._band_factors = (Ls, Cs)
            bsolve = jax.jit(banded_solve)
            bsqrt = jax.jit(banded_sqrt_matvec)

            def dsolve(th, B):
                Lf, Cf = self._band_factors
                return bsolve(Lf, Cf, B), jnp.zeros((), jnp.int32)

            self._solve = dsolve

            def dsqrt(th, B, m):
                # exact triangular transport W with K + diag = W W^T;
                # the Lanczos step count m is irrelevant here
                Lf, Cf = self._band_factors
                return bsqrt(Lf, Cf, B.T).T

            self._sqrt_batch = dsqrt
        else:
            def logdet_fn(th, key):
                vals = ell_values(pair, th, self._x, nbr, mask)
                return slq_logdet(
                    lambda v: apply_fixed(vals, v),
                    n, self._x.dtype, key,
                    num_probes=self.num_probes,
                    num_steps=self.num_steps,
                )

            ld = jax.jit(logdet_fn)(theta, jax.random.PRNGKey(self.seed))
            if not bool(jnp.isfinite(ld)):
                raise np.linalg.LinAlgError("SLQ log-determinant diverged")
        self.log_determinant = float(ld)
        self.computed = True

    def loglike_fn(self):
        """Pure ``f(theta_kernel, diag, r) -> log-likelihood`` through
        the sparse machinery (same contract as the hierarchical
        solver's): CG quadratic term via a ``custom_linear_solve`` (so
        ``jax.grad`` flows by implicit differentiation) and an SLQ log
        determinant with common random numbers across theta (the probe
        set is fixed by the solver seed, so likelihood *differences* —
        what optimizers and samplers consume — largely cancel the MC
        noise). This is what lets ``GP.log_prob_fn`` drive samplers
        through the compact-support path instead of falling back to a
        dense O(n^2) assembly."""
        if getattr(self, "_direct_loglike", None) is not None:
            # banded direct: exact, deterministic, and exactly
            # differentiable — no CG implicit solves, no SLQ noise
            return self._direct_loglike
        pair = self.kernel.pair_fn
        nbr, mask = self._nbr, self._mask
        x = self._x
        n_pad = x.shape[0]
        n = n_pad - self._pad_rows
        offsets = (
            None if self._dia_offsets is None
            else np.asarray(self._dia_offsets)
        )
        pad = self._pad_rows
        eff_tol = max(
            self.cg_tol, 30.0 * float(np.finfo(x.dtype).eps)
        )
        maxiter = self.maxiter
        num_probes, num_steps = self.num_probes, self.num_steps
        key = jax.random.PRNGKey(self.seed)

        # the diagonal of K is a column of the value table (the radius
        # query includes self-neighbors); locate each row's self slot
        # once so the CG preconditioner needs no extra kernel pass. Only
        # MASKED-VALID slots count: on the banded path boundary rows
        # carry clipped out-of-band slots that also point at the row
        # (nbr clipped to [0, n-1], mask False, value 0) and argmax on
        # nbr alone would land there, zeroing the preconditioner entry.
        nbr_np = np.asarray(nbr)
        mask_np = np.asarray(mask)
        is_self = (nbr_np == np.arange(n_pad)[:, None]) & mask_np
        self_slot = jnp.asarray(
            np.argmax(is_self, axis=1), dtype=jnp.int32
        )
        # padded mesh rows have no self entry; their vals row is all
        # zero, so the gathered entry is 0 and diag_pad (=1) dominates
        rows_idx = jnp.arange(n_pad)

        def apply_of(vals, diag_pad, Y):
            if offsets is not None:
                return dia_apply(vals, offsets, diag_pad, Y)
            return ell_apply(vals, nbr, diag_pad, Y)

        def pdiag_of(vals, diag_pad):
            return vals[rows_idx, self_slot] + diag_pad

        # log-determinant with a custom adjoint: the forward value is
        # the (CRN) SLQ estimate; the backward pass is the Hutchinson
        # trace identity grad logdet = tr(K^{-1} dK) with the SAME probe
        # set and CG solves — the reference's own split (SLQ-style value,
        # Hutchinson gradient, ``gp.py:506-562`` there). Differentiating
        # *through* Lanczos instead NaNs on breakdown (degenerate
        # tridiagonal eigenvalues have no eigh adjoint).
        @jax.custom_vjp
        def slq_ld(vals, diag_pad):
            return slq_logdet(
                lambda v: apply_of(vals, diag_pad, v), n_pad, x.dtype,
                key, num_probes=num_probes, num_steps=num_steps,
            )

        def slq_ld_fwd(vals, diag_pad):
            return slq_ld(vals, diag_pad), (vals, diag_pad)

        def slq_ld_bwd(res, g):
            vals, diag_pad = res
            # the SAME probe set as the forward SLQ estimate (which draws
            # (num_probes, n_pad) rows) — CRN between value and gradient
            V = jax.random.rademacher(
                key, (num_probes, n_pad), dtype=vals.dtype
            ).T
            KinvV, _ = cg_solve(
                lambda Y: apply_of(vals, diag_pad, Y), V,
                pdiag_of(vals, diag_pad), tol=eff_tol, maxiter=maxiter,
            )
            # d logdet / d diag_i = (K^{-1})_{ii}
            bar_diag = g * jnp.mean(V * KinvV, axis=1)
            # d logdet / d vals[i, j] = (K^{-1})_{nbr[i,j], i}. Accumulate
            # probe by probe under lax.scan so live memory is bounded at
            # ~2 value tables BY CONSTRUCTION — a per-slot Python loop
            # left all w gather columns live simultaneously and cost
            # 30.9 GB of HBM at n=2e5, band 301 (XLA would not
            # sequentialize it)
            def one_probe(acc, vk):
                vp, kp = vk                          # (n,), (n,)
                return acc + vp[:, None] * kp[nbr], None

            acc, _ = jax.lax.scan(
                one_probe, jnp.zeros_like(vals), (V.T, KinvV.T)
            )
            bar_vals = g * (acc / num_probes) * mask
            return bar_vals, bar_diag

        slq_ld.defvjp(slq_ld_fwd, slq_ld_bwd)

        @full_precision_matmuls
        def loglike(theta_k, diag, r):
            diag_pad = (
                jnp.concatenate([diag, jnp.ones(pad, dtype=diag.dtype)])
                if pad else diag
            )
            r_pad = (
                jnp.concatenate([r, jnp.zeros(pad, dtype=r.dtype)])
                if pad else r
            )
            # remat the entry table: its elementwise VJP chain otherwise
            # saves O(10) live (n, w) intermediates across the whole
            # likelihood graph
            vals = jax.checkpoint(
                lambda th: ell_values(pair, th, x, nbr, mask)
            )(theta_k)
            z = cg_diff_solve(
                lambda Y: apply_of(vals, diag_pad, Y), r_pad,
                pdiag_of(vals, diag_pad), tol=eff_tol, maxiter=maxiter,
            )
            quad = jnp.dot(r_pad, z)
            ld = slq_ld(vals, diag_pad)
            return -0.5 * (quad + ld + n * jnp.log(2.0 * jnp.pi))

        return loglike

    # -- protocol ----------------------------------------------------------

    def _pad(self, y):
        y = jnp.asarray(np.asarray(y, dtype=np.float64))
        if self._pad_rows:
            widths = ((0, self._pad_rows),) + ((0, 0),) * (y.ndim - 1)
            y = jnp.pad(y, widths)
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            spec = P(self.shard_axis, *([None] * (y.ndim - 1)))
            y = jax.device_put(y, NamedSharding(self.mesh, spec))
        return y

    def _unpad(self, z):
        z = np.asarray(z)
        return z[: len(z) - self._pad_rows] if self._pad_rows else z

    def apply_inverse(self, y, in_place=False):
        z, _ = self._solve(self._theta, self._pad(y))
        return self._unpad(z)

    def dot_solve(self, y):
        y = self._pad(y)
        z, _ = self._solve(self._theta, y)
        return float(jnp.dot(y, z))

    def apply_forward(self, y, i=0):
        y = self._pad(y)
        if i == 0:
            return self._unpad(self._mv(self._theta, y))
        tangent = jnp.zeros_like(self._theta).at[i - 1].set(1.0)
        _, Z = jax.jvp(
            lambda th: self._mv(th, y), (self._theta,), (tangent,)
        )
        return self._unpad(Z)

    def get_inverse(self):
        # self._x carries the mesh padding rows; the identity must be the
        # *unpadded* size or the result keeps pad columns.
        n = self._x.shape[0] - self._pad_rows
        return self.apply_inverse(np.eye(n))

    def apply_sqrt(self, r, num_steps=None):
        """Rows of ``r`` transported by a square root of ``K + diag``
        (the ``R = apply_sqrt(I)``, ``R^T R = K + diag`` contract of the
        dense solver) — prior-sampling support the reference's sparse
        backend lacks (its ``apply_sqrt`` is dense-only,
        ``basic.py:284-302`` there).

        On the banded direct path this is the EXACT triangular Cholesky
        factor ``W`` (``K + diag = W W^T``; ``num_steps`` is ignored,
        and ``apply_sqrt`` applied twice is NOT ``(K + diag) r`` — the
        factor is triangular, not symmetric). Otherwise it is the
        symmetric square root via Lanczos ``f(A) b``, spectrally
        accurate in ``num_steps`` iterations (default: the solver's
        ``num_steps``, floored at 30)."""
        m = int(num_steps) if num_steps is not None else max(
            self.num_steps, 30
        )
        r = np.asarray(r, dtype=np.float64)
        squeeze = r.ndim == 1
        R = r[None, :] if squeeze else r            # (size, n)
        cols = self._sqrt_batch(
            self._theta, jnp.asarray(self._pad(R.T).T), m
        )
        out = self._unpad(np.asarray(cols).T).T
        return out[0] if squeeze else out

    # -- matrix-free gradient (reference Regime B, gp.py:506-562) ----------

    def grad_log_likelihood(self, gp, x, alpha, unfrozen_mask):
        """Gradient of the GP marginal likelihood using Hutchinson traces.

        Returns the gradient over the *active* GP parameter vector (mean,
        white-noise, kernel blocks), matching ``GP.grad_log_likelihood``.

        On the banded direct path the whole gradient is EXACT: the
        kernel and white-noise blocks come out of one reverse sweep of
        the fused block-Cholesky likelihood (``jax.grad`` w.r.t. theta
        and the diagonal), replacing the Hutchinson trace estimates.
        """
        if getattr(self, "_direct_grad", None) is not None:
            alpha_j = jnp.asarray(np.asarray(alpha))
            r = self._mv(self._theta, alpha_j)      # (K + diag) alpha
            g_theta, g_diag = self._direct_grad(self._theta, self._diag, r)
            g_theta = np.asarray(g_theta)
            g_diag = np.asarray(g_diag)             # = 0.5(a_i^2 - K^{-1}_ii)
            mean_g = []
            if len(gp.mean):
                mu_g = gp._call_mean_gradient(np.asarray(x))
                mean_g = list(np.dot(mu_g, np.asarray(alpha)))
            wn_g = []
            if len(gp.white_noise):
                wn = gp._call_white_noise(np.asarray(x))
                wng = gp._call_white_noise_gradient(np.asarray(x))
                wn_g = list(
                    np.sum((np.exp(wn) * g_diag)[None, :] * wng, axis=1)
                )
            kmask = gp.kernel.unfrozen_mask
            return np.array(mean_g + wn_g + list(g_theta[kmask]))

        alpha = jnp.asarray(np.asarray(alpha))
        theta = self._theta
        nparam = int(theta.shape[0])
        key = jax.random.PRNGKey(self.seed + 1)
        probes = self._pad(
            np.asarray(
                jax.random.rademacher(
                    key, (self.num_probes, alpha.shape[0]),
                    dtype=alpha.dtype,
                )
            ).T
        )                                             # (n_pad, num_probes)
        alpha_p = self._pad(alpha)
        # Solve K^{-1} u for all probes at once (multi-RHS CG).
        Kinv_u, _ = self._solve(theta, probes)

        grads = np.zeros(nparam)
        for k in range(nparam):
            tangent = jnp.zeros_like(theta).at[k].set(1.0)
            _, dK_alpha = jax.jvp(
                lambda th: self._mv(th, alpha_p), (theta,), (tangent,)
            )
            alpha_term = 0.5 * float(jnp.dot(alpha_p, dK_alpha))
            _, dK_u = jax.jvp(
                lambda th: self._mv(th, probes), (theta,), (tangent,)
            )
            # d(diag)/dtheta = 0, so the jvp is exactly (dK/dtheta_k) u
            trace_est = float(
                jnp.mean(jnp.sum(Kinv_u * dK_u, axis=0))
            )
            grads[k] = alpha_term - 0.5 * trace_est

        # Assemble into the GP's active-parameter layout: the kernel block
        # sits after mean and white-noise blocks; mean/WN gradients use the
        # exact formulas (they are diagonal/cheap).
        mean_g = []
        if len(gp.mean):
            mu_g = gp._call_mean_gradient(np.asarray(x))
            mean_g = list(np.dot(mu_g, np.asarray(alpha)))
        wn_g = []
        if len(gp.white_noise):
            wn = gp._call_white_noise(np.asarray(x))
            wng = gp._call_white_noise_gradient(np.asarray(x))
            # diag(A) = alpha^2 - diag(K^{-1}); estimate diag(K^{-1}) by
            # Hutchinson with the same probes
            diag_Kinv = self._unpad(jnp.mean(probes * Kinv_u, axis=1))
            diag_A = np.asarray(alpha) ** 2 - diag_Kinv
            wn_g = list(
                0.5 * np.sum((np.exp(wn) * diag_A)[None, :] * wng, axis=1)
            )

        kmask = gp.kernel.unfrozen_mask
        out = np.array(mean_g + wn_g + list(grads[kmask]))
        return out

    def __getstate__(self):
        state = self.__dict__.copy()
        for k in ("_mv", "_solve", "_sqrt_batch", "_direct_loglike",
                  "_direct_grad", "_band_factors", "_x", "_nbr", "_mask",
                  "_diag", "_pdiag", "_theta"):
            state.pop(k, None)
        state["computed"] = False
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
