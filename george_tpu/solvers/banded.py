# -*- coding: utf-8 -*-
"""Exact block-tridiagonal Cholesky for banded sparse systems.

Sorted 1-D compact-support data (time series — the most common
large-N GP workload) produces a *banded* covariance: every row's
neighbors are a contiguous index range (``sparse.banded_offsets``).  A
band of half-width ``w`` is block-tridiagonal in blocks of size
``b >= w``, and block-tridiagonal SPD systems factor exactly by a
sequential block Cholesky:

    ``L_0 = chol(A_0)``;  ``C_i = B_i L_{i-1}^{-T}``;
    ``L_i = chol(A_i - C_i C_i^T)``

— O(n b^2) work as a ``lax.scan`` of dense ``(b, b)`` Cholesky /
triangular-solve / matmul steps, dense batched shapes.

This is the in-tree answer to the reference's **SuperLU_DIST sparse
direct** backend (``basic.py:26,177,206,258`` there): where the
iterative path pays CG iterations per solve and accepts a *stochastic*
SLQ log-determinant, the direct path gives the exact log-determinant,
exact solves, an exact triangular square root (``K + diag = W W^T``
with ``W`` block lower-bidiagonal), and — because ``cholesky``,
``solve_triangular`` and ``scan`` all have adjoints — an exactly
differentiable fused likelihood.

Everything here is pure JAX on static shapes; ``SparseSolver`` selects
this path automatically for banded single-device problems
(``direct="auto"``).
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from ..utils import full_precision_matmuls

__all__ = [
    "band_block_size",
    "band_blocks",
    "banded_cholesky",
    "banded_solve",
    "banded_sqrt_matvec",
    "banded_loglike_fn",
]


def band_block_size(n, offsets, multiple=8, max_block=512,
                    mem_budget=4 << 30, itemsize=8):
    """Block size for the block-tridiagonal view, or ``None`` when the
    direct path is not worthwhile (band too wide relative to ``n``, or
    the O(n b) block storage would blow the memory budget)."""
    w = max(int(offsets[-1]), -int(offsets[0]))
    b = max(multiple, -(-max(w, 1) // multiple) * multiple)
    if b > max_block or 2 * b >= n:
        return None
    nb = -(-n // b)
    # A + Ls + Cs + solve intermediates: ~4 (nb, b, b) arrays
    if 4 * nb * b * b * itemsize > mem_budget:
        return None
    return b


def band_blocks(vals, offsets, diag, b):
    """Block-tridiagonal view of the banded matrix ``K + diag(diag)``.

    ``vals``: ``(n, w)`` banded entries, ``vals[i, j] = K[i, i + offsets[j]]``
    (masked slots zero); ``offsets`` a contiguous integer range.  ``n`` is
    padded up to a block multiple with unit diagonal (log-det
    contribution zero, solves act as identity on pad rows).

    Returns ``(A, Bs)``: diagonal blocks ``(nb, b, b)`` and sub-diagonal
    blocks ``Bs[i] = K[block i+1, block i]`` of shape ``(nb-1, b, b)``.
    """
    n, w = vals.shape
    d_min = int(offsets[0])
    nb = -(-n // b)
    pad = nb * b - n
    valsP = jnp.pad(vals, ((0, pad), (0, 0)))
    diagP = jnp.pad(diag, (0, pad), constant_values=1.0)
    vb = valsP.reshape(nb, b, w)

    r = np.arange(b)[:, None]
    c = np.arange(b)[None, :]

    def block_of(dmap):
        j = dmap - d_min
        ok = (j >= 0) & (j < w)
        jc = np.clip(j, 0, w - 1)
        blk = vb[:, r, jc]                       # (nb, b, b)
        return jnp.where(jnp.asarray(ok), blk, 0.0)

    A = block_of(c - r) + jax.vmap(jnp.diag)(diagP.reshape(nb, b))
    Bs = block_of(c - r - b)[1:]
    return A, Bs


@full_precision_matmuls
def banded_cholesky(A, Bs):
    """Block-tridiagonal Cholesky ``K + diag = W W^T``.

    Returns ``(Ls, Cs, logdet)``: per-block lower-triangular factors
    ``(nb, b, b)``, sub-diagonal factors ``(nb-1, b, b)``
    (``W = bidiag(Ls, Cs)``), and the exact log-determinant.
    """
    L0 = jnp.linalg.cholesky(A[0])

    # rematerialized scan body: reverse-mode otherwise saves every
    # per-step triangular-solve/Cholesky residual — measured 30.9 GB of
    # HBM for the fused value_and_grad at n=2e5, band 301, vs a ~1 GB
    # forward footprint. Recomputing the step in the backward sweep
    # trades ~30% extra FLOPs for O(carry) memory per step.
    @jax.checkpoint
    def step(Lprev, AB):
        Ai, Bi = AB
        Ci = solve_triangular(Lprev, Bi.T, lower=True).T  # B L^{-T}
        Li = jnp.linalg.cholesky(Ai - Ci @ Ci.T)
        return Li, (Li, Ci)

    _, (Ltail, Cs) = jax.lax.scan(step, L0, (A[1:], Bs))
    Ls = jnp.concatenate([L0[None], Ltail], axis=0)
    diags = jax.vmap(jnp.diag)(Ls)
    logdet = 2.0 * jnp.sum(jnp.log(diags))
    return Ls, Cs, logdet


def _block_rhs(y, b):
    squeeze = y.ndim == 1
    Y = y[:, None] if squeeze else y
    n, k = Y.shape
    nb = -(-n // b)
    pad = nb * b - n
    Y = jnp.pad(Y, ((0, pad), (0, 0)))
    return Y.reshape(nb, b, k), n, squeeze


@full_precision_matmuls
def banded_solve(Ls, Cs, y):
    """``(K + diag)^{-1} y`` by forward + backward block substitution."""
    b = Ls.shape[1]
    Y, n, squeeze = _block_rhs(y, b)

    @jax.checkpoint
    def fwd(z_prev, LCY):
        Li, Ci, Yi = LCY
        zi = solve_triangular(Li, Yi - Ci @ z_prev, lower=True)
        return zi, zi

    z0 = solve_triangular(Ls[0], Y[0], lower=True)
    _, ztail = jax.lax.scan(fwd, z0, (Ls[1:], Cs, Y[1:]))
    Z = jnp.concatenate([z0[None], ztail], axis=0)

    @jax.checkpoint
    def bwd(w_next, LCZ):
        Li, Ci, Zi = LCZ
        wi = solve_triangular(
            Li.T, Zi - Ci.T @ w_next, lower=False
        )
        return wi, wi

    w_last = solve_triangular(Ls[-1].T, Z[-1], lower=False)
    _, wrev = jax.lax.scan(
        bwd, w_last, (Ls[:-1], Cs, Z[:-1]), reverse=True
    )
    W = jnp.concatenate([wrev, w_last[None]], axis=0)
    out = W.reshape(-1, W.shape[-1])[:n]
    return out[:, 0] if squeeze else out


@full_precision_matmuls
def banded_sqrt_matvec(Ls, Cs, y):
    """``W y`` with ``K + diag = W W^T`` (exact sampling transport):
    ``(Wy)_i = C_{i-1} y_{i-1} + L_i y_i`` — fully parallel, no scan."""
    b = Ls.shape[1]
    Y, n, squeeze = _block_rhs(y, b)
    out = jnp.einsum("irc,icK->irK", Ls, Y)
    out = out.at[1:].add(jnp.einsum("irc,icK->irK", Cs, Y[:-1]))
    flat = out.reshape(-1, out.shape[-1])[:n]
    return flat[:, 0] if squeeze else flat


def banded_loglike_fn(ell_values_fn, offsets, b, n_data):
    """Fused exact marginal likelihood for the banded path.

    Returns ``loglike(theta_kernel, diag, r)``: assemble the banded
    entry table, block Cholesky, block substitution, exact log-det.
    Exactly differentiable (no CG implicit solves, no SLQ estimators) —
    the banded analogue of the hierarchical solver's fused program.
    """

    @full_precision_matmuls
    def loglike(theta_k, diag, r):
        vals = ell_values_fn(theta_k)
        A, Bs = band_blocks(vals, offsets, diag, b)
        Ls, Cs, ld = banded_cholesky(A, Bs)
        z = banded_solve(Ls, Cs, r)
        quad = jnp.dot(r, z)
        return -0.5 * (
            quad + ld + n_data * jnp.log(2.0 * jnp.pi)
        )

    return loglike
