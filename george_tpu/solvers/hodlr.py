# -*- coding: utf-8 -*-
"""Hierarchical (HODLR-class) solver.

Re-designs the reference's recursive C++ HODLR engine (``hodlr.h:20-989``,
``_hodlr.cpp``) as a *level-by-level, fully batched, static-shape* JAX
computation:

* The recursive binary tree (``hodlr.h:38-102``) becomes ``L = log2(n/m)``
  levels processed coarsest-to-finest as stacked arrays; every per-node
  operation is a batched matmul/Cholesky over all nodes of a level at once.
* Adaptive-rank ACA with random pivoting (``hodlr.h:303-680``) becomes a
  **fixed-rank skeleton (CUR) compression** with seeded stratified pivots
  and a ridge-regularized interpolation solve: static shapes, matmul-heavy,
  deterministic — the static-shape answer to data-dependent ranks
  (SURVEY.md §7).
* The factorization identity is the classic SMW cascade the reference
  implements node-by-node (``hodlr.h:111-165, 682-711``):

      K = D · F_L · F_{L-1} ... F_1,

  where ``D`` is the block-diagonal of leaf boxes (batched Cholesky) and
  ``F_l = I + W_l Z_l^T`` is block-diagonal over the 2^{l-1} sibling pairs
  of level ``l``, with ``Z_l`` holding the raw low-rank factors and ``W_l``
  the same factors with all *finer* factors' inverses applied (the
  reference's ancestor-update sweep, ``hodlr.h:153-164``). Each pair's
  2c x 2c SMW core ``I + Z^T W`` is formed and inverted batched; the log
  determinant accumulates batched leaf Cholesky diagonals and core
  ``slogdet``s (``hodlr.h:122-151``).
* Hyperparameter gradients do not need the reference's per-parameter
  gradient trees (``_hodlr.cpp:171-191``) or Hutchinson estimators
  (``gp.py:506-562``): the whole factorization is differentiable JAX code,
  so ``jax.grad`` of :func:`HODLRSolver.loglike_fn` gives the exact
  gradient of the compressed likelihood in one reverse sweep. A Hutchinson
  estimator is still available via :func:`apply_forward` jvp matvecs for
  parity experiments.

Points are pre-sorted host-side with a Morton/argsort ordering
(``neighbors.morton_sort_samples``; reference ``utils.py:36-56``) so
off-diagonal blocks are numerically low-rank; only the permutation and the
static pivot index sets cross to the device.
"""

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..neighbors import morton_sort_samples
from .linalg import as_points
from ..utils import full_precision_matmuls, pinned_full_precision

__all__ = ["HODLRSolver", "build_structure", "hodlr_factor", "hodlr_solve",
           "hodlr_matvec", "hodlr_factor_sym", "hodlr_sqrt_matvec",
           "hodlr_loglike_and_grad_hutchinson"]


# ---------------------------------------------------------------------------
# Static structure (host-side)
# ---------------------------------------------------------------------------

class HODLRStructure(object):
    """Static shape/index data for a padded binary HODLR partition.

    ``n`` real points are padded to ``n_pad = m * 2^L`` (leaf size ``m``,
    ``L`` levels). Level ``l`` (1-based, 1 = root split) has ``2^(l-1)``
    sibling pairs of block size ``s_l = n_pad / 2^l``; each pair carries
    ``c_l = min(rank, s_l)`` skeleton pivots per side.
    """

    def __init__(self, n, min_size=64, rank=32, seed=42, x_sorted=None,
                 nns=None, ridge_floor=None):
        self.n = int(n)
        self.seed = int(seed)
        # absolute floor for the interpolation ridge (the ``tol_abs``
        # accuracy knob: coupling singular directions below sqrt(floor)
        # are not resolved); None keeps the pure machine-eps floor
        self.ridge_floor = None if ridge_floor is None else float(ridge_floor)
        L = 0
        while (self.n + (1 << (L + 1)) - 1) // (1 << (L + 1)) >= min_size:
            L += 1
        self.L = L
        self.m = (self.n + (1 << L) - 1) >> L
        self.n_pad = self.m << L
        # a uniform skeleton rank across levels lets the entry assembly
        # and interpolation solves batch over ALL levels at once
        self.rank = min(int(rank), self.m)
        # rematerialize reverse-mode intermediates only when they would
        # threaten HBM; smaller problems skip the backward recompute
        self.remat = self.n > 300_000
        # cascade layout: TRANSPOSED — skeleton factors (c, n_pad) and
        # multi-RHS (k, n_pad), long row axis minor — above the same
        # threshold, where only the forward-mode (Hutchinson) gradient
        # runs; the exact-autodiff regime keeps the row layout, whose
        # reverse mode XLA compiles to the faster sweep. Which layout
        # wins on a GPU at each N is not measured yet.
        self.transposed = self.n > 300_000
        # optional data-parallel anchors (set by the solver when its
        # inputs are mesh-sharded): full-row-layout arrays are pinned to
        # row sharding at each level boundary so GSPMD never falls back
        # to involuntary full rematerialization on the (p, 2, s, c)
        # block reshapes
        self.mesh = None
        self.shard_axis = None
        rank = self.rank
        self.levels = []
        rng = np.random.default_rng(seed)
        if x_sorted is not None:
            xpad = np.concatenate(
                [
                    x_sorted,
                    np.repeat(x_sorted[-1:], self.n_pad - self.n, axis=0),
                ],
                axis=0,
            )
        else:
            xpad = np.arange(self.n_pad, dtype=np.float64)[:, None]
        vpad = np.zeros(self.n_pad, dtype=bool)
        vpad[: self.n] = True
        if nns is not None:
            nns = np.asarray(nns, dtype=np.int64)
            if nns.shape[0] < self.n_pad:
                nns = np.concatenate(
                    [
                        nns,
                        -np.ones(
                            (self.n_pad - nns.shape[0], nns.shape[1]),
                            dtype=np.int64,
                        ),
                    ],
                    axis=0,
                )
        for lev in range(1, L + 1):
            s = self.n_pad >> lev
            p = 1 << (lev - 1)
            c = min(rank, s)
            blocks = xpad.reshape(p, 2, s, -1)
            vmask = vpad.reshape(p, 2, s)
            row_piv = _fps_pivots(blocks[:, 0], vmask[:, 0], c, rng)
            col_piv = _fps_pivots(blocks[:, 1], vmask[:, 1], c, rng)
            if nns is not None:
                # NN-guided skeletons (the reference's precomputed-neighbor
                # CUR path, ``hodlr.h:556-617`` / ``_hodlr.cpp:121-128``):
                # prefer points with neighbors in the *sibling* block —
                # for decaying kernels the coupling energy concentrates on
                # the inter-block boundary — and fall back to the FPS
                # spread for the remaining slots.
                nb = np.where(nns >= 0, nns // s, -1)
                own = np.arange(self.n_pad, dtype=np.int64) // s
                sib = np.where(own % 2 == 0, own + 1, own - 1)
                counts = (nb == sib[:, None]).sum(axis=1)
                ca = counts.reshape(p, 2, s)
                row_piv = _nn_guided_pivots(
                    row_piv, ca[:, 0], vmask[:, 0], c
                )
                col_piv = _nn_guided_pivots(
                    col_piv, ca[:, 1], vmask[:, 1], c
                )
            # convert block-local positions to absolute padded-row indices
            base = (np.arange(p, dtype=np.int64) * 2 * s)[:, None]
            self.levels.append(
                {"s": s, "p": p, "c": c,
                 "row_piv": base + row_piv,
                 "col_piv": base + s + col_piv}
            )
        self._build_flat()

    def _build_flat(self):
        """Cross-level flattened index arrays so kernel-entry assembly and
        the interpolation solves run as ONE batched op over all levels
        (compile-time and dispatch win over per-level calls)."""
        L = self.L
        if L == 0:
            self.flat = None
            return
        c = self.rank
        rp_all = np.concatenate([lv["row_piv"] for lv in self.levels])
        cp_all = np.concatenate([lv["col_piv"] for lv in self.levels])
        pair_offset = np.cumsum(
            [0] + [lv["p"] for lv in self.levels]
        )
        rowsC, pairC, rowsR, pairR = [], [], [], []
        row_offset = [0]
        for li, lv in enumerate(self.levels):
            s, p = lv["s"], lv["p"]
            base = np.arange(p, dtype=np.int64)[:, None] * 2 * s
            left = (base + np.arange(s, dtype=np.int64)[None, :]).ravel()
            right = (
                base + s + np.arange(s, dtype=np.int64)[None, :]
            ).ravel()
            pid = (
                pair_offset[li]
                + np.repeat(np.arange(p, dtype=np.int64), s)
            )
            rowsC.append(left)
            rowsR.append(right)
            pairC.append(pid)
            pairR.append(pid)
            row_offset.append(row_offset[-1] + p * s)
        self.flat = {
            "c": c,
            "rp_all": rp_all.astype(np.int32),      # (P, c)
            "cp_all": cp_all.astype(np.int32),
            "rowsC": np.concatenate(rowsC).astype(np.int32),   # (T,)
            "rowsR": np.concatenate(rowsR).astype(np.int32),
            "pair_of_row": np.concatenate(pairC).astype(np.int32),
            "pair_offset": pair_offset,
            "row_offset": np.asarray(row_offset),
        }


def _fps_pivots(xb, vmask, c, rng):
    """Seeded farthest-point-sampling pivots, batched over all blocks of a
    level. ``xb``: ``(p, s, d)`` block coordinates; returns block-local
    indices ``(p, c)``. A well-spread skeleton is the static-shape
    answer to the reference's adaptive ACA pivot search
    (``hodlr.h:483-519``) and works in any dimension."""
    p, s, _ = xb.shape
    valid = np.where(vmask, 0.0, -np.inf)              # (p, s)
    nvalid = vmask.sum(axis=1)
    start = (rng.uniform(size=p) * np.maximum(nvalid, 1)).astype(np.int64)
    start = np.minimum(start, np.maximum(nvalid - 1, 0))
    piv = np.empty((p, c), dtype=np.int64)
    piv[:, 0] = start
    last = xb[np.arange(p), start]                     # (p, d)
    d2 = ((xb - last[:, None, :]) ** 2).sum(-1) + valid
    for t in range(1, c):
        nxt = d2.argmax(axis=1)
        piv[:, t] = nxt
        last = xb[np.arange(p), nxt]
        d2 = np.minimum(d2, ((xb - last[:, None, :]) ** 2).sum(-1) + valid)
    return piv


def _nn_guided_pivots(fps_piv, counts, vmask, c):
    """Merge FPS pivots with cross-block neighbor counts: points with
    cross-neighbors rank first (by count, FPS-order tie-break), remaining
    slots fill in FPS order. ``fps_piv``: ``(p, c)`` block-local picks in
    FPS order; ``counts``/``vmask``: ``(p, s)``."""
    p, s = counts.shape
    score = np.where(vmask, counts.astype(np.float64) * (c + 1), -np.inf)
    fscore = np.zeros((p, s))
    fscore[
        np.repeat(np.arange(p), c), fps_piv.ravel()
    ] = np.tile(np.arange(c, 0, -1, dtype=np.float64), p)
    order = np.argsort(-(score + fscore), axis=1, kind="stable")
    return order[:, :c].astype(np.int64)


def build_structure(n, min_size=64, rank=32, seed=42, x_sorted=None,
                    nns=None, ridge_floor=None):
    return HODLRStructure(
        n, min_size=min_size, rank=rank, seed=seed, x_sorted=x_sorted,
        nns=nns, ridge_floor=ridge_floor,
    )


@partial(jax.jit, static_argnames=("pair_fn", "c"))
@full_precision_matmuls
def _aca_level_pivots(pair_fn, theta, xl, vl, xr, vr, c):
    """Kernel-adaptive skeleton pivots by batched partial-pivot ACA
    (the static-shape analogue of the reference's adaptive cross search,
    ``hodlr.h:483-519``), one ``lax.fori_loop`` over the rank, vmapped
    over all sibling pairs of a level.

    Geometry-only FPS pivots catch smooth decaying kernels but can miss
    oscillatory structure entirely (measured: quasi-periodic 1-D blocks
    of intrinsic rank ~35 where rank-48 FPS-CUR has O(1) error and
    rank-48 ACA-CUR reaches ~1e-7). ACA walks the actual kernel: each
    step evaluates one residual row and column and pivots on the largest
    remaining entry.

    ``xl``/``xr``: ``(p, s, d)`` left/right block coordinates; ``vl``/
    ``vr``: validity masks. Returns block-local ``(p, c)`` row and column
    pivots. Pivots depend on ``theta`` (selected once per ``compute()``);
    the factorization itself stays exact-in-theta for autodiff.
    """
    p, s, d = xl.shape
    neg = jnp.asarray(-jnp.inf, xl.dtype)

    def one_pair(xlp, vlp, xrp, vrp):
        U = jnp.zeros((s, c), xl.dtype)
        Vt = jnp.zeros((c, s), xl.dtype)
        used_r = ~vlp
        used_c = ~vrp
        # start from the last valid row — for sorted 1-D data this is the
        # sibling interface, elsewhere it is just a harmless seed (ACA
        # relocates via the column argmax after the first sweep)
        i0 = jnp.argmax(
            jnp.where(vlp, jnp.arange(s), -1)
        )
        Ipiv = jnp.zeros((c,), jnp.int32)
        Jpiv = jnp.zeros((c,), jnp.int32)

        def row_of(i):
            return jax.vmap(lambda b: pair_fn(theta, xlp[i], b))(xrp)

        def col_of(j):
            return jax.vmap(lambda a: pair_fn(theta, a, xrp[j]))(xlp)

        def body(k, carry):
            i, U, Vt, used_r, used_c, Ipiv, Jpiv = carry
            row = jnp.where(vrp, row_of(i), 0.0) - U[i] @ Vt
            j = jnp.argmax(jnp.where(used_c, neg, jnp.abs(row)))
            pv = row[j]
            col = jnp.where(vlp, col_of(j), 0.0) - U @ Vt[:, j]
            denom = jnp.where(jnp.abs(pv) > 1e-300, pv, 1.0)
            U = U.at[:, k].set(col / denom)
            Vt = Vt.at[k].set(row)
            Ipiv = Ipiv.at[k].set(i.astype(jnp.int32))
            Jpiv = Jpiv.at[k].set(j.astype(jnp.int32))
            used_r = used_r.at[i].set(True)
            used_c = used_c.at[j].set(True)
            i_next = jnp.argmax(jnp.where(used_r, neg, jnp.abs(col)))
            return (i_next, U, Vt, used_r, used_c, Ipiv, Jpiv)

        carry = (i0, U, Vt, used_r, used_c, Ipiv, Jpiv)
        _, _, _, _, _, Ipiv, Jpiv = jax.lax.fori_loop(0, c, body, carry)
        return Ipiv, Jpiv

    return jax.vmap(one_pair)(xl, vl, xr, vr)


def pivot_device():
    """The device of the ACA pivot walk: the host CPU, which JAX provides
    beside an accelerator unless ``JAX_PLATFORMS`` leaves ``cpu`` out
    (then this raises)."""
    return jax.devices("cpu")[0]


def select_aca_pivots(pair_fn, theta, xpad, valid, struct):
    """Re-pivot every level of ``struct`` with kernel-adaptive ACA
    skeletons (in place), then rebuild the flattened index arrays.

    The walk runs in float64 (scoped x64) on the host CPU
    (:func:`pivot_device`), whatever the compute dtype and device: its
    residual downdates are cancellation-heavy and its argmax choices
    flip with their rounding, so a walk on another device picks other
    near-tied pivots. On the host every platform gets the same
    skeletons, the ones the CPU tests and the truth anchors were made
    with. (On an H100 a float64 walk on the card gave pivots whose f32
    N=1e6 factorization missed its anchor, 7.8e-3 against 5e-3, where
    host pivots gave 1.1e-3.) Pivots are static setup-time indices, so
    where they are computed costs nothing per evaluation.
    """
    with jax.default_device(pivot_device()), jax.enable_x64():
        xj = jnp.asarray(np.asarray(xpad), dtype=jnp.float64)
        theta = jnp.asarray(np.asarray(theta), dtype=jnp.float64)
        vj = jnp.asarray(np.asarray(valid))
        for lev in struct.levels:
            s, p, c = lev["s"], lev["p"], lev["c"]
            xb = xj.reshape(p, 2, s, -1)
            vb = vj.reshape(p, 2, s)
            Ipiv, Jpiv = _aca_level_pivots(
                pair_fn, theta, xb[:, 0], vb[:, 0], xb[:, 1], vb[:, 1],
                c
            )
            base = (np.arange(p, dtype=np.int64) * 2 * s)[:, None]
            lev["row_piv"] = base + np.asarray(Ipiv, dtype=np.int64)
            lev["col_piv"] = base + s + np.asarray(Jpiv, dtype=np.int64)
    struct._build_flat()


# ---------------------------------------------------------------------------
# Functional core (pure, jittable, differentiable)
# ---------------------------------------------------------------------------

def _block_matrix(pair_fn, theta, xa, va, xb, vb, remat=True):
    """Masked kernel block ``K[i, j] = k(xa[i], xb[j])`` (0 where either
    point is padding). With ``remat`` the assembly recomputes in reverse
    mode — its residuals dominate memory at large N; smaller problems
    skip the recompute."""

    def assemble(theta, xa, xb):
        return jax.vmap(
            lambda a: jax.vmap(lambda b: pair_fn(theta, a, b))(xb)
        )(xa)

    if remat:
        assemble = jax.checkpoint(assemble)
    K = assemble(theta, xa, xb)
    return jnp.where(va[:, None] & vb[None, :], K, 0.0)


def _cho_solve_lower(L, y):
    z = jax.scipy.linalg.solve_triangular(L, y, lower=True)
    return jax.scipy.linalg.solve_triangular(L, z, lower=True, trans=1)


@pinned_full_precision
def ridge_gram(M, ridge_floor=None):
    """``G = M^T M + lam I`` — the ridge-regularized skeleton gram.

    This is one half of the project's CUR design invariant (see
    ``_all_lowrank`` and CLAUDE.md): the interpolant must be the ridge
    pseudo-inverse of ``M`` solved against the PROJECTED right-hand side
    ``M^T R``.  ``lam`` scales with ``trace(G)/c`` (relative eps ridge)
    plus an absolute floor — ``ridge_floor`` carries the reference's
    ``tol_abs`` semantics (singular directions below it are damped; G
    holds squared singular values, hence the square). Shared by the weak
    (HODLR) and strong (H-matrix) compressions so the numerics cannot
    drift apart.  ``M``: ``(..., c, c)``.
    """
    dtype = M.dtype
    c = M.shape[-1]
    eps = 100.0 * jnp.finfo(dtype).eps
    G = jnp.einsum("...ki,...kj->...ij", M, M)
    abs_floor = float(jnp.finfo(dtype).eps)
    if ridge_floor is not None:
        abs_floor = max(abs_floor, float(ridge_floor) ** 2)
    lam = (
        eps * jnp.trace(G, axis1=-2, axis2=-1)[..., None] / c
        + abs_floor
    )
    return G + lam[..., None] * jnp.eye(c, dtype=dtype)


def _all_lowrank_t(pair_fn, theta, xpad, valid, struct, dtype):
    """Skeleton (CUR) factors for EVERY level's sibling couplings, with
    the kernel-entry assembly and the interpolation solves batched over
    all levels at once (one fused op instead of 3L per-level calls).

    Per pair, ``A12 ~= C @ Q^T``: ``C = K[left, J]`` sampled columns and
    ``Q = K[I, right]^T M G^{-1}`` the ridge-regularized interpolant —
    a differentiable, static-shape stand-in for adaptive ACA
    (``hodlr.h:303-680``). The ridge acts as a smooth truncated
    pseudo-inverse (couplings are often numerically rank-deficient; a QR
    triangular solve would amplify the null directions) and its absolute
    floor keeps exactly-zero couplings (fully-padded siblings,
    underflow-range blocks) at 0 instead of NaN.

    Returns ``[(Ct, Qt), ...]`` per level, each TRANSPOSED ``(c, p, s)``
    — the pivot-slot axis leads so the long row axis stays minor (a
    minor axis of width c=12 wastes memory and bandwidth wherever the
    layout pads it).
    """
    flat = struct.flat
    if flat is None:
        return []
    c = flat["c"]
    rp = jnp.asarray(flat["rp_all"])
    cp = jnp.asarray(flat["cp_all"])
    pid = jnp.asarray(flat["pair_of_row"])
    xI, vI = xpad[rp], valid[rp]                # (P, c, d), (P, c)
    xJ, vJ = xpad[cp], valid[cp]

    remat = struct.remat
    blk = jax.vmap(
        lambda xa, va, xb_, vb_: _block_matrix(pair_fn, theta, xa, va,
                                               xb_, vb_, remat)
    )
    M = blk(xI, vI, xJ, vJ)                     # (P, c, c)
    G = ridge_gram(M, struct.ridge_floor)

    def ev(theta, xa, xbT):
        # xa (T, d), xbT (c, T, d) -> (c, T): pivot-slot axis OUTER
        return jax.vmap(
            lambda xbj: jax.vmap(
                lambda a, b: pair_fn(theta, a, b)
            )(xa, xbj)
        )(xbT)

    if remat:
        ev = jax.checkpoint(ev)

    def rows_eval(rows, xP, vP):
        rows = jnp.asarray(rows)
        xa, va = xpad[rows], valid[rows]        # (T, d), (T,)
        xb, vb = xP[pid], vP[pid]               # (T, c, d), (T, c)
        E = ev(theta, xa, jnp.moveaxis(xb, 1, 0))
        return jnp.where(va[None, :] & jnp.moveaxis(vb, 1, 0), E, 0.0)

    C_flat = rows_eval(flat["rowsC"], xJ, vJ)   # (c, T): K[left, J] cols
    # kernel symmetry: K[I, right]^T rows are K(x_right_row, x_I)
    Rt_flat = rows_eval(flat["rowsR"], xI, vI)  # (c, T)

    out = []
    ro, po = flat["row_offset"], flat["pair_offset"]
    for li, lev in enumerate(struct.levels):
        s, p = lev["s"], lev["p"]
        Ct = _level_anchor_t(
            C_flat[:, ro[li]:ro[li + 1]].reshape(c, p, s), struct, p
        )
        Rt = _level_anchor_t(
            Rt_flat[:, ro[li]:ro[li + 1]].reshape(c, p, s), struct, p
        )
        Ml = _level_anchor(M[po[li]:po[li + 1]], struct, p)
        Gl = G[po[li]:po[li + 1]]
        # Solve with the PROJECTED right-hand side M^T R (which lies in
        # range(M)): precomputing G^{-1} M^T and multiplying by R later is
        # mathematically identical but numerically injects ~eps/lam
        # null-space junk. The projection AND the solve stay pinned to
        # full f32 regardless of GEORGE_TPU_MATMUL_PRECISION: the ridge
        # system sits at the eps/lambda noise floor, and a reduced-
        # precision matmul here is amplified far past the N=1e5 anchor.
        with jax.default_matmul_precision("highest"):
            rhs = _level_anchor(
                jnp.einsum("pkc,kps->pcs", Ml, Rt), struct, p
            )
            Qsol = jnp.linalg.solve(_level_anchor(Gl, struct, p), rhs)
        out.append((Ct, jnp.moveaxis(Qsol, 1, 0)))   # (c, p, s) each
    return out




# ---------------------------------------------------------------------------
# Row-major cascade (small/medium N, the exact reverse-mode gradient;
# see HODLRStructure.transposed)
# ---------------------------------------------------------------------------

def _all_lowrank(pair_fn, theta, xpad, valid, struct, dtype):
    """Layout-dispatching skeleton factors (see the _t/_row variants)."""
    fn = _all_lowrank_t if struct.transposed else _all_lowrank_row
    return fn(pair_fn, theta, xpad, valid, struct, dtype)


def _all_lowrank_row(pair_fn, theta, xpad, valid, struct, dtype):
    """Skeleton (CUR) factors for EVERY level's sibling couplings, with
    the kernel-entry assembly and the interpolation solves batched over
    all levels at once (one fused op instead of 3L per-level calls).

    Per pair, ``A12 ~= C @ Q^T``: ``C = K[left, J]`` sampled columns and
    ``Q = K[I, right]^T M G^{-1}`` the ridge-regularized interpolant —
    a differentiable, static-shape stand-in for adaptive ACA
    (``hodlr.h:303-680``). The ridge acts as a smooth truncated
    pseudo-inverse (couplings are often numerically rank-deficient; a QR
    triangular solve would amplify the null directions) and its absolute
    floor keeps exactly-zero couplings (fully-padded siblings,
    underflow-range blocks) at 0 instead of NaN.

    Returns ``[(C, Q), ...]`` per level, each ``(p, s, c)``.
    """
    flat = struct.flat
    if flat is None:
        return []
    c = flat["c"]
    rp = jnp.asarray(flat["rp_all"])
    cp = jnp.asarray(flat["cp_all"])
    pid = jnp.asarray(flat["pair_of_row"])
    xI, vI = xpad[rp], valid[rp]                # (P, c, d), (P, c)
    xJ, vJ = xpad[cp], valid[cp]

    remat = struct.remat
    blk = jax.vmap(
        lambda xa, va, xb_, vb_: _block_matrix(pair_fn, theta, xa, va,
                                               xb_, vb_, remat)
    )
    M = blk(xI, vI, xJ, vJ)                     # (P, c, c)
    G = ridge_gram(M, struct.ridge_floor)

    def ev(theta, xa, xb):
        return jax.vmap(
            lambda a, B: jax.vmap(lambda b: pair_fn(theta, a, b))(B)
        )(xa, xb)

    if remat:
        ev = jax.checkpoint(ev)

    def rows_eval(rows, xP, vP):
        rows = jnp.asarray(rows)
        xa, va = xpad[rows], valid[rows]        # (T, d), (T,)
        xb, vb = xP[pid], vP[pid]               # (T, c, d), (T, c)
        E = ev(theta, xa, xb)
        return jnp.where(va[:, None] & vb, E, 0.0)

    C_flat = rows_eval(flat["rowsC"], xJ, vJ)   # (T, c) rows of K[left, J]
    # kernel symmetry: K[I, right]^T rows are K(x_right_row, x_I)
    Rt_flat = rows_eval(flat["rowsR"], xI, vI)  # (T, c)

    out = []
    ro, po = flat["row_offset"], flat["pair_offset"]
    for li, lev in enumerate(struct.levels):
        s, p = lev["s"], lev["p"]
        C = _level_anchor(
            C_flat[ro[li]:ro[li + 1]].reshape(p, s, c), struct, p
        )
        Rt = _level_anchor(
            Rt_flat[ro[li]:ro[li + 1]].reshape(p, s, c), struct, p
        )
        Ml = _level_anchor(M[po[li]:po[li + 1]], struct, p)
        Gl = G[po[li]:po[li + 1]]
        # Solve with the PROJECTED right-hand side M^T R (which lies in
        # range(M)): precomputing G^{-1} M^T and multiplying by R later is
        # mathematically identical but numerically injects ~eps/lam
        # null-space junk. The projection AND the solve stay pinned to
        # full f32 regardless of GEORGE_TPU_MATMUL_PRECISION: the ridge
        # system sits at the eps/lambda noise floor, and a reduced-
        # precision matmul here is amplified far past the N=1e5 anchor.
        with jax.default_matmul_precision("highest"):
            rhs = _level_anchor(
                jnp.einsum("pkc,psk->pcs", Ml, Rt), struct, p
            )
            Qt = jnp.linalg.solve(_level_anchor(Gl, struct, p), rhs)
        out.append((C, jnp.swapaxes(Qt, -1, -2)))
    return out


def _factor_apply_inv_row(Z, T, core_inv, p, s, c, X, remat=True,
                      struct=None):
    """Apply ``F_l^{-1} = I - W (I + Z^T W)^{-1} Z^T`` to ``X``
    ``(n_pad, k)`` (SMW; reference per-node solve ``hodlr.h:792-845``).
    With ``remat`` each application recomputes in the backward pass,
    trading negligible FLOPs for the O(L^2) chain of stored
    intermediates at large N."""

    def apply(Z, T, core_inv, X):
        k = X.shape[-1]
        Xb = X.reshape(p, 2, s, k)
        Zb = Z.reshape(p, 2, s, c)
        Tb = T.reshape(p, 2, s, c)
        if struct is not None:
            Xb = _level_anchor(Xb, struct, p)
            Zb = _level_anchor(Zb, struct, p)
            Tb = _level_anchor(Tb, struct, p)
        top = jnp.einsum("psc,psk->pck", Zb[:, 1], Xb[:, 1])  # Q^T X_r
        bot = jnp.einsum("psc,psk->pck", Zb[:, 0], Xb[:, 0])  # P^T X_l
        y = jnp.einsum(
            "pcd,pdk->pck", core_inv, jnp.concatenate([top, bot], axis=1)
        )
        dx_l = jnp.einsum("psc,pck->psk", Tb[:, 0], y[:, :c])
        dx_r = jnp.einsum("psc,pck->psk", Tb[:, 1], y[:, c:])
        out = Xb - jnp.stack([dx_l, dx_r], axis=1)
        return out.reshape(X.shape)

    if remat:
        apply = jax.checkpoint(apply)
    return apply(Z, T, core_inv, X)


@full_precision_matmuls
def _hodlr_factor_row(pair_fn, theta, xpad, valid, diag_pad, struct):
    """Factorize ``K_compressed + diag`` level-by-level.

    Returns ``(factors, logdet)`` where ``factors`` is a pytree:
    ``{"Lleaf": (B, m, m), "levels": [(Z, T, core_inv), ...]}`` with ``Z``
    the raw and ``T`` the finer-inverse-applied low-rank factors in full-row
    layout ``(n_pad, c_l)``, and ``core_inv`` the batched inverted SMW
    cores ``(p_l, 2c_l, 2c_l)``.
    """
    n_pad, m, L = struct.n_pad, struct.m, struct.L
    B = n_pad // m
    dtype = diag_pad.dtype

    # --- leaf boxes: batched assemble + Cholesky (HBM-chunked) -----------
    xb = xpad.reshape(B, m, -1)
    vb = valid.reshape(B, m)
    Lleaf = _leaf_cholesky_chunked(
        pair_fn, theta, xb, vb, diag_pad.reshape(B, m), struct.remat
    )
    logdet = 2.0 * jnp.sum(
        jnp.log(jnp.diagonal(Lleaf, axis1=-2, axis2=-1))
    )

    def leaf_solve(X):
        Y = jax.vmap(_cho_solve_lower)(Lleaf, X.reshape(B, m, -1))
        return Y.reshape(X.shape)

    # --- raw skeleton factors, all levels assembled in one batch ---------
    Zs = []
    for lev, (C, Q) in zip(
        struct.levels, _all_lowrank_row(pair_fn, theta, xpad, valid, struct,
                                    dtype)
    ):
        Z = _row_anchor(
            _level_anchor(
                jnp.stack([C, Q], axis=1), struct, lev["p"]
            ).reshape(n_pad, lev["c"]),
            struct,
        )
        Zs.append(Z)

    # --- upward sweep: factor each level, update coarser left factors -----
    # The reference updates every ancestor's U factors one node at a time
    # (``hodlr.h:153-164``); here each level's inverse hits ALL coarser
    # levels' factors as one concatenated multi-RHS application — L x fewer
    # dispatches and wider matmuls.
    if L:
        widths = [Z.shape[1] for Z in Zs]
        Tcat = _row_anchor(leaf_solve(jnp.concatenate(Zs, axis=1)), struct)
        splits = list(np.cumsum(widths))[:-1]
        T = list(jnp.split(Tcat, splits, axis=1))
    else:
        T = []
    levels_out = [None] * L
    for li in range(L - 1, -1, -1):   # li = level index (0 = root split)
        lev = struct.levels[li]
        s, p, c = lev["s"], lev["p"], lev["c"]
        Zb = _level_anchor(Zs[li].reshape(p, 2, s, c), struct, p)
        Tb = _level_anchor(T[li].reshape(p, 2, s, c), struct, p)
        P, Q = Zb[:, 0], Zb[:, 1]
        Pt, Qt_ = Tb[:, 0], Tb[:, 1]
        # SMW core assembly/inversion feeds the logdet: always full f32
        with jax.default_matmul_precision("highest"):
            upper = jnp.einsum("psc,psd->pcd", Q, Qt_)      # Q^T Qtilde
            lower = jnp.einsum("psc,psd->pcd", P, Pt)       # P^T Ptilde
            eye = jnp.eye(c, dtype=dtype)
            zero = jnp.zeros((p, c, c), dtype=dtype)
            core = jnp.concatenate(
                [
                    jnp.concatenate([eye + zero, upper], axis=-1),
                    jnp.concatenate([lower, eye + zero], axis=-1),
                ],
                axis=-2,
            )                                                # (p, 2c, 2c)
            core = _level_anchor(core, struct, p)
            core_inv, ld = _core_inv_slogdet(core, struct)
        logdet = logdet + jnp.sum(ld)
        levels_out[li] = (Zs[li], T[li], core_inv)

        if li > 0:
            # Ancestor update: this level's inverse hits ALL coarser
            # levels' factors. One wide concatenated application is the
            # dispatch-optimal form (L x fewer calls, wider matmuls) —
            # but the concat temps are (n_pad, c*li) and the scheduler
            # keeps several alive across the level loop (7 live copies
            # of the width-60 mid-sweep update at N=1e6 / L=10). Past
            # the width budget, apply in width-bounded groups instead:
            # same FLOPs/traffic, bounded liveness.
            width = c * li
            itemsize = jnp.dtype(diag_pad.dtype).itemsize
            if n_pad * width * itemsize <= _ANCESTOR_UPDATE_BYTES:
                groups = [list(range(li))]
            else:
                per = max(1, _ANCESTOR_UPDATE_BYTES
                          // (n_pad * c * itemsize))
                groups = [
                    list(range(j, min(j + per, li)))
                    for j in range(0, li, per)
                ]
            for grp in groups:
                X = (T[grp[0]] if len(grp) == 1
                     else jnp.concatenate([T[j] for j in grp], axis=1))
                X = _row_anchor(
                    _factor_apply_inv_row(Zs[li], T[li], core_inv, p, s, c,
                                      X, struct.remat, struct),
                    struct,
                )
                if len(grp) == 1:
                    T[grp[0]] = X
                else:
                    offs = list(np.cumsum(
                        [T[j].shape[1] for j in grp]
                    ))[:-1]
                    for j, piece in zip(grp, jnp.split(X, offs, axis=1)):
                        T[j] = piece

    factors = {"Lleaf": Lleaf, "levels": levels_out}
    return factors, logdet


@full_precision_matmuls
def _hodlr_solve_row(factors, struct, X):
    """``K^{-1} X`` through the factor cascade: ``D^{-1}`` then
    ``F_L^{-1} ... F_1^{-1}`` (finest first)."""
    Lleaf = factors["Lleaf"]
    B, m, _ = Lleaf.shape
    squeeze = X.ndim == 1
    if squeeze:
        X = X[:, None]
    X = _row_anchor(
        jax.vmap(_cho_solve_lower)(Lleaf, X.reshape(B, m, -1)).reshape(
            X.shape
        ),
        struct,
    )
    for li in range(struct.L - 1, -1, -1):
        lev = struct.levels[li]
        Z, T, core_inv = factors["levels"][li]
        X = _row_anchor(
            _factor_apply_inv_row(
                Z, T, core_inv, lev["p"], lev["s"], lev["c"], X,
                struct.remat, struct,
            ),
            struct,
        )
    return X[:, 0] if squeeze else X


@full_precision_matmuls
def _hodlr_matvec_factors_row(factors, struct, X):
    """Compressed matvec ``(K_bar + diag) X`` rebuilt from the
    factorization itself — ZERO kernel re-assembly.

    ``hodlr_matvec`` re-evaluates every leaf gram and skeleton entry
    (the dominant per-call cost at large N: ~1 GB of kernel entries at
    N=1e6), which made each refinement step as expensive as the
    factorization. But the factors already hold everything the matvec
    needs: the leaf blocks as their Cholesky factors
    (``L L^T = K_leaf + diag`` — two batched triangular matmuls, the
    same FLOPs as one dense block matmul, backward error O(eps||K||),
    i.e. the same rounding class as a fresh assembly) and the raw
    skeleton factors ``Z = [C, Q]`` per level. Only valid for the
    non-symmetric cascade's factor pytree."""
    Lleaf = factors["Lleaf"]
    B, m, _ = Lleaf.shape
    squeeze = X.ndim == 1
    if squeeze:
        X = X[:, None]
    k = X.shape[-1]
    Xb = X.reshape(B, m, k)
    Y = jnp.einsum(
        "bij,bjk->bik", Lleaf,
        jnp.einsum("bji,bjk->bik", Lleaf, Xb),
    ).reshape(X.shape)
    for li, lev in enumerate(struct.levels):
        s, p, c = lev["s"], lev["p"], lev["c"]
        Z = factors["levels"][li][0]
        Zb = Z.reshape(p, 2, s, c)
        C, Q = Zb[:, 0], Zb[:, 1]
        Xl = X.reshape(p, 2, s, k)
        qx = jnp.einsum("psc,psk->pck", Q, Xl[:, 1])
        px = jnp.einsum("psc,psk->pck", C, Xl[:, 0])
        add_l = jnp.einsum("psc,pck->psk", C, qx)
        add_r = jnp.einsum("psc,pck->psk", Q, px)
        Y = Y + jnp.stack([add_l, add_r], axis=1).reshape(Y.shape)
    return Y[:, 0] if squeeze else Y


@full_precision_matmuls
def _hodlr_matvec_row(pair_fn, theta, xpad, valid, diag_pad, struct, X,
                 include_diag=True):
    """Structured matvec with the *compressed* matrix ``K_bar (+ diag)``
    (reference ``apply_forward``, ``hodlr.h:242-259``): batched leaf-block
    matmuls plus per-level low-rank couplings — O(N r log N)."""
    n_pad, m = struct.n_pad, struct.m
    B = n_pad // m
    squeeze = X.ndim == 1
    if squeeze:
        X = X[:, None]
    k = X.shape[-1]

    xb = xpad.reshape(B, m, -1)
    vb = valid.reshape(B, m)
    db = diag_pad.reshape(B, m)
    Xl = X.reshape(B, m, k)

    def leaf_apply(xc, vc, dc, Xc):
        Kc = jax.vmap(
            lambda xa, va: _block_matrix(pair_fn, theta, xa, va, xa, va)
        )(xc, vc)
        if include_diag:
            Kc = Kc + jax.vmap(jnp.diag)(dc)
        return jnp.einsum("bij,bjk->bik", Kc, Xc)

    # size the HBM budget from the materialized leaf-gram dtype (theta x
    # xpad), not the probe dtype: mixed-precision calls (f32 probes on an
    # f64-built kernel) would otherwise under-count by 2x
    chunk = _leaf_chunk(B, m, jnp.result_type(theta.dtype, xpad.dtype))
    if chunk is None:
        Y = leaf_apply(xb, vb, db, Xl).reshape(X.shape)
    else:
        nc = B // chunk
        Y = jax.lax.map(
            lambda a: leaf_apply(*a),
            (
                xb.reshape(nc, chunk, m, -1),
                vb.reshape(nc, chunk, m),
                db.reshape(nc, chunk, m),
                Xl.reshape(nc, chunk, m, k),
            ),
        ).reshape(X.shape)

    for lev, (C, Q) in zip(
        struct.levels,
        _all_lowrank_row(pair_fn, theta, xpad, valid, struct, diag_pad.dtype),
    ):
        s, p, c = lev["s"], lev["p"], lev["c"]
        Xb = X.reshape(p, 2, s, k)
        # left rows += P (Q^T x_right); right rows += Q (P^T x_left)
        qx = jnp.einsum("psc,psk->pck", Q, Xb[:, 1])
        px = jnp.einsum("psc,psk->pck", C, Xb[:, 0])
        add_l = jnp.einsum("psc,pck->psk", C, qx)
        add_r = jnp.einsum("psc,pck->psk", Q, px)
        Y = Y + jnp.stack([add_l, add_r], axis=1).reshape(Y.shape)
    return Y[:, 0] if squeeze else Y


# Double-single SMW cores are OPT-IN only (GEORGE_TPU_CORE_DS=1), never
# automatic: the CPU attribution ladder found that core-precision
# promotion does not fix the deep-cascade f32 error (the loss lives in
# the T-update chain, not the small inverses). ``ops/ds.py`` remains a
# tested double-single utility.


def _core_inv_slogdet(core, struct):
    """Per-level SMW core inverse + log|det|.

    Modes (static at trace time): f32 with ``GEORGE_TPU_CORE_DS=1`` ->
    double-single Gauss-Jordan (opt-in experiment only, see the note
    above); otherwise plain ``linalg`` in the input dtype.
    """
    import os as _os

    if core.dtype == jnp.float32 and _os.environ.get(
            "GEORGE_TPU_CORE_DS") == "1":
        from ..ops.ds import ds_inv_logdet

        core_inv, ld, _sign = ds_inv_logdet(core)
        return core_inv, ld
    core_inv = jnp.linalg.inv(core)
    _, ld = jnp.linalg.slogdet(core)
    return core_inv, ld


def _leaf_cholesky_chunked(pair_fn, theta, xb, vb, db, remat):
    """Batched leaf assemble + Cholesky, chunked at large N.

    Materializing every leaf gram at once costs ``B m^2`` floats and the
    graph holds it 2-3x (the masked assembly, its remat copy, and the
    factor). Chunking the leaf sweep bounds the assembly temp to
    ``_LEAF_MATVEC_CHUNK_BYTES`` while the (required) Cholesky factors
    stream into the output; small problems stay un-chunked."""
    B, m = vb.shape

    def leaf_factor(xc, vc, dc):
        Kc = jax.vmap(
            lambda xa, va: _block_matrix(pair_fn, theta, xa, va, xa, va,
                                         remat)
        )(xc, vc)
        Kc = Kc + jax.vmap(jnp.diag)(dc)
        return jnp.linalg.cholesky(Kc)

    chunk = _leaf_chunk(B, m, jnp.result_type(theta.dtype, xb.dtype))
    if chunk is None:
        return leaf_factor(xb, vb, db)
    nc = B // chunk
    # scan with an in-place carry, NOT lax.map: the map's stacked
    # (nc, chunk, m, m) output lives ALONGSIDE its (B, m, m) reshape,
    # two full-size leaf buffers; the dynamic-update-slice on a loop
    # carry aliases one output buffer.
    xc = xb.reshape(nc, chunk, m, -1)
    vc = vb.reshape(nc, chunk, m)
    dc = db.reshape(nc, chunk, m)

    def body(out, i):
        Lc = leaf_factor(xc[i], vc[i], dc[i])
        return jax.lax.dynamic_update_slice_in_dim(
            out, Lc, i * chunk, axis=0
        ), None

    out0 = jnp.zeros(
        (B, m, m),
        dtype=jnp.result_type(theta.dtype, xb.dtype, db.dtype),
    )
    out, _ = jax.lax.scan(body, out0, jnp.arange(nc))
    return out


@full_precision_matmuls
def _hodlr_factor_t(pair_fn, theta, xpad, valid, diag_pad, struct):
    """Factorize ``K_compressed + diag`` level-by-level.

    Returns ``(factors, logdet)`` where ``factors`` is a pytree:
    ``{"Lleaf": (B, m, m), "levels": [(Zt, Tt, core_inv), ...]}`` with
    ``Zt`` the raw and ``Tt`` the finer-inverse-applied low-rank factors
    TRANSPOSED — ``(c_l, n_pad)``, long row axis minor, so the
    c=12-ish dimension is never the padded minor one — and ``core_inv`` the
    batched inverted SMW cores ``(p_l, 2c_l, 2c_l)``.
    """
    n_pad, m, L = struct.n_pad, struct.m, struct.L
    B = n_pad // m
    dtype = diag_pad.dtype

    # --- leaf boxes: batched assemble + Cholesky (chunked) ---------------
    xb = xpad.reshape(B, m, -1)
    vb = valid.reshape(B, m)
    Lleaf = _leaf_cholesky_chunked(
        pair_fn, theta, xb, vb, diag_pad.reshape(B, m), struct.remat
    )
    logdet = 2.0 * jnp.sum(
        jnp.log(jnp.diagonal(Lleaf, axis1=-2, axis2=-1))
    )

    # --- raw skeleton factors, all levels assembled in one batch ---------
    Zs = []
    for lev, (Ct, Qt) in zip(
        struct.levels, _all_lowrank_t(pair_fn, theta, xpad, valid,
                                      struct, dtype)
    ):
        # (c, p, s) halves -> transposed full-row layout (c, n_pad)
        Zt = _row_anchor_t(
            _level_anchor_t(
                jnp.stack([Ct, Qt], axis=2), struct, lev["p"],
            ).reshape(lev["c"], n_pad),
            struct,
        )
        Zs.append(Zt)

    # --- upward sweep: factor each level, update coarser left factors -----
    # The reference updates every ancestor's U factors one node at a time
    # (``hodlr.h:153-164``); here each level's inverse hits ALL coarser
    # levels' factors as one concatenated multi-RHS application — L x fewer
    # dispatches and wider matmuls.
    if L:
        widths = [Zt.shape[0] for Zt in Zs]
        Tcat = _row_anchor_t(
            _leaf_solve_t(Lleaf, jnp.concatenate(Zs, axis=0)), struct
        )
        splits = list(np.cumsum(widths))[:-1]
        T = list(jnp.split(Tcat, splits, axis=0))
    else:
        T = []
    levels_out = [None] * L
    for li in range(L - 1, -1, -1):   # li = level index (0 = root split)
        lev = struct.levels[li]
        s, p, c = lev["s"], lev["p"], lev["c"]
        Zb = _level_anchor_t(Zs[li].reshape(c, p, 2, s), struct, p)
        Tb = _level_anchor_t(T[li].reshape(c, p, 2, s), struct, p)
        P, Q = Zb[:, :, 0], Zb[:, :, 1]                  # (c, p, s)
        Pt, Qt_ = Tb[:, :, 0], Tb[:, :, 1]
        # SMW core assembly/inversion feeds the logdet: always full f32
        with jax.default_matmul_precision("highest"):
            upper = jnp.einsum("cps,dps->pcd", Q, Qt_)      # Q^T Qtilde
            lower = jnp.einsum("cps,dps->pcd", P, Pt)       # P^T Ptilde
            eye = jnp.eye(c, dtype=dtype)
            zero = jnp.zeros((p, c, c), dtype=dtype)
            core = jnp.concatenate(
                [
                    jnp.concatenate([eye + zero, upper], axis=-1),
                    jnp.concatenate([lower, eye + zero], axis=-1),
                ],
                axis=-2,
            )                                                # (p, 2c, 2c)
            core = _level_anchor(core, struct, p)
            core_inv, ld = _core_inv_slogdet(core, struct)
        logdet = logdet + jnp.sum(ld)
        levels_out[li] = (Zs[li], T[li], core_inv)

        if li > 0:
            # Ancestor update: this level's inverse hits ALL coarser
            # levels' factors. One wide concatenated application is the
            # dispatch-optimal form (L x fewer calls, wider matmuls) AND
            # the accurate one: splitting into groups roughly doubles the
            # factored inverse's residual at N=1e6/L=11 (the group
            # boundaries interleave differently-rounded updates).
            # Transposed temps are their logical size, so a 512 MB
            # budget keeps every level of the N=1e6 sweep (width 120 ->
            # 480 MB) in one wide application.
            width = c * li
            itemsize = jnp.dtype(diag_pad.dtype).itemsize
            budget = 512 * 1024 * 1024
            if n_pad * width * itemsize <= budget:
                groups = [list(range(li))]
            else:
                per = max(1, budget // (n_pad * c * itemsize))
                groups = [
                    list(range(j, min(j + per, li)))
                    for j in range(0, li, per)
                ]
            for grp in groups:
                X = (T[grp[0]] if len(grp) == 1
                     else jnp.concatenate([T[j] for j in grp], axis=0))
                X = _row_anchor_t(
                    _factor_apply_inv_t(Zs[li], T[li], core_inv, p, s,
                                        c, X, struct.remat, struct),
                    struct,
                )
                if len(grp) == 1:
                    T[grp[0]] = X
                else:
                    offs = list(np.cumsum(
                        [T[j].shape[0] for j in grp]
                    ))[:-1]
                    for j, piece in zip(grp, jnp.split(X, offs, axis=0)):
                        T[j] = piece

    factors = {"Lleaf": Lleaf, "levels": levels_out}
    return factors, logdet


def hodlr_factor(pair_fn, theta, xpad, valid, diag_pad, struct):
    """Factorize ``K_compressed + diag`` level-by-level.

    Returns ``(factors, logdet)``; the factor pytree's level layout
    depends on ``struct.transposed`` — row ``(n_pad, c)`` factors below
    the large-N threshold (faster XLA reverse mode), transposed
    ``(c, n_pad)`` above it (fits the N=1e6 split in HBM). Treat the
    pytree as opaque and consume it through :func:`hodlr_solve` /
    :func:`hodlr_matvec_factors`, which dispatch on the same flag.
    """
    if struct.transposed:
        return _hodlr_factor_t(pair_fn, theta, xpad, valid, diag_pad,
                               struct)
    return _hodlr_factor_row(pair_fn, theta, xpad, valid, diag_pad,
                             struct)


def _row_anchor(X, struct):
    """Pin a full-row-layout array to the struct's row sharding (no-op
    when unsharded)."""
    if getattr(struct, "mesh", None) is None:
        return X
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = P(struct.shard_axis, *([None] * (X.ndim - 1)))
    return jax.lax.with_sharding_constraint(
        X, NamedSharding(struct.mesh, spec)
    )


def _level_anchor(arr, struct, nblk):
    """Pin a per-level blocked view (leading dim = ``nblk`` sibling
    pairs): shard the block dim when it tiles the mesh, otherwise
    replicate — the coarse levels near the root have fewer blocks than
    devices, and an explicit (cheap, tiny-tensor) all-gather there beats
    GSPMD's involuntary full-rematerialization fallback."""
    if getattr(struct, "mesh", None) is None:
        return arr
    from jax.sharding import NamedSharding, PartitionSpec as P

    ndev = int(np.prod(list(struct.mesh.shape.values())))
    if nblk % ndev == 0:
        spec = P(struct.shard_axis, *([None] * (arr.ndim - 1)))
    else:
        spec = P(*([None] * arr.ndim))
    return jax.lax.with_sharding_constraint(
        arr, NamedSharding(struct.mesh, spec)
    )


def _row_anchor_t(X, struct):
    """Transposed-layout twin of :func:`_row_anchor`: the padded-row axis
    is LAST (``(..., n_pad)``), so pin the row sharding there."""
    if getattr(struct, "mesh", None) is None:
        return X
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = P(*([None] * (X.ndim - 1)), struct.shard_axis)
    return jax.lax.with_sharding_constraint(
        X, NamedSharding(struct.mesh, spec)
    )


def _level_anchor_t(arr, struct, nblk, block_axis=1):
    """Transposed-layout twin of :func:`_level_anchor` for blocked views
    ``(c, p, 2, s)`` / ``(k, p, 2, s)`` whose sibling-pair axis sits at
    ``block_axis``."""
    if getattr(struct, "mesh", None) is None:
        return arr
    from jax.sharding import NamedSharding, PartitionSpec as P

    ndev = int(np.prod(list(struct.mesh.shape.values())))
    spec = [None] * arr.ndim
    if nblk % ndev == 0:
        spec[block_axis] = struct.shard_axis
    return jax.lax.with_sharding_constraint(
        arr, NamedSharding(struct.mesh, P(*spec))
    )


def _leaf_solve_t(Lleaf, Xt):
    """``(L L^T)^{-1}`` applied to transposed multi-RHS ``Xt (k, n_pad)``.

    Works on right-side triangular solves so every buffer keeps the LONG
    axis minor: ``X^T (L L^T)^{-1} = (X^T L^{-T}) L^{-1}``. The
    row-layout form reshapes RHS to ``(B, m, k)`` whose minor ``k`` is
    1-9 in the solve/gradient paths, a narrow minor axis on every leaf
    solve at large N."""
    B, m, _ = Lleaf.shape
    k = Xt.shape[0]
    Xb = Xt.reshape(k, B, m).transpose(1, 0, 2)          # (B, k, m)
    z1 = jax.lax.linalg.triangular_solve(
        Lleaf, Xb, left_side=False, lower=True, transpose_a=True
    )                                                    # X^T L^{-T}
    z2 = jax.lax.linalg.triangular_solve(
        Lleaf, z1, left_side=False, lower=True, transpose_a=False
    )                                                    # ... L^{-1}
    return z2.transpose(1, 0, 2).reshape(k, B * m)


def _factor_apply_inv_t(Zt, Tt, core_inv, p, s, c, Xt, remat=True,
                      struct=None):
    """Apply ``F_l^{-1} = I - W (I + Z^T W)^{-1} Z^T`` to transposed
    ``Xt (k, n_pad)`` (SMW; reference per-node solve ``hodlr.h:792-845``).

    All level factors live TRANSPOSED — ``Zt/Tt (c, n_pad)`` — so every
    large operand keeps the long row axis minor, not the narrow c=12.
    With ``remat`` each application recomputes in the backward pass,
    trading negligible FLOPs for the O(L^2) chain of stored
    intermediates at large N."""

    def apply(Zt, Tt, core_inv, Xt):
        k = Xt.shape[0]
        Xb = Xt.reshape(k, p, 2, s)
        Zb = Zt.reshape(c, p, 2, s)
        Tb = Tt.reshape(c, p, 2, s)
        if struct is not None:
            Xb = _level_anchor_t(Xb, struct, p)
            Zb = _level_anchor_t(Zb, struct, p)
            Tb = _level_anchor_t(Tb, struct, p)
        top = jnp.einsum("cps,kps->pck", Zb[:, :, 1], Xb[:, :, 1])
        bot = jnp.einsum("cps,kps->pck", Zb[:, :, 0], Xb[:, :, 0])
        y = jnp.einsum(
            "pcd,pdk->pck", core_inv, jnp.concatenate([top, bot], axis=1)
        )
        dx_l = jnp.einsum("cps,pck->kps", Tb[:, :, 0], y[:, :c])
        dx_r = jnp.einsum("cps,pck->kps", Tb[:, :, 1], y[:, c:])
        out = Xb - jnp.stack([dx_l, dx_r], axis=2)
        return out.reshape(Xt.shape)

    if remat:
        apply = jax.checkpoint(apply)
    return apply(Zt, Tt, core_inv, Xt)


@full_precision_matmuls
def _solve_t(factors, struct, Xt):
    """``(K^{-1} X)^T`` on transposed multi-RHS ``Xt (k, n_pad)``:
    ``D^{-1}`` then ``F_L^{-1} ... F_1^{-1}`` (finest first)."""
    Xt = _row_anchor_t(_leaf_solve_t(factors["Lleaf"], Xt), struct)
    for li in range(struct.L - 1, -1, -1):
        lev = struct.levels[li]
        Zt, Tt, core_inv = factors["levels"][li]
        Xt = _row_anchor_t(
            _factor_apply_inv_t(
                Zt, Tt, core_inv, lev["p"], lev["s"], lev["c"], Xt,
                struct.remat, struct,
            ),
            struct,
        )
    return Xt


@full_precision_matmuls
def hodlr_solve(factors, struct, X):
    """``K^{-1} X`` through the factor cascade: ``D^{-1}`` then
    ``F_L^{-1} ... F_1^{-1}`` (finest first). ``X``: ``(n_pad,)`` or
    ``(n_pad, k)``; dispatches on the struct's cascade layout (see
    ``HODLRStructure.transposed``)."""
    if not struct.transposed:
        return _hodlr_solve_row(factors, struct, X)
    squeeze = X.ndim == 1
    Xt = X[None, :] if squeeze else X.T
    Xt = _solve_t(factors, struct, Xt)
    return Xt[0] if squeeze else Xt.T


@full_precision_matmuls
def hodlr_matvec_factors(factors, struct, X):
    """Compressed matvec ``(K_bar + diag) X`` rebuilt from the
    factorization itself — ZERO kernel re-assembly.

    ``hodlr_matvec`` re-evaluates every leaf gram and skeleton entry
    (the dominant per-call cost at large N: ~1 GB of kernel entries at
    N=1e6), which made each refinement step as expensive as the
    factorization. But the factors already hold everything the matvec
    needs: the leaf blocks as their Cholesky factors
    (``L L^T = K_leaf + diag`` — two batched triangular matmuls, the
    same FLOPs as one dense block matmul, backward error O(eps||K||),
    i.e. the same rounding class as a fresh assembly) and the raw
    skeleton factors ``Z = [C, Q]`` per level. Only valid for the
    non-symmetric cascade's factor pytree."""
    if not struct.transposed:
        return _hodlr_matvec_factors_row(factors, struct, X)
    squeeze = X.ndim == 1
    Xt = X[None, :] if squeeze else X.T
    Yt = _matvec_factors_t(factors, struct, Xt)
    return Yt[0] if squeeze else Yt.T


@full_precision_matmuls
def _matvec_factors_t(factors, struct, Xt):
    """Transposed core of :func:`hodlr_matvec_factors`:
    ``Xt (k, n_pad) -> ((K_bar + diag) X)^T``."""
    Lleaf = factors["Lleaf"]
    B, m, _ = Lleaf.shape
    k = Xt.shape[0]
    # X^T K_leaf = (X^T L) L^T per leaf box, long axis minor throughout
    Xb = Xt.reshape(k, B, m).transpose(1, 0, 2)          # (B, k, m)
    t1 = jnp.einsum("bkm,bmn->bkn", Xb, Lleaf)
    Yb = jnp.einsum("bkn,bjn->bkj", t1, Lleaf)
    Yt = Yb.transpose(1, 0, 2).reshape(k, B * m)
    for li, lev in enumerate(struct.levels):
        s, p, c = lev["s"], lev["p"], lev["c"]
        Zt = factors["levels"][li][0]
        Zb = Zt.reshape(c, p, 2, s)
        Ct, Qt = Zb[:, :, 0], Zb[:, :, 1]                # (c, p, s)
        Xl = Xt.reshape(k, p, 2, s)
        qx = jnp.einsum("cps,kps->pck", Qt, Xl[:, :, 1])
        px = jnp.einsum("cps,kps->pck", Ct, Xl[:, :, 0])
        add_l = jnp.einsum("cps,pck->kps", Ct, qx)
        add_r = jnp.einsum("cps,pck->kps", Qt, px)
        Yt = Yt + jnp.stack([add_l, add_r], axis=2).reshape(Yt.shape)
    return Yt


@full_precision_matmuls
def hodlr_solve_refined(pair_fn, theta, xpad, valid, diag_pad, struct,
                        factors, X, steps=1):
    """``hodlr_solve`` plus mixed-precision iterative refinement.

    The f32 forward error of the level-batched inverse cascade grows
    with N (at N=1e6, rank 12, of order 5e-3 relative on the quadratic
    form r^T K^{-1} r, while the same factorization in CPU f64 is at
    1.4e-9 — and the error grows with rank as trailing
    skeleton singular values sink under f32 noise). Each refinement
    step ``z += F^{-1}(x - K z)`` costs one compressed matvec + one
    factor solve and contracts that error to the matvec's rounding
    floor; both operators are the SAME compressed ``K_bar``, so the
    iteration targets exactly the system the factorization approximates
    (the rank-truncation error, 1e-9 at rank 12, is untouched). The
    analogue of the refinement loops dense f64 solvers never need —
    this is the price/fix for running the cascade in f32.

    Plain Richardson (``z += F^{-1} r``) DIVERGES here: the f32 inverse
    cascade's error is not small-norm — the coarse-level SMW cores are
    ill-conditioned and their explicit f32 inverses carry O(1)-gain
    error directions (at N=1e6 one plain step can send the quadratic
    form from +1.0e6 to -5.8e6). Each step is therefore
    residual-MINIMIZING: with search direction ``d = F^{-1} r``, the
    per-column ``omega = <r, K d> / <K d, K d>`` makes ``||r'|| <=
    ||r||`` unconditionally (GMRES(1) with the cascade as the right
    preconditioner), and ``omega ~= 1`` recovers plain refinement
    wherever the cascade is good.
    """
    squeeze = X.ndim == 1
    Xt = X[None, :] if squeeze else X.T
    if struct.transposed:
        slv = lambda V: _solve_t(factors, struct, V)  # noqa: E731
        mv = lambda V: _matvec_factors_t(  # noqa: E731
            factors, struct, V)
    else:
        slv = lambda V: hodlr_solve(factors, struct, V.T).T  # noqa: E731
        mv = lambda V: hodlr_matvec_factors(  # noqa: E731
            factors, struct, V.T).T
    Z = slv(Xt)
    # the compressed operator straight from the factors (no kernel
    # re-assembly): refinement's extra cost drops from ~2 full
    # assembly passes per step to a few bandwidth-bound matmuls
    R = Xt - mv(Z)
    for _ in range(steps):
        D = slv(R)
        KD = mv(D)
        w = jnp.sum(R * KD, axis=1) / jnp.maximum(
            jnp.sum(KD * KD, axis=1), jnp.finfo(X.dtype).tiny
        )
        Z = Z + w[:, None] * D
        R = R - w[:, None] * KD
    return Z[0] if squeeze else Z.T


# HBM budget for one materialized chunk of leaf gram blocks inside
# hodlr_matvec (bytes). The full leaf gram at N=1e6 / m=245 is ~1 GB and
# the matvec appears several times in the fused Hutchinson graph
# (refinement residual + jacfwd tangents), so XLA keeps multiple remat
# copies live — chunking the leaf sweep with lax.map bounds each copy.
# The matvec is HBM-bandwidth-bound (k << m), so serializing chunks
# costs little. The live set holds ~3 chunk-sized temps. The value
# bounds temporaries on any device; whether the 80 GB card wants a
# larger one is not measured yet.
_LEAF_MATVEC_CHUNK_BYTES = 64 * 1024 * 1024

# Width budget (bytes) for one concatenated ancestor-update application
# in the factor sweep: the N=1e5 headline (width 120 -> 48 MB) keeps the
# single wide dispatch; the N=1e6 graph (width 120 -> 480 MB) splits
# into width-bounded groups so the scheduler can't hold multi-GB of
# mid-sweep update temps live.
_ANCESTOR_UPDATE_BYTES = 96 * 1024 * 1024


def _leaf_chunk(B, m, dtype):
    """Largest divisor of ``B`` whose leaf-gram chunk fits the budget
    (None = no chunking needed)."""
    itemsize = jnp.dtype(dtype).itemsize
    if B * m * m * itemsize <= _LEAF_MATVEC_CHUNK_BYTES:
        return None
    chunk = max(1, _LEAF_MATVEC_CHUNK_BYTES // (m * m * itemsize))
    while B % chunk:
        chunk -= 1
    return chunk


@full_precision_matmuls
def hodlr_matvec(pair_fn, theta, xpad, valid, diag_pad, struct, X,
                 include_diag=True):
    """Structured matvec with the *compressed* matrix ``K_bar (+ diag)``
    (reference ``apply_forward``, ``hodlr.h:242-259``): batched leaf-block
    matmuls plus per-level low-rank couplings — O(N r log N)."""
    if not struct.transposed:
        return _hodlr_matvec_row(pair_fn, theta, xpad, valid, diag_pad,
                                 struct, X, include_diag)
    squeeze = X.ndim == 1
    Xt = X[None, :] if squeeze else X.T
    Yt = _matvec_t(pair_fn, theta, xpad, valid, diag_pad, struct, Xt,
                   include_diag)
    return Yt[0] if squeeze else Yt.T


@full_precision_matmuls
def _matvec_t(pair_fn, theta, xpad, valid, diag_pad, struct, Xt,
              include_diag=True):
    """Transposed core of :func:`hodlr_matvec`: ``Xt (k, n_pad)`` with
    the long row axis minor throughout (see :func:`_factor_apply_inv`)."""
    n_pad, m = struct.n_pad, struct.m
    B = n_pad // m
    k = Xt.shape[0]

    xb = xpad.reshape(B, m, -1)
    vb = valid.reshape(B, m)
    db = diag_pad.reshape(B, m)
    Xl = Xt.reshape(k, B, m).transpose(1, 0, 2)          # (B, k, m)

    def leaf_apply(xc, vc, dc, Xc):
        Kc = jax.vmap(
            lambda xa, va: _block_matrix(pair_fn, theta, xa, va, xa, va)
        )(xc, vc)
        if include_diag:
            Kc = Kc + jax.vmap(jnp.diag)(dc)
        # X^T K (K symmetric): contract the row index, minor stays long
        return jnp.einsum("bki,bij->bkj", Xc, Kc)

    # size the HBM budget from the materialized leaf-gram dtype (theta x
    # xpad), not the probe dtype: mixed-precision calls (f32 probes on an
    # f64-built kernel) would otherwise under-count by 2x
    chunk = _leaf_chunk(B, m, jnp.result_type(theta.dtype, xpad.dtype))
    if chunk is None:
        Yb = leaf_apply(xb, vb, db, Xl)
    else:
        nc = B // chunk
        Yb = jax.lax.map(
            lambda a: leaf_apply(*a),
            (
                xb.reshape(nc, chunk, m, -1),
                vb.reshape(nc, chunk, m),
                db.reshape(nc, chunk, m),
                Xl.reshape(nc, chunk, k, m),
            ),
        ).reshape(B, k, m)
    Yt = Yb.transpose(1, 0, 2).reshape(k, n_pad)

    for lev, (Ct, Qt) in zip(
        struct.levels,
        _all_lowrank_t(pair_fn, theta, xpad, valid, struct,
                       diag_pad.dtype),
    ):
        s, p, c = lev["s"], lev["p"], lev["c"]
        Xb = Xt.reshape(k, p, 2, s)
        # left rows += P (Q^T x_right); right rows += Q (P^T x_left)
        qx = jnp.einsum("cps,kps->pck", Qt, Xb[:, :, 1])
        px = jnp.einsum("cps,kps->pck", Ct, Xb[:, :, 0])
        add_l = jnp.einsum("cps,pck->kps", Ct, qx)
        add_r = jnp.einsum("cps,pck->kps", Qt, px)
        Yt = Yt + jnp.stack([add_l, add_r], axis=2).reshape(Yt.shape)
    return Yt


@full_precision_matmuls
def hodlr_loglike_and_grad_hutchinson(
    pair_fn, theta, xpad, valid, diag_pad, r_pad, struct, key,
    num_probes=16, n_real=None, refine_steps=0, factors_logdet=None,
):
    """Log-likelihood + gradient without reverse-mode through the sweep.

    The exact-autodiff gradient stores the O(L^2) ancestor-update chain —
    ~10 GB at N=1e6 — so at very large N the gradient uses the reference's
    matrix-free Regime B (``gp.py:506-562``) built from this solver's
    primitives, entirely forward-mode:

      d ll / d theta_k = 1/2 a^T (dK/dth_k) a
                          - 1/2 E_u[(K^{-1}u)^T (dK/dth_k) u],

    with ``a = K^{-1} r`` and Rademacher probes ``u``; ``dK`` matvecs are
    ``jax.jvp`` of the compressed matvec (the analogue of the reference's
    per-parameter gradient trees, ``_hodlr.cpp:171-191``). Memory: one
    factorization + (1 + num_probes) solves.

    ``factors_logdet``: optionally pass a precomputed
    ``(factors, logdet)`` from :func:`hodlr_factor` and skip the in-graph
    factorization. Jitting the factorization and this remainder as TWO
    programs, with the factor pytree threaded between them as device
    arguments, bounds each program's peak memory instead of
    their sum (at N=1e6 the single fused program needs ~16 G).
    """
    n = struct.n if n_real is None else n_real
    if factors_logdet is not None:
        factors, logdet = factors_logdet
    else:
        factors, logdet = hodlr_factor(
            pair_fn, theta, xpad, valid, diag_pad, struct
        )
    # transposed throughout: multi-RHS batches are (k, n_pad), long row
    # axis minor (see _factor_apply_inv_t). On a row-layout struct (small N) the
    # same math routes through the public row functions with boundary
    # transposes — cheap at those sizes.
    if struct.transposed:
        _solve = lambda Xt: _solve_t(factors, struct, Xt)  # noqa: E731
        _mvf = lambda Xt: _matvec_factors_t(  # noqa: E731
            factors, struct, Xt)
        _mv_nd = lambda th, Xt: _matvec_t(  # noqa: E731
            pair_fn, th, xpad, valid, diag_pad, struct, Xt,
            include_diag=False)
    else:
        _solve = lambda Xt: hodlr_solve(  # noqa: E731
            factors, struct, Xt.T).T
        _mvf = lambda Xt: hodlr_matvec_factors(  # noqa: E731
            factors, struct, Xt.T).T
        _mv_nd = lambda th, Xt: hodlr_matvec(  # noqa: E731
            pair_fn, th, xpad, valid, diag_pad, struct, Xt.T,
            include_diag=False).T
    probes = jax.random.rademacher(
        key, (num_probes, struct.n_pad), dtype=r_pad.dtype
    )
    probes = probes * valid[None, :]
    rhs = jnp.concatenate([r_pad[None, :], probes], axis=0)
    if refine_steps:
        # f32 at very large N: the cascade's CONSTRUCTION error moves
        # both halves of the likelihood (at N=1e6 ~1e-2 relative ll
        # error with quad-only refinement — the logdet bias from the
        # f32 build is the remainder). Two fixes
        # from the same residual pass, both assembly-free
        # (``hodlr_matvec_factors``):
        #
        # 1. residual-minimizing refinement of the solves
        #    (``hodlr_solve_refined``);
        # 2. a trace correction of the computed logdet: with F the
        #    factored inverse and E = K_bar F - I,
        #      log det K_bar = log det F^{-1} + tr log(I + E)
        #                   ~= logdet + tr(E) - tr(E^2)/2,
        #    where tr(E) = -E_u[u^T r_u] over the Rademacher probes
        #    (r_u = u - K_bar F u is the refinement residual, already
        #    computed) and tr(E^2) = E_u[u^T(r_u - K_bar F r_u)] reuses
        #    the refinement direction's matvec. The estimator noise is
        #    ~sqrt(2 ||E||_F^2 / P) nats — O(1) against the O(1e3)-nat
        #    bias it removes.
        #
        # The series for tr log(I + E) only converges for spectral
        # radius < 1. A healthy f32 cascade sits at ||E u||/||u|| ~ 1e-3;
        # but CPU f32 cascades can reach O(10) (measured: the correction turned
        # a 1.3e-1 ll error into 1.3e+0 there), so the correction is
        # gated on the measured residual ratio and degrades to the
        # uncorrected logdet outside its validity regime.
        sol0 = _solve(rhs)
        R0 = rhs - _mvf(sol0)
        trE = -jnp.mean(jnp.sum(probes * R0[1:], axis=1))
        rho2 = jnp.mean(
            jnp.sum(R0[1:] ** 2, axis=1)
            / jnp.maximum(jnp.sum(probes**2, axis=1), 1.0)
        )
        sol = sol0
        R = R0
        trE2 = None
        for _ in range(refine_steps):
            D = _solve(R)
            KD = _mvf(D)
            if trE2 is None:
                # E u = -r_u, E(E u) = r_u - K_bar D_u: second-order
                # trace term free from the first refinement step
                trE2 = jnp.mean(
                    jnp.sum(probes * (R0 - KD)[1:], axis=1)
                )
            w = jnp.sum(R * KD, axis=1) / jnp.maximum(
                jnp.sum(KD * KD, axis=1), jnp.finfo(rhs.dtype).tiny
            )
            sol = sol + w[:, None] * D
            R = R - w[:, None] * KD
        logdet = logdet + jnp.where(
            rho2 < 0.25, trE - 0.5 * trE2, 0.0
        )
    else:
        sol = _solve(rhs)
    alpha, Kinv_u = sol[0], sol[1:]
    quad = jnp.dot(r_pad, alpha)
    ll = -0.5 * (quad + logdet + n * jnp.log(2.0 * jnp.pi))

    av = jnp.concatenate([alpha[None, :], probes], axis=0)

    def mv(th):
        return _mv_nd(th, av)

    T = theta.shape[0]
    eyeT = jnp.eye(T, dtype=theta.dtype)
    # One batched forward pass for every theta direction at once: vmap
    # of jvp keeps the PRIMAL un-batched (it does not depend on the
    # tangent axis) and batches only the tangent-linear ops, with the
    # tangent axis FIRST so the long row axis stays minor (jacfwd would
    # put the narrow T axis last). In the row layout this batch's
    # skeleton temps held ~1.2 G at N=1e6 and tangents had to stream
    # through lax.map with the primal recomputed per direction; the
    # transposed layout shrinks those temps, so one vectorized pass is
    # both the fast and the memory-safe form at every N. dK_av_t: (T, 1 + P, n_pad).
    dK_av_t = jax.vmap(
        lambda e: jax.jvp(mv, (theta,), (e,))[1]
    )(eyeT)
    quad_terms = 0.5 * jnp.einsum("i,ti->t", alpha, dK_av_t[:, 0, :])
    trace_terms = 0.5 * jnp.mean(
        jnp.einsum("pi,tpi->tp", Kinv_u, dK_av_t[:, 1:, :]), axis=1
    )
    return ll, quad_terms - trace_terms


@full_precision_matmuls
def hodlr_factor_sym(pair_fn, theta, xpad, valid, diag_pad, struct):
    """Symmetric factorization ``K = W W^T`` (reference ``sym`` variant,
    ``hodlr.h:713-786``), batched level-by-level.

    ``W = L_leaf G_L ... G_1`` where each ``G_l`` is block-diagonal over
    sibling pairs: per pair, with ``Utilde = W_left^{-1} P`` and
    ``Vtilde = W_right^{-T} Q``, the symmetrized node is
    ``I + U C U^T`` (``U = blkdiag(Utilde, Vtilde)``, ``C = [[0,I],[I,0]]``);
    QR-orthonormalize each half (the reference's Q-factors,
    ``hodlr.h:736-754``) and take the PSD square root of the small
    ``2c x 2c`` core by eigendecomposition, clamping eigenvalues at a tiny
    floor (replacing the reference's jitter-escalation retry loop,
    ``hodlr.h:755-774``, with an analytic repair). ``G`` is symmetric, so
    ``G^{-T} = G^{-1}`` and one small matrix pair (``S^{1/2}-I``,
    ``S^{-1/2}-I``) serves all four applications.

    Returns ``({"Lleaf", "levels": [(Qu, Qv, Msym, Minv), ...]}, logdet)``
    with ``logdet = log det K = 2 log det W`` accumulated from the leaf
    Cholesky diagonals and the small-core eigenvalues (the reference reads
    the same quantities off its LDLT/LU diagonals, ``hodlr.h:122-151``).
    """
    n_pad, m, L = struct.n_pad, struct.m, struct.L
    B = n_pad // m
    dtype = diag_pad.dtype

    xb = xpad.reshape(B, m, -1)
    vb = valid.reshape(B, m)
    # struct.remat gates leaf-assembly rematerialization exactly as on
    # the non-symmetric path: small problems (remat=False) keep the
    # cheaper non-recomputing reverse mode; large-N problems recompute.
    Lleaf = _leaf_cholesky_chunked(
        pair_fn, theta, xb, vb, diag_pad.reshape(B, m), struct.remat
    )
    logdet = 2.0 * jnp.sum(
        jnp.log(jnp.diagonal(Lleaf, axis1=-2, axis2=-1))
    )

    def leaf_tri_solve(X, trans):
        def one(Lb, Xb):
            return jax.scipy.linalg.solve_triangular(
                Lb, Xb, lower=True, trans=trans
            )

        return jax.vmap(one)(Lleaf, X.reshape(B, m, -1)).reshape(X.shape)

    Us, Vs = [], []
    for lev, (C, Q) in zip(
        struct.levels, _all_lowrank_row(pair_fn, theta, xpad, valid,
                                        struct, dtype)
    ):
        c = lev["c"]
        # full-row layout: U rows live on left blocks, V rows on right
        U = jnp.stack([C, jnp.zeros_like(Q)], axis=1).reshape(n_pad, c)
        V = jnp.stack([jnp.zeros_like(C), Q], axis=1).reshape(n_pad, c)
        Us.append(U)
        Vs.append(V)

    # B = W1^{-1} A12 W2^{-T} = (W1^{-1} P)(W2^{-1} Q)^T — both tilde
    # factors take the same W^{-1} sweep (leaf L^{-1} first, then each
    # G^{-1} as it is created, fine to coarse).
    Ut = [leaf_tri_solve(U, 0) for U in Us]
    Vt = [leaf_tri_solve(V, 0) for V in Vs]

    levels_out = [None] * L
    eigen_floor = 100.0 * jnp.finfo(dtype).eps
    for li in range(L - 1, -1, -1):
        lev = struct.levels[li]
        s, p, c = lev["s"], lev["p"], lev["c"]
        Ub = Ut[li].reshape(p, 2, s, c)[:, 0]
        Vb = Vt[li].reshape(p, 2, s, c)[:, 1]
        Qu, Ru = jnp.linalg.qr(Ub)               # (p, s, c), (p, c, c)
        Qv, Rv = jnp.linalg.qr(Vb)
        cross = jnp.einsum("pij,pkj->pik", Ru, Rv)   # Ru Rv^T
        zero = jnp.zeros((p, c, c), dtype=dtype)
        S = jnp.concatenate(
            [
                jnp.concatenate([zero, cross], axis=-1),
                jnp.concatenate(
                    [jnp.swapaxes(cross, -1, -2), zero], axis=-1
                ),
            ],
            axis=-2,
        )
        eye2 = jnp.eye(2 * c, dtype=dtype)
        evals, evecs = jnp.linalg.eigh(eye2 + S)
        evals = jnp.maximum(evals, eigen_floor)
        # det G = det(I + Qhat M Qhat^T) = det(S^{1/2}); logdet K = 2 logdet W
        logdet = logdet + jnp.sum(jnp.log(evals))
        sqrt_e = jnp.sqrt(evals)
        Msym = (
            jnp.einsum("pik,pk,pjk->pij", evecs, sqrt_e, evecs) - eye2
        )
        Minv = (
            jnp.einsum("pik,pk,pjk->pij", evecs, 1.0 / sqrt_e, evecs)
            - eye2
        )
        levels_out[li] = (Qu, Qv, Msym, Minv)

        def ginv(X, Qu=Qu, Qv=Qv, Minv=Minv, p=p, s=s, c=c):
            return _sym_apply(Qu, Qv, Minv, p, s, c, X)

        # update coarser factors: G^{-1} hits both U-tilde and V-tilde
        for mi in range(li):
            Ut[mi] = ginv(Ut[mi])
            Vt[mi] = ginv(Vt[mi])

    return {"Lleaf": Lleaf, "levels": levels_out}, logdet


def _sym_apply(Qu, Qv, M, p, s, c, X):
    """Apply the symmetric factor ``I + Qhat M Qhat^T`` (block-diagonal
    per pair, ``Qhat = blkdiag(Qu, Qv)``) to ``X`` ``(n_pad, k)``."""
    k = X.shape[-1]
    Xb = X.reshape(p, 2, s, k)
    top = jnp.einsum("psc,psk->pck", Qu, Xb[:, 0])
    bot = jnp.einsum("psc,psk->pck", Qv, Xb[:, 1])
    y = jnp.einsum("pcd,pdk->pck", M, jnp.concatenate([top, bot], axis=1))
    add_l = jnp.einsum("psc,pck->psk", Qu, y[:, :c])
    add_r = jnp.einsum("psc,pck->psk", Qv, y[:, c:])
    return (Xb + jnp.stack([add_l, add_r], axis=1)).reshape(X.shape)


@full_precision_matmuls
def hodlr_sqrt_matvec(sym_factors, struct, X, transpose=False):
    """``W X`` (or ``W^T X``) through the symmetric cascade.

    ``W = L_leaf G_L ... G_1``: forward applies the root factor first and
    the leaf Cholesky last; transpose reverses and uses ``L^T``.
    """
    Lleaf = sym_factors["Lleaf"]
    B, m, _ = Lleaf.shape
    squeeze = X.ndim == 1
    if squeeze:
        X = X[:, None]

    def leaf_mul(X, trans):
        Xb = X.reshape(B, m, -1)
        if trans:
            Y = jnp.einsum("bji,bjk->bik", Lleaf, Xb)
        else:
            Y = jnp.einsum("bij,bjk->bik", Lleaf, Xb)
        return Y.reshape(X.shape)

    if transpose:
        # W^T = G_1 ... G_L L^T: leaf first, then fine -> coarse
        X = leaf_mul(X, True)
        order = range(len(struct.levels) - 1, -1, -1)
    else:
        # W = L G_L ... G_1: coarse -> fine, leaf last
        order = range(len(struct.levels))
    for li in order:
        lev = struct.levels[li]
        Qu, Qv, Msym, _ = sym_factors["levels"][li]
        X = _sym_apply(Qu, Qv, Msym, lev["p"], lev["s"], lev["c"], X)
    if not transpose:
        X = leaf_mul(X, False)
    return X[:, 0] if squeeze else X


@full_precision_matmuls
def hodlr_sqrt_solve(sym_factors, struct, X, transpose=False):
    """``W^{-1} X`` (or ``W^{-T} X``) through the symmetric cascade — the
    reference's ``solve_sym`` / ``solve_sym_transpose``
    (``hodlr.h:169-185, 848-968``).

    ``W = L G_L ... G_1`` with every ``G_l`` symmetric, so
    ``W^{-1} = G_1^{-1} ... G_L^{-1} L^{-1}`` (leaf triangular solve first,
    levels fine-to-coarse) and ``W^{-T} = L^{-T} G_L^{-1} ... G_1^{-1}``
    (levels coarse-to-fine, ``L^T`` solve last); each ``G_l^{-1}`` is the
    stored ``I + Qhat (S^{-1/2}-I) Qhat^T``. ``K^{-1} = W^{-T} W^{-1}``.
    """
    Lleaf = sym_factors["Lleaf"]
    B, m, _ = Lleaf.shape
    squeeze = X.ndim == 1
    if squeeze:
        X = X[:, None]

    def leaf_solve_tri(X, trans):
        def one(Lb, Xb):
            return jax.scipy.linalg.solve_triangular(
                Lb, Xb, lower=True, trans=trans
            )

        return jax.vmap(one)(Lleaf, X.reshape(B, m, -1)).reshape(X.shape)

    if transpose:
        order = range(len(struct.levels))
    else:
        X = leaf_solve_tri(X, 0)
        order = range(len(struct.levels) - 1, -1, -1)
    for li in order:
        lev = struct.levels[li]
        Qu, Qv, _, Minv = sym_factors["levels"][li]
        X = _sym_apply(Qu, Qv, Minv, lev["p"], lev["s"], lev["c"], X)
    if transpose:
        X = leaf_solve_tri(X, 1)
    return X[:, 0] if squeeze else X


# ---------------------------------------------------------------------------
# Solver class (george-compatible protocol)
# ---------------------------------------------------------------------------

class HODLRSolver(object):
    """Hierarchical solver with the george HODLR surface
    (``solvers/hodlr.py:13-104`` / ``_hodlr.cpp:301-427``).

    :param kernel: the covariance kernel.
    :param min_size: leaf box size (reference default 100; here 64).
    :param rank: skeleton rank per off-diagonal block; if ``None``, derived
        from ``tol`` (the reference's accuracy knob).
    :param tol: target relative accuracy; mapped to a static rank.
    :param seed: pivot RNG seed (reference ``seed=42``).
    :param sort: Morton-sort inputs host-side for compressibility.
    :param pivots: ``"aca"`` (default) or ``"fps"``. The ACA walk runs
        on JAX's host CPU device (:func:`pivot_device`), so a process
        that restricts ``JAX_PLATFORMS`` must keep ``cpu`` in the list
        (``cuda,cpu``); without it ``compute`` raises.
    """

    matrix_free = False

    def __init__(self, kernel, min_size=64, rank=None, tol=0.1,
                 tol_abs=None, seed=42, sort=True, verbose=False,
                 debug=False, compute_grad=False, sym=False, knn=None,
                 grad_mode="exact", num_probes=16, mesh=None,
                 shard_axis="data", pivots="aca", refine_steps="auto",
                 **kwargs):
        self.kernel = kernel
        self.min_size = int(min_size)
        if rank is None:
            if tol >= 1e-2:
                rank = 16
            elif tol >= 1e-4:
                rank = 24
            elif tol >= 1e-6:
                rank = 32
            elif tol >= 1e-8:
                rank = 48
            else:
                rank = 64
        self.rank = int(rank)
        self.seed = int(seed)
        self.sort = bool(sort)
        self.verbose = bool(verbose)
        self.debug = bool(debug)
        # ``sym=1``: factor K = W W^T (reference ``hodlr.h:713-786``) and
        # run the solver protocol through W^{-T} W^{-1}; exposes
        # ``apply_inverse_sym_W(_transpose)`` and the symmetric Hutchinson
        # trace estimator (``gp.py:544-547``).
        self.sym = bool(sym)
        # ``knn=k``: NN-guided skeleton pivots (the reference's
        # precomputed-neighbor CUR path); neighbor lists come from
        # ``compute(..., nns=...)`` or are built with the in-tree kd-tree.
        self.knn = None if knn is None else int(knn)
        # ``tol_abs``: absolute accuracy floor for the skeleton
        # interpolation ridge (see ``HODLRStructure.ridge_floor``).
        self.tol_abs = None if tol_abs is None else float(tol_abs)
        # pivot strategy: "aca" (default) walks the actual kernel at
        # compute-time theta — required for oscillatory / quasi-periodic
        # kernels, strictly better elsewhere; "fps" is the geometry-only
        # fallback (theta-independent). Explicit ``nns``/``knn`` input
        # switches to the neighbor-guided FPS path.
        if pivots not in ("aca", "fps"):
            raise ValueError("pivots must be 'aca' or 'fps'")
        self.pivots = pivots
        # "exact": gradients by reverse-mode through the factorization
        # (default; stores the update chain — fine to N ~ 3e5 per device).
        # "hutchinson": the reference's matrix-free Regime B
        # (gp.py:506-562) built from jvp matvecs + multi-RHS solves —
        # O(N r log N) memory, stochastic trace term, for very large N.
        # compute_grad=True (the reference's flag) selects hutchinson.
        if compute_grad:
            grad_mode = "hutchinson"
        if grad_mode not in ("exact", "hutchinson"):
            raise ValueError("grad_mode must be 'exact' or 'hutchinson'")
        self.grad_mode = grad_mode
        self.matrix_free = grad_mode == "hutchinson"
        self.num_probes = int(num_probes)
        # Optional data-parallel distribution: placing the padded point,
        # mask, diagonal and RHS arrays row-sharded over a device mesh is
        # sufficient — GSPMD partitions the whole level-batched
        # factorization/solve, inserting collectives where coarse levels
        # couple shards (validated against the unsharded path to 1e-9).
        self.mesh = mesh
        self.shard_axis = shard_axis
        # Mixed-precision iterative refinement on every factor solve
        # (see ``hodlr_solve_refined``): "auto" = 1 step when running
        # f32 at N >= 2e5, where the cascade's forward error crosses
        # the likelihood's accuracy budget (measured 1.1e-2 relative ll
        # error at N=1e6 f32, back to ~7e-4 with one step); an int
        # forces that many steps (0 disables).
        if refine_steps != "auto":
            refine_steps = int(refine_steps)
        self.refine_steps = refine_steps
        self.computed = False
        self.log_determinant = None
        self._struct = None
        self._factors = None
        self._perm = None
        self._x = None
        self._xpad = None
        self._valid = None
        self._diag_pad = None

    # -- setup -------------------------------------------------------------

    def compute(self, x, yerr=0.0, nns=None, **kwargs):
        # Drop every derived cache: they close over the previous
        # structure/points/hyperparameters and would silently go stale on
        # a recompute (GP.compute re-instantiates the solver, but direct
        # solver use must be safe too).
        self._mv_fn = None
        self._mv_jvp_fn = None
        self._sym_factors = None
        self._sqrt_fn = None
        self._sym_theta = None
        self._sym_factor_fn = None
        x = as_points(x)
        n = len(x)
        yerr2 = np.atleast_1d(np.asarray(yerr, dtype=np.float64)) ** 2
        if yerr2.size == 1:
            yerr2 = yerr2 * np.ones(n)

        # geometry coordinates: kernels with a non-geometric label column
        # (the LCM task id) declare their spatial axes via ``sort_axes``;
        # ordering/partitioning on the label would make coarse
        # off-diagonal blocks full-domain cross-task matrices (not
        # low-rank) — see ``LCMKernel.sort_axes``
        sa = getattr(self.kernel, "sort_axes", None)
        x_geom = x if sa is None else x[:, list(sa)]
        self._perm = (
            morton_sort_samples(x_geom) if self.sort
            else np.arange(n, dtype=np.int64)
        )
        xs = x[self._perm]
        xs_geom = x_geom[self._perm]
        # the skeleton-guidance path only understands a rectangular kNN
        # matrix (the reference's precomputed-neighbor format,
        # ``_hodlr.cpp:121-128``); CSR tuples / ragged listings / bare
        # triggers are sparse-solver structures — accept and ignore them,
        # as the reference's HODLR ctor does with foreign nns forms
        if nns is not None and (
            isinstance(nns, tuple) or np.isscalar(nns)
            or np.asarray(nns).dtype == object
            or np.ndim(nns) != 2
        ):
            nns = None
        if nns is None and self.knn:
            from ..neighbors import knn_indices

            nns = knn_indices(x, self.knn)
        nns_sorted = None
        if nns is not None:
            # neighbor lists arrive in the original point order; map both
            # rows and entries into the sorted/padded layout
            nns = np.asarray(nns, dtype=np.int64)
            pos = np.empty(n, dtype=np.int64)
            pos[self._perm] = np.arange(n, dtype=np.int64)
            mapped = np.where(nns >= 0, pos[np.clip(nns, 0, n - 1)], -1)
            nns_sorted = mapped[self._perm]
        self._struct = build_structure(
            n, min_size=self.min_size, rank=self.rank, seed=self.seed,
            x_sorted=xs_geom, nns=nns_sorted, ridge_floor=self.tol_abs,
        )
        st = self._struct
        if self.pivots == "aca" and nns_sorted is None and st.L > 0:
            # kernel-adaptive skeletons at the compute-time theta (see
            # select_aca_pivots); the downstream factorization is still
            # exact-in-theta, so autodiff through loglike_fn is unaffected
            xs_pad = np.concatenate(
                [xs, np.repeat(xs[-1:], st.n_pad - n, axis=0)], axis=0
            )
            vpad = np.zeros(st.n_pad, dtype=bool)
            vpad[:n] = True
            select_aca_pivots(
                self.kernel.pair_fn,
                np.asarray(self.kernel.parameter_vector),
                xs_pad, vpad, st,
            )
        d2 = yerr2[self._perm]

        xpad = np.concatenate(
            [xs, np.repeat(xs[-1:], st.n_pad - n, axis=0)], axis=0
        )
        valid = np.zeros(st.n_pad, dtype=bool)
        valid[:n] = True
        diag_pad = np.ones(st.n_pad)
        diag_pad[:n] = d2

        self._x = x
        self._xpad = jnp.asarray(xpad)
        self._valid = jnp.asarray(valid)
        self._diag_pad = jnp.asarray(diag_pad)
        self._row_sharding = None
        if self.mesh is not None:
            ndev = int(np.prod(list(self.mesh.shape.values())))
            if st.n_pad % ndev != 0:
                import warnings

                warnings.warn(
                    "HODLRSolver: padded size %d is not divisible by the "
                    "%d-device mesh; running unsharded. Choose min_size "
                    "so that n_pad %% n_devices == 0 to distribute."
                    % (st.n_pad, ndev),
                    RuntimeWarning,
                )
            if st.n_pad % ndev == 0:
                from jax.sharding import NamedSharding, PartitionSpec as P

                self._row_sharding = NamedSharding(
                    self.mesh, P(self.shard_axis)
                )
                # let the factor/solve sweeps pin their row-layout arrays
                # (see _row_anchor)
                st.mesh = self.mesh
                st.shard_axis = self.shard_axis
                row2 = NamedSharding(self.mesh, P(self.shard_axis, None))
                self._xpad = jax.device_put(self._xpad, row2)
                self._valid = jax.device_put(
                    self._valid, self._row_sharding
                )
                self._diag_pad = jax.device_put(
                    self._diag_pad, self._row_sharding
                )

        pair = self.kernel.pair_fn
        theta = jnp.asarray(self.kernel.parameter_vector)
        refine = self.refine_steps
        if refine == "auto":
            refine = int(
                self._xpad.dtype == jnp.float32 and n >= 200_000
            )
        self._refine_eff = refine
        if self.sym:
            self._factor_fn = jax.jit(
                lambda th, xp, v, dp: hodlr_factor_sym(
                    pair, th, xp, v, dp, st
                )
            )
            base_solve = lambda f, yy: hodlr_sqrt_solve(  # noqa: E731
                f, st, hodlr_sqrt_solve(f, st, yy), transpose=True
            )
        else:
            self._factor_fn = jax.jit(
                lambda th, xp, v, dp: hodlr_factor(pair, th, xp, v, dp, st)
            )
            base_solve = lambda f, yy: hodlr_solve(f, st, yy)  # noqa: E731
        if refine:
            # refinement needs the compressed matvec at compute-theta;
            # it wraps EITHER cascade (any approximate K^{-1} apply)
            xp_, v_, dp_ = self._xpad, self._valid, self._diag_pad

            def _refined(f, yy, th=theta):
                Z = base_solve(f, yy)
                for _ in range(refine):
                    R = yy - hodlr_matvec(
                        pair, th, xp_, v_, dp_, st, Z, include_diag=True
                    )
                    Z = Z + base_solve(f, R)
                return Z

            self._solve_fn = jax.jit(_refined)
        else:
            self._solve_fn = jax.jit(base_solve)
        from ..diagnostics import timer

        # the reference prints "Time taken for HODLR" per build
        # (_hodlr.cpp:139-141); here the span is registered and only
        # printed when verbose
        with timer("hodlr.compute", verbose=self.verbose) as tm:
            factors, logdet = tm.sync(
                self._factor_fn(
                    theta, self._xpad, self._valid, self._diag_pad
                )
            )
        if not bool(jnp.isfinite(logdet)):
            raise np.linalg.LinAlgError(
                "HODLR factorization failed (non-finite log-determinant)"
            )
        self._factors = factors
        if self.sym:
            # the main factors ARE the symmetric cascade; share them with
            # the sqrt/sym-W surface
            self._sym_factors = factors
            self._sym_theta = np.asarray(theta)
        self.log_determinant = float(logdet)
        self.computed = True
        self._factorization_self_check()

    # configs already residual-checked this process: the check costs two
    # program traces (solve + compressed matvec), too much to pay on
    # every recompute of an optimizer loop. Its target failure mode (an
    # unsuitable kernel FAMILY) is mostly a per-configuration property,
    # but the instability threshold is theta-dependent (a length scale
    # growing past the domain size turns a decaying kernel effectively
    # non-decaying), so the memo key includes a coarse per-parameter
    # e-fold bucket: an optimizer walking theta into a new regime
    # re-triggers the check once per regime, while same-regime
    # recomputes stay free. Sampler-driven theta changes go through the
    # fused ``loglike_fn`` path and are not covered — by design (that
    # path must stay pure/jittable).
    _checked_configs = set()

    def _factorization_self_check(self):
        """One-probe residual check ``|K̄ (K̄^{-1} v) - v| / |v|`` against
        the COMPRESSED operator (so skeleton truncation does not enter —
        only factorization instability does). Runs once per (kernel
        structure, n, min_size, rank) per process — unless ``debug=1``,
        which runs it unconditionally on every compute and additionally
        reports the compression error against the EXACT kernel (the
        reference's two debug prints, ``_hodlr.cpp:143-161``:
        ``|K - K_bar I|/|K|`` and ``|K_bar^{-1} K_bar I - I|``; here both
        are probe-based so debug stays usable beyond toy N).

        The weak-admissibility SMW cascade is numerically unstable for
        NON-DECAYING kernels (Linear/Polynomial/DotProduct-dominated
        covariances): the off-diagonal coupling rivals the block
        diagonal and the 2c x 2c SMW cores become singular to working
        precision (measured: cond ~8e18 on a PolynomialKernel where the
        compressed K̄ itself is exact to 6e-9). The reference's
        identical cascade (``hodlr.h:707-711``) fails the same way and
        stays silent; here the failure is detected and reported."""
        self.factor_residual = None  # not measured on memoized recomputes
        self.compression_error = None  # measured only under debug=1
        theta = np.asarray(self.kernel.parameter_vector, dtype=np.float64)
        if np.isfinite(theta).all():
            # e-fold regime buckets. Most parameters live in log space so
            # unit-width buckets track multiplicative regime; linear-scale
            # params (e.g. ExpSine2 gamma) just get finer granularity
            # (more conservative — extra checks, never missed ones).
            key = (
                tuple(self.kernel.get_parameter_names()),
                type(self.kernel).__name__,
                len(self._perm), self.min_size, self.rank,
                str(np.asarray(self._xpad).dtype),
                tuple(np.floor(theta).astype(np.int64).tolist()),
            )
            if key in HODLRSolver._checked_configs and not self.debug:
                return
            HODLRSolver._checked_configs.add(key)
        # non-finite theta: floor() is undefined for the bucket — never
        # memoize, always run the check (such a compute deserves one)
        rng = np.random.default_rng(self.seed + 7)
        v = rng.standard_normal(len(self._perm))
        z = self.apply_inverse(v)
        r = float(
            np.linalg.norm(np.asarray(self.apply_forward(z)) - v)
            / np.linalg.norm(v)
        )
        self.factor_residual = r
        if self.debug:
            # the reference's first debug print: compression error of the
            # hierarchical representation vs the exact kernel
            # (``_hodlr.cpp:143-155``), probe-based instead of K_bar @ I
            zb = np.asarray(self.apply_forward(v))
            ze = self._exact_matvec(v)
            self.compression_error = float(
                np.linalg.norm(zb - ze) / np.linalg.norm(ze)
            )
            if self.verbose:
                print(
                    "HODLR debug: compression rel err %.3e; "
                    "factorization residual %.3e"
                    % (self.compression_error, self.factor_residual)
                )
        tol = 1e-6 if np.asarray(self._xpad).dtype == np.float64 else 1e-2
        if r > tol:
            import warnings

            warnings.warn(
                "HODLR factorization self-check failed: relative solve "
                "residual %.2e against the compressed operator. The "
                "weak-admissibility SMW cascade is numerically unstable "
                "for non-decaying kernels (Linear/Polynomial/DotProduct"
                "-dominated covariances) — log-likelihoods and solves "
                "from this factorization are unreliable; use BasicSolver "
                "(or, for compact-support kernels, SparseSolver) "
                "instead." % r,
                stacklevel=3,
            )

    def _exact_matvec(self, v, chunk=4096):
        """Exact ``(K + diag) v`` by chunked dense row blocks (original
        point order) — O(n^2) flops but O(n * chunk) memory, so the
        debug compression check stays usable at large n."""
        x = self._x
        n = len(x)
        d_sorted = np.asarray(self._diag_pad)[:n]
        d = np.empty(n)
        d[self._perm] = d_sorted
        v = np.asarray(v, dtype=np.float64)
        out = np.empty(n)
        for i in range(0, n, chunk):
            rows = self.kernel.get_value(x[i:i + chunk], x)
            out[i:i + chunk] = np.asarray(rows, dtype=np.float64) @ v
        return out + d * v

    # -- pure fused surface -------------------------------------------------

    def loglike_fn(self):
        """Pure ``f(theta_kernel, diag, r) -> log-likelihood`` through the
        hierarchical factorization (differentiable end-to-end)."""
        st = self._struct
        pair = self.kernel.pair_fn
        perm = jnp.asarray(self._perm)
        xpad, valid = self._xpad, self._valid
        n = st.n

        @full_precision_matmuls
        def loglike(theta_k, diag, r):
            diag_pad = jnp.concatenate(
                [diag[perm], jnp.ones(st.n_pad - n, dtype=diag.dtype)]
            )
            r_pad = jnp.concatenate(
                [r[perm], jnp.zeros(st.n_pad - n, dtype=r.dtype)]
            )
            factors, logdet = hodlr_factor(
                pair, theta_k, xpad, valid, diag_pad, st
            )
            z = hodlr_solve(factors, st, r_pad)
            quad = jnp.dot(r_pad, z)
            return -0.5 * (quad + logdet + n * jnp.log(2.0 * jnp.pi))

        return loglike

    def residual_fn(self):
        """Pure ``f(theta_kernel, diag, r) -> relative solve residual``
        ``|K_bar z - r| / |r|`` of the fused factorization at ``theta``.

        The fused ``loglike_fn`` path is pure/jittable by design, so the
        per-compute factorization self-check never sees the thetas a
        sampler walks through — a chain crossing into a non-decaying
        regime (e.g. a Linear/Polynomial amplitude growing until the SMW
        cores go singular, the silent failure of the reference's
        identical cascade ``hodlr.h:707-711``) would get garbage
        log-probabilities with no diagnostic. This function is the
        post-hoc monitor: evaluate it at the thetas a sampler visited
        (``GP.check_fused_thetas`` picks the extremes) and compare
        against the self-check tolerance."""
        st = self._struct
        pair = self.kernel.pair_fn
        perm = jnp.asarray(self._perm)
        xpad, valid = self._xpad, self._valid
        n = st.n

        @full_precision_matmuls
        def residual(theta_k, diag, r):
            diag_pad = jnp.concatenate(
                [diag[perm], jnp.ones(st.n_pad - n, dtype=diag.dtype)]
            )
            r_pad = jnp.concatenate(
                [r[perm], jnp.zeros(st.n_pad - n, dtype=r.dtype)]
            )
            factors, _ = hodlr_factor(
                pair, theta_k, xpad, valid, diag_pad, st
            )
            z = hodlr_solve(factors, st, r_pad)
            kz = hodlr_matvec(
                pair, theta_k, xpad, valid, diag_pad, st, z,
                include_diag=True,
            )
            return jnp.linalg.norm(kz - r_pad) / jnp.linalg.norm(r_pad)

        return residual

    # -- george protocol ----------------------------------------------------

    def _pad_rhs(self, y):
        st = self._struct
        y = np.asarray(y, dtype=np.float64)
        squeeze = y.ndim == 1
        Y = y[:, None] if squeeze else y
        Ys = Y[self._perm]
        pad = np.zeros((st.n_pad - st.n, Y.shape[1]))
        out = jnp.asarray(np.concatenate([Ys, pad], axis=0))
        if self._row_sharding is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            out = jax.device_put(
                out, NamedSharding(self.mesh, P(self.shard_axis, None))
            )
        return out, squeeze

    def _unpad(self, Z, squeeze):
        st = self._struct
        Z = np.asarray(Z)[: st.n]
        out = np.empty_like(Z)
        out[self._perm] = Z
        return out[:, 0] if squeeze else out

    def apply_inverse(self, y, in_place=False):
        Y, squeeze = self._pad_rhs(y)
        Z = self._solve_fn(self._factors, Y)
        return self._unpad(Z, squeeze)

    def dot_solve(self, y):
        Y, _ = self._pad_rhs(y)
        Z = self._solve_fn(self._factors, Y)
        return float(jnp.sum(Y * Z))

    def apply_forward(self, y, i=0):
        """Compressed matvec ``K_bar y`` (``i == 0``) or ``dK_bar/dtheta_{i-1} y``
        via a jvp through the compressed matvec (replacing the reference's
        per-parameter gradient trees, ``_hodlr.cpp:171-191``)."""
        Y, squeeze = self._pad_rhs(y)
        theta = jnp.asarray(self.kernel.parameter_vector)
        if self.__dict__.get("_mv_fn") is None:
            pair = self.kernel.pair_fn
            st = self._struct

            def mv(th, YY):
                return hodlr_matvec(
                    pair, th, self._xpad, self._valid, self._diag_pad,
                    st, YY,
                )

            self._mv_fn = jax.jit(mv)
            self._mv_jvp_fn = jax.jit(
                lambda th, tan, YY: jax.jvp(
                    lambda t: mv(t, YY), (th,), (tan,)
                )[1]
            )
        if i == 0:
            Z = self._mv_fn(theta, Y)
        else:
            tangent = jnp.zeros_like(theta).at[i - 1].set(1.0)
            Z = self._mv_jvp_fn(theta, tangent, Y)
        return self._unpad(Z, squeeze)

    def get_inverse(self):
        return self.apply_inverse(np.eye(self._struct.n))

    def get_full(self, i=0):
        """Dense reconstruction of the compressed operator ``K_bar + diag``
        (``i == 0``) or ``dK_bar/dtheta_{i-1}`` — debug parity with the
        reference's ``get_full`` (``_hodlr.cpp:402-415``). O(N^2) memory;
        for inspection at small N only."""
        return self.apply_forward(np.eye(self._struct.n), i=i)

    def grad_log_likelihood(self, gp, x, alpha, unfrozen_mask):
        """Matrix-free GP gradient (``grad_mode='hutchinson'``): exact
        quadratic terms, Hutchinson-estimated traces (reference Regime B,
        ``gp.py:506-562``), through this solver's jvp matvecs."""
        n = self._struct.n
        alpha = np.asarray(alpha)
        rng = np.random.default_rng(self.seed + 1)
        probes = rng.choice([-1.0, 1.0], size=(n, self.num_probes))
        if self.sym:
            # symmetric estimator (reference ``gp.py:544-547``): with
            # K = W W^T, tr(K^{-1} dK) = E_u[(W^{-T}u)^T dK (W^{-T}u)] —
            # the quadratic form in a *symmetric* operator, which halves
            # the Hutchinson variance relative to the unsymmetrized
            # K^{-1}u pairing below.
            w = self.apply_inverse_sym_W_transpose(probes)
            probe_l, probe_r = w, w
        else:
            probe_l, probe_r = self.apply_inverse(probes), probes

        nparam = int(self.kernel.full_size)
        kernel_grads = np.empty(nparam)
        for k in range(nparam):
            dK_alpha = self.apply_forward(alpha, k + 1)
            dK_u = self.apply_forward(probe_r, k + 1)
            quad_term = 0.5 * float(alpha @ dK_alpha)
            trace_term = 0.5 * float(
                np.mean(np.sum(probe_l * dK_u, axis=0))
            )
            kernel_grads[k] = quad_term - trace_term

        mean_g = []
        if len(gp.mean):
            mu_g = gp._call_mean_gradient(np.asarray(x))
            mean_g = list(np.dot(mu_g, alpha))
        wn_g = []
        if len(gp.white_noise):
            wn = gp._call_white_noise(np.asarray(x))
            wng = gp._call_white_noise_gradient(np.asarray(x))
            # E[w w^T] = W^{-T} W^{-1} = K^{-1} in the sym branch, so the
            # same elementwise products estimate diag(K^{-1}) either way
            diag_Kinv = (
                np.mean(probe_l ** 2, axis=1) if self.sym
                else np.mean(probe_r * probe_l, axis=1)
            )
            diag_A = alpha ** 2 - diag_Kinv
            wn_g = list(
                0.5 * np.sum((np.exp(wn) * diag_A)[None, :] * wng, axis=1)
            )
        kmask = gp.kernel.unfrozen_mask
        return np.array(mean_g + wn_g + list(kernel_grads[kmask]))

    def _ensure_sym(self):
        """(Re)build the symmetric factors ``K = W W^T`` lazily, keyed on
        the current kernel parameter vector (a parameter change between
        calls invalidates the cache)."""
        theta = np.asarray(self.kernel.parameter_vector)
        if (
            self.__dict__.get("_sym_factors") is None
            or self.__dict__.get("_sym_theta") is None
            or not np.array_equal(theta, self._sym_theta)
        ):
            if self.__dict__.get("_sym_factor_fn") is None:
                # one jitted program of theta, built per compute(): a
                # theta change is then a cheap re-execution, not a fresh
                # trace+compile
                pair = self.kernel.pair_fn
                st = self._struct
                self._sym_factor_fn = jax.jit(
                    lambda th: hodlr_factor_sym(
                        pair, th, self._xpad, self._valid,
                        self._diag_pad, st,
                    )
                )
            self._sym_factors, _ = self._sym_factor_fn(jnp.asarray(theta))
            self._sym_theta = theta
            self._sqrt_fn = None
        if self.__dict__.get("_sqrt_fn") is None:
            st = self._struct
            self._sqrt_fn = {
                "mul": jax.jit(
                    lambda f, X, t: hodlr_sqrt_matvec(
                        f, st, X, transpose=t
                    ),
                    static_argnums=2,
                ),
                "solve": jax.jit(
                    lambda f, X, t: hodlr_sqrt_solve(
                        f, st, X, transpose=t
                    ),
                    static_argnums=2,
                ),
            }

    def apply_sqrt(self, r):
        """``r @ W^T`` with ``K = W W^T`` from the symmetric factorization
        (reference ``sym`` variant + ``apply_sqrt`` semantics,
        ``basic.py:284-302``) — O(N r log N) prior sampling transport."""
        self._ensure_sym()
        r = np.asarray(r, dtype=np.float64)
        squeeze = r.ndim == 1
        R = r[None, :] if squeeze else r           # (size, n)
        st = self._struct
        Z = np.zeros((st.n_pad, R.shape[0]))
        Z[: st.n] = R.T[self._perm]
        out = np.asarray(
            self._sqrt_fn["mul"](self._sym_factors, jnp.asarray(Z), False)
        )
        res = np.empty((st.n, R.shape[0]))
        res[self._perm] = out[: st.n]
        res = res.T
        return res[0] if squeeze else res

    def _apply_sym_W(self, y, solve, transpose):
        self._ensure_sym()
        Y, squeeze = self._pad_rhs(y)
        fn = self._sqrt_fn["solve" if solve else "mul"]
        Z = fn(self._sym_factors, Y, transpose)
        return self._unpad(Z, squeeze)

    def apply_inverse_sym_W(self, y):
        """``W^{-1} y`` (reference ``apply_inverse_sym_W``,
        ``solvers/hodlr.py:72-74`` / ``hodlr.h:169-177``). Columns of a
        matrix RHS are transformed independently."""
        return self._apply_sym_W(y, solve=True, transpose=False)

    def apply_inverse_sym_W_transpose(self, y):
        """``W^{-T} y`` (reference ``apply_inverse_sym_W_transpose``,
        ``solvers/hodlr.py:75-77`` / ``hodlr.h:179-185``)."""
        return self._apply_sym_W(y, solve=True, transpose=True)

    # Pickling: drop device state; recompute on demand (the reference HODLR
    # does the same, ``hodlr.py:96-104``).
    def __getstate__(self):
        state = self.__dict__.copy()
        for k in ("_factors", "_xpad", "_valid", "_diag_pad",
                  "_factor_fn", "_solve_fn", "_mv_fn", "_mv_jvp_fn",
                  "_sym_factors", "_sqrt_fn", "_sym_factor_fn",
                  "_row_sharding",
                  "_struct"):  # _struct carries the mesh too
            state.pop(k, None)
        state["mesh"] = None  # device meshes do not serialize
        state["computed"] = False
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.__dict__.setdefault("_struct", None)
