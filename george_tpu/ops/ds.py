# -*- coding: utf-8 -*-
"""Double-single (two-float) arithmetic and a batched Gauss-Jordan
inverse + log-determinant for small, ill-conditioned matrices in f32.

Why this exists: the HODLR/SMW cascade inverts one tiny ``(2c, 2c)``
core per sibling pair per level (``solvers/hodlr.py::hodlr_factor``).
Those cores are ill-conditioned for smooth long-range kernels (kappa up
to ~7e6 at N=1e6), and an f32-COMPUTED explicit inverse carries
``kappa * eps`` forward error in its *entries* — which the T-factor
update chain can amplify with O(1) gain once the tree is deep enough.
The hypothesis behind this module is that computing ONLY the core
inverse + logdet in higher precision removes that error; it is opt-in
(``GEORGE_TPU_CORE_DS=1``) and no benchmark turns it on.

This module emulates ~2x-f32 precision (about 48 mantissa bits) with
error-free transformations on f32 pairs ``(hi, lo)`` — Dekker/Knuth
two_sum/two_prod, no FMA required — and runs Gauss-Jordan with partial
pivoting as batched elementwise work. The matrices are
tiny (m = 2c <= ~96) and batched (p up to n_pad/2m), so the O(m) masked
sequential steps cost milliseconds against the level sweep they protect.

References: Dekker (1971); Hida/Li/Bailey double-double (the f32 analog,
"double-single"), standard on f32-only accelerators. All public content;
the algorithm here is written for XLA's batched/masked execution model.
"""

import jax
import jax.numpy as jnp
import numpy as np


# -- error-free transformations (f32 in, f32-pair out) -----------------------

def _two_sum(a, b):
    """Exact sum: returns (s, e) with s = fl(a+b), s + e == a + b."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _quick_two_sum(a, b):
    """Exact sum assuming |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    """Dekker split of a 24-bit-mantissa float into two 12-bit halves.

    The splitter is 2**12 + 1 for f32 (2**27 + 1 for f64 — this module
    is f32-only by design; on CPU tests it still runs in f32).
    """
    c = jnp.asarray(4097.0, a.dtype) * a
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """Exact product: returns (p, e) with p = fl(a*b), p + e == a * b."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# -- double-single ops on (hi, lo) pairs -------------------------------------

def ds_add(xh, xl, yh, yl):
    s, e = _two_sum(xh, yh)
    e = e + (xl + yl)
    return _quick_two_sum(s, e)


def ds_sub(xh, xl, yh, yl):
    return ds_add(xh, xl, -yh, -yl)


def ds_mul(xh, xl, yh, yl):
    p, e = _two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return _quick_two_sum(p, e)


def ds_div(xh, xl, yh, yl):
    q1 = xh / yh
    ph, pl = _two_prod(q1, yh)
    pl = pl + q1 * yl
    rh, rl = ds_add(xh, xl, -ph, -pl)
    q2 = (rh + rl) / yh
    return _quick_two_sum(q1, q2)


# -- batched Gauss-Jordan with partial pivoting ------------------------------

def ds_inv_logdet(A):
    """Inverse and log|det| of a batch of small matrices, computed in
    double-single precision and returned in f32.

    ``A``: ``(p, m, m)`` float32. Returns ``(A_inv, logdet, sign)`` with
    ``A_inv`` ``(p, m, m)`` f32 (hi+lo recombined — the representation
    rounding of an ACCURATE inverse is benign, unlike the kappa*eps
    entry error of an f32-computed one), ``logdet`` ``(p,)`` f32
    ``log|det A|``, and ``sign`` ``(p,)`` the determinant sign.

    Gauss-Jordan with partial pivoting, all arithmetic on (hi, lo)
    f32 pairs (~48-bit effective mantissa): forward error in the inverse
    entries ~ kappa * 2^-48 — 7 extra decimal digits over plain f32.
    Fully batched over ``p``; the m sequential steps are masked
    full-tensor updates (XLA-friendly, no per-batch control flow).
    """
    A = jnp.asarray(A)
    p, m, _ = A.shape
    dtype = A.dtype
    eye = jnp.broadcast_to(jnp.eye(m, dtype=dtype), (p, m, m))
    Ah = jnp.concatenate([A, eye], axis=-1)            # (p, m, 2m)
    Al = jnp.zeros_like(Ah)
    rows = jnp.arange(m)

    def step(k, carry):
        Ah, Al, sign, ld_h, ld_l = carry
        # -- partial pivot on the hi parts (magnitude ordering only) --
        col = jax.lax.dynamic_index_in_dim(Ah, k, axis=2,
                                           keepdims=False)  # (p, m)
        mag = jnp.where(rows[None, :] >= k, jnp.abs(col), -jnp.inf)
        piv = jnp.argmax(mag, axis=1)                       # (p,)
        perm = jnp.broadcast_to(rows[None, :], (p, m))
        perm = jnp.where(
            perm == k, piv[:, None],
            jnp.where(perm == piv[:, None], k, perm),
        )
        Ah = jnp.take_along_axis(Ah, perm[:, :, None], axis=1)
        Al = jnp.take_along_axis(Al, perm[:, :, None], axis=1)
        sign = sign * jnp.where(piv == k, 1.0, -1.0).astype(dtype)

        # -- pivot element and row ------------------------------------
        prow_h = jax.lax.dynamic_index_in_dim(Ah, k, axis=1,
                                              keepdims=True)  # (p,1,2m)
        prow_l = jax.lax.dynamic_index_in_dim(Al, k, axis=1,
                                              keepdims=True)
        pe_h = jax.lax.dynamic_index_in_dim(prow_h, k, axis=2,
                                            keepdims=True)    # (p,1,1)
        pe_l = jax.lax.dynamic_index_in_dim(prow_l, k, axis=2,
                                            keepdims=True)

        # log|det| += log|pivot|: the DS pivot is accurate to ~2^-48;
        # log(|hi|) + lo/hi carries that into the log to f32 rounding
        lp = jnp.log(jnp.abs(pe_h[:, 0, 0])) + pe_l[:, 0, 0] / pe_h[:, 0, 0]
        ld_h, ld_l = ds_add(ld_h, ld_l, lp, jnp.zeros_like(lp))
        sign = sign * jnp.sign(pe_h[:, 0, 0])

        # -- normalize the pivot row ----------------------------------
        nrow_h, nrow_l = ds_div(prow_h, prow_l, pe_h, pe_l)   # (p,1,2m)

        # -- eliminate every other row --------------------------------
        f_h = jax.lax.dynamic_index_in_dim(Ah, k, axis=2,
                                           keepdims=True)     # (p,m,1)
        f_l = jax.lax.dynamic_index_in_dim(Al, k, axis=2,
                                           keepdims=True)
        mh, ml = ds_mul(f_h, f_l, nrow_h, nrow_l)             # (p,m,2m)
        eh, el = ds_add(Ah, Al, -mh, -ml)
        is_k = (rows == k)[None, :, None]
        Ah = jnp.where(is_k, nrow_h, eh)
        Al = jnp.where(is_k, nrow_l, el)
        return Ah, Al, sign, ld_h, ld_l

    sign0 = jnp.ones((p,), dtype)
    zros = jnp.zeros((p,), dtype)
    Ah, Al, sign, ld_h, ld_l = jax.lax.fori_loop(
        0, m, step, (Ah, Al, sign0, zros, zros)
    )
    inv = Ah[:, :, m:] + Al[:, :, m:]
    return inv, ld_h + ld_l, sign


def ds_inv_logdet_ref(A):
    """f64 reference for tests (CPU only)."""
    A64 = np.asarray(A, dtype=np.float64)
    inv = np.linalg.inv(A64)
    sign, ld = np.linalg.slogdet(A64)
    return inv, ld, sign
