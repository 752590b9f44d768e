# -*- coding: utf-8 -*-
"""Affine-invariant ensemble MCMC (Goodman & Weare stretch moves).

The reference's documented inference pattern is ``emcee.EnsembleSampler``
driven by ``gp.lnlikelihood`` (``docs/tutorials/hyper.rst:205-245``): 36
walkers, each step re-assembling and re-factorizing K once per walker on the
host. Here the whole ensemble update is one fused jitted function — every
walker's (assemble -> factor -> solve -> logdet) likelihood runs batched on
device via ``vmap``, and the red/black half-ensemble update is a
``lax.scan`` — so a step costs two batched likelihood evaluations regardless
of the walker count. The walker axis is the natural sharding axis: jit the
step with a ``NamedSharding`` over a ``('chains',)`` mesh and XLA inserts the
(tiny) collectives for the cross-half proposals.

All functions are pure; :class:`EnsembleSampler` is a light stateful wrapper
mirroring the emcee driver API used by the reference docs.
"""

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["stretch_move_half", "ensemble_step", "run_ensemble",
           "EnsembleSampler"]


def stretch_move_half(key, active, active_logp, other, log_prob_fn, a=2.0):
    """One stretch-move update of ``active`` walkers against ``other``.

    ``active``: ``(k, ndim)`` walkers to move; ``other``: ``(m, ndim)``
    complementary ensemble. Returns updated ``(walkers, logp, accepted)``.
    """
    k, ndim = active.shape
    key_z, key_pick, key_acc = jax.random.split(key, 3)
    # z ~ g(z) \propto 1/sqrt(z) on [1/a, a]
    u = jax.random.uniform(key_z, (k,))
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    idx = jax.random.randint(key_pick, (k,), 0, other.shape[0])
    # Partner lookup as a one-hot contraction instead of a dynamic
    # gather: with both halves row-sharded over the ('chains',) mesh, a
    # gather with random cross-shard indices forces GSPMD into
    # involuntary full rematerialization; the contraction lowers to one
    # clean all-gather of the (tiny) complementary half. Values are
    # bit-identical to the gather (one-hot rows select exactly).
    onehot = (
        idx[:, None] == jnp.arange(other.shape[0])[None, :]
    ).astype(other.dtype)
    partners = onehot @ other
    proposal = partners + z[:, None] * (active - partners)
    new_logp = log_prob_fn(proposal)
    log_ratio = (ndim - 1.0) * jnp.log(z) + new_logp - active_logp
    accept = jnp.log(jax.random.uniform(key_acc, (k,))) < log_ratio
    walkers = jnp.where(accept[:, None], proposal, active)
    logp = jnp.where(accept, new_logp, active_logp)
    return walkers, logp, accept


def ensemble_step(key, walkers, logp, log_prob_fn, a=2.0):
    """One full red/black ensemble sweep. ``walkers``: ``(nw, ndim)``.

    Returns ``(walkers, logp, accept_fraction)``.
    """
    half = walkers.shape[0] // 2
    (first, second), (lp1, lp2), acc = _ensemble_step_halves(
        key, (walkers[:half], walkers[half:]),
        (logp[:half], logp[half:]), log_prob_fn, a,
    )
    walkers = jnp.concatenate([first, second], axis=0)
    logp = jnp.concatenate([lp1, lp2], axis=0)
    return walkers, logp, acc


def _ensemble_step_halves(key, halves, logps, log_prob_fn, a=2.0):
    """Red/black sweep on pre-split halves. Keeping the halves separate
    through the whole scan (instead of re-splitting a concatenated
    ensemble each step) keeps every per-step array aligned with the
    ('chains',) row sharding — no per-step reshard of the walker axis."""
    (first, second), (lp1, lp2) = halves, logps
    k1, k2 = jax.random.split(key)
    first, lp1, acc1 = stretch_move_half(k1, first, lp1, second,
                                         log_prob_fn, a)
    second, lp2, acc2 = stretch_move_half(k2, second, lp2, first,
                                          log_prob_fn, a)
    acc = 0.5 * (
        acc1.astype(lp1.dtype).mean() + acc2.astype(lp2.dtype).mean()
    )
    return (first, second), (lp1, lp2), acc


@partial(jax.jit, static_argnames=("log_prob_fn", "nsteps", "thin", "a"))
def run_ensemble(key, p0, log_prob_fn, nsteps, thin=1, a=2.0):
    """Run ``nsteps`` ensemble sweeps from ``p0`` ``(nw, ndim)``.

    Returns ``(chain, logps, accept)`` with ``chain`` of shape
    ``(nsteps // thin, nw, ndim)``. The whole run is one compiled
    ``lax.scan`` — zero host round-trips between steps.
    """
    logp0 = log_prob_fn(p0)
    half = p0.shape[0] // 2
    # split once before the scan; the carry stays in half layout so the
    # sharded walker axis is never re-partitioned step to step
    halves0 = (p0[:half], p0[half:])
    logps0 = (logp0[:half], logp0[half:])

    def body(state, key):
        halves, logps = state
        def inner(carry, k):
            h, l, _ = carry
            h, l, acc = _ensemble_step_halves(k, h, l, log_prob_fn, a)
            return (h, l, acc), None
        keys = jax.random.split(key, thin)
        (halves, logps, acc), _ = jax.lax.scan(
            inner, (halves, logps, jnp.zeros((), dtype=logp0.dtype)), keys)
        return (halves, logps), (halves, logps, acc)

    nkept = nsteps // thin
    keys = jax.random.split(key, nkept)
    _, ((c1, c2), (l1, l2), accs) = jax.lax.scan(
        body, (halves0, logps0), keys
    )
    # reassemble the emcee walker order once, outside the step loop
    chain = jnp.concatenate([c1, c2], axis=1)
    logps = jnp.concatenate([l1, l2], axis=1)
    return chain, logps, accs


class EnsembleSampler(object):
    """emcee-style driver over the fused device ensemble update.

    :param nwalkers: number of walkers (even).
    :param ndim: parameter dimension.
    :param log_prob_fn: scalar log-probability ``f(theta)`` (jax-traceable);
        it is ``vmap``-ed over walkers internally.
    :param a: stretch scale (emcee default 2.0).
    """

    def __init__(self, nwalkers, ndim, log_prob_fn, a=2.0, vectorize=True):
        if nwalkers % 2:
            raise ValueError("nwalkers must be even")
        self.nwalkers = int(nwalkers)
        self.ndim = int(ndim)
        self.a = float(a)
        self._batched = log_prob_fn if not vectorize else jax.vmap(log_prob_fn)
        self._chain = None
        self._logps = None
        self._accs = None

    def run_mcmc(self, p0, nsteps, seed=0, thin=1):
        """Run the sampler; returns ``(final_walkers, final_logp)``."""
        p0 = jnp.asarray(np.atleast_2d(p0), dtype=jnp.float64)
        if p0.shape != (self.nwalkers, self.ndim):
            raise ValueError("p0 must have shape (nwalkers, ndim)")
        key = jax.random.PRNGKey(seed)
        chain, logps, accs = run_ensemble(
            key, p0, self._batched, int(nsteps), thin=int(thin), a=self.a)
        self._chain = np.asarray(chain)
        self._logps = np.asarray(logps)
        self._accs = np.asarray(accs)
        return self._chain[-1], self._logps[-1]

    @property
    def chain(self):
        """Samples, shape ``(nwalkers, nsteps, ndim)`` (emcee layout)."""
        return np.swapaxes(self._chain, 0, 1)

    @property
    def flatchain(self):
        return self._chain.reshape(-1, self.ndim)

    @property
    def lnprobability(self):
        return np.swapaxes(self._logps, 0, 1)

    @property
    def acceptance_fraction(self):
        return np.broadcast_to(self._accs.mean(), (self.nwalkers,))
