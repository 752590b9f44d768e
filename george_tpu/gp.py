# -*- coding: utf-8 -*-
"""The user-facing GP object.

API-compatible re-implementation of the reference ``GP``
(``src/george/gp.py:23-731``) over the JAX stack:

* the covariance is a compiled JAX pair function (``kernels/base.py``);
* solvers factorize on-device inside fused jitted functions;
* ``grad_log_likelihood`` is ``jax.grad`` of the whole marginal likelihood
  (one autodiff sweep), replacing the reference's Regime-A machinery
  (``gp.py:440-504``: explicit ``K^{-1}``, per-parameter ``dK/dtheta``
  tensors, einsum contractions); matrix-free solvers instead provide
  Hutchinson-estimated gradients (reference Regime B, ``gp.py:506-562``).

API notes vs the GPTune fork: ``compute(x, yerr)`` restores the vanilla
argument order (the fork's ``compute(x, nns, yerr)`` broke its own tests —
SURVEY.md §4); neighbor structures are the optional keyword ``nns``.
"""

import warnings

import numpy as np

import jax
import jax.numpy as jnp

from . import kernels
from .modeling import ModelSet, ConstantModel, Model, CallableModel
from .solvers import TrivialSolver, BasicSolver
from .solvers.linalg import assemble_dense, mahalanobis_loglike
from .utils import multivariate_gaussian_samples

__all__ = ["GP", "TINY"]

# Tiny diagonal jitter (as the default white-noise level) keeping K positive
# definite in the absence of observational uncertainties (reference
# ``gp.py:20``).
TINY = 1.25e-12


def _parse_model(model):
    try:
        val = float(model)
    except TypeError:
        if callable(model) and not isinstance(model, Model):
            return CallableModel(model)
        return model
    return ConstantModel(val)


class GP(ModelSet):
    """A Gaussian process with a mean model, white-noise model and kernel.

    :param kernel: a :class:`kernels.Kernel`; ``None`` means an
        :class:`EmptyKernel` served by the :class:`TrivialSolver`.
    :param fit_kernel: include kernel parameters in the fitted vector.
    :param mean: scalar, callable, or modeling-protocol object for the mean.
    :param fit_mean: include mean parameters in the fitted vector.
    :param white_noise: scalar, callable, or model for the *log* white-noise
        variance added to the diagonal.
    :param fit_white_noise: include white-noise parameters in the fit.
    :param solver: solver class (default: :class:`BasicSolver`, or
        :class:`TrivialSolver` when there is no kernel).
    :param kwargs: forwarded to the solver constructor.
    """

    def __init__(
        self,
        kernel=None,
        fit_kernel=True,
        mean=None,
        fit_mean=None,
        white_noise=None,
        fit_white_noise=None,
        solver=None,
        **kwargs
    ):
        self._computed = False
        self._alpha = None
        self._y = None
        self._fused = None

        super(GP, self).__init__(
            [
                (
                    "mean",
                    ConstantModel(0.0) if mean is None else _parse_model(mean),
                ),
                (
                    "white_noise",
                    ConstantModel(np.log(TINY))
                    if white_noise is None
                    else _parse_model(white_noise),
                ),
                (
                    "kernel",
                    kernels.EmptyKernel() if kernel is None else kernel,
                ),
            ]
        )

        # Constants default to not-fitted (reference ``gp.py:99-116``).
        try:
            float(mean)
        except TypeError:
            pass
        else:
            fit_mean = False if fit_mean is None else fit_mean
        try:
            float(white_noise)
        except TypeError:
            pass
        else:
            fit_white_noise = (
                False if fit_white_noise is None else fit_white_noise
            )

        if not fit_kernel:
            self.models["kernel"].freeze_all_parameters()
        if mean is None or (fit_mean is not None and not fit_mean):
            self.models["mean"].freeze_all_parameters()
        if white_noise is None or (
            fit_white_noise is not None and not fit_white_noise
        ):
            self.models["white_noise"].freeze_all_parameters()

        if solver is None:
            trivial = (
                kernel is None
                or kernel.kernel_type == kernels.EmptyKernel.kernel_type
            )
            solver = TrivialSolver if trivial else BasicSolver
        self.solver_type = solver
        self.solver_kwargs = kwargs
        self.solver = None

    # ------------------------------------------------------------------
    # Sub-model access
    # ------------------------------------------------------------------

    @property
    def mean(self):
        return self.models["mean"]

    @property
    def white_noise(self):
        return self.models["white_noise"]

    @property
    def kernel(self):
        return self.models["kernel"]

    def _call_mean(self, x):
        if x.ndim == 2 and x.shape[1] == 1:
            mu = np.asarray(self.mean.get_value(x[:, 0])).flatten()
        else:
            mu = np.asarray(self.mean.get_value(x)).flatten()
        if not np.all(np.isfinite(mu)):
            raise ValueError("mean function returned NaN or Inf")
        return mu

    def _call_mean_gradient(self, x):
        if x.ndim == 2 and x.shape[1] == 1:
            mu = self.mean.get_gradient(x[:, 0])
        else:
            mu = self.mean.get_gradient(x)
        if np.any(~np.isfinite(mu)):
            raise ValueError("mean gradient returned NaN or Inf")
        return mu

    def _call_white_noise(self, x):
        if x.ndim == 2 and x.shape[1] == 1:
            return np.asarray(self.white_noise.get_value(x[:, 0])).flatten()
        return np.asarray(self.white_noise.get_value(x)).flatten()

    def _call_white_noise_gradient(self, x):
        if x.ndim == 2 and x.shape[1] == 1:
            return self.white_noise.get_gradient(x[:, 0])
        return self.white_noise.get_gradient(x)

    # ------------------------------------------------------------------
    # Computation state
    # ------------------------------------------------------------------

    @property
    def computed(self):
        return (
            self._computed
            and self.solver is not None
            and self.solver.computed
            and not self.kernel.dirty
        )

    @computed.setter
    def computed(self, v):
        self._computed = v
        if v:
            self.kernel.dirty = False

    def parse_samples(self, t):
        """Coerce input coordinates to ``(n, ndim)`` float64."""
        t = np.atleast_1d(np.asarray(t, dtype=np.float64))
        if t.ndim == 1:
            t = t[:, None]
        if t.ndim != 2 or (
            t.shape[1] != self.kernel.input_ndim
            and self.kernel.kernel_type != 13
        ):
            raise ValueError("Dimension mismatch")
        return np.ascontiguousarray(t, dtype=np.float64)

    def _check_dimensions(self, y, check_dim=True):
        n, _ = self._x.shape
        y = np.atleast_1d(y)
        if check_dim and y.ndim > 1:
            raise ValueError("The predicted dimension must be 1-D")
        if len(y) != n:
            raise ValueError("Dimension mismatch")
        return y

    def compute(self, x, yerr=0.0, nns=None, **kwargs):
        """Assemble and factorize ``K(x, x) + diag(yerr^2 + exp(wn))``."""
        self._x = self.parse_samples(x)
        from .neighbors import normalize_nns
        self._nns = normalize_nns(nns)
        try:
            self._yerr2 = float(yerr) ** 2 * np.ones(len(x))
        except TypeError:
            self._yerr2 = self._check_dimensions(yerr) ** 2
        self._yerr2 = np.ascontiguousarray(self._yerr2, dtype=np.float64)

        self.solver = self.solver_type(self.kernel, **self.solver_kwargs)
        yerr_eff = np.sqrt(
            self._yerr2 + np.exp(self._call_white_noise(self._x))
        )
        self.solver.compute(self._x, yerr_eff, nns=self._nns, **kwargs)

        self._const = -0.5 * (
            len(self._x) * np.log(2 * np.pi) + self.solver.log_determinant
        )
        self.computed = True
        self._alpha = None
        self._fused = None  # solver identity is baked into the fused fns

    def recompute(self, quiet=False, **kwargs):
        """Refactorize iff the parameters changed since :func:`compute`."""
        if not self.computed:
            if not (hasattr(self, "_x") and hasattr(self, "_yerr2")):
                raise RuntimeError("You need to compute the model first")
            try:
                self.compute(
                    self._x, np.sqrt(self._yerr2), nns=self._nns, **kwargs
                )
            except (ValueError, np.linalg.LinAlgError):
                if quiet:
                    return False
                raise
        return True

    # ------------------------------------------------------------------
    # Likelihood
    # ------------------------------------------------------------------

    def lnlikelihood(self, y, quiet=False):
        warnings.warn(
            "'lnlikelihood' is deprecated. Use 'log_likelihood'",
            DeprecationWarning,
        )
        return self.log_likelihood(y, quiet=quiet)

    def grad_lnlikelihood(self, y, quiet=False):
        warnings.warn(
            "'grad_lnlikelihood' is deprecated. Use 'grad_log_likelihood'",
            DeprecationWarning,
        )
        return self.grad_log_likelihood(y, quiet=quiet)

    def log_likelihood(self, y, quiet=False):
        """Marginal log-likelihood of ``y`` under the GP (requires
        :func:`compute`)."""
        if not self.recompute(quiet=quiet):
            return -np.inf
        try:
            mu = self._call_mean(self._x)
        except ValueError:
            if quiet:
                return -np.inf
            raise
        r = np.ascontiguousarray(
            self._check_dimensions(y) - mu, dtype=np.float64
        )
        ll = self._const - 0.5 * self.solver.dot_solve(r)
        return ll if np.isfinite(ll) else -np.inf

    def grad_log_likelihood(self, y, quiet=False):
        """Gradient of :func:`log_likelihood` w.r.t. the active parameters.

        Exact solvers: a single reverse-mode sweep through the fused
        (assemble -> factor -> solve -> logdet) computation. Matrix-free
        solvers (HODLR with ``compute_grad``, sparse): the solver's
        Hutchinson-estimated gradient (reference Regime B).
        """
        if not self.recompute(quiet=quiet):
            return np.zeros(len(self), dtype=np.float64)

        if getattr(self.solver, "matrix_free", False):
            return self._grad_log_likelihood_matrix_free(y, quiet=quiet)

        if self._traceable:
            try:
                vag = self._fused_value_and_grad()
                _, g = vag(
                    jnp.asarray(self.parameter_vector),
                    jnp.asarray(self._x),
                    jnp.asarray(
                        np.ascontiguousarray(
                            self._check_dimensions(y), dtype=np.float64
                        )
                    ),
                    jnp.asarray(self._yerr2),
                )
                g = np.asarray(g)[self.unfrozen_mask]
                if not np.all(np.isfinite(g)):
                    raise ValueError("non-finite gradient")
                return g
            except ValueError:
                if quiet:
                    return np.zeros(len(self), dtype=np.float64)
                raise
        return self._grad_log_likelihood_host(y, quiet=quiet)

    @property
    def _traceable(self):
        return self.mean.traceable and self.white_noise.traceable

    def _fused_loglike_full(self):
        """Pure ``loglike(theta_full, x, y, yerr2)``.

        If the computed solver exposes a fused factorization program
        (``loglike_fn``; e.g. the hierarchical solver), the likelihood and
        its ``jax.grad`` flow through *that* factorization — so gradients at
        scale cost one reverse sweep of the O(N log^2 N) path instead of any
        dense O(N^3) work. Otherwise the dense closed form is used.
        """
        mean = self.mean
        wn = self.white_noise
        pair = self.kernel.pair_fn
        n_m = mean.full_size
        n_w = wn.full_size

        sfn = None
        if (
            self.solver is not None
            and self.solver.computed
            and hasattr(self.solver, "loglike_fn")
        ):
            sfn = self.solver.loglike_fn()

        def loglike(theta, x, y, yerr2):
            mu = mean.value_fn(theta[:n_m], x)
            wnv = wn.value_fn(theta[n_m : n_m + n_w], x)
            diag = yerr2 + jnp.exp(wnv)
            if sfn is not None:
                return sfn(theta[n_m + n_w :], diag, y - mu)
            K = assemble_dense(pair, theta[n_m + n_w :], x, x)
            K = K + jnp.diag(diag)
            L = jnp.linalg.cholesky(K)
            return mahalanobis_loglike(L, y - mu)

        return loglike

    def log_prob_fn(self, x, y, yerr=0.0, gate_prior=True, log_prior=None):
        """A pure jax-traceable ``f(theta_active) -> log-posterior``.

        The returned closure evaluates the fused (assemble -> factor ->
        solve -> logdet) marginal likelihood at an *active* (unfrozen)
        parameter vector, holding data constant. Uniform-prior bounds gate
        the result to ``-inf`` outside the box (the reference's
        ``log_prior`` pattern, ``modeling.py:331``); non-finite likelihoods
        also map to ``-inf`` so samplers reject instead of propagating NaN.

        ``log_prior`` may be a traceable callable ``theta_active ->
        scalar`` added to the likelihood. Gradient-based samplers want a
        *smooth* prior here rather than the hard ``gate_prior`` box: a GP
        marginal likelihood typically plateaus as amplitudes/scales run
        off to infinity (the data-free noise-only model), so without a
        proper prior the posterior is improper — chains drift along the
        plateau, every NUTS trajectory runs to max depth, and step-size
        adaptation collapses. (The reference's MCMC tutorial composes the
        prior into ``lnprob`` the same way, ``docs/tutorials/hyper.rst``.)

        This is the sampler-facing surface: ``vmap`` it over walkers/chains,
        shard the batch axis over a mesh, and the per-step cost is one
        batched factorization (replacing the reference's per-walker host
        refactorization loop, ``docs/tutorials/hyper.rst:205-245``).
        """
        if not self._traceable:
            raise ValueError(
                "log_prob_fn requires traceable mean/white-noise models"
            )
        x = self.parse_samples(x)
        if (
            self.solver is not None
            and self.solver.computed
            and hasattr(self.solver, "loglike_fn")
            and not np.array_equal(np.asarray(x), np.asarray(self._x))
        ):
            # The fused solver path evaluates the covariance on the points
            # cached by compute() (sorted/padded inside the solver); a
            # different x here would silently score the wrong dataset.
            raise ValueError(
                "log_prob_fn: x must match the computed inputs when the "
                "solver provides a fused likelihood (call gp.compute(x, "
                "...) with these points first)"
            )
        x = jnp.asarray(x)
        y = jnp.asarray(
            np.ascontiguousarray(np.atleast_1d(y), dtype=np.float64)
        )
        try:
            yerr2 = float(yerr) ** 2 * jnp.ones(y.shape[0])
        except TypeError:
            yerr2 = jnp.asarray(np.asarray(yerr, dtype=np.float64)) ** 2

        loglike = self._fused_loglike_full()
        base = jnp.asarray(self.parameter_vector)
        mask = self.unfrozen_mask
        (active_idx,) = np.nonzero(mask)
        active_idx = jnp.asarray(active_idx)

        bounds = self.get_parameter_bounds()
        lo = jnp.asarray(
            [-np.inf if b[0] is None else float(b[0]) for b in bounds]
        )
        hi = jnp.asarray(
            [np.inf if b[1] is None else float(b[1]) for b in bounds]
        )

        def log_prob(theta_active):
            theta = base.at[active_idx].set(theta_active)
            ll = loglike(theta, x, y, yerr2)
            ll = jnp.where(jnp.isfinite(ll), ll, -jnp.inf)
            if log_prior is not None:
                ll = ll + log_prior(theta_active)
                ll = jnp.where(jnp.isfinite(ll), ll, -jnp.inf)
            if gate_prior:
                inside = jnp.all(
                    (theta_active >= lo) & (theta_active <= hi)
                )
                ll = jnp.where(inside, ll, -jnp.inf)
            return ll

        return log_prob

    def check_fused_thetas(self, thetas, y, yerr=0.0, max_evals=16,
                           tol=None, warn=True):
        """Post-hoc factorization health check over sampler-visited thetas.

        The fused ``log_prob_fn`` closure is pure/jittable by design, so
        the per-compute factorization self-check never sees the thetas a
        sampler proposes — a chain walking a Linear/Polynomial-component
        amplitude into the non-decaying regime (where the hierarchical
        SMW cores go singular; the reference's identical cascade fails
        the same way and stays silent, ``hodlr.h:707-711``) would get
        silently corrupted log-probabilities. Run THIS after sampling:
        it evaluates the relative solve residual ``|K z - r| / |r|`` of
        the fused factorization at the per-dimension extreme thetas plus
        an even subsample of the chain (instability lives at the
        extremes of a regime walk), and warns when any exceeds ``tol``.

        Parameters mirror :func:`log_prob_fn`: ``thetas`` are ACTIVE
        parameter vectors, shape ``(..., ndim)`` (chains/samples leading
        dims are flattened); ``y``/``yerr`` are the computed dataset.
        Returns ``{"thetas", "residuals", "max", "ok"}``; ``None`` when
        the computed solver has no fused residual monitor (dense and
        CG-based solvers control their residual by construction).
        """
        if not (
            self.solver is not None
            and self.solver.computed
            and hasattr(self.solver, "residual_fn")
        ):
            return None
        x = jnp.asarray(self.parse_samples(self._x))
        y = jnp.asarray(
            np.ascontiguousarray(np.atleast_1d(y), dtype=np.float64)
        )
        try:
            yerr2 = float(yerr) ** 2 * jnp.ones(y.shape[0])
        except TypeError:
            yerr2 = jnp.asarray(np.asarray(yerr, dtype=np.float64)) ** 2

        mean, wn = self.mean, self.white_noise
        n_m, n_w = mean.full_size, wn.full_size
        rfn = self.solver.residual_fn()
        base = jnp.asarray(self.parameter_vector)
        mask = self.unfrozen_mask
        (active_idx,) = np.nonzero(mask)
        active_idx = jnp.asarray(active_idx)

        @jax.jit
        def residual(theta_active):
            theta = base.at[active_idx].set(theta_active)
            mu = mean.value_fn(theta[:n_m], x)
            wnv = wn.value_fn(theta[n_m:n_m + n_w], x)
            return rfn(theta[n_m + n_w:], yerr2 + jnp.exp(wnv), y - mu)

        th = np.asarray(thetas, dtype=np.float64)
        th = th.reshape(-1, th.shape[-1])
        th = th[np.all(np.isfinite(th), axis=1)]
        if th.shape[0] == 0:
            return {"thetas": th, "residuals": np.empty(0),
                    "max": 0.0, "ok": True}
        # per-dimension extremes + an even subsample, deduplicated
        idx = set()
        for d in range(th.shape[1]):
            idx.add(int(np.argmin(th[:, d])))
            idx.add(int(np.argmax(th[:, d])))
        for i in np.linspace(0, th.shape[0] - 1,
                             max(max_evals - len(idx), 2)).astype(int):
            idx.add(int(i))
        idx = sorted(idx)[:max(max_evals, 2 * th.shape[1])]
        picked = th[idx]
        res = np.array([float(residual(t)) for t in picked])
        if tol is None:
            f64 = np.asarray(x).dtype == np.float64 and jax.config.jax_enable_x64
            tol = 1e-6 if f64 else 1e-2
        bad = ~(res < tol)  # NaN residuals count as failures
        out = {"thetas": picked, "residuals": res,
               "max": float(np.nanmax(res)) if np.isfinite(res).any()
               else float("inf"),
               "ok": not bool(bad.any())}
        if warn and bad.any():
            worst = int(np.nanargmax(np.where(np.isfinite(res), res,
                                              np.inf)))
            warnings.warn(
                "fused-path factorization residual check failed at %d of "
                "%d sampled thetas (worst |Kz-r|/|r| = %.2e at theta=%s, "
                "tol %.0e): the chain visited a regime where the "
                "hierarchical factorization is unstable (typically a "
                "non-decaying kernel component growing dominant) — "
                "log-probabilities there are unreliable. Restrict the "
                "prior, or use BasicSolver at these scales."
                % (int(bad.sum()), len(res), out["max"],
                   np.array2string(picked[worst], precision=3), tol),
                stacklevel=2,
            )
        return out

    def _fused_value_and_grad(self):
        if self._fused is None:
            self._fused = {}
        if "vag" not in self._fused:
            self._fused["vag"] = jax.jit(
                jax.value_and_grad(self._fused_loglike_full())
            )
        return self._fused["vag"]

    def _grad_log_likelihood_host(self, y, quiet=False):
        """Gradient for host-side (non-traceable) mean or white-noise
        models, from the classic identity

            d ll / d theta = 1/2 tr[(a a^T - K^{-1}) dK/dtheta] ,
                  a = K^{-1} (y - mu),

        assembled on the host because the component models cannot be traced
        (same regime as reference ``gp.py:440-504``, derived independently
        here from the marginal-likelihood identity above)."""
        try:
            alpha = self._compute_alpha(y, False)
        except ValueError:
            if quiet:
                return np.zeros(len(self), dtype=np.float64)
            raise

        # the "information matrix" of the identity; every block below is a
        # contraction of a parameter-Jacobian against it
        info = np.outer(alpha, alpha) - self.solver.get_inverse()

        pieces = []
        if len(self.mean):
            # d ll / d mean-params = (d mu / d p) @ a
            pieces.append(self._call_mean_gradient(self._x) @ alpha)
        if len(self.white_noise):
            # dK/dp is diagonal: exp(wn) * d wn / d p on the diagonal
            scale = np.exp(self._call_white_noise(self._x)) * np.diag(info)
            jac = self._call_white_noise_gradient(self._x)
            pieces.append(0.5 * jac @ scale)
        if len(self.kernel):
            dK = self.kernel.get_gradient(self._x)  # (n, n, n_params)
            pieces.append(
                0.5 * np.tensordot(dK, info, axes=[(0, 1), (0, 1)])
            )
        return np.concatenate(pieces) if pieces else np.empty(0)

    def _grad_log_likelihood_matrix_free(self, y, quiet=False):
        """Hutchinson trace-estimated gradient through a matrix-free solver
        (reference ``gp.py:506-562``)."""
        try:
            alpha = self._compute_alpha(y, False)
        except ValueError:
            if quiet:
                return np.zeros(len(self), dtype=np.float64)
            raise
        g = self.solver.grad_log_likelihood(
            self, self._x, alpha, self.unfrozen_mask
        )
        if getattr(self.solver, "debug", False):
            self._debug_gradient_check(y, g)
        return g

    def _debug_gradient_check(self, y, g_est):
        """Under ``debug=1``, mirror the reference's GP-layer debug
        prints (reference ``gp.py:556-562``): the dense-exact gradient
        next to the matrix-free estimate, so compression/Monte-Carlo
        error in the estimated gradient is visible. O(n^2) memory —
        debug is a small/medium-n tool (the reference's version
        materializes the same dense matrices)."""
        n = len(self._x)
        self.debug_gradient = None
        if n > 20000:
            warnings.warn(
                "debug gradient comparison skipped at n=%d (it "
                "materializes dense O(n^2) matrices)" % n
            )
            return None
        K = np.asarray(
            self.kernel.get_value(self._x), dtype=np.float64
        ).copy()
        K[np.diag_indices_from(K)] += self._yerr2 + np.exp(
            self._call_white_noise(self._x)
        )
        import scipy.linalg as sla

        cf = sla.cho_factor(K, lower=True)
        r = np.ascontiguousarray(
            self._check_dimensions(y) - self._call_mean(self._x),
            dtype=np.float64,
        )
        alpha = sla.cho_solve(cf, r)
        info = np.outer(alpha, alpha) - sla.cho_solve(cf, np.eye(n))
        pieces = []
        if len(self.mean):
            pieces.append(self._call_mean_gradient(self._x) @ alpha)
        if len(self.white_noise):
            scale = np.exp(self._call_white_noise(self._x)) * np.diag(info)
            pieces.append(
                0.5 * self._call_white_noise_gradient(self._x) @ scale
            )
        if len(self.kernel):
            dK = self.kernel.get_gradient(self._x)
            pieces.append(
                0.5 * np.tensordot(dK, info, axes=[(0, 1), (0, 1)])
            )
        # pieces are already active-sized (len(model) counts unfrozen
        # params), exactly as in _grad_log_likelihood_host
        g_exact = np.concatenate(pieces) if pieces else np.empty(0)
        g_est = np.asarray(g_est, dtype=np.float64)
        rep = {
            "exact": g_exact,
            "estimated": g_est,
            "max_abs_delta": float(np.max(np.abs(g_exact - g_est)))
            if g_exact.size else 0.0,
        }
        self.debug_gradient = rep
        if getattr(self.solver, "verbose", False):
            # the reference's two prints (gp.py:560-562)
            print(g_exact, "grad_exact")
            print(g_est, "grad_estimated")
        return rep

    def nll(self, vector, y, quiet=True):
        """Negative log-likelihood at ``vector`` (optimizer objective)."""
        self.set_parameter_vector(vector)
        if not np.isfinite(self.log_prior()):
            return np.inf
        return -self.log_likelihood(y, quiet=quiet)

    def grad_nll(self, vector, y, quiet=True):
        self.set_parameter_vector(vector)
        if not np.isfinite(self.log_prior()):
            return np.zeros(len(vector))
        return -self.grad_log_likelihood(y, quiet=quiet)

    # ------------------------------------------------------------------
    # alpha / inverse applications
    # ------------------------------------------------------------------

    def _compute_alpha(self, y, cache):
        if not cache:
            r = np.ascontiguousarray(
                self._check_dimensions(y) - self._call_mean(self._x),
                dtype=np.float64,
            )
            return self.solver.apply_inverse(r, in_place=True).flatten()
        if self._alpha is None or not np.array_equiv(y, self._y):
            self._y = y
            r = np.ascontiguousarray(
                self._check_dimensions(y) - self._call_mean(self._x),
                dtype=np.float64,
            )
            self._alpha = self.solver.apply_inverse(
                r, in_place=True
            ).flatten()
        return self._alpha

    def apply_inverse(self, y):
        """``(K + diag)^{-1} (y - mu)`` for vectors or matrices of samples."""
        self.recompute(quiet=False)
        r = np.array(y, dtype=np.float64, order="F")
        r = self._check_dimensions(r, check_dim=False)
        m = [slice(None)] + [np.newaxis for _ in range(r.ndim - 1)]
        r -= self._call_mean(self._x)[tuple(m)]
        if r.ndim == 1:
            return self.solver.apply_inverse(r, in_place=True).flatten()
        return self.solver.apply_inverse(r, in_place=True)

    # ------------------------------------------------------------------
    # Prediction and sampling
    # ------------------------------------------------------------------

    def predict(
        self,
        y,
        t,
        return_cov=True,
        return_var=False,
        cache=True,
        kernel=None,
    ):
        """Posterior predictive distribution at coordinates ``t``.

        Returns ``mu``, ``(mu, cov)`` or ``(mu, var)`` depending on
        ``return_cov`` / ``return_var``. A ``kernel`` override computes the
        cross-covariance with a different kernel (mixture-of-GPs separation,
        reference ``gp.py:624-628``).
        """
        self.recompute()
        alpha = self._compute_alpha(y, cache)
        xs = self.parse_samples(t)

        if kernel is None:
            kernel = self.kernel

        Kxs = kernel.get_value(xs, self._x)
        mu = np.dot(Kxs, alpha) + self._call_mean(xs)
        if not (return_var or return_cov):
            return mu

        KinvKxs = self.solver.apply_inverse(Kxs.T)
        if return_var:
            var = np.array(kernel.get_value(xs, diag=True))
            var -= np.sum(Kxs.T * KinvKxs, axis=0)
            return mu, var

        cov = np.array(kernel.get_value(xs))
        cov -= np.dot(Kxs, KinvKxs)
        return mu, cov

    def sample_conditional(self, y, t, size=1):
        """Samples from the predictive conditional distribution."""
        mu, cov = self.predict(y, t)
        return multivariate_gaussian_samples(cov, size, mean=mu)

    def sample(self, t=None, size=1):
        """Samples from the prior distribution (at ``t``, or at the
        precomputed coordinates using the stored factorization)."""
        if t is None:
            self.recompute()
            n, _ = self._x.shape
            results = np.array(self.solver.apply_sqrt(np.random.randn(size, n)))
            results += self._call_mean(self._x)
            return results[0] if size == 1 else results

        x = self.parse_samples(t)
        cov = self.get_matrix(x)
        cov[np.diag_indices_from(cov)] += TINY
        return multivariate_gaussian_samples(
            cov, size, mean=self._call_mean(x)
        )

    def get_matrix(self, x1, x2=None):
        """The covariance matrix at coordinates ``x1`` (cross-covariance
        against ``x2`` if given)."""
        x1 = self.parse_samples(x1)
        if x2 is None:
            return self.kernel.get_value(x1)
        x2 = self.parse_samples(x2)
        return self.kernel.get_value(x1, x2)

    # Modeling-protocol synonyms (reference ``gp.py:713-731``).
    def get_value(self, *args, **kwargs):
        return self.log_likelihood(*args, **kwargs)

    def get_gradient(self, *args, **kwargs):
        return self.grad_log_likelihood(*args, **kwargs)

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_fused"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
