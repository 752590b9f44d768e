# -*- coding: utf-8 -*-
"""Hyperparameter inference engines (the reference's L7 ecosystem layer,
``docs/tutorials/hyper.rst``, rebuilt as fused device programs).

* :mod:`ensemble` — affine-invariant stretch-move MCMC (emcee semantics),
  fully fused and chain-shardable.
* :mod:`hmc` — gradient-based HMC/NUTS with window adaptation, vmapped
  chains and collective-based cross-chain statistics.
* :mod:`optimize` — L-BFGS style MAP optimization over the fused
  value-and-grad likelihood.
"""

from .ensemble import EnsembleSampler, run_ensemble, ensemble_step  # noqa: F401

__all__ = ["EnsembleSampler", "run_ensemble", "ensemble_step"]

try:
    from .hmc import NUTS, HMC, sample_nuts, sample_hmc  # noqa: F401

    __all__ += ["NUTS", "HMC", "sample_nuts", "sample_hmc"]
except ImportError:  # pragma: no cover
    pass

try:
    from .optimize import minimize, fit_adam  # noqa: F401

    __all__ += ["minimize", "fit_adam"]
except ImportError:  # pragma: no cover
    pass

try:
    from .vi import (ADVI, fit_advi, fit_advi_fullrank,  # noqa: F401
                     advi_sample)

    __all__ += ["ADVI", "fit_advi", "fit_advi_fullrank", "advi_sample"]
except ImportError:  # pragma: no cover
    pass
