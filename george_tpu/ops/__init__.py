# -*- coding: utf-8 -*-
"""Numerical building blocks outside the solvers: the double-single
(two-float) SMW core inverse behind ``GEORGE_TPU_CORE_DS`` (``ds.py``).
The leaf Cholesky and the banded matvec are plain XLA
(``jnp.linalg.cholesky`` in ``solvers/hodlr.py``, ``dia_apply`` in
``solvers/sparse.py``)."""
