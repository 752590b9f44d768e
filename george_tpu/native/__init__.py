# -*- coding: utf-8 -*-
"""In-tree native (C++) runtime components.

Where the reference relies on out-of-tree native code (sklearn BallTree,
scipy cKDTree, the MPI solver backends — SURVEY.md §2.2/§2.5), this package
provides first-class C++ equivalents for the parts that belong on the host
(tree queries, orderings); the device compute path is JAX/XLA.

Modules compile lazily with the system toolchain and expose
``available()``; every caller has a pure-Python/scipy fallback, so the
framework works with or without a compiler.
"""

from . import kdtree  # noqa: F401

__all__ = ["kdtree"]
