# -*- coding: utf-8 -*-
"""Structured timing and profiling.

The reference's observability is printf-in-hot-path (`std::chrono` prints
around the HODLR build, ``_hodlr.cpp:130-141``; ``time.time()`` spans in
solver assembly, ``basic.py:84-134``; per-call likelihood prints,
``gp.py:400``). Here the equivalents are structured and zero-cost when
off:

* :class:`timer` — a context manager accumulating named wall-clock spans
  into a global registry (device-synchronized when a result is given);
* :func:`report` — the collected spans;
* :func:`trace` — a ``jax.profiler`` trace context for device timelines;
* solver ``verbose=True`` flags route through :func:`log_span` instead of
  bare prints.
"""

import contextlib
import time

import jax

__all__ = ["timer", "report", "reset", "trace", "log_span", "annotate"]

_REGISTRY = {}


class timer(object):
    """``with timer("hodlr.factor", result):`` — accumulate a named span.

    If ``sync`` is given (an array or pytree), it is block-until-ready'd
    before the clock stops, so device work is included.
    """

    def __init__(self, name, verbose=False):
        self.name = name
        self.verbose = verbose
        self._sync = None

    def sync(self, value):
        """Mark a value to synchronize on at exit; returns it unchanged."""
        self._sync = value
        return value

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            jax.block_until_ready(self._sync)
        dt = time.perf_counter() - self._t0
        count, total, best = _REGISTRY.get(self.name, (0, 0.0, float("inf")))
        _REGISTRY[self.name] = (count + 1, total + dt, min(best, dt))
        if self.verbose:
            log_span(self.name, dt)
        return False


def log_span(name, seconds):
    print("[george-tpu] {0}: {1:.4f} s".format(name, seconds), flush=True)


def report():
    """``{name: {"count", "total_s", "mean_s", "best_s"}}`` for all spans."""
    return {
        name: {
            "count": c,
            "total_s": t,
            "mean_s": t / c if c else 0.0,
            "best_s": b,
        }
        for name, (c, t, b) in _REGISTRY.items()
    }


def reset():
    _REGISTRY.clear()


@contextlib.contextmanager
def trace(log_dir="/tmp/george_tpu_trace"):
    """``jax.profiler`` trace context — open the result in XProf/TensorBoard
    to see the on-device timeline (the structured replacement for the
    reference's wall-clock printf instrumentation)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name):
    """Named region inside traced code (shows up in profiler timelines)."""
    return jax.profiler.TraceAnnotation(name)
