# -*- coding: utf-8 -*-
"""Driver contract: bench.py prints exactly one valid JSON line and the
graft entry points stay importable."""

import io
import json
import runpy
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest


def test_bench_emits_json_line():
    import jax

    argv = sys.argv
    buf = io.StringIO()
    try:
        sys.argv = ["bench.py", "2000"]
        with redirect_stdout(buf):
            runpy.run_path("bench.py", run_name="__main__")
    finally:
        sys.argv = argv
    lines = [l for l in buf.getvalue().splitlines() if l.strip()]
    assert len(lines) == 1
    record = json.loads(lines[0])
    # required driver contract keys, plus whatever provenance fields
    # the bench adds (precision tier, per-repeat spread, anchor error)
    assert {"metric", "value", "unit", "vs_baseline"} <= set(record)
    assert record["value"] > 0
    assert record["unit"] == "evals/s"
    assert all(t > 0 for t in record["spread_s_per_eval"])
    # every record names the device it ran on
    assert record["platform"] == jax.devices()[0].platform
    assert record["device_kind"] == jax.devices()[0].device_kind
    assert record["device_count"] == len(jax.devices())


@pytest.mark.parametrize("n,dtype", [(1200, np.float32), (2400, np.float64)])
def test_build_scopes_f64_from_threshold(n, dtype, monkeypatch):
    """In an f32 process a cell at or above ``F64_FROM_N`` builds and runs
    in scoped float64 (and leaves the process f32); below it runs f32.
    Either way its log-likelihood matches a dense host-f64 one."""
    import jax

    import bench
    import chip_smoke

    monkeypatch.setattr(bench, "F64_FROM_N", 2000)
    with jax.enable_x64(False):
        cell = bench.build("smooth", n)
        ll, grad = cell.vag(cell.theta + 1e-5)
        assert not jax.config.jax_enable_x64
    assert cell.dtype == dtype and cell.theta.dtype == dtype
    assert np.asarray(ll).dtype == dtype and np.all(np.isfinite(grad))
    err, tol = chip_smoke._bench_reference("smooth", n, ll)
    assert err <= tol


def test_graft_entry_contract():
    import __graft_entry__ as g

    fn, args = g.entry()
    assert callable(fn)
    assert isinstance(args, tuple)
    assert callable(g.dryrun_multichip)
