# -*- coding: utf-8 -*-
"""``chip_smoke.py`` on the CPU: every phase at a tiny size against its
host-f64 reference, the four-device phase on 4 of the virtual CPU
devices, and the refusal to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


_TINY = {
    "dense": dict(nuts_n=64, chains=4, warmup=3, samples=3, segment=2),
    "hodlr_gp": dict(n=1500, lbfgs_steps=1),
    "bench": dict(cells=(("smooth", 1200), ("qp", 1200))),
    "sparse": dict(n=4000),
    "hmatrix": dict(n=1200),
}


@pytest.mark.parametrize("phase", sorted(_TINY))
def test_phase_tiny(phase, capsys):
    """Each phase passes its own checks at a tiny size and reports one
    JSON record per check, naming its reference error and tolerance."""
    recs = getattr(_smoke(), "phase_" + phase)(**_TINY[phase])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    assert len(lines) == len(recs) >= 1
    for rec in recs:
        errs = [k for k in rec if k.endswith(("_err", "_diff", "_rel"))]
        assert errs, rec
        assert all(np.isfinite(rec[k]) for k in errs)


def test_phase_four_on_virtual_devices(capsys):
    """The mesh phase on 4 of the 8 virtual CPU devices: chain-sharded
    NUTS and the row-sharded hierarchical solver agree with one device."""
    assert len(jax.devices()) >= 4
    nuts, hodlr = _smoke().phase_four(
        n_devices=4, hodlr_n=2048, nuts_n=64, chains=8, warmup=3,
        samples=3,
    )
    assert nuts["devices"] == nuts["draw_shards"] == 4
    assert nuts["dtype"] == "float64"
    assert nuts["f32_transition_max_abs_diff"] <= nuts["f32_transition_atol"]
    assert nuts["inv_mass_rel_diff"] <= nuts["inv_mass_rtol"]
    assert nuts["step_size_rel_diff"] <= nuts["step_size_rtol"]
    assert hodlr["mesh_vs_one_rel"] <= hodlr["mesh_rtol"]
    assert hodlr["anchor_rel_err"] <= hodlr["anchor_rtol"]


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_main_refuses_without_gpu(where, tmp_path, capsys):
    """No GPU: a non-zero exit and no result line, in the repository and
    in a directory holding nothing but the script."""
    if where == "repo":
        rc = _smoke().main([])
        out = capsys.readouterr().out
    else:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env.pop("PYTHONPATH", None)
        proc = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
            capture_output=True, text=True, timeout=300,
        )
        rc, out = proc.returncode, proc.stdout
    assert rc != 0
    assert '"ok": true' not in out


@pytest.mark.parametrize("env_set", [True, False])
def test_use_compile_cache(env_set, monkeypatch, tmp_path):
    """``JAX_COMPILATION_CACHE_DIR`` wins and nothing is set in code;
    otherwise the cache is the fixed ``<checkout>/.jax_cache``."""
    from george_tpu.utils import use_compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert use_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = use_compile_cache()
            assert path == os.path.join(ROOT, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
