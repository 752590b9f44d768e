# -*- coding: utf-8 -*-
"""Test configuration: run everything on a virtual 8-device CPU mesh.

The reference test suite is float64 on CPU; we match it for parity tests
(``jax_enable_x64``) and give every test session 8 virtual CPU devices so the
multi-device sharding paths (chain- and data-parallel) are exercised without
a GPU. ``jax.config.update`` pins the CPU even on a host with a card, so no
test needs one.
"""

import os

# Must be set before the XLA backend initializes.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


# ---------------------------------------------------------------------------
# Slow-test marking (central, tuned from `pytest --durations`): the fast
# developer loop is `pytest -m "not slow"` (~9-12 min depending on host load); CI and release runs
# execute everything. Keep this list in sync when a test's cost changes
# materially — entries are exact test names (parametrized variants all
# match by base name).
# ---------------------------------------------------------------------------

_SLOW_TESTS = {
    "test_grad_deflation_auto_rank_2d",            # 396s (n=1e4 2-D + dense oracle)
    "test_hutchinson_loglike_and_grad_function",   # 87s
    "test_hmatrix_fused_loglike_and_grad",         # 80s
    "test_baseline_config3_hodlr_1e6_at_1e4_quasiperiodic",  # 57s
    "test_bench_emits_json_line",                  # 51s
    "test_graft_dryrun_multichip",                 # 45s
    "test_sparse_fused_loglike_and_grad",          # 44s
    "test_hodlr_loglike_autodiff_gradient",        # 39s
    "test_spatial_example",                        # 36s
    "test_hyper_example",                          # 32s
    "test_nuts_vs_ensemble_gp_posterior_moments",  # 30s
    "test_hodlr_kernel_zoo_oracle",                # 28s
    "test_hodlr_mesh_sharded_gp",                  # 27s
    "test_strong_beats_weak_at_equal_rank",        # 25s
    "test_hmatrix_matvec_matches_dense",           # 25s + 16s
    "test_nuts_gp_posterior_smoke",                # 20s
    "test_scaling_example",                        # 16s
    "test_gp_loglike_and_predict_vs_basic",        # 15s
    "test_general_metric_loglike_and_grad",        # 14s
    "test_sparse_fused_pdiag_boundary_rows",       # 14s
    "test_hodlr_self_check_warns_on_nondecaying_kernel",  # 14s
    "test_solver_protocol_vs_dense",               # 13s
    "test_hodlr_debug_flag_reports_errors",        # 13s
    "test_hmatrix_apply_sqrt_lanczos",             # 13s
    "test_golden_loglike_hodlr_compressed",        # 13s
    "test_gp_gradient_hutchinson_tracks_exact",    # 13s
    "test_hodlr_recompute_invalidates_caches",     # 13s
    # can block on gRPC machinery for minutes when ports/processes
    # misbehave, regardless of its healthy 11s runtime
    "test_two_process_distributed_nuts",
    "test_hodlr_lcm_multitask_oracle",
    "test_samplers_match_quadrature_truth",
    "test_hmatrix_lcm_multitask_oracle",
}


def pytest_collection_modifyitems(config, items):
    import pytest as _pytest

    for item in items:
        base = item.name.split("[")[0]
        if base in _SLOW_TESTS:
            item.add_marker(_pytest.mark.slow)
