# -*- coding: utf-8 -*-
"""Two-process ``jax.distributed`` integration: ``parallel.initialize()``
joins a real multi-process runtime (CPU collectives over gRPC — the same
code path as a multi-host GPU runtime), a global mesh spans both
processes, and sharded NUTS runs with cross-process adaptation
reductions.  This is the one distributed layer a single-process suite
cannot touch (SURVEY §5 "distributed communication backend")."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_distributed_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_nuts():
    port = _free_port()
    env = dict(os.environ)
    # one device per process: the coordinator glues them into a global
    # 2-device view (drop any inherited virtual-mesh flag)
    env.pop("XLA_FLAGS", None)
    env["JAX_NUM_CPU_DEVICES"] = "1"
    # the worker is spawned bare (no pytest/conftest), so put the repo
    # root on its path; APPEND to any existing PYTHONPATH — a plugin or
    # sitecustomize on PYTHONPATH must survive for every JAX child
    repo_root = os.path.dirname(HERE)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo_root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )

    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=env, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=540)
        assert p.returncode == 0, (
            "worker failed\n--- stdout ---\n%s\n--- stderr ---\n%s"
            % (out, err)
        )
        outs.append(json.loads(out.strip().splitlines()[-1]))

    a, b = sorted(outs, key=lambda r: r["process_id"])
    assert a["n_devices"] == b["n_devices"] == 2
    # the reduction saw both processes' shards: 1 + 2
    assert a["psum"] == b["psum"] == 3.0
    # SPMD determinism: both processes computed identical moments
    assert np.allclose(a["mean"], b["mean"], atol=0)
    assert np.allclose(a["std"], b["std"], atol=0)
