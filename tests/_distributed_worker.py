# -*- coding: utf-8 -*-
"""Worker process for the two-process ``jax.distributed`` test.

Launched by ``test_distributed.py`` as::

    python tests/_distributed_worker.py <process_id> <num_processes> <port>

Each process joins the distributed runtime through
``george_tpu.parallel.initialize()``, builds a global mesh spanning both
processes, and runs (a) a cross-process ``psum`` and (b) a sharded NUTS
chain with cross-process adaptation collectives.  Results are printed as
one JSON line; the parent asserts both processes agree.
"""

import json
import sys

import jax

# force CPU before any backend initializes: the worker must not touch a
# GPU the host may have
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

    from george_tpu import parallel

    parallel.initialize(
        coordinator_address="127.0.0.1:%s" % port,
        num_processes=nproc,
        process_id=pid,
    )
    assert jax.process_count() == nproc
    ndev = len(jax.devices())
    assert ndev >= nproc, "expected a global device view"

    mesh = parallel.chain_mesh()

    # (a) cross-process reduction: sum of each device's (index + 1)
    local = np.arange(ndev, dtype=np.float64) + 1.0
    arr = parallel.shard_chains(mesh, local)
    with mesh:
        total = jax.jit(
            jnp.sum, out_shardings=NamedSharding(mesh, P())
        )(arr)
    psum_val = float(total)

    # (b) sharded NUTS across both processes on an anisotropic Gaussian
    scales = jnp.array([1.0, 0.5, 2.0])

    def log_prob(q):
        return -0.5 * jnp.sum((q / scales) ** 2)

    chains = 2 * ndev
    key = jax.random.PRNGKey(7)
    p0 = 0.1 * np.asarray(
        jax.random.normal(key, (chains, 3), dtype=jnp.float64)
    )
    samples, stats = parallel.sharded_sample_nuts(
        mesh, jax.random.PRNGKey(11), log_prob, p0,
        num_warmup=150, num_samples=150, max_depth=6,
    )
    with mesh:
        moments = jax.jit(
            lambda s: (jnp.mean(s, axis=(0, 1)), jnp.std(s, axis=(0, 1))),
            out_shardings=(
                NamedSharding(mesh, P()), NamedSharding(mesh, P()),
            ),
        )(samples)
    mean = np.asarray(moments[0])
    std = np.asarray(moments[1])

    assert np.all(np.abs(mean) < 0.6), mean
    assert np.all(np.abs(std / np.asarray(scales) - 1.0) < 0.5), std

    print(json.dumps({
        "process_id": pid,
        "n_devices": ndev,
        "psum": psum_val,
        "mean": [round(float(v), 10) for v in mean],
        "std": [round(float(v), 10) for v in std],
    }), flush=True)


if __name__ == "__main__":
    main()
