"""Device mesh helpers for sample-axis parallelism.

The reference's only parallelism is Julia threads over the K candidate
rollouts (mppi_mpopi_policies.jl:269-270) and envpool's C++ thread pool.
The scaling dimension here is the same K axis, sharded over a 1-D
`jax.sharding.Mesh` ("samples"): rollouts fan out across devices, while
the tiny distribution-update math stays replicated. Cross-shard
reductions (cost min/sum, weighted moments, global top-k) ride XLA
collectives — see mpopis_tpu.parallel.collectives.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SAMPLE_AXIS = "samples"


def make_sample_mesh(n_devices: int | None = None, axis: str = SAMPLE_AXIS) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devs)} available"
            )
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def sample_sharding(mesh: Mesh, ndim: int = 3, axis: str = SAMPLE_AXIS) -> NamedSharding:
    """NamedSharding that shards the leading (sample) axis of an ndim array."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def distributed_init(**kwargs) -> None:
    """Multi-host initialization.

    Thin wrapper over jax.distributed.initialize; no-op if already
    initialized. On single-host (including CPU test topologies) this is not
    needed — meshes span local devices.
    """
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError:
        pass  # already initialized
