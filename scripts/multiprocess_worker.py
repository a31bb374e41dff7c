"""Worker for the multi-process (multi-host analog) validation.

Each process owns a slice of a global device mesh (forced CPU devices
stand in for each host's accelerators; the coordinator wire-up is exactly
jax.distributed, the same path a multi-host deployment uses).
The sharded CEMPPI policy step runs under jit over the GLOBAL mesh; every
input is process-replicated, the K sample axis is sharded across all
processes' devices, and the resulting action must be identical on every
process — and identical to the single-process reference value computed
from the same seed.

Usage (spawned by tests/test_multiprocess.py or run manually):
    python scripts/multiprocess_worker.py <coordinator> <num_procs> <pid> \
        <devices_per_proc> <out_file>
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import sys


def main() -> None:
    coordinator, n_proc, pid, dev_per_proc, out_file = (
        sys.argv[1],
        int(sys.argv[2]),
        int(sys.argv[3]),
        int(sys.argv[4]),
        sys.argv[5],
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=n_proc,
        process_id=pid,
        local_device_ids=list(range(dev_per_proc)),
    )
    import numpy as np

    from mpopis_tpu.models import MountainCarEnv
    from mpopis_tpu.parallel import make_sample_mesh, sample_sharding
    from mpopis_tpu.policies import PolicyConfig, make_policy

    assert len(jax.devices()) == n_proc * dev_per_proc, (
        len(jax.devices()),
        n_proc,
        dev_per_proc,
    )
    import jax.numpy as jnp

    mesh = make_sample_mesh()  # global mesh over all processes' devices
    env = MountainCarEnv(dtype=jnp.float64)
    cfg = PolicyConfig(kind="cemppi", num_samples=32, horizon=8, lam=0.1,
                       opt_its=2)
    pol = make_policy(
        env, cfg, cov_mat=[1.5], sample_sharding=sample_sharding(mesh, ndim=3)
    )
    s, ps = env.reset(), pol.init_state(7)
    action, _, _ = pol.step(s, ps)
    result = np.asarray(action)
    with open(out_file, "w") as f:
        f.write(",".join(repr(float(v)) for v in result))
    print(f"proc {pid}: action={result}", flush=True)


if __name__ == "__main__":
    main()
