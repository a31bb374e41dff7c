"""Sample-axis scaling measurement.

On real multi-chip hardware this measures control-steps/s vs device count
with the K rollouts sharded over the mesh (the BASELINE scaling-efficiency
metric). On a single-chip/CPU machine, run with
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scripts/scaling_bench.py --cpu
to exercise the sharded program end-to-end (CPU numbers validate the
machinery and partitioning, not interconnect bandwidth). --cpu forces the
CPU platform from inside the program.
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import json
import time

import numpy as np


def main():
    import sys

    import jax

    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from mpopis_tpu.models import CarRacingEnv
    from mpopis_tpu.parallel import make_sample_mesh, sample_sharding
    from mpopis_tpu.policies import PolicyConfig, make_policy

    n_dev = len(jax.devices())
    env = CarRacingEnv(dtype=jnp.float32)
    cov = np.diag([0.0625, 0.1])
    results = {}
    counts = sorted({1, 2, n_dev} & set(range(1, n_dev + 1)))
    for nd in counts:
        mesh = make_sample_mesh(nd)
        k = 1024 * nd
        cfg = PolicyConfig(
            kind="cemppi", num_samples=k, horizon=20, lam=10.0, opt_its=3,
            sigma_est="ss", use_fused_rollout=False,
        )
        pol = make_policy(
            env, cfg, cov_mat=cov,
            sample_sharding=sample_sharding(mesh, ndim=3),
        )
        s, ps = env.reset(), pol.init_state(0)
        # warmup + steady state
        for _ in range(2):
            _, ps2, _ = pol.step(s, ps)
        jax.block_until_ready(ps2.U)
        t0 = time.perf_counter()
        iters = 5
        for _ in range(iters):
            _, ps2, _ = pol.step(s, ps)
        jax.block_until_ready(ps2.U)
        dt = (time.perf_counter() - t0) / iters
        results[nd] = {"K": k, "ms_per_step": round(dt * 1e3, 2),
                       "samples_per_s": round(k / dt)}
    base = results[counts[0]]["samples_per_s"] / counts[0]
    for nd, r in results.items():
        r["weak_scaling_efficiency"] = round(r["samples_per_s"] / (nd * base), 3)
    out = {"devices": n_dev, "weak_scaling": results}
    if jax.devices()[0].platform == "cpu":
        import os

        out["note"] = (
            f"virtual CPU devices share {os.cpu_count()} physical core(s): "
            "this validates the sharded program, not hardware scaling"
        )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
