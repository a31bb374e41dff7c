"""Single-core host-engine throughput for the MuJoCo tasks.

Measures raw batched env-steps/s (one env-step = one frame-skipped
control step) of the C++ envpool_lite engine, for the device-vs-host
comparison. These are 1-core numbers — the reference's envpool scales them
by ~n_cores.

Usage: python scripts/bench_host_engine.py [task ...]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

DEFAULT_TASKS = [
    "HalfCheetah-v4", "Ant-v4", "Pusher-v4",
    "Humanoid-v4", "HumanoidStandup-v4",
]


def main(tasks):
    from mpopis_tpu.models.mujoco_host import MujocoBatchedEnv

    rng = np.random.default_rng(0)
    for task in tasks:
        env = MujocoBatchedEnv(task, num_envs=64)
        acts = rng.uniform(
            env.action_low, env.action_high, (env.num_envs, env.action_dim)
        )
        env.step(acts)  # warm
        n = 50
        t0 = time.perf_counter()
        for _ in range(n):
            env.step(acts)
        dt = time.perf_counter() - t0
        rate = env.num_envs * n / dt
        print(
            f"{task:22s} backend={env._backend:6s} frame_skip={env.frame_skip} "
            f"env_steps/s={rate:10.0f}",
            flush=True,
        )
        env.close()


if __name__ == "__main__":
    main(sys.argv[1:] or DEFAULT_TASKS)
