"""A/B of the car rollout kernel against the XLA vmap rollout, on the GPU.

For each K, times the reference's CEMPPI car policy step (H=50, 10 AIS
iterations, `ss` shrinkage, Σ=diag(0.0625, 0.1)) built twice in one
process: with the Triton rollout kernel (kernels/car_rollout.py) at each
block size, and with `use_fused_rollout=False` (models/rollout.py). It also
times the rollout alone (kernel call vs `rollout_batch`) on the same
controls. Every time is the median over `--reps` calls that each end in
`block_until_ready`; the variants run in turns (A, B, ..., B, A) so that
drift hits all of them alike. Compile seconds are reported separately.

    python scripts/ab_car_kernel.py --ks 150,8192 --blocks 32,64,128
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _median_ms(fn, reps: int) -> float:
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ks", default="150,8192")
    ap.add_argument("--blocks", default="32,64,128")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from mpopis_tpu.kernels import car_rollout
    from mpopis_tpu.models import CarRacingEnv, rollout_batch
    from mpopis_tpu.policies import PolicyConfig, make_policy
    from mpopis_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, found {dev.platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"device: {dev.device_kind} | nvidia-smi: {smi}", flush=True)

    env = CarRacingEnv(dtype=jnp.float32)
    s0 = env.reset()
    blocks = [int(b) for b in args.blocks.split(",")]
    results = []
    for k in (int(v) for v in args.ks.split(",")):
        cfg = PolicyConfig(kind="cemppi", num_samples=k, horizon=50, lam=10.0,
                           opt_its=10, ce_elite_threshold=0.8, sigma_est="ss")
        ctrl = jax.random.uniform(jax.random.PRNGKey(k), (50, 2, k),
                                  minval=-1.0, maxval=1.0)
        ps0 = make_policy(env, cfg, cov_mat=np.diag([0.0625, 0.1])).init_state(0)
        row = {"K": k, "compile_s": {}, "step_ms": {}, "rollout_ms": {}}
        variants = {}

        def add(name, pol, roll):
            # compile now: the kernel's block size is read at trace time
            step = jax.jit(pol.step)
            roll = jax.jit(roll)
            t0 = time.perf_counter()
            jax.block_until_ready(step(s0, ps0))
            jax.block_until_ready(roll(ctrl))
            row["compile_s"][name] = round(time.perf_counter() - t0, 2)
            variants[name] = (step, roll)

        for blk in blocks:
            car_rollout.DEFAULT_BLOCK = blk
            add(f"kernel_b{blk}",
                make_policy(env, cfg, cov_mat=np.diag([0.0625, 0.1]),
                            jit=False),
                lambda c, blk=blk: car_rollout.car_rollout_costs(
                    env, s0.x, c, block=blk))
        add("xla_vmap",
            make_policy(env, dataclasses.replace(cfg, use_fused_rollout=False),
                        cov_mat=np.diag([0.0625, 0.1]), jit=False),
            lambda c: rollout_batch(env, s0, jnp.transpose(c, (2, 0, 1)))[0])
        order = list(variants) + list(reversed(variants))
        step_t = {n: [] for n in variants}
        roll_t = {n: [] for n in variants}
        for name in order:
            step, roll = variants[name]
            step_t[name].append(_median_ms(
                lambda: jax.block_until_ready(step(s0, ps0)), args.reps))
            roll_t[name].append(_median_ms(
                lambda: jax.block_until_ready(roll(ctrl)), args.reps))
        for name in variants:
            row["step_ms"][name] = [round(v, 4) for v in step_t[name]]
            row["rollout_ms"][name] = [round(v, 4) for v in roll_t[name]]
        print(json.dumps(row), flush=True)
        results.append(row)
    print(json.dumps({"device": dev.device_kind, "nvidia_smi": smi,
                      "results": results}))


if __name__ == "__main__":
    main()
