"""Quickest proof that the system runs on one NVIDIA GPU.

    python chip_smoke.py          # one card: phases 1-6 below
    python chip_smoke.py --four   # four cards: the sample-sharded phase only

Phases, each printed with its result and wall time on its own line:

1. device: JAX's device and `nvidia-smi`'s card name and power limit. No
   GPU (or no package beside this script) exits non-zero with no result.
2. car kernel parity: the Triton car rollout kernel against the plain
   `rollout_batch` at K=8192, H=50, one car and three cars.
3. policy step, GPU vs CPU: one CEMPPI car step at the reference config on
   the GPU (kernel) against the same step on the CPU (plain rollout), with
   the same injected normals; compares the action and U.
4. CLI main path (`simulate_car_racing`): K=150 for 100 steps, which must
   give finite costs, a mean speed above the 10 m/s start and no
   violations; then K=8192 for 20 steps.
5. HalfCheetah on the device (vmap rollout with the contact QP): K=2048,
   H=15, 3 AIS iterations, a few control steps.
6. Ant (K=1024): compile seconds, `memory_analysis()`, then 2 steps.

`--four` runs car CEMPPI at K=4×8192 sharded over a 4-card sample mesh
(the shard-mapped Triton kernel) and compares it with the same K on one
card. The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": n}}.
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

# Tolerances. Costs are sums over 50 steps of rewards of order 1e2 with
# -1e6 off-track, -5000 side-slip and -11000 collision penalties. Both the
# kernel and the plain path compute in f32, in another order (the kernel
# carries the heading as sin/cos and skips atan in the slip angles), so
# costs agree to f32 rounding amplified over 500 substeps: COST_RTOL
# relative to max(|cost|, 1). A sample whose trajectory grazes the track
# edge, the side-slip limit or the 4 m collision radius can take a penalty
# in one implementation and not in the other. Both f32 costs are therefore
# held against an f64 reference (the plain path on the CPU): the share of
# kernel samples beyond COST_RTOL may be at most twice the plain f32
# path's own share, and at least MISMATCH_FLOOR (8 of 8192 samples).
COST_RTOL = 1e-3
MISMATCH_FLOOR = 1e-3
# The GPU step (kernel rollout, GPU linear algebra) against the CPU step
# (plain rollout) with the same normals: actions and U are controls in
# [-1, 1]; both are weighted means over the same samples, so they agree
# to f32 rounding carried through 10 AIS refits.
STEP_ATOL = 1e-4
# The 4-card run reduces over K in another order than the 1-card run.
SHARD_ATOL = 1e-4


def _phase(name: str, fn):
    t0 = time.perf_counter()
    detail = fn()
    dt = time.perf_counter() - t0
    print(f"[phase] {name}: ok ({dt:.1f} s) {detail}", flush=True)


def _check_standalone() -> None:
    """Exit non-zero unless the package sits beside this script."""
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        import mpopis_tpu
    except ImportError as exc:
        sys.exit(f"chip_smoke: mpopis_tpu is not importable ({exc})")
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(mpopis_tpu.__file__)))
    if pkg != here:
        sys.exit(f"chip_smoke: mpopis_tpu found at {pkg}, not beside this script")


def _device() -> dict:
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX platform is {devs[0].platform!r})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _policy_controls(num_cars: int, k: int, horizon: int, seed: int):
    """(T, 2N, K) controls drawn as the policy draws them: N(0, Σ) with
    Σ=diag(0.0625, 0.1) per car, clamped to the action box."""
    sd = np.tile(np.sqrt([0.0625, 0.1]), num_cars)
    z = np.random.default_rng(seed).standard_normal((horizon, 2 * num_cars, k))
    return np.clip(z * sd[None, :, None], -1.0, 1.0).astype(np.float32)


def car_kernel_parity(k: int = 8192, horizon: int = 50) -> str:
    import jax
    import jax.numpy as jnp

    from mpopis_tpu.kernels.car_rollout import car_rollout_costs
    from mpopis_tpu.models import CarRacingEnv, MultiCarRacingEnv, rollout_batch

    def plain(env, ctrl):
        s0 = env.reset()
        return jax.jit(lambda c: rollout_batch(
            env, s0, jnp.transpose(c, (2, 0, 1)))[0])(ctrl)

    def beyond(a, ref):
        rel = np.abs(a - ref) / np.maximum(np.abs(ref), 1.0)
        return float(np.mean(rel > COST_RTOL)), float(np.median(rel))

    out = []
    for n in (1, 3):
        env = CarRacingEnv() if n == 1 else MultiCarRacingEnv(num_cars=n)
        ctrl = _policy_controls(n, k, horizon, seed=n)
        x0 = env.reset().x
        got = np.asarray(jax.jit(
            lambda c: car_rollout_costs(env, x0, c))(jnp.asarray(ctrl)),
            np.float64)
        xla = np.asarray(plain(env, jnp.asarray(ctrl)), np.float64)
        with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
            env64 = dataclasses.replace(env, dtype=jnp.float64)
            ref = np.asarray(plain(env64, jnp.asarray(ctrl, jnp.float64)))
        if got.shape != (k,) or not np.isfinite(got).all():
            raise AssertionError(f"{n} cars: kernel costs not finite (K,)")
        f_kernel, med_kernel = beyond(got, ref)
        f_xla, _ = beyond(xla, ref)
        f_pair, _ = beyond(got, xla)
        allowed = max(2.0 * f_xla, MISMATCH_FLOOR)
        out.append(
            f"{n} car(s) vs f64: kernel beyond rtol {f_kernel:.5f} (median "
            f"rel {med_kernel:.2e}), plain f32 {f_xla:.5f}; kernel vs plain "
            f"f32 {f_pair:.5f}")
        if f_kernel > allowed:
            raise AssertionError(
                f"{n} cars: {f_kernel:.5f} of kernel costs beyond rtol "
                f"{COST_RTOL} of the f64 reference (allowed {allowed:.5f})")
    return f"K={k} H={horizon} rtol={COST_RTOL}: " + "; ".join(out)


def _car_cfg(k: int):
    from mpopis_tpu.policies import PolicyConfig

    return PolicyConfig(kind="cemppi", num_samples=k, horizon=50, lam=10.0,
                        alpha=1.0, opt_its=10, ce_elite_threshold=0.8,
                        sigma_est="ss")


def gpu_vs_cpu_step(k: int = 150) -> str:
    import jax
    import jax.numpy as jnp

    from mpopis_tpu.models import CarRacingEnv
    from mpopis_tpu.policies import make_policy

    env = CarRacingEnv()
    cfg = _car_cfg(k)
    cov = np.diag([0.0625, 0.1])
    z = np.random.default_rng(3).standard_normal(
        (cfg.opt_its, 2 * cfg.horizon, k)).astype(np.float32)

    pol = make_policy(env, cfg, cov_mat=cov)
    if not env.supports_fused_rollout:
        raise AssertionError("the car kernel is not selected on the GPU")
    s, ps = env.reset(), pol.init_state(5)
    a_g, ps_g, _ = pol.step(s, ps, z=jnp.asarray(z))

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        pol_c = make_policy(
            env, dataclasses.replace(cfg, use_fused_rollout=False), cov_mat=cov)
        s_c, ps_c = jax.device_put((s, ps), cpu)
        a_c, ps_c2, _ = pol_c.step(s_c, ps_c, z=jax.device_put(z, cpu))
    da = float(np.max(np.abs(np.asarray(a_g) - np.asarray(a_c))))
    du = float(np.max(np.abs(np.asarray(ps_g.U) - np.asarray(ps_c2.U))))
    if not (da <= STEP_ATOL and du <= STEP_ATOL):
        raise AssertionError(
            f"GPU step differs from CPU: max|da|={da:.3e} max|dU|={du:.3e} "
            f"(atol {STEP_ATOL})")
    return (f"K={k}: max|da|={da:.3e} max|dU|={du:.3e} (atol {STEP_ATOL}); "
            f"action={np.asarray(a_g)}")


def cli_main_path() -> str:
    from mpopis_tpu.harness import simulate_car_racing

    out = []
    m = simulate_car_racing(num_trials=1, num_steps=100, num_samples=150,
                            seed=7, laps=2)
    if not np.isfinite(m["rewards"]).all():
        raise AssertionError("K=150: non-finite reward")
    if not m["mean_vs"][0] > 10.0:
        raise AssertionError(f"K=150: mean V {m['mean_vs'][0]:.2f} m/s "
                             "did not rise above the 10 m/s start")
    viol = m["track_violations"][0] + m["beta_violations"][0]
    if viol != 0:
        raise AssertionError(f"K=150: {viol:.0f} violations")
    out.append(f"K=150: reward {m['rewards'][0]:.1f}, mean V "
               f"{m['mean_vs'][0]:.2f} m/s, 0 violations, "
               f"{m['control_steps_per_s'][0]:.2f} steps/s incl. compile")
    m = simulate_car_racing(num_trials=1, num_steps=20, num_samples=8192,
                            seed=7, laps=2)
    if not np.isfinite(m["rewards"]).all():
        raise AssertionError("K=8192: non-finite reward")
    out.append(f"K=8192: reward {m['rewards'][0]:.1f}, mean V "
               f"{m['mean_vs'][0]:.2f} m/s")
    return "; ".join(out)


def cheetah_on_device() -> str:
    from mpopis_tpu.harness.simulate import simulate_mujoco_on_device

    m = simulate_mujoco_on_device(
        "HalfCheetah-v4", num_trials=1, num_steps=5, num_samples=2048,
        horizon=15, lam=0.1, ais_its=3, seed=1, print_output=False)
    if not np.isfinite(m["rewards"]).all():
        raise AssertionError("HalfCheetah: non-finite reward")
    return f"K=2048 H=15: reward over 5 steps {m['rewards'][0]:.3f}"


def ant_compile() -> str:
    import jax
    import jax.numpy as jnp

    from mpopis_tpu.models import AntDeviceEnv
    from mpopis_tpu.policies import PolicyConfig, make_policy

    env = AntDeviceEnv(dtype=jnp.float32)
    cfg = PolicyConfig(kind="cemppi", num_samples=1024, horizon=10, lam=1.0,
                       opt_its=2, sigma_est="mle")
    pol = make_policy(env, cfg, cov_mat=[0.25] * env.action_dim, jit=False)

    def mpc_step(s, ps):
        a, ps, _ = pol.step(s, ps)
        return env.step(s, a), ps

    s, ps = env.reset(), pol.init_state(0)
    t0 = time.perf_counter()
    compiled = jax.jit(mpc_step).lower(s, ps).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    for _ in range(2):
        s, ps = compiled(s, ps)
    x = np.asarray(s.x)
    if not np.isfinite(x).all():
        raise AssertionError("Ant: non-finite state")
    return f"K=1024 H=10: compile {compile_s:.1f} s, memory_analysis {mem}"


def four_card_sharded(k_per_card: int = 8192) -> str:
    import jax

    from mpopis_tpu.models import CarRacingEnv
    from mpopis_tpu.parallel import make_sample_mesh, sample_sharding
    from mpopis_tpu.policies import make_policy

    if len(jax.devices()) < 4:
        raise AssertionError(f"--four needs 4 cards, found {len(jax.devices())}")
    env = CarRacingEnv()
    cfg = _car_cfg(4 * k_per_card)
    cov = np.diag([0.0625, 0.1])
    pol_s = make_policy(env, cfg, cov_mat=cov, sample_sharding=sample_sharding(
        make_sample_mesh(4), ndim=3))
    pol_1 = make_policy(env, cfg, cov_mat=cov)
    s = env.reset()
    a_s, ps_s, i_s = pol_s.step(s, pol_s.init_state(11))
    a_1, ps_1, i_1 = pol_1.step(s, pol_1.init_state(11))
    if not np.isfinite(np.asarray(i_s["costs"])).all():
        raise AssertionError("sharded costs not finite")
    da = float(np.max(np.abs(np.asarray(a_s) - np.asarray(a_1))))
    du = float(np.max(np.abs(np.asarray(ps_s.U) - np.asarray(ps_1.U))))
    times = {}
    for name, pol in (("4 cards", pol_s), ("1 card", pol_1)):
        ps = pol.init_state(11)
        jax.block_until_ready(pol.step(s, ps))
        t0 = time.perf_counter()
        for _ in range(10):
            jax.block_until_ready(pol.step(s, ps))
        times[name] = (time.perf_counter() - t0) / 10 * 1e3
    if not (da <= SHARD_ATOL and du <= SHARD_ATOL):
        raise AssertionError(
            f"sharded step differs from 1 card: max|da|={da:.3e} "
            f"max|dU|={du:.3e} (atol {SHARD_ATOL})")
    return (f"K={4 * k_per_card}: max|da|={da:.3e} max|dU|={du:.3e} "
            f"(atol {SHARD_ATOL}); step ms 4 cards "
            f"{times['4 cards']:.3f}, 1 card {times['1 card']:.3f}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card sharded phase")
    args = ap.parse_args()

    _check_standalone()
    from mpopis_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    t0 = time.perf_counter()
    dev = _device()
    print(f"[phase] device: ok {dev}", flush=True)
    if args.four:
        _phase("four-card sharded car CEMPPI", four_card_sharded)
    else:
        _phase("car kernel parity", car_kernel_parity)
        _phase("policy step GPU vs CPU", gpu_vs_cpu_step)
        _phase("CLI main path", cli_main_path)
        _phase("HalfCheetah on device", cheetah_on_device)
        _phase("Ant compile", ant_compile)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": dev}))


if __name__ == "__main__":
    main()
