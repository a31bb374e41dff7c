"""Benchmark: control throughput on one accelerator.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline", "details"}.
`details.device` names the device JAX ran on, and on a GPU the card's name
and power limit as `nvidia-smi` reports them.

Primary metric (BASELINE.json): control steps/s per chip at 8192 samples on
the car-racing task (CEMPPI, horizon 50, ais_its 10 — the reference's
default config at examples/car_example.jl:51-68, scaled to 8192 samples).
vs_baseline divides by the only wall-clock the reference publishes:
~2.56 control steps/s (HalfCheetah CEMPPI trial, README.md:90-95; the
reference has no faster published config at any sample count).
`cheetah_e2e_vs_baseline` is the same-task ratio (our HalfCheetah
end-to-end rate over that 2.56).

Rates are slopes between two chained-run lengths, so the fixed dispatch
and final device-to-host transfer cancel. A slope that stays non-positive
after retries reports NaN and the entry is marked unmeasurable.

Delivery: the headline runs first; the JSON line is emitted from a
try/finally and from a SIGTERM/SIGINT handler, so a killed or crashed run
still ships whatever was measured (entries not reached read "skipped:").
Every entry runs under a signal.alarm timeout (MPOPIS_BENCH_ENTRY_S,
default 240 s; the headline gets MPOPIS_BENCH_HEADLINE_S, 900 s), and a
wall-clock budget (MPOPIS_BENCH_BUDGET_S, default 1500 s) skips the
remaining entries.
"""

from __future__ import annotations

import json
import math
import os
import signal
import sys
import time

import numpy as np

BASELINE_STEPS_PER_S = 50.0 / 19.54  # reference README.md:90-95

COMPILE_TIMES: dict[str, float] = {}  # per-bench first-call (compile) wall

# --- delivery machinery (emit-on-partial; see module docstring) -----------

T_START = time.monotonic()
BUDGET_S = float(os.environ.get("MPOPIS_BENCH_BUDGET_S", "1500"))
ENTRY_TIMEOUT_S = float(os.environ.get("MPOPIS_BENCH_ENTRY_S", "240"))
HEADLINE_TIMEOUT_S = float(os.environ.get("MPOPIS_BENCH_HEADLINE_S", "900"))

RESULT: dict = {
    "metric": "car_racing_control_steps_per_s_K8192_H50",
    "value": None,
    "unit": "control_steps/s",
    "vs_baseline": None,
    "cheetah_e2e_vs_baseline": None,
    "details": {},
}
_EMITTED = False
_EMIT_LOCK = None  # created lazily (threading import below)


def device_info() -> dict:
    """The device JAX runs on; on a GPU also the card's name and power
    limit from nvidia-smi, since a card set below its maximum power runs
    slower under load."""
    import subprocess

    import jax

    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    if dev.platform == "gpu":
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"],
                capture_output=True, text=True, timeout=30, check=True,
            ).stdout.strip().splitlines()
            info["nvidia_smi"] = out[0] if out else ""
        except (OSError, subprocess.SubprocessError) as exc:
            info["nvidia_smi"] = f"unavailable: {type(exc).__name__}"
    return info


class EntryTimeout(Exception):
    pass


def _emit(note: str | None = None) -> None:
    """Print the result JSON exactly once. Safe to call from a signal
    handler or the watchdog thread mid-entry: RESULT/details are mutated
    in place as entries finish, so a partial run emits everything
    measured so far."""
    global _EMITTED
    import threading

    global _EMIT_LOCK
    if _EMIT_LOCK is None:
        _EMIT_LOCK = threading.Lock()
    with _EMIT_LOCK:
        if _EMITTED:
            return
        _EMITTED = True
    if note:
        RESULT["details"]["partial"] = note
    RESULT["details"]["elapsed_s"] = round(time.monotonic() - T_START, 1)
    RESULT["details"]["compile_s"] = COMPILE_TIMES
    try:
        line = json.dumps(RESULT)
        json.loads(line)  # self-check: must round-trip
        assert "\n" not in line
    except Exception:
        try:  # concurrent mutation: retry on a shallow copy
            snap = dict(RESULT)
            snap["details"] = dict(RESULT["details"])
            line = json.dumps(snap)
        except Exception:  # a detail value resisted serialization
            minimal = {k: RESULT.get(k) for k in
                       ("metric", "value", "unit", "vs_baseline")}
            minimal["details"] = {"error": "details failed json self-check"}
            line = json.dumps(minimal)
    sys.stderr.flush()
    # leading newline: the line must be parseable even if prior stdout
    # output was cut mid-line by the signal
    sys.stdout.write("\n" + line + "\n")
    sys.stdout.flush()


def _on_term(signum, frame):  # driver timeout sends SIGTERM (rc=124)
    _emit(note=f"killed by signal {signum}")
    os._exit(98)


def _on_alarm(signum, frame):
    raise EntryTimeout()


def _start_watchdog() -> None:
    """Backstop: SIGTERM/SIGALRM handlers only run when the main thread
    regains control, which a long blocking C call (a compile) can defer.
    A daemon thread needs no signal delivery: past budget+120s it emits
    whatever was measured and exits the process itself."""
    import threading

    def watch():
        deadline = T_START + BUDGET_S + 120.0
        while not _EMITTED:
            time.sleep(5.0)
            if not _EMITTED and time.monotonic() > deadline:
                _emit(note="watchdog: budget+120s exceeded "
                           "(main thread blocked in a C call)")
                os._exit(97)

    threading.Thread(target=watch, daemon=True, name="bench-watchdog").start()


def _slope(run, n_short: int, n_long: int, reps: int = 3,
           retries: int = 2) -> float:
    """Per-step slope between two chained-run lengths, guarded against
    timing noise making t_long <= t_short (which would report a negative
    or infinite rate): re-measure up to `retries` times, then return NaN —
    the caller marks the entry unmeasurable instead of publishing a rate
    fabricated from jitter."""
    per_step = float("nan")
    for _ in range(retries + 1):
        t_short = min(run(n_short) for _ in range(reps))
        t_long = min(run(n_long) for _ in range(reps))
        per_step = (t_long - t_short) / (n_long - n_short)
        if per_step > 0.0:
            return per_step
    return float("nan")


def _slope_spread(run, n_short: int, n_long: int, reps: int = 2,
                  samples: int = 3):
    """Repeat the slope measurement `samples` times: (median, spread%).

    The spread (max-min)/median tells run-to-run noise from a real
    change."""
    vals = [_slope(run, n_short, n_long, reps) for _ in range(samples)]
    vals = [v for v in vals if math.isfinite(v)]
    if not vals:
        return float("nan"), float("nan")
    med = float(np.median(vals))
    return med, 100.0 * (max(vals) - min(vals)) / med


def _timed_first(tag: str, fn):
    """Run fn() once, recording wall time as this bench's compile time."""
    t0 = time.perf_counter()
    out = fn()
    COMPILE_TIMES[tag] = round(time.perf_counter() - t0, 2)
    return out


def _mpc_steps_per_s(env, cfg, cov_mat, tag: str, n_short: int = 10,
                     n_long: int = 60, spread: bool = False):
    """End-to-end control steps/s of a jitted policy+env MPC step.

    Each MPC step feeds the next, and every run ends in a device-to-host
    transfer of the final state; the slope (t_long - t_short)/(n_long -
    n_short) cancels the fixed dispatch and transfer.
    """
    import jax

    from mpopis_tpu.policies import make_policy

    pol = make_policy(env, cfg, cov_mat=cov_mat, jit=False)

    @jax.jit
    def mpc_step(env_state, pol_state):
        action, pol_state, _ = pol.step(env_state, pol_state)
        return env.step(env_state, action), pol_state

    def run(n: int) -> float:
        s, ps = env.reset(), pol.init_state(1)
        t0 = time.perf_counter()
        for _ in range(n):
            s, ps = mpc_step(s, ps)
        x_host = np.asarray(s.x)
        dt = time.perf_counter() - t0
        assert bool(np.isfinite(x_host).all())
        return dt

    _timed_first(tag, lambda: run(1))
    run(2)  # settle
    if spread:
        med, spr = _slope_spread(run, n_short, n_long)
        return 1.0 / med, spr
    return 1.0 / _slope(run, n_short, n_long)


def bench_car_racing(num_samples: int, horizon: int = 50, ais_its: int = 10,
                     kind: str = "cemppi", spread: bool = False):
    import jax.numpy as jnp

    from mpopis_tpu.models import CarRacingEnv
    from mpopis_tpu.policies import PolicyConfig

    env = CarRacingEnv(dtype=jnp.float32)
    cfg = PolicyConfig(
        kind=kind,
        num_samples=num_samples,
        horizon=horizon,
        lam=10.0,
        alpha=1.0,
        opt_its=ais_its,
        ce_elite_threshold=0.8,
        sigma_est="ss",
    )
    return _mpc_steps_per_s(
        env, cfg, np.diag([0.0625, 0.1]), f"car_{kind}_K{num_samples}",
        spread=spread,
    )


def bench_ais_iter_ms(kind: str = "cemppi", num_samples: int = 8192):
    """ms per AIS iteration by opt_its scaling (its=10 vs its=40 MPC
    chains in one process — cancels dispatch and the per-step fixed
    work)."""
    import jax
    import jax.numpy as jnp

    from mpopis_tpu.models import CarRacingEnv
    from mpopis_tpu.policies import PolicyConfig, make_policy

    env = CarRacingEnv(dtype=jnp.float32)

    def build(its):
        cfg = PolicyConfig(
            kind=kind, num_samples=num_samples, horizon=50, lam=10.0,
            alpha=1.0, opt_its=its, ce_elite_threshold=0.8, sigma_est="ss",
            # early stop skips converged iterations, which would zero the
            # its=40-vs-10 slope for policies that converge — disable it
            # so the slope measures the per-iteration cost.
            elite_stop_tol=0.0,
        )
        pol = make_policy(env, cfg, cov_mat=np.diag([0.0625, 0.1]), jit=False)

        @jax.jit
        def step(s, ps):
            a, ps, _ = pol.step(s, ps)
            return env.step(s, a), ps

        def chain(n):
            s, ps = env.reset(), pol.init_state(1)
            t0 = time.perf_counter()
            for _ in range(n):
                s, ps = step(s, ps)
            np.asarray(s.x)
            return time.perf_counter() - t0

        return chain

    c10, c40 = build(10), build(40)
    _timed_first(f"ais_iter_{kind}", lambda: (c10(1), c40(1)))
    c10(2)
    t10 = min(c10(20) for _ in range(3)) / 20
    t40 = min(c40(20) for _ in range(3)) / 20
    return 1e3 * (t40 - t10) / 30.0


def bench_reacher_on_device(num_samples: int = 8192, horizon: int = 15):
    """On-device MuJoCo env-steps/s (CEMPPI policy step incl. 3 AIS its)."""
    import jax.numpy as jnp

    from mpopis_tpu.models import ReacherDeviceEnv
    from mpopis_tpu.policies import PolicyConfig

    env = ReacherDeviceEnv(dtype=jnp.float32)
    cfg = PolicyConfig(kind="cemppi", num_samples=num_samples, horizon=horizon,
                       lam=0.05, opt_its=3, sigma_est="mle")
    sps = _mpc_steps_per_s(env, cfg, [0.02, 0.02], "reacher_e2e")
    # env-steps/s = control steps/s x K x H x AIS its
    return _fmt_rate(sps, scale=num_samples * horizon * 3, nd=0)


# End-to-end contact configs: (env, K, H, opt_its, lam, cov). These tasks
# run the generic vmap rollout (models/rollout.py).
_E2E_TASKS = {
    "cheetah": ("CheetahDeviceEnv", 2048, 15, 3, 0.1, 0.25),
    "swimmer": ("SwimmerDeviceEnv", 4096, 25, 3, 0.1, 0.25),
    "ant": ("AntDeviceEnv", 1024, 10, 2, 1.0, 0.25),
    "pusher": ("PusherDeviceEnv", 1024, 10, 2, 0.1, 0.25),
    "humanoid": ("HumanoidDeviceEnv", 1024, 8, 2, 1.0, 0.25),
    "standup": ("HumanoidStandupDeviceEnv", 1024, 8, 2, 0.3, 0.25),
}


def bench_device_rate(env, cfg, cov, tag: str, n: int = 30):
    """Device-rate control steps/s: n MPC steps inside ONE jitted
    lax.scan, so the number contains no per-step host dispatch."""
    import jax

    from mpopis_tpu.policies import make_policy

    pol = make_policy(env, cfg, cov_mat=cov, jit=False)

    @jax.jit
    def run(s, ps):
        def body(c, _):
            s, ps = c
            a, ps2, _ = pol.step(s, ps)
            return (env.step(s, a), ps2), None
        (s, ps), _ = jax.lax.scan(body, (s, ps), None, length=n)
        return s.x

    s, ps = env.reset(), pol.init_state(1)
    x = _timed_first(tag, lambda: np.asarray(run(s, ps)))
    assert bool(np.isfinite(x).all())
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        np.asarray(run(s, ps))
        ts.append(time.perf_counter() - t0)
    return _fmt_rate(n / min(ts))


def bench_contact_e2e(task: str):
    """End-to-end control steps/s (CEMPPI MPC step: rollout +
    distribution update + env step) for a contact task — the number a
    user of simulate_mujoco_on_device actually gets, the same quantity as
    the reference's only published wall-clock (README.md:90-95)."""
    import importlib

    import jax.numpy as jnp

    from mpopis_tpu.policies import PolicyConfig

    cls_name, num_samples, horizon, opt_its, lam, cov = _E2E_TASKS[task]
    models = importlib.import_module("mpopis_tpu.models")
    env = getattr(models, cls_name)(dtype=jnp.float32)
    cfg = PolicyConfig(kind="cemppi", num_samples=num_samples,
                       horizon=horizon, lam=lam, opt_its=opt_its,
                       sigma_est="mle")
    rate = _mpc_steps_per_s(
        env, cfg, [cov] * env.action_dim, f"{task}_e2e", n_short=5, n_long=30
    )
    return _fmt_rate(rate)


def _sanitize(text: str, limit: int = 200) -> str:
    """One printable line: ANSI escapes stripped, control chars dropped,
    truncated, so that an error message cannot break the JSON line."""
    import re

    text = re.sub(r"\x1b\[[0-9;]*[A-Za-z]", "", text)
    text = " ".join(text.split())
    return text[:limit]


def _fmt_rate(rate, scale: float = 1.0, nd: int = 1):
    """Round a measured rate; NaN (slope unmeasurable) becomes a label."""
    v = rate * scale
    if isinstance(v, float) and not math.isfinite(v):
        return "unmeasurable: slope stayed non-positive after retries"
    return round(v, nd) if nd > 0 else int(round(v))


def _entry(details: dict, key: str, fn, timeout: float | None = None) -> None:
    """Run one measurement under the wall-clock budget and a per-entry
    signal.alarm timeout; a failure/timeout records a 'skipped:' row and
    the bench moves on (the final JSON always ships)."""
    if time.monotonic() - T_START > BUDGET_S:
        details[key] = "skipped: budget exhausted"
        return
    timeout = timeout if timeout is not None else ENTRY_TIMEOUT_S
    # never let one entry run past the budget by more than a minute
    # (alarm(0) would DISABLE the alarm, hence the floor of 1s)
    remaining = BUDGET_S - (time.monotonic() - T_START)
    timeout = max(1.0, min(timeout, remaining + 60.0))
    old = signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(int(timeout))
    try:
        v = fn()
        if isinstance(v, float) and not math.isfinite(v):
            v = "unmeasurable: slope stayed non-positive after retries"
        elif isinstance(v, float):
            v = round(v, 1)
        details[key] = v
    except EntryTimeout:
        details[key] = f"skipped: entry timeout ({int(timeout)}s)"
    except Exception as exc:  # mujoco-free images etc.: skip the detail
        details[key] = f"skipped: {_sanitize(f'{type(exc).__name__}: {exc}')}"
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _measure_headline(details: dict) -> None:
    sps, spread_pct = bench_car_racing(8192, spread=True)
    if math.isfinite(sps):
        RESULT["value"] = round(sps, 3)
        RESULT["vs_baseline"] = round(sps / BASELINE_STEPS_PER_S, 2)
    details["spread_pct_K8192"] = round(spread_pct, 1)


def _run_all(details: dict) -> None:
    # The headline first, with its own long timeout: everything after it
    # is detail.
    _entry(details, "headline_status",
           lambda: (_measure_headline(details), "ok")[1],
           timeout=HEADLINE_TIMEOUT_S)

    # Same-task baseline ratio: our HalfCheetah e2e rate over the
    # reference's published 2.56 steps/s wall-clock.
    def _cheetah():
        v = bench_contact_e2e("cheetah")
        if isinstance(v, (int, float)) and math.isfinite(v):
            RESULT["cheetah_e2e_vs_baseline"] = round(
                v / BASELINE_STEPS_PER_S, 2
            )
        return v

    _entry(details, "cheetah_e2e_control_steps_per_s", _cheetah)

    _entry(details, "K150_H50_steps_per_s",
           lambda: _fmt_rate(bench_car_racing(150)))
    _entry(details, "cmamppi_K8192_steps_per_s",
           lambda: _fmt_rate(bench_car_racing(8192, kind="cmamppi")))
    _entry(details, "reacher_on_device_env_steps_per_s",
           bench_reacher_on_device)
    for task in ("swimmer", "ant", "pusher", "humanoid", "standup"):
        _entry(details, f"{task}_e2e_control_steps_per_s",
               lambda t=task: bench_contact_e2e(t), timeout=420)

    def _dr(kind="cemppi", K=8192):
        import jax.numpy as jnp

        from mpopis_tpu.models import CarRacingEnv
        from mpopis_tpu.policies import PolicyConfig

        env = CarRacingEnv(dtype=jnp.float32)
        cfg = PolicyConfig(kind=kind, num_samples=K, horizon=50, lam=10.0,
                           alpha=1.0, opt_its=10, ce_elite_threshold=0.8,
                           sigma_est="ss")
        return bench_device_rate(env, cfg, np.diag([0.0625, 0.1]),
                                 f"devicerate_car_{kind}")

    _entry(details, "devicerate_car_cemppi_K8192_steps_per_s", _dr)
    _entry(details, "devicerate_car_cmamppi_K8192_steps_per_s",
           lambda: _dr("cmamppi"))

    def _dr_task(task):
        import importlib

        import jax.numpy as jnp

        from mpopis_tpu.policies import PolicyConfig

        cls_name, K, H, its, lam, cov = _E2E_TASKS[task]
        models = importlib.import_module("mpopis_tpu.models")
        env = getattr(models, cls_name)(dtype=jnp.float32)
        cfg = PolicyConfig(kind="cemppi", num_samples=K, horizon=H, lam=lam,
                           opt_its=its, sigma_est="mle")
        return bench_device_rate(env, cfg, [cov] * env.action_dim,
                                 f"devicerate_{task}")

    for task in _E2E_TASKS:
        _entry(details, f"devicerate_{task}_e2e_steps_per_s",
               lambda t=task: _dr_task(t))
    _entry(details, "cemppi_ms_per_ais_iteration",
           lambda: round(bench_ais_iter_ms("cemppi"), 3))
    _entry(details, "cmamppi_ms_per_ais_iteration",
           lambda: round(bench_ais_iter_ms("cmamppi"), 3))

    def _harness():
        # end-to-end harness wall-clock (chunked MPC, telemetry + lap/
        # violation bookkeeping included); trial 2 excludes compiles
        from mpopis_tpu.harness import simulate_car_racing

        metrics = simulate_car_racing(
            num_trials=2, num_steps=100, seed=7, laps=1, print_output=False
        )
        return round(float(metrics["control_steps_per_s"][1]), 1)

    _entry(details, "harness_steps_per_s_K150", _harness)

    # One retry if the headline itself failed (its compile may have landed
    # in the persistent cache meanwhile).
    if RESULT["value"] is None and time.monotonic() - T_START < BUDGET_S:
        _entry(details, "headline_status_retry",
               lambda: (_measure_headline(details), "ok")[1],
               timeout=HEADLINE_TIMEOUT_S)


def main() -> None:
    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)
    _start_watchdog()
    details = RESULT["details"]
    details["baseline_steps_per_s"] = round(BASELINE_STEPS_PER_S, 3)
    details["config"] = (
        "cemppi, H=50, ais_its=10, ss-shrinkage, bicycle car racing"
    )
    details["budget_s"] = BUDGET_S
    try:
        from mpopis_tpu.utils.cache import enable_compilation_cache

        enable_compilation_cache()
        details["device"] = device_info()
        _run_all(details)
    finally:
        # the JSON line ships on crashes too
        _emit()


if __name__ == "__main__":
    main()
