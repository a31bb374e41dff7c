"""Experiment drivers — capability parity with the reference's example
harness: config banner, per-trial seeded runs, violation/lap bookkeeping,
AVE/STD/MED/L95/U95/MIN/MAX summary tables, optional trajectory plots/gifs.

Ref: examples/car_example.jl (simulate_car_racing), mountaincar_example.jl,
cartpole_example.jl. The MPC loop runs host-side like the reference's
`act = pol(env); env(act)` loop — but each device call is a single
compiled program covering `steps_per_call` full control steps
(policy + env step + reward + packed telemetry under `lax.scan`), so the
host pays one dispatch and one device→host transfer per chunk instead of
per step. Early termination (laps/violations) is detected host-side from
the telemetry block; steps computed past the stopping point inside a
chunk are simply discarded, which leaves results identical to the
step-by-step loop up to compile-level rounding (the chunked scan is a
differently-compiled program; tests/test_harness.py pins equality at
rtol=1e-12 in f64 — in f32, threshold-based bookkeeping such as
violation counts can in principle flip on boundary-grazing steps). Paths that need
host interposition every step (gif rendering, trajectory plots, additive
state noise, policy logging) fall back to steps_per_call=1.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from mpopis_tpu.harness.factory import get_policy
from mpopis_tpu.harness.stats import SUMMARY_ROWS, summary_value
from mpopis_tpu.models import CarRacingEnv, CartPoleEnv, MountainCarEnv, MultiCarRacingEnv
from mpopis_tpu.policies.config import canonical_kind

_AIS_KINDS = {"imppi", "cemppi", "cmamppi", "muaismppi", "musigmaaismppi", "pmcmppi", "nesmppi"}
_LAMBDA_AIS_KINDS = {"muaismppi", "musigmaaismppi", "pmcmppi"}


def _print(enabled: bool, fmt: str, *args) -> None:
    if enabled:
        print(fmt % args if args else fmt, flush=True)


class _Progress:
    """Per-trial liveness meter — the reference shows a ProgressMeter bar
    during every trial (car_example.jl:190,238) and erases it afterwards
    with ANSI cursor cleanup (:305-311). This analog renders an in-place
    `\\r` line (bar, step count, rate, ETA), updated at most ~10x/s,
    only when printing is enabled AND stdout is a real TTY — piped runs,
    log mirrors, and bench.py capture stay byte-clean."""

    def __init__(self, enabled: bool, trial: int, num_trials: int,
                 total_steps: int):
        import sys

        self.on = bool(enabled and sys.stdout.isatty() and total_steps > 0)
        self.trial = trial
        self.num_trials = num_trials
        self.total = total_steps
        self.t0 = time.perf_counter()
        self._last = 0.0

    def update(self, step: int) -> None:
        if not self.on:
            return
        now = time.perf_counter()
        if now - self._last < 0.1 and step < self.total:
            return
        self._last = now
        import sys

        frac = min(step / self.total, 1.0)
        filled = int(frac * 20)
        rate = step / max(now - self.t0, 1e-9)
        eta = (self.total - step) / max(rate, 1e-9)
        sys.stdout.write(
            f"\rTrial {self.trial}/{self.num_trials} "
            f"[{'#' * filled}{'.' * (20 - filled)}] "
            f"{step}/{self.total} steps  {rate:5.1f}/s  ETA {eta:4.0f}s\x1b[K"
        )
        sys.stdout.flush()

    def finish(self) -> None:
        if not self.on:
            return
        import sys

        sys.stdout.write("\r\x1b[K")  # erase the bar (ref :305-311)
        sys.stdout.flush()


def _banner(
    enabled,
    sim_type,
    policy_type,
    num_trials,
    num_steps,
    num_samples,
    horizon,
    lam,
    alpha,
    ais_its,
    lambda_ais,
    ce_elite_threshold,
    ce_sigma_est,
    cma_sigma,
    cma_elite_threshold,
    seed,
    extra=(),
):
    kind = canonical_kind(policy_type)
    _print(enabled, "")
    _print(enabled, "%-30s%s", "Sim Type:", sim_type)
    for label, value in extra:
        _print(enabled, "%-30s%s", label, value)
    _print(enabled, "%-30s%d", "Num Trails:", num_trials)
    _print(enabled, "%-30s%d", "Num Steps:", num_steps)
    _print(enabled, "%-30s%s", "Policy Type:", policy_type)
    _print(enabled, "%-30s%d", "Num samples", num_samples)
    _print(enabled, "%-30s%d", "Horizon", horizon)
    _print(enabled, "%-30s%.2f", "λ (inverse temp):", lam)
    _print(enabled, "%-30s%.2f", "α (control cost param):", alpha)
    if kind in _AIS_KINDS:
        _print(enabled, "%-30s%d", "# AIS Iterations:", ais_its)
        if kind in _LAMBDA_AIS_KINDS:
            _print(enabled, "%-30s%.2f", "λ_ais (ais inverse temp):", lambda_ais)
        elif kind == "cemppi":
            _print(enabled, "%-30s%.2f", "CE Elite Threshold:", ce_elite_threshold)
            _print(enabled, "%-30s%s", "CE Σ Est Method:", ce_sigma_est)
        elif kind == "cmamppi":
            _print(enabled, "%-30s%.2f", "CMA Step Factor (σ):", cma_sigma)
            _print(enabled, "%-30s%.2f", "CMA Elite Perc Thres:", cma_elite_threshold)
    _print(enabled, "%-30s%d", "Seed:", seed)
    _print(enabled, "")


def _summary_table(enabled, metrics: dict, order: list[str]):
    """Print AVE/STD/MED/L95/U95/MIN/MAX rows over trials for each metric."""
    for row in SUMMARY_ROWS:
        vals = " : ".join(
            f"{summary_value(row, metrics[name]):12.2f}" for name in order
        )
        _print(enabled, "Trials %3s: %s", row, vals)


def _default_seed() -> int:
    return int(np.random.randint(1, 10**10))


def _resolve_chunk(steps_per_call, needs_host_every_step: bool) -> int:
    """Control steps per compiled device call. Gif rendering, trajectory
    plots, state-noise injection, and policy logging only exist in the
    per-step path, so they force 1 — even over an explicit request."""
    if needs_host_every_step:
        if steps_per_call is not None and steps_per_call > 1:
            import warnings

            warnings.warn(
                f"steps_per_call={steps_per_call} ignored: gif/plot/noise/"
                "logging need the host every control step; using 1",
                stacklevel=3,
            )
        return 1
    return 10 if steps_per_call is None else max(int(steps_per_call), 1)


# ---------------------------------------------------------------------------
# MountainCar / CartPole
# ---------------------------------------------------------------------------

def _simulate_simple(
    env,
    sim_type: str,
    *,
    num_trials=1,
    num_steps=200,
    policy_type="cemppi",
    num_samples=20,
    horizon=15,
    lam=0.1,
    alpha=1.0,
    u0=(0.0,),
    cov_mat=(1.5,),
    ais_its=5,
    lambda_ais=0.1,
    ce_elite_threshold=0.8,
    ce_sigma_est="mle",
    cma_sigma=0.75,
    cma_elite_threshold=0.8,
    seed=None,
    log_runs=True,
    pol_log=False,
    plot_traj=False,
    plot_traj_perc=1.0,
    save_gif=False,
    gif_name=None,
    print_output=True,
    steps_per_call=None,
    output_acts_file=False,
    acts_dir="acts",
):
    if seed is None:
        seed = _default_seed()
    if save_gif and sim_type not in ("MountainCar", "CartPole") \
            and not plot_traj:
        import warnings

        warnings.warn(
            f"save_gif for {sim_type} needs plot_traj=True (sampled-"
            "trajectory overlays); disabling",
            stacklevel=2,
        )
        save_gif = False
    pol_log = pol_log or plot_traj
    chunk = _resolve_chunk(
        steps_per_call, needs_host_every_step=save_gif or pol_log
    )
    _banner(
        print_output, sim_type, policy_type, num_trials, num_steps, num_samples,
        horizon, lam, alpha, ais_its, lambda_ais, ce_elite_threshold,
        ce_sigma_est, cma_sigma, cma_elite_threshold, seed,
    )
    _print(print_output, "Trial    #: %12s : %7s: %12s : %7s", "Reward", "Steps", "Reward/Step", "Ex Time")

    pol = get_policy(
        policy_type, env, num_samples, horizon, lam, alpha, list(u0),
        list(cov_mat), pol_log, ais_its, lambda_ais, ce_elite_threshold,
        ce_sigma_est, cma_sigma, cma_elite_threshold,
    )

    @jax.jit
    def fused_chunk(s, ps):
        """`chunk` control steps in one device program; emits per-step
        [reward, done, act...] rows so the host transfers once per
        chunk. env.step_reward keeps totals gym-exact for
        pre-step-reward envs."""
        def body(carry, _):
            s, ps = carry
            act, ps2, _ = pol.step(s, ps)
            s2, r = env.step_reward(s, act)
            row = jnp.concatenate([
                jnp.stack([r.astype(env.dtype), s2.done.astype(env.dtype)]),
                act.astype(env.dtype),
            ])
            return (s2, ps2), row
        (s2, ps2), rows = jax.lax.scan(body, (s, ps), None, length=chunk)
        return s2, ps2, rows

    frames = [] if save_gif else None

    rews = np.zeros(num_trials)
    steps = np.zeros(num_trials)
    exec_times = np.zeros(num_trials)
    for k in range(1, num_trials + 1):
        ps = pol.init_state(seed + k)
        s = env.reset(jax.random.PRNGKey(seed + k))
        t0 = time.perf_counter()
        rew, cnt, done = 0.0, 0, False
        acts: list[np.ndarray] = []
        trail: list[np.ndarray] = []  # executed states (plot_traj)
        prog = _Progress(print_output, k, num_trials, num_steps)
        while not done and cnt <= num_steps:
            prog.update(cnt)
            if chunk > 1:
                s, ps, rows_d = fused_chunk(s, ps)
                for row in np.asarray(rows_d):
                    if done or cnt > num_steps:
                        break
                    cnt += 1
                    rew += float(row[0])
                    done = bool(row[1])
                    if output_acts_file:
                        acts.append(row[2:].astype(np.float64))
                continue
            act, ps, info = pol.step(s, ps)
            if plot_traj:
                trail.append(np.asarray(s.x))
            s, r_step = env.step_reward(s, act)
            rew += float(r_step)
            cnt += 1
            done = bool(s.done)
            if output_acts_file:
                acts.append(np.asarray(act, dtype=np.float64))
            if frames is not None:
                from mpopis_tpu.harness import plotting

                if plot_traj and "trajectories" in info:
                    # sampled-rollout overlay (plots.jl:96-126 analog)
                    task = sim_type.replace(" (on-device)", "")
                    fig = plotting.render_mujoco_trajectories(
                        task, trail + [np.asarray(s.x)],
                        info["trajectories"], info["weights"],
                        plot_traj_perc,
                    )
                else:
                    render = {
                        "MountainCar": plotting.render_mountaincar,
                        "CartPole": plotting.render_cartpole,
                    }.get(sim_type)
                    fig = render(env, s)
                frames.append(plotting.figure_to_array(fig))
                plotting.close(fig)
        prog.finish()
        dt = time.perf_counter() - t0
        rews[k - 1] = rew
        steps[k - 1] = cnt - 1
        exec_times[k - 1] = dt
        if output_acts_file and acts:
            # executed-action CSV at 20 decimals, the reference's
            # write_acts_to_file format (envpool_env.jl:184-197) — feeds
            # scripts/replay_mujoco.py for the gymnasium replay check
            import os

            os.makedirs(acts_dir, exist_ok=True)
            fname = os.path.join(
                acts_dir,
                f"{sim_type.replace(' ', '')}_{policy_type}_{num_steps}"
                f"_{num_trials}_{seed}_{horizon}_{num_samples}_{ais_its}"
                f"trial-{k}.csv",
            )
            with open(fname, "w") as f:
                for a in acts:
                    f.write(",".join(f"{v:.20f}" for v in a) + "\n")
            _print(print_output, "Wrote acts...%s", fname)
        if log_runs:
            _print(
                print_output, "Trial %4d: %12.2f : %7d: %12.2f : %7.2f",
                k, rew, cnt - 1, rew / max(cnt - 1, 1), dt,
            )

    metrics = {
        "rewards": rews,
        "steps": steps,
        "rewards_per_step": rews / np.maximum(steps, 1),
        "exec_times": exec_times,
    }
    _print(print_output, "-----------------------------------")
    _summary_table(print_output, metrics, ["rewards", "steps", "rewards_per_step", "exec_times"])
    if frames:
        from mpopis_tpu.harness import plotting

        if gif_name is None:
            gif_name = f"{sim_type}-{num_samples}-{horizon}-{lam}-{num_trials}.gif"
        plotting.save_gif(frames, gif_name, fps=10)
        _print(print_output, "Saved gif...%s", gif_name)
    return metrics


def simulate_mountaincar(**kwargs):
    """Parity driver for mountaincar_example.jl:49-207."""
    import jax.numpy as jnp

    dtype = kwargs.pop("dtype", jnp.float32)
    env = MountainCarEnv(dtype=dtype)
    return _simulate_simple(env, "MountainCar", **kwargs)


def simulate_cartpole(**kwargs):
    """Parity driver for cartpole_example.jl:33-187."""
    import jax.numpy as jnp

    dtype = kwargs.pop("dtype", jnp.float32)
    env = CartPoleEnv(dtype=dtype)
    return _simulate_simple(env, "CartPole", **kwargs)


ON_DEVICE_MUJOCO_TASKS = (
    "Ant-v4",
    "Humanoid-v4",
    "HumanoidStandup-v4",
    "Pusher-v4",
    "Reacher-v4",
    "Swimmer-v4",
    "InvertedPendulum-v4",
    "InvertedDoublePendulum-v4",
    "HalfCheetah-v4",
    "Hopper-v4",
    "Walker2d-v4",
)


def simulate_mujoco_on_device(task: str, **kwargs):
    """MuJoCo task with ON-DEVICE dynamics (no host engine): the K×T
    rollout fan-out runs on the accelerator like the car models. Available
    for the contact-free tasks with closed-form dynamics, the
    HalfCheetah/Hopper/Walker2d contact pipeline (models/planar_contact.py)
    AND the 3D spatial-contact family
    (models/spatial_contact.py — Ant, Humanoid, HumanoidStandup,
    Pusher): all 11 reference envpool tasks
    (src/envs/envpool_env.jl:35-61). Contact-free tasks match mj_step to
    solver tolerance; contact tasks default to control-grade solver
    iterations — pass solver_iters=(6, 40) for mj_step-parity-grade
    trajectories. `output_acts_file=True` exports the executed action
    sequence per trial as a 20-decimal CSV (the reference's
    write_acts_to_file format, envpool_env.jl:184-197) for the
    scripts/replay_mujoco.py gymnasium replay cross-check.
    `plot_traj=True, save_gif=True` renders the logged K sampled
    rollouts per control step as weight-graded overlays over the
    executed trail (the reference's plot(env, pol, perc),
    plots.jl:96-126) into a gif — see plotting.MUJOCO_VIEWS for each
    task's 2D projection."""
    import jax.numpy as jnp

    from mpopis_tpu.models import (
        AntDeviceEnv,
        CheetahDeviceEnv,
        HopperDeviceEnv,
        HumanoidDeviceEnv,
        HumanoidStandupDeviceEnv,
        InvertedDoublePendulumDeviceEnv,
        InvertedPendulumDeviceEnv,
        PusherDeviceEnv,
        ReacherDeviceEnv,
        SwimmerDeviceEnv,
        Walker2dDeviceEnv,
    )

    registry = {
        "Ant-v4": AntDeviceEnv,
        "Humanoid-v4": HumanoidDeviceEnv,
        "HumanoidStandup-v4": HumanoidStandupDeviceEnv,
        "Pusher-v4": PusherDeviceEnv,
        "Reacher-v4": ReacherDeviceEnv,
        "Swimmer-v4": SwimmerDeviceEnv,
        "InvertedPendulum-v4": InvertedPendulumDeviceEnv,
        "InvertedDoublePendulum-v4": InvertedDoublePendulumDeviceEnv,
        "HalfCheetah-v4": CheetahDeviceEnv,
        "Hopper-v4": HopperDeviceEnv,
        "Walker2d-v4": Walker2dDeviceEnv,
    }
    if task not in registry:
        raise ValueError(
            f"no on-device dynamics for {task!r}; options {ON_DEVICE_MUJOCO_TASKS} "
            "(the host engine supports all 11 tasks: python -m mpopis_tpu mujoco)"
        )
    dtype = kwargs.pop("dtype", jnp.float32)
    solver_iters = kwargs.pop("solver_iters", None)
    env_kwargs = {}
    if solver_iters is not None:
        cls = registry[task]
        if not hasattr(cls, "solver_outer"):
            raise ValueError(f"{task!r} has no contact solver (solver_iters)")
        env_kwargs = {"solver_outer": solver_iters[0], "solver_cg": solver_iters[1]}
    env = registry[task](dtype=dtype, **env_kwargs)
    kwargs.setdefault("u0", (0.0,) * env.action_dim)
    kwargs.setdefault("cov_mat", (0.25,) * env.action_dim)
    return _simulate_simple(env, f"{task} (on-device)", **kwargs)


# ---------------------------------------------------------------------------
# Car racing (single + multi)
# ---------------------------------------------------------------------------

def simulate_car_racing(
    *,
    num_trials=1,
    num_steps=200,
    num_cars=1,
    policy_type="cemppi",
    laps=2,
    num_samples=150,
    horizon=50,
    lam=10.0,
    alpha=1.0,
    u0=None,
    cov_mat=None,
    ais_its=10,
    lambda_ais=20.0,
    ce_elite_threshold=0.8,
    ce_sigma_est="ss",
    cma_sigma=0.75,
    cma_elite_threshold=0.8,
    state_x_sigma=0.0,
    state_y_sigma=0.0,
    state_psi_sigma=0.0,
    seed=None,
    log_runs=True,
    pol_log=False,
    plot_traj=False,
    plot_traj_perc=1.0,
    text_with_plot=True,
    text_on_plot_xy=(80.0, -60.0),
    save_gif=False,
    gif_name=None,
    track="curve",
    print_output=True,
    dtype=None,
    sample_sharding=None,
    steps_per_call=None,
):
    """Parity driver for car_example.jl:51-416.

    Violation accounting, lap detection, and trial summary replicate
    car_example.jl:203-281; per-trial seeding follows :187-188 (seed + k).
    """
    if seed is None:
        seed = _default_seed()
    if dtype is None:
        dtype = jnp.float32
    sim_type = "mcr" if num_cars > 1 else "cr"
    if u0 is None:
        u0 = [0.0, 0.0] * num_cars
    if cov_mat is None:
        cov_mat = np.diag([0.0625, 0.1] * num_cars)
    if plot_traj:
        pol_log = True

    _banner(
        print_output, sim_type, policy_type, num_trials, num_steps, num_samples,
        horizon, lam, alpha, ais_its, lambda_ais, ce_elite_threshold,
        ce_sigma_est, cma_sigma, cma_elite_threshold, seed,
        extra=[("Num Cars:", num_cars), ("Max Num Laps:", laps)],
    )

    if num_cars > 1:
        env = MultiCarRacingEnv(num_cars=num_cars, dtype=dtype, track_name=track)
    else:
        env = CarRacingEnv(dtype=dtype, track_name=track)

    pol = get_policy(
        policy_type, env, num_samples, horizon, lam, alpha, u0, cov_mat,
        pol_log, ais_its, lambda_ais, ce_elite_threshold, ce_sigma_est,
        cma_sigma, cma_elite_threshold, sample_sharding=sample_sharding,
    )
    has_noise = sim_type == "cr" and bool(
        state_x_sigma or state_y_sigma or state_psi_sigma
    )
    chunk = _resolve_chunk(
        steps_per_call,
        needs_host_every_step=save_gif or plot_traj or has_noise or pol_log,
    )

    def _stats_vec(s, rew):
        """Per-step bookkeeping packed into ONE device vector so the host
        loop pays a single transfer per control step:
        [rew, within, d, curr_y, vs(num_cars), betas(num_cars)]
        (car_example.jl:240-270)."""
        cars = s.x.reshape(num_cars, 8)
        vs = jnp.sqrt(cars[:, 3] ** 2 + cars[:, 4] ** 2)
        betas = jnp.abs(jnp.arctan2(cars[:, 4], cars[:, 3]))
        within, _ = env.within_track(s)
        d = jnp.min(jnp.sqrt(cars[:, 0] ** 2 + cars[:, 1] ** 2))
        curr_y = jnp.min(cars[:, 1])
        head = jnp.stack(
            [rew, within.astype(rew.dtype), d.astype(rew.dtype),
             curr_y.astype(rew.dtype)]
        )
        return jnp.concatenate([head, vs.astype(rew.dtype), betas.astype(rew.dtype)])

    @jax.jit
    def fused_step(s, ps):
        """One device call per control step: policy + env step + reward
        (+ packed metrics when no host-side state noise interposes)."""
        act, ps2, info = pol.step(s, ps)
        s2 = env.step(s, act)
        rew = env.reward(s2)
        stats = None if has_noise else _stats_vec(s2, rew)
        return s2, ps2, info, rew, stats

    stats_fn = jax.jit(_stats_vec)

    @jax.jit
    def fused_chunk(s, ps):
        """`chunk` control steps in one compiled program (lax.scan),
        emitting the packed per-step telemetry block — one dispatch and
        one device→host transfer per chunk."""
        def body(carry, _):
            s, ps = carry
            act, ps2, _ = pol.step(s, ps)
            s2 = env.step(s, act)
            rew = env.reward(s2)
            return (s2, ps2), _stats_vec(s2, rew)
        (s2, ps2), stats = jax.lax.scan(body, (s, ps), None, length=chunk)
        return s2, ps2, stats

    frames = [] if save_gif else None
    header = f"Trial    #: {'Reward':>12} : {'Steps':>7}: {'Reward/Step':>12}"
    for ii in range(1, laps + 1):
        header += f" : {'lap ':>6}{ii}"
    header += f" : {'Mean V':>7} : {'Max V':>7} : {'Mean β':>7} : {'Max β':>7}"
    header += f" : {'β Viol':>7} : {'T Viol':>7}"
    if sim_type == "mcr":
        header += f" : {'C Viol':>7}"
    header += f" : {'Ex Time':>7}"
    _print(print_output, header)

    n_t = num_trials
    rews = np.zeros(n_t)
    steps = np.zeros(n_t)
    lap_ts = np.zeros((laps, n_t))
    mean_vs = np.zeros(n_t)
    max_vs = np.zeros(n_t)
    mean_bs = np.zeros(n_t)
    max_bs = np.zeros(n_t)
    b_viols = np.zeros(n_t)
    t_viols = np.zeros(n_t)
    c_viols = np.zeros(n_t)
    exec_times = np.zeros(n_t)

    for k in range(1, n_t + 1):
        ps = pol.init_state(seed + k)
        s = env.reset()
        noise_rng = np.random.default_rng(seed + k)
        t0 = time.perf_counter()

        lap_time = np.zeros(laps, dtype=int)
        v_mean_log, v_max_log, b_mean_log, b_max_log = [], [], [], []
        rew, cnt, lap, prev_y = 0.0, 0, 0, 0.0
        trk_viol, b_viol, crash_viol = 0, 0, 0
        done = False

        prog = _Progress(print_output, k, n_t, num_steps)
        while not done and cnt <= num_steps:
            prog.update(cnt)
            if chunk > 1:
                s, ps, stats_block_d = fused_chunk(s, ps)
                stats_block = np.asarray(stats_block_d)
            else:
                s, ps, info, step_rew_d, stats_d = fused_step(s, ps)

                if frames is not None or plot_traj:
                    from mpopis_tpu.harness import plotting

                    fig = plotting.render_frame(
                        env, s, info if plot_traj else None, plot_traj_perc,
                        text_output=text_with_plot, text_xy=text_on_plot_xy,
                    )
                    if frames is not None:
                        frames.append(plotting.figure_to_array(fig))
                    plotting.close(fig)

                # additive state noise, single car only (car_example.jl:224-236)
                if has_noise:
                    x = np.asarray(s.x).copy()
                    x[0] += state_x_sigma * noise_rng.standard_normal()
                    x[1] += state_y_sigma * noise_rng.standard_normal()
                    dpsi = state_psi_sigma * noise_rng.standard_normal()
                    x[2] += dpsi
                    rot = np.array(
                        [[np.cos(dpsi), np.sin(dpsi)], [-np.sin(dpsi), np.cos(dpsi)]]
                    )
                    x[3:5] = rot @ x[3:5]
                    s = s.replace(x=jnp.asarray(x, dtype=dtype))
                    stats_d = stats_fn(s, step_rew_d)

                stats_block = np.asarray(stats_d)[None]

            for stats in stats_block:
                if done or cnt > num_steps:
                    break  # steps computed past the stop are discarded
                cnt += 1
                step_rew = float(stats[0])
                rew += step_rew
                within_t = bool(stats[1] != 0.0)
                d = float(stats[2])
                curr_y = float(stats[3])
                vs = stats[4 : 4 + num_cars]
                bs = stats[4 + num_cars :]
                v_mean_log.append(float(np.mean(vs)))
                v_max_log.append(float(np.max(vs)))
                b_mean_log.append(float(np.mean(bs)))
                b_max_log.append(float(np.max(bs)))

                # violation accounting (car_example.jl:255-263)
                if step_rew < -4000:
                    ex_b = bool(np.max(bs) > env.params.beta_limit)
                    if ex_b:
                        b_viol += 1
                    if not within_t:
                        trk_viol += 1
                    temp_rew = step_rew + ex_b * 5000 + (not within_t) * 1000000
                    if temp_rew < -10500:
                        crash_viol += 1

                # lap detection on curve.csv (car_example.jl:272-276)
                if prev_y < 0.0 <= curr_y and d <= 15.0:
                    lap += 1
                    if lap <= laps:
                        lap_time[lap - 1] = cnt
                if lap >= laps or trk_viol > 10 or b_viol > 50:
                    done = True
                prev_y = curr_y

        prog.finish()
        dt_s = time.perf_counter() - t0
        rews[k - 1] = rew
        steps[k - 1] = cnt - 1
        exec_times[k - 1] = dt_s
        lap_ts[:, k - 1] = lap_time
        mean_vs[k - 1] = np.mean(v_mean_log)
        max_vs[k - 1] = np.max(v_max_log)
        mean_bs[k - 1] = np.mean(b_mean_log)
        max_bs[k - 1] = np.max(b_max_log)
        b_viols[k - 1] = b_viol
        t_viols[k - 1] = trk_viol
        c_viols[k - 1] = crash_viol

        if log_runs:
            row = f"Trial {k:4d}: {rew:12.2f} : {cnt - 1:7d}: {rew / max(cnt - 1, 1):12.2f}"
            for ii in range(laps):
                row += f" : {lap_time[ii]:7d}"
            row += f" : {np.mean(v_mean_log):7.2f} : {np.max(v_max_log):7.2f}"
            row += f" : {np.mean(b_mean_log):7.2f} : {np.max(b_max_log):7.2f}"
            row += f" : {b_viol:7d} : {trk_viol:7d}"
            if sim_type == "mcr":
                row += f" : {crash_viol:7d}"
            row += f" : {dt_s:7.2f}"
            _print(print_output, row)

    metrics = {
        "rewards": rews,
        "steps": steps,
        "rewards_per_step": rews / np.maximum(steps, 1),
        "mean_vs": mean_vs,
        "max_vs": max_vs,
        "mean_betas": mean_bs,
        "max_betas": max_bs,
        "beta_violations": b_viols,
        "track_violations": t_viols,
        "crash_violations": c_viols,
        "exec_times": exec_times,
        "lap_times": lap_ts,
        "control_steps_per_s": steps / np.maximum(exec_times, 1e-9),
    }
    _print(print_output, "-----------------------------------")
    order = ["rewards", "steps", "rewards_per_step"]
    for ii in range(laps):
        metrics[f"lap{ii + 1}_times"] = lap_ts[ii]
        order.append(f"lap{ii + 1}_times")
    order += ["mean_vs", "max_vs", "mean_betas", "max_betas",
              "beta_violations", "track_violations"]
    if sim_type == "mcr":
        order.append("crash_violations")
    order.append("exec_times")
    _summary_table(print_output, metrics, order)

    if frames:
        from mpopis_tpu.harness import plotting

        if gif_name is None:
            gif_name = (
                f"{sim_type}-{num_cars}-{canonical_kind(policy_type)}-{num_samples}-"
                f"{horizon}-{lam}-{alpha}-{ais_its}-{num_trials}-{laps}.gif"
            )
        plotting.save_gif(frames, gif_name, fps=10)
        _print(print_output, "Saved gif...%s", gif_name)
    return metrics
