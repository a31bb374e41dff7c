"""Planar single-track (bicycle) car-racing dynamics with brush/Fiala tire
forces, in pure branchless JAX (all conditionals are jnp.where selects so the
model vmaps over thousands of candidate rollouts).

Model: Brown & Gerdes, "Coordinating Tire Forces to Avoid Obstacles Using
Nonlinear Model Predictive Control", IEEE T-IV 5(1), 2020 — the same model
the reference implements at src/envs/car_racing.jl:252-344. State layout
[x, y, Ψ, Vx, Vy, Ψ̇, δ, pedal] (car_racing.jl:161-173); action
[steer∈[-1,1], pedal∈[-1,1]]; semi-implicit Euler at δt inside dt action
steps (10 substeps by default, car_racing.jl:299-333); reward −1e6 off-track
−5000 on |β|>β_limit − centerline distance + 2‖v‖ (car_racing.jl:201-213).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from mpopis_tpu.models.base import Env, EnvState, make_state
from mpopis_tpu.models.track import Track, distance_query

_G = 9.81


@dataclasses.dataclass(frozen=True, eq=False)
class CarParams:
    """Physical parameters (defaults: car_racing.jl:68-93)."""

    m: float = 2000.0  # mass (kg)
    i_zz: float = 3764.0  # yaw moment of inertia (kg m^2)
    h_cm: float = 0.3  # CoM height (m)
    l_f: float = 1.53  # CoM to front axle (m)
    l_r: float = 1.23  # CoM to rear axle (m)
    c_d0: float = 241.0  # constant drag (N)
    c_d1: float = 25.1  # linear drag (N s/m)
    c_af: float = 150000.0  # front cornering stiffness (N/rad)
    c_ar: float = 280000.0  # rear cornering stiffness (N/rad)
    mu_f: float = 0.9  # front tire friction
    mu_r: float = 0.9  # rear tire friction
    delta_max: float = float(np.deg2rad(18.0))  # steering limit (rad)
    delta_dot_max: float = float(np.deg2rad(90.0))  # steering rate limit
    fx_max: float = 7200.0  # max drive force (N)
    fx_min: float = 22500.0  # max brake force (N)
    lambda_brake: float = 0.6  # brake force front/rear split
    lambda_drive: float = 0.0  # drive force front/rear split
    beta_limit: float = float(np.deg2rad(45.0))  # sideslip penalty limit


def _tire_fy(alpha, mu, c_a, fz, fx):
    """Brush tire lateral force (car_racing.jl:252-260), branchless."""
    fy_max = jnp.sqrt(jnp.maximum((mu * fz) ** 2 - fx**2, 1e-8))
    ta = jnp.tan(alpha)
    cubic = (
        -c_a * ta
        + (c_a**2 / (3.0 * fy_max)) * jnp.abs(ta) * ta
        - (c_a**3 / (27.0 * fy_max**2)) * ta**3
    )
    saturated = -fy_max * jnp.sign(alpha)
    return jnp.where(jnp.abs(alpha) < jnp.arctan(3.0 * fy_max / c_a), cubic, saturated)


@dataclasses.dataclass(frozen=True, eq=False)
class CarRacingEnv(Env):
    params: CarParams = CarParams()
    dt: float = 0.1  # action step
    ddt: float = 0.01  # integration substep
    track: Track = None  # type: ignore[assignment]
    track_name: str = "curve"
    track_width: float = 15.0
    track_sample_factor: int = 20
    fused_interpret: bool = False  # run the kernel in the Pallas interpreter (tests)

    has_fused_kernel = True

    state_dim = 8
    action_dim = 2
    action_low = np.array([-1.0, -1.0])
    action_high = np.array([1.0, 1.0])

    def __post_init__(self):
        if self.track is None:
            object.__setattr__(
                self,
                "track",
                Track.load(
                    self.track_name,
                    width=self.track_width,
                    sample_factor=self.track_sample_factor,
                ),
            )

    # ------------------------------------------------------------------
    def reset(self, key: jax.Array | None = None) -> EnvState:
        """Zeros except Ψ=90°, Vx=10 (car_racing.jl:215-223)."""
        x = jnp.zeros((8,), dtype=self.dtype)
        x = x.at[2].set(jnp.asarray(np.deg2rad(90.0), dtype=self.dtype))
        x = x.at[3].set(10.0)
        return make_state(x)

    def step(self, state: EnvState, action: jnp.ndarray) -> EnvState:
        x_new = step_car_state(
            self.params, state.x, action, self.dt, self.ddt, self.dtype
        )
        return EnvState(x=x_new, t=state.t + 1, done=state.done)

    def reward(self, state: EnvState) -> jnp.ndarray:
        pts, widths = self.track.query_arrays(self.dtype)
        return car_reward(self.params, pts, widths, state.x)

    def fused_rollout_costs(self, state: EnvState, controls_tak: jnp.ndarray):
        """(T, na, K) clamped controls -> (K,) costs through the Triton
        rollout kernel (kernels/car_rollout.py)."""
        from mpopis_tpu.kernels.car_rollout import car_rollout_costs

        return car_rollout_costs(
            self, state.x, controls_tak, interpret=self.fused_interpret
        )

    # conveniences mirroring the reference exports
    def within_track(self, state: EnvState):
        pts, widths = self.track.query_arrays(self.dtype)
        return distance_query(pts, widths, state.x[:2])

    def beta(self, state: EnvState):
        return jnp.arctan2(state.x[4], state.x[3])

    def exceed_beta(self, state: EnvState):
        return jnp.abs(self.beta(state)) > self.params.beta_limit


def step_car_state(p: CarParams, s: jnp.ndarray, action: jnp.ndarray, dt, ddt, dtype):
    """One action step = `dt/ddt` semi-implicit Euler substeps
    (car_racing.jl:282-344). Pure function over the 8-vector state; shared by
    the vmap path, the multi-car env, and the Pallas kernel's reference
    oracle.
    """
    x, y, psi, vx, vy, psid, delta = s[0], s[1], s[2], s[3], s[4], s[5], s[6]
    a_steer = action[0]
    pedal = action[1]

    target = a_steer * p.delta_max
    commanded_rate = jnp.abs(target - delta) / dt
    ddelta_rate = jnp.minimum(commanded_rate, p.delta_dot_max) * jnp.sign(
        target - delta
    )

    ll = p.l_r + p.l_f
    # pedal-dependent force split (constant across substeps)
    lam = jnp.where(pedal <= 0.0, p.lambda_brake, p.lambda_drive)
    accel = p.fx_max * jnp.maximum(pedal, 0.0)

    n_sub = int(round(dt / ddt))
    for _ in range(n_sub):
        delta = delta + ddelta_rate * ddt

        alpha_f = jnp.arctan2(vy + p.l_f * psid, vx) - delta
        alpha_r = jnp.arctan2(vy - p.l_r * psid, vx)

        fx_aero = (p.c_d0 + p.c_d1 * jnp.abs(vx)) * jnp.sign(vx)

        brake = p.fx_min * jnp.minimum(pedal, 0.0) * jnp.sign(vx)
        fx = accel + brake

        fxf = lam * fx
        fxr = (1.0 - lam) * fx
        fzf = (p.m * p.l_r * _G - p.h_cm * fx) / ll
        fzr = (p.m * p.l_f * _G + p.h_cm * fx) / ll
        fyf = _tire_fy(alpha_f, p.mu_f, p.c_af, fzf, fxf)
        fyr = _tire_fy(alpha_r, p.mu_r, p.c_ar, fzr, fxr)

        sin_d = jnp.sin(delta)
        cos_d = jnp.cos(delta)
        psidd = (p.l_f * (fxf * sin_d + fyf * cos_d) - p.l_r * fyr) / p.i_zz
        vy_dot = (fyf * cos_d + fxf * sin_d + fyr) / p.m - psid * vx
        vx_dot = (fxf * cos_d - fyf * sin_d + fxr - fx_aero) / p.m + psid * vy

        psid = psid + psidd * ddt
        vx = vx + vx_dot * ddt
        vy = vy + vy_dot * ddt
        psi = psi + psid * ddt
        psi = jnp.arctan2(jnp.sin(psi), jnp.cos(psi))
        x = x + (vx * jnp.cos(psi) - vy * jnp.sin(psi)) * ddt
        y = y + (vx * jnp.sin(psi) + vy * jnp.cos(psi)) * ddt

    return jnp.stack([x, y, psi, vx, vy, psid, delta, pedal]).astype(dtype)


def car_reward(p: CarParams, pts: jnp.ndarray, widths: jnp.ndarray, s: jnp.ndarray):
    """Reward on the post-step state (car_racing.jl:201-213)."""
    within, dist = distance_query(pts, widths, s[:2])
    beta = jnp.arctan2(s[4], s[3])
    rew = jnp.where(within, 0.0, -1000000.0)
    rew = rew + jnp.where(jnp.abs(beta) > p.beta_limit, -5000.0, 0.0)
    rew = rew - dist
    rew = rew + 2.0 * jnp.sqrt(s[3] ** 2 + s[4] ** 2)
    return rew
