"""Fused car-racing rollout kernel (1..N cars): Pallas on the Triton route.

One kernel evaluates a batch of candidate control sequences: the
T-step × 10-substep brush-tire integration (car_racing.jl:282-344), the
track distance query (car_racing_tracks.jl:64-92), the reward
(car_racing.jl:201-213; joint multi-car reward with pairwise distance and
collision terms, multi-car_racing.jl:145-158), and cost accumulation.

Why a kernel: one rollout is T·10 dependent substeps (500 at T=50, 5,000
per 10-iteration AIS control step). The vmap path (models/rollout.py) runs
them as a `lax.scan`, and every scan iteration is at least one kernel
launch carrying a few microseconds of work at K=150.

Layout: one sample per thread. Each program owns `block` samples (a power
of two); every car's state (x, y, sin ψ, cos ψ, Vx, Vy, ψ̇, δ) and the
running cost stay in registers for the whole horizon. Controls keep the
(T, na, K) layout, so each step's load is coalesced along K. The
subsampled track centerline (~50 points) is read from global memory inside
a `fori_loop`; every thread of a program reads the same address, so it
stays in L1. The nearest-point sweep tracks only the argmin index and
gathers the neighbours once after the sweep. Nothing carries between
programs.

Physics parameters and the track are static per environment and baked in
at trace time; the initial state is the only dynamic scalar input.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from mpopis_tpu.models.car_racing import CarParams

_G = 9.81

# Samples per program, one per thread (num_warps = block / 32). On the H100
# (scripts/ab_car_kernel.py) blocks of 32, 64 and 128 samples tie in the
# policy step at K=150 and K=8192; two or four samples per thread (fewer
# warps) ran the rollout 1.4-4x slower.
DEFAULT_BLOCK = 32

# rows of the packed track table
_TX, _TY, _TW, _TC, _TX2, _TY2 = range(6)


def _tire_fy_sc(sin_num, cos_num, vx, y_num, mu, c_a, fz, fx):
    """Brush tire lateral force from scaled slip-angle components.

    `sin_num = h·sin(α)` and `cos_num = h·cos(α)` for some h > 0, with
    α = atan2(y_num, vx) − δ the (unwrapped) slip angle of the oracle
    (models/car_racing.py::_tire_fy, ref car_racing.jl:252-260). α only
    enters the tire model through tan(α), sign(α), and the test
    |α| < atan(3·fy_max/c_a) — all exactly recoverable from the
    components, which replaces atan2, atan and tan per tire per substep
    with one divide and compares:

    - tan(α) = sin_num / cos_num (quotient identity);
    - |α| < atan(q) ⟺ cos(α) > 0 ∧ |tan(α)| < q, and since the unwrapped
      α ∈ (−π−δmax, π+δmax] never reaches the next cos-positive branch,
      cos_num > 0 decides cos(α) > 0 exactly;
    - sign(α) = sign(sin_num) except when α lies beyond ±π (possible only
      for the front tire when reversing, vx < 0): algebra on
      tan θ = y_num/vx reduces `α > π` to vx<0 ∧ y_num≥0 ∧ sin_num<0 and
      `α < −π` to vx<0 ∧ y_num<0 ∧ sin_num>0.
    """
    fy2 = jnp.maximum((mu * fz) ** 2 - fx * fx, 1e-8)
    inv_fy = jax.lax.rsqrt(fy2)
    fy_max = fy2 * inv_fy
    ta = sin_num / cos_num
    cubic = (
        -c_a * ta
        + ((c_a * c_a) / 3.0) * inv_fy * jnp.abs(ta) * ta
        - ((c_a**3) / 27.0) * (inv_fy * inv_fy) * ta * ta * ta
    )
    sgn = jnp.sign(sin_num)
    rev = vx < 0.0
    sgn = jnp.where(rev & (y_num >= 0.0) & (sin_num < 0.0), 1.0, sgn)
    sgn = jnp.where(rev & (y_num < 0.0) & (sin_num > 0.0), -1.0, sgn)
    sat = -fy_max * sgn
    in_range = (cos_num > 0.0) & (jnp.abs(ta) * c_a < 3.0 * fy_max)
    return jnp.where(in_range, cubic, sat)


def _make_kernel(p: CarParams, n_sub: int, dt: float, ddt: float,
                 m_track: int, num_cars: int):
    """Build the kernel body with physics constants baked in."""
    ll = p.l_r + p.l_f

    def kernel(state0_ref, track_ref, controls_ref, costs_ref):
        horizon = controls_ref.shape[0]
        block = costs_ref.shape[0]

        def full(v):
            return jnp.full((block,), v, dtype=jnp.float32)

        def track_dist(x, y):
            """(within, dist) per sample; ref car_racing_tracks.jl:64-92."""

            def sweep(m, carry):
                min_d2, best = carry
                # squared distance up to the per-sample constant x²+y²:
                # c_m − 2pₓx − 2pᵧy; the argmin is offset-invariant
                d2 = (track_ref[_TC, m] - track_ref[_TX2, m] * x
                      - track_ref[_TY2, m] * y)
                better = d2 < min_d2  # strict: the first minimum wins
                return jnp.where(better, d2, min_d2), jnp.where(better, m, best)

            _, best = jax.lax.fori_loop(
                jnp.int32(0), jnp.int32(m_track), sweep,
                (full(3.4e38), jnp.zeros((block,), jnp.int32)),
            )
            prev = jnp.where(best == 0, m_track - 1, best - 1)
            nxt = jnp.where(best == m_track - 1, 0, best + 1)
            bx = track_ref[_TX, best]
            by = track_ref[_TY, best]
            bpx = track_ref[_TX, prev]
            bpy = track_ref[_TY, prev]
            bnx = track_ref[_TX, nxt]
            bny = track_ref[_TY, nxt]
            d_prev2 = (bpx - x) ** 2 + (bpy - y) ** 2
            d_next2 = (bnx - x) ** 2 + (bny - y) ** 2
            use_prev = d_prev2 <= d_next2
            p2x = jnp.where(use_prev, bpx, bnx)
            p2y = jnp.where(use_prev, bpy, bny)
            segx = p2x - bx
            segy = p2y - by
            seg2 = segx * segx + segy * segy
            t_par = ((x - bx) * segx + (y - by) * segy) / seg2
            projx = bx + t_par * segx
            projy = by + t_par * segy
            dist = jnp.sqrt((projx - x) ** 2 + (projy - y) ** 2)
            return dist < track_ref[_TW, best], dist

        def car_reward(car):
            """Per-car reward (ref car_racing.jl:201-213)."""
            x, y, _sin_p, _cos_p, vx, vy, _psid, _delta = car
            within, dist = track_dist(x, y)
            beta = jnp.arctan2(vy, vx)
            rew = jnp.where(within, 0.0, -1000000.0)
            rew = rew + jnp.where(jnp.abs(beta) > p.beta_limit, -5000.0, 0.0)
            rew = rew - dist
            rew = rew + 2.0 * jnp.sqrt(vx * vx + vy * vy)
            return rew

        def advance_car(car, steer, pedal):
            """One dt action step = n_sub Euler substeps (car_racing.jl:282-344).

            Carries (sin ψ, cos ψ) instead of ψ — the heading only ever enters
            the dynamics through its sin/cos (position update; the wrap at
            ref :330-332 is sin/cos-invariant), so ψ is advanced as a small-
            angle rotation (4th-order sin/cos of ψ̇·δt, renormalized once per
            action step) and δ's sin/cos by composing a per-action-step
            constant rotation (δ̇ is constant within the step, ref :295-296),
            replacing four transcendentals per substep with a few
            multiply-adds.
            """
            x, y, sin_p, cos_p, vx, vy, psid, delta = car
            target = steer * p.delta_max
            commanded = jnp.abs(target - delta) / dt
            ddelta = jnp.minimum(commanded, p.delta_dot_max) * jnp.sign(
                target - delta
            )
            lam = jnp.where(pedal <= 0.0, p.lambda_brake, p.lambda_drive)
            accel = p.fx_max * jnp.maximum(pedal, 0.0)

            # δ rotation increment for this action step (trig once)
            d_step = ddelta * ddt
            sin_e = jnp.sin(d_step)
            cos_e = jnp.cos(d_step)
            sin_d = jnp.sin(delta)
            cos_d = jnp.cos(delta)

            for _ in range(n_sub):
                delta = delta + d_step
                sin_d, cos_d = (
                    sin_d * cos_e + cos_d * sin_e,
                    cos_d * cos_e - sin_d * sin_e,
                )
                # slip angles as scaled sin/cos components (see _tire_fy_sc):
                # front α_f = atan2(y_f, vx) − δ via the angle-difference
                # identity; rear α_r = atan2(y_r, vx) directly.
                y_f = vy + p.l_f * psid
                y_r = vy - p.l_r * psid
                sin_f = y_f * cos_d - vx * sin_d
                cos_f = vx * cos_d + y_f * sin_d
                fx_aero = (p.c_d0 + p.c_d1 * jnp.abs(vx)) * jnp.sign(vx)
                brake = p.fx_min * jnp.minimum(pedal, 0.0) * jnp.sign(vx)
                fx = accel + brake
                fxf = lam * fx
                fxr = (1.0 - lam) * fx
                fzf = (p.m * p.l_r * _G - p.h_cm * fx) * (1.0 / ll)
                fzr = (p.m * p.l_f * _G + p.h_cm * fx) * (1.0 / ll)
                fyf = _tire_fy_sc(sin_f, cos_f, vx, y_f, p.mu_f, p.c_af, fzf, fxf)
                fyr = _tire_fy_sc(y_r, vx, vx, y_r, p.mu_r, p.c_ar, fzr, fxr)
                psidd = (p.l_f * (fxf * sin_d + fyf * cos_d) - p.l_r * fyr) * (
                    1.0 / p.i_zz
                )
                vy_dot = (fyf * cos_d + fxf * sin_d + fyr) * (1.0 / p.m) - psid * vx
                vx_dot = (fxf * cos_d - fyf * sin_d + fxr - fx_aero) * (
                    1.0 / p.m
                ) + psid * vy
                psid = psid + psidd * ddt
                vx = vx + vx_dot * ddt
                vy = vy + vy_dot * ddt
                # rotate (sin ψ, cos ψ) by the small angle ψ̇·δt (|dψ|≲0.05:
                # the 4th-order series is below f32 rounding of sin/cos)
                dp = psid * ddt
                dp2 = dp * dp
                sin_q = dp * (1.0 - dp2 * (1.0 / 6.0))
                cos_q = 1.0 - dp2 * (0.5 - dp2 * (1.0 / 24.0))
                sin_p, cos_p = (
                    sin_p * cos_q + cos_p * sin_q,
                    cos_p * cos_q - sin_p * sin_q,
                )
                x = x + (vx * cos_p - vy * sin_p) * ddt
                y = y + (vx * sin_p + vy * cos_p) * ddt
            # renormalize the heading rotation once per action step
            inv_n = jax.lax.rsqrt(sin_p * sin_p + cos_p * cos_p)
            return (x, y, sin_p * inv_n, cos_p * inv_n, vx, vy, psid, delta)

        def action_step(t, carry):
            cars, cost = carry
            new_cars = tuple(
                advance_car(
                    cars[ci],
                    controls_ref[t, 2 * ci, :],
                    controls_ref[t, 2 * ci + 1, :],
                )
                for ci in range(num_cars)
            )
            rew = full(0.0)
            for ci in range(num_cars):
                rew = rew + car_reward(new_cars[ci])
            # joint terms: pairwise distance + collision (multi-car_racing.jl:145-158)
            for i in range(num_cars):
                for j in range(i + 1, num_cars):
                    dx = new_cars[i][0] - new_cars[j][0]
                    dy = new_cars[i][1] - new_cars[j][1]
                    dd = jnp.sqrt(dx * dx + dy * dy + 1e-30)
                    rew = rew - dd
                    rew = rew - jnp.where(dd <= 4.0, 11000.0, 0.0)
            return new_cars, cost - rew

        def car0(ci):
            s = [state0_ref[8 * ci + j] for j in range(8)]
            x, y, psi, vx, vy, psid, delta = s[:7]
            return tuple(full(v) for v in (
                x, y, jnp.sin(psi), jnp.cos(psi), vx, vy, psid, delta
            ))

        cars0 = tuple(car0(ci) for ci in range(num_cars))
        _, cost = jax.lax.fori_loop(
            jnp.int32(0), jnp.int32(horizon), action_step, (cars0, full(0.0))
        )
        costs_ref[:] = cost

    return kernel


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.partial(
    jax.jit,
    static_argnames=(
        "params", "track", "dt", "ddt", "num_cars", "block", "interpret",
    ),
)
def _car_rollout_costs_impl(
    params: CarParams,
    track: tuple,  # ((xs...), (ys...), (widths...)) — hashable for jit
    dt: float,
    ddt: float,
    state0_x: jnp.ndarray,
    controls_tak: jnp.ndarray,  # (T, na, K)
    num_cars: int,
    block: int,
    interpret: bool,
) -> jnp.ndarray:
    horizon, na, k = controls_tak.shape
    n_sub = int(round(dt / ddt))
    xs, ys, ws = (np.asarray(a, dtype=np.float64) for a in track)
    track_tab = np.stack([xs, ys, ws, xs * xs + ys * ys, 2.0 * xs, 2.0 * ys])
    m_track = track_tab.shape[1]

    k_pad = _round_up(k, block)
    ctrl = controls_tak.astype(jnp.float32)
    if k_pad != k:
        ctrl = jnp.pad(ctrl, ((0, 0), (0, 0), (0, k_pad - k)))
    state0 = state0_x[: 8 * num_cars].astype(jnp.float32)

    kernel = _make_kernel(params, n_sub, dt, ddt, m_track, num_cars)
    costs = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((k_pad,), jnp.float32),
        grid=(k_pad // block,),
        in_specs=[
            pl.BlockSpec((8 * num_cars,), lambda i: (0,)),
            pl.BlockSpec((6, m_track), lambda i: (0, 0)),
            pl.BlockSpec((horizon, na, block), lambda i: (0, 0, i)),
        ],
        out_specs=pl.BlockSpec((block,), lambda i: (i,)),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=max(block // 32, 1), num_stages=1
        ),
        interpret=interpret,
        name="car_rollout",
    )(state0, jnp.asarray(track_tab, dtype=jnp.float32), ctrl)
    return costs[:k]


def car_rollout_costs(
    env,
    state0_x: jnp.ndarray,
    controls_tak: jnp.ndarray,  # (T, 2*num_cars, K), already clamped
    block: int | None = None,
    interpret: bool = False,
) -> jnp.ndarray:
    """Fused rollout for CarRacingEnv / MultiCarRacingEnv: (K,) trajectory
    costs Σ_t -reward(s_t), the same costs as `rollout_batch` (the vmap path
    is the correctness oracle; see tests/test_kernels.py). Controls come in
    the kernel's (T, na, K) layout — a flat (cs, K) candidate matrix
    reshapes to it for free. `block` samples per program (default
    `DEFAULT_BLOCK`, one per thread) must be a power of two."""
    if block is None:
        block = DEFAULT_BLOCK
    if block <= 0 or block & (block - 1):
        raise ValueError(f"block must be a power of two, got {block}")
    track = env.track
    costs = _car_rollout_costs_impl(
        env.params,
        (tuple(track.xs.tolist()), tuple(track.ys.tolist()),
         tuple(track.lane_width_s.tolist())),
        env.dt,
        env.ddt,
        state0_x,
        controls_tak,
        getattr(env, "num_cars", 1),
        block,
        interpret,
    )
    return costs.astype(env.dtype)
