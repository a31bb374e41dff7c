"""Multi-car racing: N cars under joint control, concatenated 8N-dim state
and 2N-dim action, vectorized over the car axis with vmap (the reference
loops over per-car sub-environments, multi-car_racing.jl:200-216).

Joint reward = Σ per-car rewards − Σ pairwise distances − 11000 per
collision (≤ 4 m), multi-car_racing.jl:145-158 (the code's −11000, not the
docstring's −7000). Staggered reset positions: multi-car_racing.jl:160-180.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from mpopis_tpu.models.base import Env, EnvState, make_state
from mpopis_tpu.models.car_racing import CarParams, car_reward, step_car_state
from mpopis_tpu.models.track import Track, distance_query


@dataclasses.dataclass(frozen=True, eq=False)
class MultiCarRacingEnv(Env):
    num_cars: int = 2
    params: CarParams = CarParams()
    dt: float = 0.1
    ddt: float = 0.01
    track: Track = None  # type: ignore[assignment]
    track_name: str = "curve"
    track_width: float = 15.0
    track_sample_factor: int = 20
    fused_interpret: bool = False  # run the kernel in the Pallas interpreter (tests)

    has_fused_kernel = True

    action_low = None  # set in __post_init__
    action_high = None

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
        object.__setattr__(self, "action_low", np.tile([-1.0, -1.0], self.num_cars))
        object.__setattr__(self, "action_high", np.tile([1.0, 1.0], self.num_cars))

    @property
    def state_dim(self) -> int:
        return 8 * self.num_cars

    @property
    def action_dim(self) -> int:
        return 2 * self.num_cars

    # ------------------------------------------------------------------
    def reset(self, key: jax.Array | None = None) -> EnvState:
        n = self.num_cars
        cars = np.zeros((n, 8))
        cars[:, 2] = np.deg2rad(90.0)
        cars[:, 3] = 10.0
        for i in range(2, n + 1):  # 1-based car index, ref :166-174
            cars[i - 1, 0] = (i / 2) * 5.0 if i % 2 == 0 else ((1 - i) / 2) * 5.0
        return make_state(jnp.asarray(cars.reshape(-1), dtype=self.dtype))

    def step(self, state: EnvState, action: jnp.ndarray) -> EnvState:
        n = self.num_cars
        cars = state.x.reshape(n, 8)
        acts = action.reshape(n, 2)
        stepped = jax.vmap(
            lambda s, a: step_car_state(self.params, s, a, self.dt, self.ddt, self.dtype)
        )(cars, acts)
        return EnvState(x=stepped.reshape(-1), t=state.t + 1, done=state.done)

    def reward(self, state: EnvState) -> jnp.ndarray:
        n = self.num_cars
        pts, widths = self.track.query_arrays(self.dtype)
        cars = state.x.reshape(n, 8)
        per_car = jax.vmap(lambda s: car_reward(self.params, pts, widths, s))(cars)
        rew = jnp.sum(per_car)
        pos = cars[:, :2]
        diff = pos[:, None, :] - pos[None, :, :]
        dists = jnp.sqrt(jnp.sum(diff * diff, axis=-1) + 1e-30)
        iu = jnp.triu_indices(n, k=1)
        pair = dists[iu]
        rew = rew - jnp.sum(pair)
        rew = rew - 11000.0 * jnp.sum(pair <= 4.0)
        return rew

    def fused_rollout_costs(self, state: EnvState, controls_tak: jnp.ndarray):
        """(T, na, K) clamped controls -> (K,) costs through the Triton
        rollout kernel (kernels/car_rollout.py)."""
        from mpopis_tpu.kernels.car_rollout import car_rollout_costs

        return car_rollout_costs(
            self, state.x, controls_tak, interpret=self.fused_interpret
        )

    # conveniences mirroring reference exports -------------------------
    def within_track(self, state: EnvState):
        pts, widths = self.track.query_arrays(self.dtype)
        cars = state.x.reshape(self.num_cars, 8)
        w, d = jax.vmap(lambda s: distance_query(pts, widths, s[:2]))(cars)
        return jnp.all(w), d

    def betas(self, state: EnvState):
        cars = state.x.reshape(self.num_cars, 8)
        return jnp.arctan2(cars[:, 4], cars[:, 3])

    def exceed_beta(self, state: EnvState):
        return jnp.any(jnp.abs(self.betas(state)) > self.params.beta_limit)
