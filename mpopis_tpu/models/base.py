"""Environment (dynamics model) protocol.

The reference's environments are mutable objects stepped by side effect
(RLBase protocol: `state`, `reward`, `reset!`, functor `env(a)`, plus
`copy(env)` for per-sample cloning — e.g. car_racing.jl:215-250). The
inversion here: an environment is an immutable parameter object with
pure functions over an explicit `EnvState` value. Per-sample "cloning" is
free (states are values), snapshot/restore is free (keep the old value),
and K-sample rollouts are `vmap` + `lax.scan` — no envpool-style
restore-by-replay (envpool_env.jl:112-125) is ever needed.

Environments are frozen Python dataclasses whose parameters are baked into
the jitted policy step as XLA constants (the fastest layout for control
loops re-run thousands of times with fixed physics).
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar

import jax
import jax.numpy as jnp


def pytree_dataclass(cls):
    """Frozen dataclass registered as a JAX pytree: every field is a leaf
    subtree, flattened in declaration order. `replace(**changes)` returns
    an updated copy."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = dataclasses.replace
    return jax.tree_util.register_dataclass(cls)


@pytree_dataclass
class EnvState:
    """Value-type environment state.

    `x` is the flat state vector (matching the reference's `env.state`),
    `t` the step counter, `done` the termination flag. All reference envs
    are fully observed, so `x` doubles as the observation.
    """

    x: jax.Array  # (state_dim,)
    t: jax.Array  # () int32
    done: jax.Array  # () bool


def make_state(x: jnp.ndarray, t: int = 0, done: bool = False) -> EnvState:
    return EnvState(
        x=jnp.asarray(x),
        t=jnp.asarray(t, dtype=jnp.int32),
        done=jnp.asarray(done, dtype=bool),
    )


@dataclasses.dataclass(frozen=True, eq=False)
class Env:
    """Base environment. Subclasses define physics params as dataclass
    fields and implement `reset`, `step`, `reward`.

    Required class-level/static attributes on subclasses:
      - state_dim, action_dim: int
      - action_low, action_high: (action_dim,) arrays (numpy ok)
    """

    dtype: Any = jnp.float32

    # True on envs that implement `fused_rollout_costs` with a Pallas
    # kernel; such envs make `fused_interpret` a field (tests set it to run
    # the kernel in the Pallas interpreter)
    has_fused_kernel: ClassVar[bool] = False
    fused_interpret: ClassVar[bool] = False

    # --- protocol -----------------------------------------------------
    def reset(self, key: jax.Array | None = None) -> EnvState:
        raise NotImplementedError

    def step(self, state: EnvState, action: jnp.ndarray) -> EnvState:
        raise NotImplementedError

    def reward(self, state: EnvState) -> jnp.ndarray:
        raise NotImplementedError

    def step_reward(self, state: EnvState, action: jnp.ndarray):
        """Step + the reward the driver should account for this action.
        Default: post-step reward(s'). Envs whose reward is a function of
        the PRE-step state and the action (gym Reacher/Swimmer semantics)
        override this so MPOPI costs and harness totals stay gym-exact."""
        s2 = self.step(state, action)
        return s2, self.reward(s2)

    def fused_rollout_costs(self, state: EnvState, controls_tak: jnp.ndarray):
        """(T, action_dim, K) clamped controls -> (K,) trajectory costs
        through the env's fused rollout kernel (envs with
        `has_fused_kernel`); the same costs as `rollout_batch`."""
        raise NotImplementedError

    @property
    def supports_fused_rollout(self) -> bool:
        """The one backend seam for fused rollout kernels: true for an
        env with a kernel, at float32, when JAX's default backend is the
        GPU, or when the env asks for the Pallas interpreter (tests)."""
        return (
            self.has_fused_kernel
            and self.dtype == jnp.float32
            and (
                self.fused_interpret
                or jax.default_backend() == "gpu"
            )
        )

    # --- conveniences ---------------------------------------------------
    @property
    def control_bounds(self):
        """(low, high) each (action_dim,) for candidate-control clamping."""
        return jnp.asarray(self.action_low, dtype=self.dtype), jnp.asarray(
            self.action_high, dtype=self.dtype
        )
