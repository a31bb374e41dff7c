"""On-device (pure-JAX) Reacher-v4 — MuJoCo-exact closed-form dynamics.

The host engine (models/mujoco_host.py, the envpool-equivalent subsystem)
steps MuJoCo on CPU, which bounds rollout throughput by host cores. For the
contact-free tasks the full MuJoCo computation reduces to closed form, so
the K×T rollout fan-out can run on-chip like the car models. This module
implements gymnasium's Reacher-v4 (reacher.xml):

- 2-DoF planar arm; mass matrix M(q2) = [[a + 2b·cosq2, I2 + b·cosq2],
  [·, I2 + armature]] with constants probed from mj_fullM (capsule inertias
  + armature=1); Coriolis closed form; joint damping 1; motor gear 200.
- RK4 integrator at h=0.01 (reacher.xml's integrator="RK4"), frame_skip=2.
- joint1's soft limit (range ±3.0) reproduces MuJoCo's constraint model
  exactly: impedance from the solimp sigmoid, aref = −b·v − k·imp·pos with
  k = 1/(dmax·timeconst)²·dampratio⁻², b = 2/(dmax·timeconst), and the
  single-constraint Newton solution λ = max(0, (aref − J·a_smooth)/(A+R)),
  R = (1−imp)/(imp·A), A = J M⁻¹ Jᵀ (verified against mj_forward's
  efc_force on probe states; tests/test_reacher_device.py re-derives every
  constant from the mujoco wheel and pins trajectory equality vs mj_step).

Reward/obs follow reacher_v4.py: reward = −‖fingertip−target‖ − Σa²
computed on the PRE-step state; obs = [cosθ, sinθ, target, θ̇,
fingertip−target]. Reset is deterministic (qpos0: arm at 0, target at
(0.1, −0.1)) matching the batch engine's reset, not gym's randomized one.

Capability context: the reference reaches MuJoCo through envpool's C++
pool (envpool_env.jl:35-61); this is the device-resident equivalent for the
closed-form-able tasks.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from mpopis_tpu.models.base import Env, EnvState, make_state
from mpopis_tpu.models.planar import _kb, impedance

# --- constants probed from reacher.xml via mj_fullM / mjModel (f64) -------
_A = 1.0007051618870246  # M00 constant part (incl. joint0 armature 1.0)
_B = 2.2410027595607144e-04  # cos-coupling inertia term
_I2 = 1.7903936532800e-04  # link-2 inertia about joint1 (no armature)
_ARMATURE = 1.0
_DAMPING = 1.0
_GEAR = 200.0
_H = 0.01  # option timestep
_FRAME_SKIP = 2  # gym Reacher frame_skip
_LIMIT = 3.0  # joint1 range ±3.0
# solref/solimp defaults: shared with the planar toolkit
_KC, _BC = _kb(_H)
_L1, _L2 = 0.1, 0.11  # link0 length, joint1->fingertip
_INVWEIGHT1 = 0.9998211549602818  # mjModel.dof_invweight0[1] (constraint R)
_Z = 0.0  # fingertip and target share z=0.01 -> vec z component is 0


def _qacc(q1, q2, v1, v2, tau1, tau2):
    """Constrained forward dynamics, exactly mj_forward on reacher.xml."""
    cb = _B * jnp.cos(q2)
    sb = _B * jnp.sin(q2)
    m00 = _A + 2.0 * cb
    m01 = _I2 + cb
    m11 = _I2 + _ARMATURE
    det = m00 * m11 - m01 * m01
    c1 = -sb * (2.0 * v1 * v2 + v2 * v2)
    c2 = sb * v1 * v1
    rhs1 = tau1 - c1 - _DAMPING * v1
    rhs2 = tau2 - c2 - _DAMPING * v2
    a1 = (m11 * rhs1 - m01 * rhs2) / det
    a2 = (-m01 * rhs1 + m00 * rhs2) / det

    # joint1 soft limit (single scalar constraint; sign s is the Jacobian)
    d_lo = q2 + _LIMIT
    d_hi = _LIMIT - q2
    lower_closer = d_lo < d_hi
    pos = jnp.where(lower_closer, d_lo, d_hi)
    s = jnp.where(lower_closer, 1.0, -1.0)
    imp = impedance(pos)
    aref = -_BC * (s * v2) - _KC * imp * pos
    a_mat = m00 / det  # J M^-1 J^T for J = ±e2 (true inverse)
    # MuJoCo regularizes with the MODEL CONSTANT dof_invweight0 (the
    # reference-pose inverse-mass diagonal), not the state-dependent
    # J M^-1 J^T (confirmed against efc_R on both reacher and swimmer)
    r_reg = (1.0 - imp) / imp * _INVWEIGHT1
    lam = jnp.maximum(0.0, (aref - s * a2) / (a_mat + r_reg))
    lam = jnp.where(pos < 0.0, lam, 0.0)
    a1 = a1 + (-m01 / det) * (s * lam)
    a2 = a2 + (m00 / det) * (s * lam)
    return a1, a2


def _rk4(q1, q2, v1, v2, tau1, tau2):
    """One mj_RungeKutta step at h=_H (ctrl held fixed).

    Also returns the stage-4 qpos: mj_step leaves data.xpos at the LAST
    RK stage's kinematics (no forward pass after integration), and both
    gymnasium's obs/reward and the batch engine read that stale xpos —
    reproduced here so all three implementations agree bit-for-bit.
    """
    def f(state):
        q1_, q2_, v1_, v2_ = state
        a1, a2 = _qacc(q1_, q2_, v1_, v2_, tau1, tau2)
        return jnp.stack([v1_, v2_, a1, a2])

    y = jnp.stack([q1, q2, v1, v2])
    k1 = f(y)
    k2 = f(y + 0.5 * _H * k1)
    k3 = f(y + 0.5 * _H * k2)
    y4 = y + _H * k3
    k4 = f(y4)
    y = y + (_H / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return y[0], y[1], y[2], y[3], y4[0], y4[1]


def _fingertip(q1, q2):
    c1, s1 = jnp.cos(q1), jnp.sin(q1)
    c12, s12 = jnp.cos(q1 + q2), jnp.sin(q1 + q2)
    return _L1 * c1 + _L2 * c12, _L1 * s1 + _L2 * s12


@dataclasses.dataclass(frozen=True, eq=False)
class ReacherDeviceEnv(Env):
    """gymnasium Reacher-v4 with on-device dynamics.

    State layout x = [q1, q2, q̇1, q̇2, target_x, target_y, fk_q1, fk_q2]
    where (fk_q1, fk_q2) are the stale-kinematics angles (see _rk4); action
    [torque0, torque1] ∈ [−1, 1] (scaled by gear 200 like the motor
    actuators). `reward(state, action)` needs the action because gym's
    reward is computed on the pre-step state with the ctrl penalty.
    """

    target: tuple = (0.1, -0.1)  # qpos0 of the target slides (xml ref=)

    state_dim = 8
    action_dim = 2
    action_low = np.array([-1.0, -1.0])
    action_high = np.array([1.0, 1.0])

    @property
    def dt(self) -> float:
        return _H * _FRAME_SKIP

    def reset(self, key: jax.Array | None = None) -> EnvState:
        # fresh kinematics after reset (mj_forward runs at reset): fk = q
        x = jnp.zeros((8,), dtype=self.dtype)
        x = x.at[4].set(self.target[0])
        x = x.at[5].set(self.target[1])
        return make_state(x)

    def step(self, state: EnvState, action: jnp.ndarray) -> EnvState:
        a = jnp.clip(action, -1.0, 1.0)
        tau1 = _GEAR * a[0]
        tau2 = _GEAR * a[1]
        q1, q2, v1, v2 = state.x[0], state.x[1], state.x[2], state.x[3]
        for _ in range(_FRAME_SKIP):
            q1, q2, v1, v2, fk1, fk2 = _rk4(q1, q2, v1, v2, tau1, tau2)
        x = jnp.stack(
            [q1, q2, v1, v2, state.x[4], state.x[5], fk1, fk2]
        ).astype(self.dtype)
        return EnvState(x=x, t=state.t + 1, done=state.done)

    def step_reward(self, state: EnvState, action: jnp.ndarray):
        """Step + gym-exact reward (pre-step distance + ctrl penalty) in one
        call — used by the rollout layer so MPOPI costs match gym totals."""
        return self.step(state, action), self.reward_pre(state, action)

    def reward_pre(self, state: EnvState, action: jnp.ndarray) -> jnp.ndarray:
        """reacher_v4.py step(): −‖fingertip−target‖ − Σa² on the PRE-step
        state (the distance is measured before do_simulation), through the
        stale kinematics gym reads (fk angles)."""
        fx, fy = _fingertip(state.x[6], state.x[7])
        dx = fx - state.x[4]
        dy = fy - state.x[5]
        dist = jnp.sqrt(dx * dx + dy * dy + _Z)
        return -dist - jnp.sum(action * action)

    def reward(self, state: EnvState) -> jnp.ndarray:
        """Action-independent part (distance) for harness accounting."""
        fx, fy = _fingertip(state.x[6], state.x[7])
        dx = fx - state.x[4]
        dy = fy - state.x[5]
        return -jnp.sqrt(dx * dx + dy * dy + _Z)

    def observation(self, state: EnvState) -> jnp.ndarray:
        """gym obs: [cosθ(2), sinθ(2), target(2), θ̇(2), fingertip−target(3)]."""
        q1, q2 = state.x[0], state.x[1]
        fx, fy = _fingertip(state.x[6], state.x[7])
        return jnp.concatenate(
            [
                jnp.stack([jnp.cos(q1), jnp.cos(q2), jnp.sin(q1), jnp.sin(q2)]),
                state.x[4:6],
                state.x[2:4],
                jnp.stack([fx - state.x[4], fy - state.x[5], jnp.zeros_like(fx)]),
            ]
        )
