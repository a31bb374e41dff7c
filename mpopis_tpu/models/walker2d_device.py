"""On-device (pure-JAX) Walker2d-v4 — MuJoCo-exact dynamics WITH contacts.

Instantiates the generic planar-contact pipeline
(models/planar_contact.py) for walker2d.xml: 9-DoF planar tree (root
x/z/y + two thigh/leg/foot chains hinging about −y, the left chain
duplicating the right), plane-capsule contacts with sigmoid solimp
(0.9, 0.95, 0.001), no margin, per-geom friction max-combined with the
floor's 0.7 (⇒ 0.9 everywhere except foot_left's 1.9), and
mj_RungeKutta (RK4) integration. Body geoms have conaffinity=0, so there
is NO capsule-capsule self-collision (unlike Hopper). Every constant
below was probed from the compiled MjModel (scripts/probe_planar.py) and
the dynamics are pinned against mj_forward/mj_step in
tests/test_walker2d_device.py.

Obs/reward follow walker2d_v4.py and the host engine
(native/envpool_lite.cc kWalker2d): obs = [qpos[1:], clip(qvel, ±10)],
reward = 1.0 (healthy) + (x'−x)/dt − 1e-3·Σa². Like the reference's
envpool rollouts (src/envs/envpool_env.jl:35-61), the rollout engine
does not terminate episodes.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from mpopis_tpu.models.base import Env, EnvState, make_state
from mpopis_tpu.models.planar_contact import (
    PCBody,
    PCContact,
    PCLimit,
    PlanarContactModel,
    build_contact_stepper,
)

_H = 0.002
_FRAME_SKIP = 4
_GEAR = (100.0,) * 6  # dofs 3..8

# right chain: thigh(1) → leg(2) → foot(3); left chain duplicates as
# bodies 4..6 off the torso. Leg/foot joints are anchored off the body
# origin (leg at (0, 0.25), foot at (−0.2, 0.1)) and hinge about −y.
_BODIES = (
    PCBody(parent=-1, pos=(0.0, 0.0), anchor=(0.0, 0.0), sign=1.0,
           com=(0.0, 0.0), mass=3.6651914291880923,
           iyy=0.069245938072875, dof=2),  # torso
    PCBody(parent=0, pos=(0.0, -0.19999999999999996), anchor=(0.0, 0.0),
           sign=-1.0, com=(0.0, -0.2250000000000001),
           mass=4.057890510886818, iyy=0.09329875682692194, dof=3),
    PCBody(parent=1, pos=(0.0, -0.7000000000000001), anchor=(0.0, 0.25),
           sign=-1.0, com=(0.0, 0.0),
           mass=2.7813566959781637, iyy=0.07230254017320971, dof=4),
    PCBody(parent=2, pos=(0.2, -0.35), anchor=(-0.2, 0.1), sign=-1.0,
           com=(-0.1, 0.1), mass=3.1667253948185117,
           iyy=0.02399774663482943, dof=5),
    PCBody(parent=0, pos=(0.0, -0.19999999999999996), anchor=(0.0, 0.0),
           sign=-1.0, com=(0.0, -0.2250000000000001),
           mass=4.057890510886818, iyy=0.09329875682692194, dof=6),
    PCBody(parent=4, pos=(0.0, -0.7000000000000001), anchor=(0.0, 0.25),
           sign=-1.0, com=(0.0, 0.0),
           mass=2.7813566959781637, iyy=0.07230254017320971, dof=7),
    PCBody(parent=5, pos=(0.2, -0.35), anchor=(-0.2, 0.1), sign=-1.0,
           com=(-0.1, 0.1), mass=3.1667253948185117,
           iyy=0.02399774663482943, dof=8),
)

_CON_SOLIMP = (0.9, 0.95, 0.001)
# (body, local(x,z), radius, mu): capsule end spheres; μ max-combined
# with the floor's 0.7 (foot_left geom is 1.9, everything else 0.9)
_CAPSULES = (
    (0, (0.0, 0.19999999999999996), 0.05, 0.9),
    (0, (0.0, -0.19999999999999996), 0.05, 0.9),
    (1, (0.0, -5.551115123125783e-17), 0.05, 0.9),
    (1, (0.0, -0.4500000000000001), 0.05, 0.9),
    (2, (0.0, 0.25), 0.04, 0.9),
    (2, (0.0, -0.25), 0.04, 0.9),
    (3, (-0.2, 0.10000000000000003), 0.06, 0.9),
    (3, (0.0, 0.09999999999999998), 0.06, 0.9),
    (4, (0.0, -5.551115123125783e-17), 0.05, 0.9),
    (4, (0.0, -0.4500000000000001), 0.05, 0.9),
    (5, (0.0, 0.25), 0.04, 0.9),
    (5, (0.0, -0.25), 0.04, 0.9),
    (6, (-0.2, 0.10000000000000003), 0.06, 1.9),
    (6, (0.0, 0.09999999999999998), 0.06, 1.9),
)

_LIM_SOLIMP = (0.9, 0.95, 0.001)
_LIMITS = (
    (3, -2.6179938779914944, 0.0),
    (4, -2.6179938779914944, 0.0),
    (5, -0.7853981633974483, 0.7853981633974483),
    (6, -2.6179938779914944, 0.0),
    (7, -2.6179938779914944, 0.0),
    (8, -0.7853981633974483, 0.7853981633974483),
)

_DOF_INVWEIGHT0 = (
    0.20743031034355516, 0.04851918372605742, 6.0249121053811585,
    12.106152843486317, 9.595294937183608, 18.21142212360485,
    12.106152843486317, 9.595294937183608, 18.21142212360485,
)
_BODY_INVWEIGHT0 = (
    0.0853164980232042, 0.06051637875212593, 0.06299719488697496,
    0.13474576502547686, 0.06051637875212593, 0.06299719488697496,
    0.13474576502547686,
)

MODEL = PlanarContactModel(
    n_dof=9,
    root_offset=(0.0, 0.0),  # rootz ref=1.25 ⇒ torso z = q1 (qpos0[1]=1.25)
    bodies=_BODIES,
    contacts=tuple(
        PCContact(body=b, local=loc, radius=r, mu=mu, margin=0.0,
                  solimp=_CON_SOLIMP)
        for (b, loc, r, mu) in _CAPSULES
    ),
    limits=tuple(
        PCLimit(dof=d, lo=lo, hi=hi, solimp=_LIM_SOLIMP)
        for (d, lo, hi) in _LIMITS
    ),
    damping=(0.0, 0.0, 0.0) + (0.1,) * 6,
    armature=(0.0, 0.0, 0.0) + (0.01,) * 6,
    stiffness=(0.0,) * 9,
    gear=_GEAR,
    dof_invweight0=_DOF_INVWEIGHT0,
    body_invweight0=_BODY_INVWEIGHT0,
    timestep=_H,
    integrator="rk4",
)

_substep, _mass_entries, _bias, _qfrc_smooth, _qacc = (
    build_contact_stepper(MODEL)
)

_INIT_QPOS = (0.0, 1.25) + (0.0,) * 7


@dataclasses.dataclass(frozen=True, eq=False)
class Walker2dDeviceEnv(Env):
    """gymnasium Walker2d-v4 with on-device dynamics (incl. contacts).

    State x = [qpos(9), qvel(9)]; action = 6 joint torques ∈ [−1, 1]
    scaled by gear 100. solver_outer/solver_cg as in CheetahDeviceEnv:
    (3, 6) is control-grade (λ warm-starts chain across the RK4 stages
    and substeps — ~1e-10 from the converged solve on realistic
    trajectories), (6, 40) mj_step-parity grade.
    """

    solver_outer: int = 3
    solver_cg: int = 6

    state_dim = 18
    action_dim = 6
    action_low = np.array([-1.0] * 6)
    action_high = np.array([1.0] * 6)

    @property
    def dt(self) -> float:
        return _H * _FRAME_SKIP

    def reset(self, key: jax.Array | None = None) -> EnvState:
        x = jnp.concatenate([
            jnp.asarray(_INIT_QPOS, dtype=self.dtype),
            jnp.zeros((9,), dtype=self.dtype),
        ])
        return make_state(x)

    def step(self, state: EnvState, action: jnp.ndarray) -> EnvState:
        a = jnp.clip(action, -1.0, 1.0)
        zero = jnp.zeros_like(state.x[0])
        tau = (zero, zero, zero) + tuple(
            _GEAR[i] * a[i] for i in range(6)
        )
        q = tuple(state.x[i] for i in range(9))
        qv = tuple(state.x[9 + i] for i in range(9))
        lam = jnp.zeros((MODEL.n_rows,) + jnp.shape(state.x[0]),
                        dtype=state.x.dtype)

        def sub(carry, _):
            qq, vv, ll = carry
            return _substep(
                qq, vv, tau, self.solver_outer, self.solver_cg, ll
            ), None

        (q, qv, _), _ = jax.lax.scan(sub, (q, qv, lam), None, length=_FRAME_SKIP)
        x = jnp.stack(q + qv).astype(self.dtype)
        return EnvState(x=x, t=state.t + 1, done=state.done)

    def step_reward(self, state: EnvState, action: jnp.ndarray):
        new = self.step(state, action)
        x_vel = (new.x[0] - state.x[0]) / self.dt
        # walker2d_v4.py: healthy 1.0 + forward − 1e-3·Σa² (host-engine
        # parity: native/envpool_lite.cc kWalker2d)
        r = 1.0 + x_vel - 1e-3 * jnp.sum(action * action)
        return new, r

    def reward(self, state: EnvState) -> jnp.ndarray:
        """Instantaneous healthy + forward velocity (harness accounting)."""
        return 1.0 + state.x[9]

    def observation(self, state: EnvState) -> jnp.ndarray:
        """gym obs: qpos[1:] + clip(qvel, ±10) (17,)."""
        return jnp.concatenate(
            [state.x[1:9], jnp.clip(state.x[9:], -10.0, 10.0)]
        )
