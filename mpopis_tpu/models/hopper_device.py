"""On-device (pure-JAX) Hopper-v4 — MuJoCo-exact dynamics WITH contacts.

Instantiates the generic planar-contact pipeline
(models/planar_contact.py) for hopper.xml: 6-DoF planar tree (rootx,
rootz, rooty + thigh/leg/foot hinges about −y), plane-capsule contacts
with per-geom friction (foot μ=2.0, others μ=1.0 — MuJoCo max-combines
each geom with the floor's default friction 1.0), contact margin
0.001+0.001, constant-impedance contact solimp (0.8, 0.8, 0.01), sigmoid
limit solimp (0.9, 0.95, 0.001), and mj_RungeKutta (RK4) integration —
the constrained forward dynamics (contact QP included) is evaluated at
all 4 stages. Every constant below was probed from the compiled MjModel
(scripts/probe_planar.py) and the dynamics are pinned against
mj_forward/mj_step in tests/test_hopper_device.py.

The leg joints are anchored OFF the body origin (leg_joint at (0, 0.25),
foot_joint at (−0.13, 0.1) in their body frames) and rotate about −y
(sign −1) — both handled by the generic kinematics.

Obs/reward follow hopper_v4.py and the host engine
(native/envpool_lite.cc kHopper): obs = [qpos[1:], clip(qvel, ±10)],
reward = 1.0 (healthy) + (x'−x)/dt − 1e-3·Σa². Like the reference's
envpool rollouts (src/envs/envpool_env.jl:35-61), the rollout engine does
not terminate episodes — termination is a training-loop concern, not a
dynamics one; the healthy bonus is paid every step as in the host engine.

Reference workload: src/envs/envpool_env.jl:35-61 (the envpool task
registry the reference reaches Hopper through).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from mpopis_tpu.models.base import Env, EnvState, make_state
from mpopis_tpu.models.planar_contact import (
    PCBody,
    PCCapsulePair,
    PCContact,
    PCLimit,
    PlanarContactModel,
    build_contact_stepper,
)

_H = 0.002
_FRAME_SKIP = 4
_GEAR = (200.0, 200.0, 200.0)  # dofs 3..5

# (parent, pos(x,z) in parent, anchor(x,z) in body, sign, com(x,z), mass,
#  body-frame I_yy, dof) — probed from the compiled MjModel
_BODIES = (
    PCBody(parent=-1, pos=(0.0, 0.0), anchor=(0.0, 0.0), sign=1.0,
           com=(0.0, 0.0), mass=3.6651914291880923,
           iyy=0.069245938072875, dof=2),  # torso (rooty about +y)
    PCBody(parent=0, pos=(0.0, -0.19999999999999996), anchor=(0.0, 0.0),
           sign=-1.0, com=(0.0, -0.2250000000000001),
           mass=4.057890510886818, iyy=0.09329875682692194, dof=3),  # thigh
    PCBody(parent=1, pos=(0.0, -0.7000000000000001), anchor=(0.0, 0.25),
           sign=-1.0, com=(0.0, 0.0),
           mass=2.7813566959781637, iyy=0.07230254017320971, dof=4),  # leg
    PCBody(parent=2, pos=(0.13, -0.35), anchor=(-0.13, 0.1), sign=-1.0,
           com=(-0.065, 0.1), mass=5.315574769873931,
           iyy=0.1035230805900054, dof=5),  # foot
)

_CON_SOLIMP = (0.8, 0.8, 0.01)  # constant impedance 0.8
_MARGIN = 0.002  # includemargin = geom margin 0.001 + floor margin 0.001
# (body, local(x,z), radius, mu): capsule end spheres; μ is the
# max-combined contact friction vs the floor (probed)
_CAPSULES = (
    (0, (0.0, 0.19999999999999996), 0.05, 1.0),   # torso top
    (0, (0.0, -0.19999999999999996), 0.05, 1.0),  # torso bottom
    (1, (0.0, -5.551115123125783e-17), 0.05, 1.0),
    (1, (0.0, -0.4500000000000001), 0.05, 1.0),   # thigh
    (2, (0.0, 0.25), 0.04, 1.0),
    (2, (0.0, -0.25), 0.04, 1.0),                 # leg
    (3, (-0.26, 0.10000000000000005), 0.06, 2.0),
    (3, (0.13, 0.09999999999999996), 0.06, 2.0),  # foot
)

# full capsule segments per body (endpoint1, endpoint2, radius) for the
# self-collision pairs
_SEGS = {
    0: ((0.0, 0.19999999999999996), (0.0, -0.19999999999999996), 0.05),
    1: ((0.0, -5.551115123125783e-17), (0.0, -0.4500000000000001), 0.05),
    2: ((0.0, 0.25), (0.0, -0.25), 0.04),
    3: ((-0.26, 0.10000000000000005), (0.13, 0.09999999999999996), 0.06),
}

_LIM_SOLIMP = (0.9, 0.95, 0.001)
_LIMITS = (  # (dof, lo, hi) in radians (compiled jnt_range)
    (3, -2.6179938779914944, 0.0),
    (4, -2.6179938779914944, 0.0),
    (5, -0.7853981633974483, 0.7853981633974483),
)

_DOF_INVWEIGHT0 = (
    0.1909279154706013, 0.06383927369632438, 1.0585064134514297,
    0.9173573040079763, 0.8423092317158408, 0.9000381439194955,
)
_BODY_INVWEIGHT0 = (
    0.08492239638897524, 0.051923310146107036, 0.04959511864425975,
    0.06690271076821869,
)

MODEL = PlanarContactModel(
    n_dof=6,
    root_offset=(0.0, 0.0),  # rootz ref=1.25 ⇒ torso z = q1 (qpos0[1]=1.25)
    bodies=_BODIES,
    contacts=tuple(
        PCContact(body=b, local=loc, radius=r, mu=mu, margin=_MARGIN,
                  solimp=_CON_SOLIMP)
        for (b, loc, r, mu) in _CAPSULES
    ),
    limits=tuple(
        PCLimit(dof=d, lo=lo, hi=hi, solimp=_LIM_SOLIMP)
        for (d, lo, hi) in _LIMITS
    ),
    # capsule-capsule self-collision (contype/conaffinity all 1; MuJoCo
    # excludes same-body and parent-child pairs, leaving these three —
    # the torso↔foot one fires in crumpled random-action states)
    pairs=tuple(
        PCCapsulePair(
            body1=bi1, a1=_SEGS[bi1][0], b1=_SEGS[bi1][1], r1=_SEGS[bi1][2],
            body2=bi2, a2=_SEGS[bi2][0], b2=_SEGS[bi2][1], r2=_SEGS[bi2][2],
            margin=_MARGIN, solimp=_CON_SOLIMP,
        )
        for (bi1, bi2) in ((0, 2), (0, 3), (1, 3))
    ),
    damping=(0.0, 0.0, 0.0, 1.0, 1.0, 1.0),
    armature=(0.0, 0.0, 0.0, 1.0, 1.0, 1.0),
    stiffness=(0.0,) * 6,
    gear=_GEAR,
    dof_invweight0=_DOF_INVWEIGHT0,
    body_invweight0=_BODY_INVWEIGHT0,
    timestep=_H,
    integrator="rk4",
)

_substep, _mass_entries, _bias, _qfrc_smooth, _qacc = (
    build_contact_stepper(MODEL)
)

_INIT_QPOS = (0.0, 1.25, 0.0, 0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True, eq=False)
class HopperDeviceEnv(Env):
    """gymnasium Hopper-v4 with on-device dynamics (incl. contacts).

    State x = [qpos(6), qvel(6)]; action = 3 joint torques ∈ [−1, 1]
    scaled by gear 200. solver_outer/solver_cg as in CheetahDeviceEnv:
    (3, 6) is control-grade (λ warm-starts chain across the RK4 stages
    and substeps — ~1e-10 from the converged solve on realistic
    trajectories), (6, 40) mj_step-parity grade.
    """

    solver_outer: int = 3
    solver_cg: int = 6

    state_dim = 12
    action_dim = 3
    action_low = np.array([-1.0] * 3)
    action_high = np.array([1.0] * 3)

    @property
    def dt(self) -> float:
        return _H * _FRAME_SKIP

    def reset(self, key: jax.Array | None = None) -> EnvState:
        x = jnp.concatenate([
            jnp.asarray(_INIT_QPOS, dtype=self.dtype),
            jnp.zeros((6,), dtype=self.dtype),
        ])
        return make_state(x)

    def step(self, state: EnvState, action: jnp.ndarray) -> EnvState:
        a = jnp.clip(action, -1.0, 1.0)
        zero = jnp.zeros_like(state.x[0])
        tau = (zero, zero, zero) + tuple(
            _GEAR[i] * a[i] for i in range(3)
        )
        q = tuple(state.x[i] for i in range(6))
        qv = tuple(state.x[6 + i] for i in range(6))
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
        # hopper_v4.py: healthy 1.0 + forward − 1e-3·Σa² (host-engine
        # parity: native/envpool_lite.cc kHopper)
        r = 1.0 + x_vel - 1e-3 * jnp.sum(action * action)
        return new, r

    def reward(self, state: EnvState) -> jnp.ndarray:
        """Instantaneous healthy + forward velocity (harness accounting)."""
        return 1.0 + state.x[6]

    def observation(self, state: EnvState) -> jnp.ndarray:
        """gym obs: qpos[1:] + clip(qvel, ±10) (11,)."""
        return jnp.concatenate(
            [state.x[1:6], jnp.clip(state.x[6:], -10.0, 10.0)]
        )
