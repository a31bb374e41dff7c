"""On-device (pure-JAX) Pusher-v4 — MuJoCo-exact spatial dynamics WITH contacts.

The reference reaches Pusher through envpool (src/envs/envpool_env.jl:35-61);
here it instantiates the generic spatial-contact pipeline
(models/spatial_contact.py). Pusher is structurally unlike the locomotion
tasks: ZERO gravity, a 7-hinge arm plus a free-sliding object and goal
(nq = nv = 11, no quaternions), the Euler integrator with implicit joint
damping, and THREE contact families —

- fingertip capsule ends vs the table plane at z = -0.325 (6 candidates,
  condim 1 => a single frictionless normal row each),
- fingertip capsules vs the object's upright cylinder (3 analytic
  capsule-cylinder pairs, condim 1 — the actual pushing interaction),
- the object cylinder vs the table: its body has only x/y slide dofs, so
  the row Jacobian is identically zero and the rows are dynamically inert
  (probed — MuJoCo creates them but they contribute no force; skipped).

11 joint-limit rows + 6 + 3 = 20 QP rows. Every constant below was
emitted by scripts/probe_spatial.py from the compiled MjModel (the
gymnasium `pusher.xml` under the installed mujoco — gymnasium.make
refuses Pusher-v4 on mujoco>=3, Farama #950, so the parity oracle is the
native host engine stepping the same XML) and is pinned against it in
tests/test_pusher_device.py.

Obs/reward follow gymnasium pusher_v4.py: obs = [qpos[:7], qvel[:7],
xpos(tips_arm), xpos(object), xpos(goal)] (23,); reward =
-dist(object, goal) - 0.1*||a||^2 - 0.5*dist(object, tips_arm) with the
distances read from data.xpos BEFORE the step — which at that point holds
the kinematics of the PENULTIMATE substep of the PREVIOUS control step
(Euler mj_step runs no forward pass after integrating), so the env state
carries those stale xpos values alongside qpos/qvel, exactly like the
RK4 tasks carry the stage-4 torso x (ant_device.py:16-23).

Layout: scalar/SoA over tuples; the QP state is (20, K) with K minor.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from mpopis_tpu.models.base import Env, EnvState, make_state
from mpopis_tpu.models.spatial_contact import (
    SCBody,
    SCContact,
    SCLimit,
    SCPairCylinder,
    SJoint,
    SpatialContactModel,
    build_spatial_stepper,
    frames,
)

_H = 0.01
_FRAME_SKIP = 5

# === Pusher-v4 ===
# timestep=0.01 integrator=0 (0=Euler 1=RK4) gravity=0.0 cone=0
# frame_skip=5 nq=11 nv=11 nu=7 nbody=13
# qpos0 = zeros(11)
_BODIES = (  # parent, pos, quat, joints, com(ipos), mass, inertia(full body-frame 6)
    # r_shoulder_pan_link
    (-1, (0.0, -0.6, 0.0), (1.0, 0.0, 0.0, 0.0), (SJoint(kind='hinge', dof=0, qadr=0, axis=(0.0, 0.0, 1.0), anchor=(0.0, 0.0, 0.0)),), (0.0, 0.0029910406616126804, -0.08428669882839421), 7.293521504574065, (0.36437053959404203, -2.0994170859380347e-19, 9.17394969821784e-18, 0.36447600218823506, -0.006201776703614731, 0.03628453502376305)),
    # r_shoulder_lift_link
    (0, (0.1, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0), (SJoint(kind='hinge', dof=1, qadr=1, axis=(0.0, 1.0, 0.0), anchor=(0.0, 0.0, 0.0)),), (0.0, 0.0, 0.0), 3.141592653589794, (0.03801327110843651, 0.0, 0.0, 0.014451326206513054, 5.23180274701295e-18, 0.03801327110843651)),
    # r_upper_arm_roll_link
    (1, (0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0), (SJoint(kind='hinge', dof=2, qadr=2, axis=(1.0, 0.0, 0.0), anchor=(0.0, 0.0, 0.0)),), (0.0, 0.0, 0.0), 0.08545132017764237, (1.6688140175868983e-05, 0.0, 7.980243123443751e-20, 0.00037608633974654137, 0.0, 0.00037608633974654137)),
    # r_upper_arm_link
    (2, (0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0), (), (0.2, 0.0, 0.0), 1.6286016316209488, (0.002833766839020451, 0.0, 6.700055869934662e-18, 0.0330081359582197, 0.0, 0.0330081359582197)),
    # r_elbow_flex_link
    (3, (0.4, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0), (SJoint(kind='hinge', dof=3, qadr=3, axis=(0.0, 1.0, 0.0), anchor=(0.0, 0.0, 0.0)),), (0.0, 0.0, 0.0), 0.4071504079052372, (0.0008839687744964818, 0.0, 0.0, 0.0006351546363321701, 5.524783700845674e-20, 0.0008839687744964818)),
    # r_forearm_roll_link
    (4, (0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0), (SJoint(kind='hinge', dof=4, qadr=4, axis=(1.0, 0.0, 0.0), anchor=(0.0, 0.0, 0.0)),), (0.0, 0.0, 0.0), 0.08545132017764237, (1.6688140175868983e-05, 0.0, 7.980243123443751e-20, 0.00037608633974654137, 0.0, 0.00037608633974654137)),
    # r_forearm_link
    (5, (0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0), (), (0.1455, 0.0, 0.0), 0.8427322293254622, (0.0010141453784869555, 0.0, 1.907902042578994e-18, 0.00960657230650512, 0.0, 0.00960657230650512)),
    # r_wrist_flex_link
    (6, (0.321, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0), (SJoint(kind='hinge', dof=5, qadr=5, axis=(0.0, 1.0, 0.0), anchor=(0.0, 0.0, 0.0)),), (0.0, 0.0, 0.0), 0.00502654824574367, (1.338318470429252e-06, 0.0, 0.0, 2.3876104167282434e-07, 2.4415079486060425e-22, 1.338318470429252e-06)),
    # r_wrist_roll_link
    (7, (0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0), (SJoint(kind='hinge', dof=6, qadr=6, axis=(1.0, 0.0, 0.0), anchor=(0.0, 0.0, 0.0)),), (0.026388888888888896, 0.0, 0.0), 0.1809557368467721, (0.0013494271420523532, 3.595596199585537e-18, -4.217459900323825e-18, 0.0002683702033670592, 7.150818693634657e-19, 0.001582812569629036)),
    # tips_arm
    (8, (0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0), (), (0.09999999999999999, 0.0, 0.0), 0.002513274122871835, (2.5233272193633227e-05, 0.0, 0.0, 1.0053096491487366e-07, -3.348353758088292e-20, 2.5233272193633295e-05)),
    # object (two slide joints: y first, then x — the XML order)
    (-1, (0.45, -0.05, -0.275), (1.0, 0.0, 0.0, 0.0), (SJoint(kind='slide', dof=7, qadr=7, axis=(0.0, 1.0, 0.0), anchor=(0.0, 0.0, 0.0)), SJoint(kind='slide', dof=8, qadr=8, axis=(1.0, 0.0, 0.0), anchor=(0.0, 0.0, 0.0)),), (0.0, 0.0, 0.0), 1.3089969389957475e-08, (1.668971097219578e-11, 0.0, 0.0, 1.668971097219578e-11, 0.0, 1.5053464798451097e-11)),
    # goal
    (-1, (0.45, -0.05, -0.323), (1.0, 0.0, 0.0, 0.0), (SJoint(kind='slide', dof=9, qadr=9, axis=(0.0, 1.0, 0.0), anchor=(0.0, 0.0, 0.0)), SJoint(kind='slide', dof=10, qadr=10, axis=(1.0, 0.0, 0.0), anchor=(0.0, 0.0, 0.0)),), (0.0, 0.0, 0.0), 4.021238596594936e-10, (6.435322167417429e-13, 0.0, 0.0, 6.435322167417429e-13, 0.0, 1.2867963509103798e-12)),
)
_FLOOR_Z = -0.325
_CONTACTS = (  # body(0-based), local center, radius, mu, includemargin, solimp, capsule axis_local, condim
    # fingertip capsule ends vs the table plane (3 capsules x 2 ends)
    (8, (0.0, -0.1, 2.2204460492503132e-17), 0.02, 0.8, 0.004, (0.9, 0.95, 0.001), (0.0, -1.0, 2.220446049250313e-16), 1),
    (8, (0.0, 0.1, -2.2204460492503132e-17), 0.02, 0.8, 0.004, (0.9, 0.95, 0.001), (0.0, -1.0, 2.220446049250313e-16), 1),
    (8, (0.0, -0.1, 1.1102230246251566e-17), 0.02, 0.8, 0.004, (0.9, 0.95, 0.001), (-1.0, -0.0, 2.220446049250313e-16), 1),
    (8, (0.1, -0.1, -1.1102230246251566e-17), 0.02, 0.8, 0.004, (0.9, 0.95, 0.001), (-1.0, -0.0, 2.220446049250313e-16), 1),
    (8, (0.0, 0.1, 1.1102230246251566e-17), 0.02, 0.8, 0.004, (0.9, 0.95, 0.001), (-1.0, -0.0, 2.220446049250313e-16), 1),
    (8, (0.1, 0.1, -1.1102230246251566e-17), 0.02, 0.8, 0.004, (0.9, 0.95, 0.001), (-1.0, -0.0, 2.220446049250313e-16), 1),
    # the object cylinder vs the plane is omitted: its body has no z/tilt
    # dofs, so J == 0 identically and the rows are dynamically inert
)
_PAIRS = (  # body1, a1, b1, r1, body2, center2, r2, hh2, mu, includemargin, solimp, condim
    (8, (0.0, 0.1, -2.2204460492503132e-17), (0.0, -0.1, 2.2204460492503132e-17), 0.02, 10, (0.0, 0.0, 0.0), 0.05, 0.05, 0.8, 0.004, (0.9, 0.95, 0.001), 1),
    (8, (0.1, -0.1, -1.1102230246251566e-17), (0.0, -0.1, 1.1102230246251566e-17), 0.02, 10, (0.0, 0.0, 0.0), 0.05, 0.05, 0.8, 0.004, (0.9, 0.95, 0.001), 1),
    (8, (0.1, 0.1, -1.1102230246251566e-17), (0.0, 0.1, 1.1102230246251566e-17), 0.02, 10, (0.0, 0.0, 0.0), 0.05, 0.05, 0.8, 0.004, (0.9, 0.95, 0.001), 1),
)
_LIMITS = (  # dof, lo, hi, solimp, margin
    (0, -2.2854, 1.714602, (0.9, 0.95, 0.001), 0.0),
    (1, -0.5236, 1.3963, (0.9, 0.95, 0.001), 0.0),
    (2, -1.5, 1.7, (0.9, 0.95, 0.001), 0.0),
    (3, -2.3213, 0.0, (0.9, 0.95, 0.001), 0.0),
    (4, -1.5, 1.5, (0.9, 0.95, 0.001), 0.0),
    (5, -1.094, 0.0, (0.9, 0.95, 0.001), 0.0),
    (6, -1.5, 1.5, (0.9, 0.95, 0.001), 0.0),
    (7, -10.3213, 10.3, (0.9, 0.95, 0.001), 0.0),
    (8, -10.3213, 10.3, (0.9, 0.95, 0.001), 0.0),
    (9, -10.3213, 10.3, (0.9, 0.95, 0.001), 0.0),
    (10, -10.3213, 10.3, (0.9, 0.95, 0.001), 0.0),
)
_DAMPING = (1.0, 1.0, 0.1, 0.1, 0.1, 0.1, 0.1, 0.5, 0.5, 0.5, 0.5)
_ARMATURE = (0.04,) * 11
_STIFFNESS = (0.0,) * 11
_SPRINGREF = (0.0,) * 11
_DOF_INVWEIGHT0 = (1.0539426498091766, 2.3631094710931526, 21.7561687466271, 15.467935531072987, 23.67412269693543, 24.770180508653834, 24.216854994363437, 76394372.68410975, 76394372.68410975, 2486795985.810864, 2486795985.810864)
_BODY_INVWEIGHT0 = (3.1429708916490028e-06, 0.003513142166030589, 0.003513142166030589, 0.06312640577551736, 0.21386105927573285, 0.21386105927573285, 0.3168059260304052, 0.6727262724077382, 0.7502106844267026, 1.0548471154413133, 76394372.68410975, 2486795985.810864)
_ACTUATORS = tuple((d, 1.0) for d in range(7))  # gear 1, XML order = dof order

MODEL = SpatialContactModel(
    n_dof=11,
    n_q=11,
    bodies=tuple(
        SCBody(parent=p, pos=pos, quat=quat, joints=joints, com=com,
               mass=mass, inertia=inertia)
        for (p, pos, quat, joints, com, mass, inertia) in _BODIES
    ),
    contacts=tuple(
        SCContact(body=b, local=loc, radius=r, mu=mu, margin=margin,
                  solimp=solimp, axis_local=axis, condim=condim)
        for (b, loc, r, mu, margin, solimp, axis, condim) in _CONTACTS
    ),
    limits=tuple(
        SCLimit(dof=d, lo=lo, hi=hi, solimp=solimp, margin=margin)
        for (d, lo, hi, solimp, margin) in _LIMITS
    ),
    damping=_DAMPING,
    armature=_ARMATURE,
    stiffness=_STIFFNESS,
    springref=_SPRINGREF,
    dof_invweight0=_DOF_INVWEIGHT0,
    body_invweight0=_BODY_INVWEIGHT0,
    timestep=_H,
    integrator="euler_implicit",
    gravity=0.0,
    floor_z=_FLOOR_Z,
    pairs=tuple(
        SCPairCylinder(body1=b1, a1=a1, b1=b1v, r1=r1, body2=b2,
                       center2=c2, r2=r2, hh2=hh2, mu=mu, margin=margin,
                       solimp=solimp, condim=condim)
        for (b1, a1, b1v, r1, b2, c2, r2, hh2, mu, margin, solimp,
             condim) in _PAIRS
    ),
)
assert MODEL.n_rows == 11 + 6 + 3 == 20

_euler_substep, _mass_entries, _bias, _qfrc_smooth_fn, _qacc_constrained = (
    build_spatial_stepper(MODEL)
)

# body indices (0-based) whose xpos feeds obs/reward
_B_TIPS, _B_OBJ, _B_GOAL = 9, 10, 11
# FK of qpos0 (pinned vs mj_forward in tests): xpos after reset
_XPOS0 = (0.821, -0.6, 0.0, 0.45, -0.05, -0.275, 0.45, -0.05, -0.323)


def _xpos9(q):
    """(tips_arm, object, goal) body-frame origins at qpos q — the three
    data.xpos reads of gymnasium pusher_v4 (get_body_com returns the
    frame origin, not the com)."""
    fr = frames(MODEL, q)
    return (
        fr.origin[_B_TIPS] + fr.origin[_B_OBJ] + fr.origin[_B_GOAL]
    )


def _dist3(x, i, j):
    d0 = x[i] - x[j]
    d1 = x[i + 1] - x[j + 1]
    d2 = x[i + 2] - x[j + 2]
    return jnp.sqrt(jnp.maximum(d0 * d0 + d1 * d1 + d2 * d2, 1e-30))


@dataclasses.dataclass(frozen=True, eq=False)
class PusherDeviceEnv(Env):
    """gymnasium Pusher-v4 with on-device spatial dynamics (incl. the
    arm-object contact).

    State x = [qpos(11), qvel(11), xpos_tips(3), xpos_obj(3),
    xpos_goal(3)] (31,); action = 7 arm torques clamped to ctrlrange
    [-2, 2] (gear 1). solver_outer/solver_cg set the contact-QP iteration
    counts: (3, 6) is control-grade with lambda warm-starting across
    substeps, (6, 40) matches mj_step to solver tolerance (the parity
    tests use that setting).
    """

    solver_outer: int = 3
    solver_cg: int = 6

    state_dim = 31
    action_dim = 7
    action_low = np.array([-2.0] * 7)
    action_high = np.array([2.0] * 7)

    @property
    def dt(self) -> float:
        return _H * _FRAME_SKIP

    def reset(self, key: jax.Array | None = None) -> EnvState:
        """Host-engine reset: qpos0 (all zeros), zero velocity. (The
        gymnasium reset randomizes the object/goal xy even at
        reset_noise_scale=0; the batch engines pin them to qpos0 so
        rollout and replay agree — mujoco_host.py resets the same way.)"""
        x = np.zeros((31,))
        x[22:] = _XPOS0
        return make_state(jnp.asarray(x, dtype=self.dtype))

    def _tau(self, action):
        zero = jnp.zeros_like(action[0])
        return tuple(action[i] for i in range(7)) + (zero,) * 4

    def step(self, state: EnvState, action: jnp.ndarray) -> EnvState:
        a = jnp.clip(action, -2.0, 2.0)
        tau = self._tau(a)
        q = tuple(state.x[i] for i in range(11))
        qv = tuple(state.x[11 + i] for i in range(11))
        lam = jnp.zeros((MODEL.n_rows,) + jnp.shape(state.x[0]),
                        dtype=state.x.dtype)

        def sub(carry, _):
            qq, vv, ll, _qpre = carry
            return _euler_substep(
                qq, vv, tau, self.solver_outer, self.solver_cg, ll
            ), None

        (q, qv, _, q_pen), _ = jax.lax.scan(
            sub, (q, qv, lam, q), None, length=_FRAME_SKIP
        )
        # data.xpos after an Euler mj_step holds FK of the substep's
        # PRE-integration qpos => after frame_skip substeps, FK(q_penult)
        xp = tuple(
            jnp.full_like(q[0], e) if isinstance(e, (int, float)) else e
            for e in _xpos9(q_pen)
        )
        x = jnp.stack(q + qv + xp).astype(self.dtype)
        return EnvState(x=x, t=state.t + 1, done=state.done)

    def step_reward(self, state: EnvState, action: jnp.ndarray):
        """pusher_v4.py step(): reward reads data.xpos BEFORE stepping —
        i.e. the xpos snapshot carried in `state` (stale by one substep,
        matching gym/host-engine semantics exactly)."""
        new = self.step(state, action)
        r = (
            -_dist3(state.x, 22 + 3, 22 + 6)          # -|obj - goal|
            - 0.1 * jnp.sum(action * action)           # ctrl cost (raw a)
            - 0.5 * _dist3(state.x, 22 + 3, 22)        # -0.5|obj - tips|
        )
        return new, r

    def reward(self, state: EnvState) -> jnp.ndarray:
        """Instantaneous shaped reward (harness accounting)."""
        return -_dist3(state.x, 25, 28) - 0.5 * _dist3(state.x, 25, 22)

    def observation(self, state: EnvState) -> jnp.ndarray:
        """gym obs: qpos[:7], qvel[:7], xpos(tips/object/goal) (23,)."""
        return jnp.concatenate(
            [state.x[0:7], state.x[11:18], state.x[22:31]]
        )
