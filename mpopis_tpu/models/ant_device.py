"""On-device (pure-JAX) Ant-v4 — MuJoCo-exact SPATIAL dynamics WITH contacts.

The first 3D task of the on-device family (the reference reaches Ant
through envpool, src/envs/envpool_env.jl:35-61; Ant is the showcase task
of the reference's own gif script, src/envs/make_mujoco_gif.py:8-9).
Instantiates the generic spatial-contact pipeline
(models/spatial_contact.py — where all the probed 3D conventions are
documented): free-joint quaternion root + 8 hinge dofs (nq=15, nv=14),
13 sphere/capsule-end floor-contact candidates with mu=1 pyramidal cones
(4 rows each) + 8 joint-limit rows = 60 QP rows, mj_RungeKutta
integration (4 constrained forward evaluations per 0.01 s substep,
frame_skip 5). Every constant below was emitted by
scripts/probe_spatial.py from the compiled MjModel and is pinned against
it in tests/test_ant_device.py.

Obs/reward follow gymnasium ant_v4.py defaults: obs = [qpos[2:], qvel]
(27), reward = healthy(1.0) + x-velocity - 0.5*ctrl^2 with the
x-positions read from data.xpos of the torso — which after mj_step holds
the LAST RK STAGE's kinematics, not FK(qpos'): the env state therefore
carries the stage-4 torso x alongside qpos/qvel so rewards match the
gymnasium replay bit-for-bit (probed: qpos[0] and xpos[0] differ by
~1e-5 after one step). Like the rest of the on-device family, rollouts
do not terminate: the healthy bonus is paid every step (termination is a
training-loop concern, not a dynamics one — hopper_device.py:21-24).

Layout: scalar/SoA over tuples; the QP state is (60, K) with K minor.
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
    SJoint,
    SpatialContactModel,
    build_spatial_stepper,
)

_H = 0.01
_FRAME_SKIP = 5

# === Ant-v4 ===
# timestep=0.01 integrator=1 (0=Euler 1=RK4) gravity=-9.81 cone=0
# frame_skip=5 nq=15 nv=14 nu=8 nbody=14
# qpos0=[0.0, 0.0, 0.75, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
_BODIES = (  # parent, pos, quat, joints, com(ipos), mass, inertia(full body-frame 6)
    # torso
    (-1, (0.0, 0.0, 0.75), (1.0, 0.0, 0.0, 0.0), (SJoint(kind='free', dof=0, qadr=0, axis=(0.0, 0.0, 1.0), anchor=(0.0, 0.0, 0.0)),), (0.0, 0.0, 0.0), 0.32724923474893675, (0.008181230868723419, 0.0, 0.0, 0.008181230868723419, 0.0, 0.008181230868723419)),
    # front_left_leg
    (0, (0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0), (), (0.1, 0.1, 0.0), 0.03915775372846671, (0.0003432039906261858, -0.00022476209256661435, 1.0387409966673809e-19, 0.0003432039906261858, 1.1059462118807715e-19, 0.0005679660831928)),
    # aux_1
    (1, (0.2, 0.2, 0.0), (1.0, 0.0, 0.0, 0.0), (SJoint(kind='hinge', dof=6, qadr=7, axis=(0.0, 0.0, 1.0), anchor=(0.0, 0.0, 0.0)),), (0.1, 0.1, 0.0), 0.03915775372846671, (0.0003432039906261858, -0.00022476209256661435, 1.0387409966673809e-19, 0.0003432039906261858, 1.1059462118807715e-19, 0.0005679660831928)),
    # None
    (2, (0.2, 0.2, 0.0), (1.0, 0.0, 0.0, 0.0), (SJoint(kind='hinge', dof=7, qadr=8, axis=(-0.7071067811865475, 0.7071067811865475, 0.0), anchor=(0.0, 0.0, 0.0)),), (0.2, 0.2, 0.0), 0.06759220453268026, (0.0014421114003356182, -0.0012326792597025633, 8.743952453758647e-19, 0.0014421114003356182, 8.898316300255301e-19, 0.002674790660038181)),
    # front_right_leg
    (0, (0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0), (), (-0.1, 0.1, 0.0), 0.03915775372846671, (0.0003432039906261858, 0.00022476209256661435, -1.0387409966673809e-19, 0.0003432039906261858, 1.1059462118807715e-19, 0.0005679660831928)),
    # aux_2
    (4, (-0.2, 0.2, 0.0), (1.0, 0.0, 0.0, 0.0), (SJoint(kind='hinge', dof=8, qadr=9, axis=(0.0, 0.0, 1.0), anchor=(0.0, 0.0, 0.0)),), (-0.1, 0.1, 0.0), 0.03915775372846671, (0.0003432039906261858, 0.00022476209256661435, -1.0387409966673809e-19, 0.0003432039906261858, 1.1059462118807715e-19, 0.0005679660831928)),
    # None
    (5, (-0.2, 0.2, 0.0), (1.0, 0.0, 0.0, 0.0), (SJoint(kind='hinge', dof=9, qadr=10, axis=(0.7071067811865475, 0.7071067811865475, 0.0), anchor=(0.0, 0.0, 0.0)),), (-0.2, 0.2, 0.0), 0.06759220453268026, (0.0014421114003356182, 0.0012326792597025633, -8.743952453758647e-19, 0.0014421114003356182, 8.898316300255301e-19, 0.002674790660038181)),
    # back_leg
    (0, (0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0), (), (-0.1, -0.1, 0.0), 0.03915775372846671, (0.0003432039906261858, -0.00022476209256661435, -1.0387409966673809e-19, 0.0003432039906261858, -1.1059462118807715e-19, 0.0005679660831928)),
    # aux_3
    (7, (-0.2, -0.2, 0.0), (1.0, 0.0, 0.0, 0.0), (SJoint(kind='hinge', dof=10, qadr=11, axis=(0.0, 0.0, 1.0), anchor=(0.0, 0.0, 0.0)),), (-0.1, -0.1, 0.0), 0.03915775372846671, (0.0003432039906261858, -0.00022476209256661435, -1.0387409966673809e-19, 0.0003432039906261858, -1.1059462118807715e-19, 0.0005679660831928)),
    # None
    (8, (-0.2, -0.2, 0.0), (1.0, 0.0, 0.0, 0.0), (SJoint(kind='hinge', dof=11, qadr=12, axis=(-0.7071067811865475, 0.7071067811865475, 0.0), anchor=(0.0, 0.0, 0.0)),), (-0.2, -0.2, 0.0), 0.06759220453268026, (0.0014421114003356182, -0.0012326792597025633, -8.743952453758647e-19, 0.0014421114003356182, -8.898316300255301e-19, 0.002674790660038181)),
    # right_back_leg
    (0, (0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0), (), (0.1, -0.1, 0.0), 0.03915775372846671, (0.0003432039906261858, 0.00022476209256661435, 1.0387409966673809e-19, 0.0003432039906261858, -1.1059462118807715e-19, 0.0005679660831928)),
    # aux_4
    (10, (0.2, -0.2, 0.0), (1.0, 0.0, 0.0, 0.0), (SJoint(kind='hinge', dof=12, qadr=13, axis=(0.0, 0.0, 1.0), anchor=(0.0, 0.0, 0.0)),), (0.1, -0.1, 0.0), 0.03915775372846671, (0.0003432039906261858, 0.00022476209256661435, 1.0387409966673809e-19, 0.0003432039906261858, -1.1059462118807715e-19, 0.0005679660831928)),
    # None
    (11, (0.2, -0.2, 0.0), (1.0, 0.0, 0.0, 0.0), (SJoint(kind='hinge', dof=13, qadr=14, axis=(0.7071067811865475, 0.7071067811865475, 0.0), anchor=(0.0, 0.0, 0.0)),), (0.2, -0.2, 0.0), 0.06759220453268026, (0.0014421114003356182, 0.0012326792597025633, 8.743952453758647e-19, 0.0014421114003356182, -8.898316300255301e-19, 0.002674790660038181)),
)
_CONTACTS = (  # body(0-based), local center, radius, mu, includemargin, solimp, capsule axis_local (None=sphere)
    # torso_geom (sphere)
    (0, (0.0, 0.0, 0.0), 0.25, 1.0, 0.02, (0.9, 0.95, 0.001), None),
    # aux_1_geom end +
    (1, (0.0, 0.0, 6.280369834735101e-17), 0.08, 1.0, 0.02, (0.9, 0.95, 0.001), (-0.7071067811865475, -0.7071067811865475, 4.440892098500626e-16)),
    # aux_1_geom end -
    (1, (0.2, 0.2, -6.280369834735101e-17), 0.08, 1.0, 0.02, (0.9, 0.95, 0.001), (-0.7071067811865475, -0.7071067811865475, 4.440892098500626e-16)),
    # left_leg_geom end +
    (2, (0.0, 0.0, 6.280369834735101e-17), 0.08, 1.0, 0.02, (0.9, 0.95, 0.001), (-0.7071067811865475, -0.7071067811865475, 4.440892098500626e-16)),
    # left_leg_geom end -
    (2, (0.2, 0.2, -6.280369834735101e-17), 0.08, 1.0, 0.02, (0.9, 0.95, 0.001), (-0.7071067811865475, -0.7071067811865475, 4.440892098500626e-16)),
    # left_ankle_geom end +
    (3, (0.0, 0.0, 1.2560739669470203e-16), 0.08, 1.0, 0.02, (0.9, 0.95, 0.001), (-0.7071067811865475, -0.7071067811865475, 4.440892098500626e-16)),
    # left_ankle_geom end -
    (3, (0.4, 0.4, -1.2560739669470203e-16), 0.08, 1.0, 0.02, (0.9, 0.95, 0.001), (-0.7071067811865475, -0.7071067811865475, 4.440892098500626e-16)),
    # aux_2_geom end +
    (4, (0.0, 0.0, 6.280369834735101e-17), 0.08, 1.0, 0.02, (0.9, 0.95, 0.001), (0.7071067811865475, -0.7071067811865475, 4.440892098500626e-16)),
    # aux_2_geom end -
    (4, (-0.2, 0.2, -6.280369834735101e-17), 0.08, 1.0, 0.02, (0.9, 0.95, 0.001), (0.7071067811865475, -0.7071067811865475, 4.440892098500626e-16)),
    # right_leg_geom end +
    (5, (0.0, 0.0, 6.280369834735101e-17), 0.08, 1.0, 0.02, (0.9, 0.95, 0.001), (0.7071067811865475, -0.7071067811865475, 4.440892098500626e-16)),
    # right_leg_geom end -
    (5, (-0.2, 0.2, -6.280369834735101e-17), 0.08, 1.0, 0.02, (0.9, 0.95, 0.001), (0.7071067811865475, -0.7071067811865475, 4.440892098500626e-16)),
    # right_ankle_geom end +
    (6, (0.0, 0.0, 1.2560739669470203e-16), 0.08, 1.0, 0.02, (0.9, 0.95, 0.001), (0.7071067811865475, -0.7071067811865475, 4.440892098500626e-16)),
    # right_ankle_geom end -
    (6, (-0.4, 0.4, -1.2560739669470203e-16), 0.08, 1.0, 0.02, (0.9, 0.95, 0.001), (0.7071067811865475, -0.7071067811865475, 4.440892098500626e-16)),
    # aux_3_geom end +
    (7, (0.0, 0.0, 6.280369834735101e-17), 0.08, 1.0, 0.02, (0.9, 0.95, 0.001), (0.7071067811865475, 0.7071067811865475, 4.440892098500626e-16)),
    # aux_3_geom end -
    (7, (-0.2, -0.2, -6.280369834735101e-17), 0.08, 1.0, 0.02, (0.9, 0.95, 0.001), (0.7071067811865475, 0.7071067811865475, 4.440892098500626e-16)),
    # back_leg_geom end +
    (8, (0.0, 0.0, 6.280369834735101e-17), 0.08, 1.0, 0.02, (0.9, 0.95, 0.001), (0.7071067811865475, 0.7071067811865475, 4.440892098500626e-16)),
    # back_leg_geom end -
    (8, (-0.2, -0.2, -6.280369834735101e-17), 0.08, 1.0, 0.02, (0.9, 0.95, 0.001), (0.7071067811865475, 0.7071067811865475, 4.440892098500626e-16)),
    # third_ankle_geom end +
    (9, (0.0, 0.0, 1.2560739669470203e-16), 0.08, 1.0, 0.02, (0.9, 0.95, 0.001), (0.7071067811865475, 0.7071067811865475, 4.440892098500626e-16)),
    # third_ankle_geom end -
    (9, (-0.4, -0.4, -1.2560739669470203e-16), 0.08, 1.0, 0.02, (0.9, 0.95, 0.001), (0.7071067811865475, 0.7071067811865475, 4.440892098500626e-16)),
    # aux_4_geom end +
    (10, (0.0, 0.0, 6.280369834735101e-17), 0.08, 1.0, 0.02, (0.9, 0.95, 0.001), (-0.7071067811865475, 0.7071067811865475, 4.440892098500626e-16)),
    # aux_4_geom end -
    (10, (0.2, -0.2, -6.280369834735101e-17), 0.08, 1.0, 0.02, (0.9, 0.95, 0.001), (-0.7071067811865475, 0.7071067811865475, 4.440892098500626e-16)),
    # rightback_leg_geom end +
    (11, (0.0, 0.0, 6.280369834735101e-17), 0.08, 1.0, 0.02, (0.9, 0.95, 0.001), (-0.7071067811865475, 0.7071067811865475, 4.440892098500626e-16)),
    # rightback_leg_geom end -
    (11, (0.2, -0.2, -6.280369834735101e-17), 0.08, 1.0, 0.02, (0.9, 0.95, 0.001), (-0.7071067811865475, 0.7071067811865475, 4.440892098500626e-16)),
    # fourth_ankle_geom end +
    (12, (0.0, 0.0, 1.2560739669470203e-16), 0.08, 1.0, 0.02, (0.9, 0.95, 0.001), (-0.7071067811865475, 0.7071067811865475, 4.440892098500626e-16)),
    # fourth_ankle_geom end -
    (12, (0.4, -0.4, -1.2560739669470203e-16), 0.08, 1.0, 0.02, (0.9, 0.95, 0.001), (-0.7071067811865475, 0.7071067811865475, 4.440892098500626e-16)),
)
_LIMITS = (  # dof, lo, hi, solimp, margin
    (6, -0.5235987755982988, 0.5235987755982988, (0.9, 0.95, 0.001), 0.0),
    (7, 0.5235987755982988, 1.2217304763960306, (0.9, 0.95, 0.001), 0.0),
    (8, -0.5235987755982988, 0.5235987755982988, (0.9, 0.95, 0.001), 0.0),
    (9, -1.2217304763960306, -0.5235987755982988, (0.9, 0.95, 0.001), 0.0),
    (10, -0.5235987755982988, 0.5235987755982988, (0.9, 0.95, 0.001), 0.0),
    (11, -1.2217304763960306, -0.5235987755982988, (0.9, 0.95, 0.001), 0.0),
    (12, -0.5235987755982988, 0.5235987755982988, (0.9, 0.95, 0.001), 0.0),
    (13, 0.5235987755982988, 1.2217304763960306, (0.9, 0.95, 0.001), 0.0),
)
_DAMPING = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0)
_ARMATURE = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0)
_STIFFNESS = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
_SPRINGREF = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
_DOF_INVWEIGHT0 = (1.1014374991441787, 1.1014374991441787, 1.1014374991441787, 6.536040226517904, 6.536040226517904, 6.536040226517904, 0.9826359559730786, 0.9951024317528863, 0.9826359559730786, 0.9951024317528863, 0.9826359559730786, 0.9951024317528863, 0.9826359559730786, 0.9951024317528863)
_BODY_INVWEIGHT0 = (1.1014374991441787, 1.1804717947906864, 1.8087762335752948, 3.984413328576989, 1.1804717947906864, 1.8087762335752948, 3.984413328576989, 1.1804717947906864, 1.8087762335752948, 3.984413328576989, 1.1804717947906864, 1.808776233575295, 3.984413328576989)
_ACTUATORS = (  # (dof, gear) per actuator, XML order
    (12, 150.0),  # None
    (13, 150.0),  # None
    (6, 150.0),  # None
    (7, 150.0),  # None
    (8, 150.0),  # None
    (9, 150.0),  # None
    (10, 150.0),  # None
    (11, 150.0),  # None
)

MODEL = SpatialContactModel(
    n_dof=14,
    n_q=15,
    bodies=tuple(
        SCBody(parent=p, pos=pos, quat=quat, joints=joints, com=com,
               mass=mass, inertia=inertia)
        for (p, pos, quat, joints, com, mass, inertia) in _BODIES
    ),
    contacts=tuple(
        SCContact(body=b, local=loc, radius=r, mu=mu, margin=margin,
                  solimp=solimp, axis_local=axis)
        for (b, loc, r, mu, margin, solimp, axis) in _CONTACTS
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
    integrator="rk4",
)
assert MODEL.n_rows == 8 + 4 * 25 == 108

_rk4_substep, _mass_entries, _bias, _qfrc_smooth_fn, _qacc_constrained = (
    build_spatial_stepper(MODEL)
)


@dataclasses.dataclass(frozen=True, eq=False)
class AntDeviceEnv(Env):
    """gymnasium Ant-v4 with on-device spatial dynamics (incl. contacts).

    State x = [qpos(15), qvel(14), torso_stage4_x] (30,); action = 8
    joint torques in [-1, 1] scaled by gear 150 (actuator order hip_4,
    ankle_4, hip_1, ankle_1, hip_2, ankle_2, hip_3, ankle_3 — the XML
    order, NOT dof order). solver_outer/solver_cg set the contact-QP
    iteration counts: (3, 6) is control-grade with lambda warm-starting
    across the RK stages/substeps, (6, 40) matches mj_step to solver
    tolerance (the parity tests use that setting).
    """

    solver_outer: int = 3
    solver_cg: int = 6

    state_dim = 30
    action_dim = 8
    action_low = np.array([-1.0] * 8)
    action_high = np.array([1.0] * 8)

    @property
    def dt(self) -> float:
        return _H * _FRAME_SKIP

    def reset(self, key: jax.Array | None = None) -> EnvState:
        """reset_noise_scale=0 init: qpos0 (torso at z=0.75, unit quat,
        joint angles 0 — the ankle limits are VIOLATED at init and the
        constraint solver pushes them into range, exactly as in gym)."""
        x = np.zeros((30,))
        x[2] = 0.75
        x[3] = 1.0
        x[29] = 0.0  # stage-4 torso x of the "previous" step
        return make_state(jnp.asarray(x, dtype=self.dtype))

    def _tau(self, action):
        zero = jnp.zeros_like(action[0])
        tau = [zero] * 14
        for i, (dof, gear) in enumerate(_ACTUATORS):
            tau[dof] = gear * action[i]
        return tuple(tau)

    def step(self, state: EnvState, action: jnp.ndarray) -> EnvState:
        a = jnp.clip(action, -1.0, 1.0)
        tau = self._tau(a)
        q = tuple(state.x[i] for i in range(15))
        qv = tuple(state.x[15 + i] for i in range(14))
        lam = jnp.zeros((MODEL.n_rows,) + jnp.shape(state.x[0]),
                        dtype=state.x.dtype)

        def sub(carry, _):
            qq, vv, ll, _q4 = carry
            return _rk4_substep(
                qq, vv, tau, self.solver_outer, self.solver_cg, ll
            ), None

        (q, qv, _, q4), _ = jax.lax.scan(
            sub, (q, qv, lam, q), None, length=_FRAME_SKIP
        )
        x = jnp.stack(q + qv + (q4[0],)).astype(self.dtype)
        return EnvState(x=x, t=state.t + 1, done=state.done)

    def step_reward(self, state: EnvState, action: jnp.ndarray):
        new = self.step(state, action)
        # ant_v4.py reads get_body_com("torso")[0] = stage-4 xpos
        x_vel = (new.x[29] - state.x[29]) / self.dt
        r = 1.0 + x_vel - 0.5 * jnp.sum(action * action)
        return new, r

    def reward(self, state: EnvState) -> jnp.ndarray:
        """Instantaneous healthy + forward velocity (harness accounting)."""
        return 1.0 + state.x[15]

    def observation(self, state: EnvState) -> jnp.ndarray:
        """gym obs: qpos[2:] + qvel (27,)."""
        return jnp.concatenate([state.x[2:15], state.x[15:29]])
