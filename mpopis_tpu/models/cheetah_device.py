"""On-device (pure-JAX) HalfCheetah-v4 — MuJoCo-exact dynamics WITH contacts.

The flagship benchmark of the reference (README.md:58-100 is a HalfCheetah
run through envpool). This module instantiates the generic planar-contact
pipeline (models/planar_contact.py — where all the probed contact-model
facts are documented) for half_cheetah.xml: the 9-DoF planar kinematic
tree (energy-AD mass matrix/Coriolis via models/planar.py), joint
springs/damping/armature, plane-capsule contacts with MuJoCo's pyramidal
friction model (μ=0.4, solimp (0, 0.8, 0.01), no margin), the joint soft
limits (solimp (0, 0.8, 0.03)), and Euler integration with implicit
damping. Every constant below was probed from the mujoco wheel and
verified numerically (models/planar_contact.py records the probe results).

Obs/reward follow half_cheetah_v4.py: obs = [qpos[1:], qvel] (fresh —
cheetah reads joint state, not xpos), reward = (x'−x)/dt − 0.1·Σa²
(pre-step x ⇒ exposed through step_reward).

Layout: scalar/SoA over tuples like the rest of the on-device family;
the CG state is (N_ROWS, K)-shaped with K minor (lane-dense); J is a
static-sparsity structure (each row touches ≤ 6 dofs), applied as unrolled
scalar accumulations.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from mpopis_tpu.models.base import Env, EnvState, make_state
from mpopis_tpu.models.planar import chol_solve_unrolled, chol_unrolled
from mpopis_tpu.models.planar_contact import (
    PCBody,
    PCContact,
    PCLimit,
    PlanarContactModel,
    build_contact_stepper,
    contact_rows,
    solve_qp,
)

_H = 0.01
_FRAME_SKIP = 5
_MU = 0.4
_RADIUS = 0.046

# --- bodies: (name, parent(-1=root/torso chain), offset(x,z) in parent,
#              com(x,z), mass, I_yy, hinge dof index) -----------------------
# torso is the root: origin (q0, 0.7+q1), angle q2.
_BODIES = (
    # torso I_yy is the BODY-FRAME yy inertia (its inertial frame is
    # tilted by iquat, so the principal middle entry does not apply)
    ("torso", -1, (0.0, 0.7), (0.15238987816307403, 0.025398313027179008),
     6.25020920502092, 0.8971176881117483, 2),
    ("bthigh", 0, (-0.5, 0.0), (0.1, -0.13),
     1.5435146443514645, 0.01684433958158996, 3),
    ("bshin", 1, (0.16, -0.25), (-0.14, -0.07),
     1.5874476987447697, 0.018267419079497905, 4),
    ("bfoot", 2, (-0.28, -0.14), (0.03, -0.097),
     1.0953974895397491, 0.0063524232635983275, 5),
    ("fthigh", 0, (0.5, 0.0), (-0.07, -0.12),
     1.4380753138075317, 0.013739643347280341, 6),
    ("fshin", 4, (-0.14, -0.24), (0.065, -0.09),
     1.200836820083682, 0.008222108619246861, 7),
    ("ffoot", 5, (0.13, -0.18), (0.045, -0.07),
     0.8845188284518829, 0.003529109456066946, 8),
)
# capsule endpoints in body-local (x,z); two candidates per geom
_ENDPOINTS = (
    (0, (-0.5, 3.061616997868383e-17)), (0, (0.5, -3.061616997868383e-17)),
    (0, (0.7146493405538257, 0.19672398208600017)),
    (0, (0.4853506594461742, 0.0032760179139998263)),
    (1, (0.18871939418669426, -0.24469031822759044)),
    (1, (0.011280605813305769, -0.015309681772409572)),
    (2, (-0.27446086117273405, -0.13648516234985636)),
    (2, (-0.005539138827266005, -0.003514837650143668)),
    (3, (0.004927244951249871, -0.006405535741606294)),
    (3, (0.05507275504875013, -0.1875944642583937)),
    (4, (-0.003914941666783009, -0.00458004910287256)),
    (4, (-0.136085058333217, -0.23541995089712742)),
    (5, (0.005147897820126257, -0.0025144248195740904)),
    (5, (0.12485210217987375, -0.1774855751804259)),
    (6, (0.005475026862347521, -0.01222650695632252)),
    (6, (0.08452497313765248, -0.1277734930436775)),
)
_N_CON = len(_ENDPOINTS)
_DAMPING = (0.0, 0.0, 0.0, 6.0, 4.5, 3.0, 4.5, 3.0, 1.5)
_ARMATURE = (0.0, 0.0, 0.0, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1)
_STIFFNESS = (0.0, 0.0, 0.0, 240.0, 180.0, 120.0, 180.0, 120.0, 60.0)
_GEAR = (120.0, 90.0, 60.0, 120.0, 60.0, 30.0)  # dofs 3..8
_LIMITS = (  # (dof, lo, hi)
    (3, -0.52, 1.05), (4, -0.785, 0.785), (5, -0.4, 0.785),
    (6, -1.0, 0.7), (7, -1.2, 0.87), (8, -0.5, 0.5),
)
_DOF_INVWEIGHT0 = (
    0.10673572816871127, 0.08459229161068711, 0.41634706198577387,
    2.729788644884893, 5.893248984162904, 8.894877004054676,
    3.0813926054768768, 6.882795962275771, 9.468134962769764,
)
_BODY_INVWEIGHT0 = (  # translation component, bodies in _BODIES order
    0.06415751945610272, 0.09691101560963138, 0.12720922534654555,
    0.24374928349017175, 0.08148379481367073, 0.1319968179007737,
    0.2661441029233887,
)
# constraint constants: contact solimp (0, 0.8, 0.01); limit solimp (0, 0.8, 0.03)
_CON_SOLIMP = (0.0, 0.8, 0.01)
_LIM_SOLIMP = (0.0, 0.8, 0.03)
_N_ROWS = len(_LIMITS) + 3 * _N_CON

MODEL = PlanarContactModel(
    n_dof=9,
    root_offset=(0.0, 0.7),
    bodies=tuple(
        PCBody(parent=p, pos=off, anchor=(0.0, 0.0), sign=1.0, com=com,
               mass=m, iyy=iyy, dof=dof)
        for (_nm, p, off, com, m, iyy, dof) in _BODIES
    ),
    contacts=tuple(
        PCContact(body=b, local=loc, radius=_RADIUS, mu=_MU, margin=0.0,
                  solimp=_CON_SOLIMP)
        for (b, loc) in _ENDPOINTS
    ),
    limits=tuple(
        PCLimit(dof=d, lo=lo, hi=hi, solimp=_LIM_SOLIMP)
        for (d, lo, hi) in _LIMITS
    ),
    damping=_DAMPING,
    armature=_ARMATURE,
    stiffness=_STIFFNESS,
    gear=_GEAR,
    dof_invweight0=_DOF_INVWEIGHT0,
    body_invweight0=_BODY_INVWEIGHT0,
    timestep=_H,
    integrator="euler_implicit",
)
assert MODEL.n_rows == _N_ROWS

_euler_substep, _mass_entries, _bias, _qfrc_smooth_fn, _ = (
    build_contact_stepper(MODEL)
)


# --- thin wrappers keeping the round-1 test surface stable -----------------
def _qfrc_smooth(q, qv, tau):
    """Actuation + passive (springs + explicit damping) − bias."""
    return _qfrc_smooth_fn(q, qv, tau)


def _contact_rows(q, qv, zero):
    return contact_rows(MODEL, q, qv, zero)


def _solve_qp(rows, zero, l_chol, a_smooth, outer: int, cg: int):
    assert len(rows) == _N_ROWS, (len(rows), _N_ROWS)
    return solve_qp(rows, zero, l_chol, a_smooth, outer, cg, 9)


def _euler_step(q, qv, tau, outer, cg):
    q2, qv2, _lam = _euler_substep(q, qv, tau, outer, cg)
    return q2, qv2


@dataclasses.dataclass(frozen=True, eq=False)
class CheetahDeviceEnv(Env):
    """gymnasium HalfCheetah-v4 with on-device dynamics (incl. contacts).

    State x = [qpos(9), qvel(9)]; action = 6 joint torques ∈ [−1, 1]
    scaled by the per-joint gears. solver_outer/solver_cg set the fixed
    iteration counts of the contact QP solve: the defaults (3, 6) are
    control-grade (the λ warm-start across the frame-skip substeps makes
    them match the converged solve to ~1e-3 worst-case on realistic
    trajectories); (6, 40) matches mj_step to solver tolerance even on
    deep-contact states (the parity tests use that setting).
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
        return make_state(jnp.zeros((18,), dtype=self.dtype))

    def step(self, state: EnvState, action: jnp.ndarray) -> EnvState:
        a = jnp.clip(action, -1.0, 1.0)
        zero = jnp.zeros_like(state.x[0])
        tau = (zero, zero, zero) + tuple(
            _GEAR[i] * a[i] for i in range(6)
        )
        q = tuple(state.x[i] for i in range(9))
        qv = tuple(state.x[9 + i] for i in range(9))
        # λ warm-starts chain across the frame-skip substeps (contact
        # forces are continuous in time); reset at control-step boundaries
        lam = jnp.zeros((MODEL.n_rows,) + jnp.shape(state.x[0]),
                        dtype=state.x.dtype)

        def sub(carry, _):
            qq, vv, ll = carry
            return _euler_substep(
                qq, vv, tau, self.solver_outer, self.solver_cg, ll
            ), None

        (q, qv, _), _ = jax.lax.scan(sub, (q, qv, lam), None, length=_FRAME_SKIP)
        x = jnp.stack(q + qv).astype(self.dtype)
        return EnvState(x=x, t=state.t + 1, done=state.done)

    def step_reward(self, state: EnvState, action: jnp.ndarray):
        new = self.step(state, action)
        x_vel = (new.x[0] - state.x[0]) / self.dt
        r = x_vel - 0.1 * jnp.sum(action * action)  # half_cheetah_v4.py
        return new, r

    def reward(self, state: EnvState) -> jnp.ndarray:
        """Instantaneous forward velocity (harness accounting)."""
        return state.x[9]

    def observation(self, state: EnvState) -> jnp.ndarray:
        """gym obs: qpos[1:] + qvel (17,)."""
        return jnp.concatenate([state.x[1:9], state.x[9:]])
