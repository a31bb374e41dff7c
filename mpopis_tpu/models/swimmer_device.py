"""On-device (pure-JAX) Swimmer-v4 — MuJoCo-exact closed-form dynamics.

Second member of the on-device MuJoCo family (see reacher_device.py for
the rationale). swimmer.xml: a free planar 3-link chain (2 slide + 3 hinge
DoF, armature 0.1 each, no damping), driven by 2 gear-150 motors, swimming
in MuJoCo's inertia-box fluid model (density 4000, viscosity 0.1), RK4 at
h=0.01, frame_skip=4, soft joint limits ±100° on both motor joints.

Dynamics pieces, each validated against the mujoco wheel
(tests/test_swimmer_device.py):

- mass matrix / Coriolis: assembled by forward-mode AD of the planar
  kinematics (com positions + link angles); M = Jᵀ diag(m,m,I) J +
  armature·I₅, bias = (∂(Mq̇)/∂q)q̇ − ∂T/∂q — exact, no hand-derivation.
- fluid forces (reverse-engineered from qfrc_passive probes on an isolated
  capsule; the "inertia-box" model): equivalent box sides
  sᵢ = √(6(Iⱼ+Iₖ−Iᵢ)/m); per inertial axis quadratic drag
  −½ρ·sⱼ·sₖ·|vᵢ|vᵢ, isotropic viscous force −3πνd·v with
  d = (s₁+s₂+s₃)/3, quadratic torque −(ρ/64)·sᵢ(sⱼ⁴+sₖ⁴)|ωᵢ|ωᵢ, viscous
  torque −πνd³ω. Mapped to joint space through the kinematics VJP.
- joint limits: the same soft-constraint model as reacher_device.py
  (solref (0.02,1), solimp (0.9,0.95,0.001,0.5,2), regularizer
  R = (1−imp)/imp · dof_invweight0[j] — a model constant), extended to the
  2-constraint case with an exhaustive active-set enumeration of the 2×2
  projected solve. Matches mj_forward's qacc to ~1e-15 with one or both
  limits active.

Layout note: every quantity is a SCALAR expression over a pytree of
(5|9|10)-tuples — never a (…,5) array. Under vmap the scalars become
dense (K,) vectors along the sample axis. The 5×5 solves are unrolled
scalar Cholesky for the same reason (batched tiny jnp.linalg.cholesky
lowers to dynamic-slice loops).

Reward/obs follow swimmer_v4.py: reward = (x_after−x_before)/dt −
1e-4·Σa² (pre/post-step torso x), obs = [qpos[2:], qvel]; deterministic
reset to qpos0 (zeros) like the batch engine.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from mpopis_tpu.models.base import Env, EnvState, make_state
from mpopis_tpu.models.planar import LimitSpec, build_planar_dynamics, rk4_step

# --- constants from swimmer.xml via mjModel (f64) --------------------------
_MASS = 35.604716740684324  # per link (capsule r=0.1, l=1.0, density 1000)
_I_MAX = 3.9175660390264717  # principal inertia, short axes (in-plane rot)
_I_MIN = 0.17383479349863523  # about the capsule's long axis
_ARMATURE = 0.1
_GEAR = 150.0
_H = 0.01
_FRAME_SKIP = 4
_LIMIT = float(np.deg2rad(100.0))  # motor joint range
_RHO, _VISC = 4000.0, 0.1
# equivalent-box sides from the principal inertias
_S_SHORT = float(np.sqrt(6.0 * (_I_MAX + _I_MIN - _I_MAX) / _MASS))
_S_LONG = float(np.sqrt(6.0 * (_I_MAX + _I_MAX - _I_MIN) / _MASS))
_D_EQ = (2.0 * _S_SHORT + _S_LONG) / 3.0
_C_VISC_F = 3.0 * np.pi * _VISC * _D_EQ
_C_VISC_T = np.pi * _VISC * _D_EQ**3
_C_PAR = 0.5 * _RHO * _S_SHORT * _S_SHORT  # motion along the link axis
_C_PERP = 0.5 * _RHO * _S_SHORT * _S_LONG  # in-plane perpendicular motion
_C_ROT = _RHO / 64.0 * _S_SHORT * (_S_SHORT**4 + _S_LONG**4)
# mjModel.dof_invweight0[3:5]: constraint regularizer weights (R)
_INVWEIGHT = (0.38529334162134676, 0.3933336741383495)


def _kin(q):
    """Kinematics over a 5-tuple qpos: 9-tuple of link-com coordinates and
    absolute angles (p1x, p1y, p2x, p2y, p3x, p3y, th1, th2, th3).

    Geometry from swimmer.xml: torso origin at the slides, its capsule com
    at +1.0 along the link axis (fromto 1.5..0.5, ipos (1,0)); mid body at
    +0.5 on the torso with its com at \u22120.5; back at \u22121.0 on mid, com \u22120.5.
    """
    x, y, t1, a2, a3 = q
    th1 = t1
    th2 = t1 + a2
    th3 = th2 + a3
    c1, s1 = jnp.cos(th1), jnp.sin(th1)
    c2, s2 = jnp.cos(th2), jnp.sin(th2)
    c3, s3 = jnp.cos(th3), jnp.sin(th3)
    o2x, o2y = x + 0.5 * c1, y + 0.5 * s1
    o3x, o3y = o2x - c2, o2y - s2
    return (
        x + c1,
        y + s1,
        o2x - 0.5 * c2,
        o2y - 0.5 * s2,
        o3x - 0.5 * c3,
        o3y - 0.5 * s3,
        th1,
        th2,
        th3,
    )


_W_OUT = (_MASS,) * 6 + (_I_MAX,) * 3  # kinetic-energy weights per output


def _fluid_qfrc(q, qv):
    """Generalized fluid forces: per-link drag/viscous wrench pulled back
    through the kinematics VJP (exactly \u03a3 J\u1d40F without forming J)."""
    out, kin_vjp = jax.vjp(_kin, q)
    vel = jax.jvp(_kin, (q,), (qv,))[1]
    th = out[6:9]
    cot = [None] * 9
    for i in range(3):
        c, s = jnp.cos(th[i]), jnp.sin(th[i])
        vx, vy, w = vel[2 * i], vel[2 * i + 1], vel[6 + i]
        v_par = vx * c + vy * s
        v_perp = -vx * s + vy * c
        f_par = -(_C_VISC_F + _C_PAR * jnp.abs(v_par)) * v_par
        f_perp = -(_C_VISC_F + _C_PERP * jnp.abs(v_perp)) * v_perp
        cot[2 * i] = f_par * c - f_perp * s
        cot[2 * i + 1] = f_par * s + f_perp * c
        cot[6 + i] = -(_C_VISC_T + _C_ROT * jnp.abs(w)) * w
    return kin_vjp(tuple(cot))[0]


_BASE_QACC, _mass_entries, _ = build_planar_dynamics(
    _kin,
    kin_weights=_W_OUT,
    pot_coeffs=(0.0,) * 9,  # horizontal plane: no gravity torque
    n_dof=5,
    damping=(0.0,) * 5,
    armature=(_ARMATURE,) * 5,
    limits=(
        LimitSpec(dof=3, lo=-_LIMIT, hi=_LIMIT, invweight=_INVWEIGHT[0]),
        LimitSpec(dof=4, lo=-_LIMIT, hi=_LIMIT, invweight=_INVWEIGHT[1]),
    ),
)


def _qacc_full(q, qv, tau):
    """Constrained forward dynamics over 5-tuples; exactly mj_forward.
    The fluid wrench is state-dependent, so it folds into the applied
    force (re-evaluated per RK stage by rk4_step)."""
    fl = _fluid_qfrc(q, qv)
    return _BASE_QACC(q, qv, tuple(t + f for t, f in zip(tau, fl)))


def _qacc(q, qv, tau3, tau4):
    """Acceleration-only wrapper (probe/tests API)."""
    zero = jnp.zeros_like(q[0])
    return _qacc_full(q, qv, (zero, zero, zero, tau3, tau4))[0]


def _rk4(q, qv, tau3, tau4):
    """One mj_RungeKutta step at h=_H over (5-tuple, 5-tuple) state."""
    zero = jnp.zeros_like(q[0])
    tau = (zero, zero, zero, tau3, tau4)
    qn, vn, _, _ = rk4_step(_qacc_full, q, qv, tau, _H)
    return qn, vn


# ---------------------------------------------------------------------------
# Analytic route (no AD transforms): the same dynamics assembled from the
# generic planar-contact chain formulas. The swimmer rotates about +z while
# the planar_contact convention rotates about +y — R_mine(−θ) = R_z(θ), so
# every hinge gets sign −1 and the link angles/ω flip sign inside the fluid
# model (which is written in z-convention below). This route is pinned
# equal to the AD route (tests/test_swimmer_device.py) and is what
# env.step runs: it needs no jacfwd/jvp/vjp graphs.
# ---------------------------------------------------------------------------

from mpopis_tpu.models.planar_contact import (  # noqa: E402
    PCBody,
    PCLimit,
    PlanarContactModel,
    build_contact_stepper,
    frames,
)

PC_MODEL = PlanarContactModel(
    n_dof=5,
    root_offset=(0.0, 0.0),
    bodies=(
        PCBody(parent=-1, pos=(0.0, 0.0), anchor=(0.0, 0.0), sign=-1.0,
               com=(1.0, 0.0), mass=_MASS, iyy=_I_MAX, dof=2),  # torso
        PCBody(parent=0, pos=(0.5, 0.0), anchor=(0.0, 0.0), sign=-1.0,
               com=(-0.5, 0.0), mass=_MASS, iyy=_I_MAX, dof=3),  # mid
        PCBody(parent=1, pos=(-1.0, 0.0), anchor=(0.0, 0.0), sign=-1.0,
               com=(-0.5, 0.0), mass=_MASS, iyy=_I_MAX, dof=4),  # back
    ),
    contacts=(),
    limits=(
        PCLimit(dof=3, lo=-_LIMIT, hi=_LIMIT, solimp=(0.9, 0.95, 0.001)),
        PCLimit(dof=4, lo=-_LIMIT, hi=_LIMIT, solimp=(0.9, 0.95, 0.001)),
    ),
    damping=(0.0,) * 5,
    armature=(_ARMATURE,) * 5,
    stiffness=(0.0,) * 5,
    gear=(_GEAR, _GEAR),
    dof_invweight0=(0.0, 0.0, 0.0) + _INVWEIGHT,
    body_invweight0=(0.0, 0.0, 0.0),
    timestep=_H,
    integrator="rk4",
    gravity=0.0,
)


def _fluid_force_analytic(q, qv):
    """Generalized inertia-box fluid forces via the chain Jacobians
    (z-convention: θ_z = −θ_mine, ω_z = −ω_mine; coordinates coincide)."""
    model = PC_MODEL
    ox, oz, th, awx, awz = frames(model, q)
    chains = model.chains
    nb = len(model.bodies)
    omega = [None] * nb
    vax, vaz = [None] * nb, [None] * nb
    for bi, b in enumerate(model.bodies):
        if b.parent == -1:
            omega[bi] = b.sign * qv[b.dof]
            vax[bi], vaz[bi] = qv[0], qv[1]
        else:
            p = b.parent
            omega[bi] = omega[p] + b.sign * qv[b.dof]
            dx, dz = awx[bi] - awx[p], awz[bi] - awz[p]
            vax[bi] = vax[p] + omega[p] * dz
            vaz[bi] = vaz[p] - omega[p] * dx
    zero = jnp.zeros_like(q[0])
    out = [zero] * 5
    for bi, b in enumerate(model.bodies):
        c, s = jnp.cos(th[bi]), jnp.sin(th[bi])
        cx, cz = b.com
        px = ox[bi] + c * cx + s * cz
        pz = oz[bi] - s * cx + c * cz
        vpx = vax[bi] + omega[bi] * (pz - awz[bi])
        vpz = vaz[bi] - omega[bi] * (px - awx[bi])
        # z-convention axis: (cos θ_z, sin θ_z) = (c, −s)
        sz = -s
        v_par = vpx * c + vpz * sz
        v_perp = -vpx * sz + vpz * c
        f_par = -(_C_VISC_F + _C_PAR * jnp.abs(v_par)) * v_par
        f_perp = -(_C_VISC_F + _C_PERP * jnp.abs(v_perp)) * v_perp
        fx = f_par * c - f_perp * sz
        fz = f_par * sz + f_perp * c
        w_z = -omega[bi]
        tq = -(_C_VISC_T + _C_ROT * jnp.abs(w_z)) * w_z
        out[0] = out[0] + fx
        out[1] = out[1] + fz
        for body in chains[bi]:
            bb = model.bodies[body]
            jx = bb.sign * (pz - awz[body])
            jz = -bb.sign * (px - awx[body])
            # ∂θ_z/∂q_d = −sign (θ_z = −θ_mine)
            out[bb.dof] = out[bb.dof] + jx * fx + jz * fz - bb.sign * tq
    return tuple(out)


_analytic_substep, _pc_mass, _pc_bias, _pc_smooth, _pc_qacc = (
    build_contact_stepper(PC_MODEL, extra_force=_fluid_force_analytic)
)


def _rk4_analytic(q, qv, tau3, tau4, lam=None):
    """One mj_RungeKutta step via the analytic route; returns
    (q', qv', λ). Solver (2, 3) is EXACT for the 2-row limit QP (a 2-dim
    Krylov space: 3 CG its are a direct solve; the second active-set pass
    fixes any mispick — pinned bitwise equal to (8, 8) on limit-active
    states), and the small fixed counts keep the compile small."""
    zero = jnp.zeros_like(q[0])
    tau = (zero, zero, zero, tau3, tau4)
    return _analytic_substep(q, qv, tau, 2, 3, lam)


@dataclasses.dataclass(frozen=True, eq=False)
class SwimmerDeviceEnv(Env):
    """gymnasium Swimmer-v4 with on-device dynamics.

    State x = [qpos(5), qvel(5)]; action = 2 motor torques ∈ [−1,1]
    (gear 150). Reward follows swimmer_v4.py (forward x velocity of the
    torso slide minus 1e-4·Σa²), exposed via step_reward since it needs
    the pre-step x.
    """


    state_dim = 10
    action_dim = 2
    action_low = np.array([-1.0, -1.0])
    action_high = np.array([1.0, 1.0])

    @property
    def dt(self) -> float:
        return _H * _FRAME_SKIP

    def reset(self, key: jax.Array | None = None) -> EnvState:
        return make_state(jnp.zeros((10,), dtype=self.dtype))

    def step(self, state: EnvState, action: jnp.ndarray) -> EnvState:
        a = jnp.clip(action, -1.0, 1.0)
        tau3 = _GEAR * a[0]
        tau4 = _GEAR * a[1]
        q = tuple(state.x[i] for i in range(5))
        qv = tuple(state.x[5 + i] for i in range(5))
        # analytic route (pinned equal to the AD route to ~3e-15/substep);
        # λ warm-starts the 2-row limit solve across the frame skip
        lam = jnp.zeros((PC_MODEL.n_rows,) + jnp.shape(state.x[0]),
                        dtype=state.x.dtype)

        def sub(carry, _):
            qq, vv, ll = carry
            return _rk4_analytic(qq, vv, tau3, tau4, ll), None

        (q, qv, _), _ = jax.lax.scan(
            sub, (q, qv, lam), None, length=_FRAME_SKIP
        )
        x = jnp.stack(q + qv).astype(self.dtype)
        return EnvState(x=x, t=state.t + 1, done=state.done)

    def step_reward(self, state: EnvState, action: jnp.ndarray):
        new = self.step(state, action)
        x_vel = (new.x[0] - state.x[0]) / self.dt
        r = x_vel - 1e-4 * jnp.sum(action * action)  # gym uses the raw action
        return new, r

    def reward(self, state: EnvState) -> jnp.ndarray:
        """Instantaneous forward velocity (harness accounting; the exact
        gym reward comes from step_reward)."""
        return state.x[5]

    def observation(self, state: EnvState) -> jnp.ndarray:
        """gym obs: qpos[2:] + qvel (8,)."""
        return jnp.concatenate([state.x[2:5], state.x[5:]])
