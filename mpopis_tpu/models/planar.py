"""Closed-form planar MuJoCo dynamics toolkit (the on-device MuJoCo core).

Shared machinery for the contact-free gymnasium tasks whose full MuJoCo
computation reduces to closed form (reacher/swimmer/pendula): given a
kinematics function over a tuple of joint coordinates, builds the exact
constrained forward dynamics by automatic differentiation —

- mass matrix M = Jᵀ diag(w) J + armature·I from a forward-mode Jacobian
  of the kinematics outputs (w = masses for translational outputs, link
  inertias for angular outputs);
- Coriolis/centrifugal bias (∂(Mq̇)/∂q)q̇ − ∂T/∂q via one JVP + one grad;
- gravity as a potential linear in the kinematics outputs, pulled back
  through the kinematics VJP;
- MuJoCo's soft joint-limit constraint model: solimp impedance sigmoid,
  aref = −b·v − k·imp·pos with k = (dmax·timeconst)⁻²·dampratio⁻²,
  b = 2/(dmax·timeconst), regularizer R = (1−imp)/imp · dof_invweight0
  (a model constant — confirmed against efc_R probes), margin support,
  and the projected active-set solve for up to two simultaneous limits;
- mj_RungeKutta (RK4) stepping that also reports the LAST STAGE's
  coordinates and constraint forces: mj_step leaves data.xpos /
  qfrc_constraint at the final RK stage's values (no forward pass after
  integration), and gymnasium observations/rewards read those stale
  fields.

Layout discipline: everything is a SCALAR expression over tuples — never
a (…,n) array. Under vmap scalars become dense (K,) vectors along the
sample axis; a (K,n) layout with small n wastes the minor dimension, and
batched tiny `jnp.linalg.cholesky` lowers to dynamic-slice loops — hence
the unrolled scalar Cholesky.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import jax
import jax.numpy as jnp

# solimp defaults (0.9, 0.95, 0.001, 0.5, 2) and solref (0.02, 1)
_D0, _DMAX, _WIDTH, _MID = 0.9, 0.95, 0.001, 0.5
_SOLREF_TC = 0.02


def _kb(timestep: float):
    """Constraint stiffness/damping from solref — MuJoCo clamps the
    timeconst to at least 2·timestep (confirmed on inverted_pendulum.xml,
    h=0.02: KBIP halves/quarters vs the h=0.01 models)."""
    tc = max(_SOLREF_TC, 2.0 * timestep)
    return 1.0 / (_DMAX * tc) ** 2, 2.0 / (_DMAX * tc)


def impedance(pos, d0=_D0, dmax=_DMAX, width=_WIDTH):
    """solimp sigmoid d(|pos|), power 2, midpoint 0.5. MuJoCo clamps D0 to
    mjMINIMP=1e-4 BEFORE the sigmoid (probed on cheetah's d0=0 solimp)."""
    d0_eff = max(d0, 1e-4)
    x = jnp.clip(jnp.abs(pos) / width, 0.0, 1.0)
    y = jnp.where(x < _MID, 2.0 * x * x, 1.0 - 2.0 * (1.0 - x) ** 2)
    return d0_eff + (dmax - d0_eff) * y


def chol_unrolled(m, n):
    """Unrolled scalar Cholesky of the lower-triangle list-of-lists m."""
    l = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = m[i][j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            if i == j:
                l[i][j] = jnp.sqrt(s)
            else:
                l[i][j] = s / l[j][j]
    return l


def chol_solve_unrolled(l, b, n):
    """Solve L Lᵀ x = b (b: n scalars) with the unrolled factor."""
    y = []
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y.append(s / l[i][i])
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return x


@dataclasses.dataclass(frozen=True)
class LimitSpec:
    """A limited dof: range (lo, hi), dof_invweight0, and margin."""

    dof: int
    lo: float
    hi: float
    invweight: float
    margin: float = 0.0


def build_planar_dynamics(
    kin: Callable,
    kin_weights: Sequence[float],
    pot_coeffs: Sequence[float],
    n_dof: int,
    damping: Sequence[float],
    armature: Sequence[float],
    limits: Sequence[LimitSpec] = (),
    timestep: float = 0.01,
):
    """Build qacc(q, qv, tau) for a planar chain.

    kin: tuple(n_dof scalars) -> tuple of m output scalars (com coordinates
    and absolute link angles). kin_weights: kinetic-energy weight per
    output (mass for coordinates, inertia for angles). pot_coeffs:
    potential V = Σ c_i · out_i (e.g. m·g on vertical coordinates).
    Returns qacc(q, qv, tau) -> (acc tuple, qfrc_constraint tuple), exactly
    mj_forward for the corresponding MJCF model.
    """
    assert len(limits) <= 2, "projected solve implemented for ≤2 limits"
    kc, bc = _kb(timestep)
    n_out = len(kin_weights)
    use_pot = any(c != 0.0 for c in pot_coeffs)

    def kinetic(q, qv):
        vel = jax.jvp(kin, (q,), (qv,))[1]
        t = 0.0
        for a, v in zip(armature, qv):
            t = t + 0.5 * a * v * v
        for w, v in zip(kin_weights, vel):
            t = t + 0.5 * w * v * v
        return t

    def mass_entries(q):
        jac = jax.jacfwd(kin)(q)  # tuple(n_out) of tuple(n_dof)
        m = [[None] * (i + 1) for i in range(n_dof)]
        for i in range(n_dof):
            for j in range(i + 1):
                s = armature[i] if i == j else 0.0
                for out in range(n_out):
                    s = s + kin_weights[out] * jac[out][i] * jac[out][j]
                m[i][j] = s
        return m

    def bias(q, qv):
        def mom(q_):
            m = mass_entries(q_)
            return tuple(
                sum(
                    (m[i][j] if i >= j else m[j][i]) * qv[j]
                    for j in range(n_dof)
                )
                for i in range(n_dof)
            )

        dir_term = jax.jvp(mom, (q,), (qv,))[1]
        grad_q = jax.grad(kinetic, argnums=0)(q, qv)
        out = [d - g for d, g in zip(dir_term, grad_q)]
        if use_pot:
            _, kin_vjp = jax.vjp(kin, q)
            zero = jnp.zeros_like(q[0])
            cot = tuple(
                c * jnp.ones_like(q[0]) if c != 0.0 else zero
                for c in pot_coeffs
            )
            grad_v = kin_vjp(cot)[0]
            out = [o + g for o, g in zip(out, grad_v)]
        return tuple(out)

    def limit_forces(q, qv, minv_cols, a_smooth):
        """Projected active-set solve for the (≤2) soft limits; returns the
        per-limit signed generalized forces (s·λ)."""
        if not limits:
            return ()
        arefs, signs, active, rs = [], [], [], []
        for spec in limits:
            qk = q[spec.dof]
            d_lo = (qk - spec.lo) - spec.margin
            d_hi = (spec.hi - qk) - spec.margin
            lower_closer = d_lo < d_hi
            pos = jnp.where(lower_closer, d_lo, d_hi)
            s = jnp.where(lower_closer, 1.0, -1.0)
            imp = impedance(pos)
            arefs.append(-bc * (s * qv[spec.dof]) - kc * imp * pos)
            signs.append(s)
            active.append(pos < 0.0)
            rs.append((1.0 - imp) / imp * spec.invweight)
        if len(limits) == 1:
            d0 = limits[0].dof
            a00 = minv_cols[0][d0]
            rhs0 = jnp.where(active[0], arefs[0] - signs[0] * a_smooth[d0], 0.0)
            lam0 = jnp.maximum(rhs0 / (a00 + rs[0]), 0.0)
            return (signs[0] * lam0,)
        d0, d1 = limits[0].dof, limits[1].dof
        s0, s1 = signs
        a00, a11 = minv_cols[0][d0], minv_cols[1][d1]
        a01 = s0 * s1 * minv_cols[1][d0]
        a10 = s0 * s1 * minv_cols[0][d1]
        rhs0 = jnp.where(active[0], arefs[0] - s0 * a_smooth[d0], 0.0)
        rhs1 = jnp.where(active[1], arefs[1] - s1 * a_smooth[d1], 0.0)
        r00, r11 = a00 + rs[0], a11 + rs[1]
        det = r00 * r11 - a01 * a10
        lb0 = (r11 * rhs0 - a01 * rhs1) / det
        lb1 = (-a10 * rhs0 + r00 * rhs1) / det
        l0 = rhs0 / r00
        l1 = rhs1 / r11
        ok_both = active[0] & active[1] & (lb0 >= 0.0) & (lb1 >= 0.0)
        ok_0 = active[0] & (l0 > 0.0) & ((~active[1]) | (a10 * l0 - rhs1 >= 0.0))
        ok_1 = active[1] & (l1 > 0.0) & ((~active[0]) | (a01 * l1 - rhs0 >= 0.0))
        lam0 = jnp.maximum(jnp.where(ok_both, lb0, jnp.where(ok_0, l0, 0.0)), 0.0)
        lam1 = jnp.maximum(jnp.where(ok_both, lb1, jnp.where(ok_1, l1, 0.0)), 0.0)
        return (s0 * lam0, s1 * lam1)

    def qacc(q, qv, tau):
        """(acc, qfrc_constraint) — both n_dof tuples of scalars."""
        m = mass_entries(q)
        l = chol_unrolled(m, n_dof)
        fluid_free = bias(q, qv)
        rhs = [
            tau[i] - fluid_free[i] - damping[i] * qv[i] for i in range(n_dof)
        ]
        a_smooth = chol_solve_unrolled(l, rhs, n_dof)
        if not limits:
            zero = jnp.zeros_like(q[0])
            return tuple(a_smooth), (zero,) * n_dof
        zero = jnp.zeros_like(q[0])
        one = jnp.ones_like(q[0])
        minv_cols = []
        for spec in limits:
            e = [zero] * n_dof
            e[spec.dof] = one
            minv_cols.append(chol_solve_unrolled(l, e, n_dof))
        forces = limit_forces(q, qv, minv_cols, a_smooth)
        qfrc_c = [zero] * n_dof
        acc = list(a_smooth)
        for col, f, spec in zip(minv_cols, forces, limits):
            qfrc_c[spec.dof] = qfrc_c[spec.dof] + f
            for i in range(n_dof):
                acc[i] = acc[i] + col[i] * f
        return tuple(acc), tuple(qfrc_c)

    return qacc, mass_entries, bias


def rk4_step(qacc, q, qv, tau, h):
    """One mj_RungeKutta step. Returns (q', qv', q_stage4, qfrc_c_stage4):
    the stage-4 values are what data.xpos / qfrc_constraint hold after
    mj_step (no forward pass after integration)."""

    def add(a, b, hh):
        return tuple(x + hh * y for x, y in zip(a, b))

    k1v, _ = qacc(q, qv, tau)
    k1q = qv
    q2, v2 = add(q, k1q, 0.5 * h), add(qv, k1v, 0.5 * h)
    k2v, _ = qacc(q2, v2, tau)
    k2q = v2
    q3, v3 = add(q, k2q, 0.5 * h), add(qv, k2v, 0.5 * h)
    k3v, _ = qacc(q3, v3, tau)
    k3q = v3
    q4, v4 = add(q, k3q, h), add(qv, k3v, h)
    k4v, qfrc4 = qacc(q4, v4, tau)
    k4q = v4
    qn = tuple(
        a + (h / 6.0) * (b + 2.0 * c + 2.0 * d + e)
        for a, b, c, d, e in zip(q, k1q, k2q, k3q, k4q)
    )
    vn = tuple(
        a + (h / 6.0) * (b + 2.0 * c + 2.0 * d + e)
        for a, b, c, d, e in zip(qv, k1v, k2v, k3v, k4v)
    )
    return qn, vn, q4, qfrc4
