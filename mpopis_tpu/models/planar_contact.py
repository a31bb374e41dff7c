"""Generic on-device planar MuJoCo dynamics WITH contacts.

Generalization of the HalfCheetah contact pipeline (round 1,
models/cheetah_device.py) to the whole planar-locomotion family
(HalfCheetah, Hopper, Walker2d — the tasks the reference reaches through
envpool, src/envs/envpool_env.jl:35-61). A model is a static constant
table probed from the compiled MjModel (scripts/probe_planar.py); the
builder turns it into pure-JAX substep functions in the scalar/SoA layout
(every quantity a (K,) vector under vmap).

Everything below was probed from the mujoco wheel and verified
numerically (the original cheetah probes; the Hopper/Walker2d
extensions re-verified on those models):

- plane-capsule collision: one candidate contact per capsule end sphere;
  dist = p_z − radius, ACTIVE when dist < includemargin (the sum of the
  two geoms' margins — 0.002 on Hopper, 0 elsewhere); contact point
  (p_x, dist/2) regardless of margin (probed on Hopper's margin=0.001
  geoms);
- condim-3 PYRAMIDAL cone ⇒ 4 rows per contact, J = J_normal ± μ·J_tangent
  (probed at μ=0.4, 1.0 and 2.0 — the coefficient is exactly the contact
  friction, which MuJoCo combines as the elementwise MAX of the two
  geoms' friction when priorities are equal: Hopper foot 2.0 vs floor 1.0
  → 2.0, torso 0.9 vs floor 1.0 → 1.0); the two pure-normal rows of the
  pyramid merge into ONE row with regularizer R/2 carrying the pair's
  total λ (see the stationarity argument in the row-count note below);
- per-row aref = −b·(J q̇) − k·imp·(pos − margin) with the row's OWN
  solimp/solref: k = (dmax·tc)⁻², b = 2/(dmax·tc), tc = max(0.02, 2h);
  impedance is the solimp sigmoid evaluated at |pos − margin| with d0
  clamped to mjMINIMP=1e-4 (probed; constant 0.8 on Hopper's
  (0.8, 0.8, 0.01) solimp, sigmoid on Walker2d's (0.9, 0.95, 0.001));
- row regularizers: contacts R = (1−imp)/imp · body_invweight0[b][0] ·
  2μ²(1+μ²) (the floor is the world body, invweight 0); joint limits
  R = (1−imp)/imp · dof_invweight0[d] (verified on Walker2d:
  efc_R = 0.0526·18.211 at deep violation);
- the constrained step is a strictly convex box-QP in λ ≥ 0
  (A = J M⁻¹ Jᵀ + diag(R)) solved by the fixed-iteration ACTIVE-SET/CG
  method from round 1 (machine-precision agreement with MuJoCo's Newton);
- integrators: `euler_implicit` (HalfCheetah) — λ against the UNDAMPED M,
  then v' = v + h·(M + h·diag(damping))⁻¹(smooth + Jᵀλ); `rk4`
  (Hopper/Walker2d) — mj_RungeKutta evaluates the FULL constrained
  forward dynamics (contact QP included) at each of the 4 stages, damping
  enters qfrc_passive explicitly.

Kinematic generality beyond the cheetah: per-joint hinge AXIS SIGN
(Hopper/Walker2d leg joints rotate about −y: body angle = parent angle +
sign·q) and per-joint ANCHORS off the body-frame origin (e.g. Hopper's
leg_joint at (0, 0.25), foot_joint at (−0.13, 0.1)): the body frame is
X_p ∘ T(pos) ∘ Rot_about_anchor(sign·q), so
origin_world = anchor_world − R(θ_body)·anchor_local.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp

from mpopis_tpu.models.planar import (
    build_planar_dynamics,
    chol_solve_unrolled,
    chol_unrolled,
    impedance,
)


@dataclasses.dataclass(frozen=True)
class PCBody:
    """One body of the planar tree. `parent` indexes into the body tuple
    (-1 = root). `pos` is the body-frame origin in the parent frame,
    `anchor` the hinge anchor in THIS body's frame, `sign` the hinge axis
    sign (+1 for +y, -1 for -y), `com`/`mass`/`iyy` the inertial constants
    (iyy in the BODY frame — round-1 lesson: a tilted inertial frame's
    principal middle entry does not apply), `dof` the hinge dof index
    (the root body uses dof 2 = rooty; dofs 0, 1 are the x/z slides)."""

    parent: int
    pos: tuple[float, float]
    anchor: tuple[float, float]
    sign: float
    com: tuple[float, float]
    mass: float
    iyy: float
    dof: int


@dataclasses.dataclass(frozen=True)
class PCContact:
    """One candidate contact: a capsule end sphere vs the floor plane."""

    body: int
    local: tuple[float, float]
    radius: float
    mu: float
    margin: float  # includemargin (sum of the two geoms' margins)
    solimp: tuple[float, float, float]  # (d0, dmax, width)


@dataclasses.dataclass(frozen=True)
class PCCapsulePair:
    """A capsule-capsule self-collision pair (condim 1 — frictionless,
    one row), e.g. Hopper's torso↔foot. MuJoCo includes geom pairs whose
    bodies are neither identical nor parent-child when
    contype/conaffinity intersect; the contact is the closest-point pair
    of the two segments (single contact — the exactly-parallel 2-contact
    branch triggers only at machine-precision-parallel axes, probed
    unreachable from dynamics), condim = max(1, 1) = 1, and
    R = (1−imp)/imp · (body_invweight0₁ + body_invweight0₂) (probed:
    efc_R = 0.0379562768 on Hopper's torso↔foot = 0.25·(bw₁+bw₂))."""

    body1: int
    a1: tuple[float, float]  # segment endpoints, body1 frame
    b1: tuple[float, float]
    r1: float
    body2: int
    a2: tuple[float, float]
    b2: tuple[float, float]
    r2: float
    margin: float
    solimp: tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class PCLimit:
    dof: int
    lo: float
    hi: float
    solimp: tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class PlanarContactModel:
    """Static constant table for one planar-locomotion MJCF model."""

    n_dof: int
    root_offset: tuple[float, float]  # torso origin = (q0+ox, q1+oz)
    bodies: tuple[PCBody, ...]
    contacts: tuple[PCContact, ...]
    limits: tuple[PCLimit, ...]
    damping: tuple[float, ...]
    armature: tuple[float, ...]
    stiffness: tuple[float, ...]
    gear: tuple[float, ...]  # actuated dofs 3..n_dof-1
    dof_invweight0: tuple[float, ...]
    body_invweight0: tuple[float, ...]  # per body, translation component
    timestep: float
    integrator: str  # "euler_implicit" | "rk4"
    gravity: float = 9.81
    pairs: tuple[PCCapsulePair, ...] = ()

    @property
    def n_rows(self) -> int:
        """Limit rows + [n+μt, n−μt, merged-normal] per contact.

        Row-count note: each contact's 4 pyramid rows are
        (n+μt, n−μt, n, n); the two identical pure-normal rows carry
        equal λ at the optimum, so they merge into ONE row whose λ is the
        pair total and whose regularizer is R/2 (two parallel identical
        regularized rows): substituting ν = λ₁+λ₂ into the stationarity
        conditions gives a·ν + (R/2)·ν = rhs — identical equations,
        identical coupling into the other rows. The solved QP is exactly
        MuJoCo's. Capsule-capsule pairs add one frictionless row each."""
        return len(self.limits) + 3 * len(self.contacts) + len(self.pairs)

    @property
    def chains(self):
        """Tuple of root-ward body-index chains, one per body."""
        out = []
        for bi in range(len(self.bodies)):
            chain = []
            cur = bi
            while cur != -1:
                chain.append(cur)
                cur = self.bodies[cur].parent
            out.append(tuple(chain))
        return tuple(out)

    def kb(self, dmax: float) -> tuple[float, float]:
        """Constraint stiffness/damping from solref (0.02, 1); MuJoCo
        clamps the timeconst to at least 2·timestep."""
        tc = max(0.02, 2.0 * self.timestep)
        return 1.0 / (dmax * tc) ** 2, 2.0 / (dmax * tc)


def frames(model: PlanarContactModel, q):
    """Per-body world origin (x, z), absolute angle, and hinge-anchor
    world position from the qpos tuple."""
    nb = len(model.bodies)
    ox, oz, th = [None] * nb, [None] * nb, [None] * nb
    awx, awz = [None] * nb, [None] * nb
    for bi, b in enumerate(model.bodies):
        if b.parent == -1:
            rx, rz = model.root_offset
            bx, bz = q[0] + rx, q[1] + rz
            th[bi] = b.sign * q[b.dof]
            ax, az = b.anchor
            if ax == 0.0 and az == 0.0:
                ox[bi], oz[bi] = bx, bz
                awx[bi], awz[bi] = bx, bz
            else:
                c, s = jnp.cos(th[bi]), jnp.sin(th[bi])
                awx[bi], awz[bi] = bx + ax, bz + az
                ox[bi] = awx[bi] - (c * ax + s * az)
                oz[bi] = awz[bi] - (-s * ax + c * az)
        else:
            p = b.parent
            cp, sp = jnp.cos(th[p]), jnp.sin(th[p])
            th[bi] = th[p] + b.sign * q[b.dof]
            px, pz = b.pos
            ax, az = b.anchor
            # anchor_world = origin_p + R_p·(pos + anchor)
            awx[bi] = ox[p] + cp * (px + ax) + sp * (pz + az)
            awz[bi] = oz[p] - sp * (px + ax) + cp * (pz + az)
            if ax == 0.0 and az == 0.0:
                ox[bi], oz[bi] = awx[bi], awz[bi]
            else:
                c, s = jnp.cos(th[bi]), jnp.sin(th[bi])
                ox[bi] = awx[bi] - (c * ax + s * az)
                oz[bi] = awz[bi] - (-s * ax + c * az)
    return ox, oz, th, awx, awz


def make_kinematics(model: PlanarContactModel):
    """Kinematics function for build_planar_dynamics: per-body world com
    coordinates then absolute angles, plus the kinetic-energy weights and
    gravity potential coefficients."""
    nb = len(model.bodies)

    def kin(q):
        ox, oz, th, _, _ = frames(model, q)
        out = []
        for bi, b in enumerate(model.bodies):
            c, s = jnp.cos(th[bi]), jnp.sin(th[bi])
            cx, cz = b.com
            out.append(ox[bi] + c * cx + s * cz)
            out.append(oz[bi] - s * cx + c * cz)
        out.extend(th)
        return tuple(out)

    weights = tuple(
        w for b in model.bodies for w in (b.mass, b.mass)
    ) + tuple(b.iyy for b in model.bodies)
    pot = tuple(
        c for b in model.bodies for c in (0.0, b.mass * model.gravity)
    ) + (0.0,) * nb
    return kin, weights, pot


def build_ad_dynamics(model: PlanarContactModel):
    """Energy-AD (jacfwd/jvp) mass/bias via build_planar_dynamics — the
    round-1 route, kept as the independent cross-check for the analytic
    forms below (tests pin them equal to ~1e-14)."""
    kin, weights, pot = make_kinematics(model)
    return build_planar_dynamics(
        kin,
        kin_weights=weights,
        pot_coeffs=pot,
        n_dof=model.n_dof,
        damping=(0.0,) * model.n_dof,
        armature=model.armature,
        limits=(),
        timestep=model.timestep,
    )


def mass_entries_analytic(model: PlanarContactModel, q):
    """Mass matrix lower triangle from the analytic com Jacobians.

    M_ij = Σ_b m_b J^b_i·J^b_j + Σ_b I_b w_i w_j + armature·δ_ij, where
    J^b_d = s_d·rot(p_b − a_d) for hinge dofs in body b's chain (rot(v) =
    (v_z, −v_x)), the identity columns for the root slides, and w_d = s_d
    on chain hinges (1 for rooty). Identical values to the AD route
    (build_planar_dynamics' jacfwd — pinned in tests), but ~3x fewer ops,
    chain-sparsity aware, and free of AD transforms — the form the Pallas
    rollout kernel traces."""
    n = model.n_dof
    ox, oz, th, awx, awz = frames(model, q)
    chains = model.chains
    m = [[0.0] * (i + 1) for i in range(n)]
    for d in range(n):
        m[d][d] = model.armature[d]
    for bi, b in enumerate(model.bodies):
        c, s = jnp.cos(th[bi]), jnp.sin(th[bi])
        cx, cz = b.com
        px = ox[bi] + c * cx + s * cz
        pz = oz[bi] - s * cx + c * cz
        # com Jacobian columns: dof -> (Jx, Jz); slides first
        cols = {0: (1.0, 0.0), 1: (0.0, 1.0)}
        wcols = {}
        for body in chains[bi]:
            bb = model.bodies[body]
            cols[bb.dof] = (
                bb.sign * (pz - awz[body]),
                -bb.sign * (px - awx[body]),
            )
            wcols[bb.dof] = bb.sign
        dofs = sorted(cols)
        for i_idx, di in enumerate(dofs):
            jxi, jzi = cols[di]
            for dj in dofs[: i_idx + 1]:
                jxj, jzj = cols[dj]
                hi, lo = max(di, dj), min(di, dj)
                m[hi][lo] = m[hi][lo] + b.mass * (jxi * jxj + jzi * jzj)
        wd = sorted(wcols)
        for i_idx, di in enumerate(wd):
            for dj in wd[: i_idx + 1]:
                hi, lo = max(di, dj), min(di, dj)
                m[hi][lo] = m[hi][lo] + b.iyy * wcols[di] * wcols[dj]
    # promote any remaining python-float zeros to arrays
    one = jnp.ones_like(q[0])
    for i in range(n):
        for j in range(i + 1):
            m[i][j] = m[i][j] * one
    return m


def bias_analytic(model: PlanarContactModel, q, qv):
    """Coriolis/centrifugal + gravity generalized forces, analytically.

    Recursive velocity/acceleration propagation down the tree with q̈=0:
    ȧ_b = ȧ_p + ω_p·rot(a_b − a_p), ä_b = ä_p + ω_p·rot(ȧ_b − ȧ_p),
    ṗ = ȧ_b + ω_b·rot(p − a_b), p̈ = ä_b + ω_b·rot(ṗ − ȧ_b) (the angles
    are linear in q, so the angular velocities carry no Coriolis of their
    own). bias_i = Σ_b m_b J^b_i·p̈_b + g·m_b·(J^b_i)_z. Matches the
    energy-AD bias of build_planar_dynamics (pinned in tests)."""
    n = model.n_dof
    ox, oz, th, awx, awz = frames(model, q)
    chains = model.chains
    nb = len(model.bodies)
    omega = [None] * nb  # total angular velocity per body
    vax, vaz = [None] * nb, [None] * nb  # anchor velocity
    aax, aaz = [None] * nb, [None] * nb  # anchor acceleration (q̈=0)
    zero = jnp.zeros_like(q[0])
    for bi, b in enumerate(model.bodies):
        if b.parent == -1:
            omega[bi] = b.sign * qv[b.dof]
            vax[bi], vaz[bi] = qv[0], qv[1]
            aax[bi], aaz[bi] = zero, zero
        else:
            p = b.parent
            omega[bi] = omega[p] + b.sign * qv[b.dof]
            dx, dz = awx[bi] - awx[p], awz[bi] - awz[p]
            vax[bi] = vax[p] + omega[p] * dz
            vaz[bi] = vaz[p] - omega[p] * dx
            vdx, vdz = vax[bi] - vax[p], vaz[bi] - vaz[p]
            aax[bi] = aax[p] + omega[p] * vdz
            aaz[bi] = aaz[p] - omega[p] * vdx
    out = [zero] * n
    g = model.gravity
    for bi, b in enumerate(model.bodies):
        c, s = jnp.cos(th[bi]), jnp.sin(th[bi])
        cx, cz = b.com
        px = ox[bi] + c * cx + s * cz
        pz = oz[bi] - s * cx + c * cz
        rx, rz = px - awx[bi], pz - awz[bi]
        vpx = vax[bi] + omega[bi] * rz
        vpz = vaz[bi] - omega[bi] * rx
        apx = aax[bi] + omega[bi] * (vpz - vaz[bi])
        apz = aaz[bi] - omega[bi] * (vpx - vax[bi])
        fx = b.mass * apx
        fz = b.mass * (apz + g)
        out[0] = out[0] + fx
        out[1] = out[1] + fz
        for body in chains[bi]:
            bb = model.bodies[body]
            jx = bb.sign * (pz - awz[body])
            jz = -bb.sign * (px - awx[body])
            out[bb.dof] = out[bb.dof] + jx * fx + jz * fz
    return tuple(out)


def contact_rows(model: PlanarContactModel, q, qv, zero):
    """Constraint rows: (J as n_dof scalars, aref, R, active) per row.

    Jacobians are analytic over the static kinematic chains: a hinge dof
    with axis sign s anchored at world (ax, az) contributes
    ∂p_z/∂q = −s·(p_x − ax) and ∂p_x/∂q = s·(p_z − az); slides contribute
    identity entries. Normal rows use the sphere-center x; tangential
    rows use the CONTACT POINT z = dist/2 (verified against efc_J).
    `zero` is the caller's structural-zero sentinel: the solver skips J
    entries that ARE this object, so it must be shared (XLA does not fold
    float x·0)."""
    chains = model.chains
    rows = []
    for lim in model.limits:
        d_lo = q[lim.dof] - lim.lo
        d_hi = lim.hi - q[lim.dof]
        lower_closer = d_lo < d_hi
        pos = jnp.where(lower_closer, d_lo, d_hi)
        sgn = jnp.where(lower_closer, 1.0, -1.0)
        d0, dmax, width = lim.solimp
        imp = impedance(pos, d0=d0, dmax=dmax, width=width)
        kc, bc = model.kb(dmax)
        aref = -bc * (sgn * qv[lim.dof]) - kc * imp * pos
        r_reg = (1.0 - imp) / imp * model.dof_invweight0[lim.dof]
        j = [zero] * model.n_dof
        j[lim.dof] = sgn
        rows.append((j, aref, r_reg, pos < 0.0))

    ox, oz, th, awx, awz = frames(model, q)
    for con in model.contacts:
        bi = con.body
        c, s = jnp.cos(th[bi]), jnp.sin(th[bi])
        lx, lz = con.local
        px = ox[bi] + c * lx + s * lz
        pz = oz[bi] - s * lx + c * lz
        dist = pz - con.radius
        active = dist < con.margin
        cpz = 0.5 * dist  # contact point z (midpoint of the overlap)
        jn = [zero] * model.n_dof
        jt = [zero] * model.n_dof
        jn[1] = jnp.ones_like(q[0])  # rootz
        jt[0] = jnp.ones_like(q[0])  # rootx
        for body in chains[bi]:
            b = model.bodies[body]
            ax, az = awx[body], awz[body]
            jn[b.dof] = -b.sign * (px - ax)
            jt[b.dof] = b.sign * (cpz - az)
        d0, dmax, width = con.solimp
        pos_m = dist - con.margin
        imp = impedance(pos_m, d0=d0, dmax=dmax, width=width)
        kc, bc = model.kb(dmax)
        mu = con.mu
        r_factor = 2.0 * mu * mu * (1.0 + mu * mu)
        r_reg = (1.0 - imp) / imp * model.body_invweight0[bi] * r_factor
        jv_n = sum(
            jn[d] * qv[d] for d in range(model.n_dof) if jn[d] is not zero
        )
        jv_t = sum(
            jt[d] * qv[d] for d in range(model.n_dof) if jt[d] is not zero
        )
        base_aref = -kc * imp * pos_m
        # rows n ± μ t (preserve structural-zero identity for sparsity)
        for sgn in (1.0, -1.0):
            j = []
            for d in range(model.n_dof):
                if jn[d] is zero and jt[d] is zero:
                    j.append(zero)
                elif jn[d] is zero:
                    j.append(sgn * mu * jt[d])
                elif jt[d] is zero:
                    j.append(jn[d])
                else:
                    j.append(jn[d] + sgn * mu * jt[d])
            aref = -bc * (jv_n + sgn * mu * jv_t) + base_aref
            rows.append((j, aref, r_reg, active))
        # merged pure-normal pair: R/2 and the pair-total λ (see n_rows)
        rows.append((list(jn), -bc * jv_n + base_aref, 0.5 * r_reg, active))

    def _world(bi, pt):
        c, s = jnp.cos(th[bi]), jnp.sin(th[bi])
        return (ox[bi] + c * pt[0] + s * pt[1],
                oz[bi] - s * pt[0] + c * pt[1])

    for pair in model.pairs:
        b1, b2 = pair.body1, pair.body2
        p1x, p1z = _world(b1, pair.a1)
        q1x, q1z = _world(b1, pair.b1)
        p2x, p2z = _world(b2, pair.a2)
        q2x, q2z = _world(b2, pair.b2)
        # closest points between the two segments (Ericson's algorithm,
        # branchless); a and e are the squared segment lengths (static)
        d1x, d1z = q1x - p1x, q1z - p1z
        d2x, d2z = q2x - p2x, q2z - p2z
        rx, rz = p1x - p2x, p1z - p2z
        la = d1x * d1x + d1z * d1z
        le = d2x * d2x + d2z * d2z
        lf = d2x * rx + d2z * rz
        lc = d1x * rx + d1z * rz
        lb = d1x * d2x + d1z * d2z
        denom = la * le - lb * lb  # = L1²L2²sin²φ ≥ 0
        s_seg = jnp.where(
            denom > 1e-12 * la * le,
            jnp.clip((lb * lf - lc * le) / jnp.maximum(denom, 1e-30), 0.0, 1.0),
            0.0,
        )
        t_raw = (lb * s_seg + lf) / le
        t_seg = jnp.clip(t_raw, 0.0, 1.0)
        s_seg = jnp.where(
            t_raw < 0.0,
            jnp.clip(-lc / la, 0.0, 1.0),
            jnp.where(t_raw > 1.0, jnp.clip((lb - lc) / la, 0.0, 1.0), s_seg),
        )
        c1x, c1z = p1x + s_seg * d1x, p1z + s_seg * d1z
        c2x, c2z = p2x + t_seg * d2x, p2z + t_seg * d2z
        dx, dz = c2x - c1x, c2z - c1z
        seg_len = jnp.sqrt(jnp.maximum(dx * dx + dz * dz, 1e-24))
        nx, nz = dx / seg_len, dz / seg_len  # normal: geom1 → geom2
        dist = seg_len - pair.r1 - pair.r2
        active = dist < pair.margin
        # contact point: midpoint of the two surface points
        cx = c1x + nx * (pair.r1 + 0.5 * dist)
        cz = c1z + nz * (pair.r1 + 0.5 * dist)
        # J = n·(v₂(c) − v₁(c)); shared chain-prefix dofs cancel exactly,
        # so only the symmetric difference is emitted (preserves the
        # structural sparsity the solver skips on)
        set1, set2 = set(chains[b1]), set(chains[b2])
        j = [zero] * model.n_dof
        jv = zero
        for body, sgn_chain in (
            *(((bb, 1.0) for bb in chains[b2] if bb not in set1)),
            *(((bb, -1.0) for bb in chains[b1] if bb not in set2)),
        ):
            b = model.bodies[body]
            ax, az = awx[body], awz[body]
            contrib = sgn_chain * b.sign * (nx * (cz - az) - nz * (cx - ax))
            j[b.dof] = contrib
            jv = jv + contrib * qv[b.dof]
        d0, dmax, width = pair.solimp
        pos_m = dist - pair.margin
        imp = impedance(pos_m, d0=d0, dmax=dmax, width=width)
        kc, bc = model.kb(dmax)
        r_reg = (1.0 - imp) / imp * (
            model.body_invweight0[b1] + model.body_invweight0[b2]
        )
        aref = -bc * jv - kc * imp * pos_m
        rows.append((j, aref, r_reg, active))
    return rows


def solve_qp(
    rows, zero, l_chol, a_smooth, outer: int, cg: int, n_dof: int,
    lam0=None, return_lam: bool = False,
):
    """Fixed-iteration active-set/CG solve of the strictly convex box-QP
    min ½λᵀ(A+R)λ − rhsᵀλ, λ≥0 (A = J M⁻¹ Jᵀ), matrix-free through the
    static-sparsity J (`zero` is the shared structural-zero sentinel the
    rows were built with). Returns qfrc_constraint as an n_dof tuple.
    Matches MuJoCo's Newton optimum to machine precision at (6, 40) on
    realistic trajectories (measured on CPU in f64).

    `lam0` ((n_rows,) + sample shape) WARM-STARTS the solve from the
    previous substep's multipliers (contact forces are continuous in
    time, so the active set and magnitudes carry over — measured: warm
    (2,8) matches cold (3,16) accuracy at ~2x less work). Rows invalid
    at THIS state are zeroed on entry so stale forces can't leak."""
    n = len(rows)

    def j_t_apply(lam_rows):
        u = [zero] * n_dof
        for r, (j, _a, _r, _act) in enumerate(rows):
            lr = lam_rows[r]
            for d in range(n_dof):
                if j[d] is not zero:
                    u[d] = u[d] + lr * j[d]
        return u

    def a_apply(lam_rows):
        u = j_t_apply(lam_rows)
        w = chol_solve_unrolled(l_chol, u, n_dof)
        out = []
        for j, _a, _r, _act in rows:
            s = zero
            for d in range(n_dof):
                if j[d] is not zero:
                    s = s + j[d] * w[d]
            out.append(s)
        return out

    rhs = []
    for j, aref, _r, act in rows:
        s = zero
        for d in range(n_dof):
            if j[d] is not zero:
                s = s + j[d] * a_smooth[d]
        rhs.append(jnp.where(act, aref - s, 0.0))
    rhs = jnp.stack(rhs)  # (n, ...) K-minor
    r_diag = jnp.stack([r[2] for r in rows])
    valid = jnp.stack([jnp.broadcast_to(r[3], rhs[0].shape) for r in rows])

    def ar_apply(lam):
        a = a_apply([lam[r] for r in range(n)])
        return jnp.stack(a) + r_diag * lam

    lam = _qp_iterate(ar_apply, rhs, valid, lam0, outer, cg)
    qfrc = tuple(j_t_apply([lam[r] for r in range(n)]))
    if return_lam:
        return qfrc, lam
    return qfrc


def _qp_iterate(ar_apply, rhs, valid, lam0, outer: int, cg: int):
    """The fixed-iteration active-set/CG/arc-search core of solve_qp,
    parameterized over the (A+R)·λ application so the scalar-sparse
    (planar) and dense-stacked-J (spatial) row representations share one
    verified iteration. Returns the multiplier block λ (same shape as
    rhs)."""
    if lam0 is None:
        lam0 = jnp.zeros_like(rhs)
    else:
        lam0 = jnp.where(valid, lam0, 0.0)
    zeros_lam = jnp.zeros_like(rhs)

    def outer_body(_i, lam):
        grad = ar_apply(lam) - rhs
        active = valid & ((lam > 0.0) | (grad < 0.0))
        x0 = jnp.where(active, lam, 0.0)

        def masked_ar(v):
            return jnp.where(active, ar_apply(jnp.where(active, v, 0.0)), 0.0)

        r0 = jnp.where(active, rhs - ar_apply(x0), 0.0)

        def cg_body(_, carry):
            x, r, p, rs = carry
            ap = masked_ar(p)
            denom = jnp.sum(p * ap, axis=0)
            alpha = jnp.where(denom > 1e-30, rs / jnp.maximum(denom, 1e-30), 0.0)
            x = x + alpha * p
            r = r - alpha * ap
            rs_new = jnp.sum(r * r, axis=0)
            beta = jnp.where(rs > 1e-30, rs_new / jnp.maximum(rs, 1e-30), 0.0)
            p = r + beta * p
            return (x, r, p, rs_new)

        x, _, _, _ = jax.lax.fori_loop(
            0, cg, cg_body, (x0, r0, r0, jnp.sum(r0 * r0, axis=0))
        )
        # projected ARC search (Bertsekas projected-Newton style): the
        # naive solve-then-project update can CYCLE between wrong active
        # sets or stall (both observed on Walker2d fallen-flat multi-
        # contact states). Along the arc
        # λ(t) = max(λ + t·(x − λ), 0) the small-t direction is a Newton
        # descent direction on the free set, so picking the best of a
        # fixed trial ladder (t=0 included) is monotone and breaks the
        # cycle; at a clean reduced solve t=1 wins and the update is the
        # exact constrained optimum (converged behavior unchanged —
        # verified: 3 outer its reach MuJoCo's Newton optimum to 8e-13
        # on the stall case).
        delta = jnp.where(active, x - lam, 0.0)
        # f(λ) = ½λᵀGλ − rhsᵀλ = ½λᵀgrad − ½rhsᵀλ (grad already known)
        best_f = 0.5 * jnp.sum(lam * grad, axis=0) - 0.5 * jnp.sum(
            rhs * lam, axis=0
        )
        best_lam = lam
        for t in (1.0, 0.5, 0.25, 0.1, 0.03, 0.01):
            lam_t = jnp.maximum(lam + t * delta, 0.0)
            g_t = masked_ar(lam_t)
            f_t = 0.5 * jnp.sum(lam_t * g_t, axis=0) - jnp.sum(
                rhs * lam_t, axis=0
            )
            take = f_t < best_f
            best_f = jnp.where(take, f_t, best_f)
            best_lam = jnp.where(take, lam_t, best_lam)
        return best_lam

    # Contact-free fast path: when NO row is active anywhere in this batch
    # (hopper/walker flight phases — under vmap "batch" is one sample),
    # the unique optimum is
    # λ = 0 exactly (rhs and the warm start are already masked to 0), so
    # the whole active-set/CG/arc-search iteration is skipped. Bitwise
    # identical to running the solve: every iterate stays 0.
    any_active = jnp.any(valid)
    return jax.lax.cond(
        any_active,
        lambda l0: jax.lax.fori_loop(0, outer, outer_body, l0),
        lambda l0: zeros_lam,
        lam0,
    )


def solve_qp_dense(
    rows, zero, l_chol, a_smooth, outer: int, cg: int, n_dof: int,
    lam0=None, return_lam: bool = False,
):
    """solve_qp with the row Jacobians STACKED into one (n_rows, n_dof)
    array so each J/Jᵀ application is a single reduction instead of
    n_rows×n_dof scalar HLO ops. Same rows contract, same _qp_iterate
    core, same answer; built for the spatial (3D) family whose scalar
    graphs (108 rows × 14 dofs × RK4) made XLA CPU compiles take tens of
    minutes — the dense form compiles ~an order of magnitude faster and
    is K-vectorized identically under vmap."""
    n = len(rows)
    shp = jnp.shape(rows[0][1])

    def _mat(v):
        if isinstance(v, (int, float)):
            return jnp.broadcast_to(jnp.asarray(v, dtype=zero.dtype), shp)
        return jnp.broadcast_to(v, shp)

    jmat = jnp.stack([
        jnp.stack([_mat(j[d]) for d in range(n_dof)]) for j, *_ in rows
    ])  # (n_rows, n_dof) + sample shape
    a_sm = jnp.stack([_mat(a) for a in a_smooth])
    rhs = jnp.stack([
        jnp.where(act, aref - jnp.sum(jmat[r] * a_sm, axis=0), 0.0)
        for r, (_j, aref, _r, act) in enumerate(rows)
    ])
    r_diag = jnp.stack([_mat(r[2]) for r in rows])
    valid = jnp.stack([jnp.broadcast_to(r[3], shp) for r in rows])

    def j_t_apply(lam):  # (n_rows,)+S -> (n_dof,)+S
        return jnp.sum(jmat * lam[:, None], axis=0)

    def ar_apply(lam):
        u = j_t_apply(lam)
        w = chol_solve_unrolled(
            l_chol, [u[d] for d in range(n_dof)], n_dof
        )
        a = jnp.sum(jmat * jnp.stack(w)[None], axis=1)
        return a + r_diag * lam

    lam = _qp_iterate(ar_apply, rhs, valid, lam0, outer, cg)
    u = j_t_apply(lam)
    qfrc = tuple(u[d] for d in range(n_dof))
    if return_lam:
        return qfrc, lam
    return qfrc


def build_contact_stepper(model: PlanarContactModel, extra_force=None):
    """Build (substep, mass_entries, bias, qfrc_smooth) for the model.

    substep(q, qv, tau, outer, cg) advances ONE physics timestep with the
    model's integrator; q/qv are n_dof tuples of scalars (vmap makes them
    (K,) vectors), tau the n_dof generalized-force tuple. `extra_force`
    (q, qv) -> n_dof tuple adds state-dependent applied forces into
    qfrc_smooth (e.g. the swimmer's fluid wrench), re-evaluated at every
    integrator stage like MuJoCo's qfrc_passive."""
    n = model.n_dof

    def mass_entries(q):
        return mass_entries_analytic(model, q)

    def bias(q, qv):
        return bias_analytic(model, q, qv)

    def qfrc_smooth(q, qv, tau):
        b = bias(q, qv)
        out = [
            tau[d] - b[d] - model.damping[d] * qv[d]
            - model.stiffness[d] * q[d]
            for d in range(n)
        ]
        if extra_force is not None:
            f = extra_force(q, qv)
            out = [o + f[d] for d, o in enumerate(out)]
        return out

    def qacc_warm(q, qv, tau, outer, cg, lam0):
        """Full constrained forward dynamics (one mj_forward), warm-
        startable; returns (acc tuple, λ)."""
        m = mass_entries(q)
        l = chol_unrolled(m, n)
        smooth = qfrc_smooth(q, qv, tau)
        a_smooth = chol_solve_unrolled(l, smooth, n)
        zero = jnp.zeros_like(q[0])
        rows = contact_rows(model, q, qv, zero)
        qfrc_c, lam = solve_qp(
            rows, zero, l, a_smooth, outer, cg, n, lam0=lam0, return_lam=True
        )
        acc = chol_solve_unrolled(
            l, [smooth[d] + qfrc_c[d] for d in range(n)], n
        )
        return acc, lam

    def qacc_constrained(q, qv, tau, outer, cg):
        """Cold-start constrained forward dynamics (acc tuple only)."""
        return qacc_warm(q, qv, tau, outer, cg, None)[0]

    h = model.timestep

    def euler_implicit_substep(q, qv, tau, outer, cg, lam0=None):
        m = mass_entries(q)
        l = chol_unrolled(m, n)
        smooth = qfrc_smooth(q, qv, tau)
        a_smooth = chol_solve_unrolled(l, smooth, n)
        zero = jnp.zeros_like(q[0])
        rows = contact_rows(model, q, qv, zero)
        qfrc_c, lam = solve_qp(
            rows, zero, l, a_smooth, outer, cg, n, lam0=lam0, return_lam=True
        )
        # implicit damping: (M + h·D) Δv/h = smooth + qfrc_c (λ was solved
        # against the UNDAMPED M — probed round 1)
        md = [[m[i][j] for j in range(i + 1)] for i in range(n)]
        for d in range(n):
            md[d][d] = md[d][d] + h * model.damping[d]
        ld = chol_unrolled(md, n)
        acc = chol_solve_unrolled(
            ld, [smooth[d] + qfrc_c[d] for d in range(n)], n
        )
        qv2 = tuple(qv[d] + h * acc[d] for d in range(n))
        q2 = tuple(q[d] + h * qv2[d] for d in range(n))
        return q2, qv2, lam

    def rk4_substep(q, qv, tau, outer, cg, lam0=None):
        """mj_RungeKutta: the constrained dynamics (contact QP included)
        is evaluated at each of the 4 stages; λ warm-starts chain through
        the stages (the stage states differ by O(h))."""

        def add(a, b, hh):
            return tuple(x + hh * y for x, y in zip(a, b))

        k1v, lam = qacc_warm(q, qv, tau, outer, cg, lam0)
        k1q = qv
        q2, v2 = add(q, k1q, 0.5 * h), add(qv, k1v, 0.5 * h)
        k2v, lam = qacc_warm(q2, v2, tau, outer, cg, lam)
        k2q = v2
        q3, v3 = add(q, k2q, 0.5 * h), add(qv, k2v, 0.5 * h)
        k3v, lam = qacc_warm(q3, v3, tau, outer, cg, lam)
        k3q = v3
        q4, v4 = add(q, k3q, h), add(qv, k3v, h)
        k4v, lam = qacc_warm(q4, v4, tau, outer, cg, lam)
        k4q = v4
        qn = tuple(
            a + (h / 6.0) * (b + 2.0 * c + 2.0 * d + e)
            for a, b, c, d, e in zip(q, k1q, k2q, k3q, k4q)
        )
        vn = tuple(
            a + (h / 6.0) * (b + 2.0 * c + 2.0 * d + e)
            for a, b, c, d, e in zip(qv, k1v, k2v, k3v, k4v)
        )
        return qn, vn, lam

    substep = (
        euler_implicit_substep
        if model.integrator == "euler_implicit"
        else rk4_substep
    )
    return substep, mass_entries, bias, qfrc_smooth, qacc_constrained
