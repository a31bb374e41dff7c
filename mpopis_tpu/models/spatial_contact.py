"""Generic on-device SPATIAL (3D) MuJoCo dynamics WITH contacts.

Generalization of the planar-contact pipeline (models/planar_contact.py)
to full 3D kinematic trees — free-joint roots with quaternion attitude,
hinge joints about arbitrary axes, sphere/capsule-vs-plane contacts with
3D pyramidal friction cones. This is what the remaining reference MuJoCo
tasks (Ant, Humanoid, HumanoidStandup, Pusher — reached through envpool
in the reference, src/envs/envpool_env.jl:35-61) need that the planar
family could not express.

Every convention below was probed numerically against the mujoco wheel
on Ant (machine-precision agreement; see git history for the probe
sessions):

- FREE JOINT: qpos carries (x, y, z, qw, qx, qy, qz); qvel carries the
  world-frame linear velocity followed by the BODY-FRAME angular
  velocity (verified: mj_integratePos rotates by quat ⊗ exp(h/2·ω), the
  LOCAL composition). The rotational dof world axes are the columns of
  the root rotation matrix; the rotation anchor is the body origin.
- MASS MATRIX: M_ij = Σ_b m_b Jv_i·Jv_j + Jω_i·(R I_b Rᵀ)·Jω_j +
  armature·δ_ij over com Jacobian columns (hinge dof: Jω = a_w,
  Jv = a_w × (p − anchor_w); free trans: Jv = e_i; free rot: Jω = R e_i,
  Jv = (R e_i) × (p − root)). Matches mj_fullM to 5e-17 on random
  states.
- BIAS: recursive ω/α and origin-point velocity/acceleration propagation
  with q̈ = 0 (α_root = 0 exactly — d/dt(R ω_local) = ω×ω = 0), per-body
  wrench F = m(a_com − g), T = I_w α + ω×(I_w ω) (the gyroscopic term is
  the one genuinely new physical term vs planar), projected onto the dof
  columns. Matches qfrc_bias to 6e-16.
- CONTACTS: candidates are sphere centers / capsule end-sphere centers
  vs the z=0 floor plane; dist = p_z − radius, active when dist <
  includemargin (sum of both geoms' margins — 0.02 on Ant), contact
  point at z = dist/2. condim-3 PYRAMIDAL cone ⇒ 4 rows per contact,
  J = J_n ± μ·J_t1, J_n ± μ·J_t2. The tangent frame is geometry-
  dependent (probed over 200 random Ant states): capsule-plane uses
  t1 = the normalized in-plane projection of the capsule axis (exact
  sign), sphere-plane uses mju_makeFrame's t1 = (0, 1, 0), and
  t2 = n × t1 in both cases. Per-row regularizer
  R = (1−imp)/imp · (bw₁+bw₂) · 2μ²(1+μ²), aref = −b·(J q̇) −
  k·imp·(pos − margin) with the planar family's KBIP rules.
- INTEGRATORS: `rk4` — mj_RungeKutta with stage positions
  integrate_pos(q₀, v_stage, c·h) and the final position
  integrate_pos(q₀, (k1+2k2+2k3+k4)/6, h); quaternions advance by the
  exponential map of the body-frame angular velocity and are normalized
  (mj_step normalizes qpos quaternions — probed: a non-unit quat is
  written back normalized). `euler_implicit` — as in the planar family.

The box-QP over contact rows reuses the planar solver's iteration core
verbatim (planar_contact._qp_iterate — machine-precision match to
MuJoCo's Newton) through the DENSE stacked-J entry point
(solve_qp_dense): at n=14 dofs × 108 rows the scalar-sparse J
application would emit ~10⁵ scalar HLO ops per forward and make XLA CPU
compiles take tens of minutes; stacking J into one (rows, dofs) array
keeps the same math in a handful of array ops. λ warm starts and the
contact-free fast path carry over unchanged.

Layout discipline: everything is a SCALAR expression over tuples
(vmap makes each a dense (K,) vector). Static model constants stay
python floats; `_mul`/`_add` below short-circuit them so identity body
quats, axis zeros and static anchors never emit device ops (the planar
family did this by hand; 3D needs it systematically).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from mpopis_tpu.models.planar import (
    chol_solve_unrolled,
    chol_unrolled,
    impedance,
)
from mpopis_tpu.models.planar_contact import solve_qp, solve_qp_dense


# --- static-constant-aware scalar arithmetic -------------------------------
def _is_const(a) -> bool:
    return isinstance(a, (int, float))


def _mul(a, b):
    if _is_const(a):
        if a == 0.0:
            return 0.0
        if a == 1.0:
            return b
        if _is_const(b):
            return a * b
    if _is_const(b):
        if b == 0.0:
            return 0.0
        if b == 1.0:
            return a
    return a * b


def _add(a, b):
    if _is_const(a) and a == 0.0:
        return b
    if _is_const(b) and b == 0.0:
        return a
    if _is_const(a) and _is_const(b):
        return a + b
    return a + b


def _sub(a, b):
    if _is_const(b) and b == 0.0:
        return a
    if _is_const(a) and a == 0.0:
        return -b if not _is_const(b) else -b
    if _is_const(a) and _is_const(b):
        return a - b
    return a - b


def _dot3(a, b):
    return _add(_add(_mul(a[0], b[0]), _mul(a[1], b[1])), _mul(a[2], b[2]))


def _cross3(a, b):
    return (
        _sub(_mul(a[1], b[2]), _mul(a[2], b[1])),
        _sub(_mul(a[2], b[0]), _mul(a[0], b[2])),
        _sub(_mul(a[0], b[1]), _mul(a[1], b[0])),
    )


def _vadd(a, b):
    return tuple(_add(x, y) for x, y in zip(a, b))


def _vsub(a, b):
    return tuple(_sub(x, y) for x, y in zip(a, b))


def _vscale(s, a):
    return tuple(_mul(s, x) for x in a)


def _rvec(r, v):
    """Apply 9-tuple (row-major) rotation to a 3-tuple."""
    return (
        _add(_add(_mul(r[0], v[0]), _mul(r[1], v[1])), _mul(r[2], v[2])),
        _add(_add(_mul(r[3], v[0]), _mul(r[4], v[1])), _mul(r[5], v[2])),
        _add(_add(_mul(r[6], v[0]), _mul(r[7], v[1])), _mul(r[8], v[2])),
    )


def _rtvec(r, v):
    """Apply the TRANSPOSE of a 9-tuple rotation to a 3-tuple."""
    return (
        _add(_add(_mul(r[0], v[0]), _mul(r[3], v[1])), _mul(r[6], v[2])),
        _add(_add(_mul(r[1], v[0]), _mul(r[4], v[1])), _mul(r[7], v[2])),
        _add(_add(_mul(r[2], v[0]), _mul(r[5], v[1])), _mul(r[8], v[2])),
    )


def _rmul(a, b):
    """3x3 @ 3x3 on row-major 9-tuples."""
    out = []
    for i in range(3):
        for j in range(3):
            out.append(
                _add(
                    _add(
                        _mul(a[3 * i + 0], b[0 + j]),
                        _mul(a[3 * i + 1], b[3 + j]),
                    ),
                    _mul(a[3 * i + 2], b[6 + j]),
                )
            )
    return tuple(out)


def _qmat(w, x, y, z):
    """Quaternion (w,x,y,z) -> row-major 9-tuple rotation."""
    return (
        _sub(1.0, _mul(2.0, _add(_mul(y, y), _mul(z, z)))),
        _mul(2.0, _sub(_mul(x, y), _mul(w, z))),
        _mul(2.0, _add(_mul(x, z), _mul(w, y))),
        _mul(2.0, _add(_mul(x, y), _mul(w, z))),
        _sub(1.0, _mul(2.0, _add(_mul(x, x), _mul(z, z)))),
        _mul(2.0, _sub(_mul(y, z), _mul(w, x))),
        _mul(2.0, _sub(_mul(x, z), _mul(w, y))),
        _mul(2.0, _add(_mul(y, z), _mul(w, x))),
        _sub(1.0, _mul(2.0, _add(_mul(x, x), _mul(y, y)))),
    )


_R_IDENT = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


def _axis_rot_static(axis, ang):
    """Rodrigues rotation about a STATIC unit axis by a traced angle;
    the K and K² coefficient matrices fold to python floats."""
    ax, ay, az = axis
    k = (0.0, -az, ay, az, 0.0, -ax, -ay, ax, 0.0)
    k2 = [0.0] * 9
    for i in range(3):
        for j in range(3):
            k2[3 * i + j] = sum(k[3 * i + l] * k[3 * l + j] for l in range(3))
    c, s = jnp.cos(ang), jnp.sin(ang)
    one_c = 1.0 - c
    out = []
    for i in range(9):
        e = 1.0 if i in (0, 4, 8) else 0.0
        term = e
        if k[i] != 0.0:
            term = _add(term, _mul(s, k[i]))
        if k2[i] != 0.0:
            term = _add(term, _mul(one_c, k2[i]))
        out.append(term)
    return tuple(out)


# --- model tables -----------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SJoint:
    """One joint attached to a body. kind: 'free' | 'hinge' | 'slide'.
    `axis` and `anchor` (jnt_pos) are in the OWNING body's frame;
    `dof`/`qadr` index into qvel/qpos."""

    kind: str
    dof: int
    qadr: int
    axis: tuple[float, float, float] = (0.0, 0.0, 1.0)
    anchor: tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class SCBody:
    """One body of the spatial tree. `pos`/`quat` are the static frame
    offset in the parent frame; `joints` apply in declaration order
    (each body carries 0 or 1 joint in the supported models; the free
    root carries exactly one). `inertia` is the FULL body-frame inertia
    (ixx, ixy, ixz, iyy, iyz, izz) = R_iquat diag(principal) R_iquatᵀ —
    the planar family's round-1 tilted-iquat lesson, systematized."""

    parent: int
    pos: tuple[float, float, float]
    quat: tuple[float, float, float, float]
    joints: tuple[SJoint, ...]
    com: tuple[float, float, float]
    mass: float
    inertia: tuple[float, float, float, float, float, float]


@dataclasses.dataclass(frozen=True)
class SCContact:
    """One candidate floor contact: a sphere (or capsule end sphere)
    center vs the z=0 plane. `axis_local` is the capsule axis direction
    in the body frame (None for spheres): the contact tangent frame is
    t1 = normalize(project_xy(R_b·axis_local)), t2 = n × t1 (probed —
    sphere-plane uses the fixed t1 = (0,1,0))."""

    body: int
    local: tuple[float, float, float]
    radius: float
    mu: float
    margin: float
    solimp: tuple[float, float, float]
    axis_local: tuple[float, float, float] | None = None
    # 3 => 4 pyramidal rows; 1 => a single frictionless normal row
    # (probed on Pusher: R = (1-imp)/imp * sum(bw), no pyramid factor)
    condim: int = 3


@dataclasses.dataclass(frozen=True)
class SCPairCylinder:
    """Capsule (on body1) vs UPRIGHT cylinder (on body2) — the Pusher
    arm-object interaction. Valid when body2's kinematic chain has no
    rotational dofs (the cylinder axis stays world-z; asserted by the
    probe script). MuJoCo routes this geom pair through its convex
    (native CCD / GJK) collider; the analytic treatment here finds the
    EXACT witness pair — the capsule-axis point minimizing the convex
    point-to-solid-cylinder distance over the segment (bisection on the
    distance derivative, `_capsule_cylinder`) — i.e. the optimum GJK
    iterates toward, across the side, cap AND rim regions. Probed vs
    mujoco 3.10 on contact-rich pushing states: dist to 6e-11, normals
    to mujoco's own ~4e-5 GJK residual."""

    body1: int
    a1: tuple[float, float, float]  # capsule segment ends, body1 frame
    b1: tuple[float, float, float]
    r1: float
    body2: int
    center2: tuple[float, float, float]  # cylinder center, body2 frame
    r2: float
    hh2: float  # half height
    mu: float
    margin: float
    solimp: tuple[float, float, float]
    condim: int = 1


@dataclasses.dataclass(frozen=True)
class SCPairCapsule:
    """Generic sphere/capsule vs sphere/capsule pair on two bodies — the
    Humanoid self-collision geometry (all its body geoms are condim-1
    with full contype/conaffinity, so a fallen humanoid makes
    frictionless single-row contacts between non-adjacent bodies). A
    sphere is a zero-length segment (a == b); the static point/segment
    distinction folds the closest-point algebra at trace time.

    Conventions verified against mujoco on live Humanoid-v4 states
    (machine precision over sphere-sphere, sphere-capsule and
    capsule-capsule contacts): closest points between the two axis
    segments (Ericson), dist = |c2−c1| − r1 − r2, normal from geom1
    toward geom2, contact point at c1 + n·(r1 + dist/2), J = n·(J2−J1),
    R = (1−imp)/imp·(bw1+bw2), aref with the shared KBIP rules. MuJoCo
    orders each pair so type1 ≤ type2 (sphere before capsule), else by
    geom index — the probe script emits that order. Known deviation:
    EXACTLY parallel overlapping capsules make MuJoCo emit 2 endpoint
    contacts; this analytic pair emits the single closest-point contact
    (a measure-zero configuration for generic states — same grade as
    the Pusher pair's CCD-manifold note)."""

    body1: int
    a1: tuple[float, float, float]  # segment ends, body1 frame (a1==b1
    b1: tuple[float, float, float]  # for a sphere)
    r1: float
    body2: int
    a2: tuple[float, float, float]
    b2: tuple[float, float, float]
    r2: float
    margin: float
    solimp: tuple[float, float, float]
    condim: int = 1  # only condim-1 (frictionless) pairs are supported


@dataclasses.dataclass(frozen=True)
class SCLimit:
    dof: int
    lo: float
    hi: float
    solimp: tuple[float, float, float]
    margin: float = 0.0


@dataclasses.dataclass(frozen=True)
class SpatialContactModel:
    """Static constant table for one spatial MJCF model."""

    n_dof: int
    n_q: int
    bodies: tuple[SCBody, ...]
    contacts: tuple[SCContact, ...]
    limits: tuple[SCLimit, ...]
    damping: tuple[float, ...]
    armature: tuple[float, ...]
    stiffness: tuple[float, ...]  # per dof, springs pull toward qpos_spring
    springref: tuple[float, ...]
    dof_invweight0: tuple[float, ...]
    body_invweight0: tuple[float, ...]  # per body, translation component
    timestep: float
    integrator: str  # "rk4" | "euler_implicit"
    gravity: float = 9.81
    floor_z: float = 0.0  # height of the contact plane (Pusher: -0.325)
    pairs: tuple[SCPairCylinder, ...] = ()
    self_pairs: tuple[SCPairCapsule, ...] = ()

    @property
    def n_rows(self) -> int:
        """Limit rows + 4 pyramid rows per condim-3 contact (3D cones
        never degenerate into the planar family's mergeable pure-normal
        pair — both tangents are live) + 1 normal row per condim-1
        contact/pair."""
        assert all(p.condim == 1 for p in self.self_pairs)
        return (
            len(self.limits)
            + sum(4 if c.condim == 3 else 1 for c in self.contacts)
            + sum(4 if p.condim == 3 else 1 for p in self.pairs)
            + len(self.self_pairs)
        )

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

    @property
    def dof_joints(self):
        """All (body_index, joint) pairs in tree order."""
        return tuple(
            (bi, j)
            for bi, b in enumerate(self.bodies)
            for j in b.joints
        )

    def kb(self, dmax: float) -> tuple[float, float]:
        tc = max(0.02, 2.0 * self.timestep)
        return 1.0 / (dmax * tc) ** 2, 2.0 / (dmax * tc)


def normalize_quat(q, model: SpatialContactModel):
    """Normalize every quaternion block of the qpos tuple (mj_step
    normalizes qpos quaternions in place — probed)."""
    out = list(q)
    for _bi, j in model.dof_joints:
        if j.kind == "free":
            w, x, y, z = (q[j.qadr + 3 + i] for i in range(4))
            inv = jax.lax.rsqrt(w * w + x * x + y * y + z * z)
            for i, c in enumerate((w, x, y, z)):
                out[j.qadr + 3 + i] = c * inv
    return tuple(out)


@dataclasses.dataclass
class Frames:
    """World-frame kinematics: per-body origin / rotation, per-joint
    world axis and anchor (keyed by dof index)."""

    origin: list
    rot: list
    jaxis: dict
    janchor: dict


def frames(model: SpatialContactModel, q) -> Frames:
    nb = len(model.bodies)
    origin, rot = [None] * nb, [None] * nb
    jaxis, janchor = {}, {}
    for bi, b in enumerate(model.bodies):
        if b.parent == -1:
            o, r = (0.0, 0.0, 0.0), _R_IDENT
        else:
            o, r = origin[b.parent], rot[b.parent]
        if any(c != 0.0 for c in b.pos):
            o = _vadd(o, _rvec(r, b.pos))
        if tuple(b.quat) != (1.0, 0.0, 0.0, 0.0):
            r = _rmul(r, _qmat(*b.quat))
        for j in b.joints:
            if j.kind == "free":
                o = (q[j.qadr], q[j.qadr + 1], q[j.qadr + 2])
                r = _qmat(*(q[j.qadr + 3 + i] for i in range(4)))
                jaxis[j.dof] = r
                janchor[j.dof] = o
            elif j.kind == "slide":
                a_w = _rvec(r, j.axis)
                o = _vadd(o, _vscale(q[j.qadr], a_w))
                jaxis[j.dof] = a_w
                janchor[j.dof] = o
            else:  # hinge
                anchor_w = (
                    _vadd(o, _rvec(r, j.anchor))
                    if any(c != 0.0 for c in j.anchor)
                    else o
                )
                jaxis[j.dof] = _rvec(r, j.axis)
                janchor[j.dof] = anchor_w
                r = _rmul(r, _axis_rot_static(j.axis, q[j.qadr]))
                o = (
                    _vsub(anchor_w, _rvec(r, j.anchor))
                    if any(c != 0.0 for c in j.anchor)
                    else anchor_w
                )
        origin[bi], rot[bi] = o, r
    return Frames(origin=origin, rot=rot, jaxis=jaxis, janchor=janchor)


def _sym_rotate(r, i6):
    """R · I · Rᵀ for a symmetric body-frame inertia (6-tuple
    ixx, ixy, ixz, iyy, iyz, izz) -> world-frame 6-tuple."""
    ixx, ixy, ixz, iyy, iyz, izz = i6
    rows = ((ixx, ixy, ixz), (ixy, iyy, iyz), (ixz, iyz, izz))
    # tmp = R · I (3x3)
    tmp = []
    for i in range(3):
        for j in range(3):
            tmp.append(
                _add(
                    _add(
                        _mul(r[3 * i + 0], rows[0][j]),
                        _mul(r[3 * i + 1], rows[1][j]),
                    ),
                    _mul(r[3 * i + 2], rows[2][j]),
                )
            )
    out = []
    for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)):
        out.append(
            _add(
                _add(
                    _mul(tmp[3 * i + 0], r[3 * j + 0]),
                    _mul(tmp[3 * i + 1], r[3 * j + 1]),
                ),
                _mul(tmp[3 * i + 2], r[3 * j + 2]),
            )
        )
    return tuple(out)  # (xx, xy, xz, yy, yz, zz) world


def _sym_vec(i6, v):
    xx, xy, xz, yy, yz, zz = i6
    return (
        _add(_add(_mul(xx, v[0]), _mul(xy, v[1])), _mul(xz, v[2])),
        _add(_add(_mul(xy, v[0]), _mul(yy, v[1])), _mul(yz, v[2])),
        _add(_add(_mul(xz, v[0]), _mul(yz, v[1])), _mul(zz, v[2])),
    )


def _dof_columns(model: SpatialContactModel, fr: Frames, bi: int, point):
    """com/contact-point Jacobian columns for body bi at a world point:
    list of (dof, Jv 3-tuple, Jω 3-tuple-or-None) in dof order."""
    cols = []
    for body in reversed(model.chains[bi]):
        for j in model.bodies[body].joints:
            if j.kind == "free":
                anchor = fr.janchor[j.dof]
                rel = _vsub(point, anchor)
                r = fr.jaxis[j.dof]  # root rotation, columns = axes
                for i in range(3):
                    e = tuple(1.0 if k == i else 0.0 for k in range(3))
                    cols.append((j.dof + i, e, None))
                for i in range(3):
                    a = (r[i], r[3 + i], r[6 + i])
                    cols.append((j.dof + 3 + i, _cross3(a, rel), a))
            elif j.kind == "slide":
                cols.append((j.dof, fr.jaxis[j.dof], None))
            else:
                a = fr.jaxis[j.dof]
                rel = _vsub(point, fr.janchor[j.dof])
                cols.append((j.dof, _cross3(a, rel), a))
    cols.sort(key=lambda c: c[0])
    return cols


def mass_entries_analytic(model: SpatialContactModel, q, fr: Frames = None):
    """Mass matrix lower triangle (list-of-lists of scalars); matches
    mj_fullM to machine precision (probed on Ant)."""
    n = model.n_dof
    if fr is None:
        fr = frames(model, q)
    m = [[0.0] * (i + 1) for i in range(n)]
    for d in range(n):
        m[d][d] = model.armature[d]
    for bi, b in enumerate(model.bodies):
        com_w = _vadd(fr.origin[bi], _rvec(fr.rot[bi], b.com))
        iw = _sym_rotate(fr.rot[bi], b.inertia)
        cols = _dof_columns(model, fr, bi, com_w)
        for i_idx, (di, jvi, jwi) in enumerate(cols):
            iwi = _sym_vec(iw, jwi) if jwi is not None else None
            for dj, jvj, jwj in cols[: i_idx + 1]:
                s = _mul(b.mass, _dot3(jvi, jvj))
                if iwi is not None and jwj is not None:
                    s = _add(s, _dot3(iwi, jwj))
                m[di][dj] = _add(m[di][dj], s)
    one = jnp.ones_like(q[0])
    for i in range(n):
        for j in range(i + 1):
            m[i][j] = _mul(m[i][j], one) if _is_const(m[i][j]) else m[i][j]
    return m


def bias_analytic(model: SpatialContactModel, q, qv, fr: Frames = None):
    """Coriolis/centrifugal + gyroscopic + gravity generalized forces
    (q̈ = 0 propagation). Matches qfrc_bias to ~1e-15 (probed on Ant)."""
    n = model.n_dof
    if fr is None:
        fr = frames(model, q)
    nb = len(model.bodies)
    zero3 = (0.0, 0.0, 0.0)
    omega = [None] * nb
    alpha = [None] * nb
    vel_o = [None] * nb  # velocity of the body origin point
    acc_o = [None] * nb
    for bi, b in enumerate(model.bodies):
        if b.parent == -1:
            om, al, vo, ao = zero3, zero3, zero3, zero3
            op = (0.0, 0.0, 0.0)
        else:
            p = b.parent
            om, al = omega[p], alpha[p]
            d = _vsub(fr.origin[bi], fr.origin[p])
            vo = _vadd(vel_o[p], _cross3(om, d))
            ao = _vadd(
                _vadd(acc_o[p], _cross3(al, d)),
                _cross3(om, _cross3(om, d)),
            )
        for j in b.joints:
            if j.kind == "free":
                vo = (qv[j.dof], qv[j.dof + 1], qv[j.dof + 2])
                ao = zero3
                r = fr.jaxis[j.dof]
                om = _rvec(r, (qv[j.dof + 3], qv[j.dof + 4], qv[j.dof + 5]))
                al = zero3  # d/dt(R ω_local) = ω × ω = 0 at ω̇ = 0
            elif j.kind == "slide":
                a_w = fr.jaxis[j.dof]
                vo = _vadd(vo, _vscale(qv[j.dof], a_w))
                ao = _vadd(ao, _cross3(om, _vscale(qv[j.dof], a_w)))
            else:  # hinge at anchor w
                w = fr.janchor[j.dof]
                dw = _vsub(w, fr.origin[bi])
                # move the propagation point from the body origin path to
                # the anchor, add the joint rate, then back to the origin
                vw = _vadd(vo, _cross3(om, dw))
                aw = _vadd(
                    _vadd(ao, _cross3(al, dw)),
                    _cross3(om, _cross3(om, dw)),
                )
                aq = _vscale(qv[j.dof], fr.jaxis[j.dof])
                al = _vadd(al, _cross3(om, aq))
                om = _vadd(om, aq)
                do = _vsub(fr.origin[bi], w)
                # with zero static anchor do = 0 and these fold away
                vo = _vadd(vw, _cross3(om, do))
                ao = _vadd(
                    _vadd(aw, _cross3(al, do)),
                    _cross3(om, _cross3(om, do)),
                )
        omega[bi], alpha[bi] = om, al
        vel_o[bi], acc_o[bi] = vo, ao

    g = model.gravity
    out = [0.0] * n
    for bi, b in enumerate(model.bodies):
        r_com = _rvec(fr.rot[bi], b.com)
        com_w = _vadd(fr.origin[bi], r_com)
        vcom = _vadd(vel_o[bi], _cross3(omega[bi], r_com))
        acom = _vadd(
            _vadd(acc_o[bi], _cross3(alpha[bi], r_com)),
            _cross3(omega[bi], _vsub(vcom, vel_o[bi])),
        )
        iw = _sym_rotate(fr.rot[bi], b.inertia)
        f = (
            _mul(b.mass, acom[0]),
            _mul(b.mass, acom[1]),
            _mul(b.mass, _add(acom[2], g)),
        )
        t = _vadd(
            _sym_vec(iw, alpha[bi]),
            _cross3(omega[bi], _sym_vec(iw, omega[bi])),
        )
        for di, jv, jw in _dof_columns(model, fr, bi, com_w):
            s = _dot3(jv, f)
            if jw is not None:
                s = _add(s, _dot3(jw, t))
            out[di] = _add(out[di], s)
    zero = jnp.zeros_like(q[0])
    return tuple(o if not _is_const(o) else zero for o in out)


def contact_rows(model: SpatialContactModel, q, qv, zero, fr: Frames = None):
    """Constraint rows: (J as n_dof scalars, aref, R, active) per row —
    the planar solve_qp contract. Limit rows first, then 4 pyramid rows
    per contact in MuJoCo's order (n±μt1, n±μt2)."""
    n = model.n_dof
    if fr is None:
        fr = frames(model, q)
    rows = []
    for lim in model.limits:
        d_lo = (q_of_dof(model, q, lim.dof) - lim.lo) - lim.margin
        d_hi = (lim.hi - q_of_dof(model, q, lim.dof)) - lim.margin
        lower_closer = d_lo < d_hi
        pos = jnp.where(lower_closer, d_lo, d_hi)
        sgn = jnp.where(lower_closer, 1.0, -1.0)
        d0, dmax, width = lim.solimp
        imp = impedance(pos, d0=d0, dmax=dmax, width=width)
        kc, bc = model.kb(dmax)
        aref = -bc * (sgn * qv[lim.dof]) - kc * imp * pos
        r_reg = (1.0 - imp) / imp * model.dof_invweight0[lim.dof]
        j = [zero] * n
        j[lim.dof] = sgn
        rows.append((j, aref, r_reg, pos < 0.0))

    def _dezero(j):
        # free-joint translation columns produce CONSTANT nonzero
        # entries (e.g. the z dof's 1.0) — only a constant ZERO is a
        # structural zero
        return [zero if _is_const(e) and e == 0.0 else e for e in j]

    for con in model.contacts:
        bi = con.body
        p = _vadd(fr.origin[bi], _rvec(fr.rot[bi], con.local))
        dist = (p[2] - model.floor_z) - con.radius
        active = dist < con.margin
        cp = (p[0], p[1], model.floor_z + 0.5 * dist)
        cols = _dof_columns(model, fr, bi, cp)
        jn = [0.0] * n
        for d, jv, _jw in cols:
            jn[d] = jv[2]
        d0, dmax, width = con.solimp
        pos_m = dist - con.margin
        imp = impedance(pos_m, d0=d0, dmax=dmax, width=width)
        kc, bc = model.kb(dmax)
        mu = con.mu
        jv_n = _jdotv(jn, qv, n)
        base_aref = -kc * imp * pos_m
        if con.condim == 1:  # frictionless: single normal row, no
            # pyramid R factor (probed on Pusher efc_R)
            r_reg = (1.0 - imp) / imp * model.body_invweight0[bi]
            rows.append((_dezero(jn), -bc * jv_n + base_aref, r_reg, active))
            continue
        if con.axis_local is None:
            t1 = (0.0, 1.0, 0.0)  # mju_makeFrame for n = +z (probed)
        else:
            a_w = _rvec(fr.rot[bi], con.axis_local)
            nrm = jnp.sqrt(
                jnp.maximum(a_w[0] * a_w[0] + a_w[1] * a_w[1], 1e-24)
            )
            t1 = (a_w[0] / nrm, a_w[1] / nrm, 0.0)
        t2 = (-t1[1], t1[0], 0.0)  # n × t1 for n = +z
        jt1 = [0.0] * n
        jt2 = [0.0] * n
        for d, jv, _jw in cols:
            jt1[d] = _dot3(jv, t1)
            jt2[d] = _dot3(jv, t2)
        r_factor = 2.0 * mu * mu * (1.0 + mu * mu)
        r_reg = (
            (1.0 - imp) / imp * model.body_invweight0[bi] * r_factor
        )
        jv_t1 = _jdotv(jt1, qv, n)
        jv_t2 = _jdotv(jt2, qv, n)
        for jt, jv_t in ((jt1, jv_t1), (jt2, jv_t2)):
            for sgn in (1.0, -1.0):
                j = [
                    _add(jn[d], _mul(sgn * mu, jt[d])) for d in range(n)
                ]
                aref = -bc * (jv_n + sgn * mu * jv_t) + base_aref
                rows.append((_dezero(j), aref, r_reg, active))

    for pair in model.pairs:
        dist, nvec, cp = _capsule_cylinder(model, fr, pair)
        active = dist < pair.margin
        # J = n · (v_body2(cp) − v_body1(cp)); chains from a common
        # world root, so emit both bodies' columns with signs (shared
        # ancestor dofs cancel exactly when they overlap)
        j = [0.0] * n
        for d, jv, _jw in _dof_columns(model, fr, pair.body1, cp):
            j[d] = _sub(j[d], _dot3(jv, nvec))
        for d, jv, _jw in _dof_columns(model, fr, pair.body2, cp):
            j[d] = _add(j[d], _dot3(jv, nvec))
        d0, dmax, width = pair.solimp
        pos_m = dist - pair.margin
        imp = impedance(pos_m, d0=d0, dmax=dmax, width=width)
        kc, bc = model.kb(dmax)
        r_reg = (1.0 - imp) / imp * (
            model.body_invweight0[pair.body1]
            + model.body_invweight0[pair.body2]
        )
        jv_n = _jdotv(j, qv, n)
        aref = -bc * jv_n - kc * imp * pos_m
        rows.append((_dezero(j), aref, r_reg, active))

    for pair in model.self_pairs:
        dist, nvec, cp = _capsule_capsule(model, fr, pair)
        active = dist < pair.margin
        j = [0.0] * n
        for d, jv, _jw in _dof_columns(model, fr, pair.body1, cp):
            j[d] = _sub(j[d], _dot3(jv, nvec))
        for d, jv, _jw in _dof_columns(model, fr, pair.body2, cp):
            j[d] = _add(j[d], _dot3(jv, nvec))
        d0, dmax, width = pair.solimp
        pos_m = dist - pair.margin
        imp = impedance(pos_m, d0=d0, dmax=dmax, width=width)
        kc, bc = model.kb(dmax)
        r_reg = (1.0 - imp) / imp * (
            model.body_invweight0[pair.body1]
            + model.body_invweight0[pair.body2]
        )
        aref = -bc * _jdotv(j, qv, n) - kc * imp * pos_m
        rows.append((_dezero(j), aref, r_reg, active))
    return rows


def contact_force_ssq(model: SpatialContactModel, q, lam, fr: Frames = None):
    """Σ_b ‖cfrc_ext[b]‖² over the model's bodies — the quantity
    gymnasium's HumanoidStandup impact cost reads (0.5e-6 ·
    Σ data.cfrc_ext², humanoidstandup_v4.py). Probed conventions
    (reconstructed to machine precision against mj_rnePostConstraint on
    live HumanoidStandup states): cfrc_ext rows are (torque, force)
    world 6-vectors; each contact adds +wrench to geom2's body and
    −wrench to geom1's (the WORLD body accumulates nothing — its row
    stays zero even under floor contact); the torque reference point is
    subtree_com[body_rootid[b]] = the whole-robot mass-weighted com
    (every body of a single floating tree shares it). λ is the efc
    force vector returned by the stage-4 QP (`solve_qp_dense`'s lam, at
    the q the same solve saw): pyramid rows combine as
    f = n·Σλ + μ·t₁(λ₀−λ₁) + μ·t₂(λ₂−λ₃) (mju_decodePyramid); condim-1
    rows as f = n·λ. Limit rows carry no cartesian force. mj_step with
    RK4 leaves data.cfrc_ext at the LAST STAGE's values (no forward
    pass after integration), so callers pass the stage-4 (q, λ)."""
    if fr is None:
        fr = frames(model, q)
    nb = len(model.bodies)
    total_m = sum(b.mass for b in model.bodies)
    com = (0.0, 0.0, 0.0)
    for bi, b in enumerate(model.bodies):
        cw = _vadd(fr.origin[bi], _rvec(fr.rot[bi], b.com))
        com = _vadd(com, _vscale(b.mass, cw))
    com = _vscale(1.0 / total_m, com)
    acc = [[0.0] * 6 for _ in range(nb)]

    def _accum(bi, cp, f, sgn):
        t = _cross3(_vsub(cp, com), f)
        for i in range(3):
            acc[bi][i] = _add(acc[bi][i], _mul(sgn, t[i]))
            acc[bi][3 + i] = _add(acc[bi][3 + i], _mul(sgn, f[i]))

    r = len(model.limits)
    for con in model.contacts:
        bi = con.body
        p = _vadd(fr.origin[bi], _rvec(fr.rot[bi], con.local))
        dist = (p[2] - model.floor_z) - con.radius
        cp = (p[0], p[1], model.floor_z + 0.5 * dist)
        if con.condim == 1:
            _accum(bi, cp, (0.0, 0.0, lam[r]), 1.0)
            r += 1
            continue
        if con.axis_local is None:
            t1 = (0.0, 1.0, 0.0)
        else:
            a_w = _rvec(fr.rot[bi], con.axis_local)
            nrm = jnp.sqrt(
                jnp.maximum(a_w[0] * a_w[0] + a_w[1] * a_w[1], 1e-24)
            )
            t1 = (a_w[0] / nrm, a_w[1] / nrm, 0.0)
        t2 = (-t1[1], t1[0], 0.0)
        fn = lam[r] + lam[r + 1] + lam[r + 2] + lam[r + 3]
        ft1 = con.mu * (lam[r] - lam[r + 1])
        ft2 = con.mu * (lam[r + 2] - lam[r + 3])
        f = tuple(
            _add(
                _mul(fn, nv), _add(_mul(ft1, t1[i]), _mul(ft2, t2[i]))
            )
            for i, nv in enumerate((0.0, 0.0, 1.0))
        )
        _accum(bi, cp, f, 1.0)
        r += 4
    for pair in model.pairs:
        _dist, nvec, cp = _capsule_cylinder(model, fr, pair)
        f = _vscale(lam[r], nvec)
        _accum(pair.body2, cp, f, 1.0)
        _accum(pair.body1, cp, f, -1.0)
        r += 1
    for pair in model.self_pairs:
        _dist, nvec, cp = _capsule_capsule(model, fr, pair)
        f = _vscale(lam[r], nvec)
        _accum(pair.body2, cp, f, 1.0)
        _accum(pair.body1, cp, f, -1.0)
        r += 1
    assert r == model.n_rows
    s = 0.0
    for bi in range(nb):
        for c in acc[bi]:
            s = _add(s, _mul(c, c))
    return s if not _is_const(s) else jnp.zeros_like(q[0])


def _capsule_capsule(model: SpatialContactModel, fr: Frames,
                     pair: SCPairCapsule):
    """Analytic sphere/capsule-vs-sphere/capsule contact: returns
    (dist, normal geom1→geom2, contact point). Closest points between
    the two axis segments (Ericson 5.1.9, branchless); the static
    point-vs-segment distinction (a sphere is a zero-length segment)
    and the static segment lengths fold at trace time. Verified to
    machine precision against live mujoco Humanoid-v4 contacts of all
    three type combinations (see SCPairCapsule)."""
    o1, r1m = fr.origin[pair.body1], fr.rot[pair.body1]
    o2, r2m = fr.origin[pair.body2], fr.rot[pair.body2]
    d1_loc = tuple(b - a for a, b in zip(pair.a1, pair.b1))
    d2_loc = tuple(b - a for a, b in zip(pair.a2, pair.b2))
    la = sum(c * c for c in d1_loc)  # static |segment|²
    le = sum(c * c for c in d2_loc)
    seg1, seg2 = la > 0.0, le > 0.0
    a1 = _vadd(o1, _rvec(r1m, pair.a1))
    a2 = _vadd(o2, _rvec(r2m, pair.a2))
    if not seg1 and not seg2:  # sphere vs sphere
        c1, c2 = a1, a2
    elif not seg1:  # sphere vs capsule 2
        d2 = _rvec(r2m, d2_loc)
        t = jnp.clip(_dot3(_vsub(a1, a2), d2) * (1.0 / le), 0.0, 1.0)
        c1, c2 = a1, _vadd(a2, _vscale(t, d2))
    elif not seg2:  # capsule 1 vs sphere
        d1 = _rvec(r1m, d1_loc)
        s = jnp.clip(_dot3(_vsub(a2, a1), d1) * (1.0 / la), 0.0, 1.0)
        c1, c2 = _vadd(a1, _vscale(s, d1)), a2
    else:  # capsule vs capsule
        d1 = _rvec(r1m, d1_loc)
        d2 = _rvec(r2m, d2_loc)
        r = _vsub(a1, a2)
        lf = _dot3(d2, r)
        lc = _dot3(d1, r)
        lb = _dot3(d1, d2)
        den = la * le - lb * lb
        s = jnp.where(
            den > 1e-12 * la * le,
            jnp.clip(
                (lb * lf - lc * le) / jnp.maximum(den, 1e-30), 0.0, 1.0
            ),
            0.0,
        )
        t_raw = (lb * s + lf) * (1.0 / le)
        s = jnp.where(
            t_raw < 0.0,
            jnp.clip(-lc * (1.0 / la), 0.0, 1.0),
            jnp.where(
                t_raw > 1.0,
                jnp.clip((lb - lc) * (1.0 / la), 0.0, 1.0),
                s,
            ),
        )
        t = jnp.clip(t_raw, 0.0, 1.0)
        c1, c2 = _vadd(a1, _vscale(s, d1)), _vadd(a2, _vscale(t, d2))
    dvec = _vsub(c2, c1)
    ln = jnp.sqrt(jnp.maximum(_dot3(dvec, dvec), 1e-24))
    nvec = _vscale(1.0 / ln, dvec)
    dist = ln - pair.r1 - pair.r2
    cp = _vadd(c1, _vscale(pair.r1 + 0.5 * dist, nvec))
    return dist, nvec, cp


def _capsule_cylinder(model: SpatialContactModel, fr: Frames,
                      pair: SCPairCylinder):
    """Analytic capsule-vs-upright-cylinder contact: returns
    (dist, normal body1→body2, contact point). See SCPairCylinder.

    The capsule-axis point is the EXACT minimizer of the point-to-solid-
    cylinder distance f(s) over the segment: distance-to-a-convex-set is
    convex along a line, so its derivative u(p(s))·d (u = outward unit
    direction at the witness point) is monotone and a fixed-iteration
    bisection on its sign converges to the true witness pair — the same
    answer MuJoCo's native CCD (GJK) iterates to at ~1e-6 tolerance.
    The previous closest-point-to-the-AXIS-segment choice agreed only on
    side contacts and was ~5e-4 wrong on RIM contacts (19% of the pair
    contacts in the probe episode, normals off by 0.19) — probed against
    mujoco 3.10 on the test_pusher_device pushing episode: the bisected
    minimizer matches nativeccd's dist/normal/pos to its own GJK
    residual (~1e-6). Valid while the segment stays outside the solid
    cylinder (penetration < capsule radius — always, here): inside,
    f would stop being a distance-to-set along the whole segment."""
    o1, r1m = fr.origin[pair.body1], fr.rot[pair.body1]
    a = _vadd(o1, _rvec(r1m, pair.a1))
    b = _vadd(o1, _rvec(r1m, pair.b1))
    c = _vadd(fr.origin[pair.body2],
              _rvec(fr.rot[pair.body2], pair.center2))
    hh, r2 = pair.hh2, pair.r2
    d1 = _vsub(b, a)

    def dderiv(s):
        """u(p(s))·d — sign of df/ds at s (outside witness direction;
        inside the solid, the max(er, ez) subgradient)."""
        px = a[0] + s * d1[0] - c[0]
        py = a[1] + s * d1[1] - c[1]
        pz = a[2] + s * d1[2] - c[2]
        dr = jnp.sqrt(jnp.maximum(px * px + py * py, 1e-24))
        er = dr - r2
        ez = jnp.abs(pz) - hh
        zsign = jnp.where(pz >= 0.0, 1.0, -1.0)
        inside = (er < 0.0) & (ez < 0.0)
        erp = jnp.maximum(er, 0.0)
        ezp = jnp.maximum(ez, 0.0)
        d_out = jnp.sqrt(jnp.maximum(erp * erp + ezp * ezp, 1e-24))
        use_radial = er > ez
        ux = jnp.where(inside, jnp.where(use_radial, px / dr, 0.0),
                       erp * px / (dr * d_out))
        uy = jnp.where(inside, jnp.where(use_radial, py / dr, 0.0),
                       erp * py / (dr * d_out))
        uz = jnp.where(inside, jnp.where(use_radial, 0.0, zsign),
                       ezp * zsign / d_out)
        return ux * d1[0] + uy * d1[1] + uz * d1[2]

    lo = jnp.zeros_like(a[0])
    hi = jnp.ones_like(a[0])
    # 40 halvings: |hi-lo| ~ 1e-12 — below the f64 GJK comparison
    # tolerance and far below f32 resolution
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        going_down = dderiv(mid) < 0.0
        lo = jnp.where(going_down, mid, lo)
        hi = jnp.where(going_down, hi, mid)
    s1 = 0.5 * (lo + hi)
    p1 = _vadd(a, _vscale(s1, d1))  # true witness point on the capsule axis
    # point-vs-solid-cylinder from p1 (side / cap / rim regions)
    dx = p1[0] - c[0]
    dy = p1[1] - c[1]
    dzs = p1[2] - c[2]
    dr = jnp.sqrt(jnp.maximum(dx * dx + dy * dy, 1e-24))
    er = dr - r2
    ez = jnp.abs(dzs) - hh
    inside = (er < 0.0) & (ez < 0.0)
    erp = jnp.maximum(er, 0.0)
    ezp = jnp.maximum(ez, 0.0)
    d_out = jnp.sqrt(jnp.maximum(erp * erp + ezp * ezp, 1e-24))
    d_pt = jnp.where(inside, jnp.maximum(er, ez), d_out)
    # normal from the CYLINDER surface toward p1: radial on the side
    # wall, vertical on the caps, mixed on the rim
    zsign = jnp.where(dzs >= 0.0, 1.0, -1.0)
    rad_x, rad_y = dx / dr, dy / dr
    use_radial = er > ez  # inside: shallower exit is the normal
    nx = jnp.where(inside, jnp.where(use_radial, rad_x, 0.0),
                   erp * rad_x / d_out)
    ny = jnp.where(inside, jnp.where(use_radial, rad_y, 0.0),
                   erp * rad_y / d_out)
    nz = jnp.where(inside, jnp.where(use_radial, 0.0, zsign),
                   ezp * zsign / d_out)
    dist = d_pt - pair.r1
    # MuJoCo frame convention: the normal points geom1 (capsule) →
    # geom2 (cylinder) — opposite the surface→p1 direction above
    nvec = (-nx, -ny, -nz)
    cp = (
        p1[0] + nvec[0] * (pair.r1 + 0.5 * dist),
        p1[1] + nvec[1] * (pair.r1 + 0.5 * dist),
        p1[2] + nvec[2] * (pair.r1 + 0.5 * dist),
    )
    return dist, nvec, cp


def _jdotv(j, qv, n):
    s = 0.0
    for d in range(n):
        s = _add(s, _mul(j[d], qv[d]))
    return s


def q_of_dof(model: SpatialContactModel, q, dof: int):
    """qpos scalar addressed by a (1-dof-joint) dof index."""
    for _bi, j in model.dof_joints:
        if j.kind in ("hinge", "slide") and j.dof == dof:
            return q[j.qadr]
    raise KeyError(dof)


def integrate_pos(model: SpatialContactModel, q, v, h):
    """qpos ← qpos ⊕ h·v (mj_integratePos): linear for slide/hinge dofs,
    quaternion exponential of the BODY-FRAME angular velocity for free
    joints, normalized afterwards (probed conventions)."""
    out = list(q)
    for _bi, j in model.dof_joints:
        if j.kind == "free":
            for i in range(3):
                out[j.qadr + i] = q[j.qadr + i] + h * v[j.dof + i]
            wx, wy, wz = v[j.dof + 3], v[j.dof + 4], v[j.dof + 5]
            n2 = wx * wx + wy * wy + wz * wz
            nrm = jnp.sqrt(jnp.maximum(n2, 1e-30))
            half = 0.5 * h * nrm
            cw = jnp.cos(half)
            sfac = jnp.where(
                n2 < 1e-24, 0.5 * h, jnp.sin(half) / nrm
            )
            ew, ex, ey, ez = cw, sfac * wx, sfac * wy, sfac * wz
            w, x, y, z = (q[j.qadr + 3 + i] for i in range(4))
            nw = w * ew - x * ex - y * ey - z * ez
            nx = w * ex + x * ew + y * ez - z * ey
            ny = w * ey - x * ez + y * ew + z * ex
            nz = w * ez + x * ey - y * ex + z * ew
            inv = jax.lax.rsqrt(nw * nw + nx * nx + ny * ny + nz * nz)
            out[j.qadr + 3] = nw * inv
            out[j.qadr + 4] = nx * inv
            out[j.qadr + 5] = ny * inv
            out[j.qadr + 6] = nz * inv
        else:
            out[j.qadr] = q[j.qadr] + h * v[j.dof]
    return tuple(out)


def build_spatial_stepper(model: SpatialContactModel,
                          unroll_rk4: bool = False,
                          rk4_mode: str | None = None,
                          qp_dense: bool = True):
    """Build (substep, mass_entries, bias, qfrc_smooth, qacc) for the
    model — the spatial sibling of planar_contact.build_contact_stepper.
    substep(q, qv, tau, outer, cg, lam0) advances ONE physics timestep;
    q is an n_q tuple (quaternions included), qv an n_dof tuple.

    RK4 stage-loop forms (same arithmetic, different emission):
    - "scan" (default): stage coefficients as (4,) scan constants — the
      cheapest XLA CPU compile (1× qacc in the graph).
    - "unroll": the 4 stages inline with static float coefficients — 4
      live qacc bodies at once.
    - "loop": lax.fori_loop with scalar-select coefficients — no array
      constants and a 1× qacc live window, the form for a kernel body.
      `unroll_rk4=True` is the legacy spelling of "unroll".

    QP forms (same _qp_iterate core, same optimum):
    - qp_dense=True: the stacked-J solve (solve_qp_dense) — few big
      array ops, the fast-XLA-CPU-compile form the vmap path needs
      (scalar-sparse at 108 rows × 14 dofs made CPU compiles take tens
      of minutes).
    - qp_dense=False: the scalar-sparse solve (solve_qp) — unrolls only
      the structurally nonzero J entries (~45% on the spatial models),
      halving the per-CG-iteration instruction count and the live J
      footprint, the form for a kernel body."""
    if rk4_mode is None:
        rk4_mode = "unroll" if unroll_rk4 else "scan"
    solve = solve_qp_dense if qp_dense else solve_qp
    n = model.n_dof

    def mass_entries(q, fr=None):
        return mass_entries_analytic(model, q, fr)

    def bias(q, qv, fr=None):
        return bias_analytic(model, q, qv, fr)

    def qfrc_smooth(q, qv, tau, fr=None):
        b = bias(q, qv, fr)
        out = []
        for d in range(n):
            s = tau[d] - b[d] - model.damping[d] * qv[d]
            if model.stiffness[d] != 0.0:
                s = s - model.stiffness[d] * (
                    q_of_dof(model, q, d) - model.springref[d]
                )
            out.append(s)
        return out

    def qacc_warm(q, qv, tau, outer, cg, lam0):
        """Full constrained forward dynamics (one mj_forward);
        returns (acc tuple, λ)."""
        fr = frames(model, q)
        m = mass_entries(q, fr)
        l = chol_unrolled(m, n)
        smooth = qfrc_smooth(q, qv, tau, fr)
        a_smooth = chol_solve_unrolled(l, smooth, n)
        zero = jnp.zeros_like(q[0])
        rows = contact_rows(model, q, qv, zero, fr)
        qfrc_c, lam = solve(
            rows, zero, l, a_smooth, outer, cg, n, lam0=lam0,
            return_lam=True,
        )
        acc = chol_solve_unrolled(
            l, [smooth[d] + qfrc_c[d] for d in range(n)], n
        )
        return acc, lam

    def qacc_constrained(q, qv, tau, outer, cg):
        return qacc_warm(normalize_quat(q, model), qv, tau, outer, cg, None)[0]

    h = model.timestep

    def euler_implicit_substep(q, qv, tau, outer, cg, lam0=None):
        q = normalize_quat(q, model)
        fr = frames(model, q)
        m = mass_entries(q, fr)
        l = chol_unrolled(m, n)
        smooth = qfrc_smooth(q, qv, tau, fr)
        a_smooth = chol_solve_unrolled(l, smooth, n)
        zero = jnp.zeros_like(q[0])
        rows = contact_rows(model, q, qv, zero, fr)
        qfrc_c, lam = solve(
            rows, zero, l, a_smooth, outer, cg, n, lam0=lam0,
            return_lam=True,
        )
        md = [[m[i][j] for j in range(i + 1)] for i in range(n)]
        for d in range(n):
            md[d][d] = md[d][d] + h * model.damping[d]
        ld = chol_unrolled(md, n)
        acc = chol_solve_unrolled(
            ld, [smooth[d] + qfrc_c[d] for d in range(n)], n
        )
        qv2 = tuple(qv[d] + h * acc[d] for d in range(n))
        q2 = integrate_pos(model, q, qv2, h)
        # 4th element mirrors rk4: the qpos whose kinematics data.xpos
        # holds after mj_step (Euler runs no forward pass after
        # integration either, so it is the PRE-step qpos)
        return q2, qv2, lam, q

    def rk4_substep(q, qv, tau, outer, cg, lam0=None):
        """mj_RungeKutta over the quaternion manifold: stage positions
        integrate from q₀ by the previous stage's velocity
        (mj_integratePos at C·h), the final position by the B-weighted
        accumulated velocity (mj_RungeKutta accumulates dX with
        mju_addToScl per stage — mirrored here). λ warm-starts chain
        through the stages. The 4 stages run as ONE lax.scan body (each
        stage is a full constrained forward — the scan keeps the XLA
        graph at 1× qacc instead of 4×, which matters enormously for
        compile time at n=14/108 rows). Returns (q', qv', λ, q_stage4):
        mj_step leaves data.xpos at the LAST STAGE's kinematics (no
        forward pass after integration) and gymnasium's get_body_com
        rewards read it."""
        q = normalize_quat(q, model)
        dt_ = jnp.result_type(q[0])
        cs = jnp.asarray([0.0, 0.5, 0.5, 1.0], dtype=dt_)
        ws = jnp.asarray([1 / 6, 1 / 3, 1 / 3, 1 / 6], dtype=dt_)
        zero = jnp.zeros_like(q[0])
        if lam0 is None:
            lam0 = jnp.zeros((model.n_rows,) + zero.shape, dtype=zero.dtype)
        zeros_v = (zero,) * n

        def stage(carry, cw):
            kq_prev, kv_prev, accq, accv, lam, _qs = carry
            c, w = cw
            q_s = integrate_pos(model, q, kq_prev, c * h)
            v_s = tuple(qv[d] + (c * h) * kv_prev[d] for d in range(n))
            kv, lam = qacc_warm(q_s, v_s, tau, outer, cg, lam)
            kv = tuple(kv)  # chol_solve_unrolled returns a list
            accq = tuple(accq[d] + w * v_s[d] for d in range(n))
            accv = tuple(accv[d] + w * kv[d] for d in range(n))
            return (v_s, kv, accq, accv, lam, q_s), None

        (_, _, accq, accv, lam, q4), _ = jax.lax.scan(
            stage, (qv, zeros_v, zeros_v, zeros_v, lam0, q), (cs, ws)
        )
        qn = integrate_pos(model, q, accq, h)
        vn = tuple(qv[d] + h * accv[d] for d in range(n))
        return qn, vn, lam, q4

    def rk4_substep_loop(q, qv, tau, outer, cg, lam0=None):
        """`rk4_substep` with the stage loop as a `lax.fori_loop` whose
        stage coefficients are scalar selects on the loop index — the
        rolled form without array constants. The 4x-unrolled form keeps
        4 full qacc_warm bodies live at once; one stage body bounds the
        live window to 1x qacc. Arithmetic is the scan's:
        stage 1 integrates positions by c=0 (exact identity up to one
        quaternion renormalize by rsqrt(1)).

        Loop-carry inits are ANCHORED to the data (`x * 0.0` / `x + zero`
        instead of constants), so every carry has the shape and layout
        of the body's output. The anchor adds are exact (0·x = 0,
        x + 0 = x for finite f32)."""
        q = normalize_quat(q, model)
        dt_ = jnp.result_type(q[0])
        zero = q[0] * jnp.asarray(0.0, dtype=dt_)  # data-layout zero
        if lam0 is None:
            lam0 = jnp.zeros((model.n_rows,) + zero.shape, dtype=zero.dtype)
        lam0 = lam0 + zero  # anchor (exact)
        zeros_v = (zero,) * n
        q = tuple(x + zero for x in q)  # anchor the _qs carry slot
        qv = tuple(x + zero for x in qv)  # anchor the kq_prev slot
        sixth = jnp.asarray(1.0 / 6.0, dtype=dt_)
        third = jnp.asarray(1.0 / 3.0, dtype=dt_)
        half_ = jnp.asarray(0.5, dtype=dt_)
        one_ = jnp.asarray(1.0, dtype=dt_)
        zero_ = jnp.asarray(0.0, dtype=dt_)

        def stage(i, carry):
            kq_prev, kv_prev, accq, accv, lam, _qs = carry
            c = jnp.where(i == 0, zero_, jnp.where(i == 3, one_, half_))
            w = jnp.where((i == 0) | (i == 3), sixth, third)
            q_s = integrate_pos(model, q, kq_prev, c * h)
            v_s = tuple(qv[d] + (c * h) * kv_prev[d] for d in range(n))
            kv, lam = qacc_warm(q_s, v_s, tau, outer, cg, lam)
            kv = tuple(kv)
            accq = tuple(accq[d] + w * v_s[d] for d in range(n))
            accv = tuple(accv[d] + w * kv[d] for d in range(n))
            return (v_s, kv, accq, accv, lam, q_s)

        carry = (qv, zeros_v, zeros_v, zeros_v, lam0, q)
        _, _, accq, accv, lam, q4 = jax.lax.fori_loop(0, 4, stage, carry)
        qn = integrate_pos(model, q, accq, h)
        vn = tuple(qv[d] + h * accv[d] for d in range(n))
        return qn, vn, lam, q4

    def rk4_substep_unrolled(q, qv, tau, outer, cg, lam0=None):
        """The scan body of `rk4_substep` emitted inline 4× with static
        stage coefficients — identical arithmetic (see docstring)."""
        q = normalize_quat(q, model)
        zero = jnp.zeros_like(q[0])
        if lam0 is None:
            lam0 = jnp.zeros((model.n_rows,) + zero.shape, dtype=zero.dtype)
        accq = accv = (0.0,) * n
        kq_prev, kv_prev, lam = qv, (0.0,) * n, lam0
        q_s = q
        for c, w in ((0.0, 1 / 6), (0.5, 1 / 3), (0.5, 1 / 3), (1.0, 1 / 6)):
            if c == 0.0:
                q_s, v_s = q, qv
            else:
                q_s = integrate_pos(model, q, kq_prev, c * h)
                v_s = tuple(qv[d] + (c * h) * kv_prev[d] for d in range(n))
            kv, lam = qacc_warm(q_s, v_s, tau, outer, cg, lam)
            kv = tuple(kv)
            accq = tuple(_add(accq[d], _mul(w, v_s[d])) for d in range(n))
            accv = tuple(_add(accv[d], _mul(w, kv[d])) for d in range(n))
            kq_prev, kv_prev = v_s, kv
        qn = integrate_pos(model, q, accq, h)
        vn = tuple(qv[d] + h * accv[d] for d in range(n))
        return qn, vn, lam, q_s

    if model.integrator == "euler_implicit":
        substep = euler_implicit_substep
    else:
        substep = {
            "scan": rk4_substep,
            "unroll": rk4_substep_unrolled,
            "loop": rk4_substep_loop,
        }[rk4_mode]
    return substep, mass_entries, bias, qfrc_smooth, qacc_constrained
