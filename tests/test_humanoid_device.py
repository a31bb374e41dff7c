"""On-device Humanoid-v4 (3D spatial contacts + self-collision) vs the
real MuJoCo.

The largest on-device task: free-joint quaternion root, 17 hinge dofs,
29 floor candidates with 3D pyramidal cones, 109 frictionless condim-1
self-collision pairs (242 QP rows). Mirrors test_ant_device.py.

SOLVER NOTE (why the reference solver is switched to Newton): gym's
humanoid.xml pins `solver="PGS" iterations="50"`, and PGS-50 does NOT
converge on deep multi-contact states — its qacc deviates from the true
optimum of its own convex QP by up to ~5e-3 (measured: `pgs50 vs
newton` residuals 3e-6..5e-3 on fallen-humanoid states). Our
fixed-iteration active-set/CG solver converges to the unique optimum,
which matches MuJoCo's NEWTON solver on the same model to ~3e-14. The
exactness pins below therefore run mj_forward/mj_step with
opt.solver=Newton (same physics model and constraint data — only the
numerical QP method differs); the PGS-50 residual is the documented gap
to gym's stock binary (an under-converged solver cannot be matched
without replicating its iteration path).
"""

import numpy as np
import pytest

mujoco = pytest.importorskip("mujoco")
gymnasium = pytest.importorskip("gymnasium")

import jax
import jax.numpy as jnp

from mpopis_tpu.models import HumanoidDeviceEnv
from mpopis_tpu.models import humanoid_device as hd
from mpopis_tpu.models.spatial_contact import (
    bias_analytic,
    frames,
    mass_entries_analytic,
)
from mpopis_tpu.utils.fastjit import fast_jit


def _mj(newton: bool = True):
    import os

    import gymnasium.envs.mujoco as gm

    xml = os.path.join(os.path.dirname(gm.__file__), "assets", "humanoid.xml")
    m = mujoco.MjModel.from_xml_path(xml)
    if newton:  # converged reference (see module docstring)
        m.opt.solver = 2
        m.opt.iterations = 200
        m.opt.tolerance = 1e-15
    return m, mujoco.MjData(m)


def _thrash_states(n, seed=0, every=(30, 60, 120, 250, 399)):
    """States along a random-action gym trajectory (the humanoid falls
    and contacts itself); returns (qpos, qvel) snapshots, preferring
    self-contact-rich ones."""
    env = gymnasium.make("Humanoid-v4", reset_noise_scale=0.0)
    m, d = env.unwrapped.model, env.unwrapped.data
    env.reset(seed=seed)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(400):
        env.step(rng.uniform(-0.4, 0.4, 17))
        nself = sum(1 for c in d.contact if c.geom1 != 0)
        if i in every or (nself >= 2 and len(out) < n):
            out.append((d.qpos.copy(), d.qvel.copy()))
        if len(out) >= n:
            break
    env.close()
    return out[:n]


def test_constants_match_mjmodel():
    m, _ = _mj(newton=False)
    np.testing.assert_allclose(
        [b[5] for b in hd._BODIES], m.body_mass[1:], rtol=1e-12
    )
    np.testing.assert_allclose(m.dof_damping, hd._DAMPING, rtol=1e-12)
    np.testing.assert_allclose(m.dof_armature, hd._ARMATURE, rtol=1e-12)
    np.testing.assert_allclose(
        m.dof_invweight0, hd._DOF_INVWEIGHT0, rtol=1e-12
    )
    np.testing.assert_allclose(
        m.body_invweight0[1:, 0], hd._BODY_INVWEIGHT0, rtol=1e-12
    )
    np.testing.assert_allclose(
        m.jnt_range[1:], [(lo, hi) for _, lo, hi, _, _ in hd._LIMITS],
        rtol=1e-12,
    )
    assert m.opt.timestep == hd._H
    assert int(m.opt.integrator) == 1  # RK4
    assert int(m.opt.solver) == 0  # stock humanoid.xml pins PGS (see doc)
    np.testing.assert_allclose(m.actuator_gear[:, 0],
                               [g for _, g in hd._ACTUATORS], rtol=1e-12)
    # per-dof stiffness/springref (humanoid has joint springs)
    stiff = np.zeros(m.nv)
    for j in range(m.njnt):
        if m.jnt_type[j] == 3 and m.jnt_stiffness[j] != 0.0:
            stiff[m.jnt_dofadr[j]] = m.jnt_stiffness[j]
    np.testing.assert_allclose(stiff, hd._STIFFNESS, rtol=1e-12)
    assert hd.MODEL.n_rows == 242


def test_fk_mass_bias_match_mj_forward():
    """World FK, mass matrix and bias forces match MuJoCo to machine
    precision on fallen/self-contact states."""
    m, d = _mj(newton=False)

    @fast_jit
    def fk_m_bias(q, qv):
        fr = frames(hd.MODEL, q)
        mm = mass_entries_analytic(hd.MODEL, q, fr)
        b = bias_analytic(hd.MODEL, q, qv, fr)
        xp = jnp.stack([jnp.stack(fr.origin[bi]) for bi in range(13)])
        mj = jnp.stack([
            jnp.stack([mm[i][j] if i >= j else mm[j][i] for j in range(23)])
            for i in range(23)
        ])
        return xp, mj, jnp.stack(b)

    for qp, qv in _thrash_states(3, seed=3):
        d.qpos[:] = qp
        d.qvel[:] = qv
        mujoco.mj_forward(m, d)
        xp, mj, b = fk_m_bias(
            tuple(jnp.float64(x) for x in qp),
            tuple(jnp.float64(x) for x in qv),
        )
        np.testing.assert_allclose(np.asarray(xp), d.xpos[1:], atol=1e-12)
        full = np.zeros((23, 23))
        mujoco.mj_fullM(m, d, full)
        np.testing.assert_allclose(np.asarray(mj), full, atol=1e-11)
        np.testing.assert_allclose(np.asarray(b), d.qfrc_bias, atol=1e-9)


def test_constrained_qacc_matches_mj_forward_newton():
    """Constrained forward dynamics (floor cones + self-collision +
    limits through the box-QP) matches the Newton-converged mj_forward
    at solver tolerance on fallen states with active self-contacts."""
    m, d = _mj(newton=True)

    @fast_jit
    def qacc(q, qv, tau):
        return jnp.stack(hd._qacc_constrained(q, qv, tau, 6, 40))

    rng = np.random.default_rng(1)
    ncon = nself = 0
    for qp, qv in _thrash_states(5, seed=0):
        ctrl = rng.uniform(-0.4, 0.4, 17)
        d.qpos[:] = qp
        d.qvel[:] = qv
        d.ctrl[:] = ctrl
        mujoco.mj_forward(m, d)
        tau = np.zeros(23)
        for k, (dof, gear) in enumerate(hd._ACTUATORS):
            tau[dof] = gear * ctrl[k]
        acc = np.asarray(
            qacc(
                tuple(jnp.float64(x) for x in qp),
                tuple(jnp.float64(x) for x in qv),
                tuple(jnp.float64(x) for x in tau),
            )
        )
        scale = max(1.0, np.abs(d.qacc).max())
        np.testing.assert_allclose(acc / scale, d.qacc / scale, atol=1e-10)
        ncon += d.ncon
        nself += sum(1 for c in d.contact if c.geom1 != 0)
    assert ncon >= 10 and nself >= 4  # genuinely contact/self-contact rich


@pytest.mark.slow
def test_trajectory_matches_mj_step_newton():
    """Frame-skipped steps of random full-range actions from the gym
    standing init (fall + impact): the on-device trajectory tracks the
    Newton-solver mj_step at MACHINE precision — measured max relative
    error 2.1e-14 over the 15 steps at (6, 40), unchanged at (12, 120)
    (round-5 sweep; the earlier rtol=3e-5 was a stale conservative bound
    from before the solver-convergence work, not the actual error).
    Asserted at rtol=1e-12 — the planar suites' exactness grade."""
    m, d = _mj(newton=True)
    mujoco.mj_resetData(m, d)
    env = HumanoidDeviceEnv(dtype=jnp.float64, solver_outer=6, solver_cg=40)
    s = env.reset()
    step = fast_jit(env.step)
    rng = np.random.default_rng(1)
    for t in range(15):
        a = rng.uniform(-0.4, 0.4, 17)
        d.ctrl[:] = a
        for _ in range(hd._FRAME_SKIP):
            mujoco.mj_step(m, d)
        s = step(s, jnp.asarray(a))
        np.testing.assert_allclose(
            np.asarray(s.x[:24]), d.qpos, rtol=1e-12, atol=1e-13
        )
    # stage-4 com x quirk: matches gym's mass_center over data.xipos
    num = np.einsum("b,bj->j", m.body_mass, d.xipos) / m.body_mass.sum()
    np.testing.assert_allclose(float(s.x[47]), num[0], rtol=1e-6, atol=1e-7)


def test_obs_and_reward_match_gymnasium_newton():
    """Obs (kinematic prefix) and reward vs the gym env with the solver
    switched to Newton (converged reference; stock PGS-50 drifts by its
    own solver residual)."""
    g = gymnasium.make("Humanoid-v4", reset_noise_scale=0.0).unwrapped
    g.reset(seed=0)
    g.model.opt.solver = 2
    g.model.opt.iterations = 200
    g.model.opt.tolerance = 1e-15
    env = HumanoidDeviceEnv(dtype=jnp.float64, solver_outer=6, solver_cg=40)
    s = env.reset()
    np.testing.assert_allclose(
        np.asarray(env.observation(s)), g._get_obs()[:45], atol=0
    )
    sr = fast_jit(env.step_reward)
    rng = np.random.default_rng(5)
    for _ in range(6):
        a = rng.uniform(-0.4, 0.4, 17)
        og, rg, *_ = g.step(a)
        s, r = sr(s, jnp.asarray(a))
        np.testing.assert_allclose(float(r), rg, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(env.observation(s)), og[:45],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.slow
def test_policy_keeps_torso_up():
    """CEMPPI on the on-device Humanoid slows the fall dramatically vs
    zero-action (the healthy-bonus objective through the full MPC loop;
    a tiny-K smoke test, not a trained controller).

    The policy step and the env step are jitted SEPARATELY: fusing the
    vmapped rollout and the scalar substep of a 242-row model into one
    XLA:CPU module makes LLVM blow up (segfault at any K/H — probed on
    r4 and r5 code alike; the split modules each compile in minutes).
    Marked slow: the two CPU compiles take ~10 min cold on one core."""
    from mpopis_tpu.policies import PolicyConfig, make_policy

    env = HumanoidDeviceEnv(dtype=jnp.float64, solver_outer=3, solver_cg=6)
    cfg = PolicyConfig(kind="cemppi", num_samples=12, horizon=6, lam=1.0,
                       opt_its=2, sigma_est="mle")
    pol = make_policy(env, cfg, cov_mat=[0.04] * 17, jit=False)

    pol_step = fast_jit(lambda s, ps: pol.step(s, ps)[:2])
    step = fast_jit(env.step)

    s, ps = env.reset(), pol.init_state(1)
    for _ in range(6):
        a, ps = pol_step(s, ps)
        s = step(s, a)
    z_mpc = float(s.x[2])

    step = fast_jit(env.step)
    s0 = env.reset()
    for _ in range(6):
        s0 = step(s0, jnp.zeros(17))
    assert z_mpc > float(s0.x[2]) - 0.25  # not collapsing faster than free fall
    assert z_mpc > 0.6
