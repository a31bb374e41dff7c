"""Policy-level tests: every variant runs, invariants hold, and the
minimum end-to-end slice (MountainCar) is actually solved."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpopis_tpu.models import CartPoleEnv, MountainCarEnv
from mpopis_tpu.policies import PolicyConfig, make_policy

ALL_KINDS = [
    "mppi",
    "gmppi",
    "imppi",
    "cemppi",
    "cmamppi",
    "muaismppi",
    "musigmaaismppi",
    "pmcmppi",
    "nesmppi",
]


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_policy_step_runs_and_weights_normalized(kind):
    env = MountainCarEnv(dtype=jnp.float64)
    cfg = PolicyConfig(
        kind=kind,
        num_samples=16,
        horizon=8,
        lam=0.1,
        opt_its=3,
        lambda_ais=0.1,
        log=True,
    )
    pol = make_policy(env, cfg, cov_mat=[1.5])
    ps = pol.init_state(0)
    s = env.reset()
    act, ps2, info = pol.step(s, ps)
    assert act.shape == (1,)
    assert np.isfinite(float(act[0]))
    assert -1.0 <= float(act[0]) <= 1.0
    w = np.asarray(info["weights"])
    np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-6)
    assert np.all(w >= 0)
    assert np.all(np.isfinite(np.asarray(info["costs"])))
    assert info["trajectories"].shape == (16, 8, 2)
    # policy state advanced
    assert ps2.U.shape == ps.U.shape
    assert not np.array_equal(np.asarray(ps2.key), np.asarray(ps.key))


@pytest.mark.parametrize("kind", ["mppi", "cemppi", "musigmaaismppi"])
def test_mountain_car_solved(kind):
    """The reference's MountainCar defaults (K=20, H=15, λ=0.1, Σ=[1.5],
    ais_its=5) drive the car to the goal well under 200 steps."""
    env = MountainCarEnv(dtype=jnp.float64)
    cfg = PolicyConfig(
        kind=kind,
        num_samples=20,
        horizon=15,
        lam=0.1,
        opt_its=5,
        lambda_ais=0.1,
        sigma_est="mle",
    )
    pol = make_policy(env, cfg, cov_mat=[1.5])
    ps = pol.init_state(42)
    s = env.reset(jax.random.PRNGKey(7))
    total = 0.0
    for step in range(200):
        act, ps, _ = pol.step(s, ps)
        s = env.step(s, act)
        total += float(env.reward(s))
        if bool(s.done):
            break
    assert bool(s.done)
    assert float(s.x[0]) >= env.goal_pos
    assert total > 90000.0  # got the +1e5 goal bonus
    assert step < 199


def test_cartpole_balances():
    env = CartPoleEnv(dtype=jnp.float64)
    cfg = PolicyConfig(
        kind="cemppi", num_samples=20, horizon=15, lam=0.1, opt_its=5
    )
    pol = make_policy(env, cfg, cov_mat=[1.5])
    ps = pol.init_state(3)
    s = env.reset(jax.random.PRNGKey(5))
    steps = 0
    while not bool(s.done) and steps <= 200:
        act, ps, _ = pol.step(s, ps)
        s = env.step(s, act)
        steps += 1
    assert steps > 150  # balanced most of the episode


def test_gmppi_single_iteration_equals_unadapted_ce():
    """With opt_its=1 every AIS strategy degenerates to plain GMPPI (no
    update is ever applied), so actions must agree for identical keys."""
    env = MountainCarEnv(dtype=jnp.float64)
    base = dict(num_samples=16, horizon=8, lam=0.1, opt_its=1)
    p1 = make_policy(env, PolicyConfig(kind="gmppi", **base), cov_mat=[1.5])
    p2 = make_policy(env, PolicyConfig(kind="cemppi", **base), cov_mat=[1.5])
    s = env.reset()
    a1, _, _ = p1.step(s, p1.init_state(9))
    a2, _, _ = p2.step(s, p2.init_state(9))
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a2), rtol=1e-9)


def test_ais_iterations_improve_costs():
    """More AIS iterations should (generically) lower the best cost found."""
    env = MountainCarEnv(dtype=jnp.float64)
    s = env.reset()
    mins = []
    for its in [1, 5]:
        cfg = PolicyConfig(
            kind="cemppi", num_samples=32, horizon=15, lam=0.1, opt_its=its
        )
        pol = make_policy(env, cfg, cov_mat=[1.5])
        _, _, info = pol.step(s, pol.init_state(11))
        mins.append(float(np.min(np.asarray(info["costs"]))))
    assert mins[1] <= mins[0] + 1e-9


def test_control_cost_zero_when_alpha_one():
    """α=1 ⇒ γ=0 ⇒ costs are pure trajectory costs; α<1 adds control cost."""
    env = MountainCarEnv(dtype=jnp.float64)
    s = env.reset()
    cfg1 = PolicyConfig(kind="gmppi", num_samples=16, horizon=8, lam=0.1, alpha=1.0)
    cfg2 = PolicyConfig(kind="gmppi", num_samples=16, horizon=8, lam=0.1, alpha=0.5)
    # control cost is γ·U_origᵀΣ⁻¹(V−U_orig): needs a nonzero nominal U
    p1 = make_policy(env, cfg1, u0=[0.5], cov_mat=[1.5])
    p2 = make_policy(env, cfg2, u0=[0.5], cov_mat=[1.5])
    _, _, i1 = p1.step(s, p1.init_state(13))
    _, _, i2 = p2.step(s, p2.init_state(13))
    c1 = np.asarray(i1["costs"])
    c2 = np.asarray(i2["costs"])
    assert not np.allclose(c1, c2)


def test_cma_update_survives_degenerate_sigma_f32():
    """Regression: the reference's scalar rank-μ quirk can leave Σ
    indefinite; in f32 the unguarded Σ^{-1/2} / step-size chain overflowed
    to NaN (and a NaN covariance breaks eigh). The relative eigenvalue
    floor and the step-size clips must keep every output finite."""
    import jax

    from mpopis_tpu.policies.strategies import AISCarry, make_strategy

    cs, k = 6, 32
    cfg = PolicyConfig(kind="cmamppi", num_samples=k, horizon=3, lam=10.0,
                       opt_its=10)
    strat = make_strategy(cfg, cs, jnp.float32)
    rng = np.random.default_rng(0)
    e = jnp.asarray(rng.normal(size=(cs, k)), dtype=jnp.float32)
    # indefinite Σ (quirk-shaped: PSD part plus a large constant matrix)
    sigma_bad = jnp.asarray(
        0.01 * np.eye(cs) - 5.0 * np.ones((cs, cs)), dtype=jnp.float32
    )
    carry = AISCarry(
        U=jnp.zeros((cs,), jnp.float32),
        chol=jnp.eye(cs, dtype=jnp.float32),
        E=e,
        costs=jnp.asarray(rng.normal(size=k) * 1e8, dtype=jnp.float32),
        trajs=None,
        done=jnp.asarray(False),
        key=jax.random.key(0),
        extra=dict(
            Sigma=sigma_bad,
            sigma=jnp.asarray(1e-6, jnp.float32),
            p_sigma=jnp.full((cs,), 1e3, jnp.float32),
            p_Sigma=jnp.zeros((cs,), jnp.float32),
        ),
    )
    new, _ = strat.update(carry, jax.random.key(1), carry.U, jnp.asarray(1))
    for leaf in jax.tree.leaves((new.U, new.chol, new.extra)):
        assert np.isfinite(np.asarray(leaf)).all()
