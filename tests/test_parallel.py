"""Sharding tests on the forced 8-device CPU topology: collective
formulations must match local math exactly, and a sharded policy step must
equal the single-device step bitwise (same keys)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map

from mpopis_tpu import ops
from mpopis_tpu.models import CarRacingEnv, MountainCarEnv
from mpopis_tpu.parallel import (
    SAMPLE_AXIS,
    global_it_weights,
    global_mean_cov,
    global_top_k,
    global_weighted_mean_cov,
    make_sample_mesh,
    sample_sharding,
)
from mpopis_tpu.policies import PolicyConfig, make_policy


def _mesh():
    assert len(jax.devices()) == 8, "tests expect the forced 8-device topology"
    return make_sample_mesh(8)


def test_global_it_weights_matches_local():
    mesh = _mesh()
    costs = jnp.asarray(np.random.default_rng(0).normal(size=64))
    f = shard_map(
        functools.partial(global_it_weights, lam=3.0, axis=SAMPLE_AXIS),
        mesh=mesh,
        in_specs=P(SAMPLE_AXIS),
        out_specs=P(SAMPLE_AXIS),
    )
    w_sharded = np.asarray(f(costs))
    w_local = np.asarray(ops.information_theoretic_weights(costs, 3.0))
    np.testing.assert_array_equal(w_sharded, w_local)


def test_global_weighted_mean_cov_matches_local():
    mesh = _mesh()
    rng = np.random.default_rng(1)
    e = jnp.asarray(rng.normal(size=(6, 64)))
    w = rng.uniform(size=64)
    w = jnp.asarray(w / w.sum())
    f = shard_map(
        functools.partial(global_weighted_mean_cov, axis=SAMPLE_AXIS),
        mesh=mesh,
        in_specs=(P(None, SAMPLE_AXIS), P(SAMPLE_AXIS)),
        out_specs=(P(), P()),
    )
    mu_s, cov_s = f(e, w)
    mu_l, cov_l = ops.weighted_mean_and_cov(e, w)
    np.testing.assert_allclose(np.asarray(mu_s), np.asarray(mu_l), rtol=1e-12)
    # cov via E[wxxᵀ]−μμᵀ differs from the centered form only by rounding
    np.testing.assert_allclose(np.asarray(cov_s), np.asarray(cov_l), atol=1e-12)


def test_global_mean_cov_matches_local():
    mesh = _mesh()
    e = jnp.asarray(np.random.default_rng(2).normal(size=(4, 40)))
    f = shard_map(
        functools.partial(global_mean_cov, axis=SAMPLE_AXIS, k_global=40),
        mesh=mesh,
        in_specs=P(None, SAMPLE_AXIS),
        out_specs=(P(), P()),
    )
    mu_s, cov_s = f(e)
    mu_l, cov_l = ops.mean_and_cov(e, corrected=True)
    np.testing.assert_allclose(np.asarray(mu_s), np.asarray(mu_l), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(cov_s), np.asarray(cov_l), atol=1e-12)


def test_global_top_k_matches_local():
    mesh = _mesh()
    costs = jnp.asarray(np.random.default_rng(3).permutation(64).astype(float))
    f = shard_map(
        functools.partial(global_top_k, k=5, axis=SAMPLE_AXIS),
        mesh=mesh,
        in_specs=P(SAMPLE_AXIS),
        out_specs=(P(), P()),
    )
    vals, idx = f(costs)
    order = np.argsort(np.asarray(costs))[:5]
    np.testing.assert_array_equal(np.asarray(vals), np.asarray(costs)[order])
    np.testing.assert_array_equal(np.sort(np.asarray(idx)), np.sort(order))


def test_sharded_policy_step_equals_single_device():
    """The GSPMD-sharded policy step must produce the same action as the
    unsharded one — sharding is a layout annotation, not a math change."""
    mesh = _mesh()
    env = CarRacingEnv(dtype=jnp.float64)
    cfg = PolicyConfig(
        kind="cemppi", num_samples=32, horizon=10, lam=10.0, opt_its=2,
        sigma_est="ss",
    )
    cov = np.diag([0.0625, 0.1])
    p_plain = make_policy(env, cfg, cov_mat=cov)
    p_shard = make_policy(
        env, cfg, cov_mat=cov, sample_sharding=sample_sharding(mesh, ndim=3)
    )
    s = env.reset()
    a1, ps1, i1 = p_plain.step(s, p_plain.init_state(5))
    a2, ps2, i2 = p_shard.step(s, p_shard.init_state(5))
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a2), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(i1["costs"]), np.asarray(i2["costs"]), rtol=1e-12
    )
    np.testing.assert_allclose(np.asarray(ps1.U), np.asarray(ps2.U), rtol=1e-12)


def test_sharded_fused_kernel_matches_unsharded():
    """With sample sharding active, the car rollout kernel runs per-shard
    inside shard_map (GSPMD cannot partition a pallas_call); its policy
    step must match the unsharded kernel step and the vmap-path step.
    The Pallas interpreter stands in for the GPU kernel on the CPU
    topology."""
    mesh = _mesh()
    env = CarRacingEnv(dtype=jnp.float32, fused_interpret=True)
    assert env.supports_fused_rollout
    cfg = PolicyConfig(
        kind="cemppi", num_samples=32, horizon=6, lam=10.0, opt_its=2,
        sigma_est="ss",
    )
    cov = np.diag([0.0625, 0.1])
    p_fused = make_policy(env, cfg, cov_mat=cov)
    p_shard = make_policy(
        env, cfg, cov_mat=cov, sample_sharding=sample_sharding(mesh, ndim=3)
    )
    env_vmap = CarRacingEnv(dtype=jnp.float32)
    assert not env_vmap.supports_fused_rollout
    p_vmap = make_policy(env_vmap, cfg, cov_mat=cov)

    s = env.reset()
    a_f, ps_f, i_f = p_fused.step(s, p_fused.init_state(9))
    a_s, ps_s, i_s = p_shard.step(s, p_shard.init_state(9))
    a_v, _, i_v = p_vmap.step(s, p_vmap.init_state(9))
    np.testing.assert_allclose(np.asarray(a_s), np.asarray(a_f), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(i_s["costs"]), np.asarray(i_f["costs"]), rtol=1e-5
    )
    np.testing.assert_allclose(np.asarray(a_v), np.asarray(a_s), rtol=1e-3, atol=1e-4)


def test_sharded_fused_mppi_and_uneven_fallback():
    """Classic MPPI's (K,T,as) controls also reach the kernel under
    shard_map; a K that doesn't divide over the mesh takes the GSPMD vmap
    path with a warning instead of failing at trace time."""
    import warnings

    mesh = _mesh()
    env = CarRacingEnv(dtype=jnp.float32, fused_interpret=True)
    cfg = PolicyConfig(kind="mppi", num_samples=32, horizon=5, lam=10.0)
    cov = np.diag([0.0625, 0.1])
    p_fused = make_policy(env, cfg, cov_mat=cov)
    p_shard = make_policy(
        env, cfg, cov_mat=cov, sample_sharding=sample_sharding(mesh, ndim=3)
    )
    s = env.reset()
    a_f, _, i_f = p_fused.step(s, p_fused.init_state(3))
    a_s, _, i_s = p_shard.step(s, p_shard.init_state(3))
    np.testing.assert_allclose(np.asarray(a_s), np.asarray(a_f), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(i_s["costs"]), np.asarray(i_f["costs"]), rtol=1e-5
    )

    cfg_odd = PolicyConfig(kind="cemppi", num_samples=30, horizon=5,
                           lam=10.0, opt_its=2, sigma_est="ss")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        p_odd = make_policy(
            env, cfg_odd, cov_mat=cov,
            sample_sharding=sample_sharding(mesh, ndim=3),
        )
        assert any("not divisible" in str(x.message) for x in w)
    a_o, _, _ = p_odd.step(s, p_odd.init_state(3))
    assert np.isfinite(np.asarray(a_o)).all()


def test_sharded_full_training_step_runs():
    """A full MPC step (policy + env step) jitted over the mesh executes."""
    mesh = _mesh()
    env = MountainCarEnv(dtype=jnp.float64)
    cfg = PolicyConfig(kind="muaismppi", num_samples=16, horizon=8, lam=0.1, opt_its=2)
    pol = make_policy(
        env, cfg, cov_mat=[1.5], sample_sharding=sample_sharding(mesh, ndim=3)
    )

    @jax.jit
    def mpc_step(env_state, pol_state):
        act, pol_state, _ = pol.step(env_state, pol_state)
        return env.step(env_state, act), pol_state

    s, ps = env.reset(), pol.init_state(0)
    s2, ps2 = mpc_step(s, ps)
    assert np.isfinite(np.asarray(s2.x)).all()


def test_global_top_k_exceeding_shard_size():
    """k > K_local (the reference's m_elite=30 at K=150 over 8 devices ⇒
    K_local=19): every shard contributes all its elements padded with
    +inf losers, so the hierarchical result stays exact."""
    mesh = _mesh()
    rng = np.random.default_rng(7)
    for k_total, k in ((152, 30), (64, 20), (160, 8)):
        costs = jnp.asarray(rng.permutation(k_total).astype(float))
        f = shard_map(
            functools.partial(global_top_k, k=k, axis=SAMPLE_AXIS),
            mesh=mesh,
            in_specs=P(SAMPLE_AXIS),
            out_specs=(P(), P()),
        )
        vals, idx = f(costs)
        order = np.argsort(np.asarray(costs), kind="stable")[:k]
        np.testing.assert_array_equal(np.asarray(vals), np.asarray(costs)[order])
        np.testing.assert_array_equal(np.sort(np.asarray(idx)), np.sort(order))


def test_gspmd_emits_psum_of_outer_products():
    """The compiled sharded μΣ-AIS step must contain the collective
    pattern parallel/collectives.py prescribes — scalar all-reduces for
    the softmax baseline/normalizer, a (cs,)-shaped all-reduce for the
    weighted mean, a (cs,cs)-shaped all-reduce for the covariance
    (psum of per-shard outer products) — and NO all-gather: the (cs,K)
    sample matrix never crosses devices. This pins GSPMD's lowering of
    the production path to the manual-collective formulation."""
    import re

    mesh = _mesh()
    env = MountainCarEnv(dtype=jnp.float64)
    cfg = PolicyConfig(
        kind="musigmaaismppi", num_samples=64, horizon=10, lam=0.1, opt_its=3
    )
    pol = make_policy(
        env, cfg, cov_mat=[1.5],
        sample_sharding=sample_sharding(mesh, ndim=3), jit=False,
    )
    s = env.reset()
    hlo = jax.jit(pol.step).lower(s, pol.init_state(0)).compile().as_text()
    assert "all-gather" not in hlo
    ar_shapes = re.findall(r"= (\S+) all-reduce", hlo)
    cs = 10  # horizon * action_dim
    assert any(sh.startswith("f64[]") for sh in ar_shapes), ar_shapes
    assert any(sh.startswith(f"f64[{cs},{cs}]") for sh in ar_shapes), ar_shapes
    assert any(sh.startswith(f"f64[{cs}]") for sh in ar_shapes), ar_shapes


def test_sharded_contact_kernel_matches_unsharded():
    """A contact task (HalfCheetah: generic vmap rollout with the contact
    QP in every substep) must run sample-sharded too. Two tiers:

    1. The rollout under shard_map, on identical clamped controls, is
       pinned TIGHT against the unsharded rollout — per-sample math is
       position-independent, so sharding the K axis must not change it.
    2. The full sample-sharded CEMPPI policy step matches the unsharded
       step at looser tolerance: GSPMD partitions the (cs,K) sampling
       matmul, whose f32 accumulation-order differences the chaotic
       contact rollout amplifies."""
    import jax.sharding as shd

    from mpopis_tpu.models import CheetahDeviceEnv, make_state, rollout_batch

    mesh = _mesh()
    env = CheetahDeviceEnv(dtype=jnp.float32, solver_outer=1, solver_cg=3)
    assert not env.supports_fused_rollout
    s = env.reset()

    # tier 1: the vmap rollout under shard_map, same controls
    k, t = 16, 2
    rng = np.random.default_rng(4)
    ctrl = jnp.asarray(
        rng.uniform(-1.0, 1.0, (k, t, env.action_dim)), dtype=jnp.float32
    )
    ref, _ = rollout_batch(env, s, ctrl)
    sharded = jax.shard_map(
        lambda x, c: rollout_batch(env, make_state(x), c)[0],
        mesh=mesh,
        in_specs=(shd.PartitionSpec(), shd.PartitionSpec(SAMPLE_AXIS)),
        out_specs=shd.PartitionSpec(SAMPLE_AXIS),
        # the contact solver's warm-start carry starts replicated
        check_vma=False,
    )(s.x, ctrl)
    np.testing.assert_allclose(
        np.asarray(sharded), np.asarray(ref), rtol=1e-6, atol=1e-6
    )

    # tier 2: full policy step
    cfg = PolicyConfig(
        kind="cemppi", num_samples=k, horizon=t, lam=0.1, opt_its=2,
        sigma_est="mle",
    )
    cov = [0.25] * env.action_dim
    p_plain = make_policy(env, cfg, cov_mat=cov)
    p_shard = make_policy(
        env, cfg, cov_mat=cov, sample_sharding=sample_sharding(mesh, ndim=3)
    )
    a_f, ps_f, i_f = p_plain.step(s, p_plain.init_state(11))
    a_s, ps_s, i_s = p_shard.step(s, p_shard.init_state(11))
    np.testing.assert_allclose(
        np.asarray(a_s), np.asarray(a_f), rtol=1e-2, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(i_s["costs"]), np.asarray(i_f["costs"]), rtol=1e-2, atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(ps_s.U), np.asarray(ps_f.U), rtol=1e-2, atol=1e-4
    )
