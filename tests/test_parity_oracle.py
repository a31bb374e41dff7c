"""Independent parity oracle: straight-line NumPy transcriptions of the
reference's AIS update loops, driven with the SAME injected standard
normals as the compiled driver (the `z=` hook, driver.py:280/363), and
compared per-configuration.

This is the implementation-independent semantic check: unlike the
self-goldens (which regress the code against
itself), every formula here is transcribed directly from
mppi_mpopi_policies.jl / utils.jl — the reference's loop structure,
moment conventions, jitters, clamps, and quirks — in plain NumPy with
per-sample Python loops, sharing no code with mpopis_tpu:

- simulate_model: V = U + E[:,k]; control cost γ·U_origᵀΣ⁻¹(V − U_orig)
  with the CURRENT iteration's sampling Σ (:249/:272); per-dimension
  clamp; cost = Σ_t −reward (utils.jl:129-144).
- IT weights: exp(−(c − min c)/λ) normalized (utils.jl:79-86).
- CE loop :434-472 (elite sortperm, flat-elite break BEFORE the refit,
  SimpleCovariance=uncorrected MLE + 10e-9·I, elite-mean shift).
- CMA loop :478-606 (full constant set, σ²Σ sampling for N>1, path
  updates, hσ with the loop variable n, and the scalar rank-μ quirk:
  δs[order[ii]] is a column-major LINEAR index into the cs×m_elite
  elite matrix).
- μ-AIS :644-671 / μΣ-AIS :709-742 (ProbabilityWeights mean_and_cov,
  uncorrected) and IMPPI :347-373.
- PMC :782-817 (inverse-CDF categorical resampling on the driver's own
  uniforms, corrected /(K−1) moments, +10e-9·I).
- NES :853-893 (per-sample gradient accumulation, the double-/K step,
  unsorted flat-cost break).
- Final glue :221-238: E translated by (U_final − U_orig), IT weights
  with the policy λ, weighted noise, first-action clamp, and the
  off-by-one U roll of get_controls_roll_U! (utils.jl:88-102).

Known intentional deviations absorbed by the tolerances: the driver
adds a dtype-scaled eps floor (~1e-14 in f64) on top of the reference's
1e-8 jitter (strategies.py::_jittered), and CMA's resampling Cholesky
adds the 1e-8 jitter where the reference has none (the raw quirk can
leave Σ indefinite).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mpopis_tpu.models.base import Env, EnvState, make_state
from mpopis_tpu.policies import PolicyConfig, make_policy

DT = 0.1
K, T, AS = 16, 4, 1
CS = T * AS


# ---------------------------------------------------------------------------
# Tiny nonlinear env, defined twice with identical arithmetic
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class OscEnv(Env):
    """Driven oscillator: x0' = x0 + dt·x1, x1' = x1 + dt·(a − 0.2 sin x0);
    post-step reward −(x0² + 0.1 x1²)."""

    state_dim = 2
    action_dim = 1
    action_low = np.array([-1.0])
    action_high = np.array([1.0])

    def reset(self, key=None) -> EnvState:
        return make_state(jnp.asarray([0.4, -0.3], dtype=self.dtype))

    def step(self, state: EnvState, action):
        x0, x1 = state.x[0], state.x[1]
        a = action[0]
        y0 = x0 + DT * x1
        y1 = x1 + DT * (a - 0.2 * jnp.sin(x0))
        return EnvState(
            x=jnp.stack([y0, y1]), t=state.t + 1, done=state.done
        )

    def reward(self, state: EnvState):
        return -(state.x[0] ** 2) - 0.1 * state.x[1] ** 2


def np_rollout_cost(x, v_clamped):
    """Σ_t −reward(s_{t+1}) for one flat clamped control sequence (cs,)."""
    x0, x1 = x
    cost = 0.0
    for t in range(T):
        a = v_clamped[t]
        y0 = x0 + DT * x1
        y1 = x1 + DT * (a - 0.2 * np.sin(x0))
        x0, x1 = y0, y1
        cost += x0 * x0 + 0.1 * x1 * x1
    return cost


def np_simulate(x0, u_cur, e, sigma_inv, u_orig, gamma):
    """simulate_model (mppi_mpopi_policies.jl:258-278)."""
    costs = np.zeros(K)
    for k in range(K):
        v = u_cur + e[:, k]
        cc = gamma * (u_orig @ sigma_inv @ (v - u_orig))
        costs[k] = np_rollout_cost(x0, np.clip(v, -1.0, 1.0)) + cc
    return costs


def np_it_weights(costs, lam):
    w = np.exp(-(costs - np.min(costs)) / lam)
    return w / np.sum(w)


def np_roll_u(weighted_controls, u0_flat):
    """get_controls_roll_U! (utils.jl:88-102): control = clamp of the
    first as entries; U[1:end−as] = wc[as+1:end]; U[end−as:end] =
    U₀[end−as:end] — the last assignment spans as+1 entries (the
    off-by-one quirk)."""
    control = np.clip(weighted_controls[:AS], -1.0, 1.0)
    u = np.empty(CS)
    u[: CS - AS] = weighted_controls[AS:]
    u[CS - AS - 1 :] = u0_flat[CS - AS - 1 :]
    return control, u


def np_weighted_mean_cov(e, w):
    """StatsBase.mean_and_cov(E, ProbabilityWeights(w), 2) — uncorrected."""
    mu = e @ w
    xc = e - mu[:, None]
    return mu, (xc * w[None, :]) @ xc.T


def _glue(u_final, u_orig, e_last, costs, lam, u0_flat):
    e_t = e_last + (u_final - u_orig)[:, None]
    w = np_it_weights(costs, lam)
    wc = u_orig + e_t @ w
    control, u_next = np_roll_u(wc, u0_flat)
    return control, u_next, costs, w


# ---------------------------------------------------------------------------
# Oracle loops (one function per reference calculate_trajectory_costs)
# ---------------------------------------------------------------------------


def oracle_gmppi(cfg, x0, u_orig, sigma0, z, u0_flat):
    chol = np.linalg.cholesky(sigma0)
    sigma_inv = np.linalg.inv(sigma0)
    e = chol @ z[0]
    costs = np_simulate(x0, u_orig, e, sigma_inv, u_orig, cfg.gamma)
    return _glue(u_orig, u_orig, e, costs, cfg.lam, u0_flat)


def oracle_mean_only(cfg, x0, u_orig, sigma0, z, u0_flat, inner_lam):
    """IMPPI (:347-373) and μ-AIS (:644-671): fixed P, mean-only shift."""
    u = u_orig.copy()
    chol = np.linalg.cholesky(sigma0)
    sigma_inv = np.linalg.inv(sigma0)
    for n in range(cfg.opt_its):
        e = chol @ z[n]
        costs = np_simulate(x0, u, e, sigma_inv, u_orig, cfg.gamma)
        if n < cfg.opt_its - 1:
            ws = np_it_weights(costs, inner_lam)
            mu, _ = np_weighted_mean_cov(e, ws)
            u = u + mu
    return _glue(u, u_orig, e, costs, cfg.lam, u0_flat)


def oracle_mean_cov(cfg, x0, u_orig, sigma0, z, u0_flat):
    """μΣ-AIS (:709-742)."""
    u = u_orig.copy()
    sigma = sigma0.copy()
    for n in range(cfg.opt_its):
        chol = np.linalg.cholesky(sigma)
        sigma_inv = np.linalg.inv(sigma)
        e = chol @ z[n]
        costs = np_simulate(x0, u, e, sigma_inv, u_orig, cfg.gamma)
        if n < cfg.opt_its - 1:
            ws = np_it_weights(costs, cfg.lambda_ais)
            mu, sg = np_weighted_mean_cov(e, ws)
            sigma = sg + 1e-8 * np.eye(CS)
            u = u + mu
    return _glue(u, u_orig, e, costs, cfg.lam, u0_flat)


def oracle_pmc(cfg, x0, u_orig, sigma0, z, u0_flat, uniforms):
    """PMC (:782-817); `uniforms` are the driver's resampling uniforms —
    the categorical draw is inverse-CDF over them (RNG streams are out of
    parity scope; the update math given the randomness is what's pinned)."""
    u = u_orig.copy()
    sigma = sigma0.copy()
    for n in range(cfg.opt_its):
        chol = np.linalg.cholesky(sigma)
        sigma_inv = np.linalg.inv(sigma)
        e = chol @ z[n]
        costs = np_simulate(x0, u, e, sigma_inv, u_orig, cfg.gamma)
        if n < cfg.opt_its - 1:
            ws = np_it_weights(costs, cfg.lambda_ais)
            cdf = np.cumsum(ws)
            cdf = cdf / cdf[-1]
            idx = np.searchsorted(cdf, uniforms[n], side="left")
            ep = e[:, idx]
            mu = np.mean(ep, axis=1)
            xc = ep - mu[:, None]
            sigma = (xc @ xc.T) / (K - 1) + 1e-8 * np.eye(CS)
            u = u + mu
    return _glue(u, u_orig, e, costs, cfg.lam, u0_flat)


def oracle_ce(cfg, x0, u_orig, sigma0, z, u0_flat):
    """CEMPPI (:434-472) with the :mle estimator (SimpleCovariance,
    uncorrected /m)."""
    m_elite = int(round(K * (1.0 - cfg.ce_elite_threshold)))
    u = u_orig.copy()
    sigma = sigma0.copy()
    for n in range(cfg.opt_its):
        chol = np.linalg.cholesky(sigma)
        sigma_inv = np.linalg.inv(sigma)
        e = chol @ z[n]
        costs = np_simulate(x0, u, e, sigma_inv, u_orig, cfg.gamma)
        if n < cfg.opt_its - 1:
            order = np.argsort(costs, kind="stable")
            elite = e[:, order[:m_elite]]
            elite_costs = costs[order[:m_elite]]
            if np.max(np.abs(np.diff(elite_costs))) < cfg.elite_stop_tol:
                break
            xc = elite.T - np.mean(elite.T, axis=0, keepdims=True)
            sigma = (xc.T @ xc) / m_elite + 1e-8 * np.eye(CS)
            u = u + np.mean(elite, axis=1)
    return _glue(u, u_orig, e, costs, cfg.lam, u0_flat)


def oracle_cma(cfg, x0, u_orig, sigma0, z, u0_flat):
    """CMAMPPI (:478-606), including the scalar rank-μ quirk."""
    m, n_dim = K, CS
    m_elite = int(round((1.0 - cfg.cma_elite_threshold) * m))
    ws = np.log((m + 1) / 2.0) - np.log(np.arange(1, m + 1))
    ws[:m_elite] = ws[:m_elite] / np.sum(ws[:m_elite])
    mu_eff = 1.0 / np.sum(ws[:m_elite] ** 2)
    c_sig = (mu_eff + 2.0) / (n_dim + mu_eff + 5.0)
    d_sig = (
        1.0
        + 2.0 * max(0.0, np.sqrt((mu_eff - 1.0) / (n_dim + 1.0)) - 1.0)
        + c_sig
    )
    c_Sig = (4.0 + mu_eff / n_dim) / (n_dim + 4.0 + 2.0 * mu_eff / n_dim)
    c1 = 2.0 / ((n_dim + 1.3) ** 2 + mu_eff)
    c_mu = min(
        1.0 - c1,
        2.0 * (mu_eff - 2.0 + 1.0 / mu_eff) / ((n_dim + 2.0) ** 2 + mu_eff),
    )
    ws[m_elite:] = ws[m_elite:] * (-(1.0 + c1 / c_mu) / np.sum(ws[m_elite:]))
    e_norm = n_dim**0.5 * (
        1.0 - 1.0 / (4.0 * n_dim) + 1.0 / (21.0 * n_dim**2)
    )

    N = cfg.opt_its
    sig = cfg.cma_sigma
    u = u_orig.copy()
    Sigma = sigma0.copy()
    p_sig = np.zeros(CS)
    p_Sig = np.zeros(CS)
    for n in range(1, N + 1):
        samp_cov = (sig**2 * Sigma) if N > 1 else Sigma
        # the driver factorizes with the +1e-8 jitter (the raw quirk can
        # leave Σ indefinite); mirror it for the sampling factor only
        chol = np.linalg.cholesky(
            sig**2 * (Sigma + 1e-8 * np.eye(CS)) if N > 1 else Sigma
        )
        sigma_inv = np.linalg.inv(samp_cov)
        e = chol @ z[n - 1]
        costs = np_simulate(x0, u, e, sigma_inv, u_orig, cfg.gamma)
        if n < N:
            order = np.argsort(costs, kind="stable")
            elite_e = e[:, order[:m_elite]]
            elite_costs = costs[order[:m_elite]]
            if np.max(np.abs(np.diff(elite_costs))) < cfg.elite_stop_tol:
                break
            ds = elite_e / sig
            dw = np.array(
                [ws[:m_elite] @ elite_e[r, :] for r in range(CS)]
            )
            u = u + sig * dw
            # C = Σ^-0.5 (principal, via eigendecomposition)
            evals, evecs = np.linalg.eigh(Sigma)
            C = (evecs / np.sqrt(evals)[None, :]) @ evecs.T
            p_sig = (1 - c_sig) * p_sig + np.sqrt(
                c_sig * (2 - c_sig) * mu_eff
            ) * (C @ dw)
            sig = sig * np.exp(
                c_sig / d_sig * (np.linalg.norm(p_sig) / e_norm - 1.0)
            )
            h_sig = int(
                np.linalg.norm(p_sig) / np.sqrt(1 - (1 - c_sig) ** (2 * n))
                < (1.4 + 2.0 / (CS + 1)) * e_norm
            )
            p_Sig = (1 - c_Sig) * p_Sig + h_sig * np.sqrt(
                c_Sig * (2 - c_Sig) * mu_eff
            ) * dw
            # scalar rank-μ quirk: δs[order[ii]] is a column-major linear
            # index into the cs×m_elite matrix (a scalar)
            ds_cm = ds.flatten(order="F")
            temp_sum = 0.0
            for ii in range(K):
                s = ds_cm[order[ii]]
                if ws[ii] >= 0:
                    w0 = ws[ii]
                else:
                    w0 = n * ws[ii] / np.linalg.norm(C * s, "fro") ** 2
                temp_sum += w0 * s * s
            Sigma = (
                (1 - c1 - c_mu) * Sigma
                + c1
                * (
                    np.outer(p_Sig, p_Sig)
                    + (1 - h_sig) * c_Sig * (2 - c_Sig) * Sigma
                )
                + c_mu * temp_sum
            )
            Sigma = np.triu(Sigma) + np.triu(Sigma, 1).T
    return _glue(u, u_orig, e, costs, cfg.lam, u0_flat)


def oracle_nes(cfg, x0, u_orig, sigma0, z, u0_flat):
    """NESMPPI (:853-893)."""
    u = u_orig.copy()
    # A = sqrt(Σ) — Julia's principal matrix sqrt for symmetric matrices
    evals, evecs = np.linalg.eigh(sigma0)
    A = (evecs * np.sqrt(np.maximum(evals, 0.0))[None, :]) @ evecs.T
    Sigma = sigma0.copy()
    N = cfg.opt_its
    for n in range(1, N + 1):
        chol = np.linalg.cholesky(Sigma + (0.0 if n == 1 else 1e-8 * np.eye(CS)))
        sigma_inv = np.linalg.inv(Sigma)
        e = chol @ z[n - 1]
        costs = np_simulate(x0, u, e, sigma_inv, u_orig, cfg.gamma)
        if np.max(np.abs(np.diff(costs))) < cfg.elite_stop_tol:
            break
        if n < N:
            g_mu = np.zeros(CS)
            g_A = np.zeros((CS, CS))
            for k in range(K):
                g_mu += sigma_inv @ e[:, k] * costs[k]
                g_S = (
                    0.5 * sigma_inv @ np.outer(e[:, k], e[:, k]) @ sigma_inv
                    - 0.5 * sigma_inv
                )
                g_A += A @ (g_S + g_S.T) * costs[k]
            A = A - cfg.nes_step_factor / K * g_A / K
            Sigma = A.T @ A
            u = u - cfg.nes_step_factor / K * g_mu
    return _glue(u, u_orig, e, costs, cfg.lam, u0_flat)


def oracle_mppi(cfg, x0, u_orig, sigma_as, z_kta, u0_flat):
    """Classic MPPI (:148-216): per-timestep as-dim noise, γ·uₜᵀΣ⁻¹εₖₜ."""
    chol = np.linalg.cholesky(sigma_as)
    sigma_inv = np.linalg.inv(sigma_as)
    e = z_kta @ chol.T  # (K, T, as)
    u_mat = u_orig.reshape(T, AS)
    costs = np.zeros(K)
    for k in range(K):
        v = np.clip(u_mat + e[k], -1.0, 1.0)
        costs[k] = np_rollout_cost(x0, v.reshape(-1))
        for t in range(T):
            costs[k] += cfg.gamma * (u_mat[t] @ sigma_inv @ e[k, t])
    w = np_it_weights(costs, cfg.lam)
    wn = np.einsum("k,kta->ta", w, e).reshape(CS)
    wc = u_orig + wn
    control, u_next = np_roll_u(wc, u0_flat)
    return control, u_next, costs, w


# ---------------------------------------------------------------------------
# Driver runner + comparisons
# ---------------------------------------------------------------------------


def _sigma0():
    rng = np.random.default_rng(42)
    a = rng.normal(size=(CS, CS)) * 0.2
    return a @ a.T + 0.3 * np.eye(CS)


def _run_driver(kind, opt_its, z_shape, seed=11, **cfg_kw):
    env = OscEnv(dtype=jnp.float64)
    cfg_kw.setdefault("ce_elite_threshold", 0.75)
    cfg = PolicyConfig(
        kind=kind, num_samples=K, horizon=T, lam=0.5, alpha=0.6,
        opt_its=opt_its, lambda_ais=2.0,
        sigma_est="mle", cma_sigma=0.9, cma_elite_threshold=0.5,
        nes_step_factor=0.01, **cfg_kw,
    )
    u0 = np.array([0.1])
    sigma0 = _sigma0() if kind != "mppi" else np.array([[0.25]])
    pol = make_policy(env, cfg, u0=u0, cov_mat=sigma0, jit=False)
    s = env.reset()
    ps = pol.init_state(seed)
    rng = np.random.default_rng(7)
    z = rng.normal(size=z_shape)
    action, ps2, info = pol.step(s, ps, z=jnp.asarray(z))
    return (
        cfg, np.asarray(s.x), np.asarray(ps.U), sigma0, z,
        pol.u0_flat, np.asarray(action), np.asarray(ps2.U),
        np.asarray(info["costs"]), np.asarray(info["weights"]), ps,
    )


def _compare(dr, orc, rtol=1e-9, atol=1e-11):
    action, u_next, costs, weights = dr
    o_action, o_u, o_costs, o_w = orc
    np.testing.assert_allclose(costs, o_costs, rtol=rtol, atol=atol)
    np.testing.assert_allclose(weights, o_w, rtol=rtol, atol=atol)
    np.testing.assert_allclose(action, o_action, rtol=rtol, atol=atol)
    np.testing.assert_allclose(u_next, o_u, rtol=rtol, atol=atol)


@pytest.mark.parametrize("opt_its", [1, 3])
def test_oracle_gmppi_imppi_muais(opt_its):
    for kind, inner in (("imppi", 0.5), ("muaismppi", 2.0)):
        cfg, x0, u_orig, sigma0, z, u0f, *dr = _run_driver(
            kind, opt_its, (opt_its, CS, K)
        )
        orc = oracle_mean_only(cfg, x0, u_orig, sigma0, z, u0f, inner)
        _compare(tuple(dr[:4]), orc)
    cfg, x0, u_orig, sigma0, z, u0f, *dr = _run_driver("gmppi", 1, (1, CS, K))
    orc = oracle_gmppi(cfg, x0, u_orig, sigma0, z, u0f)
    _compare(tuple(dr[:4]), orc)


@pytest.mark.parametrize("opt_its", [1, 3])
def test_oracle_musigma(opt_its):
    cfg, x0, u_orig, sigma0, z, u0f, *dr = _run_driver(
        "musigmaaismppi", opt_its, (opt_its, CS, K)
    )
    orc = oracle_mean_cov(cfg, x0, u_orig, sigma0, z, u0f)
    _compare(tuple(dr[:4]), orc, rtol=1e-7)


@pytest.mark.parametrize("opt_its", [1, 3])
def test_oracle_ce(opt_its):
    # ce_elite_threshold=0.5 ⇒ m_elite=8 > cs: full-rank refit, strict check
    cfg, x0, u_orig, sigma0, z, u0f, *dr = _run_driver(
        "cemppi", opt_its, (opt_its, CS, K), ce_elite_threshold=0.5
    )
    orc = oracle_ce(cfg, x0, u_orig, sigma0, z, u0f)
    _compare(tuple(dr[:4]), orc, rtol=1e-7)


def test_oracle_ce_rank_deficient():
    """m_elite=4 = cs ⇒ the MLE refit Σ is singular and Σ⁻¹ rides on the
    jitter; the driver's dtype eps-floor (~2e-15 in f64 on top of the
    reference's 1e-8) shows up at ~1e-7 relative in the γ control costs —
    the one documented deviation, checked at a tolerance that would still
    catch any semantic error."""
    cfg, x0, u_orig, sigma0, z, u0f, *dr = _run_driver(
        "cemppi", 3, (3, CS, K)
    )
    orc = oracle_ce(cfg, x0, u_orig, sigma0, z, u0f)
    _compare(tuple(dr[:4]), orc, rtol=5e-6, atol=1e-8)


def test_oracle_ce_early_stop():
    """elite_stop_tol=1e9 forces the break at iteration 1: the driver's
    masked pass-through must equal the reference's literal break (final
    E/costs are iteration 1's, no update applied)."""
    cfg, x0, u_orig, sigma0, z, u0f, *dr = _run_driver(
        "cemppi", 3, (3, CS, K), elite_stop_tol=1e9
    )
    orc = oracle_ce(cfg, x0, u_orig, sigma0, z, u0f)
    _compare(tuple(dr[:4]), orc, rtol=1e-7)


@pytest.mark.parametrize("opt_its", [1, 3])
def test_oracle_cma(opt_its):
    cfg, x0, u_orig, sigma0, z, u0f, *dr = _run_driver(
        "cmamppi", opt_its, (opt_its, CS, K)
    )
    orc = oracle_cma(cfg, x0, u_orig, sigma0, z, u0f)
    # CMA's sampling factor carries the driver's 1e-8 jitter (the raw
    # reference factorization is not PD-safe) — slightly looser tolerance
    _compare(tuple(dr[:4]), orc, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("opt_its", [1, 3])
def test_oracle_pmc(opt_its):
    cfg, x0, u_orig, sigma0, z, u0f, a, un, c, w, ps = _run_driver(
        "pmcmppi", opt_its, (opt_its, CS, K)
    )
    # reconstruct the driver's per-iteration resampling uniforms (the key
    # schedule in driver.py:287-306)
    _, k_loop = jax.random.split(ps.key)
    carry_key = k_loop
    uniforms = []
    for _ in range(opt_its):
        carry_key, k_samp, k_strat = jax.random.split(carry_key, 3)
        uniforms.append(
            np.asarray(jax.random.uniform(k_strat, (K,), dtype=jnp.float64))
        )
    orc = oracle_pmc(cfg, x0, u_orig, sigma0, z, u0f, uniforms)
    _compare((a, un, c, w), orc, rtol=1e-7)


@pytest.mark.parametrize("opt_its", [1, 3])
def test_oracle_nes(opt_its):
    cfg, x0, u_orig, sigma0, z, u0f, *dr = _run_driver(
        "nesmppi", opt_its, (opt_its, CS, K)
    )
    orc = oracle_nes(cfg, x0, u_orig, sigma0, z, u0f)
    _compare(tuple(dr[:4]), orc, rtol=1e-7)


def test_oracle_mppi():
    cfg, x0, u_orig, sigma_as, z, u0f, *dr = _run_driver(
        "mppi", 1, (K, T, AS)
    )
    orc = oracle_mppi(cfg, x0, u_orig, sigma_as, z, u0f)
    _compare(tuple(dr[:4]), orc)
