"""Adaptive-importance-sampling strategies.

Each MPOPI variant is a small pure "strategy": given the current AIS carry
(mean U, sampling-cov factor, this iteration's samples E and costs), produce
the next carry and an early-stop flag. One scan-based driver
(mpopis_tpu.policies.gmppi) runs any of them — mirroring the shared skeleton
of the reference's calculate_trajectory_costs methods
(mppi_mpopi_policies.jl:303-893) without duplicating the loop nine times.

All updates are matmul-shaped: weighted covariances are (cs,K)x(K,cs)
matmuls, never per-sample loops.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from mpopis_tpu.models.base import pytree_dataclass
from mpopis_tpu.ops.covariance import shrinkage_cov_masked, weighted_mean_and_cov
from mpopis_tpu.ops.sampling import multinomial_resample_counts
from mpopis_tpu.ops.weights import information_theoretic_weights


@pytree_dataclass
class AISCarry:
    U: jax.Array  # (cs,) current AIS mean
    chol: jax.Array  # (cs,cs) lower factor of the current sampling cov
    E: jax.Array  # (cs,K) last iteration's samples
    costs: jax.Array  # (K,) last iteration's trajectory costs
    trajs: Any  # (K,T,ss) logged states or None
    done: jax.Array  # () bool — AIS early-stopped
    key: jax.Array
    extra: Any  # strategy-specific state


@dataclasses.dataclass(frozen=True, eq=False)
class Strategy:
    """A no-op strategy (plain GMPPI: single-iteration, no adaptation)."""

    cfg: Any
    cs: int
    num_samples: int
    dtype: Any

    def init_chol(self, chol0: jnp.ndarray) -> jnp.ndarray:
        return chol0

    @property
    def can_stop(self) -> bool:
        """True when update() can ever return stop=True. The driver runs
        a `lax.while_loop` with a data-dependent trip count only when this
        is set; strategies that never stop (and stop-capable ones with
        elite_stop_tol <= 0) get a static `lax.scan`."""
        return False

    def update(self, carry: AISCarry, key, u_orig, it_index):
        """Returns (updated carry, stop_now). `carry` already holds this
        iteration's E/costs/trajs; `it_index` is the 1-based iteration
        number (the reference's loop variable n, which CMA reads)."""
        return carry, jnp.asarray(False)


def _eigh_inv_sqrt(sigma: jnp.ndarray, guards: bool, dtype) -> jnp.ndarray:
    """C = Σ^{-1/2} via eigendecomposition (the reference's Σ^-0.5)."""
    evals, evecs = jnp.linalg.eigh(sigma)
    if guards:
        eps = jnp.finfo(dtype).eps
        floor = jnp.maximum(jnp.maximum(evals[-1], 0.0) * eps * 10.0, 1e-30)
    else:
        floor = 1e-30
    inv_sqrt = 1.0 / jnp.sqrt(jnp.maximum(evals, floor))
    return (evecs * inv_sqrt[None, :]) @ evecs.T


def _inv_sqrt_newton_schulz(sigma: jnp.ndarray, its: int = 20):
    """Coupled Newton-Schulz iteration for Σ^{-1/2}: Y→(Σ/s)^{1/2},
    Z→(Σ/s)^{-1/2} with s = tr(Σ) (spectrum of Σ/s in (0,1] for PSD Σ, the
    convergence region). Matmul-only — ~60 (cs,cs) matmuls replace the
    sequential eigh. Returns (C, err) with err = max|ZY − I| for the caller's
    converged-check (quadratic convergence once close; very ill-
    conditioned or quirk-indefinite Σ won't converge — fall back)."""
    n = sigma.shape[0]
    eye = jnp.eye(n, dtype=sigma.dtype)
    s = jnp.trace(sigma)
    y = sigma / s

    def body(_, yz):
        y, z = yz
        t = 1.5 * eye - 0.5 * (z @ y)
        return y @ t, t @ z

    y, z = jax.lax.fori_loop(0, its, body, (y, eye))
    err = jnp.max(jnp.abs(z @ y - eye))
    return z / jnp.sqrt(s), err


def _jittered(sigma: jnp.ndarray, jitter: float) -> jnp.ndarray:
    """Diagonal jitter before Cholesky. The reference adds a fixed 1e-8·I
    (mppi_mpopi_policies.jl:464,733,808), which is enough in f64 but below
    rounding error in f32 when the refit covariance is rank-deficient (m_elite
    < cs with the :mle estimator); a dtype-scaled floor keeps the factorization
    PD in both precisions without visibly changing the sampling distribution."""
    scale = jnp.mean(jnp.diag(sigma))
    eps_floor = 100.0 * jnp.finfo(sigma.dtype).eps * scale
    return sigma + (jitter + eps_floor) * jnp.eye(
        sigma.shape[0], dtype=sigma.dtype
    )


@dataclasses.dataclass(frozen=True, eq=False)
class MeanOnlyStrategy(Strategy):
    """IMPPI (λ = policy λ) and μ-AIS (decoupled λ_ais): weighted moment
    matching of the mean only; Σ stays fixed.
    Ref: mppi_mpopi_policies.jl:347-373 and :644-671."""

    inner_lam: float = 1.0

    def update(self, carry, key, u_orig, it_index):
        ws = information_theoretic_weights(carry.costs, self.inner_lam)
        mu, _ = weighted_mean_and_cov(carry.E, ws)
        return carry.replace(U=carry.U + mu), jnp.asarray(False)


@dataclasses.dataclass(frozen=True, eq=False)
class MeanCovStrategy(Strategy):
    """μΣ-AIS: weighted moment matching of mean and covariance with jitter.
    Ref: mppi_mpopi_policies.jl:709-742."""

    inner_lam: float = 20.0

    def update(self, carry, key, u_orig, it_index):
        ws = information_theoretic_weights(carry.costs, self.inner_lam)
        mu, sigma = weighted_mean_and_cov(carry.E, ws)
        chol = jnp.linalg.cholesky(_jittered(sigma, self.cfg.cov_jitter))
        return carry.replace(U=carry.U + mu, chol=chol), jnp.asarray(False)


@dataclasses.dataclass(frozen=True, eq=False)
class PMCStrategy(Strategy):
    """Population Monte Carlo: multinomial resampling of the sample columns,
    then unweighted (corrected) moments. Ref: mppi_mpopi_policies.jl:782-817."""

    inner_lam: float = 20.0

    def update(self, carry, key, u_orig, it_index):
        ws = information_theoretic_weights(carry.costs, self.inner_lam)
        # moments of the resampled multiset via draw counts: identical set
        # statistics to gathering E[:, resample_indices] (same uniforms,
        # same bucketing), but a fused compare-reduce + two matmuls in
        # place of searchsorted + gather/scatter
        k = self.num_samples
        counts = multinomial_resample_counts(key, ws, k)
        mu = carry.E @ (counts / k)
        xc = carry.E - mu[:, None]
        sigma = (xc * counts[None, :]) @ xc.T / (k - 1)
        chol = jnp.linalg.cholesky(_jittered(sigma, self.cfg.cov_jitter))
        return carry.replace(U=carry.U + mu, chol=chol), jnp.asarray(False)


@dataclasses.dataclass(frozen=True, eq=False)
class CrossEntropyStrategy(Strategy):
    """CE-MPOPI: elite selection, shrinkage Σ refit, elite-mean shift, and
    early stop on flat elite costs. Ref: mppi_mpopi_policies.jl:434-472."""

    m_elite: int = 10

    @property
    def can_stop(self) -> bool:
        return float(self.cfg.elite_stop_tol) > 0.0

    def update(self, carry, key, u_orig, it_index):
        # Elite selection WITHOUT top_k/gather: a value sort gives the
        # sorted elite costs directly (the early-stop check, ref :455-461),
        # and the refit runs K-dense through a 0/1 mask (ties broken in
        # index order — exactly the reference's stable sortperm), so the
        # refit is matmul-only with no (cs, m) gather.
        m = self.m_elite
        costs = carry.costs
        sorted_costs = jnp.sort(costs)
        elite_costs = sorted_costs[:m]
        stop = jnp.max(jnp.abs(jnp.diff(elite_costs))) < self.cfg.elite_stop_tol
        thresh = sorted_costs[m - 1]
        lt = costs < thresh
        tie = costs == thresh
        n_take = m - jnp.sum(lt, dtype=jnp.int32)
        tie_rank = jnp.cumsum(tie.astype(jnp.int32))
        mask = (lt | (tie & (tie_rank <= n_take))).astype(costs.dtype)
        mu = (carry.E @ mask) / m
        sigma = shrinkage_cov_masked(carry.E, mask, m, self.cfg.sigma_est)
        chol = jnp.linalg.cholesky(_jittered(sigma, self.cfg.cov_jitter))
        new = carry.replace(U=carry.U + mu, chol=chol)
        return new, stop


@dataclasses.dataclass(frozen=True, eq=False)
class CMAStrategy(Strategy):
    """CMA-ES adaptation per control step. Ref: mppi_mpopi_policies.jl:478-606.

    Constants (log-rank weights, μ_eff, cσ, dσ, cΣ, c1, cμ, E[‖N(0,I)‖])
    follow the reference ctor (:513-525). The rank-μ term reproduces the
    reference's degenerate scalar form by default (it linearly indexes the
    cs×m_elite elite matrix with sample ranks up to K — column-major scalar
    gathers — so the update adds a scalar to every Σ entry, :588-598);
    cfg.cma_rank_mu_quirk=False switches to the textbook rank-μ outer-product
    update.
    """

    sigma0: float = 1.0
    m_elite: int = 10
    ws: np.ndarray = None  # (K,)
    mu_eff: float = 0.0
    c_sigma: float = 0.0
    d_sigma: float = 0.0
    c_Sigma: float = 0.0
    c1: float = 0.0
    c_mu: float = 0.0
    e_norm: float = 0.0

    @staticmethod
    def constants(num_samples: int, cs: int, elite_perc_threshold: float):
        m = num_samples
        n = cs
        m_elite = int(round((1.0 - elite_perc_threshold) * m))
        ws = np.log((m + 1) / 2.0) - np.log(np.arange(1, m + 1))
        ws[:m_elite] = ws[:m_elite] / np.sum(ws[:m_elite])
        mu_eff = 1.0 / np.sum(ws[:m_elite] ** 2)
        c_sigma = (mu_eff + 2.0) / (n + mu_eff + 5.0)
        d_sigma = (
            1.0
            + 2.0 * max(0.0, np.sqrt((mu_eff - 1.0) / (n + 1.0)) - 1.0)
            + c_sigma
        )
        c_Sigma = (4.0 + mu_eff / n) / (n + 4.0 + 2.0 * mu_eff / n)
        c1 = 2.0 / ((n + 1.3) ** 2 + mu_eff)
        c_mu = min(
            1.0 - c1, 2.0 * (mu_eff - 2.0 + 1.0 / mu_eff) / ((n + 2.0) ** 2 + mu_eff)
        )
        tail = ws[m_elite:]
        ws[m_elite:] = tail * (-(1.0 + c1 / c_mu) / np.sum(tail))
        e_norm = n**0.5 * (1.0 - 1.0 / (4.0 * n) + 1.0 / (21.0 * n**2))
        return dict(
            m_elite=m_elite,
            ws=ws,
            mu_eff=mu_eff,
            c_sigma=c_sigma,
            d_sigma=d_sigma,
            c_Sigma=c_Sigma,
            c1=c1,
            c_mu=c_mu,
            e_norm=e_norm,
        )

    def make_extra(self, sigma0_mat: jnp.ndarray):
        return dict(
            Sigma=sigma0_mat,
            sigma=jnp.asarray(self.sigma0, dtype=self.dtype),
            p_sigma=jnp.zeros((self.cs,), dtype=self.dtype),
            p_Sigma=jnp.zeros((self.cs,), dtype=self.dtype),
        )

    def init_chol(self, chol0: jnp.ndarray) -> jnp.ndarray:
        # samples from N(0, σ²Σ) when N > 1 (ref :550-554)
        if self.cfg.opt_its > 1:
            return self.sigma0 * chol0
        return chol0

    @property
    def can_stop(self) -> bool:
        return float(self.cfg.elite_stop_tol) > 0.0

    def update(self, carry, key, u_orig, it_index):
        cfg = self.cfg
        cs = self.cs
        ex = carry.extra
        sigma_s, Sigma = ex["sigma"], ex["Sigma"]
        ws = jnp.asarray(self.ws, dtype=self.dtype)

        order = jnp.argsort(carry.costs)
        elite_idx = order[: self.m_elite]
        elite_costs = carry.costs[elite_idx]
        stop = jnp.max(jnp.abs(jnp.diff(elite_costs))) < cfg.elite_stop_tol

        elite_e = carry.E[:, elite_idx]
        ds = elite_e / sigma_s  # δs (ref :572)
        dw = elite_e @ ws[: self.m_elite]  # δw (ref :573-576)
        u_new = carry.U + sigma_s * dw

        # C = Σ^{-1/2} via eigendecomposition (ref :580 uses Σ^-0.5).
        # The scalar rank-μ quirk (below) can leave Σ indefinite; a RELATIVE
        # eigenvalue floor keeps C bounded where an absolute 1e-30 floor
        # produced ~1e15 factors that overflow f32 downstream (the reference
        # runs f64, where the same math merely degrades). The floor never
        # binds for a well-conditioned Σ. cfg.cma_fast_sqrt computes C by
        # matmul-only Newton-Schulz with a runtime fallback to eigh when
        # the iteration hasn't converged.
        if cfg.cma_fast_sqrt:
            c_ns, ns_err = _inv_sqrt_newton_schulz(Sigma)
            c_mat = jax.lax.cond(
                jnp.isfinite(ns_err) & (ns_err < 1e-3),
                lambda: c_ns,
                lambda: _eigh_inv_sqrt(
                    Sigma, cfg.cma_stability_guards, self.dtype
                ),
            )
        else:
            c_mat = _eigh_inv_sqrt(Sigma, cfg.cma_stability_guards, self.dtype)

        p_sigma = (1.0 - self.c_sigma) * ex["p_sigma"] + jnp.sqrt(
            self.c_sigma * (2.0 - self.c_sigma) * self.mu_eff
        ) * (c_mat @ dw)
        norm_ps = jnp.sqrt(jnp.sum(p_sigma**2))
        # the step-size exponent and σ are unbounded in the reference
        # (:580-582); in f32 a degenerate Σ drives exp() to Inf and the
        # resulting NaN covariance breaks eigh. The guards never
        # bind in the stable regime; cfg.cma_stability_guards=False restores
        # raw reference semantics.
        step_exp = self.c_sigma / self.d_sigma * (norm_ps / self.e_norm - 1.0)
        if cfg.cma_stability_guards:
            step_exp = jnp.clip(step_exp, -20.0, 20.0)
        sigma_new = sigma_s * jnp.exp(step_exp)
        if cfg.cma_stability_guards:
            sigma_new = jnp.clip(sigma_new, 1e-10, 1e10)

        # hσ uses the 1-based iteration number (the reference's loop var n)
        it_f = it_index.astype(self.dtype)
        denom = jnp.sqrt(1.0 - (1.0 - self.c_sigma) ** (2.0 * it_f))
        h_sigma = (
            norm_ps / denom < (1.4 + 2.0 / (cs + 1.0)) * self.e_norm
        ).astype(self.dtype)
        p_Sigma = (1.0 - self.c_Sigma) * ex["p_Sigma"] + h_sigma * jnp.sqrt(
            self.c_Sigma * (2.0 - self.c_Sigma) * self.mu_eff
        ) * dw

        if cfg.cma_rank_mu_quirk:
            # Reference :588-598: δs[order[ii]] is a *scalar* (column-major
            # linear index into the cs×m_elite elite matrix with a sample
            # rank in 1..K), so the rank-μ term collapses to a scalar added
            # to every entry of Σ. Reproduced exactly; w0's `n` is the
            # iteration number.
            ds_flat = ds.T.reshape(-1)  # column-major flatten of (cs, m)
            svals = ds_flat[order]  # (K,) scalar gathers
            norm_c2 = jnp.sum(c_mat * c_mat)  # ‖C·s‖² = s²‖C‖_F²
            w0 = jnp.where(
                ws >= 0.0,
                ws,
                it_f * ws / jnp.maximum(norm_c2 * svals**2, 1e-30),
            )
            rank_mu = jnp.sum(w0 * svals**2)  # scalar
        else:
            # Textbook rank-μ: outer products of all K sorted normalized
            # steps, negative weights scaled by cs/‖C y‖².
            y = carry.E[:, order] / sigma_s  # (cs, K)
            cy = c_mat @ y
            ncy2 = jnp.sum(cy * cy, axis=0)
            w0 = jnp.where(ws >= 0.0, ws, cs * ws / jnp.maximum(ncy2, 1e-30))
            rank_mu = (y * w0[None, :]) @ y.T

        Sigma_new = (
            (1.0 - self.c1 - self.c_mu) * Sigma
            + self.c1
            * (
                jnp.outer(p_Sigma, p_Sigma)
                + (1.0 - h_sigma) * self.c_Sigma * (2.0 - self.c_Sigma) * Sigma
            )
            + self.c_mu * rank_mu
        )
        Sigma_new = jnp.triu(Sigma_new) + jnp.triu(Sigma_new, 1).T  # symmetry

        if cfg.opt_its > 1:
            chol_new = sigma_new * jnp.linalg.cholesky(
                _jittered(Sigma_new, cfg.cov_jitter)
            )
        else:
            chol_new = carry.chol
        new = carry.replace(
            U=u_new,
            chol=chol_new,
            extra=dict(
                Sigma=Sigma_new, sigma=sigma_new, p_sigma=p_sigma, p_Sigma=p_Sigma
            ),
        )
        return new, stop


@dataclasses.dataclass(frozen=True, eq=False)
class NESStrategy(Strategy):
    """Natural evolution strategies: analytic log-density gradients w.r.t.
    μ and A=√Σ, gradient descent with step_factor, early stop on flat costs.
    Ref: mppi_mpopi_policies.jl:853-893."""

    def make_extra(self, a0_mat: jnp.ndarray):
        return dict(A=a0_mat)

    @property
    def can_stop(self) -> bool:
        return float(self.cfg.elite_stop_tol) > 0.0

    def update(self, carry, key, u_orig, it_index):
        cfg = self.cfg
        k = self.num_samples
        # early stop on raw (unsorted) adjacent cost differences (ref :872)
        stop = jnp.max(jnp.abs(jnp.diff(carry.costs))) < cfg.elite_stop_tol

        a_mat = carry.extra["A"]
        eye = jnp.eye(self.cs, dtype=self.dtype)
        sigma_inv = jax.scipy.linalg.cho_solve((carry.chol, True), eye)
        e = carry.E
        c = carry.costs
        g_mu = sigma_inv @ (e @ c)  # Σ_k Σ⁻¹E_k c_k (ref :880)
        g = (e * c[None, :]) @ e.T  # Σ_k c_k E_k E_kᵀ
        m = 0.5 * (sigma_inv @ g @ sigma_inv) - 0.5 * jnp.sum(c) * sigma_inv
        grad_a = a_mat @ (m + m.T)  # ref :881-882 accumulated
        a_new = a_mat - (cfg.nes_step_factor / k) * grad_a / k  # double /K, ref :884
        sigma_new = a_new.T @ a_new
        u_new = carry.U - (cfg.nes_step_factor / k) * g_mu
        chol_new = jnp.linalg.cholesky(_jittered(sigma_new, cfg.cov_jitter))
        new = carry.replace(U=u_new, chol=chol_new, extra=dict(A=a_new))
        return new, stop


def make_strategy(cfg, cs: int, dtype) -> Strategy:
    """Build the strategy for cfg.kind (gmppi-family kinds only)."""
    k = cfg.num_samples
    base = dict(cfg=cfg, cs=cs, num_samples=k, dtype=dtype)
    kind = cfg.kind
    if kind == "gmppi":
        return Strategy(**base)
    if kind == "imppi":
        return MeanOnlyStrategy(**base, inner_lam=cfg.lam)
    if kind == "muaismppi":
        return MeanOnlyStrategy(**base, inner_lam=cfg.lambda_ais)
    if kind == "musigmaaismppi":
        return MeanCovStrategy(**base, inner_lam=cfg.lambda_ais)
    if kind == "pmcmppi":
        return PMCStrategy(**base, inner_lam=cfg.lambda_ais)
    if kind == "cemppi":
        m_elite = int(round(k * (1.0 - cfg.ce_elite_threshold)))
        return CrossEntropyStrategy(**base, m_elite=max(m_elite, 2))
    if kind == "cmamppi":
        consts = CMAStrategy.constants(k, cs, cfg.cma_elite_threshold)
        return CMAStrategy(**base, sigma0=cfg.cma_sigma, **consts)
    if kind == "nesmppi":
        return NESStrategy(**base)
    raise ValueError(f"no AIS strategy for kind {kind!r}")
