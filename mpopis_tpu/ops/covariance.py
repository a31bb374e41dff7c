"""Covariance estimation: weighted moments and linear-shrinkage estimators.

Reference semantics:
- Weighted mean/cov moment matching: `StatsBase.mean_and_cov(E, pw, 2)` at
  MPOPIS mppi_mpopi_policies.jl:364,662,732 (ProbabilityWeights, uncorrected:
  cov = Σ_k w_k (x_k-μ)(x_k-μ)ᵀ with Σw=1) and the unweighted corrected
  variant at :807 (divide by K-1).
- Shrinkage estimators: the CEMPPI Σ-refit (mppi_mpopi_policies.jl:407-426,
  :464) delegates to CovarianceEstimation.jl's SimpleCovariance (:mle) and
  LinearShrinkage estimators (:lw, :ss on a diagonal-unequal-variance target;
  :rblw, :oas on a diagonal-common-variance target). Those are reimplemented
  here from the published formulas — Ledoit & Wolf 2004 ("Honey, I shrunk the
  sample covariance matrix"), Schäfer & Strimmer 2005 (Target D), and Chen,
  Wiesel, Eldar & Hero 2009 (arXiv:0907.4698, RBLW/OAS) — not translated from
  the Julia package.

Data convention: X has shape (n, p) = (samples, dims), matching the
reference's `cov(method, elite')` call where elite' is (m_elite × cs).
All estimators are pure jnp and jit-safe (static shapes only).
"""

from __future__ import annotations

import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Weighted / unweighted moments
# ---------------------------------------------------------------------------

def weighted_mean_and_cov(e: jnp.ndarray, w: jnp.ndarray):
    """Probability-weighted mean and covariance of column samples.

    `e` is (d, K) — K samples of dimension d (the reference's E matrix);
    `w` is (K,) with Σw = 1. Returns (μ (d,), Σ (d,d)) with the uncorrected
    StatsBase convention Σ = Σ_k w_k (x_k-μ)(x_k-μ)ᵀ.

    The covariance is a single (d,K)x(K,d) matmul, and the
    form that psum-composes across a sharded K axis.
    """
    mu = e @ w
    xc = e - mu[:, None]
    cov = (xc * w[None, :]) @ xc.T
    return mu, cov


def mean_and_cov(e: jnp.ndarray, corrected: bool = True):
    """Unweighted mean/cov of column samples (d, K); corrected ⇒ /(K-1).

    Matches StatsBase.mean_and_cov(E′, 2) used by the PMC resampling update
    (mppi_mpopi_policies.jl:807).
    """
    k = e.shape[1]
    mu = jnp.mean(e, axis=1)
    xc = e - mu[:, None]
    denom = (k - 1) if corrected else k
    return mu, (xc @ xc.T) / denom


# ---------------------------------------------------------------------------
# Shrinkage estimators (X is (n, p), rows are samples)
# ---------------------------------------------------------------------------

def sample_cov(x: jnp.ndarray, corrected: bool = False) -> jnp.ndarray:
    """MLE sample covariance (divide by n; `corrected` divides by n-1).

    CovarianceEstimation.jl's SimpleCovariance() default is uncorrected,
    which is what the reference's :mle option uses.
    """
    n = x.shape[0]
    xc = x - jnp.mean(x, axis=0, keepdims=True)
    denom = (n - 1) if corrected else n
    return (xc.T @ xc) / denom


def _offdiag_sum_sq(m: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(m * m) - jnp.sum(jnp.diag(m) ** 2)


def lw_shrinkage_cov(x: jnp.ndarray) -> jnp.ndarray:
    """Ledoit-Wolf linear shrinkage toward the diagonal-unequal-variance
    target F = diag(S).

    Intensity λ = Σ_{i≠j} Var̂(S_ij) / Σ_{i≠j} S_ij² with
    Var̂(S_ij) = (1/n²) Σ_k (x_ki x_kj − S_ij)² (plug-in variance of the
    covariance entries, Ledoit & Wolf 2004). Diagonal is preserved exactly
    since the target matches it there.
    """
    xc = x - jnp.mean(x, axis=0, keepdims=True)
    return _lw_from_centered(xc, x.shape[0])


def _lw_from_centered(xc: jnp.ndarray, n: int) -> jnp.ndarray:
    s = (xc.T @ xc) / n
    # Var̂(S_ij): second moment of products minus S_ij², over n.
    prod_sq = ((xc * xc).T @ (xc * xc)) / n  # E[(x_i x_j)^2]
    var_s = (prod_sq - s * s) / n
    num = _offdiag_sum(var_s)
    den = _offdiag_sum_sq(s)
    lam = jnp.clip(num / jnp.maximum(den, jnp.finfo(s.dtype).tiny), 0.0, 1.0)
    f = jnp.diag(jnp.diag(s))
    return (1.0 - lam) * s + lam * f


def _offdiag_sum(m: jnp.ndarray) -> jnp.ndarray:
    """Sum of off-diagonal entries (not squared) — helper for variance sums."""
    return jnp.sum(m) - jnp.sum(jnp.diag(m))


def ss_shrinkage_cov(x: jnp.ndarray) -> jnp.ndarray:
    """Schäfer-Strimmer (2005) Target-D shrinkage: shrink off-diagonal
    correlations toward zero, keep sample variances.

    λ = Σ_{i≠j} Var̂(r_ij) / Σ_{i≠j} r_ij², with the paper's unbiased
    small-sample constants: on standardized data,
    Var̂(r_ij) = n/(n-1)³ Σ_k (w_kij - w̄_ij)², r_ij = n/(n-1) w̄_ij.
    """
    xc = x - jnp.mean(x, axis=0, keepdims=True)
    return _ss_from_centered(xc, x.shape[0])


def _ss_from_centered(xc: jnp.ndarray, n: int) -> jnp.ndarray:
    p = xc.shape[1]
    v = jnp.sum(xc * xc, axis=0) / (n - 1)  # unbiased variances
    sd = jnp.sqrt(jnp.maximum(v, jnp.finfo(xc.dtype).tiny))
    xs = xc / sd[None, :]
    wbar = (xs.T @ xs) / n  # mean of w_kij
    r = (n / (n - 1)) * wbar
    # Σ_k (w_kij - w̄)² = Σ_k w² - n w̄²
    sum_w2 = (xs * xs).T @ (xs * xs)
    var_r = (n / (n - 1) ** 3) * (sum_w2 - n * wbar * wbar)
    num = _offdiag_sum(var_r)
    den = _offdiag_sum_sq(r)
    lam = jnp.clip(num / jnp.maximum(den, jnp.finfo(xc.dtype).tiny), 0.0, 1.0)
    r_shrunk = (1.0 - lam) * r
    # restore diagonal to 1 and rescale to covariances; variances use the
    # uncorrected MLE scale to stay consistent with the other estimators.
    r_shrunk = r_shrunk - jnp.diag(jnp.diag(r_shrunk)) + jnp.eye(p, dtype=xc.dtype)
    v_mle = jnp.sum(xc * xc, axis=0) / n
    sd_mle = jnp.sqrt(jnp.maximum(v_mle, jnp.finfo(xc.dtype).tiny))
    return r_shrunk * sd_mle[:, None] * sd_mle[None, :]


def _common_variance_shrink(x: jnp.ndarray, rho_fn) -> jnp.ndarray:
    xc = x - jnp.mean(x, axis=0, keepdims=True)
    return _common_variance_from_centered(xc, x.shape[0], rho_fn)


def _common_variance_from_centered(xc: jnp.ndarray, n: int, rho_fn) -> jnp.ndarray:
    p = xc.shape[1]
    s = (xc.T @ xc) / n
    tr_s = jnp.trace(s)
    tr_s2 = jnp.sum(s * s)  # tr(S²) for symmetric S
    f = (tr_s / p) * jnp.eye(p, dtype=xc.dtype)
    rho = jnp.clip(rho_fn(n, p, tr_s, tr_s2), 0.0, 1.0)
    return (1.0 - rho) * s + rho * f


def _rho_rblw(n, p, tr_s, tr_s2):
    num = ((n - 2.0) / n) * tr_s2 + tr_s**2
    den = (n + 2.0) * (tr_s2 - tr_s**2 / p)
    return num / jnp.maximum(den, jnp.finfo(tr_s.dtype).tiny)


def _rho_oas(n, p, tr_s, tr_s2):
    num = (1.0 - 2.0 / p) * tr_s2 + tr_s**2
    den = (n + 1.0 - 2.0 / p) * (tr_s2 - tr_s**2 / p)
    return num / jnp.maximum(den, jnp.finfo(tr_s.dtype).tiny)


def rblw_shrinkage_cov(x: jnp.ndarray) -> jnp.ndarray:
    """Rao-Blackwellized Ledoit-Wolf (Chen et al. 2009, eq. 17),
    diagonal-common-variance target tr(S)/p · I."""
    return _common_variance_shrink(x, _rho_rblw)


def oas_shrinkage_cov(x: jnp.ndarray) -> jnp.ndarray:
    """Oracle-Approximating Shrinkage (Chen et al. 2009, eq. 23)."""
    return _common_variance_shrink(x, _rho_oas)


_ESTIMATORS = {
    "mle": lambda x: sample_cov(x, corrected=False),
    "lw": lw_shrinkage_cov,
    "ss": ss_shrinkage_cov,
    "rblw": rblw_shrinkage_cov,
    "oas": oas_shrinkage_cov,
}


def shrinkage_cov(x: jnp.ndarray, method: str = "mle") -> jnp.ndarray:
    """Dispatch on the reference's Σ_est symbols (:mle,:lw,:ss,:rblw,:oas)."""
    try:
        return _ESTIMATORS[method](x)
    except KeyError:
        raise ValueError(
            f"unknown Σ estimation method {method!r}; options: {sorted(_ESTIMATORS)}"
        ) from None


_MASKED_ESTIMATORS = {
    "mle": lambda xc, n: (xc.T @ xc) / n,
    "lw": _lw_from_centered,
    "ss": _ss_from_centered,
    "rblw": lambda xc, n: _common_variance_from_centered(xc, n, _rho_rblw),
    "oas": lambda xc, n: _common_variance_from_centered(xc, n, _rho_oas),
}


def shrinkage_cov_masked(
    e: jnp.ndarray, mask: jnp.ndarray, m: int, method: str = "mle"
) -> jnp.ndarray:
    """shrinkage_cov over the masked COLUMNS of e (d, K) without the
    gather: `mask` (K,) selects exactly `m` columns (0/1 in e's dtype).

    Algebraically identical to shrinkage_cov(e[:, idx].T, method) — the
    masked columns are centered then zeroed, so every sample sum in the
    estimators (all matmuls/elementwise-square matmuls over the sample
    axis) picks up only the selected columns. Keeps the elite refit
    K-dense and matmul-shaped instead of paying a (d, m) gather per AIS
    iteration.
    """
    try:
        est = _MASKED_ESTIMATORS[method]
    except KeyError:
        raise ValueError(
            f"unknown Σ estimation method {method!r}; options: "
            f"{sorted(_MASKED_ESTIMATORS)}"
        ) from None
    mu = (e @ mask) / m
    xc = ((e - mu[:, None]) * mask[None, :]).T  # (K, d), zeros off-mask
    return est(xc, m)
