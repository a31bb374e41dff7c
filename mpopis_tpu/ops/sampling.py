"""Gaussian control-noise sampling and multinomial resampling.

Reference semantics: `rand(rng, MvNormal(Σ), K)` draws throughout
mppi_mpopi_policies.jl (e.g. :154-156, :447-448) and the PMC categorical
resampling at :803-806. The reference's MersenneTwister stream cannot (and
should not) be reproduced on the device; we use JAX's counter-based
threefry keys.
Parity vs the Julia reference is defined at matched sampling *moments*
(BASELINE.json), and `mvnormal_samples` accepts externally injected standard
normals (`z`) so exact-match debugging against any RNG is possible.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def cholesky_psd(sigma: jnp.ndarray, jitter: float = 0.0) -> jnp.ndarray:
    """Lower Cholesky factor with optional diagonal jitter."""
    d = sigma.shape[0]
    if jitter:
        sigma = sigma + jitter * jnp.eye(d, dtype=sigma.dtype)
    return jnp.linalg.cholesky(sigma)


def mvnormal_samples(
    key: jax.Array,
    chol: jnp.ndarray,
    num_samples: int,
    z: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Draw (d, K) samples from N(0, L Lᵀ) as E = L @ Z.

    `z` (d, K) standard normals can be injected for cross-implementation
    exact-match testing; otherwise drawn from `key`.
    """
    d = chol.shape[0]
    if z is None:
        z = jax.random.normal(key, (d, num_samples), dtype=chol.dtype)
    return chol @ z


def multinomial_resample_indices(
    key: jax.Array, weights: jnp.ndarray, num_draws: int
) -> jnp.ndarray:
    """K iid draws from Categorical(weights) via inverse-CDF.

    Ref: mppi_mpopi_policies.jl:803-806 (PMC). Static shapes; O(K log K) via
    searchsorted on the weight CDF — no host round-trip.
    """
    cdf = jnp.cumsum(weights)
    cdf = cdf / cdf[-1]
    u = jax.random.uniform(key, (num_draws,), dtype=weights.dtype)
    # method="sort" (concatenate + argsort) instead of the default
    # binary-search scan; which is faster on the GPU is not measured yet
    return jnp.searchsorted(cdf, u, side="left", method="sort").astype(jnp.int32)


def multinomial_resample_counts(
    key: jax.Array, weights: jnp.ndarray, num_draws: int
) -> jnp.ndarray:
    """Draw counts per category for `num_draws` iid Categorical(weights)
    draws — the same multiset as `multinomial_resample_indices` on the same
    key (bitwise: identical uniforms, identical bucketing), but computed as
    a fused (K, K) compare-reduce instead of searchsorted + scatter-add.
    Use when only multiset statistics (moments)
    of the resampled set are needed, not the draw order.
    """
    cdf = jnp.cumsum(weights)
    cdf = cdf / cdf[-1]
    u = jax.random.uniform(key, (num_draws,), dtype=weights.dtype)
    # p_k = #{u_i <= cdf_k}; counts_k = p_k - p_{k-1} reproduces
    # searchsorted(side="left") bucketing exactly. The (K, draws) compare is
    # tiled over 4096-draw blocks to bound the intermediate at K·4096 bools
    # (a full K=32768 PMC step would otherwise materialize ~1-4 GB); block
    # sums are exact integer-valued floats, so the result is bitwise
    # identical to the untiled compare-reduce.
    tile = 4096
    if num_draws <= tile:
        p = jnp.sum(u[None, :] <= cdf[:, None], axis=1, dtype=weights.dtype)
    else:
        pad = (-num_draws) % tile
        u_t = jnp.pad(u, (0, pad), constant_values=jnp.inf).reshape(-1, tile)

        def body(acc, ublk):
            return acc + jnp.sum(
                ublk[None, :] <= cdf[:, None], axis=1, dtype=weights.dtype
            ), None

        p, _ = jax.lax.scan(body, jnp.zeros_like(cdf), u_t)
    return jnp.diff(p, prepend=jnp.zeros((1,), dtype=weights.dtype))
