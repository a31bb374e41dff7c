"""Policy step builders.

`make_policy(env, cfg, ...)` compiles one device-resident program per control
step: the full sample→rollout→reweight→moment-update AIS loop runs as a
`lax.scan` over iterations, each iteration rolling all K candidate control
sequences with vmap+scan (and, on a mesh, sharded over the sample axis).
This replaces the reference's per-policy-functor object protocol
(mppi_mpopi_policies.jl:121-146, :221-238) and its host-side AIS loops.

Early stopping (the reference's `break` at e.g. :459-461) is implemented as
a `lax.while_loop` with a dynamic trip count for stop-capable strategies:
once the stop flag is set the loop exits, freezing the carry — including
that iteration's samples and costs, which the reference returns — exactly
like the reference's host-loop break, at zero cost to non-stopping
iterations. Strategies that can never stop compile a static `lax.scan`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from mpopis_tpu.models.base import Env, EnvState, make_state
from mpopis_tpu.models.rollout import rollout_batch
from mpopis_tpu.ops.controls import roll_controls
from mpopis_tpu.ops.weights import information_theoretic_weights
from mpopis_tpu.policies.config import PolicyConfig, PolicyState, init_policy_state
from mpopis_tpu.policies.strategies import AISCarry, CMAStrategy, NESStrategy, make_strategy


# Precision of every f32 matrix product in the policy step: the sampling
# product chol·z, the weighted refits E·diag(w)·Eᵀ and the final weighted
# sum. At "default", XLA on a GPU may run f32 products in TF32 (about
# three decimal digits); on an H100 that moved U by up to 4e-3 against the
# CPU step. These products are small next to the rollout (one
# (cs, cs)·(cs, K) product per AIS iteration).
MATMUL_PRECISION = "highest"


def tree_select(pred, on_true, on_false):
    return jax.tree.map(lambda a, b: jnp.where(pred, a, b), on_true, on_false)


def _fused_rollout(env, sample_sharding, k_samples: int):
    """The env's fused rollout kernel as `f(x0, controls_tak) -> (K,)`
    costs, for (T, as, K) clamped controls. Under explicit sample sharding
    the kernel runs on each device's local K-shard inside shard_map (a
    pallas_call cannot be auto-partitioned by GSPMD); the initial env state
    is replicated and the costs come back sharded over K. Returns None when
    K does not divide over the mesh (the caller then takes the GSPMD vmap
    rollout).
    """
    def local(x, controls_tak):
        return env.fused_rollout_costs(make_state(x), controls_tak)

    if sample_sharding is None:
        return local

    import jax.sharding as shd

    mesh = sample_sharding.mesh
    axis = sample_sharding.spec[0]
    n_shards = mesh.shape[axis]
    if k_samples % n_shards != 0:
        import warnings

        warnings.warn(
            f"num_samples={k_samples} not divisible by the {n_shards}-device "
            f"sample mesh; the fused rollout kernel needs even shards — "
            f"using the GSPMD vmap rollout",
            stacklevel=3,
        )
        return None
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(shd.PartitionSpec(), shd.PartitionSpec(None, None, axis)),
        out_specs=shd.PartitionSpec(axis),
        # pallas_call does not carry varying-mesh-axes metadata
        check_vma=False,
    )


def _use_fused(env, cfg) -> bool:
    """Fused kernel when the env's backend seam allows it and nothing needs
    the generic path (trajectory logging needs per-step states)."""
    return cfg.use_fused_rollout and not cfg.log and env.supports_fused_rollout


def _principal_sqrtm(sigma: np.ndarray) -> np.ndarray:
    """Principal matrix square root via eigendecomposition (Julia's sqrt(Σ)
    for symmetric PSD matrices, used by NES at mppi_mpopi_policies.jl:848)."""
    w, v = np.linalg.eigh(sigma)
    w = np.maximum(w, 0.0)
    return (v * np.sqrt(w)[None, :]) @ v.T


def _prepare_u0(u0, action_dim: int, cs: int) -> np.ndarray:
    if u0 is None:
        return np.zeros(cs)
    u0 = np.asarray(u0, dtype=float).reshape(-1)
    if u0.shape[0] == action_dim:
        return np.tile(u0, cs // action_dim)
    if u0.shape[0] == cs:
        return u0
    raise ValueError(
        f"U0 must have length action_dim ({action_dim}) or cs ({cs}), got {u0.shape[0]}"
    )


def _prepare_cov(cov, action_dim: int) -> np.ndarray:
    """Normalize covariance input to an (as, as) block (ref ctor :76-81)."""
    if cov is None:
        return np.eye(action_dim)
    cov = np.asarray(cov, dtype=float)
    if cov.ndim == 1:
        cov = np.diag(cov)
    return cov


def _block_diag_np(a: np.ndarray, reps: int) -> np.ndarray:
    d = a.shape[0]
    out = np.zeros((d * reps, d * reps))
    for i in range(reps):
        out[i * d : (i + 1) * d, i * d : (i + 1) * d] = a
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class Policy:
    """Compiled policy: a pure step function plus its construction data."""

    env: Env
    cfg: PolicyConfig
    u0_flat: np.ndarray  # (cs,)
    sigma: np.ndarray  # (cs,cs) for gmppi family, (as,as) for mppi
    step: Callable[[EnvState, PolicyState], tuple]
    """step(env_state, pol_state) -> (action (as,), new_pol_state, info)"""

    def init_state(self, seed_or_key) -> PolicyState:
        return init_policy_state(
            jnp.asarray(self.u0_flat, dtype=self.env.dtype), seed_or_key
        )


def make_policy(
    env: Env,
    cfg: PolicyConfig,
    u0=None,
    cov_mat=None,
    sample_sharding=None,
    jit: bool = True,
) -> Policy:
    """Build a compiled policy step for `cfg.kind` on `env`.

    `cov_mat` may be an (as,) variance vector, an (as,as) per-step block
    (expanded block-diagonally over the horizon for the GMPPI family,
    ref :76-78), or a full (cs,cs) joint covariance.
    `sample_sharding` is an optional jax.sharding.NamedSharding whose first
    axis shards the K candidate rollouts across a device mesh.
    """
    action_dim = env.action_dim
    cs = action_dim * cfg.horizon
    u0_flat = _prepare_u0(u0, action_dim, cs)
    cov_block = _prepare_cov(cov_mat, action_dim)

    if cfg.kind == "mppi":
        if cov_block.shape[0] != action_dim:
            raise ValueError("mppi expects an (as, as) covariance")
        sigma = cov_block
    else:
        if cov_block.shape[0] == action_dim:
            sigma = _block_diag_np(cov_block, cfg.horizon)
        elif cov_block.shape[0] == cs:
            sigma = cov_block
        else:
            raise ValueError("covariance must be (as,as)-block or (cs,cs)")

    if cfg.kind == "mppi":
        inner = _make_mppi_step(env, cfg, u0_flat, sigma, sample_sharding)
    else:
        inner = _make_gmppi_step(env, cfg, u0_flat, sigma, sample_sharding)
    precision = MATMUL_PRECISION

    def step(env_state, pol_state, z=None):
        with jax.default_matmul_precision(precision):
            return inner(env_state, pol_state, z)

    if jit:
        step = jax.jit(step)
    return Policy(env=env, cfg=cfg, u0_flat=u0_flat, sigma=sigma, step=step)


# ---------------------------------------------------------------------------
# GMPPI family (joint cs-dim Gaussian + AIS strategies)
# ---------------------------------------------------------------------------

def _make_gmppi_step(env, cfg, u0_flat, sigma0, sample_sharding):
    dtype = env.dtype
    action_dim = env.action_dim
    k_samples = cfg.num_samples
    horizon = cfg.horizon
    cs = action_dim * horizon
    gamma = cfg.gamma
    low, high = env.control_bounds
    u0_j = jnp.asarray(u0_flat, dtype=dtype)
    sigma0_j = jnp.asarray(sigma0, dtype=dtype)

    strategy = make_strategy(cfg, cs, dtype)
    if isinstance(strategy, NESStrategy):
        extra0 = strategy.make_extra(
            jnp.asarray(_principal_sqrtm(sigma0), dtype=dtype)
        )
    elif isinstance(strategy, CMAStrategy):
        extra0 = strategy.make_extra(sigma0_j)
    else:
        extra0 = None

    def constrain(x):
        if sample_sharding is not None:
            return jax.lax.with_sharding_constraint(x, sample_sharding)
        return x

    fused = (
        _fused_rollout(env, sample_sharding, k_samples)
        if _use_fused(env, cfg)
        else None
    )

    def compute_costs(env_state, u_cur, e, chol, u_orig, z_n):
        v = u_cur[:, None] + e  # (cs, K), unclamped candidates
        if fused is not None:
            # clamp in flat layout; (cs,K) -> (T,na,K) is a free reshape, so
            # the kernel's native layout is reached with zero transposes
            low_f = jnp.tile(low, horizon)[:, None]
            high_f = jnp.tile(high, horizon)[:, None]
            vc = jnp.clip(v, low_f, high_f).reshape(horizon, action_dim, k_samples)
            base, trajs = fused(env_state.x, vc), None
        else:
            controls = v.T.reshape(k_samples, horizon, action_dim)
            controls = constrain(jnp.clip(controls, low, high))
            base, trajs = rollout_batch(env, env_state, controls, cfg.log)
        if gamma != 0.0:
            # γ·U_origᵀ Σ⁻¹ (V_k − U_orig) with the *current* sampling Σ
            # (ref :249, :272; Σ_inv = invcov of this iteration's P).
            # With V − U_orig = d + L·z (d = U_cur − U_orig, e = L·z) and
            # y₀ = L⁻¹U_orig, the term is γ·(y₁ᵀy₀ + zᵀy₀), y₁ = L⁻¹d —
            # two forward substitutions instead of a full cho_solve, and
            # the per-sample part is one matvec.
            ys = jax.scipy.linalg.solve_triangular(
                chol, jnp.stack([u_orig, u_cur - u_orig]).T, lower=True
            ).T
            base = base + gamma * (jnp.dot(ys[1], ys[0]) + z_n.T @ ys[0])
        return base, trajs

    chol0 = jnp.linalg.cholesky(sigma0_j)
    n_its = cfg.opt_its if cfg.kind not in ("gmppi",) else 1

    def policy_step(env_state: EnvState, pol_state: PolicyState, z=None):
        """z: optional (opt_its, cs, K) standard normals overriding the
        policy RNG — the exact-match debugging harness for cross-
        implementation comparison (SURVEY.md §7: parity vs the Julia
        reference is defined at matched sampling moments; with injected
        normals it becomes exact)."""
        u_orig = pol_state.U
        key_next, k_loop = jax.random.split(pol_state.key)

        carry0 = AISCarry(
            U=u_orig,
            chol=strategy.init_chol(chol0),
            E=jnp.zeros((cs, k_samples), dtype=dtype),
            costs=jnp.zeros((k_samples,), dtype=dtype),
            trajs=(
                jnp.zeros((k_samples, horizon, env.state_dim), dtype=dtype)
                if cfg.log
                else None
            ),
            done=jnp.asarray(False),
            key=k_loop,
            extra=extra0,
        )

        def live(carry, n, k_samp, k_strat):
            """One full AIS iteration: sample → rollout → update."""
            if z is None:
                z_n = jax.random.normal(
                    k_samp, (cs, k_samples), dtype=dtype
                )
            else:
                z_n = z[n]
            e = carry.chol @ z_n
            costs, trajs = compute_costs(
                env_state, carry.U, e, carry.chol, u_orig, z_n
            )
            base = carry.replace(E=e, costs=costs, trajs=trajs)
            new, stop = strategy.update(base, k_strat, u_orig, n + 1)
            is_last = n == n_its - 1
            cand = tree_select(stop | is_last, base, new)
            return cand.replace(done=stop)

        # Early stop EXITS the loop, like the reference's host-loop
        # `break` (mppi_mpopi_policies.jl:459-461): stop-capable
        # strategies run a lax.while_loop with a dynamic trip count, so
        # live iterations carry no per-iteration branch and iterations
        # after convergence never execute at all. Outputs are identical to the masked/cond
        # forms: the carry freezes at the stopping iteration, and the
        # RNG for the final weights (key_next) was split BEFORE the
        # loop, so key streams are unchanged. Non-stop-capable
        # strategies keep the static-trip-count scan.
        if strategy.can_stop:
            def while_cond(state):
                n, carry = state
                return (n < n_its) & ~carry.done

            def while_body(state):
                n, carry = state
                key, k_samp, k_strat = jax.random.split(carry.key, 3)
                out = live(carry, n, k_samp, k_strat)
                return n + 1, out.replace(key=key)

            _, final = jax.lax.while_loop(
                while_cond, while_body, (jnp.int32(0), carry0)
            )
        else:
            def body(carry, n):
                key, k_samp, k_strat = jax.random.split(carry.key, 3)
                out = live(carry, n, k_samp, k_strat)
                return out.replace(key=key), None

            final, _ = jax.lax.scan(body, carry0, jnp.arange(n_its))

        # Translate noise so it is relative to the original mean, restore U
        # (ref :468-469 et al.), then apply the final softmax-weighted update.
        e_final = final.E + (final.U - u_orig)[:, None]
        weights = information_theoretic_weights(final.costs, cfg.lam)
        weighted_controls = u_orig + e_final @ weights
        action = jnp.clip(weighted_controls[:action_dim], low, high)
        u_next = roll_controls(
            weighted_controls, u0_j, action_dim, cfg.shift_quirk
        )
        info = {"costs": final.costs, "weights": weights}
        if cfg.log:
            info["trajectories"] = final.trajs
        return action, PolicyState(U=u_next, key=key_next), info

    return policy_step


# ---------------------------------------------------------------------------
# Classic MPPI (per-timestep as-dim Gaussian)
# ---------------------------------------------------------------------------

def _make_mppi_step(env, cfg, u0_flat, sigma_as, sample_sharding):
    dtype = env.dtype
    action_dim = env.action_dim
    k_samples = cfg.num_samples
    horizon = cfg.horizon
    cs = action_dim * horizon
    gamma = cfg.gamma
    low, high = env.control_bounds
    u0_j = jnp.asarray(u0_flat, dtype=dtype)
    sigma_j = jnp.asarray(sigma_as, dtype=dtype)
    chol_as = jnp.linalg.cholesky(sigma_j)
    sigma_inv = jnp.linalg.inv(sigma_j)

    def constrain(x):
        if sample_sharding is not None:
            return jax.lax.with_sharding_constraint(x, sample_sharding)
        return x

    fused = (
        _fused_rollout(env, sample_sharding, k_samples)
        if _use_fused(env, cfg)
        else None
    )

    def policy_step(env_state: EnvState, pol_state: PolicyState, z=None):
        """z: optional (K, T, as) standard normals overriding the policy RNG
        (exact-match debugging harness)."""
        key_next, k_samp = jax.random.split(pol_state.key)
        if z is None:
            z = jax.random.normal(
                k_samp, (k_samples, horizon, action_dim), dtype=dtype
            )
        e = z @ chol_as.T  # E[k,t] ~ N(0, Σ_as) (ref :154-156)
        u_mat = pol_state.U.reshape(horizon, action_dim)
        controls = constrain(jnp.clip(u_mat[None, :, :] + e, low, high))
        if fused is not None:
            ctrl_tak = jnp.transpose(controls, (1, 2, 0))
            base, trajs = fused(env_state.x, ctrl_tak), None
        else:
            base, trajs = rollout_batch(env, env_state, controls, cfg.log)
        costs = base
        if gamma != 0.0:
            # γ·uₜᵀ Σ⁻¹ εₖₜ summed over t (ref :167, :204)
            costs = costs + gamma * jnp.einsum(
                "ta,ab,ktb->k", u_mat, sigma_inv, e
            )
        weights = information_theoretic_weights(costs, cfg.lam)
        weighted_noise = jnp.einsum("k,kta->ta", weights, e).reshape(cs)
        weighted_controls = pol_state.U + weighted_noise
        action = jnp.clip(weighted_controls[:action_dim], low, high)
        u_next = roll_controls(
            weighted_controls, u0_j, action_dim, cfg.shift_quirk
        )
        info = {"costs": costs, "weights": weights}
        if cfg.log:
            info["trajectories"] = trajs
        return action, PolicyState(U=u_next, key=key_next), info

    return policy_step
