"""Policy configuration and state.

Mirrors the reference's kwargs surface (MPPI_Policy_Params ctor,
mppi_mpopi_policies.jl:36-102, plus per-family ctor kwargs) as a single
hashable config. Array-valued inputs (U₀ tile, covariance) are passed to the
policy builder separately since they are data, not config.

Persistent policy state is just (U, key): the reference restores pol.U to
U_orig after every AIS loop and never writes the adapted Σ back to the policy
(e.g. :468-469), so across control steps only the receding-horizon mean and
the RNG stream evolve. That makes checkpoint/resume trivial (it's a pytree).
"""

from __future__ import annotations

import dataclasses

import jax

from mpopis_tpu.models.base import pytree_dataclass

POLICY_KINDS = (
    "mppi",
    "gmppi",
    "imppi",
    "cemppi",
    "cmamppi",
    "muaismppi",
    "musigmaaismppi",
    "pmcmppi",
    "nesmppi",
)

# Aliases accepting the reference's unicode symbols.
KIND_ALIASES = {
    "μaismppi": "muaismppi",
    "μσaismppi": "musigmaaismppi",
    "μΣaismppi": "musigmaaismppi",
    "cem": "cemppi",
    "cma": "cmamppi",
}


def canonical_kind(kind: str) -> str:
    k = str(kind).lstrip(":").lower()
    k = KIND_ALIASES.get(k, k)
    if k not in POLICY_KINDS:
        raise ValueError(f"unknown policy kind {kind!r}; options {POLICY_KINDS}")
    return k


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Static policy hyperparameters (hashable; safe as a jit static arg)."""

    kind: str = "cemppi"
    num_samples: int = 50  # K
    horizon: int = 50  # T
    lam: float = 1.0  # λ, IT inverse temperature
    alpha: float = 1.0  # α, control-cost parameter (γ = λ(1-α))
    opt_its: int = 10  # N, AIS iterations
    lambda_ais: float = 20.0  # decoupled AIS inverse temperature
    ce_elite_threshold: float = 0.8
    sigma_est: str = "mle"  # :mle,:lw,:ss,:rblw,:oas
    cma_sigma: float = 1.0
    cma_elite_threshold: float = 0.8
    nes_step_factor: float = 0.01
    log: bool = False  # capture K trajectories/costs/weights per step
    use_fused_rollout: bool = True  # Pallas kernel where the env's seam allows

    # Reference-quirk reproduction flags (see SURVEY.md §2.1): defaults keep
    # bit-level semantic parity with MPOPIS.
    shift_quirk: bool = True  # utils.jl:96 off-by-one tail refill
    cma_rank_mu_quirk: bool = True  # scalar rank-μ term, policies:588-598
    elite_stop_tol: float = 1e-2  # reference literal 10e-3
    cov_jitter: float = 1e-8  # reference literal 10e-9
    # f32 stability guards for CMA's Σ^{-1/2}/step-size chain (relative
    # eigenvalue floor, clipped step-size exponent and σ). The guards never
    # bind in the stable regime; set False for raw reference semantics
    # (safe in f64, can overflow to NaN in f32 with cma_rank_mu_quirk).
    cma_stability_guards: bool = True
    # Compute CMA's C = Σ^{-1/2} by a matmul-only Newton-Schulz iteration
    # with a runtime lax.cond fallback to eigh when the
    # iteration has not converged (ill-conditioned or indefinite Σ).
    # Default False: parity semantics keep the eigendecomposition.
    cma_fast_sqrt: bool = False

    def __post_init__(self):
        object.__setattr__(self, "kind", canonical_kind(self.kind))

    @property
    def gamma(self) -> float:
        return self.lam * (1.0 - self.alpha)


@pytree_dataclass
class PolicyState:
    """Carried across control steps: receding-horizon mean + RNG key."""

    U: jax.Array  # (cs,) flat nominal control sequence
    key: jax.Array


def init_policy_state(u0_flat, seed_or_key) -> PolicyState:
    import jax.numpy as jnp

    if isinstance(seed_or_key, int):
        key = jax.random.PRNGKey(seed_or_key)
    else:
        key = seed_or_key
    return PolicyState(U=jnp.asarray(u0_flat), key=key)
