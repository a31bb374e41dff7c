"""mpopis_tpu — a Model Predictive Optimized Path Integral (MPPI/MPOPI)
control engine built on JAX/XLA/Pallas.

Capability parity target: sisl/MPOPIS (Julia). Architecture: pure-functional
environments over explicit state values, policies compiled as single
device-resident programs (vmap over the K sample axis, lax.scan over the
horizon and the AIS iterations), sample-axis sharding over device meshes
with psum/all-gather collectives, and Pallas kernels for the hot rollout
loops.
"""

from mpopis_tpu import models, ops, policies
from mpopis_tpu.models import (
    CarParams,
    CarRacingEnv,
    CartPoleEnv,
    Env,
    EnvState,
    MountainCarEnv,
    MultiCarRacingEnv,
    Track,
)
from mpopis_tpu.policies import Policy, PolicyConfig, PolicyState, make_policy

__version__ = "0.1.0"

__all__ = [
    "models",
    "ops",
    "policies",
    "CarParams",
    "CarRacingEnv",
    "CartPoleEnv",
    "Env",
    "EnvState",
    "MountainCarEnv",
    "MultiCarRacingEnv",
    "Track",
    "Policy",
    "PolicyConfig",
    "PolicyState",
    "make_policy",
]
