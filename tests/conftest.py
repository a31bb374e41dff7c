"""Test configuration.

Tests run on the CPU with a forced 8-device topology, so sharding and
collective paths are exercised without several accelerators, and with x64
enabled so numerical parity checks against the float64 Julia reference
semantics are meaningful. The platform is forced both through
JAX_PLATFORMS and through jax.config after import. Rollout-kernel tests run
the kernel in the Pallas interpreter; on-card checks carry the `gpu`
marker and skip here (`python chip_smoke.py` runs them on the GPU).
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# The spatial-contact suites (Ant) compile very large scalar graphs; the
# persistent cache (utils/cache.py) makes later runs start in seconds.
from mpopis_tpu.utils.cache import enable_compilation_cache

enable_compilation_cache()
