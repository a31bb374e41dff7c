"""The backend seam, the compile-cache rule, error propagation from the
rollout kernel, the flax-free import, and chip_smoke.py's refusal to run
without a GPU."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpopis_tpu.models import (
    AntDeviceEnv,
    CarRacingEnv,
    CheetahDeviceEnv,
    HopperDeviceEnv,
    HumanoidDeviceEnv,
    HumanoidStandupDeviceEnv,
    MultiCarRacingEnv,
    PusherDeviceEnv,
    SwimmerDeviceEnv,
    Walker2dDeviceEnv,
)
from mpopis_tpu.policies import PolicyConfig, make_policy
from mpopis_tpu.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_KERNEL_ENVS = (CarRacingEnv, MultiCarRacingEnv)
_ENVS = _KERNEL_ENVS + (
    CheetahDeviceEnv, HopperDeviceEnv, Walker2dDeviceEnv, SwimmerDeviceEnv,
    AntDeviceEnv, PusherDeviceEnv, HumanoidDeviceEnv, HumanoidStandupDeviceEnv,
)


@pytest.mark.parametrize("cls", _ENVS, ids=lambda c: c.__name__)
def test_backend_seam(cls, monkeypatch):
    """The kernel is chosen only for an env that has one, at float32, on
    the GPU backend or with the interpreter asked for."""
    has_kernel = cls in _KERNEL_ENVS
    assert cls.has_fused_kernel == has_kernel
    assert not cls(dtype=jnp.float32).supports_fused_rollout  # CPU backend
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert cls(dtype=jnp.float32).supports_fused_rollout == has_kernel
    assert not cls(dtype=jnp.float64).supports_fused_rollout
    if has_kernel:
        monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
        assert cls(dtype=jnp.float32, fused_interpret=True).supports_fused_rollout
        assert not cls(dtype=jnp.float64, fused_interpret=True).supports_fused_rollout
    else:
        with pytest.raises(TypeError):
            cls(fused_interpret=True)


@pytest.mark.parametrize("env_set", [True, False], ids=["env_set", "env_unset"])
def test_compilation_cache_dir(env_set, monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set in code; otherwise
    the cache sits at <checkout>/.jax_cache."""
    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: updates.__setitem__(name, value))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cache.enable_compilation_cache() == str(tmp_path)
        assert updates == {}
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = cache.enable_compilation_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert updates["jax_compilation_cache_dir"] == path
        assert os.path.isdir(path)


def _broken_kernel(self, state, controls_tak):
    raise RuntimeError("synthetic kernel compile failure")


@pytest.mark.parametrize("caller", ["make_policy", "harness"])
def test_kernel_error_is_not_hidden(caller, monkeypatch):
    """A failing rollout kernel fails the run: no fallback to the vmap
    path, the CPU or the interpreter."""
    env = CarRacingEnv(dtype=jnp.float32, fused_interpret=True)
    monkeypatch.setattr(CarRacingEnv, "fused_rollout_costs", _broken_kernel)
    with pytest.raises(RuntimeError, match="synthetic kernel"):
        if caller == "make_policy":
            cfg = PolicyConfig(kind="cemppi", num_samples=16, horizon=5,
                               lam=10.0, opt_its=2, sigma_est="mle")
            pol = make_policy(env, cfg, cov_mat=np.diag([0.0625, 0.1]))
            pol.step(env.reset(), pol.init_state(3))
        else:
            from mpopis_tpu.harness import simulate

            simulate._simulate_simple(
                env, "CarRacing", num_trials=1, num_steps=3,
                policy_type="cemppi", num_samples=16, horizon=5, lam=10.0,
                u0=(0.0, 0.0), cov_mat=(0.0625, 0.1), ais_its=2,
                ce_sigma_est="mle", seed=11, print_output=False,
            )


def _run(args, cwd: str = REPO, timeout: int = 240):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("what", ["import", "cli_help"])
def test_runs_without_flax(what):
    """flax is not a dependency: the package and the CLI load with it
    blocked."""
    code = "import sys; sys.modules['flax'] = None\n"
    if what == "import":
        code += "import mpopis_tpu; print(mpopis_tpu.PolicyState)"
    else:
        code += ("import runpy; sys.argv = ['mpopis_tpu', 'car', '--help']\n"
                 "runpy.run_module('mpopis_tpu', run_name='__main__')")
    res = _run(["-c", code])
    assert res.returncode == 0, res.stderr[-2000:]
    assert ("PolicyState" if what == "import" else "--samples") in res.stdout


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_gpu(where, tmp_path):
    """No GPU, or no package beside the script: non-zero exit, no result."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        with open(script) as f:
            (tmp_path / "chip_smoke.py").write_text(f.read())
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    res = _run([script], cwd=cwd)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
