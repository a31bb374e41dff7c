"""Car rollout kernel (Triton route, Pallas interpreter on CPU) against
the vmap path, which is its correctness oracle; and the XLA linear algebra
the AIS update calls, against NumPy/SciPy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpopis_tpu.kernels.car_rollout import car_rollout_costs
from mpopis_tpu.models import CarRacingEnv, MultiCarRacingEnv, rollout_batch


def _random_controls(key, k, t, na=2):
    return jax.random.uniform(
        key, (k, t, na), minval=-1.0, maxval=1.0
    ).astype(jnp.float32)


def _kernel(env, s0, controls, **kw):
    """Kernel costs for (K, T, na) controls, in the kernel's (T, na, K)."""
    return car_rollout_costs(
        env, s0.x, jnp.transpose(controls, (1, 2, 0)), interpret=True, **kw
    )


def test_car_kernel_matches_vmap_oracle():
    env = CarRacingEnv(dtype=jnp.float32)
    s0 = env.reset()
    controls = _random_controls(jax.random.PRNGKey(0), 64, 12)
    oracle, _ = rollout_batch(env, s0, controls, log_states=False)
    kern = _kernel(env, s0, controls)
    assert kern.shape == (64,)
    np.testing.assert_allclose(
        np.asarray(kern), np.asarray(oracle), rtol=2e-4, atol=2e-3
    )


def test_car_kernel_padding_and_blocks():
    env = CarRacingEnv(dtype=jnp.float32)
    s0 = env.reset()
    # K not a multiple of the block exercises the padding path
    controls = _random_controls(jax.random.PRNGKey(1), 150, 5)
    oracle, _ = rollout_batch(env, s0, controls, log_states=False)
    kern = _kernel(env, s0, controls)
    assert kern.shape == (150,)
    np.testing.assert_allclose(
        np.asarray(kern), np.asarray(oracle), rtol=2e-4, atol=2e-3
    )


def test_multicar_kernel_matches_vmap_oracle():
    env = MultiCarRacingEnv(num_cars=3, dtype=jnp.float32)
    s0 = env.reset()
    controls = _random_controls(jax.random.PRNGKey(2), 40, 6, na=6)
    oracle, _ = rollout_batch(env, s0, controls, log_states=False)
    kern = _kernel(env, s0, controls)
    assert kern.shape == (40,)
    np.testing.assert_allclose(
        np.asarray(kern), np.asarray(oracle), rtol=2e-4, atol=2e-2
    )


@pytest.mark.parametrize("block", [32, 64, 128])
def test_car_kernel_block_sizes_pad_the_same(block):
    """Every block size pads K=100 up to a whole number of programs and
    returns the same (K,) costs; padded lanes never leak into the result."""
    env = CarRacingEnv(dtype=jnp.float32)
    s0 = env.reset()
    controls = _random_controls(jax.random.PRNGKey(3), 100, 4)
    oracle, _ = rollout_batch(env, s0, controls, log_states=False)
    kern = _kernel(env, s0, controls, block=block)
    assert kern.shape == (100,)
    np.testing.assert_allclose(
        np.asarray(kern), np.asarray(oracle), rtol=2e-4, atol=2e-3
    )


def test_car_kernel_rejects_non_power_of_two_block():
    env = CarRacingEnv(dtype=jnp.float32)
    with pytest.raises(ValueError, match="power of two"):
        car_rollout_costs(
            env, env.reset().x, jnp.zeros((2, 2, 8)), block=48, interpret=True
        )


def test_cholesky_matches_numpy():
    """The AIS refits factor Σ with jnp.linalg.cholesky (f32 on the
    device): lower-triangular and equal to NumPy's f64 factor."""
    rng = np.random.default_rng(3)
    for n in (4, 100):
        a = rng.normal(size=(n, n)).astype(np.float32) * 0.2
        spd = (a @ a.T + np.eye(n, dtype=np.float32)).astype(np.float32)
        l = np.asarray(jax.jit(jnp.linalg.cholesky)(jnp.asarray(spd)))
        ref = np.linalg.cholesky(spd.astype(np.float64))
        np.testing.assert_allclose(l, ref, rtol=5e-5, atol=5e-6)
        # strictly lower-triangular output (upper must be exactly zero)
        assert np.all(l[np.triu_indices(n, 1)] == 0.0)


def test_forward_solve_matches_scipy():
    """The γ control-cost term's two forward substitutions (driver.py):
    solve_triangular on row-stacked right-hand sides."""
    import scipy.linalg

    rng = np.random.default_rng(4)
    n = 100
    a = rng.normal(size=(n, n)).astype(np.float32) * 0.2
    spd = (a @ a.T + np.eye(n, dtype=np.float32)).astype(np.float32)
    l = np.linalg.cholesky(spd.astype(np.float64)).astype(np.float32)
    b = rng.normal(size=(2, n)).astype(np.float32)
    y = np.asarray(jax.jit(
        lambda l, b: jax.scipy.linalg.solve_triangular(l, b.T, lower=True).T
    )(jnp.asarray(l), jnp.asarray(b)))
    ref = scipy.linalg.solve_triangular(
        l.astype(np.float64), b.T.astype(np.float64), lower=True
    ).T
    np.testing.assert_allclose(y, ref, rtol=5e-5, atol=5e-6)


@pytest.mark.gpu
def test_car_kernel_compiled_on_gpu_matches_oracle():
    """The kernel as compiled for the card (no interpreter) against the
    vmap path at the full width; chip_smoke.py runs this phase on the GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")
    import chip_smoke

    chip_smoke.car_kernel_parity(k=8192, horizon=50)
