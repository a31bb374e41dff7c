"""fast_jit (utils/fastjit.py) — nesting regression.

fast_jit must not pass `compiler_options` to a jit nested inside an
outer `jax.jit` (JAX only accepts compiler options on top-level jits);
it routes tracer calls to a plain nested jit. These tests pin both legs
and the exact failure shape.
"""

import jax
import jax.numpy as jnp
import numpy as np

from mpopis_tpu.utils.fastjit import fast_jit


def _f(x, y):
    return jnp.sin(x) * y + x


def test_fast_jit_top_level():
    x = jnp.arange(4.0)
    got = fast_jit(_f)(x, 2.0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(_f(x, 2.0)))


def test_fast_jit_inside_outer_jit():
    """The r3 crash shape: a fast_jit'd function called while tracing an
    outer jax.jit must not raise (and must match the eager value)."""
    g = fast_jit(_f)

    @jax.jit
    def outer(x):
        return g(x, 3.0) + 1.0

    x = jnp.arange(4.0)
    np.testing.assert_allclose(
        np.asarray(outer(x)), np.asarray(_f(x, 3.0) + 1.0)
    )


def test_fast_jit_static_argnames_inside_outer_jit():
    """With static_argnames."""

    def h(x, n):
        return x * n

    g = fast_jit(h, static_argnames=("n",))

    @jax.jit
    def outer(x):
        return g(x, n=4)

    np.testing.assert_allclose(np.asarray(outer(jnp.ones(3))), 4.0)
