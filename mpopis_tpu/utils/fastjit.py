"""jit with reduced XLA *backend* optimization effort.

The spatial-contact scalar graphs (models/spatial_contact.py — n=14, 108
QP rows, RK4) lower to hundreds of thousands of scalar HLO ops; XLA CPU's
default backend pipeline (LLVM -O3 over one giant fused function) spends
tens of minutes on them (measured: 35 min for one Ant constrained-qacc at
the default level). Dropping `xla_backend_optimization_level` skips the
expensive LLVM passes only — HLO simplification and the numerics are
unchanged, the generated code is just less micro-optimized. The CPU test
suite uses this for every spatial jit; GPU entry points do not.

Nesting: JAX rejects `compiler_options` on a jit that is traced inside an
outer jit ("compiler options can only be passed to top-level jit calls").
The wrapper therefore checks its arguments at call
time: tracers mean we are inside an outer trace, where the inner jit is
inlined anyway and the backend options of the OUTER jit govern — so the
call routes to a plain nested jit with identical semantics.
"""

from __future__ import annotations

import functools

import jax

FAST_COMPILER_OPTIONS = {"xla_backend_optimization_level": "1"}


def _has_tracer(tree) -> bool:
    return any(
        isinstance(leaf, jax.core.Tracer)
        for leaf in jax.tree_util.tree_leaves(tree)
    )


def fast_jit(fun=None, **jit_kwargs):
    """`jax.jit` with FAST_COMPILER_OPTIONS merged in (decorator-friendly).

    Safe to call under an outer `jax.jit`: when any argument is a tracer
    the compiler options are dropped (they would raise on a nested jit;
    the outer jit's backend settings apply to the inlined computation).
    """
    if fun is None:
        return functools.partial(fast_jit, **jit_kwargs)
    opts = dict(FAST_COMPILER_OPTIONS)
    opts.update(jit_kwargs.pop("compiler_options", {}) or {})
    top = jax.jit(fun, compiler_options=opts, **jit_kwargs)
    nested = jax.jit(fun, **jit_kwargs)

    @functools.wraps(fun)
    def wrapper(*args, **kwargs):
        if _has_tracer((args, kwargs)):
            return nested(*args, **kwargs)
        return top(*args, **kwargs)

    return wrapper
