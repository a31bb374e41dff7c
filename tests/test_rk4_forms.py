"""The three RK4 stage-emission forms of the spatial stepper are the
same arithmetic (models/spatial_contact.build_spatial_stepper):

- "scan":   (4,)-array stage constants — cheapest XLA CPU compile, the
            env.step / vmap-path form.
- "unroll": 4 stages inline, static float coefficients — keeps 4 live
            qacc bodies.
- "loop":   lax.fori_loop with scalar-select coefficients and
            data-anchored carries — no array constants and a 1x qacc
            live window, the form for a kernel body.

The loop form's anchor adds (x + 0·acts) must be EXACT, so "loop" must
agree BITWISE with "scan" (the env.step / vmap-oracle form) on CPU f64
given identical inputs — this pins the loop form to the vmap-path
arithmetic. "unroll" is only pinned to ~1 ulp: its inlined stages give
XLA CPU different fusion clusters and FMA-contraction choices (measured
max rel diff 3.1e-15 on the ant model, CPU f64), which is compiler
freedom, not an arithmetic change.
"""

import numpy as np

import jax.numpy as jnp

from mpopis_tpu.models.ant_device import MODEL as ANT_MODEL
from mpopis_tpu.models.spatial_contact import build_spatial_stepper


def _rand_inputs(seed=0):
    rng = np.random.default_rng(seed)
    m = ANT_MODEL
    q = [jnp.asarray(rng.normal(0.0, 0.2, (3,))) for _ in range(m.n_q)]
    # root quaternion slots: keep near-identity so normalize_quat is tame
    q[3] = jnp.ones((3,)) + jnp.asarray(rng.normal(0, 0.01, (3,)))
    for i in (4, 5, 6):
        q[i] = jnp.asarray(rng.normal(0, 0.05, (3,)))
    q[2] = jnp.asarray(rng.uniform(0.3, 0.6, (3,)))  # torso z in contact range
    qv = [jnp.asarray(rng.normal(0.0, 0.5, (3,))) for _ in range(m.n_dof)]
    tau = [jnp.asarray(rng.normal(0.0, 0.3, (3,))) for _ in range(m.n_dof)]
    return tuple(q), tuple(qv), tuple(tau)


def test_rk4_loop_matches_scan_and_unroll_bitwise():
    m = ANT_MODEL
    q, qv, tau = _rand_inputs(7)
    outs = {}
    for mode in ("scan", "unroll", "loop"):
        substep, *_ = build_spatial_stepper(m, rk4_mode=mode)
        qn, vn, lam, q4 = substep(q, qv, tau, 2, 4, None)
        outs[mode] = [np.asarray(x) for x in (*qn, *vn, lam, *q4)]
    # loop (the fused-kernel default) must be BITWISE the oracle form.
    for a, b in zip(outs["scan"], outs["loop"]):
        np.testing.assert_array_equal(
            a, b, err_msg="rk4_mode=loop diverges from scan"
        )
    # unroll: identical arithmetic, but XLA CPU contracts different FMAs
    # in the inlined emission — measured diff 3.1e-15 (~14 ulp); rtol is
    # a few x that so a genuine arithmetic regression in the unroll path
    # cannot hide under a slack tolerance.
    for a, b in zip(outs["scan"], outs["unroll"]):
        np.testing.assert_allclose(
            a, b, rtol=1e-14, atol=1e-18,
            err_msg="rk4_mode=unroll diverges from scan",
        )
