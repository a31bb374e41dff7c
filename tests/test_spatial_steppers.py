"""Spatial-contact steppers (models/spatial_contact.py): the two QP forms
of the constrained substep agree."""

import numpy as np
import pytest

import jax.numpy as jnp

from mpopis_tpu.models import AntDeviceEnv, PusherDeviceEnv


@pytest.mark.slow
def test_qp_sparse_matches_dense_substep():
    """qp_dense=False — the scalar-sparse QP form — shares _qp_iterate
    with the stacked-dense form the vmap path uses and must produce the same
    constrained substep to f64 reduction-order tolerance, on states
    with live floor contacts (Ant dropped onto the plane) and live
    pair rows (Pusher near the object)."""
    from mpopis_tpu.models import ant_device as ad
    from mpopis_tpu.models import pusher_device as pu
    from mpopis_tpu.models.spatial_contact import build_spatial_stepper

    rng = np.random.default_rng(7)
    for env, mod, drop in (
        (PusherDeviceEnv(dtype=jnp.float64), pu, None),
        (AntDeviceEnv(dtype=jnp.float64), ad, -0.45),
    ):
        model = mod.MODEL
        x = np.array(env.reset().x, dtype=np.float64, copy=True)
        if drop is not None:
            x[2] += drop
        q = tuple(jnp.float64(v) for v in x[: model.n_q])
        qv = tuple(
            jnp.float64(v)
            for v in 0.3 * rng.standard_normal(model.n_dof)
        )
        tau = tuple(
            jnp.float64(v)
            for v in 0.5 * rng.standard_normal(model.n_dof)
        )
        sub_d, *_ = build_spatial_stepper(model, rk4_mode="loop",
                                          qp_dense=True)
        sub_s, *_ = build_spatial_stepper(model, rk4_mode="loop",
                                          qp_dense=False)
        out_d = sub_d(q, qv, tau, 3, 6, None)
        out_s = sub_s(q, qv, tau, 3, 6, None)
        if drop is not None:  # the dropped Ant must have live contacts
            assert float(jnp.max(jnp.abs(out_d[2]))) > 0.0
        for a, b in zip(out_d, out_s):
            np.testing.assert_allclose(
                np.asarray(jnp.stack(a) if isinstance(a, tuple) else a),
                np.asarray(jnp.stack(b) if isinstance(b, tuple) else b),
                rtol=1e-11, atol=1e-13,
            )
