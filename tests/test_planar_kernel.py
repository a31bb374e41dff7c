"""Planar-contact steppers: the analytic mass/bias against the energy-AD
route."""

import numpy as np
import pytest

import jax.numpy as jnp

from mpopis_tpu.models import cheetah_device, hopper_device, walker2d_device
from mpopis_tpu.models.planar_contact import (
    bias_analytic,
    build_ad_dynamics,
    mass_entries_analytic,
)


@pytest.mark.parametrize(
    "mod", [cheetah_device, hopper_device, walker2d_device],
    ids=["cheetah", "hopper", "walker2d"],
)
def test_analytic_mass_bias_match_ad(mod):
    """The analytic mass matrix / Coriolis+gravity bias (the forms the
    stepper uses) equal the independent energy-AD route (jacfwd/jvp of the
    kinematics) to ~1e-13."""
    model = mod.MODEL
    n = model.n_dof
    _, me_ad, bias_ad = build_ad_dynamics(model)
    rng = np.random.default_rng(0)
    for _ in range(4):
        q = tuple(jnp.float64(v) for v in rng.uniform(-1.0, 1.0, n))
        qv = tuple(jnp.float64(v) for v in rng.uniform(-2.0, 2.0, n))
        m_ad = me_ad(q)
        m_an = mass_entries_analytic(model, q)
        for i in range(n):
            for j in range(i + 1):
                np.testing.assert_allclose(
                    float(m_an[i][j]), float(m_ad[i][j]),
                    rtol=1e-12, atol=1e-13,
                )
        b_ad = bias_ad(q, qv)
        b_an = bias_analytic(model, q, qv)
        np.testing.assert_allclose(
            [float(x) for x in b_an], [float(x) for x in b_ad],
            rtol=1e-11, atol=1e-12,
        )
