"""Multi-host-analog validation: TWO real processes form a global 8-device
mesh via jax.distributed (gloo coordinator — the same wire-up a multi-host
deployment uses), run the K-sharded CEMPPI policy step under jit,
and must produce identical actions on both processes AND match the
single-process run of the same seed/config."""

import os
import subprocess
import sys

import numpy as np
import pytest


@pytest.mark.slow
def test_two_process_global_mesh_matches_single_process(tmp_path):
    import socket

    script = os.path.join(
        os.path.dirname(__file__), "..", "scripts", "multiprocess_worker.py"
    )
    env = dict(os.environ)
    base_flags = env.get("XLA_FLAGS", "")
    env["XLA_FLAGS"] = (
        base_flags + " --xla_force_host_platform_device_count=4"
    ).strip()
    with socket.socket() as sock:  # free ephemeral port for the coordinator
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    outs = [str(tmp_path / f"act{p}.txt") for p in (0, 1)]
    procs = [
        subprocess.Popen(
            [sys.executable, script, f"localhost:{port}", "2", str(pid), "4",
             outs[pid]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in (0, 1)
    ]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=280)
            assert p.returncode == 0, out[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    a0 = np.array([float(v) for v in open(outs[0]).read().split(",")])
    a1 = np.array([float(v) for v in open(outs[1]).read().split(",")])
    np.testing.assert_array_equal(a0, a1)

    # single-process reference on the SAME global device count (the test
    # conftest already forces an 8-device CPU topology + x64)
    import jax

    from mpopis_tpu.models import MountainCarEnv
    from mpopis_tpu.parallel import make_sample_mesh, sample_sharding
    from mpopis_tpu.policies import PolicyConfig, make_policy

    assert len(jax.devices()) == 8
    import jax.numpy as jnp

    mesh = make_sample_mesh()
    env_m = MountainCarEnv(dtype=jnp.float64)
    cfg = PolicyConfig(kind="cemppi", num_samples=32, horizon=8, lam=0.1,
                       opt_its=2)
    pol = make_policy(
        env_m, cfg, cov_mat=[1.5], sample_sharding=sample_sharding(mesh, ndim=3)
    )
    action, _, _ = pol.step(env_m.reset(), pol.init_state(7))
    # cross-process collectives reduce in a different order than the
    # single-process program: agreement at f64 rounding level
    np.testing.assert_allclose(a0, np.asarray(action), rtol=1e-12, atol=1e-14)
