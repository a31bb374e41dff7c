"""Command-line interface.

The reference has no CLI (pure kwargs on simulate_* in a Julia REPL); this
exposes the same drivers and parameter names as subcommands:

    python -m mpopis_tpu car --policy cemppi --samples 150 --horizon 50
    python -m mpopis_tpu mountaincar --policy mppi --trials 3
    python -m mpopis_tpu cartpole --policy cmamppi
"""

from __future__ import annotations

import argparse

from mpopis_tpu.policies.config import POLICY_KINDS


def _common(p: argparse.ArgumentParser, samples: int, horizon: int, lam: float,
            ais_its: int = 10, lambda_ais: float = 20.0,
            ce_sigma_est: str = "ss"):
    p.add_argument("--policy", default="cemppi", help=f"one of {POLICY_KINDS}")
    p.add_argument("--trials", type=int, default=1)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--samples", type=int, default=samples)
    p.add_argument("--horizon", type=int, default=horizon)
    p.add_argument("--lam", type=float, default=lam)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--ais-its", type=int, default=ais_its)
    p.add_argument("--lambda-ais", type=float, default=lambda_ais)
    p.add_argument("--ce-elite-threshold", type=float, default=0.8)
    p.add_argument("--ce-sigma-est", default=ce_sigma_est)
    p.add_argument("--cma-sigma", type=float, default=0.75)
    p.add_argument("--cma-elite-threshold", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--f64", action="store_true", help="use float64 (needs JAX_ENABLE_X64)")
    p.add_argument(
        "--steps-per-call", type=int, default=None,
        help="control steps per compiled device call (default: 10, or 1 when "
        "gif/plot/noise/logging needs the host every step; host-engine mujoco "
        "ignores it, on-device mujoco honors it)",
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="mpopis_tpu", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    car = sub.add_parser("car", help="single/multi car racing")
    _common(car, 150, 50, 10.0)
    car.add_argument("--cars", type=int, default=1)
    car.add_argument("--laps", type=int, default=2)
    car.add_argument("--track", default="curve")
    car.add_argument("--state-x-sigma", type=float, default=0.0)
    car.add_argument("--state-y-sigma", type=float, default=0.0)
    car.add_argument("--state-psi-sigma", type=float, default=0.0)
    car.add_argument("--save-gif", action="store_true")
    car.add_argument("--plot-traj", action="store_true")
    car.add_argument(
        "--sharded", action="store_true",
        help="shard the K rollouts across all visible devices",
    )

    # the reference's mountaincar/cartpole drivers default to 5 AIS
    # iterations with λ_ais=0.1 (mountaincar_example.jl:59-60)
    mc = sub.add_parser("mountaincar", help="continuous mountain car")
    # reference defaults: ce_Σ_est=:mle (mountaincar_example.jl:63)
    _common(mc, 20, 15, 0.1, ais_its=5, lambda_ais=0.1, ce_sigma_est="mle")
    mc.add_argument("--save-gif", action="store_true")

    cp = sub.add_parser("cartpole", help="continuous cart-pole")
    _common(cp, 20, 15, 0.1, ais_its=5, lambda_ais=0.1, ce_sigma_est="mle")
    cp.add_argument("--save-gif", action="store_true")

    mj = sub.add_parser("mujoco", help="host-batched MuJoCo (envpool-lite engine)")
    _common(mj, 100, 50, 1.0)
    mj.add_argument("--env-name", default="HalfCheetah-v4")
    mj.add_argument("--frame-skip", type=int, default=None,
                    help="host engine only (default: 5); on-device tasks use their gym value")
    mj.add_argument("--output-acts-file", action="store_true")
    mj.add_argument("--log-runs", action="store_true")
    mj.add_argument("--no-native", action="store_true", help="use the Python fallback engine")
    mj.add_argument(
        "--on-device", action="store_true",
        help="run the dynamics on the accelerator (pure-JAX; all 11 tasks — "
        "contact-free, the HalfCheetah/Hopper/Walker2d planar contact "
        "pipeline, and the Ant/Pusher/Humanoid/HumanoidStandup 3D "
        "spatial-contact pipeline)",
    )
    mj.add_argument(
        "--solver-iters", default=None, metavar="OUTER,CG",
        help="on-device contact tasks: fixed iteration counts of the "
        "contact QP solve (default 3,16 = control-grade forces ~1e-3; "
        "6,40 matches mj_step to solver tolerance)",
    )

    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import jax

    from mpopis_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    if args.f64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from mpopis_tpu.harness import simulate

    dtype = jnp.float64 if args.f64 else jnp.float32
    common = dict(
        num_trials=args.trials,
        num_steps=args.steps,
        policy_type=args.policy,
        num_samples=args.samples,
        horizon=args.horizon,
        lam=args.lam,
        alpha=args.alpha,
        ais_its=args.ais_its,
        lambda_ais=args.lambda_ais,
        ce_elite_threshold=args.ce_elite_threshold,
        ce_sigma_est=args.ce_sigma_est,
        cma_sigma=args.cma_sigma,
        cma_elite_threshold=args.cma_elite_threshold,
        seed=args.seed,
        dtype=dtype,
    )
    if args.cmd == "car":
        sharding = None
        if args.sharded:
            from mpopis_tpu.parallel import make_sample_mesh, sample_sharding

            sharding = sample_sharding(make_sample_mesh(), ndim=3)
        simulate.simulate_car_racing(
            sample_sharding=sharding,
            steps_per_call=args.steps_per_call,
            num_cars=args.cars,
            laps=args.laps,
            track=args.track,
            state_x_sigma=args.state_x_sigma,
            state_y_sigma=args.state_y_sigma,
            state_psi_sigma=args.state_psi_sigma,
            save_gif=args.save_gif,
            plot_traj=args.plot_traj,
            **common,
        )
    elif args.cmd == "mountaincar":
        simulate.simulate_mountaincar(
            save_gif=args.save_gif, steps_per_call=args.steps_per_call, **common
        )
    elif args.cmd == "cartpole":
        simulate.simulate_cartpole(
            save_gif=args.save_gif, steps_per_call=args.steps_per_call, **common
        )
    elif args.cmd == "mujoco":
        if args.on_device:
            import warnings

            for flag, name in ((args.frame_skip is not None, "--frame-skip"),
                               (args.no_native, "--no-native")):
                if flag:
                    warnings.warn(
                        f"{name} applies to the host engine only and is "
                        "ignored with --on-device (on-device tasks use their "
                        "gym frame_skip)",
                        stacklevel=1,
                    )
            solver_iters = None
            if args.solver_iters is not None:
                outer, cg = (int(v) for v in args.solver_iters.split(","))
                solver_iters = (outer, cg)
            simulate.simulate_mujoco_on_device(
                args.env_name,
                steps_per_call=args.steps_per_call,
                solver_iters=solver_iters,
                output_acts_file=args.output_acts_file,
                **common,
            )
            return 0
        from mpopis_tpu.harness.simulate_mujoco import simulate_mujoco

        common.pop("dtype")
        simulate_mujoco(
            args.env_name,
            frame_skip=args.frame_skip if args.frame_skip is not None else 5,
            output_acts_file=args.output_acts_file,
            log_runs=args.log_runs,
            native=not args.no_native,
            **common,
        )
    return 0
