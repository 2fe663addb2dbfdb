"""fit_motion CLI: IMU + GPS -> velocities / steering / forward-axis JSONs.

Flag-compatible with the reference binary (/root/reference/src/fit_motion.cc:47-104);
same input/output JSON formats. The sliding-window calibration runs as one
batched Gauss-Newton device program instead of sequential per-window L-BFGS.

Note on --optimization_iters: the reference's default of 500 is an L-BFGS
budget; this implementation's Gauss-Newton converges in tens of iterations,
so the default here is 40. Passing larger values works but wastes time.
"""

from __future__ import annotations

import sys

from pilotguru.cli._common import add_dtype_flag, make_parser, setup_backend


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--rotations_json", required=True)
    parser.add_argument("--accelerations_json", required=True)
    parser.add_argument("--locations_json", required=True)
    parser.add_argument("--velocities_out_json", default="")
    parser.add_argument("--steering_out_json", default="")
    parser.add_argument("--forward_axis_out_json", default="")
    parser.add_argument("--locations_batch_size", type=int, default=40)
    parser.add_argument("--locations_shift_step", type=int, default=5)
    parser.add_argument("--optimization_iters", type=int, default=40)
    parser.add_argument("--post_smoothing_sigma_sec", type=float, default=0.003)
    parser.add_argument(
        "--principal_rotation_axis_integration_interval_usec",
        type=int,
        default=500_000,
    )
    parser.add_argument(
        "--forward_axis_inference_min_velocity_m_s", type=float, default=5.0
    )
    parser.add_argument(
        "--forward_axis_inference_min_rotation_rad", type=float, default=0.2
    )
    parser.add_argument(
        "--print_timings",
        action="store_true",
        help="Print per-stage wall times after the run.",
    )
    add_dtype_flag(parser)
    args = parser.parse_args(argv)

    if args.optimization_iters <= 0:
        parser.error("--optimization_iters must be positive")
    if args.locations_batch_size <= 0 or args.locations_shift_step <= 0:
        parser.error("batch size and shift step must be positive")
    if args.locations_batch_size < args.locations_shift_step:
        parser.error("--locations_batch_size must be >= --locations_shift_step")
    if args.post_smoothing_sigma_sec <= 0:
        parser.error("--post_smoothing_sigma_sec must be positive")

    dtype = setup_backend(args.dtype)

    from pilotguru.calib import FitMotionConfig, fit_motion_arrays
    from pilotguru.formats import (
        json_io,
        keys,
    )

    rot_times, rot_rates = json_io.read_timestamped_3d(
        args.rotations_json, keys.ROTATIONS
    )
    acc_times, accs = json_io.read_timestamped_3d(
        args.accelerations_json, keys.ACCELERATIONS
    )
    gps_times, gps_speeds = json_io.read_gps_velocities(args.locations_json)

    config = FitMotionConfig(
        locations_batch_size=args.locations_batch_size,
        locations_shift_step=args.locations_shift_step,
        optimization_iters=args.optimization_iters,
        post_smoothing_sigma_sec=args.post_smoothing_sigma_sec,
        principal_rotation_axis_integration_interval_usec=(
            args.principal_rotation_axis_integration_interval_usec
        ),
        forward_axis_inference_min_velocity_m_s=(
            args.forward_axis_inference_min_velocity_m_s
        ),
        forward_axis_inference_min_rotation_rad=(
            args.forward_axis_inference_min_rotation_rad
        ),
        dtype=dtype,
    )

    from pilotguru.utils.profiling import StageTimer, maybe_jax_profiler_trace

    timer = StageTimer("fit_motion")
    with maybe_jax_profiler_trace("fit_motion"):
        result = fit_motion_arrays(
            rot_times, rot_rates, acc_times, accs, gps_times, gps_speeds, config,
            timer=timer,
        )
    if args.print_timings:
        import sys as _sys

        timer.report(out=_sys.stderr)

    # Reference logs the fitted axis via its vector operator<<
    # (calibration/rotation.cc:464 + include/logging/strings.hpp).
    from pilotguru.utils.strings import format_sequence

    print(
        "FixedForwardAxisCalibrator overall: "
        + format_sequence(f"{v:.6f}" for v in result.forward_axis),
        file=sys.stderr,
    )

    if args.steering_out_json:
        json_io.write_timestamped_values(
            result.steering_times_usec,
            result.steering_angular_velocities,
            args.steering_out_json,
            keys.STEERING,
            keys.ANGULAR_VELOCITY,
        )
    if args.velocities_out_json:
        json_io.write_timestamped_values(
            result.velocity_times_usec,
            result.velocities_m_s,
            args.velocities_out_json,
            keys.VELOCITIES,
            keys.SPEED_M_S,
        )
    if args.forward_axis_out_json:
        json_io.write_forward_axis(result.forward_axis, args.forward_axis_out_json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
