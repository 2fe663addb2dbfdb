"""preprocess_corpus CLI: batched fit_motion over a directory of rides.

Corpus-scale upgrade of preprocess_all (/root/reference/python/
preprocess_all.py runs one fit_motion subprocess per ride): every ride
subdirectory of --corpus_dir containing rotations.json / accelerations.json
/ locations.json is calibrated through ONE shared compiled device program
(shape-bucketed padding, see calib/corpus.py), and the standard
postprocessed/ outputs (velocities-imu.json, steering-imu.json,
forward.json) are written per ride. --process_can_data additionally
converts can_frames.json per ride like preprocess_all does.
"""

from __future__ import annotations

import os
import sys

from pilotguru.cli._common import add_dtype_flag, make_parser, setup_backend


def find_ride_dirs(corpus_dir):
    rides = []
    for name in sorted(os.listdir(corpus_dir)):
        d = os.path.join(corpus_dir, name)
        if os.path.isdir(d) and os.path.isfile(os.path.join(d, "rotations.json")):
            rides.append(d)
    return rides


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--corpus_dir", required=True)
    parser.add_argument(
        "--out_subdir",
        default="postprocessed",
        help="Per-ride output subdirectory name.",
    )
    parser.add_argument("--process_can_data", type=bool, default=False)
    parser.add_argument("--locations_batch_size", type=int, default=40)
    parser.add_argument("--locations_shift_step", type=int, default=5)
    parser.add_argument("--optimization_iters", type=int, default=40)
    parser.add_argument(
        "--shard_windows",
        action="store_true",
        help="Shard the window axis over all visible devices.",
    )
    parser.add_argument(
        "--print_timings", action="store_true",
        help="Print per-stage wall times after the run.",
    )
    add_dtype_flag(parser)
    args = parser.parse_args(argv)
    dtype = setup_backend(args.dtype)

    from pilotguru.calib import (
        FitMotionConfig,
        RideArrays,
        fit_motion_corpus,
    )
    from pilotguru.formats import json_io, keys
    from pilotguru.utils.profiling import StageTimer

    ride_dirs = find_ride_dirs(args.corpus_dir)
    if not ride_dirs:
        parser.error(f"no ride directories under {args.corpus_dir}")

    rides = []
    for d in ride_dirs:
        try:
            rot_t, rot = json_io.read_timestamped_3d(
                os.path.join(d, "rotations.json"), keys.ROTATIONS
            )
            acc_t, acc = json_io.read_timestamped_3d(
                os.path.join(d, "accelerations.json"), keys.ACCELERATIONS
            )
            gps_t, gps_v = json_io.read_gps_velocities(
                os.path.join(d, "locations.json")
            )
        except FileNotFoundError as e:
            parser.error(f"incomplete ride directory {d}: {e.filename} missing")
        rides.append(RideArrays(rot_t, rot, acc_t, acc, gps_t, gps_v))

    mesh = None
    if args.shard_windows:
        import jax
        from pilotguru.parallel.mesh import make_mesh

        devices = jax.devices()
        mesh = make_mesh(("windows",), (len(devices),), devices)

    config = FitMotionConfig(
        locations_batch_size=args.locations_batch_size,
        locations_shift_step=args.locations_shift_step,
        optimization_iters=args.optimization_iters,
        dtype=dtype,
    )
    timer = StageTimer("preprocess_corpus")
    results = fit_motion_corpus(rides, config, mesh=mesh, timer=timer)

    for d, result in zip(ride_dirs, results):
        out_dir = os.path.join(d, args.out_subdir)
        os.makedirs(out_dir, exist_ok=True)
        json_io.write_timestamped_values(
            result.steering_times_usec,
            result.steering_angular_velocities,
            os.path.join(out_dir, "steering-imu.json"),
            keys.STEERING,
            keys.ANGULAR_VELOCITY,
        )
        json_io.write_timestamped_values(
            result.velocity_times_usec,
            result.velocities_m_s,
            os.path.join(out_dir, "velocities-imu.json"),
            keys.VELOCITIES,
            keys.SPEED_M_S,
        )
        json_io.write_forward_axis(
            result.forward_axis, os.path.join(out_dir, "forward.json")
        )
        if args.process_can_data:
            from pilotguru.cli import process_can_frames

            process_can_frames.main(
                [
                    f"--can_frames_json={os.path.join(d, 'can_frames.json')}",
                    f"--velocities_out_json="
                    f"{os.path.join(out_dir, 'velocities-can.json')}",
                    f"--steering_out_json="
                    f"{os.path.join(out_dir, 'steering-can.json')}",
                ]
            )
        print(f"{d}: {result.velocity_times_usec.shape[0]} velocity events")

    if args.print_timings:
        timer.report(out=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
