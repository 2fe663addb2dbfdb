"""smooth_heading_directions CLI: re-smooth a trajectory's rotations.

Flag- and format-compatible with the reference binary
(/root/reference/src/smooth_heading_directions.cc): Gaussian-filter the
trajectory quaternions per component (sigma in frames, kernel size
4*sigma+1, renormalized), then recompute planar directions and turn angles
against the stored horizontal plane.
"""

from __future__ import annotations

import sys

import numpy as np

from pilotguru.cli._common import add_dtype_flag, make_parser, setup_backend


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--trajectory_in_file", required=True)
    parser.add_argument("--sigma", type=int, required=True)
    parser.add_argument("--trajectory_out_file", required=True)
    add_dtype_flag(parser)
    args = parser.parse_args(argv)
    if args.sigma <= 0:
        parser.error("--sigma must be positive")
    dtype = setup_backend(args.dtype)

    from pilotguru.formats.trajectory import read_trajectory, write_trajectory
    from pilotguru.timeseries.smoothing import smooth_quaternion_sequence
    from pilotguru.vo.flatten import (
        project_directions,
        turn_angles_from_directions,
    )

    trajectory = read_trajectory(args.trajectory_in_file)
    if trajectory.plane is None:
        raise ValueError("input trajectory has no stored plane")

    trajectory.rotations = np.asarray(
        smooth_quaternion_sequence(trajectory.rotations, args.sigma, dtype=dtype)
    )
    trajectory.planar_directions = project_directions(
        trajectory.rotations, trajectory.plane
    )
    trajectory.turn_angles = turn_angles_from_directions(
        trajectory.planar_directions
    )
    write_trajectory(trajectory, args.trajectory_out_file)
    return 0


if __name__ == "__main__":
    sys.exit(main())
