"""project_translations CLI: flatten trajectory translations into the plane.

Flag- and format-compatible with the reference binary
(/root/reference/src/project_translations.cc): every translation is
projected into the stored 2x3 horizontal plane and written back in 3D.
"""

from __future__ import annotations

import sys

from pilotguru.cli._common import make_parser


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--trajectory_in_file", required=True)
    parser.add_argument("--trajectory_out_file", required=True)
    args = parser.parse_args(argv)

    from pilotguru.formats.trajectory import read_trajectory, write_trajectory
    from pilotguru.vo.flatten import project_translations

    trajectory = read_trajectory(args.trajectory_in_file)
    if trajectory.plane is None:
        raise ValueError("input trajectory has no stored plane")
    trajectory.translations = project_translations(
        trajectory.translations, trajectory.plane
    )
    write_trajectory(trajectory, args.trajectory_out_file)
    return 0


if __name__ == "__main__":
    sys.exit(main())
