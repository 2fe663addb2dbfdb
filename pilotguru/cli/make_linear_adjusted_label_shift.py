"""make_linear_adjusted_label_shift CLI: linear ramp for label-shift rates.

Flag-compatible with the reference
(/root/reference/python/make_linear_adjusted_label_shift.py): prints a
comma-separated linear interpolation from start to end over the label
dimensions, to feed train.py's --horizontal_label_shift_rate.
"""

from __future__ import annotations

import sys

from pilotguru.cli._common import make_parser


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--start_value", type=float, default=0.0)
    parser.add_argument("--end_value", type=float, default=0.0)
    parser.add_argument("--dims", type=int, default=1)
    args = parser.parse_args(argv)
    values = [
        str((args.start_value * (args.dims - i) + args.end_value * i) / args.dims)
        for i in range(args.dims)
    ]
    print(",".join(values))
    return 0


if __name__ == "__main__":
    sys.exit(main())
