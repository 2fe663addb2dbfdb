"""annotate_frames CLI: per-frame time-weighted averages of a JSON series.

Flag- and format-compatible with the reference binary
(/root/reference/src/annotate_frames.cc): frame i >= 1 gets the average of
the (optionally Gaussian-smoothed) series over [frame i-1, frame i]; frames
whose interval is not fully covered by the series are dropped.
"""

from __future__ import annotations

import sys

import numpy as np

from pilotguru.cli._common import add_dtype_flag, make_parser, setup_backend


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--frames_json", required=True)
    parser.add_argument("--in_json", required=True)
    parser.add_argument("--json_root_element_name", required=True)
    parser.add_argument("--json_value_name", required=True)
    parser.add_argument("--out_json", required=True)
    parser.add_argument(
        "--smoothing_sigma",
        type=float,
        default=-1.0,
        help="If positive, Gaussian-smooth the series (sigma in seconds) "
        "before annotation.",
    )
    add_dtype_flag(parser)
    args = parser.parse_args(argv)
    dtype = setup_backend(args.dtype)

    from pilotguru.formats import json_io, keys
    from pilotguru.timeseries import annotate_frames_values, smooth_time_series

    frame_ids, frame_times = json_io.read_frames(args.frames_json)
    times, values = json_io.read_timestamped_values(
        args.in_json, args.json_root_element_name, args.json_value_name
    )

    if args.smoothing_sigma > 0:
        # GaussianSmooth uses seconds relative to the series start
        # (time_series.hpp:91-100).
        t_sec = (times - times[0]).astype(np.float64) * 1e-6
        values = np.asarray(
            smooth_time_series(values, t_sec, t_sec, args.smoothing_sigma, dtype=dtype)
        )

    annotations, valid = annotate_frames_values(times, values, frame_times, dtype=dtype)
    annotations = np.asarray(annotations)
    valid = np.asarray(valid)

    events = [
        {keys.FRAME_ID: int(frame_ids[i + 1]), args.json_value_name: float(a)}
        for i, (a, ok) in enumerate(zip(annotations, valid))
        if ok
    ]
    json_io.write_json({args.json_root_element_name: events}, args.out_json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
