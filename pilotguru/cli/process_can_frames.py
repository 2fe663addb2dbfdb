"""process_can_frames CLI: Kia CAN log -> steering-angle + velocity JSONs.

Flag- and format-compatible with the reference binary
(/root/reference/src/process_can_frames.cc): 0x2B0 frames become
{steering: [{time_usec, steering_angle_degrees}]}, 0x4B0 frames become
{velocities: [{time_usec, speed_m_s}]} with the configurable CAN-unit
scale. Malformed frames are skipped with a warning, like the reference.
"""

from __future__ import annotations

import sys

from pilotguru.cli._common import make_parser


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--can_frames_json", required=True)
    parser.add_argument("--steering_out_json", required=True)
    parser.add_argument("--velocities_out_json", required=True)
    parser.add_argument(
        "--velocity_scale_can_units_to_m_s", type=float, default=1.0
    )
    args = parser.parse_args(argv)
    if args.velocity_scale_can_units_to_m_s <= 0:
        parser.error("--velocity_scale_can_units_to_m_s must be positive")

    from pilotguru.formats import can, json_io, keys

    root = json_io.read_json(args.can_frames_json)
    steering_events = []
    velocity_events = []
    for entry in root[keys.CAN_FRAMES]:
        parsed = can.try_parse_can_frame(entry[keys.CAN_FRAME])
        if parsed is None:
            print(f"Invalid CAN frame text: [{entry}].", file=sys.stderr)
            continue
        can_id, payload = parsed
        if can_id == can.STEERING_WHEEL_ANGLE_CAN_ID:
            degrees = can.parse_steering_angle_degrees(payload)
            if degrees is None:
                continue
            steering_events.append(
                {
                    keys.TIME_USEC: entry[keys.TIME_USEC],
                    keys.STEERING_ANGLE_DEGREES: degrees,
                }
            )
        elif can_id == can.VELOCITY_CAN_ID:
            speed = can.parse_average_wheel_speed(payload)
            if speed is None:
                continue
            velocity_events.append(
                {
                    keys.TIME_USEC: entry[keys.TIME_USEC],
                    keys.SPEED_M_S: float(speed)
                    * args.velocity_scale_can_units_to_m_s,
                }
            )

    json_io.write_json({keys.STEERING: steering_events}, args.steering_out_json)
    json_io.write_json(
        {keys.VELOCITIES: velocity_events}, args.velocities_out_json
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
