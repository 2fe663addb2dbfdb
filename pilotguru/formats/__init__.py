from pilotguru.formats import keys  # noqa: F401
from pilotguru.formats.json_io import (  # noqa: F401
    dumps,
    read_forward_axis,
    read_frames,
    read_gps_velocities,
    read_json,
    read_timestamped_3d,
    read_timestamped_values,
    write_forward_axis,
    write_json,
    write_timestamped_values,
)
