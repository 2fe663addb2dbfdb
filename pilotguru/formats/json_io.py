"""Readers/writers for the pilotguru JSON data formats.

Format-compatible with the reference C++ implementation
(/root/reference/src/io/json_converters.cc). Notes on fidelity:

- The reference serializes with nlohmann::json ``dump(2)`` followed by a
  newline (json_converters.cc:169,181,201). nlohmann stores objects as
  ``std::map`` so keys come out alphabetically sorted; we match with
  ``json.dumps(..., indent=2, sort_keys=True)`` + trailing newline.
- Doubles are printed shortest-round-trip by both nlohmann and Python, so
  numeric text matches for values that round-trip identically; comparisons
  in tests are tolerance-based regardless.
"""

from __future__ import annotations

import json
from typing import Sequence

import numpy as np

from pilotguru.formats import keys


def read_json(filename: str) -> dict:
    """Parse a JSON file (reference: ReadJsonFile, json_converters.cc:172-177)."""
    with open(filename, "r") as f:
        return json.load(f)


def write_json(data: dict, filename: str) -> None:
    """Serialize like the reference WriteJsonFile (json_converters.cc:179-182)."""
    with open(filename, "w") as f:
        f.write(json.dumps(data, indent=2, sort_keys=True, allow_nan=True))
        f.write("\n")


def dumps(data: dict) -> str:
    return json.dumps(data, indent=2, sort_keys=True, allow_nan=True)


def read_timestamped_3d(filename: str, root_element: str):
    """Read a {root: [{x,y,z,time_usec}, ...]} file into arrays.

    Matches ReadTimestamp3DData (/root/reference/src/fit_motion.cc:107-120).

    Returns:
      times_usec: int64 [N]
      values: float64 [N, 3] with columns (x, y, z)
    """
    root = read_json(filename)
    entries = root[root_element]
    if not entries:
        raise ValueError(f"empty '{root_element}' list in {filename}")
    times = np.asarray([e[keys.TIME_USEC] for e in entries], dtype=np.int64)
    values = np.asarray(
        [[e[keys.X], e[keys.Y], e[keys.Z]] for e in entries], dtype=np.float64
    )
    return times, values


def read_gps_velocities(filename: str):
    """Read locations.json into (times_usec[int64 N], speeds_m_s[float64 N]).

    Matches ReadGpsVelocities (/root/reference/src/fit_motion.cc:122-134):
    only ``speed_m_s`` and ``time_usec`` fields are consumed.
    """
    root = read_json(filename)
    locations = root[keys.LOCATIONS]
    if not locations:
        raise ValueError(f"empty '{keys.LOCATIONS}' list in {filename}")
    times = np.asarray([e[keys.TIME_USEC] for e in locations], dtype=np.int64)
    speeds = np.asarray([e[keys.SPEED_M_S] for e in locations], dtype=np.float64)
    return times, speeds


def read_timestamped_values(filename: str, root_element: str, value_name: str):
    """Read a scalar time series {root: [{time_usec, <value_name>}, ...]}.

    Matches RealTimeSeries JSON ingestion
    (/root/reference/include/interpolation/time_series.hpp:244-265).
    """
    root = read_json(filename)
    entries = root[root_element]
    times = np.asarray([e[keys.TIME_USEC] for e in entries], dtype=np.int64)
    values = np.asarray([e[value_name] for e in entries], dtype=np.float64)
    return times, values


def write_timestamped_values(
    times_usec: Sequence[int],
    values: Sequence[float],
    filename: str,
    root_element: str,
    value_name: str,
) -> None:
    """Write {root: [{time_usec, <value_name>}, ...]}.

    Matches JsonWriteTimestampedRealData
    (/root/reference/src/io/json_converters.cc:184-202).
    """
    times_usec = np.asarray(times_usec)
    values = np.asarray(values)
    if times_usec.shape[0] != values.shape[0]:
        raise ValueError("times and values length mismatch")
    events = [
        {keys.TIME_USEC: int(t), value_name: float(v)}
        for t, v in zip(times_usec, values)
    ]
    write_json({root_element: events}, filename)


def read_frames(filename: str):
    """Read frames.json into (frame_ids[int64], times_usec[int64]).

    The recorder's frames.json has entries {frame_id, time_usec}
    (reference consumers: src/annotate_frames.cc:57-66).
    """
    root = read_json(filename)
    frames = root[keys.FRAMES]
    ids = np.asarray([e[keys.FRAME_ID] for e in frames], dtype=np.int64)
    times = np.asarray([e[keys.TIME_USEC] for e in frames], dtype=np.int64)
    return ids, times


def write_forward_axis(axis, filename: str) -> None:
    """Write {"forward_axis": {x,y,z}} (reference: fit_motion.cc:285-292)."""
    axis = np.asarray(axis, dtype=np.float64)
    write_json(
        {
            keys.FORWARD_AXIS: {
                keys.X: float(axis[0]),
                keys.Y: float(axis[1]),
                keys.Z: float(axis[2]),
            }
        },
        filename,
    )


def read_forward_axis(filename: str) -> np.ndarray:
    root = read_json(filename)
    ax = root[keys.FORWARD_AXIS]
    return np.asarray([ax[keys.X], ax[keys.Y], ax[keys.Z]], dtype=np.float64)
