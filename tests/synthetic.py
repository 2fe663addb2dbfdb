"""Synthetic ride generator: physically consistent IMU + GPS + frames data.

Produces the recorder's data model (rotations / accelerations / locations /
frames arrays and JSON files) from an analytic planar trajectory, with known
ground truth for every quantity fit_motion infers:

  - vertical axis  = device z (rotations are pure yaw)
  - forward axis   = device x (vehicle frame, velocity is s(t) * x_dev)
  - steering       = yaw rate omega(t)
  - speed          = s(t)

The device frame coincides with the vehicle frame and with the world frame
at t = 0. The accelerometer measures specific force in the device frame:
a_meas = R(t)^T (a_world - g_world) - local_bias, so a strapdown chain with
global bias = +g_world and local bias = +local_bias reproduces a_world,
matching the reference's bias model (velocity.cc:36-46, geometry.cc:35-46).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Ride:
    rot_times_usec: np.ndarray
    rot_rates: np.ndarray  # [N, 3]
    acc_times_usec: np.ndarray
    accelerations: np.ndarray  # [M, 3]
    gps_times_usec: np.ndarray
    gps_speeds: np.ndarray
    frame_times_usec: np.ndarray
    # Ground truth.
    true_local_bias: np.ndarray
    true_gravity_world: np.ndarray

    def speed_at(self, times_usec):
        return self._speed((np.asarray(times_usec) - self.t0_usec) * 1e-6)

    def yaw_rate_at(self, times_usec):
        return self._yaw_rate((np.asarray(times_usec) - self.t0_usec) * 1e-6)

    t0_usec: int = 0
    _speed: object = None
    _yaw_rate: object = None


def make_ride(
    duration_sec: float = 120.0,
    imu_hz: float = 100.0,
    gps_hz: float = 1.0,
    frame_hz: float = 30.0,
    base_speed: float = 9.0,
    speed_amplitude: float = 3.0,
    speed_period: float = 37.0,
    heading_amplitude: float = 0.6,
    heading_period: float = 23.0,
    local_bias=(0.0, 0.0, 0.0),
    gravity: float = 9.81,
    t0_usec: int = 1_000_000,
    jitter_seed: int | None = None,
) -> Ride:
    lb = np.asarray(local_bias, np.float64)
    g_world = np.array([0.0, 0.0, -gravity])

    def speed(t):
        return base_speed + speed_amplitude * np.sin(2 * np.pi * t / speed_period)

    def dspeed(t):
        return (
            speed_amplitude * (2 * np.pi / speed_period)
            * np.cos(2 * np.pi * t / speed_period)
        )

    def heading(t):
        return heading_amplitude * np.sin(2 * np.pi * t / heading_period)

    def yaw_rate(t):
        return (
            heading_amplitude * (2 * np.pi / heading_period)
            * np.cos(2 * np.pi * t / heading_period)
        )

    def dyaw_rate(t):
        return (
            -heading_amplitude * (2 * np.pi / heading_period) ** 2
            * np.sin(2 * np.pi * t / heading_period)
        )

    def accel_world(t):
        s, ds, th, w = speed(t), dspeed(t), heading(t), yaw_rate(t)
        ax = ds * np.cos(th) - s * np.sin(th) * w
        ay = ds * np.sin(th) + s * np.cos(th) * w
        return np.stack([ax, ay, np.zeros_like(t)], axis=-1)

    rng = np.random.default_rng(jitter_seed) if jitter_seed is not None else None

    def grid(hz, phase_usec):
        n = int(duration_sec * hz)
        t = t0_usec + phase_usec + (np.arange(n) * (1e6 / hz)).astype(np.int64)
        if rng is not None:
            t = t + rng.integers(0, max(int(1e5 / hz), 1), size=n)
            t = np.unique(t)
        return t

    rot_t = grid(imu_hz, 0)
    acc_t = grid(imu_hz, int(0.3 * 1e6 / imu_hz))  # offset grids exercise merge
    gps_t = grid(gps_hz, 137)
    frame_t = grid(frame_hz, 977)

    def t_sec(t_usec):
        return (t_usec - t0_usec) * 1e-6

    # Gyro: pure yaw in the device frame (device z == world z).
    rot_rates = np.zeros((rot_t.shape[0], 3))
    rot_rates[:, 2] = yaw_rate(t_sec(rot_t))

    # Accelerometer: specific force rotated into the device frame.
    ta = t_sec(acc_t)
    th = heading(ta)
    a_w = accel_world(ta) - g_world[None, :]
    cos_t, sin_t = np.cos(th), np.sin(th)
    a_dev = np.stack(
        [
            cos_t * a_w[:, 0] + sin_t * a_w[:, 1],
            -sin_t * a_w[:, 0] + cos_t * a_w[:, 1],
            a_w[:, 2],
        ],
        axis=-1,
    ) - lb[None, :]

    ride = Ride(
        rot_times_usec=rot_t,
        rot_rates=rot_rates,
        acc_times_usec=acc_t,
        accelerations=a_dev,
        gps_times_usec=gps_t,
        gps_speeds=speed(t_sec(gps_t)),
        frame_times_usec=frame_t,
        true_local_bias=lb,
        # Solver-convention global bias: a_world = R(a_meas + b_l) + b_g with
        # a_meas = R^T(a_world - g_world) - b_l  =>  b_g == g_world.
        true_gravity_world=g_world,
        t0_usec=t0_usec,
    )
    ride._speed = speed
    ride._yaw_rate = yaw_rate
    return ride


def write_ride_jsons(ride: Ride, out_dir: str):
    """Write recorder-format rotations/accelerations/locations/frames JSONs."""
    import os

    from pilotguru.formats import json_io, keys

    os.makedirs(out_dir, exist_ok=True)

    def xyz_events(times, vals):
        return [
            {
                keys.TIME_USEC: int(t),
                keys.X: float(v[0]),
                keys.Y: float(v[1]),
                keys.Z: float(v[2]),
            }
            for t, v in zip(times, vals)
        ]

    json_io.write_json(
        {keys.ROTATIONS: xyz_events(ride.rot_times_usec, ride.rot_rates)},
        os.path.join(out_dir, "rotations.json"),
    )
    json_io.write_json(
        {keys.ACCELERATIONS: xyz_events(ride.acc_times_usec, ride.accelerations)},
        os.path.join(out_dir, "accelerations.json"),
    )
    json_io.write_json(
        {
            keys.LOCATIONS: [
                {keys.TIME_USEC: int(t), keys.SPEED_M_S: float(s)}
                for t, s in zip(ride.gps_times_usec, ride.gps_speeds)
            ]
        },
        os.path.join(out_dir, "locations.json"),
    )
    json_io.write_json(
        {
            keys.FRAMES: [
                {keys.FRAME_ID: int(i), keys.TIME_USEC: int(t)}
                for i, t in enumerate(ride.frame_times_usec)
            ]
        },
        os.path.join(out_dir, "frames.json"),
    )
    return out_dir


def parallax_frames(
    width: int = 320,
    height: int = 240,
    frames: int = 120,
    num_points: int = 400,
    fx: float = 250.0,
    seed: int = 7,
    dot_scale: float = 7.0 / 250.0,
    period_frames: float = 0.0,
    distortion: tuple = (0.0, 0.0, 0.0, 0.0),
    forward_speed: float = 0.015,
    corridor: bool = False,
):
    """Draw a curving drive through random textured billboards, in numpy.

    Yields ``frames`` grayscale uint8 [height, width] images. The camera
    follows a planar curving path (so the PCA flatness test accepts the
    trajectory), with yaw following the path direction. ``distortion`` =
    (k1, k2, p1, p2) applies the OpenCV radial/tangential lens model to the
    projection, so the tracker's keypoint undistortion path is exercised
    end to end. Camera intrinsics: (fx, fx, width / 2, height / 2); the
    analytic yaw rate is ``parallax_yaw_rates``.
    """
    k1, k2, p1, p2 = distortion
    rng = np.random.default_rng(seed)
    cx, cy = width / 2.0, height / 2.0
    if corridor:
        # Long-drive mode: strew billboards along the WHOLE path so the
        # scenery continuously turns over (old points leave the frustum,
        # fresh ones appear) — the map-pressure regime of a multi-minute
        # ride, which a fixed 12-unit-deep cloud never reaches. Density is
        # kept at num_points per 12 z-units of corridor.
        depth = forward_speed * frames + 18.0
        n = max(int(num_points * depth / 12.0), num_points)
        pts = np.stack(
            [rng.uniform(-8, 8, n), rng.uniform(-4, 4, n),
             rng.uniform(-2, depth, n)],
            axis=1,
        )
        shade = rng.integers(90, 255, n)
    else:
        pts = np.stack(
            [rng.uniform(-8, 8, num_points), rng.uniform(-4, 4, num_points),
             rng.uniform(4, 16, num_points)],
            axis=1,
        )
        shade = rng.integers(90, 255, num_points)
    period = _yaw_period(frames, period_frames)
    for t in range(frames):
        cam_t = np.array(
            [0.9 * np.sin(2 * np.pi * t / period), 0.0, forward_speed * t]
        )
        yaw = _yaw_of(t, period)
        c, s = np.cos(yaw), np.sin(yaw)
        rot = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
        local = (pts - cam_t) @ rot.T
        sh = shade
        if corridor:
            # Cull beyond the 16-unit visibility window of the non-corridor
            # cloud (plus margin): keeps per-frame draw cost flat and the
            # feature field statistically identical to the short-ride mode.
            keep = (local[:, 2] > 0.4) & (local[:, 2] < 18.0)
            local, sh = local[keep], shade[keep]
        img = np.full((height, width), 25, np.uint8)
        for i in np.argsort(-local[:, 2]):
            x, y, z = local[i]
            if z < 0.5:
                continue
            xn, yn = x / z, y / z
            if k1 or k2 or p1 or p2:
                r2 = xn * xn + yn * yn
                radial = 1.0 + k1 * r2 + k2 * r2 * r2
                xn, yn = (
                    xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn),
                    yn * radial + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn,
                )
            u, v = fx * xn + cx, fx * yn + cy
            # Billboard size scales with focal length so the rendered
            # texture has comparable pixel footprint at any resolution.
            r = max(int(round(dot_scale * fx / z)), 1)
            if -r <= u < width + r and -r <= v < height + r:
                fill_square(img, int(u), int(v), r, sh[i])
        yield img


def fill_square(img: np.ndarray, x: int, y: int, r: int, value) -> None:
    """Fill [x - r, x + r] x [y - r, y + r], corners inclusive, clipped to
    the image: the pixels of a filled ``cv2.rectangle``."""
    rows = slice(max(y - r, 0), max(y + r + 1, 0))
    cols = slice(max(x - r, 0), max(x + r + 1, 0))
    img[rows, cols] = value


def _yaw_period(frames: int, period_frames: float) -> float:
    # Lateral-swing period: any tracked SEGMENT must see a full 2-D sweep,
    # or the trajectory-plane test (lambda3 > 1e-2 * lambda2,
    # track_image_sequence.cc:85-92) rejects the near-collinear stretch.
    return period_frames or 1.25 * frames


def _yaw_of(t, period: float):
    return 0.25 * np.cos(2 * np.pi * t / period)


def parallax_yaw_rates(frames: int, period_frames: float = 0.0) -> np.ndarray:
    """Analytic camera yaw rate of ``parallax_frames``, rad/s at 30 fps."""
    period = _yaw_period(frames, period_frames)
    return np.gradient(_yaw_of(np.arange(frames), period)) * 30.0


def render_parallax_video(path: str, **kwargs):
    """Write ``parallax_frames(**kwargs)`` to an mp4v video at 30 fps.

    Returns (fx, fy, cx, cy, true_yaw_rate_per_frame).
    """
    import cv2

    width = kwargs.get("width", 320)
    height = kwargs.get("height", 240)
    frames = kwargs.get("frames", 120)
    fx = kwargs.get("fx", 250.0)
    writer = cv2.VideoWriter(
        path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (width, height)
    )
    for img in parallax_frames(**kwargs):
        writer.write(cv2.cvtColor(img, cv2.COLOR_GRAY2BGR))
    writer.release()
    rates = parallax_yaw_rates(frames, kwargs.get("period_frames", 0.0))
    return fx, fx, width / 2.0, height / 2.0, rates
