"""Generate golden byte-level fixtures for the data CLIs (tests/golden/).

The oracle-diff tests in tests/ check numerics in-process; what they cannot
catch is byte-format drift of the serialized outputs (key order, rounding,
indentation) against the reference's conventions
(/root/reference/src/io/json_converters.cc:137-202 — nlohmann dump(2)-style
files). This script builds one tiny synthetic ride (plus CAN log, trajectory
file, parallax video, and chessboard video), runs every data CLI on it, and
commits both the inputs and the byte-exact expected outputs under
tests/golden/. tests/test_golden.py re-runs each CLI on the committed
inputs and asserts byte equality, so ANY serialization change fails loudly
and must be regenerated deliberately:

    python tools/make_goldens.py

The generator pins the same environment as the test suite (CPU backend,
8 virtual devices, x64) so generated and replayed bytes agree.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ["JAX_PLATFORMS"] = "cpu"

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import jax  # noqa: E402

# The config update forces CPU whatever the environment says (goldens must
# be generated on the exact backend the test suite replays them on).
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

GOLDEN_DIR = os.path.join(REPO, "tests", "golden")
INPUTS = os.path.join(GOLDEN_DIR, "inputs")
EXPECTED = os.path.join(GOLDEN_DIR, "expected")


def golden_cases():
    """Manifest shared by the generator and tests/test_golden.py.

    Returns [(name, main_callable, argv_fn, [output file names])] where
    ``argv_fn(inputs_dir, out_dir)`` builds the CLI argv. Output names are
    relative to ``out_dir``.
    """
    from pilotguru.cli import (
        annotate_frames,
        calibrate,
        fit_motion,
        integrate_motion,
        interpolate_velocity,
        optical_trajectories,
        process_can_frames,
        project_translations,
        smooth_heading_directions,
    )

    return [
        (
            "fit_motion",
            fit_motion.main,
            lambda i, o: [
                f"--rotations_json={i}/ride/rotations.json",
                f"--accelerations_json={i}/ride/accelerations.json",
                f"--locations_json={i}/ride/locations.json",
                f"--velocities_out_json={o}/velocities.json",
                f"--steering_out_json={o}/steering.json",
                f"--forward_axis_out_json={o}/forward_axis.json",
                "--locations_batch_size=20",
                "--locations_shift_step=5",
            ],
            ["velocities.json", "steering.json", "forward_axis.json"],
        ),
        (
            "annotate_frames",
            annotate_frames.main,
            lambda i, o: [
                f"--frames_json={i}/ride/frames.json",
                f"--in_json={i}/ride/locations.json",
                "--json_root_element_name=locations",
                "--json_value_name=speed_m_s",
                f"--out_json={o}/annotated.json",
            ],
            ["annotated.json"],
        ),
        (
            "interpolate_velocity",
            interpolate_velocity.main,
            lambda i, o: [
                f"--locations_json={i}/ride/locations.json",
                f"--frames_json={i}/ride/frames.json",
                f"--out_json={o}/interpolated.json",
                # The reference CHECKs l1+l2 > 0 with both defaulting to 0
                # (interpolate_velocity.cc:21-22,72): weights are always
                # explicit in real invocations.
                "--l1_weight=1.0",
                "--iters=200",
            ],
            ["interpolated.json"],
        ),
        (
            "integrate_motion",
            integrate_motion.main,
            lambda i, o: [
                f"--rotations_json={i}/ride/rotations.json",
                f"--accelerations_json={i}/ride/accelerations.json",
                f"--out_json={o}/integrated.json",
            ],
            ["integrated.json"],
        ),
        (
            "process_can_frames",
            process_can_frames.main,
            lambda i, o: [
                f"--can_frames_json={i}/can.json",
                f"--steering_out_json={o}/can_steering.json",
                f"--velocities_out_json={o}/can_velocities.json",
                "--velocity_scale_can_units_to_m_s=0.01",
            ],
            ["can_steering.json", "can_velocities.json"],
        ),
        (
            "smooth_heading_directions",
            smooth_heading_directions.main,
            lambda i, o: [
                f"--trajectory_in_file={i}/trajectory.json",
                "--sigma=2",
                f"--trajectory_out_file={o}/trajectory_smoothed.json",
            ],
            ["trajectory_smoothed.json"],
        ),
        (
            "project_translations",
            project_translations.main,
            lambda i, o: [
                f"--trajectory_in_file={i}/trajectory.json",
                f"--trajectory_out_file={o}/trajectory_projected.json",
            ],
            ["trajectory_projected.json"],
        ),
        (
            "optical_trajectories",
            optical_trajectories.main,
            lambda i, o: [
                "--vocabulary_file=",
                f"--camera_settings={i}/camera.yaml",
                f"--in_video={i}/video.mp4",
                f"--out_dir={o}/vo",
            ],
            ["vo/trajectory-0000.json"],
        ),
        (
            "calibrate",
            calibrate.main,
            lambda i, o: [
                f"--input={i}/board.mp4",
                "--board_side_width=7",
                "--board_side_height=5",
                "--square_size=0.03",
                f"--out_file={o}/camera_calib.yaml",
            ],
            ["camera_calib.yaml"],
        ),
    ]


def _write_ride(inputs):
    import synthetic

    ride = synthetic.make_ride(
        duration_sec=50.0, imu_hz=50.0, local_bias=(0.05, -0.1, 0.2),
        jitter_seed=7,
    )
    ride_dir = os.path.join(inputs, "ride")
    os.makedirs(ride_dir, exist_ok=True)
    synthetic.write_ride_jsons(ride, ride_dir)


def _write_can(inputs):
    from pilotguru.formats import json_io

    frames = [
        {"time_usec": 1000, "can_frame": "2B0 64 00 00 00 00"},
        {"time_usec": 2000, "can_frame": "4B0 64 00 64 00 64 00 64 00"},
        {"time_usec": 3000, "can_frame": "bogus frame"},
        {"time_usec": 4000, "can_frame": "123 01 02"},
        {"time_usec": 5000, "can_frame": "2B0 C8 00 00 00 00"},
        {"time_usec": 6000, "can_frame": "4B0 C8 00 C8 00 C8 00 C8 00"},
        {"time_usec": 7000, "can_frame": "2B0 FF 7F 00 00 00"},  # invalid angle
    ]
    json_io.write_json({"can_frames": frames}, os.path.join(inputs, "can.json"))


def _write_trajectory(inputs):
    """A curving trajectory with a stored plane: input for the trajectory
    post-processing CLIs."""
    from pilotguru.formats.trajectory import Trajectory, write_trajectory

    n = 60
    t = np.arange(n, dtype=np.float64)
    yaw = 0.04 * t + 0.3 * np.sin(t / 9.0)
    translations = np.stack(
        [np.cumsum(np.cos(yaw)) * 0.1, 0.02 * np.sin(t / 5.0),
         np.cumsum(np.sin(yaw)) * 0.1], axis=1,
    )
    # Rotation about the y axis by yaw (camera optical axis sweeping in the
    # xz plane): q = (cos(yaw/2), 0, sin(yaw/2), 0).
    rotations = np.stack(
        [np.cos(yaw / 2), np.zeros(n), np.sin(yaw / 2), np.zeros(n)], axis=1
    )
    traj = Trajectory(
        time_usec=(1_000_000 + np.arange(n) * 33_000).astype(np.int64),
        frame_id=np.arange(n, dtype=np.int64),
        is_lost=np.zeros(n, bool),
        translations=translations,
        rotations=rotations,
        plane=np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]),
    )
    write_trajectory(traj, os.path.join(inputs, "trajectory.json"))


def _write_video_and_camera(inputs):
    import cv2
    import synthetic

    video = os.path.join(inputs, "video.mp4")
    fx, fy, cx, cy, _ = synthetic.render_parallax_video(video)
    yaml_path = os.path.join(inputs, "camera.yaml")
    fs = cv2.FileStorage(yaml_path, cv2.FILE_STORAGE_WRITE)
    for key, value in [
        ("Camera_fx", fx), ("Camera_fy", fy), ("Camera_cx", cx),
        ("Camera_cy", cy), ("Camera_k1", 0.0), ("Camera_k2", 0.0),
        ("Camera_p1", 0.0), ("Camera_p2", 0.0), ("Camera_fps", 30.0),
        ("ORBextractor_nFeatures", 600), ("ORBextractor_scaleFactor", 1.2),
        ("ORBextractor_nLevels", 3), ("ORBextractor_iniThFAST", 20),
        ("ORBextractor_minThFAST", 7),
    ]:
        fs.write(key, value)
    fs.release()


def _write_board_video(inputs):
    """Chessboard ride through a known pinhole camera (calibrate input)."""
    import cv2

    fx = fy = 300.0
    cx, cy = 160.0, 120.0
    k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    board_w, board_h = 7, 5
    square = 0.03
    rng = np.random.default_rng(0)
    path = os.path.join(inputs, "board.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (320, 240))
    for _ in range(40):
        rvec = rng.normal(scale=0.25, size=3)
        tvec = np.array(
            [rng.uniform(-0.05, 0.05), rng.uniform(-0.04, 0.04),
             rng.uniform(0.35, 0.6)]
        )
        img = np.full((240, 320), 180, np.uint8)
        for y in range(board_h + 1):
            for x in range(board_w + 1):
                if (x + y) % 2:
                    continue
                corners = []
                for dy, dx in ((0, 0), (0, 1), (1, 1), (1, 0)):
                    px = (x + dx) * square
                    py = (y + dy) * square
                    p, _ = cv2.projectPoints(
                        np.array([[px, py, 0.0]]), rvec, tvec, k, None
                    )
                    corners.append(p[0, 0])
                cv2.fillConvexPoly(img, np.asarray(corners, np.int32), 20)
        writer.write(cv2.cvtColor(img, cv2.COLOR_GRAY2BGR))
    writer.release()


def main():
    os.makedirs(INPUTS, exist_ok=True)
    os.makedirs(EXPECTED, exist_ok=True)
    _write_ride(INPUTS)
    _write_can(INPUTS)
    _write_trajectory(INPUTS)
    _write_video_and_camera(INPUTS)
    _write_board_video(INPUTS)

    for name, cli_main, argv_fn, outputs in golden_cases():
        argv = argv_fn(INPUTS, EXPECTED)
        for out in outputs:
            d = os.path.dirname(os.path.join(EXPECTED, out))
            os.makedirs(d, exist_ok=True)
        print(f"[goldens] {name} ...", flush=True)
        rc = cli_main(argv)
        assert rc in (0, None), f"{name} exited {rc}"
        for out in outputs:
            path = os.path.join(EXPECTED, out)
            assert os.path.exists(path), f"{name} did not write {out}"
            print(f"  wrote {out} ({os.path.getsize(path)} bytes)")
    print("[goldens] done")


if __name__ == "__main__":
    main()
