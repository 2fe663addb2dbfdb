"""Full user journey: raw ride recording -> trained steering model -> inference.

One end-to-end test covering the reference's documented workflow
(/root/reference/README.md: record -> preprocess_all -> make_steering_dataset
-> train -> predict_video) as in-process CLI calls:

  1. synthesize a ride (IMU + GPS + frame timestamps) and render a video
     whose pixels encode the true turn rate (a bar whose horizontal
     position tracks yaw rate);
  2. preprocess_all: IMU calibration -> velocities/steering/forward JSONs;
  3. make_steering_dataset: video + annotations -> per-frame npz examples;
  4. train: a 2-net toy ensemble on those examples;
  5. predict_video: run the ensemble over the same video and check the
     predictions track the ground-truth steering signal.
"""

import glob
import json
import os

import numpy as np

from pilotguru.formats import json_io
from synthetic import make_ride, write_ride_jsons
import pytest

# Heavy e2e tier: excluded from the quick loop via `pytest -m "not slow"`.
pytestmark = pytest.mark.slow

HEIGHT, WIDTH = 64, 96
TARGET_HEIGHT, TARGET_WIDTH = 48, 64  # toy net needs >=48px after 3 pools


def _render_steering_video(path, ride, fps):
    """Bar x-position linearly encodes the yaw rate at each frame time."""
    from pilotguru.video.io import VideoWriterRgb

    yaw_rates = ride.yaw_rate_at(ride.frame_times_usec)
    scale = (WIDTH / 2 - 6) / (np.max(np.abs(yaw_rates)) + 1e-9)
    with VideoWriterRgb(path, fps=fps) as writer:
        for rate in yaw_rates:
            frame = np.full((HEIGHT, WIDTH, 3), 32, np.uint8)
            x = int(round(WIDTH / 2 + rate * scale))
            frame[:, max(x - 2, 0) : x + 2, 0] = 255
            frame[:, max(x - 2, 0) : x + 2, 1] = 180
            writer.consume(frame)


def test_record_to_predict_user_journey(tmp_path):
    from pilotguru.cli import (
        make_steering_dataset,
        predict_video,
        preprocess_all,
        train,
    )

    # --- 1. "Record" a ride. -------------------------------------------
    fps = 10.0
    ride = make_ride(
        duration_sec=40.0,
        imu_hz=50.0,
        frame_hz=fps,
        heading_amplitude=0.7,
        heading_period=11.0,
        local_bias=(0.05, -0.1, 0.15),
    )
    ride_dir = str(tmp_path / "ride")
    write_ride_jsons(ride, ride_dir)
    video_path = os.path.join(ride_dir, "video.mp4")
    _render_steering_video(video_path, ride, fps)

    # --- 2. Calibrate. --------------------------------------------------
    assert preprocess_all.main([f"--in_dir={ride_dir}"]) == 0
    post = os.path.join(ride_dir, "postprocessed")
    assert os.path.isfile(os.path.join(post, "velocities-imu.json"))

    # --- 3. Build the dataset. ------------------------------------------
    crop_path = str(tmp_path / "crop.json")
    json_io.write_json({"crop_settings": {}}, crop_path)
    data_dir = str(tmp_path / "dataset")
    assert (
        make_steering_dataset.main(
            [
                f"--in_video={video_path}",
                f"--in_frames_json={os.path.join(ride_dir, 'frames.json')}",
                f"--in_steering_json={os.path.join(post, 'steering-imu.json')}",
                "--steering_source=imu",
                f"--in_velocities_json={os.path.join(post, 'velocities-imu.json')}",
                f"--in_forward_axis_json={os.path.join(post, 'forward.json')}",
                f"--crop_settings_json={crop_path}",
                f"--out_dir={data_dir}",
                "--frames_step=1",
                f"--target_height={TARGET_HEIGHT}",
                f"--target_width={TARGET_WIDTH}",
            ]
        )
        == 0
    )
    examples = sorted(glob.glob(os.path.join(data_dir, "*-data.npz")))
    assert len(examples) > 200, f"only {len(examples)} training examples"
    sample = np.load(examples[0])
    assert sample["frame_img"].shape == (3, TARGET_HEIGHT, TARGET_WIDTH)
    assert sample["steering"].shape == (1,)
    assert sample["forward_axis"].shape == (3,)

    # --- 4. Train a small ensemble. --------------------------------------
    model_dir = str(tmp_path / "models")
    assert (
        train.main(
            [
                f"--data_dirs={data_dir}",
                f"--validation_data_dirs={data_dir}",
                "--batch_size=32",
                "--epochs=10",
                "--optimizer=adam",
                "--learning_rate=3e-3",
                f"--target_height={TARGET_HEIGHT}",
                f"--target_width={TARGET_WIDTH}",
                "--net_name=toy",
                "--num_nets_to_train=2",
                f"--out_dir={model_dir}",
            ]
        )
        == 0
    )
    checkpoints = [
        os.path.join(model_dir, f"model-{i}-best.msgpack") for i in range(2)
    ]
    assert all(os.path.isfile(p) for p in checkpoints)

    # --- 5. Predict over the ride video. ---------------------------------
    settings_path = str(tmp_path / "net_settings.json")
    with open(settings_path, "w") as f:
        json.dump(
            {
                "net_name": "toy",
                "target_height": TARGET_HEIGHT,
                "target_width": TARGET_WIDTH,
            },
            f,
        )
    out_json = str(tmp_path / "predicted-steering.json")
    assert (
        predict_video.main(
            [
                f"--in_video={video_path}",
                f"--forward_axis_json={os.path.join(post, 'forward.json')}",
                f"--net_settings_json={settings_path}",
                f"--in_model_weights={','.join(checkpoints)}",
                f"--out_steering_json={out_json}",
                "--trajectory_frame_update_rate=1.0",
            ]
        )
        == 0
    )

    predictions = json_io.read_json(out_json)["steering"]
    pred_by_frame = {p["frame_id"]: p["steering"] for p in predictions}
    assert len(pred_by_frame) > 300

    # Ground truth in training-label units: yaw_rate / (speed + 1) * 28
    # (make_steering_dataset.steering_labels, IMU source).
    frame_ids = sorted(pred_by_frame)
    times = ride.frame_times_usec[frame_ids]
    truth = (
        ride.yaw_rate_at(times) / (ride.speed_at(times) + 1.0) * 28.0
    )
    pred = np.array([pred_by_frame[i] for i in frame_ids])
    corr = float(np.corrcoef(pred, truth)[0, 1])
    assert corr > 0.8, f"prediction/truth correlation too weak: {corr:.3f}"
