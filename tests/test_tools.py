"""Tests for the postprocessing/rendering/dataset/inference tool CLIs."""

import glob
import json
import os

import numpy as np
import pytest

from pilotguru.formats import can as can_lib
from pilotguru.formats import json_io

# Heavy e2e tier: excluded from the quick loop via `pytest -m "not slow"`.
pytestmark = pytest.mark.slow


class TestCanParsing:
    def test_parse_frame_round_trip(self):
        parsed = can_lib.try_parse_can_frame("2B0 01 02 03 04 05")
        assert parsed is not None
        can_id, payload = parsed
        assert can_id == 0x2B0
        assert payload == bytes([1, 2, 3, 4, 5])

    def test_trailing_space_ok(self):
        assert can_lib.try_parse_can_frame("4B0 01 02 ") is not None

    @pytest.mark.parametrize(
        "text",
        ["xyz 01", "2B0  01", "2B0 1", "2B0 011 22",
         "2B0 01 02 03 04 05 06 07 08 09"],
    )
    def test_malformed_frames_rejected(self, text):
        assert can_lib.try_parse_can_frame(text) is None

    def test_int16_little_endian_signed(self):
        assert can_lib.parse_can_int16(bytes([0x34, 0x12])) == 0x1234
        assert can_lib.parse_can_int16(bytes([0xFF, 0xFF])) == -1

    def test_integer_average_truncated_mean(self):
        # Truncated integer mean (the reference's evident intent; its
        # as-written remainder accumulation is a bug, see can.py docstring).
        assert can_lib.integer_average_int16([1, 1, 1, 1]) == 1
        assert can_lib.integer_average_int16([1, 2, 3, 4]) == 2
        assert can_lib.integer_average_int16([-1, -2, -3, -4]) == -2
        assert can_lib.integer_average_int16([32000, 32000, 32000, 32000]) == 32000
        assert can_lib.integer_average_int16([3, 3, 3, 4]) == 3

    def test_steering_degrees(self):
        payload = bytes([0x0A, 0x00, 0, 0, 0])  # 10 deci-degrees
        assert can_lib.parse_steering_angle_degrees(payload) == 1.0
        assert can_lib.parse_steering_angle_degrees(bytes(4)) is None


class TestProcessCanFramesCli:
    def test_end_to_end(self, tmp_path):
        from pilotguru.cli.process_can_frames import main

        frames = [
            {"time_usec": 1000, "can_frame": "2B0 64 00 00 00 00"},  # 10 deg
            {"time_usec": 2000, "can_frame": "4B0 64 00 64 00 64 00 64 00"},
            {"time_usec": 3000, "can_frame": "bogus frame"},
            {"time_usec": 4000, "can_frame": "123 01 02"},  # unknown id
            {"time_usec": 5000, "can_frame": "2B0 C8 00 00 00 00"},  # 20 deg
        ]
        json_io.write_json({"can_frames": frames}, str(tmp_path / "can.json"))
        rc = main(
            [
                f"--can_frames_json={tmp_path}/can.json",
                f"--steering_out_json={tmp_path}/steering.json",
                f"--velocities_out_json={tmp_path}/velocities.json",
                "--velocity_scale_can_units_to_m_s=0.01",
            ]
        )
        assert rc == 0
        steering = json_io.read_json(f"{tmp_path}/steering.json")["steering"]
        assert [s["steering_angle_degrees"] for s in steering] == [10.0, 20.0]
        velocities = json_io.read_json(f"{tmp_path}/velocities.json")["velocities"]
        assert velocities == [{"speed_m_s": 1.0, "time_usec": 2000}]


@pytest.fixture(scope="module")
def tiny_video(tmp_path_factory):
    import cv2

    d = tmp_path_factory.mktemp("video")
    path = str(d / "tiny.mp4")
    rng = np.random.default_rng(0)
    writer = cv2.VideoWriter(
        path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 48)
    )
    frames = rng.integers(0, 255, size=(20, 48, 64, 3), dtype=np.uint8)
    for f in frames:
        writer.write(f)
    writer.release()
    return path, frames


class TestRenderClis:
    def test_render_frame_numbers(self, tiny_video, tmp_path):
        from pilotguru.cli.render_frame_numbers import main
        from pilotguru.video.io import read_video_rgb

        path, _ = tiny_video
        out = str(tmp_path / "numbered.mp4")
        rc = main(
            [
                f"--in_video={path}",
                f"--out_video={out}",
                "--frames_to_skip=2",
                "--max_out_frames=5",
                "--output_every_n_frames=2",
            ]
        )
        assert rc == 0
        frames = list(read_video_rgb(out))
        assert len(frames) == 5

    def test_render_motion(self, tiny_video, tmp_path):
        import cv2

        from pilotguru.cli.render_motion import main
        from pilotguru.video.io import read_video_rgb

        path, _ = tiny_video
        wheel = np.zeros((24, 24, 3), np.uint8)
        cv2.circle(wheel, (12, 12), 10, (0, 255, 0), 2)
        cv2.imwrite(str(tmp_path / "wheel.png"), wheel)
        json_io.write_json(
            {
                "steering": [
                    {"frame_id": i, "steering": 0.5 * i} for i in range(20)
                ]
            },
            str(tmp_path / "steering.json"),
        )
        json_io.write_json(
            {
                "velocities": [
                    {"frame_id": i, "speed_m_s": 5.0 + i} for i in range(20)
                ]
            },
            str(tmp_path / "velocities.json"),
        )
        out = str(tmp_path / "motion.mp4")
        rc = main(
            [
                f"--in_video={path}",
                f"--steering_left_json={tmp_path}/steering.json",
                f"--velocities_json_left={tmp_path}/velocities.json",
                f"--steering_wheel={tmp_path}/wheel.png",
                f"--out_video={out}",
                "--max_out_frames=10",
            ]
        )
        assert rc == 0
        frames = list(read_video_rgb(out))
        assert len(frames) == 10
        # Output is taller than input (wheel panel below) and wide enough
        # for 4 wheel tiles.
        assert frames[0][1].shape[0] == 48 + 24
        assert frames[0][1].shape[1] >= 4 * 24


class TestMakeSteeringDataset:
    def test_end_to_end(self, tiny_video, tmp_path):
        from pilotguru.cli.make_steering_dataset import main

        video_path, _ = tiny_video
        # Frames at 30 fps; steering + velocity series covering them.
        frame_times = [int(1e6 + i * 33333) for i in range(20)]
        json_io.write_json(
            {
                "frames": [
                    {"frame_id": i, "time_usec": t}
                    for i, t in enumerate(frame_times)
                ]
            },
            str(tmp_path / "frames.json"),
        )
        series_t = np.arange(900_000, 1_800_000, 5_000, dtype=np.int64)
        json_io.write_timestamped_values(
            series_t,
            0.1 * np.sin(series_t * 1e-5),
            str(tmp_path / "steering.json"),
            "steering",
            "angular_velocity",
        )
        json_io.write_timestamped_values(
            series_t,
            np.full(series_t.size, 8.0),
            str(tmp_path / "velocities.json"),
            "velocities",
            "speed_m_s",
        )
        json_io.write_forward_axis([1.0, 0, 0], str(tmp_path / "forward.json"))
        json_io.write_json(
            {"crop_settings": {"crop_top": 8, "crop_bottom": 4}},
            str(tmp_path / "crop.json"),
        )
        out = tmp_path / "out"
        rc = main(
            [
                f"--in_video={video_path}",
                f"--in_frames_json={tmp_path}/frames.json",
                f"--in_steering_json={tmp_path}/steering.json",
                "--steering_source=imu",
                f"--in_velocities_json={tmp_path}/velocities.json",
                f"--in_forward_axis_json={tmp_path}/forward.json",
                f"--crop_settings_json={tmp_path}/crop.json",
                f"--out_dir={out}",
                "--frames_step=2",
                "--target_height=36",
                "--target_width=64",
                "--label_lookahead_frames=0,2",
            ]
        )
        assert rc == 0
        files = sorted(glob.glob(str(out / "frame-*-data.npz")))
        assert len(files) >= 3
        data = np.load(files[0])
        assert data["frame_img"].shape == (3, 36, 64)
        assert data["frame_img"].dtype == np.uint8
        assert data["steering"].shape == (2,)  # two lookaheads
        np.testing.assert_allclose(data["forward_axis"], [1, 0, 0])
        # IMU normalization: angular_velocity/(v+1)*28 with v=8.
        assert np.all(np.abs(data["steering"]) < 0.1 / 9.0 * 28.0 * 1.5)
        assert glob.glob(str(out / "frame-*-img.png"))


class TestPredictClis:
    @pytest.fixture(scope="class")
    def trained(self, tmp_path_factory):
        """Train a tiny toy net and return (settings_json, weights_paths)."""
        import jax

        from pilotguru.ml import augmentation as aug
        from pilotguru.ml import data as data_lib
        from pilotguru.ml import models, training, weighting

        d = tmp_path_factory.mktemp("trained")
        rng = np.random.default_rng(0)
        images = rng.integers(0, 255, size=(32, 36, 64, 3), dtype=np.uint8)
        steering = rng.normal(size=(32, 1)).astype(np.float32)
        axis = np.tile(np.float32([1, 0, 0]), (32, 1))
        dataset = {
            models.FRAME_IMG: images,
            models.STEERING: steering,
            models.FORWARD_AXIS: axis,
        }
        options = {
            models.NET_NAME: "toy",
            models.NET_HEAD_DIMS: 10,
            models.LABEL_DIMENSIONS: 1,
            models.DROPOUT_PROB: 0.0,
            models.LAYER_BLOCKS_OPTIONS: models.DEFAULT_LAYER_BLOCKS_OPTIONS,
        }
        bias = [{"input_name": models.FORWARD_AXIS, "input_dims": 3}]
        model = models.make_network(options, bias)
        settings = training.TrainSettings(
            epochs=1, batch_size=16, augment=aug.AugmentSettings(target_width=64)
        )
        tx = training.make_optimizer(settings.optimizer, settings.learning_rate)
        example = {
            models.FRAME_IMG: np.zeros((1, 36, 64, 3), np.float32),
            models.FORWARD_AXIS: np.zeros((1, 3), np.float32),
        }
        state = training.init_ensemble(model, example, 2, tx)
        training.train_models(
            model, state, tx, dataset, dataset,
            input_names=[models.FRAME_IMG, models.FORWARD_AXIS],
            label_name=models.STEERING,
            weighters=[weighting.UniformWeighter() for _ in range(2)],
            settings=settings, out_dir=str(d), print_log=False,
        )
        net_settings = {
            "net_name": "toy",
            "net_head_dims": 10,
            "label_dimensions": 1,
            "dropout_prob": 0.0,
            "target_height": 36,
            "target_width": 64,
            "linear_bias_options": bias,
        }
        settings_path = str(d / "settings.json")
        json_io.write_json(net_settings, settings_path)
        weights = [
            data_lib.model_file_name(str(d), i, data_lib.LAST) for i in (0, 1)
        ]
        json_io.write_forward_axis([1.0, 0, 0], str(d / "forward.json"))
        return settings_path, weights, str(d / "forward.json")

    def test_predict_video(self, trained, tiny_video, tmp_path):
        from pilotguru.cli.predict_video import main

        settings_path, weights, forward = trained
        video_path, _ = tiny_video
        out = str(tmp_path / "predicted.json")
        rc = main(
            [
                f"--in_video={video_path}",
                f"--forward_axis_json={forward}",
                f"--net_settings_json={settings_path}",
                f"--in_model_weights={','.join(weights)}",
                f"--out_steering_json={out}",
                "--crop_top=12",
                "--trajectory_frame_update_rate=0.5",
            ]
        )
        assert rc == 0
        steering = json_io.read_json(out)["steering"]
        assert len(steering) == 20
        assert all(np.isfinite(s["steering"]) for s in steering)

    def test_predict_live_over_zmq(self, trained, tiny_video, tmp_path):
        import threading

        import zmq

        from pilotguru.cli.predict_live import main

        settings_path, weights, forward = trained
        video_path, _ = tiny_video
        socket_addr = f"ipc://{tmp_path}/steering-predict"

        received = []

        def subscriber():
            ctx = zmq.Context()
            sub = ctx.socket(zmq.SUB)
            sub.setsockopt(zmq.SUBSCRIBE, b"")
            sub.setsockopt(zmq.RCVTIMEO, 15000)
            sub.connect(socket_addr)
            try:
                while len(received) < 3:
                    received.append(sub.recv_json())
            except zmq.Again:
                pass
            sub.close()
            ctx.term()

        thread = threading.Thread(target=subscriber, daemon=True)
        # Publisher binds in main(); start subscriber shortly after.
        timer = threading.Timer(1.0, thread.start)
        timer.start()
        rc = main(
            [
                f"--in_video_file={video_path}",
                f"--forward_axis_json={forward}",
                f"--net_settings_json={settings_path}",
                f"--in_model_weights={','.join(weights)}",
                f"--steering_prediction_socket={socket_addr}",
                "--crop_top=12",
                "--delay_max_fps=10",
                "--max_frames=20",
            ]
        )
        thread.join(timeout=20)
        assert rc == 0
        assert received, "no ZMQ messages received"
        assert all("s" in m and np.isfinite(m["s"]) for m in received)


class TestPixelImportance:
    def test_saliency_video(self, tiny_video, tmp_path, request):
        from pilotguru.cli.render_input_pixel_importance import main
        from pilotguru.video.io import read_video_rgb

        settings_path, weights, forward = request.getfixturevalue("trained")
        video_path, _ = tiny_video
        out = str(tmp_path / "saliency.mp4")
        rc = main(
            [
                f"--in_video={video_path}",
                f"--out_video={out}",
                f"--forward_axis_json={forward}",
                f"--net_settings_json={settings_path}",
                f"--in_model_weights={weights[0]}",
                "--crop_top=12",
                "--batch_size=4",
                "--max_out_frames=8",
            ]
        )
        assert rc == 0
        frames = list(read_video_rgb(out))
        assert len(frames) == 8
        # Output keeps the crop size (input 48 - 12 top crop).
        assert frames[0][1].shape[:2] == (36, 64)

    # Reuse the trained-models fixture from TestPredictClis.
    trained = TestPredictClis.trained


class TestSmallWrappers:
    def test_make_linear_adjusted_label_shift(self, capsys):
        from pilotguru.cli.make_linear_adjusted_label_shift import main

        main(["--start_value=0.0", "--end_value=1.0", "--dims=4"])
        out = capsys.readouterr().out.strip()
        np.testing.assert_allclose(
            [float(x) for x in out.split(",")], [0.0, 0.25, 0.5, 0.75]
        )

    def test_preprocess_all(self, tmp_path):
        import synthetic

        from pilotguru.cli.preprocess_all import main

        ride = synthetic.make_ride(duration_sec=30.0, imu_hz=30.0, jitter_seed=5)
        in_dir = tmp_path / "ride"
        synthetic.write_ride_jsons(ride, str(in_dir))
        rc = main([f"--in_dir={in_dir}"])
        assert rc == 0
        out_dir = in_dir / "postprocessed"
        for name in ("velocities-imu.json", "steering-imu.json", "forward.json"):
            assert (out_dir / name).exists(), name


class TestCalibrateCli:
    def test_chessboard_video_calibration(self, tmp_path):
        import cv2

        from pilotguru.cli.calibrate import main
        from pilotguru.vo.camera import read_camera_settings

        # Render a synthetic chessboard through a known pinhole camera.
        fx = fy = 300.0
        cx, cy = 160.0, 120.0
        k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
        board_w, board_h = 7, 5
        square = 0.03
        objp = np.array(
            [
                [x * square, y * square, 0.0]
                for y in range(board_h + 1)
                for x in range(board_w + 1)
            ],
            np.float64,
        )
        rng = np.random.default_rng(0)
        path = str(tmp_path / "board.mp4")
        writer = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (320, 240)
        )
        for _ in range(40):
            rvec = rng.normal(scale=0.25, size=3)
            tvec = np.array(
                [rng.uniform(-0.05, 0.05), rng.uniform(-0.04, 0.04),
                 rng.uniform(0.35, 0.6)]
            )
            proj, _ = cv2.projectPoints(objp, rvec, tvec, k, None)
            proj = proj[:, 0, :]
            img = np.full((240, 320), 180, np.uint8)
            # Draw the checker squares as filled quads.
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
                    cv2.fillConvexPoly(
                        img, np.asarray(corners, np.int32), 20
                    )
            writer.write(cv2.cvtColor(img, cv2.COLOR_GRAY2BGR))
        writer.release()

        out = str(tmp_path / "camera.yml")
        rc = main(
            [
                f"--input={path}",
                "--board_side_width=7",
                "--board_side_height=5",
                "--square_size=0.03",
                "--frames_to_use=15",
                f"--out_file={out}",
            ]
        )
        assert rc == 0
        settings = read_camera_settings(out)
        assert abs(settings.fx - fx) / fx < 0.1
        assert abs(settings.fy - fy) / fy < 0.1


class TestHyperparamsSearch:
    def test_grid_over_settings_files(self, tmp_path):
        """Each settings JSON trains its own fold into out_dir/<settings_id>
        (reference python/hyperparams_search.py semantics, sequential on one
        chip)."""
        import json

        from pilotguru.cli import hyperparams_search

        rng = np.random.default_rng(1)
        data_dir = tmp_path / "data"
        data_dir.mkdir()
        for i in range(48):
            img = rng.integers(0, 255, size=(3, 36, 80), dtype=np.uint8)
            steering = np.float32(
                [img[:, :, :40].mean() - img[:, :, 40:].mean()]
            ) / 8.0
            np.savez(
                data_dir / f"frame-{i:06d}-data.npz",
                frame_img=img,
                steering=steering.astype(np.float32),
                forward_axis=np.array([1.0, 0.0, 0.0], np.float32),
            )

        base = {
            "input_names": ["frame_img", "forward_axis"],
            "label_names": ["steering"],
            "net_name": "toy",
            "target_height": 36,
            "target_width": 72,
            "batch_size": 16,
            "linear_bias_options": [
                {"input_name": "forward_axis", "input_dims": 3}
            ],
        }
        for sid, lr in (("fold-a", 3e-3), ("fold-b", 1e-3)):
            cfg = dict(base, settings_id=sid, learning_rate=lr)
            (tmp_path / f"settings-{sid}.json").write_text(json.dumps(cfg))

        rc = hyperparams_search.main(
            [
                f"--data_dirs={data_dir}",
                f"--validation_data_dirs={data_dir}",
                f"--train_settings_json_glob={tmp_path}/settings-*.json",
                "--epochs=2",
                f"--out_dir={tmp_path}/out",
                f"--log_dir={tmp_path}/log",
            ]
        )
        assert rc == 0
        for sid in ("fold-a", "fold-b"):
            assert (tmp_path / "out" / sid / "model-0-best.msgpack").is_file()
            log = (tmp_path / "log" / sid / "train_log.jsonl").read_text()
            assert len(log.strip().splitlines()) >= 2  # one line per epoch

    def test_compatible_folds_group_into_one_sharded_program(self, tmp_path):
        """Folds sweeping only the learning rate share one compiled vmapped
        super-ensemble sharded over the device mesh — the
        replacement for the reference's least-loaded-GPU process pool
        (python/hyperparams_search.py:30-44, 118-153). 8 folds on 8 virtual
        devices = one net per device, one train step per batch total."""
        import json

        from pilotguru.cli import hyperparams_search

        lrs = [3e-3, 2.5e-3, 2e-3, 1.5e-3, 1e-3, 8e-4, 5e-4, 3e-4]
        settings_list = [
            {
                "settings_id": f"lr-{i}",
                "input_names": ["frame_img", "forward_axis"],
                "label_names": ["steering"],
                "net_name": "toy",
                "target_height": 36,
                "target_width": 72,
                "batch_size": 16,
                "learning_rate": lr,
                "linear_bias_options": [
                    {"input_name": "forward_axis", "input_dims": 3}
                ],
            }
            for i, lr in enumerate(lrs)
        ]
        groups = hyperparams_search.group_folds(settings_list)
        assert len(groups) == 1 and len(groups[0]) == 8

        # Different architecture breaks the group (different program).
        other = dict(settings_list[0], settings_id="other", net_name="nvidia",
                     target_height=66, target_width=210)
        groups = hyperparams_search.group_folds(settings_list + [other])
        assert len(groups) == 2

        rng = np.random.default_rng(2)
        data_dir = tmp_path / "data"
        data_dir.mkdir()
        for i in range(32):
            img = rng.integers(0, 255, size=(3, 36, 80), dtype=np.uint8)
            steering = np.float32(
                [img[:, :, :40].mean() - img[:, :, 40:].mean()]
            ) / 8.0
            np.savez(
                data_dir / f"frame-{i:06d}-data.npz",
                frame_img=img,
                steering=steering.astype(np.float32),
                forward_axis=np.array([1.0, 0.0, 0.0], np.float32),
            )
        for s in settings_list:
            (tmp_path / f"settings-{s['settings_id']}.json").write_text(
                json.dumps(s)
            )
        rc = hyperparams_search.main(
            [
                f"--data_dirs={data_dir}",
                f"--validation_data_dirs={data_dir}",
                f"--train_settings_json_glob={tmp_path}/settings-lr-*.json",
                "--epochs=2",
                f"--out_dir={tmp_path}/out",
                f"--log_dir={tmp_path}/log",
            ]
        )
        assert rc == 0
        for s in settings_list:
            sid = s["settings_id"]
            assert (tmp_path / "out" / sid / "model-0-best.msgpack").is_file()
            assert (tmp_path / "out" / sid / "model-0-last.msgpack").is_file()
            lines = (
                (tmp_path / "log" / sid / "train_log.jsonl")
                .read_text()
                .strip()
                .splitlines()
            )
            assert len(lines) == 2
            event = json.loads(lines[-1])
            assert len(event["val_loss_per_net"]) == 1

    def test_no_matching_settings_files_errors(self, tmp_path):
        import pytest as _pytest

        from pilotguru.cli import hyperparams_search

        with _pytest.raises(SystemExit):
            hyperparams_search.main(
                [
                    f"--data_dirs={tmp_path}",
                    f"--validation_data_dirs={tmp_path}",
                    f"--train_settings_json_glob={tmp_path}/none-*.json",
                    "--epochs=1",
                    f"--out_dir={tmp_path}/out",
                    f"--log_dir={tmp_path}/log",
                ]
            )
