"""Segment pipeline + trajectory JSON format + trajectory CLIs."""

import glob
import json
import os

import numpy as np
import pytest

from pilotguru.formats.trajectory import (
    Trajectory,
    read_trajectory,
    write_trajectory,
)
from pilotguru.vo.camera import CameraSettings, read_camera_settings, write_camera_settings
from pilotguru.vo.pipeline import (
    VideoFrame,
    track_video_segments,
    trajectory_from_tracker,
)
from pilotguru.vo.tracking import CameraModel, MonocularTracker, TrackerConfig
from test_vo_tracking import SyntheticScene

# Heavy e2e tier: excluded from the quick loop via `pytest -m "not slow"`.
pytestmark = pytest.mark.slow


def _make_trajectory(n=40, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return Trajectory(
        time_usec=np.arange(n, dtype=np.int64) * 33_000 + 1_000_000,
        frame_id=np.arange(n, dtype=np.int64),
        is_lost=np.zeros(n, bool),
        translations=rng.normal(size=(n, 3)),
        rotations=q,
        plane=np.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]),
        planar_directions=rng.normal(size=(n, 2)),
        turn_angles=np.concatenate([[0.0], rng.normal(size=n - 1) * 0.01]),
    )


class TestTrajectoryFormat:
    def test_round_trip(self, tmp_path):
        traj = _make_trajectory()
        path = str(tmp_path / "trajectory.json")
        write_trajectory(traj, path)
        back = read_trajectory(path)
        np.testing.assert_array_equal(back.time_usec, traj.time_usec)
        np.testing.assert_array_equal(back.frame_id, traj.frame_id)
        np.testing.assert_allclose(back.translations, traj.translations)
        np.testing.assert_allclose(back.rotations, traj.rotations)
        np.testing.assert_allclose(back.plane, traj.plane)
        np.testing.assert_allclose(
            back.planar_directions, traj.planar_directions
        )
        # Turn angles round-trip through angular_velocity x dt; the write
        # path's 1e-10 divisor guard (json_converters.cc:90) makes this
        # lossy at ~dt/1e-10 relative, exactly like the reference.
        np.testing.assert_allclose(
            back.turn_angles[1:], traj.turn_angles[1:], rtol=1e-8
        )
        assert back.turn_angles[0] == 0

    def test_json_shape_matches_reference(self, tmp_path):
        traj = _make_trajectory(n=3)
        path = str(tmp_path / "t.json")
        write_trajectory(traj, path)
        with open(path) as f:
            root = json.load(f)
        assert set(root.keys()) == {"plane", "trajectory"}
        point = root["trajectory"][1]
        assert set(point.keys()) == {
            "time_usec", "is_lost", "frame_id", "pose",
            "planar_direction", "angular_velocity",
        }
        assert set(point["pose"].keys()) == {"translation", "rotation"}
        assert set(point["pose"]["rotation"].keys()) == {"w", "x", "y", "z"}
        assert len(root["plane"]) == 2 and len(root["plane"][0]) == 3

    def test_frame_id_offset(self, tmp_path):
        traj = _make_trajectory(n=5)
        path = str(tmp_path / "t.json")
        write_trajectory(traj, path, frame_id_offset=2)
        back = read_trajectory(path)
        np.testing.assert_array_equal(back.frame_id, traj.frame_id - 2)


class TestCameraSettings:
    def test_round_trip(self, tmp_path):
        s = CameraSettings(fx=458.0, fy=457.2, cx=320.5, cy=240.1, k1=-0.28)
        path = str(tmp_path / "camera.yml")
        write_camera_settings(s, path)
        back = read_camera_settings(path)
        assert back.fx == s.fx and back.cy == s.cy and back.k1 == s.k1
        assert back.orb_features == 2000 and back.orb_levels == 8


class TestSegmentPipeline:
    def test_lost_restarts_new_segment(self, tmp_path):
        scene = SyntheticScene(seed=3)
        camera = CameraModel(1.0, 1.0, 0.0, 0.0)
        config = TrackerConfig(
            total_budget=256, min_init_matches=40, min_init_inliers=30,
            min_track_inliers=15, match_search_radius=0.1,
        )

        def features(t):
            kp, desc, valid = scene.frame_features(t)
            if 8.0 < t < 9.0:  # mid-ride blackout forces a LOST break
                valid[:] = False
                valid[:40] = True
                desc = scene.rng.integers(0, 2, size=desc.shape).astype(np.uint8)
            return kp, desc, valid

        times = np.arange(0, 20.0, 0.25)
        frames = iter(
            [
                VideoFrame(gray=t, frame_id=i, time_usec=int(t * 1e6))
                for i, t in enumerate(times)
            ]
        )
        settings = CameraSettings(fx=1.0, fy=1.0, cx=0.0, cy=0.0)
        segments, consumed = track_video_segments(
            frames,
            settings,
            str(tmp_path),
            make_tracker=lambda: MonocularTracker(camera, config, feature_fn=features),
        )
        assert consumed == len(times)
        assert segments >= 2
        files = sorted(glob.glob(os.path.join(str(tmp_path), "trajectory-*.json")))
        assert len(files) == segments
        first = read_trajectory(files[0])
        assert first.plane is not None
        assert first.turn_angles is not None
        assert len(first) >= 10


class TestTrajectoryClis:
    @pytest.fixture()
    def trajectory_file(self, tmp_path):
        scene = SyntheticScene(seed=4)
        camera = CameraModel(1.0, 1.0, 0.0, 0.0)
        config = TrackerConfig(
            total_budget=256, min_init_matches=40, min_init_inliers=30,
            min_track_inliers=15, match_search_radius=0.1,
        )
        tracker = MonocularTracker(
            camera, config, feature_fn=lambda t: scene.frame_features(t)
        )
        for i, t in enumerate(np.arange(0, 6.0, 0.25)):
            tracker.process_frame(t, i, int(t * 1e6))
        traj = trajectory_from_tracker(tracker)
        from pilotguru.vo.pipeline import postprocess_segment

        traj = postprocess_segment(traj)
        assert traj is not None
        path = str(tmp_path / "trajectory.json")
        write_trajectory(traj, path)
        return path

    def test_smooth_heading_directions_cli(self, trajectory_file, tmp_path):
        from pilotguru.cli.smooth_heading_directions import main

        out = str(tmp_path / "smoothed.json")
        assert main([
            f"--trajectory_in_file={trajectory_file}",
            "--sigma=2",
            f"--trajectory_out_file={out}",
        ]) == 0
        before = read_trajectory(trajectory_file)
        after = read_trajectory(out)
        # Quaternions stay unit and get smoother.
        np.testing.assert_allclose(
            np.linalg.norm(after.rotations, axis=1), 1.0, atol=1e-9
        )
        assert np.std(np.diff(after.rotations, axis=0)) <= np.std(
            np.diff(before.rotations, axis=0)
        )
        assert after.turn_angles is not None

    def test_project_translations_cli(self, trajectory_file, tmp_path):
        from pilotguru.cli.project_translations import main

        out = str(tmp_path / "projected.json")
        assert main([
            f"--trajectory_in_file={trajectory_file}",
            f"--trajectory_out_file={out}",
        ]) == 0
        before = read_trajectory(trajectory_file)
        after = read_trajectory(out)
        plane = before.plane
        # Projected translations lie in the plane's span.
        normal = np.cross(plane[0], plane[1])
        normal /= np.linalg.norm(normal)
        np.testing.assert_allclose(after.translations @ normal, 0.0, atol=1e-9)


class TestPrefetchFeatures:
    def test_matches_per_frame_extraction(self):
        """Batched prefetch must give the tracker exactly what its own
        per-frame extractor would."""
        import jax.numpy as jnp

        from pilotguru.vo.pipeline import VideoFrame, prefetch_features
        from pilotguru.vo.tracking import CameraModel, MonocularTracker, TrackerConfig

        rng = np.random.default_rng(3)
        config = TrackerConfig(total_budget=128, num_levels=2)
        camera = CameraModel(fx=100.0, fy=100.0, cx=32.0, cy=24.0)
        tracker = MonocularTracker(camera, config)

        frames = []
        for i in range(5):  # 5 frames, batch 2 -> one padded tail batch
            img = rng.uniform(size=(48, 64)).astype(np.float32)
            img[10 + i : 20 + i, 20 : 30] = 1.0  # a moving bright block
            frames.append(VideoFrame(img, i, i * 33_000))

        fetched = list(
            prefetch_features(iter(frames), camera, config, batch_size=2)
        )
        assert [f.frame_id for f in fetched] == [0, 1, 2, 3, 4]
        for f in fetched:
            kp, desc, valid, level, angle = tracker._extract(f.gray)
            pkp, pdesc, pvalid, plevel, pangle = f.features
            np.testing.assert_array_equal(pvalid, valid)
            np.testing.assert_allclose(pkp, kp, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(pdesc, desc)
            np.testing.assert_array_equal(plevel, level)
            # Angles ride back through the packed pull; the repacked batch
            # program fuses arctan2 differently than the per-frame one, so
            # allow a few f32 ulps (1e-5 rad ~ 0.0006 deg — far below any
            # matching-bin or rotation-histogram granularity).
            np.testing.assert_allclose(pangle, angle, rtol=0, atol=1e-5)


class TestOpticalTrajectoriesCli:
    @pytest.mark.parametrize(
        "distortion", [(0.0, 0.0, 0.0, 0.0), (-0.25, 0.05, 0.0, 0.0)],
        ids=["pinhole", "distorted"],
    )
    def test_end_to_end_on_rendered_video(self, tmp_path, distortion):
        """Full CLI on a rendered parallax drive: one accepted segment whose
        angular velocities track the rendered yaw rate. The distorted
        variant renders through a k1=-0.25 lens and relies on keypoint
        undistortion (Frame.cc:408 UndistortKeyPoints parity) to recover
        the same correlation."""
        import cv2

        from pilotguru.cli import optical_trajectories
        from pilotguru.formats import json_io
        from tests.synthetic import render_parallax_video

        video = str(tmp_path / "video.mp4")
        fx, fy, cx, cy, true_rates = render_parallax_video(
            video, distortion=distortion
        )
        k1, k2, p1, p2 = distortion

        yaml_path = str(tmp_path / "camera.yaml")
        fs = cv2.FileStorage(yaml_path, cv2.FILE_STORAGE_WRITE)
        for key, value in [
            ("Camera_fx", fx), ("Camera_fy", fy), ("Camera_cx", cx),
            ("Camera_cy", cy), ("Camera_k1", k1), ("Camera_k2", k2),
            ("Camera_p1", p1), ("Camera_p2", p2), ("Camera_fps", 30.0),
            ("ORBextractor_nFeatures", 600), ("ORBextractor_scaleFactor", 1.2),
            ("ORBextractor_nLevels", 3), ("ORBextractor_iniThFAST", 20),
            ("ORBextractor_minThFAST", 7),
        ]:
            fs.write(key, value)
        fs.release()

        out_dir = tmp_path / "out"
        rc = optical_trajectories.main(
            [
                "--vocabulary_file=",
                f"--camera_settings={yaml_path}",
                f"--in_video={video}",
                f"--out_dir={out_dir}",
            ]
        )
        assert rc == 0
        files = sorted(out_dir.glob("trajectory-*.json"))
        assert files, "no trajectory segments written"
        root = json_io.read_json(str(files[0]))
        points = root["trajectory"]
        assert len(points) > 40
        assert "plane" in root
        rates = np.array([p.get("angular_velocity", 0.0) for p in points])
        frame_ids = np.array([p["frame_id"] for p in points])
        corr = np.corrcoef(rates[3:], true_rates[frame_ids][3:])[0, 1]
        assert abs(corr) > 0.8, f"turn-rate correlation too weak: {corr}"

    def test_reference_budget_720p(self, tmp_path):
        """Tracker at the REFERENCE feature budget (1280x720, 2000 features
        / 8 pyramid levels — src/calibrate.cc:518-531), the config the
        bench runs at. Round 2 shipped green on toy-scale tests while the
        bench config lost tracking twice and produced zero accepted
        segments; this test pins the bench-scale behavior so it
        can never silently regress again. Kept to 100 frames so the slow
        tier stays affordable on a 1-core host."""
        from pilotguru.vo.camera import CameraSettings
        from pilotguru.vo.flatten import flatten_trajectory
        from pilotguru.vo.pipeline import (
            track_video_segments,
            trajectory_from_tracker,
            video_frames,
        )
        from tests.synthetic import render_parallax_video

        video = str(tmp_path / "ride720p.mp4")
        num_frames = 100
        fx, fy, cx, cy, true_rates = render_parallax_video(
            video, width=1280, height=720, frames=num_frames,
            num_points=2400, fx=700.0, period_frames=60.0,
        )
        settings = CameraSettings(
            fx=fx, fy=fy, cx=cx, cy=cy, orb_features=2000, orb_levels=8,
        )
        out_dir = tmp_path / "out"
        segments, consumed = track_video_segments(
            video_frames(video), settings, str(out_dir), feature_batch_size=8
        )
        assert consumed == num_frames
        assert segments >= 1, "no accepted segment at reference budget"

        from pilotguru.formats import json_io

        root = json_io.read_json(str(out_dir / "trajectory-0000.json"))
        points = root["trajectory"]
        # One unbroken segment: no mid-ride LOSTs on this clean ride.
        assert len(points) >= num_frames - 5, (
            f"segment covers only {len(points)}/{num_frames} frames "
            "(mid-ride tracking loss at reference budget)"
        )
        rates = np.array([p.get("angular_velocity", 0.0) for p in points])
        frame_ids = np.array([p["frame_id"] for p in points])
        corr = np.corrcoef(rates[3:], true_rates[frame_ids][3:])[0, 1]
        assert abs(corr) > 0.9, f"turn-rate correlation too weak: {corr}"

    def test_per_segment_videos_and_visualize(self, tmp_path):
        """--output_per_segment_videos + --visualize (reference
        optical_trajectories.cc:47,53-57): per-segment video frame counts
        must match the remapped JSON frame ids (sink consumes OK-state
        frames; frame_id_offset makes ids index into the segment video,
        track_image_sequence.cc:58-60,103-104), and the visualize overlay
        must exist with the same frame cadence as the full input."""
        import cv2

        from pilotguru.cli import optical_trajectories
        from pilotguru.formats import json_io
        from tests.synthetic import render_parallax_video

        video = str(tmp_path / "video.mp4")
        fx, fy, cx, cy, _ = render_parallax_video(video)

        yaml_path = str(tmp_path / "camera.yaml")
        fs = cv2.FileStorage(yaml_path, cv2.FILE_STORAGE_WRITE)
        for key, value in [
            ("Camera_fx", fx), ("Camera_fy", fy), ("Camera_cx", cx),
            ("Camera_cy", cy), ("Camera_fps", 30.0),
            ("ORBextractor_nFeatures", 600), ("ORBextractor_scaleFactor", 1.2),
            ("ORBextractor_nLevels", 3), ("ORBextractor_iniThFAST", 20),
            ("ORBextractor_minThFAST", 7),
        ]:
            fs.write(key, value)
        fs.release()

        out_dir = tmp_path / "out"
        rc = optical_trajectories.main(
            [
                "--vocabulary_file=",
                f"--camera_settings={yaml_path}",
                f"--in_video={video}",
                f"--out_dir={out_dir}",
                "--output_per_segment_videos",
                "--visualize",
            ]
        )
        assert rc == 0
        jsons = sorted(out_dir.glob("trajectory-*.json"))
        assert jsons, "no trajectory segments written"

        def frame_count(path):
            cap = cv2.VideoCapture(str(path))
            n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            cap.release()
            return n

        for json_path in jsons:
            seg_video = json_path.with_suffix(".mp4")
            assert seg_video.exists(), f"missing segment video {seg_video}"
            points = json_io.read_json(str(json_path))["trajectory"]
            ids = np.array([p["frame_id"] for p in points])
            # Remapped ids index into the segment video: consecutive 0..N-1
            # and the video holds exactly those frames.
            assert ids[0] == 0
            np.testing.assert_array_equal(ids, np.arange(len(ids)))
            assert frame_count(seg_video) == len(ids)
            viz = out_dir / json_path.name.replace(
                "trajectory-", "visualize-"
            ).replace(".json", ".mp4")
            assert viz.exists(), f"missing visualize video {viz}"
            assert frame_count(viz) >= frame_count(seg_video)

    def test_live_view_serves_during_tracking(self, tmp_path):
        """--visualize_live_port: the live HTTP viewer (vo/viewer.py, the
        runtime equivalent of the reference's Pangolin Viewer.cc windows)
        must serve the overlay frame and live map state while a ride
        tracks. Uses an ephemeral port; fetches happen after tracking
        completes (the server stays consistent until close) by patching
        LiveViewer.close to capture the live state first."""
        import json as json_mod
        import urllib.request

        import cv2

        from pilotguru.cli import optical_trajectories
        from pilotguru.vo import viewer as viewer_mod
        from tests.synthetic import render_parallax_video

        video = str(tmp_path / "video.mp4")
        fx, fy, cx, cy, _ = render_parallax_video(video, frames=40)

        yaml_path = str(tmp_path / "camera.yaml")
        fs = cv2.FileStorage(yaml_path, cv2.FILE_STORAGE_WRITE)
        for key, value in [
            ("Camera_fx", fx), ("Camera_fy", fy), ("Camera_cx", cx),
            ("Camera_cy", cy), ("Camera_fps", 30.0),
            ("ORBextractor_nFeatures", 400), ("ORBextractor_scaleFactor", 1.2),
            ("ORBextractor_nLevels", 2), ("ORBextractor_iniThFAST", 20),
            ("ORBextractor_minThFAST", 7),
        ]:
            fs.write(key, value)
        fs.release()

        captured = {}
        real_close = viewer_mod.LiveViewer.close

        def capturing_close(self):
            base = f"http://127.0.0.1:{self.port}"
            with urllib.request.urlopen(base + "/state.json", timeout=5) as r:
                captured["state"] = json_mod.loads(r.read())
            with urllib.request.urlopen(base + "/frame.jpg", timeout=5) as r:
                captured["jpeg"] = r.read()
            real_close(self)

        viewer_mod.LiveViewer.close = capturing_close
        try:
            rc = optical_trajectories.main(
                [
                    "--vocabulary_file=",
                    f"--camera_settings={yaml_path}",
                    f"--in_video={video}",
                    f"--out_dir={tmp_path / 'out'}",
                    "--visualize_live_port=0",
                ]
            )
        finally:
            viewer_mod.LiveViewer.close = real_close
        assert rc == 0
        assert captured["jpeg"][:2] == b"\xff\xd8"  # JPEG frame served
        state = captured["state"]
        assert state["frame_id"] >= 0
        assert state["keyframes"] >= 2
        assert state["map_points"] > 0
        assert len(state["keyframe_centers"]) == state["keyframes"]

    def test_long_ride_soak(self, tmp_path):
        """Long-ride soak at the reference FEATURE budget (2000 feat / 8
        levels) with continuous scenery turnover: billboards are strewn
        along the whole path (corridor mode) so map points constantly leave
        the frustum and fresh ones are triangulated — the map-pressure
        regime of a multi-minute ride, which fixed-cloud tests never reach.
        Resolution is reduced (480x360) to keep the 1-core-host slow tier
        affordable; tools/soak_vo.py runs the full-size variant on real
        hardware (observed behavior recorded in PARITY.md §map pressure).

        Asserts: no silent point loss (arena culling/recycling keeps up),
        bounded drift (turn-rate fidelity holds over the FINAL third as
        well as the whole segment), and no more than one mid-ride LOST."""
        from pilotguru.formats import json_io
        from pilotguru.vo.pipeline import (
            prefetch_features,
            track_video_segments,
            tracker_from_settings,
            video_frames,
        )
        from tests.synthetic import render_parallax_video

        video = str(tmp_path / "long_ride.mp4")
        num_frames = 240
        fx, fy, cx, cy, true_rates = render_parallax_video(
            video, width=480, height=360, frames=num_frames, num_points=500,
            fx=260.0, period_frames=120.0, forward_speed=0.1, corridor=True,
        )
        settings = CameraSettings(
            fx=fx, fy=fy, cx=cx, cy=cy, orb_features=2000, orb_levels=8,
        )

        trackers = []

        def make_tracker():
            t = tracker_from_settings(settings)
            trackers.append(t)
            return t

        probe = tracker_from_settings(settings)
        frames_iter = prefetch_features(
            video_frames(video), probe.camera, probe.config, 8
        )
        out_dir = tmp_path / "out"
        segments, consumed = track_video_segments(
            frames_iter, settings, str(out_dir), make_tracker=make_tracker,
            feature_batch_size=0,
        )
        assert consumed == num_frames
        assert segments >= 1, "no accepted segment on the soak ride"
        assert len(trackers) <= 2, (
            f"{len(trackers) - 1} mid-ride tracking losses over "
            f"{num_frames} frames"
        )

        stats = {}
        for t in trackers:
            for k, v in t.stats.items():
                stats[k] = stats.get(k, 0) + v
        # Scenery turnover must actually exercise map maintenance: points
        # are continuously created and culled as the corridor scrolls by.
        # Thresholds are evidence-based (PARITY.md §map pressure, r5): this
        # 500-billboard scene physically bounds distinct landmark tracks,
        # and the original aspirational `> 2000` had NEVER passed — the
        # identical scenario at the r3 commit that introduced it created
        # 1250 points. Multi-neighbor triangulation (create_neighbor_kfs,
        # LocalMapping.cc:454-525 parity) lifted creation to ~1450: these
        # gates assert several-times-initial-map churn, tight enough that
        # a return to single-pair/small-baseline creation fails again.
        assert stats["points_created"] > 1300, stats
        assert stats["points_culled"] > 300, stats
        # The arena never silently loses points: every allocation either
        # found a free slot or recycled a reported victim.
        assert stats["points_dropped"] == 0, stats

        covered = 0
        for i in range(segments):
            root = json_io.read_json(str(out_dir / f"trajectory-{i:04d}.json"))
            pts = root["trajectory"]
            covered += len(pts)
            rates = np.array([p.get("angular_velocity", 0.0) for p in pts])
            fids = np.array([p["frame_id"] for p in pts])
            corr = np.corrcoef(rates[3:], true_rates[fids][3:])[0, 1]
            assert abs(corr) > 0.85, f"segment {i} corr {corr}"
            # Bounded drift: the LAST third of the segment tracks the true
            # yaw rate as faithfully as the whole (no slow map corruption).
            n = len(pts)
            tail = slice(2 * n // 3, n)
            tail_corr = np.corrcoef(rates[tail], true_rates[fids][tail])[0, 1]
            assert abs(tail_corr) > 0.8, f"segment {i} tail corr {tail_corr}"
        assert covered >= 0.9 * num_frames, (
            f"segments cover only {covered}/{num_frames} frames"
        )


class TestImageListSource:
    def test_video_frames_reads_tum_image_list(self, tmp_path):
        """TUM-style image-list input (the reference's LoadImages,
        src/io/image_sequence_reader.cc:19-46): three header lines, then
        '<timestamp_sec> <relative_image_path>' rows. video_frames must
        yield the same grayscale frames as the video path, with timestamps
        taken from the list."""
        import cv2

        from pilotguru.vo.pipeline import video_frames
        from tests.synthetic import render_parallax_video

        video = str(tmp_path / "video.mp4")
        render_parallax_video(video, frames=6)

        list_dir = tmp_path / "tum"
        (list_dir / "rgb").mkdir(parents=True)
        stamps = []
        cap = cv2.VideoCapture(video)
        i = 0
        decoded = []
        while True:
            ok, bgr = cap.read()
            if not ok:
                break
            ts = 100.0 + i / 30.0
            name = f"rgb/{ts:.6f}.png"
            cv2.imwrite(str(list_dir / name), bgr)
            stamps.append((ts, name))
            decoded.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))
            i += 1
        cap.release()
        with open(list_dir / "rgb.txt", "w") as f:
            f.write("# color images\n# file: 'synthetic'\n# timestamp filename\n")
            for ts, name in stamps:
                f.write(f"{ts:.6f} {name}\n")

        # Directory form (rgb.txt discovered) and explicit index-file form.
        for src in (str(list_dir), str(list_dir / "rgb.txt")):
            frames = list(video_frames(src))
            assert len(frames) == len(stamps)
            for j, f in enumerate(frames):
                assert f.frame_id == j
                assert f.time_usec == int(round(stamps[j][0] * 1e6))
                np.testing.assert_array_equal(f.gray, decoded[j])

    def test_vertical_flip(self, tmp_path):
        import cv2

        from pilotguru.vo.pipeline import video_frames

        (tmp_path / "rgb").mkdir()
        img = np.zeros((8, 8, 3), np.uint8)
        img[0, :, :] = 255  # bright top row
        cv2.imwrite(str(tmp_path / "rgb" / "a.png"), img)
        with open(tmp_path / "rgb.txt", "w") as f:
            f.write("#\n#\n#\n1.5 rgb/a.png\n")
        frames = list(video_frames(str(tmp_path), vertical_flip=True))
        assert len(frames) == 1
        assert frames[0].gray[-1].min() > 200  # bright row now at bottom
        assert frames[0].gray[0].max() == 0
