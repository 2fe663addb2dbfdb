import io
import json

import numpy as np

from pilotguru.utils.profiling import StageTimer
from pilotguru.vo.map_io import load_tracker_map, save_tracker_map
from pilotguru.vo.tracking import CameraModel, MonocularTracker, TrackerConfig
from test_vo_tracking import SyntheticScene


class TestStageTimer:
    def test_accumulates_and_reports(self, tmp_path):
        timer = StageTimer("pipeline")
        with timer.stage("a"):
            pass
        with timer.stage("b"):
            pass
        with timer.stage("a"):
            pass
        assert timer.counts["a"] == 2
        assert list(timer.as_dict().keys()) == ["a", "b"]
        out = io.StringIO()
        text = timer.report(out=out)
        assert "pipeline" in text and "a" in text and "total" in text
        path = str(tmp_path / "timings.jsonl")
        timer.write_jsonl(path)
        record = json.loads(open(path).read())
        assert record["name"] == "pipeline"
        assert set(record["stages"]) == {"a", "b"}

    def test_fit_motion_reports_stages(self):
        import synthetic

        from pilotguru.calib import FitMotionConfig, fit_motion_arrays

        r = synthetic.make_ride(duration_sec=25.0, imu_hz=20.0, jitter_seed=9)
        timer = StageTimer("fit_motion")
        fit_motion_arrays(
            r.rot_times_usec, r.rot_rates, r.acc_times_usec, r.accelerations,
            r.gps_times_usec, r.gps_speeds,
            FitMotionConfig(locations_batch_size=10, optimization_iters=10),
            timer=timer,
        )
        assert set(timer.as_dict()) == {
            "rotation_axis_pca",
            "host_preprocess",
            "solve_and_reduce",
            "smooth_and_assemble",
        }
        assert timer.total_seconds() > 0


class TestTrackerMapIo:
    def test_save_load_round_trip_and_resume(self, tmp_path):
        scene = SyntheticScene(seed=6)
        camera = CameraModel(1.0, 1.0, 0.0, 0.0)
        config = TrackerConfig(
            total_budget=256, min_init_matches=40, min_init_inliers=30,
            min_track_inliers=15, match_search_radius=0.1,
        )
        tracker = MonocularTracker(
            camera, config, feature_fn=lambda t: scene.frame_features(t)
        )
        times = np.arange(0, 6.0, 0.25)
        for i, t in enumerate(times):
            tracker.process_frame(t, i, int(t * 1e6))
        assert tracker.state == "OK"

        path = str(tmp_path / "map.npz")
        save_tracker_map(tracker, path)

        restored = MonocularTracker(
            camera, config, feature_fn=lambda t: scene.frame_features(t)
        )
        load_tracker_map(path, restored)
        np.testing.assert_array_equal(restored.point_valid, tracker.point_valid)
        np.testing.assert_allclose(restored.points, tracker.points)
        np.testing.assert_array_equal(
            restored.point_desc, tracker.point_desc
        )
        assert len(restored.keyframes) == len(tracker.keyframes)
        assert len(restored.trajectory) == len(tracker.trajectory)
        np.testing.assert_allclose(restored._pose, tracker._pose)

        # Resume tracking from the restored map: the next frames keep OK.
        start = len(times)
        for i, t in enumerate(np.arange(6.0, 8.0, 0.25)):
            state = restored.process_frame(t, start + i, int(t * 1e6))
        assert state == "OK"
        assert len(restored.trajectory) > len(tracker.trajectory)


class TestKahanSum:
    def test_compensates_catastrophic_accumulation(self):
        from pilotguru.utils.kahan import KahanSum, kahan_sum

        # Classic failure case: 1 + many tiny terms.
        acc = KahanSum()
        acc.add(1.0)
        for _ in range(10_000_000 // 10000):
            acc.add(1e-16 * 10000)
        assert acc.sum > 1.0  # naive float64 would often lose the tail

        values = np.concatenate([[1e16], np.full(1000, 1.0), [-1e16]])
        assert kahan_sum(values) == 1000.0

    def test_vector_accumulation(self):
        from pilotguru.utils.kahan import kahan_sum

        rng = np.random.default_rng(0)
        values = rng.normal(size=(500, 3))
        np.testing.assert_allclose(
            kahan_sum(values, axis=0), values.sum(axis=0), rtol=1e-12
        )


class TestSynchronizedLatestValue:
    def test_overwrite_keeps_only_latest(self):
        from pilotguru.utils.latest_value import SynchronizedLatestValue

        cell = SynchronizedLatestValue()
        assert cell.latest() == (None, 0)
        cell.set("a")
        last_id = cell.set("b")
        value, update_id = cell.get_next(0, timeout=1.0)
        assert (value, update_id) == ("b", last_id)

    def test_get_next_times_out_without_newer_value(self):
        from pilotguru.utils.latest_value import SynchronizedLatestValue

        cell = SynchronizedLatestValue()
        update_id = cell.set(42)
        value, same_id = cell.get_next(update_id, timeout=0.05)
        assert value is None and same_id == update_id

    def test_producer_consumer_threads(self):
        import threading

        from pilotguru.utils.latest_value import SynchronizedLatestValue

        cell = SynchronizedLatestValue()
        seen = []

        def consumer():
            update_id = 0
            while True:
                value, update_id = cell.get_next(update_id, timeout=2.0)
                if value is None:
                    return
                seen.append(value)
                if value == 99:
                    return

        t = threading.Thread(target=consumer)
        t.start()
        for i in range(100):
            cell.set(i)
        t.join(timeout=5.0)
        assert not t.is_alive()
        # The consumer saw the final value and only ever-fresher values.
        assert seen[-1] == 99 or seen == []
        assert seen == sorted(seen)


class TestFormatSequence:
    """Parity with the reference vector operator<< layout
    (include/logging/strings.hpp:8-20)."""

    def test_matches_reference_stream_layout(self):
        from pilotguru.utils.strings import format_sequence

        assert format_sequence([1, 2, 3]) == "{1, 2, 3}"
        assert format_sequence([]) == "{}"
        assert format_sequence(["a"]) == "{a}"
        assert format_sequence(f"{v:.2f}" for v in (0.5, -1.0)) == "{0.50, -1.00}"
