"""Tracker integration tests on synthetic feature streams.

Rendering-free harness: a fixed 3D landmark cloud with stable random
descriptors; each frame's "extractor output" is the projection of the
visible landmarks through the ground-truth camera plus descriptor bit noise
and decoy features. This exercises initialization, motion-model tracking,
keyframe creation, triangulation and local BA end to end.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pilotguru.vo.flatten import flatten_trajectory
from pilotguru.vo.pose import rotvec_to_matrix
from pilotguru.vo.tracking import (
    OK,
    CameraModel,
    MonocularTracker,
    TrackerConfig,
)

# Heavy e2e tier: excluded from the quick loop via `pytest -m "not slow"`.
pytestmark = pytest.mark.slow


class SyntheticScene:
    def __init__(self, seed=0, num_points=600, budget=256):
        rng = np.random.default_rng(seed)
        self.rng = rng
        self.budget = budget
        # Landmarks spread along the road ahead.
        self.points = np.stack(
            [
                rng.uniform(-12, 12, num_points),
                rng.uniform(-2.5, 2.5, num_points),
                rng.uniform(2, 60, num_points),
            ],
            axis=1,
        )
        self.descs = rng.integers(0, 2, size=(num_points, 256)).astype(np.uint8)

    def camera_pose(self, t):
        """Ground truth world->camera pose at time t: forward motion along a
        gently curving road (yaw about the y axis, motion along +z)."""
        yaw = 0.15 * np.sin(2 * np.pi * t / 8.0)
        c, s = np.cos(yaw), np.sin(yaw)
        r_wc = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])  # camera->world
        center = np.array([2.0 * np.sin(t / 3.0), 0.0, 1.5 * t])
        r_cw = r_wc.T
        t_cw = -r_cw @ center
        return r_cw, t_cw, yaw

    def frame_features(self, t, noise_bits=4, decoys=24):
        r_cw, t_cw, _ = self.camera_pose(t)
        cam = self.points @ r_cw.T + t_cw
        vis = cam[:, 2] > 0.5
        uv = cam[:, :2] / np.maximum(cam[:, 2:3], 1e-9)
        vis &= (np.abs(uv[:, 0]) < 0.9) & (np.abs(uv[:, 1]) < 0.6)
        idx = np.nonzero(vis)[0]
        self.rng.shuffle(idx)
        idx = idx[: self.budget - decoys]

        kp = np.zeros((self.budget, 2))
        desc = np.zeros((self.budget, 256), np.uint8)
        valid = np.zeros(self.budget, bool)
        kp[: len(idx)] = uv[idx] + self.rng.normal(scale=5e-4, size=(len(idx), 2))
        d = self.descs[idx].copy()
        flips = self.rng.integers(0, 256, size=(len(idx), noise_bits))
        for i in range(len(idx)):
            d[i, flips[i]] ^= 1
        desc[: len(idx)] = d
        valid[: len(idx)] = True
        # Decoy features: random positions + random descriptors.
        kp[len(idx) : len(idx) + decoys] = self.rng.uniform(
            -0.8, 0.8, size=(decoys, 2)
        )
        desc[len(idx) : len(idx) + decoys] = self.rng.integers(
            0, 2, size=(decoys, 256)
        )
        valid[len(idx) : len(idx) + decoys] = True
        return kp, desc, valid


@pytest.fixture(scope="module")
def tracked():
    scene = SyntheticScene()
    camera = CameraModel(fx=1.0, fy=1.0, cx=0.0, cy=0.0)
    config = TrackerConfig(
        total_budget=256,
        min_init_matches=40,
        min_init_inliers=30,
        min_track_inliers=15,
        match_search_radius=0.1,
    )
    tracker = MonocularTracker(camera, config, feature_fn=lambda t: scene.frame_features(t))
    times = np.arange(0, 12.0, 0.25)
    states = []
    for i, t in enumerate(times):
        states.append(tracker.process_frame(t, frame_id=i, time_usec=int(t * 1e6)))
    return scene, tracker, times, states


class TestTracking:
    def test_initializes_and_stays_ok(self, tracked):
        _, tracker, times, states = tracked
        assert states[-1] == OK
        assert len(tracker.trajectory) >= len(times) - 3

    def test_rotations_match_ground_truth(self, tracked):
        scene, tracker, _, _ = tracked
        # World frame = first camera frame; ground-truth first camera has
        # yaw(0) = 0 so frames coincide up to the global gauge.
        max_err = 0.0
        for fp in tracker.trajectory[2:]:
            r_cw_true, _, _ = scene.camera_pose(fp.time_usec * 1e-6)
            r_cw_est = np.asarray(rotvec_to_matrix(jnp.asarray(fp.pose6[:3])))
            err = np.arccos(
                np.clip((np.trace(r_cw_est @ r_cw_true.T) - 1) / 2, -1, 1)
            )
            max_err = max(max_err, err)
        assert max_err < 0.02, f"max rotation error {max_err} rad"

    def test_translation_direction_up_to_scale(self, tracked):
        scene, tracker, _, _ = tracked
        centers_est = np.stack([fp.camera_center() for fp in tracker.trajectory])
        centers_true = np.stack(
            [
                -scene.camera_pose(fp.time_usec * 1e-6)[0].T
                @ scene.camera_pose(fp.time_usec * 1e-6)[1]
                for fp in tracker.trajectory
            ]
        )
        # Solve for the single monocular scale; shapes must then agree.
        scale = np.sum(centers_est * centers_true) / np.sum(centers_est**2)
        err = np.linalg.norm(centers_est * scale - centers_true, axis=1)
        travel = np.linalg.norm(centers_true[-1])
        assert err.max() < 0.03 * travel, (err.max(), travel)

    def test_map_grows_beyond_initialization(self, tracked):
        _, tracker, _, _ = tracked
        assert tracker.point_valid.sum() > 100
        assert len(tracker.keyframes) >= 3

    def test_flatten_produces_valid_plane_and_turns(self, tracked):
        scene, tracker, _, _ = tracked
        from pilotguru.formats.trajectory import Trajectory

        n = len(tracker.trajectory)
        traj = Trajectory(
            time_usec=np.asarray([fp.time_usec for fp in tracker.trajectory]),
            frame_id=np.asarray([fp.frame_id for fp in tracker.trajectory]),
            is_lost=np.zeros(n, bool),
            translations=np.stack(
                [fp.camera_center() for fp in tracker.trajectory]
            ),
            rotations=np.stack(
                [fp.camera_to_world_quat() for fp in tracker.trajectory]
            ),
        )
        result = flatten_trajectory(traj)
        assert result is not None
        plane, directions, angles = result
        # Turn angles integrate to roughly the ground-truth yaw span.
        t_last = traj.time_usec[-1] * 1e-6
        t_first = traj.time_usec[0] * 1e-6
        want = 0.15 * np.sin(2 * np.pi * t_last / 8.0) - 0.15 * np.sin(
            2 * np.pi * t_first / 8.0
        )
        got = np.sum(angles)
        assert abs(abs(got) - abs(want)) < 0.05, (got, want)


class TestLostBehavior:
    def test_feature_dropout_causes_lost(self):
        scene = SyntheticScene(seed=1)
        camera = CameraModel(1.0, 1.0, 0.0, 0.0)
        config = TrackerConfig(
            total_budget=256, min_init_matches=40, min_init_inliers=30,
            min_track_inliers=15, match_search_radius=0.1,
        )

        def features(t):
            kp, desc, valid = scene.frame_features(t)
            if t > 4.0:  # camera "covered": only decoys remain
                valid[:] = False
                kp = scene.rng.uniform(-0.8, 0.8, size=kp.shape)
                desc = scene.rng.integers(0, 2, size=desc.shape).astype(np.uint8)
                valid[:64] = True
            return kp, desc, valid

        tracker = MonocularTracker(camera, config, feature_fn=features)
        states = []
        for i, t in enumerate(np.arange(0, 8.0, 0.25)):
            states.append(tracker.process_frame(t, i, int(t * 1e6)))
            if states[-1] == "LOST":
                break
        assert "LOST" in states
        assert tracker.trajectory[-1].is_lost


class TestChunkedTracking:
    """process_chunk is an execution-shape change (C frames per device
    round trip), not a semantic one: it must reproduce the per-frame path's
    trajectory, keyframes and states on the same feature stream."""

    @staticmethod
    def _make_frames(scene, times):
        from types import SimpleNamespace

        frames = []
        for i, t in enumerate(times):
            kp, desc, valid = scene.frame_features(t)
            k = kp.shape[0]
            frames.append(
                SimpleNamespace(
                    features=(
                        kp, desc, valid,
                        np.zeros(k, np.int32), np.zeros(k, np.float32),
                    ),
                    dev_features=None,
                    frame_id=i,
                    time_usec=int(t * 1e6),
                )
            )
        return frames

    @staticmethod
    def _make_tracker(**overrides):
        camera = CameraModel(fx=1.0, fy=1.0, cx=0.0, cy=0.0)
        # Exact per-frame equivalence requires rewinding at keyframes; the
        # through-keyframes default is characterized separately in
        # test_chunk_through_keyframes_tracks_whole_ride.
        kwargs = dict(
            total_budget=256, min_init_matches=40, min_init_inliers=30,
            min_track_inliers=15, match_search_radius=0.1,
            chunk_through_keyframes=False,
        )
        kwargs.update(overrides)
        return MonocularTracker(camera, TrackerConfig(**kwargs))

    def _run(self, frames, chunked, **overrides):
        tracker = self._make_tracker(**overrides)
        states = []
        if chunked:
            buf = list(frames)
            while buf:
                if tracker.state == OK:
                    results = tracker.process_chunk(buf[:8])
                    states.extend(s for s, _ in results)
                    del buf[: len(results)]
                else:
                    f = buf.pop(0)
                    kp, desc, valid, level, angle = f.features
                    states.append(
                        tracker.process_features(
                            kp, desc, valid, f.frame_id, f.time_usec,
                            kp_level=level, kp_angle=angle,
                        )
                    )
        else:
            for f in frames:
                kp, desc, valid, level, angle = f.features
                states.append(
                    tracker.process_features(
                        kp, desc, valid, f.frame_id, f.time_usec,
                        kp_level=level, kp_angle=angle,
                    )
                )
        return tracker, states

    def test_chunked_matches_per_frame(self):
        times = np.arange(0, 10.0, 0.25)
        per_tracker, per_states = self._run(
            self._make_frames(SyntheticScene(seed=11), times), chunked=False
        )
        chk_tracker, chk_states = self._run(
            self._make_frames(SyntheticScene(seed=11), times), chunked=True
        )
        assert chk_states == per_states
        assert len(chk_tracker.keyframes) == len(per_tracker.keyframes)
        assert [kf.kf_id for kf in chk_tracker.keyframes] == [
            kf.kf_id for kf in per_tracker.keyframes
        ]
        per_traj = per_tracker.final_trajectory()
        chk_traj = chk_tracker.final_trajectory()
        assert len(per_traj) == len(chk_traj)
        for a, b in zip(per_traj, chk_traj):
            assert a.frame_id == b.frame_id
            # Host-composed (numpy) vs device-composed (XLA) motion
            # predictions differ by libm ulps; everything downstream is
            # integer matching + thresholded optimization, so poses agree
            # to float32 packing noise.
            np.testing.assert_allclose(a.pose6, b.pose6, atol=1e-4)

    def test_chunk_through_keyframes_tracks_whole_ride(self):
        """The production mode (chunk_through_keyframes=True) consumes whole
        chunks across keyframe insertions — frames after a mid-chunk
        keyframe keep device results tracked against the pre-keyframe map
        (the reference's Tracking-vs-LocalMapping lag). The ride must stay
        tracked end to end with poses close to the strict path's."""
        times = np.arange(0, 10.0, 0.25)
        strict_tracker, strict_states = self._run(
            self._make_frames(SyntheticScene(seed=11), times), chunked=True
        )
        thru_tracker, thru_states = self._run(
            self._make_frames(SyntheticScene(seed=11), times),
            chunked=True, chunk_through_keyframes=True,
        )
        assert "LOST" not in thru_states
        assert len(thru_states) == len(strict_states)
        assert len(thru_tracker.keyframes) >= 3
        strict_traj = {
            fp.frame_id: fp.pose6 for fp in strict_tracker.final_trajectory()
        }
        drift = [
            float(np.linalg.norm(fp.pose6 - strict_traj[fp.frame_id]))
            for fp in thru_tracker.final_trajectory()
            if fp.frame_id in strict_traj
        ]
        # Stale-map tracking may move individual poses slightly, but the
        # trajectory must remain the same ride (monocular scale ~1 here).
        assert np.median(drift) < 0.05, f"median pose drift {np.median(drift)}"

    def test_chunk_stops_at_tracking_failure(self):
        """A mid-chunk feature blackout must surface LOST through the
        chunked path (frames after the event are NOT consumed)."""
        scene = SyntheticScene(seed=5)
        times = np.arange(0, 8.0, 0.25)
        frames = self._make_frames(scene, times)
        rng = np.random.default_rng(9)
        for f in frames:
            if f.time_usec > 4_000_000:  # blackout: decoy-only frames
                kp, desc, valid, level, angle = f.features
                valid = valid.copy()
                valid[:] = False
                valid[:48] = True
                f.features = (
                    rng.uniform(-0.8, 0.8, size=kp.shape),
                    rng.integers(0, 2, size=desc.shape).astype(np.uint8),
                    valid, level, angle,
                )
        tracker, states = self._run(frames, chunked=True)
        assert "LOST" in states
        assert tracker.trajectory[-1].is_lost
