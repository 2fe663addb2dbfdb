"""Loop-closing end-to-end test: a synthetic ride around a closed circuit
must trigger loop detection and shrink the end-to-start drift.

Reference behavior being reproduced: LoopClosing detects a revisited place,
fits a Sim3, and the essential-graph optimization redistributes accumulated
drift (/root/reference/thirdparty/orb-slam2/src/LoopClosing.cc). Done
criterion from the round-1 verdict: end-to-start drift reduced >5x on a
synthetic loop ride versus loop closing disabled.
"""

import dataclasses

import numpy as np
import pytest

from pilotguru.vo.tracking import (
    LOST,
    CameraModel,
    MonocularTracker,
    TrackerConfig,
)

pytestmark = pytest.mark.slow


class LoopScene:
    """Camera driving a full circle (radius 10) through a landmark annulus.

    World frame: circle center at [10, 0, 0]; the camera starts at the
    origin heading +z and returns there after 2*pi. Landmarks fill an
    annulus around the circuit with unique random descriptors.
    """

    def __init__(self, seed=0, num_points=2000, budget=256, kp_noise=1.5e-3,
                 noise_bits=2):
        rng = np.random.default_rng(seed)
        self.rng = rng
        self.budget = budget
        self.kp_noise = kp_noise
        self.noise_bits = noise_bits
        ang = rng.uniform(0, 2 * np.pi, num_points)
        rad = rng.uniform(14, 45, num_points)
        self.points = np.stack(
            [
                10.0 - rad * np.cos(ang),
                rng.uniform(-4, 4, num_points),
                rad * np.sin(ang),
            ],
            axis=1,
        )
        self.descs = rng.integers(0, 2, size=(num_points, 256)).astype(np.uint8)

    def camera_pose(self, theta):
        c = np.array([10.0 * (1 - np.cos(theta)), 0.0, 10.0 * np.sin(theta)])
        ct, st = np.cos(theta), np.sin(theta)
        r_wc = np.array([[ct, 0, st], [0, 1, 0], [-st, 0, ct]])
        r_cw = r_wc.T
        return r_cw, -r_cw @ c, c

    def frame_features(self, theta):
        r_cw, t_cw, _ = self.camera_pose(theta)
        cam = self.points @ r_cw.T + t_cw
        vis = cam[:, 2] > 1.0
        uv = cam[:, :2] / np.maximum(cam[:, 2:3], 1e-9)
        vis &= (np.abs(uv[:, 0]) < 0.9) & (np.abs(uv[:, 1]) < 0.6)
        vis &= np.linalg.norm(cam, axis=1) < 40.0
        idx = np.nonzero(vis)[0]
        self.rng.shuffle(idx)
        idx = idx[: self.budget]

        kp = np.zeros((self.budget, 2))
        desc = np.zeros((self.budget, 256), np.uint8)
        valid = np.zeros(self.budget, bool)
        kp[: len(idx)] = uv[idx] + self.rng.normal(
            scale=self.kp_noise, size=(len(idx), 2)
        )
        d = self.descs[idx].copy()
        if self.noise_bits:
            flips = self.rng.integers(0, 256, size=(len(idx), self.noise_bits))
            for i in range(len(idx)):
                d[i, flips[i]] ^= 1
        desc[: len(idx)] = d
        valid[: len(idx)] = True
        return kp, desc, valid


def drive_loop(enable_loop_closing, num_frames=90, seed=0):
    scene = LoopScene(seed=seed)
    config = TrackerConfig(
        total_budget=scene.budget,
        min_init_matches=40,
        min_init_inliers=30,
        min_track_inliers=15,
        match_search_radius=0.1,
        keyframe_max_gap=4,
        enable_loop_closing=enable_loop_closing,
        loop_min_match_count=40,
        loop_min_inliers=15,
        # Global BA is the production default (one dense solve); its XLA
        # compile on the 1-core CPU test host is prohibitive, so the test
        # uses the seam-window BA tier.
        loop_ba="seam",
    )
    camera = CameraModel(fx=1.0, fy=1.0, cx=0.0, cy=0.0)
    tracker = MonocularTracker(
        camera, config, feature_fn=lambda th: scene.frame_features(th)
    )
    thetas = np.linspace(0, 2 * np.pi, num_frames)
    states = []
    for i, th in enumerate(thetas):
        states.append(
            tracker.process_frame(th, frame_id=i, time_usec=int(i * 33333))
        )
    # Segment end: the pipeline's terminal consistency pass
    # (track_video_segments calls this after the frame loop).
    tracker.finalize()
    return scene, tracker, states


def closure_error(tracker):
    """End-to-start camera-center distance, normalized by trajectory extent
    (scale-free: monocular maps have arbitrary global scale)."""
    frames = tracker.final_trajectory()
    centers = np.stack([fp.camera_center() for fp in frames if not fp.is_lost])
    extent = np.max(np.linalg.norm(centers - centers.mean(axis=0), axis=1))
    return np.linalg.norm(centers[-1] - centers[0]) / max(extent, 1e-9)


@pytest.fixture(scope="module")
def loop_runs():
    scene_off, tracker_off, states_off = drive_loop(False)
    scene_on, tracker_on, states_on = drive_loop(True)
    return (tracker_off, states_off), (tracker_on, states_on)


class TestLoopClosing:
    def test_full_circuit_tracks_without_lost(self, loop_runs):
        (t_off, s_off), (t_on, s_on) = loop_runs
        assert LOST not in s_off
        assert LOST not in s_on

    def test_loop_detected_on_revisit(self, loop_runs):
        _, (tracker_on, _) = loop_runs
        assert tracker_on.stats["loop_closures"] >= 1

    def test_drift_reduced_at_least_5x(self, loop_runs):
        (tracker_off, _), (tracker_on, _) = loop_runs
        err_off = closure_error(tracker_off)
        err_on = closure_error(tracker_on)
        assert err_on < err_off / 5.0, (
            f"closure error with loop closing {err_on:.4f} vs without "
            f"{err_off:.4f}"
        )

    def test_no_false_loops_on_open_trajectory(self):
        # The straight-road scene from test_vo_tracking never revisits a
        # place: the detector must stay silent.
        from test_vo_tracking import SyntheticScene

        scene = SyntheticScene()
        config = TrackerConfig(
            total_budget=256,
            min_init_matches=40,
            min_init_inliers=30,
            min_track_inliers=15,
            match_search_radius=0.1,
            enable_loop_closing=True,
            loop_exclude_recent=5,
            loop_cooldown_keyframes=2,
        )
        camera = CameraModel(fx=1.0, fy=1.0, cx=0.0, cy=0.0)
        tracker = MonocularTracker(
            camera, config, feature_fn=lambda t: scene.frame_features(t)
        )
        for i, t in enumerate(np.arange(0, 12.0, 0.25)):
            tracker.process_frame(t, frame_id=i, time_usec=int(t * 1e6))
        assert tracker.stats["loop_closures"] == 0
