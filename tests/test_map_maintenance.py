"""LocalMapping-parity tests: map-point culling, duplicate fusion, keyframe
culling, and slot recycling under arena pressure.

Reference semantics under test: LocalMapping::MapPointCulling
(/root/reference/thirdparty/orb-slam2/src/LocalMapping.cc:170-206),
SearchInNeighbors (:454-525), KeyFrameCulling (:631-695). Uses the same
rendering-free synthetic-feature harness as test_vo_tracking.
"""

import numpy as np
import pytest

from pilotguru.vo.tracking import (
    LOST,
    OK,
    CameraModel,
    MonocularTracker,
    TrackerConfig,
)
from test_vo_tracking import SyntheticScene

pytestmark = pytest.mark.slow


def run_tracker(config, scene, duration=12.0, step=0.25, feature_fn=None):
    camera = CameraModel(fx=1.0, fy=1.0, cx=0.0, cy=0.0)
    tracker = MonocularTracker(
        camera, config, feature_fn=feature_fn or (lambda t: scene.frame_features(t))
    )
    states = []
    for i, t in enumerate(np.arange(0, duration, step)):
        states.append(tracker.process_frame(t, frame_id=i, time_usec=int(t * 1e6)))
    return tracker, states


BASE = dict(
    total_budget=256,
    min_init_matches=40,
    min_init_inliers=30,
    min_track_inliers=15,
    match_search_radius=0.1,
    enable_loop_closing=False,
)


class TestMapPointCulling:
    def test_unfound_points_get_culled(self):
        scene = SyntheticScene()
        tracker, states = run_tracker(TrackerConfig(**BASE), scene)
        assert states[-1] == OK
        assert tracker.stats["points_culled"] > 0
        # Every surviving established point must satisfy the found-ratio
        # bar the culler enforces on recent ones at their last evaluation.
        valid = np.nonzero(tracker.point_valid & ~tracker.point_recent)[0]
        assert valid.size > 50

    def test_culled_slots_are_reused(self):
        scene = SyntheticScene()
        tracker, states = run_tracker(TrackerConfig(**BASE), scene)
        # Total creations exceed capacity usage: culled slots were recycled
        # by later triangulations (point_first_kf of valid points spans
        # late keyframes too).
        late = tracker.point_first_kf[tracker.point_valid] >= 3
        assert late.any()

    def test_no_dangling_keyframe_references(self):
        scene = SyntheticScene()
        tracker, _ = run_tracker(TrackerConfig(**BASE), scene)
        for kf in tracker.keyframes:
            refs = kf.map_point[kf.map_point >= 0]
            assert tracker.point_valid[refs].all(), "reference to culled point"


class TestArenaPressure:
    def test_saturated_arena_recycles_instead_of_dying(self):
        # Round-1 behavior: when the fixed arena fills, new points were
        # silently dropped until tracking degraded. Now the worst off-window
        # points must be recycled and tracking must survive the full ride
        # (a round-1 review item). max_map_points=300 saturates within a
        # few keyframes on the standard scene.
        scene = SyntheticScene()
        config = TrackerConfig(max_map_points=300, **BASE)
        tracker, states = run_tracker(config, scene, duration=16.0)
        assert states[-1] == OK, f"tracking died: {states[-5:]}"
        assert tracker.stats["points_recycled"] > 0
        # Nothing silently dropped: every shortfall is accounted.
        assert tracker.stats["points_dropped"] == 0
        # Point count stays at a healthy level, not pinned at saturation
        # with stale points.
        assert 100 < tracker.point_valid.sum() <= 300


class TestKeyframeCulling:
    # Half-speed motion + a keyframe every 2 frames: consecutive keyframes
    # share most observations (redundancy) while parallax stays sufficient
    # for healthy monocular triangulation (a full crawl breaks the
    # initializer — a degenerate monocular case, not a culling scenario).

    def test_redundant_keyframes_culled_when_camera_lingers(self):
        scene = SyntheticScene()

        def features(t):
            return scene.frame_features(t * 0.5)

        config = TrackerConfig(keyframe_max_gap=2, **BASE)
        tracker, states = run_tracker(
            config, scene, duration=20.0, feature_fn=features
        )
        assert LOST not in states
        assert tracker.stats["keyframes_culled"] > 0

    def test_trajectory_survives_keyframe_culling(self):
        scene = SyntheticScene()

        def features(t):
            return scene.frame_features(t * 0.5)

        config = TrackerConfig(keyframe_max_gap=2, **BASE)
        tracker, _ = run_tracker(config, scene, duration=20.0, feature_fn=features)
        assert tracker.stats["keyframes_culled"] > 0
        final = tracker.final_trajectory()
        assert len(final) == len(tracker.trajectory)
        live_ids = {kf.kf_id for kf in tracker.keyframes}
        for fp in tracker.trajectory:
            assert fp.ref_kf_id in live_ids or fp.ref_kf_id == -1, (
                "frame anchored to a culled keyframe was not re-anchored"
            )
        # Reconstructed poses stay finite and close to the at-track poses
        # (corrections are small refinements on this easy scene).
        for fp_final, fp_raw in zip(final, tracker.trajectory):
            assert np.all(np.isfinite(fp_final.pose6))
            assert np.linalg.norm(fp_final.pose6 - fp_raw.pose6) < 0.5


class TestFusion:
    """Deterministic unit tests on a hand-built map state. (With unique
    stable synthetic descriptors and reliable tracking, organic duplicates
    only arise at loop seams — test_loopclosing covers that integration
    path, where closures fuse 20+ points.)"""

    def _tracker_with_duplicate(self):
        from pilotguru.vo.tracking import Keyframe

        rng = np.random.default_rng(0)
        config = TrackerConfig(max_map_points=64, **BASE)
        tracker = MonocularTracker(CameraModel(1, 1, 0, 0), config)
        k = 8
        desc_dup = rng.integers(0, 2, size=256).astype(np.uint8)
        desc_other = rng.integers(0, 2, size=256).astype(np.uint8)
        p = np.array([0.1, -0.05, 4.0])
        other = np.array([-0.3, 0.2, 5.0])
        tracker.points[0] = p
        tracker.points[1] = p + 1e-4  # the duplicate
        tracker.points[2] = other
        tracker.point_desc[0] = desc_dup
        tracker.point_desc[1] = desc_dup
        tracker.point_desc[2] = desc_other
        tracker.point_valid[:3] = True
        tracker.point_visible[:3] = 4
        tracker.point_found[:3] = 4

        def kf(map_refs):
            kp = np.zeros((k, 2))
            desc = np.zeros((k, 256), np.uint8)
            valid = np.zeros(k, bool)
            kp[0] = p[:2] / p[2]
            desc[0] = desc_dup
            valid[0] = True
            kp[1] = other[:2] / other[2]
            desc[1] = desc_other
            valid[1] = True
            mp = np.full(k, -1, np.int32)
            for row, pid in map_refs.items():
                mp[row] = pid
            return Keyframe(
                np.zeros(6), kp, desc, valid, mp, 2,
                kf_id=tracker._next_kf_id,
            )

        kf_a = kf({0: 0, 1: 2})  # original observations
        tracker._next_kf_id += 1
        kf_b = kf({0: 1})  # re-observation landed on the duplicate
        tracker._next_kf_id += 1
        tracker.keyframes = [kf_a, kf_b]
        tracker._refresh_local_points()
        return tracker, kf_a, kf_b

    def test_duplicate_points_get_fused(self):
        tracker, kf_a, kf_b = self._tracker_with_duplicate()
        tracker._fuse_duplicates(kf_b)
        assert tracker.stats["points_fused"] == 1
        # One of the twins is gone; every reference points at the survivor.
        assert tracker.point_valid[:2].sum() == 1
        survivor = int(np.nonzero(tracker.point_valid[:2])[0][0])
        assert kf_a.map_point[0] == survivor
        assert kf_b.map_point[0] == survivor

    def test_match_onto_free_keypoint_adds_observation(self):
        tracker, kf_a, kf_b = self._tracker_with_duplicate()
        # kf_b sees the 'other' landmark's feature but has no reference yet.
        assert kf_b.map_point[1] == -1
        tracker._fuse_duplicates(kf_b)
        assert kf_b.map_point[1] == 2

    def test_fusion_keeps_references_consistent(self):
        tracker, _, kf_b = self._tracker_with_duplicate()
        tracker._fuse_duplicates(kf_b)
        for kf in tracker.keyframes:
            refs = kf.map_point[kf.map_point >= 0]
            assert tracker.point_valid[refs].all()
