import jax
import jax.numpy as jnp
import numpy as np

from pilotguru.vo.pose import project, transform
from pilotguru.vo.relocalize import dlt_pose, relocalize
from pilotguru.vo.tracking import CameraModel, MonocularTracker, TrackerConfig
from test_vo_tracking import SyntheticScene
import pytest

# Heavy e2e tier: excluded from the quick loop via `pytest -m "not slow"`.
pytestmark = pytest.mark.slow


class TestDltPose:
    def test_recovers_pose_from_exact_correspondences(self):
        rng = np.random.default_rng(0)
        points = np.stack(
            [rng.uniform(-2, 2, 30), rng.uniform(-2, 2, 30), rng.uniform(4, 10, 30)],
            axis=1,
        )
        true_pose = jnp.asarray([0.1, -0.05, 0.08, 0.3, -0.2, 0.5])
        obs = project(transform(true_pose, jnp.asarray(points)))
        pose = dlt_pose(
            jnp.asarray(points), obs, jnp.ones(30)
        )
        # DLT is algebraic, so allow modest error; projections must agree.
        reproj = project(transform(pose, jnp.asarray(points)))
        err = np.linalg.norm(np.asarray(reproj) - np.asarray(obs), axis=1)
        assert np.median(err) < 1e-3, np.median(err)


class TestRelocalize:
    def _mapped_scene(self):
        scene = SyntheticScene(seed=8)
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
        assert tracker.state == "OK"
        return scene, tracker

    def test_relocalizes_from_scratch(self):
        scene, tracker = self._mapped_scene()
        # A frame from a time inside the mapped span, posed WITHOUT any
        # motion prior: relocalization must find a pose whose projections
        # match the map.
        kp, desc, valid = scene.frame_features(4.0)
        result = relocalize(
            jnp.asarray(tracker.points),
            jnp.asarray(tracker.point_desc),
            jnp.asarray(tracker.point_valid),
            jnp.asarray(kp),
            jnp.asarray(desc),
            jnp.asarray(valid),
            jax.random.PRNGKey(0),
        )
        assert int(result.num_inliers) > 30
        # Pose agrees with the tracked trajectory pose at the same time
        # (same map scale/gauge): compare camera centers.
        from pilotguru.vo.pose import rotvec_to_matrix

        pose = np.asarray(result.pose6)
        r = np.asarray(rotvec_to_matrix(jnp.asarray(pose[:3])))
        center = -(r.T @ pose[3:])
        tracked = [
            fp for fp in tracker.trajectory if abs(fp.time_usec - 4_000_000) < 1
        ]
        assert tracked
        np.testing.assert_allclose(center, tracked[0].camera_center(), atol=0.02)

    def test_tracker_survives_motion_model_break(self):
        scene = SyntheticScene(seed=9)
        camera = CameraModel(1.0, 1.0, 0.0, 0.0)
        config = TrackerConfig(
            total_budget=256, min_init_matches=40, min_init_inliers=30,
            min_track_inliers=15, match_search_radius=0.03,  # tight window
        )

        def features(t):
            return scene.frame_features(t)

        tracker = MonocularTracker(camera, config, feature_fn=features)
        times = list(np.arange(0, 5.0, 0.25))
        # A time JUMP breaks the constant-velocity prediction: the projected
        # search window misses, and only relocalization can recover.
        times += list(np.arange(5.0, 7.0, 0.25) + 1.5)
        states = []
        for i, t in enumerate(times):
            states.append(tracker.process_frame(t, i, int(t * 1e6)))
        assert states[-1] == "OK", states[-8:]
