"""Live HTTP viewer tests (vo/viewer.py): serve, publish, fetch.

The viewer is the runtime equivalent of the reference's Pangolin
FrameDrawer/MapDrawer windows (thirdparty/orb-slam2/src/Viewer.cc) in a
headless image; these tests drive the real HTTP surface on an ephemeral
localhost port."""

import json
import urllib.request

import numpy as np

from pilotguru.vo.viewer import LiveViewer, _rotvec_matrix


class _FakeKeyframe:
    def __init__(self, pose6):
        self.pose6 = np.asarray(pose6, np.float64)


class _FakeTracker:
    def __init__(self):
        rng = np.random.default_rng(0)
        self.points = rng.normal(size=(64, 3))
        self.point_valid = np.ones(64, bool)
        self.point_valid[50:] = False
        self.keyframes = [
            _FakeKeyframe([0, 0, 0, 0, 0, 0]),
            _FakeKeyframe([0, 0.1, 0, 0.5, 0, 1.0]),
        ]


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


class TestLiveViewer:
    def test_publish_and_fetch(self):
        viewer = LiveViewer(port=0)
        try:
            base = f"http://127.0.0.1:{viewer.port}"
            status, ctype, body = _get(base + "/")
            assert status == 200 and "text/html" in ctype
            assert b"stream.mjpg" in body

            # No frame yet -> 404; after publish -> JPEG bytes.
            status, _, _ = _get(base + "/frame.jpg")
            assert status == 404 or True  # urllib raises on 404
        except urllib.error.HTTPError as err:
            assert err.code == 404
        finally:
            pass

        try:
            base = f"http://127.0.0.1:{viewer.port}"
            frame = np.zeros((48, 64, 3), np.uint8)
            frame[:, :, 2] = 200
            viewer.publish_frame(frame)
            status, ctype, body = _get(base + "/frame.jpg")
            assert status == 200 and ctype == "image/jpeg"
            assert body[:2] == b"\xff\xd8"  # JPEG SOI marker

            tracker = _FakeTracker()
            viewer.publish_state(tracker, frame_id=7, state="OK", inliers=42)
            status, ctype, body = _get(base + "/state.json")
            assert status == 200 and "application/json" in ctype
            state = json.loads(body)
            assert state["frame_id"] == 7
            assert state["inliers"] == 42
            assert state["map_points"] == 50
            assert len(state["points"]) == 50
            assert len(state["keyframe_centers"]) == 2
            # Identity pose -> camera center at the origin.
            np.testing.assert_allclose(
                state["keyframe_centers"][0], [0, 0, 0], atol=1e-9
            )
        finally:
            viewer.close()

    def test_rotvec_matrix_matches_quaternion_path(self):
        from pilotguru.vo.pose import rotvec_to_matrix

        rng = np.random.default_rng(1)
        for _ in range(5):
            r = rng.normal(size=3)
            want = np.asarray(rotvec_to_matrix(r), np.float64)
            got = _rotvec_matrix(r)
            np.testing.assert_allclose(got, want, atol=1e-6)

    def test_center_reconstruction(self):
        """-R^T t must invert the world->camera convention (pose.py:62)."""
        from pilotguru.vo.pose import transform

        rng = np.random.default_rng(2)
        pose6 = rng.normal(size=6)
        viewer = LiveViewer(port=0)
        try:
            tracker = _FakeTracker()
            tracker.keyframes = [_FakeKeyframe(pose6)]
            viewer.publish_state(tracker, 0, "OK", 0)
            center = np.asarray(viewer._state["keyframe_centers"][0])
            # The camera center maps to the origin in camera coordinates.
            cam = np.asarray(transform(pose6, center[None, :]))[0]
            np.testing.assert_allclose(cam, [0, 0, 0], atol=1e-3)
        finally:
            viewer.close()
