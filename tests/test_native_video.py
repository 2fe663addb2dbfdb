"""Native libav video IO: build + round-trip against cv2."""

import os
import shutil
import subprocess

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(REPO, "native")
BUILD_DIR = os.path.join(NATIVE_DIR, "build")

requires_toolchain = pytest.mark.skipif(
    shutil.which("cmake") is None, reason="cmake unavailable"
)


@pytest.fixture(scope="module")
def native_lib():
    generator = ["-G", "Ninja"] if shutil.which("ninja") else []
    subprocess.run(
        ["cmake", "-S", NATIVE_DIR, "-B", BUILD_DIR, *generator],
        check=True, capture_output=True,
    )
    subprocess.run(["cmake", "--build", BUILD_DIR], check=True, capture_output=True)
    from pilotguru.video import native

    assert native.available()
    return native


@requires_toolchain
class TestNativeVideoIo:
    def test_write_read_round_trip(self, native_lib, tmp_path):
        rng = np.random.default_rng(0)
        # Smooth blocky frames survive lossy encoding recognizably.
        frames = []
        for i in range(10):
            small = rng.integers(40, 215, size=(6, 8, 3), dtype=np.uint8)
            frames.append(np.kron(small, np.ones((8, 8, 1), np.uint8)))
        path = str(tmp_path / "native.mp4")
        with native_lib.NativeVideoWriter(path, width=64, height=48, fps=30) as w:
            for f in frames:
                w.write(f)
        assert os.path.getsize(path) > 0

        with native_lib.NativeVideoReader(path) as r:
            assert (r.width, r.height) == (64, 48)
            decoded = list(r)
        assert len(decoded) == 10
        # Timestamps are monotone ~33ms apart.
        pts = [p for _, p in decoded]
        assert all(b > a for a, b in zip(pts, pts[1:]))
        # Lossy round trip: mean absolute error bounded.
        for (got, _), want in zip(decoded, frames):
            assert got.shape == want.shape
            assert np.mean(np.abs(got.astype(int) - want.astype(int))) < 12

    def test_native_reader_matches_cv2(self, native_lib, tmp_path):
        import cv2

        rng = np.random.default_rng(1)
        path = str(tmp_path / "cv2.mp4")
        writer = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 48)
        )
        frames = []
        for _ in range(8):
            small = rng.integers(40, 215, size=(6, 8, 3), dtype=np.uint8)
            frames.append(np.kron(small, np.ones((8, 8, 1), np.uint8)))
            writer.write(cv2.cvtColor(frames[-1], cv2.COLOR_RGB2BGR))
        writer.release()

        with native_lib.NativeVideoReader(path) as r:
            decoded = list(r)
        assert len(decoded) == 8
        for (got, _), want in zip(decoded, frames):
            assert np.mean(np.abs(got.astype(int) - want.astype(int))) < 12

    def test_flips(self, native_lib, tmp_path):
        path = str(tmp_path / "flip.mp4")
        frame = np.zeros((48, 64, 3), np.uint8)
        frame[:24] = 220  # bright top half
        with native_lib.NativeVideoWriter(path, 64, 48) as w:
            for _ in range(3):
                w.write(frame)
        with native_lib.NativeVideoReader(path, vertical_flip=True) as r:
            got, _ = r.read()
        # After the vertical flip the bright half is at the bottom.
        assert got[:24].mean() < got[24:].mean()

    def test_open_missing_file(self, native_lib):
        with pytest.raises(ValueError):
            native_lib.NativeVideoReader("/nonexistent/video.mp4")
