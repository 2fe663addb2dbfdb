"""Video annotation rendering: steering-wheel overlay + speedometer tiles.

Host-side cv2 equivalents of the reference render helpers
(/root/reference/src/render_motion.cc:99-201, render_frame_numbers.cc):
rotated steering-wheel image panels and a km/h speedometer bar below the
ride video, and frame-id burn-in for manual frame blacklisting.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def load_per_frame_series(
    json_name: str, root_name: str, units: str, scale: float
) -> Dict[int, float]:
    """{frame_id: value * scale} from an annotate_frames output
    (render_motion.cc:65-77)."""
    from pilotguru.formats.json_io import read_json

    root = read_json(json_name)
    return {int(e["frame_id"]): float(e[units]) * scale for e in root[root_name]}


def render_steering(out_frame, row, col, wheel_image, turn_degrees: float):
    """Rotate the wheel image by turn_degrees and paste (render_motion.cc:99-110)."""
    import cv2

    h, w = wheel_image.shape[:2]
    rot = cv2.getRotationMatrix2D((w / 2, h / 2), turn_degrees, 1.0)
    rotated = cv2.warpAffine(wheel_image, rot, (w, h), flags=cv2.INTER_LINEAR)
    out_frame[row : row + h, col : col + w] = rotated


def render_velocity(out_frame, row, col, window_rows, window_cols, velocity_km_h):
    """Digits + vertical speedometer bar (render_motion.cc:124-181)."""
    import cv2

    panel = out_frame[row : row + window_rows, col : col + window_cols]
    panel[:] = 0
    margin = 10
    text = str(int(velocity_km_h))
    color = (255, 255, 255)
    (tw, th), _ = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, 3.0, 3)
    cv2.putText(
        panel, text, (margin, window_rows - margin),
        cv2.FONT_HERSHEY_SIMPLEX, 3.0, color, 3,
    )
    cv2.putText(
        panel, " km/h", (margin + tw, window_rows - margin),
        cv2.FONT_HERSHEY_SIMPLEX, 0.8, color, 3,
    )
    max_km_h = 100
    full_height = window_rows - th - 3 * margin
    bar_margin = 30
    marked = max(int(full_height * velocity_km_h / max_km_h), 1)
    marked = min(marked, full_height)
    cv2.rectangle(
        panel, (bar_margin, margin),
        (window_cols - bar_margin, margin + full_height), color,
    )
    panel[
        margin + full_height - marked : margin + full_height,
        bar_margin : window_cols - bar_margin,
    ] = 255


def render_frame_number(frame, frame_idx: int):
    """Burn the frame index into the image (render_frame_numbers.cc:53-58)."""
    import cv2

    cv2.putText(
        frame, str(frame_idx), (10, 100),
        cv2.FONT_HERSHEY_SIMPLEX, 3.0, (255, 0, 0), 3,
    )
    return frame


class MotionRenderer:
    """Composites one output frame: video on top, wheel/speed panels below
    (render_motion.cc:233-285 layout: left wheel at column 0, right wheel at
    the right edge, velocity panels inboard of each wheel)."""

    def __init__(
        self,
        wheel_image: np.ndarray,
        steering_left: Optional[Dict[int, float]] = None,
        steering_right: Optional[Dict[int, float]] = None,
        velocities_left: Optional[Dict[int, float]] = None,
        velocities_right: Optional[Dict[int, float]] = None,
    ):
        self.wheel = wheel_image
        self.steering_left = steering_left
        self.steering_right = steering_right
        self.velocities_left = velocities_left
        self.velocities_right = velocities_right

    def out_shape(self, video_height: int, video_width: int):
        wh, ww = self.wheel.shape[:2]
        return video_height + wh, max(video_width, 4 * ww)

    def render(self, video_frame: np.ndarray, frame_idx: int) -> np.ndarray:
        import cv2

        vh, vw = video_frame.shape[:2]
        oh, ow = self.out_shape(vh, vw)
        out = np.zeros((oh, ow, 3), np.uint8)
        out[:vh, :vw] = video_frame
        wh, ww = self.wheel.shape[:2]

        def lookup(series, idx):
            return None if series is None else series.get(idx)

        left = lookup(self.steering_left, frame_idx)
        if left is not None:
            render_steering(out, vh, 0, self.wheel, left)
        right = lookup(self.steering_right, frame_idx)
        if right is not None:
            render_steering(out, vh, ow - ww, self.wheel, right)
        v_left = lookup(self.velocities_left, frame_idx)
        if v_left is not None:
            render_velocity(out, vh, ww, wh, ww, v_left)
        v_right = lookup(self.velocities_right, frame_idx)
        if v_right is not None:
            render_velocity(out, vh, ow - 2 * ww, wh, ww, v_right)
        return out
