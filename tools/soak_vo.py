"""Long-ride VO soak driver.

Renders a corridor drive with continuous scenery turnover and runs the
tracker at the reference feature budget (2000 features / 8 levels,
/root/reference/src/calibrate.cc:518-531), reporting arena-pressure stats
(points created/recycled, keyframes culled), segment structure, and
turn-rate fidelity over the FINAL third of the ride (bounded drift).

Usage: python tools/soak_vo.py [--frames 600] [--speed 0.1] [--width 640]
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def run_soak(
    frames: int,
    speed: float,
    width: int,
    height: int,
    fx: float,
    features: int = 2000,
    levels: int = 8,
    out_dir: str | None = None,
    max_map_points: int = 0,
):
    from pilotguru.formats import json_io
    from pilotguru.vo.camera import CameraSettings
    from pilotguru.vo.pipeline import (
        track_video_segments,
        tracker_from_settings,
        video_frames,
        prefetch_features,
    )
    from tests.synthetic import render_parallax_video

    tmp = out_dir or tempfile.mkdtemp(prefix="soak_vo_")
    video = os.path.join(tmp, "ride.mp4")
    t0 = time.time()
    fx, fy, cx, cy, true_rates = render_parallax_video(
        video, width=width, height=height, frames=frames, num_points=500,
        fx=fx, period_frames=120.0, forward_speed=speed, corridor=True,
    )
    render_s = time.time() - t0
    settings = CameraSettings(
        fx=fx, fy=fy, cx=cx, cy=cy, orb_features=features, orb_levels=levels
    )

    trackers = []

    def make_tracker():
        t = tracker_from_settings(settings)
        if max_map_points:
            # Engineered arena pressure: shrink the
            # point arena at the reference feature budget so recycling
            # actually engages on a soak-length ride. Rebuild the tracker
            # (arena arrays are sized in __init__).
            import dataclasses

            from pilotguru.vo.tracking import MonocularTracker

            config = dataclasses.replace(
                t.config, max_map_points=max_map_points
            )
            t = MonocularTracker(t.camera, config)
        trackers.append(t)
        return t

    seg_dir = os.path.join(tmp, "out")
    t0 = time.time()
    probe = tracker_from_settings(settings)
    frames_iter = prefetch_features(
        video_frames(video), probe.camera, probe.config, 8
    )
    segments, consumed = track_video_segments(
        frames_iter, settings, seg_dir, make_tracker=make_tracker,
        feature_batch_size=0,
    )
    track_s = time.time() - t0

    stats = {}
    for t in trackers:
        for k, v in t.stats.items():
            stats[k] = stats.get(k, 0) + v
    report = {
        "frames": consumed,
        "segments": segments,
        "trackers": len(trackers),
        "render_s": round(render_s, 1),
        "track_s": round(track_s, 1),
        "fps_cpu": round(consumed / track_s, 2),
        "stats": stats,
        "keyframes_live": sum(len(t.keyframes) for t in trackers[-1:]),
    }

    # Bounded drift: turn-rate correlation over the LAST third of every
    # accepted segment must hold up as well as the start.
    corrs = []
    tail_corrs = []
    for i in range(segments):
        root = json_io.read_json(
            os.path.join(seg_dir, f"trajectory-{i:04d}.json")
        )
        pts = root["trajectory"]
        rates = np.array([p.get("angular_velocity", 0.0) for p in pts])
        fids = np.array([p["frame_id"] for p in pts])
        if len(pts) > 30:
            corrs.append(
                float(np.corrcoef(rates[3:], true_rates[fids][3:])[0, 1])
            )
            n = len(pts)
            tail = slice(2 * n // 3, n)
            tail_corrs.append(
                float(
                    np.corrcoef(rates[tail], true_rates[fids][tail])[0, 1]
                )
            )
    report["segment_corrs"] = [round(c, 4) for c in corrs]
    report["segment_tail_corrs"] = [round(c, 4) for c in tail_corrs]
    return report


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--speed", type=float, default=0.1)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--fx", type=float, default=350.0)
    ap.add_argument("--features", type=int, default=2000)
    ap.add_argument("--levels", type=int, default=8)
    ap.add_argument("--max_map_points", type=int, default=0)
    args = ap.parse_args()
    rep = run_soak(
        args.frames, args.speed, args.width, args.height, args.fx,
        args.features, args.levels, max_map_points=args.max_map_points,
    )
    print(json.dumps(rep, indent=1))
