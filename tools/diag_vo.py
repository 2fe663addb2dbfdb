"""Diagnose VO tracking at reference scale.

Renders the exact bench ride (720p, 150 frames, 2000 feat / 8 levels),
runs the tracker with per-frame logging, and compares the estimated
trajectory against the analytically-known camera path
(tests/synthetic.py:render_parallax_video).

Run from the repository root:  python tools/diag_vo.py
"""

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tests.synthetic import render_parallax_video  # noqa: E402

from pilotguru.vo.camera import CameraSettings  # noqa: E402
from pilotguru.vo.pipeline import (  # noqa: E402
    prefetch_features,
    tracker_from_settings,
    trajectory_from_tracker,
    video_frames,
)
from pilotguru.vo.tracking import LOST  # noqa: E402


def main():
    width, height, frames, num_points, fx = 1280, 720, 150, 2400, 700.0
    scale_arg = float(sys.argv[1]) if len(sys.argv) > 1 else 1.0
    tmp = tempfile.mkdtemp(prefix="pgtpu_diag_")
    video = os.path.join(tmp, "ride720p.mp4")
    print(f"rendering {video} ...", flush=True)
    fx, fy, cx, cy, true_rates = render_parallax_video(
        video, width=width, height=height, frames=frames,
        num_points=num_points, fx=fx, period_frames=60.0,
    )
    settings = CameraSettings(fx=fx, fy=fy, cx=cx, cy=cy,
                              orb_features=2000, orb_levels=8)

    # True camera path (world frame of the renderer).
    period = 60.0
    ts = np.arange(frames)
    true_c = np.stack(
        [0.9 * np.sin(2 * np.pi * ts / period), 0.0 * ts, 0.015 * ts], axis=1
    )

    frames_iter = video_frames(video, scale=scale_arg)
    tracker = tracker_from_settings(settings, image_scale=scale_arg)
    frames_iter = prefetch_features(frames_iter, tracker.camera,
                                    tracker.config, 8)

    seg_start = 0
    segments = []
    t0 = time.time()
    fid = -1
    for frame in frames_iter:
        fid = frame.frame_id
        kp_norm, desc, valid, kp_level, kp_angle = frame.features
        state = tracker.process_features(
            kp_norm, desc, valid, frame.frame_id, frame.time_usec,
            kp_level=kp_level, kp_angle=kp_angle,
        )
        last = tracker.trajectory[-1] if tracker.trajectory else None
        ninl = tracker.keyframes[-1].num_inliers if tracker.keyframes else 0
        if fid % 10 == 0 or state == LOST:
            print(
                f"frame {fid:4d} state={state} kfs={len(tracker.keyframes)}"
                f" traj={len(tracker.trajectory)} last_kf_inliers={ninl}",
                flush=True,
            )
        if state == LOST:
            segments.append((seg_start, fid, tracker))
            print(f"--- LOST at frame {fid}; stats={tracker.stats}")
            seg_start = fid + 1
            tracker = tracker_from_settings(settings, image_scale=scale_arg)
    segments.append((seg_start, fid, tracker))
    print(f"tracked {fid+1} frames in {time.time()-t0:.1f}s; "
          f"{len(segments)} segments")

    for si, (lo, hi, trk) in enumerate(segments):
        trk.finalize()
        traj = trajectory_from_tracker(trk)
        if traj is None:
            print(f"segment {si} [{lo},{hi}]: too short")
            continue
        c = traj.translations  # estimated camera centers, tracker world
        # Align: tracker world = camera frame at first tracked frame.
        # Compare shape only: PCA eigenvalues of centered translations.
        cc = c - c.mean(axis=0)
        cov = cc.T @ cc / len(cc)
        w = np.linalg.eigvalsh(cov)[::-1]
        lam_ratio = w[2] / max(w[1], 1e-18)
        print(
            f"segment {si} [{lo},{hi}]: {len(c)} frames, "
            f"PCA eigvals={w}, lambda3/lambda2={lam_ratio:.4f} "
            f"({'ACCEPT' if lam_ratio <= 1e-2 else 'REJECT'})"
        )
        # Procrustes-align estimated to true path (similarity transform)
        # over the overlapping frame range to get a trajectory RMSE.
        ids = traj.frame_id
        tc = true_c[ids]
        est = c
        mu_e, mu_t = est.mean(0), tc.mean(0)
        e0, t0_ = est - mu_e, tc - mu_t
        # scale + rotation via Umeyama
        cov_et = t0_.T @ e0 / len(e0)
        u, s, vt = np.linalg.svd(cov_et)
        d = np.sign(np.linalg.det(u @ vt))
        dmat = np.diag([1, 1, d])
        r = u @ dmat @ vt
        var_e = (e0 ** 2).sum() / len(e0)
        scl = (s * [1, 1, d]).sum() / max(var_e, 1e-18)
        aligned = scl * (e0 @ r.T) + mu_t
        rmse = np.sqrt(((aligned - tc) ** 2).sum(axis=1).mean())
        # Out-of-plane (y) deviation of the aligned estimate:
        print(
            f"  sim3-aligned RMSE vs true path: {rmse:.4f} "
            f"(path extent ~{np.ptp(tc, axis=0)}), "
            f"aligned y-std={aligned[:,1].std():.4f}"
        )
        print(f"  stats={trk.stats}")


if __name__ == "__main__":
    main()
