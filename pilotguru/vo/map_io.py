"""Tracker map/session checkpointing.

The reference's ORB-SLAM2 fork adds a full protobuf map-serialization
subsystem (System::Serialize + SerializedSystem/Map/KeyFrame/... protos;
see SURVEY.md section 5, checkpoint/resume). Here the tracker state is a
handful of dense arrays + keyframe records, so a single compressed npz
captures everything needed to resume tracking or to relocalize against a
previously-built map.

Format v2 adds the LocalMapping maintenance state (per-point statistics,
stable keyframe ids) and the keyframe-relative frame anchors that
final_trajectory reconstructs from; v1 files still load with safe defaults.
"""

from __future__ import annotations

import numpy as np

from pilotguru.vo.tracking import FramePose, Keyframe, MonocularTracker

FORMAT_VERSION = 2


def save_tracker_map(tracker: MonocularTracker, path: str) -> None:
    """Serialize map points, keyframes and tracker motion state."""
    tracker._flush_point_desc()  # deferred created-point descriptor writes
    has_rel = [fp.rel6 is not None for fp in tracker.trajectory]
    data = {
        "format_version": np.asarray(FORMAT_VERSION),
        "state": np.asarray(tracker.state),
        "points": tracker.points,
        "point_desc": np.packbits(tracker.point_desc, axis=1),
        "point_valid": tracker.point_valid,
        "point_visible": tracker.point_visible,
        "point_found": tracker.point_found,
        "point_first_kf": tracker.point_first_kf,
        "point_recent": tracker.point_recent,
        "pose": tracker._pose,
        "motion": tracker._motion,
        "next_kf_id": np.asarray(tracker._next_kf_id),
        "num_keyframes": np.asarray(len(tracker.keyframes)),
        "frame_times": np.asarray(
            [fp.time_usec for fp in tracker.trajectory], np.int64
        ),
        "frame_ids": np.asarray(
            [fp.frame_id for fp in tracker.trajectory], np.int64
        ),
        "frame_poses": (
            np.stack([fp.pose6 for fp in tracker.trajectory])
            if tracker.trajectory
            else np.zeros((0, 6))
        ),
        "frame_lost": np.asarray(
            [fp.is_lost for fp in tracker.trajectory], bool
        ),
        "frame_ref_kf": np.asarray(
            [fp.ref_kf_id for fp in tracker.trajectory], np.int64
        ),
        "frame_rel": (
            np.stack(
                [
                    fp.rel6 if fp.rel6 is not None else np.zeros(6)
                    for fp in tracker.trajectory
                ]
            )
            if tracker.trajectory
            else np.zeros((0, 6))
        ),
        "frame_has_rel": np.asarray(has_rel, bool),
    }
    for i, kf in enumerate(tracker.keyframes):
        data[f"kf{i}_pose"] = kf.pose6
        data[f"kf{i}_kp_norm"] = kf.kp_norm
        data[f"kf{i}_desc"] = np.packbits(kf.descriptors, axis=1)
        data[f"kf{i}_valid"] = kf.kp_valid
        data[f"kf{i}_map_point"] = kf.map_point
        data[f"kf{i}_inliers"] = np.asarray(kf.num_inliers)
        data[f"kf{i}_id"] = np.asarray(kf.kf_id)
    np.savez_compressed(path, **data)


def load_tracker_map(path: str, tracker: MonocularTracker) -> MonocularTracker:
    """Restore a saved map into a freshly-constructed tracker (camera and
    config come from the tracker, mirroring the reference's
    deserializing-System constructor reusing a loaded vocabulary)."""
    loaded = np.load(path, allow_pickle=False)
    version = int(loaded["format_version"])
    if version not in (1, FORMAT_VERSION):
        raise ValueError(f"unsupported tracker map format {version}")
    points = loaded["points"]
    if points.shape[0] != tracker.points.shape[0]:
        raise ValueError(
            "tracker max_map_points does not match the saved map "
            f"({tracker.points.shape[0]} vs {points.shape[0]})"
        )
    tracker.points = points.copy()
    tracker.point_desc = np.unpackbits(loaded["point_desc"], axis=1)[:, :256]
    tracker.point_valid = loaded["point_valid"].copy()
    tracker._pose = loaded["pose"].copy()
    tracker._motion = loaded["motion"].copy()
    tracker.state = str(loaded["state"])
    num_frames = loaded["frame_ids"].shape[0]
    if version >= 2:
        tracker.point_visible = loaded["point_visible"].copy()
        tracker.point_found = loaded["point_found"].copy()
        tracker.point_first_kf = loaded["point_first_kf"].copy()
        tracker.point_recent = loaded["point_recent"].copy()
        tracker._next_kf_id = int(loaded["next_kf_id"])
        ref_kf = loaded["frame_ref_kf"]
        rel = loaded["frame_rel"]
        has_rel = loaded["frame_has_rel"]
    else:
        # v1 defaults: stats neutral (visible==found so nothing gets culled
        # for stale ratios), points treated as established, frames
        # unanchored (absolute poses stand as saved).
        m = tracker.points.shape[0]
        tracker.point_visible = tracker.point_valid.astype(np.int32)
        tracker.point_found = tracker.point_valid.astype(np.int32)
        tracker.point_first_kf = np.where(tracker.point_valid, 0, -1).astype(
            np.int32
        )
        tracker.point_recent = np.zeros(m, bool)
        tracker._next_kf_id = int(loaded["num_keyframes"])
        ref_kf = np.full(num_frames, -1, np.int64)
        rel = np.zeros((num_frames, 6))
        has_rel = np.zeros(num_frames, bool)

    tracker.trajectory = [
        FramePose(
            int(fid), int(ft), pose.copy(), bool(lost),
            ref_kf_id=int(rk), rel6=r.copy() if hr else None,
        )
        for fid, ft, pose, lost, rk, r, hr in zip(
            loaded["frame_ids"],
            loaded["frame_times"],
            loaded["frame_poses"],
            loaded["frame_lost"],
            ref_kf,
            rel,
            has_rel,
        )
    ]
    tracker.keyframes = []
    for i in range(int(loaded["num_keyframes"])):
        tracker.keyframes.append(
            Keyframe(
                pose6=loaded[f"kf{i}_pose"].copy(),
                kp_norm=loaded[f"kf{i}_kp_norm"].copy(),
                descriptors=np.unpackbits(loaded[f"kf{i}_desc"], axis=1)[
                    :, :256
                ],
                kp_valid=loaded[f"kf{i}_valid"].copy(),
                map_point=loaded[f"kf{i}_map_point"].copy(),
                num_inliers=int(loaded[f"kf{i}_inliers"]),
                kf_id=int(loaded[f"kf{i}_id"]) if version >= 2 else i,
            )
        )
    tracker._refresh_local_points()
    return tracker
