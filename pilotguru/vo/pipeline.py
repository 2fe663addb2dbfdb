"""optical_trajectories pipeline: video -> per-segment trajectory JSONs.

Reference flow (/root/reference/src/optical_trajectories.cc:73-111 +
src/slam/track_image_sequence.cc): run monocular odometry until tracking is
LOST, post-process the segment (optional quaternion smoothing, translation
PCA with the lambda3 flatness test, planar headings, turn angles), write
trajectory-N.json, then restart a fresh tracker on the remaining video.
"""

from __future__ import annotations

import functools
import os
import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

from pilotguru.formats.trajectory import Trajectory, write_trajectory
from pilotguru.timeseries.smoothing import smooth_quaternion_sequence
from pilotguru.vo.camera import CameraSettings
from pilotguru.vo.flatten import flatten_trajectory
from pilotguru.vo.tracking import (
    LOST,
    OK,
    CameraModel,
    MonocularTracker,
    TrackerConfig,
)


@dataclass
class VideoFrame:
    gray: np.ndarray  # [H, W] uint8 (preferred) or float32 in [0, 1]
    frame_id: int
    time_usec: int
    # Pre-extracted (kp_norm, desc, valid, level, angle) from the batched
    # prefetcher (host arrays; desc may stay device-resident); None means
    # the tracker extracts on its own.
    features: Optional[tuple] = None
    # Device-resident (kp_norm, desc, valid, level) rows from the batched
    # prefetcher — the chunked tracker consumes these with zero re-upload.
    dev_features: Optional[tuple] = None


def gray_as_float(gray: np.ndarray) -> np.ndarray:
    """[H, W] image as float32 in [0, 1] regardless of stored dtype."""
    if gray.dtype == np.uint8:
        return gray.astype(np.float32) / 255.0
    return gray


def gray_as_u8(gray: np.ndarray) -> np.ndarray:
    if gray.dtype == np.uint8:
        return gray
    return np.clip(gray * 255.0, 0.0, 255.0).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _extract_pack_jit(
    camera, num_levels, scale, total_budget, threshold, devices
):
    """Jitted batch extractor, cached per (camera, orb-config, device set).

    A closure-per-call design would re-jit (and re-COMPILE) it on every
    prefetch_features invocation, which puts a compile inside every tracked
    ride even after a warmup run. Module-level caching makes the
    compile once-per-process, so a warm run actually warms the timed run.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from pilotguru.vo.features import extract_orb_features_batch
    from pilotguru.vo.tracking import normalize_keypoints_device

    def extract_pack(images):
        if images.dtype == jnp.uint8:
            images = images.astype(jnp.float32) / 255.0
        kps = extract_orb_features_batch(
            images,
            num_levels=num_levels,
            scale=scale,
            total_budget=total_budget,
            threshold=threshold,
        )
        kp_norm = normalize_keypoints_device(kps.xy, camera)
        dt = kp_norm.dtype
        packed = jnp.concatenate(
            [
                kp_norm,
                kps.valid.astype(dt)[..., None],
                kps.level.astype(dt)[..., None],
                kps.angle.astype(dt)[..., None],
            ],
            axis=-1,
        )
        return packed, kp_norm, kps.descriptors, kps.valid, kps.level

    batch_sharding = None
    if len(devices) > 1:
        mesh = Mesh(np.asarray(devices), ("frames",))
        extract_pack = jax.shard_map(
            extract_pack,
            mesh=mesh,
            in_specs=P("frames"),
            out_specs=(P("frames"),) * 5,
        )
        batch_sharding = NamedSharding(mesh, P("frames"))

    def extract_split(images):
        # Per-frame output slices happen INSIDE the jitted program: the
        # prefetch worker thread must issue no eager device ops (an eager
        # getitem racing the consumer thread's jit dispatch aborts the CPU
        # client), and per-frame device rows are what the tracker consumes.
        packed, kp_norm, desc, valid, level = extract_pack(images)
        n = images.shape[0]
        return packed, (
            [kp_norm[i] for i in range(n)],
            [desc[i] for i in range(n)],
            [valid[i] for i in range(n)],
            [level[i] for i in range(n)],
        )

    return jax.jit(extract_split), batch_sharding


def prefetch_features(
    frames: Iterator[VideoFrame],
    camera,
    config,
    batch_size: int = 8,
    devices=None,
) -> Iterator[VideoFrame]:
    """Attach ORB features to frames, extracted in whole-batch device calls.

    Extraction is stateless per frame while tracking is sequential, so
    batching it amortizes dispatch latency and keeps the device busy. The
    host round trip is minimized to ONE blocking pull per batch: keypoint
    normalization runs on device (normalize_keypoints_device), every
    per-keypoint quantity rides back in a single packed array whose host
    copy is started asynchronously, and batches run ONE AHEAD — batch k+1
    is dispatched before batch k's results are consumed, so in steady
    state the pull finds the bytes already landed. uint8 frames upload at
    a quarter of the float bandwidth and convert on device. Short tail
    batches are padded by repetition (results sliced away). Device arrays
    (normalized keypoints, descriptors, validity, levels) stay resident
    per frame in ``dev_features`` for the chunked tracker.

    Extraction is the embarrassingly-parallel half of VO (SURVEY section
    2.8): with multiple devices the batch is sharded over a 1-D
    ("frames",) mesh via ``shard_map`` — each device runs its shard of
    frames through the (sequential lax.map) extractor with zero
    collectives, so devices proceed in parallel while XLA keeps the
    single-frame fusion the in-program map preserves. ``devices``:
    explicit device list (defaults to all local devices; single-device
    keeps the plain path). batch_size is rounded up to a device-count
    multiple by the existing tail padding.

    The whole launch/finish loop runs in a DAEMON WORKER THREAD feeding a
    bounded queue: frame upload, extraction, and the packed pull all overlap the
    consumer's tracking work instead of serializing with it. Queue depth
    bounds device memory at ~3 batches of descriptors in flight.
    """
    import jax
    import jax.numpy as jnp

    if devices is None:
        devices = jax.devices()
    n_dev = len(devices)
    if n_dev > 1:
        batch_size = -(-batch_size // n_dev) * n_dev

    extract_pack, batch_sharding = _extract_pack_jit(
        camera,
        config.num_levels,
        config.scale,
        config.total_budget,
        config.fast_threshold,
        tuple(devices),
    )

    def launch(batch):
        grays = [np.asarray(f.gray) for f in batch]
        while len(grays) < batch_size:  # pad tail batch, reuse compile
            grays.append(grays[-1])
        stacked = np.stack(grays)
        if batch_sharding is not None:
            device_batch = jax.device_put(stacked, batch_sharding)
        else:
            device_batch = jnp.asarray(stacked)
        packed, rows = extract_pack(device_batch)
        if hasattr(packed, "copy_to_host_async"):
            packed.copy_to_host_async()
        return batch, packed, rows

    def finish(launched):
        batch, packed, (kp_norm, desc, valid, level) = launched
        host = np.asarray(packed)
        for i, f in enumerate(batch):
            # Per-keypoint bookkeeping comes back in the one packed pull;
            # descriptors STAY on device — matching consumes them there,
            # and the tracker pulls a host copy only when a frame is
            # promoted to keyframe.
            f.features = (
                host[i, :, :2],
                desc[i],
                host[i, :, 2] > 0.5,
                host[i, :, 3].astype(np.int32),
                host[i, :, 4],
            )
            f.dev_features = (kp_norm[i], desc[i], valid[i], level[i])
            yield f

    def pipeline() -> Iterator[VideoFrame]:
        in_flight = None
        pending: list[VideoFrame] = []
        for frame in frames:
            pending.append(frame)
            if len(pending) == batch_size:
                launched = launch(pending)
                pending = []
                if in_flight is not None:
                    yield from finish(in_flight)
                in_flight = launched
        if pending:
            launched = launch(pending)
            if in_flight is not None:
                yield from finish(in_flight)
            in_flight = launched
        if in_flight is not None:
            yield from finish(in_flight)

    if os.environ.get("PGTPU_PREFETCH_THREAD", "1") == "0":
        # Debug/fallback knob: run the launch/finish pipeline inline in the
        # consumer thread (still one batch ahead, just no cross-thread
        # overlap of uploads with tracking).
        yield from pipeline()
        return

    out: queue.Queue = queue.Queue(maxsize=3 * batch_size)
    done = object()

    def run():
        try:
            for f in pipeline():
                out.put(f)
            out.put(done)
        except BaseException as exc:  # surface in the consumer thread
            out.put(exc)

    threading.Thread(target=run, daemon=True, name="orb-prefetch").start()
    while True:
        item = out.get()
        if item is done:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def video_frames(
    video_path: str,
    vertical_flip: bool = False,
    horizontal_flip: bool = False,
    scale: float = 1.0,
) -> Iterator[VideoFrame]:
    """Decode a ride video to grayscale uint8 frames with timestamps.

    Prefers the native libav reader (native/libpgvideo.so: rotation
    metadata + exact presentation timestamps, mirroring the reference's
    src/io/image_sequence_reader.cc); falls back to cv2 when the library is
    not built. Flips mirror --vertical_flip/--horizontal_flip. Frames stay
    uint8 (the extractor converts on device — a quarter of the float
    upload bandwidth).
    """
    from pilotguru.video import native as native_video
    from pilotguru.video.io import is_image_list, read_image_list_rgb

    if is_image_list(video_path):
        # TUM-style image list (MakeImageSequenceSource's directory+index
        # input, image_sequence_reader.cc:19-46).
        import cv2

        for frame_id, time_usec, rgb in read_image_list_rgb(
            video_path, vertical_flip, horizontal_flip
        ):
            gray = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
            if scale != 1.0:
                gray = cv2.resize(
                    gray, None, fx=scale, fy=scale,
                    interpolation=cv2.INTER_AREA,
                )
            yield VideoFrame(gray, frame_id, time_usec)
        return

    if native_video.available():
        import cv2

        with native_video.NativeVideoReader(
            video_path, vertical_flip, horizontal_flip
        ) as reader:
            frame_id = 0
            for rgb, pts_usec in reader:
                gray = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
                if scale != 1.0:
                    gray = cv2.resize(
                        gray, None, fx=scale, fy=scale,
                        interpolation=cv2.INTER_AREA,
                    )
                yield VideoFrame(gray, frame_id, pts_usec)
                frame_id += 1
        return

    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise ValueError(f"cannot open video {video_path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    frame_id = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        if scale != 1.0:
            gray = cv2.resize(
                gray, None, fx=scale, fy=scale, interpolation=cv2.INTER_AREA
            )
        if vertical_flip:
            gray = gray[::-1]
        if horizontal_flip:
            gray = gray[:, ::-1]
        msec = cap.get(cv2.CAP_PROP_POS_MSEC)
        time_usec = int(msec * 1000) if msec > 0 else int(frame_id / fps * 1e6)
        yield VideoFrame(gray, frame_id, time_usec)
        frame_id += 1
    cap.release()


def background_frames(frames: Iterator[VideoFrame], maxsize: int = 16):
    """Run a frame iterator in a daemon thread so video decode overlaps
    device work (the reference decodes inline on the tracking thread,
    image_sequence_reader.cc; here decode is pure host work that would
    otherwise serialize with every device round trip). Exceptions re-raise
    in the consumer."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=maxsize)
    done = object()

    def run():
        try:
            for item in frames:
                q.put(item)
            q.put(done)
        except BaseException as exc:  # propagate into the consumer
            q.put(exc)

    threading.Thread(target=run, daemon=True).start()
    while True:
        item = q.get()
        if item is done:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def tracker_from_settings(
    settings: CameraSettings, image_scale: float = 1.0
) -> MonocularTracker:
    camera = CameraModel(
        fx=settings.fx * image_scale,
        fy=settings.fy * image_scale,
        cx=settings.cx * image_scale,
        cy=settings.cy * image_scale,
        # Distortion coefficients act on the normalized plane, so they are
        # invariant to image_scale (Frame.cc UndistortKeyPoints parity).
        k1=settings.k1,
        k2=settings.k2,
        p1=settings.p1,
        p2=settings.p2,
    )
    # Reference scale by default: 2000 features / 8 pyramid levels
    # (calibrate.cc:518-531); the camera YAML is the source of truth.
    config = TrackerConfig(
        total_budget=settings.orb_features,
        num_levels=settings.orb_levels,
        fast_threshold=settings.orb_ini_th_fast / 255.0,
    )
    return MonocularTracker(camera, config)


def trajectory_from_tracker(tracker: MonocularTracker) -> Optional[Trajectory]:
    # Reconstruct absolute poses from the CURRENT keyframe poses so local-BA
    # and loop-closure corrections reach every frame (System::GetTrajectory
    # semantics, System.cc:371-413).
    frames = [fp for fp in tracker.final_trajectory() if not fp.is_lost]
    if len(frames) < 10:
        return None
    return Trajectory(
        time_usec=np.asarray([fp.time_usec for fp in frames], np.int64),
        frame_id=np.asarray([fp.frame_id for fp in frames], np.int64),
        is_lost=np.zeros(len(frames), bool),
        translations=np.stack([fp.camera_center() for fp in frames]),
        rotations=np.stack([fp.camera_to_world_quat() for fp in frames]),
    )


def postprocess_segment(
    trajectory: Trajectory, rotation_smooth_sigma: int = 0
) -> Optional[Trajectory]:
    """Smoothing + PCA flattening (TrackImageSequence post-loop,
    track_image_sequence.cc:63-110). Returns None if the segment fails the
    flatness test."""
    if rotation_smooth_sigma > 0:
        trajectory.rotations = np.asarray(
            smooth_quaternion_sequence(trajectory.rotations, rotation_smooth_sigma)
        )
    result = flatten_trajectory(trajectory)
    if result is None:
        return None
    plane, directions, angles = result
    trajectory.plane = plane
    trajectory.planar_directions = directions
    trajectory.turn_angles = angles
    return trajectory


def _overlay_frame(gray, tracker, frame, state, rows):
    """Render the tracked-feature overlay for one frame (headless stand-in
    for the reference's live FrameDrawer window): detected keypoints as
    dots, map-point inlier tracks (``rows``: tracked keypoint indices) as
    circles, plus a status line."""
    import cv2

    img = cv2.cvtColor(gray_as_u8(gray), cv2.COLOR_GRAY2BGR)
    if frame.features is not None:
        kp_norm, _, valid, *_ = frame.features
        pix = tracker.camera.denormalize(np.asarray(kp_norm))
        h, w = gray.shape
        for x, y in pix[np.asarray(valid)]:
            if 0 <= x < w and 0 <= y < h:
                cv2.circle(img, (int(x), int(y)), 1, (0, 160, 0), -1)
        if state == OK and rows.size:
            for x, y in pix[rows]:
                if 0 <= x < w and 0 <= y < h:
                    cv2.circle(img, (int(x), int(y)), 4, (0, 0, 230), 1)
    text = (
        f"f{frame.frame_id} {state} inl={rows.size} "
        f"map={int(tracker.point_valid.sum())} kfs={len(tracker.keyframes)}"
    )
    cv2.putText(
        img, text, (8, 18), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1
    )
    return img


def track_video_segments(
    frames: Iterator[VideoFrame],
    settings: CameraSettings,
    out_dir: str,
    rotation_smooth_sigma: int = 0,
    image_scale: float = 1.0,
    make_tracker=None,
    feature_batch_size: int = 8,
    per_segment_videos: bool = False,
    visualize: bool = False,
    fps: float = 30.0,
    live_view_port: Optional[int] = None,
) -> Tuple[int, int]:
    """Segment loop (optical_trajectories.cc:91-111): fresh tracker per
    segment, restart after LOST, one JSON per valid segment.

    With the default tracker, features are prefetched in device batches of
    ``feature_batch_size`` (pass 0 to disable). Returns (segments_written,
    frames_consumed).

    ``per_segment_videos`` writes trajectory-NNNN.mp4 next to each
    trajectory JSON containing exactly the OK-tracked frames, and remaps
    the JSON frame ids to index into that video (the reference's
    --output_per_segment_videos, optical_trajectories.cc:53-57 +
    track_image_sequence.cc:58-60,103-104: the sink consumes OK-state
    frames and frame_id_offset is the first tracked frame id; trajectory
    entries before the first OK frame — the initialization reference frame
    — are dropped since they have no frame in the segment video).

    ``visualize`` writes a visualize-NNNN.mp4 overlay per segment (tracked
    keypoints + status) — the offline stand-in for the reference's live
    Pangolin/FrameDrawer windows (--visualize).

    ``live_view_port`` serves the LIVE equivalent over HTTP while the ride
    tracks (vo/viewer.py: MJPEG overlay stream + top-down map canvas, the
    FrameDrawer/MapDrawer pair of Viewer.cc) — port 0 binds an ephemeral
    port, printed on startup.
    """
    os.makedirs(out_dir, exist_ok=True)
    if make_tracker is None:
        make_tracker = lambda: tracker_from_settings(settings, image_scale)
        if feature_batch_size > 0:
            probe = make_tracker()
            frames = prefetch_features(
                background_frames(frames), probe.camera, probe.config,
                feature_batch_size,
            )
    viewer = None
    if live_view_port is not None:
        from pilotguru.vo.viewer import LiveViewer

        viewer = LiveViewer(live_view_port)
        print(f"live tracker view: http://localhost:{viewer.port}/")
    segment = 0
    raw_segment = 0  # includes segments later rejected (video file naming)
    consumed = 0
    exhausted = False
    buf: list = []  # frames decoded/prefetched but not yet fed to a tracker
    while not exhausted or buf:
        tracker = make_tracker()
        chunk_size = getattr(tracker.config, "track_chunk_frames", 0)
        fed = 0
        first_ok_fid = None
        seg_writer = None
        viz_writer = None
        seg_video_path = None
        viz_video_path = None
        if per_segment_videos or visualize:
            import cv2  # noqa: F401 — fail early, before tracking starts

        def handle_frame(frame, state, rows):
            nonlocal consumed, fed, first_ok_fid
            nonlocal seg_writer, viz_writer, seg_video_path, viz_video_path
            consumed += 1
            fed += 1
            if state == OK:
                if first_ok_fid is None:
                    first_ok_fid = frame.frame_id
                if per_segment_videos:
                    import cv2

                    if seg_writer is None:
                        seg_video_path = os.path.join(
                            out_dir, f"trajectory-{raw_segment:04d}.mp4"
                        )
                        h, w = frame.gray.shape
                        seg_writer = cv2.VideoWriter(
                            seg_video_path,
                            cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h),
                        )
                    seg_writer.write(
                        cv2.cvtColor(gray_as_u8(frame.gray), cv2.COLOR_GRAY2BGR)
                    )
            if visualize or viewer is not None:
                import cv2

                overlay = _overlay_frame(
                    frame.gray, tracker, frame, state, rows
                )
                if visualize:
                    if viz_writer is None:
                        viz_video_path = os.path.join(
                            out_dir, f"visualize-{raw_segment:04d}.mp4"
                        )
                        h, w = frame.gray.shape
                        viz_writer = cv2.VideoWriter(
                            viz_video_path,
                            cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h),
                        )
                    viz_writer.write(overlay)
                if viewer is not None:
                    viewer.publish_frame(overlay)
                    viewer.publish_state(
                        tracker, frame.frame_id, state, rows.size
                    )

        state = None
        while True:
            while len(buf) < max(chunk_size, 1) and not exhausted:
                nxt = next(frames, None)
                if nxt is None:
                    exhausted = True
                else:
                    buf.append(nxt)
            if not buf:
                break
            if (
                tracker.state == OK
                and chunk_size > 0
                and buf[0].features is not None
            ):
                # Steady state: one device round trip tracks a whole chunk,
                # including across mid-chunk keyframe insertions (the
                # reference's Tracking-vs-LocalMapping lag). The chunk stops
                # early only at tracking failures and at frames that must
                # become keyframes from fresh-map results; the unconsumed
                # tail stays in ``buf`` for the next call.
                results = tracker.process_chunk(buf[:chunk_size])
                done = buf[: len(results)]
                del buf[: len(results)]
                for frame, (state, rows) in zip(done, results):
                    handle_frame(frame, state, rows)
            else:
                frame = buf.pop(0)
                if frame.features is not None:
                    kp_norm, desc, valid, *rest = frame.features
                    kp_level, kp_angle = rest if rest else (None, None)
                    state = tracker.process_features(
                        kp_norm, desc, valid, frame.frame_id, frame.time_usec,
                        kp_level=kp_level, kp_angle=kp_angle,
                    )
                else:
                    state = tracker.process_frame(
                        frame.gray, frame.frame_id, frame.time_usec
                    )
                handle_frame(frame, state, tracker.last_track_kp_rows)
            if state == LOST:
                break
        tracker.finalize()  # terminal loop-closure pass (max revisit overlap)
        if seg_writer is not None:
            seg_writer.release()
        if viz_writer is not None:
            viz_writer.release()
        trajectory = trajectory_from_tracker(tracker)
        accepted = False
        if trajectory is not None:
            processed = postprocess_segment(trajectory, rotation_smooth_sigma)
            if processed is not None:
                offset = 0
                if per_segment_videos and first_ok_fid is not None:
                    # Remap ids to segment-video frame indices; drop the
                    # init reference frame (no frame in the video).
                    offset = int(first_ok_fid)
                    keep = processed.frame_id >= first_ok_fid
                    if not keep.all():
                        processed = Trajectory(
                            time_usec=processed.time_usec[keep],
                            frame_id=processed.frame_id[keep],
                            is_lost=processed.is_lost[keep],
                            translations=processed.translations[keep],
                            rotations=processed.rotations[keep],
                            plane=processed.plane,
                            planar_directions=(
                                processed.planar_directions[keep]
                                if processed.planar_directions is not None
                                else None
                            ),
                            turn_angles=(
                                processed.turn_angles[keep]
                                if processed.turn_angles is not None
                                else None
                            ),
                        )
                write_trajectory(
                    processed,
                    os.path.join(out_dir, f"trajectory-{segment:04d}.json"),
                    frame_id_offset=offset,
                )
                if per_segment_videos and seg_video_path is not None:
                    want = os.path.join(
                        out_dir, f"trajectory-{segment:04d}.mp4"
                    )
                    if want != seg_video_path:
                        os.replace(seg_video_path, want)
                        seg_video_path = want
                if visualize and viz_video_path is not None:
                    want = os.path.join(out_dir, f"visualize-{segment:04d}.mp4")
                    if want != viz_video_path:
                        os.replace(viz_video_path, want)
                        viz_video_path = want
                segment += 1
                accepted = True
            else:
                # Same silent-drop as the reference's lambda3 test, but say
                # so: "0 segments" on a well-tracked video reads like a
                # tracking failure otherwise.
                print(
                    f"segment with {len(trajectory)} tracked frames rejected "
                    "by the trajectory-plane flatness test (not planar)"
                )
        if not accepted:
            # Drop videos of rejected segments (the reference's sink writes
            # them regardless; we keep the directory aligned with the JSONs
            # so trajectory-N.json always pairs with trajectory-N.mp4).
            for stale in (seg_video_path, viz_video_path):
                if stale is not None and os.path.exists(stale):
                    os.remove(stale)
        raw_segment += 1
        if fed == 0:
            break
    if viewer is not None:
        viewer.close()
    return segment, consumed
