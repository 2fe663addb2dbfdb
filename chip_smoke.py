#!/usr/bin/env python3
"""Smoke run of pilotguru's calibration and visual-odometry path on a GPU.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # only the paths that span four cards

One card: fit_motion on a 20-minute ride (2x200 Hz IMU, 1 Hz GPS) against
the analytic speed and against the same ride solved in float64 on the CPU;
an 8-ride corpus through ``fit_motion_corpus``; a 150-frame 1280x720 ride
through ``track_video_segments`` at the reference ORB budget; the ORB
extractor, Hamming table and int8 BRIEF product compared with the CPU and
numpy at 720p and 1080p.

Four cards: ``preprocess_corpus --shard_windows`` over a 4-card
``("windows",)`` mesh against the same corpus on one card, and VO with
feature extraction spread over all four cards against one card.

This is a smoke check, not a benchmark: the wall times it prints include
compilation. It runs in one process (JAX reserves most of a card's memory
at start), exits non-zero and prints no result when JAX's first device is
not a GPU or any phase fails, and ends a passing run with one JSON line
naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
# The repo root (pilotguru, bench) and tests/ (the ride renderer, imported
# as a top-level module: an installed package named ``tests`` would shadow
# the namespace package ``tests``).
for _path in (REPO, os.path.join(REPO, "tests")):
    if _path not in sys.path:
        sys.path.insert(0, _path)

# Gates and tolerances, each with its reason.
RMSE_GATE_M_S = 0.5  # bench.py's quality gate on the velocity RMSE.
# Speeds from two runs that differ only in rounding: the window solves are
# ill-conditioned along some parameter directions, so rounding moves the
# speeds. float32 against float64, both on the CPU, differ by up to
# 0.015 m/s on 60-300 s rides; a 4-way window sharding against one device
# by up to 0.003 m/s even in float64. The tolerance leaves about 3x the
# former for the card's other summation order, and is a tenth of the RMSE
# gate.
DV_TOLERANCE_M_S = 0.05
CORR_GATE = 0.8  # tests/test_vo_pipeline.py's turn-rate correlation gate.
# The extractor's pyramid, FAST scores, blur and orientation moments are
# exact integers (vo/features.py), so the card and the CPU should select
# the same keypoints; the floor leaves room only for top-k's order among
# equal cell scores.
IDENTICAL_KEYPOINT_FLOOR = 0.99
XY_TIE_PX = 1e-2  # subpixel offsets are float quotients of those integers

# The bench's 720p scene: 2400 billboards, one lateral swing per 60 frames.
VO_POINTS, VO_PERIOD_FRAMES = 2400, 60.0
# (width, height, focal length in px) of the 720p and 1080p frames.
FRAME_SIZES = ((1280, 720, 700.0), (1920, 1080, 1050.0))


def card_line() -> str:
    """The card's name and power limit, read without JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def run_phase(failures: list, name: str, fn, describe) -> None:
    """Run one phase and print its wall time and checks. A failure is
    printed and recorded in ``failures``, which fails the run."""
    try:
        result = fn()
    except Exception:  # recorded in failures: the run exits non-zero
        traceback.print_exc()
        failures.append(name)
        print(f"phase {name}: FAILED", flush=True)
        return
    print(f"phase {name}: {result['seconds']:.2f} s wall (compile included); "
          f"{describe(result)}", flush=True)


def _rmse_vs_truth(result) -> float:
    import numpy as np

    # bench.make_ride's analytic speed.
    t_sec = (result.velocity_times_usec - 1_000_000) * 1e-6
    want = 9.0 + 3.0 * np.sin(2 * np.pi * t_sec / 37.0)
    return float(np.sqrt(np.mean((result.velocities_m_s - want) ** 2)))


def fit_motion_phase(duration_sec: float, device, ref_device, dtype) -> dict:
    """One ride through ``fit_motion_arrays`` with the CLI's settings, on
    ``device`` in ``dtype``, against the analytic speed and against the
    same ride in float64 on ``ref_device``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import make_ride
    from pilotguru.calib import FitMotionConfig, fit_motion_arrays

    rot_t, rates, acc_t, accs, gps_t, gps_v, _ = make_ride(duration_sec)
    start = time.perf_counter()
    with jax.default_device(device):
        got = fit_motion_arrays(
            rot_t, rates, acc_t, accs, gps_t, gps_v, FitMotionConfig(dtype=dtype)
        )
    seconds = time.perf_counter() - start
    with jax.default_device(ref_device), jax.enable_x64(True):
        ref = fit_motion_arrays(
            rot_t, rates, acc_t, accs, gps_t, gps_v,
            FitMotionConfig(dtype=jnp.float64),
        )
    if not np.array_equal(got.velocity_times_usec, ref.velocity_times_usec):
        raise AssertionError("velocity timestamps differ from the reference")
    if not np.isfinite(got.velocities_m_s).all():
        raise AssertionError("non-finite velocities")
    rmse = _rmse_vs_truth(got)
    dv = float(np.max(np.abs(got.velocities_m_s - ref.velocities_m_s)))
    if rmse > RMSE_GATE_M_S:
        raise AssertionError(f"RMSE {rmse} m/s > {RMSE_GATE_M_S}")
    if dv > DV_TOLERANCE_M_S:
        raise AssertionError(
            f"max |dv| vs float64 {dv} m/s > {DV_TOLERANCE_M_S}"
        )
    return {"seconds": seconds, "rmse": rmse, "max_dv": dv,
            "events": int(got.velocities_m_s.shape[0])}


def corpus_rides(num_rides: int, duration_sec: float):
    from bench import make_ride
    from pilotguru.calib import RideArrays

    return [
        RideArrays(*make_ride(duration_sec, seed=seed)[:6])
        for seed in range(num_rides)
    ]


def corpus_phase(num_rides: int, duration_sec: float, dtype) -> dict:
    """``num_rides`` rides through ``fit_motion_corpus`` (the
    preprocess_corpus path); every ride must pass the RMSE gate."""
    from pilotguru.calib import FitMotionConfig, fit_motion_corpus

    rides = corpus_rides(num_rides, duration_sec)
    start = time.perf_counter()
    results = fit_motion_corpus(rides, FitMotionConfig(dtype=dtype))
    seconds = time.perf_counter() - start
    rmses = [_rmse_vs_truth(r) for r in results]
    if len(results) != num_rides or max(rmses) > RMSE_GATE_M_S:
        raise AssertionError(f"corpus RMSEs {rmses} (gate {RMSE_GATE_M_S})")
    return {"seconds": seconds, "rmses": rmses}


def vo_settings(width: int, height: int, fx: float, features: int,
                levels: int):
    from pilotguru.vo.camera import CameraSettings

    return CameraSettings(
        fx=fx, fy=fx, cx=width / 2.0, cy=height / 2.0,
        orb_features=features, orb_levels=levels,
    )


def track_rendered_ride(out_dir: str, frames: int, width: int, height: int,
                        fx: float, features: int, levels: int,
                        devices=None, num_points: int = VO_POINTS,
                        period_frames: float = VO_PERIOD_FRAMES) -> dict:
    """Track a rendered parallax ride through ``track_video_segments``, the
    call ``optical_trajectories`` makes after decoding, and check each
    written trajectory's turn rate against the renderer's yaw rate.

    ``devices`` spreads feature extraction over those devices (the
    extracted features are then returned too); None keeps the CLI's
    default (every local device).
    """
    import numpy as np

    from pilotguru.formats import json_io
    from pilotguru.vo.pipeline import (
        VideoFrame,
        prefetch_features,
        track_video_segments,
        tracker_from_settings,
    )
    from synthetic import parallax_frames, parallax_yaw_rates

    settings = vo_settings(width, height, fx, features, levels)
    grays = list(parallax_frames(
        width=width, height=height, frames=frames, fx=fx,
        num_points=num_points, period_frames=period_frames,
    ))
    video = (
        VideoFrame(g, i, 1_000_000 + int(i * 1e6 / 30.0))
        for i, g in enumerate(grays)
    )
    make_tracker = None
    extracted = []
    if devices is not None:
        probe = tracker_from_settings(settings)

        def recorded(frames):
            for f in frames:
                extracted.append([np.asarray(a) for a in f.features])
                yield f

        video = recorded(prefetch_features(video, probe.camera, probe.config,
                                           8, devices=devices))
        make_tracker = lambda: tracker_from_settings(settings)  # noqa: E731
    start = time.perf_counter()
    segments, consumed = track_video_segments(
        video, settings, out_dir, feature_batch_size=8,
        make_tracker=make_tracker,
    )
    seconds = time.perf_counter() - start
    true_rates = parallax_yaw_rates(frames, period_frames)
    trajectories, corrs = [], []
    for k in range(segments):
        root = json_io.read_json(os.path.join(out_dir, f"trajectory-{k:04d}.json"))
        points = root["trajectory"]
        rates = np.array([p.get("angular_velocity", 0.0) for p in points])
        ids = np.array([p["frame_id"] for p in points])
        corrs.append(float(np.corrcoef(rates[3:], true_rates[ids][3:])[0, 1]))
        trajectories.append(
            (ids, np.array([p["pose"]["translation"] for p in points]))
        )
    best = max((abs(c) for c in corrs), default=0.0)
    if segments < 1 or not best > CORR_GATE:
        raise AssertionError(
            f"{segments} segments, turn-rate correlations {corrs} "
            f"(need one above {CORR_GATE})"
        )
    return {"seconds": seconds, "segments": segments, "frames": consumed,
            "corrs": corrs, "trajectories": trajectories,
            "features": extracted}


def extractor_parity_phase(width: int, height: int, fx: float, frames: int,
                           device, ref_device) -> dict:
    """The ORB extractor on ``device`` against the same jnp extractor on
    ``ref_device``, and the Hamming table against numpy."""
    import jax
    import numpy as np

    from pilotguru.vo.features import extract_orb_features
    from pilotguru.vo.matching import hamming_table
    from synthetic import parallax_frames

    grays = list(parallax_frames(
        width=width, height=height, frames=frames, fx=fx,
        num_points=VO_POINTS, period_frames=VO_PERIOD_FRAMES,
    ))
    start = time.perf_counter()
    identical = valid_total = desc_mismatch = 0
    descs = []
    for g in grays:
        img = np.asarray(g, np.float32) / 255.0
        got = jax.device_get(extract_orb_features(jax.device_put(img, device)))
        ref = jax.device_get(
            extract_orb_features(jax.device_put(img, ref_device))
        )
        same = (
            got.valid & ref.valid & (got.level == ref.level)
            & (np.abs(got.xy - ref.xy).max(axis=1) <= XY_TIE_PX)
        )
        identical += int(same.sum())
        valid_total += int(got.valid.sum())
        desc_mismatch += int(
            (got.descriptors[same] != ref.descriptors[same]).any(axis=1).sum()
        )
        descs.append((got.descriptors, got.valid))
    share = identical / max(valid_total, 1)
    (da, va), (db, vb) = descs[0], descs[-1]
    table = np.asarray(hamming_table(
        jax.device_put(da, device), jax.device_put(db, device),
        jax.device_put(va, device), jax.device_put(vb, device),
    ))
    want = (da[:, None, :] != db[None, :, :]).sum(axis=-1)
    want = np.where(va[:, None] & vb[None, :], want, 257).astype(np.int16)
    seconds = time.perf_counter() - start
    if share < IDENTICAL_KEYPOINT_FLOOR:
        raise AssertionError(f"identical keypoint share {share}")
    if desc_mismatch:
        raise AssertionError(
            f"{desc_mismatch} identical keypoints with other descriptors"
        )
    if table.dtype != want.dtype or not np.array_equal(table, want):
        raise AssertionError("hamming_table differs from numpy")
    return {"seconds": seconds, "identical_share": share,
            "keypoints": valid_total, "desc_mismatch": desc_mismatch}


def brief_int8_phase(device, keypoints: int = 2000) -> dict:
    """The int8 BRIEF product (K = 39*39 = 1521, not a multiple of 4)
    compiled for ``device``, against numpy's exact product."""
    import jax
    import numpy as np

    from pilotguru.vo import features

    rng = np.random.default_rng(0)
    size = features._PATCH_SIZE
    patches = rng.uniform(size=(keypoints, size, size)).astype(np.float32)
    angles = rng.uniform(-np.pi, np.pi, size=keypoints).astype(np.float32)
    start = time.perf_counter()
    fn = jax.jit(features.brief_from_patches)
    compiled = fn.lower(
        jax.device_put(patches, device), jax.device_put(angles, device)
    ).compile()
    got = np.asarray(compiled(jax.device_put(patches, device),
                              jax.device_put(angles, device)))
    seconds = time.perf_counter() - start
    q = np.clip(np.round(patches * 255.0), 0, 255) - 128
    # In float64, whose BLAS product is exact here (integer terms, sums of
    # magnitude <= 256) and minutes faster than numpy's integer matmul.
    vals = q.reshape(keypoints, -1).astype(np.float64) @ (
        features._BRIEF_BIN_MATRIX.astype(np.float64)
    )
    vals = vals.reshape(keypoints, features.BRIEF_ANGLE_BINS, -1)
    bins = np.mod(
        np.round(angles / (2 * np.pi / features.BRIEF_ANGLE_BINS)).astype(int),
        features.BRIEF_ANGLE_BINS,
    )
    want = (vals[np.arange(keypoints), bins] < 0).astype(np.uint8)
    targets = sorted(set(re.findall(r'custom_call_target="([^"]+)"',
                                    compiled.as_text())))
    lowering = ", ".join(targets) if targets else "XLA fusions only"
    if not np.array_equal(got, want):
        raise AssertionError("int8 BRIEF product differs from numpy")
    return {"seconds": seconds, "lowering": lowering}


def corpus_cli_phase(corpus_dir: str, num_rides: int, duration_sec: float,
                     shard_windows: bool) -> dict:
    """``preprocess_corpus`` over a directory of recorder-format rides;
    returns each ride's written velocities."""
    import numpy as np

    from pilotguru.cli import preprocess_corpus
    from pilotguru.formats import json_io, keys
    import synthetic

    if not os.path.isdir(corpus_dir):
        for k in range(num_rides):
            ride = synthetic.make_ride(
                duration_sec=duration_sec, imu_hz=200.0, jitter_seed=k
            )
            synthetic.write_ride_jsons(ride, os.path.join(corpus_dir, f"ride{k}"))
    out = "sharded" if shard_windows else "single"
    argv = [f"--corpus_dir={corpus_dir}", f"--out_subdir={out}"]
    if shard_windows:
        argv.append("--shard_windows")
    start = time.perf_counter()
    if preprocess_corpus.main(argv) != 0:
        raise AssertionError("preprocess_corpus failed")
    seconds = time.perf_counter() - start
    velocities = []
    for k in range(num_rides):
        root = json_io.read_json(
            os.path.join(corpus_dir, f"ride{k}", out, "velocities-imu.json")
        )
        velocities.append(
            np.array([e[keys.SPEED_M_S] for e in root[keys.VELOCITIES]])
        )
    return {"seconds": seconds, "velocities": velocities}


def run_one_card(failures: list) -> None:
    import jax

    from pilotguru.cli._common import setup_backend

    dtype = setup_backend("auto")
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")

    run_phase(
        failures,
        "fit_motion",
        lambda: fit_motion_phase(1200.0, gpu, cpu, dtype),
        lambda r: (
            f"{r['events']} velocity events; RMSE {r['rmse']:.4f} m/s "
            f"(gate <= {RMSE_GATE_M_S}); max |dv| vs CPU float64 "
            f"{r['max_dv']:.6f} m/s (tolerance {DV_TOLERANCE_M_S})"
        ),
    )
    run_phase(
        failures,
        "corpus",
        lambda: corpus_phase(8, 300.0, dtype),
        lambda r: (
            f"{len(r['rmses'])} rides; RMSEs "
            + ", ".join(f"{x:.4f}" for x in r["rmses"])
            + f" m/s (gate <= {RMSE_GATE_M_S} each)"
        ),
    )
    run_phase(
        failures,
        "vo_720p",
        lambda: track_rendered_ride(
            os.path.join(tmp, "vo"), 150, 1280, 720, 700.0, 2000, 8
        ),
        lambda r: (
            f"{r['frames']} frames, {r['segments']} segment(s), turn-rate "
            f"correlations {[round(c, 4) for c in r['corrs']]} "
            f"(gate |corr| > {CORR_GATE}); trajectory JSONs in {tmp}/vo"
        ),
    )
    for width, height, fx in FRAME_SIZES:
        run_phase(
            failures,
            f"extractor_{height}p",
            lambda: extractor_parity_phase(width, height, fx, 8, gpu, cpu),
            lambda r: (
                f"{r['identical_share']:.4f} of {r['keypoints']} keypoints "
                f"identical to the CPU (floor {IDENTICAL_KEYPOINT_FLOOR}, "
                f"|dxy| <= {XY_TIE_PX} px); descriptors of identical "
                f"keypoints differing: {r['desc_mismatch']} (must be 0); "
                "hamming_table bitwise equal to numpy"
            ),
        )
    run_phase(
        failures,
        "brief_int8_k1521",
        lambda: brief_int8_phase(gpu),
        lambda r: (
            f"int8 dot_general K=1521 compiled (custom calls: "
            f"{r['lowering']}), bitwise "
            "equal to numpy's exact product"
        ),
    )


def run_four_cards(failures: list) -> None:
    import jax
    import numpy as np

    from pilotguru.cli._common import setup_backend

    setup_backend("auto")
    devices = jax.devices()
    if len(devices) < 4:
        raise SystemExit(f"--four-cards needs 4 devices, found {len(devices)}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    corpus_dir = os.path.join(tmp, "corpus")

    def sharded_corpus():
        one = corpus_cli_phase(corpus_dir, 8, 300.0, shard_windows=False)
        four = corpus_cli_phase(corpus_dir, 8, 300.0, shard_windows=True)
        dv = max(
            float(np.max(np.abs(a - b)))
            for a, b in zip(one["velocities"], four["velocities"])
        )
        if dv > DV_TOLERANCE_M_S:
            raise AssertionError(f"sharded vs 1 card max |dv| {dv}")
        return {"seconds": four["seconds"], "one": one["seconds"], "dv": dv}

    run_phase(
        failures,
        "corpus_shard_windows",
        sharded_corpus,
        lambda r: (
            f"preprocess_corpus --shard_windows over a {len(devices)}-card "
            f"('windows',) mesh, 8 rides x 300 s (1 card: {r['one']:.2f} s); "
            f"max |dv| vs 1 card {r['dv']:.3g} m/s (tolerance "
            f"{DV_TOLERANCE_M_S} m/s)"
        ),
    )

    def multi_card_vo():
        """Extraction spread over 4 cards against 1 card: the features must
        be the same bits (the extractor is exact integer arithmetic). Each
        run must pass the turn-rate gate; how far the two trajectories
        drift apart is printed, not gated, since the tracker's float32
        reductions need not repeat bit for bit from one run to the next."""
        one = track_rendered_ride(os.path.join(tmp, "vo1"), 150, 1280, 720,
                                  700.0, 2000, 8, devices=devices[:1])
        four = track_rendered_ride(os.path.join(tmp, "vo4"), 150, 1280, 720,
                                   700.0, 2000, 8, devices=devices[:4])
        if len(one["features"]) != len(four["features"]) or not all(
            np.array_equal(a, b)
            for fa, fb in zip(one["features"], four["features"])
            for a, b in zip(fa, fb)
        ):
            raise AssertionError("features extracted on 4 cards differ")
        (ids1, t1), (ids4, t4) = one["trajectories"][0], four["trajectories"][0]
        common, i1, i4 = np.intersect1d(ids1, ids4, return_indices=True)
        dt = float(np.max(np.abs(t1[i1] - t4[i4]))) if common.size else np.nan
        return {"seconds": four["seconds"], "one": one["seconds"], "dt": dt,
                "frames": len(four["features"]), "common": int(common.size),
                "segments": (one["segments"], four["segments"]),
                "corrs": four["corrs"]}

    run_phase(
        failures,
        "vo_720p_four_cards",
        multi_card_vo,
        lambda r: (
            f"features of {r['frames']} frames extracted over 4 cards bitwise "
            f"equal to 1 card; segments (1 card, 4 cards) {r['segments']}, "
            f"4-card turn-rate correlations "
            f"{[round(c, 4) for c in r['corrs']]} (gate |corr| > {CORR_GATE} "
            f"on each run); first segments share {r['common']} frames, max "
            f"|dt| {r['dt']:.3g} (not gated); 1 card: {r['one']:.2f} s"
        ),
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--four-cards", action="store_true",
        help="Run only the paths that span four cards.",
    )
    args = parser.parse_args(argv)

    import jax

    first = jax.devices()[0]
    if first.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (first device: {first.platform})",
              file=sys.stderr)
        return 2
    from pilotguru.cli._common import setup_compile_cache

    print(f"card: {card_line()}", flush=True)
    print(f"device_kind: {first.device_kind}", flush=True)
    print(f"compile cache: {setup_compile_cache()}", flush=True)
    failures: list = []
    if args.four_cards:
        run_four_cards(failures)
    else:
        run_one_card(failures)
    if failures:
        print(f"chip_smoke: failed phases: {', '.join(failures)}",
              file=sys.stderr)
        return 1
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": first.platform,
            "kind": first.device_kind,
            "count": len(jax.devices()),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
