"""Batched multi-ride corpus calibration: parity with the per-ride path.

The corpus path (calib/corpus.py) must be numerically equivalent to
fit_motion_arrays per ride — padding to shape buckets and (optionally)
sharding the window axis over a device mesh must be exactly neutral.
"""

import os

import numpy as np
import pytest

from pilotguru.calib import (
    CorpusBuckets,
    FitMotionConfig,
    RideArrays,
    fit_motion_arrays,
    fit_motion_corpus,
)
from synthetic import make_ride, write_ride_jsons

# Heavy e2e tier: excluded from the quick loop via `pytest -m "not slow"`.
pytestmark = pytest.mark.slow

CONFIG = FitMotionConfig(
    locations_batch_size=10,
    locations_shift_step=5,
    optimization_iters=8,
)
BUCKETS = CorpusBuckets(
    pieces=2048, windows=16, gps=64, events=2048, window_pieces=32
)


def _rides():
    a = make_ride(duration_sec=40.0, imu_hz=50.0, local_bias=(0.1, -0.05, 0.2))
    b = make_ride(
        duration_sec=55.0,
        imu_hz=50.0,
        base_speed=7.0,
        heading_amplitude=0.4,
        local_bias=(-0.05, 0.15, 0.0),
        t0_usec=3_000_000,
    )
    return [a, b]


def _as_arrays(ride):
    return RideArrays(
        ride.rot_times_usec,
        ride.rot_rates,
        ride.acc_times_usec,
        ride.accelerations,
        ride.gps_times_usec,
        ride.gps_speeds,
    )


def test_padding_is_exactly_neutral_across_buckets():
    """Two different bucket signatures must give BITWISE-identical results:
    every pad row is masked, so only executable shapes change."""
    cfg = FitMotionConfig(
        locations_batch_size=10, locations_shift_step=5, optimization_iters=1
    )
    ride = _as_arrays(_rides()[0])
    other = CorpusBuckets(
        pieces=4096, windows=64, gps=256, events=4096, window_pieces=64
    )
    a = fit_motion_corpus([ride], cfg, buckets=BUCKETS)[0]
    b = fit_motion_corpus([ride], cfg, buckets=other)[0]
    np.testing.assert_array_equal(a.velocity_times_usec, b.velocity_times_usec)
    np.testing.assert_array_equal(a.window_params, b.window_params)
    np.testing.assert_array_equal(a.velocities_m_s, b.velocities_m_s)
    np.testing.assert_array_equal(a.forward_axis, b.forward_axis)


def test_corpus_matches_per_ride_fit_motion():
    """Corpus vs the single-ride path: identical event coverage and
    equivalent converged solutions. Parameter identity is NOT asserted —
    XLA tiles reductions differently for different padded shapes, and the
    resulting ~1e-13 noise can flip the multistart argmin between
    near-tied starts. Padding exactness is covered by the bitwise
    bucket-neutrality test above."""
    rides = _rides()
    corpus = fit_motion_corpus(
        [_as_arrays(r) for r in rides], CONFIG, buckets=BUCKETS
    )
    for ride, c in zip(rides, corpus):
        s = fit_motion_arrays(
            ride.rot_times_usec,
            ride.rot_rates,
            ride.acc_times_usec,
            ride.accelerations,
            ride.gps_times_usec,
            ride.gps_speeds,
            CONFIG,
        )
        np.testing.assert_array_equal(
            c.velocity_times_usec, s.velocity_times_usec
        )
        np.testing.assert_allclose(
            c.vertical_axis, s.vertical_axis, rtol=1e-9, atol=1e-12
        )
        # Converged solutions: same quality, near-identical velocities.
        np.testing.assert_allclose(
            c.velocities_m_s, s.velocities_m_s, rtol=0.02, atol=0.1
        )
        assert np.mean(c.window_final_loss) <= (
            np.mean(s.window_final_loss) * 1.2 + 1e-6
        )


def test_corpus_window_sharded_over_mesh():
    import jax

    from pilotguru.parallel.mesh import make_mesh

    devices = jax.devices()
    if len(devices) < 2:
        pytest.skip("needs a multi-device mesh")
    mesh = make_mesh(("windows",), (len(devices),), devices)

    rides = _rides()
    sharded = fit_motion_corpus(
        [_as_arrays(r) for r in rides], CONFIG, buckets=BUCKETS, mesh=mesh
    )
    unsharded = fit_motion_corpus(
        [_as_arrays(r) for r in rides], CONFIG, buckets=BUCKETS
    )
    for s, u in zip(sharded, unsharded):
        # Sharded execution repartitions reductions, so comparisons follow
        # the same quality contract as corpus-vs-single (see above).
        np.testing.assert_array_equal(
            s.velocity_times_usec, u.velocity_times_usec
        )
        np.testing.assert_allclose(
            s.velocities_m_s, u.velocities_m_s, rtol=0.02, atol=0.1
        )
        assert np.mean(s.window_final_loss) <= (
            np.mean(u.window_final_loss) * 1.2 + 1e-6
        )


def test_preprocess_corpus_cli(tmp_path):
    from pilotguru.cli import preprocess_corpus

    rides = _rides()
    for i, ride in enumerate(rides):
        write_ride_jsons(ride, str(tmp_path / f"ride-{i}"))

    rc = preprocess_corpus.main(
        [
            f"--corpus_dir={tmp_path}",
            "--locations_batch_size=10",
            "--locations_shift_step=5",
            "--optimization_iters=8",
        ]
    )
    assert rc == 0

    from pilotguru.formats import json_io, keys

    for i, ride in enumerate(rides):
        out = tmp_path / f"ride-{i}" / "postprocessed"
        assert (out / "forward.json").is_file()
        assert (out / "steering-imu.json").is_file()
        times, speeds = json_io.read_timestamped_values(
            str(out / "velocities-imu.json"), keys.VELOCITIES, keys.SPEED_M_S
        )
        assert times.shape[0] > 100
        truth = ride.speed_at(times)
        rmse = float(np.sqrt(np.mean((speeds - truth) ** 2)))
        assert rmse < 1.0, f"ride {i} velocity RMSE {rmse}"


def test_find_ride_dirs_skips_non_rides(tmp_path):
    from pilotguru.cli.preprocess_corpus import find_ride_dirs

    os.makedirs(tmp_path / "ride-0")
    (tmp_path / "ride-0" / "rotations.json").write_text("{}")
    os.makedirs(tmp_path / "not-a-ride")
    (tmp_path / "stray.txt").write_text("x")
    assert find_ride_dirs(str(tmp_path)) == [str(tmp_path / "ride-0")]


def test_rotation_axis_bucketing_is_exactly_neutral():
    from pilotguru.calib.rotation_axis import principal_rotation_axes

    ride = _rides()[0]
    plain_axes, plain_eig = principal_rotation_axes(
        ride.rot_times_usec, ride.rot_rates, 500_000
    )
    bucketed_axes, bucketed_eig = principal_rotation_axes(
        ride.rot_times_usec,
        ride.rot_rates,
        500_000,
        chunk_bucket=64,
        step_bucket=32,
    )
    np.testing.assert_allclose(bucketed_axes, plain_axes, rtol=0, atol=1e-13)
    np.testing.assert_allclose(bucketed_eig, plain_eig, rtol=1e-12, atol=0)


def test_smoothing_bucketing_is_exactly_neutral():
    from pilotguru.timeseries.smoothing import smooth_time_series

    rng = np.random.default_rng(0)
    t = np.cumsum(rng.uniform(0.004, 0.012, size=777))
    v = rng.normal(size=777)
    plain = np.asarray(smooth_time_series(v, t, t, 0.02))
    bucketed = np.asarray(
        smooth_time_series(
            v, t, t, 0.02, sample_bucket=1024, target_bucket=1024
        )
    )
    np.testing.assert_allclose(bucketed, plain, rtol=0, atol=1e-14)
