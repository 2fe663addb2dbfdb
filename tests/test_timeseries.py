import numpy as np
import pytest

import oracle
from pilotguru.timeseries import (
    annotate_frames_values,
    make_interpolation_pieces,
    merge_time_series,
    smooth_time_series,
    time_averaged_values,
    window_piece_slices,
)


def _random_sorted_times(rng, n, lo=0, hi=10_000_000):
    return np.sort(rng.choice(np.arange(lo, hi), size=n, replace=False)).astype(
        np.int64
    )


class TestMergeTimeSeries:
    def test_matches_oracle_random(self):
        rng = np.random.default_rng(0)
        for _ in range(20):
            a = _random_sorted_times(rng, rng.integers(2, 50))
            b = _random_sorted_times(rng, rng.integers(2, 50))
            times, idx = merge_time_series([a, b])
            o_times, o_idx = oracle.merge_time_series([a, b])
            np.testing.assert_array_equal(times, o_times)
            np.testing.assert_array_equal(idx, np.asarray(o_idx))

    def test_three_components(self):
        rng = np.random.default_rng(1)
        comps = [_random_sorted_times(rng, 30) for _ in range(3)]
        times, idx = merge_time_series(comps)
        o_times, o_idx = oracle.merge_time_series(comps)
        np.testing.assert_array_equal(times, o_times)
        np.testing.assert_array_equal(idx, np.asarray(o_idx))

    def test_aligned_series(self):
        a = np.array([10, 20, 30, 40], dtype=np.int64)
        times, idx = merge_time_series([a, a.copy()])
        np.testing.assert_array_equal(times, a)
        np.testing.assert_array_equal(idx[:, 0], idx[:, 1])

    def test_no_overlap(self):
        a = np.array([1, 2, 3], dtype=np.int64)
        b = np.array([10, 11], dtype=np.int64)
        times, idx = merge_time_series([a, b])
        assert times.size == 0 and idx.shape == (0, 2)

    def test_header_example(self):
        # Example from align_time_series.hpp:17-26: A=[1,3,6], B=[2,3,4,8]
        # -> events at 2,3,4,6 with indices (0,0),(1,1),(1,2),(2,2).
        a = np.array([1, 3, 6], dtype=np.int64)
        b = np.array([2, 3, 4, 8], dtype=np.int64)
        times, idx = merge_time_series([a, b])
        np.testing.assert_array_equal(times, [2, 3, 4, 6])
        np.testing.assert_array_equal(idx, [[0, 0], [1, 1], [1, 2], [2, 2]])


class TestInterpolationPieces:
    def test_matches_oracle_random(self):
        rng = np.random.default_rng(2)
        for _ in range(20):
            ref = _random_sorted_times(rng, rng.integers(3, 20), 0, 1000)
            itp = _random_sorted_times(rng, rng.integers(3, 80), 0, 1000)
            pieces = make_interpolation_pieces(ref, itp)
            grouped = pieces.grouped_by_reference(len(ref))
            o = oracle.make_interpolation_intervals(ref, itp)
            assert [len(g) for g in grouped] == [len(g) for g in o]
            for got, want in zip(grouped, o):
                assert got == want

    def test_total_duration_covers_intersection(self):
        ref = np.array([0, 100, 200, 300], dtype=np.int64)
        itp = np.arange(50, 400, 7, dtype=np.int64)
        pieces = make_interpolation_pieces(ref, itp)
        lo = max(ref[0], itp[0])
        hi = min(ref[-1], itp[-1])
        assert pieces.start_usec[0] == lo
        assert pieces.end_usec[-1] == hi
        assert np.sum(pieces.end_usec - pieces.start_usec) == hi - lo
        # Pieces are contiguous and ordered.
        np.testing.assert_array_equal(pieces.end_usec[:-1], pieces.start_usec[1:])

    def test_window_slices_match_per_window_construction(self):
        rng = np.random.default_rng(3)
        ref = _random_sorted_times(rng, 40, 0, 100_000)
        itp = _random_sorted_times(rng, 600, 0, 100_000)
        pieces = make_interpolation_pieces(ref, itp)
        starts = np.arange(0, 40, 5)
        ends = np.minimum(starts + 10, 40)
        lo, hi = window_piece_slices(pieces, ref, starts, ends)
        for w, (s, e) in enumerate(zip(starts, ends)):
            wp = make_interpolation_pieces(ref[s:e], itp)
            np.testing.assert_array_equal(
                pieces.end_usec[lo[w] : hi[w]], wp.end_usec
            )
            np.testing.assert_array_equal(
                pieces.reference_end_index[lo[w] : hi[w]] - s,
                wp.reference_end_index,
            )
            np.testing.assert_array_equal(
                pieces.interpolation_end_index[lo[w] : hi[w]],
                wp.interpolation_end_index,
            )


class TestSmoothTimeSeries:
    @pytest.mark.parametrize("sigma", [0.003, 0.05, 1.0])
    def test_matches_oracle(self, sigma):
        rng = np.random.default_rng(4)
        ts = np.sort(rng.uniform(0, 10, size=200))
        values = rng.normal(size=200)
        got = np.asarray(smooth_time_series(values, ts, ts, sigma))
        want = oracle.smooth_time_series(values, ts, ts, sigma)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)

    def test_distinct_targets(self):
        rng = np.random.default_rng(5)
        ts = np.sort(rng.uniform(0, 10, size=100))
        targets = np.sort(rng.uniform(0, 10, size=37))
        values = rng.normal(size=100)
        got = np.asarray(smooth_time_series(values, ts, targets, 0.1))
        want = oracle.smooth_time_series(values, ts, targets, 0.1)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)

    def test_vector_valued(self):
        rng = np.random.default_rng(6)
        ts = np.sort(rng.uniform(0, 5, size=60))
        values = rng.normal(size=(60, 4))
        got = np.asarray(smooth_time_series(values, ts, ts, 0.2))
        want = oracle.smooth_time_series(values, ts, ts, 0.2)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)

    def test_constant_series_is_preserved(self):
        ts = np.linspace(0, 1, 50)
        values = np.full(50, 3.25)
        got = np.asarray(smooth_time_series(values, ts, ts, 0.01))
        np.testing.assert_allclose(got, values, rtol=1e-12)


class TestTimeAveragedValues:
    def test_matches_oracle(self):
        rng = np.random.default_rng(7)
        times = np.sort(
            rng.choice(np.arange(0, 1_000_000), size=100, replace=False)
        ).astype(np.int64)
        values = rng.normal(size=100)
        q0 = rng.integers(times[0], times[-1] - 1, size=50)
        q1 = q0 + rng.integers(1, 50_000, size=50)
        got, valid = time_averaged_values(values, times, q0, q1)
        got, valid = np.asarray(got), np.asarray(valid)
        for k in range(50):
            want, want_valid = oracle.time_averaged_value(
                values, times, int(q0[k]), int(q1[k])
            )
            assert valid[k] == want_valid
            if want_valid:
                np.testing.assert_allclose(got[k], want, rtol=1e-9, atol=1e-9)

    def test_invalid_outside_coverage(self):
        times = np.array([100, 200, 300], dtype=np.int64)
        values = np.array([1.0, 2.0, 3.0])
        _, valid = time_averaged_values(values, times, [50, 150], [150, 350])
        np.testing.assert_array_equal(np.asarray(valid), [False, False])

    def test_annotate_frames_values(self):
        times = np.arange(0, 1_000_000, 2_000, dtype=np.int64)  # 500 Hz
        values = np.sin(times * 1e-6 * 2 * np.pi)
        frames = np.arange(10_000, 900_000, 33_000, dtype=np.int64)  # ~30 fps
        got, valid = annotate_frames_values(times, values, frames)
        got, valid = np.asarray(got), np.asarray(valid)
        assert valid.all()
        for k in range(len(frames) - 1):
            want, _ = oracle.time_averaged_value(
                values, times, int(frames[k]), int(frames[k + 1])
            )
            np.testing.assert_allclose(got[k], want, rtol=1e-9, atol=1e-12)
