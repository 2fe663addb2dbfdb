import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle
import synthetic
from pilotguru.calib import (
    FitMotionConfig,
    angular_velocities_around_axis,
    build_ride_pieces,
    build_windowed_problem,
    fit_motion_arrays,
    principal_rotation_axes,
    window_loss_fn,
)


@pytest.fixture(scope="module")
def small_ride():
    return synthetic.make_ride(
        duration_sec=60.0,
        imu_hz=50.0,
        gps_hz=1.0,
        local_bias=(0.05, -0.1, 0.2),
        jitter_seed=0,
    )


@pytest.fixture(scope="module")
def small_problem(small_ride):
    r = small_ride
    ride = build_ride_pieces(
        r.rot_times_usec, r.rot_rates, r.acc_times_usec, r.accelerations,
        r.gps_times_usec,
    )
    return build_windowed_problem(
        ride, r.gps_times_usec, r.gps_speeds,
        locations_batch_size=20, locations_shift_step=5,
    )


def _window_oracle(r, start, end):
    return oracle.AccelerometerCalibratorOracle(
        r.gps_times_usec[start:end],
        r.gps_speeds[start:end],
        r.rot_times_usec,
        r.rot_rates,
        r.acc_times_usec,
        r.accelerations,
    )


class TestWindowLossParity:
    def test_loss_matches_oracle(self, small_ride, small_problem):
        rng = np.random.default_rng(0)
        for w in [0, 2, 5]:
            start = int(small_problem.window_gps_start[w])
            end = start + int(small_problem.window_gps_len[w])
            cal = _window_oracle(small_ride, start, end)
            loss_fn = window_loss_fn(small_problem, w)
            for _ in range(3):
                params = rng.normal(scale=0.5, size=9)
                want, _ = cal.eval(params)
                got = float(loss_fn(jnp.asarray(params)))
                np.testing.assert_allclose(got, want, rtol=1e-9)

    def test_autodiff_gradient_matches_hand_derived(self, small_ride):
        # The reference gradient (velocity.cc:126-165) is hand-derived with a
        # one-step-lag rotation approximation for the local-bias term and a
        # 1e-5 norm guard; with gentle rotations both effects are tiny, so
        # jax.grad of our loss must agree closely.
        r = synthetic.make_ride(
            duration_sec=40.0, imu_hz=50.0, heading_amplitude=0.05, jitter_seed=1
        )
        ride = build_ride_pieces(
            r.rot_times_usec, r.rot_rates, r.acc_times_usec, r.accelerations,
            r.gps_times_usec,
        )
        problem = build_windowed_problem(
            ride, r.gps_times_usec, r.gps_speeds,
            locations_batch_size=15, locations_shift_step=15,
        )
        cal = _window_oracle(r, 0, 15)
        params = np.asarray([0.1, -9.7, 0.2, 0.05, -0.1, 0.2, 3.0, 0.5, -0.2])
        _, want_grad = cal.eval(params)
        got_grad = np.asarray(jax.grad(window_loss_fn(problem, 0))(jnp.asarray(params)))
        np.testing.assert_allclose(got_grad[0:3], want_grad[0:3], rtol=1e-5)
        np.testing.assert_allclose(got_grad[6:9], want_grad[6:9], rtol=1e-5)
        np.testing.assert_allclose(got_grad[3:6], want_grad[3:6], rtol=1e-2)


class TestRotationAxis:
    def test_vertical_axis_recovered(self, small_ride):
        axes, eigvals = principal_rotation_axes(
            small_ride.rot_times_usec, small_ride.rot_rates, 500_000
        )
        axes = np.asarray(axes)
        assert abs(axes[0] @ np.array([0.0, 0.0, 1.0])) > 0.999
        assert eigvals[0] > 100 * eigvals[1]

    def test_angular_velocity_projection(self, small_ride):
        got = np.asarray(
            angular_velocities_around_axis(
                small_ride.rot_rates, np.array([0.0, 0.0, 1.0])
            )
        )
        np.testing.assert_allclose(got, small_ride.rot_rates[:, 2], rtol=1e-12)


class TestFitMotionEndToEnd:
    @pytest.fixture(scope="class")
    def result(self):
        r = synthetic.make_ride(
            duration_sec=120.0, imu_hz=100.0, local_bias=(0.05, -0.1, 0.2),
            jitter_seed=2,
        )
        cfg = FitMotionConfig(optimization_iters=30)
        return r, fit_motion_arrays(
            r.rot_times_usec, r.rot_rates, r.acc_times_usec, r.accelerations,
            r.gps_times_usec, r.gps_speeds, cfg,
        )

    def test_vertical_axis(self, result):
        _, res = result
        assert abs(res.vertical_axis @ np.array([0, 0, 1.0])) > 0.999

    def test_steering_matches_yaw_rate(self, result):
        r, res = result
        want = r.yaw_rate_at(res.steering_times_usec)
        sign = np.sign(res.vertical_axis[2])
        np.testing.assert_allclose(
            res.steering_angular_velocities, sign * want, atol=1e-6
        )

    def test_velocities_match_ground_truth(self, result):
        # Residual error here is dominated by the objective's own modeling
        # bias (net-displacement chord vs GPS arc length + per-window bias
        # tradeoffs), which the reference shares — solver-level parity is
        # asserted separately against the sequential L-BFGS oracle below.
        r, res = result
        want = r.speed_at(res.velocity_times_usec)
        rmse = np.sqrt(np.mean((res.velocities_m_s - want) ** 2))
        assert rmse < 0.25, f"velocity RMSE {rmse}"
        # No gross bias: mean error well under the oscillation amplitude.
        assert abs(np.mean(res.velocities_m_s - want)) < 0.05

    def test_forward_axis_is_device_x(self, result):
        _, res = result
        assert res.forward_axis @ np.array([1.0, 0, 0]) > 0.99
        np.testing.assert_allclose(np.linalg.norm(res.forward_axis), 1.0, atol=1e-4)

    def test_windows_converge(self, result):
        _, res = result
        # Final per-window sum-of-squares travel mismatch on noise-free data:
        # ~40 intervals of ~10 m each, so 0.1 total means ~5 cm per interval
        # (discretization level); anything above a few meters^2 would signal
        # a window stuck in a bad basin.
        assert np.median(res.window_final_loss) < 0.1
        assert np.max(res.window_final_loss) < 2.0


class TestAgainstSequentialLBFGS:
    def test_averaged_velocities_match_oracle_pipeline(self):
        # Small ride so the scipy L-BFGS oracle stays fast; compare the
        # cross-window averaged per-event speeds of the batched GN pipeline
        # against the literal sequential solve.
        r = synthetic.make_ride(duration_sec=40.0, imu_hz=20.0, jitter_seed=3)
        want_times, want_speeds = oracle.fit_motion_velocities(
            r.gps_times_usec, r.gps_speeds, r.rot_times_usec, r.rot_rates,
            r.acc_times_usec, r.accelerations, batch_size=15, shift_step=5,
        )
        cfg = FitMotionConfig(
            locations_batch_size=15, locations_shift_step=5,
            optimization_iters=50, post_smoothing_sigma_sec=1e-4,
        )
        res = fit_motion_arrays(
            r.rot_times_usec, r.rot_rates, r.acc_times_usec, r.accelerations,
            r.gps_times_usec, r.gps_speeds, cfg,
        )
        np.testing.assert_array_equal(res.velocity_times_usec, want_times)
        # Both solvers minimize the same objective from the same init; with
        # near-zero post-smoothing the averaged speeds should agree closely.
        err = np.abs(res.velocities_m_s - want_speeds)
        assert np.median(err) < 0.02, f"median |diff| {np.median(err)}"
        assert np.max(err) < 0.3, f"max |diff| {np.max(err)}"
