import jax.numpy as jnp
import numpy as np
import pytest

import oracle
import synthetic
from pilotguru.calib.forward_axis_calibrator import (
    calibrate_fixed_forward_axis,
    initial_state,
    loss,
    normalize_velocities,
    residuals,
)
from pilotguru.calib.pieces import build_ride_pieces


@pytest.fixture(scope="module")
def small_ride():
    return synthetic.make_ride(
        duration_sec=30.0, imu_hz=20.0, local_bias=(0.05, -0.1, 0.2),
        jitter_seed=21,
    )


class TestLossParity:
    def test_matches_literal_oracle(self, small_ride):
        r = small_ride
        ride = build_ride_pieces(
            r.rot_times_usec, r.rot_rates, r.acc_times_usec, r.accelerations,
            r.gps_times_usec,
        )
        num_gps = r.gps_times_usec.shape[0]
        rng = np.random.default_rng(0)
        x0, arrays = initial_state(ride, r.gps_speeds, num_gps, jnp.float64)
        for _ in range(3):
            params = np.asarray(x0) + rng.normal(scale=0.1, size=x0.shape[0])
            got = float(loss(jnp.asarray(params), arrays, ride.num_events, num_gps))
            want = oracle.fixed_forward_axis_loss(
                r.gps_times_usec, r.gps_speeds, r.rot_times_usec, r.rot_rates,
                r.acc_times_usec, r.accelerations, params,
            )
            np.testing.assert_allclose(got, want, rtol=1e-9)


class TestNormalization:
    def test_axis_scale_folds_into_velocities(self):
        params = np.concatenate([np.zeros(6), [2.0, 0, 0], [3.0, 4.0]])
        out = normalize_velocities(params)
        np.testing.assert_allclose(out[6:9], [1.0, 0, 0])
        np.testing.assert_allclose(out[9:], [6.0, 8.0])

    def test_degenerate_axis_rejected(self):
        params = np.concatenate([np.zeros(6), np.zeros(3), [1.0]])
        with pytest.raises(ValueError):
            normalize_velocities(params)


class TestEndToEnd:
    def test_recovers_axis_and_velocities(self, small_ride):
        r = small_ride
        result = calibrate_fixed_forward_axis(
            r.rot_times_usec, r.rot_rates, r.acc_times_usec, r.accelerations,
            r.gps_times_usec, r.gps_speeds, num_iters=50,
        )
        # Ground truth: forward axis = +x in the device frame; velocities
        # track the synthetic speed profile; biases match the generator.
        assert result.forward_axis @ np.array([1.0, 0, 0]) > 0.999
        want = r.speed_at(result.event_times_usec)
        err = result.velocities - want
        # The first/last ~3 s are weakly constrained (no GPS interval closes
        # them off on both sides); the interior shows only the objective's
        # smooth chord-vs-arc drift (same as the windowed calibrator).
        t = (result.event_times_usec - result.event_times_usec[0]) * 1e-6
        interior = (t > 3.0) & (t < t[-1] - 3.0)
        rmse = np.sqrt(np.mean(err[interior] ** 2))
        assert rmse < 0.3, rmse
        # With yaw-only rotation only the SUM of the global and local z
        # biases is identifiable; it must equal g_world_z + local_bias_z.
        z_sum = (
            result.acceleration_global_bias[2]
            + result.acceleration_local_bias[2]
        )
        np.testing.assert_allclose(
            z_sum, r.true_gravity_world[2] + r.true_local_bias[2], atol=0.05
        )
