import jax.numpy as jnp
import numpy as np

import oracle
from pilotguru.geometry import (
    integrate_motion,
    quat_conjugate,
    quat_cumulative_product,
    quat_multiply,
    quat_rotate,
    quat_to_rotation_matrix,
    rotation_rate_to_quat,
)


def _random_unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


class TestQuaternion:
    def test_multiply_matches_oracle(self):
        rng = np.random.default_rng(0)
        q1, q2 = _random_unit_quats(rng, 10), _random_unit_quats(rng, 10)
        got = np.asarray(quat_multiply(jnp.asarray(q1), jnp.asarray(q2)))
        for k in range(10):
            np.testing.assert_allclose(
                got[k], oracle.quat_mul(q1[k], q2[k]), rtol=1e-12
            )

    def test_rotate_matches_matrix(self):
        rng = np.random.default_rng(1)
        q = _random_unit_quats(rng, 10)
        v = rng.normal(size=(10, 3))
        got = np.asarray(quat_rotate(jnp.asarray(q), jnp.asarray(v)))
        mats = np.asarray(quat_to_rotation_matrix(jnp.asarray(q)))
        want = np.einsum("nij,nj->ni", mats, v)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)

    def test_conjugate_inverts_rotation(self):
        rng = np.random.default_rng(2)
        q = jnp.asarray(_random_unit_quats(rng, 5))
        v = jnp.asarray(rng.normal(size=(5, 3)))
        back = quat_rotate(quat_conjugate(q), quat_rotate(q, v))
        np.testing.assert_allclose(np.asarray(back), np.asarray(v), atol=1e-12)

    def test_rate_to_quat_matches_oracle(self):
        rng = np.random.default_rng(3)
        rates = rng.normal(size=(20, 3))
        durations = rng.uniform(1e-4, 0.1, size=20)
        got = np.asarray(rotation_rate_to_quat(jnp.asarray(rates), durations))
        for k in range(20):
            np.testing.assert_allclose(
                got[k],
                oracle.rotation_rate_to_quat(rates[k], durations[k]),
                rtol=1e-12,
            )

    def test_rate_to_quat_zero_rate(self):
        got = np.asarray(rotation_rate_to_quat(jnp.zeros((3,)), 0.01))
        np.testing.assert_allclose(got, [1.0, 0, 0, 0], atol=1e-30)

    def test_cumulative_product_matches_sequential(self):
        rng = np.random.default_rng(4)
        dqs = _random_unit_quats(rng, 64)
        got = np.asarray(quat_cumulative_product(jnp.asarray(dqs)))
        acc = dqs[0]
        seq = [acc]
        for k in range(1, 64):
            acc = oracle.quat_mul(acc, dqs[k])
            seq.append(acc)
        np.testing.assert_allclose(got, np.asarray(seq), rtol=1e-10, atol=1e-12)


class TestStrapdown:
    def test_matches_sequential_oracle(self):
        rng = np.random.default_rng(5)
        t = 200
        rates = rng.normal(scale=0.5, size=(t, 3))
        accs = rng.normal(scale=2.0, size=(t, 3))
        dts = rng.uniform(1e-3, 5e-3, size=t)
        g_bias = rng.normal(size=3)
        l_bias = rng.normal(scale=0.1, size=3)
        v0 = rng.normal(size=3)

        res = integrate_motion(
            jnp.asarray(rates),
            jnp.asarray(accs),
            jnp.asarray(dts),
            jnp.asarray(g_bias),
            jnp.asarray(l_bias),
            jnp.asarray(v0),
        )
        want_q, want_v = oracle.integrate_motion_sequence(
            rates, accs, dts, g_bias, l_bias, v0
        )
        np.testing.assert_allclose(np.asarray(res.orientations), want_q, atol=1e-9)
        np.testing.assert_allclose(np.asarray(res.velocities), want_v, atol=1e-9)

    def test_initial_orientation(self):
        rng = np.random.default_rng(6)
        q0 = rng.normal(size=4)
        q0 /= np.linalg.norm(q0)
        rates = rng.normal(size=(10, 3))
        accs = rng.normal(size=(10, 3))
        dts = np.full(10, 0.01)
        res = integrate_motion(
            jnp.asarray(rates),
            jnp.asarray(accs),
            jnp.asarray(dts),
            jnp.zeros(3),
            jnp.zeros(3),
            jnp.zeros(3),
            initial_orientation=jnp.asarray(q0),
        )
        want_q, want_v = oracle.integrate_motion_sequence(
            rates, accs, dts, np.zeros(3), np.zeros(3), np.zeros(3), q0=q0
        )
        np.testing.assert_allclose(np.asarray(res.orientations), want_q, atol=1e-11)
        np.testing.assert_allclose(np.asarray(res.velocities), want_v, atol=1e-11)
