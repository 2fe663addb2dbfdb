import jax
import jax.numpy as jnp
import numpy as np

from pilotguru.solvers import (
    batched_levenberg_marquardt,
    gradient_descent,
    levenberg_marquardt,
)


class TestLevenbergMarquardt:
    def test_linear_least_squares_exact(self):
        rng = np.random.default_rng(0)
        a = jnp.asarray(rng.normal(size=(20, 5)))
        b = jnp.asarray(rng.normal(size=20))
        res = levenberg_marquardt(lambda x: a @ x - b, jnp.zeros(5), num_iters=20)
        want, *_ = np.linalg.lstsq(np.asarray(a), np.asarray(b), rcond=None)
        np.testing.assert_allclose(np.asarray(res.x), want, rtol=1e-6, atol=1e-8)

    def test_rosenbrock_residuals(self):
        def residuals(x):
            return jnp.asarray([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])

        res = levenberg_marquardt(residuals, jnp.asarray([-1.2, 1.0]), num_iters=60)
        np.testing.assert_allclose(np.asarray(res.x), [1.0, 1.0], atol=1e-6)

    def test_masked_residuals_are_exact_padding(self):
        rng = np.random.default_rng(1)
        a = jnp.asarray(rng.normal(size=(10, 3)))
        b = jnp.asarray(rng.normal(size=10))

        def padded(x):
            r = a @ x - b
            return jnp.concatenate([r, jnp.zeros(7, dtype=x.dtype)])

        # Zero rows contribute exactly nothing to J^T J / J^T r; remaining
        # differences are matmul reduction-order floating-point noise.
        r1 = levenberg_marquardt(lambda x: a @ x - b, jnp.zeros(3), num_iters=15)
        r2 = levenberg_marquardt(padded, jnp.zeros(3), num_iters=15)
        np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r2.x), rtol=1e-6)

    def test_batched_solves_independent_problems(self):
        rng = np.random.default_rng(2)
        mats = jnp.asarray(rng.normal(size=(8, 12, 4)))
        rhs = jnp.asarray(rng.normal(size=(8, 12)))

        def residual(x, a, b):
            return a @ x - b

        res = batched_levenberg_marquardt(
            residual, jnp.zeros((8, 4)), mats, rhs, num_iters=20
        )
        for k in range(8):
            want, *_ = np.linalg.lstsq(
                np.asarray(mats[k]), np.asarray(rhs[k]), rcond=None
            )
            np.testing.assert_allclose(
                np.asarray(res.x[k]), want, rtol=1e-6, atol=1e-8
            )

    def test_jittable(self):
        a = jnp.eye(3)
        b = jnp.asarray([1.0, 2.0, 3.0])
        solve = jax.jit(
            lambda: levenberg_marquardt(lambda x: a @ x - b, jnp.zeros(3), 10)
        )
        np.testing.assert_allclose(np.asarray(solve().x), [1, 2, 3], rtol=1e-8)


class TestGradientDescent:
    def test_quadratic_matches_reference_semantics(self):
        # With clipping inactive, GD on 0.5*||x - c||^2 has the closed-form
        # iteration x <- x - lr_k (x - c) with lr decaying geometrically,
        # mirroring GradientDescent (gradient_descent.cc:18-33).
        c = np.array([1.0, -2.0, 3.0])
        lr, decay, iters = 0.1, 0.95, 100

        def loss(x):
            return 0.5 * jnp.sum((x - c) ** 2)

        got = np.asarray(gradient_descent(loss, jnp.zeros(3), iters, lr, decay))
        x = np.zeros(3)
        cur = lr
        for _ in range(iters):
            g = np.clip(x - c, -10, 10)
            x = x - cur * g
            cur *= decay
        np.testing.assert_allclose(got, x, rtol=1e-12)

    def test_clipping_applied_elementwise(self):
        def loss(x):
            return 100.0 * jnp.sum(x)

        got = np.asarray(
            gradient_descent(
                loss, jnp.zeros(2), 1, 0.5, 1.0, min_gradient_clip=-1.0,
                max_gradient_clip=1.0,
            )
        )
        np.testing.assert_allclose(got, [-0.5, -0.5])
