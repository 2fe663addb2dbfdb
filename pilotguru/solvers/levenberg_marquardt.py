"""Batched damped Gauss-Newton (Levenberg-Marquardt) for small dense problems.

Replaces the reference's per-window L-BFGS solves (thirdparty/LBFGS/LBFGS.h,
driven at /root/reference/src/fit_motion.cc:192-197). The calibration losses
are nonlinear least squares, so Gauss-Newton on the residual vector converges
in far fewer iterations than first-order L-BFGS on the scalar loss, and —
crucially for an accelerator — the whole solve is a fixed-iteration-count jitted loop
with dense D x D normal-equation solves, vmappable over thousands of
independent windows at once (the reference runs them sequentially,
fit_motion.cc:179-246).

Jacobians come from forward-mode autodiff (D tangent passes, D ~ 9), not
hand-derived formulas; the reference's analytic gradients (velocity.cc:95-165)
serve as a test oracle instead.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class LMResult(NamedTuple):
    x: jnp.ndarray  # [D] final parameters
    loss: jnp.ndarray  # [] final sum-of-squares
    iterations: jnp.ndarray  # [] accepted-step count
    converged: jnp.ndarray  # [] bool


def levenberg_marquardt(
    residual_fn: Callable,
    x0,
    num_iters: int = 50,
    init_damping: float = 1e-3,
    damping_down: float = 1.0 / 3.0,
    damping_up: float = 3.0,
    min_damping: float = 1e-12,
    max_damping: float = 1e12,
    grad_tol: float = 1e-10,
    diag_regularization: float = 1e-12,
) -> LMResult:
    """Minimize ||residual_fn(x)||^2 with fixed-iteration-count LM.

    residual_fn: x[D] -> r[R]. Masked problems should return zeros in padded
    residual slots; those rows then contribute nothing to J^T J or J^T r, so
    padding is exact, not approximate.

    The loop always runs ``num_iters`` iterations (static shape for jit);
    rejected steps only raise damping. ``converged`` reports whether the
    gradient dropped below ``grad_tol`` at any point (updates freeze after).
    """
    x0 = jnp.asarray(x0)
    dim = x0.shape[0]
    eye = jnp.eye(dim, dtype=x0.dtype)

    def loss_of(r):
        return jnp.sum(r * r)

    def step(state, _):
        x, damping, nu, loss, iters, done = state
        r = residual_fn(x)
        jac = jax.jacfwd(residual_fn)(x)  # [R, D]
        # Exact-f32 normal equations: GPU default-precision f32 matmuls
        # may multiply in TF32, and a ~1e-3-relative J^T J / J^T r biases
        # every solution at that scale (and the gradient-norm convergence
        # test with it). D is small, so HIGHEST costs nothing measurable.
        hi = jax.lax.Precision.HIGHEST
        jtj = jnp.matmul(jac.T, jac, precision=hi)
        jtr = jnp.matmul(jac.T, r, precision=hi)
        # Marquardt scaling: damp the diagonal, regularized so zero-curvature
        # directions (fully masked-out parameters) stay solvable.
        diag = jnp.diagonal(jtj) + diag_regularization
        a = jtj + damping * jnp.diagflat(diag) + diag_regularization * eye
        dx = -jnp.linalg.solve(a, jtr)

        x_try = x + dx
        loss_try = loss_of(residual_fn(x_try))
        # Nielsen gain-ratio damping: predicted reduction from the damped
        # quadratic model; shrink damping sharply on good steps, escalate
        # geometrically (nu doubling) on rejects so recovery from a bad
        # damping scale costs O(log) iterations.
        predicted = jnp.dot(dx, damping * (diag * dx) - jtr)
        rho = (loss - loss_try) / jnp.maximum(predicted, 1e-300)
        accept = (loss_try < loss) & (predicted > 0)

        grad_small = jnp.max(jnp.abs(2.0 * jtr)) < grad_tol
        done_next = done | grad_small

        x_next = jnp.where(done | ~accept, x, x_try)
        loss_next = jnp.where(done | ~accept, loss, loss_try)
        shrink = jnp.maximum(
            jnp.asarray(damping_down, x.dtype), 1.0 - (2.0 * rho - 1.0) ** 3
        )
        damping_next = jnp.where(accept, damping * shrink, damping * nu)
        nu_next = jnp.where(accept, jnp.asarray(2.0, x.dtype), nu * 2.0)
        damping_next = jnp.where(done, damping, damping_next)
        nu_next = jnp.where(done, nu, nu_next)
        damping_next = jnp.clip(damping_next, min_damping, max_damping)
        iters_next = iters + jnp.where(done | ~accept, 0, 1)
        return (x_next, damping_next, nu_next, loss_next, iters_next, done_next), None

    loss0 = loss_of(residual_fn(x0))
    init = (
        x0,
        jnp.asarray(init_damping, x0.dtype),
        jnp.asarray(damping_up, x0.dtype),
        loss0,
        jnp.asarray(0, jnp.int32),
        jnp.asarray(False),
    )
    (x, _, _, loss, iters, done), _ = jax.lax.scan(
        step, init, None, length=num_iters
    )
    return LMResult(x, loss, iters, done)


def batched_levenberg_marquardt(
    residual_fn: Callable,
    x0_batch,
    *batch_args,
    num_iters: int = 50,
    **lm_kwargs,
) -> LMResult:
    """vmap LM over a batch of independent problems.

    residual_fn(x, *args) -> r; ``batch_args`` are per-problem data arrays
    with a leading batch axis. This is the batched form of the reference's
    sequential sliding-window loop (fit_motion.cc:179-246): every window
    solves simultaneously as one device program.
    """
    solver = partial(levenberg_marquardt, num_iters=num_iters, **lm_kwargs)

    def solve_one(x0, *args):
        return solver(lambda x: residual_fn(x, *args), x0)

    return jax.vmap(solve_one)(x0_batch, *batch_args)
