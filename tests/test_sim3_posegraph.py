"""Unit tests for Sim(3) algebra, scaled alignment, and the pose graph.

Quick tier: pure math on tiny shapes, deterministic.
"""

import jax
import jax.numpy as jnp
import numpy as np

from pilotguru.vo import posegraph, sim3
from pilotguru.vo.pose import rotvec_to_matrix


def _random_sim7(rng, scale_span=0.4):
    return jnp.asarray(
        np.concatenate(
            [
                rng.normal(size=3) * 0.5,
                rng.normal(size=3),
                rng.uniform(-scale_span, scale_span, size=1),
            ]
        )
    )


class TestSim3Algebra:
    def test_compose_matches_sequential_action(self):
        rng = np.random.default_rng(0)
        a, b = _random_sim7(rng), _random_sim7(rng)
        x = jnp.asarray(rng.normal(size=(7, 3)))
        lhs = sim3.act(sim3.compose(a, b), x)
        rhs = sim3.act(a, sim3.act(b, x))
        np.testing.assert_allclose(np.asarray(lhs), np.asarray(rhs), atol=1e-12)

    def test_inverse_roundtrip(self):
        rng = np.random.default_rng(1)
        a = _random_sim7(rng)
        x = jnp.asarray(rng.normal(size=(5, 3)))
        back = sim3.act(sim3.inverse(a), sim3.act(a, x))
        np.testing.assert_allclose(np.asarray(back), np.asarray(x), atol=1e-12)

    def test_error_vector_zero_iff_equal(self):
        rng = np.random.default_rng(2)
        a = _random_sim7(rng)
        assert float(jnp.max(jnp.abs(sim3.error_vector(a, a)))) == 0.0
        b = _random_sim7(rng)
        assert float(jnp.max(jnp.abs(sim3.error_vector(a, b)))) > 1e-3

    def test_to_pose6_divides_translation_by_scale(self):
        a = jnp.asarray([0.1, -0.2, 0.3, 2.0, -4.0, 6.0, np.log(2.0)])
        p = np.asarray(sim3.to_pose6(a))
        np.testing.assert_allclose(p[3:], [1.0, -2.0, 3.0], atol=1e-12)
        np.testing.assert_allclose(p[:3], [0.1, -0.2, 0.3], atol=1e-12)


class TestUmeyama:
    def test_recovers_known_transform(self):
        rng = np.random.default_rng(3)
        a = _random_sim7(rng)
        pts = jnp.asarray(rng.normal(size=(40, 3)))
        tgt = sim3.act(a, pts)
        fit = sim3.umeyama_sim3(pts, tgt, jnp.ones(40))
        assert bool(fit.valid)
        np.testing.assert_allclose(
            np.asarray(sim3.act(fit.sim7, pts)), np.asarray(tgt), atol=1e-10
        )

    def test_weights_exclude_outliers_exactly(self):
        rng = np.random.default_rng(4)
        a = _random_sim7(rng)
        pts = jnp.asarray(rng.normal(size=(30, 3)))
        tgt = np.asarray(sim3.act(a, pts))
        w = np.ones(30)
        tgt_corrupt = tgt.copy()
        tgt_corrupt[:5] += 100.0
        w[:5] = 0.0
        fit = sim3.umeyama_sim3(pts, jnp.asarray(tgt_corrupt), jnp.asarray(w))
        np.testing.assert_allclose(
            np.asarray(sim3.act(fit.sim7, pts))[5:], tgt[5:], atol=1e-10
        )

    def test_collinear_points_flagged_degenerate(self):
        pts = jnp.asarray(np.outer(np.arange(10.0), [1.0, 2.0, 3.0]))
        fit = sim3.umeyama_sim3(pts, pts, jnp.ones(10))
        assert not bool(fit.valid)

    def test_ransac_rejects_outliers(self):
        rng = np.random.default_rng(5)
        a = _random_sim7(rng)
        pts = jnp.asarray(rng.normal(size=(48, 3)))
        tgt = np.asarray(sim3.act(a, pts))
        corrupt = tgt.copy()
        corrupt[::6] += rng.normal(size=corrupt[::6].shape) * 8.0
        fit = sim3.ransac_umeyama(
            pts, jnp.asarray(corrupt), jnp.ones(48, bool), jax.random.PRNGKey(0)
        )
        clean = np.ones(48, bool)
        clean[::6] = False
        assert int(fit.num_inliers) >= clean.sum() - 2
        err = np.linalg.norm(
            np.asarray(sim3.act(fit.sim7, pts))[clean] - tgt[clean], axis=-1
        )
        assert err.max() < 1e-6


class TestPoseGraph:
    def _circle_poses(self, k, radius=10.0):
        poses = []
        for i in range(k):
            th = 2 * np.pi * i / k
            c = np.array([radius * np.sin(th), 0.0, radius * (1 - np.cos(th))])
            rv = np.array([0.0, th, 0.0])
            r = np.asarray(rotvec_to_matrix(jnp.asarray(rv)))
            poses.append(np.concatenate([rv, -r @ c, [0.0]]))
        return np.stack(poses)

    def test_loop_edge_fixes_accumulated_drift(self):
        k = 24
        true = self._circle_poses(k)
        # Integrate odometry with a deterministic bias -> end-node drift.
        est = [true[0]]
        rels = []
        for i in range(k - 1):
            rel = np.asarray(
                sim3.compose(
                    jnp.asarray(true[i + 1]), sim3.inverse(jnp.asarray(true[i]))
                )
            )
            rel = rel + np.concatenate(
                [np.full(3, 0.004), np.full(3, 0.02), [0.003]]
            )
            rels.append(rel)
            est.append(
                np.asarray(sim3.compose(jnp.asarray(rel), jnp.asarray(est[-1])))
            )
        est = np.stack(est)

        def end_drift(nodes):
            return float(
                np.linalg.norm(
                    np.asarray(
                        sim3.error_vector(
                            jnp.asarray(nodes[-1]), jnp.asarray(true[-1])
                        )
                    )
                )
            )

        before = end_drift(est)
        edge_i = np.concatenate([np.arange(1, k), [k - 1]]).astype(np.int32)
        edge_j = np.concatenate([np.arange(0, k - 1), [0]]).astype(np.int32)
        loop = np.asarray(
            sim3.compose(jnp.asarray(true[-1]), sim3.inverse(jnp.asarray(true[0])))
        )
        meas = np.concatenate([np.stack(rels), loop[None]])
        res = posegraph.optimize_pose_graph(
            jnp.asarray(est),
            jnp.asarray(edge_i),
            jnp.asarray(edge_j),
            jnp.asarray(meas),
            jnp.ones(edge_i.size, bool),
            num_iters=40,
        )
        after = end_drift(np.asarray(res.nodes7))
        assert after < before / 5.0, (before, after)

    def test_padded_edges_are_inert(self):
        k = 6
        true = self._circle_poses(k)
        edge_i, edge_j, meas = posegraph.chain_edges(jnp.asarray(true))
        pad_i = np.concatenate([edge_i, np.zeros(3, np.int32)])
        pad_j = np.concatenate([edge_j, np.zeros(3, np.int32)])
        pad_m = np.concatenate([meas, np.tile(np.zeros(7)[None], (3, 1))])
        valid = np.concatenate([np.ones(edge_i.size, bool), np.zeros(3, bool)])
        res = posegraph.optimize_pose_graph(
            jnp.asarray(true),
            jnp.asarray(pad_i),
            jnp.asarray(pad_j),
            jnp.asarray(pad_m),
            jnp.asarray(valid),
            num_iters=10,
        )
        # Consistent graph + padding: solution stays at the initial poses.
        np.testing.assert_allclose(np.asarray(res.nodes7), true, atol=1e-6)
