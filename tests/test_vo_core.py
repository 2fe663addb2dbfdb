import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pilotguru.vo import ba as ba_lib
from pilotguru.vo import features, matching, pose as pose_lib, twoview
from pilotguru.vo.flatten import (
    plane_is_valid,
    project_directions,
    project_translations,
    trajectory_pca,
    turn_angles_from_directions,
)


def _textured_image(rng, h=120, w=160, blocks=12):
    """Random blocky texture: strong corners everywhere."""
    small = rng.uniform(0.1, 0.9, size=(blocks, blocks))
    img = np.kron(small, np.ones((h // blocks + 1, w // blocks + 1)))[:h, :w]
    return img.astype(np.float32)


class TestFast:
    def test_detects_block_corners(self):
        rng = np.random.default_rng(0)
        img = _textured_image(rng)
        scores = np.asarray(features.fast_scores(jnp.asarray(img), 20.0 / 255.0))
        assert (scores > 0).sum() > 50
        # Border must be zero.
        assert scores[:3].sum() == 0 and scores[-3:].sum() == 0

    def test_flat_image_has_no_corners(self):
        img = jnp.full((64, 64), 0.5)
        scores = np.asarray(features.fast_scores(img, 20.0 / 255.0))
        assert scores.sum() == 0

    def test_single_bright_dot_is_corner(self):
        img = np.full((32, 32), 0.2, np.float32)
        img[16, 16] = 1.0
        scores = np.asarray(features.fast_scores(jnp.asarray(img), 0.1))
        assert scores[16, 16] > 0


class TestExtractor:
    def test_extract_budget_and_coordinates(self):
        rng = np.random.default_rng(1)
        img = _textured_image(rng, h=240, w=320)
        kps = features.extract_orb_features(
            jnp.asarray(img), num_levels=4, total_budget=400
        )
        valid = np.asarray(kps.valid)
        xy = np.asarray(kps.xy)
        assert valid.sum() > 100
        assert xy.shape[0] == np.asarray(kps.descriptors).shape[0]
        assert (xy[valid, 0] < 320 + 2).all() and (xy[valid, 1] < 240 + 2).all()
        # Multiple pyramid levels contribute.
        assert len(np.unique(np.asarray(kps.level)[valid])) >= 2

    def test_720p_reference_budget_spatial_spread(self):
        """Reference scale (2000 features / 8 levels, calibrate.cc:518-531)
        on a 1280x720 frame: the grid-top-k selection must cover the frame
        like ORBextractor's octree distribution — keypoints in (nearly)
        every occupied coarse region, not clumped on the strongest texture.
        """
        rng = np.random.default_rng(7)
        img = _textured_image(rng, h=720, w=1280)
        # Make one corner region much higher-contrast: a clump-prone input.
        img[:180, :320] = np.clip(img[:180, :320] * 1.8, 0, 1)
        kps = features.extract_orb_features(
            jnp.asarray(img), num_levels=8, total_budget=2000
        )
        valid = np.asarray(kps.valid)
        xy = np.asarray(kps.xy)[valid]
        # Blocky synthetic texture yields ~1 keypoint per grid cell per
        # level, so the full 2000 budget does not fill; >1000 distinct
        # corners at 720p is the meaningful bar.
        assert valid.sum() > 1000
        # Coverage over an 8x8 coarse grid: textured everywhere, so nearly
        # every region must hold keypoints.
        gx = np.clip((xy[:, 0] / 1280.0 * 8).astype(int), 0, 7)
        gy = np.clip((xy[:, 1] / 720.0 * 8).astype(int), 0, 7)
        occupied = np.zeros((8, 8), bool)
        occupied[gy, gx] = True
        assert occupied.sum() >= 60, f"only {occupied.sum()}/64 regions covered"
        # The boosted-contrast corner must not dominate.
        clump = ((xy[:, 0] < 320) & (xy[:, 1] < 180)).mean()
        assert clump < 0.25, f"{clump:.0%} of keypoints clumped in one corner"

    def test_patch_orientation_matches_gather_path(self):
        """orientations_from_patches computes the same intensity-centroid
        moments as the per-keypoint dynamic-slice path (IC_Angle semantics),
        just as a static einsum over pre-gathered patches."""
        rng = np.random.default_rng(3)
        img = jnp.asarray(_textured_image(rng, h=160, w=200))
        yx = jnp.asarray(
            np.stack(
                [rng.integers(0, 160, 64), rng.integers(0, 200, 64)], axis=1
            ).astype(np.int32)
        )
        patches = features.extract_patches(img, yx)
        got = np.asarray(features.orientations_from_patches(patches))
        want = np.asarray(features.orientations(img, yx))
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_brief_matmul_exact_at_bin_centers(self):
        """At exact steering-bin angles on a 0..255-grid image, the int8
        matmul BRIEF reproduces the scattered-gather path bit-for-bit (same
        rotated tap rounding, exact two-term difference in int32)."""
        rng = np.random.default_rng(4)
        img8 = rng.integers(0, 256, size=(160, 200)).astype(np.float32)
        img = jnp.asarray(img8 / 255.0)
        k = 64
        yx = jnp.asarray(
            np.stack(
                [rng.integers(0, 160, k), rng.integers(0, 200, k)], axis=1
            ).astype(np.int32)
        )
        bins = rng.integers(0, features.BRIEF_ANGLE_BINS, k)
        angles = jnp.asarray(
            bins * 2 * np.pi / features.BRIEF_ANGLE_BINS
        ).astype(jnp.float32)
        patches = features.extract_patches(img, yx)
        got = np.asarray(features.brief_from_patches(patches, angles))
        want = np.asarray(features.brief_descriptors(img, yx, angles))
        np.testing.assert_array_equal(got, want)

    def test_brief_matmul_close_at_arbitrary_angles(self):
        """Between bin centers the binned steering moves taps by at most
        ~2 px; on a smoothed (real-image-like) texture the descriptors stay
        close to the exact-angle gather path."""
        from pilotguru.ml.augmentation import gaussian_blur

        rng = np.random.default_rng(5)
        img = jnp.asarray(_textured_image(rng, h=160, w=200))
        img = gaussian_blur(img[None, :, :, None], 2.0)[0, :, :, 0]
        k = 64
        yx = jnp.asarray(
            np.stack(
                [rng.integers(0, 160, k), rng.integers(0, 200, k)], axis=1
            ).astype(np.int32)
        )
        angles = jnp.asarray(rng.uniform(-np.pi, np.pi, k).astype(np.float32))
        patches = features.extract_patches(img, yx)
        got = np.asarray(features.brief_from_patches(patches, angles))
        want = np.asarray(features.brief_descriptors(img, yx, angles))
        mean_hamming = (got != want).sum(axis=1).mean()
        assert mean_hamming < 32, f"mean Hamming {mean_hamming} vs exact-angle"

    def test_descriptors_distinguish_keypoints(self):
        rng = np.random.default_rng(2)
        img = _textured_image(rng, h=160, w=200)
        kps = features.extract_orb_features(
            jnp.asarray(img), num_levels=2, total_budget=200
        )
        valid = np.asarray(kps.valid)
        desc = np.asarray(kps.descriptors)[valid]
        # Pairwise distances mostly large.
        d = matching.hamming_table(jnp.asarray(desc), jnp.asarray(desc))
        d = np.asarray(d)
        off_diag = d[~np.eye(d.shape[0], dtype=bool)]
        # Blocky synthetic texture repeats similar corners (and pyramid
        # levels duplicate physical corners), so the spread is narrower than
        # on natural images; distinct keypoints must still be separable.
        assert np.median(off_diag) > 40
        assert (off_diag < 10).mean() < 0.05


class TestMatching:
    def test_hamming_table_matches_numpy(self):
        rng = np.random.default_rng(3)
        a = rng.integers(0, 2, size=(20, 256)).astype(np.uint8)
        b = rng.integers(0, 2, size=(30, 256)).astype(np.uint8)
        got = np.asarray(matching.hamming_table(jnp.asarray(a), jnp.asarray(b)))
        want = (a[:, None, :] != b[None, :, :]).sum(axis=2)
        np.testing.assert_array_equal(got, want)

    def test_planted_matches_recovered(self):
        rng = np.random.default_rng(4)
        base = rng.integers(0, 2, size=(100, 256)).astype(np.uint8)
        perm = rng.permutation(100)
        noisy = base[perm].copy()
        flips = rng.integers(0, 256, size=(100, 10))
        for i in range(100):
            noisy[i, flips[i]] ^= 1
        m = matching.match_descriptors(
            jnp.asarray(base),
            jnp.asarray(noisy),
            valid_a=jnp.ones(100, bool),
            valid_b=jnp.ones(100, bool),
        )
        idx = np.asarray(m.index)
        valid = np.asarray(m.valid)
        assert valid.sum() > 90
        inv = np.argsort(perm)
        np.testing.assert_array_equal(idx[valid], inv[valid])


def _synthetic_two_view(rng, n=200, outliers=0):
    points = np.stack(
        [
            rng.uniform(-2, 2, n),
            rng.uniform(-1.5, 1.5, n),
            rng.uniform(4, 12, n),
        ],
        axis=1,
    )
    angle = 0.06
    r21 = np.array(
        [
            [np.cos(angle), 0, np.sin(angle)],
            [0, 1, 0],
            [-np.sin(angle), 0, np.cos(angle)],
        ]
    )
    t21 = np.array([0.4, 0.02, 0.1])
    t21 /= np.linalg.norm(t21)
    cam2 = points @ r21.T + t21
    p1 = points[:, :2] / points[:, 2:3]
    p2 = cam2[:, :2] / cam2[:, 2:3]
    if outliers:
        idx = rng.choice(n, outliers, replace=False)
        p2[idx] += rng.uniform(0.05, 0.2, size=(outliers, 2))
    return points, r21, t21, p1, p2


class TestTwoView:
    def test_pose_recovery_clean(self):
        rng = np.random.default_rng(5)
        points, r21, t21, p1, p2 = _synthetic_two_view(rng)
        res = twoview.two_view_reconstruction(
            jnp.asarray(p1), jnp.asarray(p2), jnp.ones(len(p1), bool),
            jax.random.PRNGKey(0),
        )
        np.testing.assert_allclose(np.asarray(res.rotation), r21, atol=1e-3)
        t_got = np.asarray(res.translation)
        cos = abs(t_got @ t21)
        assert cos > 0.999
        assert int(res.score) > 180

    def test_pose_recovery_with_outliers(self):
        rng = np.random.default_rng(6)
        points, r21, t21, p1, p2 = _synthetic_two_view(rng, outliers=40)
        res = twoview.two_view_reconstruction(
            jnp.asarray(p1), jnp.asarray(p2), jnp.ones(len(p1), bool),
            jax.random.PRNGKey(1),
        )
        np.testing.assert_allclose(np.asarray(res.rotation), r21, atol=5e-3)
        assert abs(np.asarray(res.translation) @ t21) > 0.995
        # Outliers excluded.
        assert int(res.score) < 180

    def test_planar_scene_homography_init(self):
        """All points on ONE plane: the 8-point essential fit is degenerate
        (a plane gives the fundamental matrix a multi-parameter solution
        family, so the SVD null vector is arbitrary), which is exactly why
        the reference scores a homography in parallel and picks by
        RH = SH/(SH+SF) (Initializer.cc:104-124). The pose must come out
        right via the Faugeras decomposition (ReconstructH)."""
        rng = np.random.default_rng(11)
        n = 200
        x = rng.uniform(-2.0, 2.0, n)
        y = rng.uniform(-1.5, 1.5, n)
        # Slanted plane (non-frontoparallel) well in front of both cameras.
        z = 5.0 + 0.8 * x - 0.4 * y
        points = np.stack([x, y, z], axis=1)
        angle = 0.06
        r21 = np.array(
            [
                [np.cos(angle), 0, np.sin(angle)],
                [0, 1, 0],
                [-np.sin(angle), 0, np.cos(angle)],
            ]
        )
        t21 = np.array([0.5, -0.1, 0.15])
        t21 /= np.linalg.norm(t21)
        cam2 = points @ r21.T + t21
        p1 = points[:, :2] / points[:, 2:3]
        p2 = cam2[:, :2] / cam2[:, 2:3]
        res = twoview.two_view_reconstruction(
            jnp.asarray(p1), jnp.asarray(p2), jnp.ones(n, bool),
            jax.random.PRNGKey(3),
        )
        np.testing.assert_allclose(np.asarray(res.rotation), r21, atol=5e-3)
        assert abs(np.asarray(res.translation) @ t21) > 0.995
        assert int(res.score) > 150
        # Triangulated map must live on the true plane (scale-normalized).
        pts = np.asarray(res.points3d)[np.asarray(res.inliers)]
        scale = np.median(pts[:, 2]) / np.median(points[:, 2])
        plane_err = pts[:, 2] / scale - (
            5.0 + 0.8 * pts[:, 0] / scale - 0.4 * pts[:, 1] / scale
        )
        assert np.percentile(np.abs(plane_err), 90) < 0.05

    def test_homography_decomposition_roundtrip(self):
        """decompose_homography must contain the true (R, t) among its 8
        Faugeras hypotheses for a synthetic plane-induced homography."""
        angle = 0.1
        r21 = np.array(
            [
                [np.cos(angle), -np.sin(angle), 0],
                [np.sin(angle), np.cos(angle), 0],
                [0, 0, 1],
            ]
        )
        t21 = np.array([0.3, 0.1, -0.05])
        n_plane = np.array([0.1, -0.2, 1.0])
        d = 4.0
        h = r21 + np.outer(t21, n_plane) / d
        rs, ts = twoview.decompose_homography(jnp.asarray(h))
        rs, ts = np.asarray(rs), np.asarray(ts)
        t_unit = t21 / np.linalg.norm(t21)
        best_r = min(np.linalg.norm(rs - r21, axis=(1, 2)))
        best_t = max(abs(ts @ t_unit))
        assert best_r < 1e-5
        assert best_t > 1.0 - 1e-6

    def test_triangulation_accuracy(self):
        rng = np.random.default_rng(7)
        points, r21, t21, p1, p2 = _synthetic_two_view(rng, n=50)
        tri = np.asarray(
            twoview.triangulate(
                jnp.asarray(r21), jnp.asarray(t21), jnp.asarray(p1), jnp.asarray(p2)
            )
        )
        np.testing.assert_allclose(tri, points, rtol=1e-4, atol=1e-5)


class TestPoseOptimization:
    def test_recovers_perturbed_pose(self):
        rng = np.random.default_rng(8)
        points = np.stack(
            [rng.uniform(-2, 2, 120), rng.uniform(-2, 2, 120), rng.uniform(4, 10, 120)],
            axis=1,
        )
        true_pose = jnp.asarray([0.02, -0.03, 0.01, 0.1, -0.05, 0.2])
        obs = pose_lib.project(pose_lib.transform(true_pose, jnp.asarray(points)))
        init = true_pose + jnp.asarray([0.02, 0.01, -0.02, 0.1, 0.1, -0.1])
        res = pose_lib.optimize_pose(
            init, jnp.asarray(points), obs, jnp.ones(120, bool)
        )
        np.testing.assert_allclose(np.asarray(res.pose6), np.asarray(true_pose), atol=1e-6)
        assert int(res.num_inliers) == 120

    def test_robust_to_outliers(self):
        rng = np.random.default_rng(9)
        points = np.stack(
            [rng.uniform(-2, 2, 150), rng.uniform(-2, 2, 150), rng.uniform(4, 10, 150)],
            axis=1,
        )
        true_pose = jnp.asarray([0.0, 0.05, -0.02, -0.2, 0.1, 0.05])
        obs = np.array(
            pose_lib.project(pose_lib.transform(true_pose, jnp.asarray(points)))
        )
        out_idx = rng.choice(150, 30, replace=False)
        obs[out_idx] += rng.uniform(0.05, 0.3, size=(30, 2))
        res = pose_lib.optimize_pose(
            true_pose + 0.05, jnp.asarray(points), jnp.asarray(obs),
            jnp.ones(150, bool),
        )
        np.testing.assert_allclose(
            np.asarray(res.pose6), np.asarray(true_pose), atol=1e-3
        )
        inliers = np.asarray(res.inliers)
        assert not inliers[out_idx].any()
        assert inliers.sum() >= 115

    def test_rotvec_roundtrip(self):
        rng = np.random.default_rng(10)
        for _ in range(10):
            w = rng.normal(size=3) * 0.7
            r = np.asarray(pose_lib.rotvec_to_matrix(jnp.asarray(w)))
            w_back = np.asarray(pose_lib.matrix_to_rotvec(jnp.asarray(r)))
            np.testing.assert_allclose(w_back, w, atol=1e-7)
            q = np.asarray(pose_lib.matrix_to_quat(jnp.asarray(r)))
            # Quaternion reproduces the same rotation matrix.
            from pilotguru.geometry.quaternion import quat_to_rotation_matrix

            r_q = np.asarray(quat_to_rotation_matrix(jnp.asarray(q)))
            np.testing.assert_allclose(r_q, r, atol=1e-7)


class TestBundleAdjustment:
    def test_refines_noisy_initialization(self):
        rng = np.random.default_rng(11)
        k, m = 4, 60
        points = np.stack(
            [rng.uniform(-2, 2, m), rng.uniform(-2, 2, m), rng.uniform(5, 12, m)],
            axis=1,
        )
        poses = np.zeros((k, 6))
        for i in range(k):
            poses[i, 3] = -0.3 * i  # camera moving along +x world
            poses[i, 1] = 0.01 * i

        obs_pose, obs_point, obs_uv = [], [], []
        for i in range(k):
            uv = np.asarray(
                pose_lib.project(
                    pose_lib.transform(jnp.asarray(poses[i]), jnp.asarray(points))
                )
            )
            obs_pose.extend([i] * m)
            obs_point.extend(range(m))
            obs_uv.append(uv)
        obs_uv = np.concatenate(obs_uv)

        noisy_poses = poses + rng.normal(scale=0.01, size=poses.shape)
        noisy_poses[0] = poses[0]  # gauge anchor stays
        noisy_points = points + rng.normal(scale=0.05, size=points.shape)

        problem = ba_lib.BAProblem(
            jnp.asarray(noisy_poses),
            jnp.asarray(noisy_points),
            jnp.asarray(obs_pose, jnp.int32),
            jnp.asarray(obs_point, jnp.int32),
            jnp.asarray(obs_uv),
            jnp.ones(len(obs_pose), bool),
            jnp.ones(m, bool),
        )
        result = ba_lib.bundle_adjust(problem)

        def rms(poses_arr, points_arr):
            total = []
            for i in range(k):
                uv = np.asarray(
                    pose_lib.project(
                        pose_lib.transform(
                            jnp.asarray(poses_arr[i]), jnp.asarray(points_arr)
                        )
                    )
                )
                total.append(uv - obs_uv[i * m : (i + 1) * m])
            return np.sqrt(np.mean(np.concatenate(total) ** 2))

        before = rms(noisy_poses, noisy_points)
        after = rms(np.asarray(result.poses6), np.asarray(result.points))
        assert after < before * 1e-2, (before, after)
        assert np.asarray(result.obs_inliers).mean() > 0.95

    def test_schur_matches_dense_solver(self):
        """The Schur-complement LM must land on the same optimum as the
        flattened dense formulation it replaced (both solve the identical
        damped normal equations; only the factorization differs)."""
        rng = np.random.default_rng(7)
        k, m = 4, 50
        points = np.stack(
            [rng.uniform(-2, 2, m), rng.uniform(-2, 2, m), rng.uniform(5, 12, m)],
            axis=1,
        )
        poses = np.zeros((k, 6))
        poses[:, 3] = -0.3 * np.arange(k)
        poses[:, 1] = 0.015 * np.arange(k)

        obs_pose, obs_point, obs_uv = [], [], []
        for i in range(k):
            uv = np.asarray(
                pose_lib.project(
                    pose_lib.transform(jnp.asarray(poses[i]), jnp.asarray(points))
                )
            )
            obs_pose.extend([i] * m)
            obs_point.extend(range(m))
            obs_uv.append(uv)
        obs_uv = np.concatenate(obs_uv) + rng.normal(scale=3e-4, size=(k * m, 2))

        noisy_poses = poses + rng.normal(scale=0.01, size=poses.shape)
        noisy_poses[0] = poses[0]
        noisy_points = points + rng.normal(scale=0.05, size=points.shape)
        # Exercise padding: a masked-out point and masked-out observations.
        point_valid = np.ones(m, bool)
        point_valid[-1] = False
        obs_valid = np.ones(k * m, bool)
        obs_valid[-3:] = False
        invsigma = rng.uniform(0.5, 1.0, size=k * m)

        problem = ba_lib.BAProblem(
            jnp.asarray(noisy_poses),
            jnp.asarray(noisy_points),
            jnp.asarray(obs_pose, jnp.int32),
            jnp.asarray(obs_point, jnp.int32),
            jnp.asarray(obs_uv),
            jnp.asarray(obs_valid),
            jnp.asarray(point_valid),
            jnp.asarray(invsigma),
        )
        r_dense = ba_lib.bundle_adjust(problem, solver="dense")
        r_schur = ba_lib.bundle_adjust(problem, solver="schur")
        np.testing.assert_allclose(
            np.asarray(r_schur.poses6), np.asarray(r_dense.poses6), atol=1e-5
        )
        valid = point_valid
        np.testing.assert_allclose(
            np.asarray(r_schur.points)[valid],
            np.asarray(r_dense.points)[valid],
            atol=1e-4,
        )
        assert bool(
            np.all(
                np.asarray(r_schur.obs_inliers) == np.asarray(r_dense.obs_inliers)
            )
        )


class TestFlatten:
    def test_pca_plane_and_validity(self):
        rng = np.random.default_rng(12)
        t = np.stack(
            [rng.uniform(-5, 5, 200), rng.uniform(-3, 3, 200),
             rng.normal(scale=1e-3, size=200)],
            axis=1,
        )
        axes, eigvals = trajectory_pca(t)
        assert plane_is_valid(eigvals)
        # Plane spans x, y.
        assert abs(axes[2] @ np.array([0, 0, 1.0])) > 0.999

    def test_vertical_motion_invalidates(self):
        rng = np.random.default_rng(13)
        t = rng.uniform(-1, 1, size=(100, 3))
        _, eigvals = trajectory_pca(t)
        assert not plane_is_valid(eigvals)

    def test_turn_angles_sign(self):
        # Direction rotating counterclockwise -> positive cross -> +angle.
        angles = np.linspace(0, np.pi / 2, 10)
        dirs = np.stack([np.cos(angles), np.sin(angles)], axis=1)
        turns = turn_angles_from_directions(dirs)
        assert turns[0] == 0
        np.testing.assert_allclose(turns[1:], angles[1] - angles[0], atol=1e-9)

    def test_project_translations_idempotent(self):
        rng = np.random.default_rng(14)
        t = rng.normal(size=(50, 3))
        plane = np.array([[1.0, 0, 0], [0, 1.0, 0]])
        flat = project_translations(t, plane)
        np.testing.assert_allclose(flat[:, 2], 0, atol=1e-12)
        np.testing.assert_allclose(project_translations(flat, plane), flat)

    def test_project_directions_unit_z(self):
        from pilotguru.geometry.quaternion import quat_normalize

        rng = np.random.default_rng(15)
        q = np.asarray(quat_normalize(jnp.asarray(rng.normal(size=(20, 4)))))
        plane = np.array([[1.0, 0, 0], [0, 0, 1.0]])
        dirs = project_directions(q, plane)
        assert dirs.shape == (20, 2)
        assert (np.linalg.norm(dirs, axis=1) <= 1.0 + 1e-9).all()


class TestCameraModel:
    def test_undistort_matches_cv2(self):
        """CameraModel.normalize must invert the OpenCV distortion model.

        Oracle: cv2.undistortPoints on a grid of pixels, with typical
        smartphone coefficients (Frame.cc:408 UndistortKeyPoints parity).
        """
        import cv2

        from pilotguru.vo.tracking import CameraModel

        fx, fy, cx, cy = 700.0, 705.0, 640.0, 360.0
        k1, k2, p1, p2 = -0.28, 0.07, 1.5e-3, -8e-4
        cam = CameraModel(fx, fy, cx, cy, k1=k1, k2=k2, p1=p1, p2=p2)

        xs = np.linspace(40.0, 1240.0, 13)
        ys = np.linspace(40.0, 680.0, 9)
        gx, gy = np.meshgrid(xs, ys)
        pix = np.stack([gx.ravel(), gy.ravel()], axis=-1)

        got = cam.normalize(pix)

        # True invariant: forward-distorting the result must land exactly on
        # the input pixels. (cv2.undistortPoints' default 5-iteration scheme
        # leaves ~0.04 px roundtrip error at the corners of this lens, so it
        # is only a loose convention oracle, checked second.)
        x, y = got[..., 0], got[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        roundtrip = np.stack([xd * fx + cx, yd * fy + cy], axis=-1)
        np.testing.assert_allclose(roundtrip, pix, atol=1e-9)

        k_mat = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        dist = np.array([k1, k2, p1, p2])
        want = cv2.undistortPoints(
            pix.reshape(-1, 1, 2).astype(np.float64), k_mat, dist
        ).reshape(-1, 2)
        np.testing.assert_allclose(got, want, atol=2e-3)

    def test_zero_distortion_is_pure_pinhole(self):
        from pilotguru.vo.tracking import CameraModel

        cam = CameraModel(500.0, 500.0, 320.0, 240.0)
        pix = np.array([[320.0, 240.0], [820.0, 740.0]])
        np.testing.assert_allclose(cam.normalize(pix), [[0, 0], [1, 1]])
