"""FAST-9 + 3x3 NMS and the patch gather against literal numpy references.

The references walk pixel by pixel (FAST) or slice an edge-padded copy
(patches), independent of the array programs in vo/features.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pilotguru.vo.features import (
    FAST_CIRCLE,
    PATCH_GATHER_RADIUS,
    extract_patches,
    fast_and_nms,
)

THRESHOLD = 20.0 / 255.0


def fast9_reference(img: np.ndarray, threshold: float) -> np.ndarray:
    """Per-pixel FAST-9/16 with the SAD response, in float32 like the
    image; the 3-pixel border is zero."""
    h, w = img.shape
    thr = np.float32(threshold)
    out = np.zeros((h, w), np.float32)
    for y in range(3, h - 3):
        for x in range(3, w - 3):
            center = img[y, x]
            d = np.array(
                [img[y + dy, x + dx] - center for dy, dx in FAST_CIRCLE],
                np.float32,
            )
            response = np.float32(0.0)
            corner = False
            for mask, excess in ((d > thr, d - thr), (d < -thr, -d - thr)):
                ring = np.concatenate([mask, mask])
                if any(ring[s : s + 9].all() for s in range(16)):
                    corner = True
                response = max(response, np.float32(excess[mask].sum()))
            out[y, x] = response if corner else 0.0
    return out


def nms3x3_reference(scores: np.ndarray) -> np.ndarray:
    """Keep a score that is >= every neighbour in its 3x3 window."""
    h, w = scores.shape
    padded = np.pad(scores, 1, constant_values=-np.inf)
    out = np.zeros_like(scores)
    for y in range(h):
        for x in range(w):
            if scores[y, x] >= padded[y : y + 3, x : x + 3].max():
                out[y, x] = scores[y, x]
    return out


@pytest.mark.parametrize("shape", [(64, 96), (120, 160), (130, 250)])
def test_fast_and_nms_match_per_pixel_reference(shape):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, size=shape).astype(np.float32)
    raw, nms = fast_and_nms(jnp.asarray(img), THRESHOLD)
    want_raw = fast9_reference(img, THRESHOLD)
    want_nms = nms3x3_reference(want_raw)
    # The 16 circle differences are summed in another order.
    np.testing.assert_allclose(np.asarray(raw), want_raw, atol=1e-5)
    np.testing.assert_allclose(np.asarray(nms), want_nms, atol=1e-5)
    # Which pixels survive must not depend on that order.
    assert ((np.asarray(nms) > 0) == (want_nms > 0)).all()
    assert (np.asarray(raw) > 0).sum() > 0


def test_structured_corners_and_zeroed_border():
    img = np.full((64, 64), 0.2, np.float32)
    img[20:40, 20:40] = 0.9  # a bright square: corners at its vertices
    img[0:3, :] = 0.9  # texture under the border rows and columns
    img[:, 61:] = 0.0
    raw, nms = (np.asarray(a) for a in fast_and_nms(jnp.asarray(img), THRESHOLD))
    np.testing.assert_allclose(raw, fast9_reference(img, THRESHOLD), atol=1e-5)
    for a in (raw, nms):
        assert a[:3].sum() == 0 and a[-3:].sum() == 0
        assert a[:, :3].sum() == 0 and a[:, -3:].sum() == 0
    # Each vertex of the square keeps one NMS survivor within 2 px.
    ys, xs = np.nonzero(nms)
    for cy, cx in ((20, 20), (20, 39), (39, 20), (39, 39)):
        assert ((np.abs(ys - cy) <= 2) & (np.abs(xs - cx) <= 2)).any()
    # Straight edges away from the vertices are not corners.
    assert raw[30, 20] == 0 and raw[20, 30] == 0


def patches_reference(img: np.ndarray, yx: np.ndarray) -> np.ndarray:
    r = PATCH_GATHER_RADIUS
    padded = np.pad(img, r, mode="edge")
    return np.stack(
        [padded[y : y + 2 * r + 1, x : x + 2 * r + 1] for y, x in yx]
    )


@pytest.mark.parametrize("k", [1, 7, 8, 37])
def test_extract_patches_match_numpy_slicing(k):
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, size=(120, 160)).astype(np.float32)
    yx = np.stack(
        [rng.integers(0, 120, k), rng.integers(0, 160, k)], axis=1
    ).astype(np.int32)
    got = np.asarray(extract_patches(jnp.asarray(img), jnp.asarray(yx)))
    assert got.shape == (k, 2 * PATCH_GATHER_RADIUS + 1, 2 * PATCH_GATHER_RADIUS + 1)
    np.testing.assert_array_equal(got, patches_reference(img, yx))


def test_extract_patches_edge_keypoints():
    """Corners and edges read the edge-padded border."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, size=(64, 96)).astype(np.float32)
    yx = np.array([[0, 0], [0, 95], [63, 0], [63, 95], [31, 47]], np.int32)
    got = np.asarray(extract_patches(jnp.asarray(img), jnp.asarray(yx)))
    np.testing.assert_array_equal(got, patches_reference(img, yx))
    # The top-left patch's first row is the corner pixel repeated.
    assert (got[0, 0, : PATCH_GATHER_RADIUS + 1] == img[0, 0]).all()

