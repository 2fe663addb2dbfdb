"""Checks that need a GPU: the float32 path as it runs on the card.

Each test skips without a GPU. On the card:
    JAX_PLATFORMS=cuda,cpu python -m pytest tests/test_gpu.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


def test_fit_motion_float32_matches_cpu_float64(gpu_device):
    cpu = jax.devices("cpu")[0]
    r = chip_smoke.fit_motion_phase(300.0, gpu_device, cpu, jnp.float32)
    assert r["max_dv"] <= chip_smoke.DV_TOLERANCE_M_S


def test_extractor_and_hamming_match_cpu(gpu_device):
    cpu = jax.devices("cpu")[0]
    r = chip_smoke.extractor_parity_phase(640, 480, 350.0, 2, gpu_device, cpu)
    assert r["desc_mismatch"] == 0
    assert r["identical_share"] >= chip_smoke.IDENTICAL_KEYPOINT_FLOOR


def test_brief_int8_product_exact(gpu_device):
    chip_smoke.brief_int8_phase(gpu_device)


def test_geometry_products_keep_float32(gpu_device):
    """geo_jit pins geometry matmuls to full float32: a TF32 product of two
    near-identity rotations would be off by ~1e-3."""
    from pilotguru.vo.pose import geo_jit, rotvec_to_matrix

    compose = geo_jit(lambda a, b: rotvec_to_matrix(a) @ rotvec_to_matrix(b))
    rng = np.random.default_rng(0)
    a, b = (rng.normal(scale=3e-3, size=3).astype(np.float32) for _ in "ab")
    got = np.asarray(compose(jax.device_put(a, gpu_device),
                             jax.device_put(b, gpu_device)))
    cpu = jax.devices("cpu")[0]
    want = np.asarray(compose(jax.device_put(a, cpu), jax.device_put(b, cpu)))
    np.testing.assert_allclose(got, want, atol=1e-6)
