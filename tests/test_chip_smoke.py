"""chip_smoke.py's phases at tiny sizes on the CPU, its refusal to run
without a GPU, the compile-cache helper and the CLI dtype choice."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from pilotguru.cli import _common

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cpu():
    return jax.devices("cpu")[0]


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_smoke_exits_nonzero_without_gpu(where, tmp_path):
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, str(script)], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_fit_motion_phase_tiny(cpu):
    r = chip_smoke.fit_motion_phase(60.0, cpu, cpu, jnp.float32)
    assert r["rmse"] <= chip_smoke.RMSE_GATE_M_S
    assert 0.0 <= r["max_dv"] <= chip_smoke.DV_TOLERANCE_M_S
    assert r["events"] > 0


def test_corpus_phase_tiny():
    r = chip_smoke.corpus_phase(2, 60.0, jnp.float32)
    assert len(r["rmses"]) == 2
    assert max(r["rmses"]) <= chip_smoke.RMSE_GATE_M_S


def test_vo_phase_tiny(tmp_path):
    r = chip_smoke.track_rendered_ride(
        str(tmp_path), frames=60, width=320, height=240, fx=250.0,
        features=600, levels=3, num_points=400, period_frames=0.0,
    )
    assert r["segments"] >= 1
    assert max(abs(c) for c in r["corrs"]) > chip_smoke.CORR_GATE
    assert sorted(p.name for p in tmp_path.glob("trajectory-*.json"))


def test_extractor_parity_phase_tiny(cpu):
    r = chip_smoke.extractor_parity_phase(160, 120, 100.0, 2, cpu, cpu)
    assert r["identical_share"] == 1.0
    assert r["desc_mismatch"] == 0
    assert r["keypoints"] > 0


def test_brief_int8_phase_tiny(cpu):
    r = chip_smoke.brief_int8_phase(cpu, keypoints=64)
    assert r["seconds"] > 0


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_dir(from_env, monkeypatch, tmp_path):
    saved_dir = jax.config.jax_compilation_cache_dir
    saved_min = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 7.0)
        if from_env:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            want = str(tmp_path)
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            want = os.path.join(REPO, ".jax_compile_cache")
        assert _common.setup_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
        if from_env:  # nothing but the directory is set
            assert jax.config.jax_persistent_cache_min_compile_time_secs == 7.0
    finally:
        jax.config.update("jax_compilation_cache_dir", saved_dir)
        jax.config.update(
            "jax_persistent_cache_min_compile_time_secs", saved_min
        )


def test_compile_cache_lands_in_env_dir(tmp_path):
    """A fresh process with the variable set writes its cache there."""
    code = (
        "import jax, jax.numpy as jnp\n"
        "from pilotguru.cli._common import setup_compile_cache\n"
        "setup_compile_cache()\n"
        "print(jax.jit(lambda x: jnp.sin(x) * 2)(jnp.ones(3)))\n"
    )
    env = {
        **os.environ,
        "JAX_PLATFORMS": "cpu",
        "JAX_COMPILATION_CACHE_DIR": str(tmp_path),
        "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0",
        "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES": "0",
    }
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert any(tmp_path.iterdir())


@pytest.mark.parametrize(
    "flag, want", [("auto", jnp.float64), ("float32", jnp.float32),
                   ("float64", jnp.float64)]
)
def test_setup_backend_dtype(flag, want):
    # auto picks float64 on the CPU (float32 on a GPU).
    assert _common.setup_backend(flag) == want
    if want == jnp.float64:
        assert jax.config.jax_enable_x64


def test_fill_square_matches_cv2_rectangle():
    """parallax_frames draws the filled squares cv2.rectangle draws."""
    cv2 = pytest.importorskip("cv2")
    from synthetic import fill_square, parallax_frames

    rng = np.random.default_rng(0)
    for _ in range(200):  # many squares reach past an image edge
        x, y = int(rng.uniform(-20, 116)), int(rng.uniform(-20, 84))
        r = int(rng.integers(1, 12))
        want = np.zeros((64, 96), np.uint8)
        cv2.rectangle(want, (x - r, y - r), (x + r, y + r), 255, -1)
        got = np.zeros((64, 96), np.uint8)
        fill_square(got, x, y, r, 255)
        np.testing.assert_array_equal(got, want)
    frames = list(parallax_frames(width=96, height=64, frames=3, fx=80.0))
    assert all(f.shape == (64, 96) and f.dtype == np.uint8 for f in frames)
    assert all((f > 25).any() for f in frames)
