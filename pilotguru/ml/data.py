"""npz steering-dataset loading and batching.

Reference: /root/reference/python/io_helpers.py. Same on-disk contract —
directories of ``frame-XXXXXX-data.npz`` files, each holding arrays named
by data element (frame_img uint8, steering, forward_axis, ...) — loaded
eagerly into host RAM like LoadDatasetNumpyFiles (io_helpers.py:44-61).

Layout note: the reference stores images channels-first; this package is
NHWC end to end. ``load_dataset`` transposes image arrays on load, and a
leading frame-history axis (if present) folds into channels, so models see
[B, H, W, C_total].
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Sequence

import numpy as np

from pilotguru.ml import models

DATA_SUFFIX = "data.npz"
MODEL = "model"
LAST = "last"
BEST = "best"


def model_file_name(out_dir: str, model_id: int, tag: str) -> str:
    """Checkpoint naming contract (io_helpers.py:26-28), msgpack payload."""
    return os.path.join(out_dir, f"{MODEL}-{model_id}-{tag}.msgpack")


def preload_model_names(models_dir, num_models):
    if models_dir is None:
        return None
    return [model_file_name(models_dir, i, LAST) for i in range(num_models)]


def sorted_data_files(data_dirs: Sequence[str], data_suffix: str) -> List[str]:
    files = []
    for d in data_dirs:
        files.extend(glob.glob(os.path.join(d, "*" + data_suffix)))
    files.sort()
    return files


def _image_to_nhwc(array: np.ndarray) -> np.ndarray:
    """[C,H,W] -> [H,W,C]; [F,C,H,W] -> [H,W,F*C]."""
    if array.ndim == 3:
        return np.transpose(array, (1, 2, 0))
    if array.ndim == 4:
        f, c, h, w = array.shape
        return np.transpose(array, (2, 3, 0, 1)).reshape(h, w, f * c)
    raise ValueError(f"unexpected image shape {array.shape}")


def load_dataset(
    data_dirs: Sequence[str],
    element_names: Sequence[str],
    data_suffix: str = DATA_SUFFIX,
) -> Dict[str, np.ndarray]:
    """Eagerly load all npz files into one array per element name."""
    files = sorted_data_files(data_dirs, data_suffix)
    if not files:
        raise ValueError(f"no '*{data_suffix}' files under {list(data_dirs)}")
    out = {name: [] for name in element_names}
    for path in files:
        loaded = np.load(path)
        for name in element_names:
            arr = loaded[name]
            if name == models.FRAME_IMG:
                arr = _image_to_nhwc(arr)
            out[name].append(arr)
    return {name: np.stack(vals) for name, vals in out.items()}


def batches(num_examples: int, batch_size: int, rng: np.random.Generator | None):
    """Yield index arrays; shuffled when rng is given, drops no remainder."""
    order = (
        rng.permutation(num_examples)
        if rng is not None
        else np.arange(num_examples)
    )
    for start in range(0, num_examples, batch_size):
        yield order[start : start + batch_size]


def images_to_float(images_uint8: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [0, 1] (io_helpers.py:117-121)."""
    if images_uint8.dtype != np.uint8:
        raise ValueError("frame images must be uint8")
    return images_uint8.astype(np.float32) / 255.0
