"""Ensemble inference helpers: load checkpoints, eval, EMA trajectory update.

Reference: /root/reference/python/prediction_helpers.py. The ensemble runs
as one vmapped forward pass (the reference loops nets sequentially,
prediction_helpers.py:31-34).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from pilotguru.ml import models as models_lib
from pilotguru.ml import training


def update_future_trajectory_prediction(
    previous: Optional[np.ndarray], current: np.ndarray, lr: float
) -> np.ndarray:
    """EMA-with-shift trajectory update (prediction_helpers.py:15-29).

    Predictions are [1, T] future trajectories; each step blends the new
    prediction with the previous one shifted forward by one step.
    """
    if not (0 < lr <= 1):
        raise ValueError("lr must be in (0, 1]")
    current = np.asarray(current)
    if previous is None:
        return np.copy(current)
    result = np.copy(previous)
    result[0, :-1] = lr * current[0, :-1] + (1.0 - lr) * previous[0, 1:]
    result[0, -1] = current[0, -1]
    return result


class EnsemblePredictor:
    """Stacked-parameter ensemble with a jitted mean-forward pass."""

    def __init__(self, model, stacked_variables: Dict):
        self._model = model
        self._variables = stacked_variables

        def forward(params, batch_stats, inputs):
            def one(p, s):
                return model.apply(
                    {"params": p, "batch_stats": s}, inputs, train=False
                )

            outs = jax.vmap(one)(params, batch_stats)  # [N, B, L]
            return jnp.mean(outs, axis=0)

        self._forward = jax.jit(forward)

    @classmethod
    def from_checkpoints(cls, model, checkpoint_paths: List[str]):
        return cls(model, training.load_ensemble_params(checkpoint_paths))

    def __call__(self, inputs: Dict[str, np.ndarray]) -> np.ndarray:
        """inputs: dict of [B, ...] arrays -> ensemble-mean predictions [B, L]."""
        return np.asarray(
            self._forward(
                self._variables["params"], self._variables["batch_stats"], inputs
            )
        )


def frame_to_model_input(
    raw_frame_hwc: np.ndarray,
    crop_top: int = 0,
    crop_bottom: int = 0,
    crop_left: int = 0,
    crop_right: int = 0,
    target_height: Optional[int] = None,
    target_width: Optional[int] = None,
    convert_to_yuv: bool = False,
):
    """Crop/resize/convert one camera frame into a [1, H, W, C] float input.

    Matches RawFrameToModelInput (prediction_helpers.py:36-58), NHWC.
    Returns (model_input, resized_uint8_frame).
    """
    import cv2

    h, w = raw_frame_hwc.shape[:2]
    cropped = raw_frame_hwc[
        crop_top : h - crop_bottom if crop_bottom else h,
        crop_left : w - crop_right if crop_right else w,
    ]
    if (
        target_height is not None
        and target_width is not None
        and cropped.shape[:2] != (target_height, target_width)
    ):
        cropped = cv2.resize(
            cropped, (target_width, target_height), interpolation=cv2.INTER_AREA
        )
    if convert_to_yuv:
        cropped = cv2.cvtColor(cropped, cv2.COLOR_RGB2YUV)
    model_input = cropped.astype(np.float32)[None, ...] / 255.0
    return model_input, cropped
