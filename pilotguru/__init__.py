"""pilotguru: a JAX rebuild of the pilotguru self-driving data pipeline.

The reference (waiwnf/pilotguru) is a smartphone-based driving-data system:
C++ postprocessing binaries infer vehicle motion from IMU+GPS and monocular
video, and a PyTorch pipeline trains steering models on the annotated frames.

This package re-designs the computational core as JAX device programs
(run on an NVIDIA GPU, tested on the CPU):

- ``formats``    JSON readers/writers compatible with the recorder data formats
                 (reference: include/io/json_converters.hpp).
- ``timeseries`` merged time series, interpolation intervals, interval
                 averaging and Gaussian smoothing as vectorized array programs
                 (reference: include/interpolation/*).
- ``geometry``   quaternion algebra and strapdown IMU integration expressed as
                 associative scans (reference: src/geometry/geometry.cc).
- ``solvers``    batched masked Levenberg-Marquardt / gradient descent
                 (replaces thirdparty/LBFGS and src/optimization/).
- ``calib``      IMU+GPS calibration objectives and the fit_motion pipeline
                 (reference: src/calibration/, src/fit_motion.cc).
- ``vo``         visual odometry: fixed-shape ORB extraction, matrix-product
                 Hamming matching, dense local bundle adjustment (replaces the
                 vendored ORB-SLAM2/DBoW2/g2o stack).
- ``ml``         Flax steering-model zoo + training loop (reference: python/).
- ``parallel``   jax.sharding mesh helpers for multi-device scaling.
- ``cli``        flag-compatible command-line entry points.
"""

__version__ = "0.1.0"
