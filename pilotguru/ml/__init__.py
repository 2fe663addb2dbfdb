"""Steering-model zoo, data loading, augmentation and the training loop.

Submodules are imported on use (``from pilotguru.ml import models``), so
importing one module does not pull in the model stack and its
dependencies.
"""
