"""Deviation-score math on numpy arrays (counterpart of infer/deviation.py;
utils_vae.py:147-152):
  * reconstruction_deviation        per-subject MSE over ROIs
  * reconstruction_deviation_roi    elementwise (x - x_hat)^2
"""
from __future__ import annotations

import numpy as np


def reconstruction_deviation(x, x_pred):
    x = np.asarray(x)
    x_pred = np.asarray(x_pred)
    return np.sum((x - x_pred) ** 2, axis=1) / x.shape[1]


def reconstruction_deviation_roi(x, x_pred):
    return (np.asarray(x) - np.asarray(x_pred)) ** 2
