"""Verbatim copy of `pyqg_generative_tpu/ml/scalers.py` (numpy only), kept
here so that the PyTorch port never imports the JAX package.

Per-channel normalization with float64 statistics and JSON persistence.

Mirrors the reference's ChannelwiseScaler contract
(reference tools/cnn_tools.py:502-553): statistics computed in double
precision, `normalize`/`denormalize` divide/multiply by std,
`normalize_var`/`denormalize_var` act on quadratic quantities, and scalers
round-trip through a JSON file in the model folder.

Array convention here is NHWC (TPU-native): X is (batch, ny, nx, channels).
"""
from __future__ import annotations

import json
import os

import numpy as np

__all__ = ["ChannelwiseScaler"]


class ChannelwiseScaler:
    def __init__(self, X: np.ndarray | None = None):
        if X is not None:
            x64 = np.asarray(X, dtype=np.float64)
            self.mean = x64.mean(axis=(0, 1, 2), keepdims=True).astype("float32")
            self.std = x64.std(axis=(0, 1, 2), keepdims=True).astype("float32")

    @classmethod
    def from_stats(cls, mean, std) -> "ChannelwiseScaler":
        sc = cls()
        sc.mean = np.asarray(mean, "float32").reshape(1, 1, 1, -1)
        sc.std = np.asarray(std, "float32").reshape(1, 1, 1, -1)
        return sc

    # shape (1, 1, 1, C) broadcasting against NHWC batches
    def direct(self, X):
        return (X - self.mean) / self.std

    def inverse(self, X):
        return X * self.std + self.mean

    def normalize(self, X):
        return X / self.std

    def denormalize(self, X):
        return X * self.std

    def normalize_var(self, X):
        return X / (self.std ** 2)

    def denormalize_var(self, X):
        return X * (self.std ** 2)

    def write(self, name: str, folder: str = "model"):
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, name), "w") as f:
            json.dump({"mean": self.mean.ravel().tolist(),
                       "std": self.std.ravel().tolist()}, f)

    def read(self, name: str, folder: str = "model") -> "ChannelwiseScaler":
        with open(os.path.join(folder, name)) as f:
            d = json.load(f)
        self.mean = np.asarray(d["mean"], dtype="float32").reshape(1, 1, 1, -1)
        self.std = np.asarray(d["std"], dtype="float32").reshape(1, 1, 1, -1)
        return self
