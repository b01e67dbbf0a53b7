"""Kernels a GAN training batch, as `train.kernels_per_batch` reads them,
over the traced batches: one whole period of the schedule (a generator
batch and four critic-only ones)."""
from pathlib import Path

from benchmark import manifest

read = manifest.reader("train.kernels_per_batch", Path(__file__).parents[1])
