"""The device's idle share of the traced GAN batches, as
`train.device_idle` reads it."""
from pathlib import Path

from benchmark import manifest

read = manifest.reader("train.device_idle", Path(__file__).parents[1])
