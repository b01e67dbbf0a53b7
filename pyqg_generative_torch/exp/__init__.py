"""The experiment pipeline and its CLI (twin: `pyqg_generative_tpu/exp`).
The CLI module, `exp.cli`, is left to `python -m` to import."""
from . import pipeline
