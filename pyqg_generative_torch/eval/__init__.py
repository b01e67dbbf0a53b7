"""Offline and online metrics (twin: `pyqg_generative_tpu/eval`)."""
from . import metrics, comparison, forecast
from .forecast import (ensemble_skill, ensemble_spread,
                       spread_skill_dataset, forecast_skill_table)
from .metrics import subgrid_scores, PDF_histogram
from .comparison import (diagnostic_differences, distrib_score,
                         spectral_score, coarsegrain_reference_dataset,
                         dataset_statistics, dataset_smart_read)
