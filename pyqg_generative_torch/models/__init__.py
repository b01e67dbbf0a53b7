from .base import Parameterization, load_model, MODEL_REGISTRY
from .cgan_regression import CGANRegression
from .cvae_regression import CVAERegression
from .mean_var_model import MeanVarModel
