from .base import Parameterization, load_model, MODEL_REGISTRY
from .cgan_regression import CGANRegression
