from .base import Parameterization, load_model, MODEL_REGISTRY, \
    save_model_args, save_variables
from .ols_model import OLSModel
from .mean_var_model import MeanVarModel
from .cgan_regression import CGANRegression
from .cvae_regression import CVAERegression
from .cvae_bottleneck import CVAEBottleneck
from .ann_model import ANNModel
from .physical import (PhysicalParameterization, ZannaBolton2020,
                       Smagorinsky, BackscatterBiharmonic, BackscatterEddy,
                       BackscatterJet, ADM, ReynoldsStress, HybridSymbolic,
                       Laplace, BackscatterBiharmonicEddy,
                       BackscatterBiharmonicJet)
