from . import simulate, stochastic
from .simulate import run_ensemble, init_run_carry, make_online_step
