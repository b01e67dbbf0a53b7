from .params import (QGParams, EDDY_PARAMS, JET_PARAMS, DAY, YEAR,
                     ANDREW_1000_STEPS, AVERAGE_SLICE_ANDREW, dt_for_nx)
from .grid import SpectralGrid, make_grid
from . import core, diagnostics
