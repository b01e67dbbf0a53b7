from . import graph, simulate, stochastic
from .simulate import (run_simulation, run_ensemble, run_ensemble_segmented,
                       set_initial_condition, init_run_carry, advance_run,
                       run_with_snapshots, make_online_step,
                       generate_subgrid_forcing,
                       generate_subgrid_forcing_batch)
