from . import mesh, sweep
from .mesh import (make_mesh, ensemble_sharding, batch_sharding, replicated,
                   shard_params_tp)
from .sweep import run_experiment, product_configs
