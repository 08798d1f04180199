"""The model across a mesh: the sharding context the model is threaded
with (`ctx.py`), the sharding rules (`partition.py`), this rank's
parameter blocks (`params.py`), and the collectives with the gradients
per-rank code needs, megatron's tensor-parallel products among them
(`comm.py`)."""
from .ctx import ShardCtx, meshed
from .partition import (batch_shardings, cache_shardings, leaves_with_path, map_with_path,
                        opt_state_shardings, param_shardings, param_spec, placements)

__all__ = ["ShardCtx", "meshed", "batch_shardings", "cache_shardings", "leaves_with_path",
           "map_with_path", "opt_state_shardings", "param_shardings", "param_spec", "placements"]
