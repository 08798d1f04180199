from .ops import (cell_buffers, fedavg_agg_plain, fedavg_agg_plain_cells,
                  fedavg_aggregate, fedavg_aggregate_leaves,
                  fedavg_aggregate_leaves_batched, fedavg_aggregate_tree)

__all__ = ["fedavg_aggregate", "fedavg_aggregate_leaves",
           "fedavg_aggregate_leaves_batched", "fedavg_aggregate_tree",
           "fedavg_agg_plain", "fedavg_agg_plain_cells", "cell_buffers"]
