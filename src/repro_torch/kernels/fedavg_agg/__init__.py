from .ops import fedavg_agg_plain, fedavg_aggregate, fedavg_aggregate_tree

__all__ = ["fedavg_aggregate", "fedavg_aggregate_tree", "fedavg_agg_plain"]
