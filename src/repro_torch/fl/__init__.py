"""Federated-learning substrate of the port: client local training, eq.-34
aggregation (sync and buffered async), and the Sec.-VI simulation harness
(host-loop, device-resident scan and async event engines) with its
multi-cell hierarchy (`fl.hierarchical`; the two-tier async engine
`fl.hier_async`)."""
from .async_loop import build_async_runner, commit_event, init_async_carry
from .client import make_local_trainer
from .hierarchical import HierSimConfig, run_hier_many, run_hierarchical
from .server import (AGGREGATION_PRESETS, AsyncAggregation, aggregate,
                     aggregate_buffered, get_aggregation, masked_weighted_mean,
                     staleness_weight)
from .sim import TABLE1, SimConfig, SimHistory, run_many, run_simulation, training_draws

__all__ = ["make_local_trainer", "aggregate", "masked_weighted_mean",
           "AsyncAggregation", "AGGREGATION_PRESETS", "get_aggregation",
           "staleness_weight", "aggregate_buffered",
           "init_async_carry", "commit_event", "build_async_runner",
           "SimConfig", "SimHistory", "TABLE1", "run_simulation", "run_many",
           "training_draws", "HierSimConfig", "run_hierarchical",
           "run_hier_many"]
