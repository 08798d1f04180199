"""Federated-learning substrate of the port: client local training, eq.-34
aggregation, and the Sec.-VI simulation harness (host-loop engine)."""
from .client import make_local_trainer
from .server import aggregate, masked_weighted_mean
from .sim import TABLE1, SimConfig, SimHistory, run_many, run_simulation, training_draws

__all__ = ["make_local_trainer", "aggregate", "masked_weighted_mean",
           "SimConfig", "SimHistory", "TABLE1", "run_simulation", "run_many",
           "training_draws"]
