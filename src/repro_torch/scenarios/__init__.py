"""Scenario dynamics (NumPy copies of the JAX package's `scenarios`):
seed-deterministic whole-horizon environment traces — fading, mobility,
churn/stragglers, energy harvesting — and `apply_dynamics`, which folds
churn into a solved whole-horizon `RAResult`."""
from .processes import (ChurnProcess, EnergyProcess, FadingProcess,
                        MobilityProcess, compose_gains, sample_churn,
                        sample_coupled_fading, sample_distances, sample_energy,
                        sample_fading)
from .scenario import (PRESETS, Scenario, ScenarioTraces, apply_dynamics,
                       generate_traces, get_scenario, register_scenario,
                       scenario_name)

__all__ = [
    "FadingProcess", "MobilityProcess", "ChurnProcess", "EnergyProcess",
    "sample_fading", "sample_coupled_fading", "sample_distances",
    "sample_churn", "sample_energy", "compose_gains", "Scenario",
    "ScenarioTraces", "PRESETS", "get_scenario", "register_scenario",
    "scenario_name", "generate_traces", "apply_dynamics",
]
