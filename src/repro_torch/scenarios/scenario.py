"""Composable wireless-FL scenarios: named bundles of environment processes.

A `Scenario` is four orthogonal processes (fading x mobility x churn x
energy) plus a name; `generate_traces` materializes the whole-horizon
environment as plain numpy arrays and `apply_dynamics` folds the
availability / straggler components into a solved whole-horizon
`RAResult` so BOTH round-loop engines (host loop and fused `lax.scan`)
consume the identical modified Γ and stay differentially equivalent
under every scenario (DESIGN.md §11).

The ``static`` preset is the identity: its processes replay the exact
rng stream the pre-scenario simulator drew inline (fading ``iid`` +
mobility ``static``) and consume nothing else, so static trajectories
are bit-identical to the legacy behavior on both engines — pinned by
tests/test_scenarios.py.

Presets (see `PRESETS`; `register_scenario` adds project-local ones):

  static        today's world: i.i.d. Rayleigh, fixed topology, no churn,
                constant budget;
  corr_fading   temporally correlated fading (AR(1), rho = 0.9 — ~0.81
                power autocorrelation at lag 1);
  mobility      random-waypoint drift at pedestrian 1.5 m/s, 10 s rounds;
  churn         Markov availability (5% drop / 50% rejoin) + 20%-straggler
                rounds up to 4x compute time;
  harvest       energy-harvesting budgets, mean = Table-I E^max with a
                10% floor;
  urban         the stress composite: corr_fading + mobility + churn.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.monotonic import RAResult
from ..core.wireless import WirelessConfig, compute_energy, compute_time
from .processes import (
    ChurnProcess,
    EnergyProcess,
    FadingProcess,
    MobilityProcess,
    compose_gains,
    sample_churn,
    sample_distances,
    sample_energy,
    sample_fading,
)

__all__ = [
    "Scenario",
    "ScenarioTraces",
    "PRESETS",
    "get_scenario",
    "register_scenario",
    "scenario_name",
    "generate_traces",
    "apply_dynamics",
]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named environment: fading x mobility x churn x energy."""

    name: str = "static"
    fading: FadingProcess = FadingProcess()
    mobility: MobilityProcess = MobilityProcess()
    churn: ChurnProcess = ChurnProcess()
    energy: EnergyProcess = EnergyProcess()


@dataclasses.dataclass
class ScenarioTraces:
    """The materialized whole-horizon environment of one world."""

    scenario: Scenario
    h2_all: np.ndarray       # (rounds, K, N) eq.-3 normalized channel gains
    distances_m: np.ndarray  # (rounds, N) device-to-server distances
    avail: np.ndarray        # (rounds, N) bool availability mask
    slowdown: np.ndarray     # (rounds, N) compute-time multipliers, >= 1
    e_max_j: np.ndarray      # (rounds, N) per-round energy budgets


PRESETS: dict[str, Scenario] = {
    s.name: s for s in (
        Scenario("static"),
        Scenario("corr_fading", fading=FadingProcess("ar1", rho=0.9)),
        Scenario("mobility",
                 mobility=MobilityProcess("waypoint", speed_mps=1.5,
                                          round_s=10.0)),
        Scenario("churn",
                 churn=ChurnProcess("markov", p_drop=0.05, p_join=0.5,
                                    straggler_prob=0.2, slowdown_max=4.0)),
        Scenario("harvest",
                 energy=EnergyProcess("harvest", mean_frac=1.0,
                                      floor_frac=0.1)),
        Scenario("urban",
                 fading=FadingProcess("ar1", rho=0.9),
                 mobility=MobilityProcess("waypoint", speed_mps=1.5,
                                          round_s=10.0),
                 churn=ChurnProcess("markov", p_drop=0.05, p_join=0.5,
                                    straggler_prob=0.2, slowdown_max=4.0)),
    )
}


def get_scenario(scenario: str | Scenario) -> Scenario:
    """Resolve a preset name or pass a `Scenario` through unchanged."""
    if isinstance(scenario, Scenario):
        return scenario
    try:
        return PRESETS[scenario]
    except KeyError:
        raise ValueError(
            f"unknown scenario preset: {scenario!r} "
            f"(known: {sorted(PRESETS)})") from None


def register_scenario(scenario: Scenario, *, overwrite: bool = False) -> Scenario:
    """Add a named scenario to the preset registry (sweepable by name)."""
    if scenario.name in PRESETS and not overwrite:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    PRESETS[scenario.name] = scenario
    return scenario


def scenario_name(scenario: str | Scenario) -> str:
    return scenario if isinstance(scenario, str) else scenario.name


def generate_traces(rng: np.random.Generator | int, cfg: WirelessConfig,
                    scenario: str | Scenario, rounds: int) -> ScenarioTraces:
    """Materialize one world's whole-horizon environment.

    Canonical process order: mobility (distances) -> fading -> churn ->
    energy.  NOTE `fl.sim._prepare` interleaves its legacy cluster /
    fixed-id / permutation draws between the mobility and fading calls to
    keep the static preset's stream bit-exact; this standalone entry point
    (tests, benchmarks, notebooks) uses the canonical order, so its traces
    match `_prepare`'s statistically, not bitwise.
    """
    scn = get_scenario(scenario)
    if not isinstance(rng, np.random.Generator):
        rng = np.random.default_rng(rng)
    d_all = sample_distances(rng, cfg, scn.mobility, rounds)
    g2_all = sample_fading(rng, cfg, scn.fading, rounds)
    avail, slowdown = sample_churn(rng, scn.churn, rounds, cfg.n_devices)
    e_max = sample_energy(rng, cfg, scn.energy, rounds)
    return ScenarioTraces(scenario=scn, h2_all=compose_gains(g2_all, d_all, cfg),
                          distances_m=d_all, avail=avail, slowdown=slowdown,
                          e_max_j=e_max)


def apply_dynamics(ra: RAResult, avail: np.ndarray, slowdown: np.ndarray,
                   beta: np.ndarray, cfg: WirelessConfig) -> RAResult:
    """Fold churn into a solved whole-horizon `RAResult` (fields (T, K, N)).

    Unavailable devices lose Proposition-1 feasibility for the round
    (time -> inf, energy masked), so neither selection, matching, nor the
    learning plane can touch them — on either engine, since both consume
    this same tensor.  Straggler slowdowns scale the COMPUTE share of the
    solved round time: the plan's (tau*, p*) stay fixed (Algorithm 1
    plans against nominal DVFS), the realized clock is C/s, so

        T' = T + (s - 1) * T^cp(tau*)          (eq. 1 at the slowed clock)
        E' = E + (1/s^2 - 1) * E^cp(tau*)      (eq. 2: DVFS energy falls
                                                quadratically with clock)

    With s >= 1 (validated by `ChurnProcess`) the energy budget can only
    gain slack, so the Prop-1 feasibility mask remains valid.  A
    churn-free scenario returns `ra` unchanged (the static preset's
    bit-exactness does not survive a float round-trip, so the identity is
    literal, not numeric).
    """
    if bool(avail.all()) and not bool((slowdown != 1.0).any()):
        return ra
    avail_b = np.broadcast_to(avail[:, None, :], ra.time_s.shape)
    slow_b = np.broadcast_to(slowdown[:, None, :], ra.time_s.shape)
    beta_b = np.broadcast_to(np.asarray(beta, np.float64)[None, None, :],
                             ra.time_s.shape)
    feas = ra.feasible & avail_b
    # Evaluate the eq.-1/2 compute shares only where the plan exists
    # (tau is NaN at infeasible pairs and would poison the arithmetic).
    tau = np.where(feas, ra.tau, 0.5)
    t_cp = compute_time(tau, beta_b, cfg)
    e_cp = compute_energy(tau, beta_b, cfg)
    time_s = np.where(feas, ra.time_s + (slow_b - 1.0) * t_cp, np.inf)
    energy = np.where(feas, ra.energy_j + (1.0 / slow_b**2 - 1.0) * e_cp,
                      np.nan)
    return RAResult(tau=np.where(feas, ra.tau, np.nan),
                    p=np.where(feas, ra.p, np.nan),
                    time_s=time_s, energy_j=energy, feasible=feas,
                    iterations=ra.iterations)
