"""Stream-extension of the scenario layer: an OPEN-ENDED environment.

`generate_traces` / `fl.sim._prepare` draw whole-horizon blocks, so the
rng stream layout depends on the horizon length — two horizons of the
same world are different random worlds, which is exactly what a
long-running service cannot have.  `ScenarioStream` regenerates the same
four processes as per-round *incremental* recursions with explicitly
carried state (the AR(1) complex gain, walker positions/waypoints, the
Markov availability vector), each process on its own `SeedSequence`
child, so that for any split points

    next_segment(a) ++ next_segment(b)  ==  next_segment(a + b)

of a fresh stream with the same seed — segment boundaries are invisible,
and segment s really is rounds [t, t+s) of ONE infinite trace
(DESIGN.md §14).  The per-round recursions are the exact per-t update
rules of `scenarios.processes` (AR(1) step, waypoint walk, Markov
transition, shifted-exponential harvest), so marginals and dynamics
match the fixed-horizon generators law-for-law; the draws themselves
differ because the stream deliberately abandons the horizon-shaped
block layout.  A NumPy copy of the JAX package's `scenarios/stream.py`:
tests/test_torch_service.py holds its segments bitwise equal to the JAX
package's and to one another under any segmentation.
"""
from __future__ import annotations

import numpy as np

from ..core.wireless import WirelessConfig, sample_topology
from .processes import compose_gains
from .scenario import Scenario, ScenarioTraces, get_scenario

__all__ = ["ScenarioStream"]


class ScenarioStream:
    """One seed-deterministic infinite environment, served in segments.

    Four independent child generators (mobility, fading, churn, energy —
    spawned from one `SeedSequence`) make each process's stream position
    a pure function of how many rounds have been served, never of how
    the caller chunked them.
    """

    def __init__(self, seed: int | np.random.SeedSequence,
                 cfg: WirelessConfig, scenario: str | Scenario):
        self.cfg = cfg
        self.scenario = get_scenario(scenario)
        ss = (seed if isinstance(seed, np.random.SeedSequence)
              else np.random.SeedSequence(seed))
        self._rng_mob, self._rng_fad, self._rng_chu, self._rng_ene = (
            np.random.default_rng(child) for child in ss.spawn(4))
        self._t = 0
        # Carried process state (None = not yet initialized; every
        # process initializes on its round-0 step, so a fresh stream
        # consumes nothing until the first segment is requested).
        self._static_d: np.ndarray | None = None   # static mobility
        self._pos: np.ndarray | None = None        # waypoint walker
        self._wp: np.ndarray | None = None
        self._g: np.ndarray | None = None          # AR(1) complex gain
        self._avail: np.ndarray | None = None      # Markov chain state

    @property
    def t(self) -> int:
        """Absolute round index of the next segment's first round."""
        return self._t

    # ---- per-round process steps (the eq.-for-eq. recursions of
    # scenarios.processes, with the loop-carried state made explicit) ----

    def _step_mobility(self) -> np.ndarray:
        cfg, proc = self.cfg, self.scenario.mobility
        n = cfg.n_devices
        if proc.kind == "static":
            if self._static_d is None:
                self._static_d = sample_topology(self._rng_mob,
                                                 cfg).distances_m
            return self._static_d
        rng = self._rng_mob

        def disc_points(radius, theta):
            return np.stack([radius * np.cos(theta),
                             radius * np.sin(theta)], -1)

        if self._pos is None:
            r0 = cfg.radius_m * np.sqrt(rng.uniform(size=n))
            self._pos = disc_points(r0, rng.uniform(0.0, 2.0 * np.pi, size=n))
            self._wp = disc_points(
                cfg.radius_m * np.sqrt(rng.uniform(size=n)),
                rng.uniform(0.0, 2.0 * np.pi, size=n))
        d = np.maximum(np.linalg.norm(self._pos, axis=-1), cfg.min_dist_m)
        step = proc.speed_mps * proc.round_s
        vec = self._wp - self._pos
        dist = np.linalg.norm(vec, axis=-1)
        arrived = dist <= step
        cand = disc_points(cfg.radius_m * np.sqrt(rng.uniform(size=n)),
                           rng.uniform(0.0, 2.0 * np.pi, size=n))
        self._pos = np.where(arrived[:, None], self._wp,
                             self._pos + vec *
                             (step / np.maximum(dist, 1e-30))[:, None])
        self._wp = np.where(arrived[:, None], cand, self._wp)
        return d

    def _step_fading(self) -> np.ndarray:
        cfg, proc = self.cfg, self.scenario.fading
        k, n = cfg.n_subchannels, cfg.n_devices
        rng = self._rng_fad
        if proc.kind == "iid":
            return rng.exponential(size=(k, n))

        def cn():
            return (rng.standard_normal((k, n))
                    + 1j * rng.standard_normal((k, n))) / np.sqrt(2.0)

        if self._g is None:
            self._g = cn()
        else:
            rho = proc.rho
            self._g = rho * self._g + np.sqrt(1.0 - rho * rho) * cn()
        return np.abs(self._g) ** 2

    def _step_churn(self) -> tuple[np.ndarray, np.ndarray]:
        proc = self.scenario.churn
        n = self.cfg.n_devices
        if proc.kind == "none":
            return np.ones(n, dtype=bool), np.ones(n, dtype=np.float64)
        rng = self._rng_chu
        if self._avail is None:
            self._avail = np.ones(n, dtype=bool)
        else:
            u = rng.uniform(size=n)
            self._avail = np.where(self._avail, u >= proc.p_drop,
                                   u < proc.p_join)
        hit = rng.uniform(size=n) < proc.straggler_prob
        mult = 1.0 + rng.uniform(size=n) * (proc.slowdown_max - 1.0)
        slowdown = np.where(hit & self._avail, mult, 1.0)
        return self._avail.copy(), slowdown

    def _step_energy(self) -> np.ndarray:
        cfg, proc = self.cfg, self.scenario.energy
        n = cfg.n_devices
        if proc.kind == "static":
            return np.full(n, cfg.e_max_j, dtype=np.float64)
        scale = (proc.mean_frac - proc.floor_frac) * cfg.e_max_j
        floor = proc.floor_frac * cfg.e_max_j
        return floor + self._rng_ene.exponential(scale=scale, size=n)

    # ---- segment service ------------------------------------------------

    def next_segment(self, rounds: int) -> ScenarioTraces:
        """The next `rounds` rounds of the stream, as `ScenarioTraces`."""
        if rounds < 1:
            raise ValueError(f"segment needs >= 1 round, got {rounds}")
        k, n = self.cfg.n_subchannels, self.cfg.n_devices
        d_all = np.empty((rounds, n))
        g2_all = np.empty((rounds, k, n))
        avail = np.empty((rounds, n), dtype=bool)
        slowdown = np.empty((rounds, n))
        e_max = np.empty((rounds, n))
        for i in range(rounds):
            d_all[i] = self._step_mobility()
            g2_all[i] = self._step_fading()
            avail[i], slowdown[i] = self._step_churn()
            e_max[i] = self._step_energy()
            self._t += 1
        return ScenarioTraces(
            scenario=self.scenario,
            h2_all=compose_gains(g2_all, d_all, self.cfg),
            distances_m=d_all, avail=avail, slowdown=slowdown,
            e_max_j=e_max)
