"""Environment processes: seed-deterministic whole-horizon trace generators.

Each process is a pure ``(rng, cfg, horizon) -> trace`` generator — a
``np.random.Generator`` plays the role of the key, so a seeded generator
always reproduces the same trace — and each has a *degenerate kind* that
consumes the rng stream exactly as the pre-scenario simulator did (or not
at all), which is what makes the ``static`` preset bit-exact
(DESIGN.md §11):

  fading    ``iid``     draws ``rng.exponential((K, N))`` per round — the
                        identical Rayleigh stream `core.wireless
                        .sample_channel_gains` consumed inline;
            ``ar1``     Gauss-Markov AR(1) on COMPLEX gains
                        g_t = rho g_{t-1} + sqrt(1-rho^2) w_t with
                        g_0, w_t ~ CN(0, 1): the marginal |g|^2 stays
                        Exp(1) (Rayleigh power) at every lag while the
                        power autocorrelation decays as rho^(2*lag);
                        rho=0 recovers the i.i.d. law (different draws,
                        same distribution).
  mobility  ``static``  one `sample_topology` draw broadcast over rounds;
            ``waypoint`` random-waypoint drift inside the disc: each
                        device walks at `speed_mps` toward a uniform
                        waypoint, re-drawing on arrival.  Distances are
                        clamped to `WirelessConfig.min_dist_m`, so a
                        trace can never tunnel below the eq.-3 path-loss
                        floor.
  churn     ``none``    everyone available at nominal speed, NO rng use;
            ``markov``  per-device 2-state availability chain
                        (P[up->down] = p_drop, P[down->up] = p_join, all
                        up at t=0) plus i.i.d. straggler slowdowns
                        (prob `straggler_prob` of a Uniform(1,
                        `slowdown_max`] compute-time multiplier).
  energy    ``static``  the constant Table-I budget, NO rng use;
            ``harvest`` use-it-or-lose-it harvesting: the round-t budget
                        is E^max * (floor_frac + Exp(mean_frac -
                        floor_frac)) — mean E^max * mean_frac — i.e. the
                        energy harvested since the previous round.  No
                        battery carry-over: that would couple the budget
                        to the selection history and break the
                        whole-horizon Γ precompute (Γ must stay
                        selection-independent, DESIGN.md §6).

All traces are host-side float64/bool numpy arrays; `fl.sim` converts them
to device tensors exactly where it converted the inline-sampled equivalents.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.wireless import WirelessConfig, sample_topology

__all__ = [
    "FadingProcess",
    "MobilityProcess",
    "ChurnProcess",
    "EnergyProcess",
    "sample_fading",
    "sample_coupled_fading",
    "sample_distances",
    "sample_churn",
    "sample_energy",
    "compose_gains",
]


@dataclasses.dataclass(frozen=True)
class FadingProcess:
    """Small-scale fading law for the |g|^2 factor of eq. (3)."""

    kind: str = "iid"     # "iid" | "ar1"
    rho: float = 0.0      # AR(1) coefficient on the complex gain per round

    def __post_init__(self):
        if self.kind not in ("iid", "ar1"):
            raise ValueError(f"unknown fading kind: {self.kind!r}")
        if not 0.0 <= self.rho < 1.0:
            raise ValueError(f"fading rho must be in [0, 1), got {self.rho}")


@dataclasses.dataclass(frozen=True)
class MobilityProcess:
    """Device-position process behind the eq.-3 path-loss distances."""

    kind: str = "static"  # "static" | "waypoint"
    speed_mps: float = 0.0
    round_s: float = 1.0  # wall-clock seconds represented by one round

    def __post_init__(self):
        if self.kind not in ("static", "waypoint"):
            raise ValueError(f"unknown mobility kind: {self.kind!r}")
        if self.speed_mps < 0.0 or self.round_s <= 0.0:
            raise ValueError("mobility needs speed_mps >= 0 and round_s > 0")


@dataclasses.dataclass(frozen=True)
class ChurnProcess:
    """Availability + compute-speed process (device churn and stragglers)."""

    kind: str = "none"          # "none" | "markov"
    p_drop: float = 0.0         # P(available -> unavailable) per round
    p_join: float = 1.0         # P(unavailable -> available) per round
    straggler_prob: float = 0.0  # P(a device straggles in a given round)
    slowdown_max: float = 1.0   # straggler compute-time multiplier cap (>= 1)

    def __post_init__(self):
        if self.kind not in ("none", "markov"):
            raise ValueError(f"unknown churn kind: {self.kind!r}")
        for name in ("p_drop", "p_join", "straggler_prob"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"churn {name} must be in [0, 1], got {v}")
        if self.slowdown_max < 1.0:
            raise ValueError(
                f"slowdown_max must be >= 1 (stragglers only slow down; a "
                f"speed-up could overdraw the solved energy budget), got "
                f"{self.slowdown_max}")


@dataclasses.dataclass(frozen=True)
class EnergyProcess:
    """Per-round energy-budget process generalizing the static E^max."""

    kind: str = "static"    # "static" | "harvest"
    mean_frac: float = 1.0  # mean budget as a fraction of cfg.e_max_j
    floor_frac: float = 0.1  # guaranteed floor as a fraction of cfg.e_max_j

    def __post_init__(self):
        if self.kind not in ("static", "harvest"):
            raise ValueError(f"unknown energy kind: {self.kind!r}")
        if not 0.0 <= self.floor_frac < self.mean_frac:
            raise ValueError(
                f"energy needs 0 <= floor_frac < mean_frac, got "
                f"floor={self.floor_frac}, mean={self.mean_frac}")


# ---------------------------------------------------------------------------
# generators: (rng, cfg, horizon) -> trace
# ---------------------------------------------------------------------------

def sample_fading(rng: np.random.Generator, cfg: WirelessConfig,
                  proc: FadingProcess, rounds: int) -> np.ndarray:
    """Small-scale power gains |g_{k,n}|^2, shape (rounds, K, N), mean 1.

    ``iid`` reproduces the legacy per-round Exp(1) draws verbatim (one
    ``rng.exponential((K, N))`` call per round, in round order — the exact
    stream the inline sampler consumed); ``ar1`` runs a complex
    Gauss-Markov recursion whose |g|^2 marginal is Exp(1) at every lag.
    """
    k, n = cfg.n_subchannels, cfg.n_devices
    if proc.kind == "iid":
        return np.stack([rng.exponential(size=(k, n)) for _ in range(rounds)])
    # AR(1): g_t = rho g_{t-1} + sqrt(1-rho^2) w_t, g_0 / w_t ~ CN(0, 1).
    def cn(size):
        return (rng.standard_normal(size) + 1j * rng.standard_normal(size)) \
            / np.sqrt(2.0)

    rho = proc.rho
    g = np.empty((rounds, k, n), dtype=np.complex128)
    g[0] = cn((k, n))
    scale = np.sqrt(1.0 - rho * rho)
    for t in range(1, rounds):
        g[t] = rho * g[t - 1] + scale * cn((k, n))
    return np.abs(g) ** 2


def sample_coupled_fading(rng: np.random.Generator, cfg: WirelessConfig,
                          proc: FadingProcess, rounds: int, n_cells: int,
                          coupling: float) -> np.ndarray:
    """Cross-cell coupled small-scale fading, shape (C, rounds, K, N).

    Models inter-cell interference correlation: every cell's complex gain
    is the mixture ``sqrt(c) * g_shared + sqrt(1 - c) * g_local`` of one
    field shared by ALL cells and a per-cell independent field, each
    CN(0, 1) under the cell's `FadingProcess` (iid or AR(1)).  Because the
    mixing coefficients satisfy c + (1 - c) = 1 and the two fields are
    independent, the per-cell marginal stays CN(0, 1) — so |g|^2 keeps the
    Exp(1) Rayleigh-power law (and, under ``ar1``, the rho^(2*lag) power
    autocorrelation) at EVERY coupling, while the cross-cell power
    correlation grows with `coupling` (tests/test_torch_hier.py holds
    the draws bit-identical to the JAX package's).

    ``coupling == 0`` must not change the world stream of uncoupled
    preparation: it delegates to per-cell `sample_fading` calls in cell
    order, bit-identical to the uncoupled path (and to the flat
    single-cell stream when C == 1).
    """
    if not 0.0 <= coupling <= 1.0:
        raise ValueError(f"cell coupling must be in [0, 1], got {coupling}")
    if coupling == 0.0:
        return np.stack([sample_fading(rng, cfg, proc, rounds)
                         for _ in range(n_cells)])
    k, n = cfg.n_subchannels, cfg.n_devices

    def cn(size):
        return (rng.standard_normal(size) + 1j * rng.standard_normal(size)) \
            / np.sqrt(2.0)

    a, b = np.sqrt(coupling), np.sqrt(1.0 - coupling)
    if proc.kind == "iid":
        shared = cn((rounds, k, n))
        local = cn((n_cells, rounds, k, n))
        return np.abs(a * shared[None] + b * local) ** 2
    # AR(1): run the shared and local recursions side by side — a fixed
    # mixture of two independent AR(1) CN(0, 1) processes with the same
    # rho is itself AR(1) CN(0, 1) with that rho.
    rho = proc.rho
    scale = np.sqrt(1.0 - rho * rho)
    g = np.empty((n_cells, rounds, k, n), dtype=np.complex128)
    gs = cn((k, n))
    gl = cn((n_cells, k, n))
    g[:, 0] = a * gs[None] + b * gl
    for t in range(1, rounds):
        gs = rho * gs + scale * cn((k, n))
        gl = rho * gl + scale * cn((n_cells, k, n))
        g[:, t] = a * gs[None] + b * gl
    return np.abs(g) ** 2


def sample_distances(rng: np.random.Generator, cfg: WirelessConfig,
                     proc: MobilityProcess, rounds: int) -> np.ndarray:
    """Device-to-server distances, shape (rounds, N), clamped to min_dist_m.

    ``static`` consumes exactly one `sample_topology`-style uniform draw
    (bit-compatible with the legacy inline call) and broadcasts it;
    ``waypoint`` additionally draws angles and per-round waypoint
    candidates and walks each device `speed_mps * round_s` per round.
    """
    n = cfg.n_devices
    if proc.kind == "static":
        # Bit-exactness-critical: the legacy sampler IS the source of truth.
        d = sample_topology(rng, cfg).distances_m
        return np.broadcast_to(d, (rounds, n)).copy()
    # Initial radii: same uniform-area-density draw, at the same stream
    # position, but kept raw — walkers need positions, not clamped ranges.
    r0 = cfg.radius_m * np.sqrt(rng.uniform(size=n))

    def disc_points(radius, theta):
        return np.stack([radius * np.cos(theta), radius * np.sin(theta)], -1)

    pos = disc_points(r0, rng.uniform(0.0, 2.0 * np.pi, size=n))
    wp = disc_points(cfg.radius_m * np.sqrt(rng.uniform(size=n)),
                     rng.uniform(0.0, 2.0 * np.pi, size=n))
    step = proc.speed_mps * proc.round_s
    d_all = np.empty((rounds, n))
    for t in range(rounds):
        d_all[t] = np.maximum(np.linalg.norm(pos, axis=-1), cfg.min_dist_m)
        vec = wp - pos
        dist = np.linalg.norm(vec, axis=-1)
        arrived = dist <= step
        # Fixed-size draws every round keep the stream shape data-independent.
        cand = disc_points(cfg.radius_m * np.sqrt(rng.uniform(size=n)),
                           rng.uniform(0.0, 2.0 * np.pi, size=n))
        pos = np.where(arrived[:, None], wp,
                       pos + vec * (step / np.maximum(dist, 1e-30))[:, None])
        wp = np.where(arrived[:, None], cand, wp)
    return d_all


def sample_churn(rng: np.random.Generator, proc: ChurnProcess, rounds: int,
                 n: int) -> tuple[np.ndarray, np.ndarray]:
    """Availability mask (rounds, N) bool + compute slowdowns (rounds, N).

    ``none`` consumes NO randomness (the static preset must leave the
    world stream untouched).  ``markov`` runs the 2-state chain from
    all-available and overlays i.i.d. straggler multipliers in [1,
    slowdown_max]; an unavailable device's slowdown is forced to 1 (it
    does not run at all — availability, not speed, removes it).
    """
    if proc.kind == "none":
        return (np.ones((rounds, n), dtype=bool),
                np.ones((rounds, n), dtype=np.float64))
    avail = np.empty((rounds, n), dtype=bool)
    avail[0] = True
    for t in range(1, rounds):
        u = rng.uniform(size=n)
        avail[t] = np.where(avail[t - 1], u >= proc.p_drop, u < proc.p_join)
    hit = rng.uniform(size=(rounds, n)) < proc.straggler_prob
    mult = 1.0 + rng.uniform(size=(rounds, n)) * (proc.slowdown_max - 1.0)
    slowdown = np.where(hit & avail, mult, 1.0)
    return avail, slowdown


def sample_energy(rng: np.random.Generator, cfg: WirelessConfig,
                  proc: EnergyProcess, rounds: int) -> np.ndarray:
    """Per-round per-device energy budgets E^max_{t,n}, shape (rounds, N).

    ``static`` consumes NO randomness and returns the constant
    `cfg.e_max_j`; ``harvest`` draws shifted-exponential arrivals with
    mean ``mean_frac * e_max_j`` and floor ``floor_frac * e_max_j``.
    """
    n = cfg.n_devices
    if proc.kind == "static":
        return np.full((rounds, n), cfg.e_max_j, dtype=np.float64)
    scale = (proc.mean_frac - proc.floor_frac) * cfg.e_max_j
    floor = proc.floor_frac * cfg.e_max_j
    return floor + rng.exponential(scale=scale, size=(rounds, n))


def compose_gains(g2_all: np.ndarray, d_all: np.ndarray,
                  cfg: WirelessConfig) -> np.ndarray:
    """Eq. (3): |h|^2 = P_t |g|^2 eta d^-a / sigma^2, shape (rounds, K, N).

    The expression mirrors `core.wireless.sample_channel_gains`
    operation-for-operation (path factor first, then P_t * g2 * path /
    noise), so a static scenario's h2 horizon is bit-identical to the
    legacy per-round inline computation.
    """
    path = cfg.eta * d_all[:, None, :] ** (-cfg.pathloss_exp)
    return cfg.pt_w * g2_all * path / cfg.noise_w
