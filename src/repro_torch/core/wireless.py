"""Wireless system model for FLOWN (paper Sec. II, eqs. 1-10).

Implements the computation model (DVFS CPU time/energy), the communication
model (Shannon rate over sub-channels with Rayleigh small-scale fading and
power-law path loss), and per-round channel realizations.

This is the *control plane* of the framework: it runs on the server between
training rounds (the paper notes server compute is free, Sec. III-3).  All
model functions are *backend-agnostic*: they dispatch to numpy or torch
based on their array arguments, so the same closed forms back the host-side
reference solver (`core.monotonic`), the plain torch solvers
(`core.monotonic_torch`, `kernels.polyblock_*`) and — spelled once more in
CUDA C++ — the kernels in `csrc/polyblock.cu`.
Vectorized over (K sub-channels x N devices) — or (rounds x K x N) for the
whole-horizon batched path — a full round's model evaluates in microseconds.
"""
from __future__ import annotations

import dataclasses
import numpy as np

import torch

__all__ = [
    "WirelessConfig",
    "Topology",
    "sample_topology",
    "sample_channel_gains",
    "compute_time",
    "compute_energy",
    "comm_rate",
    "comm_time",
    "comm_energy",
    "total_time",
    "total_energy",
]


@dataclasses.dataclass(frozen=True)
class WirelessConfig:
    """Table I of the paper (defaults reproduce the MNIST setting)."""

    n_devices: int = 20              # N
    n_subchannels: int = 4           # K
    bandwidth_hz: float = 1e6        # B, per sub-channel
    pt_dbm: float = 10.0             # maximum transmit power P_t per sub-channel
    noise_dbm_per_hz: float = -174.0  # AWGN PSD sigma^2 (per Hz)
    carrier_hz: float = 1e9          # f, for the frequency-dependent factor eta
    pathloss_exp: float = 3.76       # a
    radius_m: float = 500.0          # disc radius R
    kappa0: float = 1e-28            # CPU power coefficient per cycle
    mu_cycles: float = 1e7           # CPU cycles per training sample
    cpu_hz: float = 1e9              # C_n (homogeneous default; can be per-device)
    model_bits: float = 1e6          # D(w) uplink payload in bits
    e_max_j: float = 0.02            # per-round energy budget E_n^max
    min_dist_m: float = 1.0          # physical path-loss floor (d >= this)

    def __post_init__(self):
        if not self.min_dist_m > 0.0:
            raise ValueError(
                f"min_dist_m must be > 0 (the eq.-3 path loss d^-a diverges "
                f"at d=0), got {self.min_dist_m}")

    @property
    def pt_w(self) -> float:
        return 10.0 ** (self.pt_dbm / 10.0) * 1e-3

    @property
    def noise_w(self) -> float:
        # PSD (dBm/Hz) integrated over the sub-channel bandwidth.
        return 10.0 ** (self.noise_dbm_per_hz / 10.0) * 1e-3 * self.bandwidth_hz

    @property
    def eta(self) -> float:
        """Frequency-dependent factor: free-space reference gain (c/4/pi/f)^2."""
        c = 3e8
        return (c / (4.0 * np.pi * self.carrier_hz)) ** 2


@dataclasses.dataclass(frozen=True)
class Topology:
    """Static device placement: distances to the server (paper: uniform disc)."""

    distances_m: np.ndarray  # (N,)

    @property
    def n_devices(self) -> int:
        return int(self.distances_m.shape[0])


def sample_topology(rng: np.random.Generator, cfg: WirelessConfig) -> Topology:
    """Devices uniform on a disc of radius R centred at the server."""
    # Uniform area density => r = R * sqrt(u).
    r = cfg.radius_m * np.sqrt(rng.uniform(size=cfg.n_devices))
    # Keep a minimum distance so the path loss stays physical.
    return Topology(distances_m=np.maximum(r, cfg.min_dist_m))


def sample_channel_gains(
    rng: np.random.Generator, cfg: WirelessConfig, topo: Topology
) -> np.ndarray:
    """Normalized channel gains |h_{k,n}|^2 of eq. (3), shape (K, N).

    |h|^2 = P_t * |g|^2 * eta * d^-a / sigma^2  with g ~ CN(0,1) i.i.d. per
    (sub-channel, device, round) -- Rayleigh => |g|^2 ~ Exp(1).
    """
    g2 = rng.exponential(size=(cfg.n_subchannels, topo.n_devices))
    path = cfg.eta * topo.distances_m[None, :] ** (-cfg.pathloss_exp)
    return cfg.pt_w * g2 * path / cfg.noise_w


# --------------------------------------------------------------------------
# Backend dispatch: numpy by default, torch when any argument is a torch
# tensor (on any device).  numpy inputs are promoted to float64; torch
# inputs keep their dtype and device, and Python scalars stay scalars so
# they take the tensor's dtype (a float32 tensor computes in float32, as
# the kernels do).
# --------------------------------------------------------------------------

class _TorchOps:
    """The handful of array functions the closed forms below use, spelled
    for torch (`maximum` against a Python scalar is a clamp)."""

    @staticmethod
    def maximum(x, floor):
        return torch.clamp_min(x, floor)

    log1p = staticmethod(torch.log1p)

    @staticmethod
    def divide(a, b):
        # torch spells `scalar / tensor` as reciprocal-then-multiply (two
        # roundings); a true division keeps the closed forms bit-comparable
        # with the numpy branch.
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(a, dtype=b.dtype, device=b.device)
        return torch.div(a, b)


_torch_ops = _TorchOps()


def _xp(*args):
    if any(isinstance(a, torch.Tensor) for a in args):
        return _torch_ops
    return np


def _asfloat(xp, x):
    if xp is np:
        return np.asarray(x, dtype=np.float64)
    return x if isinstance(x, (torch.Tensor, float, int)) else torch.as_tensor(x)


# --------------------------------------------------------------------------
# Computation model, eqs. (1)-(2).
# --------------------------------------------------------------------------

def compute_time(tau, beta, cfg: WirelessConfig):
    """T^cp = mu * beta / (tau * C)  (eq. 1)."""
    xp = _xp(tau, beta)
    tau = _asfloat(xp, tau)
    return xp.divide(cfg.mu_cycles * _asfloat(xp, beta),
                     xp.maximum(tau, 1e-30)) / cfg.cpu_hz


def compute_energy(tau, beta, cfg: WirelessConfig):
    """E^cp = kappa0 * mu * beta * (tau*C)^2  (eq. 2)."""
    xp = _xp(tau, beta)
    tau = _asfloat(xp, tau)
    tc = tau * cfg.cpu_hz
    return cfg.kappa0 * cfg.mu_cycles * _asfloat(xp, beta) * (tc * tc)


# --------------------------------------------------------------------------
# Communication model, eqs. (3)-(5).
# --------------------------------------------------------------------------

def comm_rate(p, h2, cfg: WirelessConfig):
    """R = B log2(1 + p |h|^2)  (eq. 3), bits/s.  log1p for precision at
    vanishing SNR (the Prop-1 infimum regime)."""
    xp = _xp(p, h2)
    p = _asfloat(xp, p)
    return cfg.bandwidth_hz * xp.log1p(p * _asfloat(xp, h2)) / np.log(2.0)


def comm_time(p, h2, cfg: WirelessConfig):
    """T^cm = D(w) / R  (eq. 4)."""
    r = comm_rate(p, h2, cfg)
    xp = _xp(p, h2)
    return xp.divide(cfg.model_bits, xp.maximum(r, 1e-30))


def comm_energy(p, h2, cfg: WirelessConfig):
    """E^cm = p * P_t * T^cm  (eq. 5).

    Note the paper's convention: p in [0,1] is the *fraction* of P_t used;
    |h|^2 is already normalized by P_t / sigma^2.
    """
    p = _asfloat(_xp(p, h2), p)
    return p * cfg.pt_w * comm_time(p, h2, cfg)


# --------------------------------------------------------------------------
# Totals, eqs. (8) and (10).
# --------------------------------------------------------------------------

def total_time(tau, p, beta, h2, cfg: WirelessConfig):
    """Per-round device time T = T^cp + T^cm (eq. 8): local compute at CPU
    share tau plus uplink at power fraction p over channel gain h2."""
    return compute_time(tau, beta, cfg) + comm_time(p, h2, cfg)


def total_energy(tau, p, beta, h2, cfg: WirelessConfig):
    """Per-round device energy E = E^cp + E^cm (eq. 10), the Prop.-1 /
    Alg.-1 budget constraint left-hand side (E <= E^max)."""
    return compute_energy(tau, beta, cfg) + comm_energy(p, h2, cfg)
