"""Server-side aggregation: the selection-masked weighted FedAvg of eq. (34),
plus the staleness-weighted buffered commit of the async engine.

    w^{t+1} = sum_n S_n (sum_k psi_kn) beta_n w_n / sum_n S_n (sum_k psi_kn) beta_n

The weighted mean runs on kernel K3 (`kernels.fedavg_agg`) for CUDA
tensors, once per parameter leaf.  If no device transmits in a round
(all-infeasible corner of Prop. 1), the global model is unchanged (weights
sum to 0 -> guarded).

Asynchronous surface (`engine="async"`): an `AsyncAggregation` spec names
the buffered server's commit policy — how many in-flight uploads the server
waits for per event (`buffer`), the staleness decay f(age) applied to each
committed update's weight (`staleness_weight`), and the server step size.
`aggregate_buffered` performs one commit:

    w <- (1-m) w + m * WeightedMean(committed; beta_n * f(s_n)),
    m = server_lr (1.0 by default; 0 when nothing committed).

The engine feeds it TRANSLATED updates w_n + (w - b_n) (`fl.async_loop`).
When every upload is fresh (f(0) = 1 exactly, translation an exact no-op)
the commit IS eq. (34) bit for bit: the full-buffer limit reproduces the
scan engine.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels.fedavg_agg import fedavg_aggregate

__all__ = ["masked_weighted_mean", "aggregate", "AsyncAggregation",
           "AGGREGATION_PRESETS", "get_aggregation", "staleness_weight",
           "aggregate_buffered"]


def masked_weighted_mean(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted mean over the leading axis; identity-safe at zero weight.

    Kernel K3 for a CUDA float32 tensor, its plain version for a CPU one;
    anything else raises (`fedavg_aggregate`)."""
    k = stacked.shape[0]
    return fedavg_aggregate(stacked.reshape(k, -1), weights).reshape(stacked.shape[1:])


def aggregate(global_params: dict, client_params: dict,
              weights: torch.Tensor) -> dict:
    """Eq. (34).  client_params leaves have a leading slot axis (K, ...);
    weights (K,) = S_n * sum_k psi_kn * beta_n per slot (0 for empty slots).
    Keeps the previous global model when sum(weights) == 0."""
    keep = weights.sum() > 0
    return {k: torch.where(keep, masked_weighted_mean(client_params[k], weights),
                           g).to(g.dtype)
            for k, g in global_params.items()}


# ---------------------------------------------------------------------------
# Asynchronous (buffered, staleness-weighted) aggregation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AsyncAggregation:
    """Commit policy of the buffered async server (`engine="async"`).

    Attributes:
      buffer: how many in-flight uploads the server waits for before
        committing an event.  An int M >= 1 waits for the M earliest
        arrivals (ties commit together); "full" waits for EVERY in-flight
        upload, the synchronous barrier that reproduces the scan engine
        bit for bit; None (default) resolves to max(1, K // 2).
      staleness: weight-decay preset applied per committed update,
        "poly" -> f(s) = (1 + s)^-exponent, "const" -> f(s) = 1.  s counts
        server events since the update's dispatch; f(0) == 1.0 exactly.
      exponent: the polynomial decay rate (ignored by "const").
      server_lr: the commit step size m in (0, 1]; 1.0 is the full step
        and the bit-exact sync endpoint.
    """

    buffer: int | str | None = None
    staleness: str = "poly"
    exponent: float = 0.5
    server_lr: float = 1.0

    def __post_init__(self):
        if isinstance(self.buffer, str) and self.buffer != "full":
            raise ValueError(f"buffer must be an int, None, or 'full': "
                             f"{self.buffer!r}")
        if isinstance(self.buffer, int) and self.buffer < 1:
            raise ValueError(f"buffer must be >= 1: {self.buffer}")
        if self.staleness not in ("poly", "const"):
            raise ValueError(f"unknown staleness preset: {self.staleness!r}")
        if self.exponent < 0:
            raise ValueError(f"exponent must be >= 0: {self.exponent}")
        if not 0.0 < self.server_lr <= 1.0:
            raise ValueError(f"server_lr must be in (0, 1]: {self.server_lr}")

    def resolve_buffer(self, n: int, k: int) -> int:
        """The concrete commit batch size M for an (N, K) network.

        An int buffer must be strictly below the K sub-channels (K = 1
        exempt): with at most K dispatches per event, M >= K drains every
        flight each event, which silently IS the synchronous barrier."""
        if self.buffer == "full":
            return n
        if self.buffer is None:
            return max(1, k // 2)
        if self.buffer >= k and k > 1:
            raise ValueError(
                f"buffer={self.buffer} >= K={k} waits for every in-flight "
                f"upload each event — that IS the synchronous barrier; say "
                f"buffer='full' if that is intended")
        return int(self.buffer)

    def stale_exponent(self) -> float:
        """The decay fed to `staleness_weight` (0.0 encodes "const")."""
        return 0.0 if self.staleness == "const" else float(self.exponent)


# Named presets usable as `SimConfig.aggregation` ("sync" is the absence of
# an AsyncAggregation).
AGGREGATION_PRESETS: dict[str, AsyncAggregation] = {
    "async": AsyncAggregation(),
    "async_const": AsyncAggregation(staleness="const"),
    "async_full": AsyncAggregation(buffer="full"),
}


def get_aggregation(agg: "str | AsyncAggregation") -> AsyncAggregation | None:
    """Resolve an aggregation spec; None means synchronous eq.-34."""
    if isinstance(agg, AsyncAggregation):
        return agg
    if agg == "sync":
        return None
    try:
        return AGGREGATION_PRESETS[agg]
    except KeyError:
        raise ValueError(
            f"unknown aggregation: {agg!r} "
            f"(known: ['sync'] + {sorted(AGGREGATION_PRESETS)})") from None


def staleness_weight(staleness: torch.Tensor, exponent: torch.Tensor) -> torch.Tensor:
    """f(s) = (1 + s)^-exponent in float32, EXACTLY 1.0 at s = 0 (and
    everywhere when exponent = 0, the "const" preset): the bit-exact sync
    limit needs fresh commits to carry the multiplier 1.0, not a float
    power round trip."""
    s = staleness.to(torch.float32)
    return torch.where(s <= 0, 1.0, torch.pow(1.0 + s, -exponent).to(torch.float32))


def aggregate_buffered(global_params: dict, committed_params: dict,
                       weights: torch.Tensor, server_lr: torch.Tensor) -> dict:
    """One buffered commit.

    committed_params leaves have a leading commit-slot axis (K, ...) and
    hold the TRANSLATED updates; weights (K,) = beta_n * f(staleness_n) per
    slot (0 for empty slots); server_lr a float32 scalar tensor.

    The committed updates' weighted mean is mixed into the global model
    with m = server_lr (0 when nothing committed).  Both endpoints are
    exact selects: m == 1 is bitwise `aggregate` (eq. 34) and m == 0 is
    bitwise identity.
    """
    wsum = weights.sum()
    m = torch.where(wsum > 0, server_lr, 0.0)
    out = {}
    for k, g in global_params.items():
        agg = torch.where(wsum > 0, masked_weighted_mean(committed_params[k], weights),
                          g).to(g.dtype)
        mixed = ((1.0 - m) * g + m * agg).to(g.dtype)
        out[k] = torch.where(m >= 1.0, agg, torch.where(m <= 0.0, g, mixed))
    return out
