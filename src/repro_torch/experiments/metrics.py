"""Derived paper metrics computed from `SimHistory` traces.

These are the quantities the paper's figures compare across scheduling
policies: convergence speed (rounds / wall-clock time to a target global
loss, Figs. 3-5), sub-channel utilization (how many of the K uplink slots
carry a transmitting device each round, Fig. 7's resource story), and
cumulative latency (the eq.-9 round latencies summed over the horizon —
the x-axis of the convergence-time plots).  All metrics are pure functions
of a finished history, so artifacts can be re-derived without re-running.
"""
from __future__ import annotations

import numpy as np

from ..fl.sim import SimConfig, SimHistory

__all__ = [
    "rounds_to_target",
    "time_to_target_s",
    "per_round_utilization",
    "eval_spacing_weights",
    "mean_subchannel_utilization",
    "cumulative_latency_s",
    "summarize_cell",
]


def rounds_to_target(hist: SimHistory, target_loss: float) -> int | None:
    """Rounds elapsed until global loss first reaches `target_loss`.

    Returns the 1-based round count at the first eval point with
    ``global_loss <= target_loss`` (loss is only observed at eval rounds,
    so this is an upper bound tight to `eval_every`), or None if the
    target is never reached within the horizon.
    """
    hit = np.nonzero(hist.global_loss <= target_loss)[0]
    return int(hist.rounds[hit[0]]) + 1 if hit.size else None


def time_to_target_s(hist: SimHistory, target_loss: float) -> float | None:
    """Simulated convergence time (eq. 9 cumsum) to reach `target_loss`."""
    hit = np.nonzero(hist.global_loss <= target_loss)[0]
    return float(hist.cum_time_s[hit[0]]) if hit.size else None


def per_round_utilization(hist: SimHistory, k: int, *,
                          allow_eval_sampled: bool = False) -> np.ndarray:
    """Fraction of the K sub-channels carrying a transmitter, per round.

    With a full ``tx_trace`` this is exact, one entry per round.  Without
    one, only the eval-sampled ``n_transmitted`` exists; that array has
    one entry per EVAL round, so it is not "per round" and its plain mean
    is biased whenever ``eval_every > 1`` (the final round and round 0
    are always sampled, interior blocks are represented by one round
    each).  Callers must opt in to that coarser series explicitly with
    ``allow_eval_sampled=True`` and weight it themselves (see
    `eval_spacing_weights`); otherwise the silent sampling-grid switch
    raises.
    """
    if hist.tx_trace is not None:
        return hist.tx_trace.sum(axis=1) / k
    if not allow_eval_sampled:
        raise ValueError(
            "history has no full tx_trace: n_transmitted is sampled on the "
            "eval grid, not per round. Pass allow_eval_sampled=True to "
            "accept the eval-sampled series (weight it by "
            "eval_spacing_weights(hist.rounds) before averaging).")
    return hist.n_transmitted / k


def eval_spacing_weights(rounds: np.ndarray) -> np.ndarray:
    """Per-eval-point block sizes: eval point j stands in for the rounds
    since the previous eval point, so weights sum to the horizon length."""
    r = np.asarray(rounds, np.int64)
    return np.diff(np.concatenate(([-1], r))).astype(np.float64)


def mean_subchannel_utilization(hist: SimHistory, k: int) -> float:
    """Mean fraction of the K sub-channels carrying a transmitter per round.

    Exact when the history carries a full ``tx_trace``.  On the
    eval-sampled fallback, each sample is weighted by the number of
    rounds its eval block spans (`eval_spacing_weights`), so uneven eval
    grids (round 0 and the final round are always sampled) don't skew
    the average the way a plain mean over eval points does.
    """
    if hist.tx_trace is not None:
        return float(per_round_utilization(hist, k).mean())
    u = per_round_utilization(hist, k, allow_eval_sampled=True)
    return float(np.average(u, weights=eval_spacing_weights(hist.rounds)))


def cumulative_latency_s(hist: SimHistory) -> float:
    """Total simulated time of the run: sum of eq.-9 round latencies."""
    if hist.latency_all is not None:
        return float(hist.latency_all.sum())
    return float(hist.cum_time_s[-1])


def summarize_cell(cfg: SimConfig, hist: SimHistory,
                   target_loss: float | None = None) -> dict:
    """One cell's scalar metric row, as stored in the sweep artifact."""
    out = {
        "final_loss": float(hist.global_loss[-1]),
        "final_accuracy": float(hist.accuracy[-1]),
        "mean_subchannel_utilization":
            mean_subchannel_utilization(hist, cfg.n_subchannels),
        "cumulative_latency_s": cumulative_latency_s(hist),
        "mean_round_latency_s": float(np.mean(
            hist.latency_all if hist.latency_all is not None
            else hist.latency_s)),
        "total_energy_j": float(np.sum(
            hist.energy_all if hist.energy_all is not None
            else hist.energy_j)),
        "wall_s": float(hist.wall_s),
        "plan_wall_s": float(hist.plan_wall_s),
    }
    if target_loss is not None:
        out["target_loss"] = float(target_loss)
        out["rounds_to_target"] = rounds_to_target(hist, target_loss)
        out["time_to_target_s"] = time_to_target_s(hist, target_loss)
    return out
