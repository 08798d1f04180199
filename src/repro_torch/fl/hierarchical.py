"""Hierarchical (multi-cell) FLOWN, PyTorch port of the JAX package's
`fl/hierarchical.py`.

C cells, each with its own base station running the paper's FULL
Stackelberg round (own channels, own sub-channels, own AoU state),
followed by an inter-cell aggregation of the cell models weighted by
transmitted data:

    cell c:   w_c = eq.(34) over its transmitting devices
    global:   w   = sum_c W_c w_c / sum_c W_c ,  W_c = sum_{n in tx_c} beta_n

Like the single-cell harness (`fl.sim`), every engine shares two stages:

  1. NumPy world (`_prepare_hier`): ONE shared mobility field across all
     C*N devices, cross-cell interference as coupled fading
     (`scenarios.sample_coupled_fading`), per-cell Markov churn and energy
     budgets — the JAX package's rng stream, so the same seed gives the
     same arrays;
  2. Γ for every (cell, round, sub-channel, device) pair concatenated into
     ONE solver call (`_solve_hier_horizons`): kernel K1, or the step
     driver over kernel K2 with `ra_solver="step"`; `ra_backend` names
     another projection, as in the JAX package ("bisect" / "jnp",
     "newton" or "mixed": the step loop with that projection, launching
     neither kernel).

Then one of three round loops:

  engine="loop"  -- host round loop: per-cell NumPy `plan_round`, local
                    SGD from the global model, eq.-34 per cell on K3, then
                    one global K3 over the cells that transmitted;
  engine="scan"  -- the device-resident round loop with the cell list a
                    Python loop in its body: per-cell device leader
                    (`core.leader_torch`), training, eq.-34 on K3 for each
                    cell that transmitted, and a global K3 over all C cell
                    slots every round (weight 0 for a silent cell);
  engine="async" -- the two-tier buffered event loop (`fl.hier_async`);
                    `HierSimConfig.aggregation` names the cell tier's
                    commit policy, `.global_aggregation` the global tier's;
                    either being async routes here.

The learning plane draws one (subchannels_per_cell, local_steps, batch)
block of minibatch uniforms per (round, cell) in which that cell trains, in
cell order, from one stream shared by all cells (`fl.sim.training_draws`
with `k=`): the order in which the JAX package splits its one key.

`run_hier_many` is the sweep entry point: like `fl.sim.run_many` it dedups
worlds across policy/aggregation variants and groups compatible configs
(`_hier_group_key`).  A group of G configs runs as ONE loop with the
configs on a leading axis, the port of the JAX package's `jit(vmap)` over
the group: cell c of every config is one flat group of G
(`engine_common.group_cell_data`), so per round and cell index the leader
runs once per policy, the host reads one (G,) vector of who trains, and one
K3 launch aggregates every config's cell c; the global tier is one K3
launch over the (G, C) cell models.  Each config is bitwise its solo run.
It returns flat-compatible `SimHistory` records with (rounds, C*N) traces.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Sequence

import numpy as np
import torch
from torch.func import functional_call

from ..core import (RAResult, RoundPolicy, RoundRandomness, WirelessConfig,
                    init_aou, make_clusters, plan_round)
from ..core.monotonic import fixed_ra
from ..core.monotonic_torch import check_ra_backend, solve_pairs_fused, solve_pairs_step
from ..data.fl_datasets import Dataset, make_dataset, partition_imbalanced_iid
from ..device import resolve_device
from ..models.small import get_small_model
from ..scenarios import (Scenario, apply_dynamics, compose_gains, get_scenario,
                         sample_churn, sample_coupled_fading, sample_distances,
                         sample_energy)
from ..train.optimizer import make_optimizer
from .client import make_local_trainer
from .engine_common import (eval_cells, group_cell_data, group_data, make_eval_fn,
                            make_group_leader, make_xs, stack_cells, sync_group_round)
from .hier_async import build_hier_async_group_runner
from .server import AsyncAggregation, aggregate, get_aggregation
from .sim import (TABLE1, SimHistory, _dispatch_group, _eval_mask, _eval_rounds,
                  _group_trainer_and_policies, _history_from_async,
                  _history_from_scan, _pad_partition, _slice_ra, _to_host,
                  training_draws)

__all__ = ["HierSimConfig", "run_hierarchical", "run_hier_many"]


@dataclasses.dataclass(frozen=True)
class HierSimConfig:
    """Multi-cell simulation settings (one Stackelberg game per cell).

    `n_cells` base stations each serve `devices_per_cell` devices over
    `subchannels_per_cell` uplink sub-channels; all cells share the global
    model and the Table-I learning settings of `dataset` (None overrides =
    "use Table I", like `SimConfig`).  `scenario` names the shared
    environment (one mobility field spans ALL cells; churn and energy are
    per-cell processes), `cell_coupling` the cross-cell fading
    correlation, and the two aggregation fields the commit policies of the
    cell tier (`aggregation`) and the global tier (`global_aggregation`) —
    either being async routes the simulation through the two-tier event
    engine (`fl.hier_async`).
    """

    dataset: str = "mnist"
    n_cells: int = 2
    devices_per_cell: int = 10
    subchannels_per_cell: int = 4
    rounds: int = 40
    policy: RoundPolicy = RoundPolicy()
    seed: int = 0
    n_samples: int | None = 400
    local_steps: int = 3
    radius_m: float = 500.0
    pt_dbm: float = 10.0
    e_max_j: float | None = None       # None -> Table I per-dataset value
    lr: float | None = None
    batch: int | None = None
    optimizer: str | None = None
    eval_every: int = 1
    track_gradnorm: bool = False
    scenario: str | Scenario = "static"
    cell_coupling: float = 0.0         # cross-cell fading correlation in [0, 1]
    aggregation: str | AsyncAggregation = "sync"         # cell tier
    global_aggregation: str | AsyncAggregation = "sync"  # global tier

    @property
    def n_devices(self) -> int:
        """Total device count across cells (sweep-metric compatibility)."""
        return self.n_cells * self.devices_per_cell

    @property
    def n_subchannels(self) -> int:
        """Total sub-channel count across cells (C*K: a learning-plane
        block is one cell's K, see `fl.sim.training_draws`)."""
        return self.n_cells * self.subchannels_per_cell

    def wireless(self) -> WirelessConfig:
        """The PER-CELL wireless world (each cell is one paper network)."""
        t1 = TABLE1[self.dataset]
        return WirelessConfig(
            n_devices=self.devices_per_cell,
            n_subchannels=self.subchannels_per_cell,
            radius_m=self.radius_m,
            pt_dbm=self.pt_dbm,
            model_bits=t1["model_bits"],
            e_max_j=self.e_max_j if self.e_max_j is not None else t1["e_max"],
        )


@dataclasses.dataclass
class _HierPrepared:
    """Per-cell worlds + whole-horizon scenario traces, sampled up front."""

    cfg: HierSimConfig
    wcfg: WirelessConfig           # per-cell wireless constants
    rng: np.random.Generator
    ds: Dataset
    beta: np.ndarray               # (C, N) float64
    x: torch.Tensor                # (C, N, Bmax, ...) padded client data
    y: torch.Tensor
    m: torch.Tensor
    clusters: np.ndarray           # (C, N)
    fixed_ids: np.ndarray          # (C, S)
    h2_all: np.ndarray             # (C, rounds, K, N)
    sel_perms: np.ndarray          # (C, rounds, N)
    assign_perms: np.ndarray       # (C, rounds, K)
    distances: np.ndarray          # (C, rounds, N) shared mobility field
    avail: np.ndarray              # (C, rounds, N) per-cell churn
    slowdown: np.ndarray           # (C, rounds, N)
    emax_all: np.ndarray           # (C, rounds, N)


def _prepare_hier(cfg: HierSimConfig, device: torch.device) -> _HierPrepared:
    """Sample the multi-cell world + whole-horizon scenario environment.

    The stream mirrors `fl.sim._prepare` phase for phase with per-cell
    blocks — dataset, per-cell partitions, ONE shared mobility field over
    all C*N devices (one city; cells are neighborhoods of the same walker
    population), per-cell leader state (clusters/fixed_ids), coupled
    cross-cell fading, per-cell selection then assignment permutations,
    per-cell churn, per-cell energy.  At C == 1 every block is exactly one
    flat-stream call in the flat order, so a single-cell hierarchy consumes
    the flat `_prepare`'s stream bit for bit.
    """
    rng = np.random.default_rng(cfg.seed)
    wcfg = cfg.wireless()
    scn = get_scenario(cfg.scenario)
    c_n, n, k = cfg.n_cells, cfg.devices_per_cell, cfg.subchannels_per_cell

    ds_kw = {} if cfg.n_samples is None else {"n": cfg.n_samples}
    ds = make_dataset(cfg.dataset, rng, **ds_kw)
    parts = [partition_imbalanced_iid(rng, ds.n, n) for _ in range(c_n)]
    beta = np.stack([p.beta.astype(np.float64) for p in parts])
    bmax = max(int(p.beta.max()) for p in parts)
    padded = [_pad_partition(ds, p, device, bmax) for p in parts]
    x, y, m = (torch.stack([p[i] for p in padded]) for i in range(3))

    # One SHARED mobility field: all C*N devices walk one world draw.
    dist_flat = sample_distances(
        rng, dataclasses.replace(wcfg, n_devices=c_n * n), scn.mobility,
        cfg.rounds)                                     # (rounds, C*N)
    distances = np.ascontiguousarray(
        dist_flat.reshape(cfg.rounds, c_n, n).transpose(1, 0, 2))

    clusters, fixed_ids = [], []
    for _ in range(c_n):
        clusters.append(make_clusters(n, k, rng))
        fixed_ids.append(rng.permutation(n)[: min(k, n)])

    g2_all = sample_coupled_fading(rng, wcfg, scn.fading, cfg.rounds, c_n,
                                   cfg.cell_coupling)   # (C, rounds, K, N)
    h2_all = np.stack([compose_gains(g2_all[c], distances[c], wcfg)
                       for c in range(c_n)])

    sel_perms = np.stack([
        np.stack([rng.permutation(n) for _ in range(cfg.rounds)])
        for _ in range(c_n)])
    assign_perms = np.stack([
        np.stack([rng.permutation(k) for _ in range(cfg.rounds)])
        for _ in range(c_n)])

    churn = [sample_churn(rng, scn.churn, cfg.rounds, n) for _ in range(c_n)]
    avail = np.stack([a for a, _ in churn])
    slowdown = np.stack([s for _, s in churn])
    emax_all = np.stack([sample_energy(rng, wcfg, scn.energy, cfg.rounds)
                         for _ in range(c_n)])

    return _HierPrepared(
        cfg=cfg, wcfg=wcfg, rng=rng, ds=ds, beta=beta, x=x, y=y, m=m,
        clusters=np.stack(clusters), fixed_ids=np.stack(fixed_ids),
        h2_all=h2_all, sel_perms=sel_perms, assign_perms=assign_perms,
        distances=distances, avail=avail, slowdown=slowdown,
        emax_all=emax_all)


def _solve_hier_horizons(preps: Sequence[_HierPrepared], solver: str,
                         device: torch.device, backend: str | None = None,
                         shard: bool | None = None
                         ) -> tuple[list[list[RAResult]], list[float]]:
    """Algorithm 1 for every (cell, round) of every prepared simulation.

    Each unique world's C cell horizons flatten into ONE solver call (K1,
    or the step driver over K2 with `solver="step"`): the solver is
    elementwise over pairs, so cells concatenate freely and the per-cell
    slices equal solo solves bit for bit — at C == 1, the flat
    `_solve_horizons` result.  Worlds shared across policy-only /
    aggregation-only variants are solved once and aliased.  `backend` is
    the solver's projection backend; `shard` shards the fused solver's rows
    over the local devices.
    """
    solve = (functools.partial(solve_pairs_fused, shard=shard) if solver == "fused"
             else solve_pairs_step)
    out: list[list[RAResult] | None] = [None] * len(preps)
    secs = [0.0] * len(preps)
    rep_idx: dict[tuple[int, str], int] = {}
    for i, p in enumerate(preps):
        key = (id(p.h2_all), p.cfg.policy.ra)
        if key in rep_idx:
            out[i] = out[rep_idx[key]]
            continue
        rep_idx[key] = i
        shp = p.h2_all.shape[1:]                  # (rounds, K, N)
        sz = int(np.prod(shp))
        t0 = time.perf_counter()
        if p.cfg.policy.ra == "mo":
            beta_cat = np.broadcast_to(p.beta[:, None, None, :],
                                       p.h2_all.shape).reshape(-1)
            emax_cat = np.broadcast_to(p.emax_all[:, :, None, :],
                                       p.h2_all.shape).reshape(-1)
            flat = solve(beta_cat, p.h2_all.reshape(-1), p.wcfg, emax_cat,
                         backend=backend, device=device)
            out[i] = [RAResult(**{f.name: getattr(flat, f.name)[c * sz:(c + 1) * sz]
                                  .reshape(shp) for f in dataclasses.fields(RAResult)})
                      for c in range(p.cfg.n_cells)]
        else:
            out[i] = [fixed_ra(p.beta[c][None, None, :], p.h2_all[c], p.wcfg,
                               np.broadcast_to(p.emax_all[c][:, None, :], shp))
                      for c in range(p.cfg.n_cells)]
        secs[i] = time.perf_counter() - t0
    return out, secs


def _apply_hier_dynamics(prep: _HierPrepared,
                         ras: list[RAResult]) -> list[RAResult]:
    """Fold per-cell churn availability + straggler slowdowns into each
    cell's solved whole-horizon RAResult, once, before any engine runs."""
    return [apply_dynamics(ra, prep.avail[c], prep.slowdown[c], prep.beta[c],
                           prep.wcfg)
            for c, ra in enumerate(ras)]


def _check_hier_f32(preps: Sequence[_HierPrepared]) -> None:
    # Mirror of `fl.sim._check_f32_priorities`: the device leaders rank
    # float32 age*beta products, exact only below 2^24.
    for p in preps:
        worst = (p.cfg.rounds + 1) * float(p.beta.max())
        if worst >= 2 ** 24:
            raise ValueError(
                f"hier scan/async engines: age*beta products may reach "
                f"{worst:.3g} >= 2^24, where float32 priorities lose host "
                f"equivalence — use engine='loop' or shrink rounds/data")


# ---------------------------------------------------------------------------
# engine="scan" / engine="async": device-resident two-tier loops
# ---------------------------------------------------------------------------

def _hier_scan_inputs(prep: _HierPrepared, ras: list[RAResult],
                      device: torch.device, policy_idx: int = 0) -> dict:
    """The hierarchy's `data` dict: `fl.sim._scan_inputs` with a leading
    cell axis on the per-cell tensors (beta/clusters/fixed_ids/client
    data) and a cell axis SECOND on the per-round traces (gamma/feas/energy
    (rounds, C, K, N), perms (rounds, C, ...))."""
    cfg = prep.cfg
    params0, next_uniforms = training_draws(
        cfg, cfg.batch or TABLE1[cfg.dataset]["batch"], device,
        k=cfg.subchannels_per_cell)

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)

    def i64(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)

    return dict(
        params0=params0,
        next_uniforms=next_uniforms,
        policy_idx=policy_idx,
        beta=f32(prep.beta),
        x_all=prep.x.to(device), y_all=prep.y.to(device), m_all=prep.m.to(device),
        x_full=torch.from_numpy(prep.ds.x).to(device),
        y_full=torch.from_numpy(prep.ds.y).to(device),
        clusters=i64(prep.clusters),
        fixed_ids=i64(prep.fixed_ids),
        gamma=f32(np.stack([ra.time_s for ra in ras], axis=1)),
        feas=torch.as_tensor(np.stack([ra.feasible for ra in ras], axis=1),
                             device=device),
        energy=f32(np.stack([np.where(np.isfinite(ra.energy_j), ra.energy_j, 0.0)
                             for ra in ras], axis=1)),
        sel_perms=i64(prep.sel_perms.swapaxes(0, 1)),
        assign_perms=i64(prep.assign_perms.swapaxes(0, 1)),
    )


def _build_hier_scan_runner(cfg: HierSimConfig, model, trainer,
                            policies: Sequence[tuple[str, str]]):
    """The multi-cell SYNC round loop of a group of G configs on the
    device: cells a Python loop in the round body, eq.-34 at both tiers.

    `data` is `engine_common.group_data` of the configs' `_hier_scan_inputs`
    dicts.  Cell c of every config is one flat group
    (`engine_common.group_cell_data`), and its round is the flat scan
    engine's `sync_group_round`, so a cell runs the flat engine's float ops
    by construction: every config trains from its own global model with its
    own draws, the host reads the (G,) counts once, and one K3 launch
    aggregates the configs whose cell c trained (none when no config's cell
    trained: the JAX package's `lax.cond(cnt > 0)`).  The cells run in the
    order the two-tier async engine runs them — the sync side of the
    full-buffer differential.  The global tier is one K3 launch every round
    over the (G, C) cell models, with weight 0 for a silent cell.  Returns
    fn(data) -> ys, per-round tensors (rounds, G, ...) on the device."""
    n, k, n_cells = cfg.devices_per_cell, cfg.subchannels_per_cell, cfg.n_cells
    n_clusters = int(math.ceil(n / k))
    eval_mask = _eval_mask(cfg)

    def run(data):
        configs = data["cells"]
        device = data["beta"].device
        zeros = torch.zeros(len(configs), dtype=torch.float32, device=device)
        cells = [group_cell_data(data, c) for c in range(n_cells)]
        leaders = [make_group_leader(policies, cells[c], k=k, n=n, n_clusters=n_clusters)
                   for c in range(n_cells)]
        evs = [make_eval_fn(model, d, cfg.track_gradnorm) for d in configs]
        xs = [make_xs(cells[c], cfg.rounds, eval_mask) for c in range(n_cells)]
        params = stack_cells([d["params0"] for d in configs])
        draws = [d["next_uniforms"] for d in configs]
        ages = [torch.ones((len(configs), n), dtype=torch.int32, device=device)] * n_cells
        ys = []
        for r in range(cfg.rounds):
            outs = [sync_group_round(leaders[c], trainer, cells[c],
                                     {name: v[r] for name, v in xs[c].items()}, params,
                                     draws, ages[c], k=k, n=n)
                    for c in range(n_cells)]
            latency = zeros
            for out in outs:
                latency = torch.maximum(latency, out["latency"])
            stacked = {name: torch.stack([out["params"][name] for out in outs], 1)
                       for name in params}
            weights = torch.stack([out["slot_w"].sum(-1) for out in outs], 1)
            params = aggregate(params, stacked, weights)
            ages = [out["lead"]["age_next"] for out in outs]
            loss, acc, gnorm = (eval_cells(evs, params) if eval_mask[r]
                                else (zeros, zeros, zeros))
            ys.append(dict(loss=loss, acc=acc, gnorm=gnorm, latency=latency,
                           energy=torch.stack([out["energy"] for out in outs], -1).sum(-1),
                           selected=torch.stack([out["lead"]["selected"] for out in outs], 1),
                           transmitted=torch.stack([out["lead"]["transmitted"]
                                                    for out in outs], 1),
                           age=torch.stack(ages, 1)))
        return {name: torch.stack([y[name] for y in ys]) for name in ys[0]}

    return run


def _hier_async_specs(cfg: HierSimConfig) -> tuple[AsyncAggregation,
                                                   AsyncAggregation]:
    """Cell-tier and global-tier commit policies.  A "sync" tier forced
    through the event engine runs the degenerate full-buffer barrier — the
    differential anchor at that tier."""
    barrier = AsyncAggregation(buffer="full", staleness="const")
    spec = get_aggregation(cfg.aggregation) or barrier
    g_spec = get_aggregation(cfg.global_aggregation) or barrier
    return spec, g_spec


def _flatten_hier_ys(ys: dict, rounds: int) -> dict:
    """Collapse (rounds, C, N) device traces to the flat engines' (rounds,
    C*N) layout so `fl.sim`'s history builders apply verbatim."""
    out = dict(ys)
    for key in ("selected", "transmitted", "age", "committed", "rem_dispatch"):
        if key in out:
            out[key] = np.asarray(out[key]).reshape(rounds, -1)
    return out


def _history_from_hier(cfg: HierSimConfig, beta_flat: np.ndarray, ys: dict,
                       wall_s: float, plan_wall_s: float,
                       mode: str) -> SimHistory:
    flat = _flatten_hier_ys(ys, cfg.rounds)
    if mode == "async":
        hist = _history_from_async(cfg, beta_flat, flat, wall_s, plan_wall_s)
        hist.async_trace.update(
            g_pending=np.asarray(ys["g_pending"], np.int64),
            cell_committed=np.asarray(ys["cell_committed"]),
            latency_cells=np.asarray(ys["latency_cells"], np.float64),
        )
    else:
        hist = _history_from_scan(cfg, beta_flat, flat, wall_s, plan_wall_s)
    return hist


def _async_operands(cfg: HierSimConfig, device: torch.device) -> dict:
    """A config's commit operands at both tiers (`g_` the global tier's),
    as the two-tier event loop takes them."""
    spec, g_spec = _hier_async_specs(cfg)

    def f32(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=device)

    return dict(buffer=spec.resolve_buffer(cfg.devices_per_cell, cfg.subchannels_per_cell),
                stale_exp=f32(spec.stale_exponent()), server_lr=f32(spec.server_lr),
                g_buffer=g_spec.resolve_buffer(cfg.n_cells, cfg.n_cells),
                g_stale_exp=f32(g_spec.stale_exponent()),
                g_server_lr=f32(g_spec.server_lr))


def _run_hier_group(mode: str, cfgs: Sequence[HierSimConfig],
                    preps: Sequence[_HierPrepared],
                    ras_list: Sequence[list[RAResult]],
                    plan_walls: Sequence[float],
                    device: torch.device) -> list[SimHistory]:
    """Run one group of hierarchical simulations through the scan or
    two-tier async engine as ONE loop over a leading config axis, sharing
    the group's model, trainer and leader variants (like `fl.sim._run_group`).
    The configs run sorted by policy, so each distinct policy's leader runs
    once per (round, cell) on a contiguous slice; the histories come back in
    the given order.  On the async engine each config's commit operands at
    both tiers enter as data.

    A config's `wall_s` is the group's wall time divided by its size, plus
    the config's own share of planning (`plan_wall_s`), as the JAX package
    counts it: the configs run together, so there is no per-config time."""
    cfg = cfgs[0]
    model, trainer, policies, pol_idx = _group_trainer_and_policies(cfgs, device)
    _check_hier_f32(preps)
    order = sorted(range(len(cfgs)), key=pol_idx.__getitem__)
    t_start = time.perf_counter()
    datas = []
    for i in order:
        d = _hier_scan_inputs(preps[i], ras_list[i], device, pol_idx[i])
        if mode == "async":
            d.update(_async_operands(cfgs[i], device))
        datas.append(d)
    if mode == "scan":
        run = _build_hier_scan_runner(cfg, model, trainer, policies)
    else:
        run = build_hier_async_group_runner(
            model, trainer, policies, n_cells=cfg.n_cells,
            k=cfg.subchannels_per_cell, n=cfg.devices_per_cell,
            rounds=cfg.rounds, eval_mask=_eval_mask(cfg),
            track_gradnorm=cfg.track_gradnorm)
    ys = _to_host(run(group_data(datas)))
    wall_each = (time.perf_counter() - t_start) / len(cfgs)
    out: list[SimHistory | None] = [None] * len(cfgs)
    for j, i in enumerate(order):
        out[i] = _history_from_hier(cfgs[i], preps[i].beta.reshape(-1),
                                    {name: v[:, j] for name, v in ys.items()},
                                    wall_each + plan_walls[i], plan_walls[i], mode)
    return out


def _hier_group_key(cfg: HierSimConfig) -> HierSimConfig:
    """Configs identical up to seed/wireless-data/policy/scenario/
    aggregation fields share one model and trainer — `fl.sim._scan_group_key`
    extended with the hierarchy's data axes (global aggregation, cell
    coupling)."""
    return dataclasses.replace(
        cfg, seed=0, radius_m=0.0, pt_dbm=0.0, e_max_j=None,
        policy=RoundPolicy(), scenario="static", cell_coupling=0.0,
        aggregation="sync", global_aggregation="sync")


def _hier_prep_key(cfg: HierSimConfig) -> HierSimConfig:
    """Configs identical up to policy/aggregation share one prepared world
    (all sampling precedes both), like `fl.sim._prep_key`."""
    return dataclasses.replace(cfg, policy=RoundPolicy(), aggregation="sync",
                               global_aggregation="sync")


def _is_async(cfg: HierSimConfig) -> bool:
    """An async commit policy at either tier (validates both names)."""
    return (get_aggregation(cfg.aggregation) is not None
            or get_aggregation(cfg.global_aggregation) is not None)


def run_hier_many(cfgs: Sequence[HierSimConfig], *, engine: str = "scan",
                  ra_backend: str | None = None, ra_solver: str = "fused",
                  device=None, shard: bool | None = None) -> list[SimHistory]:
    """Run several hierarchical simulations, sharing prepared worlds and
    their Γ solves.

    The multi-cell analogue of `fl.sim.run_many`: worlds are deduped across
    policy/aggregation variants, Γ is solved once per world (all cells in
    one call), scenario dynamics fold in once, and compatible configs run as
    one group on a leading config axis (`_run_hier_group`), each bitwise its
    solo run.  Histories come back flat-compatible: (rounds, C*N) traces.

    Args:
      cfgs: the simulations to run; results are returned in the same order.
      engine: "scan" (sync two-tier barrier) or "async" (two-tier buffered
        event loop).  Configs whose `aggregation` OR `global_aggregation`
        name an async policy route through the async engine regardless;
        the host "loop" engine is single-sim only (`run_hierarchical`).
      ra_backend: projection backend of the Γ solver, as in
        `fl.sim.run_many`: None (the kernels), "cuda" / "pallas",
        "bisect" / "jnp", "newton" or "mixed".
      ra_solver: "fused" (kernel K1 solves every pair whole) or "step" (the
        per-iteration driver over kernel K2).
      device: "cuda[:i]" or "cpu"; None means the current CUDA device and
        raises when none is visible.
      shard: shard each group's config axis and the fused Γ solve's rows
        over the local devices, as `fl.sim.run_many` does (each config
        bitwise its solo run); None shards when more than one device is
        visible.
    """
    if engine not in ("scan", "async"):
        raise ValueError(f"unknown engine: {engine} "
                         f"(run_hier_many supports 'scan' and 'async'; the "
                         f"host 'loop' engine is run_hierarchical-only)")
    if ra_solver not in ("fused", "step"):
        raise ValueError(f"unknown ra_solver: {ra_solver}")
    check_ra_backend(ra_backend)
    modes = ["async" if engine == "async" or _is_async(c) else engine for c in cfgs]
    device = resolve_device(device)

    preps_by_key: dict[HierSimConfig, _HierPrepared] = {}
    preps: list[_HierPrepared] = []
    for c in cfgs:
        key = _hier_prep_key(c)
        if key not in preps_by_key:
            preps_by_key[key] = _prepare_hier(c, device)
        shared = preps_by_key[key]
        preps.append(shared if shared.cfg == c
                     else dataclasses.replace(shared, cfg=c))

    ras_list, plan_walls = _solve_hier_horizons(preps, ra_solver, device, ra_backend, shard)
    transformed: dict[int, list[RAResult]] = {}
    for i, (p, ras) in enumerate(zip(preps, ras_list)):
        if id(ras) not in transformed:
            transformed[id(ras)] = _apply_hier_dynamics(p, ras)
        ras_list[i] = transformed[id(ras)]

    out: list[SimHistory | None] = [None] * len(cfgs)
    groups: dict[tuple[str, HierSimConfig], list[int]] = {}
    for i, (c, mode) in enumerate(zip(cfgs, modes)):
        groups.setdefault((mode, _hier_group_key(c)), []).append(i)
    for (mode, _), idx in groups.items():
        hists = _dispatch_group(functools.partial(_run_hier_group, mode),
                                [cfgs[i] for i in idx], [preps[i] for i in idx],
                                [ras_list[i] for i in idx], [plan_walls[i] for i in idx],
                                device, shard)
        for i, h in zip(idx, hists):
            out[i] = h
    return out


# ---------------------------------------------------------------------------
# engine="loop" + the single-sim dict entry point
# ---------------------------------------------------------------------------

def _run_hier_loop(cfg: HierSimConfig, device: torch.device,
                   ra_backend: str | None) -> dict:
    """Host round loop: per-cell `plan_round`, training from the global
    model, eq.-34 per cell, then one eq.-34 over the cells that
    transmitted."""
    t_start = time.perf_counter()
    prep = _prepare_hier(cfg, device)
    ras_list, _ = _solve_hier_horizons([prep], "fused", device, ra_backend)
    ras = _apply_hier_dynamics(prep, ras_list[0])
    t1 = TABLE1[cfg.dataset]
    batch = cfg.batch or t1["batch"]
    k_slots = cfg.subchannels_per_cell
    model = get_small_model(cfg.dataset).to(device)
    params, next_uniforms = training_draws(cfg, batch, device, k=k_slots)
    opt = make_optimizer(cfg.optimizer or t1["optimizer"], cfg.lr or t1["lr"])
    trainer = make_local_trainer(model, opt, batch_size=batch,
                                 local_steps=cfg.local_steps)
    x_full = torch.from_numpy(prep.ds.x).to(device)
    y_full = torch.from_numpy(prep.ds.y).to(device)

    def evaluate(p):
        with torch.no_grad():
            logits = functional_call(model, p, (x_full,))
            return (float(model.loss_per_example(logits, y_full).mean()),
                    float(model.correct(logits, y_full).mean()))

    aous = [init_aou(cfg.devices_per_cell) for _ in range(cfg.n_cells)]
    eval_at = set(_eval_rounds(cfg.rounds, cfg.eval_every))
    losses, accs, eval_rounds = [], [], []
    # Full per-round traces regardless of eval sampling: convergence time
    # accumulates unsampled rounds too.
    lat_all = np.zeros(cfg.rounds)
    energy_all = np.zeros(cfg.rounds)
    shape = (cfg.rounds, cfg.n_cells, cfg.devices_per_cell)
    tx_trace = np.zeros(shape, bool)
    age_trace = np.zeros(shape, np.int64)
    for t in range(cfg.rounds):
        cell_params, cell_weights, round_lat, round_e = [], [], 0.0, 0.0
        for c in range(cfg.n_cells):
            plan = plan_round(
                aous[c], prep.beta[c], prep.h2_all[c][t], prep.wcfg, prep.rng,
                policy=cfg.policy, round_idx=t, clusters=prep.clusters[c],
                fixed_ids=prep.fixed_ids[c], ra=_slice_ra(ras[c], t),
                randomness=RoundRandomness(sel_perm=prep.sel_perms[c][t],
                                           assign_perm=prep.assign_perms[c][t]))
            aous[c] = plan.aou_next
            round_lat = max(round_lat, plan.latency_s)  # cells in parallel
            round_e += float(plan.energy_per_device.sum())
            tx_trace[t, c] = plan.transmitted
            age_trace[t, c] = aous[c].age
            tx = np.where(plan.transmitted)[0]
            slot_ids = np.zeros(k_slots, dtype=np.int64)
            slot_w = np.zeros(k_slots, dtype=np.float32)
            slot_ids[: len(tx)] = tx
            slot_w[: len(tx)] = prep.beta[c][tx]
            if len(tx):
                sid = torch.from_numpy(slot_ids).to(device)
                client = trainer(params, prep.x[c][sid], prep.y[c][sid],
                                 prep.m[c][sid], next_uniforms())
                cell_params.append(aggregate(params, client,
                                             torch.from_numpy(slot_w).to(device)))
                cell_weights.append(float(slot_w.sum()))
        if cell_params:
            stacked = {name: torch.stack([p[name] for p in cell_params])
                       for name in params}
            params = aggregate(params, stacked,
                               torch.tensor(cell_weights, dtype=torch.float32,
                                            device=device))
        lat_all[t] = round_lat
        energy_all[t] = round_e
        if t in eval_at:
            loss, acc = evaluate(params)
            eval_rounds.append(t)
            losses.append(loss)
            accs.append(acc)
    ev = np.asarray(eval_rounds)
    return {"loss": np.asarray(losses), "accuracy": np.asarray(accs),
            "eval_rounds": ev, "cum_time_s": np.cumsum(lat_all)[ev],
            "latency": lat_all, "energy": energy_all, "tx": tx_trace,
            "age": age_trace, "wall_s": time.perf_counter() - t_start}


def run_hierarchical(cfg: HierSimConfig, *, engine: str = "loop",
                     ra_backend: str | None = None, device=None) -> dict:
    """Two-tier FedAvg: per-cell Stackelberg rounds + inter-cell
    aggregation (sync barrier or buffered async at either tier).

    Args:
      cfg: multi-cell settings; `cfg.policy` applies to every cell.
      engine: "loop" (host round loop), "scan" (device-resident round loop
        with the cell list in its body), or "async" (the two-tier buffered
        event loop).  Configs whose cell- or global-tier aggregation is
        async route through the event engine regardless.
      ra_backend: projection backend of the Γ solver (the fused one), as
        in `fl.sim.run_many`.
      device: "cuda[:i]" or "cpu"; None means the current CUDA device and
        raises when none is visible.

    Returns a dict with FULL per-round traces regardless of
    `cfg.eval_every` — "latency"/"energy" (rounds,), "tx"/"age" (rounds,
    n_cells, N) — plus eval-sampled curves "loss"/"accuracy"/"cum_time_s"
    at "eval_rounds", and "wall_s".  engine="async" adds "committed"
    (rounds, n_cells, N), "cell_committed" and "latency_cells" (rounds,
    n_cells).
    """
    if engine not in ("loop", "scan", "async"):
        raise ValueError(f"unknown engine: {engine}")
    check_ra_backend(ra_backend)
    async_mode = engine == "async" or _is_async(cfg)
    if engine == "loop" and not async_mode:
        return _run_hier_loop(cfg, resolve_device(device), ra_backend)
    hist = run_hier_many([cfg], engine="async" if async_mode else "scan",
                         ra_backend=ra_backend, device=device)[0]
    shape = (cfg.rounds, cfg.n_cells, cfg.devices_per_cell)
    out = {"loss": hist.global_loss, "accuracy": hist.accuracy,
           "eval_rounds": hist.rounds, "cum_time_s": hist.cum_time_s,
           "latency": hist.latency_all, "energy": hist.energy_all,
           "tx": hist.tx_trace.reshape(shape),
           "age": hist.age_trace.reshape(shape), "wall_s": hist.wall_s}
    if hist.commit_trace is not None:
        out["committed"] = hist.commit_trace.reshape(shape)
        out["cell_committed"] = hist.async_trace["cell_committed"]
        out["latency_cells"] = hist.async_trace["latency_cells"]
    return out
