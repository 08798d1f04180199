"""End-to-end FLOWN simulation harness (paper Sec. VI), PyTorch port.

Couples the control plane (Stackelberg round planning over a simulated
wireless network) with the learning plane (real training of the paper's
models on seeded synthetic datasets).  One `run_simulation` call produces
the trajectory behind one curve of Figs. 3-9.

Every engine shares the same first two stages:

  1. NumPy world (`_prepare`): dataset and partition, topology, the whole
     channel horizon and scenario traces, and every round's injected
     leader permutations — the same rng stream as the JAX package, so the
     same seed gives the same arrays;
  2. whole-horizon Γ (`_solve_horizons`): Algorithm 1 for every (round,
     sub-channel, device) pair in one batch, on kernel K1
     (`core.monotonic_torch.solve_pairs_fused`) or, with
     `ra_solver="step"`, on the step driver over kernel K2; `ra_backend`
     names another projection, as in the JAX package: "bisect" (alias
     "jnp"), "newton" or "mixed" route round both kernels (the step loop
     with that projection, on either solver).

Then one of three round loops:

  * engine="loop": per round, the NumPy Stackelberg leader
    (`core.stackelberg.plan_round`), local SGD of the transmitting devices
    (`fl.client`) and eq.-34 aggregation (`fl.server.aggregate`);
  * engine="scan": the device-resident round loop (`_build_scan_runner`):
    the same stages with the leader on tensors (`core.leader_torch`,
    float32 leader plane) and every per-round trace kept on the device
    until the run ends;
  * engine="async": the buffered event-timeline loop (`fl.async_loop`);
    every cell whose `SimConfig.aggregation` names an async commit policy
    runs here, whatever `engine` says.

Every aggregation is a weighted mean on kernel K3 (`kernels.fedavg_agg`)
when the run is on the card.  The scan and async engines run a `run_many`
group of cells — configs that share one model and trainer — as ONE loop on
a leading cell axis (`fl.engine_common`), the port of the JAX package's
`vmap` over the group: one leader step per distinct policy, one host read
of who trains, one K3 launch for every cell's aggregation per round; each
cell's local training and eval stay its own.  Every cell of a group gets
the bits of its solo run; `run_simulation` is the group of one.

Across devices (`run_many(..., shard=)`, the JAX package's `shard_map`
over `jax.local_devices()`): single-controller, collective-free.  The Γ
solve's rows split over the local devices (`launch.mesh.local_devices`:
every visible card, or `emulate_devices(n)` copies of one), one block per
device, and each group's cells likewise (`_dispatch_group`: padded to a
multiple of the device count by repeating cell 0, the pads dropped), every
block on a thread of its own so that all devices have work queued before
any shard's host waits.  Each cell stays bitwise its solo run.

The learning plane's random draws all go through `training_draws`: the
initial parameters, then one (K, local_steps, batch) block of minibatch
uniforms per round (or event) in which some device transmits.  A CPU
`torch.Generator` seeded with `cfg.seed` makes them, so a run on the card
and on the CPU train on the same draws; the differential tests replace the
function with the JAX package's exact draws.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Callable, Sequence

import numpy as np
import torch
from torch.func import functional_call, grad

from ..core import (RAResult, RoundPolicy, RoundRandomness, WirelessConfig,
                    init_aou, make_clusters, participation_deficit, plan_round)
from ..core.monotonic import fixed_ra
from ..core.monotonic_torch import check_ra_backend, solve_pairs_fused, solve_pairs_step
from ..data.fl_datasets import (Dataset, FLPartition, make_dataset,
                                partition_dirichlet, partition_imbalanced_iid)
from ..device import resolve_device
from ..launch.mesh import local_devices, map_shards, split_padded, use_shards
from ..models.small import SmallModel, get_small_model
from ..scenarios import (Scenario, apply_dynamics, compose_gains, get_scenario,
                         sample_churn, sample_distances, sample_energy,
                         sample_fading)
from ..train.optimizer import make_optimizer
from .async_loop import build_async_group_runner
from .client import make_local_trainer
from .engine_common import (eval_cells, group_data, make_eval_fn, make_group_leader,
                            make_xs, stack_cells, sync_group_round)
from .server import AsyncAggregation, aggregate, get_aggregation

__all__ = ["SimConfig", "SimHistory", "run_simulation", "run_many", "TABLE1",
           "training_draws"]

# Table I per-dataset settings: (model_bits, e_max, lr, batch, optimizer).
TABLE1 = {
    "mnist": dict(model_bits=1e6, e_max=0.02, lr=0.01, batch=32, optimizer="sgd"),
    "cifar10": dict(model_bits=5e6, e_max=0.1, lr=0.001, batch=512, optimizer="adam"),
    "sst2": dict(model_bits=5e6, e_max=0.1, lr=0.01, batch=128, optimizer="sgd"),
}

@dataclasses.dataclass(frozen=True)
class SimConfig:
    """One Sec.-VI simulation: dataset + network size + scheme policy +
    seed (Table-I learning settings default per dataset; override fields
    are None = "use Table I")."""

    dataset: str = "mnist"
    n_devices: int = 20
    n_subchannels: int = 4
    rounds: int = 100
    policy: RoundPolicy = RoundPolicy()
    seed: int = 0
    n_samples: int | None = None       # dataset size (None -> dataset default)
    local_steps: int = 4
    radius_m: float = 500.0
    pt_dbm: float = 10.0
    e_max_j: float | None = None       # None -> Table I per-dataset value
    lr: float | None = None
    batch: int | None = None
    optimizer: str | None = None
    eval_every: int = 1
    track_gradnorm: bool = False       # needed for the Prop-3 bound benchmark
    partition: str = "iid"             # "iid" (paper) | "dirichlet" (non-IID ext.)
    dirichlet_alpha: float = 0.5
    scenario: str | Scenario = "static"  # environment preset name or Scenario
    # Server aggregation discipline: "sync" (eq. 34, round barrier) or an
    # async preset name / `AsyncAggregation` spec (buffered staleness-
    # weighted commits; routes the cell through engine="async").
    aggregation: str | AsyncAggregation = "sync"

    def wireless(self) -> WirelessConfig:
        t1 = TABLE1[self.dataset]
        return WirelessConfig(
            n_devices=self.n_devices,
            n_subchannels=self.n_subchannels,
            radius_m=self.radius_m,
            pt_dbm=self.pt_dbm,
            model_bits=t1["model_bits"],
            e_max_j=self.e_max_j if self.e_max_j is not None else t1["e_max"],
        )


@dataclasses.dataclass
class SimHistory:
    """One finished simulation's trajectory: eval-round curves (loss,
    accuracy, eq.-9 latency, cumulative convergence time) plus full
    per-round traces (`*_all`, `tx_trace`, `age_trace`)."""

    label: str
    rounds: np.ndarray
    global_loss: np.ndarray
    accuracy: np.ndarray
    latency_s: np.ndarray          # per-round latency (eq. 9) at eval rounds
    cum_time_s: np.ndarray         # cumsum over ALL rounds, at eval rounds
    n_selected: np.ndarray
    n_transmitted: np.ndarray
    energy_j: np.ndarray           # total energy spent per round (eval rounds)
    deficits: np.ndarray           # Prop-3 participation deficits
    grad_sq_norms: np.ndarray      # ||grad F||^2 per round (0 if untracked)
    beta: np.ndarray
    wall_s: float
    plan_wall_s: float = 0.0       # control-plane share (Γ precompute)
    latency_all: np.ndarray | None = None   # (rounds,)
    energy_all: np.ndarray | None = None    # (rounds,)
    tx_trace: np.ndarray | None = None      # (rounds, N) bool
    age_trace: np.ndarray | None = None     # (rounds, N) post-update AoU
    # Async-engine extras (None on sync runs): `tx_trace` records
    # DISPATCHES there and `commit_trace` the server-side commits;
    # `async_trace` holds n_pending / overflow / rem_dispatch per event.
    commit_trace: np.ndarray | None = None  # (rounds, N) bool
    async_trace: dict | None = None


def _eval_rounds(rounds: int, eval_every: int) -> list[int]:
    return [t for t in range(rounds)
            if t % eval_every == 0 or t == rounds - 1]


def _pad_partition(ds: Dataset, part: FLPartition, device: torch.device,
                   bmax: int | None = None):
    """Pad per-device data to (N, Bmax, ...) + mask, as device tensors."""
    bmax = int(part.beta.max()) if bmax is None else bmax
    n = part.n_devices
    x = np.zeros((n, bmax) + ds.x.shape[1:], dtype=ds.x.dtype)
    y = np.zeros((n, bmax), dtype=ds.y.dtype)
    m = np.zeros((n, bmax), dtype=np.float32)
    for i, idx in enumerate(part.indices):
        x[i, : len(idx)] = ds.x[idx]
        y[i, : len(idx)] = ds.y[idx]
        m[i, : len(idx)] = 1.0
    return (torch.from_numpy(x).to(device), torch.from_numpy(y).to(device),
            torch.from_numpy(m).to(device))


def _sample_dataset(cfg: SimConfig, rng: np.random.Generator,
                    device: torch.device):
    """The world stream's dataset phase: dataset draw, device partition,
    padded client buffers (the rng prefix of `_prepare`)."""
    ds_kw = {} if cfg.n_samples is None else {"n": cfg.n_samples}
    ds = make_dataset(cfg.dataset, rng, **ds_kw)
    if cfg.partition == "dirichlet":
        part = partition_dirichlet(rng, ds.y, cfg.n_devices,
                                   cfg.dirichlet_alpha)
    else:
        part = partition_imbalanced_iid(rng, ds.n, cfg.n_devices)
    beta = part.beta.astype(np.float64)
    x_all, y_all, m_all = _pad_partition(ds, part, device)
    return ds, part, beta, x_all, y_all, m_all


@dataclasses.dataclass
class _Prepared:
    """Everything sampled ahead of the training loop for one simulation."""

    cfg: SimConfig
    wcfg: WirelessConfig
    rng: np.random.Generator
    ds: Dataset
    part: FLPartition
    beta: np.ndarray
    x_all: torch.Tensor
    y_all: torch.Tensor
    m_all: torch.Tensor
    h2_all: np.ndarray             # (rounds, K, N) pre-sampled channel gains
    clusters: np.ndarray
    fixed_ids: np.ndarray
    sel_perms: np.ndarray          # (rounds, N) injected device permutations
    assign_perms: np.ndarray       # (rounds, K) injected channel permutations
    distances: np.ndarray          # (rounds, N) mobility distance trace
    avail: np.ndarray              # (rounds, N) bool churn availability
    slowdown: np.ndarray           # (rounds, N) straggler compute multipliers
    emax_all: np.ndarray           # (rounds, N) per-round energy budgets


def _prepare(cfg: SimConfig, device: torch.device,
             _data_cache: dict | None = None) -> _Prepared:
    """Sample data + the whole-horizon scenario environment up front, in
    the JAX package's rng order (so the same seed gives the same world)."""
    rng = np.random.default_rng(cfg.seed)
    wcfg = cfg.wireless()
    scn = get_scenario(cfg.scenario)

    data_key = (cfg.dataset, cfg.n_samples, cfg.partition,
                cfg.dirichlet_alpha, cfg.n_devices, cfg.seed)
    if _data_cache is not None and data_key in _data_cache:
        ds, part, beta, x_all, y_all, m_all, state = _data_cache[data_key]
        rng.bit_generator.state = state
    else:
        ds, part, beta, x_all, y_all, m_all = _sample_dataset(cfg, rng, device)
        if _data_cache is not None:
            _data_cache[data_key] = (ds, part, beta, x_all, y_all, m_all,
                                     rng.bit_generator.state)

    distances = sample_distances(rng, wcfg, scn.mobility, cfg.rounds)
    clusters = make_clusters(cfg.n_devices, cfg.n_subchannels, rng)
    fixed_ids = rng.permutation(cfg.n_devices)[: cfg.n_subchannels]
    g2_all = sample_fading(rng, wcfg, scn.fading, cfg.rounds)
    h2_all = compose_gains(g2_all, distances, wcfg)
    sel_perms = np.stack([rng.permutation(cfg.n_devices)
                          for _ in range(cfg.rounds)])
    assign_perms = np.stack([rng.permutation(cfg.n_subchannels)
                             for _ in range(cfg.rounds)])
    avail, slowdown = sample_churn(rng, scn.churn, cfg.rounds, cfg.n_devices)
    emax_all = sample_energy(rng, wcfg, scn.energy, cfg.rounds)

    return _Prepared(cfg=cfg, wcfg=wcfg, rng=rng, ds=ds, part=part, beta=beta,
                     x_all=x_all, y_all=y_all, m_all=m_all, h2_all=h2_all,
                     clusters=clusters, fixed_ids=fixed_ids,
                     sel_perms=sel_perms, assign_perms=assign_perms,
                     distances=distances, avail=avail, slowdown=slowdown,
                     emax_all=emax_all)


def _solve_horizons(preps: Sequence[_Prepared], solver: str, device: torch.device,
                    backend: str | None = None, shard: bool | None = None
                    ) -> tuple[list[RAResult], list[float]]:
    """Algorithm 1 for every round of every prepared simulation, batched.

    All MO-RA horizons that share their wireless constants are flattened
    into ONE solver call (the solver is elementwise over pairs, with e_max a
    per-element operand); FIX-RA horizons are a closed form.  Sims sharing
    a `_Prepared` world and RA scheme alias one solve.  Returns the per-sim
    RAResults and each sim's share of planning wall time.  `backend` is the
    solver's projection backend (`core.monotonic_torch.RA_BACKENDS`);
    `shard` shards the fused solver's rows over the local devices (the step
    driver has no row-shard path, as in the JAX package).
    """
    out: list[RAResult | None] = [None] * len(preps)
    secs = [0.0] * len(preps)

    dup_of: list[int | None] = [None] * len(preps)
    rep_idx: dict[tuple[int, str], int] = {}
    for i, p in enumerate(preps):
        key = (id(p.h2_all), p.cfg.policy.ra)
        if key in rep_idx:
            dup_of[i] = rep_idx[key]
        else:
            rep_idx[key] = i

    def solver_key(wcfg: WirelessConfig) -> WirelessConfig:
        return dataclasses.replace(
            wcfg, n_devices=0, n_subchannels=0, radius_m=0.0, e_max_j=0.0,
            min_dist_m=1.0)

    groups: dict[WirelessConfig, list[int]] = {}
    for i, p in enumerate(preps):
        if p.cfg.policy.ra == "mo" and dup_of[i] is None:
            groups.setdefault(solver_key(p.wcfg), []).append(i)

    solve = (functools.partial(solve_pairs_fused, shard=shard) if solver == "fused"
             else solve_pairs_step)
    for mo in groups.values():
        h2_cat = np.concatenate([preps[i].h2_all.reshape(-1) for i in mo])
        beta_cat = np.concatenate([
            np.broadcast_to(preps[i].beta[None, None, :],
                            preps[i].h2_all.shape).reshape(-1)
            for i in mo])
        emax_cat = np.concatenate([
            np.broadcast_to(preps[i].emax_all[:, None, :],
                            preps[i].h2_all.shape).reshape(-1)
            for i in mo])
        t0 = time.perf_counter()
        ra_flat = solve(beta_cat, h2_cat, preps[mo[0]].wcfg, emax_cat,
                        backend=backend, device=device)
        group_s = time.perf_counter() - t0
        off = 0
        for i in mo:
            shp, sz = preps[i].h2_all.shape, preps[i].h2_all.size
            sl = slice(off, off + sz)
            out[i] = RAResult(**{f.name: getattr(ra_flat, f.name)[sl].reshape(shp)
                                 for f in dataclasses.fields(RAResult)})
            secs[i] = group_s * sz / h2_cat.size
            off += sz

    for i, p in enumerate(preps):
        if out[i] is None and dup_of[i] is None:
            t0 = time.perf_counter()
            out[i] = fixed_ra(p.beta[None, None, :], p.h2_all, p.wcfg,
                              np.broadcast_to(p.emax_all[:, None, :],
                                              p.h2_all.shape))
            secs[i] = time.perf_counter() - t0
    for i, rep in enumerate(dup_of):
        if rep is not None:
            out[i] = out[rep]
    return out, secs


def _slice_ra(ra: RAResult, t: int) -> RAResult:
    return RAResult(tau=ra.tau[t], p=ra.p[t], time_s=ra.time_s[t],
                    energy_j=ra.energy_j[t], feasible=ra.feasible[t],
                    iterations=ra.iterations[t])


def training_draws(cfg: SimConfig, batch: int, device: torch.device,
                   k: int | None = None
                   ) -> tuple[dict[str, torch.Tensor], Callable[[], torch.Tensor]]:
    """The learning plane's only random draws: the initial parameters, and
    a function giving one (K, local_steps, batch) float32 block of minibatch
    uniforms in [0, 1) per round in which some device transmits.

    Both come from a CPU generator seeded with `cfg.seed` whatever the
    device, so the card and the CPU train on the same numbers; a block
    reaches the card by an asynchronous copy from pinned memory (no host
    sync).  `k` overrides K = `cfg.n_subchannels`: a hierarchy's block is
    one cell's (`fl.hierarchical`)."""
    gen = torch.Generator()
    gen.manual_seed(cfg.seed)
    params0 = {name: v.to(device)
               for name, v in get_small_model(cfg.dataset).init_params(gen).items()}
    shape = (cfg.n_subchannels if k is None else k, cfg.local_steps, batch)

    def next_uniforms() -> torch.Tensor:
        u = torch.rand(shape, generator=gen, dtype=torch.float32)
        if device.type == "cuda":
            return u.pin_memory().to(device, non_blocking=True)
        return u

    return params0, next_uniforms


def _run_prepared(prep: _Prepared, ra_all: RAResult, plan_wall_s: float,
                  device: torch.device) -> SimHistory:
    cfg, wcfg, rng, beta = prep.cfg, prep.wcfg, prep.rng, prep.beta
    t_start = time.perf_counter()
    t1 = TABLE1[cfg.dataset]
    batch = cfg.batch or t1["batch"]

    # ---- model + trainer --------------------------------------------------
    model = get_small_model(cfg.dataset).to(device)
    params, next_uniforms = training_draws(cfg, batch, device)
    opt = make_optimizer(cfg.optimizer or t1["optimizer"], cfg.lr or t1["lr"])
    trainer = make_local_trainer(model, opt, batch_size=batch,
                                 local_steps=cfg.local_steps)
    x_full = torch.from_numpy(prep.ds.x).to(device)
    y_full = torch.from_numpy(prep.ds.y).to(device)

    def full_loss(p):
        return model.loss_per_example(functional_call(model, p, (x_full,)),
                                      y_full).mean()

    def evaluate(p):
        with torch.no_grad():
            logits = functional_call(model, p, (x_full,))
            return (float(model.loss_per_example(logits, y_full).mean()),
                    float(model.correct(logits, y_full).mean()))

    def grad_norm_sq(p):
        return float(sum((g * g).sum() for g in grad(full_loss)(p).values()))

    aou = init_aou(cfg.n_devices)
    k_slots = cfg.n_subchannels
    eval_at = set(_eval_rounds(cfg.rounds, cfg.eval_every))
    hist: dict[str, list] = {k: [] for k in (
        "round", "loss", "acc", "nsel", "ntx", "deficit", "gnorm")}
    lat_all = np.zeros(cfg.rounds)
    energy_all = np.zeros(cfg.rounds)
    tx_trace = np.zeros((cfg.rounds, cfg.n_devices), dtype=bool)
    age_trace = np.zeros((cfg.rounds, cfg.n_devices), dtype=np.int64)

    for t in range(cfg.rounds):
        plan = plan_round(
            aou, beta, prep.h2_all[t], wcfg, rng,
            policy=cfg.policy, round_idx=t, clusters=prep.clusters,
            fixed_ids=prep.fixed_ids, ra=_slice_ra(ra_all, t),
            randomness=RoundRandomness(sel_perm=prep.sel_perms[t],
                                       assign_perm=prep.assign_perms[t]),
        )
        aou = plan.aou_next
        lat_all[t] = plan.latency_s
        energy_all[t] = float(plan.energy_per_device.sum())
        tx_trace[t] = plan.transmitted
        age_trace[t] = aou.age

        # ---- learning plane: train the transmitting devices. -------------
        tx_ids = np.where(plan.transmitted)[0]
        slot_ids = np.zeros(k_slots, dtype=np.int64)
        slot_w = np.zeros(k_slots, dtype=np.float32)
        slot_ids[: len(tx_ids)] = tx_ids
        slot_w[: len(tx_ids)] = beta[tx_ids]

        if len(tx_ids) > 0:
            sid = torch.from_numpy(slot_ids).to(device)
            client_params = trainer(params, prep.x_all[sid], prep.y_all[sid],
                                    prep.m_all[sid], next_uniforms())
            params = aggregate(params, client_params,
                               torch.from_numpy(slot_w).to(device))

        # ---- bookkeeping ---------------------------------------------------
        if t in eval_at:
            loss, acc = evaluate(params)
            hist["round"].append(t)
            hist["loss"].append(loss)
            hist["acc"].append(acc)
            hist["nsel"].append(int(plan.selected.sum()))
            hist["ntx"].append(int(plan.transmitted.sum()))
            hist["deficit"].append(participation_deficit(beta, plan.transmitted))
            hist["gnorm"].append(grad_norm_sq(params) if cfg.track_gradnorm else 0.0)

    ev = np.asarray(hist["round"])
    return SimHistory(
        label=cfg.policy.label,
        rounds=ev,
        global_loss=np.asarray(hist["loss"]),
        accuracy=np.asarray(hist["acc"]),
        latency_s=lat_all[ev],
        cum_time_s=np.cumsum(lat_all)[ev],
        n_selected=np.asarray(hist["nsel"]),
        n_transmitted=np.asarray(hist["ntx"]),
        energy_j=energy_all[ev],
        deficits=np.asarray(hist["deficit"]),
        grad_sq_norms=np.asarray(hist["gnorm"]),
        beta=beta,
        wall_s=time.perf_counter() - t_start + plan_wall_s,
        plan_wall_s=plan_wall_s,
        latency_all=lat_all,
        energy_all=energy_all,
        tx_trace=tx_trace,
        age_trace=age_trace,
    )


# ---------------------------------------------------------------------------
# engine="scan": the device-resident round loop
# ---------------------------------------------------------------------------

def _scan_inputs(prep: _Prepared, ra: RAResult, device: torch.device,
                 policy_idx: int = 0) -> dict:
    """Per-cell device tensors consumed by the device round loops.

    Leader-plane operands are cast to float32 (the learning plane's dtype),
    as the JAX package's scan engine casts them: its latency and energy
    traces are then this engine's too.  `policy_idx` selects the cell's
    leader branch of its group.
    """
    cfg = prep.cfg
    params0, next_uniforms = training_draws(
        cfg, cfg.batch or TABLE1[cfg.dataset]["batch"], device)

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)

    def i64(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)

    return dict(
        params0=params0,
        next_uniforms=next_uniforms,
        policy_idx=policy_idx,
        beta=f32(prep.beta),
        x_all=prep.x_all.to(device), y_all=prep.y_all.to(device),
        m_all=prep.m_all.to(device),
        x_full=torch.from_numpy(prep.ds.x).to(device),
        y_full=torch.from_numpy(prep.ds.y).to(device),
        clusters=i64(prep.clusters),
        fixed_ids=i64(prep.fixed_ids),
        gamma=f32(ra.time_s),
        feas=torch.as_tensor(ra.feasible, device=device),
        energy=f32(np.where(np.isfinite(ra.energy_j), ra.energy_j, 0.0)),
        sel_perms=i64(prep.sel_perms),
        assign_perms=i64(prep.assign_perms),
    )


def _eval_mask(cfg: SimConfig) -> np.ndarray:
    mask = np.zeros(cfg.rounds, bool)
    mask[_eval_rounds(cfg.rounds, cfg.eval_every)] = True
    return mask


def _build_scan_runner(cfg: SimConfig, model: SmallModel, trainer,
                       policies: Sequence[tuple[str, str]]):
    """The round loop of a group of B cells with all its state on the
    device: leader plane + learning plane, per round.

    State = (params, draws, age) with a leading cell axis; per-round inputs
    = Γ slices + injected permutations (`make_xs`).  Returns fn(data) ->
    ys, `data` the group's (`engine_common.group_data` of the cells'
    `_scan_inputs`), ys a dict of per-round tensors (rounds, B, ...), still
    on the device.  The host reads one (B,) vector per round — which cells
    train — besides the leader's own reads (`core.leader_torch.host_int`).

    `policies` lists the distinct (ds, sa) leader variants of the group;
    each cell's `policy_idx` picks its own.
    """
    k, n = cfg.n_subchannels, cfg.n_devices
    n_clusters = int(math.ceil(n / k))
    eval_mask = _eval_mask(cfg)

    def run(data):
        device = data["beta"].device
        cells = data["cells"]
        zeros = torch.zeros(len(cells), dtype=torch.float32, device=device)
        leader = make_group_leader(policies, data, k=k, n=n, n_clusters=n_clusters)
        evs = [make_eval_fn(model, c, cfg.track_gradnorm) for c in cells]
        xs = make_xs(data, cfg.rounds, eval_mask)
        params = stack_cells([c["params0"] for c in cells])
        draws = [c["next_uniforms"] for c in cells]
        age = torch.ones((len(cells), n), dtype=torch.int32, device=device)
        ys = []
        for r in range(cfg.rounds):
            x = {name: v[r] for name, v in xs.items()}
            # Leader plane (Algorithms 2-3 + AoU), training and eq. 34.
            out = sync_group_round(leader, trainer, data, x, params, draws, age, k=k, n=n)
            params, lead = out["params"], out["lead"]
            # ---- bookkeeping: evaluate only at eval rounds ---------------
            loss, acc, gnorm = (eval_cells(evs, params) if x["eval_mask"]
                                else (zeros, zeros, zeros))
            age = lead["age_next"]
            ys.append(dict(loss=loss, acc=acc, gnorm=gnorm, latency=out["latency"],
                           energy=out["energy"], selected=lead["selected"],
                           transmitted=lead["transmitted"], age=age))
        return {name: torch.stack([y[name] for y in ys]) for name in ys[0]}

    return run


def _to_host(ys: dict) -> dict:
    """The run's per-round traces to NumPy: the one copy at its end."""
    return {name: v.cpu().numpy() for name, v in ys.items()}


def _history_from_scan(cfg: SimConfig, beta: np.ndarray, ys: dict,
                       wall_s: float, plan_wall_s: float) -> SimHistory:
    lat_all = np.asarray(ys["latency"], np.float64)
    energy_all = np.asarray(ys["energy"], np.float64)
    tx = np.asarray(ys["transmitted"])
    sel = np.asarray(ys["selected"])
    age = np.asarray(ys["age"], np.int64)
    ev = np.asarray(_eval_rounds(cfg.rounds, cfg.eval_every))
    return SimHistory(
        label=cfg.policy.label,
        rounds=ev,
        global_loss=np.asarray(ys["loss"], np.float64)[ev],
        accuracy=np.asarray(ys["acc"], np.float64)[ev],
        latency_s=lat_all[ev],
        cum_time_s=np.cumsum(lat_all)[ev],
        n_selected=sel[ev].sum(axis=1),
        n_transmitted=tx[ev].sum(axis=1),
        energy_j=energy_all[ev],
        deficits=np.asarray([participation_deficit(beta, tx[t]) for t in ev]),
        grad_sq_norms=np.asarray(ys["gnorm"], np.float64)[ev],
        beta=beta,
        wall_s=wall_s,
        plan_wall_s=plan_wall_s,
        latency_all=lat_all,
        energy_all=energy_all,
        tx_trace=tx,
        age_trace=age,
    )


def _scan_group_key(cfg: SimConfig) -> SimConfig:
    """Configs identical up to seed / wireless data / policy / scenario /
    aggregation share one model and trainer: those fields change only the
    data flowing through the round loop, never its shapes."""
    return dataclasses.replace(
        cfg, seed=0, radius_m=0.0, pt_dbm=0.0, e_max_j=None,
        policy=RoundPolicy(), scenario="static", aggregation="sync")


def _prep_key(cfg: SimConfig) -> SimConfig:
    """Configs identical up to the policy sample the same `_Prepared`
    world.  The aggregation discipline does not enter it either: sync and
    async variants of one world share its samples and its Γ solve, which
    makes the sync-vs-async comparison differential."""
    return dataclasses.replace(cfg, policy=RoundPolicy(), aggregation="sync")


def _group_trainer_and_policies(cfgs: Sequence[SimConfig], device: torch.device):
    """Shared scan/async group set-up: model, trainer, and the group's
    distinct (ds, sa) leader variants in first-appearance order with each
    cell's branch index."""
    cfg = cfgs[0]
    t1 = TABLE1[cfg.dataset]
    model = get_small_model(cfg.dataset).to(device)
    opt = make_optimizer(cfg.optimizer or t1["optimizer"], cfg.lr or t1["lr"])
    trainer = make_local_trainer(model, opt, batch_size=cfg.batch or t1["batch"],
                                 local_steps=cfg.local_steps)
    policies: list[tuple[str, str]] = []
    pol_idx = []
    for c in cfgs:
        key = (c.policy.ds, c.policy.sa)
        if key not in policies:
            policies.append(key)
        pol_idx.append(policies.index(key))
    return model, trainer, policies, pol_idx


def _check_f32_priorities(preps: Sequence[_Prepared]) -> None:
    # The device-resident leaders rank float32 age*beta products
    # (core.leader_torch.priority_order); they are integer-exact — and hence
    # tie/order identical to the host's f64 ranking — only below 2^24.
    # Ages are bounded by rounds + 1.
    for p in preps:
        worst = (p.cfg.rounds + 1) * float(p.beta.max())
        if worst >= 2 ** 24:
            raise ValueError(
                f"scan engine: age*beta products may reach {worst:.3g} >= "
                f"2^24, where float32 priorities lose host equivalence — "
                f"use engine='loop' or shrink rounds/data sizes")


def _run_group(mode: str, cfgs: Sequence[SimConfig], preps: Sequence[_Prepared],
               ras: Sequence[RAResult], plan_walls: Sequence[float],
               device: torch.device) -> list[SimHistory]:
    """Run one group of simulations through the scan or the async engine
    as ONE loop over a leading cell axis, sharing the group's model,
    trainer and leader variants.  The cells run sorted by policy, so each
    distinct policy's leader runs once per round on a contiguous slice;
    the histories come back in the given order.  On the async engine each
    cell's commit batch size, staleness exponent and server step enter as
    data.

    A cell's `wall_s` is the group's wall time divided by its size, plus
    the cell's own share of planning (`plan_wall_s`), as the JAX package
    counts it: the cells run together, so there is no per-cell time."""
    cfg = cfgs[0]
    model, trainer, policies, pol_idx = _group_trainer_and_policies(cfgs, device)
    _check_f32_priorities(preps)
    order = sorted(range(len(cfgs)), key=pol_idx.__getitem__)
    t_start = time.perf_counter()
    cells = []
    for i in order:
        d = _scan_inputs(preps[i], ras[i], device, pol_idx[i])
        if mode == "async":
            spec = _async_spec(cfgs[i])
            d.update(buffer=spec.resolve_buffer(cfg.n_devices, cfg.n_subchannels),
                     stale_exp=torch.tensor(spec.stale_exponent(), dtype=torch.float32,
                                            device=device),
                     server_lr=torch.tensor(spec.server_lr, dtype=torch.float32,
                                            device=device))
        cells.append(d)
    if mode == "scan":
        run = _build_scan_runner(cfg, model, trainer, policies)
    else:
        run = build_async_group_runner(
            model, trainer, policies, k=cfg.n_subchannels, n=cfg.n_devices,
            rounds=cfg.rounds, eval_mask=_eval_mask(cfg),
            track_gradnorm=cfg.track_gradnorm)
    ys = _to_host(run(group_data(cells)))
    wall_each = (time.perf_counter() - t_start) / len(cfgs)
    history = _history_from_scan if mode == "scan" else _history_from_async
    out: list[SimHistory | None] = [None] * len(cfgs)
    for j, i in enumerate(order):
        out[i] = history(cfgs[i], preps[i].beta, {name: v[:, j] for name, v in ys.items()},
                         wall_each + plan_walls[i], plan_walls[i])
    return out


def _dispatch_group(run_group: Callable, cfgs: Sequence, preps: Sequence, ras: Sequence,
                    plan_walls: Sequence[float], device: torch.device,
                    shard: bool | None) -> list[SimHistory]:
    """One group on one device, or — when `shard` allows and more than one
    local device is visible (`launch.mesh.local_devices`) — the port of the
    JAX package's `shard_map` over the group's cell axis: the cells are
    padded to a multiple of the device count by repeating cell 0, each
    device runs its contiguous block as a group of its own
    (`run_group(cfgs, preps, ras, plan_walls, device)`, all blocks at once,
    `launch.mesh.map_shards`), and the pad cells are dropped.  A cell is
    bitwise its solo run whatever block it lands in.  A member's `wall_s`
    is the whole dispatch's wall time over the group's size plus its own
    `plan_wall_s`, as unsharded."""
    devices = local_devices(device)
    if len(cfgs) == 1 or not use_shards(shard, devices):
        return run_group(cfgs, preps, ras, plan_walls, device)
    t_start = time.perf_counter()
    blocks = split_padded(len(cfgs), len(devices))
    parts = map_shards(lambda idx, dev: run_group([cfgs[i] for i in idx], [preps[i] for i in idx],
                                                  [ras[i] for i in idx],
                                                  [plan_walls[i] for i in idx], dev),
                       blocks, devices)
    out = [h for part in parts for h in part][:len(cfgs)]
    wall_each = (time.perf_counter() - t_start) / len(cfgs)
    for h, w in zip(out, plan_walls):
        h.wall_s = wall_each + w
    return out


# ---------------------------------------------------------------------------
# engine="async": the buffered event-timeline loop
# ---------------------------------------------------------------------------

def _async_spec(cfg: SimConfig) -> AsyncAggregation:
    """The cell's commit policy.  A "sync" cell forced through the event
    engine runs the degenerate full-buffer barrier, which reproduces the
    scan engine bit for bit — the differential anchor."""
    spec = get_aggregation(cfg.aggregation)
    if spec is None:
        spec = AsyncAggregation(buffer="full", staleness="const")
    return spec


def _history_from_async(cfg: SimConfig, beta: np.ndarray, ys: dict,
                        wall_s: float, plan_wall_s: float) -> SimHistory:
    hist = _history_from_scan(cfg, beta, ys, wall_s, plan_wall_s)
    hist.commit_trace = np.asarray(ys["committed"])
    hist.async_trace = dict(
        n_pending=np.asarray(ys["n_pending"], np.int64),
        overflow=np.asarray(ys["overflow"]),
        rem_dispatch=np.asarray(ys["rem_dispatch"], np.float64),
    )
    return hist


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def run_many(cfgs: Sequence[SimConfig], *, ra_backend: str | None = None,
             ra_solver: str = "fused", engine: str = "loop",
             device=None, shard: bool | None = None) -> list[SimHistory]:
    """Run several simulations, sharing ONE batched whole-horizon Γ solve.

    Configs identical up to the policy (and aggregation) share one
    `_Prepared` world and one Γ solve per RA scheme; each simulation then
    replays its precomputed per-round slices through its engine.  On the
    scan and async engines, configs that differ only in seed, wireless
    data, policy, scenario or aggregation form a group that runs as one
    loop on a leading cell axis (`_run_group`), each cell bitwise its solo
    run.

    Args:
      cfgs: the simulations to run; results are returned in the same order.
      ra_backend: projection backend of the Γ solver, the JAX package's
        names: None (default — the kernels), "cuda" / "pallas" (the same),
        "bisect" / "jnp", "newton" or "mixed" (the step loop with that
        projection, launching neither K1 nor K2); see
        `core.monotonic_torch`.
      ra_solver: "fused" (default — kernel K1 solves every pair whole) or
        "step" (the per-iteration driver over kernel K2).
      engine: "loop" (host round loop), "scan" (device-resident round loop)
        or "async" (buffered event-timeline loop).  Cells whose
        `SimConfig.aggregation` names an async commit policy route through
        the async engine REGARDLESS of this argument; engine="async" forces
        every cell through it, where "sync"-aggregation cells run the
        full-buffer barrier and reproduce the scan engine bit for bit.
      device: "cuda[:i]" or "cpu"; None means the current CUDA device and
        raises when none is visible.
      shard: shard the scan / async groups' cell axis — and the fused Γ
        solve's rows — over the local devices (`launch.mesh.local_devices`:
        every visible card, or `emulate_devices(n)` copies of one), one
        block per device, each cell bitwise its solo run.  None (default)
        shards when more than one device is visible; False never; True on
        one device is the unsharded path.  engine="loop" cells ignore it
        except in the Γ solve.
    """
    if engine not in ("loop", "scan", "async"):
        raise ValueError(f"unknown engine: {engine}")
    if ra_solver not in ("fused", "step"):
        raise ValueError(f"unknown ra_solver: {ra_solver}")
    check_ra_backend(ra_backend)
    # Per-cell mode: an async aggregation spec overrides the requested sync
    # engine (and validates eagerly, before any sampling).
    modes = ["async" if engine == "async" or get_aggregation(c.aggregation)
             is not None else engine for c in cfgs]
    device = resolve_device(device)

    preps_by_key: dict[SimConfig, _Prepared] = {}
    data_cache: dict = {}
    preps: list[_Prepared] = []
    for c in cfgs:
        key = _prep_key(c)
        if key not in preps_by_key:
            preps_by_key[key] = _prepare(c, device, data_cache)
        shared = preps_by_key[key]
        preps.append(shared if shared.cfg == c
                     else dataclasses.replace(shared, cfg=c))

    ras, plan_walls = _solve_horizons(preps, ra_solver, device, ra_backend, shard)
    # Churn availability and straggler slowdowns fold into the solved
    # horizon once (Γ-deduped sims alias one RAResult, transformed once).
    transformed: dict[int, RAResult] = {}
    for i, (p, ra) in enumerate(zip(preps, ras)):
        if id(ra) not in transformed:
            transformed[id(ra)] = apply_dynamics(
                ra, p.avail, p.slowdown, p.beta, p.wcfg)
        ras[i] = transformed[id(ra)]

    out: list[SimHistory | None] = [None] * len(cfgs)
    groups: dict[tuple[str, SimConfig], list[int]] = {}
    for i, (c, mode) in enumerate(zip(cfgs, modes)):
        if mode == "loop":
            out[i] = _run_prepared(preps[i], ras[i], plan_walls[i], device)
        else:
            groups.setdefault((mode, _scan_group_key(c)), []).append(i)
    for (mode, _), idx in groups.items():
        hists = _dispatch_group(functools.partial(_run_group, mode), [cfgs[i] for i in idx],
                                [preps[i] for i in idx], [ras[i] for i in idx],
                                [plan_walls[i] for i in idx], device, shard)
        for i, h in zip(idx, hists):
            out[i] = h
    return out


def run_simulation(cfg: SimConfig, *, ra_backend: str | None = None,
                   ra_solver: str = "fused", engine: str = "loop",
                   device=None) -> SimHistory:
    """Run ONE simulation: ``run_many([cfg], ...)[0]``."""
    return run_many([cfg], ra_backend=ra_backend, ra_solver=ra_solver,
                    engine=engine, device=device)[0]
